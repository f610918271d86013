"""KV page shipping and the warm host tier in the port against the JAX
package: the wire format byte for byte, the int8 quantization bit for bit,
the caches' counters over one scripted trace, and the engines' export /
install and warm-tier paths token for token (fp32, CPU)."""
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu.serving import kv_transfer as jkv
from paddle_tpu.serving import paged_kv as jpaged
from paddle_tpu_torch.serving import (GenerationConfig, GenerationEngine,
                                      HostPagePool, PagedKVPool, PrefixCache,
                                      kv_transfer as pkv, token_blocks)
from test_torch_gpt import SMALL, make_pair

GEN_CFG = dict(max_slots=2, max_seq_len=48, page_len=8,
               prefill_buckets=(8, 16, 32))


def stacks(seed, layers=2, n=3, shape=(4, 2, 8), scale=1.0):
    rng = np.random.default_rng(seed)
    k = [(scale * rng.standard_normal((n,) + shape)).astype(np.float32)
         for _ in range(layers)]
    v = [(scale * rng.standard_normal((n,) + shape)).astype(np.float32)
         for _ in range(layers)]
    return k, v


def as_bf16(arrays):
    """The same bf16 values as ml_dtypes arrays (JAX side) and torch
    tensors (port side)."""
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    j = [x.view(torch.int16).numpy().view(ml_dtypes.bfloat16) for x in t]
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantize", [False, True])
def test_pack_kv_pages_is_byte_identical(dtype, quantize):
    """Blob, manifest and meta (digest included) equal the JAX package's,
    from numpy arrays and from tensors; each package unpacks the other's
    blob to the same values."""
    k, v = stacks(0)
    k[0][1] = 0.0  # an all-zero page: the scale floor
    if dtype == "bfloat16":
        (jk, pk), (jv, pv) = as_bf16(k), as_bf16(v)
        port_inputs = [(pk, pv)]
    else:
        jk, jv = k, v
        port_inputs = [(k, v), ([torch.from_numpy(a) for a in k],
                                [torch.from_numpy(a) for a in v])]
    jblob, jman, jmeta = jkv.pack_kv_pages(jk, jv, quantize=quantize)
    for pk_, pv_ in port_inputs:
        blob, man, meta = pkv.pack_kv_pages(pk_, pv_, quantize=quantize)
        assert blob == jblob
        assert man == jman
        assert meta == jmeta
    assert jman[0]["dtype"] == dtype
    # the port unpacks the JAX blob ...
    uk, uv = pkv.unpack_kv_pages(jblob, jman)
    rk, rv = jkv.unpack_kv_pages(jblob, jman)
    for got, ref in zip(uk + uv, rk + rv):
        assert str(got.dtype) == "torch." + dtype
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref, dtype=np.float32))
    # ... and the JAX package the port's
    jk2, jv2 = jkv.unpack_kv_pages(blob, man)
    for got, ref in zip(jk2 + jv2, rk + rv):
        np.testing.assert_array_equal(np.asarray(got, np.float32),
                                      np.asarray(ref, np.float32))


def test_unpack_of_an_empty_stack_and_layer_mismatch():
    k = [np.zeros((0, 4, 2, 8), np.float32)]
    blob, man, meta = pkv.pack_kv_pages(k, k, quantize=True)
    assert meta["npages"] == 0 and blob == b""
    uk, _uv = pkv.unpack_kv_pages(blob, man)
    assert tuple(uk[0].shape) == (0, 4, 2, 8)
    with pytest.raises(ValueError, match="layer mismatch"):
        pkv.pack_kv_pages(k, k + k)
    with pytest.raises(ValueError, match="page count"):
        pkv.pack_kv_pages([np.zeros((2, 4, 2, 8), np.float32)], k)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_quantize_page_is_bit_identical(scale):
    k, _ = stacks(1, layers=1, n=1, scale=scale)
    page = k[0][0]
    q, s = pkv.quantize_page(page)
    jq, js = jkv.quantize_page(page)
    np.testing.assert_array_equal(q, jq)
    assert s == js
    d = pkv.dequantize_page(q, s)
    np.testing.assert_array_equal(d, jkv.dequantize_page(jq, js))
    assert np.abs(d - page).max() <= s / 2 * (1 + 1e-6)
    # bf16 dequantization rounds as the JAX cast does
    db = pkv.dequantize_page(q, s, torch.bfloat16)
    jdb = jkv.dequantize_page(jq, js, ml_dtypes.bfloat16)
    np.testing.assert_array_equal(db.view(torch.int16).numpy(),
                                  jdb.view(np.int16))
    assert pkv.quantize_page(np.zeros((2, 2), np.float32))[1] == 1e-12


def test_chunking_round_trips_and_detects_corruption():
    blob = bytes(range(256)) * 37
    chunks = pkv.chunk_blob(blob, chunk_bytes=1000)
    assert chunks == jkv.chunk_blob(blob, chunk_bytes=1000)
    digest = pkv.payload_digest(blob)
    assert digest == jkv.payload_digest(blob)
    assert pkv.assemble_chunks(list(reversed(chunks)), digest) == blob
    torn = [dict(c) for c in chunks]
    torn[3]["data"] = torn[4]["data"]
    with pytest.raises(ValueError, match="chunk 3 SHA"):
        pkv.assemble_chunks(torn, digest)
    with pytest.raises(ValueError, match="sequence broken"):
        pkv.assemble_chunks(chunks[:2] + chunks[3:], digest)
    with pytest.raises(ValueError, match="digest mismatch"):
        pkv.assemble_chunks(chunks, pkv.payload_digest(b"x"))
    with pytest.raises(ValueError, match="positive"):
        pkv.chunk_blob(blob, chunk_bytes=0)
    assert pkv.chunk_blob(b"") == jkv.chunk_blob(b"")


def test_prompt_cache_key_matches_jax():
    rng = np.random.default_rng(2)
    for n in (3, 8, 17, 64):
        p = rng.integers(0, 50000, size=n)
        assert pkv.prompt_cache_key(p, 8) == jkv.prompt_cache_key(p, 8)
    assert pkv.prompt_cache_key([1, 2], 8) is None


def _cache_trace(mod):
    """One scripted trace through ``FleetKVCache`` and ``KVMigrationStats``
    of module ``mod``; returns their stats."""
    cache = mod.FleetKVCache(capacity_bytes=100, admit_threshold=2,
                             ghost_cap=3)
    log = []
    for key, size in [("a", 40), ("a", 40), ("b", 50), ("b", 50),
                      ("c", 30), ("c", 30), ("a", 40), ("d", 200),
                      ("d", 200), ("e", 10), (None, 5), ("f", 1)]:
        log.append(cache.put(key, {"data": b"x" * size}))
        log.append(cache.get(key) is not None)
    log.append(cache.admittable("f"))
    st = mod.KVMigrationStats()
    st.note_ship(4, 100, 400, True)
    st.note_ship(2, 200, 200, False)
    st.note_install(2.5)
    st.note_install(1.5)
    st.note_export()
    st.note_warm_hit()
    st.note_fallback()
    st.note_failover(True)
    st.note_failover(False)
    return log, cache.stats(), st.snapshot()


def test_fleet_kv_cache_and_migration_stats_match_jax():
    assert _cache_trace(pkv) == _cache_trace(jkv)


def _host_pool_trace(mod, page_of):
    """One scripted trace of admit / reject / evict / restore through a
    ``HostPagePool`` of module ``mod``."""
    pool = mod.HostPagePool(capacity_bytes=3 * 2 * 2 * 64, admit_threshold=2,
                            ghost_cap=4)
    out = []
    for key in ["a", "a", "b", "b", "c", "c", "d", "d", "b", "e", "f", "g",
                "h", "c"]:
        pool.note_access(key)
        k = [page_of(key, i) for i in range(2)]
        out.append(pool.put(key, k, k))
    for key in ["a", "b", "c", "d", "zz"]:
        got = pool.get(key)
        out.append(None if got is None else
                   [np.asarray(x, np.float32).tolist() for x in got[0]])
    return out, pool.stats()


def test_host_page_pool_matches_jax_over_a_trace():
    def page_of(key, i):
        rng = np.random.default_rng(ord(key[0]) * 10 + i)
        return rng.standard_normal((4, 2, 8)).astype(np.float32)

    got = _host_pool_trace(__import__("paddle_tpu_torch.serving.paged_kv",
                                      fromlist=["x"]), page_of)
    ref = _host_pool_trace(jpaged, page_of)
    assert got == ref
    assert got[1]["admits"] and got[1]["rejects"] and got[1]["evictions"]


def test_paged_pool_spills_and_restores_like_jax():
    """Fill a small pool through the trie, evict (the spill hook), restore
    from the warm tier: the same counts in both pools, each restored page
    within the int8 step of its original, and the read/write path exact."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    L, P, PL, nh, hd = 2, 7, 4, 2, 8
    blocks = [tuple(range(i * 4, i * 4 + 4)) for i in range(4)]
    pools = {
        "jax": jpaged.PagedKVPool(L, P, PL, nh, hd, jnp.float32,
                                  warm_pool=jpaged.HostPagePool(1 << 20)),
        "port": PagedKVPool(L, P, PL, nh, hd, torch.float32, device="cpu",
                            warm_pool=HostPagePool(1 << 20))}
    data = [rng.standard_normal((4, PL, nh, hd)).astype(np.float32)
            for _ in range(2 * L)]
    out = {}
    for side, pool in pools.items():
        # seen once before (as an admit's warm_restore would note it)
        assert pool.warm_restore(blocks) == 0
        pages = pool.allocate(4)
        pool.write_pages(pages, data[:L], data[L:])
        k, _v = pool.read_pages(pages)
        np.testing.assert_array_equal(np.asarray(k[1]), data[1])
        pool.trie.insert(blocks, pages, pool.allocator)
        for pg in pages:
            pool.allocator.release(pg)
        taken = pool.allocate(5)   # 2 free: evicts 3 leaves, 3 spills
        for pg in taken:
            pool.allocator.release(pg)
        restored = pool.warm_restore(blocks)
        chain = pool.trie.match(blocks, PL)
        k, v = pool.read_pages(chain)
        out[side] = (restored, pool.stats()["warm"], pool.trie.stats(),
                     [np.asarray(x).tolist() for x in k])
        for li in range(L):
            for j in range(4):
                _q, s = pkv.quantize_page(data[li][j])
                assert np.abs(np.asarray(k[li][j]) - data[li][j]).max() \
                    <= s / 2 * (1 + 1e-6)
    assert out["port"] == out["jax"]
    assert out["port"][0] == 3 and out["port"][1]["restores"] == 3


def test_chain_key_and_release_all():
    blocks = [(1, 2), (3, 4)]
    assert PrefixCache.chain_key(blocks) == jpaged.PrefixCache.chain_key(
        blocks) == ((None, (1, 2)), (3, 4))
    assert PrefixCache.chain_key([]) is None
    pool = PagedKVPool(1, 5, 2, 1, 2, device="cpu")
    pages = pool.allocate(2)
    pool.trie.insert(blocks, pages, pool.allocator)
    for pg in pages:
        pool.allocator.release(pg)
    assert pool.allocator.free_pages == 2
    pool.trie.release_all(pool.allocator)
    assert pool.allocator.free_pages == 4 and len(pool.trie) == 0
    pool.allocator.check()


# -- the engines ------------------------------------------------------------------

def _warm_requests():
    rng = np.random.default_rng(9)
    V = SMALL["vocab_size"]
    a = rng.integers(0, V, size=20)
    return [(a, 4), (rng.integers(0, V, size=30), 10),
            (rng.integers(0, V, size=30), 10),
            (rng.integers(0, V, size=30), 15), (a, 6)]


def test_warm_tier_engine_gives_the_jax_engines_tokens():
    """A pool small enough that the first prompt's cached pages are evicted
    (and spilled) before it comes again: it is then served from the warm
    tier in both engines, with the same tokens and the same counters."""
    jm, pm = make_pair()
    cfg = dict(GEN_CFG, num_pages=13, warm_pool_bytes=1 << 20)
    engines = {"jax": jserving.GenerationEngine(
        jm, jserving.GenerationConfig(**cfg), name="jax-warm"),
        "port": GenerationEngine(pm, GenerationConfig(**cfg), device="cpu")}
    outs, warm = {}, {}
    for side, eng in engines.items():
        with eng:
            outs[side] = [eng.submit(p, max_new_tokens=n,
                                     return_logprobs=True).result(timeout=300)
                          for p, n in _warm_requests()]
            warm[side] = eng.stats()["kv_pages"]["warm"]
    for (jt, jl), (pt, pl) in zip(outs["jax"], outs["port"]):
        assert pt.tolist() == jt.tolist()
        np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-5)
    assert warm["port"] == warm["jax"]
    assert warm["port"]["admits"] >= 2 and warm["port"]["restores"] >= 2


def test_export_install_loopback_is_bit_identical():
    """Export a prompt's pages from one engine, install them into another
    (fp32 wire byte for byte, and the int8 wire), and the continuation is
    the uninterrupted engine's, from a prefix hit; a second install adopts
    nothing; an uncached prompt does not export."""
    _jm, pm = make_pair()

    def mk():
        return GenerationEngine(pm, GenerationConfig(**GEN_CFG),
                                device="cpu").start()

    src, dst, dst8, ref_eng = mk(), mk(), mk(), mk()
    try:
        prompt = np.random.default_rng(3).integers(0, 64, size=24)
        ref = ref_eng.submit(prompt, max_new_tokens=9).result(timeout=300)
        first = src.submit(prompt, max_new_tokens=1).result(timeout=300)
        t0 = int(first[24])
        assert t0 == ref[24]
        with pytest.raises(KeyError):
            src.export_kv_pages(np.arange(16, 32, dtype=np.int64))
        n, k_st, v_st = src.export_kv_pages(prompt)
        assert n == 3 and tuple(k_st[0].shape) == (3, 8, 4, 8)
        blob, manifest, meta = pkv.pack_kv_pages(k_st, v_st)
        assert meta["wire_bytes"] == meta["fp32_bytes"]
        k2, v2 = pkv.unpack_kv_pages(blob, manifest)
        for a, b in zip(k2 + v2, k_st + v_st):
            assert torch.equal(a, b)
        assert dst.install_kv_pages(prompt, k2, v2) == 3
        cont = dst.submit(np.append(prompt, t0),
                          max_new_tokens=8).result(timeout=300)
        assert cont.tolist() == ref.tolist()
        st = dst.stats()["kv_pages"]["prefix"]
        assert st["hits"] >= 1 and st["hit_tokens"] >= 24
        assert dst.metrics.counter("kv_installs") == 1
        assert src.metrics.counter("kv_exports") == 1
        assert dst.install_kv_pages(prompt, k2, v2) == 0
        dst._pool.allocator.check()
        # the int8 wire: a quarter of the bytes, a continuation that still
        # runs from a prefix hit
        blob8, man8, meta8 = pkv.pack_kv_pages(k_st, v_st, quantize=True)
        assert meta8["wire_bytes"] * 4 == meta["wire_bytes"]
        k8, v8 = pkv.unpack_kv_pages(blob8, man8)
        assert dst8.install_kv_pages(prompt, k8, v8) == 3
        cont8 = dst8.submit(np.append(prompt, t0),
                            max_new_tokens=8).result(timeout=300)
        assert len(cont8) == 33
        assert dst8.stats()["kv_pages"]["prefix"]["hit_tokens"] >= 24
        with pytest.raises(ValueError, match="shipped pages"):
            dst.install_kv_pages(prompt[:16], k2, v2)
    finally:
        for e in (src, dst, dst8, ref_eng):
            e.close()


def test_pages_exported_by_the_jax_engine_install_into_the_port():
    """The JAX engine's exported pages, shipped over the wire and
    installed into the port's engine, continue as the JAX engine does."""
    jm, pm = make_pair()
    prompt = np.random.default_rng(4).integers(0, 64, size=24)
    jeng = jserving.GenerationEngine(jm, jserving.GenerationConfig(**GEN_CFG),
                                     name="jax-export")
    with jeng:
        first = jeng.submit(prompt, max_new_tokens=1).result(timeout=300)
        t0 = int(first[24])
        n, k_st, v_st = jeng.export_kv_pages(prompt)
        jcont = jeng.submit(np.append(prompt, t0), max_new_tokens=8,
                            return_logprobs=True).result(timeout=300)
    blob, manifest, _meta = jkv.pack_kv_pages(k_st, v_st)
    k2, v2 = pkv.unpack_kv_pages(blob, manifest)
    peng = GenerationEngine(pm, GenerationConfig(**GEN_CFG), device="cpu")
    with peng:
        assert peng.install_kv_pages(prompt, k2, v2) == n == 3
        pcont = peng.submit(np.append(prompt, t0), max_new_tokens=8,
                            return_logprobs=True).result(timeout=300)
        assert peng.stats()["kv_pages"]["prefix"]["hit_tokens"] >= 24
    assert pcont[0].tolist() == jcont[0].tolist()
    np.testing.assert_allclose(pcont[1], jcont[1], rtol=1e-5, atol=1e-5)


def test_blocks_of_a_prompt_match_the_jax_trie_keys():
    p = np.arange(37) % 64
    assert token_blocks(p, 8) == jpaged.token_blocks(p, 8)
