"""The PyTorch/CUDA port's kernels against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against the JAX package's Pallas kernels run in interpret mode (and,
for paged attention and RMSNorm, its composed twin too) on the same numpy
inputs, forward and gradients. The
CUDA kernels are held against the plain versions by the tests marked
``gpu``, which skip without a card and live in ``test_torch_gpu.py``.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.kernels import flash_attention as jflash
from paddle_tpu.kernels.pallas import paged_attention as jpaged
from paddle_tpu.kernels.pallas import rmsnorm as jrms
from paddle_tpu.kernels.pallas import rope as jrope
from paddle_tpu_torch.kernels import (counters, flash_attention,
                                      flash_attention_with_lse,
                                      paged_attention, reset_counters,
                                      rms_norm, rms_norm_residual,
                                      rope_apply)

# the module (the package re-exports a function of the same name)
_FA = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
# fp32 on both sides; the two differ only in summation order
TOL = dict(rtol=1e-5, atol=1e-5)


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(kw or TOL))


def _paged_inputs(rng, nh, kvh, hd, PL, S=3, W=2, P=11, B=3):
    q = rng.standard_normal((S, W, nh, hd), dtype=np.float32)
    ka = rng.standard_normal((P, PL, kvh, hd), dtype=np.float32)
    va = rng.standard_normal((P, PL, kvh, hd), dtype=np.float32)
    tables = rng.integers(0, P, size=(S, B)).astype(np.int32)
    pos = np.array([[3, 4], [0, 1], [2 * PL, 2 * PL + 1]], np.int32)
    return q, ka, va, tables, pos


@pytest.mark.parametrize("impl", ["interpret", "composed"])
@pytest.mark.parametrize("nh,kvh,hd,PL", [(4, 4, 16, 4), (4, 2, 16, 4),
                                          (6, 2, 12, 5)])
def test_paged_attention_plain_matches_jax(nh, kvh, hd, PL, impl):
    """GQA ratios and non-divisible page/head shapes, against the Pallas
    kernel in interpret mode and the composed gather math."""
    rng = np.random.default_rng(6)
    q, ka, va, tables, pos = _paged_inputs(rng, nh, kvh, hd, PL)
    ref = jpaged.paged_attention(jnp.asarray(q), jnp.asarray(ka),
                                 jnp.asarray(va), jnp.asarray(tables),
                                 jnp.asarray(pos), impl=impl)
    reset_counters()
    got = paged_attention(*map(torch.from_numpy, (q, ka, va, tables, pos)))
    _close(got, ref)
    assert counters()["paged_attention"] == {"launches": 0,
                                             "plain_calls": 1}


def test_paged_attention_masks_by_position():
    """A key past pos is invisible: growing pos by one token changes the
    row, and pos = 3 with 4-token pages equals dense attention over the
    first page alone. Held against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(8)
    nh, hd, P, PL = 2, 8, 6, 4
    q = rng.standard_normal((1, 1, nh, hd), dtype=np.float32)
    ka = rng.standard_normal((P, PL, nh, hd), dtype=np.float32)
    va = rng.standard_normal((P, PL, nh, hd), dtype=np.float32)
    tables = np.array([[2, 3]], np.int32)
    outs = []
    for p in (3, 4):
        pos = np.array([[p]], np.int32)
        ref = jpaged.paged_attention(jnp.asarray(q), jnp.asarray(ka),
                                     jnp.asarray(va), jnp.asarray(tables),
                                     jnp.asarray(pos), impl="interpret")
        got = paged_attention(*map(torch.from_numpy,
                                   (q, ka, va, tables, pos)))
        _close(got, ref)
        outs.append(got.numpy())
    assert not np.allclose(outs[0], outs[1])
    logits = np.einsum("hd,Lhd->hL", q[0, 0], ka[2]) / np.sqrt(hd)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    _close(outs[0][0, 0], np.einsum("hL,Lhd->hd", probs, va[2]))


@pytest.mark.parametrize("sq,sk,offset,causal", [
    (16, 24, 8, True),     # bottom-right aligned self-attention
    (16, 32, 4, True),     # a ring-attention chunk: offset != sk - sq
    (16, 16, -4, True),    # the first rows see no key at all
    (8, 16, 0, False),
])
def test_flash_attention_plain_matches_jax(sq, sk, offset, causal):
    """o and lse against the Pallas forward kernel in interpret mode."""
    rng = np.random.default_rng(7)
    bh, d = 3, 16
    q = rng.standard_normal((bh, sq, d), dtype=np.float32)
    k = rng.standard_normal((bh, sk, d), dtype=np.float32)
    v = rng.standard_normal((bh, sk, d), dtype=np.float32)
    jo, jl = jflash.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), offset, causal, 0.3,
        8, 8)
    o, lse = flash_attention_with_lse(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), offset, causal,
                                      0.3)
    _close(o, jo)
    _close(lse, jl)
    if offset < 0:  # fully masked rows give 0, not mean(V)
        assert not np.asarray(o)[:, :-offset].any()


@pytest.mark.parametrize("sq,grad", [(8, False), (1, False), (1, True)])
def test_flash_attention_paddle_layout_matches_jax(sq, grad):
    """[b, s, h, d] wrapper with a KV cache longer than the queries, against
    the JAX ``flash_attention`` (fp32, 1e-5). A single row that needs no
    gradient takes the decode route on [b, s, h, d] views (q a view into a
    fused QKV tensor, read in place), counted on ``flash_attention_decode``;
    with gradients it keeps the ``_FlashAttention`` path, counted on
    ``flash_attention``, and its q, k, v gradients match jax.vjp within
    1e-4."""
    rng = np.random.default_rng(8)
    qkv = rng.standard_normal((2, sq, 3, 3, 16), dtype=np.float32)
    k = rng.standard_normal((2, 24, 3, 16), dtype=np.float32)
    v = rng.standard_normal((2, 24, 3, 16), dtype=np.float32)
    q = qkv[:, :, 0]
    go = rng.standard_normal(q.shape, dtype=np.float32)

    def jfn(a, c, e):
        return jflash.flash_attention(a, c, e, causal=True, block_q=8,
                                      block_k=8)

    ref, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    reset_counters()
    if grad:
        (got,), grads = _grads(lambda a, c, e: flash_attention(
            a, c, e, causal=True), (q, k, v), (go,))
        for g, r in zip(grads, vjp(jnp.asarray(go))):
            _close(g, r, rtol=1e-4, atol=1e-4)
    else:
        tq = torch.from_numpy(qkv)[:, :, 0]
        assert sq > 1 or _FA._in_place(tq) is tq
        with torch.no_grad():
            got = flash_attention(tq, *map(torch.from_numpy, (k, v)),
                                  causal=True)
    _close(got, ref)
    c = counters()
    decode = sq == 1 and not grad
    assert c["flash_attention_decode"] == {"launches": 0,
                                           "plain_calls": int(decode)}
    assert c["flash_attention"] == {"launches": 0,
                                    "plain_calls": int(not decode)}


def _decode_plans(bh, n):
    """The split plans the decode kernel would use for ``bh`` rows seeing
    ``n`` keys (on an H100 and on cards of 8 and 1000 SMs), and the first
    of them with three more splits, which start past the last visible key
    and own none."""
    plans = {_FA.decode_plan(bh, n, sms) for sms in (132, 8, 1000)}
    n_split, split_len = _FA.decode_plan(bh, n, 132)
    return sorted(plans) + [(n_split + 3, split_len)]


@pytest.mark.parametrize("sk,offset,causal", [
    (sk, off, True) for sk in (1, 7, 300, 1000)
    for off in sorted({sk - 1, sk // 2, -1})] + [
    (sk, 0, False) for sk in (1, 7, 300, 1000)])
def test_flash_decode_plain_matches_jax(sk, offset, causal):
    """The decode kernel's plain version (split plan, partials in log2
    units, fixed-order merge) at one query row against the JAX
    ``flash_attention_with_lse`` (Pallas interpret mode), o and lse within
    1e-5, for every split plan of ``_decode_plans``: causal offsets at the
    end of the cache, half way and below 0 (o = 0 and lse = -1e30
    exactly), and no mask."""
    rng = np.random.default_rng(25)
    b, h, d, scale = 2, 3, 16, 0.3
    q = rng.standard_normal((b, 1, h, d), dtype=np.float32)
    k = rng.standard_normal((b, sk, h, d), dtype=np.float32)
    v = rng.standard_normal((b, sk, h, d), dtype=np.float32)

    def bhsd(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * h, -1, d))

    jo, jl = jflash.flash_attention_with_lse(bhsd(q), bhsd(k), bhsd(v),
                                             offset, causal, scale)
    jo = np.asarray(jo).reshape(b, h, 1, d).transpose(0, 2, 1, 3)
    jl = np.asarray(jl).reshape(b, h)
    n = _FA._visible_keys(sk, offset, causal)
    for n_split, split_len in _decode_plans(b * h, n):
        o, lse = _FA.flash_decode_plain(
            *map(torch.from_numpy, (q, k, v)), offset, causal, scale,
            n_split=n_split, split_len=split_len)
        _close(o, jo)
        _close(lse, jl)
        if n == 0:
            assert not o.any() and bool((lse == -1e30).all())


def test_flash_decode_runs_on_every_call():
    """Two calls on the same tensors are two runs (two plain calls here, two
    launches on the card), and the second sees the cache as it is then: a
    memoized wrapper would hand back the first result."""
    rng = np.random.default_rng(26)
    q = torch.from_numpy(rng.standard_normal((1, 1, 2, 16), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 5, 2, 16), np.float32))
    reset_counters()
    o1, _ = _FA.flash_decode(q, k, k, 4, True, 0.25)
    k.mul_(2.0)
    o2, _ = _FA.flash_decode(q, k, k, 4, True, 0.25)
    assert counters()["flash_attention_decode"]["plain_calls"] == 2
    ref, _ = _FA.flash_decode_plain(q, k, k, 4, True, 0.25)
    assert not torch.equal(o1, o2) and torch.equal(o2, ref)


@pytest.mark.parametrize("sq,sk", [(6, 4), (9, 3), (4, 4), (3, 8)])
def test_causal_sdpa_matches_jax_when_queries_outnumber_keys(sq, sk):
    """``scaled_dot_product_attention(is_causal=True)`` against the JAX
    package's, forward within 1e-5 and the q, k, v gradients against
    jax.vjp within 1e-4: with sq > sk the first sq - sk rows see no key and
    both give mean(V) (the JAX softmax of an all-masked row is uniform);
    sq <= sk is the control. The flash kernels keep o = 0 on such rows
    (``test_flash_attention_plain_matches_jax``, offset < 0)."""
    from paddle_tpu.nn.functional.attention import (
        scaled_dot_product_attention as jsdpa)
    from paddle_tpu_torch.nn.functional import scaled_dot_product_attention

    rng = np.random.default_rng(13)
    b, h, d = 2, 3, 8
    q = rng.standard_normal((b, sq, h, d), dtype=np.float32)
    k = rng.standard_normal((b, sk, h, d), dtype=np.float32)
    v = rng.standard_normal((b, sk, h, d), dtype=np.float32)
    go = rng.standard_normal((b, sq, h, d), dtype=np.float32)
    jo, vjp = jax.vjp(lambda a, c, e: jsdpa(a, c, e, is_causal=True).data,
                      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(go))
    (o,), grads = _grads(lambda a, c, e: scaled_dot_product_attention(
        a, c, e, is_causal=True), (q, k, v), (go,))
    _close(o, jo)
    for got, ref in zip(grads, jgrads):
        _close(got, ref, rtol=1e-4, atol=1e-4)
    if sq > sk:
        _close(o[:, :sq - sk], np.broadcast_to(v.mean(axis=1, keepdims=True),
                                               (b, sq - sk, h, d)))
        assert not grads[0][:, :sq - sk].any()


def test_wrappers_reject_bad_inputs():
    q = torch.zeros(1, 1, 4, 8)
    ka = torch.zeros(2, 4, 3, 8)
    with pytest.raises(ValueError, match="do not fit"):
        paged_attention(q, ka, ka, torch.zeros(1, 1, dtype=torch.int32),
                        torch.zeros(1, 1, dtype=torch.int32))
    with pytest.raises(TypeError, match="share a dtype"):
        flash_attention_with_lse(torch.zeros(1, 2, 8),
                                 torch.zeros(1, 2, 8, dtype=torch.float64),
                                 torch.zeros(1, 2, 8, dtype=torch.float64))


def _grads(fn, inputs, cotangents):
    """Outputs of ``fn`` on leaf copies of ``inputs`` and the gradients of
    sum(out * cotangent) with respect to each input."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cotangents])
    return ([o.detach().numpy() for o in outs],
            [t.grad.numpy() for t in leaves])


@pytest.mark.parametrize("sq,sk,offset,causal", [
    (16, 16, 0, True),     # self-attention, two 8-row blocks each way
    (16, 24, 8, True),     # sq != sk, bottom-right aligned
    (24, 32, 3, True),     # offset > 0 that is not sk - sq
    (16, 16, -4, True),    # the first rows see no key: zero gradients
    (8, 24, 0, False),
])
def test_flash_attention_backward_matches_jax(sq, sk, offset, causal):
    """dq, dk, dv of a loss that reads both o and lse, against jax.vjp of
    the Pallas kernels in interpret mode (8-row blocks, so the backward
    grids take several steps)."""
    rng = np.random.default_rng(11)
    bh, d, scale = 2, 16, 0.3
    q = rng.standard_normal((bh, sq, d), dtype=np.float32)
    k = rng.standard_normal((bh, sk, d), dtype=np.float32)
    v = rng.standard_normal((bh, sk, d), dtype=np.float32)
    go = rng.standard_normal((bh, sq, d), dtype=np.float32)
    gl = rng.standard_normal((bh, sq), dtype=np.float32)
    (jo, jl), vjp = jax.vjp(
        lambda a, b, c: jflash.flash_attention_with_lse(
            a, b, c, offset, causal, scale, 8, 8), q, k, v)
    jgrads = vjp((jnp.asarray(go), jnp.asarray(gl)))
    reset_counters()
    (o, lse), grads = _grads(
        lambda a, b, c: flash_attention_with_lse(a, b, c, offset, causal,
                                                 scale), (q, k, v), (go, gl))
    _close(o, jo)
    _close(lse, jl)
    for got, ref in zip(grads, jgrads):
        _close(got, ref, rtol=1e-4, atol=1e-4)  # fp32, longer sums
    c = counters()
    assert c["flash_attention_bwd_dkv"] == {"launches": 0, "plain_calls": 1}
    assert c["flash_attention_bwd_dq"] == {"launches": 0, "plain_calls": 1}
    if offset < 0:  # rows that see no key get exactly zero dq
        assert not grads[0][:, :-offset].any()


def _sm90_emulated(q, k, v, do, delta, offset, causal, scale, drop_tile):
    """The tensor-core kernels' arithmetic in PyTorch on bf16-valued fp32
    tensors: products summed in fp32; P rounded to bf16 before P.V (the row
    sum adds the fp32 p) and before dV; dS rounded to bf16 before dK and
    dQ; outputs rounded to bf16. ``drop_tile`` plants a fault: the last
    tile of 128 keys is left out, as if its loop turn were skipped."""

    def bf16(t):
        return t.to(torch.bfloat16).float()

    sk = k.shape[1]
    mask = _FA._mask(q.shape[1], sk, offset, causal, q.device)
    if drop_tile:
        mask[:, (sk - 1) // 128 * 128:] = False
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    sm = torch.where(mask, s, -1e30)
    m = sm.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(sm - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = bf16(torch.einsum("bqk,bkd->bqd", bf16(p), v) / l)
    lse = (m + torch.log(l))[..., 0]
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dv = bf16(torch.einsum("bqk,bqd->bkd", bf16(p), do))
    ds = p * (torch.einsum("bqd,bkd->bqk", do, v) - delta[..., None]) * scale
    dk = bf16(torch.einsum("bqk,bqd->bkd", bf16(ds), q))
    dq = bf16(torch.einsum("bqk,bkd->bqd", bf16(ds), k))
    return {"o": o, "lse": lse, "dk": dk, "dv": dv, "dq": dq}


@pytest.mark.parametrize("out", ["o", "dk", "dv", "dq"])
def test_sm90_bounds_hold_for_the_kernels_roundings(out):
    """The elementwise bounds that the card tests and chip_smoke.py hold
    the tensor-core kernels to (``sm90_fwd_bound`` for o, ``sm90_dkv_bound``
    for dK and dV, ``sm90_dq_bound`` for dQ): an emulation of their bf16
    roundings stays within them against the fp32 plain versions at bh 2,
    s 512, d 128, causal, filling a fair part of them; the same emulation
    without its last key tile exceeds them."""
    rng = np.random.default_rng(21)
    bh, s, d, scale = 2, 512, 128, 128 ** -0.5
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (bh, s, d), dtype=np.float32)).to(torch.bfloat16).float()
        for _ in range(4))
    ro, rl = _FA.flash_attention_plain(q, k, v, 0, True, scale)
    delta = (do * ro).sum(-1)
    args = (rl, delta, 0, True, scale)
    if out == "o":
        ref = ro
        bound = _FA.sm90_fwd_bound(q, k, v, 0, True, scale, ro)
    elif out == "dq":
        ref = _FA.flash_attention_bwd_dq_plain(q, k, v, do, *args)
        bound = _FA.sm90_dq_bound(q, k, v, do, *args, ref)
    else:
        rdk, rdv = _FA.flash_attention_bwd_dkv_plain(q, k, v, do, *args)
        ref = rdk if out == "dk" else rdv
        bound = _FA.sm90_dkv_bound(q, k, v, do, *args, rdk, rdv)[
            0 if out == "dk" else 1]

    def excess(got):
        return ((got - ref).abs() - bound).max().item()

    sound = _sm90_emulated(q, k, v, do, delta, 0, True, scale, False)
    assert excess(sound[out]) <= 0
    _close(sound["lse"], rl, rtol=0.0, atol=1e-3)
    # the bound is not loose: the roundings' own error fills a fair part
    assert (sound[out] - ref).abs().max().item() > \
        0.05 * (bound - 1e-4).max().item()
    fault = _sm90_emulated(q, k, v, do, delta, 0, True, scale, True)
    assert excess(fault[out]) > 0


@pytest.mark.parametrize("dtype,d,sq,want", [
    (torch.bfloat16, 128, 2048, True), (torch.bfloat16, 64, 2, True),
    (torch.bfloat16, 128, 1, False), (torch.bfloat16, 128, None, True),
    (torch.bfloat16, 32, 64, True), (torch.bfloat16, 256, 64, True),
    (torch.float32, 128, 64, False), (torch.float32, 64, None, False),
    (torch.bfloat16, 64, None, True), (torch.bfloat16, 32, None, True),
    (torch.bfloat16, 256, None, True), (torch.float32, 128, None, False),
    (torch.bfloat16, 264, None, False), (torch.bfloat16, 136, 2, True)])
def test_sm90_kernels_take_bf16_head_dim_64_128(dtype, d, sq, want,
                                                monkeypatch):
    """The wrappers' choice of kernel on CUDA, in plain code: bf16 with a
    head dim that is a multiple of 8 up to 256 (and, for the forward, more
    than one row) goes to the tensor-core forward, dK/dV and dQ kernels;
    fp32 dK/dV and dQ at head dims up to 128 to the 3xTF32 kernels, the
    rest to the CUDA-core ones. For
    the backward (``sq`` None) the dK/dV and dQ dispatchers are driven on
    meta tensors (neither CPU nor CUDA) with every kernel's wrapper
    replaced by a recorder, so the choice itself is what runs."""
    assert _FA.takes_sm90(dtype, d, sq) is want
    if sq is not None:
        return
    took = []
    for name, routes in (
            ("flash_attention_bwd_dkv", ("sm90", "tf32x3", "cuda_core")),
            ("flash_attention_bwd_dq", ("sm90", "tf32x3", "cuda_core"))):
        for route in routes:
            monkeypatch.setattr(
                _FA, f"{name}_{route}",
                lambda *a, n=name, r=route: took.append((n, r)))
    q = torch.empty(2, 16, d, dtype=dtype, device="meta")
    stats = torch.empty(2, 16, device="meta")
    args = (q, q, q, q, stats, stats, 0, True, 0.1)
    _FA.flash_attention_bwd_dkv(*args)
    _FA.flash_attention_bwd_dq(*args)
    fp32 = dtype == torch.float32
    dkv = dq = "tf32x3" if fp32 else "sm90" if want else "cuda_core"
    # bf16 dQ on the tensor cores at every multiple of 8 from 8 to 256
    assert (dq == "sm90") is (dtype == torch.bfloat16 and d % 8 == 0
                              and 8 <= d <= 256)
    assert took == [("flash_attention_bwd_dkv", dkv),
                    ("flash_attention_bwd_dq", dq)]


@pytest.mark.parametrize("dtype,d,sq,want", [
    (torch.bfloat16, 128, 1, "decode"), (torch.float32, 128, 1, "decode"),
    (torch.bfloat16, 64, 1, "decode"), (torch.bfloat16, 256, 1, "decode"),
    (torch.float32, 256, 1, "decode"), (torch.bfloat16, 8, 1, "decode"),
    (torch.float32, 4, 1, "decode"), (torch.bfloat16, 12, 1, "cuda_core"),
    (torch.float32, 6, 1, "cuda_core"), (torch.bfloat16, 264, 1, "cuda_core"),
    (torch.float16, 128, 1, "cuda_core"), (torch.bfloat16, 128, 2, "sm90"),
    (torch.bfloat16, 64, 300, "sm90"), (torch.float32, 128, 2, "tf32x3"),
    (torch.bfloat16, 32, 64, "sm90"), (torch.bfloat16, 256, 2048, "sm90"),
    (torch.bfloat16, 136, 2, "sm90"), (torch.float32, 256, 64,
                                       "cuda_core")])
def test_forward_route_picks_by_dtype_head_dim_and_rows(dtype, d, sq, want,
                                                        monkeypatch):
    """``route`` in plain code: one query row in fp32 or bf16 whose head
    dim (up to 256) is whole 16-byte chunks goes to the decode kernel, bf16
    at a head dim that is a multiple of 8 up to 256 with more rows to the
    tensor-core kernel, fp32 at such head dims up to 128 with more rows to
    the 3xTF32 kernel, the rest to the CUDA-core one. ``flash_attention_fwd``
    is driven on meta tensors (neither CPU nor CUDA) with the four kernels'
    wrappers replaced by recorders, so the choice itself is what runs."""
    assert _FA.route(dtype, d, sq) == want
    took = []

    def recorder(name):
        def rec(q, *_args):
            took.append(name)
            return (torch.empty(q.shape[0], 1, 1, d, device="meta"),
                    torch.empty(q.shape[0], 1, device="meta"))
        return rec

    for name in ("flash_decode", "flash_attention_fwd_sm90",
                 "flash_attention_fwd_tf32x3",
                 "flash_attention_fwd_cuda_core"):
        monkeypatch.setattr(_FA, name, recorder(name))
    q = torch.empty(2, sq, d, dtype=dtype, device="meta")
    k = torch.empty(2, 40, d, dtype=dtype, device="meta")
    _FA.flash_attention_fwd(q, k, k, 39, True, 0.1)
    assert took == [{"decode": "flash_decode",
                     "sm90": "flash_attention_fwd_sm90",
                     "tf32x3": "flash_attention_fwd_tf32x3",
                     "cuda_core": "flash_attention_fwd_cuda_core"}[want]]


@pytest.mark.parametrize("dtype,d,device,error,match", [
    (torch.float32, 128, "cpu", ValueError, "bfloat16"),
    (torch.bfloat16, 36, "cpu", ValueError, "head_dim"),
    (torch.float16, 128, "cpu", TypeError, "float32 or bfloat16"),
    (torch.bfloat16, 128, "cpu", ValueError, "CUDA tensors"),
    (torch.bfloat16, 64, "meta", ValueError, "CUDA tensors")])
def test_sm90_dq_wrapper_rejects_what_its_kernel_does_not_take(
        dtype, d, device, error, match):
    """The tensor-core dQ wrapper raises, before any build or launch, on
    inputs its kernel does not take (not bf16, a head dim that is not a
    multiple of 8 up to 128) and on tensors off the card; it never falls
    back."""
    q = torch.zeros(2, 8, d, dtype=dtype, device=device)
    stats = torch.zeros(2, 8, device=device)
    reset_counters()
    with pytest.raises(error, match=match):
        _FA.flash_attention_bwd_dq_sm90(q, q, q, q, stats, stats, 0, True,
                                        0.1)
    assert counters()["flash_attention_bwd_dq_sm90"] == {"launches": 0,
                                                         "plain_calls": 0}


@pytest.mark.parametrize("impl", ["interpret", "composed"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("shape", [(3, 5, 40), (7, 129)])
def test_rms_norm_matches_jax(shape, residual, impl):
    """Forward outputs and every gradient (x, res, w, and through s's own
    cotangent) against the Pallas kernels in interpret mode and the
    composed twin; odd widths and row counts."""
    rng = np.random.default_rng(12)
    h, eps = shape[-1], 1e-5
    x = rng.standard_normal(shape, dtype=np.float32)
    res = rng.standard_normal(shape, dtype=np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    gy = rng.standard_normal(shape, dtype=np.float32)
    gs = rng.standard_normal(shape, dtype=np.float32)
    reset_counters()
    if residual:
        jout, vjp = jax.vjp(lambda a, b, c: jrms.rms_norm_residual(
            a, b, c, eps, impl=impl), x, res, w)
        jgrads = vjp((jnp.asarray(gy), jnp.asarray(gs)))
        outs, grads = _grads(lambda a, b, c: rms_norm_residual(a, b, c, eps),
                             (x, res, w), (gy, gs))
        name = "rms_norm_residual"
    else:
        jout, vjp = jax.vjp(lambda a, c: jrms.rms_norm(a, c, eps, impl=impl),
                            x, w)
        jgrads = vjp(jnp.asarray(gy))
        jout = (jout,)
        outs, grads = _grads(lambda a, c: rms_norm(a, c, eps), (x, w), (gy,))
        name = "rms_norm"
    for got, ref in zip(outs, jout):
        _close(got, ref)
    for got, ref in zip(grads, jgrads):
        _close(got, ref, rtol=1e-4, atol=1e-4)  # dw sums over rows
    c = counters()
    assert c[name] == {"launches": 0, "plain_calls": 1}
    assert c[name + "_bwd"] == {"launches": 0, "plain_calls": 1}


def _rms_bwd_emulated(s, w, rstd, dy, dr, sms):
    """The RMSNorm backward kernels' plan in PyTorch: dx row by row;
    ``rms_norm_bwd_plan``'s blocks each sum dy * s * rstd over their rows
    into one partial row (the vector instances: each of BWD_WARPS warps
    over every BWD_WARPS-th row, then the warps in order; the scalar one:
    the rows in order), and the column sum adds the partial rows in
    BWD_COL_GROUPS groups (group g: rows g, g + BWD_COL_GROUPS, ...),
    then the groups in order."""
    from paddle_tpu_torch.kernels import rmsnorm as rm

    n, h = s.shape
    blocks, rows, inst = rm.rms_norm_bwd_plan(n, h, s.element_size(), sms)
    sf, dyf, r = s.float(), dy.float(), rstd[:, None]
    g = dyf * w.float()
    ds = r * (g - sf * (r * r) * (g * sf).mean(dim=-1, keepdim=True))
    if dr is not None:
        ds = ds + dr.float()
    contrib = dyf * sf * r
    part = torch.zeros(blocks, h)
    for b in range(blocks):
        r0, r1 = b * rows, min(n, (b + 1) * rows)
        if inst == "scalar":
            for row in range(r0, r1):
                part[b] += contrib[row]
            continue
        for wp in range(rm.BWD_WARPS):
            acc = torch.zeros(h)
            for row in range(r0 + wp, r1, rm.BWD_WARPS):
                acc += contrib[row]
            part[b] += acc
    groups = torch.zeros(rm.BWD_COL_GROUPS, h)
    for b in range(blocks):
        groups[b % rm.BWD_COL_GROUPS] += part[b]
    dw = groups[0]
    for q in range(1, rm.BWD_COL_GROUPS):
        dw = dw + groups[q]
    return ds.to(s.dtype), dw.to(w.dtype)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("n,h,sms", [
    (7, 129, 132),    # not whole vectors (scalar), fewer rows than blocks
    (1, 40, 132),     # one row
    (65, 64, 4),      # 8 blocks of 9 rows, the last of 2
    (33, 16, 2),      # 4 blocks of 9, the last of 6
    (300, 2304, 2)])  # the looping instance, 4 blocks of 75
def test_rms_norm_bwd_plan_emulation_matches_jax(n, h, sms, residual):
    """dx and dw of the backward kernels' plan, emulated in PyTorch on the
    port's forward (s, rstd), against ``jax.vjp`` of the JAX package's
    ``rms_norm`` / ``rms_norm_residual`` (composed), within the gradient
    tolerances of ``test_rms_norm_matches_jax``."""
    from paddle_tpu_torch.kernels import rmsnorm as rm

    rng = np.random.default_rng(n + h)
    eps = 1e-5
    x = rng.standard_normal((n, h), dtype=np.float32)
    res = rng.standard_normal((n, h), dtype=np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    gy = rng.standard_normal((n, h), dtype=np.float32)
    gs = rng.standard_normal((n, h), dtype=np.float32)
    if residual:
        _o, vjp = jax.vjp(lambda a, b, c: jrms.rms_norm_residual(
            a, b, c, eps, impl="composed"), x, res, w)
        jdx, _jdres, jdw = vjp((jnp.asarray(gy), jnp.asarray(gs)))
    else:
        _o, vjp = jax.vjp(lambda a, c: jrms.rms_norm(a, c, eps,
                                                     impl="composed"), x, w)
        jdx, jdw = vjp(jnp.asarray(gy))
    _y, s, rstd = rm.rms_norm_fwd_plain(
        torch.from_numpy(x), torch.from_numpy(res) if residual else None,
        torch.from_numpy(w), eps)
    dx, dw = _rms_bwd_emulated(s, torch.from_numpy(w), rstd,
                               torch.from_numpy(gy),
                               torch.from_numpy(gs) if residual else None,
                               sms)
    _close(dx, jdx, rtol=1e-4, atol=1e-4)
    _close(dw, jdw, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,h,itemsize,aligned,plan", [
    (1, 2048, 2, True, (1, 1, "vector")),          # one row
    (0, 2048, 2, True, (1, 0, "vector")),          # none: a zero dw row
    (100, 2048, 2, True, (100, 1, "vector")),      # fewer rows than blocks
    (8192, 2048, 2, True, (264, 32, "vector")),    # the dense step
    (8192, 1536, 2, True, (264, 32, "vector")),    # the MoE step
    (6401, 2048, 2, True, (264, 25, "vector")),    # the last block one row
    (8192, 2048, 4, True, (264, 32, "looping")),   # fp32: 16 vectors a lane
    (33, 1001, 2, True, (33, 1, "scalar")),        # not whole vectors
    (3, 16384, 2, True, (3, 1, "scalar")),         # wider than BWD_WIDEST
    (65, 2048, 2, False, (65, 1, "scalar"))])      # off a 16-byte boundary
def test_rms_norm_bwd_plan(n, h, itemsize, aligned, plan):
    """``rms_norm_bwd_plan`` at 132 SMs: 2 blocks a SM, at most one a row
    and at least one; the instance by width, item size and alignment."""
    from paddle_tpu_torch.kernels.rmsnorm import rms_norm_bwd_plan

    assert rms_norm_bwd_plan(n, h, itemsize, 132, aligned) == plan


@pytest.mark.parametrize("pos_offset,theta", [(0, 10000.0), (37, 10000.0),
                                              (5, 500000.0)])
def test_rope_matches_jax(pos_offset, theta):
    """Forward and gradient (the inverse rotation of the cotangent) against
    the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 10, 3, 16), dtype=np.float32)
    g = rng.standard_normal(x.shape, dtype=np.float32)
    jout, vjp = jax.vjp(lambda a: jrope.rope_apply(
        a, theta, pos_offset, impl="interpret"), x)
    (jgrad,) = vjp(jnp.asarray(g))
    reset_counters()
    (out,), (grad,) = _grads(lambda a: rope_apply(a, theta, pos_offset),
                             (x,), (g,))
    _close(out, jout)
    _close(grad, jgrad)
    c = counters()
    assert c["rope"] == {"launches": 0, "plain_calls": 1}
    assert c["rope_inverse"] == {"launches": 0, "plain_calls": 1}
    with pytest.raises(ValueError, match="even"):
        rope_apply(torch.zeros(1, 2, 1, 3))


def test_rope_grad_on_the_attention_layout_matches_jax(monkeypatch):
    """The cotangent reaches RoPE's backward as the attention wrapper
    leaves it: a [b, s, h, d] view of a [b, h, s, d] tensor, not
    contiguous. The gradient, read through those strides, against
    ``jax.vjp`` of the Pallas kernel in interpret mode (1e-5)."""
    rope_mod = importlib.import_module("paddle_tpu_torch.kernels.rope")
    rng = np.random.default_rng(22)
    b, s, h, d = 2, 10, 3, 16
    x = rng.standard_normal((b, s, h, d), dtype=np.float32)
    g_bhsd = rng.standard_normal((b * h, s, d), dtype=np.float32)
    _jout, vjp = jax.vjp(lambda a: jrope.rope_apply(
        a, 1e4, 7, impl="interpret"), x)
    (jgrad,) = vjp(jnp.asarray(
        g_bhsd.reshape(b, h, s, d).transpose(0, 2, 1, 3)))
    seen = []
    real = rope_mod.rope

    def recording(t, theta, pos_offset, inverse):
        if inverse:
            seen.append((t.is_contiguous(), t.stride()))
        return real(t, theta, pos_offset, inverse)

    monkeypatch.setattr(rope_mod, "rope", recording)
    xt = torch.from_numpy(x).requires_grad_()
    # the flash wrapper's bhsd: [b, s, h, d] -> [b * h, s, d]
    y = rope_apply(xt, 1e4, 7).transpose(1, 2).reshape(b * h, s, d)
    y.backward(torch.from_numpy(g_bhsd))
    assert seen == [(False, (s * h * d, d, s * d, 1))]
    _close(xt.grad, jgrad)


@pytest.mark.parametrize("shape,strides,itemsize,ptr,plan", [
    # the training step's q/k and its cotangent's [b, s, h, d] view of
    # [b, h, s, d], bf16 and fp32
    ((4, 2048, 16, 128), (4194304, 2048, 128, 1), 2, 0, "vector"),
    ((4, 2048, 16, 128), (4194304, 128, 262144, 1), 2, 0, "vector"),
    ((4, 2048, 16, 128), (4194304, 128, 262144, 1), 4, 64, "vector"),
    # head dim 16 (one vector a half in bf16) and 6 (not whole vectors)
    ((2, 9, 3, 16), (432, 16, 144, 1), 2, 0, "vector"),
    ((2, 7, 3, 6), (126, 18, 6, 1), 2, 0, "scalar"),
    ((2, 7, 3, 6), (126, 18, 6, 1), 4, 0, "scalar"),
    # a start one element off a 16-byte boundary, a head stride off one
    ((3, 17, 5, 128), (10880, 640, 128, 1), 2, 2, "scalar"),
    ((2, 3, 4, 128), (1584, 528, 132, 1), 2, 0, "scalar"),
    # dims of length 1 have any stride
    ((1, 8, 1, 128), (5, 128, 3, 1), 2, 16, "vector"),
    # d not contiguous: copied first
    ((2, 3, 4, 8), (96, 32, 1, 4), 4, 0, "copy")])
def test_rope_plan_picks_the_instance(shape, strides, itemsize, ptr, plan):
    """``rope_plan``: the vector instance for 16-byte rows on 16-byte
    boundaries, the scalar one for the rest with d contiguous, a copy only
    when d is not."""
    from paddle_tpu_torch.kernels.rope import rope_plan

    assert rope_plan(shape, strides, itemsize, ptr) == plan
