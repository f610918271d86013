"""The port's context parallelism (``paddle_tpu_torch.distributed.
context_parallel``) against the JAX package.

The ring and Ulysses at cp 4 run in a gloo world of 4 spawned CPU processes
(``torch_dist_worker``; one spawn for the module), each rank its sequence
chunk; the same per-rank body also runs all 4 chunks in one process
(``ring_attention_local``), as ``chip_smoke.py`` drives it on one card.
The oracle is the JAX ring / Ulysses over a cp 4 mesh on
``jax.devices()[:4]`` and its gradients, as
``tests/test_flash_ring.py::TestRingAttention::test_parity_and_grads_cp4``
runs them. Tolerances are that test's against the dense reference:
outputs ``rtol 2e-4, atol 2e-5``, gradients ``rtol 2e-3, atol 2e-4``
(fp32; the port's plain flash versions on the CPU, merged in another
order).
"""
import numpy as np
import pytest
import torch

import torch_dist_worker as W

pytestmark = pytest.mark.dist

CP = W.WORLD
O_TOL = dict(rtol=2e-4, atol=2e-5)
G_TOL = dict(rtol=2e-3, atol=2e-4)


def _inputs():
    rng = np.random.RandomState(0)
    ring = {n: rng.randn(4, 128, 64).astype(np.float32) for n in "qkv"}
    rng = np.random.RandomState(1)
    uly = {n: rng.randn(2, 64, 4, 32).astype(np.float32) for n in "qkv"}
    return {"ring": ring, "ulysses": uly}


def _jax_oracle(impl, c, causal=True):
    """(o, dq, dk, dv) of the JAX ring / Ulysses at cp 4 for sum(o ** 2)."""
    import jax
    import jax.numpy as jnp

    import paddle_tpu.distributed as jdist
    from paddle_tpu.distributed.context_parallel import (
        ring_attention_bhsd, ulysses_attention_bshd)

    jdist.reset_mesh()
    env = jdist.init_mesh(cp=CP, devices=jax.devices()[:CP])
    fn = ring_attention_bhsd if impl == "ring" else ulysses_attention_bshd
    q, k, v = (jnp.asarray(c[n]) for n in "qkv")

    def f(a, b, d):
        return fn(a, b, d, causal=causal, env=env)

    o = jax.jit(f)(q, k, v)
    grads = jax.jit(jax.grad(lambda a, b, d: jnp.sum(f(a, b, d) ** 2),
                             (0, 1, 2)))(q, k, v)
    jdist.reset_mesh()
    return [np.asarray(t) for t in (o, *grads)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inputs = _inputs()
    outs = W.run(tmp_path_factory.mktemp("cp"), "context_parallel", inputs)
    return inputs, outs


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_cp4_across_processes_matches_jax(world, impl):
    inputs, outs = world
    ref = _jax_oracle(impl, inputs[impl])
    for name, want in zip(("o", "dq", "dk", "dv"), ref):
        got = np.concatenate([outs[r][impl][name] for r in range(CP)], axis=1)
        np.testing.assert_allclose(got, want, **(O_TOL if name == "o"
                                                 else G_TOL), err_msg=name)


def test_ring_keeps_no_chunk_but_its_own(world):
    """Each rank's ring saves its q, own k and v, o (fp32 inputs) and the
    fp32 lse: bytes of 4 chunks [4, 32, 64] plus [4, 32], no K/V chunk of
    another rank."""
    _, outs = world
    chunk = 4 * (128 // CP) * 64 * 4
    for r in range(CP):
        assert outs[r]["ring"]["saved_bytes"] == 4 * chunk + 4 * 32 * 4


@pytest.mark.parametrize("causal", [True, False])
def test_local_ring_matches_jax(causal):
    """All 4 ranks' bodies in lock step in one process: the same numbers
    as the JAX ring, and every ring step's kernels called (cp^2 forward,
    dK/dV and dQ calls, here their plain versions)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.distributed import ring_attention_local

    c = _inputs()["ring"]
    ref = _jax_oracle("ring", c, causal)
    qs, ks, vs = ([t.contiguous().requires_grad_(True) for t in
                   torch.from_numpy(c[n]).chunk(CP, dim=1)] for n in "qkv")
    kernels.reset_counters()
    outs = ring_attention_local(qs, ks, vs, causal=causal)
    sum((o ** 2).sum() for o in outs).backward()
    cnt = kernels.counters()
    assert [cnt[n]["plain_calls"] for n in (
        "flash_attention", "flash_attention_bwd_dkv",
        "flash_attention_bwd_dq")] == [CP * CP] * 3
    got = [torch.cat(t, dim=1).detach().numpy() for t in (
        outs, [q.grad for q in qs], [k.grad for k in ks], [v.grad for v in vs])]
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a, b, **(O_TOL if name == "o" else G_TOL),
                                   err_msg=name)


def test_local_ulysses_matches_jax():
    from paddle_tpu_torch.distributed import ulysses_attention_local

    c = _inputs()["ulysses"]
    ref = _jax_oracle("ulysses", c)
    qs, ks, vs = ([t.contiguous().requires_grad_(True) for t in
                   torch.from_numpy(c[n]).chunk(CP, dim=1)] for n in "qkv")
    outs = ulysses_attention_local(qs, ks, vs, causal=True)
    sum((o ** 2).sum() for o in outs).backward()
    got = [torch.cat(t, dim=1).detach().numpy() for t in (
        outs, [q.grad for q in qs], [k.grad for k in ks], [v.grad for v in vs])]
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a, b, **(O_TOL if name == "o" else G_TOL),
                                   err_msg=name)


def test_ulysses_raises_when_heads_do_not_divide():
    from paddle_tpu_torch.distributed import ulysses_attention_local

    ts = [torch.zeros(1, 4, 3, 8) for _ in range(2)]
    with pytest.raises(ValueError, match="divisible by cp=2"):
        ulysses_attention_local(ts, ts, ts)


@pytest.mark.parametrize("cp", [2, 4])
def test_ring_offsets_follow_the_jax_ring(cp):
    """offset = (idx - src) * s_loc with src = (idx - r) mod cp
    (``paddle_tpu/distributed/context_parallel.py:52-59``): step 0 the
    diagonal, a chunk from a later rank wholly in the future (offset <=
    -s_loc), one from an earlier rank wholly in the past (>= s_loc)."""
    from paddle_tpu_torch.distributed.context_parallel import ring_offset

    s = 16
    for idx in range(cp):
        for r in range(cp):
            src = (idx - r) % cp
            off = ring_offset(idx, r, cp, s)
            assert off == (idx - src) * s
            assert (off == 0) == (r == 0)
            assert (off <= -s) == (src > idx) and (off >= s) == (src < idx)
