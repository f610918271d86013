"""The fp32 tensor-core flash kernels (3xTF32: forward, dK/dV and dQ) on
the CPU.

The kernels themselves run only on the card (``test_torch_gpu.py -k
tf32x3``). Here: which calls they take (``route``, ``takes_tf32x3`` and the
dispatchers, driven on meta tensors with the kernel wrappers replaced by
recorders), the wrappers' refusals before any build, and the kernels'
arithmetic emulated in PyTorch (the hi / lo split, three TF32 products a
product, the tile-by-tile online softmax in log2 units, dQ's per-tile sums
added in fp32) against the JAX package's Pallas kernels in interpret mode
on the same numpy inputs, at the fp32 tolerances the card tests hold the
kernels to; one TF32 pass does not hold them.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.kernels import flash_attention as jflash
from paddle_tpu_torch.kernels import counters, reset_counters

_FA = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453


@pytest.mark.parametrize("dtype,d,sq,want", [
    (torch.float32, 72, 256, "tf32x3"), (torch.float32, 64, 128, "tf32x3"),
    (torch.float32, 8, 2, "tf32x3"), (torch.float32, 128, 2048, "tf32x3"),
    (torch.float32, 96, 77, "tf32x3"), (torch.float32, 40, 5, "tf32x3"),
    (torch.float32, 72, 1, "decode"), (torch.float32, 128, 1, "decode"),
    (torch.float32, 36, 64, "cuda_core"), (torch.float32, 12, 64,
                                           "cuda_core"),
    (torch.float32, 4, 64, "cuda_core"), (torch.float32, 136, 64,
                                          "cuda_core"),
    (torch.float32, 256, 64, "cuda_core"), (torch.bfloat16, 72, 256,
                                            "sm90"),
    (torch.bfloat16, 64, 256, "sm90"), (torch.bfloat16, 128, 2, "sm90"),
    (torch.float16, 64, 256, "cuda_core")])
def test_route_sends_fp32_at_multiples_of_8_to_tf32x3(dtype, d, sq, want):
    """fp32 with more than one query row and a head dim that is a multiple
    of 8 from 8 to 128 takes the 3xTF32 forward; one row stays on the
    decode kernel; bf16 at those head dims takes its own tensor-core
    kernel; everything else the CUDA-core kernel."""
    assert _FA.route(dtype, d, sq) == want
    assert _FA.takes_tf32x3(dtype, d, sq) is (want == "tf32x3")


@pytest.mark.parametrize("dtype,d,want", [
    (torch.float32, 8, True), (torch.float32, 72, True),
    (torch.float32, 128, True), (torch.float32, 64, True),
    (torch.float32, 0, False), (torch.float32, 4, False),
    (torch.float32, 68, False), (torch.float32, 136, False),
    (torch.bfloat16, 64, False), (torch.float16, 72, False)])
def test_takes_tf32x3_without_rows_is_the_backward_rule(dtype, d, want):
    """For the backward (``sq`` None) the rule is dtype and head dim alone:
    a single-row forward's dK/dV (the decode kernel ran forward) still
    takes the 3xTF32 kernel."""
    assert _FA.takes_tf32x3(dtype, d) is want
    assert _FA.takes_tf32x3(dtype, d, 1) is False


@pytest.mark.parametrize("dtype,d,dkv,dq", [
    (torch.float32, 72, "tf32x3", "tf32x3"),
    (torch.float32, 64, "tf32x3", "tf32x3"),
    (torch.float32, 8, "tf32x3", "tf32x3"),
    (torch.float32, 36, "cuda_core", "cuda_core"),
    (torch.float32, 256, "cuda_core", "cuda_core"),
    (torch.bfloat16, 128, "sm90", "sm90"),
    (torch.bfloat16, 72, "sm90", "sm90")])
def test_backward_dispatch_takes_tf32x3_for_dkv_only(dtype, d, dkv, dq,
                                                     monkeypatch):
    """The dK/dV and dQ dispatchers on meta tensors (neither CPU nor CUDA),
    every kernel wrapper replaced by a recorder: fp32 dK/dV and dQ at the
    3xTF32 head dims both go to their 3xTF32 kernels (bf16 to its
    tensor-core kernels), the other head dims to the CUDA cores."""
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
    assert took == [("flash_attention_bwd_dkv", dkv),
                    ("flash_attention_bwd_dq", dq)]


@pytest.mark.parametrize("fn", ["fwd", "dkv", "dq"])
@pytest.mark.parametrize("dtype,d,sq,device,error,match", [
    (torch.bfloat16, 64, 8, "cpu", ValueError, "fp32 tensor-core kernel"),
    (torch.float32, 36, 8, "cpu", ValueError, "fp32 tensor-core kernel"),
    (torch.float32, 136, 8, "cpu", ValueError, "fp32 tensor-core kernel"),
    (torch.float16, 64, 8, "cpu", TypeError, "float32 or bfloat16"),
    (torch.float32, 72, 8, "cpu", ValueError, "CUDA tensors"),
    (torch.float32, 64, 8, "meta", ValueError, "CUDA tensors")])
def test_tf32x3_wrappers_refuse_before_any_build(fn, dtype, d, sq, device,
                                                 error, match):
    """The 3xTF32 wrappers raise, before any build or launch, on inputs
    their kernels do not take and on tensors off the card; they never fall
    back to another kernel or the plain version."""
    q = torch.zeros(2, sq, d, dtype=dtype, device=device)
    stats = torch.zeros(2, sq, device=device)
    reset_counters()
    with pytest.raises(error, match=match):
        if fn == "fwd":
            _FA.flash_attention_fwd_tf32x3(q, q, q, 0, True, 0.1)
        elif fn == "dkv":
            _FA.flash_attention_bwd_dkv_tf32x3(q, q, q, q, stats, stats, 0,
                                               True, 0.1)
        else:
            _FA.flash_attention_bwd_dq_tf32x3(q, q, q, q, stats, stats, 0,
                                              True, 0.1)
    assert all(c == {"launches": 0, "plain_calls": 0}
               for c in counters().values())


def test_tf32x3_forward_refuses_a_single_row():
    q = torch.zeros(2, 1, 64, device="meta")
    with pytest.raises(ValueError, match="sq > 1"):
        _FA.flash_attention_fwd_tf32x3(q, q, q, 0, True, 0.1)


def test_cpu_calls_count_on_the_cuda_core_counters():
    """On the CPU the dispatchers run the plain versions and count them as
    plain calls of the CUDA-core counters, as before; the 3xTF32 counters
    stay at 0."""
    q = torch.randn(2, 16, 72)
    stats = torch.zeros(2, 16)
    reset_counters()
    _FA.flash_attention_fwd(q, q, q, 0, True, 0.1)
    _FA.flash_attention_bwd_dkv(q, q, q, q, stats, stats, 0, True, 0.1)
    _FA.flash_attention_bwd_dq(q, q, q, q, stats, stats, 0, True, 0.1)
    c = counters()
    for name in ("flash_attention", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        assert c[name] == {"launches": 0, "plain_calls": 1}
        assert c[name + "_tf32x3"] == {"launches": 0, "plain_calls": 0}


# -- the kernels' arithmetic, emulated --------------------------------------

def _tf32_nearest(x):
    """fp32 -> TF32, to nearest with ties away (``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x):
    """fp32 -> TF32 by truncation (the tensor core reading an fp32 word)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm(a, b, passes):
    """a @ b as the kernels take it: three TF32 products (lo.hi + hi.lo +
    hi.hi, hi rounded to nearest, lo = a - hi truncated), or one (hi.hi);
    TF32 products are exact in fp32, summed in fp32."""
    ah, bh = _tf32_nearest(a), _tf32_nearest(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32_truncated(a - ah), _tf32_truncated(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _visible(sq, sk, offset, causal):
    if not causal:
        return torch.ones(sq, sk, dtype=torch.bool)
    return torch.arange(sk)[None, :] <= torch.arange(sq)[:, None] + offset


def _forward_emulated(q, k, v, offset, causal, scale, passes, kt=32):
    """The forward kernel's arithmetic: key tiles of ``kt``, logits scaled
    into log2 units, a running max from -1e30, masked pairs -inf, exp2,
    O rescaled once a tile; o = 0 and lse = -1e30 where no key was seen."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    vis = _visible(sq, sk, offset, causal)
    m = torch.full((bh, sq), -1e30)
    l = torch.zeros(bh, sq)
    acc = torch.zeros(bh, sq, d)
    for j0 in range(0, sk, kt):
        s = _mm(q, k[:, j0:j0 + kt].transpose(1, 2), passes) * \
            (scale * _LOG2E)
        s = torch.where(vis[:, j0:j0 + kt], s, -float("inf"))
        mx = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(s - mx[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + _mm(p, v[:, j0:j0 + kt], passes)
        m = mx
    seen = l > 0
    o = torch.where(seen[..., None], acc / l.clamp_min(1e-30)[..., None], 0.0)
    lse = torch.where(seen, (m + torch.log2(l.clamp_min(1e-30))) * _LN2,
                      -1e30)
    return o, lse


def _dkv_emulated(q, k, v, do, lse, delta, offset, causal, scale, passes):
    """The dK/dV kernel's arithmetic: the transposed scores K Q^T and
    V dO^T, p^T = exp2(s log2e scale - lse log2e) on visible pairs (0
    elsewhere), ds^T = p^T (dp^T - delta) scale, dV = P^T dO, dK = dS^T Q."""
    vis = _visible(q.shape[1], k.shape[1], offset, causal).T
    st = _mm(k, q.transpose(1, 2), passes)
    dpt = _mm(v, do.transpose(1, 2), passes)
    p = torch.where(vis, torch.exp2(st * (scale * _LOG2E)
                                    - lse[:, None, :] * _LOG2E), 0.0)
    ds = p * (dpt - delta[:, None, :]) * scale
    return _mm(ds, q, passes), _mm(p, do, passes)


def _dq_emulated(q, k, v, do, lse, delta, offset, causal, scale, passes,
                 kt=16):
    """The dQ kernel's arithmetic: key tiles of ``kt``; S = Q K^T and
    dP = dO V^T, p = exp2(s log2e scale - lse log2e) on visible pairs (0
    elsewhere), ds = p (dp - delta) scale; each tile's dS K summed on its
    own and added to the running dQ in fp32."""
    vis = _visible(q.shape[1], k.shape[1], offset, causal)
    dq = torch.zeros_like(q)
    for j0 in range(0, k.shape[1], kt):
        kt_, vt = k[:, j0:j0 + kt], v[:, j0:j0 + kt]
        s = _mm(q, kt_.transpose(1, 2), passes)
        dp = _mm(do, vt.transpose(1, 2), passes)
        p = torch.where(vis[:, j0:j0 + kt],
                        torch.exp2(s * (scale * _LOG2E)
                                   - lse[..., None] * _LOG2E), 0.0)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + _mm(ds, kt_, passes)
    return dq


# (sq, sk, offset, causal, d): DiT's head dim non-causal, causal with an
# offset, rows that see no key, BERT's and the parity steps' head dims
_EMULATED_CASES = [(128, 128, 0, False, 72), (128, 192, 64, True, 72),
                   (128, 128, -40, True, 8), (64, 128, 64, True, 64),
                   (128, 64, 0, False, 128)]


def _jax_reference(c, causal, offset, scale):
    q, k, v, go, gl = (jnp.asarray(c[n]) for n in ("q", "k", "v", "go",
                                                   "gl"))
    (o, lse), vjp = jax.vjp(lambda a, b, e: jflash.flash_attention_with_lse(
        a, b, e, offset, causal, scale, 64, 64), q, k, v)
    dq, dk, dv = vjp((go, gl))
    return [np.array(t) for t in (o, lse, dk, dv, dq)]


def _inputs(sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    shapes = {"q": (2, sq, d), "k": (2, sk, d), "v": (2, sk, d),
              "go": (2, sq, d), "gl": (2, sq)}
    return {n: rng.standard_normal(s, dtype=np.float32)
            for n, s in shapes.items()}


def _excess(got, ref, rtol, atol):
    """How far |got - ref| goes past rtol |ref| + atol (<= 0 holds)."""
    ref = torch.from_numpy(ref)
    return ((got - ref).abs() - (rtol * ref.abs() + atol)).max().item()


@pytest.mark.parametrize("sq,sk,offset,causal,d", _EMULATED_CASES)
def test_three_tf32_passes_hold_the_fp32_tolerances(sq, sk, offset, causal,
                                                    d):
    """The kernels' arithmetic against the JAX Pallas kernels (interpret
    mode) on the same inputs: o within (0, 1e-4), lse (0, 1e-3), dK and dV
    (1e-4, 1e-4), the tolerances of the card tests; rows that see no key
    give o = 0 and lse = -1e30. One TF32 pass in the same arithmetic
    breaks o's tolerance."""
    c = _inputs(sq, sk, d, seed=d + sq)
    scale = 1.0 / d ** 0.5
    jo, jl, jdk, jdv, _ = _jax_reference(c, causal, offset, scale)
    q, k, v, go, gl = (torch.from_numpy(c[n]) for n in ("q", "k", "v", "go",
                                                         "gl"))
    o, lse = _forward_emulated(q, k, v, offset, causal, scale, passes=3)
    assert _excess(o, jo, 0.0, 1e-4) <= 0
    assert _excess(lse, jl, 0.0, 1e-3) <= 0
    delta = (go * torch.from_numpy(jo)).sum(-1) - gl
    args = (torch.from_numpy(jl), delta, offset, causal, scale)
    dk, dv = _dkv_emulated(q, k, v, go, *args, passes=3)
    assert _excess(dk, jdk, 1e-4, 1e-4) <= 0
    assert _excess(dv, jdv, 1e-4, 1e-4) <= 0
    if causal and offset < 0:
        blind = min(sq, -offset)
        assert not o[:, :blind].any() and (lse[:, :blind] == -1e30).all()
    o1, _ = _forward_emulated(q, k, v, offset, causal, scale, passes=1)
    assert _excess(o1, jo, 0.0, 1e-4) > 0


@pytest.mark.parametrize("sq,sk,offset,causal,d", _EMULATED_CASES)
def test_three_tf32_passes_hold_the_fp32_dq_tolerance(sq, sk, offset, causal,
                                                      d):
    """The dQ kernel's arithmetic against the JAX Pallas kernel's dQ
    (interpret mode) on the same inputs, within (1e-4, 1e-4), the tolerance
    of the card tests; rows that see no key give dQ = 0 exactly. One TF32
    pass in the same arithmetic breaks it."""
    c = _inputs(sq, sk, d, seed=d + sq)
    scale = 1.0 / d ** 0.5
    jo, jl, _, _, jdq = _jax_reference(c, causal, offset, scale)
    q, k, v, go, gl = (torch.from_numpy(c[n]) for n in ("q", "k", "v", "go",
                                                         "gl"))
    delta = (go * torch.from_numpy(jo)).sum(-1) - gl
    args = (torch.from_numpy(jl), delta, offset, causal, scale)
    dq = _dq_emulated(q, k, v, go, *args, passes=3)
    assert _excess(dq, jdq, 1e-4, 1e-4) <= 0
    if causal and offset < 0:
        assert not dq[:, :min(sq, -offset)].any()
    dq1 = _dq_emulated(q, k, v, go, *args, passes=1)
    assert _excess(dq1, jdq, 1e-4, 1e-4) > 0
