"""The bf16 tensor-core flash forward, dK/dV and dQ at every head dim
that is a multiple of 8 up to 256, on the CPU.

The kernels themselves run only on the card (``test_torch_gpu.py -k
sm90``). Here: which calls they take (``route``, ``takes_sm90`` and the
dispatchers, driven on meta tensors with the kernel wrappers replaced by
recorders), the wrappers' refusals before any build, and the kernels'
arithmetic emulated in PyTorch (the head dim padded to a multiple of 16
with zero columns, 128-key tiles forward (64 above 128), 64-row tiles for
dK/dV (above 128 each warpgroup's column half accumulated on its own),
64-key tiles for dQ (32 above 128), the online softmax in log2 units, P
and dS rounded to bf16 a tile) against the JAX package's Pallas kernels in
interpret mode on the same numpy inputs, within the bounds the card tests
hold the kernels to (``sm90_fwd_bound``, ``sm90_dkv_bound``,
``sm90_dq_bound``); an emulation that reads only the first 64 columns of
head dim 96, or the first 128 of 256, breaks them.
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
_NEG = -1e30

_HEAD_DIMS = [8, 12, 16, 24, 40, 64, 72, 80, 96, 112, 128, 136, 256]
# the head dims of the bf16 tensor-core kernels among them
_TC = {8, 16, 24, 40, 64, 72, 80, 96, 112, 128, 136, 256}
# those of the fp32 (3xTF32) kernels
_TF32 = {d for d in _TC if d <= 128}


def _dispatched(dtype, d, monkeypatch):
    """[(dispatcher, route)] of one dK/dV and one dQ call on meta tensors
    (neither CPU nor CUDA), every kernel wrapper replaced by a
    recorder."""
    took = []
    for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        for route in ("sm90", "tf32x3", "cuda_core"):
            monkeypatch.setattr(
                _FA, f"{name}_{route}",
                lambda *a, n=name, r=route: took.append((n, r)))
    q = torch.empty(2, 16, d, dtype=dtype, device="meta")
    stats = torch.empty(2, 16, device="meta")
    args = (q, q, q, q, stats, stats, 0, True, 0.1)
    _FA.flash_attention_bwd_dkv(*args)
    _FA.flash_attention_bwd_dq(*args)
    return took


@pytest.mark.parametrize("sq", [1, 2, 2048])
@pytest.mark.parametrize("d", _HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_and_takes_at_every_head_dim(dtype, d, sq, monkeypatch):
    """One query row goes to the decode kernel wherever its rows are whole
    16-byte chunks (bf16 d 12 is not); more rows go to the tensor-core
    kernel of their dtype at a head dim that is a multiple of 8, up to 256
    in bf16 and 128 in fp32, and to the CUDA-core kernel at the others (12;
    136 and 256 in fp32). The backward's rule (``sq`` None) is the
    forward's without the row count, for dQ as for dK/dV: bf16 dQ takes
    the tensor cores at every multiple of 8 up to 256."""
    bf16 = dtype == torch.bfloat16
    if sq == 1:
        want = "cuda_core" if bf16 and d == 12 else "decode"
    elif d in (_TC if bf16 else _TF32):
        want = "sm90" if bf16 else "tf32x3"
    else:
        want = "cuda_core"
    assert _FA.route(dtype, d, sq) == want
    assert _FA.takes_sm90(dtype, d, sq) is (want == "sm90")
    assert _FA.takes_sm90(dtype, d) is (bf16 and d in _TC)
    dq = _dispatched(dtype, d, monkeypatch)[1][1]
    assert (dq == "sm90") is (bf16 and d in _TC)
    assert _FA.takes_tf32x3(dtype, d) is (not bf16 and d in _TF32)


@pytest.mark.parametrize("dtype,d,dkv,dq", [
    (torch.bfloat16, 96, "sm90", "sm90"),
    (torch.bfloat16, 80, "sm90", "sm90"),
    (torch.bfloat16, 8, "sm90", "sm90"),
    (torch.bfloat16, 112, "sm90", "sm90"),
    (torch.bfloat16, 64, "sm90", "sm90"),
    (torch.bfloat16, 128, "sm90", "sm90"),
    (torch.bfloat16, 12, "cuda_core", "cuda_core"),
    (torch.bfloat16, 136, "sm90", "sm90"),
    (torch.bfloat16, 256, "sm90", "sm90"),
    (torch.float32, 96, "tf32x3", "tf32x3"),
    (torch.float32, 256, "cuda_core", "cuda_core")] + [
    # every other bf16 head dim above 128 (the wide instances)
    (torch.bfloat16, d, "sm90", "sm90") for d in range(144, 256, 8)])
def test_backward_dispatch_splits_dkv_from_dq(dtype, d, dkv, dq,
                                              monkeypatch):
    """The dK/dV and dQ dispatchers on meta tensors (neither CPU nor CUDA),
    every kernel wrapper replaced by a recorder: bf16 dK/dV and dQ both go
    to their tensor-core kernels at every multiple of 8 up to 256 (above
    128 ``csrc/flash_bwd_dkv_sm90_wide.cu`` and
    ``csrc/flash_bwd_dq_sm90_wide.cu``), fp32 both to their 3xTF32 kernels
    up to 128; elsewhere both stay on the CUDA cores."""
    assert _dispatched(dtype, d, monkeypatch) == [
        ("flash_attention_bwd_dkv", dkv), ("flash_attention_bwd_dq", dq)]


@pytest.mark.parametrize("fn", ["fwd", "dkv", "dq"])
@pytest.mark.parametrize("dtype,d,device,error,match", [
    (torch.bfloat16, 12, "cpu", ValueError, "tensor-core kernel"),
    (torch.bfloat16, 136, "cpu", ValueError, None),
    (torch.bfloat16, 256, "meta", ValueError, None),
    (torch.bfloat16, 264, "cpu", ValueError, "head_dim <= 256"),
    (torch.float32, 96, "cpu", ValueError, "tensor-core kernel"),
    (torch.float16, 96, "cpu", TypeError, "float32 or bfloat16"),
    (torch.bfloat16, 96, "meta", ValueError, None),
    (torch.bfloat16, 8, "cpu", ValueError, None)])
def test_sm90_wrappers_refuse_before_any_build(fn, dtype, d, device, error,
                                               match):
    """The tensor-core wrappers raise, before any build or launch, on
    inputs their kernels do not take and on tensors off the card; they
    never fall back to another kernel or the plain version. At bf16 d 8,
    96, 136 and 256 all three refuse only for the device."""
    q = torch.zeros(2, 8, d, dtype=dtype, device=device)
    stats = torch.zeros(2, 8, device=device)
    if match is None:
        match = "CUDA tensors"
    reset_counters()
    with pytest.raises(error, match=match):
        if fn == "fwd":
            _FA.flash_attention_fwd_sm90(q, q, q, 0, True, 0.1)
        elif fn == "dkv":
            _FA.flash_attention_bwd_dkv_sm90(q, q, q, q, stats, stats, 0,
                                             True, 0.1)
        else:
            _FA.flash_attention_bwd_dq_sm90(q, q, q, q, stats, stats, 0,
                                            True, 0.1)
    assert all(c == {"launches": 0, "plain_calls": 0}
               for c in counters().values())


def test_cpu_calls_at_d96_count_on_the_cuda_core_counters():
    """On the CPU the dispatchers run the plain versions and count them as
    plain calls of the CUDA-core counters; the tensor-core counters stay
    at 0."""
    q = torch.randn(2, 16, 96, dtype=torch.bfloat16)
    stats = torch.zeros(2, 16)
    reset_counters()
    _FA.flash_attention_fwd(q, q, q, 0, True, 0.1)
    _FA.flash_attention_bwd_dkv(q, q, q, q, stats, stats, 0, True, 0.1)
    _FA.flash_attention_bwd_dq(q, q, q, q, stats, stats, 0, True, 0.1)
    c = counters()
    for name in ("flash_attention", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        assert c[name] == {"launches": 0, "plain_calls": 1}
        assert c[name + "_sm90"] == {"launches": 0, "plain_calls": 0}


# -- the kernels' arithmetic, emulated --------------------------------------

def _bf16(t):
    return t.to(torch.bfloat16).float()


def _padded(t, d, read):
    """``t`` [.., d] as the kernels' shared memory holds it: ceil16(d)
    columns, those past d zero (TMA's fill); only the first ``read``
    columns kept (a planted fault reads fewer)."""
    dp = -(-d // 16) * 16
    out = torch.zeros(*t.shape[:-1], dp)
    out[..., :min(d, read)] = t[..., :read]
    return out


def _visible(sq, sk, offset, causal):
    if not causal:
        return torch.ones(sq, sk, dtype=torch.bool)
    return torch.arange(sk)[None, :] <= torch.arange(sq)[:, None] + offset


def _forward_emulated(q, k, v, offset, causal, scale, read=256, kt=128):
    """The forward kernel's arithmetic on bf16-valued fp32 inputs: key
    tiles of ``kt``; logits in log2 units, masked ones -1e30; a running max
    from -1e30; p exactly 0 where masked; the row sum adds the fp32 p and
    O += P.V takes P rounded to bf16; o rounded to bf16 and cut to d
    columns; lse = m ln 2 + ln l, -1e30 where no key was seen."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    qp, kp, vp = (_padded(t, d, read) for t in (q, k, v))
    vis = _visible(sq, sk, offset, causal)
    m = torch.full((bh, sq), _NEG)
    l = torch.zeros(bh, sq)
    acc = torch.zeros(bh, sq, qp.shape[-1])
    for j0 in range(0, sk, kt):
        s = qp @ kp[:, j0:j0 + kt].transpose(1, 2) * (scale * _LOG2E)
        s = torch.where(vis[:, j0:j0 + kt], s, _NEG)
        mx = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2(m - mx)
        p = torch.where(s > 0.5 * _NEG, torch.exp2(s - mx[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + _bf16(p) @ vp[:, j0:j0 + kt]
        m = mx
    o = _bf16(acc / l.clamp_min(1e-30)[..., None])[..., :d]
    lse = torch.where(l > 0, m * _LN2 + torch.log(l.clamp_min(1e-30)), _NEG)
    return o, lse


def _dkv_emulated(q, k, v, do, lse, delta, offset, causal, scale, read=256,
                  rt=64):
    """The dK/dV kernel's arithmetic: query tiles of ``rt``; S^T = K Q^T
    and dP^T = V dO^T over the padded columns; p^T = exp2(s^T scale log2e -
    lse log2e), exactly 0 where masked; ds^T = p^T (dp^T - delta) scale;
    dV += bf16(P^T) dO and dK += bf16(dS^T) Q a tile, above 128 (the
    64-key instances) for each warpgroup's columns on their own (0 .. 127
    and 128 on, from the same P^T and dS^T); both rounded to bf16 and cut
    to d columns."""
    d = q.shape[-1]
    qp, kp, vp, dop = (_padded(t, d, read) for t in (q, k, v, do))
    dp_ = qp.shape[-1]
    halves = [(0, dp_)] if dp_ <= 128 else [(0, 128), (128, dp_)]
    vis = _visible(q.shape[1], k.shape[1], offset, causal).T
    dk = torch.zeros(*k.shape[:2], dp_)
    dv = torch.zeros_like(dk)
    for i0 in range(0, q.shape[1], rt):
        qt, dot = qp[:, i0:i0 + rt], dop[:, i0:i0 + rt]
        st = kp @ qt.transpose(1, 2)
        dpt = vp @ dot.transpose(1, 2)
        p = torch.exp2(st * (scale * _LOG2E)
                       - lse[:, None, i0:i0 + rt] * _LOG2E)
        p = torch.where(vis[:, i0:i0 + rt], p, 0.0)
        ds = p * (dpt - delta[:, None, i0:i0 + rt]) * scale
        for c0, c1 in halves:
            dv[..., c0:c1] += _bf16(p) @ dot[..., c0:c1]
            dk[..., c0:c1] += _bf16(ds) @ qt[..., c0:c1]
    return _bf16(dk)[..., :d], _bf16(dv)[..., :d]


def _dq_emulated(q, k, v, do, lse, delta, offset, causal, scale, read=256,
                 kt=64):
    """The dQ kernel's arithmetic: key tiles of ``kt`` (:func:`_dq_tile`);
    S = Q K^T and
    dP = dO V^T over the padded columns; p = exp2(s scale log2e - lse
    log2e), exactly 0 where masked; ds = p (dp - delta) scale; dQ +=
    bf16(dS) K a tile; rounded to bf16 and cut to d columns."""
    d = q.shape[-1]
    qp, kp, vp, dop = (_padded(t, d, read) for t in (q, k, v, do))
    vis = _visible(q.shape[1], k.shape[1], offset, causal)
    dq = torch.zeros_like(qp)
    for j0 in range(0, k.shape[1], kt):
        kt_, vt = kp[:, j0:j0 + kt], vp[:, j0:j0 + kt]
        s = qp @ kt_.transpose(1, 2)
        dp = dop @ vt.transpose(1, 2)
        p = torch.exp2(s * (scale * _LOG2E) - lse[..., None] * _LOG2E)
        p = torch.where(vis[:, j0:j0 + kt], p, 0.0)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + _bf16(ds) @ kt_
    return _bf16(dq)[..., :d]


def _inputs(sq, sk, d, seed):
    """bf16-valued fp32 inputs from numpy: q, k, v, the cotangents of o
    and lse."""
    rng = np.random.default_rng(seed)
    shapes = {"q": (2, sq, d), "k": (2, sk, d), "v": (2, sk, d),
              "go": (2, sq, d), "gl": (2, sq)}
    out = {n: rng.standard_normal(s, dtype=np.float32)
           for n, s in shapes.items()}
    for n in ("q", "k", "v", "go"):
        out[n] = _bf16(torch.from_numpy(out[n])).numpy()
    return out


def _jax_reference(c, causal, offset, scale):
    """o, lse, dK, dV, dQ of the Pallas kernels (interpret mode, 64-row
    blocks) on the same fp32 inputs, through a loss reading o and lse."""
    q, k, v, go, gl = (jnp.asarray(c[n]) for n in ("q", "k", "v", "go",
                                                   "gl"))
    (o, lse), vjp = jax.vjp(lambda a, b, e: jflash.flash_attention_with_lse(
        a, b, e, offset, causal, scale, 64, 64), q, k, v)
    dq, dk, dv = vjp((go, gl))
    return [torch.from_numpy(np.array(t)) for t in (o, lse, dk, dv, dq)]


def _excess(got, ref, bound):
    """How far |got - ref| goes past ``bound`` (<= 0 holds)."""
    return ((got - ref).abs() - bound).max().item()


# (sq, sk, offset, causal, d): lengths that 128 does not divide, causal
# with an offset, rows that see no key (offset -64), and not causal
_EMULATED_CASES = [(192, 320, 128, True, 96), (320, 192, -64, True, 96),
                   (192, 320, 128, True, 80), (64, 192, 0, False, 80),
                   (192, 320, 128, True, 72), (320, 192, -64, True, 72),
                   (192, 320, 128, True, 40), (64, 192, 0, False, 40),
                   (192, 320, 128, True, 8), (320, 192, -64, True, 8)]


@pytest.mark.parametrize("sq,sk,offset,causal,d", _EMULATED_CASES)
def test_padded_head_dims_hold_the_sm90_bounds(sq, sk, offset, causal, d):
    """The kernels' arithmetic at d 96, 80, 72, 40 and 8 against the JAX
    Pallas kernels (interpret mode) on the same inputs: o within
    ``sm90_fwd_bound``, lse within 1e-3, dK and dV within
    ``sm90_dkv_bound``, dQ within ``sm90_dq_bound``; rows that see no key
    give o = 0, lse = -1e30 and dQ = 0 exactly and add nothing to dK and
    dV."""
    c = _inputs(sq, sk, d, seed=d + sq)
    scale = 1.0 / d ** 0.5
    jo, jl, jdk, jdv, jdq = _jax_reference(c, causal, offset, scale)
    q, k, v, go, gl = (torch.from_numpy(c[n]) for n in ("q", "k", "v", "go",
                                                         "gl"))
    o, lse = _forward_emulated(q, k, v, offset, causal, scale)
    assert _excess(o, jo, _FA.sm90_fwd_bound(q, k, v, offset, causal, scale,
                                              jo)) <= 0
    assert (lse - jl).abs().max().item() <= 1e-3
    delta = (go * jo).sum(-1) - gl
    args = (jl, delta, offset, causal, scale)
    bdk, bdv = _FA.sm90_dkv_bound(q, k, v, go, *args, jdk, jdv)
    dk, dv = _dkv_emulated(q, k, v, go, *args)
    assert _excess(dk, jdk, bdk) <= 0
    assert _excess(dv, jdv, bdv) <= 0
    dq = _dq_emulated(q, k, v, go, *args)
    assert _excess(dq, jdq, _FA.sm90_dq_bound(q, k, v, go, *args, jdq)) <= 0
    if causal and offset < 0:
        blind = -offset
        assert not o[:, :blind].any() and (lse[:, :blind] == _NEG).all()
        assert not dq[:, :blind].any()
        go[:, :blind] = 1000.0  # a row that sees no key adds nothing
        dk2, dv2 = _dkv_emulated(q, k, v, go, *args)
        assert torch.equal(dk2, dk) and torch.equal(dv2, dv)


def _fwd_tile(d):
    """Keys a forward tile takes: 128 up to head dim 128, 64 above (the
    64-key instances of ``csrc/flash_fwd_sm90_wide.cu``)."""
    return 128 if d <= 128 else 64


def _dq_tile(d):
    """Keys a dQ tile takes: 64 up to head dim 128, 32 above (the 32-key
    instances of ``csrc/flash_bwd_dq_sm90_wide.cu``)."""
    return 64 if d <= 128 else 32


# (sq, sk, offset, causal, d) at the 64-key instances: two whole chunks and
# a 16-column remainder (136), four whole chunks (256); ragged lengths,
# causal with an offset, rows that see no key (offset -64), and not causal
_WIDE_CASES = [(192, 320, 128, True, 136), (320, 192, -64, True, 256),
               (64, 192, 0, False, 256), (128, 192, 64, True, 136)]


@pytest.mark.parametrize("sq,sk,offset,causal,d", _WIDE_CASES)
def test_wide_head_dims_hold_the_sm90_bounds(sq, sk, offset, causal, d):
    """Above 128 the forward's 64-key tiles, dK/dV's column halves and
    dQ's 32-key tiles against the JAX Pallas kernels (interpret mode) on
    the same inputs: o within ``sm90_fwd_bound``, lse within 1e-3, dK and
    dV within ``sm90_dkv_bound``, dQ within ``sm90_dq_bound``; dQ's plain
    version (what a CPU call runs, in fp32) equals the JAX dQ within 1e-4.
    Rows that see no key give o = 0, lse = -1e30 and dQ = 0 exactly and add
    nothing to dK and dV."""
    c = _inputs(sq, sk, d, seed=d + sq)
    scale = 1.0 / d ** 0.5
    jo, jl, jdk, jdv, jdq = _jax_reference(c, causal, offset, scale)
    q, k, v, go, gl = (torch.from_numpy(c[n]) for n in ("q", "k", "v", "go",
                                                         "gl"))
    o, lse = _forward_emulated(q, k, v, offset, causal, scale,
                               kt=_fwd_tile(d))
    assert _excess(o, jo, _FA.sm90_fwd_bound(q, k, v, offset, causal, scale,
                                              jo)) <= 0
    assert (lse - jl).abs().max().item() <= 1e-3
    delta = (go * jo).sum(-1) - gl
    args = (jl, delta, offset, causal, scale)
    bdk, bdv = _FA.sm90_dkv_bound(q, k, v, go, *args, jdk, jdv)
    dk, dv = _dkv_emulated(q, k, v, go, *args)
    assert _excess(dk, jdk, bdk) <= 0
    assert _excess(dv, jdv, bdv) <= 0
    dq = _dq_emulated(q, k, v, go, *args, kt=_dq_tile(d))
    assert _excess(dq, jdq, _FA.sm90_dq_bound(q, k, v, go, *args, jdq)) <= 0
    plain = _FA.flash_attention_bwd_dq_plain(q, k, v, go, *args)
    np.testing.assert_allclose(plain.numpy(), jdq.numpy(), rtol=1e-4,
                               atol=1e-4)
    if causal and offset < 0:
        blind = -offset
        assert not o[:, :blind].any() and (lse[:, :blind] == _NEG).all()
        assert not dq[:, :blind].any()
        go[:, :blind] = 1000.0  # a row that sees no key adds nothing
        dk2, dv2 = _dkv_emulated(q, k, v, go, *args)
        assert torch.equal(dk2, dk) and torch.equal(dv2, dv)


def _first_columns_check(out, d, read, seed):
    """The emulated kernel that reads every column, and one that reads
    only the first ``read`` (the rest zero), against the JAX Pallas
    kernels at a causal 256 x 256 for ``out`` (o, dk, dv or dq): the sound
    one holds its bound and fills more than 5% of it, the faulty one
    breaks it."""
    sq = sk = 256
    offset, scale = 0, d ** -0.5
    c = _inputs(sq, sk, d, seed=seed)
    jo, jl, jdk, jdv, jdq = _jax_reference(c, True, offset, scale)
    q, k, v, go, gl = (torch.from_numpy(c[n]) for n in ("q", "k", "v", "go",
                                                         "gl"))
    delta = (go * jo).sum(-1) - gl
    args = (jl, delta, offset, True, scale)
    if out == "o":
        ref = jo
        bound = _FA.sm90_fwd_bound(q, k, v, offset, True, scale, jo)
        sound, fault = (_forward_emulated(q, k, v, offset, True, scale,
                                          read=r, kt=_fwd_tile(d))[0]
                        for r in (d, read))
    elif out == "dq":
        ref = jdq
        bound = _FA.sm90_dq_bound(q, k, v, go, *args, jdq)
        sound, fault = (_dq_emulated(q, k, v, go, *args, read=r,
                                     kt=_dq_tile(d))
                        for r in (d, read))
    else:
        i = 0 if out == "dk" else 1
        ref = (jdk, jdv)[i]
        bound = _FA.sm90_dkv_bound(q, k, v, go, *args, jdk, jdv)[i]
        sound, fault = (_dkv_emulated(q, k, v, go, *args, read=r)[i]
                        for r in (d, read))
    assert _excess(sound, ref, bound) <= 0
    assert (sound - ref).abs().max().item() > \
        0.05 * (bound - 1e-4).max().item()
    assert _excess(fault, ref, bound) > 0


@pytest.mark.parametrize("out", ["o", "dk", "dv", "dq"])
def test_reading_64_of_96_columns_breaks_the_bounds(out):
    """At d 96 the bounds are not loose (the roundings' own error fills a
    fair part of them), and an emulation that reads only the first 64
    columns (as a kernel built for 64-column halves would) exceeds them
    for o, dK, dV and dQ alike."""
    _first_columns_check(out, 96, 64, seed=5)


@pytest.mark.parametrize("out", ["o", "dk", "dv", "dq"])
def test_reading_128_of_256_columns_breaks_the_bounds(out):
    """At d 256 likewise for the 64-key forward, the column-split dK/dV
    and the 32-key dQ: an emulation that reads only the first 128 columns
    (as a kernel that loaded two of the four chunks would) exceeds the
    bounds of o, dK, dV and dQ."""
    _first_columns_check(out, 256, 128, seed=6)
