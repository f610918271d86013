"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device. The
file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py
"""
import importlib
import os
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import (counters, flash_attention,
                                      flash_attention_plain,
                                      flash_attention_with_lse,
                                      paged_attention, paged_attention_plain,
                                      reset_counters)
from paddle_tpu_torch.kernels import rmsnorm, rope
from paddle_tpu_torch.kernels.flash_attention import (
    flash_attention_bwd_dkv, flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq, flash_attention_bwd_dq_plain,
    flash_attention_fwd, route, sm90_dkv_bound, sm90_dq_bound,
    sm90_fwd_bound, takes_sm90, takes_tf32x3)

# the one-device pipeline step, a harness (tools/pipeline_harness.py)
sys.path.append(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

# the module (the package re-exports a function of the same name)
pa = importlib.import_module("paddle_tpu_torch.kernels.paged_attention")


def _close(a, b, tol):
    rtol, atol = tol
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=rtol,
                               atol=atol)


def _within(got, ref, bound, what):
    """|got - ref| <= bound elementwise (the tensor-core kernels' bound)."""
    excess = ((got.float() - ref).abs() - bound).max().item()
    assert excess <= 0, f"{what}: exceeds its bound by {excess}"


def _counter(name, dtype, d, sq=None):
    """The counter of the kernel that ``name``'s wrapper picks: for a
    forward (``sq`` given) the decode kernel (``name``_decode) where
    ``route`` says so; else the tensor-core one (``name``_sm90) where
    ``takes_sm90``, the fp32 tensor-core one (``name``_tf32x3) where
    ``takes_tf32x3``, and the CUDA-core one for the rest."""
    if sq is not None and route(dtype, d, sq) == "decode":
        return name + "_decode"
    if takes_sm90(dtype, d, sq):
        return name + "_sm90"
    if takes_tf32x3(dtype, d, sq):
        return name + "_tf32x3"
    return name


# (rtol, atol) against the plain version on fp32 copies of the inputs:
# fp32 differs by summation order; bf16 adds one rounding of the result,
# at most half an ulp (2**-8 of the value)
_TOLS = [(torch.float32, (0.0, 1e-4)), (torch.bfloat16, (2.0 ** -8, 1e-4))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


_PAGED_COUNTERS = {"decode": "paged_attention_decode",
                   "sm90": "paged_attention_sm90",
                   "cuda_core": "paged_attention"}


def _paged_case(cuda, dtype, nh, kvh, hd, PL, W, lens, idle=(), B=None,
                seed=9):
    """Inputs at one shape: slot s's window starts at lens[s] (pos = lens +
    w, negative rows see no key); every slot owns distinct random pages
    and the slots in ``idle`` an all-zero table (the scratch page), as in
    the engine. With ``B`` given, the tables are B pages wide whatever
    lens says, so a slot's pos may run past its table (as the engine's
    padded prefill rows near ``max_seq_len`` do), and their entries are
    drawn from 40 pages with repeats, the scratch page mid-table."""
    rng = np.random.default_rng(seed)
    S = len(lens)
    shared = B is not None
    if not shared:
        B = max(1, -(-(max(lens) + W) // PL))
    P = 40 if shared else S * B + 1

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    q, ka, va = rnd(S, W, nh, hd), rnd(P, PL, kvh, hd), rnd(P, PL, kvh, hd)
    if shared:
        tables = torch.from_numpy(rng.integers(0, P, (S, B)).astype(np.int32))
        tables[0, B // 2] = 0
    else:
        tables = torch.from_numpy((rng.permutation(P - 1)[:S * B] + 1)
                                  .reshape(S, B).astype(np.int32))
    tables[list(idle)] = 0
    pos = torch.tensor(lens, dtype=torch.int32)[:, None] + \
        torch.arange(W, dtype=torch.int32)
    return ([t.to(cuda).to(dtype) for t in (q, ka, va)]
            + [tables.to(cuda), pos.to(cuda)])


def _check_paged(got, args, hd):
    """Against the plain version on fp32 copies: the window kernel within
    ``sm90_paged_bound``, the others within one rounding of the result."""
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    scale = 1.0 / hd ** 0.5
    ref = paged_attention_plain(*f32, scale)
    which = pa.route(args[0].dtype, hd, args[0].shape[1],
                     args[0].shape[2] // args[1].shape[2], args[1].shape[1])
    if which == "sm90":
        _within(got, ref, pa.sm90_paged_bound(*f32, scale, ref), "o")
    else:
        _close(got.float().cpu(), ref.cpu(), dict(_TOLS)[args[0].dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,kvh,hd,PL,W,lens,idle,B", [
    (4, 4, 16, 4, 2, (0, 5, 27), (), None),           # the general kernel
    (4, 2, 16, 4, 2, (0, 5, 27), (), None),
    (6, 2, 12, 5, 2, (0, 6, 33), (), None),
    (8, 2, 128, 16, 5, (0, 17, 99), (), None),
    (32, 32, 128, 16, 1, (0, 17, 99), (), None),      # decode
    (32, 32, 128, 16, 1, (0, 63, 2046), (), None),    # 1, 64, 2047 keys
    (32, 32, 128, 16, 1, (-1, 0, 370), (1,), None),   # no key; idle slot
    (32, 4, 128, 16, 1, (5, 300, 1000), (), None),    # GQA 8
    (16, 8, 64, 32, 1, (3, 64, 513), (), None),       # GQA 2, PL 32, hd 64
    (8, 8, 8, 16, 1, (2, 40, 77), (), None),          # hd 8
    (4, 4, 256, 16, 1, (2, 40, 700), (), None),       # hd 256
    (8, 2, 128, 16, 5, (-3, 59, 2042), (), None),     # rows see none
    (16, 8, 128, 32, 63, (0, 64, 256), (), None),     # W 63, 256 prefix
    (32, 4, 64, 16, 65, (0, 1, 500), (), None),       # W 65, GQA 8
    (8, 8, 128, 16, 130, (256, 0, 0), (1, 2), None),  # W 130, idle slots
    (4, 2, 128, 8, 200, (0, 1000, 3), (), None),      # PL 8
    # tables of B = 6 pages, random with repeats and the scratch page
    # mid-table; slot 2's pos runs past the table (to B * PL + 3 and on)
    (4, 4, 16, 4, 2, (0, 5, 27), (), 6),
    (4, 2, 16, 4, 2, (0, 5, 27), (), 6),
    (6, 2, 12, 5, 2, (0, 6, 33), (), 6),
    (8, 2, 128, 16, 5, (0, 17, 99), (), 6),
    (8, 2, 128, 16, 130, (0, 40, 50), (), 6),         # W 130 over the end
    (32, 32, 128, 16, 1, (0, 17, 99), (), 6),
    (32, 8, 128, 16, 1, (0, 17, 99), (), 6),          # decode, GQA 4
    (4, 4, 256, 16, 1, (2, 40, 100), (), 6)])         # decode, hd 256
def test_paged_attention_kernel_matches_plain(cuda, nh, kvh, hd, PL, W, lens,
                                              idle, B, dtype):
    """Each CUDA call runs the one kernel ``route`` names (its counter reads
    1, the other two 0): decode at W = 1, the tensor-core window kernel for
    bf16 windows, the general kernel for the rest; each against the plain
    version."""
    args = _paged_case(cuda, dtype, nh, kvh, hd, PL, W, lens, idle, B)
    reset_counters()
    got = paged_attention(*args)
    torch.cuda.synchronize()
    want = _PAGED_COUNTERS[pa.route(dtype, hd, W, nh // kvh, PL)]
    c = counters()
    assert {n: c[n]["launches"] for n in _PAGED_COUNTERS.values()} == \
        {n: int(n == want) for n in _PAGED_COUNTERS.values()}
    _check_paged(got, args, hd)


@pytest.mark.gpu
@pytest.mark.parametrize("lens,idle", [
    ((0, 15, 16, 100, 511, 1000, 2042, 2043), ()),
    ((300, 0, 0, 1900, 0, 64, 0, 7), (1, 2, 4, 6))])
def test_paged_attention_verify_window_at_w5(cuda, lens, idle):
    """The speculative verify window (W = spec_tokens + 1 = 5) as the
    engine runs it at GPT-3 6.7B's heads: bf16, 32 heads of 128, page 16,
    8 slots, some idle on the scratch page, windows up to the last
    positions; the tensor-core window kernel, once, within
    ``sm90_paged_bound`` of the plain version."""
    args = _paged_case(cuda, torch.bfloat16, 32, 32, 128, 16, 5, lens, idle,
                       B=128)
    assert pa.route(torch.bfloat16, 128, 5, 1, 16) == "sm90"
    reset_counters()
    got = paged_attention(*args)
    torch.cuda.synchronize()
    c = counters()
    assert {n: c[n]["launches"] for n in _PAGED_COUNTERS.values()} == \
        {n: int(n == "paged_attention_sm90") for n in _PAGED_COUNTERS.values()}
    _check_paged(got, args, 128)


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 130])
def test_paged_attention_takes_a_q_that_is_not_16_byte_aligned(cuda, W):
    """TMA and 16-byte loads need aligned starts: the wrapper clones a q
    that does not have one, and the result still matches."""
    args = _paged_case(cuda, torch.bfloat16, 8, 2, 128, 16, W, (3, 200))
    flat = torch.empty(args[0].numel() + 1, dtype=torch.bfloat16,
                       device=cuda)
    q = flat[1:].view(args[0].shape)
    q.copy_(args[0])
    assert q.data_ptr() % 16 != 0
    got = paged_attention(q, *args[1:])
    torch.cuda.synchronize()
    _check_paged(got, args, 128)


@pytest.mark.gpu
def test_paged_attention_raises_where_no_kernel_takes_it(cuda):
    args = _paged_case(cuda, torch.float16, 4, 4, 64, 16, 1, (3, 20))
    reset_counters()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        paged_attention(*args)
    assert all(counters()[n] == {"launches": 0, "plain_calls": 0}
               for n in _PAGED_COUNTERS.values())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _TOLS)
@pytest.mark.parametrize("sq,sk,offset,causal,d", [
    (1, 33, 32, True, 128), (33, 33, 0, True, 128), (300, 300, 0, True, 64),
    (16, 40, 4, True, 16), (16, 16, -4, True, 32), (7, 19, 0, False, 128)])
def test_flash_attention_kernel_matches_plain(cuda, sq, sk, offset, causal,
                                              d, dtype, tol):
    rng = np.random.default_rng(10)
    bh = 3
    qkv = [torch.from_numpy(rng.standard_normal((bh, s, d),
                                                dtype=np.float32))
           .to(cuda).to(dtype) for s in (sq, sk, sk)]
    reset_counters()
    o, lse = flash_attention_with_lse(*qkv, offset, causal)
    torch.cuda.synchronize()
    f32 = [t.float() for t in qkv]
    ro, rl = flash_attention_plain(*f32, offset, causal, 1.0 / d ** 0.5)
    fwd = _counter("flash_attention", dtype, d, sq)
    assert counters()[fwd]["launches"] == 1
    if takes_sm90(dtype, d, sq):
        _within(o, ro, sm90_fwd_bound(*f32, offset, causal, 1.0 / d ** 0.5,
                                      ro), "o")
    else:
        _close(o.float().cpu(), ro.cpu(), tol)
    _close(lse.cpu(), rl.cpu(), (0.0, 1e-3))


# backward kernels: both sides sum fp32 products in different orders over up
# to sq (dK/dV) or sk (dQ) terms, hence an rtol of 1e-4 in fp32
_BWD_TOLS = [(torch.float32, (1e-4, 1e-4)),
             (torch.bfloat16, (2.0 ** -8 + 1e-4, 1e-4))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _BWD_TOLS)
@pytest.mark.parametrize("sq,sk,offset,causal,d", [
    (33, 33, 0, True, 128), (300, 300, 0, True, 64), (16, 40, 4, True, 16),
    (24, 32, 3, True, 128), (16, 16, -4, True, 32), (7, 19, 0, False, 128),
    (20, 20, 0, True, 256)])
def test_flash_attention_backward_kernels_match_plain(cuda, sq, sk, offset,
                                                      causal, d, dtype, tol):
    """dK/dV and dQ kernels against their plain versions on fp32 copies of
    the same inputs; ragged lengths, a causal offset, rows that see no key
    (offset -4: their dq must be exactly 0), head dims 16-256. The
    tensor-core kernels are held to the bounds of their bf16 roundings."""
    rng = np.random.default_rng(11)
    bh, scale = 3, 1.0 / d ** 0.5

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    q, k, v, do = (rnd(bh, s, d).to(cuda).to(dtype)
                   for s in (sq, sk, sk, sq))
    f32 = [t.float() for t in (q, k, v, do)]
    o, lse = flash_attention_plain(*f32[:3], offset, causal, scale)
    delta = (f32[3] * o).sum(-1) - rnd(bh, sq).to(cuda)
    args = (lse, delta, offset, causal, scale)
    reset_counters()
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, *args)
    dq = flash_attention_bwd_dq(q, k, v, do, *args)
    torch.cuda.synchronize()
    c = counters()
    assert c[_counter("flash_attention_bwd_dkv", dtype, d)]["launches"] == 1
    assert c[_counter("flash_attention_bwd_dq", dtype, d)]["launches"] == 1
    rdk, rdv = flash_attention_bwd_dkv_plain(*f32, *args)
    rdq = flash_attention_bwd_dq_plain(*f32, *args)
    for got, ref in ((dk, rdk), (dv, rdv), (dq, rdq)):
        assert got.dtype == dtype
    if takes_sm90(dtype, d):
        bdk, bdv = sm90_dkv_bound(*f32, *args, rdk, rdv)
        _within(dk, rdk, bdk, "dk")
        _within(dv, rdv, bdv, "dv")
    else:
        _close(dk.float().cpu(), rdk.cpu(), tol)
        _close(dv.float().cpu(), rdv.cpu(), tol)
    if takes_sm90(dtype, d):
        _within(dq, rdq, sm90_dq_bound(*f32, *args, rdq), "dq")
    else:
        _close(dq.float().cpu(), rdq.cpu(), tol)
    if offset < 0:
        assert not dq[:, :-offset].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _TOLS)
def test_flash_attention_autograd_uses_the_kernels(cuda, dtype, tol):
    """Gradients through ``flash_attention_with_lse`` (o and lse both used)
    equal the plain backward's and launch each backward kernel once: at
    bf16 the tensor-core dK/dV and dQ kernels, and no CUDA-core one."""
    rng = np.random.default_rng(12)
    bh, sq, d = 2, 40, 64
    leaves = [torch.from_numpy(rng.standard_normal((bh, sq, d),
                                                   dtype=np.float32))
              .to(cuda).to(dtype).requires_grad_() for _ in range(3)]
    go = torch.from_numpy(rng.standard_normal((bh, sq, d),
                                              dtype=np.float32)).to(cuda)
    gl = torch.from_numpy(rng.standard_normal((bh, sq),
                                              dtype=np.float32)).to(cuda)
    reset_counters()
    o, lse = flash_attention_with_lse(*leaves, 0, True)
    torch.autograd.backward([o, lse], [go.to(dtype), gl])
    torch.cuda.synchronize()
    c = counters()
    assert c[_counter("flash_attention", dtype, d, sq)]["launches"] == 1
    assert c[_counter("flash_attention_bwd_dkv", dtype, d)]["launches"] == 1
    assert c[_counter("flash_attention_bwd_dq", dtype, d)]["launches"] == 1
    if dtype == torch.bfloat16:
        assert c["flash_attention_bwd_dkv"]["launches"] == 0
        assert c["flash_attention_bwd_dq"]["launches"] == 0
    f32 = [t.detach().float() for t in leaves]
    ro, rl = flash_attention_plain(*f32, 0, True, 1.0 / d ** 0.5)
    delta = (go.to(dtype).float() * o.detach().float()).sum(-1) - gl
    args = (lse.detach(), delta, 0, True, 1.0 / d ** 0.5)
    rdk, rdv = flash_attention_bwd_dkv_plain(*f32, go.to(dtype).float(),
                                                *args)
    rdq = flash_attention_bwd_dq_plain(*f32, go.to(dtype).float(), *args)
    btol = _BWD_TOLS[0 if dtype == torch.float32 else 1][1]
    if takes_sm90(dtype, d):
        bdk, bdv = sm90_dkv_bound(*f32, go.to(dtype).float(), *args, rdk,
                                  rdv)
        _within(leaves[1].grad, rdk, bdk, "dk")
        _within(leaves[2].grad, rdv, bdv, "dv")
    else:
        _close(leaves[1].grad.float().cpu(), rdk.cpu(), btol)
        _close(leaves[2].grad.float().cpu(), rdv.cpu(), btol)
    if takes_sm90(dtype, d):
        _within(leaves[0].grad, rdq, sm90_dq_bound(
            *f32, go.to(dtype).float(), *args, rdq), "dq")
    else:
        _close(leaves[0].grad.float().cpu(), rdq.cpu(), btol)


# the tensor-core kernels at tile edges: lengths that 64 and 128 do not
# divide with a causal offset, rows that see no key (offset -8), non-causal,
# head dims 64 and 128, two query rows against a long cache, bh 3
_SM90_CASES = [(300, 340, 40, True, 128), (300, 340, 40, True, 64),
               (64, 64, -8, True, 128), (100, 77, 0, False, 128),
               (130, 130, 0, True, 64), (2, 200, 198, True, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("sq,sk,offset,causal,d", _SM90_CASES)
def test_flash_attention_sm90_kernels_match_plain(cuda, sq, sk, offset,
                                                  causal, d):
    """The tensor-core forward, dK/dV and dQ kernels against the fp32 plain
    versions on the same bf16 inputs, each output within the bound of its
    bf16 roundings (``sm90_fwd_bound``, ``sm90_dkv_bound``,
    ``sm90_dq_bound``); only the tensor-core counters rise. Rows that see
    no key give o = 0 and dQ = 0 exactly and, given a dO of 1000, still
    add nothing to dK and dV."""
    rng = np.random.default_rng(19)
    bh, scale = 3, 1.0 / d ** 0.5

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(cuda)

    q, k, v, do = (rnd(bh, s, d).to(torch.bfloat16)
                   for s in (sq, sk, sk, sq))
    if offset < 0:
        do[:, :-offset] *= 1000
    f32 = [t.float() for t in (q, k, v, do)]
    reset_counters()
    o, lse = flash_attention_fwd(q, k, v, offset, causal, scale)
    torch.cuda.synchronize()
    c = counters()
    assert c["flash_attention_sm90"]["launches"] == 1
    assert c["flash_attention"]["launches"] == 0
    ro, rl = flash_attention_plain(*f32[:3], offset, causal, scale)
    _within(o, ro, sm90_fwd_bound(*f32[:3], offset, causal, scale, ro), "o")
    _close(lse.cpu(), rl.cpu(), (0.0, 1e-3))
    if offset < 0:
        assert not o[:, :-offset].any()
    delta = (f32[3] * ro).sum(-1) - rnd(bh, sq)
    args = (rl, delta, offset, causal, scale)
    reset_counters()
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, *args)
    dq = flash_attention_bwd_dq(q, k, v, do, *args)
    torch.cuda.synchronize()
    c = counters()
    assert c["flash_attention_bwd_dkv_sm90"]["launches"] == 1
    assert c["flash_attention_bwd_dkv"]["launches"] == 0
    assert c["flash_attention_bwd_dq_sm90"]["launches"] == 1
    assert c["flash_attention_bwd_dq"]["launches"] == 0
    rdk, rdv = flash_attention_bwd_dkv_plain(*f32, *args)
    bdk, bdv = sm90_dkv_bound(*f32, *args, rdk, rdv)
    _within(dk, rdk, bdk, "dk")
    _within(dv, rdv, bdv, "dv")
    rdq = flash_attention_bwd_dq_plain(*f32, *args)
    _within(dq, rdq, sm90_dq_bound(*f32, *args, rdq), "dq")
    if offset < 0:
        assert not dq[:, :-offset].any()


# the offsets a ring of cp chunks of s rows gives the kernels: a chunk
# wholly in the future (every row sees no key), wholly in the past (every
# key visible), and odd lengths that no tile divides
_RING_OFFSET_CASES = [(256, -256), (256, 256), (256, 768), (200, -200),
                      (200, -157), (200, 157), (200, 600)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,offset", _RING_OFFSET_CASES)
def test_flash_kernels_at_ring_offsets(cuda, s, offset, dtype):
    """Forward, dK/dV and dQ (bf16: the tensor-core kernels, held to their
    bounds; fp32: the 3xTF32 kernels, 1e-4) at the ring's offsets against
    the plain versions, with a nonzero lse cotangent. A chunk wholly in the
    future gives o = 0, lse = -1e30 and dQ = dK = dV = 0 exactly."""
    rng = np.random.default_rng(23)
    bh, d, scale = 2, 128, 1.0 / 128 ** 0.5

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(cuda)

    q, k, v, do = (rnd(bh, s, d).to(dtype) for _ in range(4))
    f32 = [t.float() for t in (q, k, v, do)]
    sm90 = takes_sm90(dtype, d, s)
    reset_counters()
    o, lse = flash_attention_fwd(q, k, v, offset, True, scale)
    ro, rl = flash_attention_plain(*f32[:3], offset, True, scale)
    delta = (f32[3] * ro).sum(-1) - rnd(bh, s)
    args = (rl, delta, offset, True, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, *args)
    dq = flash_attention_bwd_dq(q, k, v, do, *args)
    torch.cuda.synchronize()
    c = counters()
    for name in ("flash_attention", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        assert c[_counter(name, dtype, d, s if name == "flash_attention"
                          else None)]["launches"] == 1
        assert c[name]["plain_calls"] == 0
    rdk, rdv = flash_attention_bwd_dkv_plain(*f32, *args)
    rdq = flash_attention_bwd_dq_plain(*f32, *args)
    if sm90:
        _within(o, ro, sm90_fwd_bound(*f32[:3], offset, True, scale, ro),
                "o")
        bdk, bdv = sm90_dkv_bound(*f32, *args, rdk, rdv)
        _within(dk, rdk, bdk, "dk")
        _within(dv, rdv, bdv, "dv")
        _within(dq, rdq, sm90_dq_bound(*f32, *args, rdq), "dq")
    else:
        for got, ref in ((o, ro), (dk, rdk), (dv, rdv), (dq, rdq)):
            _close(got.float().cpu(), ref.cpu(), (0.0, 1e-4))
    _close(lse.cpu(), rl.cpu(), (0.0, 1e-3))
    if offset <= -s:
        for t in (o, dk, dv, dq):
            assert not t.any()
        assert (lse == -1e30).all()


@pytest.mark.gpu
def test_flash_attention_picks_its_kernel(cuda):
    """bf16 at a head dim that is a multiple of 8 up to 128 (32, 64, 96,
    128) with more than one row takes the tensor-core kernels, and at 136
    and 256 the tensor-core forward and dK/dV with the CUDA-core dQ; a
    single-row forward the decode kernel (its backward the kernels its
    dtype and head dim pick); fp32 at a head dim that is a multiple of 8
    up to 128 the 3xTF32 kernels; bf16 at head dim 12 and fp32 at 36 and
    256 with more rows the CUDA-core ones; a CUDA tensor that none takes
    raises."""
    def run(dtype, sq, d):
        q = torch.randn(2, sq, d, device=cuda).to(dtype)
        k = torch.randn(2, 40, d, device=cuda).to(dtype)
        reset_counters()
        flash_attention_fwd(q, k, k, 40 - sq, True, 0.1)
        stats = (torch.zeros(2, sq, device=cuda),) * 2
        flash_attention_bwd_dkv(q, k, k, q, *stats, 40 - sq, True, 0.1)
        flash_attention_bwd_dq(q, k, k, q, *stats, 40 - sq, True, 0.1)
        torch.cuda.synchronize()
        c = counters()
        return [n for n in ("flash_attention", "flash_attention_sm90",
                            "flash_attention_tf32x3",
                            "flash_attention_decode",
                            "flash_attention_bwd_dkv",
                            "flash_attention_bwd_dkv_sm90",
                            "flash_attention_bwd_dkv_tf32x3",
                            "flash_attention_bwd_dq",
                            "flash_attention_bwd_dq_sm90",
                            "flash_attention_bwd_dq_tf32x3")
                if c[n]["launches"]]

    sm90_bwd = ["flash_attention_bwd_dkv_sm90", "flash_attention_bwd_dq_sm90"]
    tf32x3_bwd = ["flash_attention_bwd_dkv_tf32x3",
                  "flash_attention_bwd_dq_tf32x3"]
    cuda_core_bwd = ["flash_attention_bwd_dkv", "flash_attention_bwd_dq"]
    assert run(torch.bfloat16, 8, 128) == ["flash_attention_sm90"] + sm90_bwd
    assert run(torch.bfloat16, 8, 64) == ["flash_attention_sm90"] + sm90_bwd
    assert run(torch.bfloat16, 1, 128) == ["flash_attention_decode"] + \
        sm90_bwd
    assert run(torch.float32, 1, 128) == ["flash_attention_decode"] + \
        tf32x3_bwd
    assert run(torch.float32, 8, 128) == ["flash_attention_tf32x3"] + \
        tf32x3_bwd
    assert run(torch.float32, 8, 72) == ["flash_attention_tf32x3"] + \
        tf32x3_bwd
    assert run(torch.float32, 8, 36) == ["flash_attention"] + cuda_core_bwd
    assert run(torch.bfloat16, 8, 32) == ["flash_attention_sm90"] + sm90_bwd
    assert run(torch.bfloat16, 8, 96) == ["flash_attention_sm90"] + sm90_bwd
    assert run(torch.bfloat16, 1, 96) == ["flash_attention_decode"] + \
        sm90_bwd
    assert run(torch.bfloat16, 8, 12) == ["flash_attention"] + cuda_core_bwd
    wide_bwd = ["flash_attention_bwd_dkv_sm90", "flash_attention_bwd_dq_sm90"]
    assert run(torch.bfloat16, 8, 136) == ["flash_attention_sm90"] + wide_bwd
    assert run(torch.bfloat16, 8, 256) == ["flash_attention_sm90"] + wide_bwd
    assert run(torch.bfloat16, 1, 256) == ["flash_attention_decode"] + \
        wide_bwd
    assert run(torch.float32, 8, 256) == ["flash_attention"] + cuda_core_bwd
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_fwd(*[torch.zeros(1, 4, 64, device=cuda,
                                          dtype=torch.float16)] * 3, 0,
                            True, 0.1)


# the decode kernel: (b, h, sk, d, offset, causal). bh 32 at 640 keys (the
# kernels phase's decode1x640), bh 64 at 100 (serving's generate), 2047
# keys, head dims 8 to 256 (one to 64 chunks a row), a causal cut, a row
# that sees no key, one key, and no mask
_DECODE_CASES = [(2, 16, 640, 128, 639, True), (2, 32, 100, 128, 99, True),
                 (1, 32, 2047, 128, 2046, True), (2, 4, 640, 64, 639, True),
                 (2, 4, 640, 128, 300, True), (2, 4, 64, 128, -1, True),
                 (2, 4, 1, 128, 0, True), (2, 4, 77, 128, 0, False),
                 (3, 2, 300, 256, 299, True), (3, 2, 40, 16, 39, True),
                 (3, 2, 40, 8, 39, True)]


def _decode_inputs(cuda, dtype, b, h, sk, d, seed=23):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, s, h, d),
                                                 dtype=np.float32))
            .to(cuda).to(dtype) for s in (1, sk, sk)]


def _check_decode(o, lse, q, k, v, offset, causal, tol):
    """o [b, 1, h, d] and lse [b, h] against ``flash_attention_plain`` on
    fp32 copies; a row that sees no key gives o = 0 and lse = -1e30
    exactly."""
    b, _one, h, d = q.shape

    def bhsd(t):
        return t.float().transpose(1, 2).reshape(b * h, t.shape[1], d)

    ro, rl = flash_attention_plain(bhsd(q), bhsd(k), bhsd(v), offset, causal,
                                   1.0 / d ** 0.5)
    _close(bhsd(o).cpu(), ro.cpu(), tol)
    if lse is not None:
        _close(lse.reshape(-1).cpu(), rl.reshape(-1).cpu(), (0.0, 1e-3))
    if causal and offset < 0:
        assert not o.any()
        assert lse is None or bool((lse == -1e30).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _TOLS)
@pytest.mark.parametrize("b,h,sk,d,offset,causal", _DECODE_CASES)
def test_flash_decode_kernel_matches_plain(cuda, b, h, sk, d, offset, causal,
                                           dtype, tol):
    """The split-K decode kernel, through ``flash_attention_fwd`` on [bh,
    1, d] rows: its counter reads 1 and the other forwards' 0, o within one
    rounding of the fp32 plain version and lse within 1e-3."""
    q, k, v = _decode_inputs(cuda, dtype, b, h, sk, d)

    def bhsd(t):
        return t.transpose(1, 2).reshape(b * h, t.shape[1], d)

    reset_counters()
    o, lse = flash_attention_fwd(bhsd(q), bhsd(k), bhsd(v), offset, causal,
                                 1.0 / d ** 0.5)
    torch.cuda.synchronize()
    c = counters()
    assert [c[n]["launches"] for n in ("flash_attention_decode",
                                       "flash_attention",
                                       "flash_attention_sm90")] == [1, 0, 0]
    assert o.shape == (b * h, 1, d) and lse.shape == (b * h, 1)
    _check_decode(o.view(b, h, 1, d).transpose(1, 2),
                  lse.view(b, h), q, k, v, offset, causal, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _TOLS)
@pytest.mark.parametrize("layout", ["qkv_view", "unaligned_q", "gqa_expand",
                                    "contiguous"])
def test_flash_decode_reads_the_paddle_layout_in_place(cuda, layout, dtype,
                                                       tol):
    """``flash_attention`` (paddle layout) at one query row and no gradient
    launches the decode kernel on its [b, s, h, d] views: q a view into a
    fused QKV projection (read in place, as k and v), q off a 16-byte
    boundary (copied), kv heads expanded with a stride of 0 (read in
    place)."""
    fa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    b, h, sk, d = 2, 8, 300, 128
    q, k, v = _decode_inputs(cuda, dtype, b, h, sk, d, seed=24)
    if layout == "qkv_view":
        qkv = torch.stack([q, q, q], dim=2)         # [b, 1, 3, h, d]
        q = qkv[:, :, 0]
        assert fa._in_place(q) is q
    elif layout == "unaligned_q":
        flat = torch.empty(q.numel() + 1, dtype=dtype, device=cuda)
        q = flat[1:].view(q.shape).copy_(q)
        assert q.data_ptr() % 16 != 0
    elif layout == "gqa_expand":
        k, v = (t[:, :, :1].expand(b, sk, h, d) for t in (k, v))
        assert k.stride(2) == 0 and fa._in_place(k) is k
    reset_counters()
    with torch.no_grad():
        o = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    c = counters()
    assert c["flash_attention_decode"]["launches"] == 1
    assert c["flash_attention"]["launches"] == 0
    assert o.shape == (b, 1, h, d)
    _check_decode(o, None, q, k, v, sk - 1, True, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _TOLS)
@pytest.mark.parametrize("n,h", [(5, 40), (33, 129), (1030, 2048),
                                 (3, 16384), (7, 1), (9, 1001), (65, 1536),
                                 (4, 8192), (1, 2048), (2, 512), (100, 2048),
                                 (6401, 2048), (300, 1536)])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("start", [0, 1])
def test_rms_norm_kernels_match_plain(cuda, n, h, residual, start, dtype,
                                      tol):
    """Forward (y, s, rstd) and backward (dx, dw) kernels against their plain
    versions; widths that are not a multiple of 32 or of a 16-byte vector
    (1, 129, 1001: the forward's scalar instance), the training steps'
    widths (2048, 1536) and wider ones (8192, 16384: the looping
    instance), ragged row counts and one row, a width whose dw partial row
    needs more than 48 KB of shared memory, and (``start`` 1) x and the
    residual one element off a 16-byte boundary. The backward's plan on
    132 SMs: 100 rows are fewer than its 264 blocks; 6401 rows are one
    more than 256 blocks of 25 (the last block holds one row, seven
    none); fp32 rows of 1536 and 2048 take its looping instance. dw sums
    n rows in another order: rtol 1e-4 on top of ``tol``. A second
    backward is bitwise the first."""
    rng = np.random.default_rng(13)

    def rnd(*shape):
        t = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                             ).to(cuda).to(dtype)
        if start:
            flat = torch.empty(t.numel() + start, dtype=dtype, device=cuda)
            t = flat[start:].view(t.shape).copy_(t)
            assert t.data_ptr() % 16 != 0
        return t

    x, res, dy, dr = rnd(n, h), rnd(n, h), rnd(n, h), rnd(n, h)
    w = (1.0 + 0.1 * rnd(h).float()).to(dtype)
    r = res if residual else None
    dr = dr if residual else None
    reset_counters()
    y, s, rstd = rmsnorm.rms_norm_fwd(x, r, w, 1e-5)
    dx, dw = rmsnorm.rms_norm_bwd(s, w, rstd, dy, dr)
    torch.cuda.synchronize()
    name = "rms_norm_residual" if residual else "rms_norm"
    assert counters()[name]["launches"] == 1
    assert counters()[name + "_bwd"]["launches"] == 1
    f = [None if t is None else t.float() for t in (x, r, w, dy, dr)]
    ry, rs, rrstd = rmsnorm.rms_norm_fwd_plain(f[0], f[1], f[2], 1e-5)
    _close(y.float().cpu(), ry.cpu(), tol)
    _close(s.float().cpu(), rs.cpu(), tol)
    _close(rstd.cpu(), rrstd.cpu(), (1e-5, 0.0))
    # the backward on the kernel's own saved s and rstd
    rdx, rdw = rmsnorm.rms_norm_bwd_plain(s.float(), f[2], rstd, f[3], f[4])
    _close(dx.float().cpu(), rdx.cpu(), tol)
    _close(dw.float().cpu(), rdw.cpu(), (tol[0] + 1e-4, tol[1]))
    dx2, dw2 = rmsnorm.rms_norm_bwd(s, w, rstd, dy, dr)
    assert torch.equal(dx2, dx) and torch.equal(dw2, dw)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _TOLS)
@pytest.mark.parametrize("shape,pos_offset,theta", [
    ((2, 7, 3, 16), 0, 1e4), ((1, 2048, 2, 128), 0, 1e4),
    ((2, 5, 3, 6), 2041, 1e4), ((1, 9, 4, 128), 100, 5e5)])
def test_rope_kernel_matches_plain(cuda, shape, pos_offset, theta, dtype,
                                   tol):
    """Forward and inverse rotation against the plain version; positions up
    to 2047, where an angle is ~2000 rad. atol 1e-3 covers one or two ulps
    of inv_i times a position of 2047 (~2.4e-4 rad) on inputs up to ~4.
    The inverse undoes the forward to fp32 rounding."""
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                         ).to(cuda).to(dtype)
    rtol = tol[0]
    reset_counters()
    fwd = rope.rope(x, theta, pos_offset, False)
    inv = rope.rope(x, theta, pos_offset, True)
    torch.cuda.synchronize()
    assert counters()["rope"]["launches"] == 1
    assert counters()["rope_inverse"]["launches"] == 1
    for got, inverse in ((fwd, False), (inv, True)):
        ref = rope.rope_plain(x.float(), theta, pos_offset, inverse)
        _close(got.float().cpu(), ref.cpu(), (rtol, 1e-3))
    if dtype == torch.float32:
        back = rope.rope(fwd, theta, pos_offset, True)
        _close(back.cpu(), x.cpu(), (0.0, 1e-5))


def _strided_rope_input(cuda, dtype, shape, layout, seed):
    """x [b, s, h, d] in one of the layouts the kernel reads in place:
    ``bhsd`` (a view of a contiguous [b, h, s, d] tensor, the cotangent
    that reaches RoPE's backward from the attention) or ``offset1`` (a
    contiguous tensor that starts one element past a 16-byte boundary)."""
    rng = np.random.default_rng(seed)
    b, s, h, d = shape
    if layout == "bhsd":
        a = rng.standard_normal((b, h, s, d), dtype=np.float32)
        return torch.from_numpy(a).to(cuda).to(dtype).transpose(1, 2)
    a = rng.standard_normal(shape, dtype=np.float32)
    flat = torch.empty(a.size + 1, dtype=dtype, device=cuda)
    return flat[1:].view(shape).copy_(torch.from_numpy(a).to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _TOLS)
@pytest.mark.parametrize("shape,layout,plan", [
    ((4, 64, 16, 128), "bhsd", "vector"), ((2, 9, 3, 16), "bhsd", "vector"),
    ((3, 17, 5, 128), "offset1", "scalar"), ((2, 7, 3, 6), "bhsd", "scalar"),
    ((2, 7, 3, 6), "offset1", "scalar")])
def test_rope_kernel_reads_strided_and_unaligned_rows(cuda, shape, layout,
                                                      plan, dtype, tol):
    """Forward and inverse on a strided or misaligned x, each against the
    plain version, through the instance ``rope_plan`` names; the result
    is contiguous [b, s, h, d]."""
    x = _strided_rope_input(cuda, dtype, shape, layout, 15)
    assert not x.is_contiguous() or x.data_ptr() % 16
    assert rope.rope_plan(x.shape, x.stride(), x.element_size(),
                          x.data_ptr()) == plan
    for inverse in (False, True):
        got = rope.rope(x, 1e4, 2041, inverse)
        torch.cuda.synchronize()
        assert got.is_contiguous() and got.shape == x.shape
        ref = rope.rope_plain(x.float(), 1e4, 2041, inverse)
        _close(got.float().cpu(), ref.cpu(), (tol[0], 1e-3))


@pytest.mark.gpu
def test_rope_backward_reads_the_transposed_cotangent_in_place(cuda):
    """``rope_apply``'s backward on the cotangent the attention leaves (a
    [b, s, h, d] view of [b, h, s, d]) launches one CUDA kernel, the RoPE
    kernel, and no copy, and equals the inverse rotation of that
    cotangent."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(2, 64, 4, 128, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    y = rope.rope_apply(x, 1e4, 0)
    g = _strided_rope_input(cuda, torch.bfloat16, (2, 64, 4, 128), "bhsd",
                            16)
    torch.cuda.synchronize()
    reset_counters()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        (dx,) = torch.autograd.grad(y, x, g)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "rope_kernel" in names[0], names
    assert counters()["rope_inverse"]["launches"] == 1
    ref = rope.rope_plain(g.float(), 1e4, 0, True)
    _close(dx.float().cpu(), ref.cpu(), (2.0 ** -8, 1e-3))


# -- MoE kernels ---------------------------------------------------------------

def _gmm_inputs(cuda, dtype, sizes, k, n, seed):
    """lhs scaled by 1/sqrt(k) and dout by 1/sqrt(n), so that the forward
    and dgrad products are O(1) and fp32 order differences stay near 1e-6
    (unscaled, dgrad at n = 2048 reads ~45 and order differences reach
    the atol)."""
    rng = np.random.default_rng(seed)
    m = int(sum(sizes)) + 3  # three rows past the groups: zeros
    lhs = rng.standard_normal((m, k), dtype=np.float32) / np.sqrt(k)
    rhs = rng.standard_normal((len(sizes), k, n), dtype=np.float32)
    dout = rng.standard_normal((m, n), dtype=np.float32) / np.sqrt(n)
    t = [torch.from_numpy(a).to(cuda).to(dtype) for a in (lhs, rhs, dout)]
    return t + [torch.tensor(sizes, dtype=torch.int32, device=cuda)]


_GMM_NAMES = ("grouped_matmul", "grouped_matmul_dgrad",
              "grouped_matmul_wgrad")


def _gmm_launches(c, sm90):
    """[forward, dgrad, wgrad] launches of the tensor-core (``sm90``) or
    the CUDA-core counters."""
    return [c[n + ("_sm90" if sm90 else "")]["launches"] for n in _GMM_NAMES]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-5, 1e-4)),
                                       (torch.bfloat16, (2.0 ** -8, 1e-4))],
                         ids=["float32", "bfloat16-sm90"])
@pytest.mark.parametrize("sizes,k,n", [
    ([0, 1, 300, 7, 0, 129], 64, 136), ([1000], 8, 8),
    ([128, 128, 0], 256, 128), ([5] * 128, 16, 24),
    ([256, 0, 128, 1, 63, 65], 192, 384), ([1, 0, 0, 2], 1544, 72),
    ([700, 333], 1536, 2048)])
def test_grouped_matmul_kernels_match_plain(cuda, sizes, k, n, dtype, tol):
    """Forward, dgrad (transposed rhs) and wgrad kernels against their plain
    versions: empty groups, 1-row groups, groups of exact and ragged tile
    multiples, 128 groups, rows past the groups' sum (zeros), k and n
    multiples of 8 that are not of the tile, and the MoE step's widths.
    bf16 runs the tensor-core kernels and fp32 the CUDA-core ones."""
    from paddle_tpu_torch.kernels import grouped_matmul as gm

    lhs, rhs, dout, gs = _gmm_inputs(cuda, dtype, sizes, k, n, 15)
    reset_counters()
    out = gm.gmm(lhs, rhs, gs)
    d_lhs = gm.gmm(dout, rhs, gs, trans_rhs=True)
    d_rhs = gm.tgmm(lhs, dout, gs)
    torch.cuda.synchronize()
    c = counters()
    sm90 = dtype == torch.bfloat16
    assert _gmm_launches(c, sm90) == [1, 1, 1]
    assert _gmm_launches(c, not sm90) == [0, 0, 0]
    f = [t.float() for t in (lhs, rhs, dout)]
    for got, ref in ((out, gm.gmm_plain(f[0], f[1], gs)),
                     (d_lhs, gm.gmm_plain(f[2], f[1], gs, True)),
                     (d_rhs, gm.tgmm_plain(f[0], f[2], gs))):
        assert got.dtype == dtype
        _close(got.float().cpu(), ref.cpu(), tol)
    assert not out[sum(sizes):].any() and not d_lhs[sum(sizes):].any()
    for g, s in enumerate(sizes):
        if s == 0:
            assert not d_rhs[g].any()


@pytest.mark.gpu
def test_grouped_matmul_rejects_what_the_kernel_does_not_take(cuda):
    from paddle_tpu_torch.kernels import grouped_matmul as gm

    lhs = torch.zeros(4, 12, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        gm.gmm(lhs, torch.zeros(2, 12, 16, device=cuda),
               torch.tensor([2, 2], dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="groups"):
        gm.gmm(torch.zeros(4, 8, device=cuda),
               torch.zeros(129, 8, 8, device=cuda),
               torch.zeros(129, dtype=torch.int32, device=cuda))
    bf = dict(device=cuda, dtype=torch.bfloat16)
    two = torch.tensor([2, 2], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        gm.gmm(torch.zeros(4, 12, **bf), torch.zeros(2, 12, 16, **bf), two)
    with pytest.raises(ValueError, match="multiples of 8"):
        gm.tgmm(torch.zeros(4, 8, **bf), torch.zeros(4, 20, **bf), two)
    with pytest.raises(TypeError, match="bfloat16"):
        gm.tgmm_sm90(torch.zeros(4, 8, device=cuda),
                     torch.zeros(4, 8, device=cuda), two)


@pytest.mark.gpu
def test_grouped_matmul_sm90_autograd_uses_the_tensor_core_kernels(cuda):
    """A bf16 forward and backward through ``grouped_matmul`` launches the
    tensor-core forward, dgrad and wgrad once each and no CUDA-core
    kernel, and its gradients agree with the plain versions'."""
    from paddle_tpu_torch.kernels import grouped_matmul as gm

    sizes = [0, 37, 128, 1, 90]
    lhs, rhs, dout, gs = _gmm_inputs(cuda, torch.bfloat16, sizes, 64, 136, 16)
    a, b = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
    reset_counters()
    out = gm.grouped_matmul(a, b, gs)
    out.backward(dout)
    torch.cuda.synchronize()
    c = counters()
    assert _gmm_launches(c, True) == [1, 1, 1]
    assert _gmm_launches(c, False) == [0, 0, 0]
    tol = (2.0 ** -8, 1e-4)
    f = [t.float() for t in (lhs, rhs, dout)]
    _close(out.detach().float().cpu(), gm.gmm_plain(f[0], f[1], gs).cpu(),
           tol)
    _close(a.grad.float().cpu(), gm.gmm_plain(f[2], f[1], gs, True).cpu(),
           tol)
    _close(b.grad.float().cpu(), gm.tgmm_plain(f[0], f[2], gs).cpu(), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_dkv", "flash_dq",
                                    "flash_fwd_d256", "flash_dkv_d256",
                                    "flash_dq_d256", "gmm", "gmm_dgrad", "tgmm", "paged",
                                    "flash_decode", "route", "rms_norm_bwd"])
def test_sm90_kernel_launches_from_a_fresh_thread(cuda, kernel):
    """Each tensor-core kernel, the decode kernel, the routing kernels and
    the RMSNorm backward (the flash forward, dK/dV and dQ also at head dim
    256, their instances above 128) as the first CUDA call of a new host
    thread (as
    autograd's worker thread makes it): cuTensorMapEncodeTiled encodes no
    TMA map in a thread without a current context, so the launcher must
    bind one first; the routing and backward launchers set their shared
    memory limits once and launch their second kernel as a programmatic
    dependent there too."""
    import importlib
    import threading

    from paddle_tpu_torch.kernels import grouped_matmul as gm
    from paddle_tpu_torch.kernels import moe_dispatch as md

    fa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    bf = dict(device=cuda, dtype=torch.bfloat16)
    q = torch.randn(2, 130, 128, **bf)
    q256 = torch.randn(2, 130, 256, **bf)
    stats = torch.zeros(2, 130, device=cuda)
    lhs, rhs = torch.randn(40, 64, **bf), torch.randn(2, 64, 72, **bf)
    dout = torch.randn(40, 72, **bf)
    sizes = torch.tensor([15, 25], dtype=torch.int32, device=cuda)
    paged = _paged_case(cuda, torch.bfloat16, 8, 2, 128, 16, 130, (40, 3))
    q4 = q[:, :1, None]  # [2, 1, 1, 128]: one row for the decode kernel
    rows = torch.randn(300, 1536, **bf)
    w_n = torch.ones(1536, **bf)
    rstd = torch.ones(300, device=cuda)
    calls = {
        "route": lambda: md.route(rows, torch.randn(1536, 8, **bf), 2),
        "rms_norm_bwd": lambda: rmsnorm.rms_norm_bwd(rows, w_n, rstd, rows,
                                                     rows),
        "flash_fwd": lambda: fa.flash_attention_fwd_sm90(q, q, q, 0, True,
                                                         0.1),
        "flash_decode": lambda: fa.flash_decode(q4, q[:, :, None],
                                                q[:, :, None], 129, True,
                                                0.1),
        "flash_dkv": lambda: fa.flash_attention_bwd_dkv_sm90(
            q, q, q, q, stats, stats, 0, True, 0.1),
        "flash_dq": lambda: fa.flash_attention_bwd_dq_sm90(
            q, q, q, q, stats, stats, 0, True, 0.1),
        "flash_fwd_d256": lambda: fa.flash_attention_fwd_sm90(
            q256, q256, q256, 0, True, 0.1),
        "flash_dkv_d256": lambda: fa.flash_attention_bwd_dkv_sm90(
            q256, q256, q256, q256, stats, stats, 0, True, 0.1),
        "flash_dq_d256": lambda: fa.flash_attention_bwd_dq_sm90(
            q256, q256, q256, q256, stats, stats, 0, True, 0.1),
        "gmm": lambda: gm.gmm_sm90(lhs, rhs, sizes),
        "gmm_dgrad": lambda: gm.gmm_sm90(dout, rhs, sizes, trans_rhs=True),
        "tgmm": lambda: gm.tgmm_sm90(lhs, dout, sizes),
        "paged": lambda: pa.paged_attention_sm90(*paged, 0.1)}
    torch.cuda.synchronize()
    errors = []

    def run():
        try:
            calls[kernel]()
            torch.cuda.synchronize()
        except Exception as e:  # reported in the main thread below
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert not errors, errors


def _route_inputs(cuda, dtype, n, h, e, seed, special=False):
    """Router inputs; with ``special`` expert e-1 gets no row and expert
    e-2 exactly one (token 0)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h), dtype=np.float32)
    wg = 0.3 * rng.standard_normal((h, e), dtype=np.float32)
    if special:
        x[:, 0] = 4.0
        x[:, 1] = 0.0
        x[0, 1] = 4.0
        wg[0, e - 1] = wg[0, e - 2] = -4.0
        wg[1, e - 2] = 12.0
    xt = torch.from_numpy(x).to(cuda).to(dtype)
    return xt, torch.from_numpy(wg).to(cuda).to(dtype)


def logit_margin(xt, wg, k):
    """Smallest gap between consecutive logits among a token's top k + 1
    (fp64). The fp32 logits of the kernel and the plain version differ by
    their summation order, some 1e-5 at h = 1536; a margin above 1e-4
    means that no near-tie decides a choice."""
    logits = xt.double() @ wg.double()
    top = logits.sort(dim=1, descending=True).values[:, :k + 1]
    return float((top[:, :-1] - top[:, 1:]).min())


# (n, h, e, k, special, seed): seeds whose inputs have a margin above 1e-4
_ROUTE_CASES = [(37, 64, 8, 2, True, 16), (1000, 1536, 8, 2, False, 16),
                (513, 96, 16, 1, True, 17), (200, 128, 128, 2, False, 16),
                (64, 40, 128, 8, False, 20), (8192, 1536, 8, 2, False, 17),
                # the plan's edges on 132 SMs (264 blocks): one token; a
                # pass of 16 tokens and one either side; one token a
                # block and one either side; 32 tokens a block, and one
                # more (33 a block, the last block one token)
                (1, 1536, 8, 2, False, 16), (15, 1536, 8, 2, False, 16),
                (16, 1536, 8, 2, False, 16), (17, 1536, 8, 2, False, 16),
                (263, 1536, 8, 2, False, 16), (264, 1536, 8, 2, False, 16),
                (265, 1536, 8, 2, False, 16), (8448, 1536, 8, 2, False, 16),
                (8449, 1536, 8, 2, False, 16),
                # a width that is not whole 16-byte vectors (zero-padded);
                # 16 experts at top-8 (all four 32-row slices of a pass);
                # 128 experts over wg tiles of 160 columns
                (100, 37, 8, 2, False, 16), (300, 1536, 16, 8, False, 16),
                (500, 200, 128, 2, False, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,e,k,special,seed", _ROUTE_CASES)
def test_route_kernel_matches_plain(cuda, n, h, e, k, special, seed, dtype):
    """Choices, positions (token-major, across the plan's blocks) and
    counts exact, ce exact; gates within 1e-4 and me within rtol 1e-4:
    the fp32 logits differ by summation order by some 2e-5 at logits of
    ~30, and gates and probabilities move by as much. Token counts at the
    plan's edges, an expert with no row and one with one row, top_k 1 and
    8, 128 experts, a width the kernel pads."""
    from paddle_tpu_torch.kernels import moe_dispatch as md

    xt, wg = _route_inputs(cuda, dtype, n, h, e, seed, special)
    assert logit_margin(xt, wg, k) > 1e-4
    reset_counters()
    got = md.route(xt, wg, k)
    torch.cuda.synchronize()
    assert counters()["moe_route"]["launches"] == 1
    ref = md.route_plain(xt, wg, k)
    gv, gi, pos, cnt, me, ce = (t.cpu() for t in got)
    rgv, rgi, rpos, rcnt, rme, rce = (t.cpu() for t in ref)
    assert torch.equal(gi, rgi) and torch.equal(pos, rpos)
    assert torch.equal(cnt, rcnt) and torch.equal(ce, rce)
    _close(gv, rgv, (0.0, 1e-4))
    _close(me, rme, (1e-4, 1e-4))
    if special:
        assert cnt[e - 1] == 0 and cnt[e - 2] == 1
    # run again: bitwise the same (recompute relies on it)
    again = md.route(xt, wg, k)
    assert all(torch.equal(a.cpu(), b) for a, b in
               zip(again, (gv, gi, pos, cnt, me, ce)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_kernel_reads_an_unaligned_x(cuda, dtype):
    """x a view one element off a 16-byte boundary: the wrapper copies it
    to an aligned tensor, and the outputs equal those of the aligned x."""
    from paddle_tpu_torch.kernels import moe_dispatch as md

    xt, wg = _route_inputs(cuda, dtype, 37, 64, 8, 16, True)
    flat = torch.empty(xt.numel() + 1, dtype=dtype, device=cuda)
    off = flat[1:].view(xt.shape).copy_(xt)
    assert off.data_ptr() % 16 != 0
    got, ref = md.route(off, wg, 2), md.route(xt, wg, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _TOLS)
@pytest.mark.parametrize("n,k,h", [(37, 2, 64), (1000, 1, 1536),
                                   (129, 8, 8)])
def test_gather_and_combine_kernels_match_plain(cuda, n, k, h, dtype, tol):
    """Gather is exact; combine within ``tol`` of the fp32 plain version."""
    from paddle_tpu_torch.kernels import moe_dispatch as md

    rng = np.random.default_rng(17)
    src = torch.from_numpy(rng.standard_normal((n, h), dtype=np.float32)
                           ).to(cuda).to(dtype)
    idx = torch.from_numpy(rng.integers(0, n, size=n * k).astype(np.int32)
                           ).to(cuda)
    gates = torch.from_numpy(rng.random((n, k), dtype=np.float32)).to(cuda)
    dest2 = torch.from_numpy(rng.permutation(n * k).reshape(n, k)
                             .astype(np.int32)).to(cuda)
    y = torch.from_numpy(rng.standard_normal((n * k, h), dtype=np.float32)
                         ).to(cuda).to(dtype)
    reset_counters()
    out = md.gather_rows(src, idx)
    comb = md.combine_rows(y, gates, dest2)
    torch.cuda.synchronize()
    c = counters()
    assert c["moe_gather"]["launches"] == 1
    assert c["moe_combine"]["launches"] == 1
    assert torch.equal(out, md.gather_rows_plain(src, idx))
    _close(comb.float().cpu(),
           md.combine_rows_plain(y.float(), gates, dest2).cpu(), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_src,n_out,h,special", [
    (37, 74, 8, False), (300, 600, 1536, False), (50, 90, 4096, False),
    (5, 1, 1536, False), (40, 80, 1536, True), (9, 20, 8, True)])
def test_gather_kernel_cases_match_plain(cuda, n_src, n_out, h, special,
                                         dtype):
    """The gather, unscaled and with an fp32 row scale, equals its plain
    version exactly: one 16-byte vector a row (h 8 bf16), the step's
    width, the looping instance (h 4096), one output row, and
    (``special``) indices -1 and n_src (zero rows) with scales of 0 and
    below 0. The unscaled entry ``pt_moe_gather`` gives the same rows."""
    import ctypes

    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import moe_dispatch as md

    rng = np.random.default_rng(19)
    src = torch.from_numpy(rng.standard_normal((n_src, h), dtype=np.float32)
                           ).to(cuda).to(dtype)
    idx = rng.integers(0, n_src, size=n_out).astype(np.int32)
    scale = rng.standard_normal(n_out).astype(np.float32)
    if special:
        idx[:4] = [-1, n_src, 0, n_src - 1]
        scale[2:6] = [0.0, -0.0, -1.5, 0.0]
    idx = torch.from_numpy(idx).to(cuda)
    scale = torch.from_numpy(scale).to(cuda)
    reset_counters()
    out = md.gather_rows(src, idx)
    out_s = md.gather_rows(src, idx, scale)
    torch.cuda.synchronize()
    assert counters()["moe_gather"]["launches"] == 2
    assert torch.equal(out, md.gather_rows_plain(src, idx))
    assert torch.equal(out_s, md.gather_rows_plain(src, idx, scale))
    if special:
        assert not out[:2].any() and not out_s[:2].any()
    old = torch.empty_like(out)
    fn = _build.kernel("pt_moe_gather", [ctypes.c_void_p] * 3 +
                       [ctypes.c_int] * 3 + [ctypes.c_void_p])
    _build.launch(fn, "pt_moe_gather", src.device, src.data_ptr(),
                  idx.data_ptr(), old.data_ptr(), n_out, n_src,
                  h * src.element_size())
    torch.cuda.synchronize()
    assert torch.equal(old, out)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_moe_mlp_backward_uses_the_kernels(cuda, dtype, monkeypatch):
    """Forward and backward of ``fused_moe_mlp`` launch each kernel the
    reckoned number of times (backward: a combine, two gathers, dgrad and
    wgrad per projection) and agree with the same call on the plain
    versions: fp32 within 1e-4 relative L2, bf16 within 2e-2."""
    from paddle_tpu_torch.kernels import grouped_matmul as gm
    from paddle_tpu_torch.kernels import moe_dispatch as md

    rng = np.random.default_rng(18)
    h, e, i = 64, 8, 96
    arrays = [rng.standard_normal((2, 37, h), dtype=np.float32),
              0.3 * rng.standard_normal((h, e), dtype=np.float32)] + \
        [rng.standard_normal(s, dtype=np.float32) / np.sqrt(s[1])
         for s in ((e, h, i), (e, h, i), (e, i, h))]

    def run():
        leaves = [torch.from_numpy(a).to(cuda).to(dtype).requires_grad_()
                  for a in arrays]
        o, aux = md.fused_moe_mlp(*leaves, top_k=2)
        ((o.float() ** 2).sum() + aux).backward()
        return [o.detach().float()] + [t.grad.float() for t in leaves]

    reset_counters()
    got = run()
    torch.cuda.synchronize()
    c = counters()
    assert {n: c[n]["launches"] for n in (
        "moe_route", "moe_gather", "moe_combine")} == {
        "moe_route": 1, "moe_gather": 3, "moe_combine": 2}
    sm90 = dtype == torch.bfloat16
    assert _gmm_launches(c, sm90) == [3, 3, 3]
    assert _gmm_launches(c, not sm90) == [0, 0, 0]
    assert all(v["plain_calls"] == 0 for v in c.values())
    for mod, name in ((md, "route"), (md, "gather_rows"),
                      (md, "combine_rows"), (gm, "gmm"), (gm, "tgmm")):
        monkeypatch.setattr(mod, name, getattr(mod, name + "_plain"))
    ref = run()
    limit = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, ref):
        assert ((a - b).norm() / b.norm()).item() <= limit


# -- the fused optimizer update (csrc/optimizer.cu) ----------------------------

# odd shapes: sizes that are not a multiple of 8, one-element tensors, a
# tensor of more elements than one flat chunk holds, a matrix wider than
# one pass of the stats kernel, one with more rows than one tile, a 3-D
# stack, and (offset 1) one whose storage is not 16-byte aligned
_OPT_SHAPES = [(5, 3), (7,), (1,), (1, 1), (70001,), (3, 6200), (1100, 24),
               (2, 9, 16), (40, 64), (33,)]
_OPT_UNALIGNED = 3  # index of the tensor made a view at offset 1


def _opt_tensors(cuda, dtype, seed=21):
    """{name: parameter} at _OPT_SHAPES (the one at _OPT_UNALIGNED a view
    one element into its storage) and two steps of gradients, from numpy."""
    rng = np.random.default_rng(seed)
    ps, grads = {}, [{}, {}]
    for k, s in enumerate(_OPT_SHAPES):
        a = (rng.choice([-1.0, 1.0], size=s) *
             rng.uniform(0.5, 1.5, size=s)).astype(np.float32)
        name = f"t{k}" if k != 2 else "norm.t2"
        if k == _OPT_UNALIGNED:
            buf = torch.zeros(a.size + 1, dtype=dtype, device=cuda)
            t = buf[1:].view(s)
            t.copy_(torch.from_numpy(a))
        else:
            t = torch.from_numpy(a).to(cuda).to(dtype)
        ps[name] = torch.nn.Parameter(t)
        for g in grads:
            g[name] = torch.from_numpy(
                rng.standard_normal(s).astype(np.float32)).to(cuda).to(dtype)
    return ps, grads


def _opt(rule, clip, params):
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.optimizer import Adafactor, Adam, AdamW

    c = {"none": None, "value": pnn.ClipGradByValue(0.5),
         "norm": pnn.ClipGradByNorm(1.0),
         "global": pnn.ClipGradByGlobalNorm(1.0)}[clip]
    named = list(params.items())
    if rule == "adamw":
        return AdamW(learning_rate=1e-3, parameters=named, weight_decay=0.1,
                     apply_decay_param_fun=lambda n: "norm" not in n,
                     grad_clip=c)
    if rule == "adam":
        return Adam(learning_rate=1e-3, parameters=named, weight_decay=0.01,
                    grad_clip=c)
    return Adafactor(learning_rate=1e-2, beta1=0.5 if rule == "adafactor_m"
                     else 0.0, parameters=named, grad_clip=c,
                     weight_decay=0.01 if rule == "adafactor_m" else None)


_OPT_KERNELS = ("multi_tensor_sumsq", "adam_update", "adafactor_stats",
                "adafactor_update")


def _opt_snapshot(ps, opt):
    out = {n: p.detach().clone() for n, p in ps.items()}
    for n, p in ps.items():
        for k, v in opt._state.get(id(p), {}).items():
            out[f"{n}.{k}"] = v.clone()
    return out


def _opt_run(cuda, rule, clip, dtype, plain, monkeypatch, steps=2):
    """Two steps of the optimizer on fresh tensors; with ``plain`` every
    kernel wrapper is swapped for its plain version. Returns the
    parameters and state tensors after the last step and before it."""
    from paddle_tpu_torch.kernels import optimizer as kopt

    ps, grads = _opt_tensors(cuda, dtype)
    opt = _opt(rule, clip, ps)
    before = {}
    with monkeypatch.context() as mp:
        if plain:
            for name in _OPT_KERNELS:
                mp.setattr(kopt, name, getattr(kopt, name + "_plain"))
        for g in grads[:steps]:
            before = _opt_snapshot(ps, opt)
            for n, p in ps.items():
                p.grad = g[n].clone()
            opt.step()
            opt.clear_grad()
    torch.cuda.synchronize()
    return _opt_snapshot(ps, opt), before


def _bf16_ulps(a, b, scale):
    """|a - b| in bf16 ulps of ``scale`` (elementwise)."""
    m = scale.float().abs().clamp_min(2.0 ** -126)
    return (a.float() - b.float()).abs() / torch.exp2(
        torch.floor(torch.log2(m)) - 7)


def _bf16_close(got, ref, base, what):
    """bf16: equal bit for bit in >= 99.9% of elements, within one ulp
    everywhere (a rounding flipped by the last bit of an fp32 sum), an ulp
    of the larger of the two and ``base``, the value before the step (an
    update that cancels may land near zero, where its own ulp is tiny).
    Prints both readings, at the result's scale and at the operands', and
    the elements within one ulp only at the operands' scale."""
    same = (got.view(torch.int16) == ref.view(torch.int16)).float().mean()
    assert same.item() >= 0.999, f"{what}: {same.item():.5f} of elements equal"
    top = torch.maximum(got.float().abs(), ref.float().abs())
    own = _bf16_ulps(got, ref, top)
    ulps = _bf16_ulps(got, ref, torch.maximum(top, base.float().abs()))
    print(f"{what}: bitwise {same.item():.6f}, max ulps at the result's "
          f"scale {own.max().item():g}, at the operands' "
          f"{ulps.max().item():g}, within one only at the operands' "
          f"{int(((own > 1) & (ulps <= 1)).sum())}")
    assert ulps.max().item() <= 1, f"{what}: > 1 ulp apart"


@pytest.mark.gpu
@pytest.mark.parametrize("clip", ["none", "value", "norm", "global"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rule", ["adamw", "adam", "adafactor",
                                  "adafactor_m"])
def test_optimizer_kernels_match_plain(cuda, rule, dtype, clip, monkeypatch):
    """Two optimizer steps through the kernels against the same steps with
    every wrapper swapped for its plain version, at odd shapes: fp32
    within rtol 1e-6 (Adam, AdamW) or 1e-5 (Adafactor; state tensors
    also within that rtol of their largest element, fp32 sums taken in
    another order), bf16 parameters and moments equal bit for bit in
    99.9% of elements and one ulp apart at most; each wrapper launches
    once a step and never takes its plain version."""
    reset_counters()
    got, before = _opt_run(cuda, rule, clip, dtype, False, monkeypatch)
    c = counters()
    adam = rule.startswith("adam") and not rule.startswith("adafactor")
    want = {"multi_tensor_sumsq": 2 if clip in ("norm", "global") else 0,
            "adam_update": 2 if adam else 0,
            "adafactor_stats": 0 if adam else 2,
            "adafactor_update": 0 if adam else 2}
    assert {n: c[n]["launches"] for n in _OPT_KERNELS} == want
    assert all(c[n]["plain_calls"] == 0 for n in _OPT_KERNELS)
    ref = _opt_run(cuda, rule, clip, dtype, True, monkeypatch)[0]
    rtol = 1e-6 if adam else 1e-5
    for k, r in ref.items():
        g = got[k]
        if g.dtype == torch.bfloat16:
            _bf16_close(g, r, before[k], k)
        else:
            _close(g.cpu(), r.cpu(), (rtol, rtol * r.abs().max().item()))


@pytest.mark.gpu
@pytest.mark.parametrize("rule", ["adamw", "adafactor_m"])
def test_optimizer_kernels_are_deterministic(cuda, rule, monkeypatch):
    """Two runs of the same steps (global-norm clip, bf16) give the same
    bits: every cross-block sum is taken in a fixed order."""
    a = _opt_run(cuda, rule, "global", torch.bfloat16, False, monkeypatch)[0]
    b = _opt_run(cuda, rule, "global", torch.bfloat16, False, monkeypatch)[0]
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("rule", ["adamw", "adafactor"])
def test_optimizer_updates_a_replaced_storage(cuda, rule, monkeypatch):
    """A parameter whose storage is replaced between steps is updated at
    its new address (the table is built per step), as the plain version
    updates it."""
    from paddle_tpu_torch.kernels import optimizer as kopt

    def run(plain):
        ps, grads = _opt_tensors(cuda, torch.float32)
        opt = _opt(rule, "none", ps)
        with monkeypatch.context() as mp:
            if plain:
                for name in _OPT_KERNELS:
                    mp.setattr(kopt, name, getattr(kopt, name + "_plain"))
            for step, g in enumerate(grads):
                if step == 1:
                    for p in ps.values():
                        p.data = p.data.clone() * 2
                for n, p in ps.items():
                    p.grad = g[n].clone()
                opt.step()
        torch.cuda.synchronize()
        return {n: p.detach().clone() for n, p in ps.items()}

    got, ref = run(False), run(True)
    for n in ref:
        _close(got[n].cpu(), ref[n].cpu(), (1e-5, 1e-6))


@pytest.mark.gpu
def test_optimizer_kernels_raise_on_what_they_do_not_take(cuda):
    from paddle_tpu_torch.optimizer import AdamW

    p = torch.nn.Parameter(torch.ones(8, device=cuda, dtype=torch.float16))
    p.grad = torch.ones_like(p)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        AdamW(parameters=[p]).step()
    p = torch.nn.Parameter(torch.ones(8, device=cuda))
    q = torch.nn.Parameter(torch.ones(8))
    p.grad, q.grad = torch.ones_like(p), torch.ones_like(q)
    reset_counters()
    for order in ([p, q], [q, p]):  # the CUDA tensor first, then second
        with pytest.raises(ValueError, match="tensor on"):
            AdamW(parameters=order).step()
    assert counters()["adam_update"] == {"launches": 0, "plain_calls": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("clip", ["none", "global"])
@pytest.mark.parametrize("rule", ["adamw", "adafactor", "adafactor_m"])
def test_optimizer_kernels_take_fp32_gradients(cuda, rule, clip,
                                               monkeypatch):
    """bf16 parameters with fp32 gradients (the sums of
    ``TrainStep.accumulate``; the table's fp32-gradient flag): two steps
    through the kernels against the plain versions, held as the bf16
    steps above (99.9% bit for bit, one ulp at most; fp32 state within
    rtol of its largest element), one launch a call."""
    from paddle_tpu_torch.kernels import optimizer as kopt

    def run(plain):
        ps, _ = _opt_tensors(cuda, torch.bfloat16)
        _, grads = _opt_tensors(cuda, torch.float32)
        opt = _opt(rule, clip, ps)
        before = {}
        with monkeypatch.context() as mp:
            if plain:
                for name in _OPT_KERNELS:
                    mp.setattr(kopt, name, getattr(kopt, name + "_plain"))
            for g in grads:
                before = _opt_snapshot(ps, opt)
                batch = opt._apply([g[n] for n in ps])
                assert batch.params[0].dtype == torch.bfloat16
                opt._global_step += 1
        torch.cuda.synchronize()
        return _opt_snapshot(ps, opt), before

    reset_counters()
    got, before = run(False)
    c = counters()
    adam = rule == "adamw"
    want = {"multi_tensor_sumsq": 2 if clip == "global" else 0,
            "adam_update": 2 if adam else 0,
            "adafactor_stats": 0 if adam else 2,
            "adafactor_update": 0 if adam else 2}
    assert {n: c[n]["launches"] for n in _OPT_KERNELS} == want
    assert all(c[n]["plain_calls"] == 0 for n in _OPT_KERNELS)
    ref = run(True)[0]
    rtol = 1e-6 if adam else 1e-5
    for k, r in ref.items():
        g = got[k]
        if g.dtype == torch.bfloat16:
            _bf16_close(g, r, before[k], k)
        else:
            _close(g.cpu(), r.cpu(), (rtol, rtol * r.abs().max().item()))


@pytest.mark.gpu
def test_a_kept_table_on_the_card_equals_a_fresh_one(cuda):
    """The device table of a kept batch after ``set_step`` (its header
    copied from pinned memory, step after step with no synchronise)
    holds the words of a table built fresh for that rate and step."""
    from paddle_tpu_torch.kernels import optimizer as kopt

    ps, grads = _opt_tensors(cuda, torch.float32)
    params = list(ps.values())
    gs = [grads[0][n] for n in ps]
    slots = [[torch.zeros_like(p) for p in params],
             [torch.zeros_like(p) for p in params], [None] * len(params)]
    kept = kopt.StepBatch(params, gs, slots, [True] * len(params), 1e-3, 1)
    kept.table()
    for step in range(2, 10):
        lr = 1e-3 / step
        kept.set_step(lr, step)
        fresh = kopt.StepBatch(params, gs, slots, [True] * len(params), lr,
                               step)
        assert torch.equal(kept.table().cpu(), fresh.table().cpu()), step


# -- the other optimizer rules, the unscale and the master update ---------------

# each rule (its settings off the defaults) -> (its wrapper, its optimizer
# over named parameters with a clip)
def _rule_opt(rule, named, clip):
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch import regularizer as preg

    kw = dict(parameters=named, grad_clip=clip)
    if rule == "sgd":
        return popt.SGD(learning_rate=1e-2, weight_decay=preg.L2Decay(0.01),
                        **kw)
    if rule == "momentum":
        return popt.Momentum(learning_rate=1e-2, momentum=0.8,
                             use_nesterov=True, weight_decay=0.01, **kw)
    if rule == "adagrad":
        return popt.Adagrad(1e-2, epsilon=1e-5,
                            initial_accumulator_value=0.1, **kw)
    if rule == "adamax":
        return popt.Adamax(learning_rate=1e-2, beta1=0.8, beta2=0.99,
                           weight_decay=0.01, **kw)
    if rule == "rmsprop":
        return popt.RMSProp(1e-2, rho=0.9, epsilon=1e-5, momentum=0.5,
                            centered=True, **kw)
    if rule == "rmsprop_plain":
        return popt.RMSProp(1e-2, **kw)
    if rule == "adadelta":
        return popt.Adadelta(learning_rate=1.0, epsilon=1e-5, rho=0.9,
                             weight_decay=preg.L2Decay(0.01), **kw)
    if rule == "lamb":
        return popt.Lamb(learning_rate=1e-2, lamb_weight_decay=0.02,
                         exclude_from_weight_decay_fn=lambda p: p.ndim == 1,
                         **kw)
    return popt.LarsMomentum(learning_rate=1e-2, lars_coeff=0.01,
                             lars_weight_decay=0.001,
                             exclude_from_weight_decay=["norm"],
                             epsilon=1e-6, **kw)


_RULE_WRAPPERS = {"sgd": "sgd_update", "momentum": "momentum_update",
                  "adagrad": "adagrad_update", "adamax": "adamax_update",
                  "rmsprop": "rmsprop_update",
                  "rmsprop_plain": "rmsprop_update",
                  "adadelta": "adadelta_update", "lamb": "lamb_update",
                  "lars": "lars_update"}


def _rule_run(cuda, rule, clip, dtype, plain, monkeypatch):
    """Two steps of ``rule`` on fresh tensors at _OPT_SHAPES; with
    ``plain`` the rule's wrapper alone is swapped for its plain version
    (the clip's norms come from the kernel in both runs, so both read the
    same scales). Returns every parameter and state tensor."""
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.kernels import optimizer as kopt

    ps, grads = _opt_tensors(cuda, dtype)
    c = {"none": None, "value": pnn.ClipGradByValue(0.5),
         "global": pnn.ClipGradByGlobalNorm(1.0)}[clip]
    opt = _rule_opt(rule, list(ps.items()), c)
    name = _RULE_WRAPPERS[rule]
    with monkeypatch.context() as mp:
        if plain:
            mp.setattr(kopt, name, getattr(kopt, name + "_plain"))
        for g in grads:
            for n, p in ps.items():
                p.grad = g[n].clone()
            opt.step()
            opt.clear_grad()
    torch.cuda.synchronize()
    return _opt_snapshot(ps, opt)


@pytest.mark.gpu
@pytest.mark.parametrize("clip", ["none", "value", "global"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rule", list(_RULE_WRAPPERS))
def test_rule_kernels_equal_plain_in_every_bit(cuda, rule, dtype, clip,
                                               monkeypatch):
    """Two steps of each of the eight rules through its kernel against the
    same steps through its plain version, at odd shapes (an unaligned
    tensor, one wider than a chunk, one-element ones), fp32 and bf16:
    every parameter and state tensor equal in every bit (each fp32
    operation rounded on its own in the rule's order; Lamb's and LARS's
    norms fp64 sums rounded once); one launch a step, no plain call."""
    reset_counters()
    got = _rule_run(cuda, rule, clip, dtype, False, monkeypatch)
    c = counters()
    name = _RULE_WRAPPERS[rule]
    assert c[name] == {"launches": 2, "plain_calls": 0}
    assert c["multi_tensor_sumsq"]["launches"] == (2 if clip == "global"
                                                   else 0)
    ref = _rule_run(cuda, rule, clip, dtype, True, monkeypatch)
    for k, r in ref.items():
        assert torch.equal(got[k], r), k


@pytest.mark.gpu
@pytest.mark.parametrize("rule", list(_RULE_WRAPPERS))
def test_rule_kernels_raise_on_fp16(cuda, rule):
    p = torch.nn.Parameter(torch.ones(8, device=cuda, dtype=torch.float16))
    p.grad = torch.ones_like(p)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _rule_opt(rule, [("p", p)], None).step()


def _scaler_batch(cuda, dtype, planted=None):
    """Parameters at _OPT_SHAPES with gradients of ``dtype`` (the one at
    _OPT_UNALIGNED a view at offset 1) and their "grads" batch;
    ``planted`` (tensor, element, value) puts one value into a gradient."""
    from paddle_tpu_torch.kernels import optimizer as kopt

    ps, grads = _opt_tensors(cuda, dtype)
    gs = [grads[0][n] * 1024 for n in ps]
    k = _OPT_UNALIGNED
    buf = torch.zeros(gs[k].numel() + 1, dtype=dtype, device=cuda)
    gs[k] = buf[1:].view(gs[k].shape).copy_(gs[k])
    if planted is not None:
        gs[planted[0]].view(-1)[planted[1]] = planted[2]
    n = len(gs)
    return kopt.StepBatch(list(ps.values()), gs, [[None] * n] * 3,
                          [True] * n, 0.0, 1, rule="grads")


@pytest.mark.gpu
@pytest.mark.parametrize("planted", [None, (_OPT_UNALIGNED, -1, float("inf")),
                                     (4, 65540, float("nan")),
                                     (5, 0, -float("inf"))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_check_finite_and_unscale_match_plain(cuda, dtype, planted):
    """The finiteness check and the unscale against their plain versions
    at odd shapes: the same flag (a planted inf or NaN found), the
    unscaled gradients equal in every bit but a planted NaN, which stays
    a NaN (its bits are the converter's: CUDA's bf16 NaN is 0x7fff,
    torch's 0x7fc0), one launch each."""
    from paddle_tpu_torch.kernels import optimizer as kopt

    inv = 1.0 / 1024
    reset_counters()
    b = _scaler_batch(cuda, dtype, planted)
    flag = kopt.check_finite(b, inv)
    ref_flag = kopt.check_finite_plain(b, inv)
    assert int(flag.item()) == int(ref_flag.item()) == (planted is not None)
    ref = [g.clone() for g in b.grads]
    kopt.unscale(b, inv)
    r = _scaler_batch(cuda, dtype, planted)
    kopt.unscale_plain(r, inv)
    for a, e in zip(b.grads, r.grads):
        assert bool(((a == e) | (a.isnan() & e.isnan())).all())
        assert torch.equal(a.isnan(), e.isnan())
    assert not torch.equal(b.grads[0], ref[0])
    c = counters()
    assert c["check_finite"] == {"launches": 1, "plain_calls": 0}
    assert c["unscale"] == {"launches": 1, "plain_calls": 0}


@pytest.mark.gpu
def test_grad_scaler_on_the_card_raises_on_fp16(cuda):
    from paddle_tpu_torch import amp, optimizer as popt

    p = torch.nn.Parameter(torch.ones(8, device=cuda, dtype=torch.float16))
    p.grad = torch.ones_like(p)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        amp.GradScaler().step(popt.SGD(parameters=[p]))


@pytest.mark.gpu
@pytest.mark.parametrize("rule", ["adamw", "lamb"])
def test_master_update_kernels_equal_plain(cuda, rule, monkeypatch):
    """``make_master_update`` over fp32 masters of bf16 parameters at odd
    shapes, two steps with the global clip: through the kernels against
    the plain versions (the clip's norms from the kernel in both), the
    masters, states and cast parameters equal in every bit."""
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.kernels import optimizer as kopt

    def run(plain):
        ps, grads = _opt_tensors(cuda, torch.bfloat16)
        named = list(ps.items())
        clip = pnn.ClipGradByGlobalNorm(1.0)
        opt = (popt.AdamW(learning_rate=1e-3, parameters=named,
                          weight_decay=0.1, grad_clip=clip)
               if rule == "adamw" else _rule_opt("lamb", named, clip))
        up = popt.make_master_update(opt, list(ps.values()),
                                     [torch.bfloat16] * len(ps))
        master = [p.detach().float() for p in ps.values()]
        states = [opt._init_state(m) for m in master]
        name = "adam_update" if rule == "adamw" else "lamb_update"
        with monkeypatch.context() as mp:
            if plain:
                mp.setattr(kopt, name, getattr(kopt, name + "_plain"))
            for step, g in enumerate(grads, 1):
                _m, _s, cast = up(master, list(g.values()), states, 1e-3,
                                  step)
        torch.cuda.synchronize()
        return master + [v for st in states for v in st.values()] + cast

    for a, b in zip(run(False), run(True)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("clip", ["norm", "global"])
def test_clip_call_on_the_card_equals_the_cpu(cuda, clip):
    """A norm clip called on CUDA ``(param, grad)`` pairs (the sums of
    squares by the kernel) against the same call on CPU copies: rtol 1e-6
    (sums in another order)."""
    from paddle_tpu_torch import nn as pnn

    c = pnn.ClipGradByNorm(1.0) if clip == "norm" else \
        pnn.ClipGradByGlobalNorm(1.0)
    ps, grads = _opt_tensors(cuda, torch.float32)
    pairs = [(n, grads[0][n]) for n in ps]
    reset_counters()
    got = c(pairs)
    assert counters()["multi_tensor_sumsq"]["launches"] == 1
    ref = c([(n, g.cpu()) for n, g in pairs])
    for (_, a), (_, b) in zip(got, ref):
        _close(a.cpu(), b, (1e-6, 1e-7))


# -- the graphed training step (jit.TrainStep) -----------------------------------

def _small_llama(cuda, moe, seed=5):
    """A 2-layer bf16 Llama (or MoE Llama, fused dispatch) with head dim
    128, so its attention takes the tensor-core kernels, and recompute."""
    from paddle_tpu_torch.device import seed as pt_seed
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         LlamaMoEConfig)

    kw = dict(hidden_size=256, num_attention_heads=2, num_key_value_heads=2,
              dtype="bfloat16", use_recompute=True)
    cfg = (LlamaMoEConfig if moe else LlamaConfig).tiny(**kw)
    return cfg, LlamaForCausalLM(cfg, device=cuda,
                                 generator=pt_seed(seed, cuda))


def _train_run(cuda, moe, graph, steps=3, shapes=((4, 64),), lr_at=None,
               accumulate=0, reload_at=None, make_opt=None):
    """``steps`` steps per batch shape of a fresh small model (AdamW for
    the dense model, Adafactor for the MoE one, or ``make_opt(model)``);
    returns (losses, every parameter and state tensor after the last
    step, the step)."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Adafactor, AdamW

    set_flags({"FLAGS_moe_dispatch": "fused" if moe else "index"})
    try:
        cfg, model = _small_llama(cuda, moe)
        if make_opt is not None:
            opt = make_opt(model)
        elif moe:
            opt = Adafactor(learning_rate=1e-2,
                            parameters=model.parameters())
        else:
            opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                        weight_decay=0.1)
        step = TrainStep(model, lambda m, x, y: m(x, labels=y), opt,
                         graph=graph)
        if accumulate:
            step = step.accumulate(accumulate)
        gen = torch.Generator(device=cuda).manual_seed(7)
        losses = []
        for shape in shapes:
            ids = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                device=cuda)
            for i in range(steps):
                if lr_at is not None and i == lr_at[0]:
                    opt.set_lr(lr_at[1])
                if i == reload_at:  # new state tensors, the same values
                    opt.set_state_dict(opt.state_dict())
                losses.append(step(ids, ids))
        torch.cuda.synchronize()
        out = {n: p.detach().clone() for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            for k, v in opt._state.get(id(p), {}).items():
                out[f"{n}.{k}"] = v.clone()
        return [float(x) for x in losses], out, step
    finally:
        set_flags({"FLAGS_moe_dispatch": "index"})


@pytest.mark.gpu
@pytest.mark.parametrize("moe", [False, True])
def test_graphed_step_equals_the_eager_step(cuda, moe):
    """Three steps of the graphed ``TrainStep`` (one eager warm-up step, the
    capture and its first replay, one more replay) against three eager
    steps (``graph=False``) from the same weights and batch: every loss,
    parameter and optimizer state tensor equal bit for bit (the same
    kernels and cuBLAS calls on one stream, in the same order)."""
    reset_counters()
    lg, got, step = _train_run(cuda, moe, graph=True)
    assert step.captures == 1 and step.replays == 2
    c = counters()
    assert all(v["plain_calls"] == 0 for v in c.values())
    # the capture's launches, counted once by the wrappers, then replayed
    assert step.captured_launches()["flash_attention_bwd_dq_sm90"] == 2 * 2
    le, ref, _ = _train_run(cuda, moe, graph=False)
    assert lg == le
    for k, r in ref.items():
        assert torch.equal(got[k], r), k


@pytest.mark.gpu
def test_a_second_input_shape_captures_a_second_graph(cuda):
    """A new batch shape warms up and captures a graph of its own; the
    steps of both shapes equal the eager ones."""
    lg, got, step = _train_run(cuda, False, True,
                               shapes=((4, 64), (2, 96)))
    assert step.captures == 2 and step.replays == 4
    le, ref, _ = _train_run(cuda, False, False, shapes=((4, 64), (2, 96)))
    assert lg == le
    for k, r in ref.items():
        assert torch.equal(got[k], r), k


@pytest.mark.gpu
def test_a_replay_after_set_lr_uses_the_new_rate(cuda):
    """``set_lr`` before the third step (a replay) reaches the kernels
    through the table's header: the graphed run equals the eager run that
    set the same rate, and differs from a run that kept the old one."""
    _, got, step = _train_run(cuda, False, True, lr_at=(2, 5e-3))
    assert step.replays == 2
    _, ref, _ = _train_run(cuda, False, False, lr_at=(2, 5e-3))
    _, kept, _ = _train_run(cuda, False, True)
    for k, r in ref.items():
        assert torch.equal(got[k], r), k
    assert not torch.equal(got["lm_head.weight"], kept["lm_head.weight"])


@pytest.mark.gpu
def test_graphed_accumulation_equals_the_eager_window(cuda):
    """``TrainStep.accumulate(2)``: three windows as graph replays against
    three eager windows, bit for bit; one update a window."""
    reset_counters()
    lg, got, step = _train_run(cuda, False, True, accumulate=2)
    assert step.captures == 1 and step.replays == 2
    assert step.captured_launches()["adam_update"] == 2
    le, ref, _ = _train_run(cuda, False, False, accumulate=2)
    assert lg == le
    for k, r in ref.items():
        assert torch.equal(got[k], r), k


@pytest.mark.gpu
def test_state_moved_to_new_storage_is_captured_again(cuda):
    """``set_state_dict`` gives the optimizer new state tensors, whose
    addresses the graph does not hold: the next call captures again, and
    the run equals the eager one that reloaded the same state."""
    lg, got, step = _train_run(cuda, False, True, steps=4, reload_at=3)
    assert step.captures == 2 and step.replays == 3
    assert step.captured_launches()["adam_update"] == 3
    le, ref, _ = _train_run(cuda, False, False, steps=4, reload_at=3)
    assert lg == le
    for k, r in ref.items():
        assert torch.equal(got[k], r), k


@pytest.mark.gpu
@pytest.mark.parametrize("rule", ["sgd", "momentum", "adagrad", "adamax",
                                  "rmsprop", "adadelta", "lamb", "lars"])
def test_graphed_step_equals_the_eager_step_under_each_rule(cuda, rule):
    """The small bf16 Llama under each of the eight rules: three graphed
    steps against three eager ones, every loss, parameter and state tensor
    equal bit for bit; the rule's wrapper captured once, no plain call.
    Lamb's and LARS's fp64 partials come from the graph's pool."""
    def make(model):
        return _rule_opt(rule, list(model.named_parameters()), None)

    reset_counters()
    lg, got, step = _train_run(cuda, False, True, make_opt=make)
    assert step.captures == 1 and step.replays == 2
    assert all(v["plain_calls"] == 0 for v in counters().values())
    assert step.captured_launches()[_RULE_WRAPPERS[rule]] == 2
    le, ref, _ = _train_run(cuda, False, False, make_opt=make)
    assert lg == le
    for k, r in ref.items():
        assert torch.equal(got[k], r), k


# -- GPT training: the graphed step, dropout, the attention routes -------------

def _small_gpt(cuda, **cfg):
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    config = GPTConfig(vocab_size=512, hidden_size=256, num_hidden_layers=2,
                       num_attention_heads=2, max_position_embeddings=128,
                       dtype="bfloat16", use_recompute=True, **cfg)
    return config, GPTForCausalLM(config, device=cuda,
                                  generator=seed(3, cuda), dropout_seed=5)


def _gpt_run(cuda, graph, steps=3, lr=1e-3, remat_window=False, **cfg):
    """``steps`` AdamW steps of a fresh 2-layer bf16 GPT (head dim 128) on
    one batch (with ``remat_window``, windows of ``accumulate(2,
    remat=True)``): (losses, parameters and state after the last, the
    step)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    config, model = _small_gpt(cuda, **cfg)
    opt = AdamW(learning_rate=lr, parameters=model.parameters(),
                weight_decay=0.1 if lr else 0.0)
    step = TrainStep(model, lambda m, x, y: m(x, labels=y), opt, graph=graph)
    if remat_window:
        step = step.accumulate(2, remat=True)
    gen = torch.Generator(device=cuda).manual_seed(8)
    ids = torch.randint(0, config.vocab_size, (4, 128), generator=gen,
                        device=cuda)
    losses = [float(step(ids, ids)) for _ in range(steps)]
    out = {n: p.detach().clone() for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        for k, v in opt._state.get(id(p), {}).items():
            out[f"{n}.{k}"] = v.clone()
    return losses, out, step


@pytest.mark.gpu
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_graphed_gpt_step_equals_the_eager_step(cuda, p):
    """A 2-layer GPT with recompute, without and with dropout (0.1 in
    attention and on the residuals): three graphed steps against three
    eager ones from the same weights and generator state, every loss,
    parameter and state tensor bit for bit; without dropout the flash
    kernels and ``adam_update`` are the step's graph nodes."""
    reset_counters()
    lg, got, step = _gpt_run(cuda, True, attention_probs_dropout_prob=p,
                             hidden_dropout_prob=p)
    assert step.captures == 1 and step.replays == 2
    assert all(v["plain_calls"] == 0 for v in counters().values())
    if p == 0.0:
        assert step.captured_launches() == {
            "flash_attention_sm90": 2 * 2 * 2,
            "flash_attention_bwd_dkv_sm90": 2 * 2,
            "flash_attention_bwd_dq_sm90": 2 * 2, "adam_update": 2}
    le, ref, _ = _gpt_run(cuda, False, attention_probs_dropout_prob=p,
                          hidden_dropout_prob=p)
    assert lg == le
    for k, r in ref.items():
        assert torch.equal(got[k], r), k


@pytest.mark.gpu
def test_graphed_remat_window_with_dropout_equals_eager(cuda):
    """``accumulate(2, remat=True)`` over the 2-layer GPT with recompute
    and dropout 0.1: each microbatch's loss is checkpointed around the
    layers' own checkpoints, so a replay rewinds nested regions through
    twin generators. Three graphed windows equal three eager ones bit for
    bit."""
    drop = dict(attention_probs_dropout_prob=0.1, hidden_dropout_prob=0.1)
    lg, got, step = _gpt_run(cuda, True, remat_window=True, **drop)
    assert step.captures == 1 and step.replays == 2
    le, ref, _ = _gpt_run(cuda, False, remat_window=True, **drop)
    assert lg == le
    for k, r in ref.items():
        assert torch.equal(got[k], r), k


@pytest.mark.gpu
def test_a_dropout_replay_draws_a_fresh_mask(cuda):
    """At learning rate 0 the weights stay, so two replays on one batch
    differ only by their masks: their losses differ, and with p = 0 they
    do not."""
    lg, _, step = _gpt_run(cuda, True, steps=4, lr=0.0,
                           attention_probs_dropout_prob=0.1,
                           hidden_dropout_prob=0.1)
    assert step.replays == 3 and len(set(lg)) == 4
    l0, _, _ = _gpt_run(cuda, True, steps=4, lr=0.0)
    assert len(set(l0)) == 1


@pytest.mark.gpu
def test_attention_composition_launches_no_flash_kernel(cuda):
    """On CUDA an additive mask or dropout takes the plain composition (the
    JAX package's XLA one): no flash launch; the same call without them
    launches the tensor-core forward."""
    from paddle_tpu_torch.nn.functional import scaled_dot_product_attention

    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn(2, 256, 4, 128, generator=gen, device=cuda,
                           dtype=torch.bfloat16) for _ in range(3))
    reset_counters()
    masked = scaled_dot_product_attention(
        q, k, v, attn_mask=torch.zeros(256, device=cuda), is_causal=True)
    scaled_dot_product_attention(q, k, v, dropout_p=0.1, is_causal=True,
                                 generator=gen)
    c = counters()
    assert all(c[n]["launches"] == 0 and c[n]["plain_calls"] == 0
               for n in c if n.startswith("flash_attention"))
    flash = scaled_dot_product_attention(q, k, v, is_causal=True)
    assert counters()["flash_attention_sm90"]["launches"] == 1
    _close(masked.float().cpu(), flash.float().cpu(), (2.0 ** -7, 2e-2))


@pytest.mark.gpu
def test_cached_llama_attention_runs_the_decode_kernel(cuda):
    """Hidden 2048, 16 heads: one new token over a 2047-token cache runs
    the single-row decode kernel and equals the last row of the uncached
    causal call within the bf16 tolerance."""
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.models.llama import LlamaAttention

    cfg = LlamaConfig(hidden_size=2048, num_attention_heads=16,
                      num_key_value_heads=16, dtype="bfloat16")
    torch.manual_seed(0)
    att = LlamaAttention(cfg).to(cuda, torch.bfloat16)
    x = torch.randn(1, 2048, 2048, device=cuda, dtype=torch.bfloat16)
    with torch.no_grad():
        full = att(x)
        k = att.k_proj(x[:, :-1]).view(1, 2047, 16, 128)
        v = att.v_proj(x[:, :-1]).view(1, 2047, 16, 128)
        k = rope.rope_apply(k, cfg.rope_theta, 0)
        reset_counters()
        last, cache = att(x[:, -1:], cache=(k, v))
    assert counters()["flash_attention_decode"]["launches"] == 1
    assert cache[0].shape == (1, 2048, 16, 128)
    _close(last.float().cpu(), full[:, -1:].float().cpu(), (2.0 ** -6, 2e-3))


# -- the device step count and skip flag (the in-graph GradScaler) -------------

def _device_step_run(cuda, rule, dtype, skip, plain, monkeypatch):
    """Two kernel steps of ``rule`` on fresh tensors, then a third taken
    through ``Optimizer._apply(device_step=(count, flag))`` (count 6, flag
    ``skip``), its wrappers swapped for their plain versions with
    ``plain``. Returns the tensors before and after the third."""
    from paddle_tpu_torch.kernels import optimizer as kopt

    ps, grads = _opt_tensors(cuda, dtype)
    if rule in ("adamw", "adafactor_m"):
        opt = _opt(rule, "global", ps)
        names = _OPT_KERNELS[1:]
    else:
        from paddle_tpu_torch import nn as pnn

        opt = _rule_opt(rule, list(ps.items()), pnn.ClipGradByGlobalNorm(1.0))
        names = (_RULE_WRAPPERS[rule],)
    for g in grads:
        for n, p in ps.items():
            p.grad = g[n].clone()
        opt.step()
    count = torch.tensor([6], dtype=torch.int32, device=cuda)
    flag = torch.tensor([skip], dtype=torch.int32, device=cuda)
    before = _opt_snapshot(ps, opt)
    with monkeypatch.context() as mp:
        if plain:
            for name in names:
                mp.setattr(kopt, name, getattr(kopt, name + "_plain"))
        for n, p in ps.items():
            p.grad = grads[0][n].clone()
        opt._apply(device_step=(count, flag))
    torch.cuda.synchronize()
    return before, _opt_snapshot(ps, opt)


@pytest.mark.gpu
@pytest.mark.parametrize("skip", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rule", ["adamw", "adafactor_m"] +
                         list(_RULE_WRAPPERS))
def test_device_step_kernels_equal_plain_in_every_bit(cuda, rule, dtype, skip,
                                                      monkeypatch):
    """The optimizer kernels with the step number and skip flag read from
    the device (the header words ``StepBatch.bind_device_step`` writes on
    the stream) against their plain versions, over every rule, with the
    flag clear (the update at step count + 1 = 7) and set (nothing
    written: equal to the tensors before the call): the eight rules of
    ``_RULE_WRAPPERS`` equal in every bit, AdamW and Adafactor within the
    criterion of ``test_optimizer_kernels_match_plain`` (their sums run
    in another order); in fp32 the cleared flag's update moves the
    tensors (in bf16 a small SGD or Adagrad step may round away)."""
    before, got = _device_step_run(cuda, rule, dtype, skip, False,
                                   monkeypatch)
    _, ref = _device_step_run(cuda, rule, dtype, skip, True, monkeypatch)
    for k, r in ref.items():
        if rule in _RULE_WRAPPERS or skip:
            assert torch.equal(got[k], r), k
        elif got[k].dtype == torch.bfloat16:
            _bf16_close(got[k], r, before[k], k)
        else:
            rtol = 1e-6 if rule == "adamw" else 1e-5
            _close(got[k].cpu(), r.cpu(), (rtol, rtol * r.abs().max().item()))
    if skip:
        for k, b in before.items():
            assert torch.equal(got[k], b), k
    elif dtype == torch.float32:  # a bf16 SGD step may round away
        assert any(not torch.equal(got[k], b) for k, b in before.items())


@pytest.mark.gpu
def test_pipeline_local_graph_replay_equals_eager(cuda):
    """Two stages of a bf16 Llama (head dim 64: the tensor-core kernels)
    on one card through ``LocalPipelineStep``: three graphed steps (the
    eager warm-up, the capture, a replay) equal three eager ones from the
    same weights, losses and parameters bit for bit."""
    from paddle_tpu_torch.device import seed
    from pipeline_harness import LocalPipelineStep
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig.tiny(num_hidden_layers=4, hidden_size=256,
                           num_attention_heads=4, num_key_value_heads=2,
                           dtype="bfloat16", use_recompute=True)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    ids = torch.randint(0, cfg.vocab_size, (4, 128), generator=gen,
                        device=cuda)
    out = {}
    for graph in (False, True):
        stages = [LlamaForCausalLM(cfg, device=cuda,
                                   generator=seed(7, cuda), stage=(r, 2))
                  for r in range(2)]
        opt = AdamW(learning_rate=1e-3, weight_decay=0.1,
                    parameters=[p for st in stages for p in st.parameters()])
        step = LocalPipelineStep(stages, opt, 4, graph=graph)
        losses = [step(ids, ids) for _ in range(3)]
        out[graph] = (losses, {n: p.detach().clone() for st in stages
                               for n, p in st.named_parameters()})
    assert all(torch.equal(a, b) for a, b in zip(out[False][0],
                                                 out[True][0]))
    for n, p in out[False][1].items():
        assert torch.equal(out[True][1][n], p), n


# -- the optimizer kernels' split passes (ShardedTrainStep over split tensors)

def _world_one():
    """A world-1 process group (gloo over a store in memory) where none is
    up: the split passes sum over it, the rank's own sums."""
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.group.WORLD


_SPLIT_SHAPES = [(3, 5, 24), (7, 40), (9,), (1100, 24), (1, 1)]


def _split_run(cuda, rule, dtype, split, plain, steps=2):
    """``steps`` updates of ``rule`` over tensors at _SPLIT_SHAPES, the
    first marked split on its dims 0 and 2, the second on 0, the fourth
    on 1 (degree-1 axes of the world-1 group: ``split``), or unsplit;
    through the kernels or their plain versions. Returns every tensor
    the updates wrote."""
    from paddle_tpu_torch.kernels import optimizer as kopt

    rng = np.random.default_rng(31)

    def t(shape, scale):
        return (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)) * scale).to(cuda)

    p = [t(s, 0.02).to(dtype) for s in _SPLIT_SHAPES]
    grads = [[t(s, 1e-3).to(dtype) for s in _SPLIT_SHAPES]
             for _ in range(steps)]
    if rule == "adafactor":
        slots = [[t(s[:-1] if len(s) > 1 else s, 1e-4).square()
                  for s in _SPLIT_SHAPES],
                 [t(s[:-2] + s[-1:], 1e-4).square() if len(s) > 1 else None
                  for s in _SPLIT_SHAPES], [None] * len(p)]
    else:
        slots = [[t(s, 1e-4).to(dtype) for s in _SPLIT_SHAPES],
                 [t(s, 1e-3).square().to(dtype) if rule == "lamb" else None
                  for s in _SPLIT_SHAPES], [None] * len(p)]
    world = _world_one()
    marks = kopt.TensorSplits([(world, 1, {id(p[0]): 0}),
                               (world, 1, {id(p[0]): 2, id(p[1]): 0,
                                           id(p[3]): 1})]) if split else None
    sfx = "_plain" if plain else ""
    for k, g in enumerate(grads):
        b = kopt.StepBatch(p, g, slots, [True] * len(p), 1e-2, k + 1,
                           rule=rule)
        b.split = marks
        if rule == "adafactor":
            st = getattr(kopt, "adafactor_stats" + sfx)(
                b, decay_rate=0.8, epsilon1=1e-30, weight_decay=0.0,
                pscale=True)
            getattr(kopt, "adafactor_update" + sfx)(
                b, st, beta1=0.0, epsilon2=1e-3, clip_threshold=1.0,
                pscale=True, weight_decay=0.0)
        elif rule == "lamb":
            getattr(kopt, "lamb_update" + sfx)(
                b, beta1=0.9, beta2=0.999, epsilon=1e-6, weight_decay=0.01)
        else:
            getattr(kopt, "lars_update" + sfx)(
                b, momentum=0.9, lars_coeff=0.001, weight_decay=5e-4,
                epsilon=0.0)
    torch.cuda.synchronize()
    return p + [s for sl in slots for s in sl if s is not None]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rule", ["adafactor", "lamb", "lars"])
def test_split_rule_kernels_match_plain_and_unsplit(cuda, rule, dtype):
    """The split passes of Adafactor's statistics and update, Lamb and LARS
    (the partial launch, the sums over the ranks, the finish launch) over
    tensors marked split on degree-1 axes: equal to the unsplit kernels in
    every bit over two steps (the sums over one rank are its own), and to
    their plain versions as the unsplit kernels are (Lamb and LARS in
    every bit; Adafactor fp32 within rtol 1e-5 of each tensor's largest
    element, bf16 within one ulp after one step: a one-ulp difference in
    p moves the next step's parameter scale, and two steps read 2 ulps in
    0.004% of the elements)."""
    steps = 1 if rule == "adafactor" and dtype == torch.bfloat16 else 2
    reset_counters()
    got = _split_run(cuda, rule, dtype, True, False, steps)
    c = counters()
    names = ("adafactor_stats", "adafactor_update") if rule == "adafactor" \
        else (f"{rule}_update",)
    for n in names:
        assert c[n] == {"launches": steps, "plain_calls": 0}
    whole = _split_run(cuda, rule, dtype, False, False, steps)
    ref = _split_run(cuda, rule, dtype, True, True, steps)
    for a, w, r in zip(got, whole, ref):
        assert torch.equal(a, w)
        if rule != "adafactor":
            assert torch.equal(a, r)
        elif a.dtype == torch.bfloat16:
            _bf16_close(a, r, r, "adafactor split")
        else:
            scale = r.abs() + r.abs().max()
            assert ((a - r).abs() / scale.clamp_min(1e-30)).max() <= 1e-5


# -- optimizer offload: the lane and the offloaded step on the card ----------

@pytest.mark.gpu
@pytest.mark.parametrize("overlap", [True, False])
def test_stream_lane_on_the_card(cuda, overlap):
    """Copies between page-locked host tensors and the card through the
    lane: the values land, ``wait()`` orders the consumer's stream after
    the copy (a kernel queued right after reads the new bytes), the
    counters read the bytes, inline copies hide nothing."""
    from paddle_tpu_torch.jit.offload_stream import (StreamLane, pin,
                                                     pinned_host_supported)

    assert pinned_host_supported()
    host = pin(torch.arange(1 << 20, dtype=torch.float32))
    assert host.is_pinned()
    dev = torch.empty(1 << 20, dtype=torch.float32, device=cuda)
    lane = StreamLane(overlap=overlap)
    try:
        lane.submit("h2d", [host], [dev], tag=0).wait()
        total = dev.sum()  # queued after the wait on the compute stream
        back = pin(torch.empty(1 << 20, dtype=torch.float32))
        dev.mul_(2)
        lane.submit("d2h", [dev], [back], tag=0).synchronize()
        assert float(total) == float(host.double().sum())
        assert torch.equal(back, host * 2)
        s = lane.stats()
        assert s["h2d_bytes"] == s["d2h_bytes"] == 4 << 20
        assert s["transfers"] == 2 and s["transfer_ms"] > 0
        if not overlap:
            assert s["overlap_efficiency"] == 0.0
    finally:
        lane.close()


@pytest.mark.gpu
@pytest.mark.parametrize("accumulate", [0, 2])
def test_offloaded_step_equals_resident_on_the_card(cuda, accumulate,
                                                    monkeypatch):
    """A tiny fp32 Llama over a world-1 gloo mesh (eager: gloo's
    collectives cannot be captured; ``chip_smoke.py``'s ``offload-check``
    runs the graphed step over NCCL), AdamW under a global-norm clip:
    three offloaded steps (the lane overlapped and serialized) equal the
    resident step bit for bit; the moments and masters rest in
    page-locked host memory; the walk's update is one ``adam_update``
    launch a group a step."""
    import paddle_tpu_torch.distributed as pdist
    from paddle_tpu_torch.device import seed as pt_seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    _world_one()
    cfg = LlamaConfig.tiny()
    model = LlamaForCausalLM(cfg, device=cuda, generator=pt_seed(5, cuda))
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    ids = torch.randint(0, cfg.vocab_size, (4, 64), device=cuda,
                        generator=pt_seed(6, cuda))
    pdist.init_mesh()
    out = {}
    try:
        for kind in ("resident", "overlapped", "serialized"):
            monkeypatch.setenv("PT_OFFLOAD_OVERLAP",
                               "0" if kind == "serialized" else "1")
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(init[n])
            opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                        weight_decay=0.1, grad_clip=ClipGradByGlobalNorm(1.0))
            _m, opt = pdist.group_sharded_parallel(
                model, opt, level="os_g", offload=kind != "resident",
                segment_size=1 << 16, buffer_max_size=1 << 18)
            step = pdist.ShardedTrainStep(model,
                                          lambda m, x, y: m(x, labels=y),
                                          opt, graph=False)
            run = step.accumulate(accumulate) if accumulate else step
            reset_counters()
            losses = [float(run(ids, ids)) for _ in range(3)]
            torch.cuda.synchronize()
            out[kind] = (losses, {n: p.detach().clone()
                                  for n, p in model.named_parameters()})
            if kind != "resident":
                off = step._off
                assert off.host.is_pinned() and len(off.groups) > 2
                for st in opt._state.values():
                    for v in st.values():
                        assert v.device.type == "cpu" and v.is_pinned()
                assert counters()["adam_update"]["launches"] == \
                    3 * len(off.groups)
                off.close()
    finally:
        pdist.reset_mesh()
    ref_l, ref_p = out["resident"]
    for kind in ("overlapped", "serialized"):
        losses, params = out[kind]
        assert losses == ref_l, kind
        for n, p in params.items():
            assert torch.equal(p, ref_p[n]), (kind, n)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_eval_forward_runs_the_flash_kernel_at_bert_shape(cuda, dtype):
    """BERT-base's width (12 heads of 64) at 2 layers, batch 32 x 128, in
    ``eval()`` without a mask: every attention call is one flash forward
    (bh 384, 128 x 128, d 64, not causal) on the kernel the route names
    (``flash_fwd_tf32x3.cu`` in fp32, ``flash_fwd_sm90.cu`` in bf16), held
    against the plain version on fp32 copies of its inputs (fp32 1e-4,
    bf16 ``sm90_fwd_bound``)."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.models import (BertConfig,
                                         BertForSequenceClassification)

    fa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    prior = P.get_device()
    P.set_device("gpu")
    try:
        P.seed(5)
        model = BertForSequenceClassification(
            BertConfig(num_hidden_layers=2, dtype=dtype)).eval()
        gen = torch.Generator(device=cuda).manual_seed(6)
        ids = torch.randint(0, 30522, (32, 128), generator=gen, device=cuda)
        calls = []
        real = fa.flash_attention_fwd

        def recorder(q, k, v, offset, causal, scale):
            o, lse = real(q, k, v, offset, causal, scale)
            calls.append((q, k, v, offset, causal, scale, o))
            return o, lse

        fa.flash_attention_fwd = recorder
        try:
            reset_counters()
            with torch.no_grad():
                logits = model(ids)
            torch.cuda.synchronize()
        finally:
            fa.flash_attention_fwd = real
        counts = counters()
    finally:
        P.set_device(prior)
    assert logits.shape == (32, 2) and torch.isfinite(logits).all()
    want = "flash_attention_sm90" if dtype == "bfloat16" else \
        "flash_attention_tf32x3"
    assert counts[want]["launches"] == 2
    assert all(c["launches"] == 0 for n, c in counts.items() if n != want)
    assert all(c["plain_calls"] == 0 for c in counts.values())
    assert len(calls) == 2
    for q, k, v, offset, causal, scale, o in calls:
        assert tuple(q.shape) == (384, 128, 64) and not causal
        f32 = [t.float() for t in (q, k, v)]
        ref, _ = flash_attention_plain(*f32, offset, causal, scale)
        if dtype == "bfloat16":
            _within(o, ref, sm90_fwd_bound(*f32, offset, causal, scale, ref),
                    "bert flash forward")
        else:
            _close(o.cpu(), ref.cpu(), (0.0, 1e-4))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(512, 256, 256, False), (7, 77, 131, True),
                                   (5, 130, 64, False)],
                         ids=["dit_xl2", "ragged_causal", "ragged"])
def test_cuda_core_flash_kernels_at_head_dim_72(cuda, shape):
    """DiT-XL/2's attention (fp32, head dim 1152 / 16 = 72, bh 32 x 16,
    256 x 256) and ragged cases at d 72 run the 3xTF32 forward, dK/dV and
    dQ kernels (no CUDA-core one), each against its plain version on the
    same inputs: o within 1e-4, the gradients within 1e-4 relative + 1e-4
    (fp32 sums over up to s terms in another order)."""
    bh, sq, sk, causal = shape
    d = 72
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, do = (torch.randn(bh, sq, d, generator=gen, device=cuda)
             for _ in range(2))
    k, v = (torch.randn(bh, sk, d, generator=gen, device=cuda)
            for _ in range(2))
    off = sk - sq if causal else 0
    scale = 1.0 / d ** 0.5
    assert route(torch.float32, d, sq) == "tf32x3"
    assert not takes_sm90(torch.float32, d) and takes_tf32x3(torch.float32,
                                                             d)
    reset_counters()
    o, lse = flash_attention_fwd(q, k, v, off, causal, scale)
    ro, rlse = flash_attention_plain(q, k, v, off, causal, scale)
    _close(o.cpu(), ro.cpu(), (0.0, 1e-4))
    _close(lse.cpu(), rlse.cpu(), (0.0, 1e-3))
    delta = (do * ro).sum(-1)
    args = (rlse, delta, off, causal, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, *args)
    dq = flash_attention_bwd_dq(q, k, v, do, *args)
    rdk, rdv = flash_attention_bwd_dkv_plain(q, k, v, do, *args)
    rdq = flash_attention_bwd_dq_plain(q, k, v, do, *args)
    for got, ref in ((dk, rdk), (dv, rdv), (dq, rdq)):
        _close(got.cpu(), ref.cpu(), (1e-4, 1e-4))
    counts = counters()
    for n in ("flash_attention_tf32x3", "flash_attention_bwd_dkv_tf32x3",
              "flash_attention_bwd_dq_tf32x3"):
        assert counts[n] == {"launches": 1, "plain_calls": 0}, n
    for n in ("flash_attention", "flash_attention_bwd_dkv",
              "flash_attention_bwd_dq", "flash_attention_sm90",
              "flash_attention_bwd_dkv_sm90", "flash_attention_bwd_dq_sm90"):
        assert counts[n]["launches"] == 0, n


# the 3xTF32 kernels: (bh, sq, sk, offset, causal, d): DiT-XL/2's and
# BERT-base's attention; ragged causal and non-causal cases at head dims 8
# to 128; offsets below 0, where rows see no key (all of them at -96); 4096
# keys at d 128, where a running sum in the tensor cores truncated
_TF32X3_CASES = [(512, 256, 256, 0, False, 72), (384, 128, 128, 0, False, 64),
                 (2, 256, 4096, 3840, True, 128)]
_TF32X3_CASES += [(3, 77, 131, 54, True, d) for d in (8, 32, 64, 72, 96, 128)]
_TF32X3_CASES += [(3, 130, 61, 0, False, d)
                  for d in (8, 32, 64, 72, 96, 128)]
_TF32X3_CASES += [(3, 64, 64, -8, True, 72), (2, 200, 200, -157, True, 128),
                  (2, 96, 96, -96, True, 40)]


@pytest.mark.gpu
@pytest.mark.parametrize("bh,sq,sk,offset,causal,d", _TF32X3_CASES)
def test_tf32x3_kernels_match_plain(cuda, bh, sq, sk, offset, causal, d):
    """The fp32 tensor-core forward, dK/dV and dQ kernels (3xTF32), through
    the dispatching wrappers, against their plain versions on the same
    inputs at the fp32 tolerances: o (0, 1e-4), lse (0, 1e-3), dK, dV and
    dQ (1e-4, 1e-4). Each call launches its kernel once and no other. Rows
    that see no key give o = 0, lse = -1e30 and dQ = 0 exactly and add
    nothing to dK and dV (a dO of 1000 on them changes neither bit); two
    launches of each kernel agree bit for bit."""
    rng = np.random.default_rng(31)
    scale = 1.0 / d ** 0.5

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(cuda)

    q, k, v, do = (rnd(bh, s, d) for s in (sq, sk, sk, sq))
    assert route(torch.float32, d, sq) == "tf32x3"
    reset_counters()
    o, lse = flash_attention_fwd(q, k, v, offset, causal, scale)
    torch.cuda.synchronize()
    c = counters()
    assert c["flash_attention_tf32x3"] == {"launches": 1, "plain_calls": 0}
    assert sum(c[n]["launches"] for n in c) == 1
    ro, rl = flash_attention_plain(q, k, v, offset, causal, scale)
    _close(o.cpu(), ro.cpu(), (0.0, 1e-4))
    _close(lse.cpu(), rl.cpu(), (0.0, 1e-3))
    delta = (do * ro).sum(-1) - rnd(bh, sq)
    args = (rl, delta, offset, causal, scale)
    reset_counters()
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, *args)
    torch.cuda.synchronize()
    c = counters()
    assert c["flash_attention_bwd_dkv_tf32x3"] == {"launches": 1,
                                                   "plain_calls": 0}
    assert sum(c[n]["launches"] for n in c) == 1
    rdk, rdv = flash_attention_bwd_dkv_plain(q, k, v, do, *args)
    _close(dk.cpu(), rdk.cpu(), (1e-4, 1e-4))
    _close(dv.cpu(), rdv.cpu(), (1e-4, 1e-4))
    reset_counters()
    dq = flash_attention_bwd_dq(q, k, v, do, *args)
    torch.cuda.synchronize()
    c = counters()
    assert c["flash_attention_bwd_dq_tf32x3"] == {"launches": 1,
                                                  "plain_calls": 0}
    assert sum(c[n]["launches"] for n in c) == 1
    rdq = flash_attention_bwd_dq_plain(q, k, v, do, *args)
    _close(dq.cpu(), rdq.cpu(), (1e-4, 1e-4))
    o2, lse2 = flash_attention_fwd(q, k, v, offset, causal, scale)
    dk2, dv2 = flash_attention_bwd_dkv(q, k, v, do, *args)
    dq2 = flash_attention_bwd_dq(q, k, v, do, *args)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert torch.equal(dq, dq2)
    if causal and offset < 0:
        blind = min(sq, -offset)  # rows i with i + offset < 0
        assert not o[:, :blind].any()
        assert (lse[:, :blind] == -1e30).all()
        assert not dq[:, :blind].any()
        loud = do.clone()
        loud[:, :blind] *= 1000
        dk3, dv3 = flash_attention_bwd_dkv(q, k, v, loud, *args)
        assert torch.equal(dk, dk3) and torch.equal(dv, dv3)
        if blind == sq:
            assert not dk.any() and not dv.any()


@pytest.mark.gpu
def test_tf32x3_wrappers_take_unaligned_and_strided_inputs(cuda):
    """cp.async reads 16-byte aligned rows: the wrappers copy a q that
    starts off a 16-byte boundary and a non-contiguous k, and the results
    still match the plain versions."""
    rng = np.random.default_rng(32)
    bh, s, d = 4, 100, 72
    flat = torch.empty(bh * s * d + 1, device=cuda)
    q = flat[1:].view(bh, s, d)
    q.copy_(torch.from_numpy(rng.standard_normal((bh, s, d),
                                                 dtype=np.float32)))
    assert q.data_ptr() % 16 != 0
    k = torch.from_numpy(rng.standard_normal((s, bh, d), dtype=np.float32)
                         ).to(cuda).transpose(0, 1)
    v, do = (torch.from_numpy(rng.standard_normal((bh, s, d),
                                                  dtype=np.float32)).to(cuda)
             for _ in range(2))
    assert not k.is_contiguous()
    o, lse = flash_attention_fwd(q, k, v, 0, True, d ** -0.5)
    ro, rl = flash_attention_plain(q, k, v, 0, True, d ** -0.5)
    _close(o.cpu(), ro.cpu(), (0.0, 1e-4))
    args = (rl, (do * ro).sum(-1), 0, True, d ** -0.5)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, *args)
    rdk, rdv = flash_attention_bwd_dkv_plain(q, k, v, do, *args)
    _close(dk.cpu(), rdk.cpu(), (1e-4, 1e-4))
    _close(dv.cpu(), rdv.cpu(), (1e-4, 1e-4))
    dq = flash_attention_bwd_dq(q, k, v, do, *args)
    rdq = flash_attention_bwd_dq_plain(q, k, v, do, *args)
    _close(dq.cpu(), rdq.cpu(), (1e-4, 1e-4))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [12, 36, 136])
def test_cuda_core_flash_kernels_keep_the_other_fp32_head_dims(cuda, d):
    """fp32 at a head dim that is not a multiple of 8, or above 128, still
    runs PR 1's forward and PR 2's dK/dV and dQ on the CUDA cores, within
    the fp32 tolerances of their plain versions."""
    rng = np.random.default_rng(33)
    bh, sq, sk, scale = 3, 50, 70, d ** -0.5

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(cuda)

    q, k, v, do = (rnd(bh, s, d) for s in (sq, sk, sk, sq))
    assert route(torch.float32, d, sq) == "cuda_core"
    assert not takes_tf32x3(torch.float32, d)
    reset_counters()
    o, lse = flash_attention_fwd(q, k, v, sk - sq, True, scale)
    ro, rl = flash_attention_plain(q, k, v, sk - sq, True, scale)
    args = (rl, (do * ro).sum(-1), sk - sq, True, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, *args)
    dq = flash_attention_bwd_dq(q, k, v, do, *args)
    torch.cuda.synchronize()
    c = counters()
    for n in ("flash_attention", "flash_attention_bwd_dkv",
              "flash_attention_bwd_dq"):
        assert c[n] == {"launches": 1, "plain_calls": 0}, n
    assert c["flash_attention_tf32x3"]["launches"] == 0
    assert c["flash_attention_bwd_dkv_tf32x3"]["launches"] == 0
    assert c["flash_attention_bwd_dq_tf32x3"]["launches"] == 0
    _close(o.cpu(), ro.cpu(), (0.0, 1e-4))
    rdk, rdv = flash_attention_bwd_dkv_plain(q, k, v, do, *args)
    rdq = flash_attention_bwd_dq_plain(q, k, v, do, *args)
    for got, ref in ((dk, rdk), (dv, rdv), (dq, rdq)):
        _close(got.cpu(), ref.cpu(), (1e-4, 1e-4))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,sq", [(torch.bfloat16, 64, 8),
                                        (torch.float32, 36, 8),
                                        (torch.float32, 136, 8),
                                        (torch.float32, 64, 1)])
def test_tf32x3_wrappers_raise_on_what_their_kernels_do_not_take(
        cuda, dtype, d, sq):
    """On the card the 3xTF32 wrappers raise, before any launch, on a dtype,
    head dim or (forward) single row that their kernels do not take."""
    fa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    q = torch.zeros(2, sq, d, device=cuda, dtype=dtype)
    stats = torch.zeros(2, sq, device=cuda)
    reset_counters()
    with pytest.raises(ValueError, match="fp32 tensor-core kernel"):
        fa.flash_attention_fwd_tf32x3(q, q, q, 0, True, 0.1)
    if sq > 1:
        with pytest.raises(ValueError, match="fp32 tensor-core kernel"):
            fa.flash_attention_bwd_dkv_tf32x3(q, q, q, q, stats, stats, 0,
                                              True, 0.1)
        with pytest.raises(ValueError, match="fp32 tensor-core kernel"):
            fa.flash_attention_bwd_dq_tf32x3(q, q, q, q, stats, stats, 0,
                                             True, 0.1)
    assert all(c["launches"] == 0 for c in counters().values())


@pytest.mark.gpu
@pytest.mark.parametrize("fn", ["fwd", "dkv", "dq"])
@pytest.mark.parametrize("dtype,d,match", [
    (torch.bfloat16, 12, "tensor-core kernel"),
    (torch.bfloat16, 264, "head_dim <= 256"),
    (torch.float32, 256, "tensor-core kernel"),
    (torch.bfloat16, 136, None), (torch.bfloat16, 256, None)])
def test_sm90_wrappers_raise_on_what_their_kernels_do_not_take(
        cuda, fn, dtype, d, match):
    """On the card the bf16 tensor-core wrappers raise, before any launch,
    on a dtype or head dim that their kernels do not take; none hands the
    call to another kernel. At 136 and 256 all three take the call
    (``match`` None) and launch their own kernel once."""
    fa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    q = torch.zeros(2, 8, d, device=cuda, dtype=dtype)
    stats = torch.zeros(2, 8, device=cuda)
    calls = {"fwd": lambda: fa.flash_attention_fwd_sm90(q, q, q, 0, True,
                                                        0.1),
             "dkv": lambda: fa.flash_attention_bwd_dkv_sm90(
                 q, q, q, q, stats, stats, 0, True, 0.1),
             "dq": lambda: fa.flash_attention_bwd_dq_sm90(
                 q, q, q, q, stats, stats, 0, True, 0.1)}
    reset_counters()
    if match is None:
        calls[fn]()
        torch.cuda.synchronize()
        launched = {n: c["launches"] for n, c in counters().items()
                    if c["launches"]}
        assert launched == {{"fwd": "flash_attention_sm90",
                             "dkv": "flash_attention_bwd_dkv_sm90",
                             "dq": "flash_attention_bwd_dq_sm90"}[fn]: 1}
        return
    with pytest.raises(ValueError, match=match):
        calls[fn]()
    assert all(c["launches"] == 0 for c in counters().values())


# the bf16 tensor-core forward and dK/dV at head dims other than 64 and 128:
# (bh, sq, sk, offset, causal, d): ragged causal and non-causal cases at
# head dims 8 to 112 and, on the 64-key instances, 136 (two whole chunks
# and 16 columns), 192 and 256; offsets below 0, where rows see no key (all
# of them at -96); d 64 and 128 on the same kernels
_SM90_HEADDIMS = (8, 16, 40, 72, 80, 96, 112, 136, 192, 256)
_SM90_HEADDIM_CASES = [(3, 77, 131, 54, True, d) for d in _SM90_HEADDIMS]
_SM90_HEADDIM_CASES += [(3, 130, 61, 0, False, d) for d in _SM90_HEADDIMS]
_SM90_HEADDIM_CASES += [(3, 64, 64, -8, True, 72),
                        (2, 200, 200, -157, True, 96),
                        (2, 96, 96, -96, True, 40),
                        (2, 300, 340, 40, True, 80),
                        (2, 200, 200, -157, True, 128),
                        (3, 130, 61, 0, False, 64),
                        (2, 200, 200, -157, True, 256),
                        (2, 96, 96, -96, True, 136),
                        (2, 300, 340, 40, True, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("bh,sq,sk,offset,causal,d", _SM90_HEADDIM_CASES)
def test_sm90_kernels_at_every_head_dim_match_plain(cuda, bh, sq, sk, offset,
                                                    causal, d):
    """The bf16 tensor-core forward, dK/dV and dQ kernels, through the
    dispatching wrappers, against their fp32 plain versions on the same
    bf16 inputs: o within ``sm90_fwd_bound``, lse within 1e-3, dK and dV
    within ``sm90_dkv_bound``, dQ within ``sm90_dq_bound`` (above 128 the
    32-key instances). Each call launches its kernel once and no other. Rows
    that see no key give o = 0,
    lse = -1e30 and dQ = 0 exactly and add nothing to dK and dV (a dO of
    1000 on them changes neither bit); two launches of each kernel agree
    bit for bit."""
    rng = np.random.default_rng(37)
    scale = 1.0 / d ** 0.5

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(cuda)

    q, k, v, do = (rnd(bh, s, d).to(torch.bfloat16)
                   for s in (sq, sk, sk, sq))
    f32 = [t.float() for t in (q, k, v, do)]
    assert route(torch.bfloat16, d, sq) == "sm90"
    reset_counters()
    o, lse = flash_attention_fwd(q, k, v, offset, causal, scale)
    torch.cuda.synchronize()
    c = counters()
    assert c["flash_attention_sm90"] == {"launches": 1, "plain_calls": 0}
    assert sum(c[n]["launches"] for n in c) == 1
    ro, rl = flash_attention_plain(*f32[:3], offset, causal, scale)
    _within(o, ro, sm90_fwd_bound(*f32[:3], offset, causal, scale, ro), "o")
    _close(lse.cpu(), rl.cpu(), (0.0, 1e-3))
    delta = (f32[3] * ro).sum(-1) - rnd(bh, sq)
    args = (rl, delta, offset, causal, scale)
    reset_counters()
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, *args)
    torch.cuda.synchronize()
    c = counters()
    assert c["flash_attention_bwd_dkv_sm90"] == {"launches": 1,
                                                 "plain_calls": 0}
    assert sum(c[n]["launches"] for n in c) == 1
    rdk, rdv = flash_attention_bwd_dkv_plain(*f32, *args)
    bdk, bdv = sm90_dkv_bound(*f32, *args, rdk, rdv)
    _within(dk, rdk, bdk, "dk")
    _within(dv, rdv, bdv, "dv")
    reset_counters()
    dq = flash_attention_bwd_dq(q, k, v, do, *args)
    torch.cuda.synchronize()
    c = counters()
    assert takes_sm90(torch.bfloat16, d)
    assert c["flash_attention_bwd_dq_sm90"] == {"launches": 1,
                                                "plain_calls": 0}
    assert sum(c[n]["launches"] for n in c) == 1
    rdq = flash_attention_bwd_dq_plain(*f32, *args)
    _within(dq, rdq, sm90_dq_bound(*f32, *args, rdq), "dq")
    o2, lse2 = flash_attention_fwd(q, k, v, offset, causal, scale)
    dk2, dv2 = flash_attention_bwd_dkv(q, k, v, do, *args)
    dq2 = flash_attention_bwd_dq(q, k, v, do, *args)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert torch.equal(dq, dq2)
    if causal and offset < 0:
        blind = min(sq, -offset)  # rows i with i + offset < 0
        assert not o[:, :blind].any()
        assert (lse[:, :blind] == -1e30).all()
        assert not dq[:, :blind].any()
        loud = do.clone()
        loud[:, :blind] = 1000
        dk3, dv3 = flash_attention_bwd_dkv(q, k, v, loud, *args)
        assert torch.equal(dk, dk3) and torch.equal(dv, dv3)
        if blind == sq:
            assert not dk.any() and not dv.any()


# the dQ kernel's instances above 128 at the shapes of the CPU emulation
# (``_WIDE_CASES`` in tests/test_torch_sm90_headdims.py): ragged lengths,
# causal with offsets 128 and 64, rows that see no key (offset -64), not
# causal; at d 136 (DP 144), 184 (DP 192: a third chunk of 56 columns) and
# 256
_WIDE_DQ_SHAPES = [(192, 320, 128, True), (320, 192, -64, True),
                   (64, 192, 0, False), (128, 192, 64, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [136, 184, 256])
@pytest.mark.parametrize("sq,sk,offset,causal", _WIDE_DQ_SHAPES)
def test_sm90_dq_above_128_matches_plain(cuda, sq, sk, offset, causal, d):
    """The tensor-core dQ above head dim 128
    (``csrc/flash_bwd_dq_sm90_wide.cu``), through the dispatching wrapper,
    against its fp32 plain version on the same bf16 inputs and an lse
    cotangent: within ``sm90_dq_bound``, one launch of its kernel a call
    and none of another, rows that see no key exactly 0, and two calls
    equal bit for bit."""
    rng = np.random.default_rng(41 + d)
    bh, scale = 2, d ** -0.5

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(cuda)

    q, k, v, do = (rnd(bh, s, d).to(torch.bfloat16)
                   for s in (sq, sk, sk, sq))
    f32 = [t.float() for t in (q, k, v, do)]
    ro, rl = flash_attention_plain(*f32[:3], offset, causal, scale)
    args = (rl, (f32[3] * ro).sum(-1) - rnd(bh, sq), offset, causal, scale)
    reset_counters()
    dq = flash_attention_bwd_dq(q, k, v, do, *args)
    torch.cuda.synchronize()
    c = counters()
    assert c["flash_attention_bwd_dq_sm90"] == {"launches": 1,
                                                "plain_calls": 0}
    assert sum(c[n]["launches"] for n in c) == 1
    rdq = flash_attention_bwd_dq_plain(*f32, *args)
    _within(dq, rdq, sm90_dq_bound(*f32, *args, rdq), "dq")
    if causal and offset < 0:
        assert not dq[:, :-offset].any()
    assert torch.equal(dq, flash_attention_bwd_dq(q, k, v, do, *args))


@pytest.mark.gpu
def test_sm90_dq_at_d256_in_the_llama_mqa_layout(cuda):
    """The attention layout of the ``llama-d256`` step: one key/value head
    repeated to 8 query heads by ``repeat_interleave`` (as the Llama
    repeats them), the [b, s, h, 256] tensors taken to [b h, s, d] as
    ``flash_attention`` takes them, causal over 300 rows, through autograd:
    one launch each of the tensor-core forward, dK/dV and dQ and none of
    any other kernel, and dQ within ``sm90_dq_bound`` of the plain version
    on the same inputs, lse and delta."""
    rng = np.random.default_rng(43)
    b, s, h, d = 2, 300, 8, 256

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(cuda).to(torch.bfloat16)

    def bhsd(t):
        return t.transpose(1, 2).reshape(b * h, s, d)

    q = rnd(b, s, h, d).requires_grad_()
    k1, v1 = (rnd(b, s, 1, d).requires_grad_() for _ in range(2))
    go = rnd(b, s, h, d)
    reset_counters()
    k, v = (t.repeat_interleave(h, dim=2) for t in (k1, v1))
    o, lse = flash_attention_with_lse(bhsd(q), bhsd(k), bhsd(v), 0, True)
    o.backward(bhsd(go))
    torch.cuda.synchronize()
    launched = {n: c["launches"] for n, c in counters().items()
                if c["launches"]}
    assert launched == {"flash_attention_sm90": 1,
                        "flash_attention_bwd_dkv_sm90": 1,
                        "flash_attention_bwd_dq_sm90": 1}
    assert k1.grad is not None and v1.grad is not None
    f32 = [bhsd(t.detach()).float() for t in (q, k, v, go)]
    args = (lse.detach(), (f32[3] * o.detach().float()).sum(-1), 0, True,
            d ** -0.5)
    rdq = flash_attention_bwd_dq_plain(*f32, *args)
    _within(bhsd(q.grad), rdq, sm90_dq_bound(*f32, *args, rdq), "dq")


@pytest.mark.gpu
def test_sm90_wrappers_take_unaligned_and_strided_inputs_at_d96(cuda):
    """TMA reads 16-byte aligned rows: at head dim 96 the tensor-core
    wrappers (forward, dK/dV and dQ) copy a q that starts off a 16-byte
    boundary and a non-contiguous k, and the results still hold their
    bounds."""
    rng = np.random.default_rng(38)
    bh, s, d = 4, 100, 96
    bf = dict(device=cuda, dtype=torch.bfloat16)
    flat = torch.empty(bh * s * d + 1, **bf)
    q = flat[1:].view(bh, s, d)
    q.copy_(torch.from_numpy(rng.standard_normal((bh, s, d),
                                                 dtype=np.float32)))
    assert q.data_ptr() % 16 != 0
    k = torch.from_numpy(rng.standard_normal((s, bh, d), dtype=np.float32)
                         ).to(**bf).transpose(0, 1)
    v, do = (torch.from_numpy(rng.standard_normal((bh, s, d),
                                                  dtype=np.float32)).to(**bf)
             for _ in range(2))
    assert not k.is_contiguous()
    f32 = [t.float() for t in (q, k, v, do)]
    o, lse = flash_attention_fwd(q, k, v, 0, True, d ** -0.5)
    ro, rl = flash_attention_plain(*f32[:3], 0, True, d ** -0.5)
    _within(o, ro, sm90_fwd_bound(*f32[:3], 0, True, d ** -0.5, ro), "o")
    args = (rl, (f32[3] * ro).sum(-1), 0, True, d ** -0.5)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, *args)
    rdk, rdv = flash_attention_bwd_dkv_plain(*f32, *args)
    bdk, bdv = sm90_dkv_bound(*f32, *args, rdk, rdv)
    _within(dk, rdk, bdk, "dk")
    _within(dv, rdv, bdv, "dv")
    dq = flash_attention_bwd_dq(q, k, v, do, *args)
    rdq = flash_attention_bwd_dq_plain(*f32, *args)
    _within(dq, rdq, sm90_dq_bound(*f32, *args, rdq), "dq")


@pytest.mark.gpu
@pytest.mark.parametrize("d", [12, 136, 256])
def test_cuda_core_flash_kernels_keep_the_other_bf16_head_dims(cuda, d):
    """bf16 at a head dim that is not a multiple of 8 still runs the
    CUDA-core forward, dK/dV and dQ kernels; above 128 the dispatch takes
    the tensor cores for all three, and the CUDA-core kernels, which keep
    fp32 there, still compute the bf16 function when called. Each
    CUDA-core kernel holds one bf16 rounding of its plain version (the
    backward with rtol 1e-4 more for its longer sums), the tensor-core
    kernels their bounds."""
    fa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    rng = np.random.default_rng(39)
    bh, sq, sk, scale = 3, 50, 70, d ** -0.5

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(cuda)

    q, k, v, do = (rnd(bh, s, d).to(torch.bfloat16)
                   for s in (sq, sk, sk, sq))
    f32 = [t.float() for t in (q, k, v, do)]
    wide = d > 128  # every flash kernel on the tensor cores
    assert route(torch.bfloat16, d, sq) == ("sm90" if wide else "cuda_core")
    assert takes_sm90(torch.bfloat16, d) is wide
    reset_counters()
    o, lse = flash_attention_fwd(q, k, v, sk - sq, True, scale)
    ro, rl = flash_attention_plain(*f32[:3], sk - sq, True, scale)
    args = (rl, (f32[3] * ro).sum(-1), sk - sq, True, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, *args)
    dq = flash_attention_bwd_dq(q, k, v, do, *args)
    torch.cuda.synchronize()
    c = counters()
    tc = "_sm90" if wide else ""
    for n in ("flash_attention", "flash_attention_bwd_dkv",
              "flash_attention_bwd_dq"):
        assert c[n + tc] == {"launches": 1, "plain_calls": 0}, n
    assert sum(c[n]["launches"] for n in c) == 3
    rdk, rdv = flash_attention_bwd_dkv_plain(*f32, *args)
    rdq = flash_attention_bwd_dq_plain(*f32, *args)
    if wide:
        _within(o, ro, sm90_fwd_bound(*f32[:3], sk - sq, True, scale, ro),
                "o")
        bdk, bdv = sm90_dkv_bound(*f32, *args, rdk, rdv)
        _within(dk, rdk, bdk, "dk")
        _within(dv, rdv, bdv, "dv")
        _within(dq, rdq, sm90_dq_bound(*f32, *args, rdq), "dq")
        # the CUDA-core kernels on the same inputs
        o, lse = fa.flash_attention_fwd_cuda_core(q, k, v, sk - sq, True,
                                                  scale)
        dk, dv = fa.flash_attention_bwd_dkv_cuda_core(q, k, v, do, *args)
        dq = fa.flash_attention_bwd_dq_cuda_core(q, k, v, do, *args)
        torch.cuda.synchronize()
        c = counters()
        for n in ("flash_attention", "flash_attention_bwd_dkv",
                  "flash_attention_bwd_dq"):
            assert c[n] == {"launches": 1, "plain_calls": 0}, n
    _close(o.float().cpu(), ro.cpu(), (2.0 ** -8, 1e-4))
    _close(lse.cpu(), rl.cpu(), (0.0, 1e-3))
    for got, ref in ((dk, rdk), (dv, rdv), (dq, rdq)):
        _close(got.float().cpu(), ref.cpu(), (2.0 ** -8 + 1e-4, 1e-4))


def _deterministic(on):
    import paddle_tpu_torch as P

    P.set_flags({"FLAGS_cudnn_deterministic": on})


def _twice_under_the_flag(run):
    """``run()`` twice from its own seeded start with
    ``FLAGS_cudnn_deterministic`` on; the flag is turned off after."""
    _deterministic(True)
    try:
        return run(), run()
    finally:
        _deterministic(False)


@pytest.mark.gpu
def test_two_eager_bert_steps_are_bit_for_bit_under_the_flag(cuda):
    """BERT-base's width at 2 layers, fp32, dropout 0.1, the finetune
    recipe, two eager steps on ids that repeat (the embedding backward sums
    repeated rows): twice from the same weights and generator state, every
    parameter and the losses equal bit for bit."""
    import paddle_tpu_torch as P
    import paddle_tpu_torch.nn as pnn
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (BertConfig,
                                         BertForSequenceClassification)
    from paddle_tpu_torch.optimizer import AdamW

    prior = P.get_device()
    P.set_device("gpu")
    try:
        gen = torch.Generator(device=cuda).manual_seed(3)
        ids = torch.randint(1000, 1064, (16, 128), generator=gen,
                            device=cuda)
        labels = torch.randint(0, 2, (16,), generator=gen, device=cuda)

        def run():
            P.seed(4)
            model = BertForSequenceClassification(
                BertConfig(num_hidden_layers=2))
            loss_fn = pnn.CrossEntropyLoss()
            opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                        grad_clip=pnn.ClipGradByGlobalNorm(1.0))
            step = TrainStep(model, lambda m, x, y: loss_fn(m(x), y), opt,
                             graph=False)
            losses = [float(step(ids, labels)) for _ in range(2)]
            return losses, {n: p.detach().clone()
                            for n, p in model.named_parameters()}

        (la, pa_), (lb, pb) = _twice_under_the_flag(run)
    finally:
        P.set_device(prior)
    assert la == lb
    for n in pa_:
        assert torch.equal(pa_[n], pb[n]), n


@pytest.mark.gpu
def test_resnet18_steps_are_bit_for_bit_under_the_flag(cuda):
    """ResNet-18 (10 classes) on 32 x 32 images, fp32, Momentum, two eager
    steps twice under the flag: cuDNN's convolution backward and the
    adaptive pooling's mean run deterministically (the strict mode would
    raise on an operation without a deterministic form), and losses,
    parameters and BatchNorm buffers equal bit for bit."""
    import paddle_tpu_torch as P
    import paddle_tpu_torch.nn.functional as PF
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet18

    prior = P.get_device()
    P.set_device("gpu")
    try:
        gen = torch.Generator(device=cuda).manual_seed(5)
        x = torch.randn(16, 3, 32, 32, generator=gen, device=cuda)
        y = torch.randint(0, 10, (16,), generator=gen, device=cuda)

        def run():
            P.seed(6)
            model = resnet18(num_classes=10)
            opt = Momentum(learning_rate=0.05, momentum=0.9,
                           parameters=model.parameters())
            step = TrainStep(model, lambda m, a, b: PF.cross_entropy(m(a), b),
                             opt, graph=False)
            losses = [float(step(x, y)) for _ in range(2)]
            return losses, {n: t.detach().clone()
                            for n, t in model.state_dict().items()}

        (la, sa), (lb, sb) = _twice_under_the_flag(run)
    finally:
        P.set_device(prior)
    assert la == lb
    for n in sa:
        assert torch.equal(sa[n], sb[n]), n


@pytest.mark.gpu
def test_dit_step_graph_equals_eager_under_the_flag(cuda):
    """DiT-XL/2's widths at 2 layers, bf16 parameters (fp32 activations),
    non-zero adaLN: two eager ``TrainStep`` steps and two graphed calls
    (warm-up and the first replay) from the same weights and default
    generator state draw the same t, noise and label drops, and give the
    same losses and parameters bit for bit; a third replay on the same
    batch draws fresh t and noise (its loss differs from the second's)."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import DiT, DiTConfig, GaussianDiffusion
    from paddle_tpu_torch.optimizer import AdamW

    prior = P.get_device()
    P.set_device("gpu")
    try:
        cfg = DiTConfig.dit_xl_2(num_hidden_layers=2, dtype="bfloat16")
        P.seed(7)
        model = DiT(cfg)
        with torch.no_grad():
            for n, p in model.named_parameters():
                if "ada" in n or "final_proj" in n:
                    p.normal_(0.0, 0.02)
        state0 = {k: v.clone() for k, v in model.state_dict().items()}
        diffusion = GaussianDiffusion()
        gen = torch.Generator(device=cuda).manual_seed(8)
        x = torch.randn(4, 4, 32, 32, generator=gen, device=cuda)
        y = torch.randint(0, 1000, (4,), generator=gen, device=cuda)

        def run(graph):
            model.load_state_dict(state0)
            torch.cuda.manual_seed(9)
            opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                        weight_decay=0.0)
            step = TrainStep(model, lambda m, a, b:
                             diffusion.training_loss(m, a, b), opt,
                             graph=graph)
            losses = [float(step(x, y)) for _ in range(2)]
            params = {n: p.detach().clone()
                      for n, p in model.named_parameters()}
            if graph:  # one more replay on the same batch
                losses.append(float(step(x, y)))
            return losses, params

        _deterministic(True)
        try:
            (le, pe), (lg, pg) = run(False), run(True)
        finally:
            _deterministic(False)
    finally:
        P.set_device(prior)
    assert lg[:2] == le and lg[2] != lg[1]
    for n in pe:
        assert torch.equal(pe[n], pg[n]), n
