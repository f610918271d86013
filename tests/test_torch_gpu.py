"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device. The
file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import (counters, flash_attention_plain,
                                      flash_attention_with_lse,
                                      paged_attention, paged_attention_plain,
                                      reset_counters)
from paddle_tpu_torch.kernels import rmsnorm, rope
from paddle_tpu_torch.kernels.flash_attention import (
    flash_attention_bwd_dkv, flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq, flash_attention_bwd_dq_plain)


def _close(a, b, tol):
    rtol, atol = tol
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=rtol,
                               atol=atol)


# (rtol, atol) against the plain version on fp32 copies of the inputs:
# fp32 differs by summation order; bf16 adds one rounding of the result,
# at most half an ulp (2**-8 of the value)
_TOLS = [(torch.float32, (0.0, 1e-4)), (torch.bfloat16, (2.0 ** -8, 1e-4))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _TOLS)
@pytest.mark.parametrize("nh,kvh,hd,PL,W", [(4, 4, 16, 4, 2), (4, 2, 16, 4, 2),
                                            (6, 2, 12, 5, 2),
                                            (8, 2, 128, 16, 5),
                                            (32, 32, 128, 16, 1)])
def test_paged_attention_kernel_matches_plain(cuda, nh, kvh, hd, PL, W,
                                              dtype, tol):
    rng = np.random.default_rng(9)
    S, P, B = 3, 40, 6
    q = torch.from_numpy(rng.standard_normal((S, W, nh, hd),
                                             dtype=np.float32))
    ka = torch.from_numpy(rng.standard_normal((P, PL, kvh, hd),
                                              dtype=np.float32))
    va = torch.from_numpy(rng.standard_normal((P, PL, kvh, hd),
                                              dtype=np.float32))
    tables = torch.from_numpy(rng.integers(0, P, (S, B)).astype(np.int32))
    lens = torch.tensor([0, PL + 1, B * PL + 3], dtype=torch.int32)
    pos = lens[:, None] + torch.arange(W, dtype=torch.int32)
    args = [t.to(cuda) for t in (q, ka, va)]
    args = [a.to(dtype) for a in args] + [tables.to(cuda), pos.to(cuda)]
    reset_counters()
    got = paged_attention(*args)
    torch.cuda.synchronize()
    ref = paged_attention_plain(*[a.float() if a.is_floating_point() else a
                                  for a in args], 1.0 / hd ** 0.5)
    assert counters()["paged_attention"]["launches"] == 1
    _close(got.float().cpu(), ref.cpu(), tol)


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
    ro, rl = flash_attention_plain(*[t.float() for t in qkv], offset, causal,
                                   1.0 / d ** 0.5)
    assert counters()["flash_attention"]["launches"] == 1
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
    (offset -4: their dq must be exactly 0), head dims 16-256."""
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
    assert c["flash_attention_bwd_dkv"]["launches"] == 1
    assert c["flash_attention_bwd_dq"]["launches"] == 1
    rdk, rdv = flash_attention_bwd_dkv_plain(*f32, *args)
    rdq = flash_attention_bwd_dq_plain(*f32, *args)
    for got, ref in ((dk, rdk), (dv, rdv), (dq, rdq)):
        assert got.dtype == dtype
        _close(got.float().cpu(), ref.cpu(), tol)
    if offset < 0:
        assert not dq[:, :-offset].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _TOLS)
def test_flash_attention_autograd_uses_the_kernels(cuda, dtype, tol):
    """Gradients through ``flash_attention_with_lse`` (o and lse both used)
    equal the plain backward's and launch each backward kernel once."""
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
    assert c["flash_attention_bwd_dkv"]["launches"] == 1
    assert c["flash_attention_bwd_dq"]["launches"] == 1
    f32 = [t.detach().float() for t in leaves]
    ro, rl = flash_attention_plain(*f32, 0, True, 1.0 / d ** 0.5)
    delta = (go.to(dtype).float() * o.detach().float()).sum(-1) - gl
    args = (lse.detach(), delta, 0, True, 1.0 / d ** 0.5)
    rdk, rdv = flash_attention_bwd_dkv_plain(*f32, go.to(dtype).float(),
                                                *args)
    rdq = flash_attention_bwd_dq_plain(*f32, go.to(dtype).float(), *args)
    for leaf, ref in zip(leaves, (rdq, rdk, rdv)):
        _close(leaf.grad.float().cpu(), ref.cpu(), _BWD_TOLS[
            0 if dtype == torch.float32 else 1][1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _TOLS)
@pytest.mark.parametrize("n,h", [(5, 40), (33, 129), (1030, 2048),
                                 (3, 16384)])
@pytest.mark.parametrize("residual", [False, True])
def test_rms_norm_kernels_match_plain(cuda, n, h, residual, dtype, tol):
    """Forward (y, s, rstd) and backward (dx, dw) kernels against their plain
    versions; widths that are not a multiple of 32, ragged row counts, and
    a width whose dw partial row needs more than 48 KB of shared memory.
    dw sums n rows in another order: rtol 1e-4 on top of ``tol``."""
    rng = np.random.default_rng(13)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(cuda).to(dtype)

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
