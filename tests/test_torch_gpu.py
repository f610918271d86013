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
