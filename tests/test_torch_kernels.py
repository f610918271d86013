"""The PyTorch/CUDA port's kernels against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against the JAX package's Pallas kernels run in interpret mode (and,
for paged attention, its composed twin too) on the same numpy inputs. The
CUDA kernels are held against the plain versions by the tests marked
``gpu``, which skip without a card and live in ``test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import flash_attention as jflash
from paddle_tpu.kernels.pallas import paged_attention as jpaged
from paddle_tpu_torch.kernels import (counters, flash_attention,
                                      flash_attention_with_lse,
                                      paged_attention, reset_counters)

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


def test_flash_attention_paddle_layout_matches_jax():
    """[b, s, h, d] wrapper with a KV cache longer than the queries."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 8, 3, 16), dtype=np.float32)
    k = rng.standard_normal((2, 24, 3, 16), dtype=np.float32)
    v = rng.standard_normal((2, 24, 3, 16), dtype=np.float32)
    ref = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True, block_q=8,
                                 block_k=8)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    _close(got, ref)


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
