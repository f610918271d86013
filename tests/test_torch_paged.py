"""The port's paged attention: its kernel choice, the decode kernel's
split-and-merge and the window kernel's error bound, on the CPU.

On a CUDA tensor ``paged_attention`` launches one of three kernels, which
``route`` picks in plain code; here the choice is driven on ``meta``
tensors (neither CPU nor CUDA) with the launchers replaced by recorders.
The decode kernel's two passes are held, as their plain PyTorch twins
(``split_partials_plain``, ``merge_partials_plain``), against the plain
version and the JAX package's composed paged attention on the same numpy
inputs. The kernels themselves are held against the plain version by the
card tests in ``test_torch_gpu.py``.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels.pallas import paged_attention as jpaged
from paddle_tpu_torch.kernels import counters, reset_counters

PA = importlib.import_module("paddle_tpu_torch.kernels.paged_attention")


def _inputs(rng, S, W, nh, kvh, hd, PL, P, B, lengths):
    q = rng.standard_normal((S, W, nh, hd), dtype=np.float32)
    ka = rng.standard_normal((P, PL, kvh, hd), dtype=np.float32)
    va = rng.standard_normal((P, PL, kvh, hd), dtype=np.float32)
    tables = rng.integers(1, P, size=(S, B)).astype(np.int32)
    pos = (np.asarray(lengths, np.int32)[:, None]
           + np.arange(W, dtype=np.int32)[None])
    return q, ka, va, tables, pos


@pytest.mark.parametrize("dtype,hd,W,nh,kvh,PL,want", [
    (torch.bfloat16, 128, 1, 32, 32, 16, "decode"),     # serving decode
    (torch.float32, 128, 1, 32, 32, 16, "decode"),      # fp32 parity decode
    (torch.bfloat16, 8, 1, 4, 4, 5, "decode"),
    (torch.float32, 256, 1, 16, 2, 16, "decode"),       # GQA 8
    (torch.bfloat16, 12, 1, 4, 4, 16, "cuda_core"),     # hd not 8k
    (torch.bfloat16, 128, 1, 32, 2, 16, "cuda_core"),   # GQA 16
    (torch.float32, 264, 1, 4, 4, 16, "cuda_core"),     # hd > 256
    (torch.float16, 128, 1, 4, 4, 16, "cuda_core"),     # no kernel's dtype
    (torch.bfloat16, 128, 512, 32, 32, 16, "sm90"),     # serving prefill
    (torch.bfloat16, 64, 5, 32, 8, 32, "sm90"),
    (torch.bfloat16, 128, 130, 8, 2, 8, "sm90"),
    (torch.bfloat16, 128, 128, 4, 4, 64, "sm90"),
    (torch.float32, 128, 128, 32, 32, 16, "cuda_core"),  # fp32 window
    (torch.bfloat16, 96, 128, 4, 4, 16, "cuda_core"),   # other head dim
    (torch.bfloat16, 128, 128, 4, 4, 4, "cuda_core"),   # box below 8 rows
    (torch.bfloat16, 128, 2, 4, 4, 5, "cuda_core"),     # PL not dividing 64
    (torch.bfloat16, 128, 2, 4, 4, 128, "cuda_core")])  # page over a tile
def test_route_sends_each_call_to_one_kernel(dtype, hd, W, nh, kvh, PL, want,
                                             monkeypatch):
    """The routing table, in plain code and through the wrapper: on meta
    tensors with the three launchers replaced by recorders, exactly the
    launcher that ``route`` names runs, once."""
    assert PA.route(dtype, hd, W, nh // kvh, PL) == want
    took = []
    for name in ("decode", "sm90", "cuda_core"):
        monkeypatch.setattr(PA, f"paged_attention_{name}",
                            lambda *a, n=name: took.append(n))
    S, P, B = 2, 9, 4
    q = torch.empty(S, W, nh, hd, dtype=dtype, device="meta")
    ka = torch.empty(P, PL, kvh, hd, dtype=dtype, device="meta")
    tables = torch.empty(S, B, dtype=torch.int32, device="meta")
    pos = torch.empty(S, W, dtype=torch.int32, device="meta")
    PA.paged_attention(q, ka, ka, tables, pos)
    assert took == [want]


@pytest.mark.parametrize("dtype,hd,W,kvh,error,match", [
    (torch.float16, 128, 1, 4, TypeError, "float32 or bfloat16"),
    (torch.float16, 64, 128, 4, TypeError, "float32 or bfloat16"),
    (torch.float32, 264, 1, 4, ValueError, "head_dim <= 256"),
    (torch.bfloat16, 128, 1, 4, ValueError, "CUDA tensors")])
def test_no_route_falls_back(dtype, hd, W, kvh, error, match):
    """Off the CPU the wrapper launches the routed kernel or raises, before
    any build or launch: what no kernel takes raises, and the meta tensors
    here (no CPU, no card) reach no plain version."""
    q = torch.empty(2, W, 4, hd, dtype=dtype, device="meta")
    ka = torch.empty(5, 16, kvh, hd, dtype=dtype, device="meta")
    tables = torch.empty(2, 3, dtype=torch.int32, device="meta")
    pos = torch.empty(2, W, dtype=torch.int32, device="meta")
    reset_counters()
    with pytest.raises(error, match=match):
        PA.paged_attention(q, ka, ka, tables, pos)
    c = counters()
    assert all(c[n] == {"launches": 0, "plain_calls": 0} for n in (
        "paged_attention", "paged_attention_decode", "paged_attention_sm90"))


@pytest.mark.parametrize("launcher,W,dtype,hd,PL", [
    ("paged_attention_decode", 2, torch.bfloat16, 128, 16),
    ("paged_attention_decode", 1, torch.bfloat16, 12, 16),
    ("paged_attention_sm90", 1, torch.bfloat16, 128, 16),
    ("paged_attention_sm90", 8, torch.float32, 128, 16),
    ("paged_attention_sm90", 8, torch.bfloat16, 128, 4)])
def test_new_kernels_reject_what_they_do_not_take(launcher, W, dtype, hd, PL):
    q = torch.zeros(1, W, 2, hd, dtype=dtype)
    ka = torch.zeros(3, PL, 2, hd, dtype=dtype)
    tables = torch.zeros(1, 2, dtype=torch.int32)
    pos = torch.zeros(1, W, dtype=torch.int32)
    with pytest.raises(ValueError, match="takes"):
        getattr(PA, launcher)(q, ka, ka, tables, pos, 0.1)


def test_split_bounds_cover_each_slots_visible_pages():
    """Splits own consecutive runs of whole pages that together cover keys
    0..min(pos, B*PL - 1), one split per 256 visible keys up to n_split;
    splits past the last visible page own none, and a slot with pos < 0
    gives every split none."""
    PL, B, n = 4, 300, 5
    pos = torch.tensor([[-1], [0], [5], [255], [256], [1100], [1199],
                        [5000]], dtype=torch.int32)
    first, end = PA.split_bounds(pos, PL, B, n)
    for s, p in enumerate(pos[:, 0].tolist()):
        seen = min(p + 1, B * PL) if p >= 0 else 0
        keys = [j for i in range(n) for j in range(first[s, i], end[s, i])]
        assert keys == list(range(seen))
        assert all(int(f) % PL == 0 for f in first[s])
    assert (first < end).sum(dim=1).tolist() == [0, 1, 1, 1, 2, 5, 5, 5]


@pytest.mark.parametrize("n_split", [1, 3, 7])
@pytest.mark.parametrize("nh,kvh,hd,PL", [(4, 4, 16, 4), (8, 2, 8, 5),
                                          (6, 3, 24, 16)])
def test_decode_split_and_merge_match_plain_and_jax(nh, kvh, hd, PL,
                                                    n_split):
    """The decode kernel's two passes in PyTorch: per-split partials (m, l
    in log2 units), then the fixed-order merge. Slots of 1, 301 and 701
    keys and one whose pos runs past the table take 1 to 4 splits (one per
    256 keys), so some splits lie past the last visible page; a slot that
    sees no key (pos -1) gives 0. They equal the plain version and the JAX
    composed paged attention within 1e-5 (fp32)."""
    rng = np.random.default_rng(31)
    S, B = 5, -(-900 // PL)
    q, ka, va, tables, pos = _inputs(rng, S, 1, nh, kvh, hd, PL, 2 * B + 1,
                                     B, [-1, 0, 300, 700, B * PL + 7])
    t = [torch.from_numpy(a) for a in (q, ka, va, tables, pos)]
    scale = hd ** -0.5
    o, m, l = PA.split_partials_plain(*t, scale, n_split)
    assert o.shape == (S, nh, n_split, hd) and m.shape == l.shape == \
        (S, nh, n_split)
    first, end = PA.split_bounds(t[4], PL, B, n_split)
    used = (first < end).sum(dim=1).tolist()
    assert used == [0, 1] + [min(n_split, u) for u in (2, 3, 4)]
    empty = (first >= end)[:, None, :].expand_as(m)
    assert (m[empty] == -1e30).all() and (l[empty] == 0).all()
    got = PA.merge_partials_plain(o, m, l, torch.float32)
    np.testing.assert_allclose(got.numpy(), PA.paged_attention_plain(
        *t, scale).numpy(), rtol=1e-5, atol=1e-5)
    ref = jpaged.paged_attention(*map(jnp.asarray, (q, ka, va, tables, pos)),
                                 scale=scale, impl="composed")
    # the JAX composed math softmaxes an all-masked row to uniform; the
    # kernels (and the TPU kernel) give it 0
    np.testing.assert_allclose(got.numpy()[1:], np.asarray(ref)[1:],
                               rtol=1e-5, atol=1e-5)
    assert not got[0].any()


def _window_emulated(q, ka, va, tables, pos, scale, drop_page=None):
    """The window kernel's arithmetic in PyTorch on bf16-valued fp32
    tensors: 64-key tiles, an online softmax with fp32 p (the row sum adds
    it), P rounded to bf16 before P.V, o rounded to bf16. ``drop_page``
    plants a fault: that page of every slot's table is left out, as if its
    TMA box were skipped."""
    def bf16(t):
        return t.to(torch.bfloat16).float()

    kk, vv = PA._gathered(ka, va, tables, q.shape[2])
    L = kk.shape[1]
    PL = ka.shape[1]
    vis = PA._visible(pos, L)
    if drop_page is not None:
        vis = vis.clone()
        vis[..., drop_page * PL:(drop_page + 1) * PL] = False
    s = torch.einsum("swhd,sLhd->swhL", q, kk) * scale
    s = torch.where(vis, s, -1e30)
    m = torch.full(s.shape[:-1], -1e30)
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(q.shape)
    for k0 in range(0, L, 64):
        st, vt = s[..., k0:k0 + 64], vis[..., k0:k0 + 64]
        m_new = torch.maximum(m, st.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(vt, torch.exp(st - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "swhL,sLhd->swhd", bf16(p), vv[:, k0:k0 + 64])
        m = m_new
    return bf16(acc / l.clamp_min(1e-30)[..., None])


def test_sm90_paged_bound_holds_for_the_window_kernels_rounding():
    """``sm90_paged_bound``, which the card tests and chip_smoke.py hold the
    window kernel to: an emulation of its bf16 roundings stays within it
    against the fp32 plain version (two row tiles, GQA, a cached prefix, an
    idle slot on the scratch page), filling a fair part of it; the same
    emulation without one page exceeds it."""
    rng = np.random.default_rng(41)
    S, W, nh, kvh, hd, PL, P, B = 3, 130, 4, 2, 64, 16, 40, 12
    q, ka, va, tables, pos = _inputs(rng, S, W, nh, kvh, hd, PL, P, B,
                                     [37, 0, 0])
    tables[2] = 0
    q, ka, va = (torch.from_numpy(a).to(torch.bfloat16).float()
                 for a in (q, ka, va))
    tables, pos = torch.from_numpy(tables), torch.from_numpy(pos)
    scale = hd ** -0.5
    ref = PA.paged_attention_plain(q, ka, va, tables, pos, scale)
    bound = PA.sm90_paged_bound(q, ka, va, tables, pos, scale, ref)

    def excess(got):
        return ((got - ref).abs() - bound).max().item()

    sound = _window_emulated(q, ka, va, tables, pos, scale)
    assert excess(sound) <= 0
    assert (sound - ref).abs().max().item() > \
        0.05 * (bound - 1e-4).max().item()
    assert excess(_window_emulated(q, ka, va, tables, pos, scale,
                                   drop_page=1)) > 0
