"""Paged attention: window queries against the page-pool arenas.

Port of ``paddle_tpu/kernels/pallas/paged_attention.py``. Layouts are the
JAX package's:

- ``q``:      [S, W, nh, hd] — W window tokens per slot
- arenas:     [P, PL, kvh, hd] — the page pool (kvh <= nh, GQA)
- ``tables``: [S, B] int32 page ids (0 = scratch page)
- ``pos``:    [S, W] int32 global positions; key j is visible to window
              token (s, w) iff j <= pos[s, w]

On a CPU tensor :func:`paged_attention` runs :func:`paged_attention_plain`,
the gather-then-attend math of the JAX package's ``_paged_composed``. On a
CUDA tensor it launches exactly one of three hand-written kernels, which
:func:`route` picks in plain code, or raises:

- ``"decode"`` (W = 1): ``csrc/paged_attention_decode.cu``, split-K on the
  CUDA cores. The grid is (slot, kv head, split); each split owns a run of
  the slot's visible pages and writes a partial (o, m, l) in fp32, which a
  second kernel merges in a fixed order. :func:`split_partials_plain` and
  :func:`merge_partials_plain` (shared with the flash decode kernel, whose
  merge is the same code) are the same two passes in PyTorch;
- ``"sm90"`` (W > 1, bf16, head dim 64 or 128, page length 8-64 dividing
  64): ``csrc/paged_attention_sm90.cu``, both products on the tensor cores
  (wgmma), K/V loaded by TMA page by page through the page table. It
  rounds P to bf16 before P.V, so it is held to :func:`sm90_paged_bound`;
- ``"cuda_core"`` (everything else): ``csrc/paged_attention.cu``.

Each kernel counts its own launches (``COUNTS_DECODE``, ``COUNTS_SM90``,
``COUNTS``); CPU calls count as plain calls of ``COUNTS``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .flash_attention import _on_cuda, _tma_ready, merge_partials_plain

__all__ = ["paged_attention", "paged_attention_plain", "route",
           "paged_attention_decode", "paged_attention_sm90",
           "paged_attention_cuda_core", "decode_splits", "split_bounds",
           "split_partials_plain", "merge_partials_plain",
           "sm90_paged_bound", "COUNTS", "COUNTS_DECODE", "COUNTS_SM90"]

_NEG = -1e30
_LOG2E = 1.4426950408889634
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SM90_HEAD_DIMS = (64, 128)
# a page of PL rows is one TMA box; it must fill whole 1024-byte swizzle
# atoms (PL >= 8) and tile the 64-key tile (PL divides 64)
_SM90_PAGE_LENS = (8, 16, 32, 64)
_DECODE_MAX_REP = 8      # query heads one decode block holds per kv head
_DECODE_MAX_SPLITS = 16
# a decode slot gets one split per 256 visible keys; the kernel takes this
# as an argument, so split_bounds and the kernel share one policy
_SPLIT_KEYS = 256
COUNTS = _build.Counts()          # the general kernel (and CPU calls)
COUNTS_DECODE = _build.Counts()   # split-K decode (+ its merge)
COUNTS_SM90 = _build.Counts()     # tensor-core window kernel


def route(dtype, head_dim, W, rep, page_len) -> str:
    """Which kernel a CUDA call goes to: ``"decode"`` for W = 1 (fp32 or
    bf16, head dim a multiple of 8 up to 256, at most 8 query heads per
    kv head), ``"sm90"`` for W > 1 in bf16 at head dim 64 or 128 with a
    page length of 8, 16, 32 or 64, ``"cuda_core"`` for the rest (whose
    kernel raises on a dtype or head dim it does not take)."""
    if W == 1 and dtype in _DTYPES and head_dim % 8 == 0 and \
            head_dim <= 256 and rep <= _DECODE_MAX_REP:
        return "decode"
    if W > 1 and dtype == torch.bfloat16 and head_dim in _SM90_HEAD_DIMS \
            and page_len in _SM90_PAGE_LENS:
        return "sm90"
    return "cuda_core"


def _gathered(k_arena, v_arena, tables, nh):
    """Every slot's pages as a dense context [S, B * PL, nh, hd] (kv heads
    repeated for GQA)."""
    S, B = tables.shape
    _P, PL, kvh, hd = k_arena.shape
    idx = tables.long()
    kk = k_arena[idx].reshape(S, B * PL, kvh, hd)
    vv = v_arena[idx].reshape(S, B * PL, kvh, hd)
    if kvh != nh:
        kk = kk.repeat_interleave(nh // kvh, dim=2)
        vv = vv.repeat_interleave(nh // kvh, dim=2)
    return kk, vv


def _visible(pos, n_keys):
    """[S, W, 1, L] mask: key j visible to (s, w) iff j <= pos[s, w]."""
    j = torch.arange(n_keys, device=pos.device)
    return (j[None, None, :] <= pos.long()[:, :, None])[:, :, None, :]


def _probs(q, kk, pos, scale):
    """Normalised fp32 probabilities [S, W, nh, L]; exactly 0 on masked
    keys and on rows that see no key."""
    mask = _visible(pos, kk.shape[1])
    logits = torch.einsum("swhd,sLhd->swhL", q, kk).float() * scale
    logits = torch.where(mask, logits, _NEG)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def paged_attention_plain(q, k_arena, v_arena, tables, pos, scale):
    """Gather every slot's pages into a dense context, then attend. A row
    that sees no key gives 0, as the TPU kernel does (rows with
    ``pos >= 0`` always see key 0, where this equals a plain softmax)."""
    kk, vv = _gathered(k_arena, v_arena, tables, q.shape[2])
    probs = _probs(q, kk, pos, scale)
    return torch.einsum("swhL,sLhd->swhd", probs.to(q.dtype), vv)


def sm90_paged_bound(q, k_arena, v_arena, tables, pos, scale, o_ref):
    """Elementwise bound of |o - o_ref| for the tensor-core window kernel
    against the fp32 plain version ``o_ref`` on the same (fp32) inputs:
    ``2**-8 |o_ref| + 2**-8 (P |V|) + 1e-4`` over the gathered context.
    The kernel rounds its result to bf16 once (half an ulp, 2**-9 of the
    value) and each probability to bf16 before P.V (2**-9 of each term of
    P |V|); each term gets twice its worst case, plus fp32 summation
    order."""
    kk, vv = _gathered(k_arena, v_arena, tables, q.shape[2])
    p = _probs(q.float(), kk.float(), pos, scale)
    return (2.0 ** -8 * o_ref.abs()
            + 2.0 ** -8 * torch.einsum("swhL,sLhd->swhd", p, vv.float().abs())
            + 1e-4)


# -- the decode kernel's split plan and its two passes in plain PyTorch -------

def decode_splits(groups, n_blocks, sms):
    """Splits per (slot, kv head) for the decode kernel: enough blocks for
    about 8 per SM over ``groups`` = S * kvh, at most one per page of the
    table (``n_blocks``) and at most 16."""
    want = -(-8 * sms // max(groups, 1))
    return max(1, min(want, n_blocks, _DECODE_MAX_SPLITS))


def split_bounds(pos, page_len, n_blocks, n_split):
    """[S, n_split] (first key, end key) of each split, as the decode kernel
    computes them: slot s sees ``n = min(pos[s] + 1, B * PL)`` keys (0 when
    pos < 0), i.e. ``ceil(n / PL)`` pages, cut into ``used = min(n_split,
    ceil(n / 256))`` (at least 1) runs: split i owns pages ``[i * per,
    (i + 1) * per)`` with ``per = ceil(pages / used)``, cut at key n. A
    split that starts past the slot's last visible page owns no key
    (first >= end)."""
    lim = pos.long().reshape(pos.shape[0], -1)[:, 0]
    n = torch.clamp(lim + 1, min=0, max=n_blocks * page_len)
    pages = torch.div(n + page_len - 1, page_len, rounding_mode="floor")
    used = torch.clamp(torch.div(n + _SPLIT_KEYS - 1, _SPLIT_KEYS,
                                 rounding_mode="floor"), 1, n_split)
    per = torch.div(pages + used - 1, used, rounding_mode="floor")
    i = torch.arange(n_split, device=pos.device)
    first = i[None, :] * per[:, None] * page_len
    end = torch.minimum(first + per[:, None] * page_len, n[:, None])
    return first, end


def split_partials_plain(q, k_arena, v_arena, tables, pos, scale, n_split):
    """The decode kernel's first pass in PyTorch (W = 1): for every (slot,
    head, split) the partial ``o`` [S, nh, n_split, hd] (the sum of
    exp2(s - m) * v over the split's keys, not normalised), ``m``
    [S, nh, n_split] (the largest score, in log2 units: s = q.k * scale *
    log2(e)) and ``l`` (the sum of exp2(s - m)). A split with no key gives
    m = -1e30, l = 0 and o = 0."""
    S, _W, nh, hd = q.shape
    PL = k_arena.shape[1]
    kk, vv = _gathered(k_arena, v_arena, tables, nh)
    first, end = split_bounds(pos, PL, tables.shape[1], n_split)
    j = torch.arange(kk.shape[1], device=q.device)
    own = (j[None, None, :] >= first[:, :, None]) & \
        (j[None, None, :] < end[:, :, None])                # [S, n, L]
    s = torch.einsum("shd,sLhd->shL", q[:, 0].float(), kk.float()) * \
        (scale * _LOG2E)
    s = torch.where(own[:, None], s[:, :, None, :], _NEG)   # [S, nh, n, L]
    m = s.amax(dim=-1)
    p = torch.where(own[:, None], torch.exp2(s - m[..., None]), 0.0)
    o = torch.einsum("shnL,sLhd->shnd", p, vv.float())
    return o, m, p.sum(dim=-1)


# -- launchers ----------------------------------------------------------------

def _q_in_place(q):
    """q as the new kernels read it: heads packed ([..., nh, hd] contiguous)
    and the slot and window-row strides multiples of 16 bytes from a 16-byte
    aligned start. The serving step's q, a view into its fused QKV
    projection, is such a tensor and is read where it lies; anything else is
    copied."""
    nh, hd = q.shape[2], q.shape[3]
    step = 16 // q.element_size()
    if q.stride(3) == 1 and (q.stride(2) == hd or nh == 1) and \
            q.stride(1) % step == 0 and q.stride(0) % step == 0 and \
            q.data_ptr() % 16 == 0:
        return q
    return _tma_ready(q)


def _kernel_inputs(name, q, k_arena, v_arena, tables, pos):
    dev = q.device
    for what, t in (("k_arena", k_arena), ("v_arena", v_arena),
                    ("tables", tables), ("pos", pos)):
        if t.device != dev:
            raise ValueError(f"{name}: {what} on {t.device}, q on {dev}")
    if tables.dtype != torch.int32:
        tables = tables.to(torch.int32)
    if pos.dtype != torch.int32:
        pos = pos.to(torch.int32)
    return (_tma_ready(k_arena), _tma_ready(v_arena), tables.contiguous(),
            pos.contiguous())


def paged_attention_cuda_core(q, k_arena, v_arena, tables, pos, scale):
    """The general kernel (``csrc/paged_attention.cu``): fp32 or bf16,
    head dim up to 256, any W, page length and GQA ratio."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    S, W, nh, hd = q.shape
    if hd > 256:
        raise ValueError(f"paged_attention kernel takes head_dim <= 256, "
                         f"got {hd}")
    _on_cuda("paged_attention", q)
    k_arena, v_arena, tables, pos = _kernel_inputs(
        "paged_attention", q, k_arena, v_arena, tables, pos)
    q = _tma_ready(q)
    _P, PL, kvh, _ = k_arena.shape
    out = torch.empty_like(q)
    fn = _build.kernel("pt_paged_attention", [ctypes.c_void_p] * 6 +
                       [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                             ctypes.c_void_p])
    _build.launch(fn, "pt_paged_attention", q.device, q.data_ptr(),
                  k_arena.data_ptr(), v_arena.data_ptr(), tables.data_ptr(),
                  pos.data_ptr(), out.data_ptr(), S, W, nh, kvh, hd, PL,
                  tables.shape[1], float(scale), _DTYPES[q.dtype])
    COUNTS.launched()
    return out


def paged_attention_decode(q, k_arena, v_arena, tables, pos, scale):
    """The split-K decode kernel and its merge
    (``csrc/paged_attention_decode.cu``): W = 1, fp32 or bf16, head dim a
    multiple of 8 up to 256, at most 8 query heads per kv head. The fp32
    partials live in one scratch tensor allocated here."""
    S, W, nh, hd = q.shape
    kvh = k_arena.shape[2]
    if route(q.dtype, hd, W, nh // kvh, k_arena.shape[1]) != "decode":
        raise ValueError(f"paged_attention_decode takes W = 1, float32 or "
                         f"bfloat16, head_dim a multiple of 8 up to 256 and "
                         f"at most {_DECODE_MAX_REP} query heads per kv "
                         f"head; got W {W}, {q.dtype}, head_dim {hd}, "
                         f"{nh} / {kvh} heads")
    _on_cuda("paged_attention_decode", q)
    k_arena, v_arena, tables, pos = _kernel_inputs(
        "paged_attention_decode", q, k_arena, v_arena, tables, pos)
    q = _q_in_place(q)
    PL, B = k_arena.shape[1], tables.shape[1]
    n_split = decode_splits(S * kvh, B, _build.sm_count(q.device))
    out = torch.empty(S, W, nh, hd, dtype=q.dtype, device=q.device)
    # [S, nh, n_split, hd] partial o, then [S, nh, n_split, 2] (m, l)
    n_o = S * nh * n_split * hd
    part = torch.empty(n_o + S * nh * n_split * 2, dtype=torch.float32,
                       device=q.device)
    fn = _build.kernel("pt_paged_attention_decode", [ctypes.c_void_p] * 8 +
                       [ctypes.c_longlong] + [ctypes.c_int] * 8 +
                       [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    _build.launch(fn, "pt_paged_attention_decode", q.device, q.data_ptr(),
                  k_arena.data_ptr(), v_arena.data_ptr(), tables.data_ptr(),
                  pos.data_ptr(), out.data_ptr(), part.data_ptr(),
                  part.data_ptr() + 4 * n_o, q.stride(0), S, nh, kvh, hd, PL,
                  B, n_split, _SPLIT_KEYS, float(scale), _DTYPES[q.dtype])
    COUNTS_DECODE.launched()
    return out


def paged_attention_sm90(q, k_arena, v_arena, tables, pos, scale):
    """The tensor-core window kernel (``csrc/paged_attention_sm90.cu``):
    W > 1, bf16, head dim 64 or 128, page length 8, 16, 32 or 64."""
    S, W, nh, hd = q.shape
    P, PL, kvh, _ = k_arena.shape
    if route(q.dtype, hd, W, nh // kvh, PL) != "sm90":
        raise ValueError(f"paged_attention_sm90 takes W > 1, bfloat16, "
                         f"head_dim in {_SM90_HEAD_DIMS} and page_len in "
                         f"{_SM90_PAGE_LENS}; got W {W}, {q.dtype}, "
                         f"head_dim {hd}, page_len {PL}")
    _on_cuda("paged_attention_sm90", q)
    k_arena, v_arena, tables, pos = _kernel_inputs(
        "paged_attention_sm90", q, k_arena, v_arena, tables, pos)
    q = _q_in_place(q)
    out = torch.empty(S, W, nh, hd, dtype=q.dtype, device=q.device)
    fn = _build.kernel("pt_paged_attention_sm90", [ctypes.c_void_p] * 6 +
                       [ctypes.c_longlong] * 2 + [ctypes.c_int] * 8 +
                       [ctypes.c_float, ctypes.c_void_p])
    _build.launch(fn, "pt_paged_attention_sm90", q.device, q.data_ptr(),
                  k_arena.data_ptr(), v_arena.data_ptr(), tables.data_ptr(),
                  pos.data_ptr(), out.data_ptr(), q.stride(1), q.stride(0), S,
                  W, nh, kvh, hd, P, PL, tables.shape[1], float(scale))
    COUNTS_SM90.launched()
    return out


def paged_attention(q, k_arena, v_arena, tables, pos, scale=None):
    """Window attention straight against the page table. ``q`` [S, W, nh,
    hd]; arenas [P, PL, kvh, hd]; ``tables`` [S, B]; ``pos`` [S, W] (key j
    visible iff j <= pos). Returns [S, W, nh, hd] in q.dtype."""
    if q.dim() != 4 or k_arena.dim() != 4 or v_arena.shape != k_arena.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, arenas "
                         f"{tuple(k_arena.shape)} / {tuple(v_arena.shape)}")
    S, W, nh, hd = q.shape
    kvh = k_arena.shape[2]
    if k_arena.shape[3] != hd or nh % kvh:
        raise ValueError(f"q heads/dim ({nh}, {hd}) do not fit arenas "
                         f"(kv heads {kvh}, dim {k_arena.shape[3]})")
    if tables.dim() != 2 or tables.shape[0] != S or \
            tuple(pos.shape) != (S, W):
        raise ValueError(f"tables {tuple(tables.shape)} / pos "
                         f"{tuple(pos.shape)} do not fit q {tuple(q.shape)}")
    if k_arena.dtype != q.dtype or v_arena.dtype != q.dtype:
        raise TypeError("q and the arenas must share a dtype")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    if q.device.type == "cpu":
        COUNTS.plain()
        return paged_attention_plain(q, k_arena, v_arena, tables, pos, scale)
    which = route(q.dtype, hd, W, nh // kvh, k_arena.shape[1])
    if which == "decode":
        return paged_attention_decode(q, k_arena, v_arena, tables, pos, scale)
    if which == "sm90":
        return paged_attention_sm90(q, k_arena, v_arena, tables, pos, scale)
    return paged_attention_cuda_core(q, k_arena, v_arena, tables, pos, scale)
