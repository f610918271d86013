"""Paged attention: window queries against the page-pool arenas.

Port of ``paddle_tpu/kernels/pallas/paged_attention.py``. Layouts are the
JAX package's:

- ``q``:      [S, W, nh, hd] — W window tokens per slot
- arenas:     [P, PL, kvh, hd] — the page pool (kvh <= nh, GQA)
- ``tables``: [S, B] int32 page ids (0 = scratch page)
- ``pos``:    [S, W] int32 global positions; key j is visible to window
              token (s, w) iff j <= pos[s, w]

On a CUDA tensor :func:`paged_attention` launches the hand-written kernel
(``csrc/paged_attention.cu``) or raises; on a CPU tensor it runs
:func:`paged_attention_plain`, the gather-then-attend math of the JAX
package's ``_paged_composed``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["paged_attention", "paged_attention_plain", "COUNTS"]

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
COUNTS = _build.Counts()


def paged_attention_plain(q, k_arena, v_arena, tables, pos, scale):
    """Gather every slot's pages into a dense context, then attend. A row
    that sees no key gives 0, as the TPU kernel does (rows with
    ``pos >= 0`` always see key 0, where this equals a plain softmax)."""
    S, W, nh, hd = q.shape
    _P, PL, kvh, _ = k_arena.shape
    B = tables.shape[1]
    L = B * PL
    idx = tables.long()
    kk = k_arena[idx].reshape(S, L, kvh, hd)
    vv = v_arena[idx].reshape(S, L, kvh, hd)
    if kvh != nh:
        kk = kk.repeat_interleave(nh // kvh, dim=2)
        vv = vv.repeat_interleave(nh // kvh, dim=2)
    j = torch.arange(L, device=q.device)
    mask = (j[None, None, :] <= pos.long()[:, :, None])[:, :, None, :]
    logits = torch.einsum("swhd,sLhd->swhL", q, kk).float() * scale
    logits = torch.where(mask, logits, _NEG)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    probs = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("swhL,sLhd->swhd", probs.to(q.dtype), vv)


def _launch(q, k_arena, v_arena, tables, pos, scale):
    for name, t in (("k_arena", k_arena), ("v_arena", v_arena),
                    ("tables", tables), ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    S, W, nh, hd = q.shape
    _P, PL, kvh, _ = k_arena.shape
    B = tables.shape[1]
    if hd > 256:
        raise ValueError(f"paged_attention kernel takes head_dim <= 256, "
                         f"got {hd}")
    q = q.contiguous()
    k_arena, v_arena = k_arena.contiguous(), v_arena.contiguous()
    tables = tables.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    fn = _build.kernel("pt_paged_attention", [ctypes.c_void_p] * 6 +
                       [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                             ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
                 tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
                 S, W, nh, kvh, hd, PL, B, float(scale), _DTYPES[q.dtype],
                 stream)
    _build.check(err, "pt_paged_attention")
    COUNTS.launched()
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
    if q.device.type == "cuda":
        return _launch(q, k_arena, v_arena, tables, pos, scale)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    COUNTS.plain()
    return paged_attention_plain(q, k_arena, v_arena, tables, pos, scale)
