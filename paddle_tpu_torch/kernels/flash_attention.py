"""Flash-attention forward with per-row log-sum-exp.

Port of the forward half of ``paddle_tpu/kernels/flash_attention.py``:
``flash_attention_with_lse`` over ``[bh, s, d]`` and ``flash_attention``
over the paddle layout ``[b, s, h, d]``. ``offset`` shifts q's global
positions for the causal mask and ``lse`` is returned, as ring attention
needs both. On a CUDA tensor the hand-written kernel
(``csrc/flash_attention.cu``) runs or the call raises; on a CPU tensor
:func:`flash_attention_plain` runs. The backward kernels wait for the
training slice.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_with_lse",
           "flash_attention_plain", "COUNTS"]

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
COUNTS = _build.Counts()


def flash_attention_plain(q, k, v, offset, causal, scale):
    """Dense attention (the JAX ``_sdpa_xla`` math) plus the lse. A row
    that sees no key gives o = 0 and lse = -1e30, as the TPU kernel
    does."""
    sq, sk = q.shape[1], k.shape[1]
    logits = torch.einsum("bqd,bkd->bqk", q, k).float() * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + int(offset)
        mask = torch.arange(sk, device=q.device)[None, :] <= qpos
    else:
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    logits = torch.where(mask, logits, _NEG)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bqk,bkd->bqd", (p / l).to(q.dtype), v)
    return o, (m + torch.log(l))[..., 0]


def _launch(q, k, v, offset, causal, scale):
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if d > 256:
        raise ValueError(f"flash_attention kernel takes head_dim <= 256, "
                         f"got {d}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty(bh, sq, dtype=torch.float32, device=q.device)
    fn = _build.kernel("pt_flash_attention_fwd", [ctypes.c_void_p] * 5 +
                       [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                             ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), bh, sq, sk, d, int(offset), int(bool(causal)),
                 float(scale), _DTYPES[q.dtype], stream)
    _build.check(err, "pt_flash_attention_fwd")
    COUNTS.launched()
    return o, lse


def flash_attention_with_lse(q, k, v, offset=0, causal=False, scale=None):
    """q/k/v: [bh, s, d]. Returns (out [bh, sq, d] in q.dtype, lse [bh, sq]
    fp32). ``offset`` shifts q's global positions for the causal mask."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape or \
            q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}"
                         f", v {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share a dtype")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return _launch(q, k, v, offset, causal, scale)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    COUNTS.plain()
    return flash_attention_plain(q, k, v, offset, causal, scale)


def flash_attention(q, k, v, causal: bool = False, scale: float = None):
    """q/k/v: [batch, seq, heads, head_dim] (paddle layout)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)

    def bhsd(t, s):
        return t.transpose(1, 2).reshape(b * h, s, d)

    # self-attention with sk >= sq: rows see the key prefix plus the diagonal
    offset = sk - sq if causal else 0
    o, _ = flash_attention_with_lse(bhsd(q, sq), bhsd(k, sk), bhsd(v, sk),
                                    offset, causal, scale)
    return o.reshape(b, h, sq, d).transpose(1, 2)
