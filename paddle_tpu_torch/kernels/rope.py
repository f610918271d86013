"""Rotate-half rotary position embedding (RoPE) and its inverse.

Port of ``paddle_tpu/kernels/pallas/rope.py``: ``rope_apply(x, theta,
pos_offset)`` on ``x`` [b, s, h, d], d even, is a ``torch.autograd.Function``
whose backward is the same kernel with the sine negated (the inverse
rotation, applied to the cotangent); it saves nothing. On a CUDA tensor
:func:`rope` launches the hand-written kernel (``csrc/rope.cu``) or raises;
on a CPU tensor it runs :func:`rope_plain`. The kernel reads ``x`` through
its strides (the cotangent reaches the backward as a ``[b, s, h, d]`` view
of the attention's ``[b, h, s, d]`` gradient) and writes a contiguous
result; :func:`rope_plan` picks its instance.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["rope_apply", "rope", "rope_plain", "rope_plan", "COUNTS",
           "COUNTS_INVERSE"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
COUNTS = _build.Counts()          # forward rotation
COUNTS_INVERSE = _build.Counts()  # inverse rotation (the VJP)
# the kernel keeps a block's cos/sin table for at least one position in 48 KB
# of shared memory: 2 x d/2 fp32 values
MAX_HEAD_DIM = 12288


def _inv_freq(d, theta, device):
    """inv_i = exp(i * (-2/d) * ln(theta)) in fp32, as the JAX kernel's
    ``_angles`` computes it (the kernel computes the same per element)."""
    i = torch.arange(d // 2, dtype=torch.float32, device=device)
    return torch.exp(i * (-2.0 / d) * math.log(theta))


def rope_plain(x, theta, pos_offset, inverse):
    """The JAX package's ``_rope_composed``: cos/sin tables over the
    positions, split, rotate, concatenate, in fp32. The angles are those
    of the TPU kernel (``_angles``), so the kernel and this version see the
    same fp32 frequencies."""
    _b, s, _h, d = x.shape
    pos = torch.arange(s, dtype=torch.float32, device=x.device) + \
        float(pos_offset)
    freqs = torch.outer(pos, _inv_freq(d, theta, x.device))
    cos = torch.cos(freqs)[None, :, None, :]
    sin = torch.sin(freqs)[None, :, None, :]
    if inverse:
        sin = -sin
    xf = x.float()
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def rope_plan(shape, strides, itemsize, data_ptr):
    """Which kernel instance takes ``x`` [b, s, h, d] with these strides (in
    elements), element size and address: ``"vector"`` (16-byte vectors: d/2
    elements whole vectors, the start and every stride of a dim longer than
    1 on a 16-byte boundary), ``"scalar"`` (the rest with d contiguous), or
    ``"copy"`` (d not contiguous: the wrapper copies x first)."""
    if shape[3] > 1 and strides[3] != 1:
        return "copy"
    if (shape[3] // 2 * itemsize) % 16 or data_ptr % 16 or any(
            n > 1 and (st * itemsize) % 16
            for n, st in zip(shape[:3], strides[:3])):
        return "scalar"
    return "vector"


def rope(x, theta, pos_offset, inverse):
    """One rotation of ``x`` [b, s, h, d]: the kernel on CUDA, reading x
    through its strides and writing a contiguous result; the plain version
    on the CPU."""
    counts = COUNTS_INVERSE if inverse else COUNTS
    if x.device.type == "cpu":
        counts.plain()
        return rope_plain(x, theta, pos_offset, inverse)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"rope kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    _check_shape(x)
    b, s, h, d = x.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"rope kernel takes head dims up to {MAX_HEAD_DIM}, "
                         f"got {d}")
    plan = rope_plan(x.shape, x.stride(), x.element_size(), x.data_ptr())
    if plan == "copy":
        x = x.contiguous()
        plan = rope_plan(x.shape, x.stride(), x.element_size(), x.data_ptr())
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    fn = _build.kernel("pt_rope", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
    sb, ss, sh, _ = x.stride()
    _build.launch(fn, "pt_rope", x.device, x.data_ptr(), out.data_ptr(), b, s,
                  h, d, float(math.log(theta)), int(pos_offset),
                  int(bool(inverse)), _DTYPES[x.dtype], sb, ss, sh,
                  int(plan == "vector"), _build.sm_count(x.device))
    counts.launched()
    return out


class _Rope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, theta, pos_offset):
        ctx.theta, ctx.pos_offset = theta, pos_offset
        return rope(x, theta, pos_offset, False)

    @staticmethod
    def backward(ctx, dy):
        return rope(dy, ctx.theta, ctx.pos_offset, True), None, None


def _check_shape(x):
    if x.dim() != 4 or x.shape[-1] % 2:
        raise ValueError(f"RoPE takes [b, s, h, d] with d even, got "
                         f"{tuple(x.shape)}")


def rope_apply(x, theta: float = 10000.0, pos_offset: int = 0):
    """Rotate-half RoPE on ``x`` [b, s, h, d] (d even) at global positions
    ``pos_offset + [0, s)``."""
    _check_shape(x)
    return _Rope.apply(x, float(theta), int(pos_offset))
