"""Dtypes (port of ``paddle_tpu/framework/dtype.py``).

A dtype here is a ``torch.dtype``. Paddle's names (``"float32"``,
``"int64"``, ``"bfloat16"``, ...) map onto torch's dtypes one for one. The
JAX package narrows ``int64``/``float64``/``complex128`` to 32 bits when
jax runs without x64 (a TPU choice, ``paddle_tpu/framework/dtype.py:61-69``);
the port keeps paddle's widths, so an op that gives ``int64`` here gives
``int32`` there, and the parity tests compare dtypes through that
narrowing.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128",
           "convert_dtype", "dtype_name", "get_default_dtype",
           "set_default_dtype", "is_floating", "is_integer", "iinfo",
           "finfo"]



def promoted(*tensors):
    """The tensors (``None`` passes through) cast to their common dtype,
    as ``jnp.matmul`` and ``jnp``'s arithmetic promote mixed operands: an
    fp32 input against a bf16 weight gives fp32, and a gradient flows back
    to the bf16 operand in bf16. Operands of one dtype come back as they
    are, with no cast launched."""
    real = [t for t in tensors if t is not None]
    dt = real[0].dtype
    for t in real[1:]:
        dt = torch.promote_types(dt, t.dtype)
    if all(t.dtype == dt for t in real):
        return tensors
    return tuple(None if t is None else t.to(dt) for t in tensors)


bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_NAME_TO_DTYPE = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16,
    "bfloat16": bfloat16, "float32": float32, "float64": float64,
    "complex64": complex64, "complex128": complex128,
}
_DTYPE_TO_NAME = {v: k for k, v in _NAME_TO_DTYPE.items()}

_DEFAULT_DTYPE = [float32]


def convert_dtype(dtype):
    """A paddle dtype name, a ``torch.dtype`` or a numpy dtype -> the
    ``torch.dtype``; ``None`` stays ``None``."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = dtype.replace("paddle.", "").replace("paddle_tpu.", "")
        if name not in _NAME_TO_DTYPE:
            raise ValueError(f"Unknown dtype name: {dtype!r}")
        return _NAME_TO_DTYPE[name]
    name = np.dtype(dtype).name
    if name not in _NAME_TO_DTYPE:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return _NAME_TO_DTYPE[name]


def dtype_name(dtype) -> str:
    """Paddle's name of a dtype: ``torch.float32`` -> ``"float32"``."""
    return _DTYPE_TO_NAME[convert_dtype(dtype)]


def set_default_dtype(dtype):
    d = convert_dtype(dtype)
    if d not in (float16, bfloat16, float32, float64):
        raise TypeError(
            f"set_default_dtype only supports floating dtypes, got {d}")
    _DEFAULT_DTYPE[0] = d


def get_default_dtype():
    return _DEFAULT_DTYPE[0]


def is_floating(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return d == bool_ or (not d.is_floating_point and not d.is_complex)


class iinfo:
    """paddle.iinfo: the limits of an integer dtype."""

    def __init__(self, dtype):
        info = torch.iinfo(convert_dtype(dtype))
        self.min = int(info.min)
        self.max = int(info.max)
        self.bits = int(info.bits)
        self.dtype = dtype_name(info.dtype)

    def __repr__(self):
        return f"iinfo(min={self.min}, max={self.max}, dtype={self.dtype})"


class finfo:
    """paddle.finfo: the limits of a floating dtype."""

    def __init__(self, dtype):
        info = torch.finfo(convert_dtype(dtype))
        self.min = float(info.min)
        self.max = float(info.max)
        self.eps = float(info.eps)
        self.tiny = float(info.tiny)
        self.smallest_normal = float(info.tiny)
        self.resolution = float(info.resolution)
        self.bits = int(info.bits)
        self.dtype = dtype_name(info.dtype)

    def __repr__(self):
        return f"finfo(min={self.min}, max={self.max}, dtype={self.dtype})"
