"""Elementwise math (port of ``paddle_tpu/ops/math.py``).

Free functions with paddle's signatures over ``torch.Tensor``. A Python
number beside a tensor takes paddle's promotion rule (the JAX package's
``_scalar_operand``): an int adopts an integer or floating tensor's dtype,
a float a floating tensor's and the default float dtype beside an integer
tensor.
"""
from __future__ import annotations

import builtins

import torch

from ..framework import dtype as dtype_mod

_BINARY = {
    "add": torch.add, "subtract": torch.subtract, "multiply": torch.multiply,
    "divide": torch.true_divide, "floor_divide": torch.floor_divide,
    "remainder": torch.remainder, "maximum": torch.maximum,
    "minimum": torch.minimum, "fmax": torch.fmax, "fmin": torch.fmin,
    "atan2": torch.atan2, "heaviside": torch.heaviside,
    "logaddexp": torch.logaddexp, "hypot": torch.hypot,
    "copysign": torch.copysign, "nextafter": torch.nextafter,
    "gcd": torch.gcd, "lcm": torch.lcm,
}

_UNARY = {
    "exp": torch.exp, "expm1": torch.expm1, "log": torch.log,
    "log2": torch.log2, "log10": torch.log10, "log1p": torch.log1p,
    "sqrt": torch.sqrt, "rsqrt": torch.rsqrt, "abs": torch.abs,
    "neg": torch.neg, "sign": torch.sign, "sin": torch.sin, "cos": torch.cos,
    "tan": torch.tan, "asin": torch.asin, "acos": torch.acos,
    "atan": torch.atan, "sinh": torch.sinh, "cosh": torch.cosh,
    "tanh": torch.tanh, "asinh": torch.asinh, "acosh": torch.acosh,
    "atanh": torch.atanh, "floor": torch.floor, "ceil": torch.ceil,
    "round": torch.round, "trunc": torch.trunc,
    "reciprocal": torch.reciprocal, "square": torch.square,
    "erf": torch.erf, "erfinv": torch.erfinv, "sigmoid": torch.sigmoid,
    "digamma": torch.digamma, "lgamma": torch.lgamma, "i0": torch.i0,
    "frac": torch.frac, "rad2deg": torch.rad2deg, "deg2rad": torch.deg2rad,
    "conj": lambda x: torch.conj(x).resolve_conj(),
    "angle": torch.angle, "real": torch.real,
    "imag": lambda x: torch.imag(x) if x.is_complex() else
    torch.zeros_like(x),
    "isnan": torch.isnan, "isinf": torch.isinf, "isfinite": torch.isfinite,
    "logical_not": torch.logical_not, "bitwise_not": torch.bitwise_not,
}

_LOGICAL = {
    "logical_and": torch.logical_and, "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor, "bitwise_and": torch.bitwise_and,
    "bitwise_or": torch.bitwise_or, "bitwise_xor": torch.bitwise_xor,
}

__all__ = sorted(list(_BINARY) + list(_UNARY) + list(_LOGICAL) + [
    "mod", "floor_mod", "pow", "negative", "scale", "clip", "add_n",
    "cumsum", "cumprod", "lerp", "stanh", "multiply_add", "kron", "trace",
    "diff", "nan_to_num", "increment", "renorm", "logit"])


def _scalar_operand(x: torch.Tensor, other):
    """A Python number beside tensor ``x`` as a 0-dim tensor of paddle's
    dtype for it (torch does not promote a same-kind 0-dim tensor over
    ``x``'s dtype)."""
    if isinstance(other, builtins.bool):
        return torch.tensor(other, device=x.device)
    if isinstance(other, int):
        if dtype_mod.is_integer(x.dtype) or x.dtype.is_floating_point:
            return torch.tensor(other, dtype=x.dtype, device=x.device)
        return torch.tensor(other, device=x.device)
    if isinstance(other, float):
        d = x.dtype if x.dtype.is_floating_point else \
            dtype_mod.get_default_dtype()
        return torch.tensor(other, dtype=d, device=x.device)
    if isinstance(other, builtins.complex):
        return torch.tensor(other, device=x.device)
    return other


def _operands(x, y):
    if not isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
        x = _scalar_operand(y, x)
    if not isinstance(y, torch.Tensor) and isinstance(x, torch.Tensor):
        y = _scalar_operand(x, y)
    return x, y


def _binary(name, fn):
    def op(x, y, name=None):
        return fn(*_operands(x, y))

    op.__name__ = op.__qualname__ = name
    return op


def _unary(name, fn):
    def op(x, name=None):
        return fn(x)

    op.__name__ = op.__qualname__ = name
    return op


for _name, _fn in {**_BINARY, **_LOGICAL}.items():
    globals()[_name] = _binary(_name, _fn)
for _name, _fn in _UNARY.items():
    globals()[_name] = _unary(_name, _fn)
del _name, _fn

mod = floor_mod = globals()["remainder"]
negative = globals()["neg"]


def pow(x, y, name=None):
    return torch.pow(*_operands(x, y))


def logit(x, eps=None, name=None):
    """``log(x / (1 - x))``, ``x`` clamped to ``[eps, 1 - eps]`` when
    ``eps`` is given."""
    return torch.logit(x, eps)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """``scale * x + bias`` (or ``scale * (x + bias)``). ``act`` is not
    applied, as in the JAX package."""
    s = scale.item() if isinstance(scale, torch.Tensor) else float(scale)
    b = float(bias)
    if bias_after_scale:
        return s * x + b
    return s * (x + b)


def clip(x, min=None, max=None, name=None):
    mn = min.item() if isinstance(min, torch.Tensor) else min
    mx = max.item() if isinstance(max, torch.Tensor) else max
    return torch.clamp(x, mn, mx)


def add_n(inputs, name=None):
    if isinstance(inputs, torch.Tensor):
        return inputs
    out = inputs[0]
    for t in inputs[1:]:
        out = out + t
    return out


def _cast(out, dtype):
    return out if dtype is None else out.to(dtype_mod.convert_dtype(dtype))


def cumsum(x, axis=None, dtype=None, name=None):
    """Running sum along ``axis`` (``None``: of the flattened tensor).
    An integer input sums in int64, as paddle's does."""
    if axis is None:
        return _cast(torch.cumsum(x.reshape(-1), 0), dtype)
    return _cast(torch.cumsum(x, int(axis)), dtype)


def cumprod(x, dim=None, dtype=None, name=None):
    if dim is None:
        return _cast(torch.cumprod(x.reshape(-1), 0), dtype)
    return _cast(torch.cumprod(x, int(dim)), dtype)


def lerp(x, y, weight, name=None):
    """``x + weight * (y - x)``, in that order of operations."""
    if not isinstance(weight, torch.Tensor):
        weight = _scalar_operand(x, float(weight))
    return x + weight * (y - x)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return float(scale_b) * torch.tanh(float(scale_a) * x)


def multiply_add(x, y, z):
    return x * y + z


def kron(x, y, name=None):
    return torch.kron(x, y)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, int(offset), int(axis1), int(axis2)).sum(-1)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return torch.diff(x, int(n), int(axis), prepend, append)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(x, float(nan), posinf, neginf)


def increment(x, value=1.0, name=None):
    """``x + value`` as a new tensor (the JAX package's convention)."""
    return globals()["add"](x, value)


def renorm(x, p, axis, max_norm, name=None):
    """Each slice along ``axis`` scaled to p-norm at most ``max_norm``
    (``max_norm / (norm + 1e-7)`` where the norm exceeds it)."""
    p, axis, max_norm = float(p), int(axis), float(max_norm)
    moved = torch.movedim(x, axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    norms = (flat.abs() ** p).sum(dim=1) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    out = (flat * factor[:, None]).reshape(moved.shape)
    return torch.movedim(out, 0, axis)
