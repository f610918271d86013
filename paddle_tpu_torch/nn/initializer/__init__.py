"""Weight initializers (port of ``paddle_tpu/nn/initializer/__init__.py``).

An initializer called with a shape, ``(shape, dtype=None, device=None,
generator=None)``, returns a new tensor: ``dtype`` None is the default
dtype, ``device`` None the expected place, ``generator`` None that
device's default generator (``framework.random``). Called with a tensor
it fills that tensor in place (paddle's ``init(param)``) and returns it.
Fans follow the JAX package's ``_fans``: ``[in, out]`` for a 2-D weight
(paddle's ``Linear`` layout), ``OIHW`` for a conv kernel. Draws for
float16 and bfloat16 are made in float32 and rounded once.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...framework import dtype as dtype_mod
from ...framework.place import place_device

__all__ = ["Initializer", "Constant", "Uniform", "Normal", "TruncatedNormal",
           "XavierUniform", "XavierNormal", "KaimingUniform",
           "KaimingNormal", "Assign", "Orthogonal", "Dirac",
           "calculate_gain"]


def _fans(shape):
    """(fan_in, fan_out) of a weight of ``shape``: the JAX package's rule."""
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    """Subclasses give ``_draw(shape, dtype, device, generator)``."""

    def __call__(self, shape, dtype=None, device=None, generator=None):
        if isinstance(shape, torch.Tensor):
            target = shape
            with torch.no_grad():
                target.copy_(self._new(tuple(target.shape), target.dtype,
                                       target.device, generator))
            return target
        return self._new(tuple(int(s) for s in shape), dtype, device,
                         generator)

    def _new(self, shape, dtype, device, generator):
        dtype = dtype_mod.convert_dtype(dtype) or \
            dtype_mod.get_default_dtype()
        device = place_device(device)
        if generator is None:
            from ...framework.random import default_generator

            generator = default_generator(device)
        draw = dtype if dtype in (torch.float32, torch.float64) or \
            not dtype.is_floating_point else torch.float32
        return self._draw(shape, draw, device, generator).to(dtype)

    def _draw(self, shape, dtype, device, generator):
        raise NotImplementedError


def _uniform(shape, low, high, dtype, device, generator):
    u = torch.rand(shape, dtype=dtype, device=device, generator=generator)
    return u * (high - low) + low


def _normal(shape, mean, std, dtype, device, generator):
    z = torch.randn(shape, dtype=dtype, device=device, generator=generator)
    return mean + std * z


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _draw(self, shape, dtype, device, generator):
        return torch.full(shape, self.value, dtype=dtype, device=device)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = float(low), float(high)

    def _draw(self, shape, dtype, device, generator):
        return _uniform(shape, self.low, self.high, dtype, device, generator)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = float(mean), float(std)

    def _draw(self, shape, dtype, device, generator):
        return _normal(shape, self.mean, self.std, dtype, device, generator)


class TruncatedNormal(Initializer):
    """``mean + std * z`` with ``z`` a standard normal cut to ``[-2, 2]``
    (by the inverse CDF of a uniform draw between the cut's
    probabilities)."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = float(mean), float(std)

    def _draw(self, shape, dtype, device, generator):
        cdf = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))  # Phi(-2)
        u = _uniform(shape, 2.0 * cdf - 1.0, 1.0 - 2.0 * cdf, dtype, device,
                     generator)
        z = (torch.erfinv(u) * math.sqrt(2.0)).clamp_(-2.0, 2.0)
        return self.mean + self.std * z


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None):
        self._fan_in, self._fan_out = fan_in, fan_out

    def _draw(self, shape, dtype, device, generator):
        fi, fo = _fans(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        limit = math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, -limit, limit, dtype, device, generator)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None):
        self._fan_in, self._fan_out = fan_in, fan_out

    def _draw(self, shape, dtype, device, generator):
        fi, fo = _fans(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        return _normal(shape, 0.0, math.sqrt(2.0 / (fi + fo)), dtype,
                       device, generator)


class KaimingUniform(Initializer):
    """``U(±sqrt(6 / fan_in))`` (ReLU's gain; ``negative_slope`` and
    ``nonlinearity`` are taken and unused, as in the JAX package)."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self._fan_in = fan_in

    def _draw(self, shape, dtype, device, generator):
        fi = self._fan_in if self._fan_in is not None else _fans(shape)[0]
        limit = math.sqrt(6.0 / fi)
        return _uniform(shape, -limit, limit, dtype, device, generator)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self._fan_in = fan_in

    def _draw(self, shape, dtype, device, generator):
        fi = self._fan_in if self._fan_in is not None else _fans(shape)[0]
        return _normal(shape, 0.0, math.sqrt(2.0 / fi), dtype, device,
                       generator)


class Assign(Initializer):
    """The given value (a tensor, a numpy array or a list) of that shape."""

    def __init__(self, value):
        self.value = value

    def _draw(self, shape, dtype, device, generator):
        v = self.value
        t = v.detach() if isinstance(v, torch.Tensor) else \
            torch.as_tensor(np.asarray(v))
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"Assign shape {tuple(t.shape)} != {shape}")
        return t.to(device=device, dtype=dtype)


class Orthogonal(Initializer):
    """``gain`` times a matrix of orthonormal rows or columns over
    ``[prod(shape[:-1]), shape[-1]]`` (the JAX initializer's column
    axis)."""

    def __init__(self, gain=1.0):
        self.gain = float(gain)

    def _draw(self, shape, dtype, device, generator):
        cols = shape[-1]
        rows = int(np.prod(shape[:-1]))
        a = torch.randn((max(rows, cols), min(rows, cols)), dtype=dtype,
                        device=device, generator=generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))[None, :]
        if rows < cols:
            q = q.t()
        return (self.gain * q).reshape(shape)


class Dirac(Initializer):
    """1 at ``[i, i, centre...]`` for ``i < min(out, in)``, 0 elsewhere
    (``groups`` is taken and unused, as in the JAX package)."""

    def __init__(self, groups=1):
        self.groups = groups

    def _draw(self, shape, dtype, device, generator):
        out = torch.zeros(shape, dtype=dtype, device=device)
        centre = tuple(s // 2 for s in shape[2:])
        for i in range(min(shape[0], shape[1])):
            out[(i, i) + centre] = 1.0
        return out


def calculate_gain(nonlinearity, param=None):
    gains = {"sigmoid": 1.0, "linear": 1.0, "conv2d": 1.0,
             "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0), "selu": 3.0 / 4.0}
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    return gains.get(nonlinearity, 1.0)
