"""Tensor creation (port of ``paddle_tpu/ops/creation.py``).

Each function takes paddle's signature and returns a ``torch.Tensor`` on
the expected place (``framework.place``: the card unless
``set_device("cpu")``). The random ones draw from the default generator of
that device (``framework.random``); the values differ from the JAX
package's threefry draws, the distributions do not.
"""
from __future__ import annotations

import builtins
import math as _math

import numpy as np
import torch

from ..framework import dtype as dtype_mod
from ..framework.place import current_device, place_device

__all__ = ["to_tensor", "full", "zeros", "ones", "full_like", "zeros_like",
           "ones_like", "arange", "linspace", "eye", "empty", "empty_like",
           "tril", "triu", "diag", "diagflat", "meshgrid", "assign", "clone",
           "tril_indices", "triu_indices", "complex", "uniform", "rand",
           "normal", "randn", "standard_normal", "randint", "randperm",
           "bernoulli", "multinomial", "randint_like", "poisson",
           "create_parameter"]


def _dt(dtype, default=None):
    d = dtype_mod.convert_dtype(dtype)
    if d is None:
        d = default if default is not None else dtype_mod.get_default_dtype()
    return d


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        shape = [shape]
    return tuple(int(s) for s in shape)


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """A new tensor holding ``data`` (a tensor, a numpy array, a Python
    number or nested list) on ``place`` (default: the expected place).
    Python floats take the default dtype; ``stop_gradient=False`` makes it
    require a gradient."""
    dev = place_device(place)
    if isinstance(data, torch.Tensor):
        t = data.detach().to(dev, copy=True)
    elif isinstance(data, (np.ndarray, np.generic)):
        t = torch.tensor(np.asarray(data), device=dev)
    else:
        t = torch.tensor(data, device=dev)
        if t.is_floating_point():
            t = t.to(dtype_mod.get_default_dtype())
    if dtype is not None:
        t = t.to(dtype_mod.convert_dtype(dtype))
    if not stop_gradient:
        t.requires_grad_(True)
    return t


def full(shape, fill_value, dtype=None, name=None):
    """``dtype`` None: float32 for a float, bool for a bool, int64 for an
    int, the default dtype otherwise."""
    fill_value = _scalar(fill_value)
    if dtype is None and isinstance(fill_value, builtins.bool):
        d = dtype_mod.bool_
    elif dtype is None and isinstance(fill_value, int):
        d = dtype_mod.int64
    else:
        d = _dt(dtype, dtype_mod.float32 if isinstance(fill_value, float)
                else None)
    return torch.full(_shape(shape), fill_value, dtype=d,
                      device=current_device())


def zeros(shape, dtype=None, name=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype),
                       device=current_device())


def ones(shape, dtype=None, name=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype),
                      device=current_device())


def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(x, _scalar(fill_value),
                           dtype=dtype_mod.convert_dtype(dtype))


def zeros_like(x, dtype=None, name=None):
    return full_like(x, 0, dtype)


def ones_like(x, dtype=None, name=None):
    return full_like(x, 1, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    """int64 when every bound is an int, else the default dtype."""
    if end is None:
        start, end = 0, start
    for v in (start, end, step):
        if isinstance(v, torch.Tensor):
            raise TypeError("arange bounds must be python numbers")
    if dtype is None:
        dtype = dtype_mod.int64 if builtins.all(
            isinstance(v, int) for v in (start, end, step)) else \
            dtype_mod.get_default_dtype()
    return torch.arange(start, end, step, dtype=dtype_mod.convert_dtype(
        dtype), device=current_device())


def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(_scalar(start), _scalar(stop), int(num),
                          dtype=_dt(dtype), device=current_device())


def eye(num_rows, num_columns=None, dtype=None, name=None):
    cols = int(num_rows) if num_columns is None else int(num_columns)
    return torch.eye(int(num_rows), cols, dtype=_dt(dtype),
                     device=current_device())


def empty(shape, dtype=None, name=None):
    """Zeros, as the JAX package's ``empty`` gives (paddle leaves the
    values unset)."""
    return zeros(shape, dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def tril(x, diagonal=0, name=None):
    return torch.tril(x, int(diagonal))


def triu(x, diagonal=0, name=None):
    return torch.triu(x, int(diagonal))


def diag(x, offset=0, padding_value=0, name=None):
    """1-D ``x``: the matrix with ``x`` on diagonal ``offset`` and
    ``padding_value`` elsewhere; 2-D: that diagonal of ``x``."""
    out = torch.diag(x, int(offset))
    if x.dim() == 1 and padding_value != 0:
        on = torch.diag(torch.ones_like(x, dtype=torch.bool), int(offset))
        out = torch.where(on, out, torch.tensor(padding_value,
                                                dtype=out.dtype,
                                                device=out.device))
    return out


def diagflat(x, offset=0, name=None):
    return torch.diagflat(x, int(offset))


def meshgrid(*args, **kwargs):
    tensors = args[0] if len(args) == 1 and isinstance(
        args[0], (list, tuple)) else args
    return list(torch.meshgrid(*tensors, indexing="ij"))


def assign(x, output=None):
    """A copy of ``x``; with ``output``, copied into it in place."""
    x = x if isinstance(x, torch.Tensor) else to_tensor(x)
    if output is not None:
        with torch.no_grad():
            output.copy_(x)
        return output
    return x.clone()


def clone(x, name=None):
    return x.clone()


def tril_indices(row, col=None, offset=0, dtype="int64"):
    col = int(row if col is None else col)
    return torch.tril_indices(int(row), col, int(offset),
                              dtype=dtype_mod.convert_dtype(dtype),
                              device=current_device())


def triu_indices(row, col=None, offset=0, dtype="int64"):
    col = int(row if col is None else col)
    return torch.triu_indices(int(row), col, int(offset),
                              dtype=dtype_mod.convert_dtype(dtype),
                              device=current_device())


def complex(real, imag, name=None):
    return torch.complex(real, imag)


# -- random creation ---------------------------------------------------------

def _generator(seed=0):
    """The expected place's default generator, or with ``seed`` != 0 a new
    one seeded with it (the JAX package's ``jax.random.key(seed)``)."""
    from ..framework.random import default_generator

    if seed == 0:
        return default_generator()
    g = torch.Generator(device=current_device())
    g.manual_seed(int(seed))
    return g


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    d = _dt(dtype)
    u = torch.rand(_shape(shape), dtype=d, device=current_device(),
                   generator=_generator(seed))
    return u * (float(max) - float(min)) + float(min)


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype, 0.0, 1.0)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if shape is None:
        raise ValueError("normal() requires shape")
    z = torch.randn(_shape(shape), dtype=dtype_mod.get_default_dtype(),
                    device=current_device(), generator=_generator())
    return float(mean) + float(std) * z


def randn(shape, dtype=None, name=None):
    return torch.randn(_shape(shape), dtype=_dt(dtype),
                       device=current_device(), generator=_generator())


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    if high is None:
        low, high = 0, low
    return torch.randint(int(low), int(high), _shape(shape),
                         dtype=dtype_mod.convert_dtype(dtype) or
                         dtype_mod.int64, device=current_device(),
                         generator=_generator())


def randperm(n, dtype="int64", name=None):
    return torch.randperm(int(n), dtype=dtype_mod.convert_dtype(dtype),
                          device=current_device(), generator=_generator())


def bernoulli(x, name=None):
    """1 with probability ``x`` per element, in ``x``'s dtype."""
    from ..framework.random import default_generator

    return torch.bernoulli(x, generator=default_generator(x.device))


def multinomial(x, num_samples=1, replacement=False, name=None):
    """``num_samples`` class indices per row of the probabilities ``x``."""
    from ..framework.random import default_generator

    return torch.multinomial(x, int(num_samples), bool(replacement),
                             generator=default_generator(x.device))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    """Random ints with ``x``'s shape; ``dtype`` None keeps ``x``'s."""
    return randint(low, high, tuple(x.shape), dtype=dtype or x.dtype)


def poisson(x, name=None):
    """A Poisson draw per element with rate ``x``, in ``x``'s dtype."""
    from ..framework.random import default_generator

    return torch.poisson(x, generator=default_generator(x.device))


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """A free-standing ``nn.Parameter`` on the expected place:
    ``attr.initializer``, else ``default_initializer``, else zeros for a
    bias, else uniform in ``±sqrt(6 / shape[0])`` (the JAX package's
    rule)."""
    from ..nn import initializer as I
    from ..nn.layer.layers import Parameter, ParamAttr

    shape = _shape(shape)
    attr = ParamAttr._to_attr(attr)
    init = attr.initializer if attr is not None and \
        attr.initializer is not None else default_initializer
    if init is None:
        if is_bias:
            init = I.Constant(0.0)
        else:
            bound = _math.sqrt(6.0 / builtins.max(
                shape[0] if shape else 1, 1))
            init = I.Uniform(-bound, bound)
    data = init(shape, dtype_mod.convert_dtype(dtype), current_device())
    return Parameter._from_attr(data, attr, name=name)
