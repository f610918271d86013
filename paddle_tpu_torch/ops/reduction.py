"""Reductions (port of ``paddle_tpu/ops/reduction.py``).

Paddle's rules where torch's differ: ``max``/``min`` with an ``axis``
return the values only; ``argmax``/``argmin`` return int64 unless
``dtype`` says otherwise (over the flattened tensor when ``axis`` is
None); ``sum`` and ``prod`` of an integer or bool tensor give int64;
``mean`` of an integer tensor gives the default float dtype; ``median``
averages the two middle values of an even count. ``axis`` is an int, a
list or tuple of ints (``[]`` or ``None``: every axis).
"""
from __future__ import annotations

import builtins

import torch

from ..framework import dtype as dtype_mod

__all__ = ["sum", "mean", "prod", "max", "min", "amax", "amin", "all", "any",
           "nansum", "nanmean", "logsumexp", "std", "var", "argmax",
           "argmin", "median", "quantile", "count_nonzero"]


def _dims(x, axis):
    """``axis`` as a tuple of dims (every dim for None or [])."""
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if axis is None:
        return tuple(range(x.dim()))
    if isinstance(axis, (list, tuple)):
        if not axis:
            return tuple(range(x.dim()))
        return tuple(int(a) for a in axis)
    return (int(axis),)


def _float_of(x):
    return x if x.is_floating_point() or x.is_complex() else \
        x.to(dtype_mod.get_default_dtype())


def _cast(out, dtype):
    return out if dtype is None else out.to(dtype_mod.convert_dtype(dtype))


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    return _cast(torch.sum(x, dim=_dims(x, axis), keepdim=bool(keepdim)),
                 dtype)


def mean(x, axis=None, keepdim=False, name=None):
    return torch.mean(_float_of(x), dim=_dims(x, axis),
                      keepdim=bool(keepdim))


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    out = x if x.is_floating_point() or x.is_complex() else \
        x.to(torch.int64)
    for d in sorted((a % builtins.max(x.dim(), 1) for a in _dims(x, axis)),
                    reverse=True):
        out = torch.prod(out, dim=d, keepdim=bool(keepdim))
    return _cast(out, dtype)


def max(x, axis=None, keepdim=False, name=None):
    """The values only (paddle's ``max``); ties share the gradient."""
    return torch.amax(x, dim=_dims(x, axis), keepdim=bool(keepdim))


def min(x, axis=None, keepdim=False, name=None):
    return torch.amin(x, dim=_dims(x, axis), keepdim=bool(keepdim))


amax = max
amin = min


def all(x, axis=None, keepdim=False, name=None):
    return torch.all(x, dim=_dims(x, axis), keepdim=bool(keepdim))


def any(x, axis=None, keepdim=False, name=None):
    return torch.any(x, dim=_dims(x, axis), keepdim=bool(keepdim))


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    return _cast(torch.nansum(x, dim=_dims(x, axis), keepdim=bool(keepdim)),
                 dtype)


def nanmean(x, axis=None, keepdim=False, name=None):
    return torch.nanmean(_float_of(x), dim=_dims(x, axis),
                         keepdim=bool(keepdim))


def logsumexp(x, axis=None, keepdim=False, name=None):
    return torch.logsumexp(x, dim=_dims(x, axis), keepdim=bool(keepdim))


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.std(_float_of(x), dim=_dims(x, axis),
                     correction=1 if unbiased else 0, keepdim=bool(keepdim))


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.var(_float_of(x), dim=_dims(x, axis),
                     correction=1 if unbiased else 0, keepdim=bool(keepdim))


def _arg(fn, x, axis, keepdim, dtype):
    if axis is None:
        out = fn(x.reshape(-1))
    else:
        out = fn(x, dim=int(axis), keepdim=bool(keepdim))
    return out.to(dtype_mod.convert_dtype(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    """The first index of the largest value along ``axis``."""
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def _to_last(x, axis):
    """``x`` with the reduced dims moved last and flattened into one, and
    the kept shape with 1 in each reduced dim."""
    dims = sorted(d % builtins.max(x.dim(), 1) for d in _dims(x, axis))
    keep = [d for d in range(x.dim()) if d not in dims]
    moved = x.permute(keep + dims) if x.dim() else x.reshape(1)
    flat = moved.reshape([x.shape[d] for d in keep] + [-1])
    kept_shape = [1 if d in dims else x.shape[d] for d in range(x.dim())]
    return flat, kept_shape


def quantile(x, q, axis=None, keepdim=False, name=None):
    """Linear interpolation between the two nearest ranks; a list ``q``
    puts its values on a new first dim."""
    flat, kept_shape = _to_last(_float_of(x), axis)
    qt = torch.tensor(q, dtype=flat.dtype, device=flat.device)
    out = torch.quantile(flat, qt, dim=-1)
    if keepdim:
        lead = list(out.shape[:1]) if qt.dim() else []
        out = out.reshape(lead + kept_shape)
    return out


def median(x, axis=None, keepdim=False, name=None):
    return quantile(x, 0.5, axis, keepdim)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    dims = _dims(x, axis)
    out = torch.count_nonzero(x, dim=dims)
    if keepdim:
        for d in sorted(a % builtins.max(x.dim(), 1) for a in dims):
            out = out.unsqueeze(d)
    return out
