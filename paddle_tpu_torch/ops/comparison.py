"""Comparisons (port of ``paddle_tpu/ops/comparison.py``). None of them
has a gradient; each returns a bool tensor (``allclose``, ``equal_all``
and ``is_empty`` a 0-dim one, as the JAX package does, not a Python bool)."""
from __future__ import annotations

import torch

from .math import _operands

__all__ = ["equal", "not_equal", "greater_than", "greater_equal",
           "less_than", "less_equal", "allclose", "isclose", "equal_all",
           "is_empty", "is_tensor"]

_CMP = {"equal": torch.eq, "not_equal": torch.ne, "greater_than": torch.gt,
        "greater_equal": torch.ge, "less_than": torch.lt,
        "less_equal": torch.le}


def _make(pname, fn):
    def op(x, y, name=None):
        return fn(*_operands(x, y))

    op.__name__ = op.__qualname__ = pname
    return op


for _name, _fn in _CMP.items():
    globals()[_name] = _make(_name, _fn)
del _name, _fn


def _flag(value: bool, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(bool(value), device=like.device)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return _flag(torch.allclose(x, y, float(rtol), float(atol),
                                bool(equal_nan)), x)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.isclose(x, y, float(rtol), float(atol), bool(equal_nan))


def equal_all(x, y, name=None):
    return _flag(x.shape == y.shape and torch.equal(x, y), x)


def is_empty(x, name=None):
    return _flag(x.numel() == 0, x)


def is_tensor(x):
    return isinstance(x, torch.Tensor)
