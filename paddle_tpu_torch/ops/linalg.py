"""Matrix products (the part of ``paddle_tpu/ops/linalg.py`` the ported
models call). The rest of ``api.yaml``'s ``methods.linalg`` waits
(ROADMAP Queue 1 item 5)."""
from __future__ import annotations

import torch

from ..framework.dtype import promoted

__all__ = ["matmul", "bmm", "mm", "einsum"]


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """``x @ y``, either operand's last two dims swapped first when asked
    (a 1-D operand is never transposed); mixed float operands are promoted
    first, as ``jnp.matmul`` does."""
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(*promoted(x, y))


def bmm(x, y, name=None):
    return torch.bmm(*promoted(x, y))


def mm(input, mat2, name=None):
    return torch.matmul(*promoted(input, mat2))


def linear_out_in(x, weight, bias=None):
    """``x @ weight.T + bias`` with torch's ``[out, in]`` weight, promoted
    as the JAX ``linear`` (``jnp.matmul(x, w) + b``) promotes: the product
    in the common type of x and the weight, then the bias added with its
    own promotion."""
    x, weight = promoted(x, weight)
    if bias is None or bias.dtype == x.dtype:
        return torch.nn.functional.linear(x, weight, bias)
    return torch.nn.functional.linear(x, weight) + bias


def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = operands[0]
    return torch.einsum(equation, *operands)
