"""Matrix products (the part of ``paddle_tpu/ops/linalg.py`` the ported
models call). The rest of ``api.yaml``'s ``methods.linalg`` waits
(ROADMAP Queue 1 item 5)."""
from __future__ import annotations

import torch

__all__ = ["matmul", "bmm", "mm", "einsum"]


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """``x @ y``, either operand's last two dims swapped first when asked
    (a 1-D operand is never transposed)."""
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def bmm(x, y, name=None):
    return torch.bmm(x, y)


def mm(input, mat2, name=None):
    return torch.matmul(input, mat2)


def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = operands[0]
    return torch.einsum(equation, *operands)
