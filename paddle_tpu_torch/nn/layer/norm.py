"""Normalisation layers (port of ``paddle_tpu/nn/layer/norm.py``)."""
from __future__ import annotations

import torch
from torch import nn

from ..functional import rms_norm

__all__ = ["RMSNorm"]


class RMSNorm(nn.Module):
    """Root-mean-square norm over the last axis, weight initialised to 1."""

    def __init__(self, hidden_size, epsilon=1e-6):
        super().__init__()
        self.epsilon = float(epsilon)
        self.weight = nn.Parameter(torch.ones(hidden_size))

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)

    def extra_repr(self):
        return f"{self.weight.shape[0]}, epsilon={self.epsilon}"
