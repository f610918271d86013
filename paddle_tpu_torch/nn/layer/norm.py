"""Normalisation layers (port of ``paddle_tpu/nn/layer/norm.py``:
``LayerNorm`` and ``RMSNorm``)."""
from __future__ import annotations

import torch
from torch import nn

from .. import initializer as I
from ..functional import layer_norm, rms_norm
from .layers import Layer

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(Layer):
    """``F.layer_norm`` over the trailing ``normalized_shape`` dims; weight
    ones, bias zeros (``False`` for either: none)."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(self._normalized_shape,
                                          attr=bias_attr, is_bias=True)

    def forward(self, x):
        return layer_norm(x, self._normalized_shape, self.weight, self.bias,
                          self._epsilon)

    def extra_repr(self):
        return (f"normalized_shape={self._normalized_shape}, "
                f"epsilon={self._epsilon}")


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
