"""Common layers (port of ``paddle_tpu/nn/layer/common.py:88-99``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..functional.common import dropout

__all__ = ["Dropout"]


class Dropout(nn.Module):
    """Dropout with probability ``p`` in training mode (``F.dropout``).
    ``generator`` (a ``torch.Generator`` on the input's device, or ``None``
    for torch's default one) draws the keep masks; a model sets it to the
    generator it owns."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return dropout(x, self.p, axis=self.axis, training=self.training,
                       mode=self.mode, generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"
