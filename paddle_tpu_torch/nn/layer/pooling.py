"""Pooling layers (port of ``paddle_tpu/nn/layer/pooling.py``). As the JAX
layers, ``MaxPool2D`` takes ``ceil_mode`` and ``return_mask`` and passes
neither on, ``AvgPool2D`` passes ``exclusive`` and the data format, and
the adaptive layers read NCHW."""
from __future__ import annotations

from ..functional import common as Fc
from .layers import Layer

__all__ = ["MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D",
           "AdaptiveMaxPool2D"]


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW", name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.data_format = data_format

    def forward(self, x):
        return Fc.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                             data_format=self.data_format)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.exclusive = exclusive
        self.data_format = data_format

    def forward(self, x):
        return Fc.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                             exclusive=self.exclusive,
                             data_format=self.data_format)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return Fc.adaptive_avg_pool2d(x, self.output_size)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return Fc.adaptive_max_pool2d(x, self.output_size)
