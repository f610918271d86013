"""Convolution layers (port of ``paddle_tpu/nn/layer/conv.py``): kernels
OIHW (``Conv2DTranspose``: paddle's ``[in, out / groups, kh, kw]``), the
JAX layers' initializers: ``KaimingUniform`` over ``fan_in = in * prod(k)
/ groups`` for the weight and ``Uniform(+-1 / sqrt(fan_in))`` for the bias
(``Conv2DTranspose``: ``fan_in = in * kh * kw``, a zero bias)."""
from __future__ import annotations

import math

from .. import initializer as I
from ..functional import common as Fc
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv2DTranspose"]


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride, padding,
                 dilation, groups, weight_attr, bias_attr, ndim):
        super().__init__()
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * ndim
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = tuple(kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        fan_in = in_channels * int(math.prod(self._kernel_size)) // groups
        bound = 1.0 / math.sqrt(fan_in)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, *self._kernel_size],
            attr=weight_attr, default_initializer=I.KaimingUniform(
                fan_in=fan_in))
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=I.Uniform(-bound, bound))

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv2D(_ConvNd):
    """``F.conv2d`` with the layer's weight (OIHW), passed as it is for
    either ``data_format``, as the JAX layer passes it."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr, 2)
        self._data_format = data_format

    def forward(self, x):
        return Fc.conv2d(x, self.weight, self.bias, self._stride,
                         self._padding, self._dilation, self._groups,
                         self._data_format)


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr, 1)

    def forward(self, x):
        return Fc.conv1d(x, self.weight, self.bias, self._stride,
                         self._padding, self._dilation, self._groups)


class Conv2DTranspose(Layer):
    """``F.conv2d_transpose`` (NCHW) with the layer's ``[in, out / groups,
    kh, kw]`` weight; ``output_size`` at the call replaces the layer's
    ``output_padding``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size, kernel_size)
        self._stride = stride
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = dilation
        self._groups = groups
        fan_in = in_channels * kernel_size[0] * kernel_size[1]
        self.weight = self.create_parameter(
            [in_channels, out_channels // groups, *kernel_size],
            attr=weight_attr, default_initializer=I.KaimingUniform(
                fan_in=fan_in))
        self.bias = self.create_parameter([out_channels], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x, output_size=None):
        return Fc.conv2d_transpose(
            x, self.weight, self.bias, self._stride, self._padding,
            output_padding=0 if output_size is not None
            else self._output_padding,
            groups=self._groups, dilation=self._dilation,
            output_size=output_size)
