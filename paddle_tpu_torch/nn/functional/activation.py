"""Activation functionals (port of ``paddle_tpu/nn/functional/activation.py``).

Each follows the JAX function's formula; where torch's own function
computes the same thing it is called (``F.gelu``, ``F.silu``, ...), else
the formula is written out. ``softmax``/``log_softmax`` with ``dtype``
cast the input first, as paddle does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...framework import dtype as dtype_mod

__all__ = ["relu", "relu6", "sigmoid", "tanh", "silu", "swish", "softplus",
           "softsign", "mish", "hardswish", "hardsigmoid", "tanhshrink",
           "log_sigmoid", "gelu", "leaky_relu", "elu", "celu", "selu",
           "hardtanh", "hardshrink", "softshrink", "thresholded_relu",
           "softmax", "log_softmax", "prelu", "glu", "maxout",
           "gumbel_softmax", "elu_"]


def relu(x, name=None):
    return TF.relu(x)


def relu6(x, name=None):
    return TF.relu6(x)


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def tanh(x, name=None):
    return torch.tanh(x)


def silu(x, name=None):
    return TF.silu(x)


def swish(x, name=None):
    return TF.silu(x)


def softplus(x, beta=1, threshold=20, name=None):
    """``log(1 + exp(beta * x)) / beta``, ``x`` itself past
    ``threshold``."""
    return TF.softplus(x, beta=beta, threshold=threshold)


def softsign(x, name=None):
    return TF.softsign(x)


def mish(x, name=None):
    return TF.mish(x)


def hardswish(x, name=None):
    return TF.hardswish(x)


def hardsigmoid(x, slope=1.0 / 6.0, offset=0.5, name=None):
    """``clip(x * slope + offset, 0, 1)``."""
    return torch.clamp(x * slope + offset, 0.0, 1.0)


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def log_sigmoid(x, name=None):
    return TF.logsigmoid(x)


def gelu(x, approximate=False, name=None):
    """Erf GELU, or the tanh approximation with ``approximate``."""
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def leaky_relu(x, negative_slope=0.01, name=None):
    return TF.leaky_relu(x, float(negative_slope))


def elu(x, alpha=1.0, name=None):
    return TF.elu(x, float(alpha))


def elu_(x, alpha=1.0, name=None):
    """``elu`` written into ``x``."""
    return TF.elu_(x, float(alpha))


def celu(x, alpha=1.0, name=None):
    return TF.celu(x, float(alpha))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    """``scale * where(x > 0, x, alpha * expm1(x))``."""
    return float(scale) * torch.where(x > 0, x, float(alpha) * torch.expm1(x))


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, float(min), float(max))


def hardshrink(x, threshold=0.5, name=None):
    return TF.hardshrink(x, float(threshold))


def softshrink(x, threshold=0.5, name=None):
    return TF.softshrink(x, float(threshold))


def thresholded_relu(x, threshold=1.0, name=None):
    return torch.where(x > float(threshold), x, torch.zeros_like(x))


def _cast(x, dtype):
    return x if dtype is None else x.to(dtype_mod.convert_dtype(dtype))


def softmax(x, axis=-1, dtype=None, name=None):
    return torch.softmax(_cast(x, dtype), dim=int(axis))


def log_softmax(x, axis=-1, dtype=None, name=None):
    return torch.log_softmax(_cast(x, dtype), dim=int(axis))


def prelu(x, weight, data_format="NCHW", name=None):
    """``where(x > 0, x, w * x)``; a weight of more than one element is per
    channel (dim 1, or the last dim with ``data_format="NHWC"``)."""
    w = weight
    if w.dim() == 1 and w.shape[0] > 1 and x.dim() > 1:
        shape = [1] * x.dim()
        shape[-1 if data_format in ("NHWC", "NLC", "NDHWC") else 1] = \
            w.shape[0]
        w = w.reshape(shape)
    return torch.where(x > 0, x, w * x)


def glu(x, axis=-1, name=None):
    return TF.glu(x, int(axis))


def maxout(x, groups, axis=1, name=None):
    """The max over each run of ``groups`` channels along ``axis``."""
    axis = int(axis) % x.dim()
    shape = list(x.shape)
    shape[axis:axis + 1] = [shape[axis] // int(groups), int(groups)]
    return torch.amax(x.reshape(shape), dim=axis + 1)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """Softmax of ``(x + Gumbel noise) / temperature``; with ``hard`` the
    one-hot of its argmax, with the soft gradient (straight through). The
    noise comes from the default generator of ``x``'s device."""
    from ...framework.random import default_generator

    u = torch.rand(x.shape, dtype=x.dtype, device=x.device,
                   generator=default_generator(x.device))
    g = -torch.log(-torch.log(u.clamp(min=1e-20)))
    y = torch.softmax((x + g) / float(temperature), dim=int(axis))
    if hard:
        idx = y.argmax(dim=int(axis), keepdim=True)
        onehot = torch.zeros_like(y).scatter_(int(axis), idx, 1.0)
        y = onehot + y - y.detach()
    return y
