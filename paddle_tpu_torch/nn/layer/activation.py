"""Activation layers (port of ``paddle_tpu/nn/layer/activation.py``): each
calls its functional with the arguments it was built with; ``PReLU``
holds its slope as a parameter (``Constant(init)``)."""
from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh", "Silu", "Swish",
           "Mish", "Hardswish", "Hardsigmoid", "Softsign", "Tanhshrink",
           "LogSigmoid", "LeakyReLU", "ELU", "SELU", "CELU", "Hardtanh",
           "Hardshrink", "Softshrink", "Softplus", "ThresholdedReLU",
           "Softmax", "LogSoftmax", "PReLU", "Maxout"]


def _act(cls_name, fname, params=()):
    """A layer class whose ``__init__`` takes ``params`` (name, default)
    pairs and an optional ``name``, and whose forward is ``F.<fname>(x,
    *params)``."""
    fn = getattr(F, fname)
    names = [p for p, _ in params]
    defaults = dict(params)

    def __init__(self, *args, **kwargs):
        Layer.__init__(self)
        kwargs.pop("name", None)
        given = dict(zip(names, args))
        given.update(kwargs)
        for n in names:
            setattr(self, n, given.get(n, defaults[n]))

    def forward(self, x):
        return fn(x, *[getattr(self, n) for n in names])

    def extra_repr(self):
        return ", ".join(f"{n}={getattr(self, n)}" for n in names)

    return type(cls_name, (Layer,), {"__init__": __init__,
                                     "forward": forward,
                                     "extra_repr": extra_repr,
                                     "__module__": __name__})


ReLU = _act("ReLU", "relu")
ReLU6 = _act("ReLU6", "relu6")
Sigmoid = _act("Sigmoid", "sigmoid")
Tanh = _act("Tanh", "tanh")
Silu = _act("Silu", "silu")
Swish = _act("Swish", "swish")
Mish = _act("Mish", "mish")
Hardswish = _act("Hardswish", "hardswish")
Hardsigmoid = _act("Hardsigmoid", "hardsigmoid")
Softsign = _act("Softsign", "softsign")
Tanhshrink = _act("Tanhshrink", "tanhshrink")
LogSigmoid = _act("LogSigmoid", "log_sigmoid")
GELU = _act("GELU", "gelu", [("approximate", False)])
LeakyReLU = _act("LeakyReLU", "leaky_relu", [("negative_slope", 0.01)])
ELU = _act("ELU", "elu", [("alpha", 1.0)])
SELU = _act("SELU", "selu", [("scale", 1.0507009873554805),
                             ("alpha", 1.6732632423543772)])
CELU = _act("CELU", "celu", [("alpha", 1.0)])
Hardtanh = _act("Hardtanh", "hardtanh", [("min", -1.0), ("max", 1.0)])
Hardshrink = _act("Hardshrink", "hardshrink", [("threshold", 0.5)])
Softshrink = _act("Softshrink", "softshrink", [("threshold", 0.5)])
Softplus = _act("Softplus", "softplus", [("beta", 1.0), ("threshold", 20.0)])
ThresholdedReLU = _act("ThresholdedReLU", "thresholded_relu",
                       [("threshold", 1.0)])
Softmax = _act("Softmax", "softmax", [("axis", -1)])
LogSoftmax = _act("LogSoftmax", "log_softmax", [("axis", -1)])
Maxout = _act("Maxout", "maxout", [("groups", None), ("axis", 1)])


class PReLU(Layer):
    """``where(x > 0, x, weight * x)``; ``weight [num_parameters]``."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)
