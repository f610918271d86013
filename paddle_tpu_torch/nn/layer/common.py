"""Common layers (port of ``paddle_tpu/nn/layer/common.py``): ``Linear``,
``Embedding``, ``Dropout``, ``Flatten``, ``Identity``, ``CosineSimilarity``
and ``Bilinear``, with the JAX layers' parameter names, shapes and
default initializers (``Linear``'s weight is paddle's ``[in, out]``)."""
from __future__ import annotations

from typing import Optional

import torch

from .. import initializer as I
from ..functional import common as Fc
from .layers import Layer

__all__ = ["Linear", "Embedding", "Dropout", "Flatten", "Identity",
           "CosineSimilarity", "Bilinear"]


class Linear(Layer):
    """``x @ weight + bias``; weight ``[in, out]`` (``XavierUniform``),
    bias ``[out]`` (zeros; ``bias_attr=False``: none)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierUniform())
        self.bias = self.create_parameter([out_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return Fc.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Embedding(Layer):
    """Lookup in ``weight [num_embeddings, embedding_dim]`` (``Normal(0,
    1)``); ids equal to ``padding_idx`` give zero rows. ``sparse=True``
    (the JAX package's host-sharded table) is not ported and raises."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        if sparse:
            raise NotImplementedError(
                "Embedding(sparse=True): the host-sharded table is not "
                "ported; use sparse=False")
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0))

    def forward(self, x):
        return Fc.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    """Dropout with probability ``p`` in training mode (``F.dropout``).
    ``generator`` (a ``torch.Generator`` on the input's device, or ``None``
    for that device's default one, ``framework.random``) draws the keep
    masks; a model sets it to the generator it owns."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return Fc.dropout(x, self.p, axis=self.axis, training=self.training,
                          mode=self.mode, generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return torch.flatten(x, int(self.start_axis), int(self.stop_axis))


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return Fc.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class Bilinear(Layer):
    """``x1 W x2 + b``: weight ``[out, in1, in2]`` (``XavierUniform`` over
    those fans), bias ``[1, out]`` (zeros)."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr)
        self.bias = self.create_parameter([1, out_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x1, x2):
        return Fc.bilinear(x1, x2, self.weight, self.bias)
