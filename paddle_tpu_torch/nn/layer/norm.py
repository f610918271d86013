"""Normalisation layers (port of ``paddle_tpu/nn/layer/norm.py``):
``LayerNorm``, ``RMSNorm``, the BatchNorm family (``_BatchNormBase`` with
its ``_mean`` / ``_variance`` buffers under the JAX names,
``BatchNorm1D/2D/3D``, the legacy ``BatchNorm`` with ``act``,
``SyncBatchNorm``), ``GroupNorm``, ``InstanceNorm2D``,
``LocalResponseNorm`` and ``SpectralNorm`` (the layer the JAX package
exports under that name).

``SyncBatchNorm`` is BatchNorm in one process. The JAX package gets the
cross-replica moments from GSPMD over a batch-sharded mesh; the port runs
one process per rank and would need an all-reduce of the moments over the
data ranks, which is not written: under a mesh whose data axes (dp, sdp)
hold more than one rank it raises (ROADMAP Queue 1, "SyncBatchNorm over
dp")."""
from __future__ import annotations

import math

import torch
from torch import nn

from ...framework.place import current_device
from .. import initializer as I
from ..functional import common as Fc
from ..functional import layer_norm, rms_norm
from .layers import Layer

__all__ = ["LayerNorm", "RMSNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "SyncBatchNorm", "GroupNorm", "InstanceNorm2D",
           "LocalResponseNorm", "SpectralNorm"]


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


class _BatchNormBase(Layer):
    """``F.batch_norm`` with a weight (ones; ``weight_attr=False``: ones
    that take no gradient), a bias (zeros; likewise) and the running
    buffers ``_mean`` (zeros) and ``_variance`` (ones), persistable, fp32
    on the expected place; ``momentum`` is paddle's (the share of the
    running value kept)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=None if weight_attr is False else weight_attr,
            default_initializer=I.Constant(1.0))
        if weight_attr is False:
            self.weight.stop_gradient = True
        self.bias = self.create_parameter(
            [num_features], attr=None if bias_attr is False else bias_attr,
            is_bias=True)
        if bias_attr is False:
            self.bias.stop_gradient = True
        dev = current_device()
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, x):
        return Fc.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class BatchNorm(_BatchNormBase):
    """The legacy fluid-style BatchNorm (BatchNorm2D's computation) with an
    optional activation by name."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, data_layout="NCHW",
                 use_global_stats=None, **kwargs):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act is not None:
            from .. import functional as F

            out = getattr(F, self._act)(out)
        return out


def _data_ranks() -> int:
    from ...distributed.mesh import get_mesh_env

    env = get_mesh_env()
    if env is None:
        return 1
    return env.degrees.get("dp", 1) * env.degrees.get("sdp", 1)


class SyncBatchNorm(_BatchNormBase):
    """BatchNorm whose moments would span every data rank; in one process
    (or a mesh with one data rank) it is BatchNorm, and over more data
    ranks it raises (the module docstring says why)."""

    def forward(self, x):
        if _data_ranks() > 1:
            raise NotImplementedError(
                "SyncBatchNorm over more than one data rank (dp x sdp > 1) "
                "needs the moments all-reduced over the data group, which "
                "the port does not do yet (ROADMAP Queue 1, SyncBatchNorm "
                "over dp)")
        return super().forward(x)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every BatchNorm that is not a SyncBatchNorm
        replaced by one holding the same values (weight, bias, running
        buffers); a BatchNorm given alone comes back converted."""
        if isinstance(layer, _BatchNormBase) and \
                not isinstance(layer, SyncBatchNorm):
            new = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon,
                                data_format=layer._data_format)
            new.to(device=layer._mean.device, dtype=layer._mean.dtype)
            with torch.no_grad():
                for n in ("weight", "bias", "_mean", "_variance"):
                    getattr(new, n).copy_(getattr(layer, n))
            return new
        for name, sub in list(layer._modules.items()):
            if sub is not None:
                layer._modules[name] = cls.convert_sync_batchnorm(sub)
        return layer


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [num_channels], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([num_channels], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return Fc.group_norm(x, self._num_groups, self.weight, self.bias,
                             self._epsilon)


class InstanceNorm2D(Layer):
    """Per-sample, per-channel normalisation; the weight is named
    ``scale``, as in the JAX layer."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self.scale = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return Fc.instance_norm(x, weight=self.scale, bias=self.bias,
                                eps=self._epsilon)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        # the JAX layer's window: size // 2 channels before each one (its
        # functional puts (size - 1) // 2 there)
        return Fc._lrn(x, self.size, self.alpha, self.beta, self.k,
                       self.size // 2)


class SpectralNorm(Layer):
    """The standalone spectral-norm layer that the JAX package exports as
    ``nn.SpectralNorm`` (``paddle_tpu/nn/layer/extension_r3.py:459``; its
    ``norm.py`` namesake raises and is shadowed): ``forward(weight)``
    power-iterates on the held ``weight_u`` / ``weight_v`` (``Normal(0,
    1)``, no gradient) and returns ``weight / sigma`` with ``weight``'s
    ``dim`` taken as the rows."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None, dtype="float32"):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        h = weight_shape[dim]
        w = int(math.prod(weight_shape)) // h
        self.weight_u = self.create_parameter(
            [h], default_initializer=I.Normal(0.0, 1.0))
        self.weight_v = self.create_parameter(
            [w], default_initializer=I.Normal(0.0, 1.0))
        self.weight_u.stop_gradient = True
        self.weight_v.stop_gradient = True

    def forward(self, weight):
        dim = self._dim
        perm = [dim] + [d for d in range(weight.dim()) if d != dim]
        mat = weight.permute(perm) if dim != 0 else weight
        mat2 = mat.reshape(mat.shape[0], -1)
        u, v = self.weight_u, self.weight_v
        for _ in range(self._power_iters):
            v_new = mat2.t() @ u
            v = v_new / (torch.linalg.vector_norm(v_new) + self._eps)
            u_new = mat2 @ v
            u = u_new / (torch.linalg.vector_norm(u_new) + self._eps)
        sigma = (u * (mat2 @ v)).sum()
        out = (mat2 / sigma).reshape(mat.shape)
        if dim != 0:
            out = out.permute([perm.index(i) for i in range(weight.dim())])
        return out
