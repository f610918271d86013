"""``nn.Layer``, ``Parameter`` and ``ParamAttr`` (port of
``paddle_tpu/nn/layer/layers.py``).

``Layer`` is a ``torch.nn.Module`` with paddle's surface on top:
``create_parameter`` (the JAX defaults: a ``XavierUniform`` weight, a zero
bias, ``attr.initializer`` winning over both; on the expected place of
``framework.place``), ``parameters()`` as a list, ``sublayers``,
``state_dict`` / ``set_state_dict`` with structured names (numpy arrays or
tensors in, copied into the parameters in place), ``register_buffer(...,
persistable=)``, ``to(device=, dtype="bfloat16")`` with paddle's strings,
and forward pre- and post-hooks whose handles ``remove()``. Everything
else is torch's: a ``Layer`` goes wherever a module goes.

``Parameter`` is a ``torch.nn.Parameter`` carrying paddle's attributes:
``trainable`` and ``stop_gradient`` (both read ``requires_grad``),
``need_clip``, ``optimize_attr``, ``regularizer``, ``is_distributed``.
"""
from __future__ import annotations

import copy
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ...framework import dtype as dtype_mod
from ...framework.place import current_device

__all__ = ["Layer", "Parameter", "ParamAttr"]


class ParamAttr:
    """How a layer makes a parameter (``paddle.ParamAttr``)."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True,
                 do_model_average=False):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip
        self.do_model_average = do_model_average

    @staticmethod
    def _to_attr(attr):
        """paddle's accepted forms: None, False (no parameter), a
        ``ParamAttr``, a name, or an initializer."""
        from ..initializer import Initializer

        if attr is None or attr is False or isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, Initializer):
            return ParamAttr(initializer=attr)
        raise TypeError(f"not a parameter attribute: {attr!r}")


class Parameter(nn.Parameter):
    """A trainable tensor with paddle's parameter attributes."""

    def __new__(cls, data=None, trainable=True, name=None):
        if data is None:
            data = torch.empty(0)
        return torch.Tensor._make_subclass(cls, data.detach(),
                                           bool(trainable))

    def __init__(self, data=None, trainable=True, name=None):
        self._param_name = name
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True
        self.do_model_average = None
        self.is_distributed = False

    @property
    def name(self):
        """The parameter's name (torch's ``Tensor.name`` is read-only)."""
        return self._param_name

    @name.setter
    def name(self, value):
        self._param_name = value

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, value):
        self.requires_grad_(bool(value))

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        self.requires_grad_(not value)

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = type(self)(self.data.clone(memory_format=torch.preserve_format),
                         self.requires_grad)
        memo[id(self)] = out
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return out

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()

    @classmethod
    def _from_attr(cls, data, attr, name=None):
        p = cls(data, name=name)
        if attr:
            if attr.name is not None:
                p.name = attr.name
            p.optimize_attr["learning_rate"] = attr.learning_rate
            p.regularizer = attr.regularizer
            p.need_clip = attr.need_clip
            if attr.trainable is False:
                p.trainable = False
        return p


def _dtype_arg(v):
    return dtype_mod.convert_dtype(v) if isinstance(v, str) and \
        v.replace("paddle.", "") in dtype_mod._NAME_TO_DTYPE else v


def _device_arg(v):
    if isinstance(v, str) and v.lower().startswith("gpu"):
        return "cuda" + v[3:]
    return v


class Layer(nn.Module):
    """The paddle module base class over ``torch.nn.Module``."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtype
        self._full_name = name_scope or type(self).__name__.lower()

    # -- parameters -----------------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None) -> Optional[Parameter]:
        """A new ``Parameter`` of ``shape`` on the expected place;
        ``attr=False`` gives None."""
        from .. import initializer as I

        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dtype = dtype_mod.convert_dtype(dtype or self._dtype)
        init = default_initializer
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierUniform()
        if attr is not None and attr.initializer is not None:
            init = attr.initializer
        data = init([int(s) for s in shape], dtype, current_device())
        return Parameter._from_attr(data, attr)

    def add_parameter(self, name: str, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None):
        persistent = persistable if persistent is None else persistent
        super().register_buffer(name, tensor, persistent=bool(persistent))
        return tensor

    # -- iteration ------------------------------------------------------------
    def parameters(self, include_sublayers=True,
                   recurse=None) -> List[torch.Tensor]:
        """A list (paddle's), over sublayers unless told otherwise."""
        recurse = include_sublayers if recurse is None else recurse
        return list(super().parameters(recurse=bool(recurse)))

    def named_parameters(self, prefix="", include_sublayers=True,
                         remove_duplicate=True, recurse=None):
        """paddle's ``include_sublayers`` or torch's ``recurse``."""
        recurse = include_sublayers if recurse is None else recurse
        return super().named_parameters(prefix=prefix, recurse=bool(recurse),
                                        remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers=True, recurse=None):
        recurse = include_sublayers if recurse is None else recurse
        return list(super().buffers(recurse=bool(recurse)))

    def named_sublayers(self, prefix="", include_self=False):
        for name, m in self.named_modules(prefix=prefix):
            if m is self and not include_self:
                continue
            yield name, m

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    def full_name(self):
        return self._full_name

    # -- state ----------------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", *, prefix="",
                   keep_vars=False):
        """Parameters and persistable buffers by structured name."""
        out = super().state_dict(destination=destination,
                                 prefix=prefix or structured_name_prefix,
                                 keep_vars=keep_vars)
        if not include_sublayers:
            own = set(self._parameters) | set(self._buffers)
            base = len(prefix or structured_name_prefix)
            for k in [k for k in out if k[base:] not in own]:
                del out[k]
        return out

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copies each entry (a tensor, a numpy array or anything
        ``np.asarray`` takes) into the parameter or buffer of that name, in
        place and in its dtype; a shape mismatch raises. Returns
        ``(missing, unexpected)`` names."""
        own = super().state_dict(keep_vars=True)
        missing = [k for k in own if k not in state_dict]
        unexpected = []
        with torch.no_grad():
            for k, v in state_dict.items():
                tgt = own.get(k)
                if tgt is None:
                    unexpected.append(k)
                    continue
                src = v.detach() if isinstance(v, torch.Tensor) else \
                    torch.tensor(np.asarray(v))
                if tuple(src.shape) != tuple(tgt.shape):
                    raise ValueError(f"shape mismatch for {k}: "
                                     f"{tuple(src.shape)} vs "
                                     f"{tuple(tgt.shape)}")
                tgt.copy_(src.to(device=tgt.device, dtype=tgt.dtype))
        return missing, unexpected

    load_dict = set_state_dict

    # -- placement ------------------------------------------------------------
    def to(self, *args, **kwargs):
        """torch's ``to`` that also takes paddle's strings: ``"gpu:0"``,
        ``dtype="bfloat16"``, and ``blocking=``."""
        args = tuple(_device_arg(_dtype_arg(a)) for a in args)
        if "dtype" in kwargs:
            kwargs["dtype"] = _dtype_arg(kwargs["dtype"])
        if "device" in kwargs:
            kwargs["device"] = _device_arg(kwargs["device"])
            if kwargs["device"] is None:
                del kwargs["device"]
        if "blocking" in kwargs:
            kwargs["non_blocking"] = kwargs.pop("blocking") is False
        if kwargs.get("dtype", 0) is None:
            del kwargs["dtype"]
        return super().to(*args, **kwargs)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    # -- hooks ----------------------------------------------------------------
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)``; a value it returns replaces
        the outputs. The handle's ``remove()`` takes it off."""
        return self.register_forward_hook(hook)
