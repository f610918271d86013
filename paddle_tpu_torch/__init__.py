"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` is the reference; this package computes the
same functions in PyTorch, with the Pallas TPU kernels replaced by CUDA C++
kernels written for ``sm_90a`` (``paddle_tpu_torch.kernels``). Importing it
builds nothing: the kernels compile at first use on a machine with ``nvcc``.

The top level is paddle's surface: the dtypes, places and the global seed
(``framework``), ``Tensor`` (which is ``torch.Tensor``, ``core``) and
autograd's switches, and the op namespace (``ops``: ``to_tensor``,
``reshape(x, shape)``, ``split(x, num_or_sections, axis)``,
``max(x, axis)``, ...), so one script drives either package as
``P.reshape(P.to_tensor(a), [2, -1])``. ``seed(n)`` is paddle's: it seeds
the default generators and returns the expected place's;
``device.seed(n, device)`` makes a fresh seeded generator.
"""
from . import framework
from .core import (Tensor, enable_grad, grad, is_grad_enabled, no_grad,
                   set_grad_enabled)
from .device import resolve_device
from .framework import (CPUPlace, CUDAPinnedPlace, CUDAPlace, TPUPlace,
                        bfloat16, complex64, complex128, finfo, float16,
                        float32, float64, get_default_dtype, get_device,
                        get_flags, get_rng_state, iinfo, int8, int16, int32,
                        int64, seed, set_default_dtype, set_device,
                        set_flags, set_rng_state, uint8)
from .framework import bool_ as bool  # noqa: A001 (paddle.bool)
from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops
from . import nn  # noqa: E402
from .nn.layer.layers import ParamAttr  # noqa: E402

__all__ = ["resolve_device", "seed", "get_flags", "set_flags", "framework",
           "Tensor", "no_grad", "enable_grad", "set_grad_enabled",
           "is_grad_enabled", "grad", "CPUPlace", "CUDAPlace",
           "CUDAPinnedPlace", "TPUPlace", "set_device", "get_device",
           "get_rng_state", "set_rng_state", "bool", "uint8", "int8",
           "int16", "int32", "int64", "float16", "bfloat16", "float32",
           "float64", "complex64", "complex128", "get_default_dtype",
           "set_default_dtype", "iinfo", "finfo", "nn", "ParamAttr"] + _ops
