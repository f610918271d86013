"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` is the reference; this package computes the
same functions in PyTorch, with the Pallas TPU kernels replaced by CUDA C++
kernels written for ``sm_90a`` (``paddle_tpu_torch.kernels``). Importing it
builds nothing: the kernels compile at first use on a machine with ``nvcc``.
"""
from .device import resolve_device, seed

__all__ = ["resolve_device", "seed"]
