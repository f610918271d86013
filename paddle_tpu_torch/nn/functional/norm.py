"""Normalisation functionals (port of ``paddle_tpu/nn/functional/common.py``
``rms_norm`` and ``rms_norm_residual``).

They always go to the RMSNorm kernels' autograd functions
(``kernels/rmsnorm.py``): the hand-written kernel on a CUDA tensor, its plain
version on a CPU tensor. The JAX package's ``FLAGS_fused_kernels`` gate
chooses between a Pallas kernel and the composed XLA form of the same math;
the port has one path, the one the TPU runs.
"""
from __future__ import annotations

from ...kernels import rmsnorm as _rmsnorm

__all__ = ["rms_norm", "rms_norm_residual"]


def rms_norm(x, weight, epsilon=1e-6):
    """RMSNorm over the last axis: ``x * rsqrt(mean(x^2) + eps) * w``."""
    return _rmsnorm.rms_norm(x, weight, epsilon)


def rms_norm_residual(x, residual, weight, epsilon=1e-6):
    """Residual add + RMSNorm -> ``(normed, new_residual)``, the decoder
    layer's pattern ``s = x + residual; y = rmsnorm(s) * w``."""
    return _rmsnorm.rms_norm_residual(x, residual, weight, epsilon)
