"""Device resolution and seeded generators.

Counterpart of ``paddle_tpu/framework/place.py``: the JAX package places
arrays on the TPU; the port places tensors on the CUDA card. Every public
entry point of the port takes ``device=None``, which means ``"cuda"``. A
machine without a card raises instead of quietly running on the CPU; the
CPU is used only when the caller asks for it (``device="cpu"``), as the
tests do.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "seed"]

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``. A CUDA device on a machine without one raises
    ``RuntimeError``; ``"cpu"`` is honoured only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def seed(n: int, device: DeviceLike = None) -> torch.Generator:
    """A ``torch.Generator`` on the resolved device, seeded with ``n``."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(n))
    return g
