"""Where tensors live (port of ``paddle_tpu/framework/place.py``).

A ``Place`` names a device; ``set_device`` picks the one that the paddle
surface (``to_tensor``, the creation ops, ``nn.Layer.create_parameter``)
puts new tensors on. The default is the card, ``"gpu:0"``: with no card
and no ``set_device("cpu")`` a new tensor raises, as
``device.resolve_device(None)`` does. The JAX package's ``TPUPlace`` has
no counterpart here and raises.
"""
from __future__ import annotations

import torch

from ..device import resolve_device

__all__ = ["Place", "CPUPlace", "CUDAPlace", "TPUPlace", "CUDAPinnedPlace",
           "set_device", "get_device", "current_device", "place_device"]


class Place:
    """A (device type, index) pair; ``.device`` is the ``torch.device``
    (resolved: a CUDA place raises without a card)."""

    device_type = "unknown"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    def __eq__(self, other):
        return isinstance(other, Place) and \
            (self.device_type, self.device_id) == \
            (other.device_type, other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"


class CPUPlace(Place):
    device_type = "cpu"

    @property
    def device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    device_type = "gpu"

    @property
    def device(self) -> torch.device:
        return resolve_device(f"cuda:{self.device_id}")


class CUDAPinnedPlace(CPUPlace):
    """Page-locked host memory; tensors made for it are plain CPU tensors."""


class TPUPlace(Place):
    device_type = "tpu"

    def __init__(self, device_id: int = 0):
        raise ValueError("TPUPlace: the port runs on CUDA cards; use "
                         "CUDAPlace(i) (or set_device('gpu:i'))")


_EXPECTED = [CUDAPlace(0)]


def set_device(device: str) -> Place:
    """``"gpu"`` / ``"gpu:i"`` (``"cuda"`` too) or ``"cpu"``; returns the
    new place."""
    kind, _, idx = str(device).lower().partition(":")
    idx = int(idx) if idx else 0
    if kind in ("gpu", "cuda"):
        place = CUDAPlace(idx)
    elif kind == "cpu":
        place = CPUPlace(idx)
    elif kind == "tpu":
        place = TPUPlace(idx)
    else:
        raise ValueError(f"Unknown device {device!r}")
    _EXPECTED[0] = place
    return place


def get_device() -> str:
    p = _EXPECTED[0]
    return "cpu" if p.device_type == "cpu" else f"gpu:{p.device_id}"


def current_device() -> torch.device:
    """The ``torch.device`` new tensors go to; raises for the card when
    there is none."""
    return _EXPECTED[0].device


def place_device(place=None) -> torch.device:
    """``place`` (a ``Place``, a device string or ``torch.device``, or
    ``None`` for the expected place) as a resolved ``torch.device``."""
    if place is None:
        return current_device()
    if isinstance(place, Place):
        return place.device
    if isinstance(place, str) and place.lower().startswith("gpu"):
        place = "cuda" + place[3:]
    return resolve_device(place)
