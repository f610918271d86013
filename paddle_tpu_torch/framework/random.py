"""Global random state (port of ``paddle_tpu/framework/random.py``).

Paddle keeps one stateful generator per device (``paddle.seed`` seeds
them). Here those generators are torch's own default ones:
``torch.default_generator`` on the CPU and
``torch.cuda.default_generators[i]`` on card ``i``. The initializers, the
random creation ops and every dropout that holds no generator of its own
draw from them, and a CUDA graph registers the card's default generator by
itself, so a captured ``jit.TrainStep`` draws fresh dropout masks on every
replay without being told about them.

The JAX package draws with threefry keys, so the two packages draw
different values from the same seed; parity tests move weights across as
numpy.
"""
from __future__ import annotations

import torch

from .place import place_device

__all__ = ["seed", "default_generator", "get_rng_state", "set_rng_state"]


def default_generator(device=None) -> torch.Generator:
    """The default generator of ``device`` (``None``: the expected place;
    a card without one raises)."""
    dev = place_device(device)
    if dev.type == "cuda":
        torch.cuda.init()  # the default generators exist once CUDA is up
        index = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        return torch.cuda.default_generators[index]
    return torch.default_generator


def seed(value: int) -> torch.Generator:
    """paddle.seed: seeds the CPU's default generator and every card's,
    and returns the expected place's."""
    gen = default_generator()
    torch.manual_seed(int(value))  # the CPU and, where there are, the cards
    return gen


def get_rng_state(device=None):
    """The default generator's state on ``device`` (a ``ByteTensor``)."""
    return default_generator(device).get_state()


def set_rng_state(state, device=None):
    default_generator(device).set_state(state)
