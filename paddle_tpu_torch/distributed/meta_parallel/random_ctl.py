"""Model-parallel RNG control (port of
``paddle_tpu/distributed/meta_parallel/random_ctl.py``).

Named random streams over ``torch.Generator`` states: inside
``tracker.rng_state(name)`` torch's default generator of the device draws
from the named stream, which advances, and the default stream is put back
after. ``model_parallel_random_seed(seed)`` seeds the default generator
with ``seed`` and the three streams of the reference: ``global_seed``
(``seed``, the same on every rank), ``model_parallel_rng`` (``seed + 1024
+`` the mp rank: each tensor-parallel rank drops out differently) and
``local_seed`` (``seed + 2048 +`` the global rank).
"""
from __future__ import annotations

import contextlib

import torch

from ...device import resolve_device
from ...nn.functional.common import drawing_generator
from ..mesh import get_mesh_env

__all__ = ["RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed"]


class RNGStatesTracker:
    def __init__(self):
        self.states = {}  # name -> (device, generator state)

    def reset(self):
        self.states.clear()

    def add(self, name, seed, device=None):
        """A stream ``name`` seeded with ``seed`` on ``device`` (None =
        CUDA)."""
        if name in self.states:
            raise ValueError(f"rng state {name} already exists")
        dev = resolve_device(device)
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed))
        self.states[name] = (dev, g.get_state())

    @contextlib.contextmanager
    def rng_state(self, name="model_parallel_rng"):
        if name not in self.states:
            raise KeyError(f"rng state {name} was never added")
        dev, state = self.states[name]
        gen = drawing_generator(None, dev)
        saved = gen.get_state()
        gen.set_state(state)
        try:
            yield
        finally:
            self.states[name] = (dev, gen.get_state())
            gen.set_state(saved)


_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _TRACKER


def model_parallel_random_seed(seed=None, device=None):
    seed = 0 if seed is None else int(seed)
    dev = resolve_device(device)
    drawing_generator(None, dev).manual_seed(seed)
    env = get_mesh_env()
    mp_rank = env.coord("mp") if env is not None else 0
    rank = env.rank if env is not None else 0
    _TRACKER.reset()
    _TRACKER.add("global_seed", seed, dev)
    _TRACKER.add("model_parallel_rng", seed + 1024 + mp_rank, dev)
    _TRACKER.add("local_seed", seed + 2048 + rank, dev)
