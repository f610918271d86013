"""Dropout (port of ``paddle_tpu/nn/functional/common.py:112-127``).

The JAX package draws each keep mask with ``jax.random.bernoulli`` from
the framework's key stream. Here the mask comes from an explicit
``torch.Generator`` (``torch.rand(..., generator=g) < 1 - p``), which a
model owns and hands to every dropout it holds, so that a seed fixes every
mask and a captured CUDA graph can register the generator's state (each
replay then draws fresh masks). Without a generator torch's default one for
the tensor's device is used.

Activation checkpointing runs a layer's forward twice. :func:`rewinding`
makes the two runs draw the same masks, as ``jax.checkpoint`` replays its
key: the first run notes each generator's state (16 bytes on CUDA), every later
run sets the generator back to it and, when done, forward again to where
it was. So recompute keeps no mask and equals the run without it, and
nested regions rewind through their outer region's rewound state.

Inside a CUDA graph capture a generator's state can be neither read nor
copied. There the ``j``-th rewind of a step draws from a twin generator
instead, registered with the graph and set before each replay to where
the same rewind started in an eager run of the step: the generator's
offset then plus the offset the region had reached since the step began
(:class:`Rewinds`, which ``jit.TrainStep`` records in its eager warm-up
step and arms before each replay).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["dropout", "keep_mask", "rewinding", "Rewinds",
           "drawing_generator"]


def drawing_generator(generator: Optional[torch.Generator],
                      device) -> torch.Generator:
    """The generator a draw on ``device`` takes: ``generator``, or torch's
    default one for that device."""
    if generator is not None:
        return generator
    device = torch.device(device)
    if device.type == "cuda":
        index = device.index if device.index is not None else \
            torch.cuda.current_device()
        return torch.cuda.default_generators[index]
    return torch.default_generator


def _capturing(g: torch.Generator) -> bool:
    return g.device.type == "cuda" and torch.cuda.is_current_stream_capturing()


class Rewinds:
    """One CUDA generator's rewinds in one step, for a CUDA graph.

    ``record()`` before an eager run of the step and ``stop()`` after it
    give ``offsets``: for each rewind of the step, in order, the
    generator's offset at its region's first run less its offset when the
    step began. ``capture(twins)`` hands the twins to the regions of the
    captured step, in the same order; ``arm(twins, offsets)`` sets each
    twin to the generator's seed and present offset plus its rewind's, so
    that a replay draws what the eager step would."""

    # by id(generator); each entry holds its generator, so the id stays
    # its own (a CUDA generator takes no weak reference)
    _by_id: Dict[int, "Rewinds"] = {}

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.start: Optional[int] = None
        self.offsets: Optional[List[int]] = None
        self.twins: Optional[List[torch.Generator]] = None
        self.next = 0

    @classmethod
    def of(cls, generator: torch.Generator) -> "Rewinds":
        r = cls._by_id.get(id(generator))
        if r is None:
            r = cls._by_id[id(generator)] = cls(generator)
        return r

    @classmethod
    def find(cls, generator: torch.Generator) -> Optional["Rewinds"]:
        return cls._by_id.get(id(generator))

    def record(self):
        self.start = self.generator.get_offset()
        self.offsets = []

    def stop(self) -> List[int]:
        offsets, self.start, self.offsets = self.offsets, None, None
        return offsets

    def capture(self, twins: Optional[List[torch.Generator]]) -> int:
        """Hands ``twins`` to the regions of the capture that follows
        (``None`` once it is over); returns how many twins the capture
        before took."""
        used = self.next if self.twins is not None else 0
        self.twins, self.next = twins, 0
        return used

    def arm(self, twins: Sequence[torch.Generator], offsets: Sequence[int]):
        seed, offset = self.generator.initial_seed(), \
            self.generator.get_offset()
        for t, d in zip(twins, offsets):
            t.manual_seed(seed)
            t.set_offset(offset + d)


def _mark(g: torch.Generator):
    """What a region's first run notes of ``g``: its state, and its offset
    since a recorded step began (``None`` inside a capture)."""
    if _capturing(g):
        return None
    r = Rewinds.find(g)
    since = None
    if r is not None and r.offsets is not None:
        since = g.get_offset() - r.start
    return g.get_state(), since


@contextlib.contextmanager
def _rewound(g: torch.Generator, mark):
    if _capturing(g):
        r = Rewinds.find(g)
        if r is None or r.twins is None or r.next >= len(r.twins):
            raise RuntimeError(
                "a checkpointed region rewinds inside a CUDA graph capture "
                "that its eager step did not record (capture through "
                "jit.TrainStep)")
        twin = r.twins[r.next]
        r.next += 1
        prev = g.graphsafe_get_state()
        g.graphsafe_set_state(twin)
        try:
            yield
        finally:
            g.graphsafe_set_state(prev)
        return
    state, since = mark
    r = Rewinds.find(g)
    if r is not None and r.offsets is not None:
        r.offsets.append(since)
    prev = g.get_state()
    g.set_state(state)
    try:
        yield
    finally:
        g.set_state(prev)


def rewinding(fn, generators: Sequence[torch.Generator]):
    """``fn`` as the function to hand to ``torch.utils.checkpoint``
    (``preserve_rng_state=False``): every call after the first draws from
    each of ``generators`` what the first call drew, and leaves it where it
    was. A fresh wrapper for each checkpointed call."""
    gens = list(generators)
    if not gens:
        return fn
    marks = []

    def run(*args):
        if not marks:
            marks.append([_mark(g) for g in gens])
            return fn(*args)
        with contextlib.ExitStack() as stack:
            for g, m in zip(gens, marks[0]):
                stack.enter_context(_rewound(g, m))
            return fn(*args)
    return run


def keep_mask(shape, p: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """A bool mask, True with probability ``1 - p`` per element: the JAX
    ``jax.random.bernoulli(key, 1 - p, shape)``, drawn as fp32 uniforms
    from ``generator`` below ``1 - p``."""
    u = torch.rand(tuple(shape), generator=generator, device=device,
                   dtype=torch.float32)
    return u < 1.0 - float(p)


def _scalar(value, dtype):
    """``value`` rounded to ``dtype``, as the JAX package rounds a Python
    float beside an array of that dtype (torch would keep it in fp32)."""
    return torch.tensor(value, dtype=dtype)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            generator: Optional[torch.Generator] = None):
    """``upscale_in_train``: ``where(keep, x / (1 - p), 0)`` in training,
    ``x`` otherwise; ``downscale_in_infer``: ``where(keep, x, 0)`` in
    training, ``x * (1 - p)`` otherwise. ``p == 0`` in training returns
    ``x``. ``axis`` (a mask shared along axes) is not ported: the JAX
    package's ``dropout`` draws an elementwise mask whatever it says."""
    if axis is not None:
        raise NotImplementedError("dropout: axis is not ported (the JAX "
                                  "package draws an elementwise mask)")
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout: unknown mode {mode!r}")
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout: p must be in [0, 1], got {p}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * _scalar(1.0 - p, x.dtype)
        return x
    keep = keep_mask(x.shape, p, generator, x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / _scalar(1.0 - p, x.dtype),
                           x.new_zeros(()))
    return torch.where(keep, x, x.new_zeros(()))
