"""Common functionals (port of the part of
``paddle_tpu/nn/functional/common.py`` that is not about convolution,
pooling or vision): ``linear`` (paddle's ``[in, out]`` weight), ``embedding``
(with the out-of-vocabulary policy), ``layer_norm``, ``normalize``,
``cosine_similarity``, ``bilinear``, ``pad``, and ``dropout``
(``:112-127``).

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
import torch.nn.functional as TF

from ...framework.flags import EMBEDDING_OOV_POLICIES, flag

__all__ = ["dropout", "keep_mask", "rewinding", "Rewinds",
           "drawing_generator", "linear", "embedding", "layer_norm",
           "normalize", "cosine_similarity", "bilinear", "pad"]


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


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with paddle's ``[in, out]`` weight."""
    return TF.linear(x, weight.t(), bias)


def _capturing_on(t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and \
        torch.cuda.is_current_stream_capturing()


def embedding(x, weight, padding_idx=None, sparse=False, name=None,
              oov_policy=None):
    """Rows of ``weight`` at the ids ``x``; the rows at ``padding_idx`` are
    zero and pass no gradient.

    The out-of-vocabulary policy (``FLAGS_embedding_oov_policy``, or
    ``oov_policy`` for this call), as in
    ``paddle_tpu/nn/functional/common.py:57-100``:

    - ``'error'``: an eager call reads the ids' min and max back (one
      readback for both) and raises ``ValueError`` on an id outside
      ``[0, rows)``. Under a CUDA graph capture nothing can be read back,
      and an id past the table would fire a device-side assert that
      leaves the CUDA context unusable; there the ids are clamped to the
      table, unchecked. (The JAX package's traced path is unchecked too,
      but its ``jnp.take`` under jax 0.9.0 returns NaN rows for ids
      ``>= rows`` or ``< -rows`` and wraps ids in ``[-rows, 0)``; a clamp
      is what the port can do without a NaN poisoning the step.)
    - ``'clip'``: the ids are clamped to ``[0, rows - 1]`` everywhere.

    ``sparse`` is taken and has no effect (the gradient is dense)."""
    policy = oov_policy or flag("embedding_oov_policy")
    if policy not in EMBEDDING_OOV_POLICIES:
        raise ValueError(f"embedding oov_policy must be 'error' or 'clip', "
                         f"got {policy!r}")
    n = weight.shape[0]
    ids = x if x.dtype in (torch.int32, torch.int64) else x.long()
    if policy == "clip" or _capturing_on(ids):
        ids = ids.clamp(0, n - 1)
    elif ids.numel():
        lo, hi = (int(v) for v in torch.stack([ids.min(), ids.max()])
                  .tolist())
        if lo < 0 or hi >= n:
            raise ValueError(
                f"embedding: id out of range [0, {n}) (min={lo}, max={hi}); "
                f"pass oov_policy='clip' or set "
                f"FLAGS_embedding_oov_policy='clip' for the clamped lookup")
    out = TF.embedding(ids, weight)
    if padding_idx is not None:
        out = out.masked_fill((ids == padding_idx)[..., None], 0.0)
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """Normalised over the trailing ``normalized_shape`` dims (biased
    variance), then ``* weight + bias``."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    return TF.layer_norm(x, list(normalized_shape), weight, bias,
                         float(epsilon))


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(||x||_p, epsilon)`` along ``axis``."""
    p = float(p)
    norm = torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=int(axis),
                               keepdim=True), 1.0 / p)
    return x / torch.clamp(norm, min=float(epsilon))


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    """``sum(x1 * x2) / max(||x1|| * ||x2||, eps)`` along ``axis``."""
    axis = int(axis)
    dot = torch.sum(x1 * x2, dim=axis)
    n1 = torch.sqrt(torch.sum(torch.square(x1), dim=axis))
    n2 = torch.sqrt(torch.sum(torch.square(x2), dim=axis))
    return dot / torch.clamp(n1 * n2, min=float(eps))


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[n, o] = x1[n, i] weight[o, i, j] x2[n, j] + bias``."""
    out = torch.einsum("ni,oij,nj->no", x1, weight, x2)
    return out if bias is None else out + bias


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    from ...ops.manipulation import pad as _pad

    return _pad(x, pad, mode, value, data_format)
