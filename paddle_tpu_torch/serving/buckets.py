"""Shape buckets: the closed set of (batch, seq) shapes a ``ServingEngine``
runs (port of ``paddle_tpu/serving/buckets.py``, host-side numpy).

Every request is padded UP to the smallest bucket that fits, and the engine
runs every bucket's shape once before serving, so steady-state traffic
meets no new shape (the engine's ``compile_cache_misses`` stays 0).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["BucketSpec"]


class BucketSpec:
    """Pre-declared padding targets along batch and (optionally) sequence.

    - ``batch_sizes``: allowed batch dims, e.g. ``(1, 2, 4, 8)``; a batch of
      3 requests executes in the 4-bucket with one padded row.
    - ``seq_lens``: allowed lengths for variable (``None``) per-sample dims,
      e.g. ``(64, 128, 256)``; ``None`` means no variable dims are served.
    - ``seq_axis``: which PER-SAMPLE axis is the sequence axis (default 0,
      i.e. axis 1 of the batched tensor).
    - ``pad_value``: fill for padded rows/positions (0 is safe for token ids
      and for causal-attention tails — padded positions are masked off or
      causally unreachable from real ones).
    - ``observed_floor``: smallest request size this spec claims to serve
      (the online tuner passes the smallest OBSERVED size).  Any seq
      bucket below it is dead weight — it can never be selected, it only
      spends a warmed executable — so construction rejects it outright
      instead of silently padding around it.

    Both axes are validated, not repaired: entries must be positive
    integers and free of duplicates (order-insensitive input is fine and
    is canonicalized ascending; a duplicate is a spec author's error the
    engine must surface, not fold away).
    """

    def __init__(self, batch_sizes: Sequence[int] = (1, 2, 4, 8),
                 seq_lens: Optional[Sequence[int]] = None,
                 seq_axis: int = 0, pad_value=0,
                 observed_floor: Optional[int] = None):
        self.batch_sizes: Tuple[int, ...] = self._validated(
            "batch_sizes", batch_sizes)
        self.seq_lens: Optional[Tuple[int, ...]] = (
            self._validated("seq_lens", seq_lens, floor=observed_floor)
            if seq_lens else None)
        self.seq_axis = int(seq_axis)
        self.pad_value = pad_value
        self.observed_floor = (int(observed_floor)
                               if observed_floor is not None else None)

    @staticmethod
    def _validated(name: str, sizes: Sequence[int],
                   floor: Optional[int] = None) -> Tuple[int, ...]:
        """One validation path for every bucket axis (hand-declared and
        tuner-derived): positive ints, no duplicates, monotonic ascending
        canonical form, nothing below the observed floor."""
        if not sizes:
            raise ValueError(f"BucketSpec: {name} must be non-empty")
        vals = [int(s) for s in sizes]
        if any(int(s) != s for s in sizes) or min(vals) < 1:
            raise ValueError(
                f"BucketSpec: {name} must be positive integers, got "
                f"{tuple(sizes)}")
        out = tuple(sorted(vals))
        if len(out) != len(set(out)):
            dups = sorted({v for v in vals if vals.count(v) > 1})
            raise ValueError(
                f"BucketSpec: duplicate {name} entries {dups} — each "
                f"bucket is one warmed executable, declare it once")
        if floor is not None and out[0] < int(floor):
            below = tuple(v for v in out if v < int(floor))
            raise ValueError(
                f"BucketSpec: {name} buckets {below} are below the "
                f"smallest observed size {int(floor)} — they can never "
                f"be selected and only waste warmed executables")
        return out

    @property
    def max_batch(self) -> int:
        return self.batch_sizes[-1]

    def batch_bucket(self, n: int) -> Optional[int]:
        """Smallest declared batch size >= n (None: n exceeds every bucket)."""
        for b in self.batch_sizes:
            if b >= n:
                return b
        return None

    def seq_bucket(self, length: int) -> Optional[int]:
        """Smallest declared seq length >= length (None: no fit)."""
        if self.seq_lens is None:
            return None
        for s in self.seq_lens:
            if s >= length:
                return s
        return None

    # -- padding --------------------------------------------------------------
    def pad_sample_seq(self, arr: np.ndarray) -> np.ndarray:
        """Pad one per-sample array's seq axis up to its bucket (no-op when
        no seq buckets are declared or the axis is already bucket-sized)."""
        if self.seq_lens is None:
            return arr
        axis = self.seq_axis
        if axis >= arr.ndim:
            return arr
        target = self.seq_bucket(arr.shape[axis])
        if target is None:
            raise ValueError(
                f"sequence length {arr.shape[axis]} exceeds the largest "
                f"declared seq bucket {self.seq_lens[-1]}")
        if target == arr.shape[axis]:
            return arr
        pad = [(0, 0)] * arr.ndim
        pad[axis] = (0, target - arr.shape[axis])
        return np.pad(arr, pad, constant_values=self.pad_value)

    def stack_batch(self, samples: List[np.ndarray], bucket_b: int) -> np.ndarray:
        """Stack same-shaped samples and pad the batch dim up to bucket_b."""
        out = np.full((bucket_b,) + samples[0].shape, self.pad_value,
                      dtype=samples[0].dtype)
        for i, s in enumerate(samples):
            out[i] = s
        return out

    def warm_shapes(self, sample_shapes: List[Tuple[int, ...]]):
        """Every (batch_bucket, per-sample shapes) combination to AOT-warm.

        ``sample_shapes`` may contain ``None`` dims (variable); each distinct
        seq bucket instantiates them (all variable dims of one request share
        a bucket — the LM convention where ids/masks ride the same length).
        Yields (batch_bucket, tuple_of_concrete_sample_shapes).
        """
        has_var = any(d is None for shape in sample_shapes for d in shape)
        seq_choices = self.seq_lens if (has_var and self.seq_lens) else (None,)
        if has_var and not self.seq_lens:
            raise ValueError(
                "inputs have variable dims but BucketSpec declares no "
                "seq_lens")
        for bb in self.batch_sizes:
            for sl in seq_choices:
                concrete = tuple(
                    tuple(sl if d is None else d for d in shape)
                    for shape in sample_shapes)
                yield bb, concrete

    def __repr__(self):
        return (f"BucketSpec(batch_sizes={self.batch_sizes}, "
                f"seq_lens={self.seq_lens}, seq_axis={self.seq_axis})")
