"""The batching inference engine (port of ``paddle_tpu/serving/engine.py``).

Requests enter a thread-safe bounded queue, a micro-batcher coalesces them
into padded batches along pre-declared shape buckets (``BucketSpec``), and
one worker loop runs them. The JAX package keeps one warmed executable per
bucket; here one runner serves every bucket, and ``warmup`` runs it once at
each declared (batch bucket, input key) shape. A batch at a shape no warm-up
touched counts a ``compile_cache_misses`` (the JAX name), so steady-state
traffic is seen to stay on the warmed shapes.

Robustness contract:
- bounded queue with backpressure (``QueueFull`` raised at submit);
- per-request deadline: requests that expire while queued are shed with
  ``DeadlineExceeded`` before spending device time;
- per-request error isolation: a malformed payload fails ITS OWN future at
  submit; an execution fault fails only the requests of that batch.

Observability: a ``MetricsRegistry`` snapshot (QPS, p50/p95/p99 latency,
batch occupancy, queue depth, warmed-shape hits/misses) via ``stats()``.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .base import (BadRequest, DeadlineExceeded, EngineBase, EngineClosed,
                   QueueFull, _injector)
from .buckets import BucketSpec

__all__ = ["ServingConfig", "ServingEngine", "QueueFull", "DeadlineExceeded",
           "EngineClosed", "BadRequest"]


@dataclass
class ServingConfig:
    """Engine knobs."""

    max_queue: int = 256            # admission bound (backpressure beyond)
    max_batch_wait_ms: float = 2.0  # micro-batcher coalescing window
    default_deadline_ms: Optional[float] = None   # None = no deadline
    warmup_on_start: bool = True    # build every bucket's runner first
    qps_window_s: float = 30.0      # sliding window for the QPS gauge


class _Request:
    __slots__ = ("arrays", "key", "future", "t_submit", "deadline")

    def __init__(self, arrays, key, future, t_submit, deadline):
        self.arrays = arrays
        self.key = key
        self.future = future
        self.t_submit = t_submit
        self.deadline = deadline


_ENGINE_NO = itertools.count(1)


def _np_dtype(dt: str) -> np.dtype:
    if dt == "bfloat16":
        # numpy has no bf16 without a package the port does not use
        raise ValueError("bfloat16 inputs are not served: submit float32 "
                         "and cast inside the target")
    return np.dtype(dt)


def _spec_tuple(spec) -> Tuple[Tuple, str]:
    """Normalize an input spec to (per-sample shape with None dims, dtype)."""
    if hasattr(spec, "shape") and hasattr(spec, "dtype"):  # spec/array
        shape, dtype = spec.shape, spec.dtype
    else:
        shape, dtype = spec
    shape = tuple(None if (d is None or (isinstance(d, int) and d < 0))
                  else int(d) for d in shape)
    name = str(dtype).replace("torch.", "")
    return shape, str(_np_dtype(name))


def _leaves(out) -> List[Any]:
    """The output's leaves in the JAX package's pytree order (lists and
    tuples in order, dicts by sorted key)."""
    if isinstance(out, dict):
        return [x for k in sorted(out) for x in _leaves(out[k])]
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _to_numpy(x) -> np.ndarray:
    """A runner output on the host; bf16 (which numpy lacks) as fp32."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype is torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class ServingEngine(EngineBase):
    """Coalescing batch server over an ``nn.Module`` or a callable on
    tensors.

    ::

        eng = ServingEngine(fn, buckets=BucketSpec((1, 2, 4, 8)),
                            input_specs=[((None,), "int64")])
        eng.start()
        fut = eng.submit([sample])        # per-sample arrays, NO batch dim
        outs = fut.result()               # per-sample outputs, batch dim off
        eng.stats()                       # QPS / latency / occupancy / ...
        eng.close()

    ``target``:
    - ``nn.Module``: served in eval mode under ``no_grad`` on the device of
      its parameters, which must be ``device`` (``None`` = CUDA);
    - callable ``fn(*tensors) -> tensor(s)``: called on tensors on
      ``device``.
    Outputs come back as numpy arrays (bf16 ones as fp32). Pass
    ``input_specs``: per-sample shapes (``None`` marks the variable/seq
    dim) + dtypes, e.g. ``[((None,), "int64")]``, or example arrays. An
    ``inference.Predictor`` target and a target's own
    ``build_serving_runner`` need modules the port has not got yet and are
    refused with ``TypeError``.
    """

    def __init__(self, target, buckets: BucketSpec,
                 input_specs: Optional[Sequence] = None,
                 config: Optional[ServingConfig] = None,
                 name: Optional[str] = None, device=None):
        self.buckets = buckets
        self.config = config or ServingConfig()
        super().__init__(name or f"engine#{next(_ENGINE_NO)}",
                         qps_window_s=self.config.qps_window_s)
        self.device = resolve_device(device)
        self._specs = self._resolve_specs(target, input_specs)
        for shape, _dt in self._specs:
            for ax, d in enumerate(shape):
                if d is None and ax != buckets.seq_axis:
                    raise ValueError(
                        f"variable dim at per-sample axis {ax} but "
                        f"BucketSpec.seq_axis={buckets.seq_axis}; only the "
                        "declared seq axis may vary")
        self._runner = self._make_runner(target)
        self._warm: Set[Tuple] = set()  # (batch bucket, key) shapes run

    # -- target plumbing ------------------------------------------------------
    @staticmethod
    def _resolve_specs(target, input_specs):
        if input_specs is None:
            if getattr(target, "get_input_specs", None) is not None:
                raise TypeError(
                    "an inference.Predictor target needs the port's "
                    "inference module, which is not ported yet")
            raise ValueError(
                "input_specs required for Module/callable targets "
                "(per-sample shapes + dtypes; None marks the seq dim)")
        return [_spec_tuple(s) for s in input_specs]

    def _make_runner(self, target):
        """Return runner(list_of_np) -> list_of_np."""
        if getattr(target, "build_serving_runner", None) is not None:
            raise TypeError(
                "a target with build_serving_runner (an engine-native "
                "target such as sparse.EmbeddingLookupTarget) needs the "
                "port's sparse module, which is not ported yet")
        if getattr(target, "_layer", None) is not None and \
                hasattr(target, "run"):
            raise TypeError(
                "an inference.Predictor target needs the port's inference "
                "module, which is not ported yet")
        dev = self.device
        if isinstance(target, torch.nn.Module):
            target.eval()  # serve inference semantics (dropout off)
            p = next(target.parameters(), None)
            if p is not None and (p.device.type != dev.type or (
                    dev.index is not None and p.device.index != dev.index)):
                raise ValueError(f"module weights on {p.device}, engine "
                                 f"device {dev}")
        elif not callable(target):
            raise TypeError(f"cannot serve target of type {type(target)!r}")

        @torch.no_grad()
        def runner(np_inputs):
            out = target(*[torch.from_numpy(a).to(dev) for a in np_inputs])
            return [_to_numpy(x) for x in _leaves(out)]
        return runner

    # -- lifecycle ------------------------------------------------------------
    def _on_start(self):
        """Warm every declared bucket before the worker serves traffic."""
        if self.config.warmup_on_start:
            self.warmup()

    def _dummies(self, bb, key, pad_value):
        return [np.full((bb,) + shp, pad_value, dtype=_np_dtype(dt))
                for (dt, shp) in key]

    def warmup(self):
        """Run the runner once at every (batch bucket, seq bucket) shape,
        so steady-state traffic meets no shape for the first time."""
        shapes = [shape for shape, _dt in self._specs]
        for bb, concrete in self.buckets.warm_shapes(shapes):
            key = tuple((dt, shp) for (_s, dt), shp
                        in zip(self._specs, concrete))
            if (bb, key) in self._warm:
                continue
            self._runner(self._dummies(bb, key, self.buckets.pad_value))
            self._warm.add((bb, key))
            self.metrics.inc("warmup_compiles")
        return self

    def respec(self, buckets: BucketSpec) -> "ServingEngine":
        """Swap the bucket spec LIVE: every shape the new spec can route
        to is run BEFORE the swap, outside the engine lock, then the spec
        reference flips under the lock at a batch boundary.

        In-flight requests were padded under the OLD spec, so the warm set
        also covers (new batch bucket x already-seen key). Old shapes stay
        warm."""
        shapes = [shape for shape, _dt in self._specs]
        fresh: Set[Tuple] = set()

        def warm(bb, key):
            if (bb, key) in self._warm or (bb, key) in fresh:
                return
            self._runner(self._dummies(bb, key, buckets.pad_value))
            fresh.add((bb, key))
            self.metrics.inc("respec_compiles")

        for bb, concrete in buckets.warm_shapes(shapes):
            warm(bb, tuple((dt, shp) for (_s, dt), shp
                           in zip(self._specs, concrete)))
        for _bb, key in list(self._warm):
            for bb in buckets.batch_sizes:
                warm(bb, key)
        with self._cond:
            self._warm |= fresh
            self.buckets = buckets
        self.metrics.inc("respecs")
        return self

    # -- submission -----------------------------------------------------------
    def submit(self, inputs: Sequence,
               deadline_ms: Optional[float] = None) -> "Future":
        """Enqueue one request (per-sample arrays, no batch dim); returns a
        future resolving to the per-sample outputs (batch dim stripped).

        A malformed payload fails the returned future (never the batch); a
        full queue raises ``QueueFull`` synchronously — backpressure the
        caller must see."""
        self.metrics.inc("requests_total")
        fut: Future = Future()
        t_submit = time.monotonic()
        try:
            arrays, key = self._validate(inputs)
        except BadRequest as e:
            self.metrics.inc("errors_total")
            self.metrics.inc("bad_requests")
            fut.set_exception(e)
            return fut
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        deadline = None if deadline_ms is None \
            else t_submit + deadline_ms / 1000.0
        self._enqueue(_Request(arrays, key, fut, t_submit, deadline),
                      self.config.max_queue)
        return fut

    def _validate(self, inputs) -> Tuple[List[np.ndarray], Tuple]:
        if not isinstance(inputs, (list, tuple)) or \
                len(inputs) != len(self._specs):
            raise BadRequest(
                f"expected {len(self._specs)} input arrays, got "
                f"{len(inputs) if isinstance(inputs, (list, tuple)) else type(inputs)!r}")
        arrays, key = [], []
        for i, (a, (shape, dt)) in enumerate(zip(inputs, self._specs)):
            a = np.asarray(a)
            if str(a.dtype) != dt:
                raise BadRequest(
                    f"input {i}: dtype {a.dtype} != expected {dt}")
            if a.ndim != len(shape):
                raise BadRequest(
                    f"input {i}: rank {a.ndim} != expected {len(shape)} "
                    "(submit per-sample arrays without the batch dim)")
            for ax, d in enumerate(shape):
                if d is not None and a.shape[ax] != d:
                    raise BadRequest(
                        f"input {i}: dim {ax} is {a.shape[ax]}, expected {d}")
            if any(d is None for d in shape):  # only declared-variable dims
                try:                           # ride the seq buckets
                    a = self.buckets.pad_sample_seq(a)
                except ValueError as e:
                    raise BadRequest(str(e))
            arrays.append(np.ascontiguousarray(a))
            key.append((dt, a.shape))
        return arrays, tuple(key)

    # -- worker ---------------------------------------------------------------
    def _fail(self, req: _Request, exc: Exception):
        if not req.future.done():
            req.future.set_exception(exc)

    def _shed_expired_locked(self, now: Optional[float] = None) -> None:
        if now is None:
            now = time.monotonic()
        keep = deque()
        for r in self._queue:
            if r.deadline is not None and now > r.deadline:
                self.metrics.inc("shed_total")
                self._fail(r, DeadlineExceeded(
                    "deadline expired while queued"))
            else:
                keep.append(r)
        self._queue = keep

    def _collect_matching_locked(self, batch, key, limit):
        keep = deque()
        now = time.monotonic()
        for r in self._queue:
            if len(batch) < limit and r.key == key:
                if r.deadline is not None and now > r.deadline:
                    self.metrics.inc("shed_total")
                    self._fail(r, DeadlineExceeded(
                        "deadline expired while queued"))
                else:
                    batch.append(r)
            else:
                keep.append(r)
        self._queue = keep

    def _next_batch(self):
        cfg = self.config
        with self._cond:
            while True:
                self._shed_expired_locked()
                if self._queue:
                    break
                if self._closed:
                    return None
                # untimed: submit/close notify, and an empty queue has no
                # deadlines to shed — no idle polling
                self._cond.wait()
            seed = self._queue.popleft()
            batch = [seed]
            key = seed.key
            limit = self.buckets.max_batch
            t_close = time.monotonic() + cfg.max_batch_wait_ms / 1000.0
            while len(batch) < limit:
                self._collect_matching_locked(batch, key, limit)
                if len(batch) >= limit:
                    break
                rem = t_close - time.monotonic()
                if rem <= 0 or (self._closed and not self._queue):
                    break
                self._cond.wait(rem)
            return batch, key

    def _worker(self):
        while True:
            item = self._next_batch()
            if item is None:
                return
            batch, key = item
            try:
                self._execute(batch, key)
            except Exception as e:  # never kill the loop: fail the batch
                for r in batch:
                    self._fail(r, e)
                self.metrics.inc("errors_total", len(batch))
                self.metrics.inc("batch_failures")

    def _execute(self, batch: List[_Request], key: Tuple):
        # last deadline check: a request may have expired while the batch
        # coalesced — shed it now rather than spend device time on it
        now = time.monotonic()
        live = []
        for r in batch:
            if r.deadline is not None and now > r.deadline:
                self.metrics.inc("shed_total")
                self._fail(r, DeadlineExceeded(
                    "deadline expired before execution"))
            else:
                live.append(r)
        batch = live
        if not batch:
            return
        bucket_b = self.buckets.batch_bucket(len(batch))
        if (bucket_b, key) in self._warm:
            self.metrics.inc("compile_cache_hits")
        else:
            self.metrics.inc("compile_cache_misses")
            self._warm.add((bucket_b, key))
        n = len(batch)
        inputs = [self.buckets.stack_batch([r.arrays[i] for r in batch],
                                           bucket_b)
                  for i in range(len(self._specs))]
        t_exec = time.monotonic()
        for r in batch:
            self.metrics.observe_queue_wait((t_exec - r.t_submit) * 1e3)
        # chaos site: a scripted batch fault at an exact executed-batch
        # index (PT_FAULTS="batch_fault@batch=3") — only THIS batch's
        # futures fail, the queue keeps draining
        self._batch_no = getattr(self, "_batch_no", -1) + 1
        _injector().check("batch_fault", engine=self.name,
                          batch=self._batch_no)
        outs = self._runner(inputs)
        t_done = time.monotonic()
        for i, r in enumerate(batch):
            if not r.future.done():
                r.future.set_result([o[i] for o in outs])
            self.metrics.observe_latency((t_done - r.t_submit) * 1e3)
        self.metrics.inc("responses_total", n)
        self.metrics.inc("batches_total")
        self.metrics.inc("execute_ms_total", (t_done - t_exec) * 1e3)
        self.metrics.observe_occupancy(n / bucket_b)
        self.metrics.mark_done(n)

    # -- observability --------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """One snapshot: QPS, latency percentiles, occupancy, counters,
        queue depth and the shapes warmed."""
        snap = self._stats_base()
        snap["buckets"] = repr(self.buckets)
        snap["warmed_executables"] = len(self._warm)
        return snap
