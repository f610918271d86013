"""Serving-engine scaffolding (port of ``paddle_tpu/serving/base.py``):
the request exceptions, and the lifecycle every engine shares — a bounded
admission queue under a condition variable, one daemon worker thread,
``start``/``close``/``fence``/``health``/``cancel`` and the context
manager, and the fault injector the engines' chaos sites consult.
Lock-order witnessing, the flight recorder, the request tracer,
the OOM guard and the retrace auditor wait for the observability slice;
where the JAX engines call them, the port calls nothing.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, Optional

from .metrics import MetricsRegistry

__all__ = ["EngineBase", "QueueFull", "DeadlineExceeded", "EngineClosed",
           "BadRequest", "ReplicaFault", "RequestCancelled"]


def _injector():
    """The process-wide fault injector (``PT_FAULTS``): the engines' chaos
    sites (``batch_fault``, ``decode_fault``) consult it."""
    from ..distributed.resilience.faults import injector

    return injector()


class QueueFull(RuntimeError):
    """Admission control: the bounded request queue is at capacity."""


class EngineClosed(RuntimeError):
    """The engine is shut down; no further submissions."""


class BadRequest(ValueError):
    """Payload rejected by validation (shape/dtype/rank/length)."""


class DeadlineExceeded(TimeoutError):
    """The request expired before execution and was shed."""


class ReplicaFault(EngineClosed):
    """The replica itself failed (crash, lost connection, hung heartbeat)
    — the REPLICA-fault shape the router fences on, as opposed to
    request-scoped errors (``BadRequest``/``DeadlineExceeded``) that must
    leave a healthy replica in the candidate set."""


class RequestCancelled(RuntimeError):
    """The request was cancelled before completion."""


class EngineBase:
    """Queue + condition + worker-thread lifecycle. Subclasses implement
    ``_worker`` (the loop) and may override ``_on_start`` (e.g. warm-up).
    Requests must carry a ``.future``."""

    _close_timeout = 30.0

    def __init__(self, name: str, qps_window_s: float = 30.0):
        self.name = name
        self.metrics = MetricsRegistry(qps_window_s=qps_window_s)
        self.metrics.gauge("queue_depth", self.queue_depth)
        self._queue: deque = deque()
        self._cond = threading.Condition(threading.Lock())
        self._start_lock = threading.Lock()
        self._closed = False
        self._fenced = False
        self._thread: Optional[threading.Thread] = None
        # the weight generation this engine serves: 0 = the weights it was
        # built with, bumped by swap_weights()
        self.weight_version = 0

    def _on_start(self) -> None:
        pass

    def _worker(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def start(self):
        with self._start_lock:  # concurrent submits race the auto-start
            if self._thread is not None:
                return self
            self._on_start()
            self._thread = threading.Thread(target=self._worker,
                                            name=f"pt-serving-{self.name}",
                                            daemon=True)
            self._thread.start()
        return self

    def close(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop the worker. ``drain=True`` serves what is already queued;
        ``drain=False`` fails queued requests with ``EngineClosed``."""
        with self._cond:
            self._closed = True
            if not drain:
                while self._queue:
                    r = self._queue.popleft()
                    if not r.future.done():
                        r.future.set_exception(EngineClosed("engine closed"))
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=self._close_timeout
                              if timeout is None else timeout)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False

    def swap_weights(self, state, version: Optional[int] = None,
                     timeout: Optional[float] = None) -> int:
        """Replace the served weights between batches; returns the new
        ``weight_version``. Engines that can swap implement it; the base
        refuses."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support in-place weight swap")

    def fence(self) -> None:
        """Stop admitting NEW work while queued and in-flight requests run
        to completion."""
        with self._cond:
            self._fenced = True

    def unfence(self) -> None:
        with self._cond:
            self._fenced = False

    def health(self) -> bool:
        """Liveness probe (router re-admission): the engine accepts work
        and its worker loop (if started) is still running."""
        if self._closed or self._fenced:
            return False
        t = self._thread
        return t is None or t.is_alive()

    def cancel(self, future) -> bool:
        """Dequeue the request owning ``future`` before it executes (its
        future fails with ``RequestCancelled``). Returns False when the
        request already left the queue — an executing request runs to
        completion and the caller discards the result."""
        req = None
        with self._cond:
            for r in self._queue:
                if r.future is future:
                    self._queue.remove(r)
                    req = r
                    break
        if req is None:
            return False
        if not req.future.done():
            req.future.set_exception(RequestCancelled("request cancelled"))
        self.metrics.inc("cancelled_total")
        return True

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def _enqueue(self, req, max_queue: int) -> None:
        """Bounded-queue admission (raises ``EngineClosed``/``QueueFull``);
        auto-starts the worker on first use."""
        with self._cond:
            if self._closed:
                raise EngineClosed("engine closed")
            if self._fenced:
                raise EngineClosed("engine fenced (draining)")
            if len(self._queue) >= max_queue:
                self.metrics.inc("rejected_total")
                raise QueueFull(f"queue at capacity ({max_queue})")
            self._queue.append(req)
            self._cond.notify()
        if self._thread is None:
            self.start()

    def _stats_base(self) -> Dict[str, Any]:
        snap = self.metrics.snapshot()
        snap["name"] = self.name
        snap["weight_version"] = self.weight_version
        return snap
