"""Serving-engine scaffolding (port of ``paddle_tpu/serving/base.py``):
the request exceptions, and the lifecycle every engine shares — a bounded
admission queue under a condition variable, one daemon worker thread,
``start``/``close`` and the context manager. Lock-order witnessing, the
flight recorder, the request tracer and the OOM guard wait for the
observability slice.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, Optional

from .metrics import MetricsRegistry

__all__ = ["EngineBase", "QueueFull", "DeadlineExceeded", "EngineClosed",
           "BadRequest"]


class QueueFull(RuntimeError):
    """Admission control: the bounded request queue is at capacity."""


class EngineClosed(RuntimeError):
    """The engine is shut down; no further submissions."""


class BadRequest(ValueError):
    """Payload rejected by validation (shape/dtype/rank/length)."""


class DeadlineExceeded(TimeoutError):
    """The request expired before execution and was shed."""


class EngineBase:
    """Queue + condition + worker-thread lifecycle. Subclasses implement
    ``_worker`` (the loop). Requests must carry a ``.future``."""

    _close_timeout = 30.0

    def __init__(self, name: str, qps_window_s: float = 30.0):
        self.name = name
        self.metrics = MetricsRegistry(qps_window_s=qps_window_s)
        self.metrics.gauge("queue_depth", self.queue_depth)
        self._queue: deque = deque()
        self._cond = threading.Condition(threading.Lock())
        self._start_lock = threading.Lock()
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    def _worker(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def start(self):
        with self._start_lock:  # concurrent submits race the auto-start
            if self._thread is not None:
                return self
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

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def _enqueue(self, req, max_queue: int) -> None:
        """Bounded-queue admission (raises ``EngineClosed``/``QueueFull``);
        auto-starts the worker on first use."""
        with self._cond:
            if self._closed:
                raise EngineClosed("engine closed")
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
        return snap
