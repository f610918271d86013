"""Per-engine counters and latency windows.

A copy of ``LatencyWindow`` and ``MetricsRegistry`` from
``paddle_tpu/observability/registry.py``, trimmed to what the engine's
``stats()`` reads: the process-wide hub, families and histograms wait for
the observability slice.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict

import numpy as np

__all__ = ["LatencyWindow", "MetricsRegistry"]


class LatencyWindow:
    """Ring buffer of the most recent latencies (ms); percentiles on read."""

    def __init__(self, capacity: int = 8192):
        self._buf = np.zeros(capacity, dtype=np.float64)
        self._capacity = capacity
        self._count = 0      # filled entries (<= capacity)
        self._idx = 0

    def observe(self, ms: float) -> None:
        self._buf[self._idx] = ms
        self._idx = (self._idx + 1) % self._capacity
        self._count = min(self._count + 1, self._capacity)

    def percentiles(self, qs=(50, 95, 99)) -> Dict[str, float]:
        if self._count == 0:
            return {f"p{q}": 0.0 for q in qs}
        vals = np.percentile(self._buf[: self._count], qs)
        return {f"p{q}": round(float(v), 3) for q, v in zip(qs, vals)}


class MetricsRegistry:
    """Thread-safe registry for one engine.

    - ``inc(name, n)``: monotonic counters (requests, tokens, decode ms...)
    - ``observe_latency(ms)``: end-to-end request latency (submit -> result)
    - ``observe_queue_wait(ms)``: submit -> slot join
    - ``observe_occupancy(frac)``: active slots / slots per decode step
    - ``mark_done()``: completion timestamp feeding the sliding-window QPS
    - ``gauge(name, fn)``: live values sampled at snapshot time
    """

    def __init__(self, qps_window_s: float = 30.0,
                 latency_capacity: int = 8192):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._latency = LatencyWindow(latency_capacity)
        self._queue_wait = LatencyWindow(latency_capacity)
        self._occ_sum = 0.0
        self._occ_n = 0
        self._qps_window_s = qps_window_s
        self._done_ts: deque = deque()
        self._gauges: Dict[str, Callable[[], object]] = {}
        self._t0 = time.monotonic()

    def inc(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def observe_latency(self, ms: float) -> None:
        with self._lock:
            self._latency.observe(ms)

    def observe_queue_wait(self, ms: float) -> None:
        with self._lock:
            self._queue_wait.observe(ms)

    def observe_occupancy(self, frac: float) -> None:
        with self._lock:
            self._occ_sum += frac
            self._occ_n += 1

    def mark_done(self, n: int = 1) -> None:
        now = time.monotonic()
        with self._lock:
            for _ in range(n):
                self._done_ts.append(now)
            self._prune_locked(now)

    def gauge(self, name: str, fn: Callable[[], object]) -> None:
        with self._lock:
            self._gauges[name] = fn

    def _prune_locked(self, now: float) -> None:
        horizon = now - self._qps_window_s
        while self._done_ts and self._done_ts[0] < horizon:
            self._done_ts.popleft()

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0)

    def snapshot(self) -> Dict:
        """One coherent stats dict: QPS, latency percentiles (ms), batch
        occupancy, counters, live gauges."""
        now = time.monotonic()
        with self._lock:
            self._prune_locked(now)
            span = min(self._qps_window_s, max(now - self._t0, 1e-6))
            snap = {
                "qps": round(len(self._done_ts) / span, 3),
                "latency_ms": self._latency.percentiles(),
                "queue_wait_ms": self._queue_wait.percentiles(),
                "batch_occupancy": round(self._occ_sum / self._occ_n, 4)
                if self._occ_n else 0.0,
                "counters": dict(self._counters),
            }
            gauges = dict(self._gauges)
        # sampled outside the lock: a gauge may take the engine lock
        for name, fn in gauges.items():
            try:
                snap[name] = fn()
            except Exception as e:  # a broken gauge must not sink stats()
                snap[name] = f"error: {type(e).__name__}: {e}"
        return snap
