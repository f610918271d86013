"""The ``resilience`` counters (port of
``paddle_tpu/distributed/resilience/metrics.py``): one plain dict of named
counters under a lock, read by ``get``. The JAX package
keeps them as a labeled family of its observability hub, which the port
does not have yet; the names are the same (``injected_faults`` …).
Telemetry must never mask the event it records, so a write never raises.
"""
from __future__ import annotations

import threading
from typing import Dict

__all__ = ["inc", "get"]

_COUNTS: Dict[str, float] = {}
_LOCK = threading.Lock()


def inc(metric: str, n: float = 1) -> None:
    with _LOCK:
        _COUNTS[metric] = _COUNTS.get(metric, 0) + n


def get(metric: str) -> float:
    with _LOCK:
        return _COUNTS.get(metric, 0.0)
