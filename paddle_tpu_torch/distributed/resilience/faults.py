"""Deterministic fault injection (port of
``paddle_tpu/distributed/resilience/faults.py``).

Scripted faults fire at exact sites, matched by integer/string ids —
never by randomness — so a failing chaos test replays bit-identically.

Arming:

- programmatically: ``injector().arm("batch_fault", batch=3)`` or the
  ``with inject("decode_fault", step=1): ...`` context manager;
- by env: ``PT_FAULTS="batch_fault@batch=3&times=2,decode_fault@step=1"``
  — parsed once at first use, so a *subprocess* under test can be faulted
  without code changes.

Sites consult ``check(kind, **ids)`` (raises ``InjectedFault``, sleeps, or
``os._exit``\\ s, per the rule) or ``peek(kind, **ids)`` (consumes the rule
and returns True — for faults the site must *produce* rather than raise).
An unmatched call is a few dict reads.

Kinds wired in the port: ``batch_fault`` (``ServingEngine``, per executed
batch), ``decode_fault`` (``GenerationEngine``, per decode round), and the
serving-replica kinds of ``serving/fleet.py``'s replica worker:

- ``replica_crash@name=NAME&seq=N[&inc=I]`` — hard ``os._exit`` of the
  named replica process at its N-th submitted request; pin ``inc=0`` so
  the rule fires in the first incarnation only — a RESTARTED worker
  re-parses ``PT_FAULTS`` and walks ``seq`` from 1 again;
- ``replica_hang@name=NAME&seq=N[&inc=I]`` — wedges the replica's serve
  loop at its N-th submit, so heartbeats stop and the supervisor must
  fence it within the grace window;
- ``replica_slow@name=NAME&ms=MS&times=-1`` — per-request slowdown on one
  replica (the hedging trigger).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Optional

from . import metrics

__all__ = ["InjectedFault", "FaultInjector", "injector", "inject"]


class InjectedFault(RuntimeError):
    """A scripted failure. ``transient=True`` marks it retryable — the
    bounded retry-with-backoff in the checkpoint/offload lanes will eat
    it if the rule stops firing within the retry budget."""

    def __init__(self, kind: str, ids: Dict, transient: bool = True):
        self.kind = kind
        self.ids = dict(ids)
        self.transient = bool(transient)
        super().__init__(f"injected fault: {kind} @ {self.ids}")


class _Rule:
    __slots__ = ("kind", "match", "times", "transient", "exit_code",
                 "sleep_ms")

    def __init__(self, kind, match, times=1, transient=True, exit_code=None,
                 sleep_ms=None):
        self.kind = kind
        self.match = {k: str(v) for k, v in match.items()}
        self.times = int(times)  # -1 = unlimited
        self.transient = bool(transient)
        self.exit_code = exit_code
        self.sleep_ms = sleep_ms


class FaultInjector:
    """Rule table + fire counters. Thread-safe: lane worker threads and
    the checkpoint writer consult it concurrently."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: List[_Rule] = []
        self._fired: Dict[str, int] = {}

    # -- arming ---------------------------------------------------------------
    def arm(self, kind: str, times: int = 1, transient: bool = True,
            exit_code: Optional[int] = None, sleep_ms: Optional[float] = None,
            **match) -> _Rule:
        """Fire ``kind`` for the next ``times`` site calls whose ids match
        every ``match`` key (ids the site does not pass are ignored only if
        not in ``match``). ``exit_code`` turns the fault into a hard process
        death (``os._exit``); ``sleep_ms`` into a slowdown instead of an
        error."""
        rule = _Rule(kind, match, times=times, transient=transient,
                     exit_code=exit_code, sleep_ms=sleep_ms)
        with self._lock:
            self._rules.append(rule)
        return rule

    def disarm(self, rule: _Rule) -> None:
        with self._lock:
            if rule in self._rules:
                self._rules.remove(rule)

    def clear(self) -> None:
        with self._lock:
            self._rules = []
            self._fired = {}

    def fired(self, kind: str) -> int:
        with self._lock:
            return self._fired.get(kind, 0)

    # -- sites ----------------------------------------------------------------
    def _take(self, kind: str, ids: Dict) -> Optional[_Rule]:
        if not self._rules:  # lock-free: unarmed injector costs a dict read
            return None
        with self._lock:
            if not self._rules:
                return None
            for rule in self._rules:
                if rule.kind != kind or rule.times == 0:
                    continue
                if any(str(ids.get(k)) != v for k, v in rule.match.items()):
                    continue
                if rule.times > 0:
                    rule.times -= 1
                self._fired[kind] = self._fired.get(kind, 0) + 1
                return rule
        return None

    def check(self, kind: str, /, **ids) -> None:
        """Site hook: no-op unless an armed rule matches; then sleep
        (``sleep_ms`` rules), die (``exit_code`` rules) or raise
        ``InjectedFault``."""
        rule = self._take(kind, ids)
        if rule is None:
            return
        metrics.inc("injected_faults")
        if rule.sleep_ms is not None:
            time.sleep(rule.sleep_ms / 1e3)
            return
        if rule.exit_code is not None:
            os._exit(int(rule.exit_code))  # a crash does not unwind
        raise InjectedFault(kind, ids, transient=rule.transient)

    def peek(self, kind: str, /, **ids) -> bool:
        """Site hook for faults the *site* must produce (a NaN loss, a
        corrupted value): consumes a matching rule and returns True."""
        rule = self._take(kind, ids)
        if rule is None:
            return False
        metrics.inc("injected_faults")
        return True


_INJECTOR: Optional[FaultInjector] = None
_INJECTOR_LOCK = threading.Lock()


def _parse_env(spec: str, inj: FaultInjector) -> None:
    """``kind@k=v&k=v&times=N&exit=CODE&ms=MS[,kind2@...]``; a malformed
    entry is skipped (chaos config must never sink a training run)."""
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            kind, _, rest = part.partition("@")
            kw: Dict = {"times": 1}
            match: Dict = {}
            for pair in filter(None, rest.split("&")):
                k, _, v = pair.partition("=")
                if k == "times":
                    kw["times"] = int(v)
                elif k == "exit":
                    kw["exit_code"] = int(v)
                elif k == "ms":
                    kw["sleep_ms"] = float(v)
                elif k == "transient":
                    kw["transient"] = v not in ("0", "false")
                else:
                    match[k] = v
            inj.arm(kind.strip(), **kw, **match)
        except (ValueError, TypeError):
            import warnings

            warnings.warn(f"PT_FAULTS: skipping malformed rule {part!r}",
                          stacklevel=2)


def injector() -> FaultInjector:
    """The process-wide injector (env rules from ``PT_FAULTS`` armed on
    first use)."""
    global _INJECTOR
    inj = _INJECTOR  # lock-free hot path: sites call this per batch/transfer
    if inj is not None:
        return inj
    with _INJECTOR_LOCK:
        if _INJECTOR is None:
            inj = FaultInjector()
            spec = os.environ.get("PT_FAULTS", "").strip()
            if spec:
                _parse_env(spec, inj)
            _INJECTOR = inj  # publish only after the env rules are armed
    return _INJECTOR


@contextlib.contextmanager
def inject(kind: str, **kwargs):
    """Scoped arming for tests: rule armed on entry, disarmed on exit."""
    inj = injector()
    rule = inj.arm(kind, **kwargs)
    try:
        yield inj
    finally:
        inj.disarm(rule)
