"""Load-aware multi-replica router (port of ``paddle_tpu/serving/router.py``):
N ``GenerationEngine`` replicas in one process behind ONE
admission-controlled ``ReplicaRouter``:

- **admission control**: a fleet-wide in-flight bound plus per-tenant
  in-flight quotas (``TenantQuotaExceeded`` — a ``QueueFull`` subclass, so
  existing backpressure handling applies);
- **load-aware dispatch**: each submit scores every healthy replica from
  its real state — queue depth, KV-page headroom and the p95 of its recent
  request latencies — and picks the cheapest;
- **prefix affinity**: a prompt whose leading page-blocks are already in
  some replica's prefix cache is steered there, unless that replica is
  overloaded — affinity is a bounded bonus, not a hard pin;
- **fault routing**: a replica whose submit raises ``EngineClosed`` (or
  dies outright) is marked down and traffic re-dispatches to survivors.

``score_candidates`` and ``classify_submit_error`` are the policy a
multi-process fleet shares.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .base import (BadRequest, DeadlineExceeded, EngineClosed, QueueFull,
                   ReplicaFault)
from .generation import GenerationEngine
from .paged_kv import token_blocks

__all__ = ["RouterConfig", "ReplicaRouter", "TenantQuotaExceeded",
           "classify_submit_error", "score_candidates"]


class TenantQuotaExceeded(QueueFull):
    """The tenant's in-flight quota is exhausted (admission control)."""


def classify_submit_error(e: BaseException) -> str:
    """What a replica's ``submit`` raising ``e`` means for FENCING:

    - ``"busy"``: backpressure (``QueueFull``) — try the next candidate,
      the replica is healthy;
    - ``"request"``: the REQUEST is at fault (malformed payload, expired
      deadline, unexpected programming error) — surface it to the caller
      and leave the replica in the candidate set;
    - ``"fault"``: the REPLICA is at fault (closed, lost RPC connection,
      dead process) — fence it and re-dispatch through the survivors.

    Order matters: ``DeadlineExceeded`` IS a ``TimeoutError`` which IS an
    ``OSError`` in py3, so request shapes are matched before the
    connection-error shapes. Unknown exceptions default to ``"request"``
    — fencing a healthy replica on every stray bug starves the fleet one
    exception at a time."""
    if isinstance(e, QueueFull):
        return "busy"
    if isinstance(e, (BadRequest, DeadlineExceeded)):
        return "request"
    if isinstance(e, (EngineClosed, ReplicaFault, ConnectionError,
                      BrokenPipeError, OSError)):
        return "fault"
    return "request"


def score_candidates(cfg: "RouterConfig", prompt,
                     candidates: Sequence[Any],
                     pool: Optional[str] = None
                     ) -> Tuple[List[float], List[int]]:
    """(score, matched-prefix-tokens) per candidate, lower score wins —
    the load/affinity dispatch policy shared by ``ReplicaRouter`` (thread
    replicas) and ``ServingFleet`` (process replicas). The prefix match
    is probed ONCE here and reused for the affinity accounting — a
    post-submit probe would count the request's own just-inserted blocks
    as a hit.

    ``pool`` specializes the formula for a disaggregated fleet:
    ``"prefill"`` replicas are picked for the compute-bound first leg —
    queue depth dominates (a deep queue head-of-line-blocks the whole
    prefill) and KV pressure barely matters (pages are shipped out
    right after); ``"decode"`` replicas are picked for where the pages
    LAND — KV headroom and prefix/page affinity dominate (the request
    lives there for its whole decode). ``None`` keeps the classic fused
    weighting."""
    p = max(len(prompt), 1)
    # the prefix-match probe runs FIRST: for an RPC-backed replica it
    # is the combined probe whose reply also carries queue depth /
    # headroom / p95, so the reads below are cache hits — one round
    # trip per candidate, not four. Token-block chains are built ONCE
    # per page size, not once per replica — for an in-process engine
    # the probe is then just a trie walk.
    blk_cache: Dict[int, Any] = {}
    matches = []
    for r in candidates:
        pl = getattr(getattr(r, "config", None), "page_len", None)
        if pl is None:
            matches.append(r.prefix_match_tokens(prompt))
            continue
        if pl not in blk_cache:
            blk_cache[pl] = token_blocks(prompt, pl,
                                         limit=(len(prompt) - 1) // pl)
        matches.append(r.prefix_match_tokens(prompt, blocks=blk_cache[pl]))
    depths = [r.queue_depth() for r in candidates]
    p95s = [r.metrics.latency_percentile(95) for r in candidates]
    p95_hi = max(max(p95s), 1e-9)
    q_hi = max(max(depths), 1)
    if pool == "prefill":
        wq, wm, wl, wa = 2.0 * cfg.w_queue, 0.1 * cfg.w_memory, \
            cfg.w_latency, 0.5 * cfg.w_affinity
    elif pool == "decode":
        wq, wm, wl, wa = 0.5 * cfg.w_queue, 2.0 * cfg.w_memory, \
            cfg.w_latency, 2.0 * cfg.w_affinity
    else:
        wq, wm, wl, wa = cfg.w_queue, cfg.w_memory, cfg.w_latency, \
            cfg.w_affinity
    scores = []
    for r, d, p95, match in zip(candidates, depths, p95s, matches):
        s = wq * (d / q_hi) \
            + wm * (1.0 - r.kv_headroom()) \
            + wl * (p95 / p95_hi) \
            - wa * (match / p)
        scores.append(s)
    return scores, matches


@dataclass
class RouterConfig:
    """Dispatch-policy knobs. Score = lower-is-better; the affinity bonus
    subtracts, everything else adds."""

    max_inflight: int = 1024            # fleet-wide admission bound
    tenant_quotas: Dict[str, int] = field(default_factory=dict)
    default_quota: Optional[int] = None  # None: unlimited per tenant
    w_queue: float = 1.0                # per queued request (normalized)
    w_memory: float = 0.5               # (1 - kv headroom)
    w_latency: float = 0.5              # p95 normalized across replicas
    w_affinity: float = 2.0             # * matched-prefix fraction

    def quota_for(self, tenant: str) -> Optional[int]:
        return self.tenant_quotas.get(tenant, self.default_quota)


class ReplicaRouter:
    """Admission-controlled front door over N ``GenerationEngine``
    replicas.

    ::

        router = ReplicaRouter([eng_a, eng_b], RouterConfig(
            tenant_quotas={"free": 4}, default_quota=64))
        fut = router.submit(prompt, max_new_tokens=8, tenant="free")
        fut.result()
        router.stats()     # fleet + per-replica snapshot
        router.close()
    """

    def __init__(self, replicas: Sequence[GenerationEngine],
                 config: Optional[RouterConfig] = None,
                 name: str = "router"):
        if not replicas:
            raise ValueError("need at least one replica")
        self.name = name
        self.config = config or RouterConfig()
        self._replicas = list(replicas)
        self._lock = threading.Lock()
        self._down: set = set()          # replica names marked unhealthy
        self._inflight: Dict[str, int] = {}   # per-tenant in-flight
        self._inflight_total = 0
        self._routed: Dict[str, int] = {r.name: 0 for r in self._replicas}
        self._affinity_hits = 0
        self._readmitted = 0
        self._rejected = {"quota": 0, "capacity": 0}
        self._closed = False
        self._t0 = time.monotonic()

    # -- lifecycle ------------------------------------------------------------
    def start(self):
        for r in self._replicas:
            r.start()
        return self

    def close(self, drain: bool = True):
        with self._lock:
            self._closed = True
        for r in self._replicas:
            try:
                r.close(drain=drain)
            except Exception:
                pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False

    # -- health ---------------------------------------------------------------
    def mark_down(self, replica_name: str) -> None:
        with self._lock:
            self._down.add(replica_name)

    def mark_up(self, replica_name: str) -> None:
        with self._lock:
            self._down.discard(replica_name)

    def healthy(self) -> List[GenerationEngine]:
        with self._lock:
            down = set(self._down)
        return [r for r in self._replicas if r.name not in down]

    def probe_down(self) -> List[str]:
        """Health-probe every fenced replica and RE-ADMIT the ones that
        pass (fence -> probe -> re-admission): a replica fenced on a
        transient fault — or restarted by the fleet supervisor — rejoins
        the candidate set, and prefix-affinity routing resumes steering
        it the prefixes it still caches. A replica without a ``health``
        probe stays fenced (only positive evidence re-admits)."""
        with self._lock:
            down = set(self._down)
        readmitted = []
        for r in self._replicas:
            if r.name not in down:
                continue
            probe = getattr(r, "health", None)
            try:
                ok = bool(probe()) if probe is not None else False
            except Exception:
                ok = False
            if ok:
                self.mark_up(r.name)
                readmitted.append(r.name)
        if readmitted:
            with self._lock:
                self._readmitted += len(readmitted)
        return readmitted

    # -- dispatch -------------------------------------------------------------
    def _scores(self, prompt, candidates: List[GenerationEngine]
                ) -> Tuple[List[float], List[int]]:
        return score_candidates(self.config, prompt, candidates)

    def submit(self, prompt_ids, max_new_tokens: int = 16,
               tenant: str = "default",
               deadline_ms: Optional[float] = None):
        """Route one prompt to the best replica; returns its Future. The
        returned future resolves/fails exactly as the owning engine's
        would — the router adds admission control and placement only."""
        with self._lock:
            if self._closed:
                raise EngineClosed("router closed")
            if self._inflight_total >= self.config.max_inflight:
                self._rejected["capacity"] += 1
                raise QueueFull(
                    f"fleet at capacity ({self.config.max_inflight})")
            quota = self.config.quota_for(tenant)
            if quota is not None and \
                    self._inflight.get(tenant, 0) >= quota:
                self._rejected["quota"] += 1
                raise TenantQuotaExceeded(
                    f"tenant {tenant!r} at quota ({quota})")
            self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
            self._inflight_total += 1
        prompt = np.asarray(prompt_ids).reshape(-1)
        try:
            fut = self._dispatch(prompt, max_new_tokens, deadline_ms)
        except Exception:
            self._done(tenant)
            raise
        fut.add_done_callback(lambda _f: self._done(tenant))
        return fut

    def _dispatch(self, prompt, max_new_tokens, deadline_ms):
        last_exc: Optional[Exception] = None
        tried = 0
        probed = False
        while True:
            candidates = self.healthy()
            if not candidates and not probed:
                # last resort before failing the request: maybe a fenced
                # replica recovered (restarted by the fleet supervisor)
                probed = True
                if self.probe_down():
                    continue
            if not candidates:
                raise EngineClosed("no healthy replicas")
            scores, matches = self._scores(prompt, candidates)
            order = sorted(range(len(candidates)), key=scores.__getitem__)
            progressed = False
            for idx in order:
                r = candidates[idx]
                try:
                    fut = r.submit(prompt, max_new_tokens,
                                   deadline_ms=deadline_ms)
                except Exception as e:
                    kind = classify_submit_error(e)
                    if kind == "request":
                        # the REQUEST is at fault (malformed payload,
                        # expired deadline): the replica stays healthy —
                        # fencing here would let one bad client starve
                        # the fleet a replica at a time
                        raise
                    if kind == "busy":
                        last_exc = e
                        continue
                    # replica fault: fence it and keep draining through
                    # the survivors
                    self.mark_down(r.name)
                    last_exc = e
                    progressed = True
                    break  # re-score against the surviving set
                with self._lock:
                    self._routed[r.name] = self._routed.get(r.name, 0) + 1
                    if matches[idx] > 0:
                        self._affinity_hits += 1
                return fut
            if not progressed:
                raise last_exc or QueueFull("all replicas at capacity")
            tried += 1
            if tried > len(self._replicas):
                raise last_exc or EngineClosed("no healthy replicas")

    def _done(self, tenant: str) -> None:
        with self._lock:
            n = self._inflight.get(tenant, 0)
            if n > 0:
                self._inflight[tenant] = n - 1
                self._inflight_total -= 1

    # -- observability --------------------------------------------------------
    def queue_depth(self) -> int:
        return sum(r.queue_depth() for r in self._replicas)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            routed = dict(self._routed)
            down = sorted(self._down)
            inflight = dict(self._inflight)
            rejected = dict(self._rejected)
            affinity = self._affinity_hits
        per_replica = {}
        qps = 0.0
        for r in self._replicas:
            snap = r.stats()
            qps += snap.get("qps", 0.0)
            per_replica[r.name] = {
                "qps": snap.get("qps"),
                "queue_depth": r.queue_depth(),
                "active_slots": snap.get("active_slots"),
                "kv_headroom": r.kv_headroom(),
                "prefix_hit_rate": snap.get("prefix_hit_rate"),
                "p95_ms": snap.get("latency_ms", {}).get("p95"),
                "responses": snap.get("counters", {}).get(
                    "responses_total", 0),
                "routed": routed.get(r.name, 0),
                "down": r.name in down,
            }
        return {"name": self.name, "replicas": per_replica,
                "fleet_qps": round(qps, 3), "down": down,
                "inflight": inflight, "rejected": rejected,
                "affinity_hits": affinity,
                "readmitted": self._readmitted,
                "uptime_s": round(time.monotonic() - self._t0, 1)}
