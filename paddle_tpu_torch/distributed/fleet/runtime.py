"""The fleet supervisor's decision core and store helpers (port of the
supervisor's part of ``paddle_tpu/distributed/fleet/runtime.py``).

``FleetStateMachine`` is the recovery protocol's pure decision core (the
caller supplies the clock): the training gang's fence / drain / restart
decisions, and the replica mode the serving fleet drives
(``replica_fence`` / ``replica_restart_decision`` / ``replica_restarted``:
one replica fenced and restarted alone, with a per-replica budget and the
shared bounded backoff). ``_publish`` / ``_probe`` / ``_probe_json`` are
the store idiom every fleet key follows: each key carries a
``<key>/published`` add-counter so a probe never blocks (``TCPStore.get``
blocks on an absent key by design).

Not ported yet (ROADMAP Queue 1 item 6): ``ElasticFleet``,
``FleetWorkerContext``, ``elastic_fit`` and the rest of the elastic
training runtime.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional

__all__ = [
    "FleetPolicy", "FleetPhase", "FleetAction", "FleetStateMachine",
    "FleetFenced", "EXIT_FENCED", "EXIT_COORD_LOST",
]

# Worker exit codes the supervisor classifies (chosen clear of shell/
# signal ranges): a fenced worker drained and left; a coordinator-lost
# worker exits rather than orphan itself under a dead control plane.
EXIT_FENCED = 75
EXIT_COORD_LOST = 76


class FleetFenced(RuntimeError):
    """The supervisor fenced this generation: the current step can never
    complete (a collective peer is gone). The worker must abandon the
    step — its last committed checkpoint is the resume point."""


# ---------------------------------------------------------------------------
# policy + pure recovery state machine
# ---------------------------------------------------------------------------

@dataclass
class FleetPolicy:
    """Knobs of the recovery protocol."""

    min_world: int = 1
    max_restarts: int = 3
    backoff_base_s: float = 0.5     # restart n sleeps base * 2**(n-1)
    backoff_max_s: float = 30.0
    heartbeat_interval: float = 0.5
    heartbeat_timeout: float = 6.0  # the eviction grace window: a stall
    # shorter than this never evicts (tests pin it)
    drain_timeout_s: float = 20.0   # fence -> every survivor exited
    start_timeout_s: float = 180.0  # spawn -> all ranks ready
    poll_interval: float = 0.2

    def backoff_s(self, restart_id: int) -> float:
        return min(self.backoff_base_s * (2 ** max(restart_id - 1, 0)),
                   self.backoff_max_s)


class FleetPhase(Enum):
    LAUNCHING = "launching"
    RUNNING = "running"
    FENCED = "fenced"
    RESTARTING = "restarting"
    COMPLETED = "completed"
    FAILED = "failed"


@dataclass
class FleetAction:
    """What the supervisor should do next. ``kind`` is one of ``hold`` /
    ``fence`` / ``restart`` / ``complete`` / ``fail``."""

    kind: str
    dead: List[int] = field(default_factory=list)
    world: Optional[int] = None       # restart: the new world size
    backoff_s: float = 0.0
    reason: str = ""


class FleetStateMachine:
    """The recovery protocol's decision core — pure (caller supplies the
    clock), so membership flaps, budget exhaustion and grace windows are
    unit-testable without spawning a process.

    Per generation the supervisor feeds it ``heartbeat(rank, ts)`` as
    beats arrive and ``observe(now, exits)`` each poll; after a fence it
    calls ``observe`` until every worker exited, then ``restarted()``
    (or gets ``fail``/``complete``). Membership transitions land in
    ``timeline`` (bounded): join / evict (stale heartbeat) / flap (a
    beat from an evicted rank) / leave (exit) / fence / restart /
    complete / fail.
    """

    def __init__(self, world: int, policy: Optional[FleetPolicy] = None,
                 now: float = 0.0, gen: int = 0):
        self.policy = policy or FleetPolicy()
        self.phase = FleetPhase.LAUNCHING
        self.gen = int(gen)
        self.world = int(world)
        self.restarts = 0
        self.timeline: List[Dict[str, Any]] = []
        self._beats: Dict[int, float] = {}
        self._evicted: set = set()
        self._left: Dict[int, int] = {}   # rank -> exit code
        self._fence_reason = ""
        self._start_t = float(now)
        self._rank_restarts: Dict[int, int] = {}  # replica mode: per rank
        # a PLANNED fence (online retune raised by a worker, mirrored by
        # the supervisor probing the published reason) restarts the gang
        # without spending crash budget — the gang-mode analogue of
        # replica_restarted(count=False)
        self.planned_fence = False

    # -- inputs ---------------------------------------------------------------
    def _event(self, event: str, now: float, **data) -> None:
        rec = {"t": round(float(now), 3), "gen": self.gen, "event": event}
        rec.update(data)
        self.timeline.append(rec)
        if len(self.timeline) > 512:
            del self.timeline[:-512]

    def heartbeat(self, rank: int, now: float) -> None:
        first = rank not in self._beats
        if not first and float(now) <= self._beats[rank]:
            return  # a re-read of the same beat, not a fresh one
        self._beats[rank] = float(now)
        if first:
            self._event("join", now, rank=rank)
            if self.phase is FleetPhase.LAUNCHING and \
                    len(self._beats) >= self.world:
                self.phase = FleetPhase.RUNNING
        elif rank in self._evicted:
            # an evicted rank beat again: it was stalled, not dead — the
            # flap is recorded (the fence already happened; the restart
            # path re-admits it only through a fresh generation)
            self._evicted.discard(rank)
            self._event("flap", now, rank=rank)

    def ranks_alive(self, now: float) -> List[int]:
        cut = float(now) - self.policy.heartbeat_timeout
        return sorted(r for r, ts in self._beats.items()
                      if ts >= cut and r not in self._left)

    def stale_ranks(self, now: float) -> List[int]:
        """Registered ranks silent past the grace window and not exited —
        a stall SHORTER than ``heartbeat_timeout`` never lands here (the
        no-false-evict contract)."""
        cut = float(now) - self.policy.heartbeat_timeout
        return sorted(r for r, ts in self._beats.items()
                      if ts < cut and r not in self._left)

    # -- decision -------------------------------------------------------------
    def observe(self, now: float, exits: Dict[int, Optional[int]]
                ) -> FleetAction:
        """One poll: ``exits`` maps rank -> exit code (None = running)."""
        for r, rc in exits.items():
            if rc is not None and r not in self._left:
                self._left[r] = rc
                self._event("leave", now, rank=r, rc=rc)
        crashed = [r for r, rc in self._left.items()
                   if rc not in (0, EXIT_FENCED)]
        if self.phase in (FleetPhase.LAUNCHING, FleetPhase.RUNNING):
            if self.phase is FleetPhase.LAUNCHING and not crashed and \
                    now - self._start_t > self.policy.start_timeout_s:
                # checked before staleness: ranks that NEVER registered
                # have no heartbeat to go stale, and a partially-arrived
                # gang stuck past the window is a launch failure, not a
                # membership change
                self.phase = FleetPhase.FAILED
                missing = sorted(set(range(self.world)) - set(self._beats))
                self._event("fail", now, reason="start_timeout",
                            missing=missing)
                return FleetAction(
                    kind="fail",
                    reason=f"start_timeout: ranks {missing} never "
                           f"registered within "
                           f"{self.policy.start_timeout_s:.0f}s")
            stale = self.stale_ranks(now)
            if crashed or stale:
                for r in stale:
                    if r not in self._evicted:
                        self._evicted.add(r)
                        self._event("evict", now, rank=r, cause="stale",
                                    last_beat=self._beats.get(r))
                for r in crashed:
                    if r not in self._evicted:
                        self._evicted.add(r)
                        self._event("evict", now, rank=r, cause="crash",
                                    rc=self._left.get(r))
                self.phase = FleetPhase.FENCED
                dead = sorted(set(crashed) | set(stale))
                self._fence_reason = \
                    f"dead={crashed} stale={stale}".replace("'", "")
                self._event("fence", now, dead=dead,
                            reason=self._fence_reason)
                return FleetAction(kind="fence", dead=dead,
                                   reason=self._fence_reason)
            if len(self._left) == self.world:
                if all(rc == 0 for rc in self._left.values()):
                    self.phase = FleetPhase.COMPLETED
                    self._event("complete", now, world=self.world)
                    return FleetAction(kind="complete")
                # every process exited, none crashed: only fenced-style
                # exits remain (a gang that aborted a generation on its
                # own) — resolve through the restart budget instead of
                # holding forever
                self.phase = FleetPhase.FENCED
                self._fence_reason = "gang_exited"
                self._event("fence", now, dead=[], reason="gang_exited")
                return FleetAction(kind="fence", dead=[],
                                   reason="gang_exited")
            return FleetAction(kind="hold")
        if self.phase is FleetPhase.FENCED:
            if len(self._left) < self.world:
                return FleetAction(kind="hold")  # drain in progress
            return self._restart_decision(now)
        return FleetAction(kind="hold")

    def worker_fence(self, now: float, reason: str) -> None:
        """Adopt a fence the WORKERS raised themselves (online retune:
        the plan tuner published ``retune:*`` before adding the fence
        counter).  The gang moves to FENCED with NO eviction and the
        restart is flagged planned.  Adopting BEFORE any drain fallout
        lands matters: once rank 0 (which hosts the gang's
        coordination service) fast-exits ``EXIT_FENCED``, a still-
        draining peer may be killed by the coordinator loss — that
        death is drain mechanics, not a membership change, and must
        spend neither eviction nor crash budget."""
        if self.phase not in (FleetPhase.LAUNCHING, FleetPhase.RUNNING):
            return
        self.phase = FleetPhase.FENCED
        self.planned_fence = True
        self._fence_reason = reason
        self._event("fence", now, dead=[], reason=reason)

    def _restart_decision(self, now: float) -> FleetAction:
        # a fence raised during LAUNCHING may leave ranks that never
        # registered at all: they are not survivors either
        dead = sorted(self._evicted |
                      (set(range(self.world)) - set(self._beats)))
        survivors = self.world - len(dead)
        if survivors < self.policy.min_world:
            self.phase = FleetPhase.FAILED
            self._event("fail", now, reason="below_min_world",
                        survivors=survivors)
            return FleetAction(
                kind="fail", dead=dead,
                reason=f"{survivors} survivors < min_world="
                       f"{self.policy.min_world} ({self._fence_reason})")
        if not self.planned_fence and \
                self.restarts >= self.policy.max_restarts:
            self.phase = FleetPhase.FAILED
            self._event("fail", now, reason="restart_budget",
                        restarts=self.restarts)
            return FleetAction(
                kind="fail", dead=dead,
                reason=f"restart budget exhausted "
                       f"({self.restarts}/{self.policy.max_restarts})")
        self.phase = FleetPhase.RESTARTING
        backoff = 0.0 if self.planned_fence \
            else self.policy.backoff_s(self.restarts + 1)
        self._event("restart", now, world=survivors, dead=dead,
                    restart_id=self.restarts + 1, backoff_s=backoff,
                    planned=self.planned_fence)
        return FleetAction(kind="restart", dead=dead, world=survivors,
                           backoff_s=backoff)

    # -- replica mode (the serving fleet's per-replica supervision) -----------
    # A training gang fences and restarts as ONE unit: a lost rank tears
    # the collective, so everyone drains and the gang respawns at the
    # surviving world size. A SERVING fleet is the opposite shape — the
    # replicas are independent, the survivors must keep serving, and the
    # dead one restarts ALONE. These methods drive that per-rank
    # lifecycle against the same beats/eviction/timeline state (one
    # membership record, one grace window, one budget/backoff policy),
    # without touching the gang decision paths above.

    def replica_fence(self, rank: int, now: float, cause: str,
                      rc: Optional[int] = None) -> bool:
        """Fence ONE replica (crash rc / stale heartbeat / operator).
        Records evict+fence in the timeline; the fleet phase is untouched
        because the survivors keep serving. Idempotent per incarnation —
        returns False when the rank is already fenced."""
        if rank in self._evicted:
            return False
        self._evicted.add(rank)
        self._event("evict", now, rank=rank, cause=cause, rc=rc,
                    last_beat=self._beats.get(rank))
        self._event("fence", now, dead=[rank], reason=cause)
        # the beat record dies with the incarnation: a hung-not-dead
        # process that wakes later must not flap a fenced replica back
        self._beats.pop(rank, None)
        return True

    def replica_restart_decision(self, rank: int, now: float) -> FleetAction:
        """Restart-or-fail for ONE fenced replica: per-rank budget, the
        shared exponential-capped backoff formula."""
        n = self._rank_restarts.get(rank, 0)
        if n >= self.policy.max_restarts:
            self._event("fail", now, rank=rank, reason="restart_budget",
                        restarts=n)
            return FleetAction(
                kind="fail", dead=[rank],
                reason=f"replica {rank} restart budget exhausted "
                       f"({n}/{self.policy.max_restarts})")
        backoff = self.policy.backoff_s(n + 1)
        self._event("restart", now, rank=rank, restart_id=n + 1,
                    backoff_s=backoff)
        return FleetAction(kind="restart", dead=[rank], backoff_s=backoff)

    def replica_restarted(self, rank: int, now: float,
                          count: bool = True) -> None:
        """The supervisor respawned one replica: clear its fenced state so
        its first beat re-joins membership. ``count=False`` is the planned
        rolling-restart path — it spends no restart budget."""
        if count:
            self._rank_restarts[rank] = self._rank_restarts.get(rank, 0) + 1
            self.restarts += 1
        self._evicted.discard(rank)
        self._beats.pop(rank, None)
        self._left.pop(rank, None)

    def replica_restart_counts(self) -> Dict[int, int]:
        return dict(self._rank_restarts)

    def note(self, event: str, now: float, **data) -> None:
        """Record a supervisor-annotated event (planned rolling restart,
        brownout transition) in the membership timeline — one ordered
        record of everything that happened to the fleet."""
        self._event(event, now, **data)

    def restarted(self, now: float, world: int) -> None:
        """The supervisor re-spawned the gang: reset per-generation state.
        A planned (retune) fence rolls the generation without touching
        the crash-restart budget."""
        if not self.planned_fence:
            self.restarts += 1
        self.planned_fence = False
        self.gen += 1
        self.world = int(world)
        self.phase = FleetPhase.LAUNCHING
        self._beats = {}
        self._evicted = set()
        self._left = {}
        self._start_t = float(now)

    def snapshot(self) -> Dict[str, Any]:
        snap = {"phase": self.phase.value, "gen": self.gen,
                "world": self.world, "restarts": self.restarts,
                "timeline": list(self.timeline)}
        if self._rank_restarts:
            snap["rank_restarts"] = {str(r): n for r, n
                                     in self._rank_restarts.items()}
        return snap


# ---------------------------------------------------------------------------
# store helpers: publish/probe (get blocks on absent keys by design)
# ---------------------------------------------------------------------------

def _publish(store, key: str, value) -> None:
    data = value if isinstance(value, (bytes, bytearray)) else \
        json.dumps(value).encode()
    store.set(key, data)
    store.add(f"{key}/published", 1)


def _probe(store, key: str):
    """Non-blocking read: None when unpublished (the ElasticManager
    store_get_nowait idiom, shared fleet-wide)."""
    if store.add(f"{key}/published", 0) < 1:
        return None
    return store.get(key)


def _probe_json(store, key: str):
    raw = _probe(store, key)
    return None if raw is None else json.loads(raw)
