"""Fault-tolerant multi-process serving fleet (port of
``paddle_tpu/serving/fleet.py``): supervised replicas, health-checked
failover, hedged re-prefill, brownout degradation, zero-downtime rolling
restarts and disaggregated prefill/decode.

``ReplicaRouter`` load-balances replicas that share one process — a
single crash, hang or OOM takes the whole tier down. This module applies
the fleet-supervision protocol (heartbeats into the pure
``FleetStateMachine``, fence within the grace window, bounded-backoff
restart) to a continuous-batching tier:

- **process replicas**: each ``GenerationEngine`` runs in its OWN
  process (``replica_main``, ``python -m paddle_tpu_torch.serving.fleet``),
  built by the ``PT_REPLICA_BUILDER`` function, warmed (``warmup()``
  before the ready publish) and heartbeating through a control-plane
  ``TCPStore``. The builder picks the replica's device; the worker
  touches no CUDA before it runs, so a restarted incarnation starts clean;
- **RPC**: length-prefixed JSON frames — submit/stream(tokens)/cancel/
  drain/config/shutdown — served by a single-threaded event loop, so a
  wedged serve loop stops the heartbeat too (the hung-not-dead failure
  mode is detectable). A frame is byte for byte the JAX package's for the
  same message, so either side can talk to the other;
- **failover with replay**: in-flight requests on a fenced replica are
  resubmitted onto a survivor as ``prompt + already-streamed tokens``,
  and the emitted-token ledger dedups the stream — the client never sees
  a repeated or missing token;
- **hedging**: a request with no token progress past ``hedge_ms`` gets a
  second submission on another replica; first completion wins, the loser
  is cancelled;
- **brownout**: overload degrades in stages — (1) speculative decoding
  off, (2) ``max_new_tokens`` clamped for non-interactive requests, (3)
  the lowest-priority work shed (``BrownoutShed``);
- **rolling restarts**: ``rolling_restart()`` drains one replica at a
  time (fence new work -> finish in-flight -> restart -> warm -> re-admit);
- **disaggregated prefill/decode** (``pools=``): a prefill replica runs
  one token, the fleet ships the prompt's KV pages to a decode replica
  over the same frames (chunked, SHA-256-verified, int8 in transit with
  ``kv_transit="int8"``), installs them and continues the stream;
  failover ships a request's retained pages to a survivor
  (``failover_ship``) instead of re-prefilling (``failover_reprefill``),
  and a supervisor-side ``FleetKVCache`` keeps warm payloads.

Deterministic chaos: ``replica_crash@name&seq``, ``replica_hang@name&seq``
and ``replica_slow@name&ms`` (``PT_FAULTS``) fire inside the replica
worker. ``provider_snapshot()`` serves per-replica health, the
fence/restart timeline and the counters under the JAX names (``fences``,
``restarts``, ``replays``, ``hedges``, ``stream_mismatch``,
``failover_ship``, ``failover_reprefill``, ``weight_pushes`` …); a
replica's ``telemetry`` op answers its engine's ``stats()`` and its
process's ``kernels.counters()``.

Not ported yet (each raises ``NotImplementedError`` naming the module):
the fleet telemetry plane (``observability/fleet.py``: scrapes, SLO,
Prometheus text, the merged fleet trace), the request tracer,
``subscribe_weights`` (``post_training/weights.py``), the serving-shape
tuner (``tuning/serving_tuner.py``, ``PT_TUNED_SHAPE``) and the per-replica
flight recorder (``PT_FLIGHT_DIR``).
"""
from __future__ import annotations

import itertools
import json
import os
import select
import socket
import struct
import subprocess
import sys
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass
from enum import Enum
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .base import (BadRequest, DeadlineExceeded, EngineClosed, QueueFull,
                   ReplicaFault, RequestCancelled)
from .kv_transfer import (FleetKVCache, KVMigrationStats,
                          prompt_cache_key)
from .metrics import MetricsRegistry
from .router import RouterConfig, classify_submit_error, score_candidates

__all__ = [
    "ServingFleet", "ServingFleetPolicy", "ReplicaClient", "ReplicaState",
    "BrownoutShed", "BROWNOUT_STAGES", "brownout_stage", "brownout_max_new",
    "brownout_sheds", "stitch_replay", "replica_main", "resolve_builder",
]

_MAX_FRAME = 16 << 20
_CRASH_EXIT = 43  # replica_crash's os._exit code (classified as crash)
# the pieces of the JAX fleet that wait for their modules' port
_NO_WEIGHT_SERVICE = ("subscribe_weights needs the weight service "
                      "(post_training/weights.py), not ported yet")
_NO_TELEMETRY_PLANE = ("the fleet telemetry plane (observability/fleet.py: "
                       "scrapes, SLO, Prometheus text, the merged fleet "
                       "trace) is not ported yet")
_NO_SHAPE_TUNER = ("serving-shape retunes need tuning/serving_tuner.py "
                   "(apply_tuned_shape, PT_TUNED_SHAPE), not ported yet")
_NO_FLIGHT_RECORDER = ("per-replica flight dirs (PT_FLIGHT_DIR) need the "
                       "flight recorder (observability/trace/flight.py), "
                       "not ported yet")


class BrownoutShed(QueueFull):
    """Stage-3 brownout: the fleet is overloaded and this request's
    priority class is being shed (a ``QueueFull`` subclass, so existing
    backpressure handling applies)."""


# ---------------------------------------------------------------------------
# wire protocol: 4-byte big-endian length + JSON
# ---------------------------------------------------------------------------

def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


def send_frame(sock: socket.socket, obj: Dict[str, Any]) -> None:
    data = json.dumps(obj, separators=(",", ":"),
                      default=_json_default).encode()
    sock.sendall(struct.pack(">I", len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def recv_frame(sock: socket.socket) -> Optional[Dict[str, Any]]:
    """One frame, or None on a clean EOF."""
    hdr = _recv_exact(sock, 4)
    if hdr is None:
        return None
    (n,) = struct.unpack(">I", hdr)
    if n > _MAX_FRAME:
        raise ReplicaFault(f"oversized frame ({n} bytes)")
    data = _recv_exact(sock, n)
    if data is None:
        return None
    return json.loads(data.decode())


# ---------------------------------------------------------------------------
# policy + pure decision helpers (unit-testable without processes)
# ---------------------------------------------------------------------------

@dataclass
class ServingFleetPolicy:
    """Knobs of the serving recovery/overload protocol (the JAX
    package's, field for field)."""

    heartbeat_interval: float = 0.3
    heartbeat_timeout: float = 3.0   # the fence grace window
    max_restarts: int = 3            # per replica (planned rolls are free)
    backoff_base_s: float = 0.25
    backoff_max_s: float = 10.0
    start_timeout_s: float = 180.0   # spawn -> ready publish
    drain_timeout_s: float = 30.0    # rolling restart: finish in-flight
    poll_interval: float = 0.05
    rpc_timeout_s: float = 30.0
    # hedging: a request with no token progress for hedge_ms gets a
    # speculative second submission on another replica (None: off)
    hedge_ms: Optional[float] = None
    # brownout: load = fleet in-flight / (ready replicas * capacity)
    replica_capacity: int = 8
    brownout_spec_load: float = 0.7    # stage 1: speculation off
    brownout_clamp_load: float = 0.85  # stage 2: clamp batch-class budgets
    brownout_shed_load: float = 0.95   # stage 3: shed low priority
    brownout_hysteresis: float = 0.2   # exit threshold = entry - this
    brownout_clamp_tokens: int = 8
    interactive_deadline_ms: float = 2000.0
    brownout_keep_priority: int = 1    # stage 3 sheds priority < this
    # the fleet telemetry plane's knobs: kept for the JAX signature; the
    # plane that reads them is not ported, and no thread starts for it
    telemetry_interval_s: float = 2.0
    slo_target_ms: float = 1000.0
    slo_objective: float = 0.99
    slo_window_s: float = 60.0

    def fleet_policy(self):
        """The FleetStateMachine view of these knobs."""
        from ..distributed.fleet.runtime import FleetPolicy

        return FleetPolicy(
            heartbeat_interval=self.heartbeat_interval,
            heartbeat_timeout=self.heartbeat_timeout,
            max_restarts=self.max_restarts,
            backoff_base_s=self.backoff_base_s,
            backoff_max_s=self.backoff_max_s,
            drain_timeout_s=self.drain_timeout_s,
            start_timeout_s=self.start_timeout_s,
            poll_interval=self.poll_interval)


BROWNOUT_STAGES = ("normal", "no_spec", "clamp", "shed")


def brownout_stage(prev: int, load: float,
                   policy: ServingFleetPolicy) -> int:
    """Staged degradation with hysteresis: enter stage i when load
    crosses its threshold; leave (one stage per evaluation) only when
    load drops below the entry threshold minus the hysteresis margin —
    a load hovering at a boundary never flaps the spec toggle."""
    up = (policy.brownout_spec_load, policy.brownout_clamp_load,
          policy.brownout_shed_load)
    stage = 0
    for i, t in enumerate(up):
        if load >= t:
            stage = i + 1
    if stage < prev:
        exit_at = up[prev - 1] - policy.brownout_hysteresis
        stage = prev if load > exit_at else prev - 1
    return stage


def brownout_max_new(stage: int, deadline_ms: Optional[float],
                     max_new: int, policy: ServingFleetPolicy) -> int:
    """Stage >= 2 clamps the token budget of NON-interactive requests
    (no deadline, or a lax one) — interactive traffic keeps its budget,
    batch traffic gets shorter answers instead of no answers."""
    if stage < 2:
        return max_new
    interactive = deadline_ms is not None and \
        deadline_ms <= policy.interactive_deadline_ms
    return max_new if interactive else \
        max(1, min(max_new, policy.brownout_clamp_tokens))


def brownout_sheds(stage: int, priority: int,
                   policy: ServingFleetPolicy) -> bool:
    """Stage 3 sheds work below the keep-priority line."""
    return stage >= 3 and priority < policy.brownout_keep_priority


def stitch_replay(prompt: Sequence[int], emitted: Sequence[int],
                  replica_seq: Sequence[int]) -> List[int]:
    """The replay dedup rule: ``replica_seq`` is the replayed
    submission's full output (``prompt + emitted`` re-prefilled, plus
    freshly generated tokens). The client-visible sequence appends only
    the fresh tail — already-streamed tokens are never repeated and the
    prefix is never lost."""
    base = len(prompt) + len(emitted)
    return list(prompt) + list(emitted) + [int(t)
                                           for t in replica_seq[base:]]


def resolve_builder(spec: str) -> Callable[[], Any]:
    """``pkg.mod:fn`` (import path) or ``/path/to/file.py:fn`` (loaded
    by file — the drill/test builders live outside the package)."""
    mod_s, _, fn_s = spec.rpartition(":")
    if not mod_s or not fn_s:
        raise ValueError(f"builder spec {spec!r} is not 'module:function'")
    if mod_s.endswith(".py"):
        import importlib.util

        name = "_pt_replica_builder_" + \
            os.path.splitext(os.path.basename(mod_s))[0]
        s = importlib.util.spec_from_file_location(name, mod_s)
        mod = importlib.util.module_from_spec(s)
        s.loader.exec_module(mod)
    else:
        import importlib

        mod = importlib.import_module(mod_s)
    return getattr(mod, fn_s)


# ---------------------------------------------------------------------------
# replica worker (the child process)
# ---------------------------------------------------------------------------

def _injector():
    from ..distributed.resilience.faults import injector

    return injector()


class _ReplicaServer:
    """The worker-side RPC server: ONE event loop thread handles frames
    AND publishes heartbeats, so a wedged serve loop (``replica_hang``)
    stops the beat and the supervisor fences within the grace window.
    Engine worker threads hand outbound frames (token stream, done,
    errors) to the loop through a queue + self-pipe wakeup."""

    def __init__(self, name: str, engine, store=None,
                 hb_interval: float = 0.3, incarnation: int = 0):
        self.name = name
        self.engine = engine
        self._store = store
        self._hb = float(hb_interval)
        self._inc = int(incarnation)
        self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen.bind(("127.0.0.1", 0))
        self._listen.listen(4)
        self.port = self._listen.getsockname()[1]
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_r, False)
        os.set_blocking(self._wake_w, False)
        self._conns: Dict[socket.socket, bytearray] = {}
        self._out: deque = deque()           # (conn, frame)
        self._out_lock = threading.Lock()
        self._futs: Dict[int, Future] = {}   # rid -> engine future
        self._dead_rids: set = set()         # cancelled: frames suppressed
        self._seq = 0                        # submit counter (fault ids)
        self._hung = False
        self._shutdown = False
        self._store_failures = 0
        # KV page-migration staging (disaggregated prefill/decode):
        # export handles -> chunk lists, install handles -> partial
        # uploads. Both bounded FIFO — an abandoned transfer can never
        # pin memory.
        self._kv_handle = 0
        self._kv_out: Dict[int, List[Dict[str, Any]]] = {}
        self._kv_in: Dict[int, Dict[str, Any]] = {}

    # -- outbound (called from engine worker threads) -------------------------
    def _post(self, conn, frame: Dict[str, Any]) -> None:
        rid = frame.get("rid")
        if rid is not None and rid in self._dead_rids:
            return  # cancelled request: the supervisor moved on
        with self._out_lock:
            self._out.append((conn, frame))
        try:
            os.write(self._wake_w, b"x")
        except BlockingIOError:
            pass  # pipe full: the loop is already awake

    def _flush_out(self) -> None:
        while True:
            with self._out_lock:
                if not self._out:
                    return
                conn, frame = self._out.popleft()
            if conn not in self._conns:
                continue  # connection already gone
            try:
                send_frame(conn, frame)
            except OSError:
                self._drop(conn)

    def _drop(self, conn) -> None:
        self._conns.pop(conn, None)
        try:
            conn.close()
        except OSError:
            pass

    # -- store ----------------------------------------------------------------
    def _key(self, leaf: str) -> str:
        return f"svfleet/{self.name}/{self._inc}/{leaf}"

    def _publish(self, leaf: str, value) -> None:
        from ..distributed.fleet.runtime import _publish

        _publish(self._store, self._key(leaf), value)

    def _beat(self, now: float) -> None:
        if self._store is None or self._hung:
            return
        try:
            self._publish("beat", {"ts": now, "seq": self._seq})
            self._store_failures = 0
        except Exception:
            # a dead control plane means nobody will fence or restart
            # us: exit cleanly rather than serve as an orphan
            self._store_failures += 1
            if self._store_failures >= 3:
                from ..distributed.fleet.runtime import EXIT_COORD_LOST

                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(EXIT_COORD_LOST)

    # -- the loop -------------------------------------------------------------
    def serve(self) -> None:
        if self._store is not None:
            self._publish("port", {"port": self.port, "pid": os.getpid()})
        last_beat = 0.0
        while not self._shutdown:
            rs = [self._listen, self._wake_r] + list(self._conns)
            try:
                ready, _, _ = select.select(rs, [], [], self._hb / 2)
            except OSError:
                ready = []
            for s in ready:
                if s is self._listen:
                    conn, _ = self._listen.accept()
                    self._conns[conn] = bytearray()
                elif s is self._wake_r:
                    try:
                        os.read(self._wake_r, 4096)
                    except BlockingIOError:
                        pass
                else:
                    self._readable(s)
                if self._shutdown:
                    break
            self._flush_out()
            now = time.time()
            if now - last_beat >= self._hb:
                self._beat(now)
                last_beat = now
        # graceful exit (rolling restart): the supervisor drained us
        # first, so the engine is idle; close it and leave fast.
        self._flush_out()
        for c in list(self._conns):
            self._drop(c)
        try:
            self._listen.close()
        except OSError:
            pass
        try:
            self.engine.close(drain=True, timeout=10)
        except Exception:
            pass

    def _readable(self, conn) -> None:
        try:
            data = conn.recv(65536)
        except OSError:
            data = b""
        if not data:
            self._drop(conn)
            return
        buf = self._conns[conn]
        buf += data
        while len(buf) >= 4:
            (n,) = struct.unpack(">I", bytes(buf[:4]))
            if len(buf) < 4 + n:
                break
            frame = json.loads(bytes(buf[4:4 + n]).decode())
            del buf[:4 + n]
            self._handle(conn, frame)
            if self._shutdown:
                break

    # -- ops ------------------------------------------------------------------
    def _handle(self, conn, msg: Dict[str, Any]) -> None:
        op = msg.get("op")
        rid = msg.get("rid")
        if op == "submit":
            self._submit(conn, rid, msg)
        elif op == "probe":
            reply = self._probe_reply(msg)
            reply.update(rid=rid, event="reply")
            self._post(conn, reply)
        elif op == "stats":
            try:
                st = self.engine.stats()
            except Exception as e:
                st = {"error": str(e)[:200]}
            self._post(conn, {"rid": rid, "event": "reply", "stats": st})
        elif op == "config":
            if "spec_decode" in msg and \
                    hasattr(self.engine, "set_speculative"):
                self.engine.set_speculative(bool(msg["spec_decode"]))
            self._post(conn, {"rid": rid, "event": "reply", "ok": True})
        elif op == "subscribe_weights":
            self._post(conn, {"rid": rid, "event": "error",
                              "kind": "NotImplementedError",
                              "msg": _NO_WEIGHT_SERVICE})
        elif op == "telemetry":
            # the port has no observability hub: the engine's stats() and
            # this process's kernel launch counters stand in for its
            # snapshot, so the supervisor can read a replica's launches
            try:
                from .. import kernels

                snap = {"engine": self.engine.stats(),
                        "kernels": kernels.counters()}
            except Exception as e:
                snap = {"error": str(e)[:200]}
            self._post(conn, {"rid": rid, "event": "reply",
                              "telemetry": snap, "pid": os.getpid()})
        elif op == "trace":
            # no request tracer in the port: nothing is ever pending
            self._post(conn, {"rid": rid, "event": "reply",
                              "traces": [], "pid": os.getpid()})
        elif op == "kv_export":
            self._kv_export(conn, rid, msg)
        elif op == "kv_chunk":
            self._kv_chunk(conn, rid, msg)
        elif op == "kv_install_begin":
            self._kv_install_begin(conn, rid, msg)
        elif op == "kv_install_chunk":
            self._kv_install_chunk(conn, rid, msg)
        elif op == "kv_install_commit":
            self._kv_install_commit(conn, rid, msg)
        elif op == "drain":
            self.engine.fence()
            self._post(conn, {"rid": rid, "event": "reply",
                              "draining": True})
        elif op == "cancel":
            target = msg.get("target")
            fut = self._futs.get(target)
            dequeued = False
            if fut is not None and hasattr(self.engine, "cancel"):
                dequeued = bool(self.engine.cancel(fut))
            self._dead_rids.add(target)
            if len(self._dead_rids) > 8192:  # bounded: retired rids only
                self._dead_rids.clear()
            self._post(conn, {"rid": rid, "event": "reply",
                              "cancelled": dequeued})
        elif op == "shutdown":
            self._post(conn, {"rid": rid, "event": "reply", "ok": True})
            self._flush_out()
            self._shutdown = True
        else:
            self._post(conn, {"rid": rid, "event": "error",
                              "kind": "BadRequest",
                              "msg": f"unknown op {op!r}"})

    def _submit(self, conn, rid, msg) -> None:
        self._seq += 1
        inj = _injector()
        # deterministic chaos sites — every drill scenario injectable
        # without real kills (PT_FAULTS reaches this process by env).
        # `inc` is a match id: a RESTARTED replica re-parses PT_FAULTS,
        # so a rule pinning inc=0 fires once per drill, not once per
        # incarnation (the restarted process walks seq from 1 again).
        if inj.peek("replica_crash", name=self.name, seq=self._seq,
                    inc=self._inc):
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(_CRASH_EXIT)  # a crash does not unwind
        if inj.peek("replica_hang", name=self.name, seq=self._seq,
                    inc=self._inc):
            # wedge the serve loop: beats stop, the supervisor must
            # fence within the grace window and SIGTERM us
            self._hung = True
            time.sleep(3600)
        # replica_slow DEFERS the submit by the rule's ms (a slow
        # replica, not a dead one: heartbeats keep flowing, the request
        # makes no progress — exactly the hedging trigger). _take is
        # the injector's matching core; peek() would eat the rule but
        # drop its sleep_ms.
        slow = inj._take("replica_slow", {"name": self.name})
        if slow is not None and slow.sleep_ms:
            t = threading.Timer(slow.sleep_ms / 1e3, self._do_submit,
                                args=(conn, rid, msg))
            # Timer threads are non-daemon by default: an armed timer
            # outliving the replica would hold the process open
            t.daemon = True
            t.name = f"pt-serving-slow-submit-{self.name}"
            t.start()
            return
        self._do_submit(conn, rid, msg)

    def _do_submit(self, conn, rid, msg) -> None:
        post = partial(self._post, conn)
        kw: Dict[str, Any] = {}
        if msg.get("logprobs"):
            # behavior-logprob requests: each token frame carries the
            # per-token logprob alongside the token (the rollout
            # trajectory ledger), and the done frame the full vector
            kw["return_logprobs"] = True
            kw["on_token"] = lambda t, lp, _p=post, _r=rid: _p(
                {"rid": _r, "event": "token", "t": int(t),
                 "lp": float(lp)})
        else:
            kw["on_token"] = lambda t, _p=post, _r=rid: _p(
                {"rid": _r, "event": "token", "t": int(t)})
        try:
            fut = self.engine.submit(
                np.asarray(msg["prompt"], dtype=np.int64),
                int(msg.get("max_new_tokens", 16)),
                deadline_ms=msg.get("deadline_ms"), **kw)
        except Exception as e:
            post({"rid": rid, "event": "error", "kind": type(e).__name__,
                  "msg": str(e)[:300]})
            return
        self._futs[rid] = fut
        fut.add_done_callback(partial(self._req_done, rid, post))

    def _req_done(self, rid, post, fut) -> None:
        self._futs.pop(rid, None)
        try:
            res = fut.result()
        except BaseException as e:
            post({"rid": rid, "event": "error", "kind": type(e).__name__,
                  "msg": str(e)[:300]})
        else:
            if isinstance(res, tuple):  # (seq, logprobs)
                seq, lps = res
                post({"rid": rid, "event": "done",
                      "seq": [int(x) for x in seq],
                      "lp": [float(x) for x in lps]})
            else:
                post({"rid": rid, "event": "done",
                      "seq": [int(x) for x in res]})

    def _probe_reply(self, msg) -> Dict[str, Any]:
        eng = self.engine
        reply: Dict[str, Any] = {
            "queue_depth": int(eng.queue_depth()),
            "kv_headroom": float(eng.kv_headroom())
            if hasattr(eng, "kv_headroom") else 1.0,
            "p95": float(eng.metrics.latency_percentile(95)),
            "seq": self._seq,
            "weight_version": int(getattr(eng, "weight_version", 0) or 0),
        }
        if hasattr(eng, "_active"):
            try:
                reply["active"] = len(eng._active())
            except Exception:
                pass
        if "prompt" in msg and hasattr(eng, "prefix_match_tokens"):
            try:
                reply["match"] = int(eng.prefix_match_tokens(
                    np.asarray(msg["prompt"], dtype=np.int64)))
            except Exception:
                reply["match"] = 0
        return reply

    # -- kv page migration (disaggregated prefill/decode) ---------------------
    # The worker round trip blocks the event loop; that is bounded by
    # the engine worker's op drain (one step), far inside the heartbeat
    # grace window — pages for one prompt are small next to weights.
    def _kv_export(self, conn, rid, msg) -> None:
        from .kv_transfer import chunk_blob, pack_kv_pages  # lazy

        try:
            _npages, k_st, v_st = self.engine.export_kv_pages(
                np.asarray(msg["prompt"], dtype=np.int64))
            blob, manifest, meta = pack_kv_pages(
                k_st, v_st, quantize=bool(msg.get("quantize")))
            chunks = chunk_blob(blob,
                                int(msg.get("chunk_bytes", 1 << 20)))
        except Exception as e:
            self._post(conn, {"rid": rid, "event": "error",
                              "kind": type(e).__name__,
                              "msg": str(e)[:300]})
            return
        self._kv_handle += 1
        handle = self._kv_handle
        self._kv_out[handle] = chunks
        while len(self._kv_out) > 8:     # bounded staging, oldest out
            self._kv_out.pop(min(self._kv_out))
        reply = {"rid": rid, "event": "reply", "handle": handle,
                 "nchunks": len(chunks), "manifest": manifest}
        reply.update(meta)
        self._post(conn, reply)

    def _kv_chunk(self, conn, rid, msg) -> None:
        chunks = self._kv_out.get(msg.get("handle"))
        idx = int(msg.get("idx", -1))
        if chunks is None or not 0 <= idx < len(chunks):
            self._post(conn, {"rid": rid, "event": "error",
                              "kind": "KeyError",
                              "msg": f"kv export handle/chunk "
                                     f"{msg.get('handle')}/{idx}"})
            return
        ch = dict(chunks[idx])
        ch.update(rid=rid, event="reply")
        self._post(conn, ch)

    def _kv_install_begin(self, conn, rid, msg) -> None:
        self._kv_handle += 1
        handle = self._kv_handle
        self._kv_in[handle] = {
            "prompt": [int(x) for x in msg["prompt"]],
            "manifest": msg["manifest"], "digest": msg.get("digest"),
            "nchunks": int(msg["nchunks"]), "chunks": {}}
        while len(self._kv_in) > 8:
            self._kv_in.pop(min(self._kv_in))
        self._post(conn, {"rid": rid, "event": "reply",
                          "handle": handle})

    def _kv_install_chunk(self, conn, rid, msg) -> None:
        import base64
        import hashlib

        st = self._kv_in.get(msg.get("handle"))
        if st is None:
            self._post(conn, {"rid": rid, "event": "error",
                              "kind": "KeyError",
                              "msg": "unknown kv install handle"})
            return
        idx = int(msg["idx"])
        raw = base64.b64decode(msg["data"])
        if hashlib.sha256(raw).hexdigest() != msg.get("sha"):
            # reject NOW: the shipper resends just this chunk
            self._post(conn, {"rid": rid, "event": "error",
                              "kind": "ValueError",
                              "msg": f"kv chunk {idx} digest mismatch"})
            return
        st["chunks"][idx] = {"idx": idx, "data": msg["data"],
                             "sha": msg["sha"]}
        self._post(conn, {"rid": rid, "event": "reply", "ok": True,
                          "have": len(st["chunks"])})

    def _kv_install_commit(self, conn, rid, msg) -> None:
        from .kv_transfer import assemble_chunks, unpack_kv_pages

        st = self._kv_in.pop(msg.get("handle"), None)
        t0 = time.monotonic()
        try:
            if st is None:
                raise KeyError("unknown kv install handle")
            if len(st["chunks"]) != st["nchunks"]:
                raise ValueError(
                    f"kv install incomplete: {len(st['chunks'])}/"
                    f"{st['nchunks']} chunks")
            blob = assemble_chunks(
                [st["chunks"][i] for i in range(st["nchunks"])],
                digest=st.get("digest"))
            k_st, v_st = unpack_kv_pages(blob, st["manifest"])
            installed = self.engine.install_kv_pages(
                np.asarray(st["prompt"], dtype=np.int64), k_st, v_st)
        except Exception as e:
            self._post(conn, {"rid": rid, "event": "error",
                              "kind": type(e).__name__,
                              "msg": str(e)[:300]})
            return
        self._post(conn, {"rid": rid, "event": "reply",
                          "installed": int(installed),
                          "ms": round((time.monotonic() - t0) * 1e3, 3)})


def replica_main() -> int:
    """The replica worker entry
    (``python -m paddle_tpu_torch.serving.fleet``):
    build the engine from ``PT_REPLICA_BUILDER``, warm every bucket,
    publish readiness to the control-plane store, then serve RPC +
    heartbeats until shutdown."""
    name = os.environ.get("PT_REPLICA_NAME", "replica0")
    inc = int(os.environ.get("PT_REPLICA_INCARNATION", "0"))
    hb = float(os.environ.get("PT_REPLICA_HB_INTERVAL", "0.3"))
    endpoint = os.environ.get("PT_SERVING_FLEET_ENDPOINT", "")
    spec = os.environ.get("PT_REPLICA_BUILDER", "")
    if not spec:
        raise SystemExit("PT_REPLICA_BUILDER not set")
    if os.environ.get("PT_TUNED_SHAPE", ""):
        raise NotImplementedError(_NO_SHAPE_TUNER)
    engine = resolve_builder(spec)()
    if hasattr(engine, "warmup"):
        engine.warmup()  # warmed buckets BEFORE the ready publish
    engine.start()
    store = None
    if endpoint:
        from ..distributed.store import TCPStore

        host, port = endpoint.rsplit(":", 1)
        store = TCPStore(host=host, port=int(port), world_size=1,
                         timeout=60)
    _ReplicaServer(name, engine, store=store, hb_interval=hb,
                   incarnation=inc).serve()
    return 0


# ---------------------------------------------------------------------------
# supervisor-side RPC client (GenerationEngine-shaped)
# ---------------------------------------------------------------------------

class _RemoteMetrics:
    """The ``r.metrics.latency_percentile(95)`` surface the router's
    scoring reads, backed by the client's cached probe."""

    def __init__(self, client: "ReplicaClient"):
        self._c = client

    def latency_percentile(self, q: int = 95) -> float:
        return float(self._c._probe().get("p95", 0.0))


class _Pending:
    __slots__ = ("future", "on_token", "streaming")

    def __init__(self, future, on_token=None, streaming=False):
        self.future = future
        self.on_token = on_token
        self.streaming = streaming


_EXC_MAP = {
    "BadRequest": BadRequest, "DeadlineExceeded": DeadlineExceeded,
    "QueueFull": QueueFull, "EngineClosed": EngineClosed,
    "RequestCancelled": RequestCancelled, "ReplicaFault": ReplicaFault,
}


class ReplicaClient:
    """The supervisor's handle on one replica process: engine-shaped
    (``submit() -> Future``, ``queue_depth``, ``kv_headroom``,
    ``prefix_match_tokens``, ``health``) over the socket RPC, with a
    short-TTL probe cache so the router's per-submit scoring does one
    round trip, not four. A lost connection fails every pending future
    with ``ReplicaFault`` — the shape the router/fleet fence on."""

    def __init__(self, name: str, host: str, port: int,
                 rpc_timeout_s: float = 30.0, probe_ttl_s: float = 0.05,
                 probe_timeout_s: float = 2.0):
        self.name = name
        self.metrics = _RemoteMetrics(self)
        self._timeout = float(rpc_timeout_s)
        self._probe_ttl = float(probe_ttl_s)
        # probes are SCORING inputs: a wedged replica must cost the
        # dispatcher this bound, not the full rpc timeout
        self._probe_timeout = float(probe_timeout_s)
        self._sock = socket.create_connection((host, port), timeout=10)
        self._sock.settimeout(None)
        self._send_lock = threading.Lock()
        self._lock = threading.Lock()
        self._rid = itertools.count(1)
        self._pending: Dict[int, _Pending] = {}
        self._alive = True
        self._probe_cache: Dict[str, Any] = {}
        self._probe_t = 0.0
        self._recv = threading.Thread(target=self._recv_loop,
                                      name=f"pt-replica-rx-{name}",
                                      daemon=True)
        self._recv.start()

    # -- transport ------------------------------------------------------------
    def _send(self, obj: Dict[str, Any]) -> None:
        if not self._alive:
            raise ReplicaFault(f"replica {self.name} connection lost")
        try:
            # _send_lock exists precisely to hold across the socket
            # write: frames from the submit path and the hedge timer
            # must not interleave mid-frame. Leaf lock, never nested.
            with self._send_lock:
                send_frame(self._sock, obj)
        except OSError as e:
            self._fail(ReplicaFault(
                f"replica {self.name} send failed: {e}"))
            raise ReplicaFault(f"replica {self.name} connection lost")

    def _recv_loop(self) -> None:
        try:
            while True:
                frame = recv_frame(self._sock)
                if frame is None:
                    break
                self._dispatch_frame(frame)
        except Exception:
            pass
        self._fail(ReplicaFault(f"replica {self.name} connection lost"))

    def _dispatch_frame(self, frame: Dict[str, Any]) -> None:
        rid = frame.get("rid")
        ev = frame.get("event")
        with self._lock:
            p = self._pending.get(rid)
            if p is not None and ev in ("done", "error", "reply"):
                del self._pending[rid]
        if p is None:
            return  # retired rid (cancelled request): frames ignored
        if ev == "token":
            if p.on_token is not None:
                try:
                    if "lp" in frame:  # logprob-carrying token stream
                        p.on_token(int(frame["t"]), float(frame["lp"]))
                    else:
                        p.on_token(int(frame["t"]))
                except Exception:
                    pass
        elif ev == "done":
            seq = np.asarray(frame["seq"], dtype=np.int64)
            if "lp" in frame:
                p.future.set_result(
                    (seq, np.asarray(frame["lp"], dtype=np.float32)))
            else:
                p.future.set_result(seq)
        elif ev == "reply":
            p.future.set_result(frame)
        elif ev == "error":
            cls = _EXC_MAP.get(frame.get("kind"), RuntimeError)
            p.future.set_exception(cls(frame.get("msg", "replica error")))

    def _fail(self, exc: Exception) -> None:
        with self._lock:
            if not self._alive:
                return
            self._alive = False
            pending = list(self._pending.values())
            self._pending.clear()
        try:
            self._sock.close()
        except OSError:
            pass
        for p in pending:  # outside the lock: callbacks may re-enter us
            if not p.future.done():
                p.future.set_exception(exc)

    def _rpc(self, op: str, timeout: Optional[float] = None,
             **kw) -> Dict[str, Any]:
        rid = next(self._rid)
        fut: Future = Future()
        with self._lock:
            if not self._alive:
                raise ReplicaFault(
                    f"replica {self.name} connection lost")
            self._pending[rid] = _Pending(fut)
        msg = {"op": op, "rid": rid}
        msg.update(kw)
        try:
            self._send(msg)
            return fut.result(timeout=self._timeout
                              if timeout is None else timeout)
        except ReplicaFault:
            raise
        except Exception as e:
            with self._lock:
                self._pending.pop(rid, None)
            raise ReplicaFault(
                f"replica {self.name} rpc {op} failed: {e}")

    # -- engine-shaped surface ------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int = 16,
               deadline_ms: Optional[float] = None,
               on_token=None, return_logprobs: bool = False) -> Future:
        # client-side validation: a malformed REQUEST raises here — the
        # replica stays healthy and must not be fenced for it
        prompt = np.asarray(prompt_ids)
        if prompt.ndim != 1 or prompt.size == 0 or \
                not np.issubdtype(prompt.dtype, np.integer):
            raise BadRequest(
                "prompt must be a non-empty 1-D integer array")
        if max_new_tokens < 1:
            raise BadRequest("max_new_tokens must be >= 1")
        rid = next(self._rid)
        fut: Future = Future()
        fut._pt_rid = rid  # cancel() addresses the replica-side request
        with self._lock:
            if not self._alive:
                raise ReplicaFault(
                    f"replica {self.name} connection lost")
            self._pending[rid] = _Pending(fut, on_token=on_token,
                                          streaming=True)
        msg = {"op": "submit", "rid": rid,
               "prompt": [int(x) for x in prompt],
               "max_new_tokens": int(max_new_tokens),
               "deadline_ms": deadline_ms}
        if return_logprobs:
            msg["logprobs"] = True
        try:
            self._send(msg)
        except Exception:
            with self._lock:
                self._pending.pop(rid, None)
            raise
        return fut

    def cancel(self, future) -> bool:
        rid = getattr(future, "_pt_rid", None)
        if rid is None:
            return False
        with self._lock:
            self._pending.pop(rid, None)
        try:
            reply = self._rpc("cancel", target=rid, timeout=5)
            return bool(reply.get("cancelled"))
        except Exception:
            return False

    def _probe(self, prompt=None, force: bool = False,
               timeout: Optional[float] = None) -> Dict[str, Any]:
        now = time.monotonic()
        if prompt is None and not force and \
                now - self._probe_t < self._probe_ttl:
            return self._probe_cache
        kw: Dict[str, Any] = {}
        if prompt is not None:
            kw["prompt"] = [int(x) for x in np.asarray(prompt).reshape(-1)]
        reply = self._rpc("probe", timeout=self._probe_timeout
                          if timeout is None else timeout, **kw)
        self._probe_cache = reply
        self._probe_t = time.monotonic()
        return reply

    def queue_depth(self) -> int:
        return int(self._probe().get("queue_depth", 0))

    def kv_headroom(self) -> float:
        return float(self._probe().get("kv_headroom", 1.0))

    def prefix_match_tokens(self, prompt_ids, blocks=None) -> int:
        return int(self._probe(prompt=prompt_ids).get("match", 0))

    def health(self, timeout: float = 2.0) -> bool:
        if not self._alive:
            return False
        try:
            self._probe(force=True, timeout=timeout)
            return True
        except Exception:
            return False

    def weight_version(self) -> int:
        """The weight generation the replica currently serves (probe-
        cached); -1 when unknown."""
        try:
            return int(self._probe().get("weight_version", -1))
        except Exception:
            return -1

    def subscribe_weights(self, host: str, port: int,
                          poll_interval: float = 0.25) -> None:
        raise NotImplementedError(_NO_WEIGHT_SERVICE)

    def telemetry(self) -> Dict[str, Any]:
        """``{"telemetry": {"engine": stats, "kernels": launch counters},
        "pid": ...}`` of this replica (a port replica's stand-in for the
        JAX hub snapshot)."""
        return self._rpc("telemetry", timeout=10)

    def pull_traces(self) -> List[Dict[str, Any]]:
        """Drain the replica's finished fleet-parented traces (a port
        replica has none)."""
        return list(self._rpc("trace", timeout=10).get("traces") or [])

    def stats(self) -> Dict[str, Any]:
        return self._rpc("stats").get("stats", {})

    def set_spec(self, enabled: bool) -> None:
        self._rpc("config", spec_decode=bool(enabled), timeout=5)

    # -- kv page migration ----------------------------------------------------
    def kv_export(self, prompt_ids, quantize: bool = False,
                  chunk_bytes: int = 1 << 20) -> Dict[str, Any]:
        """Pull the packed KV pages backing ``prompt_ids`` from this
        replica's prefix cache: a head RPC stages the blob replica-side,
        then each chunk is pulled and digest-verified (one resend per
        bad chunk). Returns the
        payload dict ``kv_install`` accepts."""
        import base64
        import hashlib

        prompt = [int(x) for x in np.asarray(prompt_ids).reshape(-1)]
        head = self._rpc("kv_export", prompt=prompt,
                         quantize=bool(quantize),
                         chunk_bytes=int(chunk_bytes))
        parts: List[bytes] = []
        for i in range(int(head["nchunks"])):
            raw = None
            for _attempt in range(2):
                ch = self._rpc("kv_chunk", handle=head["handle"], idx=i)
                got = base64.b64decode(ch["data"])
                if hashlib.sha256(got).hexdigest() == ch.get("sha"):
                    raw = got
                    break
            if raw is None:
                raise ReplicaFault(
                    f"replica {self.name} kv chunk {i} digest mismatch")
            parts.append(raw)
        blob = b"".join(parts)
        if hashlib.sha256(blob).hexdigest() != head["digest"]:
            raise ReplicaFault(
                f"replica {self.name} kv blob digest mismatch")
        return {"prompt": prompt, "manifest": head["manifest"],
                "digest": head["digest"], "data": blob,
                "npages": int(head["npages"]),
                "wire_bytes": int(head["wire_bytes"]),
                "fp32_bytes": int(head["fp32_bytes"]),
                "quantized": bool(head["quantized"]),
                "chunks": int(head["nchunks"])}

    def kv_install(self, payload: Dict[str, Any],
                   chunk_bytes: int = 1 << 20) -> Dict[str, Any]:
        """Ship a ``kv_export`` payload into this replica's paged pool
        (begin -> digest-verified chunks, one resend each -> commit:
        the replica assembles, dequantizes if needed, writes the pages
        and adopts them into its prefix trie). Returns
        ``{"installed": npages, "ms": install_ms}``."""
        from .kv_transfer import chunk_blob  # lazy

        chunks = chunk_blob(payload["data"], int(chunk_bytes))
        head = self._rpc("kv_install_begin", prompt=payload["prompt"],
                         manifest=payload["manifest"],
                         digest=payload["digest"], nchunks=len(chunks))
        for ch in chunks:
            for attempt in range(2):
                try:
                    self._rpc("kv_install_chunk",
                              handle=head["handle"], **ch)
                    break
                except ReplicaFault:
                    if attempt or not self._alive:
                        raise
        return self._rpc("kv_install_commit", handle=head["handle"],
                         timeout=60)

    def drain(self) -> None:
        self._rpc("drain", timeout=5)

    def shutdown(self) -> None:
        try:
            self._rpc("shutdown", timeout=5)
        except Exception:
            pass

    def close(self) -> None:
        self._fail(ReplicaFault(f"replica {self.name} client closed"))


# ---------------------------------------------------------------------------
# supervisor
# ---------------------------------------------------------------------------

class ReplicaState(Enum):
    LAUNCHING = "launching"
    READY = "ready"
    DRAINING = "draining"    # rolling restart: fenced for NEW work only
    FENCED = "fenced"
    RESTARTING = "restarting"
    FAILED = "failed"        # restart budget exhausted: stays down


class _Assignment:
    """One submission of a fleet request to one replica (the primary, a
    replay of the primary, or a hedge). ``prefix`` is the prompt it was
    dispatched with (original prompt + tokens already streamed to the
    client at dispatch time) — the dedup baseline."""

    __slots__ = ("req", "replica", "prefix", "tokens", "lps", "fut",
                 "t_dispatch", "t_last", "hedge", "cancelled", "repin",
                 "stage")

    def __init__(self, req: "FleetRequest", replica: str,
                 prefix: List[int], hedge: bool = False,
                 repin: bool = False, stage: str = "decode"):
        self.req = req
        self.replica = replica
        self.prefix = prefix
        self.tokens: List[int] = []
        self.lps: List[float] = []     # behavior logprobs (want_lp)
        self.fut: Optional[Future] = None
        self.t_dispatch = time.monotonic()
        self.t_last = self.t_dispatch  # last token progress (hedge clock)
        self.hedge = hedge
        self.cancelled = False
        # a cross-version re-prefill: no same-weight-version survivor
        # existed, so this assignment restarts from the prompt alone
        # and is deduped against the ledger BY POSITION
        self.repin = repin
        # "prefill" marks a pool-split first leg: the assignment stops
        # after ONE token (the prompt's paged KV is now hot on this
        # replica) and hands the request to the migration queue
        self.stage = stage


class FleetRequest:
    __slots__ = ("id", "prompt", "max_new", "deadline", "deadline_ms",
                 "tenant", "priority", "future", "emitted", "on_token",
                 "primary", "hedge", "replays", "t_submit", "done",
                 "stream_lock", "delivered", "want_lp", "emitted_lp",
                 "weight_version", "kv_payload")

    def __init__(self, rid: int, prompt: List[int], max_new: int,
                 deadline_ms: Optional[float], tenant: str, priority: int,
                 on_token=None, want_lp: bool = False):
        self.id = rid
        self.prompt = prompt
        self.max_new = int(max_new)
        self.deadline_ms = deadline_ms
        self.deadline = None if deadline_ms is None \
            else time.monotonic() + deadline_ms / 1e3
        self.tenant = tenant
        self.priority = int(priority)
        self.future: Future = Future()
        self.future._pt_req = self     # rollout tier reads the version pin
        self.emitted: List[int] = []   # generated tokens streamed so far
        self.want_lp = bool(want_lp)
        self.emitted_lp: List[float] = []  # behavior-logprob ledger
        # weight generation the emitted prefix was produced under (the
        # replay version pin): None until first dispatch, -1 = unknown
        self.weight_version: Optional[int] = None
        # the shipped KV payload (pool mode): retained so failover can
        # re-install pages on a survivor instead of re-prefilling
        self.kv_payload: Optional[Dict[str, Any]] = None
        self.on_token = on_token
        self.primary: Optional[_Assignment] = None
        self.hedge: Optional[_Assignment] = None
        self.replays = 0
        self.t_submit = time.monotonic()
        self.done = False
        # client-stream delivery state: `delivered` tokens of `emitted`
        # have reached on_token; stream_lock serializes deliveries so
        # racing rx threads can never reorder them
        self.stream_lock = threading.Lock()
        self.delivered = 0


class _ReplicaHandle:
    __slots__ = ("idx", "name", "state", "proc", "client", "incarnation",
                 "restart_at", "count_restart", "t_launch", "inflight",
                 "routed", "routed_since_ready", "log_path", "external",
                 "fence_rec", "pool")

    def __init__(self, idx: int, name: str, external=None):
        self.idx = idx
        self.name = name
        self.pool: Optional[str] = None   # "prefill"/"decode"/None
        self.state = ReplicaState.LAUNCHING
        self.proc: Optional[subprocess.Popen] = None
        self.client = external   # ReplicaClient, or the in-process engine
        self.incarnation = -1
        self.restart_at: Optional[float] = None
        self.count_restart = True
        self.t_launch = 0.0
        self.inflight: Dict[int, _Assignment] = {}  # req id -> assignment
        self.routed = 0
        self.routed_since_ready = 0
        self.log_path: Optional[str] = None
        self.external = external is not None
        self.fence_rec: Optional[Dict[str, Any]] = None  # open recovery


class ServingFleet:
    """Supervised multi-process serving: N ``GenerationEngine`` replica
    processes behind one reliability-aware front door.

    ::

        fleet = ServingFleet(builder="chip_smoke.py:build_fleet_replica",
                             n_replicas=2).start()
        fut = fleet.submit(prompt, max_new_tokens=8)
        fut.result()                # survives a replica crash mid-stream
        fleet.rolling_restart()     # zero-downtime weight/config rollout
        fleet.close()

    ``builder`` names a zero-arg function (``module:fn`` or
    ``/path.py:fn``) that constructs the replica's engine inside the
    worker process — every replica builds identical weights from the
    same seeded recipe (or loads the same checkpoint), which is what
    makes failover replay continue the same greedy stream (bit for bit
    where the arithmetic is exact, as in fp32 on the CPU).

    Test seam: ``replicas=[...]`` (engine-shaped objects) runs the full
    dispatch/replay/hedge/brownout logic in-process with no spawning —
    the reliability protocol unit-tests without paying for processes.
    """

    def __init__(self, builder: Optional[str] = None, n_replicas: int = 2,
                 policy: Optional[ServingFleetPolicy] = None,
                 router_config: Optional[RouterConfig] = None,
                 names: Optional[Sequence[str]] = None,
                 flight_root: Optional[str] = None,
                 log_dir: Optional[str] = None,
                 extra_env: Optional[Dict[str, str]] = None,
                 eos_token_id: Optional[int] = None,
                 replicas: Optional[Sequence[Any]] = None,
                 name: str = "serving_fleet",
                 pools: Optional[Dict[str, Sequence[str]]] = None,
                 kv_transit: str = "fp32",
                 kv_cache_bytes: int = 256 << 20,
                 min_ship_tokens: int = 8,
                 prom_path: Optional[str] = None):
        from ..distributed.fleet.runtime import FleetStateMachine

        if flight_root is not None:
            raise NotImplementedError(_NO_FLIGHT_RECORDER)
        if prom_path is not None:
            raise NotImplementedError(_NO_TELEMETRY_PLANE)
        if replicas is None and not builder:
            raise ValueError("need a builder spec (process mode) or "
                             "replicas=[...] (in-process mode)")
        self.name = name
        self.builder = builder
        self.policy = policy or ServingFleetPolicy()
        self.router_config = router_config or RouterConfig()
        self.log_dir = log_dir
        self.extra_env = dict(extra_env or {})
        self.eos_token_id = eos_token_id
        self.metrics = MetricsRegistry()
        if replicas is not None:
            self._handles = [
                _ReplicaHandle(i, getattr(r, "name", f"replica{i}"),
                               external=r)
                for i, r in enumerate(replicas)]
        else:
            names = list(names or [f"replica{i}"
                                   for i in range(int(n_replicas))])
            self._handles = [_ReplicaHandle(i, n)
                             for i, n in enumerate(names)]
        self._external = replicas is not None
        # disaggregated prefill/decode: pools maps pool name ->
        # replica names; unlisted replicas belong to no pool and serve
        # only as the empty-pool fallback
        if kv_transit not in ("fp32", "int8"):
            raise ValueError("kv_transit must be 'fp32' or 'int8'")
        self.kv_transit = kv_transit
        self.min_ship_tokens = int(min_ship_tokens)
        self._pools_enabled = bool(pools)
        if pools:
            by_name = {h.name: h for h in self._handles}
            assigned: Dict[str, str] = {}
            for pool_name, members in pools.items():
                if pool_name not in ("prefill", "decode"):
                    raise ValueError(f"unknown pool {pool_name!r} "
                                     "(expected 'prefill'/'decode')")
                for m in members:
                    if m not in by_name:
                        raise ValueError(f"pool {pool_name!r} names "
                                         f"unknown replica {m!r}")
                    if m in assigned:
                        raise ValueError(
                            f"replica {m!r} is in two pools")
                    assigned[m] = pool_name
                    by_name[m].pool = pool_name
        self._kv_stats = KVMigrationStats()
        self._kv_cache = FleetKVCache(
            capacity_bytes=int(kv_cache_bytes))
        self._migrations: deque = deque()  # (req, prefill replica name)
        self.sm = FleetStateMachine(len(self._handles),
                                    self.policy.fleet_policy(),
                                    now=time.time())
        self._store = None
        self._lock = threading.RLock()
        self._req_no = itertools.count(1)
        self._requests: Dict[int, FleetRequest] = {}
        self._unplaced: deque = deque()
        self._inflight_total = 0
        self._tenant_inflight: Dict[str, int] = {}
        self._counters: Dict[str, int] = {}
        self._brownout = 0
        self._brownout_hist: List[Dict[str, Any]] = []
        self._beat_payload: Dict[int, float] = {}
        self._recoveries: List[Dict[str, Any]] = []
        self._closed = False
        self._monitor: Optional[threading.Thread] = None
        self._dispatcher: Optional[threading.Thread] = None

    def kv_migration_snapshot(self) -> Dict[str, Any]:
        """The page-migration view: pages/bytes shipped, transit-
        quantized fraction, install latency, the failover ship-vs-
        reprefill split, and the fleet-wide warm cache."""
        snap = self._kv_stats.snapshot()
        snap["transit"] = self.kv_transit
        snap["warm_cache"] = self._kv_cache.stats()
        with self._lock:
            snap["pools"] = {h.name: h.pool for h in self._handles
                             if h.pool is not None}
            snap["pending_migrations"] = len(self._migrations)
        return snap

    def _inc(self, counter: str, n: int = 1) -> None:
        with self._lock:  # re-entrant: callers may already hold it
            self._counters[counter] = self._counters.get(counter, 0) + n

    def provider_snapshot(self) -> Dict[str, Any]:
        """The fleet's anomaly view: per-replica health, the fence/
        restart timeline, hedge/replay/brownout counters, recovery
        wall-clock breakdowns."""
        now = time.time()
        with self._lock:
            reps = {}
            beats = dict(self.sm._beats)
            for h in self._handles:
                wv = None
                if h.client is not None:
                    if h.external:
                        wv = getattr(h.client, "weight_version", None)
                        if callable(wv):
                            wv = None  # only plain attributes, no I/O
                    else:  # cached probe value only: no RPC under lock
                        wv = h.client._probe_cache.get("weight_version")
                reps[h.name] = {
                    "state": h.state.value,
                    "incarnation": h.incarnation,
                    "pool": h.pool,
                    "inflight": len(h.inflight),
                    "routed": h.routed,
                    "routed_since_ready": h.routed_since_ready,
                    "weight_version": wv,
                    "last_beat_age_s": round(now - beats[h.idx], 3)
                    if h.idx in beats else None,
                }
            sm = self.sm.snapshot()
            return {
                "name": self.name,
                "replicas": reps,
                "counters": dict(self._counters),
                "inflight": self._inflight_total,
                "brownout": {"stage": self._brownout,
                             "stage_name": BROWNOUT_STAGES[self._brownout],
                             "history": list(self._brownout_hist)},
                "timeline": sm["timeline"],
                "rank_restarts": sm.get("rank_restarts", {}),
                "recoveries": list(self._recoveries),
                "unplaced": len(self._unplaced),
                "policy": {
                    "heartbeat_timeout": self.policy.heartbeat_timeout,
                    "max_restarts": self.policy.max_restarts,
                    "hedge_ms": self.policy.hedge_ms,
                    "replica_capacity": self.policy.replica_capacity,
                },
            }

    def stats(self) -> Dict[str, Any]:
        return self.provider_snapshot()

    # -- lifecycle ------------------------------------------------------------
    def start(self, wait_ready: bool = True,
              timeout: Optional[float] = None) -> "ServingFleet":
        if self._external:
            for h in self._handles:
                if hasattr(h.client, "start"):
                    h.client.start()
                h.state = ReplicaState.READY
                h.incarnation = 0
        else:
            from ..distributed.store import TCPStore

            self._store = TCPStore(is_master=True, world_size=1,
                                   timeout=60)
            for h in self._handles:
                self._spawn(h)
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name=f"pt-fleet-{self.name}",
                                         daemon=True)
        self._monitor.start()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop,
            name=f"pt-fleet-dispatch-{self.name}", daemon=True)
        self._dispatcher.start()
        if wait_ready and not self._external:
            self.wait_ready(timeout=timeout
                            or self.policy.start_timeout_s)
        return self

    def wait_ready(self, timeout: float = 180.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if all(h.state is ReplicaState.READY
                       for h in self._handles):
                    return
                if all(h.state in (ReplicaState.READY, ReplicaState.FAILED)
                       for h in self._handles) and \
                        any(h.state is ReplicaState.READY
                            for h in self._handles):
                    return
            time.sleep(0.05)
        states = {h.name: h.state.value for h in self._handles}
        raise TimeoutError(f"fleet not ready within {timeout}s: {states}")

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            live = list(self._requests.values())
            self._requests.clear()
            self._unplaced.clear()
            self._migrations.clear()
        for th in (self._monitor, self._dispatcher):
            if th is not None:
                th.join(timeout=5)
        for h in self._handles:
            c = h.client
            if c is not None and not h.external:
                try:
                    c.shutdown()
                except Exception:
                    pass
                try:
                    c.close()
                except Exception:
                    pass
            if h.external and hasattr(c, "close"):
                try:
                    c.close()
                except Exception:
                    pass
            if h.proc is not None and h.proc.poll() is None:
                try:
                    h.proc.terminate()
                except OSError:
                    pass
        for h in self._handles:
            if h.proc is not None:
                try:
                    h.proc.wait(timeout=10)
                except Exception:
                    try:
                        h.proc.kill()
                    except OSError:
                        pass
        if self._store is not None:
            try:
                self._store.close()
            except Exception:
                pass
        for req in live:
            if not req.future.done():
                req.future.set_exception(EngineClosed("fleet closed"))

    # -- spawning -------------------------------------------------------------
    def _spawn(self, h: _ReplicaHandle) -> None:
        """Launch one replica process (a fresh incarnation: fresh store
        keys, fresh log). The worker publishes its RPC port only after
        ``engine.warmup()`` — readiness means warmed buckets."""
        h.incarnation += 1
        for leaf in ("port", "beat"):
            key = f"svfleet/{h.name}/{h.incarnation}/{leaf}"
            self._store.delete_key(key)
            self._store.delete_key(f"{key}/published")
        self._beat_payload.pop(h.idx, None)
        env = dict(os.environ)
        env.update(self.extra_env)
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo_root + os.pathsep + \
            env.get("PYTHONPATH", "")
        env.update({
            "PT_REPLICA_NAME": h.name,
            "PT_REPLICA_INCARNATION": str(h.incarnation),
            "PT_REPLICA_BUILDER": self.builder,
            "PT_REPLICA_HB_INTERVAL": str(self.policy.heartbeat_interval),
            "PT_SERVING_FLEET_ENDPOINT": f"127.0.0.1:{self._store.port}",
        })
        log_fh = None
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            h.log_path = os.path.join(
                self.log_dir, f"{h.name}.{h.incarnation}.log")
            log_fh = open(h.log_path, "wb")
        h.proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.serving.fleet"], env=env,
            stdout=log_fh, stderr=subprocess.STDOUT if log_fh else None)
        if log_fh is not None:
            log_fh.close()  # the child holds its own fd
        h.state = ReplicaState.LAUNCHING
        h.t_launch = time.time()
        h.restart_at = None

    def _check_ready(self, h: _ReplicaHandle) -> None:
        from ..distributed.fleet.runtime import _probe_json

        info = _probe_json(
            self._store, f"svfleet/{h.name}/{h.incarnation}/port")
        if info is None:
            return
        try:
            client = ReplicaClient(
                h.name, "127.0.0.1", int(info["port"]),
                rpc_timeout_s=self.policy.rpc_timeout_s)
            client._probe(force=True)
        except Exception:
            return  # port published but not accepting yet: next poll
        with self._lock:
            if h.state is not ReplicaState.LAUNCHING:
                # fenced while we were connecting: stay fenced
                try:
                    client.close()
                except Exception:
                    pass
                return
            h.client = client
            h.state = ReplicaState.READY
            h.routed_since_ready = 0
            if h.fence_rec is not None:
                h.fence_rec["ready_ms"] = round(
                    (time.time() - h.fence_rec["fence_t"]) * 1e3, 1)
                h.fence_rec = None
            spec_off = self._brownout >= 1
        if spec_off:  # a replica restarted mid-brownout joins degraded
            try:
                client.set_spec(False)
            except Exception:
                pass

    # -- the monitor loops ----------------------------------------------------
    # TWO threads on purpose: supervision (beats, exits, staleness,
    # respawn) must never wait on a replica's socket — hedge/brownout/
    # retry DISPATCH does blocking probe RPCs, and one wedged replica
    # stalling those must not delay the stale-heartbeat fence past the
    # grace window (the detection-latency contract the drill pins).
    def _monitor_loop(self) -> None:
        while not self._closed:
            try:
                self._monitor_once(time.time())
            except Exception:
                pass  # supervision must outlive any single bad poll
            time.sleep(self.policy.poll_interval)

    def _dispatch_loop(self) -> None:
        while not self._closed:
            try:
                self._check_hedges()
                self._eval_brownout(time.time())
                self._drain_migrations()
                self._drain_unplaced()
            except Exception:
                pass
            time.sleep(self.policy.poll_interval)

    def _monitor_once(self, now: float) -> None:
        if not self._external:
            self._pump_beats()
            for h in list(self._handles):
                st = h.state
                rc = h.proc.poll() if h.proc is not None else None
                if st in (ReplicaState.READY, ReplicaState.DRAINING):
                    if rc is not None:
                        self._fence(h, cause="crash", rc=rc)
                elif st is ReplicaState.LAUNCHING:
                    if rc is not None:
                        self._fence(h, cause="launch_crash", rc=rc)
                    elif now - h.t_launch > self.policy.start_timeout_s:
                        self._fence(h, cause="start_timeout")
                    else:
                        self._check_ready(h)
            stale = set(self.sm.stale_ranks(now))
            for h in list(self._handles):
                if h.idx in stale and h.state in (ReplicaState.READY,
                                                  ReplicaState.DRAINING):
                    self._fence(h, cause="stale_heartbeat")
        for h in list(self._handles):
            if h.state is ReplicaState.RESTARTING and \
                    h.restart_at is not None and now >= h.restart_at:
                self._respawn(h)

    def _pump_beats(self) -> None:
        """Worker beats -> the state machine, on the SUPERVISOR's clock,
        deduped on the worker payload ts (a re-read beat is not a
        fresh one, whatever the two clocks say)."""
        from ..distributed.fleet.runtime import _probe_json

        now = time.time()
        for h in self._handles:
            if h.state not in (ReplicaState.LAUNCHING, ReplicaState.READY,
                               ReplicaState.DRAINING):
                continue
            beat = _probe_json(
                self._store, f"svfleet/{h.name}/{h.incarnation}/beat")
            if beat is None:
                continue
            try:
                ts = float(beat["ts"])
            except (KeyError, TypeError, ValueError):
                continue
            if self._beat_payload.get(h.idx) == ts:
                continue
            self._beat_payload[h.idx] = ts
            self.sm.heartbeat(h.idx, now)

    # -- fence + restart ------------------------------------------------------
    def _fence(self, h: _ReplicaHandle, cause: str,
               rc: Optional[int] = None) -> None:
        """Fence one replica: record it in the state machine timeline,
        fail over its in-flight requests (replay), and schedule a
        bounded-backoff restart. The survivors keep serving."""
        now = time.time()
        with self._lock:
            if h.state in (ReplicaState.FENCED, ReplicaState.RESTARTING,
                           ReplicaState.FAILED):
                return
            last_beat = self._beat_payload.get(h.idx)
            self.sm.replica_fence(h.idx, now, cause, rc=rc)
            self._inc("fences")
            h.state = ReplicaState.FENCED
            victims = list(h.inflight.values())
            h.inflight.clear()
            client = h.client
            if not h.external:
                h.client = None  # external objects stay for the respawn
            rec = {"replica": h.name, "cause": cause, "rc": rc,
                   "fence_t": now, "incarnation": h.incarnation,
                   "inflight_replayed": len(victims)}
            if cause == "stale_heartbeat" and last_beat is not None:
                rec["silent_s"] = round(now - last_beat, 3)
            self._recoveries.append(rec)
            h.fence_rec = rec  # closed with ready_ms at re-admission
            act = self.sm.replica_restart_decision(h.idx, now)
            if act.kind == "fail":
                h.state = ReplicaState.FAILED
                self._inc("failed_replicas")
            else:
                h.state = ReplicaState.RESTARTING
                h.restart_at = now + act.backoff_s
                h.count_restart = True
        # outside the lock: network teardown + replay dispatches
        if client is not None and not h.external:
            try:
                client.close()  # pending futures fail -> replay callbacks
            except Exception:
                pass
        if h.proc is not None and h.proc.poll() is None:
            try:
                h.proc.terminate()  # the hung-not-dead case
            except OSError:
                pass
        for asg in victims:
            self._assignment_failed(
                asg, ReplicaFault(f"replica {h.name} fenced: {cause}"))

    def fence_replica(self, name: str, cause: str = "operator") -> None:
        """Operator/test fence of one replica by name."""
        for h in self._handles:
            if h.name == name:
                self._fence(h, cause=cause)
                return
        raise KeyError(name)

    def _respawn(self, h: _ReplicaHandle) -> None:
        now = time.time()
        self.sm.replica_restarted(h.idx, now, count=h.count_restart)
        if h.external:
            # in-process seam: the replica object restarts itself
            replica = h.client
            if replica is not None:
                try:
                    if hasattr(replica, "restart"):
                        replica.restart()
                    elif hasattr(replica, "unfence"):
                        replica.unfence()
                except Exception:
                    pass
                with self._lock:
                    h.state = ReplicaState.READY
                    h.routed_since_ready = 0
                    h.restart_at = None
                    h.incarnation += 1
                    if h.fence_rec is not None:
                        h.fence_rec["ready_ms"] = round(
                            (now - h.fence_rec["fence_t"]) * 1e3, 1)
                        h.fence_rec = None
            if h.count_restart:
                self._inc("restarts")
            return
        with self._lock:
            if h.state is not ReplicaState.RESTARTING:
                return
        self._spawn(h)
        if h.count_restart:  # planned rolls spend no budget, count apart
            self._inc("restarts")

    # -- assignment lifecycle -------------------------------------------------
    def _on_tok(self, asg: _Assignment, t: int, lp=None) -> None:
        """One streamed token from a replica. Only the PRIMARY
        assignment advances the client-visible ledger — the dedup rule
        that makes failover exactly-once per token. A cross-version
        re-prefill (``asg.repin``) re-walks positions the ledger
        already holds; those dedup BY POSITION instead of extending."""
        deliver = False
        with self._lock:
            req = asg.req
            if asg.cancelled or req.done:
                return
            asg.tokens.append(int(t))
            if lp is not None:
                asg.lps.append(float(lp))
            asg.t_last = time.monotonic()
            if asg is req.primary:
                idx = (len(asg.prefix) - len(req.prompt)) + \
                    len(asg.tokens) - 1
                if idx == len(req.emitted):
                    req.emitted.append(int(t))
                    if req.want_lp:
                        req.emitted_lp.append(
                            0.0 if lp is None else float(lp))
                    deliver = True
        if deliver:
            self._deliver_stream(req)

    def _deliver_stream(self, req: FleetRequest) -> None:
        """Drain undelivered ledger tokens to the client callback IN
        ORDER. Racing rx threads (a primary token callback vs a hedge
        completion bulk-delivering the tail) serialize on the
        per-request stream lock and hand over the undelivered suffix —
        a preempted earlier caller can never deliver its token after a
        later one (the exactly-once-in-order stream contract)."""
        cb = req.on_token
        if cb is None:
            return
        with req.stream_lock:
            while True:
                with self._lock:
                    if req.delivered >= len(req.emitted):
                        return
                    t = req.emitted[req.delivered]
                    lp = None
                    if req.want_lp and \
                            req.delivered < len(req.emitted_lp):
                        lp = req.emitted_lp[req.delivered]
                    req.delivered += 1
                try:
                    if req.want_lp:
                        cb(int(t), lp)
                    else:
                        cb(int(t))
                except Exception:
                    pass

    def _asg_done_cb(self, asg: _Assignment, fut: Future) -> None:
        exc = fut.exception()
        if exc is None:
            self._assignment_completed(asg, fut.result())
        else:
            self._assignment_failed(asg, exc)

    def _assignment_completed(self, asg: _Assignment, res) -> None:
        cancel_target: Optional[Tuple[Any, Future]] = None
        if isinstance(res, tuple):  # (seq, behavior logprobs)
            seq, seq_lp = res
        else:
            seq, seq_lp = res, None
        with self._lock:
            req = asg.req
            for h in self._handles:
                if h.name == asg.replica:
                    h.inflight.pop(req.id, None)
            if req.done or asg.cancelled:
                return
            gen_prefix = len(asg.prefix) - len(req.prompt)
            full_gen = list(asg.prefix[len(req.prompt):]) + \
                [int(t) for t in seq[len(asg.prefix):]]
            if full_gen[:len(req.emitted)] != req.emitted:
                # greedy determinism makes this impossible WITHIN one
                # weight version; a cross-version re-prefill (repin)
                # may legitimately diverge — either way the completed
                # result is authoritative over the partial stream
                self._inc("version_restitch" if asg.repin
                          else "stream_mismatch")
            req.emitted = full_gen
            if req.want_lp:
                # rebuild the logprob ledger the same way: ledger
                # entries for the dispatch prefix + this assignment's
                # logprobs for everything it generated
                tail = [] if seq_lp is None else \
                    [float(x) for x in seq_lp]
                req.emitted_lp = \
                    list(req.emitted_lp[:gen_prefix]) + tail
            handoff = False
            if asg.stage == "prefill":
                work_left = len(req.emitted) < req.max_new and not (
                    self.eos_token_id is not None and req.emitted and
                    req.emitted[-1] == self.eos_token_id)
                if work_left:
                    # the prefill leg is done — the prompt's paged KV
                    # is hot on this replica. Hand the request to the
                    # migration queue (ship pages -> decode pool)
                    # instead of finishing it; the dispatcher thread
                    # owns the blocking transfer RPCs.
                    handoff = True
                    req.primary = None
                    self._migrations.append((req, asg.replica))
            if not handoff:
                other = req.hedge if asg is req.primary else req.primary
                if other is not None and other is not asg:
                    other.cancelled = True
                    owner = self._handle_by_name(other.replica)
                    if owner is not None:
                        owner.inflight.pop(req.id, None)
                    if other.fut is not None and owner is not None and \
                            owner.client is not None and \
                            hasattr(owner.client, "cancel"):
                        cancel_target = (owner.client, other.fut)
                    self._inc("hedge_cancelled")
                if asg.hedge:
                    self._inc("hedge_wins")
                self._finish_locked(req)
        # undelivered tail (a hedge win bulk-delivers it) goes through
        # the ordered per-request delivery path, BEFORE the future
        # resolves
        self._deliver_stream(req)
        if handoff:
            self._inc("prefill_handoffs")
            return
        if cancel_target is not None:
            try:
                cancel_target[0].cancel(cancel_target[1])
            except Exception:
                pass
        self._set_result(req)
        self.metrics.observe_latency(
            (time.monotonic() - req.t_submit) * 1e3)
        self.metrics.mark_done()
        self._inc("completed")

    def _set_result(self, req: FleetRequest) -> None:
        """Resolve the request future from the ledger (safe outside the
        lock once ``req.done`` — the ledger no longer mutates)."""
        if req.future.done():
            return
        result = np.asarray(list(req.prompt) + req.emitted,
                            dtype=np.int64)
        if req.want_lp:
            req.future.set_result(
                (result, np.asarray(req.emitted_lp, dtype=np.float32)))
        else:
            req.future.set_result(result)

    def _assignment_failed(self, asg: _Assignment, exc: Exception) -> None:
        with self._lock:
            req = asg.req
            owner = self._handle_by_name(asg.replica)
            if owner is not None:
                cur = owner.inflight.get(req.id)
                if cur is asg:
                    owner.inflight.pop(req.id, None)
            if req.done or asg.cancelled:
                return
            if isinstance(exc, RequestCancelled):
                return  # fleet-initiated: the winner already resolved
            if asg.hedge:
                # a failed hedge is not a failed request: the primary
                # continues; just clear the hedge slot
                if req.hedge is asg:
                    req.hedge = None
                return
            if req.primary is not asg:
                return  # already replayed by the fence path
        kind = classify_submit_error(exc)
        if kind == "request":
            self._fail_request(req, exc)
            return
        if kind == "fault":
            # the RPC layer noticed the dead replica before the monitor
            # did (lost connection mid-request) — same fence, faster
            owner = self._handle_by_name(asg.replica)
            if owner is not None:
                self._fence(owner, cause="rpc_fault")
        # fault or busy: re-dispatch the request onto a survivor with
        # the already-streamed prefix (hedged re-prefill / replay)
        self._replay(req, asg, count=kind == "fault")

    def _handle_by_name(self, name: str) -> Optional[_ReplicaHandle]:
        for h in self._handles:
            if h.name == name:
                return h
        return None

    def _fail_request(self, req: FleetRequest, exc: Exception) -> None:
        with self._lock:
            if req.done:
                return
            self._finish_locked(req)
        if not req.future.done():
            req.future.set_exception(exc)
        self._inc("failed")

    def _finish_locked(self, req: FleetRequest) -> None:
        req.done = True
        self._requests.pop(req.id, None)
        self._inflight_total = max(self._inflight_total - 1, 0)
        n = self._tenant_inflight.get(req.tenant, 0)
        if n > 0:
            self._tenant_inflight[req.tenant] = n - 1

    def _replay(self, req: FleetRequest, dead: Optional[_Assignment],
                count: bool = True) -> None:
        """Failover: resubmit ``prompt + emitted`` onto a survivor. The
        prefix cache re-prefills the shared part; the emitted ledger
        guarantees the client stream neither repeats nor loses a
        token."""
        with self._lock:
            if req.done:
                return
            if dead is not None and req.primary is not dead:
                return  # a newer assignment already owns the request
            if count:
                req.replays += 1
                self._inc("replays")
            remaining = req.max_new - len(req.emitted)
            if remaining <= 0 or (
                    self.eos_token_id is not None and req.emitted and
                    req.emitted[-1] == self.eos_token_id):
                # everything was already streamed; only the done frame
                # was lost in the crash — complete from the ledger
                self._finish_locked(req)
                ledger_done = True
            else:
                ledger_done = False
            exclude = {dead.replica} if dead is not None else set()
            if req.hedge is not None:
                # the hedge keeps racing on its replica: the replayed
                # primary must land elsewhere (one assignment per
                # replica per request — the inflight map's key)
                exclude.add(req.hedge.replica)
        if ledger_done:
            # every token was already streamed: only the done frame was
            # lost — complete from the ledger
            self._deliver_stream(req)  # any undelivered ledger tail
            self._set_result(req)
            self._inc("completed")
            self._inc("replayed_complete")
            return
        prefer = self._ship_failover(req, exclude) if count else None
        if prefer is not None:
            ok = self._dispatch(req, exclude=exclude, pool="decode",
                                prefer=prefer)
        else:
            ok = self._place(req, exclude=exclude)
        if not ok:
            with self._lock:
                if not req.done:
                    self._unplaced.append(req)

    def _ship_failover(self, req: FleetRequest,
                       exclude=()) -> Optional[str]:
        """The stitch-replay fast path: when the request still holds a
        shipped KV payload, install it on a survivor BEFORE the replay
        dispatch — the survivor's prefix cache absorbs the prompt pages
        and the replay re-prefills only the emitted suffix (bytes
        instead of recompute). Returns the preferred survivor name, or
        None (classic re-prefill)."""
        with self._lock:
            payload = req.kv_payload
        if payload is None:
            self._kv_stats.note_failover(ship=False)
            self._inc("failover_reprefill")
            return None
        pool = "decode" if self._pools_enabled else None
        for h, client in self._candidates(exclude=exclude, pool=pool):
            try:
                rep = self._kv_push(client, payload)
            except Exception:
                continue
            self._kv_stats.note_failover(ship=True)
            self._kv_stats.note_ship(
                payload["npages"], payload["wire_bytes"],
                payload["fp32_bytes"], payload["quantized"])
            self._kv_stats.note_install(float(rep.get("ms", 0.0)))
            self._inc("failover_ship")
            return h.name
        self._kv_stats.note_failover(ship=False)
        self._inc("failover_reprefill")
        return None

    # -- kv page migration (the prefill -> decode handoff) --------------------
    def _drain_migrations(self) -> None:
        while True:
            with self._lock:
                if not self._migrations:
                    return
                req, src = self._migrations.popleft()
                if req.done:
                    continue
            self._migrate_and_continue(req, src)

    def _kv_pull(self, client, prompt: List[int],
                 quantize: bool) -> Dict[str, Any]:
        """Export the packed pages for ``prompt`` from a replica: the
        chunked RPC on process replicas, a direct pack through the
        in-process seam."""
        if hasattr(client, "kv_export"):
            return client.kv_export(prompt, quantize=quantize)
        from .kv_transfer import pack_kv_pages  # lazy

        _n, k_st, v_st = client.export_kv_pages(
            np.asarray(prompt, dtype=np.int64))
        blob, manifest, meta = pack_kv_pages(k_st, v_st,
                                             quantize=quantize)
        return {"prompt": [int(x) for x in prompt],
                "manifest": manifest, "digest": meta["digest"],
                "data": blob, "npages": int(meta["npages"]),
                "wire_bytes": int(meta["wire_bytes"]),
                "fp32_bytes": int(meta["fp32_bytes"]),
                "quantized": bool(meta["quantized"]),
                "chunks": 1}

    def _kv_push(self, client, payload: Dict[str, Any]) -> Dict[str, Any]:
        if hasattr(client, "kv_install"):
            return client.kv_install(payload)
        from .kv_transfer import unpack_kv_pages  # lazy

        t0 = time.monotonic()
        k_st, v_st = unpack_kv_pages(payload["data"],
                                     payload["manifest"])
        installed = client.install_kv_pages(
            np.asarray(payload["prompt"], dtype=np.int64), k_st, v_st)
        return {"installed": int(installed),
                "ms": round((time.monotonic() - t0) * 1e3, 3)}

    def _migrate_and_continue(self, req: FleetRequest, src: str) -> None:
        """Move a prefilled request onto the decode pool: pull the
        packed pages from the prefill replica (or the fleet warm
        cache), install them on the best decode replica, then dispatch
        the decode leg preferring that replica. EVERY failure mode
        falls back to plain dispatch — the decode replica re-prefills
        ``prompt + first token`` and the stream stays bit-identical,
        just slower."""
        quantize = self.kv_transit == "int8"
        key = prompt_cache_key(req.prompt, 1)  # whole-prompt identity
        payload = self._kv_cache.get(key) if key is not None else None
        if payload is not None:
            self._kv_stats.note_warm_hit()
        else:
            with self._lock:
                h = self._handle_by_name(src)
                client = h.client if h is not None and \
                    h.state is ReplicaState.READY else None
            if client is not None:
                try:
                    payload = self._kv_pull(client, list(req.prompt),
                                            quantize)
                    self._kv_stats.note_export()
                    if key is not None:
                        self._kv_cache.put(key, payload)
                except Exception:
                    payload = None
        prefer = None
        if payload is not None:
            pool = "decode" if self._pools_enabled else None
            cands = self._candidates(exclude={src}, pool=pool)
            parr = np.asarray(req.prompt, dtype=np.int64)
            try:
                scores, _m = score_candidates(
                    self.router_config, parr,
                    [c for _h, c in cands], pool=pool)
                order = sorted(range(len(cands)),
                               key=scores.__getitem__)
            except Exception:
                order = list(range(len(cands)))
            for i in order:
                h, client = cands[i]
                try:
                    rep = self._kv_push(client, payload)
                except Exception:
                    continue
                prefer = h.name
                self._kv_stats.note_ship(
                    payload["npages"], payload["wire_bytes"],
                    payload["fp32_bytes"], payload["quantized"])
                self._kv_stats.note_install(float(rep.get("ms", 0.0)))
                with self._lock:
                    req.kv_payload = payload
                self._inc("migrations")
                break
        if prefer is None:
            # the fallback re-prefill leg: the decode dispatch below
            # re-prefills from the prompt and the stream continues
            self._kv_stats.note_fallback()
            self._inc("migrate_fallback")
        if not self._dispatch(
                req, pool="decode" if self._pools_enabled else None,
                prefer=prefer):
            with self._lock:
                if not req.done:
                    self._unplaced.append(req)

    # -- dispatch -------------------------------------------------------------
    def _candidates(self, exclude=(), pool: Optional[str] = None
                    ) -> List[Tuple[_ReplicaHandle, Any]]:
        """(handle, client) pairs captured atomically — a concurrent
        fence nulls ``h.client``, so the submit below must use the
        reference taken HERE (a submit on a just-fenced client fails
        with the fault shape and the loop moves on). With ``pool`` set
        (split fleets) only that pool's replicas qualify; an EMPTY pool
        falls back to every ready replica (counted) — a dead prefill
        tier degrades to the classic fused path, not unavailability."""
        with self._lock:
            ready = [(h, h.client) for h in self._handles
                     if h.state is ReplicaState.READY
                     and h.client is not None and h.name not in exclude]
            if pool is not None and self._pools_enabled:
                pooled = [(h, c) for h, c in ready if h.pool == pool]
                if pooled:
                    return pooled
                if ready:
                    self._inc("pool_fallback")
            return ready

    def _dispatch(self, req: FleetRequest, exclude=(),
                  hedge: bool = False, pool: Optional[str] = None,
                  cap_new: Optional[int] = None, stage: str = "decode",
                  prefer: Optional[str] = None) -> bool:
        """Place one request (or its hedge) on the best ready replica —
        the router's load/affinity scoring over live probes, plus the
        fence-and-retry loop with classified errors. Returns False when
        no replica could take it (caller queues it)."""
        tried: set = set(exclude)
        while True:
            cands = self._candidates(exclude=tried, pool=pool)
            if not cands:
                return False
            with self._lock:
                if req.done:
                    return True
                pin = req.weight_version if req.emitted else None
                prefix = list(req.prompt) + list(req.emitted)
                remaining = req.max_new - len(req.emitted)
            repin = False
            if pin is not None and pin >= 0:
                # stitch-replay must be VERSION-PURE: resuming
                # prompt+emitted onto a replica serving different
                # weights would continue a v-N prefix under v-M — a
                # sequence neither version produces. Prefer a same-
                # version survivor; with none left, re-prefill from the
                # prompt alone on the new version (position-deduped
                # against the streamed ledger, counted below).
                vers = [self._replica_version(c) for _h, c in cands]
                same = [i for i, v in enumerate(vers) if v == pin]
                if same:
                    cands = [cands[i] for i in same]
                else:
                    repin = True
                    prefix = list(req.prompt)
                    remaining = req.max_new
            if cap_new is not None:
                # the prefill leg: emit exactly one token — the point
                # is the paged KV it leaves behind, not the stream
                remaining = min(remaining, int(cap_new))
            if remaining <= 0:
                self._replay(req, None, count=False)
                return True
            deadline_ms = None
            if req.deadline is not None:
                deadline_ms = (req.deadline - time.monotonic()) * 1e3
                if deadline_ms <= 0:
                    self._fail_request(req, DeadlineExceeded(
                        "deadline expired before placement"))
                    return True
            parr = np.asarray(prefix, dtype=np.int64)
            try:
                scores, _m = score_candidates(
                    self.router_config, parr, [c for _h, c in cands],
                    pool=pool)
            except Exception:
                scores = [float(i) for i in range(len(cands))]
            order = sorted(range(len(cands)), key=scores.__getitem__)
            if prefer is not None:
                # the migration path already installed this request's
                # pages on `prefer`: try it first, scores after
                pi = [i for i in order if cands[i][0].name == prefer]
                order = pi + [i for i in order if i not in pi]
            progressed = False
            for i in order:
                h, client = cands[i]
                asg = _Assignment(req, h.name, prefix, hedge=hedge,
                                  repin=repin, stage=stage)
                with self._lock:
                    if req.done:
                        return True
                    # the stream callback checks identity against
                    # req.primary/hedge — install BEFORE the submit so
                    # the first token frame cannot race the assignment
                    if hedge:
                        req.hedge = asg
                    else:
                        req.primary = asg
                kw: Dict[str, Any] = {}
                if req.want_lp:
                    # only pass the kwarg when asked: the test seam's
                    # engine-shaped stubs keep their narrow signature
                    kw["return_logprobs"] = True
                try:
                    fut = client.submit(
                        parr, remaining, deadline_ms=deadline_ms,
                        on_token=partial(self._on_tok, asg), **kw)
                except Exception as e:
                    kind = classify_submit_error(e)
                    with self._lock:
                        if hedge and req.hedge is asg:
                            req.hedge = None
                    if kind == "busy":
                        continue
                    if kind == "request":
                        if hedge:
                            return True  # the primary is still running
                        self._fail_request(req, e)
                        return True
                    tried.add(h.name)
                    self._fence(h, cause="submit_fault")
                    progressed = True
                    break
                asg.fut = fut
                # a probe-cached RPC: outside the lock
                wv = self._replica_version(client)
                with self._lock:
                    h.inflight[req.id] = asg
                    h.routed += 1
                    h.routed_since_ready += 1
                    if not hedge and \
                            (repin or len(prefix) == len(req.prompt)):
                        # the emitted prefix (re)starts under THIS
                        # replica's weights: (re)pin the version
                        req.weight_version = wv
                    if repin:
                        self._inc("version_reprefill")
                fut.add_done_callback(partial(self._asg_done_cb, asg))
                return True
            if not progressed:
                return False

    @staticmethod
    def _replica_version(client) -> int:
        """Best-effort weight generation a replica serves: the probe-
        cached RPC accessor on ReplicaClient, the plain attribute on an
        in-process engine; -1 when unknowable."""
        try:
            wv = getattr(client, "weight_version", None)
            if callable(wv):
                wv = wv()
            if wv is None:
                return -1
            return int(wv)
        except Exception:
            return -1

    def _place(self, req: FleetRequest, exclude=()) -> bool:
        """Route one request through the pool topology: a fresh request
        starts on the prefill pool, capped to ONE token (the leg that
        fills paged KV), then migrates to the decode pool; anything
        with streamed progress, short prompts not worth a ship, and
        unsplit fleets go straight to the decode path."""
        if self._pools_enabled and not req.emitted and not req.done \
                and req.max_new > 1 \
                and len(req.prompt) >= self.min_ship_tokens:
            with self._lock:
                has_prefill = any(
                    h.pool == "prefill"
                    and h.state is ReplicaState.READY
                    and h.name not in exclude for h in self._handles)
            if has_prefill:
                return self._dispatch(req, exclude=exclude,
                                      pool="prefill", cap_new=1,
                                      stage="prefill")
        return self._dispatch(
            req, exclude=exclude,
            pool="decode" if self._pools_enabled else None)

    # -- submission -----------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int = 16,
               tenant: str = "default",
               deadline_ms: Optional[float] = None, priority: int = 1,
               on_token=None, return_logprobs: bool = False) -> Future:
        """Route one prompt through the fleet. The future resolves to
        the full sequence (prompt + generated, np.int64) and SURVIVES
        replica failure: a fenced replica's in-flight work replays onto
        a survivor with the streamed prefix deduped. ``on_token`` (if
        given) streams each generated token exactly once, in order.
        ``priority`` feeds stage-3 brownout shedding: work below
        ``brownout_keep_priority`` (default 1) is sheddable — the
        default priority 1 opts OUT, so only explicitly low-priority
        traffic is ever dropped. With ``return_logprobs=True`` the
        future resolves to ``(full_seq, behavior_logprobs)`` (the
        per-token logprob ledger, float32, replay-identical across
        failover) and ``on_token`` receives ``(token, logprob)``."""
        prompt = np.asarray(prompt_ids).reshape(-1)
        if prompt.size == 0 or \
                not np.issubdtype(prompt.dtype, np.integer):
            raise BadRequest(
                "prompt must be a non-empty 1-D integer array")
        if max_new_tokens < 1:
            raise BadRequest("max_new_tokens must be >= 1")
        self.metrics.inc("requests_total")
        with self._lock:
            if self._closed:
                raise EngineClosed("fleet closed")
            stage = self._brownout
            if brownout_sheds(stage, priority, self.policy):
                self._inc("shed_brownout")
                raise BrownoutShed(
                    f"brownout stage {stage}: priority {priority} shed")
            if self._inflight_total >= self.router_config.max_inflight:
                self._inc("rejected_capacity")
                raise QueueFull(
                    f"fleet at capacity "
                    f"({self.router_config.max_inflight})")
            quota = self.router_config.quota_for(tenant)
            if quota is not None and \
                    self._tenant_inflight.get(tenant, 0) >= quota:
                self._inc("rejected_quota")
                from .router import TenantQuotaExceeded

                raise TenantQuotaExceeded(
                    f"tenant {tenant!r} at quota ({quota})")
            clamped = brownout_max_new(stage, deadline_ms,
                                       int(max_new_tokens), self.policy)
            if clamped != max_new_tokens:
                self._inc("clamped")
            req = FleetRequest(next(self._req_no),
                               [int(x) for x in prompt], clamped,
                               deadline_ms, tenant, priority,
                               on_token=on_token,
                               want_lp=return_logprobs)
            self._requests[req.id] = req
            self._inflight_total += 1
            self._tenant_inflight[tenant] = \
                self._tenant_inflight.get(tenant, 0) + 1
            self._inc("requests")
        if not self._place(req):
            with self._lock:
                if not req.done:
                    self._unplaced.append(req)
        return req.future

    def _drain_unplaced(self) -> None:
        """Retry requests that had no ready replica at submit/replay
        time (e.g. mid-recovery with every survivor briefly saturated)."""
        while True:
            with self._lock:
                if not self._unplaced:
                    return
                req = self._unplaced.popleft()
                if req.done:
                    continue
            if req.deadline is not None and \
                    time.monotonic() > req.deadline:
                self._fail_request(req, DeadlineExceeded(
                    "deadline expired while awaiting a replica"))
                continue
            if not self._place(req):
                with self._lock:
                    if not req.done:
                        self._unplaced.appendleft(req)
                return

    # -- hedging --------------------------------------------------------------
    def _check_hedges(self) -> None:
        """Tail-latency insurance: a request whose primary has made no
        token progress for ``hedge_ms`` gets ONE speculative second
        submission on a different replica; first completion wins and
        the loser is cancelled."""
        hedge_ms = self.policy.hedge_ms
        if hedge_ms is None:
            return
        now = time.monotonic()
        with self._lock:
            due = [r for r in self._requests.values()
                   if not r.done and r.hedge is None
                   and r.primary is not None and r.primary.fut is not None
                   and r.primary.stage != "prefill"
                   and (now - r.primary.t_last) * 1e3 >= hedge_ms]
        for req in due:
            with self._lock:
                if req.done or req.hedge is not None or \
                        req.primary is None:
                    continue
                exclude = {req.primary.replica}
            if self._dispatch(req, exclude=exclude, hedge=True,
                              pool="decode" if self._pools_enabled
                              else None):
                with self._lock:
                    if req.hedge is not None:
                        self._inc("hedges")

    # -- brownout -------------------------------------------------------------
    def _eval_brownout(self, now: float) -> None:
        with self._lock:
            ready = [h for h in self._handles
                     if h.state is ReplicaState.READY]
            if not ready:
                return  # mid-outage: nothing to degrade; the unplaced
                # queue's deadlines own the overload story
            cap = max(1, len(ready) * self.policy.replica_capacity)
            load = self._inflight_total / cap
            prev = self._brownout
            stage = brownout_stage(prev, load, self.policy)
            if stage == prev:
                return
            self._brownout = stage
            self._inc("brownout_transitions")
            self._brownout_hist.append(
                {"t": round(now, 3), "stage": stage,
                 "name": BROWNOUT_STAGES[stage], "load": round(load, 3)})
            if len(self._brownout_hist) > 256:
                del self._brownout_hist[:-256]
            self.sm.note("brownout", now, stage=stage,
                         load=round(load, 3))
            flip_spec = (stage >= 1) != (prev >= 1)
            spec_on = stage < 1
            targets = [h.client for h in ready] if flip_spec else []
        if stage >= 3:
            self._shed_unplaced()
        for c in targets:  # stage-1 lever: speculation off fleet-wide
            try:
                if hasattr(c, "set_spec"):
                    c.set_spec(spec_on)
                elif hasattr(c, "set_speculative"):
                    c.set_speculative(spec_on)
            except Exception:
                pass

    def _shed_unplaced(self) -> None:
        with self._lock:
            keep, shed = deque(), []
            while self._unplaced:
                r = self._unplaced.popleft()
                if brownout_sheds(3, r.priority, self.policy):
                    shed.append(r)
                else:
                    keep.append(r)
            self._unplaced = keep
        for r in shed:
            self._inc("shed_brownout")
            self._fail_request(r, BrownoutShed(
                "brownout stage 3: queued low-priority request shed"))

    def brownout(self) -> Dict[str, Any]:
        with self._lock:
            return {"stage": self._brownout,
                    "name": BROWNOUT_STAGES[self._brownout],
                    "history": list(self._brownout_hist)}

    # -- the fleet telemetry plane (not ported) -------------------------------
    def fleet_telemetry_snapshot(self) -> Dict[str, Any]:
        raise NotImplementedError(_NO_TELEMETRY_PLANE)

    def slo_snapshot(self) -> Dict[str, Any]:
        raise NotImplementedError(_NO_TELEMETRY_PLANE)

    def scrape_now(self) -> Dict[str, Any]:
        raise NotImplementedError(_NO_TELEMETRY_PLANE)

    def export_fleet_trace(self, path: str) -> str:
        raise NotImplementedError(_NO_TELEMETRY_PLANE)

    # -- weight distribution --------------------------------------------------
    def subscribe_weights(self, host: str, port: int,
                          poll_interval: float = 0.25) -> None:
        raise NotImplementedError(_NO_WEIGHT_SERVICE)

    def replica_weight_versions(self) -> Dict[str, int]:
        """Live per-replica weight versions (one probe RPC per ready
        replica) — the rollout loop's barrier: after a publish, wait
        until every ready replica serves the new version before the
        next round. -1 marks a replica whose version is unknown."""
        with self._lock:
            targets = [(h.name, h.client) for h in self._handles
                       if h.state is ReplicaState.READY
                       and h.client is not None]
        out: Dict[str, int] = {}
        for name, client in targets:
            wv = getattr(client, "weight_version", None)
            try:
                out[name] = int(wv() if callable(wv) else wv)
            except Exception:
                out[name] = -1
        return out

    def push_weights(self, state, version: Optional[int] = None) -> Dict:
        """Directly swap ``state`` into every ready replica via
        ``engine.swap_weights()`` (the in-process seam / test path —
        process fleets push through the publisher/subscriber stream,
        which the port has not yet). Replicas whose engine cannot swap
        in place fall back to ``rolling_restart()``: the slow path costs a respawn, the
        builder re-creating the engine with current weights."""
        with self._lock:
            targets = [(h, h.client) for h in self._handles
                       if h.state is ReplicaState.READY
                       and h.client is not None]
        swapped: List[Dict[str, Any]] = []
        fallback = False
        for h, client in targets:
            fn = getattr(client, "swap_weights", None)
            if fn is None:
                fallback = True
                continue
            try:
                ver = fn(state, version=version)
                swapped.append({"replica": h.name, "version": int(ver)})
            except NotImplementedError:
                fallback = True
            except Exception as e:
                swapped.append({"replica": h.name,
                                "error": str(e)[:200]})
        self._inc("weight_pushes")
        out: Dict[str, Any] = {"swapped": swapped, "fallback": fallback}
        if fallback:
            out["rolled"] = self.rolling_restart()
        return out

    def apply_serving_shape(self, shape: Dict[str, Any]) -> Dict:
        raise NotImplementedError(_NO_SHAPE_TUNER)

    # -- rolling restart ------------------------------------------------------
    def rolling_restart(self, drain_timeout_s: Optional[float] = None,
                        ready_timeout_s: Optional[float] = None) -> Dict:
        """Zero-downtime rollout: one replica at a time — fence new
        work, finish its in-flight requests, restart the process, wait
        for it to warm and re-admit, then move on. Requests keep
        flowing through the other replicas the whole time; a planned
        roll spends NO restart budget."""
        drain_s = drain_timeout_s or self.policy.drain_timeout_s
        ready_s = ready_timeout_s or self.policy.start_timeout_s
        rolled = []
        for h in list(self._handles):
            if h.state is ReplicaState.FAILED:
                continue
            # a replica mid-recovery (fenced/restarting/launching) is
            # waited for, not skipped — the roll must cover the fleet
            deadline = time.monotonic() + ready_s
            while time.monotonic() < deadline:
                with self._lock:
                    if h.state in (ReplicaState.READY,
                                   ReplicaState.FAILED):
                        break
                time.sleep(self.policy.poll_interval)
            t0 = time.time()
            with self._lock:
                if h.state is not ReplicaState.READY:
                    continue  # stayed down past the wait: fence owns it
                h.state = ReplicaState.DRAINING
            self.sm.note("roll_drain", t0, rank=h.idx, replica=h.name)
            client = h.client
            try:  # engine-side fence too (belt and braces)
                if hasattr(client, "drain"):
                    client.drain()
                elif hasattr(client, "fence"):
                    client.fence()
            except Exception:
                pass
            deadline = time.monotonic() + drain_s
            while time.monotonic() < deadline:
                with self._lock:
                    if not h.inflight:
                        break
                time.sleep(self.policy.poll_interval)
            with self._lock:
                leftovers = list(h.inflight.values())
                h.inflight.clear()
                h.state = ReplicaState.RESTARTING
                h.restart_at = None       # the roll owns the respawn
                h.count_restart = False   # planned: no budget spent
            for asg in leftovers:  # drain window expired: fail over
                self._assignment_failed(asg, ReplicaFault(
                    f"replica {h.name} drain timeout during roll"))
            if not self._external:
                try:
                    client.shutdown()
                except Exception:
                    pass
                try:
                    client.close()
                except Exception:
                    pass
                if h.proc is not None:
                    try:
                        h.proc.wait(timeout=15)
                    except Exception:
                        try:
                            h.proc.terminate()
                        except OSError:
                            pass
            self._respawn(h)
            deadline = time.monotonic() + ready_s
            while time.monotonic() < deadline:
                with self._lock:
                    if h.state is ReplicaState.READY:
                        break
                    if h.state in (ReplicaState.FENCED,
                                   ReplicaState.FAILED):
                        break
                time.sleep(0.05)
            with self._lock:
                ok = h.state is ReplicaState.READY
            self.sm.note("roll_done", time.time(), rank=h.idx,
                         replica=h.name, ok=ok,
                         ms=round((time.time() - t0) * 1e3, 1))
            self._inc("rolled_replicas")
            rolled.append({"replica": h.name, "ok": ok,
                           "incarnation": h.incarnation})
            if not ok:
                break
        self._inc("rolling_restarts")
        return {"rolled": rolled,
                "ok": all(r["ok"] for r in rolled) and bool(rolled)}


if __name__ == "__main__":  # the replica worker entry
    sys.exit(replica_main())

