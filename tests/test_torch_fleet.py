"""The port's multi-process serving fleet (``paddle_tpu_torch/serving/
fleet.py``) against the JAX package's: frames byte for byte and read
across packages, the pure brownout/replay helpers, the fleet's reliability
logic over the same fake replicas (replay dedup, the lost done frame,
hedging, brownout, rolling restart, quotas, close), in-process fleets over
real engines (tokens, a fence mid-stream, prefill/decode pools over fp32
and int8 transit), each package's client against the other's replica
server, a real two-process fleet of port replicas through a crash, and
the engines' chaos sites."""
import os
import socket
import struct
import subprocess
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu.serving import fleet as jfleet
from paddle_tpu.serving import kv_transfer as jkv
from paddle_tpu_torch import serving as pserving
from paddle_tpu_torch.serving import fleet as pfleet
from paddle_tpu_torch.serving import kv_transfer as pkv
from test_torch_gpt import SMALL, make_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"jax": (jserving, jfleet), "port": (pserving, pfleet)}


# -- wire protocol ------------------------------------------------------------

def _messages():
    blob = np.random.default_rng(0).bytes(3000)
    return [
        {"op": "submit", "rid": 1, "prompt": [1, 2, 3],
         "max_new_tokens": 16, "deadline_ms": None},
        {"rid": np.int64(2), "event": "token", "t": np.int32(7),
         "lp": np.float32(-0.25)},
        {"rid": 3, "event": "done", "seq": np.arange(4, dtype=np.int64),
         "lp": np.linspace(-1, 0, 3).astype(np.float64)},
        {"rid": 4, "event": "reply", "nested": {"a": [1, {"b": 2.5}],
                                                "ok": True, "none": None},
         "text": "éé \"quoted\""},
        dict(pkv.chunk_blob(blob, 1024)[1], rid=5, event="reply",
             handle=1),
        {"big": "x" * 70000},                 # more than one recv() chunk
    ]


def _wire_bytes(send, msg):
    a, b = socket.socketpair()
    try:
        send(a, msg)
        a.close()
        out = b""
        while True:
            got = b.recv(1 << 16)
            if not got:
                return out
            out += got
    finally:
        b.close()


@pytest.mark.parametrize("i", range(6))
def test_frames_are_byte_identical_and_read_across_packages(i):
    msg = _messages()[i]
    pb = _wire_bytes(pfleet.send_frame, msg)
    jb = _wire_bytes(jfleet.send_frame, msg)
    assert pb == jb
    (n,) = struct.unpack(">I", pb[:4])
    assert n == len(pb) - 4
    for send, recv in ((pfleet.send_frame, jfleet.recv_frame),
                       (jfleet.send_frame, pfleet.recv_frame)):
        a, b = socket.socketpair()
        try:
            th = threading.Thread(target=send, args=(a, msg))
            th.start()
            got = recv(b)
            th.join(timeout=10)
            assert got == jfleet.recv_frame(_pair_with(jb))
            a.close()
            assert recv(b) is None            # clean EOF
        finally:
            a.close()
            b.close()


def _pair_with(data):
    a, b = socket.socketpair()
    a.sendall(data)
    a.close()
    return b


def test_oversize_frame_refused_as_in_jax():
    hdr = struct.pack(">I", pfleet._MAX_FRAME + 1)
    assert pfleet._MAX_FRAME == jfleet._MAX_FRAME == 16 << 20
    errs = []
    for mod, cls in ((pfleet, pserving.ReplicaFault),
                     (jfleet, jserving.ReplicaFault)):
        with pytest.raises(cls) as ei:
            mod.recv_frame(_pair_with(hdr))
        errs.append(str(ei.value))
    assert errs[0] == errs[1]
    # a header cut short is a clean EOF in both
    assert pfleet.recv_frame(_pair_with(b"\x00\x00")) is None


# -- pure helpers -------------------------------------------------------------

def _policies():
    return [dict(), dict(brownout_spec_load=0.5, brownout_clamp_load=0.6,
                         brownout_shed_load=0.8, brownout_hysteresis=0.05,
                         brownout_clamp_tokens=4,
                         interactive_deadline_ms=1000.0,
                         brownout_keep_priority=2)]


@pytest.mark.parametrize("pi", range(2))
def test_brownout_helpers_equal_jax(pi):
    kw = _policies()[pi]
    pp, jp = pfleet.ServingFleetPolicy(**kw), jfleet.ServingFleetPolicy(**kw)
    loads = [0.0, 0.3, 0.45, 0.5, 0.55, 0.6, 0.65, 0.7, 0.75, 0.8, 0.85,
             0.9, 0.95, 1.0, 1.5]
    got = [pfleet.brownout_stage(prev, x, pp)
           for prev in range(4) for x in loads]
    assert got == [jfleet.brownout_stage(prev, x, jp)
                   for prev in range(4) for x in loads]
    assert len(set(got)) == 4
    grid = [(st, dl, mx) for st in range(4)
            for dl in (None, 100.0, 1000.0, 2000.0, 60000.0)
            for mx in (1, 4, 8, 64)]
    assert [pfleet.brownout_max_new(*g, pp) for g in grid] == \
        [jfleet.brownout_max_new(*g, jp) for g in grid]
    sheds = [(st, pr) for st in range(4) for pr in range(-1, 4)]
    assert [pfleet.brownout_sheds(*s, pp) for s in sheds] == \
        [jfleet.brownout_sheds(*s, jp) for s in sheds]
    assert pfleet.BROWNOUT_STAGES == jfleet.BROWNOUT_STAGES
    assert vars(pp.fleet_policy()) == vars(jp.fleet_policy())


@pytest.mark.parametrize("case", [
    ([1, 2], [3, 4], [1, 2, 3, 4, 5, 6]), ([1], [2], [1, 2]),
    ([1], [], [1, 9]), ([5, 6, 7], [8], np.array([5, 6, 7, 8, 9, 10])),
    ([1, 2], [3, 4, 5], [1, 2, 3, 4])])
def test_stitch_replay_equals_jax(case):
    assert pfleet.stitch_replay(*case) == jfleet.stitch_replay(*case)


# -- the fleet's reliability logic over fakes ---------------------------------

class FakeReplica:
    """GenerationEngine-shaped stub (``test_serving_fleet._FakeReplica``)
    over one package's ``MetricsRegistry``."""

    def __init__(self, mod, name):
        self.name = name
        self.metrics = mod.MetricsRegistry()
        self.submitted, self.jobs, self.cancelled = [], [], []
        self.restarts = self.drained = 0
        self.spec = True

    def start(self):
        return self

    def close(self, drain=True):
        pass

    def restart(self):
        self.restarts += 1

    def fence(self):
        pass

    def drain(self):
        self.drained += 1

    def health(self):
        return True

    def queue_depth(self):
        return 0

    def stats(self):
        return self.metrics.snapshot()

    def kv_headroom(self):
        return 1.0

    def prefix_match_tokens(self, prompt, blocks=None):
        return 0

    def set_speculative(self, on):
        self.spec = on

    def cancel(self, fut):
        self.cancelled.append(fut)
        return False

    def submit(self, prompt, max_new_tokens=16, deadline_ms=None,
               on_token=None):
        fut = Future()
        self.submitted.append(np.asarray(prompt))
        self.jobs.append((np.asarray(prompt), int(max_new_tokens),
                          on_token, fut))
        return fut

    def finish_job(self, i=0):
        prompt, mx, cb, fut = self.jobs.pop(i)
        toks = [int(prompt[-1]) + 1 + j for j in range(mx)]
        for t in toks:
            if cb:
                cb(t)
        fut.set_result(np.asarray(list(prompt) + toks, np.int64))


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


def _mini(side, n=2, router=None, **policy_kw):
    mod, fl = SIDES[side]
    reps = [FakeReplica(mod, f"f{i}") for i in range(n)]
    kw = {} if router is None else {"router_config": mod.RouterConfig(
        **router)}
    fleet = fl.ServingFleet(replicas=reps, policy=fl.ServingFleetPolicy(
        poll_interval=0.02, **policy_kw), **kw).start()
    return mod, fleet, reps


def _counters(fleet, *names):
    c = fleet.provider_snapshot()["counters"]
    return {n: c.get(n, 0) for n in names}


def _replay_dedup(side):
    _mod, fleet, (a, b) = _mini(side)
    try:
        streamed = []
        fut = fleet.submit([7, 8], max_new_tokens=3,
                           on_token=streamed.append)
        assert _wait(lambda: a.jobs or b.jobs)
        holder, survivor = (a, b) if a.jobs else (b, a)
        holder.jobs[0][2](9)                    # one token streamed...
        fleet.fence_replica(holder.name, cause="test_crash")
        assert _wait(lambda: survivor.jobs)     # ...then the fence
        rp, rmx = survivor.jobs[0][0].tolist(), survivor.jobs[0][1]
        survivor.finish_job()
        out = fut.result(timeout=10).tolist()
        assert _wait(lambda: fleet.provider_snapshot()["replicas"]
                     [holder.name]["state"] == "ready", timeout=15)
        events = {e["event"] for e in
                  fleet.provider_snapshot()["timeline"]}
        return {"out": out, "streamed": streamed, "replay": (rp, rmx),
                "restarts": holder.restarts,
                "events": sorted(events & {"fence", "restart", "evict"}),
                **_counters(fleet, "replays", "fences", "stream_mismatch",
                            "failover_reprefill", "completed")}
    finally:
        fleet.close()


def _lost_done_frame(side):
    _mod, fleet, (a, b) = _mini(side)
    try:
        streamed = []
        fut = fleet.submit([1], max_new_tokens=2, on_token=streamed.append)
        assert _wait(lambda: a.jobs or b.jobs)
        holder, survivor = (a, b) if a.jobs else (b, a)
        holder.jobs[0][2](5)
        holder.jobs[0][2](6)                    # the whole budget streamed
        fleet.fence_replica(holder.name, cause="test_crash")
        out = fut.result(timeout=10).tolist()
        return {"out": out, "streamed": streamed,
                "survivor_jobs": len(survivor.jobs),
                **_counters(fleet, "replayed_complete", "completed",
                            "replays")}
    finally:
        fleet.close()


def _hedge(side):
    _mod, fleet, (a, b) = _mini(side, hedge_ms=100)
    try:
        fut = fleet.submit([1, 2], max_new_tokens=2)
        assert _wait(lambda: a.jobs or b.jobs)
        prim, other = (a, b) if a.jobs else (b, a)
        assert _wait(lambda: other.jobs, timeout=10)
        other.finish_job()                      # the hedge wins
        out = fut.result(timeout=10).tolist()
        prim.finish_job()                       # the late loser: ignored
        time.sleep(0.1)
        return {"out": out, "loser_cancels": len(prim.cancelled),
                **_counters(fleet, "hedges", "hedge_wins",
                            "hedge_cancelled", "completed")}
    finally:
        fleet.close()


def _brownout(side):
    _mod, fleet, (a, b) = _mini(side, replica_capacity=2)
    fl = SIDES[side][1]
    try:
        futs = [fleet.submit([9], max_new_tokens=1) for _ in range(8)]
        reached = _wait(lambda: fleet.brownout()["stage"] == 3)
        spec_off = (a.spec, b.spec)
        with pytest.raises(fl.BrownoutShed):
            fleet.submit([9], max_new_tokens=1, priority=0)
        cf = fleet.submit([5], max_new_tokens=20)   # batch class: clamped
        for _ in range(2):
            for r in (a, b):
                while r.jobs:
                    r.finish_job()
            time.sleep(0.2)
        clamped_len = len(cf.result(timeout=10))
        for f in futs:
            f.result(timeout=10)
        decayed = _wait(lambda: fleet.brownout()["stage"] == 0)
        c = _counters(fleet, "shed_brownout", "clamped",
                      "brownout_transitions")
        return {"reached_3": reached, "spec_off": spec_off,
                "clamped_len": clamped_len, "decayed": decayed,
                "spec_back": (a.spec, b.spec),
                "shed": c["shed_brownout"] >= 1, "clamped": c["clamped"],
                "transitions_2": c["brownout_transitions"] >= 2,
                "timeline": any(e["event"] == "brownout" for e in
                                fleet.provider_snapshot()["timeline"])}
    finally:
        fleet.close()


def _rolling(side):
    _mod, fleet, reps = _mini(side, n=3)
    try:
        res = fleet.rolling_restart()
        snap = fleet.provider_snapshot()
        kinds = [e["event"] for e in snap["timeline"]
                 if e["event"] in ("roll_drain", "roll_done")]
        return {"ok": res["ok"], "rolled": len(res["rolled"]),
                "replica_restarts": [r.restarts for r in reps],
                "drained": [r.drained for r in reps], "kinds": kinds,
                "states": sorted(r["state"] for r in
                                 snap["replicas"].values()),
                **_counters(fleet, "rolled_replicas", "restarts",
                            "rolling_restarts")}
    finally:
        fleet.close()


def _quota(side):
    mod, fleet, reps = _mini(side, n=1, router=dict(max_inflight=3,
                                                    default_quota=2))
    try:
        raised = []
        f1 = fleet.submit(np.arange(3), tenant="free")
        fleet.submit(np.arange(3), tenant="free")
        for args, kw in (((np.arange(3),), {"tenant": "free"}),
                         ((np.arange(3),), {"tenant": "vip"}),
                         ((np.arange(3),), {"tenant": "vip"}),
                         (([],), {"max_new_tokens": 2}),
                         (([1.5, 2.5],), {})):
            try:
                fleet.submit(*args, **kw)
                raised.append(None)
            except Exception as e:  # noqa: BLE001 - the type is the result
                raised.append(type(e).__name__)
        reps[0].finish_job()                   # completion frees quota
        f1.result(timeout=10)
        fleet.submit(np.arange(3), tenant="free")
        return {"raised": raised,
                **_counters(fleet, "rejected_quota", "rejected_capacity",
                            "requests", "completed")}
    finally:
        fleet.close()


def _close(side):
    mod, fleet, _reps = _mini(side, n=1)
    fut = fleet.submit(np.arange(3))
    fleet.close()
    out = []
    with pytest.raises(mod.EngineClosed):
        fut.result(timeout=10)
    out.append(type(fut.exception()).__name__)
    with pytest.raises(mod.EngineClosed):
        fleet.submit(np.arange(3))
    out.append(fleet.provider_snapshot()["inflight"])
    return out


FAKE_SCENARIOS = {f.__name__[1:]: f for f in (
    _replay_dedup, _lost_done_frame, _hedge, _brownout, _rolling, _quota,
    _close)}


@pytest.mark.parametrize("name", sorted(FAKE_SCENARIOS))
def test_fake_replica_scenarios_equal_jax(name):
    got = FAKE_SCENARIOS[name]("port")
    ref = FAKE_SCENARIOS[name]("jax")
    assert got == ref
    if name == "replay_dedup":
        assert got["out"] == [7, 8, 9, 10, 11]
        assert got["streamed"] == [9, 10, 11] and got["replay"] == \
            ([7, 8, 9], 2)
        assert got["replays"] == got["fences"] == got["restarts"] == 1
        assert got["stream_mismatch"] == 0
    elif name == "hedge":
        assert got["out"] == [1, 2, 3, 4] and got["loser_cancels"] == 1
        assert got["hedges"] == got["hedge_wins"] == 1
    elif name == "brownout":
        assert got["reached_3"] and got["spec_off"] == (False, False)
        assert got["clamped_len"] == 1 + 8 and got["spec_back"] == \
            (True, True)
    elif name == "rolling":
        assert got["ok"] and got["replica_restarts"] == [1, 1, 1]
        assert got["restarts"] == 0 and got["rolled_replicas"] == 3
        assert got["kinds"] == ["roll_drain", "roll_done"] * 3


def test_counters_and_fault_budget_hold_under_contending_threads():
    """State the fleet shares between its threads: its counters and a
    fault rule's budget lose no update with more threads than cores and a
    short switch interval."""
    from paddle_tpu_torch.distributed.resilience import faults as pf

    fleet = pfleet.ServingFleet(replicas=[FakeReplica(pserving, "s")])
    inj = pf.FaultInjector()
    inj.arm("stress_fault", times=500)
    n = len(os.sched_getaffinity(0)) + 4
    fired = []

    def work():
        for _ in range(200):
            fleet._inc("stress")
            if inj.peek("stress_fault"):
                fired.append(1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert fleet.provider_snapshot()["counters"]["stress"] == n * 200
    assert len(fired) == 500 and inj.fired("stress_fault") == 500


def test_left_out_pieces_raise_naming_their_module():
    fake = FakeReplica(pserving, "x")
    with pytest.raises(NotImplementedError, match="observability/fleet"):
        pfleet.ServingFleet(replicas=[fake], prom_path="/nonexistent")
    with pytest.raises(NotImplementedError, match="PT_FLIGHT_DIR"):
        pfleet.ServingFleet(replicas=[fake], flight_root="/nonexistent")
    fleet = pfleet.ServingFleet(replicas=[fake])
    for call, module in (
            (lambda: fleet.subscribe_weights("h", 1), "post_training"),
            (lambda: fleet.apply_serving_shape({}), "serving_tuner"),
            (fleet.fleet_telemetry_snapshot, "observability/fleet"),
            (fleet.slo_snapshot, "observability/fleet"),
            (fleet.scrape_now, "observability/fleet"),
            (lambda: fleet.export_fleet_trace("x"), "observability/fleet")):
        with pytest.raises(NotImplementedError, match=module):
            call()
    with pytest.raises(ValueError, match="kv_transit"):
        pfleet.ServingFleet(replicas=[fake], kv_transit="fp16")


# -- in-process fleets over real engines --------------------------------------

ENGINE = dict(max_slots=2, max_seq_len=48, page_len=8,
              prefill_buckets=(8, 16, 32))


def _engines(side, model, names):
    mod = SIDES[side][0]
    kw = {} if side == "jax" else {"device": "cpu"}
    return [mod.GenerationEngine(model, mod.GenerationConfig(**ENGINE),
                                 name=f"{side}-{n}", **kw) for n in names]


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def _prompts(seed, n, lo=9, hi=20):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, SMALL["vocab_size"], size=int(k))
            for k in rng.integers(lo, hi, size=n)]


def _serve(side, model, prompts, new, pools=None, transit="fp32",
           fence_after=None):
    """One in-process fleet over two engines: every answer with its
    stream, and the counters."""
    fl = SIDES[side][1]
    names = ["pre", "dec"] if pools else ["a", "b"]
    engines = _engines(side, model, names)
    kw = {}
    if pools:
        kw = {"pools": {"prefill": [f"{side}-pre"],
                        "decode": [f"{side}-dec"]}, "kv_transit": transit}
    fleet = fl.ServingFleet(replicas=engines, policy=fl.ServingFleetPolicy(
        poll_interval=0.02), **kw).start()
    fenced = []

    def on_tok_for(streamed):
        def cb(t, _lp):
            streamed.append(int(t))
            if fence_after is not None and len(streamed) == fence_after \
                    and not fenced:
                reps = fleet.provider_snapshot()["replicas"]
                holder = next(n for n, r in reps.items() if r["inflight"])
                fenced.append(holder)
                fleet.fence_replica(holder, cause="test")
        return cb

    try:
        streams = [[] for _ in prompts]
        outs = []
        for p, st in zip(prompts, streams):    # one at a time: no races
            seq, lps = fleet.submit(p, max_new_tokens=new,
                                    on_token=on_tok_for(st),
                                    return_logprobs=True).result(timeout=300)
            outs.append((seq.tolist(), np.asarray(lps)))
        for (seq, _l), p, st in zip(outs, prompts, streams):
            assert st == seq[len(p):]          # exactly once, in order
        snap = fleet.provider_snapshot()
        kvs = fleet.kv_migration_snapshot()
    finally:
        fleet.close()
        for e in engines:
            e.close()
    return outs, snap["counters"], kvs, fenced


def test_fleet_over_real_engines_gives_the_jax_fleets_tokens(pair):
    jm, pm = pair
    prompts = _prompts(1, 5)
    got, pc, _kv, _f = _serve("port", pm, prompts, 6)
    ref, jc, _kv, _f = _serve("jax", jm, prompts, 6)
    assert [s for s, _l in got] == [s for s, _l in ref]
    for (_s, gl), (_r, rl) in zip(got, ref):
        np.testing.assert_allclose(gl, rl, atol=1e-4)
    assert pc["completed"] == jc["completed"] == len(prompts)
    with torch.no_grad():
        for p, (seq, _l) in zip(prompts, got):
            want = pm.generate(torch.as_tensor(p)[None], max_new_tokens=6)
            assert seq == want[0].tolist()


def test_fence_mid_stream_replays_onto_the_survivor(pair):
    """The holder is fenced after the second streamed token: the request
    replays (prompt + emitted) onto the other engine; the answer and the
    stream are the undisturbed ones, in both packages."""
    jm, pm = pair
    prompts = _prompts(2, 1, lo=12, hi=13)
    got, pc, _kv, pf = _serve("port", pm, prompts, 8, fence_after=2)
    ref, jc, _kv, jf = _serve("jax", jm, prompts, 8, fence_after=2)
    assert pf and jf
    assert [s for s, _l in got] == [s for s, _l in ref]
    for c in (pc, jc):
        assert c["fences"] == 1 and c["replays"] == 1
        assert c.get("stream_mismatch", 0) == 0
    with torch.no_grad():
        want = pm.generate(torch.as_tensor(prompts[0])[None],
                           max_new_tokens=8)[0].tolist()
    assert got[0][0] == want


def _two_legs(model, prompts, new):
    """The disaggregated path on one lone engine: the prompt for one token,
    then prompt + that token from the engine's own prefix cache."""
    eng = pserving.GenerationEngine(model, pserving.GenerationConfig(
        **ENGINE), device="cpu")
    outs = []
    with eng:
        for p in prompts:
            s1, l1 = eng.submit(p, max_new_tokens=1,
                                return_logprobs=True).result(timeout=300)
            s2, l2 = eng.submit(s1, max_new_tokens=new - 1,
                                return_logprobs=True).result(timeout=300)
            outs.append((s2.tolist(), np.concatenate([l1, l2])))
    return outs


@pytest.mark.parametrize("transit", ["fp32", "int8"])
def test_prefill_decode_pools_ship_pages(pair, transit):
    """Each request prefills on the prefill engine, its pages ship to the
    decode engine (fp32: bit for bit; int8: quantized in transit) and the
    stream continues there; the tokens equal the JAX fleet's, and fp32's
    every bit equals a lone engine running the same two legs."""
    jm, pm = pair
    prompts = _prompts(3, 3, lo=17, hi=30)
    got, pc, pkvs, _ = _serve("port", pm, prompts, 5, pools=True,
                              transit=transit)
    ref, jc, jkvs, _ = _serve("jax", jm, prompts, 5, pools=True,
                              transit=transit)
    assert [s for s, _l in got] == [s for s, _l in ref]
    for c, kvs in ((pc, pkvs), (jc, jkvs)):
        assert c["migrations"] == c["prefill_handoffs"] == len(prompts)
        assert c.get("migrate_fallback", 0) == 0
        assert kvs["transit"] == transit
        assert kvs["pools"] == {k: v for k, v in kvs["pools"].items()}
    pages = sum(len(p) // ENGINE["page_len"] for p in prompts)
    for k in ("pages_shipped", "wire_bytes", "fp32_bytes"):
        assert pkvs[k] == jkvs[k], k
    assert pkvs["pages_shipped"] == pages
    if transit == "fp32":
        lone = _two_legs(pm, prompts, 5)
        for (seq, lps), (ls, ll) in zip(got, lone):
            assert seq == ls
            assert np.array_equal(lps.astype(np.float32),
                                  ll.astype(np.float32))
    else:
        assert pkvs["wire_bytes"] < pkvs["fp32_bytes"] / 3


# -- each package's client against the other's replica server ----------------

def _serve_thread(fl, name, engine):
    srv = fl._ReplicaServer(name, engine, store=None)
    th = threading.Thread(target=srv.serve, daemon=True)
    th.start()
    return srv, th


@pytest.mark.parametrize("client_side", ["port", "jax"])
def test_client_talks_to_the_other_packages_replica(pair, client_side):
    """A port ``ReplicaClient`` drives a JAX ``_ReplicaServer`` over a JAX
    engine, and the reverse: the answers are that engine's own, the stream
    is exactly the generated tail, and probe/stats/KV export work."""
    jm, pm = pair
    server_side = "jax" if client_side == "port" else "port"
    model = jm if server_side == "jax" else pm
    engine = _engines(server_side, model, ["srv"])[0]
    engine.start()
    prompts = _prompts(4, 3)
    direct = [engine.submit(p, max_new_tokens=5).result(timeout=300)
              .tolist() for p in prompts]
    srv, th = _serve_thread(SIDES[server_side][1], "srv", engine)
    cli = SIDES[client_side][1].ReplicaClient("srv", "127.0.0.1", srv.port)
    try:
        streams = [[] for _ in prompts]
        futs = [cli.submit(p, max_new_tokens=5, on_token=st.append)
                for p, st in zip(prompts, streams)]
        outs = [f.result(timeout=300).tolist() for f in futs]
        assert outs == direct
        assert [st for st in streams] == [o[len(p):] for o, p in
                                         zip(outs, prompts)]
        assert cli.health() and cli.queue_depth() == 0
        assert cli.prefix_match_tokens(prompts[0]) == \
            engine.prefix_match_tokens(prompts[0])
        assert cli.stats()["counters"]["responses_total"] >= 6
        head = cli.kv_export(prompts[0])
        assert head["npages"] == len(prompts[0]) // ENGINE["page_len"]
        assert head["wire_bytes"] == len(head["data"])
        cli.set_spec(False)
        with pytest.raises(SIDES[client_side][0].BadRequest):
            cli.submit(np.zeros(0, np.int64), max_new_tokens=2)
    finally:
        cli.shutdown()
        th.join(timeout=30)
        cli.close()
    assert not th.is_alive()


def test_port_replica_answers_telemetry_and_refuses_weight_service(pair):
    _jm, pm = pair
    engine = _engines("port", pm, ["t"])[0]
    srv, th = _serve_thread(pfleet, "t", engine)
    cli = pfleet.ReplicaClient("t", "127.0.0.1", srv.port)
    try:
        cli.submit(_prompts(5, 1)[0], max_new_tokens=3).result(timeout=300)
        tele = cli.telemetry()
        assert tele["pid"] == os.getpid()
        assert tele["telemetry"]["engine"]["counters"]["prefills_total"] == 1
        assert "paged_attention" in tele["telemetry"]["kernels"]
        assert cli.pull_traces() == []
        with pytest.raises(NotImplementedError, match="post_training"):
            cli.subscribe_weights("h", 1)
        with pytest.raises(RuntimeError, match="post_training"):
            cli._rpc("subscribe_weights", host="h", port=1, poll_s=0.1)
    finally:
        cli.shutdown()
        th.join(timeout=30)
        cli.close()


# -- one real two-process fleet -----------------------------------------------

def test_two_process_fleet_survives_a_crash(tmp_path):
    """Two port replica processes (``python -m
    paddle_tpu_torch.serving.fleet``, fp32 on the CPU); ``p1`` dies at its
    second submit. Every request equals the port's ``generate`` exactly,
    each stream is exactly its tail, and ``p1`` restarts and is ready."""
    code = f"""
import sys, time
sys.path.insert(0, {REPO!r})
sys.path.insert(0, {os.path.join(REPO, "tests")!r})
import numpy as np, torch
from paddle_tpu_torch.serving import ServingFleet, ServingFleetPolicy
import torch_fleet_builder as B

ref = B.build_model()
fleet = ServingFleet(
    builder={os.path.join(REPO, "tests", "torch_fleet_builder.py")!r}
    + ":build_replica", n_replicas=2, names=["p0", "p1"],
    policy=ServingFleetPolicy(heartbeat_interval=0.25,
                              heartbeat_timeout=3.0, backoff_base_s=0.2,
                              poll_interval=0.05),
    extra_env={{"PT_FAULTS": "replica_crash@name=p1&seq=2&inc=0"}},
    log_dir={str(tmp_path / "logs")!r})
try:
    fleet.start(wait_ready=True, timeout=120)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, size=int(n)) for n in (9, 12, 5, 20, 7)]
    streams = [[] for _ in prompts]
    futs = [fleet.submit(p, max_new_tokens=12, on_token=s.append)
            for p, s in zip(prompts, streams)]
    for p, f, s in zip(prompts, futs, streams):
        out = f.result(timeout=120).tolist()
        with torch.no_grad():
            want = ref.generate(torch.as_tensor(p)[None],
                                max_new_tokens=12)[0].tolist()
        assert out == want, (out, want)
        assert s == out[len(p):], (s, out)
    deadline = time.time() + 60
    while time.time() < deadline:
        rep = fleet.provider_snapshot()["replicas"]["p1"]
        if rep["state"] == "ready" and rep["incarnation"] >= 1:
            break
        time.sleep(0.1)
    snap = fleet.provider_snapshot()
    assert snap["replicas"]["p1"]["state"] == "ready", snap["replicas"]
    assert snap["replicas"]["p1"]["incarnation"] == 1
    c = snap["counters"]
    assert c["fences"] == 1 and c["restarts"] == 1 and c["replays"] >= 1, c
    assert c.get("stream_mismatch", 0) == 0, c
    assert snap["recoveries"][0]["replica"] == "p1"
    # the restarted incarnation serves
    out = fleet.submit(prompts[0], max_new_tokens=4).result(timeout=120)
    print("FLEET_OK", c)
finally:
    fleet.close()
"""
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:            # kill the fleet and its children
            os.killpg(proc.pid, 9)
            proc.wait()
    assert proc.returncode == 0, (out[-2000:], err[-3000:])
    assert "FLEET_OK" in out
    logs = sorted(os.listdir(tmp_path / "logs"))
    assert logs == ["p0.0.log", "p1.0.log", "p1.1.log"]


# -- the engines' chaos sites -------------------------------------------------

def _batch_fault_run(side):
    mod = SIDES[side][0]
    from paddle_tpu.distributed.resilience import faults as jf
    from paddle_tpu_torch.distributed.resilience import faults as pf
    faults = jf if side == "jax" else pf

    kw = {"device": "cpu"} if side == "port" else {}
    eng = mod.ServingEngine(lambda x: x * 2,
                            mod.BucketSpec(batch_sizes=(1, 2)),
                            input_specs=[((4,), "float32")],
                            name=f"chaos-{side}", **kw)
    inj = faults.injector()
    rules = [inj.arm("batch_fault", engine=eng.name, batch=b)
             for b in (1, 3)]
    out = []
    try:
        with eng:
            for i in range(5):                 # one request a batch
                f = eng.submit([np.full(4, i, np.float32)])
                try:
                    f.result(timeout=60)
                    out.append("ok")
                except faults.InjectedFault as e:
                    out.append(("fault", e.ids["batch"]))
            out.append(eng.stats()["counters"].get("batch_failures"))
    finally:
        for r in rules:
            inj.disarm(r)
    return out


def _decode_fault_run(side, model):
    mod = SIDES[side][0]
    from paddle_tpu.distributed.resilience import faults as jf
    from paddle_tpu_torch.distributed.resilience import faults as pf
    faults = jf if side == "jax" else pf
    eng = _engines(side, model, ["chaos"])[0]
    inj = faults.injector()
    rule = inj.arm("decode_fault", engine=eng.name, step=2)
    out = []
    try:
        with eng:
            for p in _prompts(6, 3):           # 2 decode rounds each
                f = eng.submit(p, max_new_tokens=3)
                try:
                    out.append(f.result(timeout=300).tolist())
                except faults.InjectedFault as e:
                    out.append(("fault", e.ids["step"]))
            out.append(eng.stats()["active_slots"])
    finally:
        inj.disarm(rule)
    return out


def test_batch_fault_fails_the_same_requests_as_jax():
    got, ref = _batch_fault_run("port"), _batch_fault_run("jax")
    assert got == ref == ["ok", ("fault", 1), "ok", ("fault", 3), "ok", 2]


def test_decode_fault_fails_the_same_requests_as_jax(pair):
    jm, pm = pair
    got, ref = _decode_fault_run("port", pm), _decode_fault_run("jax", jm)
    assert got == ref
    assert got[1] == ("fault", 2) and got[-1] == 0
    assert isinstance(got[0], list) and isinstance(got[2], list)
