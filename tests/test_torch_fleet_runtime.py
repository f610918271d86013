"""The port's fleet control plane against the JAX package's: the pure
``FleetStateMachine`` (the scripted cases of ``test_fleet_runtime.py`` and
the replica mode of ``test_serving_fleet.py``, the same action sequences
and snapshots in both packages), the ``FaultInjector`` and its
``PT_FAULTS`` parser (the same rules, firing at the same calls), and the
port's ``TCPStore`` over ``torch.distributed.TCPStore`` with the fleet's
publish/probe helpers, across threads and a child process."""
import json
import os
import subprocess
import sys
import threading
import time
import warnings

import pytest

from paddle_tpu.distributed.fleet import runtime as jrt
from paddle_tpu.distributed.resilience import faults as jfaults
from paddle_tpu_torch.distributed import store as pstore
from paddle_tpu_torch.distributed.fleet import runtime as prt
from paddle_tpu_torch.distributed.resilience import faults as pfaults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _policy(rt, **kw):
    base = dict(min_world=2, max_restarts=2, heartbeat_timeout=5.0,
                backoff_base_s=0.1, start_timeout_s=30.0)
    base.update(kw)
    return rt.FleetPolicy(**base)


def _act(a):
    return (a.kind, list(a.dead), a.world, round(a.backoff_s, 9), a.reason)


# -- FleetStateMachine: each scenario returns a transcript -------------------

def _join_and_hold(rt):
    sm = rt.FleetStateMachine(3, _policy(rt), now=0.0)
    out = [sm.phase.value]
    for r in range(3):
        sm.heartbeat(r, 0.2)
    out.append(sm.phase.value)
    out.append(_act(sm.observe(1.0, {r: None for r in range(3)})))
    out.append(sm.ranks_alive(1.0))
    return out, sm


def _stale_fence(rt):
    sm = rt.FleetStateMachine(2, _policy(rt), now=0.0)
    sm.heartbeat(0, 0.0)
    sm.heartbeat(1, 0.0)
    sm.heartbeat(0, 6.0)
    return [_act(sm.observe(6.0, {0: None, 1: None}))], sm


def _stall_under_grace(rt):
    sm = rt.FleetStateMachine(2, _policy(rt, heartbeat_timeout=5.0),
                              now=0.0)
    sm.heartbeat(0, 0.0)
    sm.heartbeat(1, 0.0)
    out = [_act(sm.observe(4.9, {0: None, 1: None})), sm.stale_ranks(4.9)]
    sm.heartbeat(0, 4.95)
    sm.heartbeat(1, 4.95)
    out.append(_act(sm.observe(6.0, {0: None, 1: None})))
    return out, sm


def _flap(rt):
    sm = rt.FleetStateMachine(2, _policy(rt), now=0.0)
    sm.heartbeat(0, 0.0)
    sm.heartbeat(1, 0.0)
    sm.heartbeat(0, 6.0)
    out = [_act(sm.observe(6.0, {0: None, 1: None}))]
    sm.heartbeat(1, 0.0)          # a re-read of the same old beat
    out.append(sorted(sm._evicted))
    sm.heartbeat(1, 6.5)          # a fresh one: one flap
    return out, sm


def _crash_cycle(rt):
    sm = rt.FleetStateMachine(4, _policy(rt), now=0.0)
    for r in range(4):
        sm.heartbeat(r, 0.1)
    F = rt.EXIT_FENCED
    out = [_act(sm.observe(1.0, {0: None, 1: None, 2: 43, 3: None})),
           _act(sm.observe(2.0, {0: F, 1: F, 2: 43, 3: None})),
           _act(sm.observe(3.0, {0: F, 1: F, 2: 43, 3: F}))]
    sm.restarted(4.0, 3)
    out.append((sm.gen, sm.restarts, sm.world))
    for r in range(3):
        sm.heartbeat(r, 4.1)
    out.append(_act(sm.observe(5.0, {0: 0, 1: 0, 2: 0})))
    return out, sm


def _worker_fence(rt):
    sm = rt.FleetStateMachine(2, _policy(rt, min_world=2, max_restarts=0),
                              now=0.0)
    sm.heartbeat(0, 0.1)
    sm.heartbeat(1, 0.1)
    sm.worker_fence(1.0, "retune:plan")
    sm.worker_fence(1.1, "retune:plan")
    out = [sm.phase.value, sm.planned_fence,
           _act(sm.observe(2.0, {0: rt.EXIT_FENCED, 1: None})),
           _act(sm.observe(3.0, {0: rt.EXIT_FENCED, 1: -6}))]
    sm.restarted(4.0, 2)
    out.append((sm.restarts, sm.gen, sm.planned_fence))
    return out, sm


def _backoff(rt):
    p = _policy(rt, backoff_base_s=0.5, backoff_max_s=2.0)
    return [p.backoff_s(n) for n in (1, 2, 3, 9)], None


def _budget(rt):
    sm = rt.FleetStateMachine(3, _policy(rt, min_world=1, max_restarts=1),
                              now=0.0)
    for r in range(3):
        sm.heartbeat(r, 0.1)
    F = rt.EXIT_FENCED
    out = [_act(sm.observe(1.0, {0: None, 1: 9, 2: None})),
           _act(sm.observe(2.0, {0: F, 1: 9, 2: F}))]
    sm.restarted(3.0, 2)
    for r in range(2):
        sm.heartbeat(r, 3.1)
    out += [_act(sm.observe(4.0, {0: 9, 1: None})),
            _act(sm.observe(5.0, {0: 9, 1: F})), sm.phase.value]
    return out, sm


def _min_world(rt):
    sm = rt.FleetStateMachine(3, _policy(rt, min_world=3), now=0.0)
    for r in range(3):
        sm.heartbeat(r, 0.1)
    F = rt.EXIT_FENCED
    return [_act(sm.observe(1.0, {0: None, 1: 9, 2: None})),
            _act(sm.observe(2.0, {0: F, 1: 9, 2: F}))], sm


def _launch_timeout(rt):
    sm = rt.FleetStateMachine(3, _policy(rt, start_timeout_s=10.0), now=0.0)
    sm.heartbeat(0, 1.0)
    return [_act(sm.observe(11.0, {r: None for r in range(3)}))], sm


def _snapshot_shape(rt):
    sm = rt.FleetStateMachine(2, _policy(rt), now=0.0)
    sm.heartbeat(0, 0.1)
    return [json.dumps(sm.snapshot(), sort_keys=True)], sm


def _replica_budget_backoff(rt):
    pol = rt.FleetPolicy(heartbeat_timeout=2.0, max_restarts=2,
                         backoff_base_s=0.5, backoff_max_s=2.0)
    sm = rt.FleetStateMachine(3, pol, now=0.0)
    for r in range(3):
        sm.heartbeat(r, 0.0)
    out = [sm.replica_fence(1, 1.0, "crash", rc=43),
           sm.replica_fence(1, 1.1, "crash"), sm.phase.value,
           _act(sm.replica_restart_decision(1, 2.0))]
    sm.replica_restarted(1, 2.5)
    sm.heartbeat(1, 3.0)
    sm.replica_fence(1, 4.0, "stale_heartbeat")
    out.append(_act(sm.replica_restart_decision(1, 5.0)))
    sm.replica_restarted(1, 5.5)
    sm.replica_fence(1, 6.0, "crash")
    out.append(_act(sm.replica_restart_decision(1, 7.0)))
    out.append(sm.replica_restart_counts())
    sm.note("roll_done", 8.0, rank=1)
    sm.replica_restarted(2, 9.0, count=False)   # a planned roll: free
    out.append(sm.replica_restart_counts())
    return out, sm


def _replica_grace(rt):
    sm = rt.FleetStateMachine(2, rt.FleetPolicy(heartbeat_timeout=5.0),
                              now=0.0)
    sm.heartbeat(0, 0.0)
    sm.heartbeat(1, 0.0)
    out = [sm.stale_ranks(4.9), sm.stale_ranks(5.1)]
    sm.heartbeat(0, 5.0)
    out.append(sm.stale_ranks(6.0))
    sm.replica_fence(1, 6.0, "stale_heartbeat")
    out.append(sm.stale_ranks(7.0))
    return out, sm


SCENARIOS = {f.__name__[1:]: f for f in (
    _join_and_hold, _stale_fence, _stall_under_grace, _flap, _crash_cycle,
    _worker_fence, _backoff, _budget, _min_world, _launch_timeout,
    _snapshot_shape, _replica_budget_backoff, _replica_grace)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_state_machine_equals_jax(name):
    """The same script gives the same actions, phases, timeline and
    snapshot in both packages."""
    got, psm = SCENARIOS[name](prt)
    ref, jsm = SCENARIOS[name](jrt)
    assert got == ref
    if jsm is not None:
        assert psm.snapshot() == jsm.snapshot()
        assert psm.timeline == jsm.timeline


def test_state_machine_scripts_read_as_the_reference_tests_say():
    """Spot checks that the shared scripts exercise what their names say
    (so the equality above is not between two empty transcripts)."""
    assert SCENARIOS["stale_fence"](prt)[0][0][:2] == ("fence", [1])
    assert SCENARIOS["crash_cycle"](prt)[0][-1][0] == "complete"
    assert SCENARIOS["budget"](prt)[0][-1] == "failed"
    assert "[1, 2]" in SCENARIOS["launch_timeout"](prt)[0][0][4]
    rb = SCENARIOS["replica_budget_backoff"](prt)[0]
    assert rb[3][0] == "restart" and rb[3][3] == 0.5 and rb[4][3] == 1.0
    assert rb[5][0] == "fail" and rb[6] == {1: 2} and rb[7] == {1: 2}
    assert SCENARIOS["replica_grace"](prt)[0] == [[], [0, 1], [1], []]
    flaps = [e for e in SCENARIOS["flap"](prt)[1].timeline
             if e["event"] == "flap"]
    assert len(flaps) == 1


# -- FaultInjector ------------------------------------------------------------

SPECS = [
    "replica_crash@name=r1&seq=4,replica_hang@name=r2&seq=6,"
    "replica_slow@name=r3&ms=5&times=-1",
    "replica_crash@name=p1&seq=2&inc=0",
    "batch_fault@batch=3&times=2,decode_fault@engine=e&step=1",
    "transfer@seq=3&times=2&transient=0,crash_mid_save@save=1&exit=17",
    " , nan_step@step=5 ,",
    "bad@times=x,decode_fault@step=2",        # the first rule is malformed
]


def _rules(inj):
    return [(r.kind, dict(r.match), r.times, r.transient, r.exit_code,
             r.sleep_ms) for r in inj._rules]


@pytest.mark.parametrize("spec", SPECS)
def test_pt_faults_parse_to_the_same_rules(spec):
    pi, ji = pfaults.FaultInjector(), jfaults.FaultInjector()
    with warnings.catch_warnings(record=True) as pw:
        warnings.simplefilter("always")
        pfaults._parse_env(spec, pi)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jfaults._parse_env(spec, ji)
    assert _rules(pi) == _rules(ji) and _rules(pi)
    assert [str(w.message) for w in pw] == [str(w.message) for w in jw]


def _fire_script(mod):
    """A fixed sequence of site calls; returns what each did."""
    inj = mod.FaultInjector()
    mod._parse_env(SPECS[0] + "," + SPECS[1] + "," + SPECS[2], inj)
    calls = [
        ("peek", "replica_crash", dict(name="r2", seq=4)),
        ("peek", "replica_crash", dict(name="r1", seq=3)),
        ("peek", "replica_crash", dict(name="r1", seq=4)),
        ("peek", "replica_crash", dict(name="r1", seq=4)),   # consumed
        ("peek", "replica_hang", dict(name="r2", seq=6)),
        ("check", "replica_slow", dict(name="r3")),
        ("check", "replica_slow", dict(name="r3")),          # times=-1
        ("check", "replica_slow", dict(name="r1")),
        ("take", "replica_slow", dict(name="r3")),
        ("peek", "replica_crash", dict(name="p1", seq=2, inc=1)),
        ("peek", "replica_crash", dict(name="p1", seq=2, inc=0)),
        ("peek", "replica_crash", dict(name="p1", seq=2, inc=0)),
        ("check", "batch_fault", dict(engine="x", batch=2)),
        ("check", "batch_fault", dict(engine="x", batch=3)),
        ("check", "batch_fault", dict(engine="y", batch=3)),
        ("check", "batch_fault", dict(engine="y", batch=3)),  # times=2 spent
        ("check", "decode_fault", dict(engine="e", step=0)),
        ("check", "decode_fault", dict(engine="f", step=1)),
        ("check", "decode_fault", dict(engine="e", step=1)),
    ]
    out = []
    for how, kind, ids in calls:
        if how == "peek":
            out.append(inj.peek(kind, **ids))
        elif how == "take":
            r = inj._take(kind, ids)
            out.append(None if r is None else (r.kind, r.sleep_ms, r.times))
        else:
            try:
                inj.check(kind, **ids)
                out.append("ok")
            except mod.InjectedFault as e:
                out.append(("raised", e.kind, e.ids, e.transient))
    fired = {k: inj.fired(k) for k in ("replica_crash", "replica_hang",
                                       "replica_slow", "batch_fault",
                                       "decode_fault")}
    return out, fired


def test_injector_fires_at_the_same_calls_as_jax():
    got, ref = _fire_script(pfaults), _fire_script(jfaults)
    assert got == ref
    out, fired = got
    assert out[:5] == [False, False, True, False, True]
    assert out[9:12] == [False, True, False]                # inc pinning
    assert fired == {"replica_crash": 2, "replica_hang": 1,
                     "replica_slow": 3, "batch_fault": 2, "decode_fault": 1}


def test_inject_context_and_env_arming(monkeypatch):
    """``inject`` arms for its block only; ``injector()`` arms
    ``PT_FAULTS`` once, on first use, and counts ``injected_faults``."""
    from paddle_tpu_torch.distributed.resilience import metrics

    inj = pfaults.injector()
    with pfaults.inject("batch_fault", engine="ctx", batch=0):
        with pytest.raises(pfaults.InjectedFault):
            inj.check("batch_fault", engine="ctx", batch=0)
    inj.check("batch_fault", engine="ctx", batch=0)         # disarmed
    assert metrics.get("injected_faults") >= 1
    monkeypatch.setattr(pfaults, "_INJECTOR", None)
    monkeypatch.setenv("PT_FAULTS", "decode_fault@engine=envtest&step=4")
    fresh = pfaults.injector()
    assert fresh is not inj
    assert _rules(fresh) == [("decode_fault", {"engine": "envtest",
                                               "step": "4"}, 1, True, None,
                              None)]


# -- TCPStore -----------------------------------------------------------------

def test_store_api_and_probe_across_threads():
    master = pstore.TCPStore(is_master=True, world_size=1, timeout=30)
    assert master.port > 0                      # port 0: the bound port
    client = pstore.TCPStore(port=master.port, world_size=1, timeout=30)
    try:
        master.set("k", b"v")
        assert client.get("k") == b"v"
        client.set("s", "text")
        assert master.get("s") == b"text"
        assert client.add("n", 2) == 2 and master.add("n", 3) == 5
        assert master.delete_key("k") and not master.delete_key("k")
        t0 = time.monotonic()
        assert prt._probe(client, "absent") is None  # never blocks
        assert prt._probe_json(client, "absent") is None
        assert time.monotonic() - t0 < 1.0
        got = {}

        def waiter():
            client.wait(["late/published"], timeout=20)  # set, then add
            got["late"] = prt._probe_json(client, "late")

        th = threading.Thread(target=waiter)
        th.start()
        time.sleep(0.2)
        prt._publish(master, "late", {"port": 123, "pid": 7})
        th.join(timeout=20)
        assert got == {"late": {"port": 123, "pid": 7}}
        with pytest.raises(TimeoutError):
            client.wait(["never"], timeout=1)
        with pytest.raises(ValueError):
            pstore.TCPStore(port=0)             # a client needs a port
    finally:
        client.close()
        master.close()
    with pytest.raises(RuntimeError, match="closed"):
        master.add("n", 0)


def test_store_probe_across_a_child_process():
    """A child connects as a client, publishes, and reads what the parent
    published: the fleet's readiness and heartbeat path."""
    master = pstore.TCPStore(is_master=True, world_size=1, timeout=30)
    prt._publish(master, "to_child", {"hello": 1})
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.distributed.fleet.runtime import _probe_json, _publish
s = TCPStore(port={master.port}, world_size=1, timeout=30)
assert _probe_json(s, "to_child") == {{"hello": 1}}
_publish(s, "from_child", {{"beat": 2}})
"""
    try:
        res = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr[-2000:]
        assert prt._probe_json(master, "from_child") == {"beat": 2}
        assert master.add("from_child/published", 0) == 1
    finally:
        master.close()
