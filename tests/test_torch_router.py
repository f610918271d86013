"""The port's ``ReplicaRouter`` against the JAX package's: the dispatch
scores on the same fake replicas, the error classification, admission
control, load-aware and prefix-affinity dispatch, fencing, re-admission and
rerouting, and an end-to-end run of two engines each side (fp32, CPU)."""
from concurrent.futures import Future

import numpy as np
import pytest

from paddle_tpu import serving as jserving
from paddle_tpu.serving import router as jrouter
from paddle_tpu_torch import serving
from paddle_tpu_torch.serving import router as prouter
from test_torch_gpt import SMALL, make_pair


class FakeReplica:
    """A ``GenerationEngine``-shaped stub with scripted load."""

    def __init__(self, name, depth=0, headroom=1.0, match=0, closed=False,
                 full=False, latencies=(), page_len=None, healthy=True):
        self.name = name
        self.metrics = serving.MetricsRegistry()
        for ms in latencies:
            self.metrics.observe_latency(ms)
        self.depth, self.headroom, self.match = depth, headroom, match
        self.closed, self.full, self.healthy = closed, full, healthy
        self.submitted = []
        if page_len is not None:
            self.config = serving.GenerationConfig(page_len=page_len)

    def start(self):
        return self

    def close(self, drain=True):
        self.closed = True

    def health(self):
        return self.healthy

    def queue_depth(self):
        return self.depth

    def stats(self):
        return self.metrics.snapshot()

    def kv_headroom(self):
        return self.headroom

    def prefix_match_tokens(self, prompt, blocks=None):
        if blocks is not None:
            return min(self.match, len(blocks) * self.config.page_len)
        return self.match

    def submit(self, prompt, max_new_tokens=16, deadline_ms=None):
        if self.closed:
            raise serving.EngineClosed("down")
        if self.full:
            raise serving.QueueFull("full")
        fut = Future()
        self.submitted.append(np.asarray(prompt))
        return fut


def _fleet():
    return [FakeReplica("a", depth=3, headroom=0.4, match=16,
                        latencies=(5, 7, 90), page_len=8),
            FakeReplica("b", depth=0, headroom=0.9, match=0,
                        latencies=(4, 4, 6)),
            FakeReplica("c", depth=7, headroom=0.1, match=32,
                        latencies=(30, 31), page_len=16),
            FakeReplica("d", depth=1, headroom=1.0, match=8, page_len=8)]


@pytest.mark.parametrize("pool", [None, "prefill", "decode"])
@pytest.mark.parametrize("plen", [1, 40, 100])
def test_score_candidates_equals_jax(pool, plen):
    prompt = np.arange(plen)
    got = prouter.score_candidates(serving.RouterConfig(), prompt, _fleet(),
                                   pool=pool)
    ref = jrouter.score_candidates(jserving.RouterConfig(), prompt, _fleet(),
                                   pool=pool)
    assert got == ref


@pytest.mark.parametrize("exc", [
    serving.QueueFull("x"), serving.TenantQuotaExceeded("x"),
    serving.BadRequest("x"), serving.DeadlineExceeded("x"),
    serving.EngineClosed("x"), serving.ReplicaFault("x"),
    ConnectionError("x"), BrokenPipeError("x"), OSError("x"),
    TimeoutError("x"), KeyError("x"), RuntimeError("x")])
def test_classify_submit_error_equals_jax(exc):
    twin = {serving.QueueFull: jserving.QueueFull,
            serving.TenantQuotaExceeded: jserving.TenantQuotaExceeded,
            serving.BadRequest: jserving.BadRequest,
            serving.DeadlineExceeded: jserving.DeadlineExceeded,
            serving.EngineClosed: jserving.EngineClosed,
            serving.ReplicaFault: jserving.ReplicaFault}.get(type(exc),
                                                             type(exc))
    assert prouter.classify_submit_error(exc) == \
        jrouter.classify_submit_error(twin("x"))


def test_tenant_quota_and_fleet_backpressure():
    r1 = FakeReplica("a")
    router = serving.ReplicaRouter(
        [r1], serving.RouterConfig(max_inflight=3, default_quota=2,
                                   tenant_quotas={"vip": 3}))
    p = np.arange(4)
    f1 = router.submit(p, tenant="free")
    router.submit(p, tenant="free")
    with pytest.raises(serving.TenantQuotaExceeded):
        router.submit(p, tenant="free")
    router.submit(p, tenant="vip")                 # own quota
    with pytest.raises(serving.QueueFull):         # fleet-wide bound
        router.submit(p, tenant="vip")
    f1.set_result(np.arange(5))                    # completion frees quota
    router.submit(p, tenant="free")
    st = router.stats()
    assert st["rejected"] == {"quota": 1, "capacity": 1}
    assert st["inflight"]["free"] == 2


def test_load_aware_and_prefix_affinity_dispatch():
    idle = FakeReplica("idle", depth=0, headroom=1.0)
    busy = FakeReplica("busy", depth=50, headroom=0.1)
    router = serving.ReplicaRouter([busy, idle])
    router.submit(np.arange(8))
    assert len(idle.submitted) == 1 and not busy.submitted
    holder = FakeReplica("holder", depth=2, match=8)
    cold = FakeReplica("cold", depth=0)
    router2 = serving.ReplicaRouter([cold, holder])
    router2.submit(np.arange(8))
    assert len(holder.submitted) == 1 and not cold.submitted
    assert router2.stats()["affinity_hits"] == 1


def test_fault_marks_down_reroutes_and_probe_readmits():
    dead = FakeReplica("dead", closed=True, healthy=False)
    live = FakeReplica("live")
    router = serving.ReplicaRouter([dead, live])
    router.submit(np.arange(4))
    assert len(live.submitted) == 1
    assert router.stats()["down"] == ["dead"]
    assert router.probe_down() == []               # still unhealthy
    dead.closed, dead.healthy = False, True
    assert router.probe_down() == ["dead"]
    assert router.stats()["readmitted"] == 1 and not router.stats()["down"]
    router.mark_down("live")
    router.submit(np.arange(4))
    assert len(dead.submitted) == 1
    router.mark_up("live")
    assert [r.name for r in router.healthy()] == ["dead", "live"]
    # a request-scoped error surfaces and fences nothing
    with pytest.raises(serving.BadRequest):
        serving.ReplicaRouter([_Rejecting("r")]).submit(np.arange(4))
    full = FakeReplica("full2", full=True)
    router2 = serving.ReplicaRouter([full])
    with pytest.raises(serving.QueueFull):
        router2.submit(np.arange(4))
    full.full = False
    router2.submit(np.arange(4))                   # recovers
    router2.mark_down("full2")
    with pytest.raises(serving.EngineClosed, match="no healthy"):
        full.healthy = False
        router2.submit(np.arange(4))
    with pytest.raises(ValueError):
        serving.ReplicaRouter([])


class _Rejecting(FakeReplica):
    def submit(self, prompt, max_new_tokens=16, deadline_ms=None):
        raise serving.BadRequest("bad prompt")


def _engines(side, model):
    cfg = dict(max_slots=2, max_seq_len=48, page_len=8,
               prefill_buckets=(8, 16, 32))
    if side == "jax":
        return [jserving.GenerationEngine(
            model, jserving.GenerationConfig(**cfg), name=f"jax-r{i}")
            for i in range(2)]
    return [serving.GenerationEngine(model, serving.GenerationConfig(**cfg),
                                     device="cpu", name=f"port-r{i}")
            for i in range(2)]


def test_two_engines_behind_the_router_give_the_jax_routers_tokens():
    """Two replicas each side over one model and shared-prefix traffic
    (the first request lands alone, so its replica holds the prefix): every
    answer equals the JAX router's."""
    jm, pm = make_pair()
    rng = np.random.default_rng(6)
    prefix = rng.integers(0, SMALL["vocab_size"], size=16)
    prompts = [np.concatenate([prefix, rng.integers(0, 64, size=int(n))])
               if i % 2 else rng.integers(0, 64, size=int(n) + 8)
               for i, n in enumerate(rng.integers(1, 12, size=8))]
    outs = {}
    for side, model in (("jax", jm), ("port", pm)):
        mod = jserving if side == "jax" else serving
        router = mod.ReplicaRouter(_engines(side, model), name=side)
        with router:
            first = router.submit(prompts[1], max_new_tokens=5)
            res = {1: first.result(timeout=300)}
            futs = {i: router.submit(p, max_new_tokens=5)
                    for i, p in enumerate(prompts) if i != 1}
            res.update({i: f.result(timeout=300) for i, f in futs.items()})
            st = router.stats()
            assert st["affinity_hits"] >= 3
            outs[side] = [res[i].tolist() for i in range(len(prompts))]
        assert sum(r["routed"] for r in st["replicas"].values()) == 8
    assert outs["port"] == outs["jax"]


def test_mark_down_reroutes_queued_work():
    """A replica marked down mid-run takes no new work; its queued
    requests, cancelled and resubmitted, land on the survivor; all answers
    equal an undisturbed run's."""
    _jm, pm = make_pair()
    a, b = _engines("port", pm)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 64, size=int(n))
               for n in rng.integers(4, 30, size=10)]
    ref = {}
    with serving.GenerationEngine(pm, serving.GenerationConfig(
            max_slots=2, max_seq_len=48, page_len=8,
            prefill_buckets=(8, 16, 32)), device="cpu") as eng:
        for i, p in enumerate(prompts):
            ref[i] = eng.submit(p, max_new_tokens=6).result(timeout=300)
    router = serving.ReplicaRouter([a, b])
    with router:
        futs = {i: router.submit(p, max_new_tokens=6)
                for i, p in enumerate(prompts)}
        router.mark_down(a.name)
        moved = 0
        for i, f in list(futs.items()):
            if a.cancel(f):
                with pytest.raises(serving.RequestCancelled):
                    f.result(timeout=5)
                futs[i] = router.submit(prompts[i], max_new_tokens=6)
                moved += 1
        outs = {i: f.result(timeout=300) for i, f in futs.items()}
        st = router.stats()
    assert st["down"] == [a.name]
    assert moved >= 1 and st["replicas"][b.name]["routed"] >= moved
    for i in outs:
        assert outs[i].tolist() == ref[i].tolist()
