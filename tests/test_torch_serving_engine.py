"""The port's ``ServingEngine`` and ``BucketSpec`` against the JAX
package's: the same bucket validation and padding, the same answers within
1e-6 over the same-weight module and callable (batched results are not
bit-equal to unbatched ones in either package), and the engine's own
contract — back-pressure, deadline shedding, per-request error isolation,
closed-engine rejection, and the warmed-shape counters: a shape
no warm-up ran counts a miss, once."""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import serving as jserving
from paddle_tpu_torch.serving import (BadRequest, BucketSpec,
                                      DeadlineExceeded, EngineClosed,
                                      QueueFull, ServingConfig, ServingEngine)

# -- BucketSpec -------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [
    dict(batch_sizes=()),
    dict(batch_sizes=(0, 2)),
    dict(batch_sizes=(1, 2.5)),
    dict(batch_sizes=(4, 2, 4)),
    dict(seq_lens=(8, 8, 16)),
    dict(seq_lens=(16, 8), observed_floor=12),
    dict(seq_lens=(-8,)),
])
def test_bucket_spec_rejects_as_jax_does(kwargs):
    with pytest.raises(ValueError) as ref:
        jserving.BucketSpec(**kwargs)
    with pytest.raises(ValueError) as got:
        BucketSpec(**kwargs)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("kwargs,lengths", [
    (dict(batch_sizes=(8, 1, 4), seq_lens=(16, 64, 32)), (1, 16, 17, 64)),
    (dict(batch_sizes=(2,), seq_lens=(8,), seq_axis=1, pad_value=-1), (3, 8)),
    (dict(batch_sizes=(1, 2), seq_lens=None), (5,)),
])
def test_bucket_spec_pads_as_jax_does(kwargs, lengths):
    ref, got = jserving.BucketSpec(**kwargs), BucketSpec(**kwargs)
    assert repr(got) == repr(ref)
    assert got.max_batch == ref.max_batch
    for n in range(0, 10):
        assert got.batch_bucket(n) == ref.batch_bucket(n)
    rng = np.random.default_rng(0)
    for n in lengths:
        shape = (n, 3) if got.seq_axis == 0 else (3, n)
        a = rng.integers(0, 9, size=shape)
        np.testing.assert_array_equal(got.pad_sample_seq(a),
                                      ref.pad_sample_seq(a))
        np.testing.assert_array_equal(got.stack_batch([a, a], 4),
                                      ref.stack_batch([a, a], 4))
    shapes = [(None, 3), (2,)]
    if got.seq_lens is None:
        with pytest.raises(ValueError, match="declares no seq_lens"):
            list(got.warm_shapes(shapes))
        shapes = [(4, 3)]
    assert list(got.warm_shapes(shapes)) == list(ref.warm_shapes(shapes))
    if got.seq_lens:
        with pytest.raises(ValueError, match="exceeds the largest"):
            got.pad_sample_seq(np.zeros((got.seq_lens[-1] + 1, 3)
                                        if got.seq_axis == 0 else
                                        (3, got.seq_lens[-1] + 1)))


# -- the engine against the JAX engine ----------------------------------------------


def mlp_pair(seed=0):
    """A JAX ``Sequential(Linear(8, 16), Tanh, Linear(16, 4))`` and its
    torch twin with the same numpy-drawn weights."""
    rng = np.random.default_rng(seed)
    paddle.seed(seed)
    jnet = jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 4))
    state = {k: (0.5 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
             for k, v in jnet.state_dict().items()}
    jnet.set_state_dict(state)
    tnet = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                               torch.nn.Linear(16, 4))
    with torch.no_grad():
        for i in (0, 2):
            tnet[i].weight.copy_(torch.from_numpy(state[f"{i}.weight"].T))
            tnet[i].bias.copy_(torch.from_numpy(state[f"{i}.bias"]))
    return jnet, tnet, state


def _concurrent(eng, samples, clients=4):
    """Submit ``samples`` from ``clients`` threads; results in order."""
    out = [None] * len(samples)

    def client(c):
        futs = [(i, eng.submit(list(samples[i])))
                for i in range(c, len(samples), clients)]
        for i, f in futs:
            out[i] = f.result(timeout=120)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return out


def test_module_target_matches_the_jax_engine():
    jnet, tnet, _state = mlp_pair()
    rng = np.random.default_rng(1)
    samples = [(rng.standard_normal(8).astype(np.float32),)
               for _ in range(24)]
    spec = [((8,), "float32")]
    cfg = dict(max_batch_wait_ms=5.0)
    with jserving.ServingEngine(
            jnet, jserving.BucketSpec((1, 2, 4, 8)), input_specs=spec,
            config=jserving.ServingConfig(**cfg)) as jeng:
        ref = _concurrent(jeng, samples)
    with ServingEngine(tnet, BucketSpec((1, 2, 4, 8)), input_specs=spec,
                       config=ServingConfig(**cfg), device="cpu") as eng:
        got = _concurrent(eng, samples)
        st = eng.stats()
    for g, r in zip(got, ref):
        assert g[0].dtype == np.float32 and g[0].shape == (4,)
        np.testing.assert_allclose(g[0], np.asarray(r[0]), rtol=1e-6,
                                   atol=1e-6)
    c = st["counters"]
    assert c["responses_total"] == 24 and c["warmup_compiles"] == 4
    assert c.get("compile_cache_misses", 0) == 0
    assert st["warmed_executables"] == 4 and st["qps"] > 0


def test_callable_target_over_a_seq_bucket_matches_the_jax_engine():
    """A callable over a variable-length sequence (seq buckets 8 and 16)
    with two outputs: each position's value and the row's argmax; real
    positions agree within 1e-6."""
    _jnet, tnet, state = mlp_pair()
    w1, b1 = state["0.weight"], state["0.bias"]
    w2, b2 = state["2.weight"], state["2.bias"]

    def jfn(x):
        y = jnp.tanh(x @ w1 + b1) @ w2 + b2
        return y, jnp.argmax(y, axis=-1)

    def tfn(x):
        y = tnet(x)
        return y, y.argmax(dim=-1)

    rng = np.random.default_rng(2)
    samples = [(rng.standard_normal((int(n), 8)).astype(np.float32),)
               for n in rng.integers(1, 17, size=20)]
    spec = [((None, 8), "float32")]
    buckets = dict(batch_sizes=(1, 2, 4), seq_lens=(8, 16))
    with jserving.ServingEngine(jfn, jserving.BucketSpec(**buckets),
                                input_specs=spec) as jeng:
        ref = _concurrent(jeng, samples)
    with ServingEngine(tfn, BucketSpec(**buckets), input_specs=spec,
                       device="cpu") as eng:
        got = _concurrent(eng, samples)
        misses = eng.metrics.counter("compile_cache_misses")
    for (x,), g, r in zip(samples, got, ref):
        n = len(x)
        assert g[0].shape in ((8, 4), (16, 4))
        np.testing.assert_allclose(g[0][:n], np.asarray(r[0])[:n],
                                   rtol=1e-6, atol=1e-6)
        assert g[1][:n].tolist() == np.asarray(r[1])[:n].tolist()
    assert misses == 0


def test_respec_warms_before_the_swap():
    _jnet, tnet, _ = mlp_pair()
    with ServingEngine(tnet, BucketSpec((1, 2)), input_specs=[((8,), "float32")],
                       device="cpu") as eng:
        eng.submit([np.zeros(8, np.float32)]).result(timeout=60)
        eng.respec(BucketSpec((1, 2, 4, 8)))
        assert eng.metrics.counter("respec_compiles") == 2
        outs = _concurrent(eng, [(np.ones(8, np.float32),)] * 12)
        assert eng.metrics.counter("compile_cache_misses") == 0
        assert eng.stats()["buckets"].startswith("BucketSpec(batch_sizes=(1, 2, 4, 8)")
    # each answer is bit for bit the module's on some batch bucket: a
    # request batched alone runs M = 1, whose rounding differs from M > 1
    with torch.no_grad():
        exact = [r.numpy() for b in (1, 2, 4, 8)
                 for r in tnet(torch.ones(b, 8))]
    assert all(any(np.array_equal(o[0], r) for r in exact) for o in outs)


def test_unwarmed_shape_counts_one_miss_as_jax():
    """Without warm-up, the first batch at each shape is a miss and a later
    one at that shape a hit, in both packages."""
    jnet, tnet, _ = mlp_pair()
    cfg = dict(warmup_on_start=False, max_batch_wait_ms=0.0)
    spec = [((8,), "float32")]
    xs = [np.full(8, i, np.float32) for i in range(3)]
    counts = []
    for eng in (jserving.ServingEngine(jnet, jserving.BucketSpec((1, 2)),
                                       input_specs=spec,
                                       config=jserving.ServingConfig(**cfg)),
                ServingEngine(tnet, BucketSpec((1, 2)), input_specs=spec,
                              config=ServingConfig(**cfg), device="cpu")):
        with eng:
            for x in xs:
                eng.submit([x]).result(timeout=60)
            st = eng.stats()
        counts.append((st["counters"].get("compile_cache_misses", 0),
                       st["counters"].get("compile_cache_hits", 0),
                       st["warmed_executables"]))
    assert counts[1] == counts[0] == (1, 2, 1)


# -- the engine's own contract --------------------------------------------------------


def _slow_engine(delay_s=0.15, **cfg):
    def slow(x):
        time.sleep(delay_s)
        return x * 2
    return ServingEngine(slow, BucketSpec(batch_sizes=(1, 2)),
                         input_specs=[((4,), "float32")],
                         config=ServingConfig(warmup_on_start=False, **cfg),
                         device="cpu")


def test_queue_full_backpressure():
    eng = _slow_engine(delay_s=0.2, max_queue=2, max_batch_wait_ms=0.0)
    eng.start()
    x = np.zeros(4, np.float32)
    futs = [eng.submit([x])]          # occupies the worker
    time.sleep(0.05)
    with pytest.raises(QueueFull):
        for _ in range(10):           # must trip while the worker sleeps
            futs.append(eng.submit([x]))
    assert eng.metrics.counter("rejected_total") >= 1
    eng.close()
    for f in futs:
        f.result(timeout=30)          # drained on close


def test_deadline_shedding():
    eng = _slow_engine(delay_s=0.25, max_batch_wait_ms=0.0)
    eng.start()
    x = np.zeros(4, np.float32)
    first = eng.submit([x])
    t0 = time.monotonic()
    while eng.queue_depth() > 0 and time.monotonic() - t0 < 10:
        time.sleep(0.005)
    doomed = eng.submit([x], deadline_ms=50.0)
    ok = eng.submit([x])
    with pytest.raises(DeadlineExceeded):
        doomed.result(timeout=30)
    first.result(timeout=30)
    np.testing.assert_array_equal(ok.result(timeout=30)[0], x * 2)
    assert eng.metrics.counter("shed_total") == 1
    eng.close()


def test_bad_payload_fails_own_future_only():
    _jnet, tnet, _ = mlp_pair()
    with ServingEngine(tnet, BucketSpec((1, 2, 4, 8)),
                       input_specs=[((8,), "float32")],
                       config=ServingConfig(max_batch_wait_ms=10.0),
                       device="cpu") as eng:
        good1 = eng.submit([np.zeros(8, np.float32)])
        bad_dtype = eng.submit([np.zeros(8, np.int32)])
        bad_rank = eng.submit([np.zeros((2, 8), np.float32)])
        bad_arity = eng.submit([np.zeros(8, np.float32)] * 2)
        bad_dim = eng.submit([np.zeros(7, np.float32)])
        good2 = eng.submit([np.ones(8, np.float32)])
        for bad in (bad_dtype, bad_rank, bad_arity, bad_dim):
            with pytest.raises(BadRequest):
                bad.result(timeout=30)
        with torch.no_grad():
            ref1 = tnet(torch.zeros(1, 8)).numpy()[0]
            ref2 = tnet(torch.ones(1, 8)).numpy()[0]
        np.testing.assert_allclose(good1.result(timeout=60)[0], ref1,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(good2.result(timeout=60)[0], ref2,
                                   rtol=1e-6, atol=1e-6)
        assert eng.metrics.counter("bad_requests") == 4


def test_a_faulty_batch_fails_only_its_own_requests():
    calls = []

    def flaky(x):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("planted batch fault")
        return x + 1

    eng = ServingEngine(flaky, BucketSpec((1,)), input_specs=[((2,), "int64")],
                        config=ServingConfig(warmup_on_start=False,
                                             max_batch_wait_ms=0.0),
                        device="cpu")
    with eng:
        futs = [eng.submit([np.full(2, i)]) for i in range(3)]
        outs = []
        for f in futs:
            try:
                outs.append(f.result(timeout=30)[0].tolist())
            except RuntimeError as e:
                outs.append(str(e))
    assert outs == [[1, 1], "planted batch fault", [3, 3]]
    assert eng.metrics.counter("batch_failures") == 1


def test_engine_closed_rejects_and_fence_health_cancel():
    eng = _slow_engine(delay_s=0.2, max_batch_wait_ms=0.0)
    eng.start()
    assert eng.health()
    x = np.zeros(4, np.float32)
    busy = eng.submit([x])
    time.sleep(0.05)
    queued = eng.submit([x])
    assert eng.cancel(queued) and not eng.cancel(busy)
    from paddle_tpu_torch.serving import RequestCancelled
    with pytest.raises(RequestCancelled):
        queued.result(timeout=5)
    eng.fence()
    assert not eng.health()
    with pytest.raises(EngineClosed, match="fenced"):
        eng.submit([x])
    eng.unfence()
    assert eng.health()
    busy.result(timeout=30)
    eng.close()
    assert not eng.health()
    with pytest.raises(EngineClosed):
        eng.submit([x])


def test_unported_targets_and_specs_are_refused():
    class Predictorish:
        _layer = staticmethod(lambda x: x)

        def run(self, inputs=None):
            raise NotImplementedError

        def get_input_specs(self):
            return []

    class Native:
        def build_serving_runner(self, bucket_b, key, label=None):
            raise NotImplementedError

        def __call__(self, x):
            return x

    spec = [((4,), "float32")]
    with pytest.raises(TypeError, match="inference"):
        ServingEngine(Predictorish(), BucketSpec(), device="cpu")
    with pytest.raises(TypeError, match="inference"):
        ServingEngine(Predictorish(), BucketSpec(), input_specs=spec,
                      device="cpu")
    with pytest.raises(TypeError, match="build_serving_runner|sparse"):
        ServingEngine(Native(), BucketSpec(), input_specs=spec, device="cpu")
    with pytest.raises(TypeError, match="cannot serve"):
        ServingEngine(42, BucketSpec(), input_specs=spec, device="cpu")
    with pytest.raises(ValueError, match="input_specs required"):
        ServingEngine(lambda x: x, BucketSpec(), device="cpu")
    with pytest.raises(ValueError, match="bfloat16"):
        ServingEngine(lambda x: x, BucketSpec(),
                      input_specs=[((4,), "bfloat16")], device="cpu")
    with pytest.raises(ValueError, match="seq_axis"):
        ServingEngine(lambda x: x, BucketSpec(seq_lens=(8,)),
                      input_specs=[((4, None), "float32")], device="cpu")

def test_the_engine_raises_without_cuda(monkeypatch):
    """``device=None`` means CUDA; with no card it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(lambda x: x, BucketSpec(),
                      input_specs=[((4,), "float32")])
