"""Optimizer offload (``paddle_tpu_torch/jit/offload_stream.py``,
``distributed/offload.py``) and the pipeline wrapper's eager microbatch
loop against the JAX package.

In one process: ``plan_stream_groups`` against the JAX function over a
spread of sizes and knobs; the lane's counters, order and the error at
``wait()``; the offloaded ``ShardedTrainStep`` over a world-1 gloo group
against the JAX offload step (``tests/test_offload.py``'s net and
knobs, three steps: AdamW with and without a global-norm clip,
Momentum under the clip, ``accumulate(2)``), where the state rests, the
overlapped lane against the serialized one bit for bit, the resident
step bit for bit, the lane's schedule, and the scaler / ``accum_steps``
raise. Then one gloo world of 4 spawned CPU processes
(``torch_dist_worker``'s ``offload`` suite) runs the offloaded step at
sdp 2 x dp 2 and ``PipelineParallel.train_batch`` with
``accumulate_steps`` 2 and a ``GradScaler`` or an offloaded optimizer at
dp 4 (the reference's eager microbatch loop), against the JAX step and
wrapper on ``jax.devices()[:4]``.

Tolerances, as the fp32 steps of ``test_torch_distributed.py``: losses
rtol 2e-4, parameters atol 1e-5 (another summation order than XLA's);
overlapped against serialized and offloaded against resident exactly.
"""
import numpy as np
import pytest
import torch

import torch_dist_worker as W

pytestmark = pytest.mark.dist

# group sizing that makes the tiny net walk three groups (JAX test_offload
# _executor's knobs)
KNOBS = dict(segment_size=2048, buffer_max_size=4096)
CLIP = 0.5
LOSS_RTOL, PARAM_ATOL = 2e-4, 1e-5
# name: (degrees, rule, clip, accumulate)
CASES = {
    "adamw": (dict(dp=1), "adamw", None, 0),
    "adamw_clip": (dict(dp=1), "adamw", CLIP, 0),
    "momentum_clip": (dict(dp=1), "momentum", CLIP, 0),
    "adamw_accumulate2": (dict(dp=1), "adamw", None, 2),
    "sdp2_dp2_adamw_clip": (dict(sharding=2, dp=2), "adamw", CLIP, 0),
    "sdp2_dp2_momentum": (dict(sharding=2, dp=2), "momentum", None, 0),
}
# PipelineParallel.train_batch, accumulate_steps 2 at dp 4: (scaler
# options or None, offload)
WRAPPER = {
    "wrapper_scaler": (dict(init_loss_scaling=1024.0, incr_every_n_steps=2,
                            decr_every_n_nan_or_inf=1), False),
    "wrapper_offload": (None, True),
    "wrapper_offload_scaler": (dict(init_loss_scaling=1024.0), True),
}


def _jax():
    import jax

    import paddle_tpu as paddle
    import paddle_tpu.distributed as jdist

    return jax, paddle, jdist


def _jax_reset(jdist):
    jdist.reset_mesh()
    import paddle_tpu.distributed.collective as coll

    coll._DEFAULT_GROUP = None


def _torch_layout(state):
    return {k: (np.asarray(v).T if k.endswith("weight") else np.asarray(v))
            .astype(np.float32).copy() for k, v in state.items()}


def _batch():
    x = np.random.RandomState(3).rand(8, 16).astype("float32")
    y = np.random.RandomState(4).rand(8, 16).astype("float32")
    return x, y


def _jax_offload(degrees, rule, clip, accumulate):
    """The JAX offload step (``tests/test_offload_executor.py``'s
    ``_stream_run``) at ``degrees``: the initial state, three losses, the
    final state (torch layout)."""
    jax, paddle, jdist = _jax()
    import paddle_tpu.nn as nn
    import paddle_tpu.nn.functional as JF
    import paddle_tpu.optimizer as jopt

    n = int(np.prod(list(degrees.values())))
    paddle.seed(7)
    _jax_reset(jdist)
    jdist.init_mesh(devices=jax.devices()[:n], **degrees)
    net = nn.Sequential(nn.Linear(16, 32), nn.Tanh(), nn.Linear(32, 16))
    state0 = _torch_layout({k: v.numpy() for k, v in
                            net.state_dict().items()})
    c = None if clip is None else nn.ClipGradByGlobalNorm(clip)
    if rule == "adamw":
        o = jopt.AdamW(learning_rate=0.02, parameters=net.parameters(),
                       grad_clip=c)
    else:
        o = jopt.Momentum(learning_rate=0.1, momentum=0.9,
                          parameters=net.parameters(), grad_clip=c)
    net, o = jdist.group_sharded_parallel(net, o, level="os_g",
                                          offload=True, **KNOBS)
    step = jdist.ShardedTrainStep(net, lambda m, x, y: JF.mse_loss(m(x), y),
                                  o)
    if accumulate:
        step = step.accumulate(accumulate)
    x, y = _batch()
    losses = [float(step(paddle.to_tensor(x), paddle.to_tensor(y)))
              for _ in range(3)]
    final = _torch_layout({k: v.numpy() for k, v in
                           net.state_dict().items()})
    _jax_reset(jdist)
    return state0, {"losses": losses, "state": final}


def _jax_wrapper(scaler_kw, offload):
    """The JAX ``PipelineParallel.train_batch`` with accumulate_steps 2 at
    dp 4 (its eager microbatch loop), AdamW, three calls."""
    jax, paddle, jdist = _jax()
    import paddle_tpu.nn as nn
    import paddle_tpu.optimizer as jopt
    from paddle_tpu.amp import GradScaler
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.distributed.meta_parallel import PipelineParallel

    paddle.seed(13)
    _jax_reset(jdist)
    jdist.init_mesh(dp=4, devices=jax.devices()[:4])
    net = nn.Sequential(nn.Linear(8, 16), nn.Tanh(), nn.Linear(16, 4))
    state0 = _torch_layout({k: v.numpy() for k, v in
                            net.state_dict().items()})
    strategy = jfleet.DistributedStrategy()
    strategy.pipeline = True
    strategy.pipeline_configs = {"accumulate_steps": 2}
    opt = jopt.AdamW(learning_rate=0.01, parameters=net.parameters(),
                     weight_decay=0.01)
    if offload:
        net, opt = jdist.group_sharded_parallel(net, opt, level="os_g",
                                                offload=True)
    model = PipelineParallel(net, None, strategy)
    sc = None if scaler_kw is None else GradScaler(**scaler_kw)
    rng = np.random.RandomState(6)
    x = rng.rand(16, 8).astype("float32")
    y = rng.randint(0, 4, (16,)).astype("int64")
    losses = [float(model.train_batch((paddle.to_tensor(x),
                                       paddle.to_tensor(y)), opt,
                                      scaler=sc))
              for _ in range(3)]
    final = _torch_layout({k: v.numpy() for k, v in
                           net.state_dict().items()})
    _jax_reset(jdist)
    scale = None if sc is None else float(sc._scale)
    return ({"state": state0, "x": x, "y": y, "scaler": scaler_kw,
             "offload": offload},
            {"losses": losses, "state": final, "scale": scale})


# -- the planner and the lane ---------------------------------------------------

PLANS = [([2048, 128, 2048, 64], 2048, 4096),
         ([10 ** 9, 64], 2048, 4096),
         ([10, 10, 10], 2 ** 20, 2 ** 23),
         ([], 2 ** 20, 2 ** 23),
         ([5000], 100, 50),
         ([1, 2, 3, 4, 5, 6, 7, 8], 0, 0)] + [
    (list(np.random.RandomState(s).randint(1, 10 ** 6, 40)), seg, cap)
    for s, (seg, cap) in enumerate([(2 ** 20, 2 ** 23), (2 ** 16, 2 ** 18),
                                    (2 ** 22, 2 ** 21), (1, 1)])]


@pytest.mark.parametrize("case", range(len(PLANS)))
def test_plan_stream_groups_matches_jax(case):
    from paddle_tpu.jit.offload_stream import plan_stream_groups as jplan

    from paddle_tpu_torch.jit.offload_stream import plan_stream_groups

    sizes, seg, cap = PLANS[case]
    assert plan_stream_groups(sizes, seg, cap) == jplan(sizes, seg, cap)


@pytest.mark.parametrize("overlap", [True, False])
def test_stream_lane_counters_and_order(overlap):
    """The JAX ``test_stream_lane_counters`` on CPU tensors, a copy into
    given destinations too."""
    from paddle_tpu_torch.jit.offload_stream import StreamLane

    lane = StreamLane(overlap=overlap)
    try:
        a = torch.ones(256)
        out = lane.submit("h2d", [a, a], "cpu", tag=0).wait()
        assert len(out) == 2 and float(out[0][0]) == 1.0
        dst = torch.zeros(256)
        got = lane.submit("d2h", [out[0] * 3], [dst], tag=1).wait()
        assert got[0] is dst and float(dst[5]) == 3.0
        s = lane.stats()
        assert s["h2d_bytes"] == 2 * 1024 and s["d2h_bytes"] == 1024
        assert s["transfers"] == 2 and s["overlap"] is overlap
        assert 0.0 <= s["overlap_efficiency"] <= 1.0
        if not overlap:
            assert s["overlap_efficiency"] == 0.0
        assert lane.events == [("h2d", 0), ("d2h", 1)]
    finally:
        lane.close()


@pytest.mark.parametrize("overlap", [True, False])
def test_stream_lane_error_surfaces_at_wait(overlap):
    """A transfer that fails on the worker raises ``StreamTransferError``
    (its direction, group and names) at the consumer's ``wait()``, and
    every later submit raises it again."""
    from paddle_tpu_torch.jit.offload_stream import (StreamLane,
                                                     StreamTransferError)

    lane = StreamLane(overlap=overlap)
    try:
        bad = lane.submit("h2d", [torch.ones(4)], [torch.zeros(5)], tag=9,
                          names=["w"])
        with pytest.raises(StreamTransferError) as err:
            bad.wait()
        assert err.value.kind == "h2d" and err.value.tag == 9
        assert err.value.names == ("w",)
        with pytest.raises(StreamTransferError):
            lane.submit("h2d", [torch.ones(4)], "cpu", tag=10)
    finally:
        lane.close()


# -- the offloaded step in one process ------------------------------------------

@pytest.fixture
def world1(monkeypatch):
    """A world-1 gloo group for the test, the mesh reset after it."""
    import torch.distributed as tdist

    import paddle_tpu_torch.distributed as dist

    tdist.init_process_group("gloo", store=tdist.HashStore(), rank=0,
                             world_size=1)
    try:
        yield dist
    finally:
        dist.reset_mesh()
        tdist.destroy_process_group()


def _port_offload(dist, state0, rule, clip, accumulate, offload=True,
                  overlap=True, monkeypatch=None):
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    if monkeypatch is not None:
        monkeypatch.setenv("PT_OFFLOAD_OVERLAP", "1" if overlap else "0")
    dist.init_mesh(dp=1)
    net = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.Tanh(),
                              torch.nn.Linear(32, 16))
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state0.items()})
    c = None if clip is None else ClipGradByGlobalNorm(clip)
    if rule == "adamw":
        o = popt.AdamW(learning_rate=0.02, parameters=net.parameters(),
                       grad_clip=c)
    else:
        o = popt.Momentum(learning_rate=0.1, momentum=0.9,
                          parameters=net.parameters(), grad_clip=c)
    net, o = dist.group_sharded_parallel(net, o, level="os_g",
                                         offload=offload, **KNOBS)
    step = dist.ShardedTrainStep(
        net, lambda m, x, y: torch.nn.functional.mse_loss(m(x), y), o)
    run = step.accumulate(accumulate) if accumulate else step
    x, y = (torch.from_numpy(a) for a in _batch())
    losses = [float(run(x, y)) for _ in range(3)]
    state = {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}
    dist.reset_mesh()
    return {"losses": losses, "state": state}, step


def _held(got, ref, loss_rtol=LOSS_RTOL, atol=PARAM_ATOL):
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=loss_rtol)
    assert set(got["state"]) == set(ref["state"])
    for k, v in ref["state"].items():
        np.testing.assert_allclose(got["state"][k], v, atol=atol, err_msg=k)


@pytest.mark.parametrize("case", [k for k, v in CASES.items()
                                  if v[0] == dict(dp=1)])
def test_offloaded_step_matches_jax_world1(world1, case):
    degrees, rule, clip, accumulate = CASES[case]
    state0, ref = _jax_offload(degrees, rule, clip, accumulate)
    got, _ = _port_offload(world1, state0, rule, clip, accumulate)
    _held(got, ref)
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("accumulate", [0, 2])
def test_offloaded_equals_resident_and_serialized(world1, monkeypatch,
                                                  accumulate):
    """fp32: the offloaded step equals the resident step bit for bit (an
    elementwise rule over whole tensors, one clip over all of them), and
    the overlapped lane the serialized one; the walk took three groups,
    and only the overlapped lane hid transfer time."""
    state0, _ = _jax_offload(dict(dp=1), "adamw", CLIP, 0)
    over, step = _port_offload(world1, state0, "adamw", CLIP, accumulate,
                               monkeypatch=monkeypatch)
    serial, sstep = _port_offload(world1, state0, "adamw", CLIP, accumulate,
                                  overlap=False, monkeypatch=monkeypatch)
    resident, _ = _port_offload(world1, state0, "adamw", CLIP, accumulate,
                                offload=False)
    for other in (serial, resident):
        assert over["losses"] == other["losses"]
        for k, v in other["state"].items():
            np.testing.assert_array_equal(over["state"][k], v, err_msg=k)
    assert len(step._off.groups) == 3
    assert sstep.stream_stats()["overlap_efficiency"] == 0.0
    assert sstep.stream_stats()["overlap"] is False
    stats = step.stream_stats()
    # each step moves the 1072 masters and their two moments each way,
    # each tensor padded to 64 elements: 3456 fp32 words
    assert stats["h2d_bytes"] == stats["d2h_bytes"] == 3 * 3456 * 4
    assert stats["transfers"] == 3 * 2 * 3


def test_stream_schedule_is_pipelined(world1):
    """The port's order: groups 0 and 1 up before the forward, then per
    group its download and the upload two groups ahead."""
    state0, _ = _jax_offload(dict(dp=1), "adamw", None, 0)
    _, step = _port_offload(world1, state0, "adamw", None, 0)
    one = [("h2d", 0), ("h2d", 1), ("d2h", 0), ("h2d", 2), ("d2h", 1),
           ("d2h", 2)]
    assert step.stream_schedule() == one * 3


def test_offloaded_state_lives_on_the_host(world1):
    """The moments and the fp32 masters rest in host memory (page-locked
    where CUDA runs; here the CPU); the masters equal the parameters
    (fp32); the optimizer's state_dict reads them."""
    state0, _ = _jax_offload(dict(dp=1), "adamw", None, 0)
    _, step = _port_offload(world1, state0, "adamw", None, 0)
    o = step.optimizer
    for p in o._parameter_list:
        st = o._state[id(p)]
        assert set(st) == {"moment1", "moment2"}
        for v in st.values():
            assert v.device.type == "cpu" and v.dtype == torch.float32
            assert v.data_ptr() >= step._off.host.data_ptr()
    for m, p in zip(step.offload_masters(), o._parameter_list):
        assert m.device.type == "cpu" and m.dtype == torch.float32
        torch.testing.assert_close(m, p.detach(), rtol=0, atol=0)
    sd = o.state_dict()
    assert sd["global_step"] == 3 and len(sd) == 1 + 2 * 4


@pytest.mark.parametrize("kw", [{"accum_steps": 2}, {"scaler": True}])
def test_offload_raises_with_in_graph_scaler_or_accum_steps(world1, kw):
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.amp import GradScaler

    dist = world1
    dist.init_mesh(dp=1)
    net = torch.nn.Linear(4, 4)
    net, o = dist.group_sharded_parallel(
        net, popt.AdamW(learning_rate=0.1, parameters=net.parameters()),
        level="os_g", offload=True)
    if kw.get("scaler"):
        kw = {"scaler": GradScaler()}
    with pytest.raises(NotImplementedError, match="not supported together "
                       "with optimizer-state offload"):
        dist.ShardedTrainStep(net, lambda m, x: m(x).sum(), o, **kw)


# -- across ranks ---------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs, ref = {"offload": {}}, {}
    for key, (degrees, rule, clip, accumulate) in CASES.items():
        if degrees == dict(dp=1):
            continue
        state0, ref[key] = _jax_offload(degrees, rule, clip, accumulate)
        inputs["offload"][key] = dict(degrees=degrees, rule=rule, clip=clip,
                                      accumulate=accumulate, state=state0,
                                      batch=_batch(), knobs=KNOBS)
    for key, (scaler_kw, offload) in WRAPPER.items():
        inputs["offload"][key], ref[key] = _jax_wrapper(scaler_kw, offload)
    tmp = tmp_path_factory.mktemp("offload")
    outs = W.run(tmp, "offload", inputs)
    return inputs, ref, outs


@pytest.mark.parametrize("case", [k for k, v in CASES.items()
                                  if v[0] != dict(dp=1)])
def test_offloaded_step_matches_jax_across_ranks(runs, case):
    """sdp 2 x dp 2, ZeRO os_g with offload: each rank's masters and state
    are its slices; the gathered parameters and the losses against the
    JAX offload step at the same degrees."""
    _, ref, outs = runs
    for r in range(W.WORLD):
        _held(outs[r][case], ref[case])
        assert outs[r][case]["host_elems"] < outs[r][case]["full_elems"]


@pytest.mark.parametrize("case", list(WRAPPER))
def test_pipeline_wrapper_eager_loop_matches_jax(runs, case):
    """``PipelineParallel.train_batch`` with accumulate_steps 2 on a model
    that is not pipelined, with a ``GradScaler`` and / or an offloaded
    optimizer (the reference's eager microbatch loop) at dp 4: losses,
    parameters and the loss scale against the JAX wrapper."""
    _, ref, outs = runs
    for r in range(W.WORLD):
        got = outs[r][case]
        _held(got, ref[case])
        assert got["scale"] == ref[case]["scale"]
