"""The port's pipeline (``distributed.meta_parallel``), in-graph scaler,
gradient merge and ``ShardedTrainStep.accumulate`` against the JAX
package, numpy and one process.

In one process: the 1F1B order, ``pipeline_local`` against the
sequential model, the JAX ``tests/test_pipeline_generic.py`` cases of
``bubble_fraction`` / ``choose_microbatches`` / ``_segment`` run on the
port, the SendRecvMeta contract, the heterogeneous fallback, and the
optimizer kernels' device step and skip flag (plain versions). Then one
gloo world of 4 spawned CPU processes (``torch_dist_worker``'s
``pipeline`` suite) runs the tiny Llama at pp 2 x dp 2 (AdamW, and
Momentum under a binding global-norm clip), pp 2 x dp 2 with a scaler and
``accum_steps=2``, dp 2 x mp 2 with ``accum_steps=2`` and with
``accumulate(2)``, all against the JAX ``ShardedTrainStep`` on
``jax.devices()[:4]`` (the JAX pp path is a sound oracle:
``test_distributed.py::test_pp_pipeline_matches_sequential``); pp 4, pp 2
x mp 2 and the tied head at pp 2 x dp 2 against the port's ``TrainStep``
in one process; the tensor-parallel MLP under the in-graph scaler with an
overflow planted in the second call (``amp_state()`` field by field);
``PipelineParallel`` / ``HybridParallelOptimizer`` against the JAX
wrappers; ``GPTForCausalLMPipe`` over P2P; the ``reset_mesh`` cycle; a
checkpoint saved at dp 2 x mp 2 and resumed at pp 2 x dp 2, at sdp 4 and
in one process.

Tolerances, as ``test_torch_distributed.py``: losses rtol 1e-5, gathered
parameters atol 5e-5 (the MLP: 2e-4 and 1e-5); the scaler's state
exactly.
"""
import os
import sys
import warnings

import numpy as np
import pytest
import torch

import torch_dist_worker as W

# the one-device pipeline step, a harness (tools/pipeline_harness.py)
sys.path.append(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

CONFIG = dict(num_hidden_layers=4, hidden_size=64, intermediate_size=128,
              num_attention_heads=4, num_key_value_heads=2, vocab_size=128)
CLIP = 1.0
SCALER = dict(init_loss_scaling=1024.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
# name: (degrees, config overrides, clip, ShardedTrainStep options,
#        accumulate, calls, oracle: "jax" or "one_process")
CASES = {
    "pp2_dp2": (dict(pp=2, dp=2), {}, None, {}, None, 3, "jax"),
    "pp2_dp2_clip": (dict(pp=2, dp=2), {}, CLIP, {}, None, 3, "jax"),
    "pp2_dp2_scaler_accum2": (dict(pp=2, dp=2), {}, None,
                              dict(scaler=SCALER, accum_steps=2), None, 4,
                              "jax"),
    "dp2_mp2_accum2": (dict(dp=2, mp=2), {}, None, dict(accum_steps=2),
                       None, 4, "jax"),
    "dp2_mp2_accumulate2": (dict(dp=2, mp=2), {}, None, {}, 2, 3, "jax"),
    "pp4": (dict(pp=4), {}, None, {}, None, 3, "one_process"),
    "pp2_mp2": (dict(pp=2, mp=2), {}, None, {}, None, 3, "one_process"),
    "pp2_dp2_tied": (dict(pp=2, dp=2), {"tie_word_embeddings": True}, None,
                     {}, None, 3, "one_process"),
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


def _torch_layout(state, linears):
    return {k: (np.asarray(v).T if k in linears else np.asarray(v))
            .astype(np.float32).copy() for k, v in state.items()}


def _ids():
    return np.random.RandomState(0).randint(0, 128, (8, 32)).astype("int64")


def _jax_llama(degrees, overrides, clip, step_kw, accumulate, calls):
    jax, paddle, jdist = _jax()
    import paddle_tpu.nn as jnn
    import paddle_tpu.optimizer as jopt
    from paddle_tpu.amp import GradScaler as JScaler
    from paddle_tpu.models import LlamaConfig as JConfig
    from paddle_tpu.models import LlamaForCausalLM as JLlama

    from paddle_tpu_torch.models import LlamaConfig, llama_state_from_numpy

    _jax_reset(jdist)
    jdist.init_mesh(devices=jax.devices()[:4], **degrees)
    paddle.seed(5)
    m = JLlama(JConfig.tiny(**CONFIG, **overrides))
    cfg = LlamaConfig.tiny(**CONFIG, **overrides)

    def state():
        return {k: v.numpy() for k, v in
                llama_state_from_numpy({k: np.asarray(v.numpy()) for k, v in
                                        m.state_dict().items()}, cfg).items()}

    state0 = state()
    if clip is None:
        o = jopt.AdamW(learning_rate=1e-3, parameters=m.parameters())
    else:
        o = jopt.Momentum(learning_rate=0.1, momentum=0.9,
                          parameters=m.parameters(),
                          grad_clip=jnn.ClipGradByGlobalNorm(clip))
    kw = dict(step_kw)
    if "scaler" in kw:
        kw["scaler"] = JScaler(**kw["scaler"])
    step = jdist.ShardedTrainStep(m, lambda mm, x, y: mm(x, labels=y), o,
                                  **kw)
    if accumulate:
        step = step.accumulate(accumulate)
    ids = _ids()
    losses = [float(step(paddle.to_tensor(ids.astype("int32")),
                         paddle.to_tensor(ids.astype("int32"))))
              for _ in range(calls)]
    final = state()
    _jax_reset(jdist)
    return state0, {"losses": losses, "state": final}


def _one_process(state0, overrides, calls):
    """The port's ``TrainStep`` on the whole batch (AdamW lr 1e-3)."""
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig.tiny(**CONFIG, **overrides)
    model = LlamaForCausalLM(cfg, device="cpu", generator=seed(5, "cpu"))
    if state0 is None:
        state0 = {k: v.detach().numpy().copy()
                  for k, v in model.state_dict().items()}
    else:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state0.items()})
    o = AdamW(learning_rate=1e-3, parameters=model.parameters())
    step = TrainStep(model, lambda m, x, y: m(x, labels=y), o)
    ids = torch.from_numpy(_ids())
    losses = [float(step(ids, ids)) for _ in range(calls)]
    return state0, {"losses": losses,
                    "state": {k: v.detach().numpy().copy()
                              for k, v in model.state_dict().items()}}


def _mlp_batches(accum):
    rng = np.random.RandomState(4)
    x = rng.rand(8, 8).astype("float32")
    y = rng.rand(8, 8).astype("float32")
    planted = x.copy()
    planted[0, 0] = 3e38  # overflows the scaled loss: a non-finite step
    return [(x, y), (planted, y), (x, y), (x, y)] + \
        ([(x, y), (x, y)] if accum else [])


def _jax_mlp_scaler(accum_steps):
    jax, paddle, jdist = _jax()
    import paddle_tpu.nn as nn
    import paddle_tpu.nn.functional as JF
    import paddle_tpu.optimizer as jopt
    from paddle_tpu.amp import GradScaler as JScaler
    from paddle_tpu.distributed.fleet import (ColumnParallelLinear,
                                              RowParallelLinear)

    paddle.seed(3)
    _jax_reset(jdist)
    jdist.init_mesh(dp=2, mp=2, devices=jax.devices()[:4])

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.up = ColumnParallelLinear(8, 16, gather_output=False)
            self.down = RowParallelLinear(16, 8, input_is_parallel=True)

        def forward(self, x):
            return self.down(JF.gelu(self.up(x)))

    net = MLP()
    linears = {"up.weight", "down.weight"}
    state0 = _torch_layout({k: v.numpy() for k, v in
                            net.state_dict().items()}, linears)
    o = jopt.Adam(learning_rate=0.05, parameters=net.parameters())
    step = jdist.ShardedTrainStep(net, lambda m, x, y: JF.mse_loss(m(x), y),
                                  o, scaler=JScaler(**SCALER),
                                  accum_steps=accum_steps)
    losses, amps = [], []
    for x, y in _mlp_batches(accum_steps > 1):
        losses.append(float(step(paddle.to_tensor(x), paddle.to_tensor(y))))
        amps.append(step.amp_state())
    final = _torch_layout({k: v.numpy() for k, v in
                           net.state_dict().items()}, linears)
    _jax_reset(jdist)
    return state0, {"losses": losses, "amp": amps, "state": final}


FLEET = {
    "fleet_accumulate_steps": (dict(pipeline=True, pipeline_configs={
        "accumulate_steps": 2}), 3),
    "fleet_gradient_merge": (dict(gradient_merge=True,
                                  gradient_merge_configs={"k_steps": 2,
                                                          "avg": True}), 4),
    "fleet_lamb": (dict(lamb=True), 3),
}


def _jax_fleet(strategy_kw, calls):
    jax, paddle, jdist = _jax()
    import paddle_tpu.nn as nn
    import paddle_tpu.optimizer as jopt
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.distributed.meta_parallel import (
        HybridParallelOptimizer, PipelineParallel)

    paddle.seed(13)
    _jax_reset(jdist)
    jdist.init_mesh(dp=4, devices=jax.devices()[:4])
    net = nn.Sequential(nn.Linear(8, 16), nn.Tanh(), nn.Linear(16, 4))
    linears = {"0.weight", "2.weight"}
    state0 = _torch_layout({k: v.numpy() for k, v in
                            net.state_dict().items()}, linears)
    strategy = jfleet.DistributedStrategy()
    for k, v in strategy_kw.items():
        setattr(strategy, k, v)
    opt = jopt.AdamW(learning_rate=0.01, parameters=net.parameters(),
                     weight_decay=0.01)
    hopt = HybridParallelOptimizer(opt, None, strategy)
    model = PipelineParallel(net, None, strategy)
    rng = np.random.RandomState(6)
    x = rng.rand(16, 8).astype("float32")
    y = rng.randint(0, 4, (16,)).astype("int64")
    losses = [float(model.train_batch((paddle.to_tensor(x),
                                       paddle.to_tensor(y)), hopt))
              for _ in range(calls)]
    final = _torch_layout({k: v.numpy() for k, v in
                           net.state_dict().items()}, linears)
    _jax_reset(jdist)
    return ({"state": state0, "x": x, "y": y, "strategy": strategy_kw,
             "calls": calls},
            {"losses": losses, "rule": type(hopt._inner_opt).__name__,
             "state": final})


GPT = dict(num_hidden_layers=4, hidden_size=64, num_attention_heads=4,
           vocab_size=128, max_position_embeddings=64)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, references, every rank's results)."""
    inputs = {"pipeline": {}}
    ref = {}
    tp_state = None
    for key, (degrees, overrides, clip, step_kw, accumulate, calls,
              oracle) in CASES.items():
        if oracle == "jax":
            state0, ref[key] = _jax_llama(degrees, overrides, clip, step_kw,
                                          accumulate, calls)
            if degrees.get("pp", 1) > 1 and clip is None:
                # AdamW's parameters against the JAX step with pp folded
                # into dp: the JAX pp path's own parameters stand 6.2e-5
                # from its pp = 1 step's after three AdamW steps
                flat = dict(dp=degrees["pp"] * degrees.get("dp", 1))
                _, pp1 = _jax_llama(flat, overrides, clip, step_kw,
                                    accumulate, calls)
                ref[key]["pp_state"] = ref[key]["state"]
                ref[key]["state"] = pp1["state"]
        else:
            state0, ref[key] = _one_process(None, overrides, calls)
        inputs["pipeline"][key] = dict(
            degrees=degrees, config=dict(CONFIG, **overrides), clip=clip,
            step=step_kw, accumulate=accumulate, calls=calls, state=state0,
            ids=_ids())
    for key, accum in (("mlp_scaler", 1), ("mlp_scaler_accum2", 2)):
        tp_state, ref[key] = _jax_mlp_scaler(accum)
        inputs["pipeline"][key] = dict(scaler=SCALER, accum_steps=accum,
                                       batches=_mlp_batches(accum > 1))
    inputs["tp_mlp"] = {"state": tp_state}
    for key, (kw, calls) in FLEET.items():
        inputs["pipeline"][key], ref[key] = _jax_fleet(kw, calls)
    inputs["gpt_pipe"] = {"config": GPT, "ids": _ids()[:, :16]}
    tmp = tmp_path_factory.mktemp("pipeline")
    outs = W.run(tmp, "pipeline", inputs)
    return dict(inputs, tmpdir=tmp), ref, outs


def _held(got, ref, loss_rtol, atol):
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=loss_rtol)
    assert set(got["state"]) == set(ref["state"])
    for k, v in ref["state"].items():
        np.testing.assert_allclose(got["state"][k], v, atol=atol, err_msg=k)


def _gathered(runs, key, scenario):
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.models.convert import gather_llama_state

    inputs, _, outs = runs
    case = inputs["pipeline"][key]
    got = [outs[r][scenario] for r in range(W.WORLD)]
    states = [{k: torch.from_numpy(v) for k, v in g["state"].items()}
              for g in got]
    deg = {"sdp" if k == "sharding" else k: v
           for k, v in case["degrees"].items()}
    full = gather_llama_state(states, LlamaConfig.tiny(**case["config"]),
                              deg)
    return got, {k: v.numpy() for k, v in full.items()}


@pytest.mark.dist
@pytest.mark.parametrize("case", list(CASES))
def test_tiny_llama_step_matches_its_oracle(runs, case):
    """The tiny Llama (4 layers, batch 8 x 32) at the case's degrees and
    step options, every rank's losses and the parameters gathered over
    the ranks: against the JAX ``ShardedTrainStep`` at the same degrees
    and options, or (pp 4, pp 2 x mp 2, the tied head) the port's
    ``TrainStep`` on the whole batch in one process. Under AdamW at pp 2
    the parameters are held to the JAX step with pp folded into dp (the
    same function): the JAX pp path's own parameters differ from that
    step's by 6.2e-5 after three steps (Adam's ``m / sqrt(v)`` turns an
    order-level change of a near-zero gradient into a full-size one),
    and the port's lie within 5e-5 of it; they are held to the JAX pp
    step's at 2e-4."""
    _, ref, outs = runs
    got, full = _gathered(runs, case, f"llama_{case}")
    for r in range(W.WORLD):
        np.testing.assert_allclose(got[r]["losses"], ref[case]["losses"],
                                   rtol=1e-5)
        assert got[r]["pipelined"] == (CASES[case][0].get("pp", 1) > 1)
    if CASES[case][1].get("tie_word_embeddings"):
        # the last stage's head is the embedding's copy, still equal
        np.testing.assert_array_equal(full["lm_head.weight"],
                                      full["llama.embed_tokens.weight"])
    _held({"losses": got[0]["losses"], "state": full}, ref[case], 1e-5, 5e-5)
    if "pp_state" in ref[case]:
        _held({"losses": got[0]["losses"], "state": full},
              {"losses": ref[case]["losses"], "state": ref[case]["pp_state"]},
              1e-5, 2e-4)


@pytest.mark.dist
@pytest.mark.parametrize("case", ["mlp_scaler", "mlp_scaler_accum2"])
def test_in_graph_scaler_matches_jax(runs, case):
    """The MLP at dp 2 x mp 2 under the in-graph scaler (``accum_steps``
    1 and 2), an overflow planted in the second call: the losses, the
    gathered parameters and ``amp_state()`` after every call field by
    field against the JAX step; the scaler's and optimizer's host fields
    read the last state; the scaler then takes an eager ``step`` from it,
    and a state loaded into it is what the next in-graph call reads."""
    _, ref, outs = runs
    for r in range(W.WORLD):
        got = outs[r][case]
        np.testing.assert_allclose(got["losses"], ref[case]["losses"],
                                   rtol=2e-4)
        assert got["amp"] == ref[case]["amp"]
        last = ref[case]["amp"][-1]
        host = got["host"]
        assert (host["scale"], host["good"], host["bad"], host["found_inf"],
                host["global_step"]) == (last["loss_scale"],
                                         last["good_steps"],
                                         last["bad_steps"], last["found_inf"],
                                         last["updates"])
        assert host["state_dict"]["scale"] == last["loss_scale"]
        for k, v in ref[case]["state"].items():
            np.testing.assert_allclose(got["state"][k], v, atol=1e-5,
                                       err_msg=k)
        # then an eager GradScaler step: one finite step of the state
        # machine from the in-graph state, one more update counted
        good = last["good_steps"] + 1
        scale = last["loss_scale"]
        if good >= SCALER["incr_every_n_steps"]:
            scale, good = scale * 2.0, 0
        eager = got["eager"]
        assert (eager["scale"], eager["good"], eager["bad"],
                eager["found_inf"], eager["global_step"]) == (
            scale, good, 0, False, last["updates"] + 1)
        assert eager["state_dict"]["scale"] == scale
        # a loaded state (scale 8, no good steps) is what the next in-graph
        # call reads: finite, it counts one good step and (k = 1) updates
        k = 2 if case.endswith("accum2") else 1
        assert got["after_load"] == {
            "loss_scale": 8.0, "good_steps": 1, "bad_steps": 0,
            "found_inf": False,
            "updates": last["updates"] + 1 + (1 if k == 1 else 0)}
    # the planted overflow was caught and skipped
    assert ref[case]["amp"][1]["found_inf"]


@pytest.mark.dist
@pytest.mark.parametrize("case", list(FLEET))
def test_fleet_wrappers_match_jax(runs, case):
    """``PipelineParallel.train_batch`` at dp 4: with ``accumulate_steps``
    2 (``ShardedTrainStep.accumulate``), with a ``HybridParallelOptimizer``
    gradient merge of 2 (``accum_steps``) and with its lamb swap."""
    _, ref, outs = runs
    for r in range(W.WORLD):
        got = outs[r][case]
        assert got["rule"] == ref[case]["rule"]
        _held(got, ref[case], 2e-4, 1e-5)


def _gpt_reference(cfg_kw, ids, calls):
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    model = GPTForCausalLM(GPTConfig.tiny(**cfg_kw), device="cpu",
                           generator=seed(1, "cpu"))
    o = AdamW(learning_rate=1e-3, parameters=model.parameters())
    step = TrainStep(model, lambda m, x, y: m(x, labels=y), o)
    ids = torch.from_numpy(ids)
    losses = [float(step(ids, ids)) for _ in range(calls)]
    with torch.no_grad():
        final = float(model(ids, labels=ids))
    return losses, final, {k: v.detach().numpy().copy()
                           for k, v in model.state_dict().items()}


def _pipe_name(key, layers):
    """A ``GPTForCausalLMPipe`` parameter's ``GPTForCausalLM`` name."""
    i, rest = key.split(".", 2)[1:]
    i = int(i)
    if i == 0 or rest.startswith("shared."):
        return "gpt." + rest.replace("shared.", "")
    if i == layers + 1:
        return "gpt." + rest
    return f"gpt.layers.{i - 1}.{rest}"


@pytest.mark.dist
def test_gpt_pipe_pp2_matches_gpt_in_one_process(runs):
    """``GPTForCausalLMPipe`` at pp 2 x dp 2 through
    ``PipelineParallel.train_batch`` (``accumulate_steps`` 2, P2P between
    the stages, the tied head's gradient all-reduced over pp) against the
    port's ``GPTForCausalLM`` on the whole batch in one process: losses,
    ``eval_batch``, and every parameter, the last stage's copy of the
    embedding included."""
    inputs, _, outs = runs
    c = inputs["gpt_pipe"]
    losses, final, state = _gpt_reference(c["config"], c["ids"], 3)
    for r in range(W.WORLD):
        got = outs[r]["gpt_pipe"]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(got["eval"], final, rtol=1e-5)
        for k, v in got["state"].items():
            if ".shared." in k and "embed_tokens" not in k:
                continue  # the head's copy of the position table is unused
            np.testing.assert_allclose(
                v, state[_pipe_name(k, GPT["num_hidden_layers"])],
                atol=5e-5, err_msg=k)


@pytest.mark.dist
def test_localsgd_averages_over_the_data_ranks(runs):
    """``strategy.localsgd`` with k_steps 2 at dp 4: after the first update
    each rank keeps its own weights, after the second they are the mean
    over the data ranks (1.5 from 0, 1, 2, 3)."""
    outs = runs[2]
    for r in range(W.WORLD):
        first, second = outs[r]["localsgd"]["after"]
        np.testing.assert_array_equal(first, np.full(3, float(r)))
        np.testing.assert_array_equal(second, np.full(3, 1.5))


@pytest.mark.dist
def test_reset_mesh_cycle_runs_in_one_world(runs):
    """dp 2 x mp 2, a step, ``reset_mesh``, pp 2 x dp 2, a step,
    ``reset_mesh``, three times over in one world: every step runs and
    each mesh's first step gives the same loss every time."""
    outs = runs[2]
    for r in range(W.WORLD):
        got = outs[r]["reset_cycle"]["losses"]
        assert len(got) == 6 and np.isfinite(got).all()
        assert got[0] == got[2] == got[4]
        assert got[1] == got[3] == got[5]
        np.testing.assert_allclose(got[0], got[1], rtol=1e-5)


@pytest.mark.dist
@pytest.mark.parametrize("where", ["pp2_dp2", "sdp4", "one_process"])
def test_checkpoint_resumes_on_another_mesh(runs, where):
    """A checkpoint saved at dp 2 x mp 2 after one AdamW step, loaded at pp
    2 x dp 2, at sdp 4 (ZeRO-3) or in one process: its next two steps
    equal the unbroken run's (losses rtol 1e-5, parameters atol 5e-5) and
    the step count comes back."""
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.convert import gather_llama_state
    from paddle_tpu_torch.optimizer import AdamW

    inputs, _, outs = runs
    case = inputs["pipeline"]["pp2_dp2"]
    cfg = LlamaConfig.tiny(**case["config"])
    unbroken = [outs[r]["checkpoint"]["unbroken"] for r in range(W.WORLD)]
    want = gather_llama_state([{k: torch.from_numpy(v) for k, v in
                                u["state"].items()} for u in unbroken],
                              cfg, {"dp": 2, "mp": 2})
    if where == "one_process":
        model = LlamaForCausalLM(cfg, device="cpu")
        o = AdamW(learning_rate=1e-3, parameters=model.parameters())
        ckpt.load_sharded_model(model, o, str(inputs["tmpdir"] /
                                              "ckpt_dp2_mp2"))
        assert o._global_step == 1
        step = TrainStep(model, lambda m, x, y: m(x, labels=y), o)
        ids = torch.from_numpy(case["ids"])
        got = {"losses": [float(step(ids, ids)) for _ in range(2)],
               "state": {k: v.detach().numpy() for k, v in
                         model.state_dict().items()}}
    else:
        runs_ = [outs[r]["checkpoint"][where] for r in range(W.WORLD)]
        assert all(x["global_step"] == 3 for x in runs_)
        deg = {"pp": 2, "dp": 2} if where == "pp2_dp2" else {"sdp": 4}
        full = gather_llama_state([{k: torch.from_numpy(v) for k, v in
                                    x["state"].items()} for x in runs_],
                                  cfg, deg, stage3=where == "sdp4")
        got = {"losses": runs_[0]["losses"],
               "state": {k: v.numpy() for k, v in full.items()}}
    _held(got, {"losses": unbroken[0]["losses"],
                "state": {k: v.numpy() for k, v in want.items()}},
          1e-5, 5e-5)


# -- in one process ---------------------------------------------------------------

@pytest.mark.parametrize("pp,m", [(2, 2), (2, 5), (3, 4), (4, 8), (4, 2),
                                  (1, 3)])
def test_one_f_one_b_order(pp, m):
    """Each stage runs every microbatch's forward and backward once, both
    in microbatch order, ``pp - 1 - r`` forwards before its first
    backward (fewer where M is smaller), at most ``pp - r`` microbatches
    in flight, and forward i before backward i; driven locally, the
    bodies finish (the mailboxes never deadlock)."""
    from paddle_tpu_torch.distributed.meta_parallel import one_f_one_b
    from paddle_tpu_torch.distributed.meta_parallel.pipeline import run_local

    for r in range(pp):
        ops = one_f_one_b(pp, r, m)
        fs = [i for k, i in ops if k == "F"]
        bs = [i for k, i in ops if k == "B"]
        assert fs == list(range(m)) and bs == list(range(m))
        warm = min(pp - r - 1, m)
        assert ops.index(("B", 0)) == warm + (1 if m > warm else 0)
        live = 0
        for k, i in ops:
            live += 1 if k == "F" else -1
            assert 0 <= live <= pp - r
            if k == "B":
                assert ops.index(("F", i)) < ops.index(("B", i))

    class Recorder:
        def __init__(self, r):
            self.r, self.ops = r, []

        def forward(self, i, inp):
            assert (inp is None) == (self.r == 0)
            self.ops.append(("F", i))
            return torch.tensor(float(i))

        def backward(self, i, dout):
            assert (dout is None) == (self.r == pp - 1)
            self.ops.append(("B", i))
            return torch.tensor(float(i))

    recs = [Recorder(r) for r in range(pp)]
    run_local(recs, m)
    for r, rec in enumerate(recs):
        assert rec.ops == one_f_one_b(pp, r, m)


def _llama_stages(pp, layers=4, **kw):
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(num_hidden_layers=layers, **kw)
    full = LlamaForCausalLM(cfg, device="cpu", generator=seed(3, "cpu"))
    stages = [LlamaForCausalLM(cfg, device="cpu", generator=seed(3, "cpu"),
                               stage=(r, pp)) for r in range(pp)]
    return full, stages


@pytest.mark.parametrize("pp,m", [(2, 4), (4, 8)])
def test_pipeline_local_matches_the_sequential_model(pp, m):
    """Every stage of the tiny Llama on one process (``LocalPipelineStep``,
    AdamW, recompute): the stages drawn from one generator equal the pp =
    1 model, and two steps give its ``TrainStep.accumulate(M)`` losses and
    parameters bit for bit (M a power of two: each microbatch's share
    ``sum / (M c)`` is ``(sum / c) / M`` exactly)."""
    from pipeline_harness import LocalPipelineStep
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    full, stages = _llama_stages(pp, use_recompute=True)
    ref = dict(full.named_parameters())
    for st in stages:
        for n, p in st.named_parameters():
            assert torch.equal(p, ref[n]), n
    ids = torch.randint(0, 256, (m, 16),
                        generator=torch.Generator().manual_seed(0))
    a = TrainStep(full, lambda mm, x, y: mm(x, labels=y),
                  AdamW(learning_rate=1e-3,
                        parameters=full.parameters())).accumulate(m)
    b = LocalPipelineStep(stages, AdamW(
        learning_rate=1e-3,
        parameters=[p for st in stages for p in st.parameters()]), m)
    for _ in range(2):
        assert torch.equal(a(ids, ids), b(ids, ids))
    for st in stages:
        for n, p in st.named_parameters():
            assert torch.equal(p, ref[n]), n


def test_gpt_pipe_local_matches_gpt():
    """``GPTForCausalLMPipe`` in two stages on one process (the tied
    embedding on both, its gradients summed) against ``GPTForCausalLM``'s
    ``TrainStep.accumulate(4)``: losses rtol 1e-5 over three AdamW steps,
    the two copies of the tied weight equal after each."""
    from paddle_tpu_torch.device import seed
    from pipeline_harness import LocalPipelineStep
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         GPTForCausalLMPipe)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig.tiny(**GPT)
    ref = GPTForCausalLM(cfg, device="cpu", generator=seed(1, "cpu"))
    stages = [GPTForCausalLMPipe(cfg, device="cpu", generator=seed(1, "cpu"),
                                 num_stages=2, stage=r) for r in range(2)]
    assert stages[0].pp_shared_shapes() == {"embed": (128, 64)}
    ids = torch.from_numpy(_ids()[:, :32])
    a = TrainStep(ref, lambda m, x, y: m(x, labels=y), AdamW(
        learning_rate=1e-3, parameters=ref.parameters())).accumulate(4)
    b = LocalPipelineStep(stages, AdamW(
        learning_rate=1e-3,
        parameters=[p for st in stages for p in st.parameters()]), 4)
    for _ in range(3):
        np.testing.assert_allclose(float(b(ids, ids)), float(a(ids, ids)),
                                   rtol=1e-5)
        assert torch.equal(stages[0].run_function["0"].embed_tokens.weight,
                           stages[1].run_function["6"].shared
                           .embed_tokens.weight)


def test_send_recv_meta_contract_raises():
    """A stage whose output is not the (shape, dtype) it received breaks
    the SendRecvMeta contract: the pipeline raises."""
    from paddle_tpu_torch.distributed.meta_parallel import pipeline_local

    class Stage(torch.nn.Module):
        def __init__(self, first, last, widen):
            super().__init__()
            self.first, self.last, self.widen = first, last, widen
            self.w = torch.nn.Parameter(torch.ones(4))

        def pipeline_forward(self, inp, x):
            h = x * self.w if self.first else inp * self.w
            if self.widen:
                h = torch.cat([h, h], dim=-1)
            return h.sum() if self.last else h

    x = torch.ones(4, 4)
    ok = [Stage(True, False, False), Stage(False, False, False),
          Stage(False, True, False)]
    pipeline_local(ok, x, num_microbatches=2)
    bad = [Stage(True, False, False), Stage(False, False, True),
           Stage(False, True, False)]
    with pytest.raises(ValueError, match="SendRecvMeta"):
        pipeline_local(bad, x, num_microbatches=2)


def test_heterogeneous_pipeline_warns_and_runs_whole():
    """``PipelineLayer`` over blocks that are not homogeneous, at pp 2:
    it warns (JAX ``test_pipeline_generic.py:94``) and keeps every layer,
    running the whole model."""
    from paddle_tpu_torch.distributed.meta_parallel import PipelineLayer

    with pytest.warns(UserWarning, match="no homogeneous layer run"):
        pipe = PipelineLayer(layers=[torch.nn.Linear(8, 16),
                                     torch.nn.Linear(16, 4),
                                     torch.nn.Linear(4, 2)],
                             num_stages=2, stage=1)
    assert not pipe.pipelined and len(pipe.run_function) == 3
    assert pipe(torch.randn(4, 8)).shape == (4, 2)


def test_bubble_fraction_formula():
    from paddle_tpu_torch.distributed.meta_parallel import bubble_fraction

    assert bubble_fraction(4, 2) == pytest.approx(1 / 5)
    assert bubble_fraction(2, 2) == pytest.approx(1 / 3)
    assert bubble_fraction(8, 1) == 0.0
    assert bubble_fraction(8, 4) == pytest.approx(3 / 11)


class _Env:
    """A mesh's degrees alone (``choose_microbatches`` reads no more)."""

    def __init__(self, **deg):
        self.deg = deg

    def get_dim(self, ax):
        return self.deg.get(ax, 1)


def test_microbatches_kept_when_batch_feasible():
    """The JAX case on the port: pp 2 x dp 4, batch 16 keeps M = 4 with no
    warning; batch 8 clamps to 2, loudly, naming the batch 16."""
    from paddle_tpu_torch.distributed.meta_parallel import (
        bubble_fraction, choose_microbatches)

    env = _Env(pp=2, dp=4)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert choose_microbatches(16, 4, env) == 4
    assert bubble_fraction(4, 2) == pytest.approx(1 / 5)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert choose_microbatches(8, 4, env) == 2
    assert any("multiple of 16" in str(x.message) for x in w)


def test_seg_method_pattern_balances_matching_layers():
    """The JAX ``_segment`` cases on the port: ``layer:Block`` balances the
    matching layers, the edge layers ride along, too few matches warn and
    fall back to the uniform split."""
    from paddle_tpu_torch.distributed.meta_parallel import PipelineLayer

    class Emb:
        pass

    class Block:
        pass

    class Head:
        pass

    layers = [Emb()] + [Block() for _ in range(8)] + [Head()]
    parts = PipelineLayer._segment(10, 2, "layer:Block", layers=layers)
    assert parts == [0, 5, 10]
    layers2 = [Emb(), Emb(), Emb()] + [Block() for _ in range(4)]
    parts2 = PipelineLayer._segment(7, 2, "layer:Block", layers=layers2)
    n_blocks2 = [sum(isinstance(layers2[i], Block) for i in range(lo, hi))
                 for lo, hi in zip(parts2, parts2[1:])]
    assert n_blocks2 == [2, 2], (parts2, n_blocks2)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        parts3 = PipelineLayer._segment(4, 4, "layer:Nope",
                                        layers=[Block()] * 4)
    assert parts3 == [0, 1, 2, 3, 4]
    assert any("falling back" in str(x.message) for x in w)


def test_homogeneous_run_and_signature():
    """``find_homogeneous_run`` finds the longest run of identical blocks
    (parameterless layers break a run), ``layer_signature`` tells the
    shapes apart."""
    from paddle_tpu_torch.distributed.meta_parallel import (
        find_homogeneous_run, layer_signature)

    L = torch.nn.Linear
    layers = [L(4, 8), L(8, 8), L(8, 8), L(8, 8), torch.nn.Tanh(), L(8, 8)]
    assert find_homogeneous_run(layers) == (1, 4)
    assert find_homogeneous_run(layers, min_len=4) is None
    assert layer_signature(torch.nn.Tanh()) is None
    assert layer_signature(L(4, 8)) != layer_signature(L(8, 8))


@pytest.mark.parametrize("rule", ["adam", "sgd", "momentum", "adagrad",
                                  "adamax", "rmsprop", "adadelta", "lamb",
                                  "lars", "adafactor"])
@pytest.mark.parametrize("skip", [0, 1])
def test_device_step_and_skip_flag(rule, skip):
    """A ``StepBatch`` bound to a device count and skip flag
    (``bind_device_step``): with the flag set the update writes nothing;
    clear, it equals the update at step ``count + 1`` taken from the host,
    bit for bit (the plain versions on the CPU)."""
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.kernels import optimizer as kopt

    make = {"adam": lambda ps: popt.AdamW(learning_rate=0.1, parameters=ps),
            "sgd": lambda ps: popt.SGD(learning_rate=0.1, parameters=ps),
            "momentum": lambda ps: popt.Momentum(learning_rate=0.1,
                                                 parameters=ps),
            "adagrad": lambda ps: popt.Adagrad(learning_rate=0.1,
                                               parameters=ps),
            "adamax": lambda ps: popt.Adamax(learning_rate=0.1,
                                             parameters=ps),
            "rmsprop": lambda ps: popt.RMSProp(learning_rate=0.1,
                                               parameters=ps),
            "adadelta": lambda ps: popt.Adadelta(learning_rate=0.1,
                                                 parameters=ps),
            "lamb": lambda ps: popt.Lamb(learning_rate=0.1, parameters=ps),
            "lars": lambda ps: popt.LarsMomentum(learning_rate=0.1,
                                                 parameters=ps),
            "adafactor": lambda ps: popt.Adafactor(learning_rate=0.1,
                                                   parameters=ps)}[rule]
    g = torch.Generator().manual_seed(1)
    shapes = [(6, 10), (7,)]
    init = [torch.randn(s, generator=g) for s in shapes]
    grads = [torch.randn(s, generator=g) for s in shapes]

    def run(device_step, host_step):
        ps = [torch.nn.Parameter(t.clone()) for t in init]
        o = make(ps)
        for _ in range(2):  # state from a step first
            for p, gr in zip(ps, grads):
                p.grad = gr.clone()
            o.step()
        o._global_step = host_step
        for p, gr in zip(ps, grads):
            p.grad = gr * 0.5
        before = [p.detach().clone() for p in ps]
        o._apply(device_step=device_step)
        return before, [p.detach().clone() for p in ps]

    count = torch.tensor([6], dtype=torch.int32)
    flag = torch.tensor([skip], dtype=torch.int32)
    before, got = run((count, flag), 0)
    if skip:
        for a, b in zip(before, got):
            assert torch.equal(a, b)
    else:
        _, want = run(None, 6)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert any(not torch.equal(a, b) for a, b in zip(before, got))
    assert kopt.HEADER_WORDS == 3
