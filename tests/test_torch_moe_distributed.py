"""The MoE Llama across ranks (``paddle_tpu_torch.nn.layer.moe`` under a
mesh, ``distributed.models.moe``) against the JAX ``ShardedTrainStep``.

One gloo world of 4 spawned CPU processes (``torch_dist_worker``'s ``moe``
suite, a file store under ``tmp_path``) runs every case; the JAX oracle,
the same tiny MoE Llama (2 layers, hidden 64, 4 experts top-2, vocab 128,
batch 4 x 32) at the same degrees from the same seeded weights, runs here
on ``jax.devices()[:4]``. What must agree is the global result: three
losses (rtol 1e-5) and the parameters gathered over the ranks (atol
5e-5). Under AdamW at pp 2 x dp 2 the parameters are held to the JAX pp
step at 2e-4, its own error (``test_torch_pipeline.py``): the MoE pp step
is no function of a step without pp (the aux and the capacity are taken
per microbatch), so there is no folded oracle.

The cases: dp 4 (``fused``; ``index`` with a capacity factor that drops
rows), sdp 4 (``os_g``, ``p_g_os``), ep 4, ep 2 x dp 2, ep 2 x mp 2, pp
2 x dp 2, ep 2 x dp 2 under Momentum and a global-norm clip that binds,
a per-tensor clip, and Momentum alone; Adafactor at ep 2 x dp 2, Lamb at
dp 2 x mp 2, LARS at sdp 4 (``os_g``); cp 2 x dp 2 (ring attention,
``index`` with a capacity that drops rows and ``fused``; Ulysses under
Momentum and the clip).
Four planted faults must fail their checks: a per-rank capacity, a
per-rank aux, the clip's norm without its ep all-reduce, and the
gradients of ep-replicated parameters summed over ep.
"""
import numpy as np
import pytest
import torch

import torch_dist_worker as W

pytestmark = pytest.mark.dist

MOE_CONFIG = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
                  num_attention_heads=4, num_key_value_heads=2,
                  vocab_size=128, num_experts=4, top_k=2)
# the clips of the Momentum cases: the global norm of this model's first
# gradients is about 1 and the expert stacks' own norms 0.005-0.009, so
# each clip binds (the per-tensor one on every expert stack). The
# experts' share of the global norm is small: the per-tensor clip, at lr
# 10, is what shows an expert norm counted on one rank's experts alone (a
# factor of sqrt(2) on their updates), and the unclipped case what shows
# a gradient counted twice
CLIP = ("global", 0.25)
TENSOR_CLIP = ("tensor", 0.002)
# name: (degrees, dispatch, config overrides, rule, ZeRO level, clip)
CASES = {
    "dp4_fused": (dict(dp=4), "fused", {}, "adamw", None, None),
    "dp4_index": (dict(dp=4), "index", {"capacity_factor": 0.5}, "adamw",
                  None, None),
    "sdp4_os_g": (dict(sharding=4), "index", {}, "adamw", "os_g", None),
    "sdp4_p_g_os": (dict(sharding=4), "fused", {}, "adamw", "p_g_os", None),
    "ep4": (dict(ep=4), "index", {}, "adamw", None, None),
    "ep2_dp2": (dict(ep=2, dp=2), "index", {}, "adamw", None, None),
    "ep2_mp2": (dict(ep=2, mp=2), "index", {}, "adamw", None, None),
    "pp2_dp2": (dict(pp=2, dp=2), "index", {"pp_microbatches": 2}, "adamw",
                None, None),
    "ep2_dp2_clip": (dict(ep=2, dp=2), "index", {}, "momentum", None, CLIP),
    "ep2_dp2_tensor_clip": (dict(ep=2, dp=2), "index", {}, "momentum_lr10",
                            None, TENSOR_CLIP),
    "ep2_dp2_momentum": (dict(ep=2, dp=2), "index", {}, "momentum", None,
                         None),
    "adafactor_ep2_dp2": (dict(ep=2, dp=2), "index", {}, "adafactor", None,
                          None),
    "lamb_dp2_mp2": (dict(dp=2, mp=2), "index", {}, "lamb", None, None),
    "lars_sdp4_os_g": (dict(sharding=4), "index", {}, "lars", "os_g", None),
    # under cp the tokens of a row are split over the cp ranks: the
    # capacity's places and the aux over the global batch's order
    "cp2_dp2_index": (dict(cp=2, dp=2), "index", {"capacity_factor": 0.5},
                      "adamw", None, None),
    "cp2_dp2_fused": (dict(cp=2, dp=2), "fused", {}, "adamw", None, None),
    "cp2_dp2_ulysses_momentum": (dict(cp=2, dp=2), "index",
                                 {"cp_impl": "ulysses"}, "momentum", None,
                                 CLIP),
}
# planted fault: the case whose check it must fail
FAULTS = {"per_rank_capacity": "dp4_index", "per_rank_aux": "dp4_fused",
          "norm_without_ep": "ep2_dp2_tensor_clip",
          "ep_grad_counted_twice": "ep2_dp2_momentum",
          "cp_block_order": "cp2_dp2_index"}


def _jax():
    import jax

    import paddle_tpu as paddle
    import paddle_tpu.distributed as jdist

    return jax, paddle, jdist


def _jax_reset(jdist):
    jdist.reset_mesh()
    import paddle_tpu.distributed.collective as coll

    coll._DEFAULT_GROUP = None


def _ids():
    return np.random.RandomState(0).randint(0, 128, (4, 32)).astype("int64")


def _jax_moe(degrees, dispatch, overrides, rule, level, clip):
    jax, paddle, jdist = _jax()
    import paddle_tpu.nn as jnn
    import paddle_tpu.optimizer as jopt
    from paddle_tpu.models import LlamaForCausalLM as JLlama
    from paddle_tpu.models import LlamaMoEConfig as JConfig

    from paddle_tpu_torch.models import (LlamaMoEConfig,
                                         llama_state_from_numpy)

    _jax_reset(jdist)
    jdist.init_mesh(devices=jax.devices()[:4], **degrees)
    prior = paddle.get_flags(["FLAGS_moe_dispatch",
                              "FLAGS_embedding_oov_policy"])
    paddle.set_flags({"FLAGS_moe_dispatch": dispatch,
                      "FLAGS_embedding_oov_policy": "clip"})
    try:
        paddle.seed(5)
        # Adafactor, Lamb, LARS and the per-tensor clip take statistics per
        # tensor: the JAX stacked layout would take them over [L, ...]; the
        # port's is per layer
        scan = rule not in ("adafactor", "lamb", "lars") and \
            (clip is None or clip[0] == "global")
        m = JLlama(JConfig.tiny(**MOE_CONFIG, **overrides, scan_layers=scan))
        cfg = LlamaMoEConfig.tiny(**MOE_CONFIG, **overrides)

        def state():
            return {k: v.numpy() for k, v in llama_state_from_numpy(
                {k: np.asarray(v.numpy()) for k, v in
                 m.state_dict().items()}, cfg).items()}

        state0 = state()
        params = m.parameters()
        if rule.startswith("momentum"):
            o = jopt.Momentum(
                learning_rate=10.0 if rule == "momentum_lr10" else 0.1,
                momentum=0.9, parameters=params, grad_clip=None if clip is None
                else (jnn.ClipGradByGlobalNorm if clip[0] == "global"
                      else jnn.ClipGradByNorm)(clip[1]))
        else:
            o = {"adamw": lambda: jopt.AdamW(learning_rate=1e-3,
                                             parameters=params),
                 "adafactor": lambda: jopt.Adafactor(learning_rate=1e-2,
                                                     parameters=params),
                 "lamb": lambda: jopt.Lamb(learning_rate=1e-2,
                                           parameters=params),
                 "lars": lambda: jopt.LarsMomentum(learning_rate=0.1,
                                                   parameters=params)}[rule]()
        if level:
            m, o = jdist.group_sharded_parallel(m, o, level=level)
        step = jdist.ShardedTrainStep(m, lambda mm, x, y: mm(x, labels=y), o)
        ids = _ids().astype("int32")
        losses = [float(step(paddle.to_tensor(ids), paddle.to_tensor(ids)))
                  for _ in range(3)]
        final = state()
    finally:
        paddle.set_flags(prior)
        _jax_reset(jdist)
    return state0, {"losses": losses, "state": final}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, JAX results, every rank's results)."""
    inputs, ref = {"moe": {}}, {}
    for key, (degrees, dispatch, overrides, rule, level, clip) in \
            CASES.items():
        state0, ref[key] = _jax_moe(degrees, dispatch, overrides, rule,
                                    level, clip)
        inputs["moe"][key] = dict(
            degrees=degrees, dispatch=dispatch, level=level, clip=clip,
            config=dict(MOE_CONFIG, **overrides), optimizer=rule,
            state=state0, ids=_ids())
    inputs["a2a"] = np.arange(4 * 4 * 2 * 8, dtype=np.float32).reshape(
        4, 4, 2, 8)
    tmp = tmp_path_factory.mktemp("moe")
    outs = W.run(tmp, "moe", inputs)
    return dict(inputs, tmpdir=tmp), ref, outs


def _gathered(runs, key, scenario):
    from paddle_tpu_torch.models import LlamaMoEConfig
    from paddle_tpu_torch.models.convert import gather_llama_state

    inputs, _, outs = runs
    case = inputs["moe"][key]
    got = [outs[r][scenario] for r in range(W.WORLD)]
    states = [{k: torch.from_numpy(v) for k, v in g["state"].items()}
              for g in got]
    deg = {"sdp" if k == "sharding" else k: v
           for k, v in case["degrees"].items()}
    full = gather_llama_state(states, LlamaMoEConfig.tiny(**case["config"]),
                              deg, stage3=case["level"] == "p_g_os")
    return got, {k: v.numpy() for k, v in full.items()}


def _held(runs, key, scenario):
    """Every rank's three losses and the gathered parameters of
    ``scenario`` against the JAX step of case ``key``."""
    ref = runs[1][key]
    got, full = _gathered(runs, key, scenario)
    for r in range(W.WORLD):
        np.testing.assert_allclose(got[r]["losses"], ref["losses"],
                                   rtol=1e-5)
    atol = 2e-4 if CASES[key][0].get("pp", 1) > 1 else 5e-5
    assert set(full) == set(ref["state"])
    for k, v in ref["state"].items():
        np.testing.assert_allclose(full[k], v, atol=atol, err_msg=k)
    return got


@pytest.mark.parametrize("case", list(CASES))
def test_moe_llama_matches_jax_sharded_step(runs, case):
    """The tiny MoE Llama at the case's degrees, dispatch and rule: three
    losses and the parameters gathered over every rank against the JAX
    ``ShardedTrainStep`` (``index`` over a mesh takes the global capacity
    and places; under ep every rank runs its experts' kept rows through
    the grouped GEMM and the partial outputs are summed over ep x mp)."""
    _held(runs, case, f"moe_{case}")


def test_binding_capacity_drops_rows(runs):
    """The ``index`` case's capacity factor (0.5) binds: every rank drops
    some (choice, token) rows, as many as the reference's global rule
    gives it, and still matches the JAX step."""
    outs = runs[2]
    for r in range(W.WORLD):
        got = outs[r]["moe_dp4_index"]
        assert 0 < got["dropped"] < got["rows"]


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_fails_the_moe_check(runs, fault):
    """The check above fails for a step whose capacity and places come
    from each rank's own tokens, whose aux is each rank's own, whose clip
    norm leaves out the ep all-reduce, or that sums over ep the gradients
    of the parameters every ep rank holds whole."""
    with pytest.raises(AssertionError):
        _held(runs, FAULTS[fault], f"planted_{fault}")


def test_global_scatter_gather_contract(runs):
    """``tests/test_distributed.py::test_global_scatter_gather_roundtrip``
    per rank at ep 4: rank r's scatter holds every source's bucket for its
    expert (``out[s] = x[s, r]``), the gather restores its own buckets, a
    count of 1 zeroes capacity slot 1 and keeps slot 0, and the backward
    is the all-to-all back; ``number_count`` counts expert ids."""
    inputs, _, outs = runs
    x = inputs["a2a"]
    w = np.arange(4 * 2 * 8, dtype=np.float32).reshape(4, 2, 8)
    for r in range(W.WORLD):
        got = outs[r]["a2a"]
        for s in range(4):
            np.testing.assert_array_equal(got["scatter"][s], x[s, r])
        np.testing.assert_array_equal(got["gather"], x[r])
        assert not np.array_equal(got["scatter"], x[r])
        assert np.all(got["ragged"][:, 1, :] == 0)
        np.testing.assert_array_equal(got["ragged"][:, 0, :], x[:, r, 0, :])
        # rank r's bucket e went to rank e as its source block r
        np.testing.assert_array_equal(got["grad"], np.stack(
            [w[r] for _ in range(4)]))
        np.testing.assert_array_equal(got["count"], [1, 1, 0, 2])


@pytest.mark.parametrize("where", ["dp4", "pp2_dp2"])
def test_moe_checkpoint_resumes_on_another_mesh(runs, where):
    """Saved at ep 2 x dp 2 after one step (the manifest records each
    expert stack's ep split), loaded at dp 4 and at pp 2 x dp 2 (one
    microbatch): two more steps track the unbroken run's (losses rtol
    1e-5, parameters atol 5e-5)."""
    from paddle_tpu_torch.models import LlamaMoEConfig
    from paddle_tpu_torch.models.convert import gather_llama_state

    inputs, _, outs = runs
    cfg = LlamaMoEConfig.tiny(**inputs["moe"]["ep2_dp2"]["config"])

    def full(where, degrees):
        states = [{k: torch.from_numpy(v) for k, v in
                   outs[r]["checkpoint"][where]["state"].items()}
                  for r in range(W.WORLD)]
        return {k: v.numpy() for k, v in
                gather_llama_state(states, cfg, degrees).items()}

    unbroken = full("unbroken", dict(ep=2, dp=2))
    resumed = full(where, dict(dp=4) if where == "dp4" else dict(pp=2, dp=2))
    for r in range(W.WORLD):
        got = outs[r]["checkpoint"]
        np.testing.assert_allclose(got[where]["losses"],
                                   got["unbroken"]["losses"], rtol=1e-5)
        assert got[where]["global_step"] == got["unbroken"]["global_step"]
    for k, v in unbroken.items():
        np.testing.assert_allclose(resumed[k], v, atol=5e-5, err_msg=k)
