"""The port's distributed stack (``paddle_tpu_torch.distributed``) against the
JAX package and numpy.

One gloo world of 4 spawned CPU processes per module (``torch_dist_worker``,
joined through a file store under ``tmp_path``, so no port is shared
between test workers) runs every scenario and returns its numbers; the JAX
oracle runs here, on ``jax.devices()[:4]``, from the same seeded weights
carried across in torch's layout (``models/convert.py``). What must agree
is the global result: the losses and the parameters once gathered.

Tolerances: collectives exact (small integers in fp32); the fp32 steps
``rtol 2e-4`` on losses and ``atol 1e-5`` on parameters (the reductions
add in another order than XLA's), the tiny Llama ``rtol 1e-5`` on losses
and ``atol 5e-5`` on parameters (three AdamW steps at lr 1e-3 move each
by ~3e-3; an ulp-level gradient difference moves it by far less).
"""
import numpy as np
import pytest
import torch

import torch_dist_worker as W

pytestmark = pytest.mark.dist

LLAMA_CONFIG = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
                    num_attention_heads=4, num_key_value_heads=2,
                    vocab_size=128)
# the global-norm clip of the Momentum cases: the tiny Llama's gradient
# norm reads 2.42, 2.20 and 2.01 over their three steps, so the clip binds
# at each, while a half or a quarter of it (gradients averaged over 2 or 4
# data ranks where they must be summed) would not
CLIP = 1.5
# (degrees, config overrides, ZeRO level, clip: None for AdamW)
LLAMA_CASES = {
    "dp2_mp2": (dict(dp=2, mp=2), {}, None, None),
    "cp2_dp2_ring": (dict(cp=2, dp=2), {}, None, None),
    "cp2_dp2_ulysses": (dict(cp=2, dp=2), {"cp_impl": "ulysses"}, None, None),
    "sdp4": (dict(sharding=4), {}, "p_g_os", None),
    "dp2_mp2_clip": (dict(dp=2, mp=2), {}, None, CLIP),
    "cp2_dp2_ring_clip": (dict(cp=2, dp=2), {}, None, CLIP),
    "sdp4_os_g_clip": (dict(sharding=4), {}, "os_g", CLIP),
    "sdp4_p_g_os_clip": (dict(sharding=4), {}, "p_g_os", CLIP),
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
    """JAX [in, out] Linear weights -> torch [out, in]."""
    return {k: (np.asarray(v).T if k in linears else np.asarray(v))
            .astype(np.float32).copy() for k, v in state.items()}


def _jax_tp_mlp():
    jax, paddle, jdist = _jax()
    import paddle_tpu.nn as nn
    import paddle_tpu.nn.functional as JF
    import paddle_tpu.optimizer as jopt
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
                                  o)
    x = np.random.RandomState(0).rand(8, 8).astype("float32")
    y = np.random.RandomState(1).rand(8, 8).astype("float32")
    losses = [float(step(paddle.to_tensor(x), paddle.to_tensor(y)))
              for _ in range(4)]
    final = _torch_layout({k: v.numpy() for k, v in
                           net.state_dict().items()}, linears)
    _jax_reset(jdist)
    return {"state": state0, "batch": (x, y)}, {"losses": losses,
                                                "state": final}


def _jax_zero(level):
    jax, paddle, jdist = _jax()
    import paddle_tpu.nn as nn
    import paddle_tpu.nn.functional as JF
    import paddle_tpu.optimizer as jopt

    paddle.seed(11)
    _jax_reset(jdist)
    jdist.init_mesh(sharding=4, devices=jax.devices()[:4])
    net = nn.Sequential(nn.Linear(16, 32), nn.Tanh(), nn.Linear(32, 16))
    linears = {"0.weight", "2.weight"}
    state0 = _torch_layout({k: v.numpy() for k, v in
                            net.state_dict().items()}, linears)
    o = jopt.AdamW(learning_rate=0.02, parameters=net.parameters())
    net, o = jdist.group_sharded_parallel(net, o, level=level)
    step = jdist.ShardedTrainStep(net, lambda m, x, y: JF.mse_loss(m(x), y),
                                  o)
    x = np.random.RandomState(2).rand(8, 16).astype("float32")
    y = np.random.RandomState(3).rand(8, 16).astype("float32")
    losses = [float(step(paddle.to_tensor(x), paddle.to_tensor(y)))
              for _ in range(4)]
    final = _torch_layout({k: v.numpy() for k, v in
                           net.state_dict().items()}, linears)
    _jax_reset(jdist)
    return {"state": state0, "batch": (x, y)}, {"losses": losses,
                                                "state": final}


def _jax_llama(degrees, overrides, level, clip):
    jax, paddle, jdist = _jax()
    import paddle_tpu.nn as jnn
    import paddle_tpu.optimizer as jopt
    from paddle_tpu.models import LlamaConfig as JConfig
    from paddle_tpu.models import LlamaForCausalLM as JLlama

    from paddle_tpu_torch.models import LlamaConfig, llama_state_from_numpy

    _jax_reset(jdist)
    jdist.init_mesh(devices=jax.devices()[:4], **degrees)
    paddle.seed(5)
    jcfg = JConfig.tiny(**LLAMA_CONFIG, **overrides)
    m = JLlama(jcfg)
    cfg = LlamaConfig.tiny(**LLAMA_CONFIG, **overrides)

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
    if level:
        m, o = jdist.group_sharded_parallel(m, o, level=level)
    step = jdist.ShardedTrainStep(m, lambda mm, x, y: mm(x, labels=y), o)
    ids = np.random.RandomState(0).randint(0, 128, (4, 32)).astype("int64")
    losses = [float(step(paddle.to_tensor(ids.astype("int32")),
                         paddle.to_tensor(ids.astype("int32"))))
              for _ in range(3)]
    final = state()
    _jax_reset(jdist)
    return {"state": state0, "ids": ids}, {"losses": losses, "state": final}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, JAX results, every rank's results)."""
    inputs, ref = {}, {}
    inputs["tp_mlp"], ref["tp_mlp"] = _jax_tp_mlp()
    inputs["zero"] = None
    for level in ("os", "os_g", "p_g_os"):
        inputs["zero"], ref[f"zero_{level}"] = _jax_zero(level)
    rng = np.random.RandomState(7)
    inputs["vocab"] = {"weight": rng.randn(64, 16).astype(np.float32),
                       "ids": np.array([[1, 5, 63], [0, 2, 8]], np.int64),
                       "cot": rng.randn(2, 3, 16).astype(np.float32)}
    dp_net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                                 torch.nn.Linear(16, 4))
    inputs["dp"] = {"state": {k: v.detach().numpy().copy() for k, v in
                              dp_net.state_dict().items()},
                    "batch": (rng.randn(16, 8).astype(np.float32),
                              rng.randn(16, 4).astype(np.float32))}
    inputs["pce"] = {"logits": rng.randn(2, 3, 64).astype(np.float32),
                     "labels": np.array([[1, 17, -100], [63, 40, 0]]),
                     "cot": rng.randn(2, 3).astype(np.float32)}
    inputs["llama"] = {}
    for key, (degrees, overrides, level, clip) in LLAMA_CASES.items():
        case, ref[f"llama_{key}"] = _jax_llama(degrees, overrides, level,
                                               clip)
        case.update(degrees=degrees, config=dict(LLAMA_CONFIG, **overrides),
                    level=level, clip=clip)
        inputs["llama"][key] = case
    tmp = tmp_path_factory.mktemp("dist")
    outs = W.run(tmp, "distributed", inputs)
    return dict(inputs, tmpdir=tmp), ref, outs


# -- collectives against numpy ---------------------------------------------------

def _bases():
    return [np.arange(6, dtype=np.float32) + 10 * r for r in range(W.WORLD)]


def _collective_expected(name, r):
    b = _bases()
    plus = [x + 1 for x in b]
    return {
        "all_reduce_sum": sum(plus), "all_reduce_max": plus[-1],
        "all_reduce_min": plus[0], "all_reduce_prod": np.prod(plus, axis=0),
        "all_reduce_avg": sum(plus) / W.WORLD,
        "all_gather": np.stack(b), "broadcast": b[2],
        "reduce": sum(b) if r == 1 else None,  # undefined off the root
        "reduce_scatter": sum(x + r for x in b),
        "alltoall": np.stack([b[i] + 100 * r for i in range(W.WORLD)]),
        "scatter": b[3] + 1000 * r,
        "send_recv": b[r + 1 if r % 2 == 0 else r - 1],
        "isend_irecv": b[(r - 1) % W.WORLD],
    }[name]


@pytest.mark.parametrize("name", [
    "all_reduce_sum", "all_reduce_max", "all_reduce_min", "all_reduce_prod",
    "all_reduce_avg", "all_gather", "broadcast", "reduce", "reduce_scatter",
    "alltoall", "scatter", "send_recv", "isend_irecv"])
def test_collective_matches_numpy(runs, name):
    outs = runs[2]
    for r in range(W.WORLD):
        want = _collective_expected(name, r)
        if want is not None:
            np.testing.assert_array_equal(outs[r]["collectives"][name], want)


def _helper_expected(name, r):
    """(forward, gradient) of the differentiable axis helpers, by hand."""
    xs = [(_bases()[i][:4] + 1).reshape(2, 2) for i in range(W.WORLD)]

    def weights(shape):
        return np.arange(np.prod(shape), dtype=np.float32).reshape(shape)

    w = weights((2, 2))
    if name in ("psum", "pmean"):
        f = sum(xs) / (W.WORLD if name == "pmean" else 1)
        # every rank's cotangent w flows back to every x, summed
        g = W.WORLD * w / (W.WORLD if name == "pmean" else 1)
        return f, g
    if name == "ppermute":  # i -> i + 1 for i < 3: rank 0 gets zeros
        f = xs[r - 1] if r > 0 else np.zeros((2, 2), np.float32)
        g = w if r < W.WORLD - 1 else np.zeros((2, 2), np.float32)
        return f, g
    if name == "all_to_all":  # [2, 4] split on dim 1, concat on dim 0
        f = np.concatenate([np.tile(xs[i], (1, 2))[:, r:r + 1]
                            for i in range(W.WORLD)], axis=0)
        wf = weights((8, 1))
        g = np.zeros((2, 4), np.float32)
        for j in range(W.WORLD):  # rank j's rows 2r:2r+2 came from my col j
            g[:, j] = wf[2 * r:2 * r + 2, 0]
        return f, g[:, :2] + g[:, 2:]
    if name == "all_gather":
        f = np.concatenate(xs, axis=1)
        return f, W.WORLD * weights((2, 8))[:, 2 * r:2 * r + 2]
    if name == "reduce_scatter":  # every rank's cotangent gathered back
        f = sum(np.tile(x, (2, 1)) for x in xs)[r:r + 1]
        g = np.tile(weights((1, 2)), (4, 1))
        return f, g[:2] + g[2:]
    raise KeyError(name)


@pytest.mark.parametrize("name", ["psum", "pmean", "ppermute", "all_to_all",
                                  "all_gather", "reduce_scatter"])
def test_axis_helper_and_its_transpose(runs, name):
    outs = runs[2]
    for r in range(W.WORLD):
        f, g = _helper_expected(name, r)
        np.testing.assert_allclose(outs[r]["collectives"][f"{name}_fwd"], f)
        np.testing.assert_allclose(outs[r]["collectives"][f"{name}_grad"], g)
        assert outs[r]["collectives"]["axis_index"] == r


# -- the mesh and fleet ---------------------------------------------------------------

def test_mesh_degrees_check_and_coordinates(runs):
    outs = runs[2]
    for r in range(W.WORLD):
        got = outs[r]["mesh_and_fleet"]
        assert "product of axis degrees" in got["degree_check"]
        nranks, mp, dp_rank, mp_rank, mp_ranks, dp_ranks = got["mesh"]
        assert (nranks, mp, dp_rank, mp_rank) == (4, 2, r // 2, r % 2)
        assert mp_ranks == [2 * (r // 2), 2 * (r // 2) + 1]
        assert dp_ranks == [r % 2, r % 2 + 2]


def test_fleet_init_and_topology(runs):
    outs = runs[2]
    for r in range(W.WORLD):
        (dp, mp, grank, dp_rank, mp_rank, mp_ranks, dp_ranks, mode, widx,
         wnum, comm) = outs[r]["mesh_and_fleet"]["fleet"]
        assert (dp, mp) == (2, 2)  # dp filled from the world size
        assert (grank, dp_rank, mp_rank, widx, wnum) == (r, r // 2, r % 2,
                                                         r, 4)
        assert mp_ranks == [2 * (r // 2), 2 * (r // 2) + 1]
        assert dp_ranks == [r % 2, r % 2 + 2]
        assert mode == 1  # TENSOR_PARALLEL
        assert comm == [[0, 1], [2, 3]]


# -- steps against the JAX ShardedTrainStep --------------------------------------------

def _held(got, ref, loss_rtol, atol):
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=loss_rtol)
    assert set(got["state"]) == set(ref["state"])
    for k, v in ref["state"].items():
        np.testing.assert_allclose(got["state"][k], v, atol=atol, err_msg=k)


def test_tp_mlp_dp2_mp2_matches_jax(runs):
    """The JAX ``test_tp_sharded_step_matches_eager`` net at dp 2 x mp 2
    (Adam lr 0.05, four steps)."""
    _, ref, outs = runs
    for r in range(W.WORLD):
        _held(outs[r]["tp_mlp"], ref["tp_mlp"], 2e-4, 1e-5)


@pytest.mark.parametrize("level", ["os", "os_g", "p_g_os"])
def test_zero_sdp4_matches_jax(runs, level):
    """ZeRO at sdp 4 (AdamW lr 0.02, four steps), and each rank's moments
    a quarter of the split tensors (the biases of 16 and 32 split too)."""
    _, ref, outs = runs
    for r in range(W.WORLD):
        _held(outs[r][f"zero_{level}"], ref[f"zero_{level}"], 2e-4, 1e-5)
        sizes = outs[r][f"zero_{level}"]["moments"]
        assert sizes == sorted(2 * [n // 4 for n in (512, 32, 512, 16)])


@pytest.mark.parametrize("level", ["os", "os_g", "p_g_os"])
def test_group_sharded_parallel_leaves_the_callers_optimizer(runs, level):
    """``group_sharded_parallel`` returns a new optimizer over the shards:
    the one given keeps its parameters and no state, and neither has its
    clip replaced by the step's."""
    outs = runs[2]
    for r in range(W.WORLD):
        assert outs[r][f"zero_{level}"]["given_untouched"]


@pytest.mark.parametrize("level", ["os", "os_g", "p_g_os"])
def test_save_group_sharded_model_writes_the_gathered_state(runs, level):
    """Rank 0's ``.pdparams`` holds the full parameters, equal to the
    gathered state (and so to the JAX step's)."""
    inputs, ref, outs = runs
    saved = torch.load(inputs["tmpdir"] / f"{level}.pdparams")
    assert set(saved) == set(ref[f"zero_{level}"]["state"])
    for k, v in saved.items():
        np.testing.assert_array_equal(v.numpy(),
                                      outs[0][f"zero_{level}"]["state"][k])


def test_place_model_makes_replicas_equal(runs):
    """dp 2 x mp 2, every rank starting from its own weights: the ranks of
    one mp index hold the same shards after ``place_model`` (rank 0's and
    rank 1's), the two mp indices different ones."""
    outs = runs[2]
    got = [outs[r]["placement_and_rng"]["state"] for r in range(W.WORLD)]
    for k in got[0]:
        np.testing.assert_array_equal(got[0][k], got[2][k])
        np.testing.assert_array_equal(got[1][k], got[3][k])
    assert not np.array_equal(got[0]["up.weight"], got[1]["up.weight"])
    np.testing.assert_array_equal(got[0]["down.bias"], got[1]["down.bias"])


def test_rng_tracker_streams(runs):
    """``global_seed`` draws the same on every rank, ``model_parallel_rng``
    the same within an mp index and differently across them, ``local_seed``
    differently on every rank; outside the tracker the default stream
    continues from ``seed`` on every rank alike."""
    outs = runs[2]
    d = [outs[r]["placement_and_rng"]["draws"] for r in range(W.WORLD)]
    for r in range(1, W.WORLD):
        np.testing.assert_array_equal(d[r]["global_seed"], d[0]["global_seed"])
        np.testing.assert_array_equal(outs[r]["placement_and_rng"]["outside"],
                                      outs[0]["placement_and_rng"]["outside"])
    np.testing.assert_array_equal(d[0]["model_parallel_rng"],
                                  d[2]["model_parallel_rng"])
    assert not np.array_equal(d[0]["model_parallel_rng"],
                              d[1]["model_parallel_rng"])
    locals_ = {d[r]["local_seed"].tobytes() for r in range(W.WORLD)}
    assert len(locals_) == W.WORLD


def test_vocab_parallel_embedding_mp4(runs):
    inputs, _, outs = runs
    v = inputs["vocab"]
    full_grad = np.zeros_like(v["weight"])
    np.add.at(full_grad, v["ids"].reshape(-1), v["cot"].reshape(-1, 16))
    for r in range(W.WORLD):
        np.testing.assert_allclose(outs[r]["vocab_embedding"]["out"],
                                   v["weight"][v["ids"]], rtol=0, atol=0)
        np.testing.assert_allclose(outs[r]["vocab_embedding"]["grad"],
                                   full_grad[16 * r:16 * (r + 1)],
                                   rtol=1e-6, atol=1e-6)


def test_data_parallel_dp4_matches_one_process(runs):
    """Each rank's quarter of the batch; the averaged gradients equal the
    full batch's in one process; ``no_sync`` keeps them local and the
    next backward reduces the sum (rtol 1e-5: fp32, another sum order)."""
    inputs, _, outs = runs
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                              torch.nn.Linear(16, 4))
    net.load_state_dict({k: torch.from_numpy(a)
                         for k, a in inputs["dp"]["state"].items()})
    x, y = (torch.from_numpy(a) for a in inputs["dp"]["batch"])
    torch.nn.functional.mse_loss(net(x), y).backward()
    full = {k: p.grad.numpy() for k, p in net.named_parameters()}
    local = []
    for r in range(W.WORLD):
        net.zero_grad()
        torch.nn.functional.mse_loss(net(x.chunk(4)[r]),
                                     y.chunk(4)[r]).backward()
        local.append({k: p.grad.numpy().copy()
                      for k, p in net.named_parameters()})
    for r in range(W.WORLD):
        got = outs[r]["data_parallel"]
        for k in full:
            np.testing.assert_allclose(got["synced"][k], full[k], rtol=1e-5,
                                       atol=1e-7)
            np.testing.assert_allclose(got["unsynced"][k], local[r][k],
                                       rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(got["accumulated"][k], 2 * full[k],
                                       rtol=1e-5, atol=1e-7)


def _llama_held(runs, case, scenario):
    """Every rank's three losses and the parameters gathered over the
    ranks of ``scenario`` against the JAX step of ``case``."""
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.models.convert import gather_llama_state

    inputs, ref, outs = runs
    degrees, _, level, _ = LLAMA_CASES[case]
    got = [outs[r][scenario] for r in range(W.WORLD)]
    states = [{k: torch.from_numpy(v) for k, v in g["state"].items()}
              for g in got]
    deg = {"sdp" if k == "sharding" else k: v for k, v in degrees.items()}
    cfg = LlamaConfig.tiny(**inputs["llama"][case]["config"])
    full = {k: v.numpy() for k, v in gather_llama_state(
        states, cfg, deg, stage3=level == "p_g_os").items()}
    for r in range(W.WORLD):
        np.testing.assert_allclose(got[r]["losses"],
                                   ref[f"llama_{case}"]["losses"], rtol=1e-5)
        assert got[r]["shards_match"] in ((None,) if level is None
                                          else (True,))
    _held({"losses": got[0]["losses"], "state": full},
          ref[f"llama_{case}"], 1e-5, 5e-5)


@pytest.mark.parametrize("case", list(LLAMA_CASES))
def test_tiny_llama_matches_jax_sharded_step(runs, case):
    """The tiny Llama (2 layers, hidden 64, 4 heads, 2 KV heads, vocab 128,
    batch 4 x 32; AdamW lr 1e-3, or for the ``_clip`` cases Momentum lr 0.1
    under ``ClipGradByGlobalNorm(CLIP)``): three losses, and the
    parameters gathered over every rank, against the JAX
    ``ShardedTrainStep`` at the same degrees."""
    _llama_held(runs, case, f"llama_{case}")


@pytest.mark.parametrize("fault", ["gradients_averaged", "norm_without_mp"])
def test_planted_fault_fails_the_llama_check(runs, fault):
    """The check above at dp 2 x mp 2 with the clip fails for a step that
    averages the gradients over the data ranks where the Llama's share
    loss needs their sum, and for one whose clip norm leaves out the mp
    all-reduce (``torch_dist_worker.PLANTED``)."""
    with pytest.raises(AssertionError):
        _llama_held(runs, "dp2_mp2_clip", f"planted_{fault}")


def test_tied_llama_dp2_mp2_matches_one_process(runs):
    """The tied head stays tied and correct under mp (the JAX tie is broken:
    the oracle is the port's TrainStep on the whole batch in one process;
    rtol 1e-5 on losses, atol 5e-5 on parameters)."""
    outs = runs[2]
    for r in range(W.WORLD):
        got = outs[r]["llama_tied"]
        assert got["tied"]
        _held({"losses": got["losses"], "state": got["state"]},
              {"losses": got["ref_losses"], "state": got["ref_state"]},
              1e-5, 5e-5)


def test_tied_llama_zero3_sdp4_matches_one_process(runs):
    """ZeRO-3 over the tied head at sdp 4: the embedding and the head hold
    one shard (one optimizer tensor), gathered once in the forward (its
    gradient reduce-scattered once), and the step matches the port's
    TrainStep in one process (rtol 1e-5 on losses, atol 5e-5 on
    parameters; the JAX tie is broken)."""
    outs = runs[2]
    for r in range(W.WORLD):
        got = outs[r]["llama_tied_sdp4"]
        assert got["tied"] and got["shards"] == 1 and got["gathers"] == 1
        state = {k: v for k, v in got["state"].items()}
        state.setdefault("lm_head.weight", state["llama.embed_tokens.weight"])
        ref = dict(got["ref_state"])
        ref.setdefault("lm_head.weight", ref["llama.embed_tokens.weight"])
        _held({"losses": got["losses"], "state": state},
              {"losses": got["ref_losses"], "state": ref}, 1e-5, 5e-5)


def test_parallel_cross_entropy_mp4(runs):
    """Per-row CE over mp-split logits (ignored label: 0) and each rank's
    columns of the gradient against torch's CE on the whole vocabulary
    (fp32, rtol 1e-5)."""
    inputs, _, outs = runs
    c = inputs["pce"]
    x = torch.from_numpy(c["logits"]).requires_grad_(True)
    loss = torch.nn.functional.cross_entropy(
        x.reshape(-1, 64), torch.from_numpy(c["labels"]).reshape(-1),
        reduction="none", ignore_index=-100).reshape(2, 3)
    (loss * torch.from_numpy(c["cot"])).sum().backward()
    for r in range(W.WORLD):
        got = outs[r]["parallel_cross_entropy"]
        np.testing.assert_allclose(got["loss"], loss.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["grad"],
                                   x.grad.numpy()[..., 16 * r:16 * (r + 1)],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("option", ["pp_with_cp"])
def test_deferred_option_raises(runs, option):
    """pp x cp stays refused: the JAX reference fails there itself (its
    pipeline's ``shard_map`` mesh error), so the message names that and
    the oracle caveat."""
    got = runs[2][0]["deferred"][option]
    assert got.startswith("NotImplementedError"), got
    assert "should match the mesh passed to shard_map" in got
    assert "ROADMAP Queue 3" in got
