"""What each rank of a 4-process gloo world runs for the port's distributed
tests (``test_torch_distributed.py``, ``test_torch_context_parallel.py``).

Spawned through ``paddle_tpu_torch.distributed.spawn``: each rank joins
the group through a file store, reads the parent's inputs
(``inputs.pkl``), runs every scenario of its suite in order and writes
its results to ``out<rank>.pkl``. Imports neither jax nor the JAX
package: the parent holds the results against it.
"""
from __future__ import annotations

import datetime
import os
import pickle
import sys

import numpy as np
import torch
import torch.nn.functional as F

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.meta_parallel import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)

WORLD = 4
# the MoE faults planted on the card too (tools/moe_mesh_ranks.py)
sys.path.append(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from moe_mesh_ranks import Planted  # noqa: E402


def _np(t):
    return t.detach().float().numpy().copy()


# -- collectives --------------------------------------------------------------

def collectives(inp):
    r = dist.get_rank()
    base = torch.arange(6, dtype=torch.float32) + 10 * r
    out = {}
    for op in ("sum", "max", "min", "prod", "avg"):
        t = base.clone() + 1
        dist.all_reduce(t, op=op)
        out[f"all_reduce_{op}"] = _np(t)
    lst = []
    dist.all_gather(lst, base)
    out["all_gather"] = np.stack([_np(t) for t in lst])
    t = base.clone()
    dist.broadcast(t, src=2)
    out["broadcast"] = _np(t)
    t = base.clone()
    dist.reduce(t, dst=1)
    out["reduce"] = _np(t)
    t = torch.empty(6)
    dist.reduce_scatter(t, [base + j for j in range(WORLD)])
    out["reduce_scatter"] = _np(t)
    got = []
    dist.alltoall([base + 100 * j for j in range(WORLD)], got)
    out["alltoall"] = np.stack([_np(t) for t in got])
    t = torch.empty(6)
    dist.scatter(t, [base + 1000 * j for j in range(WORLD)]
                 if r == 3 else None, src=3)
    out["scatter"] = _np(t)
    t = torch.empty(6)
    if r % 2 == 0:
        dist.send(base, dst=r + 1)
        dist.recv(t, src=r + 1)
    else:
        dist.recv(t, src=r - 1)
        dist.send(base, dst=r - 1)
    out["send_recv"] = _np(t)
    t = torch.empty(6)
    task = dist.irecv(t, src=(r - 1) % WORLD)
    dist.isend(base, dst=(r + 1) % WORLD).wait()
    task.wait()
    out["isend_irecv"] = _np(t)
    dist.barrier()
    # the differentiable axis helpers over dp = 4
    dist.init_mesh(dp=WORLD)
    x = (base[:4] + 1).reshape(2, 2).requires_grad_(True)
    helpers = {
        "psum": lambda t: dist.psum(t, "dp"),
        "pmean": lambda t: dist.pmean(t, "dp"),
        "ppermute": lambda t: dist.ppermute(
            t, "dp", [(i, (i + 1) % WORLD) for i in range(WORLD - 1)]),
        "all_to_all": lambda t: dist.all_to_all_axis(
            t.repeat(1, 2), "dp", 1, 0),
        "all_gather": lambda t: dist.all_gather_axis(t, "dp", 1),
        "reduce_scatter": lambda t: dist.reduce_scatter_axis(
            t.repeat(2, 1), "dp", 0),
    }
    for name, fn in helpers.items():
        x.grad = None
        y = fn(x)
        (y * torch.arange(y.numel(), dtype=torch.float32)
         .reshape(y.shape)).sum().backward()
        out[f"{name}_fwd"] = _np(y)
        out[f"{name}_grad"] = _np(x.grad)
    out["axis_index"] = dist.axis_index("dp")
    return out


# -- the mesh and fleet --------------------------------------------------------

def mesh_and_fleet(inp):
    out = {}
    try:
        dist.init_mesh(dp=3, mp=2)
        out["degree_check"] = "no error"
    except ValueError as e:
        out["degree_check"] = str(e)
    env = dist.init_mesh(dp=2, mp=2)
    out["mesh"] = (env.nranks, env.get_dim("mp"), env.coord("dp"),
                   env.coord("mp"),
                   dist.new_group(axis="mp").ranks,
                   dist.new_group(axis="dp").ranks)
    dist.reset_mesh()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 2,
                               "pp_degree": 1, "sharding_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    out["fleet"] = (
        hcg.get_data_parallel_world_size(), hcg.get_model_parallel_world_size(),
        hcg.get_global_rank(), hcg.get_data_parallel_rank(),
        hcg.get_model_parallel_rank(), hcg.get_model_parallel_group().ranks,
        hcg.get_data_parallel_group().ranks, hcg.get_parallel_mode(),
        fleet.worker_index(), fleet.worker_num(),
        hcg.topology().get_comm_list("model"))
    fleet.base._STATE.__init__()
    return out


# -- layers and steps against the JAX package ----------------------------------

class _TPMLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.up = ColumnParallelLinear(8, 16, gather_output=False)
        self.down = RowParallelLinear(16, 8, input_is_parallel=True)

    def forward(self, x):
        return self.down(F.gelu(self.up(x)))


def _load(model, full, env):
    """Loads this rank's tensor-parallel slices of ``full`` (torch layout)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            t = torch.from_numpy(full[name])
            if getattr(p, "mp_dim", None) is not None:
                t = t.chunk(env.get_dim("mp"), dim=p.mp_dim)[env.coord("mp")]
            p.copy_(t)


def _mse(m, x, y):
    return F.mse_loss(m(x), y)


def tp_mlp(inp):
    env = dist.init_mesh(dp=2, mp=2)
    net = _TPMLP()
    _load(net, inp["tp_mlp"]["state"], env)
    o = popt.Adam(learning_rate=0.05, parameters=net.parameters())
    step = dist.ShardedTrainStep(net, _mse, o)
    x, y = (torch.from_numpy(a) for a in inp["tp_mlp"]["batch"])
    losses = [float(step(x, y)) for _ in range(4)]
    return {"losses": losses,
            "state": {k: _np(v) for k, v in
                      dist.sharding.gather_full_state(net).items()}}


def zero(inp, level):
    dist.init_mesh(sharding=WORLD)
    net = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.Tanh(),
                              torch.nn.Linear(32, 16))
    net.load_state_dict({k: torch.from_numpy(v)
                         for k, v in inp["zero"]["state"].items()})
    given = popt.AdamW(learning_rate=0.02, parameters=net.parameters())
    params = list(given._parameter_list)
    net, o = dist.group_sharded_parallel(net, given, level=level)
    step = dist.ShardedTrainStep(net, _mse, o)
    x, y = (torch.from_numpy(a) for a in inp["zero"]["batch"])
    losses = [float(step(x, y)) for _ in range(4)]
    # the optimizer given keeps its parameters, no state and its own clip
    untouched = (o is not given and len(given._parameter_list) == len(params)
                 and all(a is b for a, b in zip(given._parameter_list, params))
                 and not given._state and "_clip" not in vars(given)
                 and "_clip" not in vars(o))
    state = {k: _np(v) for k, v in
             dist.sharding.gather_full_state(net).items()}
    moment_sizes = sorted(v.numel() for s in o._state.values()
                          for v in s.values())
    dist.save_group_sharded_model(net, os.path.join(inp["tmpdir"], level))
    return {"losses": losses, "state": state, "moments": moment_sizes,
            "given_untouched": untouched}


def placement_and_rng(inp):
    """``place_model`` makes the replicas of each shard equal (ranks start
    from different weights); the RNG tracker's streams: ``global_seed``
    the same everywhere, ``model_parallel_rng`` one per mp rank."""
    from paddle_tpu_torch.distributed.meta_parallel import (
        get_rng_state_tracker, model_parallel_random_seed)

    dist.init_mesh(dp=2, mp=2)
    torch.manual_seed(100 + dist.get_rank())
    net = _TPMLP()
    dist.place_model(net)
    model_parallel_random_seed(7, device="cpu")
    tracker = get_rng_state_tracker()
    draws = {}
    for name in ("global_seed", "model_parallel_rng", "local_seed"):
        with tracker.rng_state(name):
            draws[name] = _np(torch.rand(4))
    outside = _np(torch.rand(4))
    return {"state": {k: _np(v) for k, v in net.state_dict().items()},
            "draws": draws, "outside": outside}


def vocab_embedding(inp):
    env = dist.init_mesh(mp=WORLD)
    emb = VocabParallelEmbedding(64, 16)
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(inp["vocab"]["weight"]).chunk(
            WORLD)[env.coord("mp")])
    ids = torch.from_numpy(inp["vocab"]["ids"])
    out = emb(ids)
    (out * torch.from_numpy(inp["vocab"]["cot"])).sum().backward()
    return {"out": _np(out), "grad": _np(emb.weight.grad)}


def data_parallel(inp):
    dist.init_mesh(dp=WORLD)
    r = dist.get_rank()
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                              torch.nn.Linear(16, 4))
    net.load_state_dict({k: torch.from_numpy(v)
                         for k, v in inp["dp"]["state"].items()})
    model = dist.DataParallel(net, comm_buffer_size=1e-4)  # several buckets
    x, y = (torch.from_numpy(a) for a in inp["dp"]["batch"])
    xs, ys = x.chunk(WORLD)[r], y.chunk(WORLD)[r]
    F.mse_loss(model(xs), ys).backward()
    synced = {k: _np(p.grad) for k, p in net.named_parameters()}
    for p in net.parameters():
        p.grad = None
    with model.no_sync():
        F.mse_loss(model(xs), ys).backward()
    unsynced = {k: _np(p.grad) for k, p in net.named_parameters()}
    F.mse_loss(model(xs), ys).backward()  # reduces the sum of both
    accumulated = {k: _np(p.grad) for k, p in net.named_parameters()}
    return {"synced": synced, "unsynced": unsynced,
            "accumulated": accumulated}


def _llama_optimizer(case, params):
    """AdamW lr 1e-3, or with ``clip`` Momentum lr 0.1 (0.9) under a
    global-norm clip at ``clip``: its update follows the gradient's scale
    where the clip does not bind and the clip's norm where it does."""
    if case.get("clip") is None:
        return popt.AdamW(learning_rate=1e-3, parameters=params)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    return popt.Momentum(learning_rate=0.1, momentum=0.9, parameters=params,
                         grad_clip=ClipGradByGlobalNorm(case["clip"]))


class _GradientsAveraged(dist.ShardedTrainStep):
    """A planted fault: the gradients averaged over the data ranks where
    the Llama's loss (each rank's share) needs their sum."""

    def _reduce(self, raw):
        return [None if g is None else g / self._n_data
                for g in super()._reduce(raw)]


class _NormWithoutMp(dist.ShardedTrainStep):
    """A planted fault: the clip's norm without the mp all-reduce, each
    rank counting only its own tensor-parallel shards."""

    def _split_masks(self, params):
        masks = super()._split_masks(params).clone()
        masks[1] = 0
        return masks


PLANTED = {"gradients_averaged": _GradientsAveraged,
           "norm_without_mp": _NormWithoutMp}


def llama(inp, key, step_cls=dist.ShardedTrainStep):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.convert import shard_llama_state

    case = inp["llama"][key]
    env = dist.init_mesh(**case["degrees"])
    cfg = LlamaConfig.tiny(**case["config"])
    model = LlamaForCausalLM(cfg, device="cpu")
    full = {k: torch.from_numpy(v) for k, v in case["state"].items()}
    model.load_state_dict(shard_llama_state(full, env))
    o = _llama_optimizer(case, model.parameters())
    shards_match = None
    if case.get("level"):
        model, o = dist.group_sharded_parallel(model, o, level=case["level"])
        # the converter's ZeRO-3 slices are the parametrized model's state
        want = shard_llama_state(full, env, stage3=case["level"] == "p_g_os")
        have = model.state_dict()
        shards_match = set(want) == set(have) and all(
            torch.equal(want[k], have[k]) for k in want)
    step = step_cls(model, lambda m, x, y: m(x, labels=y), o)
    ids = torch.from_numpy(case["ids"])
    losses = [float(step(ids, ids)) for _ in range(3)]
    return {"losses": losses, "shards_match": shards_match,
            "state": {k: _np(v) for k, v in model.state_dict().items()}}


def llama_tied(inp):
    """The tied head at dp 2 x mp 2 (the vocabulary-split embedding is the
    head's weight) against the same model in one process: the JAX tie is
    broken, so the oracle is the port's own TrainStep on the whole batch."""
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.convert import shard_llama_state

    cfg = LlamaConfig.tiny(**inp["llama"]["dp2_mp2"]["config"],
                           tie_word_embeddings=True)
    ids = torch.from_numpy(inp["llama"]["dp2_mp2"]["ids"])
    model = LlamaForCausalLM(cfg, device="cpu", generator=seed(1, "cpu"))
    full = {k: v.clone() for k, v in model.state_dict().items()}
    o = popt.AdamW(learning_rate=1e-3, parameters=model.parameters())
    step = TrainStep(model, lambda m, x, y: m(x, labels=y), o)
    ref = [float(step(ids, ids)) for _ in range(3)]
    ref_state = {k: _np(v) for k, v in model.state_dict().items()}
    env = dist.init_mesh(dp=2, mp=2)
    model = LlamaForCausalLM(cfg, device="cpu", generator=seed(1, "cpu"))
    model.load_state_dict(shard_llama_state(full, env))
    tied = model.lm_head.weight is model.llama.embed_tokens.weight
    o = popt.AdamW(learning_rate=1e-3, parameters=model.parameters())
    step = dist.ShardedTrainStep(model, lambda m, x, y: m(x, labels=y), o)
    losses = [float(step(ids, ids)) for _ in range(3)]
    state = {k: _np(v) for k, v in
             dist.sharding.gather_full_state(model).items()}
    return {"losses": losses, "ref_losses": ref, "state": state,
            "ref_state": ref_state, "tied": tied}


def llama_tied_sdp4(inp):
    """The tied head under ZeRO-3 at sdp 4 (one shard of the one tensor,
    registered on the embedding and the head) against the same model in
    one process: the JAX tie is broken, so the oracle is the port's
    TrainStep on the whole batch. Also the all-gathers of the tied shard
    in the third step's forward."""
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.distributed import sharding
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(**inp["llama"]["dp2_mp2"]["config"],
                           tie_word_embeddings=True)
    ids = torch.from_numpy(inp["llama"]["dp2_mp2"]["ids"])
    model = LlamaForCausalLM(cfg, device="cpu", generator=seed(1, "cpu"))
    o = popt.AdamW(learning_rate=1e-3, parameters=model.parameters())
    step = TrainStep(model, lambda m, x, y: m(x, labels=y), o)
    ref = [float(step(ids, ids)) for _ in range(3)]
    ref_state = {k: _np(v) for k, v in model.state_dict().items()}
    dist.init_mesh(sharding=WORLD)
    model = LlamaForCausalLM(cfg, device="cpu", generator=seed(1, "cpu"))
    o = popt.AdamW(learning_rate=1e-3, parameters=model.parameters())
    model, o = dist.group_sharded_parallel(model, o, level="p_g_os")
    shard = model.llama.embed_tokens.parametrizations.weight.original
    tied = model.lm_head.parametrizations.weight.original is shard
    step = dist.ShardedTrainStep(model, lambda m, x, y: m(x, labels=y), o)
    losses = [float(step(ids, ids)) for _ in range(2)]
    seen = []
    apply = sharding._AllGather.apply

    def counting(t, *a):
        seen.append(t)
        return apply(t, *a)

    sharding._AllGather.apply = counting
    try:
        losses.append(float(step(ids, ids)))
    finally:
        del sharding._AllGather.apply
    state = {k: _np(v) for k, v in
             dist.sharding.gather_full_state(model).items()}
    return {"losses": losses, "ref_losses": ref, "state": state,
            "ref_state": ref_state, "tied": tied,
            "gathers": sum(1 for t in seen if t is shard),
            "shards": sum(1 for p in o._parameter_list if p is shard)}


def parallel_cross_entropy(inp):
    """``ParallelCrossEntropy`` at mp 4: per-row losses (an ignored label
    gives 0) and this rank's columns of the logits' gradient."""
    from paddle_tpu_torch.distributed.meta_parallel import (
        ParallelCrossEntropy)

    env = dist.init_mesh(mp=WORLD)
    c = inp["pce"]
    logits = torch.from_numpy(c["logits"]).chunk(WORLD, dim=-1)[
        env.coord("mp")].contiguous().requires_grad_(True)
    loss = ParallelCrossEntropy()(logits, torch.from_numpy(c["labels"]))
    (loss * torch.from_numpy(c["cot"])).sum().backward()
    return {"loss": _np(loss), "grad": _np(logits.grad)}


def deferred(inp):
    """Each option that is not ported raises NotImplementedError."""
    out = {}

    def record(name, fn):
        try:
            fn()
            out[name] = "no error"
        except NotImplementedError as e:
            out[name] = "NotImplementedError: " + str(e)

    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    dist.init_mesh(pp=2, cp=2)
    pp_cp = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    record("pp_with_cp", lambda: dist.ShardedTrainStep(
        pp_cp, lambda m, x, y: m(x, labels=y),
        popt.AdamW(learning_rate=0.1, parameters=pp_cp.parameters())))
    return out


# -- optimizer offload and the pipeline wrapper's eager loop ---------------------

def offload_step(inp, key):
    """The offloaded ``ShardedTrainStep`` (ZeRO os_g) at the case's degrees:
    losses, the gathered state, this rank's host elements against the
    full count."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    case = inp["offload"][key]
    dist.init_mesh(**case["degrees"])
    net = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.Tanh(),
                              torch.nn.Linear(32, 16))
    net.load_state_dict({k: torch.from_numpy(v)
                         for k, v in case["state"].items()})
    full = sum(p.numel() for p in net.parameters())
    clip = None if case["clip"] is None else ClipGradByGlobalNorm(case["clip"])
    if case["rule"] == "adamw":
        o = popt.AdamW(learning_rate=0.02, parameters=net.parameters(),
                       grad_clip=clip)
    else:
        o = popt.Momentum(learning_rate=0.1, momentum=0.9,
                          parameters=net.parameters(), grad_clip=clip)
    net, o = dist.group_sharded_parallel(net, o, level="os_g", offload=True,
                                         **case["knobs"])
    step = dist.ShardedTrainStep(net, _mse, o)
    x, y = (torch.from_numpy(a) for a in case["batch"])
    losses = [float(step(x, y)) for _ in range(3)]
    return {"losses": losses,
            "host_elems": sum(m.numel() for m in step.offload_masters()),
            "full_elems": full,
            "state": {k: _np(v) for k, v in net.state_dict().items()}}


def pp_wrapper(inp, key):
    """``PipelineParallel.train_batch`` at dp 4 with accumulate_steps 2 and
    a ``GradScaler`` and / or an offloaded optimizer (the eager microbatch
    loop): losses, the state, the final loss scale."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.distributed.meta_parallel import PipelineParallel

    case = inp["offload"][key]
    dist.init_mesh(dp=WORLD)
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                              torch.nn.Linear(16, 4))
    net.load_state_dict({k: torch.from_numpy(v)
                         for k, v in case["state"].items()})
    strategy = fleet.DistributedStrategy()
    strategy.pipeline = True
    strategy.pipeline_configs = {"accumulate_steps": 2}
    opt = popt.AdamW(learning_rate=0.01, parameters=net.parameters(),
                     weight_decay=0.01)
    if case["offload"]:
        net, opt = dist.group_sharded_parallel(net, opt, level="os_g",
                                               offload=True)
    model = PipelineParallel(net, None, strategy)
    sc = None if case["scaler"] is None else GradScaler(**case["scaler"])
    x, y = torch.from_numpy(case["x"]), torch.from_numpy(case["y"])
    losses = [float(model.train_batch((x, y), opt, scaler=sc))
              for _ in range(3)]
    return {"losses": losses,
            "scale": None if sc is None else float(sc._scale),
            "state": {k: _np(v) for k, v in net.state_dict().items()}}


# -- GPT under tensor parallelism and ZeRO-3 over its tied embedding ------------

def gpt_mp(inp, key, planted=None):
    """The tiny GPT at the case's degrees (ZeRO level, clip), three steps:
    every loss, this rank's state, and the all-gathers of the tied
    embedding shard in the third step's forward (ZeRO-3). ``planted``
    ``"qkv_contiguous"``: the q/k/v weights cut in contiguous thirds."""
    from paddle_tpu_torch.distributed import sharding
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.models.convert import shard_gpt_state
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    case = inp["gpt"][key]
    env = dist.init_mesh(**case["degrees"])
    model = GPTForCausalLM(GPTConfig.tiny(**case["config"]), device="cpu")
    full = {k: torch.from_numpy(v) for k, v in case["state"].items()}
    mine = shard_gpt_state(full, env)
    if planted == "qkv_contiguous":
        mp, r = env.get_dim("mp"), env.coord("mp")
        for k in mine:
            if ".qkv_proj." in k:
                mine[k] = full[k].chunk(mp, dim=0)[r].clone()
    model.load_state_dict(mine)
    params = model.parameters()
    if case["clip"] is None:
        o = popt.AdamW(learning_rate=1e-3, parameters=params)
    else:
        o = popt.Momentum(learning_rate=0.1, momentum=0.9, parameters=params,
                          grad_clip=ClipGradByGlobalNorm(case["clip"]))
    if case["level"]:
        model, o = dist.group_sharded_parallel(model, o, level=case["level"])
    step = dist.ShardedTrainStep(model, lambda m, x, y: m(x, labels=y), o)
    ids = torch.from_numpy(case["ids"])
    losses = [float(step(ids, ids)) for _ in range(2)]
    embed = model.gpt.embed_tokens
    seen = []
    apply = sharding._AllGather.apply

    def counting(shard, *a):
        seen.append(shard)
        return apply(shard, *a)

    sharding._AllGather.apply = counting
    try:
        losses.append(float(step(ids, ids)))
    finally:
        del sharding._AllGather.apply  # back to Function.apply
    assert sharding._AllGather.apply == apply
    tied = getattr(getattr(embed, "parametrizations", None), "weight", None)
    gathers = None if tied is None else sum(
        1 for t in seen if t is tied.original)
    return {"losses": losses, "gathers": gathers,
            "state": {k: _np(v) for k, v in model.state_dict().items()}}


def gpt_init_shards(inp):
    """The tiny GPT built at dp 2 x mp 2 from seed 1: this rank's state."""
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    dist.init_mesh(dp=2, mp=2)
    model = GPTForCausalLM(GPTConfig.tiny(**inp["gpt_pipe_mp"]["config"]),
                           device="cpu", generator=seed(1, "cpu"))
    return {k: _np(v) for k, v in model.state_dict().items()}


def gpt_pipe_mp(inp):
    """``GPTForCausalLMPipe`` at pp 2 x mp 2 through
    ``PipelineParallel.train_batch`` (accumulate_steps 2)."""
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.distributed.meta_parallel import PipelineParallel
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLMPipe

    c = inp["gpt_pipe_mp"]
    dist.init_mesh(pp=2, mp=2)
    model = GPTForCausalLMPipe(GPTConfig.tiny(**c["config"]), device="cpu",
                               generator=seed(1, "cpu"))
    strategy = fleet.DistributedStrategy()
    strategy.pipeline = True
    strategy.pipeline_configs = {"accumulate_steps": 2}
    pipe = PipelineParallel(model, None, strategy)
    opt = popt.AdamW(learning_rate=1e-3, parameters=model.parameters())
    ids = torch.from_numpy(c["ids"])
    losses = [float(pipe.train_batch((ids, ids), opt)) for _ in range(3)]
    from paddle_tpu_torch.distributed import checkpoint as ckpt

    ckpt.save_sharded_model(model, opt, os.path.join(inp["tmpdir"],
                                                     "gpt_pipe_mp"))
    dist.barrier()
    return {"losses": losses, "stage": model.stage_id,
            "eval": float(pipe.eval_batch((ids, ids))),
            "state": {k: _np(v) for k, v in model.state_dict().items()}}


# -- context parallelism ----------------------------------------------------------

def ring(inp, impl):
    """This rank's chunk of the ring (q/k/v [bh, s, d]) or of Ulysses
    ([b, s, h, d]) at cp 4: its output and gradients of sum(o ** 2), and
    the bytes the ring saved for its backward."""
    from paddle_tpu_torch.distributed import (ring_attention_bhsd,
                                              ulysses_attention_bshd)

    env = dist.init_mesh(cp=WORLD)
    i = env.coord("cp")
    c = inp["ring" if impl == "ring" else "ulysses"]
    q, k, v = (torch.from_numpy(a).chunk(WORLD, dim=1)[i].contiguous()
               .requires_grad_(True) for a in (c["q"], c["k"], c["v"]))
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        if impl == "ring":
            o = ring_attention_bhsd(q, k, v, causal=True)
        else:
            o = ulysses_attention_bshd(q, k, v, causal=True)
    (o ** 2).sum().backward()
    return {"o": _np(o), "dq": _np(q.grad), "dk": _np(k.grad),
            "dv": _np(v.grad), "saved_bytes": sum(saved)}


# -- the pipeline, the in-graph scaler, gradient merge, checkpoints ------------

def _llama_pp_model(case, env):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.convert import shard_llama_state

    cfg = LlamaConfig.tiny(**case["config"])
    model = LlamaForCausalLM(cfg, device="cpu")
    full = {k: torch.from_numpy(v) for k, v in case["state"].items()}
    model.load_state_dict(shard_llama_state(full, env))
    return model


def _scaler(kw):
    from paddle_tpu_torch.amp import GradScaler

    return GradScaler(**kw)


def llama_step(inp, key):
    """The tiny Llama under ``ShardedTrainStep`` at the case's degrees and
    step options (pp, a clip, ``accum_steps``, ``accumulate``, a scaler):
    every call's loss, this rank's state, the scaler's state."""
    case = inp["pipeline"][key]
    env = dist.init_mesh(**case["degrees"])
    model = _llama_pp_model(case, env)
    o = _llama_optimizer(case, model.parameters())
    kw = dict(case.get("step", {}))
    if "scaler" in kw:
        kw["scaler"] = _scaler(kw["scaler"])
    step = dist.ShardedTrainStep(model, lambda m, x, y: m(x, labels=y), o,
                                 **kw)
    if case.get("accumulate"):
        step = step.accumulate(case["accumulate"])
    ids = torch.from_numpy(case["ids"])
    losses = [float(step(ids, ids)) for _ in range(case["calls"])]
    return {"losses": losses, "pipelined": getattr(model, "pipelined", None),
            "state": {k: _np(v) for k, v in model.state_dict().items()}}


def mlp_scaler(inp, key):
    """The tensor-parallel MLP at dp 2 x mp 2 under the in-graph scaler
    (and ``accum_steps``), an overflowing input planted in the second
    call: losses, the gathered state, ``amp_state()`` after each call and
    the scaler's and optimizer's host mirrors."""
    case = inp["pipeline"][key]
    env = dist.init_mesh(dp=2, mp=2)
    net = _TPMLP()
    _load(net, inp["tp_mlp"]["state"], env)
    o = popt.Adam(learning_rate=0.05, parameters=net.parameters())
    sc = _scaler(case["scaler"])
    step = dist.ShardedTrainStep(net, _mse, o, scaler=sc,
                                 accum_steps=case.get("accum_steps", 1))
    losses, amps = [], []
    for x, y in case["batches"]:
        losses.append(float(step(torch.from_numpy(x), torch.from_numpy(y))))
        amps.append(step.amp_state())
    out = {"losses": losses, "amp": amps,
           "host": {"scale": float(sc._scale), "good": int(sc._good_steps),
                    "bad": int(sc._bad_steps),
                    "found_inf": bool(sc._found_inf),
                    "global_step": int(o._global_step),
                    "state_dict": sc.state_dict()},
           "state": {k: _np(v) for k, v in
                     dist.sharding.gather_full_state(net).items()}}
    # the scaler and the optimizer used eagerly after the in-graph calls,
    # then a loaded state read by the next in-graph call
    x, y = (torch.from_numpy(a) for a in case["batches"][0])
    o.clear_grad()
    sc.scale(_mse(net, x, y)).backward()
    sc.step(o)
    o.clear_grad()
    out["eager"] = {"scale": float(sc.get_loss_scaling()),
                    "good": sc._good_steps, "bad": sc._bad_steps,
                    "found_inf": sc._found_inf,
                    "global_step": o._global_step,
                    "state_dict": sc.state_dict(),
                    "hashable": len({sc._scale, sc._good_steps,
                                     sc._found_inf})}
    sc.load_state_dict({"scale": 8.0, "good_steps": 0, "bad_steps": 0})
    step(x, y)
    out["after_load"] = step.amp_state()
    return out


def fleet_wrappers(inp, key):
    """``PipelineParallel.train_batch`` at dp 4 with ``accumulate_steps``,
    with a ``HybridParallelOptimizer``'s gradient merge, and with its
    lamb swap."""
    from paddle_tpu_torch.distributed.meta_parallel import (
        HybridParallelOptimizer, PipelineParallel)

    case = inp["pipeline"][key]
    dist.init_mesh(dp=WORLD)
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                              torch.nn.Linear(16, 4))
    net.load_state_dict({k: torch.from_numpy(v)
                         for k, v in case["state"].items()})
    strategy = fleet.DistributedStrategy()
    for k, v in case["strategy"].items():
        setattr(strategy, k, v)
    opt = popt.AdamW(learning_rate=0.01, parameters=net.parameters(),
                     weight_decay=0.01)
    hopt = HybridParallelOptimizer(opt, None, strategy)
    model = PipelineParallel(net, None, strategy)
    x = torch.from_numpy(case["x"])
    y = torch.from_numpy(case["y"])
    losses = [float(model.train_batch((x, y), hopt))
              for _ in range(case["calls"])]
    return {"losses": losses, "rule": type(hopt._inner_opt).__name__,
            "state": {k: _np(v) for k, v in net.state_dict().items()}}


def gpt_pipe(inp):
    """``GPTForCausalLMPipe`` at pp 2 x dp 2 over P2P through
    ``PipelineParallel.train_batch``."""
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.distributed.meta_parallel import PipelineParallel
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLMPipe

    c = inp["gpt_pipe"]
    dist.init_mesh(pp=2, dp=2)
    cfg = GPTConfig.tiny(**c["config"])
    model = GPTForCausalLMPipe(cfg, device="cpu", generator=seed(1, "cpu"))
    strategy = fleet.DistributedStrategy()
    strategy.pipeline = True
    strategy.pipeline_configs = {"accumulate_steps": 2}
    pipe = PipelineParallel(model, None, strategy)
    opt = popt.AdamW(learning_rate=1e-3, parameters=model.parameters())
    ids = torch.from_numpy(c["ids"])
    losses = [float(pipe.train_batch((ids, ids), opt)) for _ in range(3)]
    ev = float(pipe.eval_batch((ids, ids)))
    return {"losses": losses, "eval": ev, "stage": model.stage_id,
            "state": {k: _np(v) for k, v in model.state_dict().items()}}


def localsgd(inp):
    """``HybridParallelOptimizer`` with ``strategy.localsgd`` (k_steps 2)
    at dp 4: each rank starts from its own weights; the first update
    leaves them apart, the second averages them over the data ranks."""
    from paddle_tpu_torch.distributed.meta_parallel import (
        HybridParallelOptimizer)

    dist.init_mesh(dp=WORLD)
    p = torch.nn.Parameter(torch.full((3,), float(dist.get_rank())))
    strategy = fleet.DistributedStrategy()
    strategy.localsgd = True
    strategy.localsgd_configs = {"k_steps": 2, "begin_step": 1}
    hopt = HybridParallelOptimizer(popt.SGD(learning_rate=0.0,
                                            parameters=[p]), None, strategy)
    seen = []
    for _ in range(2):
        p.grad = torch.ones(3)
        hopt.step()
        seen.append(_np(p))
    return {"after": seen}


def reset_cycle(inp):
    """Three times over in one world: dp 2 x mp 2, a step, ``reset_mesh``;
    pp 2 x dp 2, a step, ``reset_mesh``."""
    case = inp["pipeline"]["pp2_dp2"]
    ids = torch.from_numpy(case["ids"])
    out = []
    for _ in range(3):
        for degrees in (dict(dp=2, mp=2), dict(pp=2, dp=2)):
            env = dist.init_mesh(**degrees)
            model = _llama_pp_model(case, env)
            o = popt.AdamW(learning_rate=1e-3, parameters=model.parameters())
            step = dist.ShardedTrainStep(model,
                                         lambda m, x, y: m(x, labels=y), o)
            out.append(float(step(ids, ids)))
            dist.reset_mesh()
    return {"losses": out}


def checkpoint_reshard(inp):
    """A checkpoint saved at dp 2 x mp 2 after one step, loaded at pp 2 x
    dp 2 and at sdp 4 (ZeRO-3), each taking two more steps beside the
    unbroken run's two."""
    from paddle_tpu_torch.distributed import checkpoint as ckpt

    case = inp["pipeline"]["pp2_dp2"]
    ids = torch.from_numpy(case["ids"])
    path = os.path.join(inp["tmpdir"], "ckpt_dp2_mp2")

    def run(degrees, level=None, load=False):
        env = dist.init_mesh(**degrees)
        model = _llama_pp_model(case, env)
        o = popt.AdamW(learning_rate=1e-3, parameters=model.parameters())
        if level:
            model, o = dist.group_sharded_parallel(model, o, level=level)
        step = dist.ShardedTrainStep(model, lambda m, x, y: m(x, labels=y),
                                     o)
        if load:
            ckpt.load_sharded_model(model, o, path)
        else:
            step(ids, ids)
            ckpt.save_sharded_model(model, o, path)
            dist.barrier()
        losses = [float(step(ids, ids)) for _ in range(2)]
        state = {k: _np(v) for k, v in model.state_dict().items()}
        dist.reset_mesh()
        return {"losses": losses, "state": state,
                "global_step": int(o._global_step)}

    out = {"unbroken": run(dict(dp=2, mp=2))}
    dist.barrier()
    out["pp2_dp2"] = run(dict(pp=2, dp=2), load=True)
    out["sdp4"] = run(dict(sharding=WORLD), level="p_g_os", load=True)
    return out


# -- the MoE Llama across ranks -------------------------------------------------

def _moe_optimizer(case, params):
    """The case's rule: AdamW lr 1e-3; Momentum (0.9) lr 0.1, or 10 for
    ``momentum_lr10``, under the case's clip (``("global" | "tensor",
    norm)`` or None); Adafactor lr 1e-2; Lamb lr 1e-2; LARS lr 0.1."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm, ClipGradByNorm

    rule, clip = case["optimizer"], case.get("clip")
    if rule.startswith("momentum"):
        return popt.Momentum(
            learning_rate=10.0 if rule == "momentum_lr10" else 0.1,
            momentum=0.9, parameters=params, grad_clip=None if clip is None
            else (ClipGradByGlobalNorm if clip[0] == "global"
                  else ClipGradByNorm)(clip[1]))
    return {"adamw": lambda: popt.AdamW(learning_rate=1e-3,
                                        parameters=params),
            "adafactor": lambda: popt.Adafactor(learning_rate=1e-2,
                                                parameters=params),
            "lamb": lambda: popt.Lamb(learning_rate=1e-2, parameters=params),
            "lars": lambda: popt.LarsMomentum(learning_rate=0.1,
                                              parameters=params)}[rule]()


class _NormWithoutEp(dist.ShardedTrainStep):
    """A planted fault: the clip's norm without the ep all-reduce, each
    rank counting only its own experts."""

    def _split_masks(self, params):
        masks = super()._split_masks(params).clone()
        masks[3] = 0
        return masks


class _EpGradCountedTwice(dist.ShardedTrainStep):
    """A planted fault: the gradients of the parameters every ep rank holds
    whole summed over ep, where each rank's is already the full one."""

    def _reduce(self, raw):
        grads = super()._reduce(raw)
        for e, g in zip(self._plan, grads):
            if g is not None and not e.ep:
                torch.distributed.all_reduce(g, group=self._ep_pg)
        return grads


class _Drops:
    """Counts, while open, the (choice, token) rows the capacity drops in
    the MoE layers' forwards (``_moe_mlp_kept``)."""

    def __init__(self):
        from paddle_tpu_torch.nn.layer import moe

        self.moe, self.dropped, self.rows = moe, 0, 0

    def __enter__(self):
        moe, orig = self.moe, self.moe.capacity_positions
        cap_of = moe._capacity
        self.saved = (orig, cap_of)
        caps = []

        def capacity(n, e, k, cf):
            caps.append(cap_of(n, e, k, cf))
            return caps[-1]

        def positions(*a):
            flat_e, pos = orig(*a)
            self.dropped += int((pos >= caps[-1]).sum())
            self.rows += pos.numel()
            return flat_e, pos

        moe._capacity, moe.capacity_positions = capacity, positions
        return self

    def __exit__(self, *exc):
        self.moe.capacity_positions, self.moe._capacity = self.saved


MOE_STEPS = {"norm_without_ep": _NormWithoutEp,
             "ep_grad_counted_twice": _EpGradCountedTwice}


def moe_llama(inp, key, fault=None):
    """The tiny MoE Llama at the case's degrees, dispatch and rule, three
    steps: every loss, this rank's state, the capacity's drops."""
    from paddle_tpu_torch import get_flags, set_flags
    from paddle_tpu_torch.models import LlamaForCausalLM, LlamaMoEConfig
    from paddle_tpu_torch.models.convert import shard_llama_state

    case = inp["moe"][key]
    env = dist.init_mesh(**case["degrees"])
    prior = get_flags("FLAGS_moe_dispatch")
    set_flags({"FLAGS_moe_dispatch": case["dispatch"]})
    n_data = env.size_over(("dp", "sdp"))
    try:
        with Planted(fault, n_data), _Drops() as drops:
            model = LlamaForCausalLM(LlamaMoEConfig.tiny(**case["config"]),
                                     device="cpu")
            full = {k: torch.from_numpy(v) for k, v in case["state"].items()}
            model.load_state_dict(shard_llama_state(full, env))
            o = _moe_optimizer(case, model.parameters())
            if case.get("level"):
                model, o = dist.group_sharded_parallel(model, o,
                                                       level=case["level"])
            step = MOE_STEPS.get(fault, dist.ShardedTrainStep)(
                model, lambda m, x, y: m(x, labels=y), o)
            ids = torch.from_numpy(case["ids"])
            losses = [float(step(ids, ids)) for _ in range(3)]
    finally:
        set_flags(prior)
    return {"losses": losses, "dropped": drops.dropped, "rows": drops.rows,
            "state": {k: _np(v) for k, v in model.state_dict().items()}}


def moe_a2a(inp):
    """``global_scatter`` / ``global_gather`` at ep 4 on the JAX test's
    buckets ([4 sources, 4 experts, capacity 2, 8]; this rank's are
    ``x[rank]``), full and ragged counts."""
    env = dist.init_mesh(ep=WORLD)
    x = torch.from_numpy(inp["a2a"][env.coord("ep")]).requires_grad_(True)
    full = torch.full((4,), 2, dtype=torch.int64)
    y = dist.global_scatter(x, full, full)
    z = dist.global_gather(y, full, full)
    (y * torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape)
     ).sum().backward()
    ragged = torch.full((4,), 1, dtype=torch.int64)
    y2 = dist.global_scatter(x.detach(), ragged, ragged)
    counts = dist.number_count(torch.tensor([[0, 3], [3, 1]]), 4)
    return {"scatter": _np(y), "gather": _np(z), "ragged": _np(y2),
            "grad": _np(x.grad), "count": counts.numpy().copy()}


def moe_checkpoint(inp):
    """The MoE Llama saved at ep 2 x dp 2 after one step and resumed at dp
    4 and at pp 2 x dp 2 (one microbatch: the aux and the capacity are
    then over the same tokens as without pp), two more steps each beside
    the unbroken run's."""
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.models import LlamaForCausalLM, LlamaMoEConfig
    from paddle_tpu_torch.models.convert import shard_llama_state

    case = inp["moe"]["ep2_dp2"]
    ids = torch.from_numpy(case["ids"])
    path = os.path.join(inp["tmpdir"], "ckpt_moe_ep2_dp2")

    def run(degrees, load=False):
        env = dist.init_mesh(**degrees)
        model = LlamaForCausalLM(LlamaMoEConfig.tiny(
            **case["config"], pp_microbatches=1), device="cpu")
        full = {k: torch.from_numpy(v) for k, v in case["state"].items()}
        model.load_state_dict(shard_llama_state(full, env))
        o = popt.AdamW(learning_rate=1e-3, parameters=model.parameters())
        step = dist.ShardedTrainStep(model, lambda m, x, y: m(x, labels=y),
                                     o)
        if load:
            ckpt.load_sharded_model(model, o, path)
        else:
            step(ids, ids)
            ckpt.save_sharded_model(model, o, path)
            dist.barrier()
        losses = [float(step(ids, ids)) for _ in range(2)]
        state = {k: _np(v) for k, v in model.state_dict().items()}
        dist.reset_mesh()
        return {"losses": losses, "state": state,
                "global_step": int(o._global_step)}

    out = {"unbroken": run(dict(ep=2, dp=2))}
    dist.barrier()
    out["dp4"] = run(dict(dp=WORLD), load=True)
    out["pp2_dp2"] = run(dict(pp=2, dp=2), load=True)
    return out


SUITES = {
    "distributed": [
        ("collectives", collectives),
        ("mesh_and_fleet", mesh_and_fleet),
        ("tp_mlp", tp_mlp),
        ("zero_os", lambda inp: zero(inp, "os")),
        ("zero_os_g", lambda inp: zero(inp, "os_g")),
        ("zero_p_g_os", lambda inp: zero(inp, "p_g_os")),
        ("vocab_embedding", vocab_embedding),
        ("data_parallel", data_parallel),
        ("placement_and_rng", placement_and_rng),
        ("llama_dp2_mp2", lambda inp: llama(inp, "dp2_mp2")),
        ("llama_cp2_dp2_ring", lambda inp: llama(inp, "cp2_dp2_ring")),
        ("llama_cp2_dp2_ulysses", lambda inp: llama(inp, "cp2_dp2_ulysses")),
        ("llama_sdp4", lambda inp: llama(inp, "sdp4")),
        ("llama_dp2_mp2_clip", lambda inp: llama(inp, "dp2_mp2_clip")),
        ("llama_cp2_dp2_ring_clip",
         lambda inp: llama(inp, "cp2_dp2_ring_clip")),
        ("llama_sdp4_os_g_clip", lambda inp: llama(inp, "sdp4_os_g_clip")),
        ("llama_sdp4_p_g_os_clip",
         lambda inp: llama(inp, "sdp4_p_g_os_clip")),
        ("planted_gradients_averaged", lambda inp: llama(
            inp, "dp2_mp2_clip", PLANTED["gradients_averaged"])),
        ("planted_norm_without_mp", lambda inp: llama(
            inp, "dp2_mp2_clip", PLANTED["norm_without_mp"])),
        ("llama_tied", llama_tied),
        ("llama_tied_sdp4", llama_tied_sdp4),
        ("parallel_cross_entropy", parallel_cross_entropy),
        ("deferred", deferred),
    ],
    "pipeline": [
        ("reset_cycle", reset_cycle),
        ("llama_pp2_dp2", lambda inp: llama_step(inp, "pp2_dp2")),
        ("llama_pp2_dp2_clip", lambda inp: llama_step(inp, "pp2_dp2_clip")),
        ("llama_pp4", lambda inp: llama_step(inp, "pp4")),
        ("llama_pp2_mp2", lambda inp: llama_step(inp, "pp2_mp2")),
        ("llama_pp2_dp2_tied", lambda inp: llama_step(inp, "pp2_dp2_tied")),
        ("llama_pp2_dp2_scaler_accum2",
         lambda inp: llama_step(inp, "pp2_dp2_scaler_accum2")),
        ("llama_dp2_mp2_accum2", lambda inp: llama_step(inp, "dp2_mp2_accum2")),
        ("llama_dp2_mp2_accumulate2",
         lambda inp: llama_step(inp, "dp2_mp2_accumulate2")),
        ("mlp_scaler", lambda inp: mlp_scaler(inp, "mlp_scaler")),
        ("mlp_scaler_accum2", lambda inp: mlp_scaler(inp, "mlp_scaler_accum2")),
        ("fleet_accumulate_steps",
         lambda inp: fleet_wrappers(inp, "fleet_accumulate_steps")),
        ("fleet_gradient_merge",
         lambda inp: fleet_wrappers(inp, "fleet_gradient_merge")),
        ("fleet_lamb", lambda inp: fleet_wrappers(inp, "fleet_lamb")),
        ("gpt_pipe", gpt_pipe),
        ("localsgd", localsgd),
        ("checkpoint", checkpoint_reshard),
    ],
    "moe": [(f"moe_{key}", (lambda k: lambda inp: moe_llama(inp, k))(key))
            for key in ("dp4_fused", "dp4_index", "sdp4_os_g", "sdp4_p_g_os",
                        "ep4", "ep2_dp2", "ep2_mp2", "pp2_dp2",
                        "ep2_dp2_clip", "ep2_dp2_tensor_clip",
                        "ep2_dp2_momentum", "adafactor_ep2_dp2",
                        "lamb_dp2_mp2", "lars_sdp4_os_g", "cp2_dp2_index",
                        "cp2_dp2_fused", "cp2_dp2_ulysses_momentum")] + [
        (f"planted_{fault}",
         (lambda f, k: lambda inp: moe_llama(inp, k, f))(fault, key))
        for fault, key in (("per_rank_capacity", "dp4_index"),
                           ("per_rank_aux", "dp4_fused"),
                           ("norm_without_ep", "ep2_dp2_tensor_clip"),
                           ("ep_grad_counted_twice", "ep2_dp2_momentum"),
                           ("cp_block_order", "cp2_dp2_index"))] + [
        ("a2a", moe_a2a),
        ("checkpoint", moe_checkpoint),
    ],
    "gpt": [(f"gpt_{key}", (lambda k: lambda inp: gpt_mp(inp, k))(key))
            for key in ("dp2_mp2", "dp2_mp2_clip", "mp4",
                        "sdp4_p_g_os_tied")] + [
        ("planted_qkv_contiguous",
         lambda inp: gpt_mp(inp, "dp2_mp2", "qkv_contiguous")),
        ("gpt_pipe_mp", gpt_pipe_mp),
        ("gpt_init_shards", gpt_init_shards),
    ],
    "offload": [
        (key, (lambda k: lambda inp: (pp_wrapper if k.startswith("wrapper")
                                      else offload_step)(inp, k))(key))
        for key in ("sdp2_dp2_adamw_clip", "sdp2_dp2_momentum",
                    "wrapper_scaler", "wrapper_offload",
                    "wrapper_offload_scaler")],
    "context_parallel": [
        ("ring", lambda inp: ring(inp, "ring")),
        ("ulysses", lambda inp: ring(inp, "ulysses")),
    ],
}


def main(tmpdir, suite):
    torch.set_num_threads(1)
    dist.init_parallel_env(backend="gloo",
                           timeout=datetime.timedelta(seconds=120))
    rank = dist.get_rank()
    with open(os.path.join(tmpdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {}
    for name, fn in SUITES[suite]:
        torch.manual_seed(0)
        out[name] = fn(inp)
        dist.reset_mesh()
    with open(os.path.join(tmpdir, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    torch.distributed.destroy_process_group()


def run(tmpdir, suite, inputs):
    """In the parent: writes ``inputs``, spawns the world, returns each
    rank's results."""
    inputs = dict(inputs, tmpdir=str(tmpdir))
    with open(os.path.join(tmpdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    dist.spawn(main, args=(str(tmpdir), suite), nprocs=WORLD,
               store_dir=str(tmpdir))
    outs = []
    for r in range(WORLD):
        with open(os.path.join(tmpdir, f"out{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs
