#!/usr/bin/env python3
"""Multi-card drill of ``paddle_tpu_torch.distributed``: one process per card
over NCCL (or per CPU over gloo, a rehearsal at a tiny size).

    python3 tools/torch_dist_drill.py                   # every visible card
    python3 tools/torch_dist_drill.py --cpu --world 4   # gloo, tiny, no card

Every job runs in ONE world of processes, one after the other, each mesh
uninstalled by ``reset_mesh`` before the next is built (its groups kept
for the world's life and reused when the same degrees come back).

Parity (fp32, eager and graphed, the graphed step equal to the eager one
bit for bit): the Llama's ``ShardedTrainStep`` for three steps from the
same seeded weights against ``jit.TrainStep`` on the whole batch in one
process (run on every rank alone first), losses within LOSS_RTOL and each
tensor's update within UPDATE_RTOL in relative L2, on the meshes dp 4, dp
2 x mp 2, cp 2 x dp 2 (ring and Ulysses), ZeRO os_g and p_g_os at sdp 4,
pp 4, pp 2 x dp 2, pp 2 x mp 2 (1F1B over NCCL P2P), pp 2 x dp 2 with a
``GradScaler`` and ``accum_steps=2`` (four calls against two steps), and
dp 2 x mp 2 under Momentum with a global-norm clip at half the first
step's norm (it binds). Then a checkpoint saved at dp 2 x mp 2 after one
step and loaded at pp 2 x dp 2 continues as the unbroken run does.

MoE parity (fp32, the same limits): the drill's Llama with every MLP an
MoE layer (8 experts, top-2) at dp 4 (``fused``), ep 4, ep 2 x dp 2, ep 2
x mp 2, sdp 2 x ep 2 (ZeRO ``p_g_os``) and pp 2 x dp 2 (``index``, the
global capacity), each against one process: ``TrainStep`` on the whole
batch in the same dispatch, or at pp ``TrainStep.accumulate(M)`` on the
batch ordered as the pipeline's microbatches hold it (its aux and
capacity are per microbatch). A checkpoint saved at ep 2 x dp 2 after one
step and loaded at dp 4 continues as the unbroken run does.

GPT parity (fp32, the same limits): the drill's GPT (the Llama's
widths, learned positions, tied head) at dp 2 x mp 2, mp 4 and, tied, at
sdp 4 (ZeRO ``p_g_os``: one shard of the tied embedding), each against
``TrainStep`` on the whole batch in one process, and
``GPTForCausalLMPipe`` at pp 2 x mp 2 (1F1B) against the pipe at pp 1;
the MoE Llama at cp 2 x dp 2 (ring attention, ``index``: the capacity's
places over the global batch's order); and the Llama with its optimizer
offloaded (ZeRO ``os_g`` at sdp 2 x dp 2: each rank's fp32 masters and
moments in page-locked host memory, the update streamed per group).

Timed (cards only, graphed bf16, recompute, AdamW lr 3e-4 / wd 0.1): the
1.16B Llama (``bench.py:1836-1840``) on one card at 4 x 2048, at dp 4, dp
2 x mp 2, cp 4 (ring, 2 x 16384), pp 4 and pp 2 x dp 2 (16 x 2048, 8
microbatches of each rank's batch at pp 4, 4 at pp 2); and Llama-2 7B at
full depth (32 layers, 8 a stage) at pp 4, M = 8 x (1 x 4096); the MoE
flagship (``bench.py:1864-1872``, Adafactor lr 1e-2) on one card at 4 x
2048 (``fused``), at dp 4 (``fused``) and at ep 4 (``index``, capacity
factor 1.25), 16 x 2048; GPT-3 6.7B at dp 2 x mp 2, 4 x 2048. Tokens/s a
card.

Fleet (``--only fleet``; not a job of the rank world: the drill's own
process supervises a ``ServingFleet``): four GPT-3 6.7B replica processes,
one a card (``chip_smoke.py:build_fleet_replica``: bf16, the same seeded
weights, a GPT-3 Small draft at k 4), under 64 requests of the serving mix
(100-500 prompt tokens, half sharing a 256-token prefix, 64 new each): the
first 32 at once, with ``r2`` crashing at its fifth submit
(``replica_crash@name=r2&seq=5&inc=0``: fence, replay onto a survivor,
restart), then 32 more paced while ``rolling_restart()`` rolls every
replica, with no request failing; then a 2 + 2 prefill/decode fleet (no
draft) ships each prompt's pages from cards 0-1 to cards 2-3. Every answer
is checked against the model's own forward (``chip_smoke._readings``),
each stream against its answer, and each live replica's launches exactly.
Reports fleet tokens/s a card, TTFT p99, the restart timeline and the
ships. ``--cpu`` rehearses it with four tiny CPU replicas.

``--only a,b`` runs the jobs of those names alone (a mesh's, a timed
job's, ``checkpoint``, ``moe_checkpoint``, ``fleet``); ``--profile`` adds
to each timed MoE job one more replay under ``torch.profiler`` on rank 0
and prints its device time by kernel (the top names and the sum).

Prints one JSON line a check and, last, ``{"ok": true, ...}``; any failure
raises and the run exits non-zero. A rank that has not finished a job
within its limit prints every thread's stack and exits (a hung collective
fails the drill, not the machine). Rank 0 appends every line to ``--out``
(default ``torch_dist_drill.jsonl`` in the working directory).
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# fp32 parity: every mesh against one process on the whole batch; the
# reductions add in another order, so loss rtol 1e-5, and each tensor's
# update (three AdamW steps at lr 1e-3) within 1e-3 of the reference's in
# relative L2: Adam's m / sqrt(v) turns an order-level change of a
# near-zero gradient into a full-size one for that element, so an
# elementwise bound does not hold (a gloo rehearsal at the tiny size
# reads up to 6e-5; with the gradient all-reduce dropped, 1.26)
LOSS_RTOL, UPDATE_RTOL = 1e-5, 1e-3
# (name, degrees, ZeRO level, cp attention, options)
MESHES = [("dp2_mp2", dict(dp=2, mp=2), None, "ring", {}),
          ("dp4", dict(dp=4), None, "ring", {}),
          ("cp2_dp2_ring", dict(cp=2, dp=2), None, "ring", {}),
          ("cp2_dp2_ulysses", dict(cp=2, dp=2), None, "ulysses", {}),
          ("sdp4_os_g", dict(sharding=4), "os_g", "ring", {}),
          ("sdp4_p_g_os", dict(sharding=4), "p_g_os", "ring", {}),
          ("pp4", dict(pp=4), None, "ring", {}),
          ("pp2_dp2", dict(pp=2, dp=2), None, "ring", {}),
          ("pp2_mp2", dict(pp=2, mp=2), None, "ring", {}),
          ("pp2_dp2_scaler_accum2", dict(pp=2, dp=2), None, "ring",
           {"scaler": True, "accum_steps": 2}),
          ("dp2_mp2_clip", dict(dp=2, mp=2), None, "ring", {"clip": True}),
          ("offload_sdp2_dp2", dict(sharding=2, dp=2), "os_g", "ring",
           {"offload": True})]
# (name, degrees, ZeRO level, pipe): the GPT meshes
GPT_MESHES = [("gpt_dp2_mp2", dict(dp=2, mp=2), None, False),
              ("gpt_mp4", dict(mp=4), None, False),
              ("gpt_sdp4_p_g_os_tied", dict(sharding=4), "p_g_os", False),
              ("gpt_pp2_mp2", dict(pp=2, mp=2), None, True)]
GPT_PARITY = {"card": dict(vocab_size=4096, hidden_size=512,
                           num_hidden_layers=4, num_attention_heads=8,
                           max_position_embeddings=512),
              "cpu": dict(vocab_size=128, hidden_size=64,
                          num_hidden_layers=4, num_attention_heads=4,
                          max_position_embeddings=64)}
PARITY = {"card": dict(vocab_size=4096, hidden_size=512,
                       intermediate_size=1408, num_hidden_layers=4,
                       num_attention_heads=8, num_key_value_heads=4,
                       max_position_embeddings=512),
          "cpu": dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=4, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=64)}
PARITY_BATCH = {"card": (8, 256), "cpu": (8, 32)}
MOE_EXPERTS = dict(num_experts=8, top_k=2, capacity_factor=1.25)
# (name, degrees, ZeRO level, dispatch, pp microbatches)
MOE_MESHES = [("moe_dp4_fused", dict(dp=4), None, "fused", 0),
              ("moe_ep4", dict(ep=4), None, "index", 0),
              ("moe_ep2_dp2", dict(ep=2, dp=2), None, "index", 0),
              ("moe_ep2_mp2", dict(ep=2, mp=2), None, "index", 0),
              ("moe_sdp2_ep2_p_g_os", dict(sharding=2, ep=2), "p_g_os",
               "index", 0),
              ("moe_pp2_dp2", dict(pp=2, dp=2), None, "index", 2),
              ("moe_cp2_dp2", dict(cp=2, dp=2), None, "index", 0)]
BIG = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
           num_hidden_layers=20, num_attention_heads=16,
           num_key_value_heads=16)
LLAMA2_7B = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                 num_hidden_layers=32, num_attention_heads=32,
                 num_key_value_heads=32, max_position_embeddings=4096)
# (name, model, degrees, ZeRO level, global batch, pp microbatches)
TIMED = [("one_card", BIG, None, None, (4, 2048), 0),
         ("dp4", BIG, dict(dp=4), None, (16, 2048), 0),
         ("dp2_mp2", BIG, dict(dp=2, mp=2), None, (8, 2048), 0),
         ("cp4_ring", BIG, dict(cp=4), None, (2, 16384), 0),
         ("pp4", BIG, dict(pp=4), None, (16, 2048), 8),
         ("pp2_dp2", BIG, dict(pp=2, dp=2), None, (16, 2048), 4),
         ("llama2_7b_pp4", LLAMA2_7B, dict(pp=4), None, (8, 4096), 8)]
MOE_FLAGSHIP = dict(vocab_size=32000, hidden_size=1536,
                    intermediate_size=2048, num_hidden_layers=16,
                    num_attention_heads=12, num_key_value_heads=12,
                    **MOE_EXPERTS)
# (name, degrees, global batch, dispatch)
GPT3_6_7B = dict(vocab_size=50304, hidden_size=4096, num_hidden_layers=32,
                 num_attention_heads=32, max_position_embeddings=2048)
# (name, degrees, global batch); ONE_CARD_GPT: GPT-3 6.7B's tokens/s on one
# card, graphed at 2 x 2048 (chip_smoke.py's gpt-train line)
ONE_CARD_GPT = 9874.0
GPT_TIMED = [("gpt3_6_7b_dp2_mp2", dict(dp=2, mp=2), (4, 2048))]
MOE_TIMED = [("moe_one_card", None, (4, 2048), "fused"),
             ("moe_dp4_fused", dict(dp=4), (16, 2048), "fused"),
             ("moe_ep4_index", dict(ep=4), (16, 2048), "index")]
# seconds a rank may take for a job before it dumps its stacks and exits
PARITY_LIMIT_S, TIMED_LIMIT_S = 240, 420
# the fleet: 64 requests, the first FLEET_BURST at once (the crash lands in
# them), the rest one every FLEET_PACE_S while the fleet rolls
FLEET_REPLICAS, FLEET_REQUESTS, FLEET_BURST, FLEET_PACE_S = 4, 64, 32, 1.5
FLEET_CRASH = "replica_crash@name=r2&seq=5&inc=0"
FLEET_POOL_LENS = (511, 300, 200, 100)
# the CPU rehearsal's replica: a tiny fp32 GPT at the serving config
FLEET_CPU_GPT = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                     num_attention_heads=4, max_position_embeddings=2048)


def _emit(obj, log):
    log.append(obj)
    if int(os.environ.get("RANK", 0)) == 0:
        print(json.dumps(obj), flush=True)


def _loss_fn(m, x, y):
    return m(x, labels=y)


def _ids(vocab, batch, seed, device):
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randint(0, vocab, batch, generator=g, device=device)


def _optimizer(params, clip):
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, Momentum

    if clip is None:
        return AdamW(learning_rate=1e-3, parameters=params)
    return Momentum(learning_rate=0.1, momentum=0.9, parameters=params,
                    grad_clip=ClipGradByGlobalNorm(clip))


def _global_norm(model, ids):
    import torch

    model.train()
    model(ids, labels=ids).backward()
    norm = torch.sqrt(sum(p.grad.float().square().sum()
                          for p in model.parameters()))
    model.zero_grad(set_to_none=True)
    return float(norm)


def _max_over_world(x):
    import torch
    import torch.distributed as dist

    t = torch.tensor([x], dtype=torch.float64,
                     device="cuda" if dist.get_backend() == "nccl" else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _errors(state, ref, full):
    """(largest |p - ref| here, largest update error in relative L2 here)
    over the tensors this rank holds (a pp stage holds its own)."""
    pe = max((state[n].float() - ref[n].float()).abs().max().item()
             for n in state)
    ue = max(((state[n] - ref[n]).float().norm() /
              (ref[n] - full[n]).float().norm().clamp_min(1e-30)).item()
             for n in state)
    return pe, ue


def _parity(name, degrees, level, impl, opts, size, device, log):
    """One mesh's fp32 steps, eager and graphed, against TrainStep on the
    whole batch in this process."""
    import torch

    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.convert import shard_llama_state

    cfg = LlamaConfig(**PARITY[size], dtype="float32", cp_impl=impl)
    ids = _ids(cfg.vocab_size, PARITY_BATCH[size], 3, device)
    model = LlamaForCausalLM(cfg, device=device, generator=seed(5, device))
    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    clip = _global_norm(model, ids) / 2 if opts.get("clip") else None
    opt = _optimizer(model.parameters(), clip)
    step = TrainStep(model, _loss_fn, opt, graph=False)
    ref_losses = [float(step(ids, ids)) for _ in range(3)]
    ref = {n: p.detach().clone() for n, p in model.named_parameters()}
    del model, opt, step
    merge = int(opts.get("accum_steps", 1))
    graphs = [False, True] if device == "cuda" else [False]
    out = {"mesh": name, "degrees": degrees, "zero": level, "impl": impl,
           "clip": clip, **{k: v for k, v in opts.items() if k != "clip"}}
    got = {}
    env = pdist.init_mesh(**degrees)
    for graph in graphs:
        model = LlamaForCausalLM(cfg, device=device,
                                 generator=seed(5, device))
        model.load_state_dict(shard_llama_state(
            {n: t for n, t in full.items()}, env))
        opt = _optimizer(model.parameters(), clip)
        if level:
            model, opt = pdist.group_sharded_parallel(
                model, opt, level=level, offload=bool(opts.get("offload")),
                segment_size=2 ** 20, buffer_max_size=2 ** 22)
        kw = {"accum_steps": merge}
        if opts.get("scaler"):
            kw["scaler"] = GradScaler(init_loss_scaling=2.0 ** 10)
        step = pdist.ShardedTrainStep(model, _loss_fn, opt, graph=graph,
                                      **kw)
        losses = [float(step(ids, ids)) for _ in range(3 * merge)]
        state = pdist.sharding.gather_full_state(model)
        mode = "graph" if graph else "eager"
        want = [x for x in ref_losses for _ in range(merge)]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        pe, ue = _errors(state, ref, full)
        pe, ue = _max_over_world(pe), _max_over_world(ue)
        if loss_rel > LOSS_RTOL or ue > UPDATE_RTOL:
            raise RuntimeError(f"{name} ({mode}): losses {losses} vs "
                               f"{want} (rel {loss_rel}), updates {ue} off "
                               f"(max abs {pe})")
        got[mode] = (losses, state)
        out[mode] = {"losses": losses, "loss_rel_err": loss_rel,
                     "update_rel_l2_err": ue, "param_max_abs_err": pe}
        if opts.get("scaler"):
            out[mode]["amp_state"] = step.amp_state()
        if opts.get("offload"):
            off = step._off
            out[mode]["offload"] = {
                "groups": len(off.groups), "pinned": off.host.is_pinned(),
                "host_gib": off.host.numel() * 4 / 2 ** 30,
                "lane": off.lane.stats()}
            off.close()
        del model, opt, step
    out["reference_losses"] = ref_losses
    if "graph" in got:
        same = got["graph"][0] == got["eager"][0] and all(
            torch.equal(got["graph"][1][n], got["eager"][1][n])
            for n in got["eager"][1])
        if not _max_over_world(0.0 if same else 1.0) == 0.0:
            raise RuntimeError(f"{name}: the graphed step differs from the "
                               f"eager one")
        out["graph_equals_eager"] = True
    pdist.reset_mesh()
    _emit(dict(phase="parity", **out), log)


def _gpt_parity(name, degrees, level, pipe, size, device, log):
    """One GPT mesh's fp32 steps (AdamW lr 1e-3), eager and graphed,
    against one process: ``GPTForCausalLM`` under ``TrainStep`` on the
    whole batch, or for the pipe at pp 2 the pipe built at pp = 1 (the
    same weights from the same generator)."""
    import torch

    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         GPTForCausalLMPipe)

    cfg = GPTConfig(**GPT_PARITY[size], dtype="float32")
    ids = _ids(cfg.vocab_size, PARITY_BATCH[size], 3, device)

    def build():
        if pipe:
            return GPTForCausalLMPipe(cfg, device=device,
                                      generator=seed(5, device))
        return GPTForCausalLM(cfg, device=device, generator=seed(5, device))

    def loss_fn(m, x, y):
        return m.compute_loss(x, y) if pipe else m(x, labels=y)

    model = build()
    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = _optimizer(model.parameters(), None)
    step = TrainStep(model, loss_fn, opt, graph=False)
    ref_losses = [float(step(ids, ids)) for _ in range(3)]
    ref = {n: p.detach().clone() for n, p in model.named_parameters()}
    del model, opt, step
    graphs = [False, True] if device == "cuda" else [False]
    out = {"mesh": name, "model": "gpt", "degrees": degrees, "zero": level,
           "pipe": pipe}
    got = {}
    pdist.init_mesh(**degrees)
    for graph in graphs:
        model = build()  # under mp each rank draws its shards of the same
        opt = _optimizer(model.parameters(), None)
        if level:
            model, opt = pdist.group_sharded_parallel(model, opt,
                                                      level=level)
        step = pdist.ShardedTrainStep(model, loss_fn, opt, graph=graph,
                                      num_microbatches=2 if pipe else None)
        losses = [float(step(ids, ids)) for _ in range(3)]
        state, params = {}, dict(model.named_parameters())
        for n, t in pdist.sharding.gather_full_state(model).items():
            p = params.get(n)
            if getattr(p, "ckpt_copy", False) and \
                    getattr(p, "pp_shared", None) is None:
                continue  # the head's copy of the position table: unused
            state[getattr(p, "ckpt_name", None) or n] = t
        mode = "graph" if graph else "eager"
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(losses, ref_losses))
        held, kb = _key_bias_apart(state, ref, full, cfg.hidden_size)
        pe, ue = _errors(*held)
        pe, ue = _max_over_world(pe), _max_over_world(ue)
        if loss_rel > LOSS_RTOL or ue > UPDATE_RTOL or kb > 3.01e-3:
            raise RuntimeError(f"{name} ({mode}): losses {losses} vs "
                               f"{ref_losses} (rel {loss_rel}), updates {ue} "
                               f"off (max abs {pe}), key bias moved {kb}")
        got[mode] = (losses, state)
        out[mode] = {"losses": losses, "loss_rel_err": loss_rel,
                     "update_rel_l2_err": ue, "param_max_abs_err": pe,
                     "key_bias_max_move": kb}
        del model, opt, step
    out["reference_losses"] = ref_losses
    if "graph" in got:
        same = got["graph"][0] == got["eager"][0] and all(
            torch.equal(got["graph"][1][n], got["eager"][1][n])
            for n in got["eager"][1])
        if not _max_over_world(0.0 if same else 1.0) == 0.0:
            raise RuntimeError(f"{name}: the graphed step differs from the "
                               f"eager one")
        out["graph_equals_eager"] = True
    pdist.reset_mesh()
    _emit(dict(phase="parity", **out), log)


def _key_bias_apart(state, ref, full, h):
    """((state, ref, full) with the key rows of each q/k/v bias left out,
    the largest move of those rows from their start). Their gradient is
    zero in exact arithmetic (a key bias adds ``q . b`` to every score of a
    query, which the softmax cancels): AdamW's ``m / sqrt(v)`` turns the
    rounding noise there into steps of about the learning rate (1e-3), in
    any summation order, so those rows are held to three such steps."""
    import torch

    kb = 0.0
    out = [dict(state), dict(ref), dict(full)]
    for n in state:
        if n.endswith("qkv_proj.bias"):
            kb = max(kb, (state[n][h:2 * h] - full[n][h:2 * h]).abs().max()
                     .item())
            for d in out:
                d[n] = torch.cat([d[n][:h], d[n][2 * h:]])
    return out, kb


def _gpt_timed(name, degrees, batch, log, card):
    """The graphed bf16 GPT-3 6.7B step (recompute, AdamW lr 3e-4 / wd 0.1)
    over the mesh: step ms of 5 replays after warm-up and capture, tokens/s
    a card against one card's (``ONE_CARD_GPT``), peak GiB a card."""
    import gc

    import torch

    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig(**GPT3_6_7B, dtype="bfloat16", use_recompute=True)
    pdist.init_mesh(**degrees)
    torch.cuda.reset_peak_memory_stats()
    model = GPTForCausalLM(cfg, device="cuda", generator=seed(9, "cuda"))
    opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                weight_decay=0.1)
    step = pdist.ShardedTrainStep(model, _loss_fn, opt)
    ids = _ids(cfg.vocab_size, batch, 11, "cuda")
    losses = [float(step(ids, ids)) for _ in range(3)]
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        losses.append(float(step(ids, ids)))
        ms.append((time.perf_counter() - t0) * 1e3)
    if not all(map(lambda x: x == x, losses)) or losses[-1] >= losses[0]:
        raise RuntimeError(f"{name}: losses {losses} not finite and falling")
    world = pdist.get_world_size()
    per_card = batch[0] * batch[1] / (min(ms) / 1e3) / world
    _emit({"phase": "timed", "mesh": name, "card": card,
           "model": "gpt3-6.7b", "degrees": degrees,
           "global_batch": list(batch), "losses": losses, "step_ms": ms,
           "tokens_per_s_per_card": per_card,
           "one_card_tokens_per_s": ONE_CARD_GPT,
           "of_one_card": per_card / ONE_CARD_GPT,
           "peak_gib_max_over_cards": _max_over_world(
               torch.cuda.max_memory_allocated() / 2 ** 30)}, log)
    pdist.reset_mesh()
    del step, opt, model
    gc.collect()
    torch.cuda.empty_cache()


def _checkpoint(size, device, path, log):
    """A checkpoint saved at dp 2 x mp 2 after one AdamW step, loaded at pp
    2 x dp 2: two more steps there against the unbroken run's two."""
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.convert import shard_llama_state

    cfg = LlamaConfig(**PARITY[size], dtype="float32")
    ids = _ids(cfg.vocab_size, PARITY_BATCH[size], 3, device)
    full = {n: p.detach().clone() for n, p in LlamaForCausalLM(
        cfg, device=device, generator=seed(5, device)).named_parameters()}

    def build(degrees):
        env = pdist.init_mesh(**degrees)
        model = LlamaForCausalLM(cfg, device=device,
                                 generator=seed(5, device))
        model.load_state_dict(shard_llama_state(full, env))
        opt = _optimizer(model.parameters(), None)
        return model, opt, pdist.ShardedTrainStep(model, _loss_fn, opt)

    model, opt, step = build(dict(dp=2, mp=2))
    step(ids, ids)
    ckpt.save_sharded_model(model, opt, path)
    pdist.barrier()
    unbroken = [float(step(ids, ids)) for _ in range(2)]
    want = pdist.sharding.gather_full_state(model)
    pdist.reset_mesh()
    del model, opt, step
    model, opt, step = build(dict(pp=2, dp=2))
    ckpt.load_sharded_model(model, opt, path)
    resumed = [float(step(ids, ids)) for _ in range(2)]
    got = pdist.sharding.gather_full_state(model)
    pdist.reset_mesh()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, unbroken))
    pe, ue = _errors(got, want, full)
    pe, ue = _max_over_world(pe), _max_over_world(ue)
    if loss_rel > LOSS_RTOL or ue > UPDATE_RTOL or opt._global_step != 3:
        raise RuntimeError(f"checkpoint: resumed {resumed} vs unbroken "
                           f"{unbroken}, updates {ue} off")
    _emit({"phase": "checkpoint", "saved_at": "dp2_mp2",
           "loaded_at": "pp2_dp2", "unbroken": unbroken, "resumed": resumed,
           "loss_rel_err": loss_rel, "update_rel_l2_err": ue,
           "param_max_abs_err": pe}, log)


def _dispatch(mode):
    from paddle_tpu_torch import set_flags

    set_flags({"FLAGS_moe_dispatch": mode})


def _pp_order(ids, dp, m):
    """The global batch's rows in the order the pipeline's microbatches
    hold them: microbatch i of every data rank, rank by rank, then i + 1
    (each rank's local rows split into ``m`` microbatches)."""
    b = ids.shape[0]
    per = b // dp // m
    rows = [r * (b // dp) + i * per + j for i in range(m)
            for r in range(dp) for j in range(per)]
    return ids[rows]


def _moe_parity(name, degrees, level, mode, micro, size, device, log):
    """One MoE mesh's fp32 steps, eager and graphed, against one process:
    ``TrainStep`` on the whole batch, or at pp ``TrainStep.accumulate(M)``
    on the batch in the pipeline's microbatch order."""
    import torch

    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM, LlamaMoEConfig
    from paddle_tpu_torch.models.convert import shard_llama_state

    _dispatch(mode)
    cfg = LlamaMoEConfig(**PARITY[size], **MOE_EXPERTS, dtype="float32",
                         pp_microbatches=micro)
    ids = _ids(cfg.vocab_size, PARITY_BATCH[size], 3, device)
    model = LlamaForCausalLM(cfg, device=device, generator=seed(5, device))
    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = _optimizer(model.parameters(), None)
    if micro:
        step = TrainStep(model, _loss_fn, opt, graph=False).accumulate(micro)
        ref_ids = _pp_order(ids, degrees.get("dp", 1), micro)
    else:
        step, ref_ids = TrainStep(model, _loss_fn, opt, graph=False), ids
    ref_losses = [float(step(ref_ids, ref_ids)) for _ in range(3)]
    ref = {n: p.detach().clone() for n, p in model.named_parameters()}
    del model, opt, step
    graphs = [False, True] if device == "cuda" else [False]
    out = {"mesh": name, "degrees": degrees, "zero": level,
           "dispatch": mode, "pp_microbatches": micro or None,
           "experts": cfg.num_experts, "top_k": cfg.top_k}
    got = {}
    env = pdist.init_mesh(**degrees)
    for graph in graphs:
        model = LlamaForCausalLM(cfg, device=device,
                                 generator=seed(5, device))
        model.load_state_dict(shard_llama_state(full, env))
        opt = _optimizer(model.parameters(), None)
        if level:
            model, opt = pdist.group_sharded_parallel(model, opt,
                                                      level=level)
        step = pdist.ShardedTrainStep(model, _loss_fn, opt, graph=graph)
        losses = [float(step(ids, ids)) for _ in range(3)]
        state = pdist.sharding.gather_full_state(model)
        mode_ = "graph" if graph else "eager"
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(losses, ref_losses))
        pe, ue = _errors(state, ref, full)
        pe, ue = _max_over_world(pe), _max_over_world(ue)
        if loss_rel > LOSS_RTOL or ue > UPDATE_RTOL:
            raise RuntimeError(f"{name} ({mode_}): losses {losses} vs "
                               f"{ref_losses} (rel {loss_rel}), updates {ue} "
                               f"off (max abs {pe})")
        got[mode_] = (losses, state)
        out[mode_] = {"losses": losses, "loss_rel_err": loss_rel,
                      "update_rel_l2_err": ue, "param_max_abs_err": pe}
        del model, opt, step
    out["reference_losses"] = ref_losses
    if "graph" in got:
        same = got["graph"][0] == got["eager"][0] and all(
            torch.equal(got["graph"][1][n], got["eager"][1][n])
            for n in got["eager"][1])
        if not _max_over_world(0.0 if same else 1.0) == 0.0:
            raise RuntimeError(f"{name}: the graphed step differs from the "
                               f"eager one")
        out["graph_equals_eager"] = True
    pdist.reset_mesh()
    _dispatch("index")
    _emit(dict(phase="parity", **out), log)


def _moe_checkpoint(size, device, path, log):
    """The MoE Llama (``index``) saved at ep 2 x dp 2 after one AdamW step
    (each expert stack's ep split in the manifest), loaded at dp 4: two
    more steps there against the unbroken run's two."""
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.models import LlamaForCausalLM, LlamaMoEConfig
    from paddle_tpu_torch.models.convert import shard_llama_state

    _dispatch("index")
    cfg = LlamaMoEConfig(**PARITY[size], **MOE_EXPERTS, dtype="float32")
    ids = _ids(cfg.vocab_size, PARITY_BATCH[size], 3, device)
    full = {n: p.detach().clone() for n, p in LlamaForCausalLM(
        cfg, device=device, generator=seed(5, device)).named_parameters()}

    def build(degrees):
        env = pdist.init_mesh(**degrees)
        model = LlamaForCausalLM(cfg, device=device,
                                 generator=seed(5, device))
        model.load_state_dict(shard_llama_state(full, env))
        opt = _optimizer(model.parameters(), None)
        return model, opt, pdist.ShardedTrainStep(model, _loss_fn, opt)

    model, opt, step = build(dict(ep=2, dp=2))
    step(ids, ids)
    ckpt.save_sharded_model(model, opt, path)
    pdist.barrier()
    unbroken = [float(step(ids, ids)) for _ in range(2)]
    want = pdist.sharding.gather_full_state(model)
    pdist.reset_mesh()
    del model, opt, step
    model, opt, step = build(dict(dp=4))
    ckpt.load_sharded_model(model, opt, path)
    resumed = [float(step(ids, ids)) for _ in range(2)]
    got = pdist.sharding.gather_full_state(model)
    pdist.reset_mesh()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, unbroken))
    pe, ue = _errors(got, want, full)
    pe, ue = _max_over_world(pe), _max_over_world(ue)
    if loss_rel > LOSS_RTOL or ue > UPDATE_RTOL or opt._global_step != 3:
        raise RuntimeError(f"moe checkpoint: resumed {resumed} vs unbroken "
                           f"{unbroken}, updates {ue} off")
    _emit({"phase": "checkpoint", "model": "moe", "saved_at": "ep2_dp2",
           "loaded_at": "dp4", "unbroken": unbroken, "resumed": resumed,
           "loss_rel_err": loss_rel, "update_rel_l2_err": ue,
           "param_max_abs_err": pe}, log)


def _device_profile(call, top=14):
    """One ``call`` under ``torch.profiler`` on this rank: (device ms of
    all kernels, [(kernel name, device ms, calls)] for the ``top``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows[:top]


def _moe_timed(name, degrees, batch, mode, log, card, profile=False):
    """The graphed bf16 MoE flagship step (recompute, Adafactor lr 1e-2)
    on the mesh (or one card alone): step ms of 5 replays after warm-up
    and capture, tokens/s a card, peak GiB."""
    import gc

    import torch

    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM, LlamaMoEConfig
    from paddle_tpu_torch.optimizer import Adafactor

    _dispatch(mode)
    cfg = LlamaMoEConfig(**MOE_FLAGSHIP, max_position_embeddings=batch[1],
                         dtype="bfloat16", use_recompute=True)
    if degrees:
        pdist.init_mesh(**degrees)
    torch.cuda.reset_peak_memory_stats()
    model = LlamaForCausalLM(cfg, device="cuda", generator=seed(9, "cuda"))
    opt = Adafactor(learning_rate=1e-2, parameters=model.parameters())
    step = (pdist.ShardedTrainStep(model, _loss_fn, opt) if degrees
            else TrainStep(model, _loss_fn, opt))
    ids = _ids(cfg.vocab_size, batch, 11, "cuda")
    losses = [float(step(ids, ids)) for _ in range(3)]
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        losses.append(float(step(ids, ids)))
        ms.append((time.perf_counter() - t0) * 1e3)
    if not all(map(lambda x: x == x, losses)) or losses[-1] >= losses[0]:
        raise RuntimeError(f"{name}: losses {losses} not finite and falling")
    world = pdist.get_world_size() if degrees else 1
    peak = _max_over_world(torch.cuda.max_memory_allocated() / 2 ** 30) \
        if degrees else torch.cuda.max_memory_allocated() / 2 ** 30
    if profile:
        total, top = _device_profile(lambda: step(ids, ids))
        _emit({"phase": "profile", "mesh": name, "card": card,
               "rank": pdist.get_rank() if degrees else 0,
               "device_ms": total, "top": top}, log)
    _emit({"phase": "timed", "mesh": name, "card": card,
           "model": "llama-moe-1.46b", "degrees": degrees,
           "dispatch": mode, "capacity_factor": cfg.capacity_factor,
           "global_batch": list(batch), "losses": losses, "step_ms": ms,
           "tokens_per_s_per_card": batch[0] * batch[1] / (min(ms) / 1e3)
           / world, "peak_gib_max_over_cards": peak}, log)
    if degrees:
        pdist.reset_mesh()
    _dispatch("index")
    del step, opt, model
    gc.collect()
    torch.cuda.empty_cache()


def _timed(name, model_cfg, degrees, level, batch, micro, log, card):
    """The graphed bf16 step on the mesh (or one card alone): step ms of 5
    replays after warm-up and capture, tokens/s a card."""
    import torch

    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig(**{**model_cfg, "max_position_embeddings": max(
        model_cfg.get("max_position_embeddings", 2048), batch[1])},
        dtype="bfloat16", use_recompute=True, pp_microbatches=micro)
    if degrees:
        pdist.init_mesh(**degrees)
    torch.cuda.reset_peak_memory_stats()
    model = LlamaForCausalLM(cfg, device="cuda", generator=seed(9, "cuda"))
    opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                weight_decay=0.1)
    if level:
        model, opt = pdist.group_sharded_parallel(model, opt, level=level)
    step = (pdist.ShardedTrainStep(model, _loss_fn, opt) if degrees
            else TrainStep(model, _loss_fn, opt))
    ids = _ids(cfg.vocab_size, batch, 11, "cuda")
    losses = [float(step(ids, ids)) for _ in range(3)]
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        losses.append(float(step(ids, ids)))
        ms.append((time.perf_counter() - t0) * 1e3)
    if not all(map(lambda x: x == x, losses)) or losses[-1] >= losses[0]:
        raise RuntimeError(f"{name}: losses {losses} not finite and falling")
    world = pdist.get_world_size() if degrees else 1
    tokens = batch[0] * batch[1]
    peak = _max_over_world(torch.cuda.max_memory_allocated() / 2 ** 30) \
        if degrees else torch.cuda.max_memory_allocated() / 2 ** 30
    _emit({"phase": "timed", "mesh": name, "card": card,
           "model": "llama2-7b" if model_cfg == LLAMA2_7B else "llama-1.16b",
           "degrees": degrees, "zero": level, "global_batch": list(batch),
           "pp_microbatches": micro or None,
           "losses": losses, "step_ms": ms,
           "tokens_per_s_per_card": tokens / (min(ms) / 1e3) / world,
           "peak_gib_max_over_cards": peak}, log)
    if degrees:
        pdist.reset_mesh()
    del step, opt, model
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def build_cpu_replica():
    """The fleet rehearsal's replica (``--cpu``): a tiny fp32 GPT on the
    CPU at the serving config, weights from chip_smoke.FLEET_SEED, with a
    one-layer draft unless ``PT_FLEET_DRAFT=0``."""
    import chip_smoke as cs
    from paddle_tpu_torch.device import seed as pt_seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import GenerationEngine

    cfg = cs._serving_config()
    if os.environ.get("PT_FLEET_DRAFT", "1") == "1":
        cfg.draft_model = GPTForCausalLM(
            GPTConfig(**{**FLEET_CPU_GPT, "num_hidden_layers": 1},
                      dtype="float32"), device="cpu",
            generator=pt_seed(cs.FLEET_SEED + 1, "cpu"))
        cfg.spec_tokens = cs.TIER_SPEC_K
    return GenerationEngine(_fleet_cpu_model(), cfg, device="cpu",
                            name=os.environ.get("PT_REPLICA_NAME", "r0"))


def _fleet_cpu_model():
    import chip_smoke as cs
    from paddle_tpu_torch.device import seed as pt_seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    return GPTForCausalLM(GPTConfig(**FLEET_CPU_GPT, dtype="float32"),
                          device="cpu",
                          generator=pt_seed(cs.FLEET_SEED, "cpu"))


def _fleet_drill(cpu, card, out):
    """The four-replica fleet: a burst through a crash, a paced load
    through a rolling restart, then a 2 + 2 prefill/decode ship across
    cards; checks every answer and stream, each live replica's launches."""
    import tempfile
    import threading

    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.serving import ServingFleet, ServingFleetPolicy

    log = []
    here = os.path.abspath(__file__)
    repo = os.path.dirname(os.path.dirname(here))
    if cpu:
        cs.DEVICE = "cpu"
        spec, vocab = here + ":build_cpu_replica", FLEET_CPU_GPT["vocab_size"]
        L, Ld = FLEET_CPU_GPT["num_hidden_layers"], 1
    else:
        spec = os.path.join(repo, "chip_smoke.py") + ":build_fleet_replica"
        vocab, L, Ld = GPT3_6_7B["vocab_size"], 32, 12
    log_dir = tempfile.mkdtemp(prefix="torch_dist_drill_fleet_")
    rng = np.random.default_rng(cs.SEED + 21)
    prompts = [p for _ in range(FLEET_REQUESTS // 16)
               for p in cs._tier_prompts(rng, vocab, 16)]
    total, answers = {}, []
    names = [f"r{i}" for i in range(FLEET_REPLICAS)]
    run = cs._FleetRun(ServingFleet(
        builder=spec, names=names,
        policy=ServingFleetPolicy(heartbeat_timeout=10.0,
                                  replica_capacity=64),
        extra_env={"PT_FAULTS": FLEET_CRASH}, log_dir=log_dir))
    try:
        try:
            ready = run.start()
            fleet = run.fleet
            t0 = time.monotonic()
            burst = cs._fleet_submit(fleet, prompts[:FLEET_BURST],
                                     cs.FLEET_NEW)
            burst_s = time.monotonic() - t0
            cs._fleet_streams("fleet-burst", burst, cs.FLEET_NEW)
            snap = fleet.provider_snapshot()
            c = snap["counters"]
            if c.get("fences", 0) < 1 or c.get("replays", 0) < 1:
                raise RuntimeError(f"fleet: the crash was not fenced and "
                                   f"replayed: {c}")
            # the paced rest, submitted while the whole fleet rolls
            paced, errors = [], []

            def produce():
                try:
                    for p in prompts[FLEET_BURST:]:
                        paced.extend(cs._fleet_submit(
                            fleet, [p], cs.FLEET_NEW, block=False))
                        time.sleep(FLEET_PACE_S)
                except Exception as e:  # the drill fails below
                    errors.append(e)

            th = threading.Thread(target=produce, daemon=True)
            t_roll = time.monotonic()
            th.start()
            roll = fleet.rolling_restart()
            roll_s = time.monotonic() - t_roll
            th.join(timeout=FLEET_REQUESTS * FLEET_PACE_S + 600)
            if errors:
                raise errors[0]
            cs._fleet_collect(paced)
            run.note_procs()
            cs._fleet_streams("fleet-paced", paced, cs.FLEET_NEW)
            snap = fleet.provider_snapshot()
            c = snap["counters"]
            if not roll["ok"] or c.get("failed", 0) or \
                    c.get("rolled_replicas", 0) != FLEET_REPLICAS or \
                    c.get("stream_mismatch", 0):
                raise RuntimeError(f"fleet: roll {roll}, counters {c}")
            launches = cs._fleet_telemetry(run, L, Ld, (128, 512), total) \
                if not cpu else None
            timeline = [e for e in snap["timeline"] if e["event"] in (
                "fence", "restart", "roll_drain", "roll_done")]
            recs = burst + paced
            answers += recs
            tokens = sum(len(r["seq"]) - len(r["prompt"]) for r in burst)
            p50, p99 = cs._ttft_ms(recs)
            _emit({"drill": "fleet", "part": "crash-and-roll",
                   "replicas": FLEET_REPLICAS, "card": card,
                   "spawn_to_ready_s": ready, "requests": len(recs),
                   "burst": FLEET_BURST, "burst_s": burst_s,
                   "burst_tokens_per_s_per_card":
                   tokens / burst_s / FLEET_REPLICAS,
                   "ttft_ms_p50": p50, "ttft_ms_p99": p99,
                   "roll": roll, "roll_s": roll_s,
                   "failed": c.get("failed", 0),
                   "recoveries": snap["recoveries"], "timeline": timeline,
                   "counters": {k: c.get(k, 0) for k in (
                       "fences", "restarts", "replays", "rolled_replicas",
                       "stream_mismatch", "completed", "failed")},
                   "routed": {n: r["routed"] for n, r in
                              snap["replicas"].items()},
                   "launches": launches}, log)
        finally:
            run.close()
        # the 2 + 2 prefill/decode fleet: pages cross from cards 0-1 to
        # cards 2-3 (each replica on the card its name numbers)
        pools = cs._FleetRun(ServingFleet(
            builder=spec, names=["p0", "p1", "d2", "d3"],
            pools={"prefill": ["p0", "p1"], "decode": ["d2", "d3"]},
            policy=ServingFleetPolicy(heartbeat_timeout=60.0,
                                      rpc_timeout_s=120.0),
            extra_env={"PT_FLEET_DRAFT": "0"}, log_dir=log_dir,
            name="serving_fleet_pools"))
        try:
            ready = pools.start()
            fleet = pools.fleet
            ships = []
            for n in FLEET_POOL_LENS:
                p = rng.integers(0, vocab, size=n)
                w0 = fleet.kv_migration_snapshot()["wire_bytes"]
                r = cs._fleet_submit(fleet, [p], cs.FLEET_POOL_NEW)[0]
                answers.append(r)
                ships.append({"prompt_tokens": n, "pages": n // 16,
                              "handoff_ms": (r["times"][1] - r["times"][0])
                              * 1e3,
                              "wire_bytes": fleet.kv_migration_snapshot()
                              ["wire_bytes"] - w0})
            cs._fleet_streams("fleet-pools", answers[-len(ships):],
                              cs.FLEET_POOL_NEW)
            c = fleet.provider_snapshot()["counters"]
            if c.get("migrations") != len(ships) or \
                    c.get("migrate_fallback", 0):
                raise RuntimeError(f"fleet pools: counters {c}")
            launches = cs._fleet_telemetry(pools, L, 0, (128, 512), total) \
                if not cpu else None
            _emit({"drill": "fleet", "part": "pools-2+2", "card": card,
                   "spawn_to_ready_s": ready, "ships": ships,
                   "kv_migration": fleet.kv_migration_snapshot(),
                   "routed": {n: r["routed"] for n, r in
                              fleet.provider_snapshot()["replicas"].items()},
                   "launches": launches}, log)
        finally:
            pools.close()
    except Exception as e:
        raise RuntimeError(f"{e}\nreplica logs:\n"
                           f"{cs._fleet_logs_tail(log_dir)}") from e
    alive = [p for p in run.procs + pools.procs if p.poll() is None]
    if alive:
        raise RuntimeError(f"fleet: {len(alive)} replica processes outlived "
                           f"the fleet")
    model = _fleet_cpu_model() if cpu else cs._fleet_model("cuda:0")
    with torch.inference_mode():
        rd = [cs._readings(model, r["seq"], len(r["prompt"]), r["lps"])
              for r in answers]
    check = {"answers": len(rd), "argmax_gap_max": max(x[0] for x in rd),
             "logprob_err_max": max(x[1] for x in rd),
             "gap_tol": cs.GAP_TOL, "logprob_tol": cs.LP_TOL}
    _emit({"drill": "fleet", "part": "check", **check,
           "kernel_counts": {n: v for n, v in total.items()
                             if v["launches"] or v["plain_calls"]}}, log)
    if not cs._within(rd, cs.GAP_TOL, cs.LP_TOL):
        raise RuntimeError(f"fleet: answers differ from the forward {check}")
    with open(out, "a") as f:
        for row in log:
            f.write(json.dumps(row) + "\n")


def _rank(out, cpu, card, jobs, profile=False):
    """Every job in this world, one after the other; before each a
    watchdog: a rank that has not finished the job within its limit prints
    every thread's stack and exits, which ends the world."""
    import faulthandler

    import torch

    from paddle_tpu_torch import distributed as pdist

    limit = max(j[2] for j in jobs)
    pdist.init_parallel_env(backend="gloo" if cpu else "nccl",
                            timeout=datetime.timedelta(seconds=limit))
    if cpu:
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(pdist.get_rank())
    torch.backends.cuda.matmul.allow_tf32 = False
    size, device = ("cpu", "cpu") if cpu else ("card", "cuda")
    ckpt_dir = out + ".ckpt"  # removed by the parent after the world
    log = []
    t0 = time.perf_counter()
    for kind, spec, job_limit in jobs:
        faulthandler.dump_traceback_later(job_limit, exit=True)
        if kind == "parity":
            _parity(*spec, size, device, log)
        elif kind == "moe_parity":
            _moe_parity(*spec, size, device, log)
        elif kind == "checkpoint":
            _checkpoint(size, device, ckpt_dir, log)
        elif kind == "moe_checkpoint":
            _moe_checkpoint(size, device, ckpt_dir + ".moe", log)
        elif kind == "moe_timed":
            _moe_timed(*spec, log, card, profile)
        elif kind == "gpt_parity":
            _gpt_parity(*spec, size, device, log)
        elif kind == "gpt_timed":
            _gpt_timed(*spec, log, card)
        else:
            _timed(*spec, log, card)
        faulthandler.cancel_dump_traceback_later()
        pdist.barrier()
    if pdist.get_rank() == 0:
        with open(out, "a") as f:
            for row in log:
                f.write(json.dumps(row) + "\n")
        print(json.dumps({"phase": "world", "jobs": len(jobs),
                          "one_world": True,
                          "seconds": time.perf_counter() - t0}), flush=True)
    pdist.barrier()
    pdist.reset_mesh()
    torch.distributed.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="gloo processes on the CPU at a tiny size")
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--out", default="torch_dist_drill.jsonl")
    ap.add_argument("--only", default=None,
                    help="comma-separated job names to run alone")
    ap.add_argument("--profile", action="store_true",
                    help="profile one replay of each timed MoE job")
    a = ap.parse_args()
    import subprocess

    import torch

    from paddle_tpu_torch import distributed as pdist

    card = None
    if not a.cpu:
        if not torch.cuda.is_available():
            print("torch_dist_drill: no CUDA device", file=sys.stderr)
            return 2
        from paddle_tpu_torch.kernels import _build

        _build.library()  # once, before the ranks start
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    world = a.world or (4 if a.cpu else torch.cuda.device_count())
    if world != 4:
        raise SystemExit("the drill's meshes take 4 ranks")
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    open(a.out, "w").close()
    jobs = [("parity", m, PARITY_LIMIT_S) for m in MESHES]
    jobs.append(("checkpoint", ("checkpoint",), PARITY_LIMIT_S))
    jobs += [("moe_parity", m, PARITY_LIMIT_S) for m in MOE_MESHES]
    jobs.append(("moe_checkpoint", ("moe_checkpoint",), PARITY_LIMIT_S))
    jobs += [("gpt_parity", m, PARITY_LIMIT_S) for m in GPT_MESHES]
    if not a.cpu:
        jobs += [("timed", t, TIMED_LIMIT_S) for t in TIMED]
        jobs += [("moe_timed", t, TIMED_LIMIT_S) for t in MOE_TIMED]
        jobs += [("gpt_timed", t, TIMED_LIMIT_S) for t in GPT_TIMED]
    names = set(a.only.split(",")) if a.only else None
    if names is not None:
        jobs = [j for j in jobs if j[1][0] in names]
    t0 = time.perf_counter()
    if jobs:
        pdist.spawn(_rank, args=(a.out, a.cpu, card, jobs, a.profile),
                    nprocs=world)
    if names is not None and "fleet" in names:
        _fleet_drill(a.cpu, card, a.out)
    import shutil

    shutil.rmtree(a.out + ".ckpt", ignore_errors=True)
    shutil.rmtree(a.out + ".ckpt.moe", ignore_errors=True)
    print(json.dumps({"ok": True, "world": world, "card": card,
                      "backend": "gloo" if a.cpu else "nccl",
                      "jobs": len(jobs), "worlds": 1 if jobs else 0,
                      "fleet": names is not None and "fleet" in names,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
