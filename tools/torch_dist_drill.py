#!/usr/bin/env python3
"""Multi-card drill of ``paddle_tpu_torch.distributed``: one process per card
over NCCL (or per CPU over gloo, a rehearsal at a tiny size).

    python3 tools/torch_dist_drill.py                   # every visible card
    python3 tools/torch_dist_drill.py --cpu --world 4   # gloo, tiny, no card

Each rank runs, for each mesh below, the Llama's ``ShardedTrainStep`` for
three steps from the same seeded weights and holds the losses and the
gathered parameters to ``jit.TrainStep`` on the whole batch in one process
(run on every rank alone, before the mesh): fp32, eager and graphed (the
graphed step must also equal the eager one bit for bit). Meshes: dp 4, dp
2 x mp 2, cp 2 x dp 2 (ring), cp 2 x dp 2 (Ulysses), ZeRO os_g and
p_g_os at sdp 4. On the cards it then times the graphed bf16 step of the
1.16B Llama (``bench.py:1836-1840``, recompute, AdamW lr 3e-4 / wd 0.1)
on one card at batch 4 x 2048 and on the mesh at dp 4 and dp 2 x mp 2
(4 x 2048 a data rank), and at cp 4 (ring) on 2 x 16384 (the
long_seq_16k shapes). Each mesh runs in a world of fresh processes.
Prints one JSON line a check and, last, ``{"ok": true, ...}``; any
failure raises and the run exits non-zero. Rank 0 appends every line to
``--out`` (default ``torch_dist_drill.jsonl`` in the working directory).
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
MESHES = [("dp2_mp2", dict(dp=2, mp=2), None, "ring"),
          ("dp4", dict(dp=4), None, "ring"),
          ("cp2_dp2_ring", dict(cp=2, dp=2), None, "ring"),
          ("cp2_dp2_ulysses", dict(cp=2, dp=2), None, "ulysses"),
          ("sdp4_os_g", dict(sharding=4), "os_g", "ring"),
          ("sdp4_p_g_os", dict(sharding=4), "p_g_os", "ring")]
PARITY = {"card": dict(vocab_size=4096, hidden_size=512,
                       intermediate_size=1408, num_hidden_layers=2,
                       num_attention_heads=8, num_key_value_heads=4,
                       max_position_embeddings=512),
          "cpu": dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=64)}
PARITY_BATCH = {"card": (8, 256), "cpu": (4, 32)}
BIG = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
           num_hidden_layers=20, num_attention_heads=16,
           num_key_value_heads=16)
TIMED = [("one_card", None, None, (4, 2048)),
         ("dp4", dict(dp=4), None, (16, 2048)),
         ("dp2_mp2", dict(dp=2, mp=2), None, (8, 2048)),
         ("cp4_ring", dict(cp=4), None, (2, 16384))]
# seconds a rank may take for a job before it dumps its stacks and exits
PARITY_LIMIT_S, TIMED_LIMIT_S = 150, 300


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


def _parity(name, degrees, level, impl, size, device, log):
    """One mesh's three fp32 steps, eager and graphed, against TrainStep on
    the whole batch in this process."""
    import torch

    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.convert import shard_llama_state
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig(**PARITY[size], dtype="float32", cp_impl=impl)
    ids = _ids(cfg.vocab_size, PARITY_BATCH[size], 3, device)
    model = LlamaForCausalLM(cfg, device=device, generator=seed(5, device))
    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    step = TrainStep(model, _loss_fn, opt, graph=False)
    ref_losses = [float(step(ids, ids)) for _ in range(3)]
    ref = {n: p.detach().clone() for n, p in model.named_parameters()}
    del model, opt, step
    graphs = [False, True] if device == "cuda" else [False]
    out = {"mesh": name, "degrees": degrees, "zero": level, "impl": impl}
    got = {}
    env = pdist.init_mesh(**degrees)
    for graph in graphs:
        model = LlamaForCausalLM(cfg, device=device,
                                 generator=seed(5, device))
        model.load_state_dict(shard_llama_state(full, env))
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
        if level:
            model, opt = pdist.group_sharded_parallel(model, opt,
                                                      level=level)
        step = pdist.ShardedTrainStep(model, _loss_fn, opt, graph=graph)
        losses = [float(step(ids, ids)) for _ in range(3)]
        state = pdist.sharding.gather_full_state(model)
        mode = "graph" if graph else "eager"
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                           ref_losses))
        param_err = max((state[n].float() - ref[n].float()).abs().max()
                        .item() for n in ref)
        update_err = max(((state[n] - ref[n]).float().norm() /
                          (ref[n] - full[n]).float().norm().clamp_min(1e-30))
                         .item() for n in ref)
        if loss_rel > LOSS_RTOL or update_err > UPDATE_RTOL:
            raise RuntimeError(f"{name} ({mode}): losses {losses} vs "
                               f"{ref_losses} (rel {loss_rel}), updates "
                               f"{update_err} off (max abs {param_err})")
        got[mode] = (losses, state)
        out[mode] = {"losses": losses, "loss_rel_err": loss_rel,
                     "update_rel_l2_err": update_err,
                     "param_max_abs_err": param_err}
        del model, opt, step
    out["reference_losses"] = ref_losses
    if "graph" in got:
        same = got["graph"][0] == got["eager"][0] and all(
            torch.equal(got["graph"][1][n], got["eager"][1][n])
            for n in got["eager"][1])
        if not same:
            raise RuntimeError(f"{name}: the graphed step differs from the "
                               f"eager one")
        out["graph_equals_eager"] = True
    _emit(dict(phase="parity", **out), log)


def _timed(name, degrees, level, batch, log, card):
    """The graphed bf16 1.16B step on the mesh (or one card alone): step ms
    of 5 replays after warm-up and capture, tokens/s a card."""
    import torch

    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig(**BIG, max_position_embeddings=max(2048, batch[1]),
                      dtype="bfloat16", use_recompute=True)
    if degrees:
        pdist.init_mesh(**degrees)
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
    _emit({"phase": "timed", "mesh": name, "card": card,
           "degrees": degrees, "zero": level, "global_batch": list(batch),
           "losses": losses, "step_ms": ms,
           "tokens_per_s_per_card": tokens / (min(ms) / 1e3) / world,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}, log)


def _rank(out, cpu, card, job):
    """One job (a parity mesh or a timed one) in a world of its own, so a
    mesh starts from fresh processes and groups, and the process exits
    without destroying them (on four H100s, torch 2.11, destroying an NCCL
    subgroup that ran collectives hung: ROADMAP Queue 3). A rank that has
    not finished after ``limit`` seconds prints every thread's stack and
    exits, which ends the world (a hung collective fails the drill, not
    the machine)."""
    import faulthandler

    import torch

    from paddle_tpu_torch import distributed as pdist

    kind, spec, limit = job
    faulthandler.dump_traceback_later(limit, exit=True)
    pdist.init_parallel_env(backend="gloo" if cpu else "nccl",
                            timeout=datetime.timedelta(seconds=limit))
    if cpu:
        torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    log = []
    if kind == "parity":
        name, degrees, level, impl = spec
        _parity(name, degrees, level, impl, "cpu" if cpu else "card",
                "cpu" if cpu else "cuda", log)
    else:
        _timed(*spec, log, card)
    if pdist.get_rank() == 0:
        with open(out, "a") as f:
            for row in log:
                f.write(json.dumps(row) + "\n")
    pdist.barrier()
    sys.stdout.flush()
    os._exit(0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="gloo processes on the CPU at a tiny size")
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--out", default="torch_dist_drill.jsonl")
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
    if not a.cpu:
        jobs += [("timed", t, TIMED_LIMIT_S) for t in TIMED]
    t0 = time.perf_counter()
    for job in jobs:
        pdist.spawn(_rank, args=(a.out, a.cpu, card, job), nprocs=world)
    print(json.dumps({"ok": True, "world": world, "card": card,
                      "backend": "gloo" if a.cpu else "nccl",
                      "jobs": len(jobs),
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
