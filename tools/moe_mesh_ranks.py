"""One rank of the MoE Llama at dp 2 x ep 2 on one card, for
``chip_smoke.py``'s ``moe-mesh`` phase (b) and (c).

Four processes on the one card, joined by gloo over a file store in place
of NCCL (NCCL refuses two ranks on one device; gloo's CUDA path has the
all-reduce, the one collective the MoE step over dp x ep needs). Each rank
builds the MoE Llama at the flagship's width (``bench.py:1864-1872``:
hidden 1536, 8 experts top-2, intermediate 2048, vocab 32000) at the depth
given, in fp32, from the seed, takes the ``index`` dispatch and Adafactor
lr 1e-2, and runs three ``ShardedTrainStep`` steps over the global batch
(graph off: gloo is not captured). It also runs the same model unsharded
(``jit.TrainStep``, no mesh) on the same batch and holds its own shards
to that run: every loss, and each parameter's difference over its update
``||p - ref|| / ||ref - init||``. Then the same with each planted fault:
``per_rank_capacity`` (each rank's capacity and places from its own
tokens) and ``per_rank_aux`` (the aux from its own tokens). The
parameters are held after the first step: from the second on, a token
whose top choices are within rounding of a tie may route otherwise in
the two runs (their expert products round differently), and an expert
with few tokens then moves by a share of its update (both readings are
written). Writes ``rank<r>.json`` under ``--out``.

    python3 tools/moe_mesh_ranks.py --rank R --world 4 --store FILE \\
        --out DIR [--layers 2] [--seed 0] [--cpu]

``--cpu`` rehearses it on the CPU at a tiny width (hidden 64, intermediate
128, vocab 128, batch 4 x 32).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

MOE = dict(vocab_size=32000, hidden_size=1536, intermediate_size=2048,
           num_attention_heads=12, num_key_value_heads=12,
           max_position_embeddings=2048, num_experts=8, top_k=2,
           capacity_factor=1.25)
BATCH = (4, 2048)
TINY = dict(MOE, vocab_size=128, hidden_size=64, intermediate_size=128,
            num_attention_heads=4, num_key_value_heads=4)
TINY_BATCH = (4, 32)
STEPS = 3
FAULTS = ("per_rank_capacity", "per_rank_aux")


class Planted:
    """Swaps module attributes of the MoE layer for a planted fault's
    while open (also the CPU tests' faults): ``per_rank_capacity``
    (each rank's capacity and places from its own tokens),
    ``per_rank_aux`` (the aux from its own tokens), ``cp_block_order``
    (under cp, each rank's tokens placed as one contiguous block of the
    global order, where the reference interleaves the cp chunks row by
    row); any other name
    swaps nothing."""

    def __init__(self, fault, n_data):
        from paddle_tpu_torch.nn.layer import moe

        self.moe, self.saved = moe, {}
        if fault == "per_rank_capacity":
            cap, pos = moe._capacity, moe.capacity_positions
            self.swaps = {
                "_capacity": lambda n, e, k, cf: cap(n // n_data, e, k, cf),
                "capacity_positions": lambda gi, e, *a: pos(gi, e)}
        elif fault == "cp_block_order":
            pos = moe.capacity_positions
            self.swaps = {
                "capacity_positions":
                    lambda gi, e, data, nb, dr, rows=1, cp=1, cr=0: pos(
                        gi, e, data, nb * cp, dr * cp + cr)}
        elif fault == "per_rank_aux":
            self.swaps = {"_global_aux": lambda mesh: moe.router_aux}
        else:
            self.swaps = {}

    def __enter__(self):
        for k, v in self.swaps.items():
            self.saved[k] = getattr(self.moe, k)
            setattr(self.moe, k, v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.moe, k, v)


def _model(widths, layers, seed, device):
    from paddle_tpu_torch.device import seed as pt_seed
    from paddle_tpu_torch.models import LlamaForCausalLM, LlamaMoEConfig

    cfg = LlamaMoEConfig(**widths, num_hidden_layers=layers, dtype="float32",
                         use_recompute=True)
    return LlamaForCausalLM(cfg, device=device,
                            generator=pt_seed(seed, device))


def _run(step, ids, model):
    """Every loss, and the model's state after the first step."""
    losses, first = [], None
    for _ in range(STEPS):
        losses.append(float(step(ids, ids)))
        if first is None:
            first = {k: v.detach().clone()
                     for k, v in model.state_dict().items()}
    return losses, first


def _worst(state, ref, init):
    """(largest ||p - ref|| / ||ref - init|| over the tensors, its name)."""
    worst, where = 0.0, None
    for k, v in state.items():
        r, b = ref[k], init[k]
        rel = float((v.float() - r.float()).norm() /
                    (r.float() - b.float()).norm().clamp_min(1e-30))
        if rel > worst:
            worst, where = rel, k
    return worst, where


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch import kernels, set_flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.convert import shard_llama_state
    from paddle_tpu_torch.optimizer import Adafactor

    dev = "cpu" if a.cpu else "cuda"
    widths, batch = (TINY, TINY_BATCH) if a.cpu else (MOE, BATCH)
    if not a.cpu:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(0)
    set_flags({"FLAGS_moe_dispatch": "index"})
    store = torch.distributed.FileStore(a.store, a.world)
    pdist.init_parallel_env(backend="gloo", store=store, rank=a.rank,
                            world_size=a.world)
    gen = torch.Generator(device=dev)
    gen.manual_seed(a.seed + 61)
    ids = torch.randint(0, widths["vocab_size"], batch, generator=gen,
                        device=dev)

    def loss_fn(m, x, y):
        return m(x, labels=y)

    # the unsharded step, the reference
    ref_model = _model(widths, a.layers, a.seed + 61, dev)
    init = {k: v.detach().clone() for k, v in ref_model.state_dict().items()}
    ref_losses, first = _run(TrainStep(ref_model, loss_fn, Adafactor(
        learning_rate=1e-2, parameters=ref_model.parameters()), graph=False),
        ids, ref_model)
    final = {k: v.detach().clone() for k, v in ref_model.state_dict().items()}
    del ref_model
    if not a.cpu:
        torch.cuda.empty_cache()

    out = {"rank": a.rank, "ref_losses": ref_losses, "runs": {}}
    for fault in (None,) + FAULTS:
        env = pdist.init_mesh(dp=2, ep=2)
        mine_init = shard_llama_state(init, env)
        mine_first = shard_llama_state(first, env)
        mine_final = shard_llama_state(final, env)
        with Planted(fault, env.size_over(("dp", "sdp"))):
            model = _model(widths, a.layers, a.seed + 61, dev)
            same_init = all(torch.equal(v, mine_init[k]) for k, v in
                            model.state_dict().items())
            step = pdist.ShardedTrainStep(model, loss_fn, Adafactor(
                learning_rate=1e-2, parameters=model.parameters()),
                graph=False)
            kernels.reset_counters()
            losses, mine = _run(step, ids, model)
            if fault is None:  # the launches of the sound run
                out["counters"] = kernels.counters()
        worst, where = _worst(mine, mine_first, mine_init)
        last, last_where = _worst(model.state_dict(), mine_final, mine_init)
        out["runs"][fault or "sound"] = {
            "losses": losses, "same_init": same_init,
            "loss_rel": max(abs(x - y) / abs(y)
                            for x, y in zip(losses, ref_losses)),
            "param_rel": worst, "param_rel_where": where,
            "param_rel_after_last": last, "param_rel_after_last_where":
                last_where,
            "shapes": {k: list(v.shape) for k, v in model.state_dict().items()
                       if ".experts." in k and ".layers.0." in k}}
        del model, step, mine
        if not a.cpu:
            torch.cuda.empty_cache()
        pdist.reset_mesh()
    with open(os.path.join(a.out, f"rank{a.rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
