#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure, so the process exits non-zero and prints no
``ok`` line):

1. device  — card name and power limit; TF32 off for matmuls and cuDNN.
2. build   — builds the CUDA kernels from ``paddle_tpu_torch/kernels/csrc``.
3. kernels — each kernel at its path's shapes (and at odd shapes) against
             its plain PyTorch version on the same inputs, with times of the
             kernel, the plain version and a PyTorch library call where one
             computes the same function (a yardstick the port never calls),
             and the least time the card could take (bound). The
             tensor-core flash forward, dK/dV and dQ kernels (bf16, head
             dim 128) are held to the bound of their bf16 roundings of P
             and dS and timed beside the CUDA-core kernels on the same
             inputs; the fp32 cases run the 3xTF32 forward, dK/dV and dQ
             (fp32 at head dims that are multiples of 8 up to 128), held to
             the fp32 tolerances and timed beside the CUDA-core kernels.
             The single-row split-K decode kernel is timed eager and in
             CUDA-graph replay beside the CUDA-core kernel and SDPA
             (both ways too) at bh 32 x 640 keys and at serving's
             generate (bh 64 x 100), and checked at odd cases (2047 keys,
             fp32, head dim 64, a causal cut, a row that sees no key, one
             key, a strided paddle-layout q and an unaligned one). Paged
             attention runs the kernel its route names (split-K decode at
             W = 1, the tensor-core window kernel for bf16 windows, the
             general kernel for fp32 windows), checked to that kernel's
             tolerance and timed beside the general kernel, at the
             serving shapes and at odd ones (W 5 and 130, GQA, 1- and
             64-key contexts). The RMSNorm backward and (phase 8) the
             MoE routing are timed eager and in graph replay beside the
             earlier kernels on the same inputs (``earlier_ms``,
             ``earlier_graph_ms``) and a copy of the bytes their bound
             counts.
4. parity  — fp32, GPT-3 6.7B width at depth 2: the engine's greedy tokens
             (split-K decode kernel, the general kernel for the prefill
             windows) equal ``model.generate``'s (flash kernels: its
             single-row steps on the split-K flash decode kernel, counted
             exactly), and its logprobs match a teacher-forced forward.
5. serving — bf16, full 32-layer GPT-3 6.7B with random weights: an engine
             with 8 slots answers 16 requests (half share a 256-token
             prefix), then ``model.generate`` decodes two prompts; the
             kernels' counters are reset before and read after, exactly:
             every layer of every prefill window on the tensor-core paged
             kernel, of every decode step on the split-K decode kernel,
             none on the general one; generate's prefill on the
             tensor-core flash kernel and its single-row steps on the
             split-K decode kernel, none on the CUDA-core one; no plain
             version run. Every answer is then checked against the
             model's own forward, and the same check must fail on answers
             served with each of three faults planted in the
             paged-attention wrapper, and on generate's tokens with a
             fault planted in the flash decode route (each step sees only
             its first split's keys). A profiled generate gives its
             device time by kernel group.
5b. serving-tier — the single-process serving tier on a fresh GPT-3
             6.7B (bf16, random weights, the serving phase's engine
             config), each part with its kernels' launches exact (no plain
             call) and every answer checked against the model's own
             forward: (a) speculative decoding with a GPT-3 Small draft
             (12 x 768, d_head 64), k 4, over the serving phase's 16
             requests: proposals, acceptances, rounds, tokens/s, round ms,
             TTFT; every verify window on the tensor-core paged kernel
             (W = 5), every draft prefill on the tensor-core flash kernel;
             a planted fault (proposals taken unverified) must fail the
             check; (b) the model as its own draft, speculation switched
             off mid-stream (the later rounds on the split-K decode
             kernel); (c) ``swap_weights`` to a second seeded model while
             requests are in flight: they finish on the first weights, the
             later ones run the second (each set fails against the other
             model), ``weight_version`` 2; (d) a 512-token prompt's pages
             exported from one engine and installed into another over the
             bf16 wire (continuation bit for bit the uninterrupted
             engine's, from a 31-block prefix hit) and the int8 wire; (e)
             a 240-page pool with the int8 host tier: the evicted prompt's
             pages spilled and restored, each within its int8 step (plus
             bf16's rounding) of the original; (f) ``ServingEngine`` over
             a callable on the model's forward (argmax and log-probability
             a position), buckets (1, 2, 4, 8) x (128, 256, 512), 32
             concurrent requests: QPS, latency, occupancy, no runner built
             after warm-up, each answer against the model alone; (g)
             ``ReplicaRouter`` over two engines sharing the weights, two
             tenants (one at a quota of 4), a replica marked down mid-run
             and its queued requests resubmitted to the other.
5c. serving-fleet — ``ServingFleet`` over GPT-3 6.7B replica processes on
             the one card (``build_fleet_replica``: bf16, random weights
             from one seed, the serving engine config, a GPT-3 Small draft
             at k 4), nothing of the model held by this process meanwhile:
             (c) r0's first submit deferred 3 s (``replica_slow``), the
             request hedged onto r1, the loser cancelled; (b) the serving
             mix's 16 requests with r1 crashing at its third submit
             (``replica_crash@name=r1&seq=3&inc=0``): every request
             complete, each stream exactly its answer's tail, r1 fenced,
             restarted and serving again, and a planted stitch that
             re-appends the replayed tokens failing the stream check; (a)
             16 more on the healthy pair: spawn -> ready, tokens/s, TTFT,
             routing; (d) a low-priority burst past replica_capacity:
             stage 3, speculation off on both replicas, a shed, a clamped
             budget, then stage 0; (e) prefill -> decode pools without a
             draft: each prompt's pages shipped over the frames, fp32
             transit bit for bit against a lone engine on the same two
             legs, one request over int8. Each live replica's launches
             are read over its ``telemetry`` op and held exactly; every
             answer is checked against the model's own forward once the
             replicas are gone.
6. train-parity — fp32, the 1.16B Llama's width at depth 2, batch 2 x 512:
             one step's loss and every parameter gradient through the
             kernels against the same step with each kernel wrapper swapped
             for its plain version (the optimizer's too), then a 3-step
             AdamW loss curve of both, and a 3-step curve of the finetune
             recipe (LinearWarmup + ClipGradByGlobalNorm(1.0) + AdamW)
             with the optimizer's launches counted exactly.
7. train   — bf16, the 1.16B Llama at full width and depth (20 layers,
             recompute), AdamW lr 3e-4 / wd 0.1, batch 4 x 2048: one step's
             gradients through the kernels against the plain-swapped step
             (and three planted backward faults that the check must
             catch, one the inverse RoPE reading its strided cotangent as
             if it were contiguous),
             then several eager steps (``TrainStep(graph=False)``) on one
             batch with the counters reset before and read after (each
             kernel's launches per step as reckoned from the code: every
             flash forward, dK/dV and dQ on the tensor-core kernels, none
             on the CUDA-core ones; no plain call; AdamW's update one
             fused launch a step), a falling finite loss, step time,
             tokens/s, MFU, peak memory and a profiled step. Then the main
             path, the graphed step (one CUDA graph replay a step), from
             the same weights and batch: losses, parameters and AdamW
             state against the eager run bit for bit, launches reckoned
             as the captures' counts plus
             the counts per replay times the replays, the capture's debug
             dump node by node against the launches reckoned per step (no
             CUDA-core attention node), a planted stale table header
             (replays that keep the first replay's step) that the check
             must catch, the graphed and eager figures side by side with
             PR 10's, the same at the bench's batch 16, and
             ``TrainStep.accumulate(2)`` at batch 8 against the eager
             recipe with fp32 accumulation. Then the same graphed step
             under each of the eight other optimizer rules (SGD, Momentum,
             Adagrad, Adamax, RMSProp, Adadelta, Lamb, LarsMomentum; a
             halving LR schedule), each against its own three eager steps
             bit for bit, with its launches, graph nodes, stale-header
             fault, step ms, the optimizer's device ms and peak memory;
             and three eager AdamW steps under ``GradScaler`` (2**16)
             against three unscaled ones bit for bit, then two with an
             inf and a NaN planted into a gradient, both skipped with
             everything unchanged and the scale and counters as the
             reference's state machine moves them.
   optimizer — the fused optimizer's kernels over the dense model's full
             parameter set, bf16 (AdamW, and with ClipGradByGlobalNorm):
             against their plain versions (99.9% of p, m, v bit for bit,
             one ulp at most; two runs the same bits), timed eager and in
             graph replay beside their bounds and
             torch.optim.AdamW(fused=True), and with fp32 gradients beside
             the bf16 parameters (the sums of ``TrainStep.accumulate``);
             then in fp32 on the first
             tensors, with three planted faults (no bias correction, the
             decoupled decay dropped, the clip scale ignored) that the
             check must catch.
   rules   — the kernels of the eight other rules and of the unscale
             (check_finite, unscale) over the dense model's full parameter
             set, bf16: against their plain versions in every bit, timed
             eager and in graph replay beside their bounds, the plain
             versions and the torch.optim call that computes the same rule
             (or a neighbour; none for Lamb and LARS); the finiteness
             check clean and with a planted inf and NaN; then fp32 on the
             first tensors, every bit, with planted faults that the check
             must catch. ``make_master_update`` (AdamW over fp32 masters
             of the same set): kernel against plain in every bit, timed.
8. moe-kernels — the MoE path's kernels (routing, row gather, combine,
             grouped GEMM forward, dgrad and wgrad) at the MoE step's shapes
             (timed, with bound and yardstick) and at odd shapes (token
             counts that no block divides, an expert with no row and one
             with one row, top_k 1 and 8, 128 experts) against their plain
             versions; bf16 runs the tensor-core grouped GEMM, timed beside
             the CUDA-core one on the same inputs, and fp32 the CUDA-core
             one.
9. moe-train-parity — fp32, the 1.46B MoE Llama's width at depth 2, batch
             2 x 512, fused dispatch: one step's loss and every gradient
             through the kernels against the plain-swapped step, then a
             3-step Adafactor loss curve of both.
10. moe-train — bf16, the 1.46B MoE Llama (DeepSeekMoE-style, 8 experts,
             top-2) at full width and depth (16 layers, recompute),
             Adafactor lr 1e-2, batch 4 x 2048: full-depth gradients
             against the plain-swapped step, which replays the routing
             kernel's top-k picks so that no near-tie routes a token
             elsewhere, with four planted faults that the check must catch
             (routing without its cross-block base, a grouped GEMM forward
             and a wgrad that drop each group's last partial row tile, the
             combine backward's scaled gather without its scale);
             then eager steps with the
             counters reset before and read after (exact launches, every
             grouped GEMM on the tensor-core kernels, no plain
             call; Adafactor one stats and one update call a step), a
             falling finite loss, step time, tokens/s, MFU on activated
             FLOPs, peak memory and a profiled step; then the graphed step
             as for the dense model (no CUDA-core grouped GEMM node), at
             batch 4 and at the bench's batch 8.
   optimizer — Adafactor's two kernels over the MoE model's full parameter
             set, as for AdamW above (no library call computes its rule;
             fp32 gradients too), with a planted fault: the update's RMS
             clip dropped.

After the serving phase (its engine freed first):

gpt-train — bf16, GPT-3 6.7B at full width and depth (32 layers,
             recompute), AdamW lr 3e-4 / wd 0.1, ids as labels, batch 2 x
             2048: full-depth gradients against the plain-swapped step,
             with three planted faults (dQ or dK without the softmax
             scale, dK and dV swapped) that the check must catch; then
             eager steps and the graphed step on one optimizer, each with
             its launches exact (2L flash forwards, L dK/dV, L dQ, one
             ``adam_update``; the graph's as reckoned and as kernel nodes),
             a finite falling loss, step ms, tokens/s, MFU = (6N + 12 L h
             s) x tokens/s / 989e12, peak memory, device ms by group and
             idle share beside the card's name and power limit. The
             graphed step again with dropout 0.1 in both places: step ms
             and peak memory (recompute keeps no mask: one generator
             rewind a layer). Graph = eager bit for bit at 8 of the 32
             layers (a copy of the full
             weights does not fit beside the moments), with the node check
             and the stale-header fault.
gpt-dropout — the same width at 2 layers with dropout 0.1 in attention
             and on the residuals: every mask's keep share within 4 sigma
             of 0.9, each recomputed layer's masks equal to its first
             run's, replays at learning rate 0 drawing fresh masks (and
             none with p = 0), the graphed step equal to the eager one
             from the same weights and generator state, bit for bit.

After the MoE phases:

moe-modes — the MoE Llama at full width and depth 2, bf16: ``index``
             and ``einsum`` on each MoE layer's inputs agree (output, aux,
             every gradient) within MOE_MODES_TOL (``sort`` runs
             ``index``); no MoE kernel runs.
llama-cache — the 1.16B Llama's attention at full width: one token over a
             2047-token cache runs the split-K decode kernel once and
             equals the last row of the uncached causal call.
adafactor_1p8b, long_seq_16k — the bench's configurations (bench.py
             _configs() "big_1p8" with Adafactor at batch 4 x 2048, and
             "long16k" with AdamW at batch 2 x 16384) as eager and graphed
             steps with the dense line's figures; before the 16384-token
             step the flash forward, dK/dV, dQ and RoPE are held to their
             plain versions at that length (bh 1).

distributed — the distributed slice on one card: (a) a world-1 NCCL
             group (a FileStore in a temporary directory) and every port
             collective over it on CUDA tensors, fp32 and bf16; (b)
             ``ShardedTrainStep`` under ``group_sharded_parallel(level=
             "os_g")`` on the 1.16B Llama step (bf16, recompute, AdamW,
             4 x 2048) against ``jit.TrainStep``: three steps' losses and
             every parameter bit for bit, eager and graphed, step ms side
             by side and the graph nodes the sharded step adds; (d) the
             flash forward, dK/dV and dQ kernels (bf16 tensor-core; fp32
             3xTF32) at the ring's offsets (a chunk wholly in the
             future: o = 0, lse = -1e30, zero gradients exactly; the
             diagonal; wholly in the past; odd lengths; a nonzero lse
             cotangent) against their plain versions; (c) the ring and
             Ulysses at the long_seq_16k shapes (b 2, 16 heads, 16384,
             cp 4), the cp shards driven through the port's per-rank body
             on the one card, held head by head to the plain version
             within the tensor-core bounds, their distance from one-shot
             flash reported, launches exact (cp^2 / cp per kernel), forward
             + backward ms beside one-shot flash's; (e) two planted ring
             faults in fp32 (a merge that drops a step, an offset one tile
             off) that the check must catch.
pipeline   — (a) the Llama at Llama-2 7B's widths, depth cut to 4, in 4
             stages on the one card through ``pipeline_local``
             (``tools/pipeline_harness.py``'s ``LocalPipelineStep``):
             bf16, recompute, AdamW, M = 8 microbatches of 1 x 4096, two
             steps eager and two graphed, equal bit for bit, launches
             reckoned exactly, losses and parameters equal bit for bit to
             the pp = 1 model's ``TrainStep.accumulate(8)``, step ms and
             peak memory beside it; (a') its fp32 twin at 2 layers in 2
             stages, gradients within PIPE_GRAD_TOL of the pp = 1 model's,
             and two planted faults (an activation gradient dropped at the
             boundary, one stage's microbatches reversed) that must fail
             it; (b) on the 1.16B step over a world-1 NCCL group, graphed:
             ``ShardedTrainStep(scaler=)`` with an inf planted in step 2's
             gradient against the eager ``GradScaler`` loop (losses,
             parameters, the skip, the halved scale, the update count, bit
             for bit), ``accum_steps=2`` over two calls and
             ``accumulate(2)`` against ``TrainStep.accumulate(2)`` bit for
             bit; (c) a checkpoint round trip of the model and its AdamW
             state: the resumed step equals the unbroken one bit for bit,
             save and load GB/s.
offload    — optimizer offload over a world-1 NCCL group, ZeRO os_g,
             graphed, AdamW lr 3e-4 / wd 0.1 under ClipGradByGlobalNorm
             (1.0): (a) the 1.16B Llama in fp32 at 2 x 2048, three
             offloaded steps (the lane overlapped and serialized, and under
             ``accumulate(2)``) equal to the resident step bit for bit, and
             a planted fault (one group's state download skipped) that
             must differ; (b) the same model in bf16 at 4 x 2048, resident
             against offloaded (the lane overlapped and serialized): step
             ms, peak device GiB, pinned host GiB, the lane's bytes and
             ``overlap_efficiency``; (c) Llama-2 13B at full width (depth
             cut to what ``MemAvailable`` holds beside HOST_SPARE, at 12
             bytes a parameter, and to at most L13B_MAX_LAYERS), bf16, recompute, batch 1 x 4096, three
             steps on one batch with the optimizer offloaded: a finite
             falling loss under 80 GiB on the card, step ms, tokens/s,
             MFU, pinned host GiB, the lane's counters, the resident bytes
             reckoned, and the walk's launches exact (one ``adam_update``
             a group a step, one clip sum a step).

bert-finetune — BERT-base (Devlin et al. 2019: L 12, H 768, A 12, FFN 3072,
             vocab 30522; random weights from the seed) with a 2-class
             head, built on the paddle surface (``nn.Layer``, the op
             functions, ``F.cross_entropy``), the finetune recipe of
             ``examples/finetune_bert.py`` (AdamW 2e-5,
             ClipGradByGlobalNorm(1.0), CrossEntropyLoss, dropout 0.1,
             batch 32 x 128 of its surrogate sentences) through
             ``jit.TrainStep``: (a) fp32 graphed = eager for 3 steps, bit
             for bit, both under ``FLAGS_cudnn_deterministic`` (torch's
             CUDA embedding backward sums repeated ids with atomics; eager
             twice without it is reported beside); (b) 30
             graphed steps in fp32 and in bf16: step ms,
             tokens/s, device ms, idle share, peak GiB, losses, MFU
             against the dtype's peak (67 / 989 TFLOP/s); (c) ``eval()``
             without a mask: 12 flash forward launches a forward
             (``flash_fwd_tf32x3.cu`` in fp32, ``flash_fwd_sm90.cu`` in
             bf16),
             each call and the logits held against the plain versions, and
             a padded batch with ``attention_mask`` through the
             composition; (d) fp32 with dropout 0: one step's gradients
             through the flash forward and both backward kernels against
             the plain versions, with a planted dQ fault caught; then the
             flash forward (fp32 and bf16) and the fp32 backward timed at
             BERT's attention shape (bh 384, 128 x 128, d 64) beside SDPA
             and the CUDA-core kernels.

dit        — DiT-XL/2 (Peebles & Xie 2023 Table 1: 28 layers, hidden
             1152, 16 heads, patch 2, 32 x 32 x 4 latents; random weights
             from the seed, the adaLN-Zero parameters drawn non-zero),
             ``dtype="bfloat16"`` with fp32 inputs as ``bench.py``'s DiT
             row (so every activation is fp32 and attention runs the fp32
             flash kernels at head dim 72: the 3xTF32 forward, dK/dV and
             dQ), AdamW 1e-4 without
             decay, batch 32 (cut from 256), through ``jit.TrainStep``
             over ``GaussianDiffusion.training_loss``: (a) graph = eager
             for 2 steps bit for bit under ``FLAGS_cudnn_deterministic``,
             and a replay on the same batch drawing fresh t, noise and
             label drops; (b) 8 graphed calls then 3 eager steps: step ms,
             images/s, MFU (bench.py's FLOPs against 989 TFLOP/s, and
             against fp32's 67), peak GiB, device ms by group (SGEMM,
             flash, elementwise, AdamW), idle share, launches exact (28
             3xTF32 flash forwards, dK/dV and dQ, none on the CUDA-core
             flash kernels, one AdamW update a step), a
             finite falling loss; (c) ``ddim_sample``
             with 50 steps at eta 0, batch 8: images/s, 50 x 28 forward
             launches, two runs of one seed equal bit for bit, the first
             step's eps against the plain versions; (d) fp32 at depth 2:
             every gradient against the plain versions and a planted fault
             (a dQ kernel that reads only the first 64 of the 72 head dims)
             caught; then the three flash kernels at DiT's attention
             (fp32, bh 512, 256 x 256, d 72), eager and in graph replay,
             beside the CUDA-core kernels on the same inputs,
             SDPA in fp32 and the plain versions, with the bound at the
             3xTF32 rate (``bound_ms``) and at fp32's (``bound_fp32_ms``).
gpt-d96    — bf16 flash at head dims other than 64 and 128: GPT-3
             Large's widths (Brown et al. 2020 Table 2.1: 1536, 16 heads
             of 96) at 2 layers, bf16, recompute, batch 2 x 2048: one
             step's gradients against the plain-swapped step, eager and
             graphed steps with exact launches (4 tensor-core forwards, 2
             dK/dV and 2 dQ at the padded head dim, no CUDA-core flash
             kernel, one AdamW update) and a falling loss; the same for
             the repo's Llama at Gemma 2B's widths (``llama-d256`` lines;
             Gemma Team 2024 Table 1: 2048, 8 heads of 256, 1 key/value
             head, feed-forward 16384 a half, vocabulary 256128) at 2 of 18
             layers, batch 2 x 2048: it is not Gemma (SwiGLU for GeGLU, no
             sqrt(d) embedding scale, an untied head); 4 tensor-core
             forwards and 2 dK/dV on the 64-key instances above 128, 2
             dQ on the 32-key ones, no CUDA-core flash kernel, the dense
             step's RMSNorm, RoPE and AdamW launches; step ms, tokens/s,
             MFU, device ms by group, idle share and peak GiB; then the
             kernels at GPT-3 Large's attention shape (bh 32, causal
             2048, d 96), at GPT-3 2.7B's (bh 64, d 80), at Gemma's head
             dim 256 (bh 16) and at 136 (bh 16), eager and in graph
             replay beside the CUDA-core kernels on the same inputs (at
             256 with rows of their own),
             SDPA and the plain versions; and five planted faults (the
             forward and dQ reading only the first 64 of d 96's columns,
             the forward, dK/dV and dQ the first 128 of d 256's) that each
             kernel's check against its plain version must catch.
resnet     — ResNet-18 with 10 classes on 32 x 32 surrogate images from
             the seed (``bench.py``'s CIFAR-10 stand-in), fp32, TF32 off:
             bench.py's 12-step curve (Momentum 0.01, batch 32) eager =
             graphed bit for bit under ``FLAGS_cudnn_deterministic``, with
             every BatchNorm buffer; then 20 graphed steps of Momentum 0.05
             / 0.9 at batch 128: step ms, images/s, peak GiB, device ms by
             group (cuDNN convolutions, BatchNorm moments, pooling,
             Momentum, elementwise), launches exact; ``resnet18(pretrained=
             True)`` raises.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the package beside the script, it exits non-zero.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

PEAK_BYTES_S = 3.35e12                     # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,          # dense tensor-core bf16
              "float32": 67e12,            # float32 outside the tensor cores
              # float32 on the tensor cores as three TF32 products a
              # product (3xTF32; TF32 dense at 495 TFLOP/s)
              "tf32x3": 495e12 / 3}
DEVICE = "cuda"
SEED = 0  # inputs and random weights are drawn from it
# serving check of the bf16 32-layer model against its own forward: about
# 3x the largest sound reading over all 16 requests and both generate rows
# (argmax gap 0.0625 = one bf16 ulp of logits in [8, 16), logprob 0.063);
# the planted faults read 1.0 and more
GAP_TOL, LP_TOL = 0.2, 0.2
FAULTS = ("shifted_tables", "unscaled", "first_split_only")


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def _time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _graph_ms(fn, iters=20, reps=5):
    """Device time of one call of ``fn``: ``iters`` calls captured in a CUDA
    graph, replayed ``reps`` times between CUDA events, so no host time is
    in it (the wrappers allocate from the graph's pool while it is
    captured). ``_time_ms``, the yardstick of every ``ms`` here, times the
    same calls as the host issues them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    del graph
    return t0.elapsed_time(t1) / (reps * iters)


def _release():
    """Free what a phase left: collect Python's reference cycles first (the
    serving engine is one, and holds its KV pool), so that the memory is
    returned now and a later phase's peak does not count it."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _bound(nbytes, flops, dtype_name):
    tb = nbytes / PEAK_BYTES_S * 1e3
    to = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# -- phase: kernels -----------------------------------------------------------

def _compare(name, out, ref, tol):
    """Elementwise |out - ref| <= rtol * |ref| + atol; returns the max abs
    and max relative error."""
    import torch

    rtol, atol = tol
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise RuntimeError(f"{name}: non-finite kernel output")
    diff = (out - ref).abs()
    excess = (diff - (rtol * ref.abs() + atol)).max().item()
    err = diff.max().item()
    if not excess <= 0:
        raise RuntimeError(f"{name}: error exceeds rtol {rtol} / atol {atol} "
                           f"by {excess} (max abs err {err})")
    return err, err / max(ref.abs().max().item(), 1e-30)


def _tol(dtype):
    """(rtol, atol) of a kernel against its plain version on fp32 copies of
    the same inputs. fp32: both sides compute in fp32 and differ only in
    summation order. bf16: the kernel rounds its fp32 result to bf16 once,
    at most half an ulp, which is 2**-8 of the value, plus fp32 order."""
    import torch

    return (0.0, 1e-4) if dtype == torch.float32 else (2.0 ** -8, 1e-4)


# the counter of each paged-attention route (``paged_attention.route``)
PAGED_COUNTERS = {"decode": "paged_attention_decode",
                  "sm90": "paged_attention_sm90",
                  "cuda_core": "paged_attention"}


def _paged_case(label, dtype, S, W, lengths, active, gen, kvh=32,
                timed=True):
    """Paged attention at one shape: lengths [S] window starts, `active`
    slots own real pages (the rest have all-zero tables, as in the engine);
    32 query heads, `kvh` kv heads. Records the route that ran and holds
    it to its tolerance: the single rounding of the decode kernel and PR
    1's kernel, ``sm90_paged_bound`` for the tensor-core window kernel;
    timed beside the general kernel, ``paged_attention.cu``, on the same
    inputs (``cuda_core_ms``)."""
    import torch
    import torch.nn.functional as TF

    from paddle_tpu_torch.kernels import counters, reset_counters
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_attention, paged_attention_cuda_core, paged_attention_plain,
        route, sm90_paged_bound)

    nh = 32
    hd, PL, B = 128, 16, 128
    P = 8 * B + 2 * B + 1
    dev = DEVICE
    q = torch.randn(S, W, nh, hd, generator=gen, device=dev).to(dtype)
    ka = torch.randn(P, PL, kvh, hd, generator=gen, device=dev).to(dtype)
    va = torch.randn(P, PL, kvh, hd, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P - 1, generator=gen, device=dev)[: S * B] + 1
    tables = torch.zeros(S, B, dtype=torch.int32, device=dev)
    for s in active:
        tables[s] = perm[s * B:(s + 1) * B].to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    pos = lens[:, None] + torch.arange(W, dtype=torch.int32, device=dev)
    scale = 1.0 / hd ** 0.5
    which = route(dtype, hd, W, nh // kvh, PL)
    kernel = PAGED_COUNTERS[which]

    reset_counters()
    out = paged_attention(q, ka, va, tables, pos, scale)
    torch.cuda.synchronize()
    ran = {n: c["launches"] for n, c in counters().items()
           if n in PAGED_COUNTERS.values()}
    if ran != {n: int(n == kernel) for n in PAGED_COUNTERS.values()}:
        raise RuntimeError(f"paged_attention[{label}]: route {which} but "
                           f"launches {ran}")
    f32 = (q.float(), ka.float(), va.float(), tables, pos, scale)
    ref = paged_attention_plain(*f32)
    if which == "sm90":
        bound = sm90_paged_bound(*f32, ref)
        err, share = _compare_bound(f"{kernel}[{label}]", out, ref, bound)
        tol = SM90_TOL
        del bound
    else:
        err, _rel = _compare(f"{kernel}[{label}]", out, ref, _tol(dtype))
        tol, share = _tol(dtype), None
    del ref, f32
    row = {"phase": "kernel", "kernel": kernel, "route": which,
           "case": label, "dtype": _dname(dtype), "S": S, "W": W,
           "nh": nh, "kvh": kvh, "max_abs_err": err, "tol": tol}
    if share is not None:
        row["bound_share_max"] = share
    if not timed:
        _emit(row)
        return row

    def call():
        return paged_attention(q, ka, va, tables, pos, scale)

    # CUDA events around eager calls, as every kernel is timed; and once
    # in CUDA-graph replay, the device time without the wrapper's host time
    ms, graph_ms = _time_ms(call), _graph_ms(call)
    plain_ms = _time_ms(lambda: paged_attention_plain(
        q, ka, va, tables, pos, scale), iters=5, warmup=1)
    # library yardstick: SDPA over the pre-gathered dense context with the
    # visibility mask (the gather itself is not timed)
    L = B * PL
    kd = ka[tables.long()].reshape(S, L, kvh, hd).transpose(1, 2)
    vd = va[tables.long()].reshape(S, L, kvh, hd).transpose(1, 2)
    qd = q.transpose(1, 2)
    mask = (torch.arange(L, device=dev)[None, None, :]
            <= pos[:, :, None])[:, None]

    def lib():
        return TF.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                               enable_gqa=kvh != nh)

    lib_ms = _time_ms(lib)
    del kd, vd
    _release()
    # least work: every distinct visible key position (page id, offset)
    # read once for K and V — idle slots' all-zero tables see the scratch
    # page's 16 keys, however often — q read, out written; 4*hd FLOPs per
    # visible (row, key) pair
    esz = q.element_size()
    vis_rows = torch.clamp(pos.long() + 1, min=0, max=L)         # [S, W]
    vis_slot = vis_rows.max(dim=1).values                        # [S]
    j = torch.arange(L, device=dev)
    keys = tables.long()[:, j // PL] * PL + j % PL               # [S, L]
    n_keys = keys[j[None, :] < vis_slot[:, None]].unique().numel()
    nbytes = (2 * n_keys * kvh * hd * esz
              + 2 * q.numel() * esz + tables.numel() * 4 + pos.numel() * 4)
    flops = 4 * hd * nh * int(vis_rows.sum())
    bound_ms, bound_by = _bound(nbytes, flops, _dname(dtype))
    row.update(distinct_keys=n_keys, kernel_ms=ms, graph_ms=graph_ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
               bound_by=bound_by, tflop_per_s=flops / ms / 1e9)
    if which != "cuda_core":
        # the general kernel on the same inputs
        row.update(cuda_core_ms=_time_ms(
            lambda: paged_attention_cuda_core(q, ka, va, tables, pos, scale),
            iters=5, warmup=1))
    _emit(row)
    return row


def _compare_bound(name, out, ref, bound):
    """Elementwise |out - ref| <= bound (the tensor-core kernels' bound from
    their bf16 roundings, ``sm90_fwd_bound`` / ``sm90_dkv_bound``); returns
    the max abs error and the largest share of the bound it reaches."""
    import torch

    out = out.float()
    if not torch.isfinite(out).all():
        raise RuntimeError(f"{name}: non-finite kernel output")
    diff = (out - ref).abs()
    excess = (diff - bound).max().item()
    if not excess <= 0:
        raise RuntimeError(f"{name}: error exceeds its bound by {excess} "
                           f"(max abs err {diff.max().item()})")
    return diff.max().item(), (diff / bound).max().item()


# the counter of each forward route (``flash_attention.route``)
FLASH_FWD_COUNTERS = {"sm90": "flash_attention_sm90",
                      "tf32x3": "flash_attention_tf32x3",
                      "cuda_core": "flash_attention",
                      "decode": "flash_attention_decode"}
# the tensor-core kernels' tolerance, as the rows record it
SM90_TOL = "2^-8|ref| + 2^-8 (P|V|, P^T|dO|, |dS^T||Q|, |dS||K|) + 1e-4"


def _flash_case(label, dtype, bh, sq, sk, causal, gen, d=128,
                cuda_core_row=False):
    """The forward at one shape against its plain version on fp32 copies
    of the same inputs, on the kernel ``route`` names. bf16 at a head dim
    that is a multiple of 8 up to 256 with sq > 1 runs the tensor-core
    kernel, held to its bound and timed eager and in graph replay beside
    the CUDA-core kernel on the same inputs (with ``cuda_core_row``, that
    kernel also gets a row of its own, held to one bf16 rounding: it runs
    on no main path now); fp32 at a head
    dim that is a multiple of 8 up to 128 the 3xTF32 kernel, held to 1e-4
    and timed eager and in graph replay beside the CUDA-core kernel, with
    its bound at the 3xTF32 rate (``bound_ms``) and at fp32's
    (``bound_fp32_ms``); the rest runs the CUDA-core kernel. Returns the
    row, or with ``cuda_core_row`` the list of both rows."""
    import torch
    import torch.nn.functional as TF

    from paddle_tpu_torch.kernels import counters, reset_counters

    fa = _flash_module()
    dev = DEVICE
    q = torch.randn(bh, sq, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(bh, sk, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(bh, sk, d, generator=gen, device=dev).to(dtype)
    off = sk - sq if causal else 0
    scale = 1.0 / d ** 0.5
    which = fa.route(dtype, d, sq)
    sm90 = which == "sm90"
    if cuda_core_row and not sm90:
        raise ValueError(f"{label}: a CUDA-core row beside route {which}")
    name = FLASH_FWD_COUNTERS[which]
    reset_counters()
    o, lse = fa.flash_attention_with_lse(q, k, v, off, causal, scale)
    torch.cuda.synchronize()
    if counters()[name]["launches"] != 1:
        raise RuntimeError(f"{name}[{label}]: not launched once")
    f32 = [t.float() for t in (q, k, v)]
    ro, rlse = fa.flash_attention_plain(*f32, off, causal, scale)
    if sm90:
        bound = fa.sm90_fwd_bound(*f32, off, causal, scale, ro)
        err, share = _compare_bound(f"flash_attention_sm90[{label}]", o, ro,
                                    bound)
        del bound
    else:
        err, _rel = _compare(f"{name}[{label}]", o, ro, _tol(dtype))
    lse_err, _ = _compare(f"{name}[{label}].lse", lse, rlse, (0.0, 1e-3))
    del ro, rlse, f32
    _release()
    ms = _time_ms(lambda: fa.flash_attention_with_lse(q, k, v, off, causal,
                                                      scale))
    plain_ms = _time_ms(lambda: fa.flash_attention_plain(
        q, k, v, off, causal, scale), iters=5, warmup=1)
    # library yardstick: torch's SDPA on [1, bh, s, d]; its is_causal is
    # top-left aligned, which equals ours for sq == sk, and sq == 1 at the
    # end of the cache sees every key
    lib_causal = causal and sq == sk
    lib_ms = _time_ms(lambda: TF.scaled_dot_product_attention(
        q[None], k[None], v[None], is_causal=lib_causal))
    esz = q.element_size()
    pairs = sum(min(sk, i + off + 1) for i in range(sq)) if causal \
        else sq * sk
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * esz + bh * sq * 4
    flops = 4 * d * bh * pairs
    bound_ms, bound_by = _bound(nbytes, flops, "tf32x3" if which == "tf32x3"
                                else str(dtype).split(".")[1])
    row = {"phase": "kernel", "kernel": name,
           "case": label, "dtype": str(dtype).split(".")[1], "bh": bh,
           "sq": sq, "sk": sk, "d": d, "causal": causal, "max_abs_err": err,
           "lse_max_abs_err": lse_err,
           "tol": SM90_TOL if sm90 else _tol(dtype), "kernel_ms": ms,
           "tflop_per_s": flops / ms / 1e9, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    if sm90:
        # graph replay, and the CUDA-core kernel on the same inputs
        row.update(bound_share_max=share, graph_ms=_graph_ms(
            lambda: fa.flash_attention_fwd_sm90(q, k, v, off, causal,
                                                scale)),
            cuda_core_ms=_time_ms(
            lambda: fa.flash_attention_fwd_cuda_core(q, k, v, off, causal,
                                                     scale), iters=5,
            warmup=1))
    if cuda_core_row:
        # the CUDA-core kernel on the same inputs, checked as its own route
        # checks it
        co, cl = fa.flash_attention_fwd_cuda_core(q, k, v, off, causal,
                                                  scale)
        torch.cuda.synchronize()
        ro, rlse = fa.flash_attention_plain(*[t.float() for t in (q, k, v)],
                                            off, causal, scale)
        core = dict(row, kernel="flash_attention", tol=_tol(dtype),
                    kernel_ms=row["cuda_core_ms"],
                    tflop_per_s=flops / row["cuda_core_ms"] / 1e9,
                    max_abs_err=_compare(f"flash_attention[{label}]", co, ro,
                                         _tol(dtype))[0],
                    lse_max_abs_err=_compare(f"flash_attention[{label}].lse",
                                             cl, rlse, (0.0, 1e-3))[0])
        for key in ("cuda_core_ms", "graph_ms", "bound_share_max"):
            core.pop(key, None)
        del co, cl, ro, rlse
        _release()
    if which == "tf32x3":
        # graph replay (no host time), PR 1's CUDA-core kernel on the same
        # inputs, and the bound at fp32's rate on the CUDA cores
        row.update(
            graph_ms=_graph_ms(lambda: fa.flash_attention_fwd_tf32x3(
                q, k, v, off, causal, scale)),
            cuda_core_ms=_time_ms(lambda: fa.flash_attention_fwd_cuda_core(
                q, k, v, off, causal, scale), iters=5, warmup=1),
            bound_fp32_ms=_bound(nbytes, flops, "float32")[0])
    _emit(row)
    if cuda_core_row:
        _emit(core)
        return [row, core]
    return row


def _flash_decode_case(label, dtype, b, h, sk, d, offset, causal, gen,
                       layout="cache", timed=False):
    """The split-K decode kernel at one query row per (batch, head), paddle
    layout: q [b, 1, h, d] against a cache k, v [b, sk, h, d], through
    ``flash_decode`` (o and lse) or, for ``layout`` "qkv_view" (q a view
    into a fused QKV tensor, as a decode step makes it) and "unaligned_q"
    (q one element off a 16-byte boundary), through the paddle-layout
    ``flash_attention`` under inference mode (o only). Held to one rounding
    of o and 1e-3 of lse against ``flash_attention_plain`` on fp32 copies;
    a row that sees no key must give o = 0 and lse = -1e30 exactly. Timed
    eager and in CUDA-graph replay beside the CUDA-core kernel
    (``flash_attention_fwd_cuda_core``) and torch's SDPA on the same
    inputs in [bh, s, d] (copied there once, outside the timing)."""
    import torch
    import torch.nn.functional as TF

    from paddle_tpu_torch.kernels import counters, reset_counters
    from paddle_tpu_torch.kernels.flash_attention import flash_attention

    fa = _flash_module()
    scale = 1.0 / d ** 0.5
    q, k, v = (_rand(gen, (b, s, h, d), dtype) for s in (1, sk, sk))
    if layout == "qkv_view":
        q = torch.stack([q, k[:, :1], v[:, :1]], dim=2)[:, :, 0]
    elif layout == "unaligned_q":
        flat = torch.empty(q.numel() + 1, dtype=dtype, device=DEVICE)
        q = flat[1:].view(q.shape).copy_(q)

    def call():
        if layout == "cache":
            return fa.flash_decode(q, k, v, offset, causal, scale)
        with torch.inference_mode():
            return flash_attention(q, k, v, causal=causal, scale=scale), None

    reset_counters()
    o, lse = call()
    torch.cuda.synchronize()
    ran = {n: counters()[n]["launches"] for n in (
        "flash_attention_decode", "flash_attention", "flash_attention_sm90")}
    if ran != {"flash_attention_decode": 1, "flash_attention": 0,
               "flash_attention_sm90": 0}:
        raise RuntimeError(f"flash_attention_decode[{label}]: launches {ran}")

    def bhsd(t):
        return t.transpose(1, 2).reshape(b * h, t.shape[1], d).contiguous()

    qb, kb, vb = bhsd(q), bhsd(k), bhsd(v)
    ro, rl = fa.flash_attention_plain(qb.float(), kb.float(), vb.float(),
                                      offset, causal, scale)
    err, _rel = _compare(f"flash_attention_decode[{label}]", bhsd(o), ro,
                         _tol(dtype))
    row = {"phase": "kernel", "kernel": "flash_attention_decode",
           "case": label, "dtype": _dname(dtype), "b": b, "h": h, "sk": sk,
           "d": d, "offset": offset, "causal": causal, "layout": layout,
           "max_abs_err": err, "tol": _tol(dtype)}
    if lse is not None:
        row["lse_max_abs_err"] = _compare(
            f"flash_attention_decode[{label}].lse", lse.reshape(-1),
            rl.reshape(-1), (0.0, 1e-3))[0]
    if causal and offset < 0 and (o.any().item() or (
            lse is not None and not bool((lse == -1e30).all()))):
        raise RuntimeError(f"flash_attention_decode[{label}]: a row that "
                           f"sees no key gives o != 0 or lse != -1e30")
    del ro, rl
    if timed:
        def pr1():
            return fa.flash_attention_fwd_cuda_core(qb, kb, vb, offset,
                                                    causal, scale)

        # SDPA on [1, bh, s, d]: without a mask a row sees every key,
        # which is this row's view under causal at offset sk - 1
        if causal and offset != sk - 1:
            raise ValueError(f"{label}: SDPA times the whole cache")

        def lib():
            return TF.scaled_dot_product_attention(qb[None], kb[None],
                                                   vb[None])

        n = min(sk, max(0, offset + 1)) if causal else sk
        esz = q.element_size()
        nbytes = 2 * b * h * n * d * esz + 2 * b * h * d * esz + b * h * 4
        bound_ms, bound_by = _bound(nbytes, 4 * d * b * h * n, _dname(dtype))
        row.update(
            kernel_ms=_time_ms(call), graph_ms=_graph_ms(call),
            cuda_core_ms=_time_ms(pr1), cuda_core_graph_ms=_graph_ms(pr1),
            library_ms=_time_ms(lib), library_graph_ms=_graph_ms(lib),
            plain_ms=_time_ms(lambda: fa.flash_decode_plain(
                q, k, v, offset, causal, scale), iters=5, warmup=1),
            bound_ms=bound_ms, bound_by=bound_by,
            splits=list(fa.decode_plan(b * h, n, torch.cuda
                                       .get_device_properties(0)
                                       .multi_processor_count)))
    _emit(row)
    return row


def phase_kernels(seed):
    import numpy as np
    import torch

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    # bring the card to its working clocks before the first timing
    warm = torch.randn(8192, 8192, generator=gen, device=DEVICE,
                       dtype=torch.bfloat16)
    for _ in range(100):
        warm @ warm
    torch.cuda.synchronize()
    del warm
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        name = _dname(dtype)
        # decode: 8 slots, lengths spread over 1..2047
        lengths = np.sort(rng.integers(1, 2048, size=8))
        lengths[-1] = 2047
        rows.append(_paged_case(f"decode-{name}", dtype, 8, 1,
                                lengths.tolist(), range(8), gen))
        # prefill: one slot active, a 128-token suffix after a 256-token
        # cached prefix, and a cold 512-token prompt
        rows.append(_paged_case(f"prefill128-{name}", dtype, 8, 128,
                                [256] + [0] * 7, [0], gen))
        rows.append(_paged_case(f"prefill512-{name}", dtype, 8, 512,
                                [0] * 8, [0], gen))
        _release()
    bf = torch.bfloat16
    # decode at the serving run's mean context
    rows.append(_paged_case("decode370-bfloat16", bf, 8, 1, [370] * 8,
                            range(8), gen))
    # odd shapes, checked and not timed: windows of 5 and 130 rows, GQA
    # 32 / 8, one-key and 64-key contexts
    spread = np.sort(rng.integers(0, 2000, size=8)).tolist()
    for label, W, lens, active, kvh in (
            ("w5-gqa4", 5, spread, range(8), 8),
            ("w130", 130, [256] + [0] * 7, [0], 32),
            ("w5-64keys", 5, [59] * 8, range(8), 32),
            ("decode-gqa4", 1, spread, range(8), 8),
            ("decode-1key", 1, [0] * 8, range(8), 32),
            ("decode-64keys", 1, [63] * 8, range(8), 32)):
        rows.append(_paged_case(f"{label}-bfloat16", bf, 8, W, lens, active,
                                gen, kvh=kvh, timed=False))
    _release()
    for sq in (128, 512, 2048):
        rows.append(_flash_case(f"causal{sq}-bfloat16", torch.bfloat16, 32,
                                sq, sq, True, gen))
    # the training steps' shapes: dense batch 4 x 16 heads, MoE 4 x 12
    for bh in (64, 48):
        rows.append(_flash_case(f"train-bh{bh}-bfloat16", torch.bfloat16, bh,
                                2048, 2048, True, gen))
    rows.append(_flash_case("causal512-float32", torch.float32, 32, 512, 512,
                            True, gen))
    # the serving tier's draft prefill (GPT-3 Small: one prompt x 12 heads
    # of 64, padded to the prefill buckets)
    for sq in (128, 512):
        rows.append(_flash_case(f"draft-hd64-causal{sq}-bfloat16",
                                torch.bfloat16, 12, sq, sq, True, gen, d=64))
    # single-row decode, split-K: bh 32 at 640 keys and serving's generate
    # (two prompts x 32 heads, ~100 keys), timed; then odd cases, checked
    bf, f32 = torch.bfloat16, torch.float32
    for label, dtype, b, h, sk, d, off, causal, layout, timed in (
            ("decode1x640-bfloat16", bf, 2, 16, 640, 128, 639, True,
             "cache", True),
            ("decode64x100-bfloat16", bf, 2, 32, 100, 128, 99, True,
             "cache", True),
            ("decode1x640-float32", f32, 2, 16, 640, 128, 639, True,
             "cache", True),
            ("decode-sk2047-bfloat16", bf, 1, 32, 2047, 128, 2046, True,
             "cache", False),
            ("decode-hd64-bfloat16", bf, 2, 16, 640, 64, 639, True,
             "cache", False),
            ("decode-cut300-bfloat16", bf, 2, 16, 640, 128, 300, True,
             "cache", False),
            ("decode-nokey-bfloat16", bf, 2, 16, 64, 128, -1, True,
             "cache", False),
            ("decode-sk1-bfloat16", bf, 2, 16, 1, 128, 0, True, "cache",
             False),
            ("decode-qkv-view-bfloat16", bf, 2, 32, 100, 128, 99, True,
             "qkv_view", False),
            ("decode-unaligned-q-bfloat16", bf, 2, 32, 100, 128, 99, True,
             "unaligned_q", False)):
        rows.append(_flash_decode_case(label, dtype, b, h, sk, d, off,
                                       causal, gen, layout, timed))
    rows.append(_flash_case("ragged300-bfloat16", torch.bfloat16, 32, 300,
                            300, True, gen))
    _release()
    return rows


# -- phases: parity and serving -----------------------------------------------

def _teacher_forced(model, seq, prompt_len):
    """Greedy-check logits of ``model`` over the full sequence: returns
    (logits at each generated position [n, V] fp32, chosen tokens [n])."""
    import torch

    ids = torch.as_tensor(seq, device=DEVICE)[None]
    logits = model(ids)[0, prompt_len - 1:-1].float()
    return logits, ids[0, prompt_len:]


def _readings(model, seq, prompt_len, logprobs):
    """How far the generated tokens of ``seq`` stand from the model's own
    teacher-forced forward: (largest gap between a row's maximum logit and
    the chosen token's logit, largest |logprob - forward log-softmax| at
    the chosen token, 0.0 where ``logprobs`` is None)."""
    import torch

    logits, toks = _teacher_forced(model, seq, prompt_len)
    if not torch.isfinite(logits).all():
        raise RuntimeError("non-finite logits in the teacher-forced forward")
    chosen = logits.gather(1, toks[:, None])[:, 0]
    gap = (logits.max(dim=1).values - chosen).max().item()
    lp_err = 0.0
    if logprobs is not None:
        ref_lp = chosen - torch.logsumexp(logits, dim=1)
        lp_err = (ref_lp.cpu() - torch.as_tensor(logprobs)).abs().max().item()
    return gap, lp_err


def _within(readings, gap_tol, lp_tol):
    return (max(r[0] for r in readings) <= gap_tol
            and max(r[1] for r in readings) <= lp_tol)


def _serving_config():
    from paddle_tpu_torch.serving import GenerationConfig

    return GenerationConfig(max_slots=8, max_seq_len=2048, page_len=16,
                            prefill_buckets=(128, 512))


def _faulty_k1(fault, k1):
    """K1 with a planted fault, to show that the serving check catches
    one: ``shifted_tables`` reads block j + 1's page for block j;
    ``unscaled`` drops the 1/sqrt(hd) of the scores; ``first_split_only``
    clamps each decode row's pos to the last key of the decode kernel's
    first split, which is what a merge that dropped the later splits would
    serve."""
    import torch

    from paddle_tpu_torch.kernels.paged_attention import (decode_splits,
                                                          split_bounds)

    def faulty(q, k_arena, v_arena, tables, pos, scale):
        if fault == "shifted_tables":
            tables = torch.cat([tables[:, 1:], tables[:, :1] * 0], dim=1)
        elif fault == "unscaled":
            scale = 1.0
        elif q.shape[1] == 1:
            S, B = tables.shape
            n = decode_splits(
                S * k_arena.shape[2], B,
                torch.cuda.get_device_properties(q.device)
                .multi_processor_count)
            _first, end = split_bounds(pos, k_arena.shape[1], B, n)
            pos = torch.minimum(pos, (end[:, :1] - 1).to(pos.dtype))
        return k1(q, k_arena, v_arena, tables, pos, scale)
    return faulty


def _fault_readings(model, prompts, new, fault):
    """Serve ``prompts`` through K1 with ``fault`` planted and return each
    request's readings against the (sound) teacher-forced forward."""
    import torch

    from paddle_tpu_torch.serving import GenerationEngine, generation

    real = generation.paged_attention
    generation.paged_attention = _faulty_k1(fault, real)
    try:
        with GenerationEngine(model, _serving_config(), device=DEVICE) as eng:
            futs = [eng.submit(p, max_new_tokens=new, return_logprobs=True)
                    for p in prompts]
            outs = [f.result(timeout=600) for f in futs]
    finally:
        generation.paged_attention = real
    with torch.inference_mode():
        return [_readings(model, seq, len(p), lps)
                for p, (seq, lps) in zip(prompts, outs)]


def _generate_fault_readings(model, gen_ids, new):
    """``model.generate`` with a ``first_split_only`` fault planted in the
    flash decode route: each single-row step sees only the keys of the
    decode kernel's first split, which is what a merge that dropped the
    later splits would give; returns each row's readings against the
    (sound) teacher-forced forward."""
    import torch

    fa = _flash_module()
    real = fa.flash_decode

    def faulty(q, k, v, offset, causal, scale, with_lse=True):
        n = min(k.shape[1], offset + 1) if causal else k.shape[1]
        _n_split, first = fa.decode_plan(
            q.shape[0] * q.shape[2], n,
            torch.cuda.get_device_properties(q.device).multi_processor_count)
        return real(q, k[:, :first], v[:, :first], min(offset, first - 1),
                    causal, scale, with_lse)

    fa.flash_decode = faulty
    try:
        with torch.inference_mode():
            out = model.generate(gen_ids, max_new_tokens=new)
    finally:
        fa.flash_decode = real
    with torch.inference_mode():
        return [_readings(model, out[r], gen_ids.shape[1], None)
                for r in range(out.shape[0])]


def _generate_breakdown(model, gen_ids, new):
    """One profiled ``model.generate`` as serving runs it: wall ms by the
    host clock, device ms by kernel group and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model.generate(gen_ids, max_new_tokens=new)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.generate(gen_ids, max_new_tokens=new)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    _by_name, groups, device = _device_ms(prof, _train_group)
    return {"wall_ms": wall, "device_ms": device or None,
            "idle_share": (1.0 - device / wall) if device else None,
            "groups_ms": groups or None}


def phase_parity(seed):
    import numpy as np
    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.device import seed as pt_seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import GenerationConfig, GenerationEngine

    cfg = GPTConfig.gpt3_6_7b(num_hidden_layers=2, dtype="float32")
    model = GPTForCausalLM(cfg, device=DEVICE,
                           generator=pt_seed(seed + 1, DEVICE))
    rng = np.random.default_rng(seed + 1)
    prefix = rng.integers(0, cfg.vocab_size, size=256)
    prompts = [rng.integers(0, cfg.vocab_size, size=37),
               np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 60)]),
               np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 9)]),
               rng.integers(0, cfg.vocab_size, size=480)]
    new = 16
    eng = GenerationEngine(model, GenerationConfig(
        max_slots=4, max_seq_len=2048, page_len=16,
        prefill_buckets=(128, 512)), device=DEVICE)
    kernels.reset_counters()
    with eng:
        futs = [eng.submit(p, max_new_tokens=new, return_logprobs=True)
                for p in prompts]
        outs = [f.result(timeout=600) for f in futs]
    # fp32: decode steps on the split-K decode kernel, prefill windows on
    # the general kernel (the tensor-core one takes bf16 only)
    counts = kernels.counters()
    paged = {n: counts[n]["launches"] for n in PAGED_COUNTERS.values()}
    if not paged["paged_attention_decode"] or not paged["paged_attention"] \
            or paged["paged_attention_sm90"]:
        raise RuntimeError(f"parity: paged-attention launches {paged}")
    lp_errs = []
    kernels.reset_counters()
    with torch.inference_mode():
        for p, (seq, lps) in zip(prompts, outs):
            ref = model.generate(torch.as_tensor(p, device=DEVICE)[None],
                                 max_new_tokens=new)[0].cpu().numpy()
            if seq.tolist() != ref.tolist():
                raise RuntimeError(
                    f"parity: engine tokens {seq[len(p):].tolist()} != "
                    f"generate {ref[len(p):].tolist()}")
            # fp32: logits of magnitude ~1 agree to summation order
            r = _readings(model, seq, len(p), lps)
            if not _within([r], 1e-3, 2e-3):
                raise RuntimeError(f"parity: argmax gap {r[0]} (tol 1e-3), "
                                   f"logprob err {r[1]} (tol 2e-3)")
            lp_errs.append(r[1])
    # generate's single-row steps on the split-K decode kernel, exactly
    gen_counts = kernels.counters()
    decode = gen_counts["flash_attention_decode"]["launches"]
    want = cfg.num_hidden_layers * (new - 1) * len(prompts)
    if decode != want or any(c["plain_calls"] for c in gen_counts.values()):
        raise RuntimeError(f"parity: generate's decode launches {decode}, "
                           f"expected {want}, and no plain call")
    st = eng.stats()
    if st["prefix_hit_rate"] <= 0:
        raise RuntimeError("parity: the shared prefix was not reused")
    _emit({"phase": "parity", "ok": True, "requests": len(prompts),
           "new_tokens": new, "logprob_max_abs_err": max(lp_errs),
           "logprob_tol": 2e-3, "prefix_hit_rate": st["prefix_hit_rate"],
           "paged_launches": paged, "generate_decode_launches": decode})
    counts["flash_attention_decode"] = gen_counts["flash_attention_decode"]
    del eng, model
    _release()
    return counts


def phase_serving(seed):
    import numpy as np
    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.device import seed as pt_seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import GenerationEngine

    cfg = GPTConfig.gpt3_6_7b(dtype="bfloat16")
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device=DEVICE,
                           generator=pt_seed(seed + 2, DEVICE))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    eng = GenerationEngine(model, _serving_config(), device=DEVICE)
    rng = np.random.default_rng(seed + 2)
    prefix = rng.integers(0, cfg.vocab_size, size=256)
    prompts = []
    for i in range(16):  # odd requests share the prefix
        n = int(rng.integers(300 if i % 2 else 100, 501))
        tail = rng.integers(0, cfg.vocab_size, size=n - 256 * (i % 2))
        prompts.append(np.concatenate([prefix, tail]) if i % 2 else tail)
    new = 64
    eng.warmup()
    torch.cuda.synchronize()
    kernels.reset_counters()
    first = {}
    t_sub = {}

    def on_token_for(i):
        def cb(_t, _lp):
            first.setdefault(i, time.monotonic())
        return cb

    t0 = time.monotonic()
    futs = []
    for i, p in enumerate(prompts):
        t_sub[i] = time.monotonic()
        futs.append(eng.submit(p, max_new_tokens=new, return_logprobs=True,
                               on_token=on_token_for(i)))
    outs = [f.result(timeout=900) for f in futs]
    wall = time.monotonic() - t0
    st = eng.stats()
    eng.close()
    # the model's own inference entry point (flash kernel): greedy,
    # KV-cached generate for two prompts of one length
    gen_len, gen_new = 96, 16
    gen_ids = torch.as_tensor(np.stack([prompts[0][:gen_len],
                                        prompts[2][:gen_len]]), device=DEVICE)
    with torch.inference_mode():
        gen_out = model.generate(gen_ids, max_new_tokens=gen_new)
    torch.cuda.synchronize()
    counts = kernels.counters()
    for name, c in counts.items():
        if c["plain_calls"] != 0:
            raise RuntimeError(f"serving: kernel {name} counts {c}")
    # the engine's paged attention, exactly: every layer of every prefill
    # window on the tensor-core kernel, of every decode step on the split-K
    # decode kernel, none on the general kernel
    L = cfg.num_hidden_layers
    eng_counts = st["counters"]
    paged = {n: counts[n]["launches"] for n in PAGED_COUNTERS.values()}
    want = {"paged_attention_sm90": L * eng_counts.get("prefills_total", 0),
            "paged_attention_decode": L * eng_counts.get("decode_steps", 0),
            "paged_attention": 0}
    if paged != want or not want["paged_attention_decode"] or \
            not want["paged_attention_sm90"]:
        raise RuntimeError(f"serving: paged-attention launches {paged}, "
                           f"expected {want}")
    # generate's flash launches, exactly: each layer's prefill (96 rows) on
    # the tensor-core kernel, each later single-row step on the split-K
    # decode kernel, none on the CUDA-core one
    flash = {n: counts[n]["launches"] for n in (
        "flash_attention_sm90", "flash_attention_decode", "flash_attention")}
    if flash != {"flash_attention_sm90": L,
                 "flash_attention_decode": L * (gen_new - 1),
                 "flash_attention": 0}:
        raise RuntimeError(f"serving: generate's flash launches {flash}, "
                           f"expected {L} prefill and {L * (gen_new - 1)} "
                           f"decode")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    gen_tokens = sum(len(s) - len(p) for p, (s, _lp) in zip(prompts, outs))
    ttft = np.array([(first[i] - t_sub[i]) * 1e3 for i in range(16)])
    # correctness by the model's own forward (flash kernel), for every
    # request and generate row: each generated token's logit within
    # GAP_TOL of the row maximum, each engine logprob within LP_TOL of the
    # forward's. The same check on answers served with a fault planted in
    # K1 must fail, or it could not tell a wrong answer from bf16 noise.
    with torch.inference_mode():
        checks = [_readings(model, seq, len(p), lps)
                  for p, (seq, lps) in zip(prompts, outs)]
        checks += [_readings(model, gen_out[r], gen_len, None)
                   for r in range(gen_out.shape[0])]
    del eng
    faults = {f: _fault_readings(model, prompts[:4], 16, f) for f in FAULTS}
    # generate's decode steps with their merge cut to the first split
    faults["generate_first_split_only"] = _generate_fault_readings(
        model, gen_ids, gen_new)
    check = {"gap_tol": GAP_TOL, "logprob_tol": LP_TOL,
             "argmax_gap_max": max(c[0] for c in checks),
             "logprob_err_max": max(c[1] for c in checks),
             "faults": {f: {"argmax_gap_max": max(c[0] for c in r),
                            "logprob_err_max": max(c[1] for c in r),
                            "caught": not _within(r, GAP_TOL, LP_TOL)}
                        for f, r in faults.items()}}
    _emit({"phase": "serving-check", **check})
    if not _within(checks, GAP_TOL, LP_TOL):
        raise RuntimeError(f"serving: answers differ from the forward {check}")
    if not all(f["caught"] for f in check["faults"].values()):
        raise RuntimeError(f"serving: the check missed a planted fault "
                           f"{check['faults']}")
    for p, (seq, lps) in zip(prompts, outs):
        if len(seq) != len(p) + new or not np.isfinite(lps).all() or \
                seq.min() < 0 or seq.max() >= cfg.vocab_size:
            raise RuntimeError("serving: malformed response")
    if tuple(gen_out.shape) != (2, gen_len + gen_new) or \
            not torch.equal(gen_out[:, :gen_len], gen_ids):
        raise RuntimeError("serving: malformed generate output")
    ctx = int(np.mean([len(p) for p in prompts])) + new // 2
    breakdown = _step_breakdown(model, cfg, ctx)
    breakdown["generate"] = _generate_breakdown(model, gen_ids, gen_new)
    _emit({"phase": "serving", "ok": True, "model": "gpt3_6_7b",
           "layers": cfg.num_hidden_layers, "dtype": "bfloat16",
           "requests": 16, "new_tokens_each": new,
           "prompt_tokens": int(sum(len(p) for p in prompts)),
           "model_init_s": t_init, "wall_s": wall,
           "tokens_per_s": gen_tokens / wall,
           "decode_step_ms_mean": st["decode_step_ms_mean"],
           "decode_steps": st["counters"].get("decode_steps", 0),
           "prefills": st["counters"].get("prefills_total", 0),
           "generate_new_tokens": gen_new * gen_out.shape[0],
           "prefill_ms_mean": st["counters"].get("prefill_ms_total", 0)
           / max(st["counters"].get("prefills_total", 1), 1),
           "ttft_ms_p50": float(np.percentile(ttft, 50)),
           "ttft_ms_p99": float(np.percentile(ttft, 99)),
           "prefix_hit_rate": st["prefix_hit_rate"],
           "peak_mem_gb": peak_gb, "kernel_counts": counts})
    _emit({"phase": "serving-breakdown", "mean_context": ctx, **breakdown})
    del model
    _release()
    return counts


# -- phase: serving-tier -----------------------------------------------------

TIER_SPEC_K = 4          # draft proposals a round (verify window W = 5)
TIER_NEW = 64            # (a): new tokens a request, as the serving phase
TIER_SELF_NEW = 32       # (b), (c), (g): cut from 64 to keep the phase short
TIER_WARM_BYTES = 2 << 30
TIER_WARM_PAGES = 240    # (e): 3840 tokens of device pool, so prefixes evict
# (b): the self-draft's acceptance floor; its most is (k - 1) / k = 0.75
# (the advance is capped at k), and a draft whose arena or prefill is wrong
# proposes at random (about 0 of 50304 match)
TIER_SELF_ACCEPT_MIN = 0.6


def _tier_counts(total):
    """Read the kernels' counters since the last reset into ``total`` (the
    serving-tier path's sum) and return this part's own."""
    from paddle_tpu_torch import kernels

    c = kernels.counters()
    for name, v in c.items():
        t = total.setdefault(name, {"launches": 0, "plain_calls": 0})
        t["launches"] += v["launches"]
        t["plain_calls"] += v["plain_calls"]
    return c


def _tier_exact(part, c, want):
    """Launches of this part equal ``want`` exactly, no plain call."""
    got = {n: c[n]["launches"] for n in want}
    plain = {n: v["plain_calls"] for n, v in c.items() if v["plain_calls"]}
    if got != want or plain:
        raise RuntimeError(f"serving-tier ({part}): launches {got}, expected "
                           f"{want}; plain calls {plain}")
    return got


def _tier_prompts(rng, vocab, n, lo=100, hi=500, shared=256):
    """``n`` prompts of lo..hi tokens; odd ones start with one shared
    ``shared``-token prefix."""
    import numpy as np

    prefix = rng.integers(0, vocab, size=shared)
    out = []
    for i in range(n):
        m = int(rng.integers(max(lo, shared + 44) if i % 2 else lo, hi + 1))
        tail = rng.integers(0, vocab, size=m - shared * (i % 2))
        out.append(np.concatenate([prefix, tail]) if i % 2 else tail)
    return out


def _tier_serve(eng, prompts, new):
    """Submit ``prompts`` at once; returns the answers, the wall seconds and
    each request's TTFT (ms)."""
    import numpy as np

    first, t_sub = {}, {}

    def on_token_for(i):
        def cb(_t, _lp):
            first.setdefault(i, time.monotonic())
        return cb

    t0 = time.monotonic()
    futs = []
    for i, p in enumerate(prompts):
        t_sub[i] = time.monotonic()
        futs.append(eng.submit(p, max_new_tokens=new, return_logprobs=True,
                               on_token=on_token_for(i)))
    outs = [f.result(timeout=900) for f in futs]
    wall = time.monotonic() - t0
    ttft = np.array([(first[i] - t_sub[i]) * 1e3 for i in range(len(prompts))])
    return outs, wall, ttft


def _tier_check(part, model, prompts, outs, new):
    """Every answer well formed and each token within GAP_TOL / LP_TOL of
    the model's own forward (``outs``: (sequence, logprobs or None));
    returns the largest readings."""
    import numpy as np
    import torch

    with torch.inference_mode():
        r = [_readings(model, seq, len(p), lps)
             for p, (seq, lps) in zip(prompts, outs)]
    vocab = model.config.vocab_size
    for p, (seq, lps) in zip(prompts, outs):
        if len(seq) != len(p) + new or \
                (lps is not None and not np.isfinite(lps).all()) or \
                seq.min() < 0 or seq.max() >= vocab or \
                seq[:len(p)].tolist() != np.asarray(p).tolist():
            raise RuntimeError(f"serving-tier ({part}): malformed response")
    check = {"argmax_gap_max": max(x[0] for x in r),
             "logprob_err_max": max(x[1] for x in r)}
    if not _within(r, GAP_TOL, LP_TOL):
        raise RuntimeError(f"serving-tier ({part}): answers differ from the "
                           f"forward {check}")
    return check


def _tier_speculative(model, draft, prompts, total):
    """(a): a GPT-3 Small draft at k = 4; then the planted fault (every
    proposal accepted without verification) on a few requests."""
    import numpy as np

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving import GenerationConfig, GenerationEngine, \
        generation

    cfg = _serving_config()
    cfg.draft_model, cfg.spec_tokens = draft, TIER_SPEC_K
    eng = GenerationEngine(model, cfg, device=DEVICE).warmup()
    kernels.reset_counters()
    with eng:
        outs, wall, ttft = _tier_serve(eng, prompts, TIER_NEW)
        st = eng.stats()
    c = _tier_counts(total)
    L, Ld = model.config.num_hidden_layers, draft.config.num_hidden_layers
    ec = st["counters"]
    launches = _tier_exact("a", c, {
        "paged_attention_sm90":
            L * (ec["prefills_total"] + ec["decode_steps"]),
        "paged_attention_decode": 0, "paged_attention": 0,
        "flash_attention_sm90": Ld * ec["draft_prefills"],
        "flash_attention_decode": 0, "flash_attention": 0})
    if ec["spec_rounds"] != ec["decode_steps"]:
        raise RuntimeError("serving-tier (a): a round ran without the draft")
    check = _tier_check("a", model, prompts, outs, TIER_NEW)
    del eng
    _release()
    # the planted fault: proposals taken without verification
    real = generation.greedy_accept
    generation.greedy_accept = lambda d, t: len(d)
    try:
        with GenerationEngine(model, cfg, device=DEVICE) as bad:
            fouts = [bad.submit(p, max_new_tokens=16, return_logprobs=True)
                     for p in prompts[:4]]
            fouts = [f.result(timeout=600) for f in fouts]
    finally:
        generation.greedy_accept = real
    import torch
    with torch.inference_mode():
        fr = [_readings(model, seq, len(p), lps)
              for p, (seq, lps) in zip(prompts[:4], fouts)]
    fault = {"argmax_gap_max": max(x[0] for x in fr),
             "logprob_err_max": max(x[1] for x in fr),
             "caught": not _within(fr, GAP_TOL, LP_TOL)}
    if not fault["caught"]:
        raise RuntimeError(f"serving-tier (a): the check missed unverified "
                           f"proposals {fault}")
    tokens = sum(len(s) - len(p) for p, (s, _l) in zip(prompts, outs))
    return {"part": "a-speculative", "draft": "gpt3_small", "k": TIER_SPEC_K,
            "requests": len(prompts), "new_tokens_each": TIER_NEW,
            "proposed": ec["spec_proposed"], "accepted": ec["spec_accepted"],
            "rounds": ec["spec_rounds"], "acceptance": st["spec_acceptance"],
            "tokens_per_s": tokens / wall, "wall_s": wall,
            "decode_round_ms_mean": st["decode_step_ms_mean"],
            "prefill_ms_mean": ec["prefill_ms_total"] / ec["prefills_total"],
            "ttft_ms_p50": float(np.percentile(ttft, 50)),
            "ttft_ms_p99": float(np.percentile(ttft, 99)),
            "draft_prefills": ec["draft_prefills"], "launches": launches,
            **check, "fault_accept_unverified": fault}


def _tier_self_draft(model, prompts, total):
    """(b): the target as its own draft; speculation switched off once a few
    rounds have run: the later rounds are W = 1."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving import GenerationEngine

    cfg = _serving_config()
    cfg.draft_model, cfg.spec_tokens = model, TIER_SPEC_K
    eng = GenerationEngine(model, cfg, device=DEVICE).warmup()
    kernels.reset_counters()
    with eng:
        futs = [eng.submit(p, max_new_tokens=TIER_SELF_NEW,
                           return_logprobs=True) for p in prompts]
        t0 = time.monotonic()
        while eng.metrics.counter("spec_rounds") < 3 and \
                time.monotonic() - t0 < 300:
            time.sleep(0.001)
        eng.set_speculative(False)
        # a round already running when the switch came finishes as it began
        at_switch = eng.metrics.counter("spec_rounds")
        outs = [f.result(timeout=900) for f in futs]
        st = eng.stats()
    c = _tier_counts(total)
    L = model.config.num_hidden_layers
    ec = st["counters"]
    spec_rounds = ec["spec_rounds"]
    single = ec["decode_steps"] - spec_rounds
    if not at_switch <= spec_rounds <= at_switch + 1 or not single:
        raise RuntimeError(f"serving-tier (b): {spec_rounds} speculative "
                           f"rounds ({at_switch} at the switch), {single} "
                           f"single-token rounds")
    launches = _tier_exact("b", c, {
        "paged_attention_sm90": L * (ec["prefills_total"] + spec_rounds),
        "paged_attention_decode": L * single, "paged_attention": 0,
        "flash_attention_sm90": L * ec["draft_prefills"],
        "flash_attention_decode": 0})
    if not st["spec_acceptance"] >= TIER_SELF_ACCEPT_MIN:
        raise RuntimeError(f"serving-tier (b): self-draft acceptance "
                           f"{st['spec_acceptance']} < "
                           f"{TIER_SELF_ACCEPT_MIN}")
    check = _tier_check("b", model, prompts, outs, TIER_SELF_NEW)
    return {"part": "b-self-draft", "requests": len(prompts),
            "new_tokens_each": TIER_SELF_NEW, "proposed": ec["spec_proposed"],
            "accepted": ec["spec_accepted"],
            "acceptance": st["spec_acceptance"],
            "acceptance_min": TIER_SELF_ACCEPT_MIN,
            "acceptance_max": (TIER_SPEC_K - 1) / TIER_SPEC_K,
            "speculative_rounds": spec_rounds, "single_token_rounds": single,
            "tokens_per_speculative_slot_round": (
                (ec["spec_accepted"] / (ec["spec_proposed"] / TIER_SPEC_K)) + 1
                if ec["spec_proposed"] else None),
            "decode_round_ms_mean": st["decode_step_ms_mean"],
            "launches": launches, **check}


def _tier_swap(model, seed, prompts, total):
    """(c): a staged swap to a second seeded GPT-3 6.7B while requests are
    in flight: they finish on the first weights, the later ones run the
    second, and the answers of each set fail against the other model."""
    import threading

    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.device import seed as pt_seed
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.serving import GenerationEngine

    model2 = GPTForCausalLM(model.config, device=DEVICE,
                            generator=pt_seed(seed + 3, DEVICE))
    first_half, second_half = prompts[:4], prompts[4:8]
    eng = GenerationEngine(model, _serving_config(), device=DEVICE).warmup()
    kernels.reset_counters()
    with eng:
        early = [eng.submit(p, max_new_tokens=TIER_SELF_NEW,
                            return_logprobs=True) for p in first_half]
        t0 = time.monotonic()
        while len(eng._active()) < len(first_half) and \
                time.monotonic() - t0 < 300:
            time.sleep(0.001)
        swapped = {}
        t_swap = time.monotonic()
        th = threading.Thread(target=lambda: swapped.setdefault(
            "v", eng.swap_weights(model2, version=2)))
        th.start()
        while eng._pending_swap is None and th.is_alive():
            time.sleep(0.0005)
        late = [eng.submit(p, max_new_tokens=TIER_SELF_NEW,
                           return_logprobs=True) for p in second_half]
        early = [f.result(timeout=900) for f in early]
        th.join(timeout=900)
        swap_s = time.monotonic() - t_swap
        late = [f.result(timeout=900) for f in late]
        st = eng.stats()
    c = _tier_counts(total)
    L = model.config.num_hidden_layers
    ec = st["counters"]
    launches = _tier_exact("c", c, {
        "paged_attention_sm90": L * ec["prefills_total"],
        "paged_attention_decode": L * ec["decode_steps"],
        "paged_attention": 0})
    if swapped.get("v") != 2 or eng.weight_version != 2:
        raise RuntimeError(f"serving-tier (c): weight_version "
                           f"{eng.weight_version}")
    on_first = _tier_check("c-in-flight", model, first_half, early,
                           TIER_SELF_NEW)
    on_second = _tier_check("c-after", model2, second_half, late,
                            TIER_SELF_NEW)
    with torch.inference_mode():
        cross = [_readings(model2, s, len(p), lp)
                 for p, (s, lp) in zip(first_half, early)] + \
            [_readings(model, s, len(p), lp)
             for p, (s, lp) in zip(second_half, late)]
    if _within(cross, GAP_TOL, LP_TOL):
        raise RuntimeError("serving-tier (c): answers also pass against the "
                           "other weights: the check cannot tell versions")
    # the swap landed new tensors: the first model's weights are untouched
    # (another engine over it would see no change)
    if eng._params["embed"].data_ptr() == model.gpt.embed_tokens.weight \
            .data_ptr():
        raise RuntimeError("serving-tier (c): the swap wrote into the live "
                           "weights")
    del eng, model2
    _release()
    return {"part": "c-swap", "weight_version": 2, "in_flight": len(early),
            "after": len(late), "swap_wait_s": swap_s,
            "weight_swaps": ec["weight_swaps"], "launches": launches,
            "in_flight_check": on_first, "after_check": on_second,
            "cross_check_argmax_gap_min": min(x[0] for x in cross)}


def _tier_loopback(model, rng, total):
    """(d): export a 512-token prompt's pages from one engine and install
    them into another over the native (bf16) wire and the int8 wire."""
    import numpy as np

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving import GenerationEngine
    from paddle_tpu_torch.serving import kv_transfer as kv

    vocab = model.config.vocab_size
    prompt = rng.integers(0, vocab, size=512)
    new = 16
    src = GenerationEngine(model, _serving_config(), device=DEVICE).warmup()
    dst = GenerationEngine(model, _serving_config(), device=DEVICE).warmup()
    kernels.reset_counters()
    with src, dst:
        cold = src.submit(prompt, max_new_tokens=new,
                          return_logprobs=True).result(timeout=600)
        t0 = time.perf_counter()
        n, k_st, v_st = src.export_kv_pages(prompt)
        export_ms = (time.perf_counter() - t0) * 1e3
        # the uninterrupted engine: src serves the prompt again from its
        # own cache (31 of 32 blocks; the last one is prefilled)
        ref = src.submit(prompt, max_new_tokens=new,
                         return_logprobs=True).result(timeout=600)
        wire = {}
        for quant in (False, True):
            t0 = time.perf_counter()
            blob, man, meta = kv.pack_kv_pages(k_st, v_st, quantize=quant)
            chunks = kv.chunk_blob(blob, chunk_bytes=64 << 20)
            got = kv.assemble_chunks(chunks, meta["digest"])
            k2, v2 = kv.unpack_kv_pages(got, man)
            ship_ms = (time.perf_counter() - t0) * 1e3
            wire["int8" if quant else "bf16"] = (k2, v2, meta, ship_ms)
        k2, v2, meta, ship_ms = wire["bf16"]
        hits0 = dst.stats()["kv_pages"]["prefix"]["hit_tokens"]
        t0 = time.perf_counter()
        adopted = dst.install_kv_pages(prompt, k2, v2)
        install_ms = (time.perf_counter() - t0) * 1e3
        cont = dst.submit(prompt, max_new_tokens=new,
                          return_logprobs=True).result(timeout=600)
        hit = dst.stats()["kv_pages"]["prefix"]["hit_tokens"] - hits0
        st_src, st_dst = src.stats(), dst.stats()
    c = _tier_counts(total)
    L = model.config.num_hidden_layers
    pre = st_src["counters"]["prefills_total"] + \
        st_dst["counters"]["prefills_total"]
    dec = st_src["counters"]["decode_steps"] + \
        st_dst["counters"]["decode_steps"]
    launches = _tier_exact("d", c, {"paged_attention_sm90": L * pre,
                                    "paged_attention_decode": L * dec,
                                    "paged_attention": 0})
    if adopted != n or n != 32 or hit != 31 * 16:
        raise RuntimeError(f"serving-tier (d): {adopted} of {n} pages "
                           f"adopted, prefix hit {hit} tokens")
    if cont[0].tolist() != ref[0].tolist() or \
            not np.array_equal(cont[1], ref[1]):
        raise RuntimeError("serving-tier (d): the installed engine's "
                           "continuation differs from the uninterrupted one")
    check = _tier_check("d", model, [prompt] * 3, [cold, ref, cont], new)
    del dst
    _release()
    # the int8 wire into a fresh engine: a prefix hit; its tokens are read
    # against the forward but not gated (the KV is int8-approximate)
    k8, v8, meta8, ship8_ms = wire["int8"]
    dst8 = GenerationEngine(model, _serving_config(), device=DEVICE)
    kernels.reset_counters()
    with dst8:
        t0 = time.perf_counter()
        dst8.install_kv_pages(prompt, k8, v8)
        install8_ms = (time.perf_counter() - t0) * 1e3
        out8 = dst8.submit(prompt, max_new_tokens=new,
                           return_logprobs=True).result(timeout=600)
        st8 = dst8.stats()
    hit8 = st8["kv_pages"]["prefix"]["hit_tokens"]
    launches8 = _tier_exact("d-int8", _tier_counts(total), {
        "paged_attention_sm90": L * st8["counters"]["prefills_total"],
        "paged_attention_decode": L * st8["counters"]["decode_steps"],
        "paged_attention": 0})
    import torch
    with torch.inference_mode():
        r8 = _readings(model, out8[0], len(prompt), out8[1])
    same8 = int(sum(a == b for a, b in zip(out8[0][512:], ref[0][512:])))
    del src, dst8
    _release()
    return {"part": "d-export-install", "prompt_tokens": 512, "pages": n,
            "export_ms": export_ms, "install_ms": install_ms,
            "wire_bytes": meta["wire_bytes"], "pack_ship_unpack_ms": ship_ms,
            "int8_wire_bytes": meta8["wire_bytes"],
            "int8_pack_ship_unpack_ms": ship8_ms,
            "int8_install_ms": install8_ms, "prefix_hit_tokens": hit,
            "int8_prefix_hit_tokens": hit8, "bit_identical": True,
            "int8_tokens_equal_of_16": same8,
            "int8_argmax_gap_max": r8[0], "int8_logprob_err_max": r8[1],
            "launches": launches, "int8_launches": launches8, **check}


def _tier_warm(model, rng, total):
    """(e): a device pool of TIER_WARM_PAGES pages; a prompt's cached pages
    are evicted by later traffic (spilled, int8, to the host tier) and
    restored when it comes again."""
    import numpy as np
    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving import GenerationEngine
    from paddle_tpu_torch.serving import kv_transfer as kv

    vocab = model.config.vocab_size
    cfg = _serving_config()
    cfg.num_pages = TIER_WARM_PAGES
    cfg.warm_pool_bytes = TIER_WARM_BYTES
    eng = GenerationEngine(model, cfg, device=DEVICE)
    hot = rng.integers(0, vocab, size=480)
    others = [rng.integers(0, vocab, size=480) for _ in range(8)]
    new = 16
    kernels.reset_counters()
    with eng:
        eng.submit(hot, max_new_tokens=new).result(timeout=600)
        _n, k0, v0 = eng.export_kv_pages(hot)
        futs = [eng.submit(p, max_new_tokens=new) for p in others]
        for f in futs:
            f.result(timeout=600)
        depth = eng.prefix_match_tokens(hot) // 16
        t0 = time.perf_counter()
        again = eng.submit(hot, max_new_tokens=new,
                           return_logprobs=True).result(timeout=600)
        again_ms = (time.perf_counter() - t0) * 1e3
        _n, k1, v1 = eng.export_kv_pages(hot)
        st = eng.stats()
    L = model.config.num_hidden_layers
    launches = _tier_exact("e", _tier_counts(total), {
        "paged_attention_sm90": L * st["counters"]["prefills_total"],
        "paged_attention_decode": L * st["counters"]["decode_steps"],
        "paged_attention": 0})
    warm = st["kv_pages"]["warm"]
    restored = warm["restores"]
    if depth >= 29 or not restored or not warm["admits"] or \
            depth + restored > 29:
        raise RuntimeError(f"serving-tier (e): {depth} blocks still cached "
                           f"after the churn; warm tier {warm}")
    # blocks [0, depth) stayed on the device: equal; [depth, depth +
    # restored) came back from the host tier: |x - x^| <= scale/2 (the
    # int8 step) + the bf16 rounding of the dequantized value (2^-8 |x^|);
    # the rest were prefilled again (over restored pages: not compared)
    worst = 0.0
    for a, b in zip(k0 + v0, k1 + v1):
        if not torch.equal(a[:depth], b[:depth]):
            raise RuntimeError("serving-tier (e): a resident page changed")
        for j in range(depth, depth + restored):
            x, y = a[j].float().numpy(), b[j].float().numpy()
            _q, s = kv.quantize_page(a[j])
            excess = np.abs(x - y) - (s / 2 + 2.0 ** -8 * np.abs(y))
            worst = max(worst, float(excess.max()))
    if worst > 0:
        raise RuntimeError(f"serving-tier (e): a restored page is off by "
                           f"{worst} past its int8 step")
    with torch.inference_mode():
        r = _readings(model, again[0], len(hot), again[1])
    del eng
    _release()
    return {"part": "e-warm-tier", "device_pages": TIER_WARM_PAGES,
            "warm_bytes_budget": TIER_WARM_BYTES, "spills_seen": warm["admits"]
            + warm["rejects"], "admits": warm["admits"],
            "rejects": warm["rejects"], "restores": warm["restores"],
            "warm_evictions": warm["evictions"], "warm_bytes": warm["bytes"],
            "blocks_resident_after_churn": depth,
            "restored_request_ms": again_ms,
            "restored_argmax_gap": r[0], "restored_logprob_err": r[1],
            "page_bound": "scale/2 + 2^-8 |x^|", "launches": launches}


def _position_readings(model, ids, toks, lps):
    """(gap, logprob error) of per-position answers ``toks``/``lps`` against
    the model's own forward on ``ids`` alone (unpadded)."""
    import torch

    with torch.inference_mode():
        logits = model(torch.as_tensor(ids, device=DEVICE)[None])[0].float()
    t = torch.as_tensor(toks, device=DEVICE).long()[:, None]
    chosen = logits.gather(1, t)[:, 0]
    gap = (logits.max(dim=1).values - chosen).max().item()
    ref = chosen - torch.logsumexp(logits, dim=1)
    err = (ref.cpu() - torch.as_tensor(lps)).abs().max().item()
    return gap, err


def _tier_serving_engine(model, rng, total):
    """(f): ``ServingEngine`` over a callable on the model's forward that
    returns each position's argmax and its log-probability."""
    import threading

    import numpy as np
    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving import (BucketSpec, ServingConfig,
                                          ServingEngine)

    def forward(ids):
        logits = model(ids)
        a = logits.argmax(dim=-1)
        lp = torch.log_softmax(logits.float(), dim=-1)
        return a, lp.gather(-1, a[..., None])[..., 0]

    eng = ServingEngine(forward, BucketSpec((1, 2, 4, 8),
                                            seq_lens=(128, 256, 512)),
                        input_specs=[((None,), "int64")],
                        config=ServingConfig(max_batch_wait_ms=5.0),
                        device=DEVICE)
    vocab = model.config.vocab_size
    reqs = [rng.integers(0, vocab, size=int(n))
            for n in rng.integers(100, 513, size=32)]
    t0 = time.monotonic()
    eng.start()  # builds and runs the 12 bucket runners
    warm_s = time.monotonic() - t0
    kernels.reset_counters()
    outs = [None] * len(reqs)

    def client(c):
        futs = [(i, eng.submit([reqs[i]])) for i in range(c, len(reqs), 4)]
        for i, f in futs:
            outs[i] = f.result(timeout=900)

    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    wall = time.monotonic() - t0
    st = eng.stats()
    eng.close()
    c = _tier_counts(total)
    L = model.config.num_hidden_layers
    ec = st["counters"]
    launches = _tier_exact("f", c, {
        "flash_attention_sm90": L * ec["batches_total"],
        "flash_attention": 0, "flash_attention_decode": 0})
    if ec.get("compile_cache_misses", 0) != 0 or \
            ec["responses_total"] != len(reqs):
        raise RuntimeError(f"serving-tier (f): counters {ec}")
    r = [_position_readings(model, ids, o[0][:len(ids)], o[1][:len(ids)])
         for ids, o in zip(reqs, outs)]
    check = {"argmax_gap_max": max(x[0] for x in r),
             "logprob_err_max": max(x[1] for x in r)}
    if not _within(r, GAP_TOL, LP_TOL):
        raise RuntimeError(f"serving-tier (f): batched answers differ from "
                           f"the callable alone {check}")
    return {"part": "f-serving-engine", "requests": len(reqs),
            "buckets": st["buckets"], "warmup_s": warm_s,
            "warmup_runners": ec["warmup_compiles"], "wall_s": wall,
            "qps": len(reqs) / wall, "latency_ms": st["latency_ms"],
            "batches": ec["batches_total"],
            "occupancy": st["batch_occupancy"],
            "execute_ms_mean": ec["execute_ms_total"] / ec["batches_total"],
            "cache_misses_after_warmup": ec.get("compile_cache_misses", 0),
            "launches": launches, **check}


def _tier_router(model, rng, total):
    """(g): ``ReplicaRouter`` over two engines that share the model's
    weights: two tenants ("free" with a quota of 4 in flight), 32 requests
    with half sharing a prefix; one replica marked down mid-run, its queued
    requests cancelled and resubmitted through the router."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving import (GenerationEngine, ReplicaRouter,
                                          RequestCancelled, RouterConfig,
                                          TenantQuotaExceeded)

    a = GenerationEngine(model, _serving_config(), device=DEVICE,
                         name="replica-a").warmup()
    b = GenerationEngine(model, _serving_config(), device=DEVICE,
                         name="replica-b").warmup()
    if a._params["embed"].data_ptr() != b._params["embed"].data_ptr():
        raise RuntimeError("serving-tier (g): replicas copied the weights")
    prompts = _tier_prompts(rng, model.config.vocab_size, 32)
    tenants = ["free" if i % 4 == 0 else "pro" for i in range(32)]
    router = ReplicaRouter([a, b], RouterConfig(tenant_quotas={"free": 4}))
    kernels.reset_counters()
    futs, quota_hits = {}, [0]

    def submit(i):
        while True:  # a tenant at its quota waits for one of its own
            try:
                futs[i] = router.submit(prompts[i], TIER_SELF_NEW,
                                        tenant=tenants[i])
                return
            except TenantQuotaExceeded:
                quota_hits[0] += 1
                time.sleep(0.005)

    with router:
        # the first shared-prefix request lands alone: its replica then
        # holds the prefix that the other half asks for
        submit(1)
        futs[1].result(timeout=600)
        for i in range(32):
            if i == 1:
                continue
            submit(i)
            if i == 20:
                router.mark_down("replica-a")
                moved = [j for j, f in futs.items() if a.cancel(f)]
                for j in moved:
                    try:
                        futs[j].result(timeout=5)
                    except RequestCancelled:
                        pass
                    submit(j)
        outs = [(futs[i].result(timeout=900), None) for i in range(32)]
        st = router.stats()
    c = _tier_counts(total)
    L = model.config.num_hidden_layers
    ca, cb = a.stats()["counters"], b.stats()["counters"]
    launches = _tier_exact("g", c, {
        "paged_attention_sm90": L * (ca["prefills_total"]
                                     + cb["prefills_total"]),
        "paged_attention_decode": L * (ca["decode_steps"]
                                       + cb["decode_steps"]),
        "paged_attention": 0})
    if not moved or st["down"] != ["replica-a"] or not quota_hits[0]:
        raise RuntimeError(f"serving-tier (g): rerouted {moved}, down "
                           f"{st['down']}, quota hits {quota_hits[0]}")
    check = _tier_check("g", model, prompts, outs, TIER_SELF_NEW)
    routed = sum(r["routed"] for r in st["replicas"].values())
    del a, b, router
    _release()
    return {"part": "g-router", "requests": 32, "rerouted": len(moved),
            "affinity_hits": st["affinity_hits"],
            "affinity_share": st["affinity_hits"] / routed,
            "routed": {n: r["routed"] for n, r in st["replicas"].items()},
            "responses": {n: r["responses"]
                          for n, r in st["replicas"].items()},
            "quota_rejections": quota_hits[0], "rejected": st["rejected"],
            "launches": launches, **check}


def phase_serving_tier(seed):
    """(a)-(g) at GPT-3 6.7B's full width: each part's launches exact, every
    answer checked; returns the path's counters (every part summed)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.device import seed as pt_seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    t_phase = time.perf_counter()
    cfg = GPTConfig.gpt3_6_7b(dtype="bfloat16")
    model = GPTForCausalLM(cfg, device=DEVICE,
                           generator=pt_seed(seed + 2, DEVICE))
    # GPT-3 Small (Brown et al. 2020 Table 2.1): 12 x 768, 12 heads of 64
    draft = GPTForCausalLM(
        GPTConfig.gpt2_small(max_position_embeddings=2048,
                             dtype="bfloat16"),
        device=DEVICE, generator=pt_seed(seed + 4, DEVICE))
    rng = np.random.default_rng(seed + 5)
    prompts = _tier_prompts(rng, cfg.vocab_size, 16)
    total = {}
    parts = [_tier_speculative(model, draft, prompts, total)]
    del draft
    _release()
    parts.append(_tier_self_draft(model, prompts[:8], total))
    _release()
    parts.append(_tier_swap(model, seed, prompts, total))
    parts.append(_tier_loopback(model, rng, total))
    parts.append(_tier_warm(model, rng, total))
    parts.append(_tier_serving_engine(model, rng, total))
    _release()
    parts.append(_tier_router(model, rng, total))
    plain = {n: c["plain_calls"] for n, c in total.items()
             if c["plain_calls"]}
    if plain:
        raise RuntimeError(f"serving-tier: plain calls on the path {plain}")
    for p in parts:
        _emit({"phase": "serving-tier", **p})
    _emit({"phase": "serving-tier-summary", "ok": True,
           "model": "gpt3_6_7b", "dtype": "bfloat16",
           "seconds": time.perf_counter() - t_phase,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "kernel_counts": {n: c for n, c in total.items()
                             if c["launches"] or c["plain_calls"]}})
    del model
    _release()
    return total


# -- phase: serving-fleet ----------------------------------------------------

FLEET_SEED = SEED + 9     # every replica's weights (and the checking model)
FLEET_NEW = 64            # (a), (b): new tokens a request, as the serving phase
FLEET_HEDGE_NEW = 16      # (c)
FLEET_SLOW_MS = 3000      # (c): r0's first submit is deferred this long
FLEET_HEDGE_MS = 1000     # (c): a request this long without a token is hedged
FLEET_FAULTS = (f"replica_slow@name=r0&ms={FLEET_SLOW_MS},"
                "replica_crash@name=r1&seq=3&inc=0")
# brownout's load is in-flight requests / (ready replicas x capacity):
# (a)-(c) keep 16 requests on one replica under stage 1 (16 / 32 < 0.7),
# (d)'s burst of 8 on two replicas lands at stage 3 (8 / (2 x 2) = 2)
FLEET_TRAFFIC_CAPACITY = 32
FLEET_CAPACITY = 2
FLEET_BURST = 8           # (d): low-priority requests
FLEET_BURST_NEW = 16
FLEET_CLAMP_ASK = 32      # (d): asked at stage >= 2, clamped to 8
# (e), fp32 transit: the decode leg resubmits prompt + first token, and an
# engine refuses a prompt past its largest bucket (512) as the JAX one does,
# so the longest prompt is 511 tokens (31 full pages shipped)
FLEET_POOL_LENS = (511, 200, 100, 48)
FLEET_INT8_LEN = 300                    # (e): the int8 request
FLEET_POOL_NEW = 16
FLEET_READY_S = 300.0


def build_fleet_replica():
    """One replica of the serving-fleet phase, built inside the replica
    process (``PT_REPLICA_BUILDER=chip_smoke.py:build_fleet_replica``):
    GPT-3 6.7B, bf16, random weights from FLEET_SEED, on the card its name
    numbers (``r1`` -> card 1 modulo the cards), the serving phase's engine
    config, and a GPT-3 Small draft at k 4 unless ``PT_FLEET_DRAFT=0``."""
    import torch

    from paddle_tpu_torch.device import seed as pt_seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import GenerationEngine

    name = os.environ.get("PT_REPLICA_NAME", "r0")
    index = int("".join(ch for ch in name if ch.isdigit()) or 0)
    dev = f"cuda:{index % torch.cuda.device_count()}"
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = GPTForCausalLM(GPTConfig.gpt3_6_7b(dtype="bfloat16"), device=dev,
                           generator=pt_seed(FLEET_SEED, dev))
    cfg = _serving_config()
    if os.environ.get("PT_FLEET_DRAFT", "1") == "1":
        cfg.draft_model = GPTForCausalLM(
            GPTConfig.gpt2_small(max_position_embeddings=2048,
                                 dtype="bfloat16"),
            device=dev, generator=pt_seed(FLEET_SEED + 1, dev))
        cfg.spec_tokens = TIER_SPEC_K
    return GenerationEngine(model, cfg, device=dev, name=name)


def _fleet_vocab():
    from paddle_tpu_torch.models import GPTConfig

    return GPTConfig.gpt3_6_7b().vocab_size


def _fleet_model(device=DEVICE):
    """The replicas' model, for the checks after the fleet is closed."""
    from paddle_tpu_torch.device import seed as pt_seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    return GPTForCausalLM(GPTConfig.gpt3_6_7b(dtype="bfloat16"),
                          device=device,
                          generator=pt_seed(FLEET_SEED, device))


class _FleetRun:
    """A fleet under test: every replica process it ever started is
    remembered, and ``close`` kills whatever outlived ``fleet.close()``, so
    a failing part leaves no process holding the card."""

    def __init__(self, fleet):
        self.fleet = fleet
        self.procs = []

    def handles(self):
        return {h.name: h for h in self.fleet._handles}

    def note_procs(self):
        for h in self.fleet._handles:
            if h.proc is not None and h.proc not in self.procs:
                self.procs.append(h.proc)

    def start(self, timeout=FLEET_READY_S):
        """Start the replicas; returns each one's spawn -> ready seconds."""
        t0 = time.monotonic()
        self.fleet.start(wait_ready=False)
        self.note_procs()
        ready = {}
        while time.monotonic() - t0 < timeout:
            reps = self.fleet.provider_snapshot()["replicas"]
            for name, r in reps.items():
                if r["state"] == "ready" and name not in ready:
                    ready[name] = time.monotonic() - t0
                if r["state"] == "failed":
                    raise RuntimeError(f"serving-fleet: {name} failed to "
                                       f"start: {reps}")
            if len(ready) == len(reps):
                return ready
            time.sleep(0.05)
        raise RuntimeError(f"serving-fleet: replicas not ready within "
                           f"{timeout} s: {self.fleet.provider_snapshot()}")

    def clients(self):
        return {n: h.client for n, h in self.handles().items()}

    def close(self):
        try:
            self.fleet.close()
        finally:
            self.note_procs()
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=60)


def _fleet_logs_tail(log_dir, n=4000):
    """The replica logs' tails, for a failure's message."""
    out = []
    for f in sorted(os.listdir(log_dir)) if os.path.isdir(log_dir) else []:
        with open(os.path.join(log_dir, f), "rb") as fh:
            out.append(f"--- {f}\n" + fh.read()[-n:].decode(errors="replace"))
    return "\n".join(out)


def _fleet_submit(fleet, prompts, new, wait_on=None, block=True, **kw):
    """Submit ``prompts`` to the fleet with ``on_token`` streams; a request
    the fleet placed on the replica ``wait_on`` waits until it has streamed
    4 tokens before the next goes. Returns one record a request (``placed``:
    the replica its submit went to), completed (``block``) or for
    ``_fleet_collect``."""
    recs = []
    for p in prompts:
        rec = {"prompt": p, "stream": [], "times": []}

        def cb(t, _lp, rec=rec):
            rec["times"].append(time.monotonic())
            rec["stream"].append(int(t))

        rec["t_sub"] = time.monotonic()
        rec["fut"] = fleet.submit(p, max_new_tokens=new, on_token=cb,
                                  return_logprobs=True, **kw)
        asg = getattr(getattr(rec["fut"], "_pt_req", None), "primary", None)
        rec["placed"] = asg.replica if asg is not None else None
        recs.append(rec)
        if wait_on is not None and rec["placed"] == wait_on:
            t_end = time.monotonic() + 30
            while len(rec["stream"]) < 4 and time.monotonic() < t_end and \
                    not rec["fut"].done():
                time.sleep(0.005)
    return _fleet_collect(recs) if block else recs


def _fleet_collect(recs):
    for rec in recs:
        rec["seq"], rec["lps"] = rec["fut"].result(timeout=900)
    return recs


def _stream_ok(prompt, stream, seq, new):
    """Each stream is exactly its answer's generated tail: no repeated and
    no missing token, and the length the request asked for."""
    p = len(prompt)
    return (len(seq) == p + new and list(seq[:p]) == [int(x) for x in prompt]
            and list(stream) == [int(x) for x in seq[p:]])


def _stitch_reappend(prompt, emitted, replica_seq):
    """A planted fault: a replay stitch that re-appends the tokens already
    emitted (the replayed output already holds them)."""
    return list(prompt) + list(emitted) + [int(t) for t in
                                           replica_seq[len(prompt):]]


def _fleet_streams(part, recs, new):
    for r in recs:
        if not _stream_ok(r["prompt"], r["stream"], r["seq"], new):
            raise RuntimeError(f"serving-fleet ({part}): a stream differs "
                               f"from its answer")


def _ttft_ms(recs):
    import numpy as np

    t = np.array([(r["times"][0] - r["t_sub"]) * 1e3 for r in recs])
    return float(np.percentile(t, 50)), float(np.percentile(t, 99))


def _fleet_launch_check(name, tele, L, Ld, buckets):
    """A replica's launches since its process started, exactly: the warm-up
    (one window at W = 1, at each bucket and at k + 1; the draft's prefill
    at each bucket) plus L per prefill window and verify window on the
    tensor-core paged kernel, L per W = 1 round on the split-K decode
    kernel, 12 per draft prefill on the tensor-core flash kernel; no other
    attention kernel and no plain call."""
    st = tele["engine"]["counters"]
    counts = tele["kernels"]
    draft = Ld > 0
    warm = {"paged_attention_sm90": L * (len(buckets) + (1 if draft else 0)),
            "paged_attention_decode": L,
            "flash_attention_sm90": Ld * len(buckets)}
    spec = st.get("spec_rounds", 0)
    want = {
        "paged_attention_sm90": warm["paged_attention_sm90"]
        + L * (st.get("prefills_total", 0) + spec),
        "paged_attention_decode": warm["paged_attention_decode"]
        + L * (st.get("decode_steps", 0) - spec),
        "flash_attention_sm90": warm["flash_attention_sm90"]
        + Ld * st.get("draft_prefills", 0),
        "paged_attention": 0, "flash_attention": 0,
        "flash_attention_decode": 0}
    got = {n: counts[n]["launches"] for n in want}
    plain = {n: c["plain_calls"] for n, c in counts.items()
             if c["plain_calls"]}
    if got != want or plain:
        raise RuntimeError(f"serving-fleet: {name}'s launches {got}, "
                           f"expected {want}; plain calls {plain}")
    return {"launches": got, "warmup": warm,
            "prefills": st.get("prefills_total", 0),
            "verify_windows": spec,
            "w1_rounds": st.get("decode_steps", 0) - spec,
            "draft_prefills": st.get("draft_prefills", 0)}


def _fleet_telemetry(run, L, Ld, buckets, total):
    """Each live replica's launches, read over the ``telemetry`` op and
    checked exactly; summed into ``total`` (the path's counters)."""
    out = {}
    for name, client in run.clients().items():
        tele = client.telemetry()["telemetry"]
        out[name] = _fleet_launch_check(name, tele, L, Ld, buckets)
        for n, c in tele["kernels"].items():
            t = total.setdefault(n, {"launches": 0, "plain_calls": 0})
            t["launches"] += c["launches"]
            t["plain_calls"] += c["plain_calls"]
    return out


def _wait_for(cond, timeout, what):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        if cond():
            return
        time.sleep(0.005)
    raise RuntimeError(f"serving-fleet: {what} within {timeout} s")


def _spec_states(run):
    """Each replica's own report: is its draft speculation on?"""
    return {n: c.stats()["spec_enabled"] for n, c in run.clients().items()}


def _fleet_hedge(run, prompt):
    """(c): r0's first submit is deferred FLEET_SLOW_MS; with hedge_ms set,
    the request is hedged on r1, which finishes first; the loser is
    cancelled."""
    fleet = run.fleet
    fleet.policy.hedge_ms = FLEET_HEDGE_MS
    try:
        recs = _fleet_submit(fleet, [prompt], FLEET_HEDGE_NEW)
    finally:
        fleet.policy.hedge_ms = None
    # r0 runs the loser once its deferred submit fires (frames suppressed):
    # let it finish before the next part's routing reads the load
    time.sleep(max(0.0, recs[0]["t_sub"] + FLEET_SLOW_MS / 1e3 + 0.5
                   - time.monotonic()))
    c = fleet.provider_snapshot()["counters"]
    if c.get("hedges", 0) < 1 or c.get("hedge_wins", 0) < 1 or \
            c.get("hedge_cancelled", 0) != c.get("hedges", 0):
        raise RuntimeError(f"serving-fleet (c): hedge counters {c}")
    _fleet_streams("c", recs, FLEET_HEDGE_NEW)
    r0 = run.clients()["r0"]
    _wait_for(lambda: r0._probe(force=True).get("active", 0) == 0 and
              r0.queue_depth() == 0, 60, "r0 did not drain the hedge loser")
    return recs, {"part": "c-hedging", "hedge_ms": FLEET_HEDGE_MS,
                  "slow_ms": FLEET_SLOW_MS,
                  "latency_ms": (recs[0]["times"][-1] - recs[0]["t_sub"])
                  * 1e3,
                  "hedges": c["hedges"], "hedge_wins": c["hedge_wins"],
                  "hedge_cancelled": c["hedge_cancelled"]}


def _fleet_crash(run, prompts, later_prompts):
    """(b): r1 dies at its third submit (``replica_crash@name=r1&seq=3&
    inc=0``) with a request streaming; every request completes, each stream
    exactly its answer's tail; r1 is fenced, restarts and serves again; a
    planted stitch that re-appends the emitted tokens fails the check.

    The router picks r1 by its live load and prefix affinity, so which of
    the requests reach r1 varies from run to run: each request placed on
    r1 waits until it has streamed 4 tokens before the next goes, and so
    the crash at r1's next submit meets a request mid-stream."""
    import threading

    from paddle_tpu_torch.serving import fleet as fl

    fleet = run.fleet
    r1 = run.handles()["r1"]
    proc, exit_t = r1.proc, []

    def watch():
        while proc.poll() is None and not stop:
            time.sleep(0.002)
        if proc.poll() is not None:
            exit_t.append(time.time())

    stop = False
    th = threading.Thread(target=watch, daemon=True)
    th.start()
    t0 = time.monotonic()
    recs = _fleet_submit(fleet, prompts, FLEET_NEW, wait_on="r1")
    wall = time.monotonic() - t0
    stop = True
    th.join(timeout=5)
    _fleet_streams("b", recs, FLEET_NEW)
    _wait_for(lambda: (fleet.provider_snapshot()["replicas"]["r1"]["state"]
                       == "ready"), FLEET_READY_S, "r1 not ready again")
    run.note_procs()
    snap = fleet.provider_snapshot()
    c = snap["counters"]
    if c.get("fences", 0) < 1 or c.get("restarts", 0) < 1 or \
            c.get("replays", 0) < 1 or c.get("stream_mismatch", 0) or \
            snap["replicas"]["r1"]["incarnation"] < 1 or not exit_t:
        raise RuntimeError(f"serving-fleet (b): counters {c}, replicas "
                           f"{snap['replicas']}, r1 exit seen {exit_t}")
    rec = snap["recoveries"][0]
    # the replayed requests: the fleet's own record of each replay (its
    # dispatch prefix = prompt + the tokens emitted before the crash, and
    # the tokens the survivor streamed) stitches back to the answer, and the
    # planted re-appending stitch fails the stream check
    replayed, caught = [], []
    for r in recs:
        req = r["fut"]._pt_req
        if not req.replays:
            continue
        asg = req.primary
        p = r["prompt"]
        emitted = list(asg.prefix[len(p):])
        replica_seq = list(asg.prefix) + list(asg.tokens)
        if fl.stitch_replay(p, emitted, replica_seq) != \
                [int(x) for x in r["seq"]]:
            raise RuntimeError("serving-fleet (b): stitch_replay of the "
                               "replay differs from the answer")
        bad = _stitch_reappend(p, emitted, replica_seq)
        replayed.append(len(emitted))
        if emitted:
            caught.append(not _stream_ok(p, r["stream"], bad, FLEET_NEW))
    if not caught or not all(caught):
        raise RuntimeError(f"serving-fleet (b): the planted re-appending "
                           f"stitch was not caught (emitted before the "
                           f"crash per replayed request: {replayed}; "
                           f"placed: {[r['placed'] for r in recs]}; "
                           f"counters {c})")
    # the restarted replica serves later requests
    before = snap["replicas"]["r1"]["routed_since_ready"]
    later = _fleet_submit(fleet, later_prompts, FLEET_HEDGE_NEW)
    _fleet_streams("b-later", later, FLEET_HEDGE_NEW)
    served = fleet.provider_snapshot()["replicas"]["r1"][
        "routed_since_ready"] - before
    if served < 1:
        raise RuntimeError("serving-fleet (b): the restarted r1 served "
                           "nothing")
    tokens = sum(len(r["seq"]) - len(r["prompt"]) for r in recs)
    return recs + later, {
        "part": "b-crash", "faults": FLEET_FAULTS, "requests": len(recs),
        "tokens_per_s": tokens / wall, "wall_s": wall,
        "fence_cause": rec["cause"], "fence_rc": rec["rc"],
        "crash_to_fence_ms": (rec["fence_t"] - exit_t[0]) * 1e3,
        "fence_to_ready_ms": rec.get("ready_ms"),
        "inflight_replayed": rec["inflight_replayed"],
        "replayed_requests": len(replayed),
        "emitted_before_crash": replayed,
        "planted_reappend_caught": True,
        "r1_incarnation": snap["replicas"]["r1"]["incarnation"],
        "r1_served_after_restart": served,
        "counters": {k: c.get(k, 0) for k in (
            "fences", "restarts", "replays", "stream_mismatch",
            "failover_reprefill", "failover_ship", "replayed_complete")}}


def _fleet_clean(run, prompts, ready):
    """(a): the 16 requests over the two healthy replicas."""
    fleet = run.fleet
    before = {n: r["routed"] for n, r in
              fleet.provider_snapshot()["replicas"].items()}
    t0 = time.monotonic()
    recs = _fleet_submit(fleet, prompts, FLEET_NEW)
    wall = time.monotonic() - t0
    _fleet_streams("a", recs, FLEET_NEW)
    routed = {n: r["routed"] - before[n] for n, r in
              fleet.provider_snapshot()["replicas"].items()}
    p50, p99 = _ttft_ms(recs)
    tokens = sum(len(r["seq"]) - len(r["prompt"]) for r in recs)
    return recs, {"part": "a-two-replicas", "replicas": 2,
                  "draft": "gpt3_small", "k": TIER_SPEC_K,
                  "spawn_to_ready_s": ready, "requests": len(recs),
                  "new_tokens_each": FLEET_NEW,
                  "tokens_per_s": tokens / wall, "wall_s": wall,
                  "ttft_ms_p50": p50, "ttft_ms_p99": p99,
                  "routed": routed}


def _fleet_brownout(run, prompts):
    """(d): a low-priority burst past replica_capacity walks the stages:
    speculation off on both replicas, the burst's tail shed at stage 3
    (``BrownoutShed``), a request's budget clamped; then back to stage 0
    with speculation on."""
    from paddle_tpu_torch.serving import BrownoutShed

    fleet = run.fleet
    fleet.policy.replica_capacity = FLEET_CAPACITY
    recs, shed = [], []
    try:
        for p in prompts:
            try:
                recs += _fleet_submit(fleet, [p], FLEET_BURST_NEW,
                                      block=False, priority=0)
            except BrownoutShed as e:
                shed.append(type(e).__name__)
        _wait_for(lambda: fleet.brownout()["stage"] >= 3, 30,
                  "the burst did not reach stage 3")
        if not shed:                 # the whole burst got in: one more
            try:
                fleet.submit(prompts[0], max_new_tokens=4, priority=0)
            except BrownoutShed as e:
                shed.append(type(e).__name__)
            else:
                raise RuntimeError("serving-fleet (d): no shed at stage 3")
        if fleet.brownout()["stage"] < 2:
            raise RuntimeError("serving-fleet (d): the stage fell below 2 "
                               "before the clamped request")
        clamp = _fleet_submit(fleet, [prompts[1]], FLEET_CLAMP_ASK,
                              block=False)[0]
        _wait_for(lambda: all(v is False for v in
                              _spec_states(run).values()), 30,
                  "speculation not off on both replicas")
        spec_off = _spec_states(run)
        _fleet_collect(recs + [clamp])
        _wait_for(lambda: fleet.brownout()["stage"] == 0, 60,
                  "no decay to stage 0")
        _wait_for(lambda: all(v is True for v in
                              _spec_states(run).values()), 30,
                  "speculation not back on")
        spec_on = _spec_states(run)
    finally:
        fleet.policy.replica_capacity = FLEET_TRAFFIC_CAPACITY
    clamped_to = fleet.policy.brownout_clamp_tokens
    _fleet_streams("d", recs, FLEET_BURST_NEW)
    _fleet_streams("d-clamp", [clamp], clamped_to)
    c = fleet.provider_snapshot()["counters"]
    hist = fleet.brownout()["history"]
    return recs + [clamp], {
        "part": "d-brownout", "replica_capacity": FLEET_CAPACITY,
        "burst": len(prompts), "burst_admitted": len(recs),
        "shed": shed, "stages": [h["stage"] for h in hist],
        "loads": [h["load"] for h in hist],
        "max_stage": max(h["stage"] for h in hist),
        "spec_during": spec_off, "spec_after": spec_on,
        "clamp_asked": FLEET_CLAMP_ASK, "clamped_to": clamped_to,
        "counters": {k: c.get(k, 0) for k in (
            "shed_brownout", "clamped", "brownout_transitions")}}


def _fleet_pools(spec, log_dir, total, L):
    """(e): a prefill replica and a decode replica (no draft); each request
    prefills on p0, its pages ship to d1 over the frames (fp32 transit: the
    bf16 pages as raw 16-bit words) and continue there; then one request
    over the int8 wire."""
    import numpy as np

    from paddle_tpu_torch.serving import ServingFleet, ServingFleetPolicy

    rng = np.random.default_rng(FLEET_SEED + 3)
    vocab = _fleet_vocab()
    prompts = [rng.integers(0, vocab, size=n) for n in FLEET_POOL_LENS]
    run = _FleetRun(ServingFleet(
        builder=spec, names=["p0", "d1"],
        pools={"prefill": ["p0"], "decode": ["d1"]}, kv_transit="fp32",
        # a 512-token prompt's 256 MiB of pages are packed and unpacked on
        # the replica's RPC thread: give its beat the time
        policy=ServingFleetPolicy(heartbeat_timeout=60.0,
                                  rpc_timeout_s=120.0),
        extra_env={"PT_FLEET_DRAFT": "0"}, log_dir=log_dir,
        name="serving_fleet_pools"))
    try:
        ready = run.start()
        fleet = run.fleet
        recs, ships = [], []
        for transit, ps in (("fp32", prompts),
                            ("int8", [rng.integers(0, vocab,
                                                   size=FLEET_INT8_LEN)])):
            fleet.kv_transit = transit
            for p in ps:                  # one at a time: each ship timed
                w0 = fleet.kv_migration_snapshot()["wire_bytes"]
                r = _fleet_submit(fleet, [p], FLEET_POOL_NEW)[0]
                r["transit"] = transit
                recs.append(r)
                ships.append({"transit": transit, "prompt_tokens": len(p),
                              "pages": len(p) // 16,
                              "handoff_ms": (r["times"][1] - r["times"][0])
                              * 1e3,
                              "wire_bytes": fleet.kv_migration_snapshot()
                              ["wire_bytes"] - w0})
        _fleet_streams("e", recs, FLEET_POOL_NEW)
        c = fleet.provider_snapshot()["counters"]
        kvs = fleet.kv_migration_snapshot()
        n = len(recs)
        if c.get("migrations") != n or c.get("prefill_handoffs") != n or \
                c.get("migrate_fallback", 0):
            raise RuntimeError(f"serving-fleet (e): counters {c}")
        for s in ships:
            per = 2 * L * 16 * 4096 * (2 if s["transit"] == "fp32" else 1)
            if s["wire_bytes"] < s["pages"] * per:
                raise RuntimeError(f"serving-fleet (e): {s['wire_bytes']} "
                                   f"wire bytes for {s['pages']} pages")
        launches = _fleet_telemetry(run, L, 0, (128, 512), total)
    finally:
        run.close()
    return recs, {"part": "e-pools", "pools": {"prefill": ["p0"],
                                               "decode": ["d1"]},
                  "spawn_to_ready_s": ready, "ships": ships,
                  "kv_migration": kvs, "launches": launches,
                  "counters": {k: c.get(k, 0) for k in (
                      "migrations", "prefill_handoffs", "migrate_fallback",
                      "pool_fallback")}}


def _two_legs(model, recs, new):
    """What a lone engine (no draft) gives on the fleet's two legs: the
    prompt for one token, then prompt + that token from its own prefix
    cache."""
    from paddle_tpu_torch.serving import GenerationEngine

    out = []
    with GenerationEngine(model, _serving_config(), device=DEVICE) as eng:
        for r in recs:
            s1, l1 = eng.submit(r["prompt"], max_new_tokens=1,
                                return_logprobs=True).result(timeout=600)
            s2, l2 = eng.submit(s1, max_new_tokens=new - 1,
                                return_logprobs=True).result(timeout=600)
            out.append((s2, l1, l2))
    return out


def phase_serving_fleet(seed):
    """(a)-(e): GPT-3 6.7B replica processes behind ``ServingFleet`` on the
    one card. Returns the path's counters (the live replicas' launches)."""
    import tempfile

    import numpy as np
    import torch

    from paddle_tpu_torch.serving import ServingFleet, ServingFleetPolicy

    t_phase = time.perf_counter()
    _release()
    spec = os.path.abspath(__file__) + ":build_fleet_replica"
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    vocab, L, Ld, buckets = _fleet_vocab(), 32, 12, (128, 512)
    rng = np.random.default_rng(seed + 11)
    # (a) and (b) draw the serving phase's traffic each (16 requests of
    # 100-500 tokens, half sharing a 256-token prefix): one set would
    # reach (a) with (b)'s pages cached
    crash_prompts = _tier_prompts(rng, vocab, 16)
    clean_prompts = _tier_prompts(rng, vocab, 16)
    hedge_prompt = rng.integers(0, vocab, size=200)
    later_prompts = [rng.integers(0, vocab, size=150) for _ in range(2)]
    burst_prompts = [rng.integers(0, vocab, size=int(n))
                     for n in rng.integers(100, 151, size=FLEET_BURST)]
    total, parts, answers = {}, {}, {}
    run = _FleetRun(ServingFleet(
        builder=spec, names=["r0", "r1"],
        policy=ServingFleetPolicy(heartbeat_timeout=10.0,
                                  replica_capacity=FLEET_TRAFFIC_CAPACITY),
        extra_env={"PT_FAULTS": FLEET_FAULTS}, log_dir=log_dir))
    try:
        try:
            ready = run.start()
            # execution order: (c) spends r0's slow rule and takes r1's
            # first submit, so (b)'s traffic meets the crash at r1's third;
            # (a) then runs on the healthy pair (r1 restarted), then (d)
            answers["c"], parts["c"] = _fleet_hedge(run, hedge_prompt)
            answers["b"], parts["b"] = _fleet_crash(run, crash_prompts,
                                                    later_prompts)
            answers["a"], parts["a"] = _fleet_clean(run, clean_prompts,
                                                    ready)
            answers["d"], parts["d"] = _fleet_brownout(run, burst_prompts)
            parts["a"]["launches"] = _fleet_telemetry(run, L, Ld, buckets,
                                                      total)
        finally:
            run.close()
        answers["e"], parts["e"] = _fleet_pools(spec, log_dir, total, L)
    except Exception as e:
        raise RuntimeError(f"{e}\nreplica logs:\n"
                           f"{_fleet_logs_tail(log_dir)}") from e
    alive = [p for p in run.procs if p.poll() is None]
    if alive:
        raise RuntimeError(f"serving-fleet: {len(alive)} replica processes "
                           f"outlived the fleet")
    # the checks that need the model, with every replica gone
    model = _fleet_model()
    with torch.inference_mode():
        readings = {}
        for part in "abcde":
            rd = [_readings(model, r["seq"], len(r["prompt"]), r["lps"])
                  for r in answers[part]]
            readings[part] = {"argmax_gap_max": max(x[0] for x in rd),
                              "logprob_err_max": max(x[1] for x in rd),
                              "answers": len(rd)}
            if not _within(rd, GAP_TOL, LP_TOL):
                raise RuntimeError(f"serving-fleet ({part}): answers differ "
                                   f"from the forward {readings[part]}")
    fp32 = [r for r in answers["e"] if r["transit"] == "fp32"]
    lone = _two_legs(model, fp32, FLEET_POOL_NEW)
    for r, (s2, l1, l2) in zip(fp32, lone):
        if s2.tolist() != r["seq"].tolist() or \
                not np.array_equal(np.concatenate([l1, l2]), r["lps"]):
            raise RuntimeError("serving-fleet (e): the fp32-transit "
                               "continuation differs from the lone engine's")
    parts["e"]["fp32_bit_identical"] = len(fp32)
    del model
    _release()
    for k in "abcde":
        _emit({"phase": "serving-fleet", **parts[k],
               "check": readings[k]})
    _emit({"phase": "serving-fleet-summary", "ok": True,
           "model": "gpt3_6_7b", "dtype": "bfloat16",
           "gap_tol": GAP_TOL, "logprob_tol": LP_TOL,
           "seconds": time.perf_counter() - t_phase,
           "kernel_counts": {n: c for n, c in total.items()
                             if c["launches"] or c["plain_calls"]}})
    return total


def _kernel_group(name):
    low = name.lower()
    if any(k in low for k in ("paged_attention_kernel", "decode_split_kernel",
                              "decode_merge_kernel", "paged_sm90_kernel")):
        return "paged_attention"
    if "flash_fwd_sm90" in low:
        return "flash_attention_sm90"
    if "flash_fwd_kernel" in low:
        return "flash_attention"
    if any(s in low for s in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
        return "matmul"
    return "other"


def _step_breakdown(model, cfg, ctx_len, reps=3):
    """Wall and device time of one window step at the serving phase's
    shapes — decode (8 slots at context ``ctx_len``) and a 512-token
    prefill (one slot) — with device time by kernel from torch.profiler.
    Device figures are None where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models import gpt_engine_params
    from paddle_tpu_torch.serving import PagedKVPool, build_window_step

    S, PL, B = 8, 16, 128
    nh = cfg.num_attention_heads
    per = max(-(-(ctx_len + 1) // PL), 512 // PL)
    pool = PagedKVPool(cfg.num_hidden_layers, S * per + 1, PL, nh,
                       cfg.hidden_size // nh, torch.bfloat16,
                       prefix_cache=False, device=DEVICE)
    tables = torch.zeros(S, B, dtype=torch.int32, device=DEVICE)
    tables[:, :per] = torch.arange(S * per, dtype=torch.int32,
                                   device=DEVICE).view(S, per) + 1
    one = torch.zeros_like(tables)
    one[0] = tables[0]
    params = gpt_engine_params(model)
    out = {}
    for label, W, lens, tbl in (
            ("decode", 1, torch.full((S,), ctx_len), tables),
            ("prefill512", 512, torch.zeros(S), one)):
        step = build_window_step(cfg, S, B, PL, W)
        tokens = torch.zeros(S, W, dtype=torch.int32, device=DEVICE)
        lens = lens.to(torch.int32).to(DEVICE)

        def run():
            step(params, pool.k, pool.v, tbl, tokens, lens)

        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
        # device records only: a CPU op's device time is its kernels' again
        by_name, groups, device = _device_ms(prof, _kernel_group)
        by_name = {k: ms / reps for k, ms in by_name.items()}
        groups = {g: ms / reps for g, ms in groups.items()}
        device /= reps
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        out[label] = {
            "wall_ms": wall, "device_ms": device or None,
            "idle_share": (1.0 - device / wall) if device else None,
            "groups_ms": groups or None,
            "top": [[name[:80], ms] for name, ms in top]}
    del pool
    return out


# -- phase: training kernels --------------------------------------------------

def _tol_bwd(dtype):
    """(rtol, atol) of a backward kernel against its plain version: as
    ``_tol``, plus rtol 1e-4 because the two sum fp32 products over up to
    s terms (rows or keys) in different orders."""
    import torch

    return (1e-4, 1e-4) if dtype == torch.float32 else (2.0 ** -8 + 1e-4,
                                                        1e-4)


def _rope_tol(dtype):
    """RoPE against its plain version: the bf16 rounding of ``_tol``, and
    atol 1e-3, which covers one or two ulps of inv_i times a position of
    2047 (~2.4e-4 rad) on inputs of magnitude up to ~4."""
    import torch

    return (0.0 if dtype == torch.float32 else 2.0 ** -8, 1e-3)


def _rand(gen, shape, dtype):
    import torch

    return torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)


def _visible_pairs(sq, sk, offset, causal):
    if not causal:
        return sq * sk
    return sum(min(sk, max(0, i + offset + 1)) for i in range(sq))


def _dname(dtype):
    return str(dtype).split(".")[1]


def _flash_bwd_case(label, dtype, bh, sq, sk, offset, causal, gen,
                    timed=True, with_dlse=False, d=128, cuda_core_row=False):
    """dK/dV and dQ kernels at one shape against their plain versions on
    fp32 copies of the same inputs. bf16 at a head dim that is a multiple
    of 8 up to 256 runs the tensor-core dK/dV and dQ kernels, each held to
    the bound of its roundings; fp32 at such head dims up to 128 runs the
    3xTF32 dK/dV and dQ kernels (their bound at the 3xTF32 rate and at
    fp32's); each of these is timed eager and in graph replay beside the
    CUDA-core kernel on the same inputs. The rest runs the CUDA-core
    kernels. With ``cuda_core_row`` the CUDA-core dK/dV and dQ kernels,
    which run on no main path now, also get rows of their own beside the
    tensor-core ones (held to their tolerance). Returns one row per
    kernel."""
    import torch

    fa = _flash_module()
    scale = 1.0 / d ** 0.5
    sm90 = fa.takes_sm90(dtype, d)  # dK/dV and dQ on the tensor cores
    tf32x3 = fa.takes_tf32x3(dtype, d)
    if cuda_core_row and not sm90:
        raise ValueError(f"{label}: a CUDA-core row beside a CUDA-core route")
    suffix = "_sm90" if sm90 else "_tf32x3" if tf32x3 else ""
    dkv_name = "flash_attention_bwd_dkv" + suffix
    dq_name = "flash_attention_bwd_dq" + suffix
    q, do = (_rand(gen, (bh, sq, d), dtype) for _ in range(2))
    k, v = (_rand(gen, (bh, sk, d), dtype) for _ in range(2))
    f32 = [t.float() for t in (q, k, v, do)]
    with torch.no_grad():
        o, lse = fa.flash_attention_plain(*f32[:3], offset, causal, scale)
    delta = (f32[3] * o).sum(-1)
    if with_dlse:
        delta = delta - _rand(gen, (bh, sq), torch.float32)
    del o
    args = (lse, delta, offset, causal, scale)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, *args)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, *args)
    torch.cuda.synchronize()
    rdk, rdv = fa.flash_attention_bwd_dkv_plain(*f32, *args)
    tol = _tol_bwd(dtype)
    if sm90:
        bdk, bdv = fa.sm90_dkv_bound(*f32, *args, rdk, rdv)
        (ek, sk_), (ev, sv_) = (
            _compare_bound(f"flash_bwd_dkv_sm90[{label}].dk", dk, rdk, bdk),
            _compare_bound(f"flash_bwd_dkv_sm90[{label}].dv", dv, rdv, bdv))
        err_dkv, share = max(ek, ev), max(sk_, sv_)
        del bdk, bdv
    else:
        err_dkv = max(
            _compare(f"{dkv_name}[{label}].dk", dk, rdk, tol)[0],
            _compare(f"{dkv_name}[{label}].dv", dv, rdv, tol)[0])
    del rdk, rdv
    rdq = fa.flash_attention_bwd_dq_plain(*f32, *args)
    if sm90:
        bdq = fa.sm90_dq_bound(*f32, *args, rdq)
        err_dq, share_dq = _compare_bound(f"flash_bwd_dq_sm90[{label}].dq",
                                          dq, rdq, bdq)
        del bdq
    else:
        err_dq = _compare(f"{dq_name}[{label}].dq", dq, rdq, tol)[0]
    if offset < 0 and causal and dq[:, :-offset].abs().max().item() != 0.0:
        raise RuntimeError(f"{dq_name}[{label}]: rows that see no key "
                           f"have non-zero dq")
    del rdq, f32
    _release()
    base = {"phase": "kernel", "case": label, "dtype": _dname(dtype),
            "bh": bh, "sq": sq, "sk": sk, "d": d, "offset": offset,
            "causal": causal}
    rows = [dict(base, kernel=dkv_name,
                 max_abs_err=err_dkv, tol=SM90_TOL if sm90 else tol),
            dict(base, kernel=dq_name,
                 max_abs_err=err_dq, tol=SM90_TOL if sm90 else tol)]
    if sm90:
        rows[0]["bound_share_max"] = share
        rows[1]["bound_share_max"] = share_dq
    if cuda_core_row:
        ck, cv = fa.flash_attention_bwd_dkv_cuda_core(q, k, v, do, *args)
        cq = fa.flash_attention_bwd_dq_cuda_core(q, k, v, do, *args)
        torch.cuda.synchronize()
        f32 = [t.float() for t in (q, k, v, do)]
        rdk, rdv = fa.flash_attention_bwd_dkv_plain(*f32, *args)
        rows.append(dict(base, kernel="flash_attention_bwd_dkv", tol=tol,
                         max_abs_err=max(
            _compare(f"flash_attention_bwd_dkv[{label}].dk", ck, rdk,
                     tol)[0],
            _compare(f"flash_attention_bwd_dkv[{label}].dv", cv, rdv,
                     tol)[0])))
        del ck, cv, rdk, rdv
        rdq = fa.flash_attention_bwd_dq_plain(*f32, *args)
        rows.append(dict(base, kernel="flash_attention_bwd_dq", tol=tol,
                         max_abs_err=_compare(
                             f"flash_attention_bwd_dq[{label}].dq", cq, rdq,
                             tol)[0]))
        del cq, rdq, f32
        _release()
    if timed:
        rows[0]["kernel_ms"] = _time_ms(
            lambda: fa.flash_attention_bwd_dkv(q, k, v, do, *args), iters=10,
            warmup=2)
        rows[1]["kernel_ms"] = _time_ms(
            lambda: fa.flash_attention_bwd_dq(q, k, v, do, *args), iters=10,
            warmup=2)
        # graph replay, and the CUDA-core kernel on the same inputs, for the
        # kernels that are not the CUDA-core ones
        for row, kind in ((rows[0], "dkv"), (rows[1], "dq")):
            if not suffix:
                break
            wrapper = getattr(fa, f"flash_attention_bwd_{kind}{suffix}")
            core = getattr(fa, f"flash_attention_bwd_{kind}_cuda_core")
            row["graph_ms"] = _graph_ms(
                lambda w=wrapper: w(q, k, v, do, *args))
            row["cuda_core_ms"] = _time_ms(
                lambda c=core: c(q, k, v, do, *args), iters=3, warmup=1)
        if cuda_core_row:
            rows[2]["kernel_ms"] = rows[0]["cuda_core_ms"]
            rows[3]["kernel_ms"] = rows[1]["cuda_core_ms"]
        rows[0]["plain_ms"] = _time_ms(
            lambda: fa.flash_attention_bwd_dkv_plain(q, k, v, do, *args),
            iters=3, warmup=1)
        rows[1]["plain_ms"] = _time_ms(
            lambda: fa.flash_attention_bwd_dq_plain(q, k, v, do, *args),
            iters=3, warmup=1)
        if cuda_core_row:
            rows[2]["plain_ms"] = rows[0]["plain_ms"]
            rows[3]["plain_ms"] = rows[1]["plain_ms"]
        _release()
        lib = spread = None
        if not causal or (sq == sk and offset == 0):
            lib, spread = _sdpa_bwd_ms(q, k, v, do, causal)
        esz = q.element_size()
        pairs = bh * _visible_pairs(sq, sk, offset, causal)
        io = (2 * bh * sq * d + 2 * bh * sk * d) * esz + 2 * bh * sq * 4
        rate = "tf32x3" if tf32x3 else _dname(dtype)
        work = [(rows[0], 2 * bh * sk * d * esz, 8 * d),
                (rows[1], bh * sq * d * esz, 6 * d)]
        if cuda_core_row:
            work += [(rows[2], 2 * bh * sk * d * esz, 8 * d),
                     (rows[3], bh * sq * d * esz, 6 * d)]
        for row, out_bytes, flops_per in work:
            b_ms, b_by = _bound(io + out_bytes, flops_per * pairs, rate)
            row.update(library_ms=lib, library_ms_spread=spread,
                       bound_ms=b_ms, bound_by=b_by, visible_pairs=pairs,
                       tflop_per_s=flops_per * pairs / row["kernel_ms"] / 1e9)
            if rate == "tf32x3":
                row["bound_fp32_ms"] = _bound(io + out_bytes,
                                              flops_per * pairs,
                                              "float32")[0]
    for row in rows:
        _emit(row)
    return rows


def _sdpa_bwd_ms(q, k, v, do, causal, repeats=5):
    """Library yardstick of the flash backward: torch's SDPA backward (dq,
    dk and dv together) on [1, bh, s, d]. The graph is built once and only
    ``torch.autograd.grad(out, leaves, do, retain_graph=True)`` is timed,
    ``repeats`` times: (median ms, [min, max] ms). Its is_causal is
    top-left aligned, which equals ours for sq == sk and offset 0."""
    import torch
    import torch.nn.functional as TF

    leaves = [t[None].detach().requires_grad_() for t in (q, k, v)]
    out = TF.scaled_dot_product_attention(*leaves, is_causal=causal)
    cot = do[None]
    reads = sorted(_time_ms(lambda: torch.autograd.grad(
        out, leaves, cot, retain_graph=True), iters=10, warmup=2)
        for _ in range(repeats))
    del out, leaves
    return reads[len(reads) // 2], [reads[0], reads[-1]]


def _rmsnorm_case(label, dtype, n, h, residual, gen, timed=True, start=0):
    """RMSNorm forward and backward kernels (plain or +residual variant)
    against their plain versions on fp32 copies of the same inputs; with
    ``start`` 1, x and the residual begin one element off a 16-byte
    boundary (the forward's scalar instance). The forward is timed eager
    and in CUDA-graph replay, beside ``F.rms_norm`` timed both ways; the
    backward both ways beside the earlier backward on the same inputs
    (both ways), ``F.rms_norm``'s autograd backward and a copy of the
    bytes its bound counts (graph)."""
    import torch
    import torch.nn.functional as TF

    from paddle_tpu_torch.kernels import rmsnorm

    def off(t):
        if t is None or not start:
            return t
        flat = torch.empty(t.numel() + start, dtype=t.dtype, device=DEVICE)
        return flat[start:].view(t.shape).copy_(t)

    eps = 1e-5
    x, dy = off(_rand(gen, (n, h), dtype)), _rand(gen, (n, h), dtype)
    res = off(_rand(gen, (n, h), dtype)) if residual else None
    dr = _rand(gen, (n, h), dtype) if residual else None
    w = (1.0 + 0.1 * _rand(gen, (h,), torch.float32)).to(dtype)

    def f32(t):
        return None if t is None else t.float()

    y, s, rstd = rmsnorm.rms_norm_fwd(x, res, w, eps)
    dx, dw = rmsnorm.rms_norm_bwd(s, w, rstd, dy, dr)
    torch.cuda.synchronize()
    tol = _tol(dtype)
    ry, rs, rrstd = rmsnorm.rms_norm_fwd_plain(f32(x), f32(res), f32(w), eps)
    err_f = _compare(f"rms_norm[{label}].y", y, ry, tol)[0]
    if residual:
        err_f = max(err_f, _compare(f"rms_norm[{label}].s", s, rs, tol)[0])
    _compare(f"rms_norm[{label}].rstd", rstd, rrstd, (1e-5, 0.0))
    # the backward on the kernel's own saved s and rstd; dw sums n rows in
    # another order (rtol 1e-4 more)
    rdx, rdw = rmsnorm.rms_norm_bwd_plain(f32(s), f32(w), rstd, f32(dy),
                                          f32(dr))
    err_b = max(_compare(f"rms_norm_bwd[{label}].dx", dx, rdx, tol)[0],
                _compare(f"rms_norm_bwd[{label}].dw", dw, rdw,
                         (tol[0] + 1e-4, tol[1]))[0])
    name = "rms_norm_residual" if residual else "rms_norm"
    base = {"phase": "kernel", "case": label, "dtype": _dname(dtype),
            "n": n, "h": h, "start": start, "tol": tol}
    rows = [dict(base, kernel=name, max_abs_err=err_f),
            dict(base, kernel=name + "_bwd", max_abs_err=err_b)]
    if timed:
        def fwd():
            return rmsnorm.rms_norm_fwd(x, res, w, eps)

        rows[0]["kernel_ms"] = _time_ms(fwd)
        rows[0]["graph_ms"] = _graph_ms(fwd)
        rows[0]["plain_ms"] = _time_ms(
            lambda: rmsnorm.rms_norm_fwd_plain(x, res, w, eps))

        def bwd():
            return rmsnorm.rms_norm_bwd(s, w, rstd, dy, dr)

        k = 2 if residual else 1
        earlier = _earlier_rms_bwd(s, w, rstd, dy, dr)
        e_dx = earlier()[0]
        torch.cuda.synchronize()
        _compare(f"rms_norm_bwd_earlier[{label}].dx", e_dx, rdx, tol)
        # a copy that moves the bytes the bound counts (s, dy, dr read, dx
        # written): the card's practical rate for this traffic
        c_in = torch.empty((2 + k) * n // 2, h, dtype=dtype, device=DEVICE)
        c_out = torch.empty_like(c_in)
        rows[1].update(kernel_ms=_time_ms(bwd), graph_ms=_graph_ms(bwd),
                       plain_ms=_time_ms(lambda: rmsnorm.rms_norm_bwd_plain(
                           s, w, rstd, dy, dr)),
                       earlier_ms=_time_ms(earlier),
                       earlier_graph_ms=_graph_ms(earlier),
                       copy_graph_ms=_graph_ms(lambda: c_out.copy_(c_in)))
        lib_f = lib_b = None
        if not residual:
            # torch.nn.functional.rms_norm; its backward is autograd's
            xl = x.detach().requires_grad_()
            wl = w.detach().requires_grad_()

            def lib_fwd():
                return TF.rms_norm(xl, (h,), wl, eps)

            def lib_fwd_bwd():
                torch.autograd.grad(lib_fwd(), (xl, wl), dy)

            def lib_fwd_nograd():
                with torch.no_grad():
                    return TF.rms_norm(x, (h,), w, eps)

            lib_f = _time_ms(lib_fwd)
            lib_b = _time_ms(lib_fwd_bwd) - lib_f
            rows[0]["library_graph_ms"] = _graph_ms(lib_fwd_nograd)
            # the backward in graph replay: autograd's forward and backward
            # captured together, less the forward with its graph built;
            # where this torch cannot capture autograd, eager only and why
            try:
                rows[1]["library_graph_ms"] = (_graph_ms(lib_fwd_bwd) -
                                               _graph_ms(lib_fwd))
            except RuntimeError as err:
                rows[1]["library_graph_error"] = str(err)[:200]
            # a copy of x moves the forward's bytes: the card's practical
            # rate for this read/write mix, in graph replay
            buf = torch.empty_like(x)
            rows[0]["copy_graph_ms"] = _graph_ms(lambda: buf.copy_(x))
        esz = x.element_size()
        fwd_bytes = 2 * k * n * h * esz + h * esz + n * 4
        bwd_bytes = (2 + k) * n * h * esz + 2 * h * esz + n * 4
        for row, nbytes, flops, lib in (
                (rows[0], fwd_bytes, (4 + k) * n * h, lib_f),
                (rows[1], bwd_bytes, 10 * n * h, lib_b)):
            # elementwise fp32 arithmetic on the CUDA cores
            b_ms, b_by = _bound(nbytes, flops, "float32")
            row.update(library_ms=lib, bound_ms=b_ms, bound_by=b_by)
    for row in rows:
        _emit(row)
    return rows


def _earlier_rms_bwd(s, w, rstd, dy, dr):
    """The earlier RMSNorm backward (a 256-thread block a row with scalar
    loads on 512 blocks, then a column sum of one thread per column) on
    the same inputs, for timing beside the new one: a call that launches
    it and returns (dx, dw, its scratch)."""
    import ctypes

    import torch

    from paddle_tpu_torch.kernels import _build

    n, h = s.shape
    dx = torch.empty_like(s)
    dw = torch.empty(h, dtype=w.dtype, device=s.device)
    blocks = max(1, min(n, 512))
    part = torch.empty(blocks, h, dtype=torch.float32, device=s.device)
    fn = _build.kernel("pt_rmsnorm_bwd_earlier", [ctypes.c_void_p] * 8 +
                       [ctypes.c_int] * 5 + [ctypes.c_void_p])
    args = (s.data_ptr(), w.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
            None if dr is None else dr.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), part.data_ptr(), n, h, blocks, int(dr is not None),
            int(s.dtype == torch.bfloat16))

    def call():  # holds every buffer whose pointer it passes
        _build.launch(fn, "pt_rmsnorm_bwd_earlier", s.device, *args)
        return dx, dw, part
    return call


def _rope_input(gen, shape, dtype, layout):
    """x [b, s, h, d]: contiguous, ``bhsd`` (a view of a contiguous [b, h,
    s, d] tensor, the layout of the cotangent that reaches RoPE's backward
    from the attention) or ``offset1`` (contiguous, starting one element
    past a 16-byte boundary: the scalar instance)."""
    import torch

    b, s, h, d = shape
    if layout == "bhsd":
        return _rand(gen, (b, h, s, d), dtype).transpose(1, 2)
    x = _rand(gen, shape, dtype)
    if layout == "offset1":
        flat = torch.empty(x.numel() + 1, dtype=dtype, device=DEVICE)
        x = flat[1:].view(shape).copy_(x)
    return x


def _rope_case(label, dtype, shape, pos_offset, theta, gen, timed=True,
               layout="contiguous"):
    """RoPE forward and inverse kernels against the plain version on fp32
    copies of the same input, read in ``layout`` (:func:`_rope_input`)
    through the instance ``rope_plan`` names. Timed eager and in CUDA-graph
    replay, beside a copy of the same bytes (graph)."""
    import torch

    from paddle_tpu_torch.kernels import rope

    x = _rope_input(gen, shape, dtype, layout)
    plan = rope.rope_plan(x.shape, x.stride(), x.element_size(), x.data_ptr())
    rows = []
    for inverse in (False, True):
        out = rope.rope(x, theta, pos_offset, inverse)
        torch.cuda.synchronize()
        ref = rope.rope_plain(x.float(), theta, pos_offset, inverse)
        name = "rope_inverse" if inverse else "rope"
        err = _compare(f"{name}[{label}]", out, ref, _rope_tol(dtype))[0]
        if not out.is_contiguous():
            raise RuntimeError(f"{name}[{label}]: result not contiguous")
        row = {"phase": "kernel", "kernel": name, "case": label,
               "dtype": _dname(dtype), "shape": list(shape),
               "layout": layout, "plan": plan, "pos_offset": pos_offset,
               "theta": theta, "max_abs_err": err, "tol": _rope_tol(dtype)}
        if timed:
            def run():
                return rope.rope(x, theta, pos_offset, inverse)

            buf = torch.empty(shape, dtype=dtype, device=DEVICE)
            row["kernel_ms"] = _time_ms(run)
            row["graph_ms"] = _graph_ms(run)
            row["plain_ms"] = _time_ms(
                lambda: rope.rope_plain(x, theta, pos_offset, inverse))
            # a copy moves the same bytes: the card's practical rate
            row["copy_graph_ms"] = _graph_ms(lambda: buf.copy_(out))
            # one read and one write of x; a rotation (6 FLOPs) per pair
            b_ms, b_by = _bound(2 * x.numel() * x.element_size(),
                                3 * x.numel(), "float32")
            row.update(library_ms=None, bound_ms=b_ms, bound_by=b_by)
        _emit(row)
        rows.append(row)
    return rows


def phase_train_kernels(seed):
    """The five training kernels at the 1.16B Llama step's shapes (timed)
    and at odd shapes (checked only)."""
    import torch

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 10)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        name = _dname(dtype)
        # batch 4 x 16 heads, causal 2048, head dim 128
        rows += _flash_bwd_case(f"train-{name}", dtype, 64, 2048, 2048, 0,
                                True, gen)
        for residual in (False, True):
            rows += _rmsnorm_case(f"train-{name}", dtype, 8192, 2048,
                                  residual, gen)
        rows += _rope_case(f"train-{name}", dtype, (4, 2048, 16, 128), 0,
                           1e4, gen)
        # the cotangent's layout at the training shape, read in place
        rows += _rope_case(f"train-bhsd-{name}", dtype, (4, 2048, 16, 128),
                           0, 1e4, gen, layout="bhsd")
        # odd shapes: ragged lengths with a causal offset and a live lse
        # cotangent; rows that see no key; ragged rows and a width that is
        # not a multiple of 32; a position offset near 2048
        rows += _flash_bwd_case(f"ragged300x340-off40-{name}", dtype, 3, 300,
                                340, 40, True, gen, timed=False,
                                with_dlse=True)
        rows += _flash_bwd_case(f"masked-off-8-{name}", dtype, 3, 64, 64, -8,
                                True, gen, timed=False)
        for residual in (False, True):
            rows += _rmsnorm_case(f"odd1000x1000-{name}", dtype, 1000, 1000,
                                  residual, gen, timed=False)
            # the MoE step's width, timed; a width that is not whole
            # 16-byte vectors in bf16, one row, and unaligned starts
            rows += _rmsnorm_case(f"moe-{name}", dtype, 8192, 1536,
                                  residual, gen)
            rows += _rmsnorm_case(f"odd33x1001-{name}", dtype, 33, 1001,
                                  residual, gen, timed=False)
            rows += _rmsnorm_case(f"one-row-{name}", dtype, 1, 2048,
                                  residual, gen, timed=False)
            rows += _rmsnorm_case(f"unaligned-{name}", dtype, 65, 2048,
                                  residual, gen, timed=False, start=1)
        rows += _rope_case(f"odd-off2000-{name}", dtype, (3, 37, 5, 64),
                           2000, 1e4, gen, timed=False)
        # head dims 6 (not whole vectors) and 16, a start one element off a
        # 16-byte boundary, a position offset of 2041, theta 5e5
        for case in ((f"d6-off2041-{name}", (2, 7, 3, 6), 2041, 1e4,
                      "contiguous"),
                     (f"d6-bhsd-{name}", (2, 7, 3, 6), 0, 1e4, "bhsd"),
                     (f"d16-bhsd-{name}", (2, 9, 3, 16), 2041, 1e4, "bhsd"),
                     (f"offset1-{name}", (3, 17, 5, 128), 2041, 1e4,
                      "offset1"),
                     (f"theta5e5-{name}", (1, 2048, 2, 128), 0, 5e5,
                      "contiguous")):
            rows += _rope_case(case[0], dtype, *case[1:4], gen, timed=False,
                               layout=case[4])
        _release()
    return rows


# -- phases: training parity and the training step ------------------------------

# the 1.16B Llama of the JAX package's flagship training bench
# (bench.py _configs()["big"]): vocab 32000, hidden 2048, 5632, 20 layers,
# 16 heads of 128 (no GQA), 2048 positions
BIG = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
           num_hidden_layers=20, num_attention_heads=16,
           num_key_value_heads=16, max_position_embeddings=2048)
# fp32 parity, kernels against plain-swapped: both compute in fp32 and
# differ by summation order; loss rtol 1e-5, each parameter's gradient
# within 1e-4 relative L2, the 3-step AdamW curve within rtol 1e-4
PARITY_LOSS_RTOL, PARITY_GRAD_TOL, PARITY_CURVE_RTOL = 1e-5, 1e-4, 1e-4
# bf16 full-depth gradient check: the largest relative L2 error of any
# parameter's gradient, kernels against plain-swapped. About 3x the sound
# reading (0.045, layer 17's k_proj; bf16 rounding on two paths through 20
# layers); the planted faults read 1.31 (RoPE) and 43.8 (dQ) and more
TRAIN_GRAD_TOL = 0.15
TRAIN_STEPS = 6


def _flash_module():
    """The module ``paddle_tpu_torch.kernels.flash_attention`` (the package
    re-exports a function of the same name)."""
    import importlib

    return importlib.import_module("paddle_tpu_torch.kernels.flash_attention")


def _plain_swaps():
    """(module, attribute, plain version) for every kernel wrapper that
    the training paths (dense and MoE) call; the autograd functions, the
    MoE MLP and the optimizers look these attributes up at call time."""
    from paddle_tpu_torch.kernels import grouped_matmul as gm
    from paddle_tpu_torch.kernels import moe_dispatch as md
    from paddle_tpu_torch.kernels import rmsnorm, rope

    fa = _flash_module()
    ko = _opt_module()
    return [(fa, "flash_attention_fwd", fa.flash_attention_plain),
            (fa, "flash_attention_bwd_dkv", fa.flash_attention_bwd_dkv_plain),
            (fa, "flash_attention_bwd_dq", fa.flash_attention_bwd_dq_plain),
            (rmsnorm, "rms_norm_fwd", rmsnorm.rms_norm_fwd_plain),
            (rmsnorm, "rms_norm_bwd", rmsnorm.rms_norm_bwd_plain),
            (rope, "rope", rope.rope_plain),
            (md, "route", md.route_plain),
            (md, "gather_rows", md.gather_rows_plain),
            (md, "combine_rows", md.combine_rows_plain),
            (gm, "gmm", gm.gmm_plain), (gm, "tgmm", gm.tgmm_plain)] + [
                (ko, n, getattr(ko, n + "_plain")) for n in OPT_KERNELS]


def _faulty(fault):
    """A planted backward fault: ``dq_unscaled`` drops the softmax scale
    from dQ (the kernel's result times sqrt(d)); ``rope_no_sign`` applies
    the forward rotation, not its inverse, to RoPE's cotangent;
    ``rope_reads_contiguous`` has the inverse read the strided cotangent
    (a [b, s, h, d] view of [b, h, s, d]) as if it were contiguous."""
    import torch

    from paddle_tpu_torch.kernels import rope

    fa = _flash_module()
    if fault == "dq_unscaled":
        real = fa.flash_attention_bwd_dq
        return [(fa, "flash_attention_bwd_dq",
                 lambda *a: real(*a) / a[-1])]
    real = rope.rope
    if fault == "rope_no_sign":
        return [(rope, "rope", lambda x, theta, pos, inverse:
                 real(x, theta, pos, False))]

    def reads_contiguous(x, theta, pos, inverse):
        if inverse and not x.is_contiguous():
            x = x.as_strided(x.shape, torch.empty(x.shape,
                                                  device="meta").stride())
        return real(x, theta, pos, inverse)
    return [(rope, "rope", reads_contiguous)]


class _swapped:
    """Context manager: set module attributes, restore them on exit."""

    def __init__(self, swaps):
        self.swaps = swaps
        self.saved = []

    def __enter__(self):
        self.saved = [(m, a, getattr(m, a)) for m, a, _f in self.swaps]
        for m, a, f in self.swaps:
            setattr(m, a, f)
        return self

    def __exit__(self, *exc):
        for m, a, f in self.saved:
            setattr(m, a, f)
        return False


def _loss_and_grads(model, ids):
    """One forward and backward in training mode: (loss, {name: grad})."""
    model.train()
    model.zero_grad(set_to_none=True)
    loss = model(ids, labels=ids)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def _grad_errors(grads, ref):
    """{name: ||g - ref|| / ||ref||} over every parameter (fp32 norms)."""
    return {n: ((g.float() - ref[n].float()).norm()
                / ref[n].float().norm().clamp_min(1e-30)).item()
            for n, g in grads.items()}


def _worst(errs, k=3):
    return sorted(errs.items(), key=lambda kv: -kv[1])[:k]


def _train_curve(model, state, ids, steps, finetune=False):
    """AdamW lr 3e-4 / wd 0.1 losses; ``finetune``: the JAX package's
    finetune recipe (``bench.py:855-864``), the rate a ``LinearWarmup``
    from 0 over 2 steps (stepped after each) and ClipGradByGlobalNorm(1.0).
    Eager steps (``graph=False``): the plain-swapped reference cannot be
    captured (the plain grouped GEMM reads its group sizes on the host)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, lr

    model.load_state_dict(state)
    sched = lr.LinearWarmup(learning_rate=3e-4, warmup_steps=2,
                            start_lr=0.0, end_lr=3e-4) if finetune else None
    opt = AdamW(learning_rate=sched or 3e-4, parameters=model.parameters(),
                weight_decay=0.1,
                grad_clip=ClipGradByGlobalNorm(1.0) if finetune else None)
    step = TrainStep(model, lambda m, x, y: m(x, labels=y), opt, graph=False)
    losses = []
    for _ in range(steps):
        losses.append(float(step(ids, ids)))
        if sched is not None:
            sched.step()
    return losses


# the kernels of the dense training step in fp32 (the parity phases: the
# 3xTF32 flash forward, dK/dV and dQ; bf16 takes the tensor-core flash
# forward, dK/dV and dQ instead), and their launches per bf16 step as
# reckoned from the code: recompute runs every layer's forward twice, the
# final norm adds one forward and one backward
DENSE_TRAIN_KERNELS = ("flash_attention_tf32x3",
                       "flash_attention_bwd_dkv_tf32x3",
                       "flash_attention_bwd_dq_tf32x3", "rms_norm",
                       "rms_norm_residual", "rms_norm_bwd",
                       "rms_norm_residual_bwd", "rope", "rope_inverse")
# the CUDA-core flash kernels, which no training path at a head dim that is
# a multiple of 8 launches (up to 128 in fp32, up to 256 in bf16)
CUDA_CORE_FLASH = ("flash_attention", "flash_attention_bwd_dkv",
                   "flash_attention_bwd_dq")


def _dense_launches(L):
    """{counter: launches per step} of the bf16 dense training step; every
    other counter 0: all 2L flash forwards and the L dK/dV and L dQ
    launches go to the tensor-core kernels, none to the CUDA-core ones;
    AdamW's update is one ``adam_update`` launch over every parameter."""
    from paddle_tpu_torch import kernels

    per_step = {n: 0 for n in kernels.counters()}
    per_step.update({
        "flash_attention_sm90": 2 * L, "flash_attention_bwd_dkv_sm90": L,
        "flash_attention_bwd_dq_sm90": L, "rms_norm": 2 * L + 1,
        "rms_norm_residual": 2 * L, "rms_norm_bwd": L + 1,
        "rms_norm_residual_bwd": L, "rope": 4 * L, "rope_inverse": 2 * L,
        "adam_update": 1})
    return per_step


def phase_train_parity(seed):
    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.device import seed as pt_seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**{**BIG, "num_hidden_layers": 2}, dtype="float32",
                      use_recompute=True)
    model = LlamaForCausalLM(cfg, device=DEVICE,
                             generator=pt_seed(seed + 3, DEVICE))
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 3)
    ids = torch.randint(0, cfg.vocab_size, (2, 512), generator=gen,
                        device=DEVICE)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    with _swapped(_plain_swaps()):
        loss_p, grads_p = _loss_and_grads(model, ids)
    kernels.reset_counters()
    loss_k, grads_k = _loss_and_grads(model, ids)
    counts = kernels.counters()
    unused = [n for n, c in counts.items() if c["plain_calls"]
              or (c["launches"] == 0 and n in DENSE_TRAIN_KERNELS)
              or (c["launches"] and n in CUDA_CORE_FLASH)]
    if unused:
        raise RuntimeError(f"train-parity: kernels not all launched, or "
                           f"CUDA-core flash launched: "
                           f"{ {n: counts[n] for n in unused} }")
    errs = _grad_errors(grads_k, grads_p)
    del grads_k, grads_p
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    curve_k = _train_curve(model, state, ids, 3)
    with _swapped(_plain_swaps()):
        curve_p = _train_curve(model, state, ids, 3)
    curve_rel = max(abs(a - b) / abs(b) for a, b in zip(curve_k, curve_p))
    # the finetune recipe: warmup and the global-norm clip, whose sums of
    # squares are one multi_tensor_sumsq launch a step
    kernels.reset_counters()
    tune_k = _train_curve(model, state, ids, 3, finetune=True)
    tune_counts = kernels.counters()
    with _swapped(_plain_swaps()):
        tune_p = _train_curve(model, state, ids, 3, finetune=True)
    tune_rel = max(abs(a - b) / abs(b) for a, b in zip(tune_k, tune_p))
    tune_opt = {n: tune_counts[n]["launches"] for n in OPT_KERNELS}
    row = {"phase": "train-parity", "layers": 2, "dtype": "float32",
           "batch": [2, 512], "loss_kernels": loss_k, "loss_plain": loss_p,
           "loss_rel_err": loss_rel, "loss_rtol": PARITY_LOSS_RTOL,
           "grad_rel_l2_max": max(errs.values()),
           "grad_worst": _worst(errs), "grad_tol": PARITY_GRAD_TOL,
           "params_checked": len(errs), "curve_kernels": curve_k,
           "curve_plain": curve_p, "curve_rel_err": curve_rel,
           "curve_rtol": PARITY_CURVE_RTOL, "finetune_kernels": tune_k,
           "finetune_plain": tune_p, "finetune_rel_err": tune_rel,
           "finetune_optimizer_launches": tune_opt}
    _emit(row)
    if not (loss_rel <= PARITY_LOSS_RTOL
            and max(errs.values()) <= PARITY_GRAD_TOL
            and curve_rel <= PARITY_CURVE_RTOL
            and tune_rel <= PARITY_CURVE_RTOL):
        raise RuntimeError(f"train-parity: kernels differ from plain: {row}")
    if tune_opt != {"multi_tensor_sumsq": 3, "adam_update": 3,
                    "adafactor_stats": 0, "adafactor_update": 0} or any(
                        c["plain_calls"] for c in tune_counts.values()):
        raise RuntimeError(f"train-parity: the finetune steps' optimizer "
                           f"launches {tune_opt}")
    if not (curve_k[-1] < curve_k[0] and tune_k[-1] < tune_k[0]):
        raise RuntimeError(f"train-parity: loss did not fall {curve_k} "
                           f"{tune_k}")
    del model, state
    _release()
    return counts, tune_counts


def _train_group(name):
    low = name.lower()
    for key, group in (("tgmm_sm90_kernel", "grouped_gemm_wgrad_sm90"),
                       ("gmm_sm90_kernel", "grouped_gemm_sm90"),
                       ("tgmm_kernel", "grouped_gemm_wgrad"),
                       ("gmm_kernel", "grouped_gemm"),
                       ("moe_route", "moe_route"),
                       ("gather_rows_kernel", "moe_gather"),
                       ("combine_rows_kernel", "moe_combine"),
                       ("flash_decode", "flash_decode"),
                       ("flash_fwd_sm90", "flash_fwd_sm90"),
                       ("flash_bwd_dkv_sm90", "flash_bwd_dkv_sm90"),
                       ("flash_bwd_dq_sm90", "flash_bwd_dq_sm90"),
                       ("flash_fwd_tf32x3", "flash_fwd_tf32x3"),
                       ("flash_bwd_dkv_tf32x3", "flash_bwd_dkv_tf32x3"),
                       ("flash_fwd_kernel", "flash_fwd"),
                       ("flash_bwd_dkv", "flash_bwd_dkv"),
                       ("flash_bwd_dq", "flash_bwd_dq"),
                       ("rmsnorm", "rmsnorm"), ("rope_kernel", "rope"),
                       ("softmax", "ce_softmax"),
                       ("layer_norm", "layernorm"),
                       ("gammabeta", "layernorm"), ("gelu", "gelu"),
                       ("embedding", "embedding"),
                       # csrc/optimizer.cu
                       ("rule_kernel", "optimizer"),
                       ("norms_kernel", "optimizer"),
                       ("norm_apply_kernel", "optimizer"),
                       ("adam_kernel", "optimizer"),
                       ("sumsq_", "optimizer"),
                       ("adafactor_", "optimizer")):
        if key in low:
            return group
    if any(s in low for s in ("gemm", "xmma", "cutlass", "cublas", "nvjet",
                              "sm90_")):
        return "gemm"
    return "other"


def _busy_ms(spans):
    """ms covered by the union of (start, end) spans in us. A kernel
    launched as a programmatic dependent (griddepcontrol: the RMSNorm
    backward's column sum, the routing fix-up, the decode merges) is
    recorded from its early launch, while it still waits on the grid
    before it, so a sum of spans would count that wait twice."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total / 1e3


def _device_ms(prof, group_of):
    """(device ms by kernel name, by group ``group_of(name)``, and in all),
    each the union of its device records' spans, from a profiler session
    (CUPTI's "Command Buffer Full" records mark the host waiting on a full
    launch queue, annotations span other records and ``spin_kernel`` is
    the session's marker (``_train_breakdown``); none of them is work)."""
    import torch

    spans = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                e.name.startswith("Command Buffer") or \
                "spin_kernel" in e.name or \
                getattr(e, "is_user_annotation", False):
            continue
        spans.setdefault(e.name, []).append((e.time_range.start,
                                             e.time_range.end))
    by_group = {}
    for name, sp in spans.items():
        by_group.setdefault(group_of(name), []).extend(sp)
    return ({k: _busy_ms(sp) for k, sp in spans.items()},
            {g: _busy_ms(sp) for g, sp in by_group.items()},
            _busy_ms([x for sp in spans.values() for x in sp]))


def _step_profile(call, group_of=None):
    """One call in one profiler session, closed by a synchronise: wall ms
    by the host clock, events_ms (CUDA events around it: the stream's time
    from its first operation to its last, gaps included, a bound on its
    device time that does not rest on the profiler's records), device ms
    (the union of kernel spans) by group (``group_of``, default
    ``_train_group``) and in all, and the device's idle share of the wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a marker kernel first: in this script's later sessions the
        # first device records of a session went missing (PR 10's first
        # runs lost the optimizer's table copy and its first kernel); the
        # marker is not counted (_device_ms)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev0.record()
        call()
        ev1.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name, groups, device = _device_ms(prof, group_of or _train_group)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall, "events_ms": ev0.elapsed_time(ev1),
            "device_ms": device or None,
            "idle_share": (1.0 - device / wall) if device else None,
            "kernels": len(by_name), "groups_ms": groups,
            "top": [[k[:70], ms] for k, ms in top]}


def _train_breakdown(model, opt, ids):
    """One training step in three phases (forward, backward, optimizer),
    each in its own profiler session (``_step_profile``)."""
    model.train()
    state = {}

    def forward():
        state["loss"] = model(ids, labels=ids)

    def backward():
        state.pop("loss").backward()

    def optimizer():
        opt.step()
        opt.clear_grad()

    phases = {name: _step_profile(fn, (lambda k: "optimizer")
                                  if name == "optimizer" else None)
              for name, fn in (("forward", forward), ("backward", backward),
                               ("optimizer", optimizer))}
    wall = sum(p["wall_ms"] for p in phases.values())
    device = sum(p["device_ms"] or 0.0 for p in phases.values())
    groups = {}
    for p in phases.values():
        for g, ms in p["groups_ms"].items():
            groups[g] = groups.get(g, 0.0) + ms
    return {"wall_ms": wall, "device_ms": device or None,
            "idle_share": (1.0 - device / wall) if device else None,
            "groups_ms": groups, "phases": phases}


# device ms per step of groups before a redesign, the profiled steps on
# an H100 80GB HBM3 at 700 W (PERF.md, section 5): RoPE and "other"
# (elementwise) with the earlier RoPE kernel (angles per element, a
# transposing copy of the cotangent before each inverse) and the combine
# backward's gate scale as three elementwise passes; "rmsnorm" with the
# earlier backward (a block a row, scalar loads) and "moe_route" with the
# earlier routing kernels (32 tokens a block, a one-block scan);
# "optimizer" with the per-tensor update loop (PR 9's run)
EARLIER_GROUPS_MS = {"train": {"rope": 6.7, "other": 34.6, "rmsnorm": 6.39,
                               "optimizer": 74.3},
                     "moe-train": {"rope": 4.1, "other": 34.5,
                                   "rmsnorm": 4.21, "moe_route": 3.36,
                                   "optimizer": 77.5}}


def _beside_earlier(path, breakdown):
    return {g: {"ms": breakdown["groups_ms"].get(g, 0.0), "earlier_ms": ms}
            for g, ms in EARLIER_GROUPS_MS[path].items()}


# -- the graphed step (jit.TrainStep) ------------------------------------------

# the graphed step against the eager one: bit for bit (the same kernels and
# cuBLAS calls on one stream, in the same order; every recorded run was).
# The largest difference is still reported: each parameter's over its
# update ||a - b|| / ||b - before||, each state tensor's ||a - b|| / ||b||;
# the planted stale header (replays keep the first replay's rate and step)
# reads tens of percent there (the bias corrections 1 - b^t move by that
# much per step), and any difference at all fails the check
# PR 10's eager steps at batch 4 (PERF.md section 5; H100 80GB HBM3,
# 700.00 W): step ms, profiled device ms, idle share, peak memory GB
PR10_STEP = {"dense": {"step_ms": 170.8, "device_ms": 164.0,
                       "idle_share": 0.109, "peak_mem_gb": 9.33},
             "moe": {"step_ms": 169.9, "device_ms": 131.8,
                     "idle_share": 0.270, "peak_mem_gb": 6.16}}
# the bench's batches (bench.py:2024 dense 16, bench.py:2031 MoE 8), which
# the steps above cut to 4
BENCH_BATCH = {"dense": 16, "moe": 8}
# the graph's kernel nodes by function name (csrc/), and the counters whose
# launches each add one node of each name; nodes that a bf16 training graph
# must not hold: the CUDA-core attention and grouped GEMM, the earlier
# routing and RMSNorm column-sum kernels
GRAPH_NODES = [
    (("flash_fwd_sm90_kernel", "flash_fwd_sm90_wide_kernel"),
     ("flash_attention_sm90",)),
    (("flash_bwd_dkv_sm90_kernel", "flash_bwd_dkv_sm90_wide_kernel"),
     ("flash_attention_bwd_dkv_sm90",)),
    (("flash_bwd_dq_sm90_kernel", "flash_bwd_dq_sm90_wide_kernel"),
     ("flash_attention_bwd_dq_sm90",)),
    (("flash_fwd_tf32x3_kernel",), ("flash_attention_tf32x3",)),
    (("flash_bwd_dkv_tf32x3_kernel",), ("flash_attention_bwd_dkv_tf32x3",)),
    (("flash_bwd_dq_tf32x3_kernel",), ("flash_attention_bwd_dq_tf32x3",)),
    (("rmsnorm_fwd_vec_kernel", "rmsnorm_fwd_scalar_kernel"),
     ("rms_norm", "rms_norm_residual")),
    (("rmsnorm_bwd_vec_kernel", "rmsnorm_bwd_kernel"),
     ("rms_norm_bwd", "rms_norm_residual_bwd")),
    (("rmsnorm_dw_cols_kernel",), ("rms_norm_bwd", "rms_norm_residual_bwd")),
    (("rope_kernel",), ("rope", "rope_inverse")),
    (("moe_route_mma_kernel", "moe_route_tokens_kernel"), ("moe_route",)),
    (("moe_route_fix_kernel",), ("moe_route",)),
    (("gather_rows_kernel",), ("moe_gather",)),
    (("combine_rows_kernel",), ("moe_combine",)),
    (("gmm_sm90_kernel",), ("grouped_matmul_sm90",
                            "grouped_matmul_dgrad_sm90")),
    (("tgmm_sm90_kernel",), ("grouped_matmul_wgrad_sm90",)),
    (("sumsq_partial_kernel",), ("multi_tensor_sumsq",)),
    (("sumsq_finish_kernel",), ("multi_tensor_sumsq",)),
    (("adam_kernel",), ("adam_update",)),
    (("adafactor_stats_kernel",), ("adafactor_stats",)),
    (("adafactor_finish_kernel",), ("adafactor_stats",)),
    (("adafactor_usq_kernel",), ("adafactor_update",)),
    (("adafactor_apply_kernel",), ("adafactor_update",)),
    (("rule_kernel",), ("sgd_update", "momentum_update", "adagrad_update",
                        "adamax_update", "rmsprop_update",
                        "adadelta_update")),
    (("norms_kernel",), ("lamb_update", "lars_update")),
    (("norm_apply_kernel",), ("lamb_update", "lars_update")),
    (("finite_kernel",), ("check_finite",)),
    (("unscale_kernel",), ("unscale",)),
]
GRAPH_FORBIDDEN = ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
                   "flash_bwd_dq_kernel", "flash_decode", "gmm_kernel",
                   "tgmm_kernel", "route_local_kernel", "route_scan_kernel",
                   "rmsnorm_dw_sum_kernel")


def _graph_nodes(dot):
    """{kernel function name: nodes} of a CUDA graph's debug dump (the DOT
    text of ``cudaGraphDebugDotPrint``: a node's label opens with its type
    and, for a kernel, its mangled name)."""
    import re
    from collections import Counter

    return Counter(name for kind, name in re.findall(
        r'label="\{(\w+)\s*\n\| \{ID \| \d+ \(topoId: \d+\) \| ([^\\}]+)',
        dot) if kind == "KERNEL")


def _count_named(nodes, name):
    """Nodes whose (mangled) function name holds ``name`` as a whole
    identifier: "gmm_kernel" counts no "tgmm_kernel" node."""
    import re

    pat = re.compile(r"(?<![A-Za-z_])" + re.escape(name))
    return sum(c for n, c in nodes.items() if pat.search(n))


def _node_check(nodes, per_step):
    """The graph's node counts against the launches per step reckoned from
    the code: (rows, forbidden nodes, total kernel nodes, ok)."""
    rows, ok = [], True
    for names, counters in GRAPH_NODES:
        want = sum(per_step.get(c, 0) for c in counters)
        got = sum(_count_named(nodes, n) for n in names)
        rows.append({"kernels": list(names), "nodes": got, "reckoned": want})
        ok = ok and got == want
    forbidden = {n: _count_named(nodes, n) for n in GRAPH_FORBIDDEN}
    ok = ok and not any(forbidden.values())
    return rows, forbidden, sum(nodes.values()), ok


def _snapshot(model, opt):
    """Clones of every parameter and optimizer state tensor."""
    out = {n: p.detach().clone() for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        for k, v in opt._state.get(id(p), {}).items():
            out[f"{n}.{k}"] = v.clone()
    return out


def _agreement(got, ref, before):
    """(every tensor equal bit for bit, the largest relative difference, its
    tensor): a parameter's difference over its update from ``before``, a
    state tensor's over its norm."""
    import torch

    worst, where, same = 0.0, None, True
    for k, r in ref.items():
        g = got[k]
        if torch.equal(g, r):
            continue
        same = False
        scale = (r.float() - before[k].float()).norm() if k in before \
            else r.float().norm()
        rel = ((g.float() - r.float()).norm() /
               scale.clamp_min(1e-30)).item()
        if rel > worst:
            worst, where = rel, k
    return same, worst, where


def _stale_header():
    """A planted fault: replays keep the table header their capture's first
    replay wrote (its rate and step, so Adam's and Adafactor's step-dependent
    corrections stay at that step's)."""
    kopt = _opt_module()
    real = kopt.StepBatch.set_step

    def stale(self, lr, step):
        if self._table is None or self._pending:
            return real(self, lr, step)
        return None
    return [(kopt.StepBatch, "set_step", stale)]


def _timed(step, ids, n, tick=False):
    """(losses, host ms of each call, each ending in a synchronise); with
    ``tick`` the optimizer's LR schedule steps after each call."""
    losses, ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        losses.append(float(step(ids, ids)))
        ms.append((time.perf_counter() - t0) * 1e3)
        if tick:
            step.optimizer._learning_rate.step()
    return losses, ms


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _reckoned(gstep):
    """The graphed run's launches in the counters' form: the wrappers'
    counts (eager warm-up steps and the captures) plus each graph's
    captured launches times its replays."""
    from paddle_tpu_torch import kernels

    counts = kernels.counters()
    for n, c in gstep.captured_launches().items():
        counts[n]["launches"] += c
    return counts


def _graph_run(path, model, make_opt, ids, steps, per_step, flops, ref,
               ref_losses, state0, tick=False):
    """The graphed ``TrainStep`` on the weights ``state0``: ``steps`` steps
    (an eager warm-up, the capture and its replay, replays), launches
    reckoned and held exactly to ``per_step`` x (steps + 1) (the capture's
    launches are counted once when the wrappers run, then replayed), the
    capture's debug dump node by node against ``per_step``, every loss,
    parameter and state tensor against the eager run (``ref``), the planted
    stale header caught, step times and one profiled replay. ``tick``: the
    optimizer's LR schedule steps after each call, in the planted run too
    (``_timed``)."""
    import os
    import tempfile

    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.jit import TrainStep

    def fresh():
        model.load_state_dict(state0)
        opt = make_opt()
        return opt, TrainStep(model, lambda m, x, y: m(x, labels=y), opt)

    before = {n: t.detach().clone() for n, t in state0.items()}
    # the check's own copies, which the peak leaves out
    held = _nbytes(ref.values()) + 2 * _nbytes(state0.values())
    opt, gstep = fresh()
    _release()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    with tempfile.TemporaryDirectory() as tmp:
        gstep.debug_dump = os.path.join(tmp, "step.dot")
        losses, ms = _timed(gstep, ids, steps, tick)
        dot = open(gstep.debug_dump).read()
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 2**30
    counts = _reckoned(gstep)
    entry = next(iter(gstep._graphs.values()))
    captured = entry.counts
    wrong = {n: (c, per_step[n] * (steps + 1)) for n, c in counts.items()
             if c["plain_calls"] or
             c["launches"] != per_step[n] * (steps + 1)}
    if wrong or captured != {n: c for n, c in per_step.items() if c}:
        raise RuntimeError(f"{path}-graph: launches differ from the "
                           f"reckoned (reading, expected): {wrong}, "
                           f"captured {captured}")
    rows, forbidden, total_nodes, nodes_ok = _node_check(_graph_nodes(dot),
                                                         per_step)
    got = _snapshot(model, opt)
    same, worst, where = _agreement(got, ref, before)
    loss_same = losses == ref_losses
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    del got
    profile_ = _step_profile(lambda: gstep(ids, ids))
    batch, seq = ids.shape
    step_ms = sum(ms[2:]) / len(ms[2:])
    tok_s = batch * seq / step_ms * 1e3
    del gstep, opt, entry
    _release()

    # the planted fault: replays without their header update
    with _swapped(_stale_header()):
        opt, fstep = fresh()
        flosses, _ = _timed(fstep, ids, steps, tick)
        fgot = _snapshot(model, opt)
    fsame, fworst, fwhere = _agreement(fgot, ref, before)
    del fstep, opt, fgot
    _release()
    check = {"phase": f"{path}-graph-check", "steps": steps,
             "bitwise": same and loss_same, "max_rel_diff": worst,
             "max_rel_where": where, "loss_max_rel_diff": loss_rel,
             "limit": "bit for bit", "nodes": rows,
             "forbidden_nodes": forbidden, "kernel_nodes": total_nodes,
             "captured_launches_per_step": captured,
             "fault_stale_header": {"max_rel_diff": fworst,
                                    "where": fwhere,
                                    "caught": not (fsame and
                                                   flosses == ref_losses)}}
    _emit(check)
    if not (same and loss_same):
        raise RuntimeError(f"{path}-graph: the graphed step differs from "
                           f"the eager one {check}")
    if not nodes_ok:
        raise RuntimeError(f"{path}-graph: the graph's kernel nodes differ "
                           f"from the reckoned launches {check}")
    if not check["fault_stale_header"]["caught"]:
        raise RuntimeError(f"{path}-graph: the check missed the stale "
                           f"header {check}")
    return counts, {"losses": losses, "step_ms": step_ms,
                    "step_ms_each": ms, "tokens_per_s": tok_s,
                    "mfu": flops * tok_s / PEAK_FLOPS["bfloat16"],
                    "peak_mem_gb": peak_gb, "profile": profile_}


def _bench_batch(path, model, make_opt, vocab, seed, flops, state0):
    """The steps at the bench's batch (``BENCH_BATCH``) x 2048: the eager
    and the graphed step, each from ``state0``: step ms over the steps
    after the first (eager) or after the capture (graph), tokens/s, MFU,
    peak memory and one profiled step."""
    import torch

    from paddle_tpu_torch.jit import TrainStep

    batch, seq = BENCH_BATCH[path], 2048
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    ids = torch.randint(0, vocab, (batch, seq), generator=gen,
                        device=DEVICE)
    out = {"batch": [batch, seq]}
    held = _nbytes(state0.values())  # the check's copy, left out of the peak
    for graph, n, skip in ((False, 3, 1), (True, 4, 2)):
        model.load_state_dict(state0)
        step = TrainStep(model, lambda m, x, y: m(x, labels=y), make_opt(),
                         graph=graph)
        _release()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = _timed(step, ids, n)
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        prof = _step_profile(lambda: step(ids, ids))
        step_ms = sum(ms[skip:]) / len(ms[skip:])
        tok_s = batch * seq / step_ms * 1e3
        if not all(x == x for x in losses):
            raise RuntimeError(f"{path}: a loss at batch {batch} is NaN")
        out["graph" if graph else "eager"] = {
            "losses": losses, "step_ms": step_ms, "step_ms_each": ms,
            "tokens_per_s": tok_s,
            "mfu": flops * tok_s / PEAK_FLOPS["bfloat16"],
            "peak_mem_gb": peak, "profile": prof}
        del step
        _release()
    return out


def _side_by_side(path, eager, graph, eager_profile):
    """The batch-4 figures of the graphed and the eager step and PR 10's."""
    def row(r, prof):
        return {"step_ms": r["step_ms"], "tokens_per_s": r["tokens_per_s"],
                "mfu": r["mfu"], "peak_mem_gb": r["peak_mem_gb"],
                "events_ms": prof["events_ms"],
                "device_ms": prof["device_ms"],
                "idle_share": prof["idle_share"],
                "profiled_wall_ms": prof["wall_ms"]}
    return {"phase": f"{path}-steps", "graph": row(graph, graph["profile"]),
            "eager": row(eager, eager_profile), "pr10_eager": PR10_STEP[path],
            "graph_groups_ms": graph["profile"]["groups_ms"]}


def phase_train(seed):
    import math

    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.device import seed as pt_seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         llama_flops_per_token,
                                         llama_param_count)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig(**BIG, dtype="bfloat16", use_recompute=True)
    batch, seq = 4, 2048
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=DEVICE,
                             generator=pt_seed(seed + 4, DEVICE))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 4)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                        device=DEVICE)

    # gradients at full depth, on the initial weights: kernels against the
    # plain-swapped step, and three planted backward faults that must fail
    with _swapped(_plain_swaps()):
        loss_p, grads_p = _loss_and_grads(model, ids)
    loss_k, grads_k = _loss_and_grads(model, ids)
    sound = _grad_errors(grads_k, grads_p)
    del grads_k
    faults = {}
    for fault in ("dq_unscaled", "rope_no_sign", "rope_reads_contiguous"):
        with _swapped(_faulty(fault)):
            _l, grads_f = _loss_and_grads(model, ids)
        errs = _grad_errors(grads_f, grads_p)
        del grads_f
        faults[fault] = {"grad_rel_l2_max": max(errs.values()),
                         "worst": _worst(errs, 1),
                         "caught": max(errs.values()) > TRAIN_GRAD_TOL}
    del grads_p
    _release()
    check = {"phase": "train-grad-check", "layers": cfg.num_hidden_layers,
             "dtype": "bfloat16", "loss_kernels": loss_k,
             "loss_plain": loss_p, "grad_rel_l2_max": max(sound.values()),
             "grad_worst": _worst(sound), "grad_tol": TRAIN_GRAD_TOL,
             "faults": faults}
    _emit(check)
    if not max(sound.values()) <= TRAIN_GRAD_TOL:
        raise RuntimeError(f"train: kernel gradients differ from plain "
                           f"{check}")
    if not all(f["caught"] for f in faults.values()):
        raise RuntimeError(f"train: the gradient check missed a planted "
                           f"fault {faults}")

    def make_opt():
        return AdamW(learning_rate=3e-4, parameters=model.parameters(),
                     weight_decay=0.1)

    # the eager step (graph=False): the reference the graphed step is held to
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_opt()
    step = TrainStep(model, lambda m, x, y: m(x, labels=y), opt, graph=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    losses, ms = _timed(step, ids, TRAIN_STEPS)
    counts = kernels.counters()
    # the check's copy of the weights is left out of the peak
    peak_gb = (torch.cuda.max_memory_allocated() -
               _nbytes(state0.values())) / 2**30
    L = cfg.num_hidden_layers
    per_step = _dense_launches(L)
    wrong = {n: (c, per_step[n] * TRAIN_STEPS) for n, c in counts.items()
             if c["plain_calls"] or
             c["launches"] != per_step[n] * TRAIN_STEPS}
    if wrong:
        raise RuntimeError(f"train: kernel counts differ from the expected "
                           f"(reading, expected launches): {wrong}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise RuntimeError(f"train: loss not finite and falling: {losses}")
    ref = _snapshot(model, opt)
    step_ms = sum(ms[1:]) / (len(ms) - 1)
    tok_s = batch * seq / step_ms * 1e3
    flops = llama_flops_per_token(cfg, seq)
    mfu = flops * tok_s / PEAK_FLOPS["bfloat16"]
    breakdown = _train_breakdown(model, opt, ids)
    eager_profile = _step_profile(lambda: step(ids, ids))
    _emit({"phase": "train", "ok": True, "model": "llama-1.16b",
           "graph": False, "params": llama_param_count(cfg), "layers": L,
           "dtype": "bfloat16", "recompute": True, "batch": [batch, seq],
           "model_init_s": t_init, "losses": losses,
           "step_ms": step_ms, "step_ms_each": ms,
           "tokens_per_s": tok_s, "mfu": mfu, "peak_mem_gb": peak_gb,
           "kernel_counts": counts,
           "expected_launches_per_step": per_step})
    _emit({"phase": "train-breakdown", **breakdown,
           "beside_earlier": _beside_earlier("train", breakdown)})
    eager = {"step_ms": step_ms, "tokens_per_s": tok_s, "mfu": mfu,
             "peak_mem_gb": peak_gb}
    del step, opt
    _release()

    # the graphed step, the main path: against the eager run above
    graph_counts, graph = _graph_run("train", model, make_opt, ids,
                                     TRAIN_STEPS, per_step, flops, ref,
                                     losses, state0)
    del ref
    _release()
    _emit({**_side_by_side("dense", eager, graph, eager_profile),
           "losses": graph["losses"], "step_ms_each": graph["step_ms_each"],
           "kernel_counts": graph_counts})
    _emit({"phase": "train-bench-batch",
           **_bench_batch("dense", model, make_opt, cfg.vocab_size,
                          seed + 40, flops, state0)})
    accumulate = _accumulate_check(model, make_opt, cfg, seed, state0)
    rule_counts, rule_rows = _rule_steps(model, cfg, ids, flops, state0)
    scaler = _scaler_check(model, ids, state0)
    shapes = [tuple(p.shape) for p in model.parameters()]
    del model, state0
    _release()
    return (graph_counts, counts, accumulate, shapes, rule_counts, rule_rows,
            scaler)


ACC_STEPS, ACC_WINDOWS = 2, 3


def _accumulate_check(model, make_opt, cfg, seed, state0):
    """``TrainStep.accumulate(2)`` on the dense model at batch 8 x 2048,
    three windows as a graph (an eager warm-up window, the capture, a
    replay) against the eager recipe with fp32 accumulation (each
    microbatch's backward, its bf16 gradients added into fp32 sums scaled
    by 1/2, one ``Optimizer._apply`` from the sums, whose kernels read the
    fp32 gradients beside the bf16 parameters): each window's loss against
    the mean of its two microbatch losses, then every parameter and state
    tensor, bit for bit; the launches reckoned exactly (one optimizer
    update a window)."""
    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.jit import TrainStep

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 41)
    ids = torch.randint(0, cfg.vocab_size, (8, 2048), generator=gen,
                        device=DEVICE)
    micro = ids.reshape(ACC_STEPS, 8 // ACC_STEPS, 2048)
    before = {n: t.detach().clone() for n, t in state0.items()}

    model.load_state_dict(state0)
    opt = make_opt()
    params = list(model.parameters())
    model.train()
    ref_losses = []
    for _ in range(ACC_WINDOWS):
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=DEVICE)
               for p in params]
        mls = []
        for mb in micro:
            loss = model(mb, labels=mb)
            loss.backward()
            with torch.no_grad():
                for a, p in zip(acc, params):
                    a.add_(p.grad.float() * (1.0 / ACC_STEPS))
            model.zero_grad(set_to_none=True)
            mls.append(loss.detach().float())
        ref_losses.append(float(torch.stack(mls).mean()))
        opt._apply(acc)
        opt._global_step += 1
        del acc
    # the last loss's autograd graph holds the parameters' gradient
    # accumulators, made on this (the default) stream: a capture whose
    # backward met them would make the default stream wait on it
    del loss, mls
    ref = _snapshot(model, opt)
    del opt
    _release()

    model.load_state_dict(state0)
    opt = make_opt()
    step = TrainStep(model, lambda m, x, y: m(x, labels=y), opt) \
        .accumulate(ACC_STEPS)
    kernels.reset_counters()
    losses, ms = _timed(step, ids, ACC_WINDOWS)
    counts = _reckoned(step)
    per_window = {n: ACC_STEPS * c for n, c in
                  _dense_launches(cfg.num_hidden_layers).items()}
    per_window["adam_update"] = 1
    wrong = {n: (c, per_window[n] * (ACC_WINDOWS + 1))
             for n, c in counts.items() if c["plain_calls"] or
             c["launches"] != per_window[n] * (ACC_WINDOWS + 1)}
    got = _snapshot(model, opt)
    same, worst, where = _agreement(got, ref, before)
    loss_same = losses == ref_losses
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    del got, ref, step, opt
    _release()
    row = {"phase": "accumulate-check", "steps": ACC_STEPS,
           "windows": ACC_WINDOWS, "batch": [8, 2048], "losses": losses,
           "eager_recipe_losses": ref_losses, "bitwise": same and loss_same,
           "max_rel_diff": worst, "max_rel_where": where,
           "loss_max_rel_diff": loss_rel, "limit": "bit for bit",
           "window_ms_each": ms}
    _emit(row)
    if wrong:
        raise RuntimeError(f"accumulate: launches differ from the reckoned "
                           f"(reading, expected): {wrong}")
    if not (same and loss_same):
        raise RuntimeError(f"accumulate: the graphed window differs from "
                           f"the eager recipe {row}")
    return counts


# -- phase: MoE kernels -------------------------------------------------------

def _gmm_tol(dtype):
    """(rtol, atol) of the grouped GEMM kernels against their plain versions
    on fp32 copies of the same inputs, which are scaled so that the outputs
    are O(1): fp32 order differences stay near 1e-6; bf16 adds one rounding
    of the result (2**-8 of the value)."""
    import torch

    return (1e-5, 1e-4) if dtype == torch.float32 else (2.0 ** -8, 1e-4)


def _gmm_case(label, dtype, sizes, k, n, gen, timed=True):
    """Forward, dgrad and wgrad kernels on ``sizes`` row groups (a device
    int32 tensor or a list): lhs [m, k] / sqrt(k), rhs [g, k, n], dout
    [m, n] / sqrt(n), so that the forward and dgrad outputs are O(1). bf16
    runs the tensor-core kernels, timed beside the CUDA-core ones on the
    same inputs; fp32 the CUDA-core ones. Returns one row per kernel."""
    import torch

    from paddle_tpu_torch.kernels import grouped_matmul as gm

    gs = torch.as_tensor(sizes, dtype=torch.int32, device=DEVICE)
    host = gs.tolist()
    m, g = int(sum(host)), len(host)
    lhs = (_rand(gen, (m, k), torch.float32) / k ** 0.5).to(dtype)
    rhs = _rand(gen, (g, k, n), dtype)
    dout = (_rand(gen, (m, n), torch.float32) / n ** 0.5).to(dtype)
    out = gm.gmm(lhs, rhs, gs)
    d_lhs = gm.gmm(dout, rhs, gs, trans_rhs=True)
    d_rhs = gm.tgmm(lhs, dout, gs)
    torch.cuda.synchronize()
    f32 = [t.float() for t in (lhs, rhs, dout)]
    tol = _gmm_tol(dtype)
    sm90 = gm.takes_sm90(dtype)
    names = tuple(nm + ("_sm90" if sm90 else "") for nm in (
        "grouped_matmul", "grouped_matmul_dgrad", "grouped_matmul_wgrad"))
    errs = [_compare(f"{names[0]}[{label}]", out,
                     gm.gmm_plain(f32[0], f32[1], gs), tol)[0],
            _compare(f"{names[1]}[{label}]", d_lhs,
                     gm.gmm_plain(f32[2], f32[1], gs, True), tol)[0],
            _compare(f"{names[2]}[{label}]", d_rhs,
                     gm.tgmm_plain(f32[0], f32[2], gs), tol)[0]]
    for j, size in enumerate(host):
        if size == 0 and d_rhs[j].abs().max().item() != 0.0:
            raise RuntimeError(f"{names[2]}[{label}]: empty group {j} has a "
                               f"non-zero gradient")
    del f32
    base = {"phase": "kernel", "case": label, "dtype": _dname(dtype),
            "m": m, "k": k, "n": n, "groups": g,
            "group_sizes": host if g <= 16 else None, "tol": tol}
    rows = [dict(base, kernel=nm, max_abs_err=err)
            for nm, err in zip(names, errs)]
    if timed:
        ranges, start = [], 0
        for size in host:
            ranges.append((start, start + size))
            start += size
        rhs_t = rhs.transpose(1, 2)
        calls = (
            (lambda: gm.gmm(lhs, rhs, gs),
             lambda: gm.gmm_cuda_core(lhs, rhs, gs),
             lambda: gm.gmm_plain(lhs, rhs, gs),
             lambda: [lhs[a:b] @ rhs[j] for j, (a, b) in enumerate(ranges)],
             m * k + g * k * n + m * n),
            (lambda: gm.gmm(dout, rhs, gs, trans_rhs=True),
             lambda: gm.gmm_cuda_core(dout, rhs, gs, trans_rhs=True),
             lambda: gm.gmm_plain(dout, rhs, gs, True),
             lambda: [dout[a:b] @ rhs_t[j] for j, (a, b) in enumerate(ranges)],
             m * n + g * k * n + m * k),
            (lambda: gm.tgmm(lhs, dout, gs),
             lambda: gm.tgmm_cuda_core(lhs, dout, gs),
             lambda: gm.tgmm_plain(lhs, dout, gs),
             lambda: [lhs[a:b].t() @ dout[a:b] for a, b in ranges],
             m * k + m * n + g * k * n))
        for row, (kern, cuda_core, plain, lib, elems) in zip(rows, calls):
            # the yardstick is a per-group loop of cuBLAS products in the
            # inputs' type: the port never calls it
            b_ms, b_by = _bound(elems * lhs.element_size(), 2 * m * k * n,
                                _dname(dtype))
            row.update(kernel_ms=_time_ms(kern, iters=10, warmup=2),
                       plain_ms=_time_ms(plain, iters=5, warmup=1),
                       library_ms=_time_ms(lib, iters=10, warmup=2),
                       library="per-group torch.matmul loop (cuBLAS)",
                       bound_ms=b_ms, bound_by=b_by,
                       tflops=2 * m * k * n / 1e9)
            row["tflop_per_s"] = row["tflops"] / row["kernel_ms"]
            if sm90:  # the CUDA-core kernel on the same inputs
                row["cuda_core_ms"] = _time_ms(cuda_core, iters=3, warmup=1)
    for row in rows:
        _emit(row)
    return rows


def _route_inputs(dtype, n, h, e, seed, special=False):
    """Router inputs drawn with numpy (x ~ N(0, 1), wg ~ N(0, 0.3^2)), so
    that their top-k margin can be checked off the card; with ``special``
    expert e-1 gets no row and expert e-2 exactly one (token 0)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h), dtype=np.float32)
    wg = 0.3 * rng.standard_normal((h, e), dtype=np.float32)
    if special:
        x[:, 0] = 4.0
        x[:, 1] = 0.0
        x[0, 1] = 4.0
        wg[0, e - 1] = wg[0, e - 2] = -4.0
        wg[1, e - 2] = 12.0
    return (torch.from_numpy(x).to(DEVICE).to(dtype),
            torch.from_numpy(wg).to(DEVICE).to(dtype))


def _logit_margin(xt, wg, k):
    """Smallest gap between consecutive fp64 logits among a token's top
    k + 1. The kernel's and the plain version's fp32 logits differ by
    summation order (~2e-5 at h = 1536); above 1e-4 no near-tie decides a
    choice, and choices, positions and counts must agree exactly."""
    logits = xt.double() @ wg.double()
    top = logits.sort(dim=1, descending=True).values[:, :k + 1]
    return (top[:, :-1] - top[:, 1:]).min().item()


def _earlier_route(xt, wg, k):
    """The earlier routing kernels (32 tokens a block, a one-block scan)
    on the same inputs, for timing beside the new ones: a call that
    launches them and returns (route's six outputs, its scratch)."""
    import ctypes

    import torch

    from paddle_tpu_torch.kernels import _build

    n, h = xt.shape
    e, dev = wg.shape[1], xt.device
    outs = [torch.empty(n, k, device=dev),
            torch.empty(n, k, dtype=torch.int32, device=dev),
            torch.empty(n, k, dtype=torch.int32, device=dev),
            torch.empty(e, dtype=torch.int32, device=dev),
            torch.empty(e, device=dev), torch.empty(e, device=dev)]
    # per block of 32 tokens: counts, probability sums, top-1 counts
    scratch = torch.empty(3, -(-n // 32), e, dtype=torch.int32, device=dev)
    fn = _build.kernel("pt_moe_route_earlier", [ctypes.c_void_p] * 2 +
                       [ctypes.c_int] * 4 + [ctypes.c_void_p] * 9 +
                       [ctypes.c_int, ctypes.c_void_p])
    args = (xt.data_ptr(), wg.data_ptr(), n, h, e, k,
            *[t.data_ptr() for t in outs],
            *[scratch[i].data_ptr() for i in range(3)],
            int(xt.dtype == torch.bfloat16))

    def call():  # holds every buffer whose pointer it passes
        _build.launch(fn, "pt_moe_route_earlier", dev, *args)
        return outs, scratch
    return call


def _route_case(label, dtype, n, h, e, k, seed, special=False, timed=True):
    """The routing kernel against its plain version: choices, positions,
    counts and top-1 counts exact, gates within 1e-4 and probability sums
    within rtol 1e-4 (the fp32 logits differ by ~2e-5). Timed: eager and in
    graph replay, beside the earlier routing kernels on the same inputs
    (which must route alike) and a copy of x's bytes. Returns (row, the
    kernel's counts)."""
    import torch

    from paddle_tpu_torch.kernels import moe_dispatch as md

    xt, wg = _route_inputs(dtype, n, h, e, seed, special)
    margin = _logit_margin(xt, wg, k)
    if not margin > 1e-4:
        raise RuntimeError(f"moe_route[{label}]: inputs have a near-tie "
                           f"(margin {margin}); the exact check needs > 1e-4")
    got = md.route(xt, wg, k)
    torch.cuda.synchronize()
    ref = md.route_plain(xt, wg, k)
    names = ("gv", "gi", "pos", "cnt", "me", "ce")
    for name, a, b in zip(names, got, ref):
        if name in ("gi", "pos", "cnt", "ce") and not torch.equal(a, b):
            bad = (a != b).sum().item()
            raise RuntimeError(f"moe_route[{label}].{name}: {bad} entries "
                               f"differ from the plain version")
    err = _compare(f"moe_route[{label}].gv", got[0], ref[0], (0.0, 1e-4))[0]
    _compare(f"moe_route[{label}].me", got[4], ref[4], (1e-4, 1e-4))
    again = md.route(xt, wg, k)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise RuntimeError(f"moe_route[{label}]: two runs differ")
    cnt = got[3]
    if special and not (cnt[e - 1].item() == 0 and cnt[e - 2].item() == 1):
        raise RuntimeError(f"moe_route[{label}]: counts {cnt.tolist()}")
    row = {"phase": "kernel", "kernel": "moe_route", "case": label,
           "dtype": _dname(dtype), "n": n, "h": h, "e": e, "top_k": k,
           "margin": margin, "max_abs_err": err, "tol": (0.0, 1e-4),
           "counts": cnt.tolist() if e <= 16 else None}
    if timed:
        esz = xt.element_size()
        nbytes = (n * h + h * e) * esz + n * k * 12 + 3 * e * 4
        b_ms, b_by = _bound(nbytes, 2 * n * h * e, "float32")
        earlier = _earlier_route(xt, wg, k)
        e_out = earlier()[0]
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(e_out[1:4], got[1:4])):
            raise RuntimeError(f"moe_route[{label}]: the earlier kernels "
                               f"route otherwise")
        # a copy that moves x's bytes (half of x read, half written)
        half = xt[:n // 2]
        c_out = torch.empty_like(half)

        def kernel():
            return md.route(xt, wg, k)

        row.update(kernel_ms=_time_ms(kernel), graph_ms=_graph_ms(kernel),
                   plain_ms=_time_ms(lambda: md.route_plain(xt, wg, k)),
                   earlier_ms=_time_ms(earlier),
                   earlier_graph_ms=_graph_ms(earlier),
                   copy_graph_ms=_graph_ms(lambda: c_out.copy_(half)),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by)
    _emit(row)
    return row, cnt


def _rows_case(label, dtype, n, k, h, gen, timed=True):
    """Gather (exact), scaled gather (exact) and combine (``_tol``) kernels
    against their plain versions: gather [n * k] rows of a [n, h] source,
    each source row k times in a shuffled order (as the dispatch's ``g2f //
    k`` does), the same with an fp32 row scale (the combine's backward:
    gathered cotangent times each row's gate), and combine [n * k, h] rows
    into [n, h] through a permutation with fp32 gates. Timed: the gather
    eager and in graph replay beside ``index_select`` (both ways) and two
    copies (graph): one that moves the bytes the bound counts, one of the
    output; the scaled gather both ways beside the composition it
    replaces (gather, fp32 copy, multiply, cast)."""
    import torch
    import torch.nn.functional as TF

    from paddle_tpu_torch.kernels import moe_dispatch as md

    src = _rand(gen, (n, h), dtype)
    idx = (torch.randperm(n * k, generator=gen, device=DEVICE) // k).to(
        torch.int32)
    scale = torch.rand(n * k, generator=gen, device=DEVICE)
    y = _rand(gen, (n * k, h), dtype)
    dest2 = torch.randperm(n * k, generator=gen, device=DEVICE).to(
        torch.int32).view(n, k)
    gates = torch.rand(n, k, generator=gen, device=DEVICE)
    out = md.gather_rows(src, idx)
    out_s = md.gather_rows(src, idx, scale)
    comb = md.combine_rows(y, gates, dest2)
    torch.cuda.synchronize()
    if not torch.equal(out, md.gather_rows_plain(src, idx)):
        raise RuntimeError(f"moe_gather[{label}]: differs from the plain "
                           f"version")
    if not torch.equal(out_s, md.gather_rows_plain(src, idx, scale)):
        raise RuntimeError(f"moe_gather_scaled[{label}]: differs from the "
                           f"plain version")
    err = _compare(f"moe_combine[{label}]", comb,
                   md.combine_rows_plain(y.float(), gates, dest2),
                   _tol(dtype))[0]
    base = {"phase": "kernel", "case": label, "dtype": _dname(dtype),
            "n": n, "top_k": k, "h": h}
    rows = [dict(base, kernel="moe_gather", max_abs_err=0.0, tol="exact"),
            dict(base, kernel="moe_gather_scaled", max_abs_err=0.0,
                 tol="exact"),
            dict(base, kernel="moe_combine", max_abs_err=err,
                 tol=_tol(dtype))]
    if timed:
        esz = src.element_size()
        # the gather reads each source row that idx names once (and the
        # scaled one its fp32 scale)
        rows_read = torch.unique(idx).numel()
        g_bytes = (rows_read + n * k) * h * esz + n * k * 4
        b_g = _bound(g_bytes, 0, "float32")
        b_s = _bound(g_bytes + n * k * 4, n * k * h, "float32")
        b_c = _bound((n * k * h + n * h) * esz + n * k * 8, 2 * n * k * h,
                     "float32")
        # a copy that moves the bytes the bound counts, and one of the
        # output: the card's practical rates for this traffic
        half_rows = (rows_read + n * k) // 2
        a_in = torch.empty(half_rows, h, dtype=dtype, device=DEVICE)
        a_out = torch.empty_like(a_in)
        o_buf = torch.empty_like(out)

        def gather():
            return md.gather_rows(src, idx)

        def scaled():
            return md.gather_rows(src, idx, scale)

        def composition():
            return (md.gather_rows(src, idx).float() *
                    scale[:, None]).to(dtype)

        def index_select():
            return torch.index_select(src, 0, idx)

        rows[0].update(kernel_ms=_time_ms(gather), graph_ms=_graph_ms(gather),
                       plain_ms=_time_ms(
                           lambda: md.gather_rows_plain(src, idx)),
                       library_ms=_time_ms(index_select),
                       library_graph_ms=_graph_ms(index_select),
                       library="torch.index_select",
                       copy_graph_ms=_graph_ms(lambda: a_out.copy_(a_in)),
                       copy_out_graph_ms=_graph_ms(lambda: o_buf.copy_(out)),
                       bound_ms=b_g[0], bound_by=b_g[1])
        rows[1].update(kernel_ms=_time_ms(scaled), graph_ms=_graph_ms(scaled),
                       plain_ms=_time_ms(
                           lambda: md.gather_rows_plain(src, idx, scale)),
                       composition_ms=_time_ms(composition),
                       composition_graph_ms=_graph_ms(composition),
                       library_ms=None, bound_ms=b_s[0], bound_by=b_s[1])
        # the combine's yardstick: embedding_bag's weighted sum of the
        # rows that each token's k indices name (gates in y's dtype)
        bags, weights = dest2.long(), gates.to(dtype)
        rows[2].update(kernel_ms=_time_ms(
            lambda: md.combine_rows(y, gates, dest2)),
            plain_ms=_time_ms(lambda: md.combine_rows_plain(y, gates, dest2)),
            library_ms=_time_ms(lambda: TF.embedding_bag(
                bags, y, per_sample_weights=weights, mode="sum")),
            library="torch.nn.functional.embedding_bag",
            bound_ms=b_c[0], bound_by=b_c[1])
    for row in rows:
        _emit(row)
    return rows


def _gather_case(label, dtype, n_src, n_out, h, gen, special=False):
    """The gather, unscaled and scaled, equal to its plain version at an
    odd shape; ``special``: indices -1 and n_src (zero rows) and scales
    of 0, -0 and below 0 in the first rows."""
    import torch

    from paddle_tpu_torch.kernels import moe_dispatch as md

    src = _rand(gen, (n_src, h), dtype)
    idx = torch.randint(0, n_src, (n_out,), generator=gen, device=DEVICE,
                        dtype=torch.int32)
    scale = torch.randn(n_out, generator=gen, device=DEVICE)
    if special:
        idx[:4] = torch.tensor([-1, n_src, 0, n_src - 1], device=DEVICE)
        scale[2:6] = torch.tensor([0.0, -0.0, -1.5, 0.0], device=DEVICE)
    out = md.gather_rows(src, idx)
    out_s = md.gather_rows(src, idx, scale)
    torch.cuda.synchronize()
    for name, got, ref in (
            ("moe_gather", out, md.gather_rows_plain(src, idx)),
            ("moe_gather_scaled", out_s,
             md.gather_rows_plain(src, idx, scale))):
        if not torch.equal(got, ref):
            raise RuntimeError(f"{name}[{label}]: differs from the plain "
                               f"version")
        if special and got[:2].any():
            raise RuntimeError(f"{name}[{label}]: an index outside the "
                               f"rows gave a row that is not zero")
    rows = [{"phase": "kernel", "kernel": name, "case": label,
             "dtype": _dname(dtype), "n_src": n_src, "n_out": n_out, "h": h,
             "special": special, "max_abs_err": 0.0, "tol": "exact"}
            for name in ("moe_gather", "moe_gather_scaled")]
    for row in rows:
        _emit(row)
    return rows


# the MoE flagship of the JAX package's bench (bench.py _configs()["moe"],
# "BASELINE config 5", DeepSeekMoE/Qwen2-MoE-style): vocab 32000, hidden
# 1536, expert intermediate 2048, 16 layers, 12 heads of 128 (no GQA), 8
# experts, top-2, capacity factor 1.25 (unused by the dropless fused
# dispatch), aux weight 0.01; 1,457,505,792 parameters, 551,536,128
# activated per token
MOE = dict(vocab_size=32000, hidden_size=1536, intermediate_size=2048,
           num_hidden_layers=16, num_attention_heads=12,
           num_key_value_heads=12, max_position_embeddings=2048,
           num_experts=8, top_k=2, capacity_factor=1.25)
MOE_BATCH = (4, 2048)
MOE_ROUTE_SEED = 17  # its inputs at [8192, 1536] have a margin > 1e-4
# the MoE kernels of the bf16 step, and their launches per MoE layer per
# training step (recompute runs the forward twice; the combine's backward
# gathers twice, the dispatch's backward is a combine); the fp32 parity
# phases run the CUDA-core grouped GEMM (MOE_FP32_KERNELS) instead
MOE_KERNELS = {"moe_route": 2, "moe_gather": 4, "moe_combine": 3,
               "grouped_matmul_sm90": 6, "grouped_matmul_dgrad_sm90": 3,
               "grouped_matmul_wgrad_sm90": 3}
MOE_FP32_KERNELS = tuple(n.replace("_sm90", "") for n in MOE_KERNELS)


def phase_moe_kernels(seed):
    """The MoE path's kernels at its shapes (timed) and at odd shapes
    (checked only), bf16 and fp32."""
    import torch

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 20)
    n, s = MOE_BATCH[0] * MOE_BATCH[1], MOE["hidden_size"]
    e, k, i = MOE["num_experts"], MOE["top_k"], MOE["intermediate_size"]
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        name = _dname(dtype)
        # the step's shapes: 8192 tokens, top-2 of 8 experts, the groups
        # that this routing gives
        row, counts = _route_case(f"moe-{name}", dtype, n, s, e, k,
                                  MOE_ROUTE_SEED)
        rows.append(row)
        rows += _rows_case(f"moe-{name}", dtype, n, k, s, gen)
        rows += _gmm_case(f"moe-gate-{name}", dtype, counts, s, i, gen)
        rows += _gmm_case(f"moe-down-{name}", dtype, counts, i, s, gen)
        _release()
        # odd shapes: 37 tokens (not a multiple of the routing block of 32)
        # with an expert that gets no row and one that gets one; top_k 1
        # on 16 experts; 128 experts at top-2; top-8; groups empty, of one
        # row, ragged and exact tile multiples; 128 groups; narrow widths
        for case in ((f"odd37-e8k2-{name}", 37, 64, 8, 2, 16, True),
                     (f"odd513-e16k1-{name}", 513, 96, 16, 1, 17, True),
                     (f"odd200-e128k2-{name}", 200, 128, 128, 2, 16, False),
                     (f"odd64-e128k8-{name}", 64, 40, 128, 8, 20, False)):
            rows.append(_route_case(*case[:1], dtype, *case[1:],
                                    timed=False)[0])
        rows += _rows_case(f"odd37-k8-h8-{name}", dtype, 37, 8, 8, gen,
                           timed=False)
        # gather: one 16-byte vector a row (h 8 in bf16), the looping
        # instance (h 4096), one output row, indices outside the rows and
        # scales of 0 and below 0
        for case in ((f"h8-{name}", 37, 74, 8, False),
                     (f"h4096-{name}", 50, 90, 4096, False),
                     (f"one-row-{name}", 5, 1, 1536, False),
                     (f"outside-{name}", 40, 80, 1536, True),
                     (f"outside-h8-{name}", 9, 20, 8, True)):
            rows += _gather_case(case[0], dtype, *case[1:4], gen,
                                 special=case[4])
        rows += _gmm_case(f"odd-groups-{name}", dtype, [0, 1, 300, 7, 0, 129],
                          64, 136, gen, timed=False)
        rows += _gmm_case(f"odd-128groups-{name}", dtype, [5] * 128, 16, 24,
                          gen, timed=False)
        _release()
    return rows


# -- phases: MoE training parity and the MoE training step ---------------------

# bf16 full-depth gradient check of the MoE step: the largest relative L2
# error of any parameter's gradient, kernels against the step with every
# kernel swapped for its plain version. The plain step replays the routing
# kernel's top-k picks: left to itself, bf16 roundings that differ by half
# an ulp flip the routing of tokens near a tie, and the flips cascade with
# depth (the experts' gradients then read 0.18 at layer 0 to 0.30 at layer
# 15, which would mask a small fault). The picks themselves are held
# exactly in moe-kernels. About 3x the sound reading (0.021, layer 13's
# k_proj; experts 0.015-0.018); the planted faults read 0.185 (wgrad), 0.354
# (grouped GEMM forward) and ~550 (routing).
MOE_TRAIN_GRAD_TOL = 0.06
MOE_TRAIN_STEPS = 6


def _full_tile_rows(m, group_sizes, device):
    """[m] bool: the rows that lie in one of their group's full
    ``TILE_ROWS``-row tiles (not in its last partial tile)."""
    import torch

    from paddle_tpu_torch.kernels import grouped_matmul as gm

    sizes = group_sizes.long()
    ends = torch.cumsum(sizes, dim=0)
    starts = ends - sizes
    keep = sizes // gm.TILE_ROWS * gm.TILE_ROWS
    row = torch.arange(m, device=device)
    grp = torch.bucketize(row, ends, right=True).clamp(max=sizes.numel() - 1)
    return (row - starts[grp]) < keep[grp]


def _route_recorder(tape):
    """Swaps that make the routing kernel's wrapper append each call's top-k
    pick (gate_i) to ``tape``."""
    from paddle_tpu_torch.kernels import moe_dispatch as md

    real = md.route

    def route(xt, wg, top_k):
        out = real(xt, wg, top_k)
        tape.append(out[1].clone())
        return out
    return [(md, "route", route)]


def _route_replay(tape):
    """Swaps that make the plain router take its top-k picks from ``tape``,
    in call order (a step calls the router in the same order each time:
    every layer's forward, then the recomputed forwards); it then derives
    gates, positions, counts and aux statistics from them as usual."""
    from paddle_tpu_torch.kernels import moe_dispatch as md

    def topk_first(p, k):
        gi = tape.pop(0).long()
        if gi.shape != (p.shape[0], k):
            raise RuntimeError(f"route replay: pick {tuple(gi.shape)} for "
                               f"probabilities {tuple(p.shape)}, k={k}")
        return p.gather(1, gi), gi
    return [(md, "topk_first", topk_first)]


def _moe_faulty(fault):
    """A planted fault: ``gather_scale_dropped`` has the combine
    backward's scaled gather ignore its scale (the gates);
    ``route_no_base`` drops the cross-block base from
    the routing kernel's positions (each block's positions restart at 0);
    ``gmm_drops_tail`` zeroes the grouped GEMM forward's output rows in each
    group's last partial row tile (``TILE_ROWS`` rows); ``wgrad_drops_tail``
    runs the wgrad kernel without those rows."""
    import torch
    import torch.nn.functional as TF

    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import grouped_matmul as gm
    from paddle_tpu_torch.kernels import moe_dispatch as md

    if fault == "gather_scale_dropped":
        real_gather = md.gather_rows
        return [(md, "gather_rows",
                 lambda src, idx, scale=None: real_gather(src, idx))]
    if fault == "route_no_base":
        real = md.route

        def route(xt, wg, top_k):
            gv, gi, pos, cnt, me, ce = real(xt, wg, top_k)
            n, e = gi.shape[0], wg.shape[1]
            nb, tokens = md.route_plan(n, _build.sm_count(xt.device))
            per = tokens * top_k
            flat = gi.reshape(-1).long()
            oh = TF.pad(TF.one_hot(flat, e), (0, 0, 0, nb * per - flat.numel()))
            blk = oh.view(nb, per, e).sum(dim=1)
            base = torch.cumsum(blk, dim=0) - blk
            rb = torch.arange(flat.numel(), device=flat.device) // per
            pos = (pos.reshape(-1) - base[rb, flat]).to(torch.int32)
            return gv, gi, pos.view(n, top_k), cnt, me, ce
        return [(md, "route", route)]
    if fault == "gmm_drops_tail":
        real_gmm = gm.gmm

        def gmm(lhs, rhs, group_sizes, trans_rhs=False):
            out = real_gmm(lhs, rhs, group_sizes, trans_rhs)
            if trans_rhs:
                return out
            inside = _full_tile_rows(lhs.shape[0], group_sizes, lhs.device)
            return out * inside[:, None].to(out.dtype)
        return [(gm, "gmm", gmm)]
    real = gm.tgmm

    def tgmm(lhs, dout, group_sizes):
        inside = _full_tile_rows(lhs.shape[0], group_sizes, lhs.device)
        return real(lhs * inside[:, None].to(lhs.dtype), dout, group_sizes)
    return [(gm, "tgmm", tgmm)]


def _moe_model(dtype, layers, seed):
    from paddle_tpu_torch.device import seed as pt_seed
    from paddle_tpu_torch.models import LlamaForCausalLM, LlamaMoEConfig

    cfg = LlamaMoEConfig(**{**MOE, "num_hidden_layers": layers},
                         dtype=dtype, use_recompute=True)
    return cfg, LlamaForCausalLM(cfg, device=DEVICE,
                                 generator=pt_seed(seed, DEVICE))


def _adafactor_curve(model, state, ids, steps):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Adafactor

    model.load_state_dict(state)
    step = TrainStep(model, lambda m, x, y: m(x, labels=y),
                     Adafactor(learning_rate=1e-2,
                               parameters=model.parameters()), graph=False)
    return [float(step(ids, ids)) for _ in range(steps)]


def phase_moe_train_parity(seed):
    import torch

    from paddle_tpu_torch import kernels, set_flags

    set_flags({"FLAGS_moe_dispatch": "fused"})
    cfg, model = _moe_model("float32", 2, seed + 5)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 5)
    ids = torch.randint(0, cfg.vocab_size, (2, 512), generator=gen,
                        device=DEVICE)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    with _swapped(_plain_swaps()):
        loss_p, grads_p = _loss_and_grads(model, ids)
    kernels.reset_counters()
    loss_k, grads_k = _loss_and_grads(model, ids)
    counts = kernels.counters()
    unused = [n for n, c in counts.items() if c["plain_calls"] or (
        c["launches"] == 0 and (n in DENSE_TRAIN_KERNELS
                                or n in MOE_FP32_KERNELS))
        or (c["launches"] and n in CUDA_CORE_FLASH)]
    if unused:
        raise RuntimeError(f"moe-train-parity: kernels not all launched, or "
                           f"CUDA-core flash launched: "
                           f"{ {n: counts[n] for n in unused} }")
    errs = _grad_errors(grads_k, grads_p)
    del grads_k, grads_p
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    curve_k = _adafactor_curve(model, state, ids, 3)
    with _swapped(_plain_swaps()):
        curve_p = _adafactor_curve(model, state, ids, 3)
    curve_rel = max(abs(a - b) / abs(b) for a, b in zip(curve_k, curve_p))
    row = {"phase": "moe-train-parity", "layers": 2, "dtype": "float32",
           "batch": [2, 512], "dispatch": "fused", "loss_kernels": loss_k,
           "loss_plain": loss_p, "loss_rel_err": loss_rel,
           "loss_rtol": PARITY_LOSS_RTOL,
           "grad_rel_l2_max": max(errs.values()),
           "grad_worst": _worst(errs), "grad_tol": PARITY_GRAD_TOL,
           "params_checked": len(errs), "curve_kernels": curve_k,
           "curve_plain": curve_p, "curve_rel_err": curve_rel,
           "curve_rtol": PARITY_CURVE_RTOL}
    _emit(row)
    if not (loss_rel <= PARITY_LOSS_RTOL
            and max(errs.values()) <= PARITY_GRAD_TOL
            and curve_rel <= PARITY_CURVE_RTOL):
        raise RuntimeError(f"moe-train-parity: kernels differ from plain: "
                           f"{row}")
    if not curve_k[-1] < curve_k[0]:
        raise RuntimeError(f"moe-train-parity: loss did not fall {curve_k}")
    del model, state
    _release()
    return counts


def phase_moe_train(seed):
    import math

    import torch

    from paddle_tpu_torch import kernels, set_flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (llama_moe_flops_per_token,
                                         llama_moe_param_counts)
    from paddle_tpu_torch.optimizer import Adafactor

    set_flags({"FLAGS_moe_dispatch": "fused"})
    batch, seq = MOE_BATCH
    t0 = time.perf_counter()
    cfg, model = _moe_model("bfloat16", MOE["num_hidden_layers"], seed + 6)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 6)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                        device=DEVICE)

    # gradients at full depth on the initial weights: kernels against the
    # plain-swapped step fed the kernels' routing picks; four planted
    # faults (routing, grouped GEMM forward, wgrad, the gather's scale) must
    # exceed the limit
    tape = []
    with _swapped(_route_recorder(tape)):
        loss_k, grads_k = _loss_and_grads(model, ids)
    picks = len(tape)
    with _swapped(_plain_swaps() + _route_replay(tape)):
        loss_p, grads_p = _loss_and_grads(model, ids)
    if picks != 2 * cfg.num_hidden_layers or tape:
        raise RuntimeError(f"moe-train: the plain step used "
                           f"{picks - len(tape)} of {picks} recorded picks")
    sound = _grad_errors(grads_k, grads_p)
    del grads_k
    faults = {}
    for fault in ("route_no_base", "gmm_drops_tail", "wgrad_drops_tail",
                  "gather_scale_dropped"):
        with _swapped(_moe_faulty(fault)):
            _l, grads_f = _loss_and_grads(model, ids)
        errs = _grad_errors(grads_f, grads_p)
        del grads_f
        faults[fault] = {"grad_rel_l2_max": max(errs.values()),
                         "worst": _worst(errs, 1),
                         "caught": max(errs.values()) > MOE_TRAIN_GRAD_TOL}
    del grads_p
    _release()
    L = cfg.num_hidden_layers
    experts_by_layer = [max(v for n, v in sound.items()
                            if n.startswith(f"llama.layers.{li}.mlp.experts."))
                        for li in range(L)]
    check = {"phase": "moe-train-grad-check", "layers": L,
             "dtype": "bfloat16", "loss_kernels": loss_k,
             "loss_plain": loss_p, "routing_picks_replayed": picks,
             "grad_rel_l2_max": max(sound.values()),
             "grad_worst": _worst(sound),
             "experts_by_layer": experts_by_layer,
             "grad_tol": MOE_TRAIN_GRAD_TOL, "faults": faults}
    _emit(check)
    if not max(sound.values()) <= MOE_TRAIN_GRAD_TOL:
        raise RuntimeError(f"moe-train: kernel gradients differ from plain "
                           f"{check}")
    if not all(f["caught"] for f in faults.values()):
        raise RuntimeError(f"moe-train: the gradient check missed a planted "
                           f"fault {faults}")

    def make_opt():
        return Adafactor(learning_rate=1e-2, parameters=model.parameters())

    # the eager step (graph=False): the reference the graphed step is held to
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_opt()
    step = TrainStep(model, lambda m, x, y: m(x, labels=y), opt, graph=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    losses, ms = _timed(step, ids, MOE_TRAIN_STEPS)
    counts = kernels.counters()
    # the check's copy of the weights is left out of the peak
    peak_gb = (torch.cuda.max_memory_allocated() -
               _nbytes(state0.values())) / 2**30
    per_step = _dense_launches(L)
    per_step.update({n: c * L for n, c in MOE_KERNELS.items()})
    # Adafactor, not AdamW: its statistics and its update, one call each
    per_step.update(adam_update=0, adafactor_stats=1, adafactor_update=1)
    wrong = {n: (c, per_step[n] * MOE_TRAIN_STEPS) for n, c in counts.items()
             if c["plain_calls"] or
             c["launches"] != per_step[n] * MOE_TRAIN_STEPS}
    if wrong:
        raise RuntimeError(f"moe-train: kernel counts differ from the "
                           f"expected (reading, expected launches): {wrong}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise RuntimeError(f"moe-train: loss not finite and falling: "
                           f"{losses}")
    ref = _snapshot(model, opt)
    step_ms = sum(ms[1:]) / (len(ms) - 1)
    tok_s = batch * seq / step_ms * 1e3
    flops = llama_moe_flops_per_token(cfg, seq)
    mfu = flops * tok_s / PEAK_FLOPS["bfloat16"]
    total, activated = llama_moe_param_counts(cfg)
    breakdown = _train_breakdown(model, opt, ids)
    eager_profile = _step_profile(lambda: step(ids, ids))
    _emit({"phase": "moe-train", "ok": True, "model": "llama-moe-1.46b",
           "graph": False, "params": total, "activated_params": activated,
           "layers": L, "experts": cfg.num_experts, "top_k": cfg.top_k,
           "dtype": "bfloat16", "recompute": True, "dispatch": "fused",
           "optimizer": "Adafactor lr 1e-2", "batch": [batch, seq],
           "model_init_s": t_init, "losses": losses,
           "step_ms": step_ms, "step_ms_each": ms,
           "tokens_per_s": tok_s, "mfu_activated": mfu,
           "peak_mem_gb": peak_gb, "kernel_counts": counts,
           "expected_launches_per_step": per_step})
    _emit({"phase": "moe-train-breakdown", **breakdown,
           "beside_earlier": _beside_earlier("moe-train", breakdown)})
    eager = {"step_ms": step_ms, "tokens_per_s": tok_s, "mfu": mfu,
             "peak_mem_gb": peak_gb}
    del step, opt
    _release()

    # the graphed step, the main path: against the eager run above
    graph_counts, graph = _graph_run("moe-train", model, make_opt, ids,
                                     MOE_TRAIN_STEPS, per_step, flops, ref,
                                     losses, state0)
    del ref
    _release()
    _emit({**_side_by_side("moe", eager, graph, eager_profile),
           "losses": graph["losses"], "step_ms_each": graph["step_ms_each"],
           "kernel_counts": graph_counts})
    _emit({"phase": "moe-train-bench-batch",
           **_bench_batch("moe", model, make_opt, cfg.vocab_size, seed + 42,
                          flops, state0)})
    shapes = [tuple(p.shape) for p in model.parameters()]
    del model, state0
    _release()
    set_flags({"FLAGS_moe_dispatch": "index"})
    return graph_counts, counts, shapes


# -- phase: the fused optimizer -----------------------------------------------

# the optimizer's kernels (csrc/optimizer.cu)
OPT_KERNELS = ("multi_tensor_sumsq", "adam_update", "adafactor_stats",
               "adafactor_update")
OPT_STEP = 7  # the step number of the checked update (bias corrections)
# the check of a kernel against its plain version: bf16 parameters and
# moments equal bit for bit in 99.9% of elements and one ulp apart at most
# (a rounding flipped by the last bit of an fp32 sum taken in another
# order), an ulp of the larger of the two results and the value before the
# update; fp32 every element within rtol of its plain value plus rtol of
# its tensor's largest element (a moment is a sum that cancels), as
# tests/test_torch_gpu.py holds them
OPT_RTOL = {"adam": 1e-6, "adafactor": 1e-5}
OPT_BF16_SAME = 0.999
# planted faults, set through the wrappers' arguments: the bias corrections
# at an enormous step (1 - b^t = 1), the decoupled decay's weight 0, the
# clip scale not applied, Adafactor's update-clip threshold infinite.
# Checked in fp32, where every term shows: in bf16 the decoupled decay at
# lr 3e-4 is under half an ulp of p and rounds away in both versions
OPT_FAULTS = {"adam": ("no_bias_correction", "decoupled_decay_dropped",
                       "clip_scale_ignored"),
              "adafactor": ("rms_clip_dropped",)}
# the fp32 check runs on the set's first tensors up to this many elements
OPT_FP32_ELEMENTS = 120_000_000


def _opt_module():
    import importlib

    return importlib.import_module("paddle_tpu_torch.kernels.optimizer")


class _OptCase:
    """One optimizer update over tensors of ``shapes``, through the kernels
    or their plain versions, each run from the same seeded tensors: p
    (scale 0.02), g (1e-3) and the rule's state as after some steps
    (Adam's m and v; Adafactor's vr/vc or v at about a tenth of E[g^2],
    so that its update clip is active). AdamW lr 3e-4, wd 0.1;
    Adafactor lr 1e-2; ``clip``: ClipGradByGlobalNorm(1.0); ``grad_dtype``:
    the gradients' (fp32 beside bf16 parameters: the sums of
    ``TrainStep.accumulate``), the parameters' by default."""

    def __init__(self, rule, shapes, dtype, clip, gen, grad_dtype=None):
        import torch

        def rnd(shape, scale, dt=dtype):
            return (torch.randn(shape, generator=gen, device=DEVICE) *
                    scale).to(dt)

        def acc(shape):
            return (torch.rand(shape, generator=gen, device=DEVICE) +
                    0.5) * 1e-7

        self.rule, self.clip = rule, clip
        self.p = [rnd(s, 0.02) for s in shapes]
        self.g = [rnd(s, 1e-3, grad_dtype or dtype) for s in shapes]
        if rule == "adam":
            self.slots = [[rnd(s, 1e-4) for s in shapes],
                          [rnd(s, 1e-3).square() for s in shapes]]
        else:
            self.slots = [[acc(s[:-1] if len(s) > 1 else s) for s in shapes],
                          [acc(s[:-2] + s[-1:]) if len(s) > 1 else None
                           for s in shapes]]
        self.slots.append([None] * len(shapes))  # no first moment
        self.init = [t.clone() for t in self.live()]
        self.lr = 3e-4 if rule == "adam" else 1e-2

    def live(self):
        """What an update writes: p and the state tensors."""
        return self.p + [t for s in self.slots for t in s if t is not None]

    def batch(self, step=OPT_STEP):
        return _opt_module().StepBatch(self.p, self.g, self.slots,
                                       [True] * len(self.p), self.lr, step,
                                       rule=self.rule)

    def calls(self, b, plain=False, fault=None):
        """{kernel: closure} of one update over batch ``b``; Adafactor's
        update closure reads the stats of one stats call made here."""
        kopt = _opt_module()
        sfx = "_plain" if plain else ""
        out, norms, clip = {}, None, ("none",)
        if self.clip:
            out["multi_tensor_sumsq"] = lambda: getattr(
                kopt, "multi_tensor_sumsq" + sfx)(b, 1.0, 2)
            norms = out["multi_tensor_sumsq"]()
            clip = ("none",) if fault == "clip_scale_ignored" else ("scale",)
        if self.rule == "adam":
            wd = 0.0 if fault == "decoupled_decay_dropped" else 0.1
            out["adam_update"] = lambda: getattr(kopt, "adam_update" + sfx)(
                b, beta1=0.9, beta2=0.999, epsilon=1e-8, weight_decay=wd,
                decoupled=True, clip=clip, norms=norms)
            return out

        def stats():
            return getattr(kopt, "adafactor_stats" + sfx)(
                b, decay_rate=0.8, epsilon1=1e-30, weight_decay=0.0,
                pscale=True, clip=clip, norms=norms)

        out["adafactor_stats"] = stats
        st = stats()
        thr = float("inf") if fault == "rms_clip_dropped" else 1.0
        out["adafactor_update"] = lambda: getattr(
            kopt, "adafactor_update" + sfx)(
                b, st, beta1=0.0, epsilon2=1e-3, clip_threshold=thr,
                pscale=True, weight_decay=0.0, clip=clip, norms=norms)
        return out

    def update(self, plain=False, fault=None):
        """One update from the initial tensors; returns what it wrote."""
        import torch

        for t, t0 in zip(self.live(), self.init):
            t.copy_(t0)
        b = self.batch(2 ** 30 if fault == "no_bias_correction"
                       else OPT_STEP)
        calls = self.calls(b, plain, fault)  # runs sumsq and stats once
        last = "adam_update" if self.rule == "adam" else "adafactor_update"
        calls[last]()
        torch.cuda.synchronize()
        return [t.clone() for t in self.live()]


def _bf16_ulps(a, b, scale):
    """|a - b| in bf16 ulps of ``scale`` (elementwise)."""
    import torch

    m = scale.float().abs().clamp_min(2.0 ** -126)
    return (a.float() - b.float()).abs() / torch.exp2(
        torch.floor(torch.log2(m)) - 7)


def _opt_agreement(got, ref, init):
    """(share of bf16 elements equal bit for bit, largest distance in bf16
    ulps at the operands' scale max(|a|, |b|, |before|), largest fp32
    error over rtol's scale |ref| + max|ref|, largest distance in ulps at
    the result's own scale max(|a|, |b|), count of elements within one ulp
    only at the operands' scale); ``init``: the tensors before the update.
    The check reads the first three: the operands' scale is that of the
    fp32 terms of an update that cancels, whose result may land near
    zero, where its own ulp is tiny."""
    import torch

    same = total = base_only = 0
    ulps = worst = own = 0.0
    for a, b, a0 in zip(got, ref, init):
        if a.dtype == torch.bfloat16:
            same += int((a.view(torch.int16) == b.view(torch.int16)).sum())
            total += a.numel()
            top = torch.maximum(a.float().abs(), b.float().abs())
            at_own = _bf16_ulps(a, b, top)
            at_ops = _bf16_ulps(a, b, torch.maximum(top, a0.float().abs()))
            ulps = max(ulps, float(at_ops.max()))
            own = max(own, float(at_own.max()))
            base_only += int(((at_own > 1) & (at_ops <= 1)).sum())
        else:
            scale = b.abs() + b.abs().max()
            worst = max(worst, float(((a - b).abs() /
                                      scale.clamp_min(1e-30)).max()))
    return (same / total if total else 1.0), ulps, worst, own, base_only


def _opt_sound(rule, agreement):
    same, ulps, worst = agreement[:3]
    return same >= OPT_BF16_SAME and ulps <= 1 and worst <= OPT_RTOL[rule]


def _opt_nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def phase_optimizer(path, shapes, rule, seed):
    """The fused optimizer's kernels over a model's full parameter set
    (``shapes``), bf16: each kernel's update against its plain version
    (the check above, two runs bit for bit the same, one launch a call),
    timed eager and in CUDA-graph replay beside the plain version, the
    bound of the bytes its function moves and a PyTorch yardstick
    (``torch.optim.AdamW(fused=True)`` on the same tensors; for the sums
    of squares ``torch._foreach_norm``; none computes Adafactor's rule);
    then the same check in fp32 on the set's first tensors, which each
    planted fault must fail. Dense: AdamW with and without
    ClipGradByGlobalNorm(1.0); MoE: Adafactor."""
    import math

    import torch

    from paddle_tpu_torch import kernels

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 30)
    # the fp32-gradient cases: bf16 parameters, fp32 gradients (the table's
    # fp32-gradient flag), 2 more bytes read per element
    variants = ([(f"{path}-bfloat16", False, None),
                 (f"{path}-clip-bfloat16", True, None),
                 (f"{path}-fp32grad-bfloat16", True, torch.float32)]
                if rule == "adam" else
                [(f"{path}-bfloat16", False, None),
                 (f"{path}-fp32grad-bfloat16", False, torch.float32)])
    rows = []
    for case, clip, grad_dtype in variants:
        oc = _OptCase(rule, shapes, torch.bfloat16, clip, gen, grad_dtype)
        ref = oc.update(plain=True)
        kernels.reset_counters()
        got = oc.update()
        counts = kernels.counters()
        again = oc.update()
        agree = _opt_agreement(got, ref, oc.init)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got[:len(oc.p)], ref))
        deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
        del ref, got, again
        want = {n: 0 for n in OPT_KERNELS}
        b = oc.batch()
        calls = oc.calls(b)
        want.update({n: 1 for n in calls})
        launched = {n: counts[n]["launches"] for n in OPT_KERNELS}
        plain = sum(counts[n]["plain_calls"] for n in OPT_KERNELS)
        check = {"phase": "optimizer-check", "case": case, "rule": rule,
                 "tensors": len(shapes),
                 "elements": sum(p.numel() for p in oc.p),
                 "bitwise_share": agree[0], "max_ulps": agree[1],
                 "max_ulps_own_scale": agree[3],
                 "within_one_ulp_only_at_operands": agree[4],
                 "fp32_state_err": agree[2], "deterministic": deterministic,
                 "launches": launched}
        _emit(check)
        if not (_opt_sound(rule, agree) and deterministic and plain == 0
                and launched == want):
            raise RuntimeError(f"optimizer: kernels differ from plain or "
                               f"launch otherwise {check}")
        plain_calls = oc.calls(b, plain=True)
        n, nm = len(oc.p), b.n_matrices
        P, G = _opt_nbytes(oc.p), _opt_nbytes(oc.g)
        S = _opt_nbytes(oc.slots[0]) + _opt_nbytes(oc.slots[1])
        nbytes = {"multi_tensor_sumsq": G + 4 * (2 * n + 1),
                  "adam_update": P + G + S + P + S,
                  "adafactor_stats": G + P + 2 * S + 4 * (n + nm),
                  "adafactor_update": G + 2 * P + S + 4 * (n + nm)}
        lib = {}
        if rule == "adam" and grad_dtype is None:
            lp = [torch.nn.Parameter(t.clone()) for t in oc.p]
            for t, g in zip(lp, oc.g):
                t.grad = g
            fused = torch.optim.AdamW(lp, lr=oc.lr, weight_decay=0.1,
                                      fused=True)
            lib["adam_update"] = _time_ms(fused.step, iters=5, warmup=2)
            del fused, lp
            lib["multi_tensor_sumsq"] = _time_ms(
                lambda: torch._foreach_norm(oc.g), iters=5, warmup=2)
        for name, fn in calls.items():
            b_ms, b_by = _bound(nbytes[name], 0, "float32")
            row = {"phase": "kernel", "kernel": name, "case": case,
                   "dtype": "bfloat16", "tensors": n,
                   "elements": sum(p.numel() for p in oc.p),
                   "max_abs_err": err, "bitwise_share": agree[0],
                   "max_ulps": agree[1],
                   "kernel_ms": _time_ms(fn, iters=10, warmup=2),
                   "graph_ms": _graph_ms(fn, iters=5, reps=3),
                   "plain_ms": _time_ms(plain_calls[name], iters=2,
                                        warmup=1),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": lib.get(name)}
            if name in lib:
                row["library"] = ("torch.optim.AdamW(fused=True)"
                                  if name == "adam_update"
                                  else "torch._foreach_norm")
            rows.append(row)
            _emit(row)
        del oc, b, calls, plain_calls
        _release()

    # fp32 on the first tensors: sound, and every planted fault caught
    sub, total = [], 0
    for s in shapes:
        k = math.prod(s)
        if sub and total + k > OPT_FP32_ELEMENTS:
            break
        sub.append(s)
        total += k
    oc = _OptCase(rule, sub, torch.float32, rule == "adam", gen)
    ref = oc.update(plain=True)
    sound = _opt_agreement(oc.update(), ref, oc.init)
    faults = {}
    for fault in OPT_FAULTS[rule]:
        reading = _opt_agreement(oc.update(fault=fault), ref, oc.init)
        faults[fault] = {"fp32_err": reading[2],
                         "caught": not _opt_sound(rule, reading)}
    check = {"phase": "optimizer-fault-check", "rule": rule,
             "tensors": len(sub), "elements": total, "fp32_err": sound[2],
             "rtol": OPT_RTOL[rule], "clip": rule == "adam",
             "faults": faults}
    _emit(check)
    del oc, ref
    _release()
    if not _opt_sound(rule, sound):
        raise RuntimeError(f"optimizer: fp32 kernels differ from plain "
                           f"{check}")
    if not all(f["caught"] for f in faults.values()):
        raise RuntimeError(f"optimizer: the check missed a planted fault "
                           f"{faults}")
    return rows


# -- phase: the other optimizer rules, the unscale, the master update -----------

# the kernel checks over the dense model's parameter set, bf16: (case,
# wrapper, the rule of its batch, its keyword arguments, the rate); the
# bytes its function moves are ``passes`` reads or writes of the set
RULE_CHECKS = [
    ("sgd", "sgd_update", "sgd", dict(weight_decay=0.01), 1e-2),
    ("momentum", "momentum_update", "momentum",
     dict(momentum=0.9, nesterov=True), 1e-2),
    ("adagrad", "adagrad_update", "adagrad", dict(epsilon=1e-6), 1e-2),
    ("adamax", "adamax_update", "adamax",
     dict(beta1=0.9, beta2=0.999, epsilon=1e-8), 2e-3),
    ("rmsprop", "rmsprop_update", "rmsprop",
     dict(rho=0.95, epsilon=1e-6, momentum=0.0, centered=False,
          weight_decay=0.01), 1e-3),
    ("rmsprop-centered", "rmsprop_update", "rmsprop",
     dict(rho=0.95, epsilon=1e-6, momentum=0.9, centered=True), 1e-3),
    ("adadelta", "adadelta_update", "adadelta",
     dict(rho=0.95, epsilon=1e-6), 1.0),
    ("lamb", "lamb_update", "lamb",
     dict(beta1=0.9, beta2=0.999, epsilon=1e-6, weight_decay=0.01), 1e-3),
    ("lars", "lars_update", "lars",
     dict(momentum=0.9, lars_coeff=0.001, weight_decay=5e-4, epsilon=0.0),
     0.1),
]
# the state each rule's update reads and writes (RMSProp not centered
# keeps mean_grad untouched)
RULE_STATE = {"sgd": 0, "momentum": 1, "adagrad": 1, "adamax": 2,
              "rmsprop": 2, "rmsprop-centered": 3, "adadelta": 2, "lamb": 2,
              "lars": 1}
# planted faults, set through the wrappers' arguments and caught in fp32:
# the coupled decay dropped, Nesterov dropped, Adagrad's and Adadelta's
# eps dropped, Adamax's and Lamb's bias corrections at an enormous step,
# RMSProp not centered, Lamb's decay dropped, LARS's decay and momentum
# dropped, the unscale's factor 1
RULE_FAULTS = {"sgd": ("decay_dropped",), "momentum": ("nesterov_dropped",),
               "adagrad": ("eps_dropped",), "adamax": ("no_bias_correction",),
               "rmsprop": ("decay_dropped",),
               "rmsprop-centered": ("not_centered",),
               "adadelta": ("eps_dropped",),
               "lamb": ("no_bias_correction", "decay_dropped"),
               "lars": ("decay_dropped", "momentum_dropped"),
               "unscale": ("not_unscaled",)}
UNSCALE_SCALE = 2.0 ** 16


def _fault_kw(kw, fault):
    kw = dict(kw)
    if fault == "decay_dropped":
        kw["weight_decay"] = 0.0
    elif fault == "nesterov_dropped":
        kw["nesterov"] = False
    elif fault == "eps_dropped":
        kw["epsilon"] = 0.0
    elif fault == "not_centered":
        kw["centered"] = False
    elif fault == "momentum_dropped":
        kw["momentum"] = 0.0
    return kw


class _RuleCase:
    """One update of a rule of RULE_CHECKS (or the unscale: ``case``
    "unscale") over tensors of ``shapes``, through its kernel or its plain
    version, each run from the same seeded tensors: p (scale 0.02), g
    (1e-3; the unscale's times UNSCALE_SCALE, as the scaled loss's) and the
    rule's state as after some steps. Decay flags: every tensor of 2+
    dimensions (1-D ones, the norms' weights, excluded)."""

    def __init__(self, case, shapes, dtype, gen):
        import torch

        def rnd(shape, scale):
            return (torch.randn(shape, generator=gen, device=DEVICE) *
                    scale).to(dtype)

        self.case = case
        self.p = [rnd(s, 0.02) for s in shapes]
        n = len(shapes)
        if case == "unscale":
            self.g = [rnd(s, 1e-3 * UNSCALE_SCALE) for s in shapes]
            self.name, self.rule, self.kw, self.lr = ("unscale", "grads", {},
                                                      0.0)
            self.slots = [[None] * n] * 3
        else:
            self.g = [rnd(s, 1e-3) for s in shapes]
            _c, self.name, self.rule, self.kw, self.lr = next(
                r for r in RULE_CHECKS if r[0] == case)
            # the state: magnitudes as after some steps, squares positive
            init = {"sgd": [], "momentum": [("g", 1e-3)],
                    "adagrad": [("sq", 3e-3)],
                    "adamax": [("g", 1e-4), ("abs", 1e-3)],
                    "rmsprop": [("sq", 1e-3), ("g", 1e-4), ("g", 1e-4)],
                    "adadelta": [("sq", 1e-3), ("sq", 1e-4)],
                    "lamb": [("g", 1e-4), ("sq", 1e-3)],
                    "lars": [("g", 1e-5)]}[self.rule]
            self.slots = []
            for kind, scale in init:
                ts = [rnd(s, scale) for s in shapes]
                if kind == "sq":
                    ts = [t.square() for t in ts]
                elif kind == "abs":
                    ts = [t.abs() for t in ts]
                self.slots.append(ts)
            self.slots += [[None] * n] * (3 - len(self.slots))
        self.decay = [len(s) > 1 for s in shapes]
        self.init = [t.clone() for t in self.live()]

    def live(self):
        """What an update writes: p and the state (the unscale: g)."""
        if self.case == "unscale":
            return self.g
        return self.p + [t for s in self.slots for t in s if t is not None]

    def batch(self, step=OPT_STEP):
        return _opt_module().StepBatch(self.p, self.g, self.slots,
                                       self.decay, self.lr, step,
                                       rule=self.rule)

    def call(self, b, plain=False, fault=None):
        """The update over batch ``b`` as a closure."""
        kopt = _opt_module()
        sfx = "_plain" if plain else ""
        if self.case == "unscale":
            inv = 1.0 if fault == "not_unscaled" else 1.0 / UNSCALE_SCALE
            return lambda: getattr(kopt, "unscale" + sfx)(b, inv)
        kw = _fault_kw(self.kw, fault)
        return lambda: getattr(kopt, self.name + sfx)(b, **kw)

    def update(self, plain=False, fault=None):
        """One update from the initial tensors; returns what it wrote."""
        import torch

        for t, t0 in zip(self.live(), self.init):
            t.copy_(t0)
        b = self.batch(2 ** 30 if fault == "no_bias_correction"
                       else OPT_STEP)
        self.call(b, plain, fault)()
        torch.cuda.synchronize()
        return [t.clone() for t in self.live()]

    def nbytes(self):
        """The bytes the function must move: p and g read (the unscale: g),
        its state read, p and its state written (the unscale: g)."""
        P, G = _opt_nbytes(self.p), _opt_nbytes(self.g)
        if self.case == "unscale":
            return 2 * G
        S = RULE_STATE[self.case] * P  # every state has p's dtype and size
        return P + G + S + P + S


def _rule_library(oc):
    """(ms, call) of one PyTorch optimizer step on copies of ``oc``'s
    tensors where torch has the rule (fused where it takes it on CUDA,
    else foreach; "neighbour" where its eps sits elsewhere), else (None,
    reason)."""
    import torch

    case, kw, lr = oc.case, oc.kw, oc.lr
    make = {
        "sgd": lambda ps: torch.optim.SGD(ps, lr=lr, weight_decay=0.01,
                                          fused=True),
        "momentum": lambda ps: torch.optim.SGD(ps, lr=lr, momentum=0.9,
                                               nesterov=True, fused=True),
        "adagrad": lambda ps: torch.optim.Adagrad(ps, lr=lr, eps=1e-6,
                                                  foreach=True),
        "adamax": lambda ps: torch.optim.Adamax(ps, lr=lr, foreach=True),
        "rmsprop": lambda ps: torch.optim.RMSprop(ps, lr=lr, alpha=0.95,
                                                  eps=1e-6, foreach=True),
        "rmsprop-centered": lambda ps: torch.optim.RMSprop(
            ps, lr=lr, alpha=0.95, eps=1e-6, momentum=0.9, centered=True,
            foreach=True),
        "adadelta": lambda ps: torch.optim.Adadelta(ps, lr=lr, rho=0.95,
                                                    eps=1e-6, foreach=True),
    }
    names = {"sgd": "torch.optim.SGD(fused=True)",
             "momentum": "torch.optim.SGD(momentum, nesterov, fused=True)",
             "adagrad": "torch.optim.Adagrad(foreach=True)",
             "adamax": "neighbour: torch.optim.Adamax(foreach=True), eps "
                       "added to max(b2 u, |g| + eps)",
             "rmsprop": "neighbour: torch.optim.RMSprop(foreach=True), eps "
                        "outside the root",
             "rmsprop-centered": "neighbour: torch.optim.RMSprop(centered, "
                                 "momentum, foreach=True), eps outside the "
                                 "root",
             "adadelta": "torch.optim.Adadelta(foreach=True)"}
    if case == "unscale":
        # torch's check-and-unscale takes no bf16: fp16 copies, the same
        # bytes
        grads = [g.half() for g in oc.g]
        found = torch.zeros(1, device=DEVICE)
        inv = torch.full((1,), 1.0 / UNSCALE_SCALE, device=DEVICE)
        ms = _time_ms(lambda: torch._amp_foreach_non_finite_check_and_unscale_(
            grads, found, inv), iters=5, warmup=2)
        del grads
        return ms, ("torch._amp_foreach_non_finite_check_and_unscale_ "
                    "(check and unscale in one) on fp16 copies: it takes "
                    "no bf16")
    if case not in make:
        return None, "no call"
    ps = [torch.nn.Parameter(t.clone()) for t in oc.p]
    for t, g in zip(ps, oc.g):
        t.grad = g
    opt = make[case](ps)
    ms = _time_ms(opt.step, iters=5, warmup=2)
    del opt, ps
    return ms, names[case]


def phase_rules(path, shapes, seed):
    """The kernels of the eight other rules and of the gradient scaler's
    unscale over a model's full parameter set (``shapes``), bf16: each
    kernel's update against its plain version in every bit (two runs the
    same bits, one launch a call), timed eager and in CUDA-graph replay
    beside the plain version, the bound of the bytes its function moves
    and a PyTorch call that computes the same function (or a neighbour,
    or none); the finiteness check over the same gradients, clean and
    with a planted inf; then each in fp32 on the set's first tensors,
    which each planted fault must fail."""
    import math

    import torch

    from paddle_tpu_torch import kernels

    kopt = _opt_module()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 50)
    rows = []
    for case in [r[0] for r in RULE_CHECKS] + ["unscale"]:
        oc = _RuleCase(case, shapes, torch.bfloat16, gen)
        ref = oc.update(plain=True)
        kernels.reset_counters()
        got = oc.update()
        counts = kernels.counters()
        again = oc.update()
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, ref))
        deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
        del ref, got, again
        launched = {n: c["launches"] for n, c in counts.items()
                    if c["launches"] or c["plain_calls"]}
        check = {"phase": "rule-check", "case": f"{path}-{case}",
                 "tensors": len(shapes),
                 "elements": sum(p.numel() for p in oc.p),
                 "bitwise": same, "max_abs_err": err,
                 "deterministic": deterministic, "launches": launched}
        _emit(check)
        if not (same and deterministic and launched == {oc.name: 1}):
            raise RuntimeError(f"rules: a kernel differs from its plain "
                               f"version or launches otherwise {check}")
        b = oc.batch()
        fn, plain_fn = oc.call(b), oc.call(b, plain=True)
        b_ms, b_by = _bound(oc.nbytes(), 0, "float32")
        lib_ms, lib = _rule_library(oc)
        row = {"phase": "kernel", "kernel": oc.name,
               "case": f"{path}-{case}-bfloat16", "dtype": "bfloat16",
               "tensors": len(shapes),
               "elements": sum(p.numel() for p in oc.p),
               "max_abs_err": err, "bitwise": same,
               "kernel_ms": _time_ms(fn, iters=10, warmup=2),
               "graph_ms": _graph_ms(fn, iters=5, reps=3),
               "plain_ms": _time_ms(plain_fn, iters=2, warmup=1),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
               "library": lib}
        if case == "lamb":  # two passes: p, g, m, v read twice
            row["design_floor_ms"] = _bound(
                oc.nbytes() + _opt_nbytes(oc.p + oc.g) +
                2 * _opt_nbytes(oc.p), 0, "float32")[0]
        if case == "lars":  # the norm pass reads p and g once more
            row["design_floor_ms"] = _bound(
                oc.nbytes() + _opt_nbytes(oc.p + oc.g), 0, "float32")[0]
        rows.append(row)
        _emit(row)
        if case == "unscale":
            rows += _finite_rows(path, oc, b, kopt, lib_ms, lib)
        del oc, b, fn, plain_fn
        _release()

    # fp32 on the first tensors: equal in every bit, each fault caught
    sub, total = [], 0
    for s in shapes:
        k = math.prod(s)
        if sub and total + k > OPT_FP32_ELEMENTS:
            break
        sub.append(s)
        total += k
    faults = {}
    for case, planted in RULE_FAULTS.items():
        oc = _RuleCase(case, sub, torch.float32, gen)
        ref = oc.update(plain=True)
        if not all(torch.equal(a, b) for a, b in zip(oc.update(), ref)):
            raise RuntimeError(f"rules: fp32 {case} differs from its plain "
                               f"version")
        for fault in planted:
            got = oc.update(fault=fault)
            rel = max(float(((a - b).abs() /
                             (b.abs() + b.abs().max()).clamp_min(1e-30)
                             ).max()) for a, b in zip(got, ref))
            faults[f"{case}:{fault}"] = {
                "max_rel_diff": rel,
                "caught": not all(torch.equal(a, b)
                                  for a, b in zip(got, ref))}
            del got
        del oc, ref
        _release()
    check = {"phase": "rule-fault-check", "tensors": len(sub),
             "elements": total, "fp32": "every bit", "faults": faults}
    _emit(check)
    if not all(f["caught"] for f in faults.values()):
        raise RuntimeError(f"rules: the check missed a planted fault "
                           f"{faults}")
    return rows


def _finite_rows(path, oc, b, kopt, lib_ms, lib):
    """The finiteness check over ``oc``'s gradients: its flag against the
    plain version's, clean and with an inf planted into the last element
    of the last tensor and a NaN into the first of the first (both must
    set it); timed as the rules are."""
    import torch

    from paddle_tpu_torch import kernels

    inv = 1.0 / UNSCALE_SCALE
    flags = {}
    for label, where in (("clean", []), ("inf-last", [(-1, -1, "inf")]),
                         ("nan-first", [(0, 0, "nan")])):
        saved = [(oc.g[t].view(-1)[e].clone(), t, e) for t, e, _v in where]
        for t, e, v in where:
            oc.g[t].view(-1)[e] = float(v)
        kernels.reset_counters()
        got = int(kopt.check_finite(b, inv).item())
        ref = int(kopt.check_finite_plain(b, inv).item())
        launched = kernels.counters()["check_finite"]
        for x, t, e in saved:
            oc.g[t].view(-1)[e] = x
        flags[label] = {"kernel": got, "plain": ref}
        if got != ref or got != bool(where) or launched != {
                "launches": 1, "plain_calls": 0}:
            raise RuntimeError(f"rules: the finiteness check reads "
                               f"{got}, plain {ref}, on {label} gradients "
                               f"({launched})")
    G = _opt_nbytes(oc.g)
    b_ms, b_by = _bound(G, 0, "float32")
    row = {"phase": "kernel", "kernel": "check_finite",
           "case": f"{path}-unscale-bfloat16", "dtype": "bfloat16",
           "tensors": len(oc.g), "elements": sum(g.numel() for g in oc.g),
           "max_abs_err": 0.0, "flags": flags,
           "kernel_ms": _time_ms(lambda: kopt.check_finite(b, inv), iters=10,
                                 warmup=2),
           "graph_ms": _graph_ms(lambda: kopt.check_finite(b, inv), iters=5,
                                 reps=3),
           "plain_ms": _time_ms(lambda: kopt.check_finite_plain(b, inv),
                                iters=2, warmup=1),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
           "library": lib,
           "function_bound_ms": _bound(2 * G, 0, "float32")[0],
           "design_floor_ms": _bound(3 * G, 0, "float32")[0]}
    _emit(row)
    return [row]


# the dense step under each of the eight other rules, graphed against
# eager: (counter, optimizer class, its arguments); the rate halves after
# each step (StepDecay), so a replay that kept a stale header is caught
# for rules that read no step number too
RULE_STEP_OPTS = {
    "sgd": ("sgd_update", "SGD", dict(learning_rate=0.1,
                                      weight_decay=1e-4)),
    "momentum": ("momentum_update", "Momentum",
                 dict(learning_rate=0.05, use_nesterov=True)),
    "adagrad": ("adagrad_update", "Adagrad", dict(learning_rate=1e-2)),
    "adamax": ("adamax_update", "Adamax", dict(learning_rate=1e-3)),
    "rmsprop": ("rmsprop_update", "RMSProp",
                dict(learning_rate=1e-4, momentum=0.9, centered=True)),
    "adadelta": ("adadelta_update", "Adadelta", dict(learning_rate=1.0)),
    "lamb": ("lamb_update", "Lamb", dict(learning_rate=1e-3)),
    "lars": ("lars_update", "LarsMomentum", dict(learning_rate=0.1)),
}
RULE_STEPS = 3


def _rule_steps(model, cfg, ids, flops, state0):
    """The dense bf16 step at batch 4 x 2048 under each rule of
    RULE_STEP_OPTS, each from ``state0`` and its state released before the
    next: RULE_STEPS eager steps (``graph=False``), then the graphed run
    against them (``_graph_run``: every bit, the launches as reckoned, the
    graph's nodes, a planted stale header); finite losses. Returns the
    launches of all the graphed runs and one row per rule."""
    import math

    import paddle_tpu_torch.optimizer as popt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer.lr import StepDecay

    L = cfg.num_hidden_layers
    total, rows = {}, {}
    for rule, (counter, cls, kw) in RULE_STEP_OPTS.items():
        def make_opt():
            args = dict(kw)
            args["learning_rate"] = StepDecay(args["learning_rate"],
                                              step_size=1, gamma=0.5)
            return getattr(popt, cls)(parameters=model.parameters(), **args)

        model.load_state_dict(state0)
        opt = make_opt()
        step = TrainStep(model, lambda m, x, y: m(x, labels=y), opt,
                         graph=False)
        losses, _ms = _timed(step, ids, RULE_STEPS, tick=True)
        ref = _snapshot(model, opt)
        del step, opt
        _release()
        if not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f"rule-steps: {rule} losses {losses}")
        per_step = _dense_launches(L)
        per_step["adam_update"] = 0
        per_step[counter] = 1
        counts, g = _graph_run(f"train-{rule}", model, make_opt, ids,
                               RULE_STEPS, per_step, flops, ref, losses,
                               state0, tick=True)
        del ref
        _release()
        for n, c in counts.items():
            t = total.setdefault(n, {"launches": 0, "plain_calls": 0})
            t["launches"] += c["launches"]
            t["plain_calls"] += c["plain_calls"]
        prof = g["profile"]
        rows[rule] = {"optimizer": cls, "losses": g["losses"],
                      "step_ms": g["step_ms"], "step_ms_each":
                      g["step_ms_each"], "device_ms": prof["device_ms"],
                      "optimizer_device_ms": prof["groups_ms"].get(
                          "optimizer"),
                      "idle_share": prof["idle_share"],
                      "peak_mem_gb": g["peak_mem_gb"],
                      "launches_per_step": {counter: 1}}
        _emit({"phase": "rule-step", "rule": rule, **rows[rule]})
    return total, rows


# (scale, good_steps, bad_steps) after each step of the scaler check:
# three finite steps, then two with a non-finite gradient planted, as the
# reference's state machine moves them (paddle_tpu/amp/grad_scaler.py:
# 84-98; decr_every_n_nan_or_inf 2, incr_every_n_steps 2000)
SCALER_STATES = [(65536.0, 1, 0), (65536.0, 2, 0), (65536.0, 3, 0),
                 (65536.0, 0, 1), (32768.0, 0, 0)]
SCALER_PLANTS = (float("inf"), float("nan"))


def _scaler_check(model, ids, state0):
    """Eager AdamW steps of the dense model (lr 3e-4, wd 0.1) under
    ``GradScaler(init_loss_scaling=2**16)``: three against three unscaled
    steps, every loss, parameter and state tensor equal bit for bit (a
    power-of-two scale is exact through the backward and the unscale);
    then two steps with an inf and a NaN planted into the embedding's
    gradient, both skipped with parameters and state unchanged bit for
    bit, the scale and counters as SCALER_STATES; the launches counted."""
    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.optimizer import AdamW

    def run(scaled, plants=()):
        model.load_state_dict(state0)
        model.train()
        opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                    weight_decay=0.1)
        scaler = GradScaler(init_loss_scaling=2.0 ** 16) if scaled else None
        losses, states, snap = [], [], None
        emb = next(model.parameters())
        for i in range(3 + len(plants)):
            loss = model(ids, labels=ids)
            losses.append(float(loss))
            (scaler.scale(loss) if scaled else loss).backward()
            if i >= 3:
                emb.grad.view(-1)[i] = plants[i - 3]
            if scaled:
                scaler.step(opt)
                states.append((scaler._scale, scaler._good_steps,
                               scaler._bad_steps))
            else:
                opt.step()
            opt.clear_grad()
            del loss
            if i == 2:
                snap = _snapshot(model, opt)
        end = _snapshot(model, opt) if plants else None
        step_no = opt._global_step
        del opt
        return losses, states, snap, end, step_no

    losses_u, _s, ref, _e, _n = run(False)
    _release()
    kernels.reset_counters()
    losses_s, states, got, end, step_no = run(True, SCALER_PLANTS)
    counts = kernels.counters()
    torch.cuda.synchronize()
    same = all(torch.equal(got[k], r) for k, r in ref.items())
    kept = all(torch.equal(end[k], r) for k, r in got.items())
    del ref, got, end
    _release()
    want = {"check_finite": 5, "unscale": 3, "adam_update": 3}
    launched = {n: c["launches"] for n, c in counts.items() if c["launches"]}
    check = {"phase": "scaler-check", "model": "llama-1.16b",
             "init_loss_scaling": 2.0 ** 16,
             "losses_scaled": losses_s, "losses_unscaled": losses_u,
             "bitwise_with_unscaled": same and losses_s[:3] == losses_u,
             "skipped_steps_unchanged": kept, "optimizer_steps": step_no,
             "states": states, "expected_states": SCALER_STATES,
             "launches": launched}
    _emit(check)
    if not (same and losses_s[:3] == losses_u and kept and step_no == 3 and
            [tuple(s) for s in states] == SCALER_STATES and
            launched == {**{n: c for n, c in launched.items()
                            if n not in want}, **want} and
            all(c["plain_calls"] == 0 for c in counts.values())):
        raise RuntimeError(f"scaler: the scaled steps differ from the "
                           f"reference {check}")
    return counts


def phase_master(shapes, seed):
    """``make_master_update`` with AdamW (lr 3e-4, wd 0.1) over fp32
    masters of a model's full parameter set (bf16 parameters and
    gradients, fp32 m and v as after some steps): through the kernel
    against its plain version, masters, states and the cast bf16
    parameters equal in every bit; ms per call beside the bound (28 B an
    element: masters, m, v read and written, the bf16 gradient read, the
    bf16 parameter written) and the plain version's."""
    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.optimizer import AdamW, make_master_update

    kopt = _opt_module()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 60)

    def rnd(shape, scale, dt=torch.float32):
        return (torch.randn(shape, generator=gen, device=DEVICE) *
                scale).to(dt)

    params = [rnd(s, 0.02, torch.bfloat16) for s in shapes]
    grads = [rnd(s, 1e-3, torch.bfloat16) for s in shapes]
    opt = AdamW(learning_rate=3e-4, parameters=params, weight_decay=0.1)
    up = make_master_update(opt, params, [torch.bfloat16] * len(params))
    master = [p.float() for p in params]
    states = [{"moment1": rnd(s, 1e-4), "moment2": rnd(s, 1e-3).square()}
              for s in shapes]

    def copies():
        return ([m.clone() for m in master],
                [{k: v.clone() for k, v in st.items()} for st in states])

    km, ks = copies()
    kernels.reset_counters()
    _m, _s, kcast = up(km, grads, ks, 3e-4, OPT_STEP)
    launched = kernels.counters()["adam_update"]
    with _swapped([(kopt, "adam_update", kopt.adam_update_plain)]):
        _m, _s, pcast = up(master, grads, states, 3e-4, OPT_STEP)
    torch.cuda.synchronize()
    got = km + [v for st in ks for v in st.values()] + kcast
    ref = master + [v for st in states for v in st.values()] + pcast
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, ref))
    del got, ref, kcast, pcast
    n = sum(m.numel() for m in master)
    b_ms, b_by = _bound(28 * n, 0, "float32")
    row = {"phase": "kernel", "kernel": "adam_update",
           "case": "dense-master-fp32", "dtype": "float32",
           "tensors": len(shapes), "elements": n, "max_abs_err": err,
           "bitwise": same, "launches_per_call": launched["launches"],
           "kernel_ms": _time_ms(lambda: up(km, grads, ks, 3e-4, OPT_STEP),
                                 iters=5, warmup=2),
           "plain_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None,
           "library": "no call: torch.optim.AdamW keeps no master"}
    with _swapped([(kopt, "adam_update", kopt.adam_update_plain)]):
        row["plain_ms"] = _time_ms(lambda: up(master, grads, states, 3e-4,
                                              OPT_STEP), iters=2, warmup=1)
    _emit({**row, "phase": "master-check"})
    del km, ks, master, states, params, grads, opt, up
    _release()
    if not (same and launched == {"launches": 1, "plain_calls": 0}):
        raise RuntimeError(f"master: the kernel differs from its plain "
                           f"version or launches otherwise {row}")
    return [row]


# -- phases: GPT-3 6.7B training and its dropout --------------------------------

# GPT-3 6.7B (Brown et al. 2020, Table 2.1; GPTConfig.gpt3_6_7b, the model
# the serving phase answers with) trained as the JAX package's GPT trains:
# ids as labels, AdamW lr 3e-4 / wd 0.1, per-layer recompute, bf16
GPT_BATCH = (2, 2048)
GPT_SEED = 13
# bf16 full-depth gradient check of GPT-3 6.7B: the largest relative L2
# error of any parameter's gradient, kernels against plain-swapped, set as
# the dense step's is, at about 3x the sound reading (0.0282, the position
# embedding's; bf16 rounding on two paths through 32 layers; H100 80GB
# HBM3, 700.00 W); the planted faults read 38.4 (dQ without the softmax
# scale), 182 (dK without it) and 1.47 (dK and dV swapped)
GPT_GRAD_TOL = 0.085
GPT_FAULTS = ("dq_unscaled", "dk_unscaled", "dkv_swapped")
GPT_EAGER_STEPS, GPT_GRAPH_STEPS = 3, 5
# graph = eager bit for bit at this depth (full width): the check keeps a
# copy of the weights (13.3 GB at 32 layers), which does not fit beside
# the full model's AdamW moments (26.6 GB), gradients and activations
GPT_GRAPH_LAYERS = 8
GPT_DROPOUT_P = 0.1


def _gpt_model(layers, seed, **overrides):
    from paddle_tpu_torch.device import seed as pt_seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig.gpt3_6_7b(dtype="bfloat16", use_recompute=True,
                              num_hidden_layers=layers, **overrides)
    return cfg, GPTForCausalLM(cfg, device=DEVICE,
                               generator=pt_seed(seed, DEVICE),
                               dropout_seed=seed)


def _set_dropout(model, p):
    """Sets every dropout of the GPT ``model`` (the ``nn.Dropout`` layers
    and each attention's ``dropout_p``) to ``p``."""
    from paddle_tpu_torch.models import GPTAttention
    from paddle_tpu_torch.nn import Dropout

    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = p
        elif isinstance(m, GPTAttention):
            m.dropout_p = p


def _ids(vocab, batch, seed):
    import torch

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    return torch.randint(0, vocab, batch, generator=gen, device=DEVICE)


def _gpt_flops(cfg, seq):
    """Model FLOPs per token, forward and backward: 6 N + 12 L h s."""
    from paddle_tpu_torch.models import gpt_param_count

    return 6 * gpt_param_count(cfg) + \
        12 * cfg.num_hidden_layers * cfg.hidden_size * seq


def _gpt_launches(L):
    """{counter: launches per step} of the bf16 GPT step; every other
    counter 0: 2L tensor-core flash forwards (recompute runs each layer's
    forward twice), L dK/dV, L dQ, one ``adam_update``."""
    from paddle_tpu_torch import kernels

    per_step = {n: 0 for n in kernels.counters()}
    per_step.update({"flash_attention_sm90": 2 * L,
                     "flash_attention_bwd_dkv_sm90": L,
                     "flash_attention_bwd_dq_sm90": L, "adam_update": 1})
    return per_step


def _gpt_faulty(fault):
    """Planted backward faults of the GPT check: ``dq_unscaled`` (as the
    dense step's), ``dk_unscaled`` (dK times sqrt(d)), ``dkv_swapped``."""
    fa = _flash_module()
    if fault == "dq_unscaled":
        return _faulty(fault)
    real = fa.flash_attention_bwd_dkv

    def dkv(*a):
        dk, dv = real(*a)
        return (dk / a[-1], dv) if fault == "dk_unscaled" else (dv, dk)
    return [(fa, "flash_attention_bwd_dkv", dkv)]


def _exact(path, counts, per_step, n):
    wrong = {k: (c, per_step[k] * n) for k, c in counts.items()
             if c["plain_calls"] or c["launches"] != per_step[k] * n}
    if wrong:
        raise RuntimeError(f"{path}: launches differ from the reckoned "
                           f"(reading, expected): {wrong}")


def _run_figures(batch, seq, ms, skip, flops, peak, prof, losses):
    step_ms = sum(ms[skip:]) / len(ms[skip:])
    tok_s = batch * seq / step_ms * 1e3
    return {"losses": losses, "step_ms": step_ms, "step_ms_each": ms,
            "tokens_per_s": tok_s,
            "mfu": flops * tok_s / PEAK_FLOPS["bfloat16"],
            "peak_mem_gb": peak, "device_ms": prof["device_ms"],
            "events_ms": prof["events_ms"], "idle_share": prof["idle_share"],
            "profiled_wall_ms": prof["wall_ms"],
            "groups_ms": prof["groups_ms"]}


def _falling(path, losses):
    import math

    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise RuntimeError(f"{path}: loss not finite and falling: {losses}")


def _eager_then_graph(path, model, opt, ids, per_step, flops, eager_steps,
                      graph_steps, dump=False):
    """``eager_steps`` eager steps then ``graph_steps`` calls of the graphed
    step (an eager warm-up, the capture and its replay, replays), one
    optimizer throughout: launches exact for both (the graph's reckoned),
    the graph's kernel nodes against the launches (``dump``), losses
    finite and falling, and the figures of each with a profiled step.
    Returns (eager counters, graph counters, eager figures, graph
    figures, node check)."""
    import os
    import tempfile

    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.jit import TrainStep

    batch, seq = ids.shape

    def loss_fn(m, x, y):
        return m(x, labels=y)

    estep = TrainStep(model, loss_fn, opt, graph=False)
    _release()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    elosses, ems = _timed(estep, ids, eager_steps)
    ecounts = kernels.counters()
    epeak = torch.cuda.max_memory_allocated() / 2**30
    _exact(f"{path}-eager", ecounts, per_step, eager_steps)
    eprof = _step_profile(lambda: estep(ids, ids))
    del estep
    _release()
    gstep = TrainStep(model, loss_fn, opt)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    with tempfile.TemporaryDirectory() as tmp:
        if dump:
            gstep.debug_dump = os.path.join(tmp, "step.dot")
        glosses, gms = _timed(gstep, ids, graph_steps)
        dot = open(gstep.debug_dump).read() if dump else None
    gpeak = torch.cuda.max_memory_allocated() / 2**30
    gcounts = _reckoned(gstep)
    _exact(f"{path}-graph", gcounts, per_step, graph_steps + 1)
    captured = next(iter(gstep._graphs.values())).counts
    if captured != {n: c for n, c in per_step.items() if c}:
        raise RuntimeError(f"{path}-graph: captured {captured}")
    nodes = None
    if dump:
        rows, forbidden, total, ok = _node_check(_graph_nodes(dot), per_step)
        nodes = {"nodes": rows, "forbidden_nodes": forbidden,
                 "kernel_nodes": total}
        if not ok:
            raise RuntimeError(f"{path}-graph: the graph's kernel nodes "
                               f"differ from the reckoned launches {nodes}")
    gprof = _step_profile(lambda: gstep(ids, ids))
    del gstep
    _release()
    _falling(f"{path}-eager", elosses)
    _falling(f"{path}-graph", glosses)
    return (ecounts, gcounts,
            _run_figures(batch, seq, ems, 1, flops, epeak, eprof, elosses),
            _run_figures(batch, seq, gms, 2, flops, gpeak, gprof, glosses),
            nodes)


def phase_gpt_train(seed):
    """GPT-3 6.7B at full width and depth, bf16, recompute, batch 2 x 2048:
    the gradient check against the plain-swapped step with planted faults,
    eager steps and the graphed step (exact launches, graph nodes, falling
    loss, figures); the graphed step with dropout 0.1 (step ms, peak
    memory, one rewind a layer); then graph = eager bit for bit at 8
    layers."""
    import math

    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import gpt_param_count
    from paddle_tpu_torch.optimizer import AdamW

    _release()  # the serving engine, a reference cycle, holds its KV pool
    t0 = time.perf_counter()
    cfg, model = _gpt_model(32, seed + GPT_SEED)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    ids = _ids(cfg.vocab_size, GPT_BATCH, seed + GPT_SEED)
    L = cfg.num_hidden_layers

    # gradients at full depth, before the optimizer state exists
    with _swapped(_plain_swaps()):
        loss_p, grads_p = _loss_and_grads(model, ids)
    loss_k, grads_k = _loss_and_grads(model, ids)
    sound = _grad_errors(grads_k, grads_p)
    del grads_k
    faults = {}
    for fault in GPT_FAULTS:
        with _swapped(_gpt_faulty(fault)):
            _l, grads_f = _loss_and_grads(model, ids)
        errs = _grad_errors(grads_f, grads_p)
        del grads_f
        faults[fault] = {"grad_rel_l2_max": max(errs.values()),
                         "worst": _worst(errs, 1),
                         "caught": max(errs.values()) > GPT_GRAD_TOL}
    del grads_p
    _release()
    check = {"phase": "gpt-train-grad-check", "layers": L,
             "dtype": "bfloat16", "batch": list(GPT_BATCH),
             "loss_kernels": loss_k, "loss_plain": loss_p,
             "grad_rel_l2_max": max(sound.values()),
             "grad_worst": _worst(sound), "grad_tol": GPT_GRAD_TOL,
             "params_checked": len(sound), "faults": faults}
    _emit(check)
    if not max(sound.values()) <= GPT_GRAD_TOL:
        raise RuntimeError(f"gpt-train: kernel gradients differ from plain "
                           f"{check}")
    if not all(f["caught"] for f in faults.values()):
        raise RuntimeError(f"gpt-train: the gradient check missed a planted "
                           f"fault {faults}")

    per_step = _gpt_launches(L)
    flops = _gpt_flops(cfg, GPT_BATCH[1])
    opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                weight_decay=0.1)
    ecounts, gcounts, eager, graph, nodes = _eager_then_graph(
        "gpt-train", model, opt, ids, per_step, flops, GPT_EAGER_STEPS,
        GPT_GRAPH_STEPS, dump=True)
    _emit({"phase": "gpt-train", "ok": True, "model": "gpt3-6.7b",
           "card": _nvidia_smi(), "params": gpt_param_count(cfg),
           "layers": L, "dtype": "bfloat16", "recompute": True,
           "batch": list(GPT_BATCH), "optimizer": "AdamW lr 3e-4 wd 0.1",
           "model_init_s": t_init, "flops_per_token": flops,
           "graph": graph, "eager": eager,
           "launches_per_step": {n: c for n, c in per_step.items() if c},
           **nodes})

    # the same model and optimizer with dropout in attention and on the
    # residuals: the recompute keeps no keep mask (each layer rewinds its
    # generator, in the graph through one twin a layer), so the peak is
    # the step's without dropout plus one layer's attention composition
    _set_dropout(model, GPT_DROPOUT_P)
    dstep = TrainStep(model, lambda m, x, y: m(x, labels=y), opt)
    _release()
    torch.cuda.reset_peak_memory_stats()
    dlosses, dms = _timed(dstep, ids, 4)
    dpeak = torch.cuda.max_memory_allocated() / 2**30
    entry = next(iter(dstep._graphs.values()))
    twins = sum(len(t) for _, t, _ in entry.rewinds)
    row = {"phase": "gpt-train-dropout", "layers": L, "p": GPT_DROPOUT_P,
           "batch": list(GPT_BATCH), "card": _nvidia_smi(),
           "losses": dlosses, "step_ms_each": dms,
           "step_ms": sum(dms[2:]) / len(dms[2:]),
           "step_ms_without": graph["step_ms"], "peak_mem_gb": dpeak,
           "peak_mem_gb_without": graph["peak_mem_gb"],
           "captures": dstep.captures, "replays": dstep.replays,
           "rewinds_per_step": twins}
    del dstep, entry
    _set_dropout(model, 0.0)
    _emit(row)
    if not (all(math.isfinite(x) for x in dlosses) and twins == L
            and row["replays"] == 3):
        raise RuntimeError(f"gpt-train-dropout: {row}")
    del opt, model
    _release()

    # the graphed step against the eager one, bit for bit, at 8 layers
    cfg8, model = _gpt_model(GPT_GRAPH_LAYERS, seed + GPT_SEED)

    def make_opt():
        return AdamW(learning_rate=3e-4, parameters=model.parameters(),
                     weight_decay=0.1)

    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_opt()
    estep = TrainStep(model, lambda m, x, y: m(x, labels=y), opt,
                      graph=False)
    kernels.reset_counters()
    ref_losses, _ms = _timed(estep, ids, 3)
    ref = _snapshot(model, opt)
    del estep, opt
    _release()
    counts8, _figures = _graph_run(
        "gpt-train", model, make_opt, ids, 3,
        _gpt_launches(GPT_GRAPH_LAYERS), _gpt_flops(cfg8, GPT_BATCH[1]),
        ref, ref_losses, state0)
    del model, state0, ref
    _release()
    return gcounts, ecounts, counts8


def phase_gpt_dropout(seed):
    """GPT-3 6.7B's width at 2 layers with dropout 0.1 in attention and on
    the residuals (recompute on): the keep share of every mask one step
    draws, each recomputed layer's masks equal to its first run's, a fresh
    mask on each replay (learning rate 0: the losses of
    replays on one batch differ; with p = 0 they do not), and the graphed
    step against the eager step from the same weights and generator state,
    bit for bit."""
    import importlib
    import math

    import torch

    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    pattn = importlib.import_module("paddle_tpu_torch.nn.functional.attention")
    pcommon = importlib.import_module("paddle_tpu_torch.nn.functional.common")
    p = GPT_DROPOUT_P
    cfg, model = _gpt_model(2, seed + GPT_SEED + 1,
                            attention_probs_dropout_prob=p,
                            hidden_dropout_prob=p)
    ids = _ids(cfg.vocab_size, GPT_BATCH, seed + GPT_SEED + 1)
    gen = model.dropout_generator

    def loss_fn(m, x, y):
        return m(x, labels=y)

    # 1. the keep share of every mask of one step; the recompute draws
    # each layer's masks again, equal to its first run's
    drawn = []
    real = pcommon.keep_mask

    def recorder(shape, p_, generator, device):
        m = real(shape, p_, generator, device)
        drawn.append(m)
        return m
    with _swapped([(pattn, "keep_mask", recorder),
                   (pcommon, "keep_mask", recorder)]):
        _loss_and_grads(model, ids)
    layers = cfg.num_hidden_layers
    first, again = drawn[:1 + 3 * layers], drawn[1 + 3 * layers:]
    shares = []
    for m in first:
        n, kept = m.numel(), int(m.sum())
        sigma = math.sqrt(p * (1 - p) / n)
        shares.append({"shape": list(m.shape), "keep_share": kept / n,
                       "sigmas": (kept / n - (1 - p)) / sigma})
    # the backward recomputes the last layer first: layer j's three masks
    # (attention's, then the two residuals') are again[3 * (L-1-j) + t]
    redrawn_ok = len(again) == 3 * layers and all(
        torch.equal(again[3 * (layers - 1 - j) + t], first[1 + 3 * j + t])
        for j in range(layers) for t in range(3))
    calls = len(drawn)
    del drawn, first, again, m
    # 7 masks: the embeddings', then per layer attention's and two residuals'
    share_ok = len(shares) == 1 + 3 * layers and \
        all(abs(s["sigmas"]) <= 4 for s in shares) and redrawn_ok

    # 2. replays at learning rate 0 draw fresh masks; with p = 0 they do not
    state0 = {k: v.clone() for k, v in model.state_dict().items()}

    def steps(lr, n):
        step = TrainStep(model, loss_fn, AdamW(
            learning_rate=lr, parameters=model.parameters(),
            weight_decay=0.1 if lr else 0.0))
        losses, _ = _timed(step, ids, n)
        return step, losses

    fstep, fresh = steps(0.0, 4)
    replays = fstep.replays
    del fstep
    _set_dropout(model, 0.0)
    zstep, still = steps(0.0, 4)
    del zstep
    _set_dropout(model, p)
    _release()
    fresh_ok = replays == 3 and len(set(fresh)) == len(fresh) and \
        len(set(still)) == 1

    # 3. graphed = eager from the same weights and generator state
    model.load_state_dict(state0)
    g0 = gen.get_state()
    estep = TrainStep(model, loss_fn, AdamW(
        learning_rate=3e-4, parameters=model.parameters(),
        weight_decay=0.1), graph=False)
    elosses, _ = _timed(estep, ids, 3)
    ref = _snapshot(model, estep.optimizer)
    g_eager = gen.get_state()
    del estep
    _release()
    model.load_state_dict(state0)
    gen.set_state(g0)
    gstep = TrainStep(model, loss_fn, AdamW(
        learning_rate=3e-4, parameters=model.parameters(),
        weight_decay=0.1))
    glosses, _ = _timed(gstep, ids, 3)
    got = _snapshot(model, gstep.optimizer)
    same, worst, where = _agreement(got, ref, state0)
    gen_same = torch.equal(gen.get_state(), g_eager)
    del gstep, got, ref
    row = {"phase": "gpt-dropout", "layers": cfg.num_hidden_layers,
           "width": cfg.hidden_size, "p": p, "batch": list(GPT_BATCH),
           "masks": shares, "mask_draws": calls,
           "recompute_redraws_first_masks": redrawn_ok,
           "keep_share_ok": share_ok, "lr0_replay_losses": fresh,
           "lr0_p0_losses": still, "fresh_mask_per_replay": fresh_ok,
           "graph_losses": glosses, "eager_losses": elosses,
           "graph_equals_eager_bitwise": same and glosses == elosses,
           "max_rel_diff": worst, "max_rel_where": where,
           "generator_state_equal": gen_same}
    _emit(row)
    if not (share_ok and fresh_ok and row["graph_equals_eager_bitwise"]
            and gen_same):
        raise RuntimeError(f"gpt-dropout: {row}")
    del model, state0
    _release()


# -- phases: the Llama KV cache and the MoE dispatch modes -----------------------

def phase_llama_cache(seed):
    """The 1.16B Llama's attention at full width (hidden 2048, 16 heads of
    128), bf16: one new token over a 2047-token cache runs the single-row
    split-K decode kernel once; its row and the last row of the uncached
    causal call (the tensor-core forward) are each within their kernel's
    tolerance of the plain fp32 attention on the same q, k, v, so within
    the sum of both of each other. Returns the counters of the cached
    call."""
    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.models.llama import (LlamaAttention,
                                               apply_rotary_pos_emb)

    fa = _flash_module()
    cfg = LlamaConfig(**BIG, dtype="bfloat16")
    torch.manual_seed(seed + 16)
    att = LlamaAttention(cfg).to(DEVICE, torch.bfloat16)
    s, h, d = 2048, cfg.num_attention_heads, 128
    x = _rand(torch.Generator(device=DEVICE).manual_seed(seed + 16),
              (1, s, cfg.hidden_size), torch.bfloat16)
    cores = []
    hook = att.o_proj.register_forward_pre_hook(
        lambda m, a: cores.append(a[0].detach()))
    with torch.no_grad():
        full = att(x)
        q = apply_rotary_pos_emb(att.q_proj(x).view(1, s, h, d),
                                 cfg.rope_theta)
        k = apply_rotary_pos_emb(att.k_proj(x).view(1, s, h, d),
                                 cfg.rope_theta)
        v = att.v_proj(x).view(1, s, h, d)
        kernels.reset_counters()
        last, cache = att(x[:, -1:], cache=(k[:, :-1], v[:, :-1]))
        counts = kernels.counters()
    hook.remove()
    full_core, dec_core = (c.view(-1, h, d)[-1].float() for c in cores)

    def bhsd(t):
        return t[0].transpose(0, 1).float()
    ro, _ = fa.flash_attention_plain(bhsd(q), bhsd(k), bhsd(v), 0, True,
                                     d ** -0.5)
    bound_full = fa.sm90_fwd_bound(bhsd(q), bhsd(k), bhsd(v), 0, True,
                                   d ** -0.5, ro)[:, -1]
    ref = ro[:, -1]
    rtol, atol = _tol(torch.bfloat16)
    tol_dec = rtol * ref.abs() + atol
    dec_err = ((dec_core - ref).abs() - tol_dec).max().item()
    full_err = ((full_core - ref).abs() - bound_full).max().item()
    pair_err = ((dec_core - full_core).abs() -
                (tol_dec + bound_full)).max().item()
    launched = {n: c["launches"] for n, c in counts.items() if c["launches"]}
    row = {"phase": "llama-cache", "hidden": cfg.hidden_size, "heads": h,
           "cache_len": s - 1, "new_tokens": 1, "launches": launched,
           "decode_max_abs_err": (dec_core - ref).abs().max().item(),
           "full_max_abs_err": (full_core - ref).abs().max().item(),
           "decode_vs_full_max_abs": (dec_core - full_core).abs().max()
           .item(),
           "module_out_max_abs": (last.float() - full[:, -1:].float()).abs()
           .max().item(), "cache_shape": list(cache[0].shape),
           "tol": "decode 2^-8|ref| + 1e-4; full sm90_fwd_bound; the pair "
                  "their sum"}
    _emit(row)
    if launched != {"flash_attention_decode": 1, "rope": 2} or \
            any(c["plain_calls"] for c in counts.values()):
        raise RuntimeError(f"llama-cache: the cached call's launches {row}")
    if not (dec_err <= 0 and full_err <= 0 and pair_err <= 0) or \
            list(cache[0].shape) != [1, s, h, d]:
        raise RuntimeError(f"llama-cache: the cached row differs {row}")
    del att, x, q, k, v, ro
    _release()
    return counts


# index and einsum on the same layer inputs: each output's and gradient's
# relative L2 difference from index; the two compute the same slots, so
# bf16 leaves one or two roundings of each product (einsum rounds the gates
# and sums the choices in fp32 inside its matmul)
MOE_MODES_TOL = 2.0 ** -6


def phase_moe_modes(seed):
    """The MoE Llama at full width (hidden 1536, 8 experts, top-2) and
    depth 2, bf16, batch 4 x 2048: each MoE layer's input under the
    ``index`` dispatch, then ``index`` and ``einsum`` on those inputs:
    output, aux and the gradients of x, the router and the expert stacks
    agree (MOE_MODES_TOL); no MoE kernel runs (``sort`` runs ``index``).
    The model's loss under each mode is reported beside."""
    import torch

    from paddle_tpu_torch import kernels, set_flags
    from paddle_tpu_torch.nn.layer.moe import moe_mlp

    cfg, model = _moe_model("bfloat16", 2, seed + 17)
    ids = _ids(cfg.vocab_size, MOE_BATCH, seed + 17)
    inputs = []

    def recording(mlp):
        real = mlp.forward_with_aux

        def forward_with_aux(x):
            inputs.append(x.detach())
            return real(x)
        return forward_with_aux

    losses = {}
    mlps = [layer.mlp for layer in model.llama.layers]
    try:
        for mlp in mlps:  # the decoder layer calls forward_with_aux
            mlp.forward_with_aux = recording(mlp)
        for mode in ("index", "einsum"):
            set_flags({"FLAGS_moe_dispatch": mode})
            with torch.no_grad():
                losses[mode] = float(model(ids, labels=ids))
    finally:
        set_flags({"FLAGS_moe_dispatch": "index"})
        for mlp in mlps:
            del mlp.forward_with_aux
    layers = []
    ok = True
    kernels.reset_counters()
    for li in range(cfg.num_hidden_layers):
        mlp = model.llama.layers[li].mlp
        x = inputs[li]  # the index run's inputs
        runs = {}
        for mode in ("index", "einsum"):
            leaves = [x.clone().requires_grad_()] + [
                w.detach().clone().requires_grad_() for w in (
                    mlp.gate_weight, mlp.experts.gate, mlp.experts.up,
                    mlp.experts.down)]
            o, aux = moe_mlp(*leaves, top_k=mlp.top_k,
                             capacity_factor=mlp.capacity_factor,
                             dispatch=mode)
            ((o.float() ** 2).mean() + 0.1 * aux).backward()
            runs[mode] = [o.detach(), aux.detach().reshape(1)] + \
                [t.grad for t in leaves]
            del leaves, o, aux
        names = ["out", "aux", "x", "router", "gate", "up", "down"]
        entry = {"layer": li}
        for mode in ("einsum",):
            errs = {nm: ((a.float() - b.float()).norm() /
                         b.float().norm().clamp_min(1e-30)).item()
                    for nm, a, b in zip(names, runs[mode], runs["index"])}
            entry[mode] = {"rel_l2_max": max(errs.values()),
                           "worst": max(errs, key=errs.get),
                           "bitwise": all(torch.equal(a, b) for a, b in
                                          zip(runs[mode], runs["index"]))}
            ok = ok and max(errs.values()) <= MOE_MODES_TOL
        layers.append(entry)
        del runs
        _release()
    counts = kernels.counters()
    moe_kernels = {n: c for n, c in counts.items() if n.startswith(
        ("moe_", "grouped_matmul")) and (c["launches"] or c["plain_calls"])}
    row = {"phase": "moe-modes", "layers": cfg.num_hidden_layers,
           "dtype": "bfloat16", "batch": list(MOE_BATCH),
           "capacity_factor": cfg.capacity_factor, "per_layer": layers,
           "tol": MOE_MODES_TOL, "model_losses": losses,
           "moe_kernel_launches": moe_kernels}
    _emit(row)
    if not ok or moe_kernels:
        raise RuntimeError(f"moe-modes: the dispatch modes disagree {row}")
    del model, inputs
    _release()


# -- phase: the bench's adafactor_1p8b and long_seq_16k ------------------------

# bench.py _configs(): "big_1p8" (:1846-1849), run as adafactor_1p8b
# (:2025-2027: Adafactor lr 1e-2, batch 4 x 2048), and "long16k"
# (:1852-1855), the 1.16B model at 16384 positions, run as long_seq_16k
# (:2028-2029: AdamW, batch 2 x 16384)
BIG_1P8 = dict(vocab_size=32000, hidden_size=2560, intermediate_size=6912,
               num_hidden_layers=21, num_attention_heads=20,
               num_key_value_heads=20, max_position_embeddings=2048)
BENCH_CONFIGS = [
    ("adafactor_1p8b", BIG_1P8, (4, 2048), "adafactor", 2, 5),
    ("long_seq_16k", {**BIG, "max_position_embeddings": 16384}, (2, 16384),
     "adamw", 2, 4),
]


def phase_bench_configs(seed):
    """Each configuration as the bench runs it, bf16 with recompute: eager
    steps then the graphed step (exact launches, finite falling loss, step
    ms, tokens/s, MFU, peak memory, device ms by group and idle share). At
    16384 the flash forward and backward and RoPE are first held to their
    plain versions at one layer's sequence (bh 1: the plain forward's
    scores take 1 GiB in fp32). Returns ({config: graph counters},
    kernel rows)."""
    import torch

    from paddle_tpu_torch.device import seed as pt_seed
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         llama_flops_per_token,
                                         llama_param_count)
    from paddle_tpu_torch.optimizer import Adafactor, AdamW

    out, rows = {}, []
    for name, shape, batch, rule, eager_n, graph_n in BENCH_CONFIGS:
        if batch[1] > 2048:
            gen = torch.Generator(device=DEVICE)
            gen.manual_seed(seed + 18)
            label = f"long{batch[1] // 1024}k-bfloat16"
            rows.append(_flash_case(label, torch.bfloat16, 1, batch[1],
                                    batch[1], True, gen))
            rows += _flash_bwd_case(label, torch.bfloat16, 1, batch[1],
                                    batch[1], 0, True, gen)
            rows += _rope_case(label, torch.bfloat16, (1, batch[1], 16, 128),
                               0, 1e4, gen, timed=False)
            _release()
        cfg = LlamaConfig(**shape, dtype="bfloat16", use_recompute=True)
        model = LlamaForCausalLM(cfg, device=DEVICE,
                                 generator=pt_seed(seed + 19, DEVICE))
        ids = _ids(cfg.vocab_size, batch, seed + 19)
        if rule == "adafactor":
            opt = Adafactor(learning_rate=1e-2,
                            parameters=model.parameters())
        else:
            opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                        weight_decay=0.1)
        per_step = _dense_launches(cfg.num_hidden_layers)
        if rule == "adafactor":
            per_step.update(adam_update=0, adafactor_stats=1,
                            adafactor_update=1)
        flops = llama_flops_per_token(cfg, batch[1])
        ecounts, gcounts, eager, graph, _nodes = _eager_then_graph(
            name, model, opt, ids, per_step, flops, eager_n, graph_n)
        _emit({"phase": name, "ok": True, "card": _nvidia_smi(),
               "params": llama_param_count(cfg),
               "layers": cfg.num_hidden_layers, "hidden": cfg.hidden_size,
               "dtype": "bfloat16", "recompute": True, "batch": list(batch),
               "optimizer": rule, "flops_per_token": flops, "graph": graph,
               "eager": eager,
               "launches_per_step": {n: c for n, c in per_step.items()
                                     if c}})
        out[name] = gcounts
        out[name + "-eager"] = ecounts
        del model, opt
        _release()
    return out, rows


# -- the distributed slice ------------------------------------------------------

# the ring at the long_seq_16k shapes (bench.py:1852-1855): b 2, 16 heads,
# head dim 128, 16384 positions, cp 4 (4096 a rank); its planted faults run
# in fp32 at 2 x 4096 with 4 heads (the CUDA-core kernels)
RING_SHAPE = dict(b=2, h=16, s=16384, d=128, cp=4)
RING_FAULT_SHAPE = dict(b=2, h=4, s=4096, d=128, cp=4)
# the bf16 ring (and Ulysses) is held to the plain version over the whole
# sequence, head by head, within the tensor-core kernels' bounds (SM90_TOL:
# each ring step's partial obeys them, and so does their weighted sum), dQ
# and dK also within the delta term (the backward's delta comes from the
# ring's bf16 output, the reference's from its own); its distance from
# one-shot flash (two bf16 results, whose P roundings differ) is reported
# beside the single-rounding 2**-8 |ref| + 1e-4. The fp32 fault runs are
# held to one-shot fp32 flash within 1e-4
RING_TOL = SM90_TOL + "; dQ, dK + delta_error_bound"
# (s_loc, offset) of the flash kernels at the ring's offsets: a chunk wholly
# in the future (every row sees no key), the diagonal, wholly in the past;
# odd lengths that no tile divides
RING_OFFSETS = [(4096, -4096), (4096, 0), (4096, 4096), (4096, 3 * 4096),
                (1000, -1000), (1000, 1000), (1000, -777), (1000, 777)]
RING_FAULTS = ("merge_drops_a_step", "offset_off_by_a_tile")


def _nccl_collectives():
    """(a) Every port collective over the world-1 NCCL group on CUDA
    tensors, fp32 and bf16: over one rank each leaves its input as it is
    (reductions, broadcast, scatter) or returns it once (gathers,
    all-to-all). Point-to-point needs a second rank."""
    import torch

    from paddle_tpu_torch import distributed as pdist

    checked = []
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.arange(1, 257, device=DEVICE).to(dtype)

        def same(name, got, want):
            if not torch.equal(got, want):
                raise RuntimeError(f"nccl {name} ({dtype}): "
                                   f"{got.flatten()[:4].tolist()} != "
                                   f"{want.flatten()[:4].tolist()}")
            checked.append(f"{name}-{_dname(dtype)}")

        for op in ("sum", "max", "min", "prod", "avg"):
            t = x.clone()
            pdist.all_reduce(t, op=op)
            same(f"all_reduce_{op}", t, x)
        lst = []
        pdist.all_gather(lst, x)
        same("all_gather", torch.stack(lst), x[None])
        for name, fn in (
                ("broadcast", lambda t: pdist.broadcast(t, src=0)),
                ("reduce", lambda t: pdist.reduce(t, dst=0)),
                ("reduce_scatter", lambda t: pdist.reduce_scatter(t, [x])),
                ("scatter", lambda t: pdist.scatter(t, [x], src=0))):
            t = x.clone() if name in ("broadcast", "reduce") \
                else torch.empty_like(x)
            fn(t)
            same(name, t, x)
        got = []
        pdist.alltoall([x], got)
        same("alltoall", got[0], x)
        pdist.barrier()
    torch.cuda.synchronize()
    row = {"phase": "distributed-collectives", "backend": "nccl",
           "world": 1, "store": "FileStore", "checked": checked, "ok": True}
    _emit(row)
    return row


def _node_kinds(dot):
    """{node type: count} of a CUDA graph's debug dump (KERNEL, MEMCPY,
    MEMSET, ...)."""
    import re
    from collections import Counter

    return dict(Counter(re.findall(r'label="\{(\w+)\s*\n', dot)))


def _params_equal(model, ref):
    import torch

    return [n for n, p in model.named_parameters()
            if not torch.equal(p.detach(), ref[n])]


def _sharded_step(seed):
    """(b) The flagship 1.16B Llama step (``bench.py:1836-1840``: bf16,
    recompute, AdamW lr 3e-4 / wd 0.1, batch 4 x 2048) from the same
    weights four ways: ``jit.TrainStep``, then ``ShardedTrainStep`` under
    ``group_sharded_parallel(level="os_g")`` over the world-1 NCCL mesh,
    each eager and graphed. After 3 steps the sharded step's losses and
    every parameter equal ``TrainStep``'s bit for bit in the same mode; 2
    more steps are timed. The graphs' kernel nodes give the launches the
    sharded step adds. Returns the sharded graphed run's counters."""
    import tempfile

    import torch

    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.device import seed as pt_seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig(**BIG, dtype="bfloat16", use_recompute=True)
    model = LlamaForCausalLM(cfg, device=DEVICE,
                             generator=pt_seed(seed + 23, DEVICE))
    ids = _ids(cfg.vocab_size, (4, 2048), seed + 23)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    pdist.init_mesh()  # every degree 1 over the world-1 NCCL group
    ref, nodes, kinds, runs, gcounts = {}, {}, {}, {}, None

    def loss_fn(m, x, y):
        return m(x, labels=y)

    for graph in (False, True):
        mode = "graph" if graph else "eager"
        for kind in ("train", "sharded"):
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(init[n])
            opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                        weight_decay=0.1)
            if kind == "sharded":
                _m, opt = pdist.group_sharded_parallel(model, opt,
                                                       level="os_g")
                step = pdist.ShardedTrainStep(model, loss_fn, opt,
                                              graph=graph)
            else:
                step = TrainStep(model, loss_fn, opt, graph=graph)
            if graph:
                step.debug_dump = os.path.join(tmp, f"{kind}.dot")
            kernels.reset_counters()
            losses, ms = _timed(step, ids, 3)
            if kind == "train":
                ref[mode] = (losses, {n: p.detach().clone()
                                      for n, p in model.named_parameters()})
                differ = []
            else:
                differ = _params_equal(model, ref[mode][1])
                if losses != ref[mode][0] or differ:
                    raise RuntimeError(
                        f"sharded step ({mode}) differs from TrainStep: "
                        f"losses {losses} vs {ref[mode][0]}, parameters "
                        f"{differ[:3]} ({len(differ)} of "
                        f"{len(ref[mode][1])})")
                del ref[mode]
            if graph:
                dot = open(step.debug_dump).read()
                nodes[kind] = _graph_nodes(dot)
                kinds[kind] = _node_kinds(dot)
                if kind == "sharded":
                    gcounts = _reckoned(step)
            _l, more = _timed(step, ids, 2)
            runs[f"{kind}-{mode}"] = {"losses": losses, "first_ms": ms,
                                      "step_ms": more,
                                      "peak_gb": torch.cuda.max_memory_allocated()
                                      / 2 ** 30}
            del step, opt
            _release()
            torch.cuda.reset_peak_memory_stats()
    pdist.reset_mesh()
    added = {n: c - nodes["train"].get(n, 0) for n, c in
             nodes["sharded"].items() if c != nodes["train"].get(n, 0)}
    removed = {n: c for n, c in nodes["train"].items()
               if n not in nodes["sharded"]}
    row = {"phase": "distributed-sharded-step", "ok": True,
           "card": _nvidia_smi(), "model": "llama-1.16b",
           "batch": [4, 2048], "dtype": "bfloat16", "recompute": True,
           "zero": "os_g", "world": 1, "backend": "nccl",
           "bitwise_equal": {"eager": True, "graph": True}, "runs": runs,
           "graph_nodes_by_type": kinds,
           "nodes_the_sharded_step_adds": added,
           "nodes_it_drops": removed}
    _emit(row)
    del model, init
    _release()
    return gcounts


def _ring_inputs(shape, dtype, gen):
    """q, k, v, dO [b * h, s, d] and their cp chunks along the sequence."""
    bh = shape["b"] * shape["h"]
    ts = [_rand(gen, (bh, shape["s"], shape["d"]), dtype) for _ in range(4)]
    chunks = [list(t.chunk(shape["cp"], dim=1)) for t in ts]
    return ts, chunks


def _ring_run(impl, chunks, shape):
    """The ring or Ulysses through the port's per-rank body over the cp
    chunks on this one device: (o, dq, dk, dv) over the whole sequence."""
    import torch

    from paddle_tpu_torch.distributed import (ring_attention_local,
                                              ulysses_attention_local)

    qs, ks, vs = ([c.detach().contiguous().requires_grad_(True) for c in cs]
                  for cs in chunks[:3])
    if impl == "ring":
        outs = ring_attention_local(qs, ks, vs, causal=True)
        dos = chunks[3]
    else:  # [bh, s, d] chunks as the paddle layout [b, s, h, d]
        b, h = shape["b"], shape["h"]

        def bshd(t):
            return t.reshape(b, h, t.shape[1], t.shape[2]).transpose(1, 2)

        outs = [o.transpose(1, 2).reshape(b * h, o.shape[1], o.shape[3])
                for o in ulysses_attention_local(
                    [bshd(q) for q in qs], [bshd(k) for k in ks],
                    [bshd(v) for v in vs], causal=True)]
        dos = chunks[3]
    torch.autograd.backward(outs, dos)
    return [torch.cat(t, dim=1) for t in (
        [o.detach() for o in outs], [q.grad for q in qs],
        [k.grad for k in ks], [v.grad for v in vs])]


def _one_shot(ts):
    """One flash call over the whole sequence: (o, dq, dk, dv)."""
    import torch

    fa = _flash_module()
    q, k, v = (t.detach().clone().requires_grad_(True) for t in ts[:3])
    o, _lse = fa.flash_attention_with_lse(q, k, v, 0, True)
    o.backward(ts[3])
    return [o.detach(), q.grad, k.grad, v.grad]


def _ring_check(label, got, ref):
    """fp32: each of o, dQ, dK, dV within 1e-4 of ``ref``; returns the worst
    error."""
    return max(_compare(f"{label}.{name}", g, r.float(), (0.0, 1e-4))[0]
               for name, g, r in zip(("o", "dq", "dk", "dv"), got, ref))


def _ring_distance(got, ref):
    """(largest |got - ref| over o, dQ, dK, dV; the largest share of
    elements beyond the single-rounding 2**-8 |ref| + 1e-4)."""
    worst, beyond = 0.0, 0.0
    for g, r in zip(got, ref):
        diff = (g.float() - r.float()).abs()
        worst = max(worst, diff.max().item())
        beyond = max(beyond, (diff > 2.0 ** -8 * r.float().abs() + 1e-4)
                     .float().mean().item())
    return worst, beyond


def _ring_vs_plain(label, got, ts):
    """(o, dQ, dK, dV) of a bf16 ring over [bh, s, d] against the plain
    version over the whole sequence, one head at a time: o within the
    tensor-core forward's bound; the gradients against the plain backward
    with its own ``delta = rowsum(dO * O)``, within the kernels' bounds
    plus, for dQ and dK, the bound of what the backward's delta from the
    ring's own output moves (``delta_error_bound``: the forward's measured
    difference carried through). Returns (the worst error, the largest
    delta term)."""
    import torch

    fa = _flash_module()
    scale = 1.0 / ts[0].shape[-1] ** 0.5
    worst = term = 0.0
    for i in range(ts[0].shape[0]):
        f32 = [t[i:i + 1].float() for t in ts]
        o, dq, dk, dv = (t[i:i + 1] for t in got)
        with torch.no_grad():
            ro, rl = fa.flash_attention_plain(*f32[:3], 0, True, scale)
        errs = [_compare_bound(f"{label}[{i}].o", o, ro, fa.sm90_fwd_bound(
            *f32[:3], 0, True, scale, ro))[0]]
        args = (rl, (f32[3] * ro).sum(-1), 0, True, scale)
        # the ring's backward took delta from its own bf16 output
        e_dq, e_dk = fa.delta_error_bound(
            f32[0], f32[1], rl, (f32[3] * (o.float() - ro)).sum(-1), 0, True,
            scale)
        term = max(term, e_dq.max().item(), e_dk.max().item())
        del ro
        rdk, rdv = fa.flash_attention_bwd_dkv_plain(*f32, *args)
        bdk, bdv = fa.sm90_dkv_bound(*f32, *args, rdk, rdv)
        errs += [_compare_bound(f"{label}[{i}].dk", dk, rdk, bdk + e_dk)[0],
                 _compare_bound(f"{label}[{i}].dv", dv, rdv, bdv)[0]]
        del rdk, rdv, bdk, bdv, e_dk
        rdq = fa.flash_attention_bwd_dq_plain(*f32, *args)
        errs.append(_compare_bound(
            f"{label}[{i}].dq", dq, rdq,
            fa.sm90_dq_bound(*f32, *args, rdq) + e_dq)[0])
        worst = max(worst, *errs)
        del rdq, f32, args, e_dq
    _release()
    return worst, term


def _ring_fault(fault):
    """(module, attribute, replacement) planting ``fault`` in the ring's
    per-rank body, which looks both names up at call time."""
    import importlib

    cpm = importlib.import_module(
        "paddle_tpu_torch.distributed.context_parallel")
    if fault == "merge_drops_a_step":
        real = cpm.merge_partials

        def merge(o, lse, o_r, lse_r, _n=[0]):
            _n[0] += 1
            if _n[0] % 3 == 0:  # every third merge keeps what it had
                return o, lse
            return real(o, lse, o_r, lse_r)
        return [(cpm, "merge_partials", merge)]
    real_off = cpm.ring_offset

    def offset(idx, r, cp, s_loc):
        off = real_off(idx, r, cp, s_loc)
        return off + 64 if off else off  # a tile of the CUDA-core kernel
    return [(cpm, "ring_offset", offset)]


def _ring_phase(seed):
    """(c) The ring and Ulysses at the long_seq_16k shapes, cp 4 on one
    device, forward and backward, against one-shot flash over the whole
    sequence (and at bh 1 against the plain version), with the launches
    counted; (e) the planted faults that the check must catch. Returns
    ({path: counters}, rows)."""
    import torch

    from paddle_tpu_torch import kernels

    fa = _flash_module()
    shape = dict(RING_SHAPE)
    cp = shape["cp"]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 29)
    ts, chunks = _ring_inputs(shape, torch.bfloat16, gen)
    ref = _one_shot(ts)
    paths, worst, distance, delta_term = {}, {}, {}, {}
    for impl in ("ring", "ulysses"):
        kernels.reset_counters()
        got = _ring_run(impl, chunks, shape)
        torch.cuda.synchronize()
        counts = kernels.counters()
        paths[impl] = counts
        per = cp * cp if impl == "ring" else cp
        want = {"flash_attention_sm90": per,
                "flash_attention_bwd_dkv_sm90": per,
                "flash_attention_bwd_dq_sm90": per,
                "flash_attention": 0, "flash_attention_bwd_dkv": 0,
                "flash_attention_bwd_dq": 0, "flash_attention_decode": 0,
                "flash_attention_tf32x3": 0,
                "flash_attention_bwd_dkv_tf32x3": 0,
                "flash_attention_bwd_dq_tf32x3": 0}
        seen = {n: counts[n]["launches"] for n in want}
        plain = sum(c["plain_calls"] for c in counts.values())
        if seen != want or plain:
            raise RuntimeError(f"{impl}: launches {seen} (want {want}), "
                               f"{plain} plain calls")
        worst[impl], delta_term[impl] = _ring_vs_plain(impl, got, ts)
        distance[impl] = _ring_distance(got, ref)
        del got
        _release()

    ring_ms = _time_ms(lambda: _ring_run("ring", chunks, shape), iters=3,
                       warmup=1)
    uly_ms = _time_ms(lambda: _ring_run("ulysses", chunks, shape), iters=3,
                      warmup=1)
    one_ms = _time_ms(lambda: _one_shot(ts), iters=3, warmup=1)
    del ts, chunks, ref
    _release()

    # (e) planted faults, fp32: the sound ring passes, each fault fails
    fshape = dict(RING_FAULT_SHAPE)
    fts, fchunks = _ring_inputs(fshape, torch.float32, gen)
    fref = _one_shot(fts)
    sound = _ring_check("ring-fp32", _ring_run("ring", fchunks, fshape),
                        fref)
    caught = {}
    for fault in RING_FAULTS:
        with _swapped(_ring_fault(fault)):
            got = _ring_run("ring", fchunks, fshape)
        try:
            _ring_check(f"ring-{fault}", got, fref)
        except RuntimeError as e:  # the check must fail: that is a catch
            caught[fault] = str(e)[:160]
        else:
            raise RuntimeError(f"the ring check missed the planted fault "
                               f"{fault}")
    del fts, fchunks, fref
    _release()
    row = {"phase": "distributed-ring", "ok": True, "card": _nvidia_smi(),
           "shape": shape, "s_loc": shape["s"] // cp, "dtype": "bfloat16",
           "tol": RING_TOL + " against the plain version, head by head",
           "max_abs_err": worst, "largest_delta_term": delta_term,
           "one_shot_flash": {
               impl: {"max_abs_diff": d, "share_beyond_2^-8|ref|+1e-4": b}
               for impl, (d, b) in distance.items()},
           "launches": {impl: {n: paths[impl][n]["launches"] for n in (
               "flash_attention_sm90", "flash_attention_bwd_dkv_sm90",
               "flash_attention_bwd_dq_sm90")} for impl in paths},
           "fwd_bwd_ms": {"ring": ring_ms, "ulysses": uly_ms,
                          "one_shot_flash": one_ms},
           "faults_fp32": {"shape": fshape, "sound_max_abs_err": sound,
                           "caught": caught}}
    _emit(row)
    return paths


def _offset_case(label, dtype, s, offset, gen, with_dlse):
    """(d) The forward, dK/dV and dQ kernels (bf16: tensor cores; fp32:
    the 3xTF32 kernels) on one ring step's chunk pair at ``offset`` against
    their plain versions; a chunk wholly in the future must give o = 0,
    lse = -1e30 and dQ = dK = dV = 0 exactly. Returns kernel rows."""
    import torch

    fa = _flash_module()
    bh, d = 2, 128
    scale = 1.0 / d ** 0.5
    q, k, v, do = (_rand(gen, (bh, s, d), dtype) for _ in range(4))
    f32 = [t.float() for t in (q, k, v, do)]
    o, lse = fa.flash_attention_fwd(q, k, v, offset, True, scale)
    with torch.no_grad():
        ro, rl = fa.flash_attention_plain(*f32[:3], offset, True, scale)
    delta = (f32[3] * ro).sum(-1)
    if with_dlse:
        delta = delta - _rand(gen, (bh, s), torch.float32)
    args = (rl, delta, offset, True, scale)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, *args)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, *args)
    torch.cuda.synchronize()
    rdk, rdv = fa.flash_attention_bwd_dkv_plain(*f32, *args)
    rdq = fa.flash_attention_bwd_dq_plain(*f32, *args)
    sm90 = fa.takes_sm90(dtype, d, s)
    if sm90:
        bdk, bdv = fa.sm90_dkv_bound(*f32, *args, rdk, rdv)
        errs = [_compare_bound(f"{label}.o", o, ro, fa.sm90_fwd_bound(
                    *f32[:3], offset, True, scale, ro))[0],
                max(_compare_bound(f"{label}.dk", dk, rdk, bdk)[0],
                    _compare_bound(f"{label}.dv", dv, rdv, bdv)[0]),
                _compare_bound(f"{label}.dq", dq, rdq, fa.sm90_dq_bound(
                    *f32, *args, rdq))[0]]
    else:
        tol = _tol(dtype)
        errs = [_compare(f"{label}.o", o, ro, tol)[0],
                max(_compare(f"{label}.dk", dk, rdk, tol)[0],
                    _compare(f"{label}.dv", dv, rdv, tol)[0]),
                _compare(f"{label}.dq", dq, rdq, tol)[0]]
    lse_err, _ = _compare(f"{label}.lse", lse, rl, (0.0, 1e-3))
    exact = None
    if offset <= -s:
        exact = bool(not o.any() and not dk.any() and not dv.any()
                     and not dq.any() and (lse == -1e30).all())
        if not exact:
            raise RuntimeError(f"{label}: a chunk wholly in the future gave "
                               f"nonzero o/dQ/dK/dV or lse != -1e30")
    suffix = "_sm90" if sm90 else \
        "_tf32x3" if fa.takes_tf32x3(dtype, d, s) else ""
    base = {"phase": "kernel", "case": label, "dtype": _dname(dtype),
            "bh": bh, "sq": s, "sk": s, "offset": offset, "causal": True,
            "dlse": with_dlse, "exact_zeros": exact,
            "tol": SM90_TOL if sm90 else _tol(dtype)}
    rows = [dict(base, kernel="flash_attention" + suffix,
                 max_abs_err=errs[0], lse_max_abs_err=lse_err),
            dict(base, kernel="flash_attention_bwd_dkv" + suffix,
                 max_abs_err=errs[1]),
            dict(base, kernel="flash_attention_bwd_dq" + suffix,
                 max_abs_err=errs[2])]
    for row in rows:
        _emit(row)
    del f32, ro, rl, rdk, rdv, rdq
    _release()
    return rows


def phase_distributed(seed):
    """The distributed slice on one card: (a) the collectives over a
    world-1 NCCL group (a ``FileStore`` in a temporary directory), (b)
    ``ShardedTrainStep`` on the flagship step against ``TrainStep``, (d)
    the flash kernels at the ring's offsets, (c) the ring and Ulysses at
    full width with (e) their planted faults. Returns ({path: counters},
    kernel rows)."""
    import tempfile

    import torch

    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch import kernels

    store = torch.distributed.FileStore(
        os.path.join(tempfile.mkdtemp(prefix="chip_smoke_nccl_"), "store"),
        1)
    pdist.init_parallel_env(backend="nccl", store=store, rank=0,
                            world_size=1)
    _nccl_collectives()
    sharded = _sharded_step(seed)
    torch.distributed.destroy_process_group()
    rows = []
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 31)
    for dtype in (torch.bfloat16, torch.float32):
        for i, (s, off) in enumerate(RING_OFFSETS):
            rows += _offset_case(f"ring{s}@{off}-{_dname(dtype)}", dtype, s,
                                 off, gen, with_dlse=i % 2 == 1)
    kernels.reset_counters()
    paths = _ring_phase(seed)
    paths["sharded-step"] = sharded
    return paths, rows


# -- phase: the pipeline, the in-graph scaler, gradient merge, checkpoints ----

PIPE_PP, PIPE_M, PIPE_ROWS, PIPE_SEQ = 4, 8, 8, 4096  # M = 8 x (1 x 4096)
PIPE_LAYERS = 4          # Llama-2 7B's widths, depth cut from 32 (8 up to
                         # PR 20; halved to make room for the DiT and
                         # ResNet phases: one layer a stage)
PIPE_GRAD_TOL = 1e-4     # fp32 twin: per-tensor ||g - ref|| / ||ref||
PIPE_FAULTS = ("activation_grad_dropped", "microbatch_order_reversed")
SCALER_KW = dict(init_loss_scaling=2.0 ** 15, incr_every_n_steps=2,
                 decr_every_n_nan_or_inf=1)


def _pipe_stages(cfg, seed, pp):
    """Every stage of the pp-stage Llama, each drawn as the pp = 1 model is
    from the same generator."""
    from paddle_tpu_torch.device import seed as pt_seed
    from paddle_tpu_torch.models import LlamaForCausalLM

    return [LlamaForCausalLM(cfg, device=DEVICE,
                             generator=pt_seed(seed, DEVICE), stage=(r, pp))
            for r in range(pp)]


def _local_pipeline_step():
    """The one-device pipeline step, ``tools/pipeline_harness.py``."""
    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
    if tools not in sys.path:
        sys.path.append(tools)
    from pipeline_harness import LocalPipelineStep
    return LocalPipelineStep


def _stage_params(stages):
    return {n: p for st in stages for n, p in st.named_parameters()}


def _pipe_run(stages, state0, graph, ids, steps, timed):
    """``LocalPipelineStep`` (AdamW lr 3e-4 / wd 0.1) from ``state0``:
    (losses, step ms of ``timed`` more calls, the reckoned launches of the
    first ``steps``, the parameters after them, peak GiB)."""
    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.optimizer import AdamW

    LocalPipelineStep = _local_pipeline_step()
    params = _stage_params(stages)
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(state0[n])
    opt = AdamW(learning_rate=3e-4, parameters=list(params.values()),
                weight_decay=0.1)
    step = LocalPipelineStep(stages, opt, PIPE_M, graph=graph)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    losses, _ms = _timed(step, ids, steps)
    counts = _reckoned(step) if graph else kernels.counters()
    after = {n: p.detach().clone() for n, p in params.items()}
    _l, ms = _timed(step, ids, timed)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del step, opt
    _release()
    return losses, ms, counts, after, peak


def _pipe_exact(path, counts, per_step, n):
    wrong = {k: (c["launches"], per_step.get(k, 0) * n)
             for k, c in counts.items()
             if c["plain_calls"] or c["launches"] != per_step.get(k, 0) * n}
    if wrong:
        raise RuntimeError(f"{path}: launches differ from the reckoned "
                           f"(reading, expected): {wrong}")


def _pipe_twin_grads(stages, ids, m):
    """Per-parameter fp32 gradient sums of ``pipeline_local`` over the
    stages."""
    from paddle_tpu_torch.distributed.meta_parallel import pipeline_local

    _losses, accs = pipeline_local(stages, ids, ids, num_microbatches=m)
    out = {}
    for st, acc in zip(stages, accs):
        for (n, _p), a in zip(st.named_parameters(), acc):
            out[n] = a
    return out


def _pipe_fault(fault):
    """(module, attribute, replacement) planting ``fault`` in the schedule:
    the first stage's activation gradient of microbatch 1 dropped at the
    boundary, or the second stage running its microbatches in reverse."""
    import importlib

    import torch

    pm = importlib.import_module(
        "paddle_tpu_torch.distributed.meta_parallel.pipeline")
    real = pm.stage_body
    if fault == "activation_grad_dropped":
        def body(run, pp, rank, m):
            gen = real(run, pp, rank, m)
            got, seen = None, 0
            while True:
                try:
                    hop, t = gen.send(got)
                except StopIteration:
                    return
                got = yield (hop, t)
                if rank == 0 and hop in ("recv_bwd", "send_fwd_recv_bwd") \
                        and got is not None:
                    seen += 1
                    if seen == 2:
                        got = torch.zeros_like(got)
        return [(pm, "stage_body", body)]

    def reversed_body(run, pp, rank, m):
        if rank == 1:
            run.mbs = run.mbs[::-1]
        return real(run, pp, rank, m)
    return [(pm, "stage_body", reversed_body)]


def _pipe_twin(seed):
    """(a') The fp32 twin: Llama-2 7B's widths at 2 layers in 2 stages,
    ``pipeline_local``'s fp32 gradient sums over 4 microbatches against
    the pp = 1 model's (each microbatch's backward, summed in fp32), per
    tensor within PIPE_GRAD_TOL; each planted fault must exceed it."""
    import torch

    from paddle_tpu_torch.device import seed as pt_seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2, dtype="float32")
    ids = _ids(cfg.vocab_size, (4, 512), seed + 53)
    full = LlamaForCausalLM(cfg, device=DEVICE,
                            generator=pt_seed(seed + 53, DEVICE))
    stages = _pipe_stages(cfg, seed + 53, 2)
    ref = {n: torch.zeros(p.shape, dtype=torch.float32, device=DEVICE)
           for n, p in full.named_parameters()}
    count = (ids[:, 1:] != -100).sum()
    full.train()
    for mb in ids.reshape(4, 1, 512):
        full.zero_grad(set_to_none=True)
        loss = full(mb, labels=mb) * ((mb[:, 1:] != -100).sum() / count)
        loss.backward()
        with torch.no_grad():
            for n, p in full.named_parameters():
                ref[n].add_(p.grad.float())
    full.zero_grad(set_to_none=True)
    del full, loss
    _release()

    def check(label, grads):
        errs = _grad_errors(grads, ref)
        worst = max(errs.values())
        if worst > PIPE_GRAD_TOL:
            raise RuntimeError(f"pipeline twin ({label}): gradient off by "
                               f"{worst:.3e} > {PIPE_GRAD_TOL} at "
                               f"{_worst(errs)}")
        return worst

    sound = check("sound", _pipe_twin_grads(stages, ids, 4))
    caught = {}
    for fault in PIPE_FAULTS:
        with _swapped(_pipe_fault(fault)):
            grads = _pipe_twin_grads(stages, ids, 4)
        try:
            check(fault, grads)
        except RuntimeError as e:  # the check must fail: that is a catch
            caught[fault] = str(e)[:160]
        else:
            raise RuntimeError(f"the pipeline check missed the planted "
                               f"fault {fault}")
        del grads
    del stages, ref
    _release()
    return {"model": "llama2-7b-width", "layers": 2, "pp": 2,
            "microbatches": 4, "batch": [4, 512], "dtype": "float32",
            "grad_tol": PIPE_GRAD_TOL, "sound_worst": sound,
            "caught": caught}


def _pipe_full_width(seed):
    """(a) The Llama at Llama-2 7B's widths (hidden 4096, 32 heads,
    intermediate 11008, vocab 32000), depth 8 in 4 stages on one card,
    bf16, recompute, AdamW: M = 8 microbatches of 1 x 4096 through
    ``pipeline_local`` (``LocalPipelineStep``), two steps eager and two
    graphed, equal bit for bit; both equal bit for bit to the pp = 1
    model's ``TrainStep.accumulate(8)`` from the same generator; launches
    reckoned exactly. Returns (row, the graphed run's counters)."""
    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.device import seed as pt_seed
    from paddle_tpu_torch.distributed.meta_parallel import bubble_fraction
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=PIPE_LAYERS,
                                dtype="bfloat16", use_recompute=True)
    ids = _ids(cfg.vocab_size, (PIPE_ROWS, PIPE_SEQ), seed + 51)
    stages = _pipe_stages(cfg, seed + 51, PIPE_PP)
    state0 = {n: p.detach().clone() for n, p in _stage_params(stages).items()}
    per_step = {n: PIPE_M * c for n, c in
                _dense_launches(PIPE_LAYERS).items()}
    per_step["adam_update"] = 1
    runs = {}
    for graph in (False, True):
        mode = "graph" if graph else "eager"
        losses, ms, counts, after, peak = _pipe_run(stages, state0, graph,
                                                    ids, 2, 2)
        # a graphed run's first call is the eager warm-up and its second
        # the capture (the wrappers count) and a replay
        _pipe_exact(f"pipeline ({mode})", counts, per_step,
                    3 if graph else 2)
        runs[mode] = {"losses": losses, "step_ms": ms, "peak_gib": peak,
                      "after": after, "counts": counts}
    same = runs["graph"]["losses"] == runs["eager"]["losses"] and all(
        torch.equal(runs["graph"]["after"][n], runs["eager"]["after"][n])
        for n in state0)
    if not same:
        raise RuntimeError("pipeline: the graphed steps differ from the "
                           "eager ones")
    # the pp = 1 model from the same generator, TrainStep.accumulate(8)
    del stages
    _release()
    full = LlamaForCausalLM(cfg, device=DEVICE,
                            generator=pt_seed(seed + 51, DEVICE))
    for n, p in full.named_parameters():
        if not torch.equal(p, state0[n]):
            raise RuntimeError(f"pipeline: stage tensor {n} is not the pp = "
                               f"1 model's draw")
    opt = AdamW(learning_rate=3e-4, parameters=full.parameters(),
                weight_decay=0.1)
    acc = TrainStep(full, lambda m, x, y: m(x, labels=y), opt) \
        .accumulate(PIPE_M)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    acc_losses, _ = _timed(acc, ids, 2)
    acc_after = {n: p.detach().clone() for n, p in full.named_parameters()}
    _l, acc_ms = _timed(acc, ids, 2)
    acc_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    before = {n: t for n, t in state0.items()}
    bitwise, worst, where = _agreement(runs["graph"]["after"], acc_after,
                                       before)
    loss_same = acc_losses == runs["graph"]["losses"]
    del acc, opt, full, acc_after
    _release()
    # the same fp32 sums in the same microbatch order: every bit (should
    # an op ever break that, the fp32 twin (a') is what holds the sums)
    if not (bitwise and loss_same):
        raise RuntimeError(
            f"pipeline: differs from accumulate({PIPE_M}): losses "
            f"{runs['graph']['losses']} vs {acc_losses}, parameters "
            f"{worst:.3e} apart at {where}")
    tokens = PIPE_ROWS * PIPE_SEQ
    h, L = cfg.hidden_size, PIPE_LAYERS
    row = {"phase": "pipeline", "ok": True, "card": _nvidia_smi(),
           "model": "llama2-7b-width", "layers": L, "pp": PIPE_PP,
           "microbatches": PIPE_M, "microbatch": [1, PIPE_SEQ],
           "dtype": "bfloat16", "recompute": True,
           "bubble_fraction": bubble_fraction(PIPE_M, PIPE_PP),
           # activations forward and their gradients back, bf16, at each
           # of the pp - 1 boundaries, per microbatch
           "p2p_bytes_per_step": 2 * (PIPE_PP - 1) * PIPE_M * PIPE_SEQ * h
           * 2,
           "graph_equals_eager": same,
           "losses": runs["graph"]["losses"],
           "accumulate_losses": acc_losses,
           "accumulate_bitwise": True,
           "step_ms": {"eager": runs["eager"]["step_ms"],
                       "graph": runs["graph"]["step_ms"],
                       "accumulate_graph": acc_ms},
           "tokens_per_s": tokens / (min(runs["graph"]["step_ms"]) / 1e3),
           "peak_gib": {"eager": runs["eager"]["peak_gib"],
                        "graph": runs["graph"]["peak_gib"],
                        "accumulate_graph": acc_peak},
           "launches_per_step": {k: v for k, v in per_step.items() if v},
           "launches_exact": True}
    counts = runs["graph"]["counts"]
    del runs, state0
    _release()
    return row, counts


def _scaler_runs(model, state0, ids, seed):
    """(b) The in-graph scaler on the 1.16B step at world-1 NCCL, graphed,
    against the eager GradScaler loop from the same weights: an inf
    planted in step 2's gradient (a hook multiplies the final norm's
    gradient by a device scalar set to inf for that step). Both equal bit
    for bit: losses, parameters, the skip, the scale, the update count."""
    import torch

    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.optimizer import AdamW

    plant = torch.ones((), dtype=torch.float32, device=DEVICE)
    hook = model.llama.norm.weight.register_hook(
        lambda g: g * plant.to(g.dtype))
    steps = 4
    out = {}
    try:
        for kind in ("eager_scaler", "sharded_graph"):
            model.load_state_dict(state0)
            opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                        weight_decay=0.1)
            sc = GradScaler(**SCALER_KW)
            kernels.reset_counters()
            losses, scales = [], []
            if kind == "sharded_graph":
                step = pdist.ShardedTrainStep(
                    model, lambda m, x, y: m(x, labels=y), opt, scaler=sc)
            for i in range(steps):
                plant.fill_(float("inf") if i == 1 else 1.0)
                if kind == "eager_scaler":
                    model.train()
                    loss = model(ids, labels=ids)
                    sc.scale(loss).backward()
                    sc.step(opt)
                    opt.clear_grad()
                    losses.append(float(loss.detach()))
                    del loss
                else:
                    losses.append(float(step(ids, ids)))
                scales.append(float(sc._scale))
            counts = _reckoned(step) if kind == "sharded_graph" \
                else kernels.counters()
            out[kind] = {"losses": losses, "scales": scales,
                         "updates": int(opt._global_step),
                         "snap": _snapshot(model, opt), "counts": counts}
            if kind == "sharded_graph":
                out[kind]["amp_state"] = step.amp_state()
                plant.fill_(1.0)
                _l, out[kind]["step_ms"] = _timed(step, ids, 3)
                del step
            del opt
            _release()
    finally:
        hook.remove()
    a, b = out["eager_scaler"], out["sharded_graph"]
    bitwise = a["losses"] == b["losses"] and all(
        torch.equal(a["snap"][k], b["snap"][k]) for k in a["snap"])
    state = b["amp_state"]
    held = (a["scales"] == b["scales"] and a["updates"] == b["updates"]
            == steps - 1 and state["updates"] == steps - 1 and
            b["scales"][1] == SCALER_KW["init_loss_scaling"] / 2)
    if not (bitwise and held):
        raise RuntimeError(f"in-graph scaler: differs from the eager "
                           f"GradScaler loop: losses {a['losses']} vs "
                           f"{b['losses']}, scales {a['scales']} vs "
                           f"{b['scales']}, updates {a['updates']} vs "
                           f"{b['updates']}, bitwise {bitwise}")
    per_step = _dense_launches(model.config.num_hidden_layers)
    per_step.update({"check_finite": 1, "unscale": 1})
    # warm-up, capture and steps - 1 replays; the skipped step's AdamW
    # kernel launches too and returns at once (the device skip flag)
    want = {k: v * (steps + 1) for k, v in per_step.items()}
    got = {k: c["launches"] for k, c in b["counts"].items()}
    if any(got.get(k, 0) != v for k, v in want.items()):
        raise RuntimeError(f"in-graph scaler: launches {got} != {want}")
    return {"steps": steps, "planted_inf_step": 2, "scaler": SCALER_KW,
            "graph_step_ms": b["step_ms"],
            "losses": b["losses"], "scales": b["scales"],
            "amp_state": state, "bitwise_equal_eager_scaler": True,
            "eager_launches_check_finite":
                a["counts"]["check_finite"]["launches"]}, b["counts"]


def _merge_runs(model, state0, ids):
    """(b) ``accum_steps=2`` over two calls (each half the batch) and
    ``accumulate(2)`` on the whole batch, both graphed, against
    ``TrainStep.accumulate(2)``: two windows, losses and parameters bit
    for bit."""
    import torch

    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    def fresh():
        model.load_state_dict(state0)
        return AdamW(learning_rate=3e-4, parameters=model.parameters(),
                     weight_decay=0.1)

    def loss_fn(m, x, y):
        return m(x, labels=y)

    windows = 3
    opt = fresh()
    ref = TrainStep(model, loss_fn, opt).accumulate(2)
    ref_losses = [ref(ids, ids) for _ in range(windows)]
    ref_snap = _snapshot(model, opt)
    del ref, opt
    _release()
    rows, counts = {}, None
    for kind in ("accum_steps", "accumulate"):
        opt = fresh()
        kernels.reset_counters()
        if kind == "accum_steps":
            step = pdist.ShardedTrainStep(model, loss_fn, opt, accum_steps=2)
            halves = ids.chunk(2)
            losses = []
            for _ in range(windows):
                pair = [step(h, h) for h in halves]
                losses.append(torch.stack(pair).mean())
        else:
            step = pdist.ShardedTrainStep(model, loss_fn, opt).accumulate(2)
            losses = [step(ids, ids) for _ in range(windows)]
        snap = _snapshot(model, opt)
        same = all(torch.equal(a, b) for a, b in zip(losses, ref_losses)) \
            and all(torch.equal(snap[k], ref_snap[k]) for k in ref_snap)
        if not same:
            raise RuntimeError(f"{kind}: differs from TrainStep.accumulate"
                               f"(2): losses {[float(x) for x in losses]} "
                               f"vs {[float(x) for x in ref_losses]}")
        rows[kind] = {"losses": [float(x) for x in losses],
                      "bitwise_equal_accumulate": True}
        if kind == "accumulate":
            counts = _reckoned(step)
        del step, opt, snap
        _release()
    return rows, counts


def _checkpoint_round_trip(model, state0, ids, seed):
    """(c) Save the 1.16B model and its AdamW state from
    ``ShardedTrainStep`` after a step, load them into a fresh model and
    optimizer, take one step: equal to the unbroken run's next step bit
    for bit (eager, so both sides take the same path). GB/s of the save
    and of the load."""
    import shutil
    import tempfile

    import torch

    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.device import seed as pt_seed
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    def loss_fn(m, x, y):
        return m(x, labels=y)

    model.load_state_dict(state0)
    opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                weight_decay=0.1)
    step = pdist.ShardedTrainStep(model, loss_fn, opt, graph=False)
    step(ids, ids)
    path = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_sharded_model(model, opt, path)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        want_loss = float(step(ids, ids))
        want = _snapshot(model, opt)
        del step, opt
        _release()
        fresh = LlamaForCausalLM(model.config, device=DEVICE,
                                 generator=pt_seed(seed + 77, DEVICE))
        fopt = AdamW(learning_rate=3e-4, parameters=fresh.parameters(),
                     weight_decay=0.1)
        t0 = time.perf_counter()
        ckpt.load_sharded_model(fresh, fopt, path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        fstep = pdist.ShardedTrainStep(fresh, loss_fn, fopt, graph=False)
        got_loss = float(fstep(ids, ids))
        got = _snapshot(fresh, fopt)
        same = got_loss == want_loss and all(
            torch.equal(got[k], want[k]) for k in want)
        steps = int(fopt._global_step)
        del fstep, fopt, fresh, got, want
    finally:
        shutil.rmtree(path, ignore_errors=True)
    _release()
    if not same or steps != 2:
        raise RuntimeError(f"checkpoint: the resumed step differs from the "
                           f"unbroken one (loss {got_loss} vs {want_loss}, "
                           f"step count {steps})")
    return {"bytes": nbytes, "save_s": save_s, "load_s": load_s,
            "save_gb_s": nbytes / save_s / 1e9,
            "load_gb_s": nbytes / load_s / 1e9,
            "resumed_bitwise_equal": True}


def phase_pipeline(seed):
    """The pipeline slice on one card: (a) the full-width pp 4 pipeline,
    (a') its fp32 twin with two planted faults, (b) the in-graph scaler,
    ``accum_steps`` and ``accumulate`` on the 1.16B step over a world-1
    NCCL group, (c) a checkpoint round trip. Returns ({path: counters})."""
    import tempfile

    import torch

    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.device import seed as pt_seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    t_phase = time.perf_counter()
    row, pipe_counts = _pipe_full_width(seed)
    row["fp32_twin"] = _pipe_twin(seed)
    store = torch.distributed.FileStore(
        os.path.join(tempfile.mkdtemp(prefix="chip_smoke_pp_"), "store"), 1)
    pdist.init_parallel_env(backend="nccl", store=store, rank=0,
                            world_size=1)
    pdist.init_mesh()
    cfg = LlamaConfig(**BIG, dtype="bfloat16", use_recompute=True)
    model = LlamaForCausalLM(cfg, device=DEVICE,
                             generator=pt_seed(seed + 61, DEVICE))
    state0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    ids = _ids(cfg.vocab_size, (4, 2048), seed + 61)
    row["scaler"], scaler_counts = _scaler_runs(model, state0, ids, seed)
    row["gradient_merge"], merge_counts = _merge_runs(model, state0, ids)
    row["checkpoint"] = _checkpoint_round_trip(model, state0, ids, seed)
    pdist.reset_mesh()
    torch.distributed.destroy_process_group()
    del model, state0
    _release()
    row["seconds"] = time.perf_counter() - t_phase
    _emit(row)
    return {"pipeline": pipe_counts, "pipeline-scaler": scaler_counts,
            "pipeline-accumulate": merge_counts}


# -- phase: the MoE Llama across ranks ----------------------------------------

MOE_MESH_STEPS = 3
MOE_MESH_TIMED = 3       # (a): replays timed after the check
MOE_MESH_LAYERS = 2      # (b): the flagship's widths, depth cut from 16
MOE_MESH_RANKS = 4       # (b): dp 2 x ep 2
# (b) the ranks' steps against the unsharded ones, fp32: each of the three
# losses within this relative difference, and after the first step each
# parameter's difference over its update ||p - ref|| / ||ref - init||
# within this limit (from the second step on, a token within rounding of
# a routing tie may route otherwise in the two runs, and an expert with few
# tokens moves by a share of its update: 0.039 after three steps on an H100
# 80GB HBM3 at 700 W, where the first step reads 4.8e-6 and the planted
# faults 0.22 and 0.91)
MOE_MESH_LOSS_RTOL = 1e-4
MOE_MESH_PARAM_TOL = 1e-2
# the optimizer kernels' split passes against their plain versions (fp32,
# tensors marked split over degree-1 axes of the world-1 group): as the
# optimizer-check holds the rules
SPLIT_RTOL = 1e-5


def _moe_mesh_world1(seed):
    """(a) The flagship MoE step (``bench.py:1864-1872``: 1.46B, bf16,
    recompute, Adafactor lr 1e-2, ``fused``) at batch 4 x 2048, graphed,
    ``jit.TrainStep`` and then ``ShardedTrainStep`` over the world-1 NCCL
    mesh from the same weights: after MOE_MESH_STEPS steps every loss,
    parameter and Adafactor state tensor bit for bit the same, and the
    sharded step's launches reckoned exactly; then MOE_MESH_TIMED more
    replays of each are timed. Returns its counters."""
    import torch

    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch import kernels, set_flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Adafactor

    set_flags({"FLAGS_moe_dispatch": "fused"})
    cfg, model = _moe_model("bfloat16", MOE["num_hidden_layers"], seed + 71)
    L = cfg.num_hidden_layers
    ids = _ids(cfg.vocab_size, MOE_BATCH, seed + 71)
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    per_step = _dense_launches(L)
    per_step.update({n: c * L for n, c in MOE_KERNELS.items()})
    per_step.update(adam_update=0, adafactor_stats=1, adafactor_update=1)
    pdist.init_mesh()  # every degree 1 over the world-1 NCCL group
    got, counts = {}, None

    def loss_fn(m, x, y):
        return m(x, labels=y)

    held = _nbytes(state0.values())
    for kind in ("train", "sharded"):
        model.load_state_dict(state0)
        opt = Adafactor(learning_rate=1e-2, parameters=model.parameters())
        step = pdist.ShardedTrainStep(model, loss_fn, opt) \
            if kind == "sharded" else TrainStep(model, loss_fn, opt)
        _release()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counters()
        losses, _ms = _timed(step, ids, MOE_MESH_STEPS)
        if kind == "sharded":
            counts = _reckoned(step)
        snap = _snapshot(model, opt)
        _l, ms = _timed(step, ids, MOE_MESH_TIMED)
        # the check's copies of the weights are left out of the peak
        got[kind] = (losses, snap, ms, (torch.cuda.max_memory_allocated()
                                        - held) / 2 ** 30)
        held += _nbytes(snap.values())
        del step, opt, snap
        _release()
    pdist.reset_mesh()
    (ref_l, ref_s, ref_ms, ref_gb), (losses, snap, ms, gb) = \
        got["train"], got["sharded"]
    differ = [k for k, v in ref_s.items() if not torch.equal(v, snap[k])]
    n = MOE_MESH_STEPS + 1  # the capture's launches count once, then replay
    wrong = {k: (c, per_step[k] * n) for k, c in counts.items()
             if c["plain_calls"] or c["launches"] != per_step[k] * n}
    moe_per_step = {k: counts[k]["launches"] / n for k in MOE_KERNELS}
    row = {"phase": "moe-mesh-world1", "card": _nvidia_smi(),
           "model": "llama-moe-1.46b", "layers": L, "dtype": "bfloat16",
           "recompute": True, "dispatch": "fused",
           "optimizer": "Adafactor lr 1e-2", "batch": list(MOE_BATCH),
           "world": 1, "backend": "nccl", "graph": True,
           "bitwise_equal": losses == ref_l and not differ,
           "tensors_differ": differ[:4], "losses": losses,
           "train_losses": ref_l, "step_ms_each": ms,
           "step_ms": min(ms), "train_step_ms_each": ref_ms,
           "train_step_ms": min(ref_ms), "tokens_per_s": MOE_BATCH[0] *
           MOE_BATCH[1] / min(ms) * 1e3, "peak_gb": gb,
           "train_peak_gb": ref_gb,
           "moe_launches_per_step": moe_per_step,
           "moe_reckoned_per_step": {k: per_step[k] for k in MOE_KERNELS},
           "launches_wrong": wrong}
    _emit(row)
    del got, ref_s, snap, model, state0
    _release()
    if not row["bitwise_equal"]:
        raise RuntimeError(f"moe-mesh: the world-1 sharded step differs from "
                           f"TrainStep {row}")
    if wrong:
        raise RuntimeError(f"moe-mesh: the sharded step's launches differ "
                           f"from the reckoned (reading, expected): {wrong}")
    return counts


def _split_calls(kopt, rule, rate, p, g, slots, split, plain=False):
    """{kernel: its call} of one update of ``rule`` over ``p`` with
    ``split`` marks (None: unsplit), through the kernels or their plain
    versions; each call is one wrapper call over the tensors as they
    stand. Adafactor's statistics run once here, and its update call
    reads them."""
    sfx = "_plain" if plain else ""
    b = kopt.StepBatch(p, g, slots, [True] * len(p), rate, 5, rule=rule)
    b.split = split
    if rule == "adafactor":
        stats = getattr(kopt, "adafactor_stats" + sfx)
        update = getattr(kopt, "adafactor_update" + sfx)
        kw = dict(decay_rate=0.8, epsilon1=1e-30, weight_decay=0.0,
                  pscale=True)
        st = stats(b, **kw)
        return {"adafactor_stats": lambda: stats(b, **kw),
                "adafactor_update": lambda: update(
                    b, st, beta1=0.0, epsilon2=1e-3, clip_threshold=1.0,
                    pscale=True, weight_decay=0.0)}
    fn = getattr(kopt, f"{rule}_update" + sfx)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-6, weight_decay=0.01) \
        if rule == "lamb" else dict(momentum=0.9, lars_coeff=0.001,
                                    weight_decay=5e-4, epsilon=0.0)
    return {f"{rule}_update": lambda: fn(b, **kw)}


def _split_rules(seed):
    """The optimizer kernels' split passes (Adafactor's statistics and
    update, Lamb, LARS over tensors that ``TensorSplits`` marks split)
    against their plain versions, fp32, and against the unsplit kernels:
    the marks are over degree-1 axes of the world-1 group, so every sum
    over ranks is the rank's own and the split step is the unsplit one.
    Tensors: an expert stack [8, 1536, 2048] split on its expert and
    intermediate dims, an embedding [32000, 1536] on its rows, a router
    [1536, 8] and a norm [1536] whole. Returns kernel rows."""
    import torch

    from paddle_tpu_torch import kernels

    kopt = _opt_module()
    world = torch.distributed.group.WORLD
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 73)
    shapes = [(8, 1536, 2048), (32000, 1536), (1536, 8), (1536,)]
    rows = []
    for rule, rate in (("adafactor", 1e-2), ("lamb", 1e-2), ("lars", 0.1)):
        p = [(torch.randn(s, generator=gen, device=DEVICE) * 0.02)
             for s in shapes]
        g = [(torch.randn(s, generator=gen, device=DEVICE) * 1e-3)
             for s in shapes]
        if rule == "adafactor":
            slots = [[(torch.rand(s[:-1] if len(s) > 1 else s, generator=gen,
                                  device=DEVICE) + 0.5) * 1e-7
                      for s in shapes],
                     [(torch.rand(s[:-2] + s[-1:], generator=gen,
                                  device=DEVICE) + 0.5) * 1e-7
                      if len(s) > 1 else None for s in shapes],
                     [None] * len(shapes)]
        else:
            slots = [[torch.randn(s, generator=gen, device=DEVICE) * 1e-4
                      for s in shapes],
                     [torch.randn(s, generator=gen, device=DEVICE).square()
                      * 1e-6 if rule == "lamb" else None for s in shapes],
                     [None] * len(shapes)]
        live = p + [t for sl in slots for t in sl if t is not None]
        init = [t.clone() for t in live]
        splits = kopt.TensorSplits([(world, 1, {id(p[0]): 0}),
                                    (world, 1, {id(p[0]): 2, id(p[1]): 0})])

        def update(split, plain=False):
            """One update from the initial tensors; what it wrote."""
            for t, t0 in zip(live, init):
                t.copy_(t0)
            fns = _split_calls(kopt, rule, rate, p, g, slots, split, plain)
            list(fns.values())[-1]()
            torch.cuda.synchronize()
            return [t.clone() for t in live]

        ref = update(splits, plain=True)
        kernels.reset_counters()
        got = update(splits)
        counts = kernels.counters()
        whole = update(None)
        agree = _opt_agreement(got, ref, init)
        same_unsplit = all(torch.equal(a, b) for a, b in zip(got, whole))
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        P, G = _opt_nbytes(p), _opt_nbytes(g)
        S = sum(_opt_nbytes(sl) for sl in slots)
        # the bytes each function must move: its reads and writes once
        nbytes = {"adafactor_stats": G + P + 2 * S,
                  "adafactor_update": G + 2 * P + S,
                  "lamb_update": P + G + S + P + S,
                  "lars_update": P + G + S + P + S}
        timed = [_split_calls(kopt, rule, rate, p, g, slots, sp, pl)
                 for sp, pl in ((splits, False), (splits, True),
                                (None, False))]
        for name in timed[0]:
            row = {"phase": "kernel", "kernel": name,
                   "case": f"split-{rule}-float32", "dtype": "float32",
                   "tensors": len(p),
                   "elements": sum(t.numel() for t in p),
                   "max_abs_err": err, "fp32_err": agree[2],
                   "rtol": SPLIT_RTOL, "equal_to_unsplit": same_unsplit,
                   "launches": counts[name]["launches"],
                   "kernel_ms": _time_ms(timed[0][name], iters=5, warmup=2),
                   "unsplit_ms": _time_ms(timed[2][name], iters=5,
                                          warmup=2),
                   "plain_ms": _time_ms(timed[1][name], iters=2, warmup=1)}
            row["bound_ms"], row["bound_by"] = _bound(nbytes[name], 0,
                                                      "float32")
            row["library_ms"] = None
            rows.append(row)
            _emit(row)
            if not (agree[2] <= SPLIT_RTOL and same_unsplit and
                    counts[name]["launches"] == 1 and
                    counts[name]["plain_calls"] == 0):
                raise RuntimeError(f"moe-mesh: the split {rule} kernels "
                                   f"differ from plain or unsplit {row}")
        del p, g, slots, live, init, ref, got, whole, timed
        _release()
    return rows


def _moe_mesh_ranks(seed):
    """(b, c) ``tools/moe_mesh_ranks.py`` as four processes on the one card
    (dp 2 x ep 2 over gloo in place of NCCL; the file's docstring says
    why): each holds its losses over three ``index`` steps of the fp32 MoE
    Llama at the flagship's widths and MOE_MESH_LAYERS layers, and its
    shards after the first, to the unsharded step's; each planted fault
    must exceed the limits.
    Every process is waited for or killed. Returns the ranks' summed
    counters."""
    import glob
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(here, "tools", "moe_mesh_ranks.py")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_moe_mesh_")
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w")
            for r in range(MOE_MESH_RANKS)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, script, "--rank", str(r), "--world",
         str(MOE_MESH_RANKS), "--store", os.path.join(tmp, "store"),
         "--out", tmp, "--layers", str(MOE_MESH_LAYERS), "--seed",
         str(seed)], stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(MOE_MESH_RANKS)]
    try:
        codes = [p.wait(timeout=420) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    seconds = time.perf_counter() - t0
    if any(codes):
        tails = {r: open(os.path.join(tmp, f"rank{r}.log")).read()[-1500:]
                 for r, c in enumerate(codes) if c}
        raise RuntimeError(f"moe-mesh: ranks exited {codes}: {tails}")
    outs = [json.load(open(f)) for f in
            sorted(glob.glob(os.path.join(tmp, "rank*.json")))]
    runs = {name: {"loss_rel": max(o["runs"][name]["loss_rel"] for o in outs),
                   "param_rel": max(o["runs"][name]["param_rel"]
                                    for o in outs),
                   "param_rel_where": max(
                       ((o["runs"][name]["param_rel"],
                         o["runs"][name]["param_rel_where"]) for o in outs),
                       key=lambda x: x[0])[1],
                   "param_rel_after_last": max(
                       o["runs"][name]["param_rel_after_last"]
                       for o in outs),
                   "same_init": all(o["runs"][name]["same_init"]
                                    for o in outs)}
            for name in outs[0]["runs"]}

    def within(r):
        return r["loss_rel"] <= MOE_MESH_LOSS_RTOL and \
            r["param_rel"] <= MOE_MESH_PARAM_TOL

    counts = {}
    for o in outs:
        for k, c in o["counters"].items():
            got = counts.setdefault(k, {"launches": 0, "plain_calls": 0})
            got["launches"] += c["launches"]
            got["plain_calls"] += c["plain_calls"]
    need = ("moe_gather", "moe_combine", "grouped_matmul",
            "grouped_matmul_dgrad", "grouped_matmul_wgrad",
            "adafactor_stats", "adafactor_update") + DENSE_TRAIN_KERNELS[:3]
    row = {"phase": "moe-mesh-ranks", "card": _nvidia_smi(),
           "degrees": {"dp": 2, "ep": 2}, "transport": "gloo (one card)",
           "widths": "flagship", "layers": MOE_MESH_LAYERS,
           "dtype": "float32", "dispatch": "index", "capacity_factor": 1.25,
           "optimizer": "Adafactor lr 1e-2", "batch": list(MOE_BATCH),
           "steps": MOE_MESH_STEPS, "ref_losses": outs[0]["ref_losses"],
           "losses": outs[0]["runs"]["sound"]["losses"],
           "expert_shard_shapes": outs[0]["runs"]["sound"]["shapes"],
           "loss_rtol": MOE_MESH_LOSS_RTOL, "param_tol": MOE_MESH_PARAM_TOL,
           "sound": runs["sound"],
           "faults": {k: {**v, "caught": not within(v)}
                      for k, v in runs.items() if k != "sound"},
           "launches": {k: counts.get(k, {}).get("launches", 0)
                        for k in need},
           "seconds": seconds}
    _emit(row)
    if not (within(runs["sound"]) and runs["sound"]["same_init"]):
        raise RuntimeError(f"moe-mesh: the dp 2 x ep 2 ranks differ from the "
                           f"unsharded index step {row}")
    if not all(f["caught"] for f in row["faults"].values()):
        raise RuntimeError(f"moe-mesh: the check missed a planted fault "
                           f"{row['faults']}")
    unused = [k for k in need if not counts.get(k, {}).get("launches")]
    plain = [k for k, c in counts.items() if c["plain_calls"]]
    core = [k for k in CUDA_CORE_FLASH
            if counts.get(k, {}).get("launches")]
    if unused or plain or core:
        raise RuntimeError(f"moe-mesh: the ranks' step did not launch "
                           f"{unused} (plain calls: {plain}; CUDA-core "
                           f"flash launched: {core})")
    return counts


def phase_moe_mesh(seed):
    """The MoE Llama across ranks on one card: (a) the world-1 NCCL mesh's
    sharded step on the flagship against ``TrainStep`` bit for bit, with
    its launches; the split optimizer passes against their plain versions;
    (b) the per-rank steps of dp 2 x ep 2 against the unsharded ``index``
    step; (c) the planted faults (a per-rank capacity, a per-rank aux).
    Returns ({path: counters}, kernel rows)."""
    import tempfile

    import torch

    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch import set_flags

    store = torch.distributed.FileStore(
        os.path.join(tempfile.mkdtemp(prefix="chip_smoke_nccl_"), "store"),
        1)
    pdist.init_parallel_env(backend="nccl", store=store, rank=0,
                            world_size=1)
    try:
        world1 = _moe_mesh_world1(seed)
        rows = _split_rules(seed)
    finally:
        set_flags({"FLAGS_moe_dispatch": "index"})
        _release()
        torch.distributed.destroy_process_group()
    ranks = _moe_mesh_ranks(seed)
    return {"moe-mesh": world1, "moe-mesh-ranks": ranks}, rows


# -- phase: optimizer offload through the streaming lane ------------------------

OFFLOAD_KNOBS = dict(segment_size=2 ** 28, buffer_max_size=2 ** 30)
OFFLOAD_CHECK_BATCH = (2, 2048)    # (a) fp32 "big"
OFFLOAD_BENCH_BATCH = (4, 2048)    # (b) bf16 "big"
OFFLOAD_CHECK_STEPS = 3
OFFLOAD_TIMED = 3
# Llama-2 13B (Touvron et al. 2023, Table 1; meta-llama/Llama-2-13b-hf)
LLAMA2_13B = dict(vocab_size=32000, hidden_size=5120, intermediate_size=13824,
                  num_hidden_layers=40, num_attention_heads=40,
                  num_key_value_heads=40, max_position_embeddings=4096,
                  rms_norm_eps=1e-5)
L13B_BATCH = (1, 4096)
L13B_STEPS = 3
# its depth: what the host holds, at most this many layers (PR 20 ran the
# 19 that fit; cut to 8 to make room for the DiT and ResNet phases, whose
# ~65 s the script's time limit must absorb, then to 4 for the build of
# the flash instances above head dim 128 and the llama-d256 step: the host
# pinning and the steps scale with the layers)
L13B_MAX_LAYERS = 4
HOST_SPARE = 12 * 2 ** 30  # host memory left free beside the offloaded state


def _mem_available() -> int:
    """The host's MemAvailable in bytes (``/proc/meminfo``)."""
    with open("/proc/meminfo") as f:
        for ln in f:
            if ln.startswith("MemAvailable:"):
                return int(ln.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def _offload_run(model, init, ids, *, offload, overlap=True, accumulate=0,
                 steps=OFFLOAD_CHECK_STEPS, timed=0, clip=1.0, fault=None):
    """``ShardedTrainStep`` (ZeRO os_g, graphed, AdamW lr 3e-4 / wd 0.1,
    a global-norm clip) from the weights ``init``, resident or offloaded
    (the lane overlapped or not; ``fault`` a group whose state download is
    skipped): (losses, parameters after ``steps``, step ms of ``timed``
    more, the step, its offloaded state)."""
    import torch

    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    os.environ["PT_OFFLOAD_OVERLAP"] = "1" if overlap else "0"
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(init[n])
    opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                weight_decay=0.1,
                grad_clip=None if clip is None else ClipGradByGlobalNorm(clip))
    _m, opt = pdist.group_sharded_parallel(model, opt, level="os_g",
                                           offload=offload, **OFFLOAD_KNOBS)
    step = pdist.ShardedTrainStep(model, lambda m, x, y: m(x, labels=y), opt)
    off = step._offloaded() if offload else None
    if fault is not None:
        down = off._down
        off._down = lambda gi: None if gi == fault else down(gi)
    run = step.accumulate(accumulate) if accumulate else step
    losses, ms = [], []
    for i in range(steps + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = run(ids, ids)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return losses[:steps], params, ms[steps:], step, off


def _offload_check(seed):
    """(a) fp32 "big" at 2 x 2048: three offloaded steps against the
    resident step bit for bit, the lane overlapped against serialized,
    the same under ``accumulate(2)``, and a planted fault (one group's
    state download skipped) that must differ."""
    import torch

    from paddle_tpu_torch.device import seed as pt_seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**BIG, dtype="float32", use_recompute=True)
    model = LlamaForCausalLM(cfg, device=DEVICE,
                             generator=pt_seed(seed + 81, DEVICE))
    ids = _ids(cfg.vocab_size, OFFLOAD_CHECK_BATCH, seed + 81)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    checks, groups, plain_ref = {}, None, None
    for acc in (0, 2):
        ref_l, ref_p, _ms, step, _o = _offload_run(model, init, ids,
                                                   offload=False,
                                                   accumulate=acc)
        if not acc:
            plain_ref = ref_p  # the planted fault's reference too
        del step, _o
        _release()
        for overlap in (True, False):
            losses, params, _ms, step, off = _offload_run(
                model, init, ids, offload=True, overlap=overlap,
                accumulate=acc)
            groups = len(off.groups)
            differ = [n for n in params if not torch.equal(params[n],
                                                           ref_p[n])]
            name = f"{'accumulate2-' if acc else ''}" \
                   f"{'overlapped' if overlap else 'serialized'}"
            checks[name] = {"losses": losses, "resident_losses": ref_l,
                            "bitwise_equal": losses == ref_l and not differ,
                            "tensors_differ": differ[:3]}
            off.close()
            del step, off, params
            _release()
        del ref_p
        _release()
    ref_p = plain_ref
    fault_group = 1
    losses, params, _ms, step, off = _offload_run(model, init, ids,
                                                  offload=True,
                                                  fault=fault_group)
    differ = [n for n in params if not torch.equal(params[n], ref_p[n])]
    caught = bool(differ)
    off.close()
    del step, off, params, ref_p, model, init
    _release()
    row = {"phase": "offload-check", "card": _nvidia_smi(),
           "model": "llama-1.16b", "dtype": "float32", "recompute": True,
           "batch": list(OFFLOAD_CHECK_BATCH), "zero": "os_g",
           "optimizer": "AdamW lr 3e-4 wd 0.1, ClipGradByGlobalNorm(1.0)",
           "graph": True, "knobs": OFFLOAD_KNOBS, "groups": groups,
           "checks": checks,
           "planted": {"state_download_skipped_group": fault_group,
                       "caught": caught, "tensors_differ": len(differ)}}
    _emit(row)
    bad = [k for k, v in checks.items() if not v["bitwise_equal"]]
    if bad or not caught:
        raise RuntimeError(f"offload-check: {bad} differ from the resident "
                           f"step, or the planted fault passed ({caught})")


def _offload_bench(seed):
    """(b) bf16 "big" at 4 x 2048: the resident step, then the offloaded
    one with the lane overlapped and serialized; step ms, peak device GiB,
    pinned host GiB and the lane's counters."""
    import torch

    from paddle_tpu_torch.device import seed as pt_seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**BIG, dtype="bfloat16", use_recompute=True)
    model = LlamaForCausalLM(cfg, device=DEVICE,
                             generator=pt_seed(seed + 83, DEVICE))
    ids = _ids(cfg.vocab_size, OFFLOAD_BENCH_BATCH, seed + 83)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    held = _nbytes(init.values())
    runs = {}
    for kind, offload, overlap in (("resident", False, True),
                                   ("offload-overlapped", True, True),
                                   ("offload-serialized", True, False)):
        _release()
        torch.cuda.reset_peak_memory_stats()
        losses, params, ms, step, off = _offload_run(
            model, init, ids, offload=offload, overlap=overlap, steps=2,
            timed=OFFLOAD_TIMED)
        run = {"losses": losses, "step_ms_each": ms, "step_ms": min(ms),
               "tokens_per_s": OFFLOAD_BENCH_BATCH[0] *
               OFFLOAD_BENCH_BATCH[1] / min(ms) * 1e3,
               "peak_device_gb": (torch.cuda.max_memory_allocated() - held)
               / 2 ** 30}
        if off is not None:
            off.lane.reset_stats()
            step(ids, ids)  # one step's lane counters
            torch.cuda.synchronize()
            run.update(pinned_host_gb=off.host.numel() * 4 / 2 ** 30,
                       groups=len(off.groups), lane=off.lane.stats())
            off.close()
        runs[kind] = run
        del step, off, params
    del model, init
    _release()
    row = {"phase": "offload-bench", "card": _nvidia_smi(),
           "model": "llama-1.16b", "dtype": "bfloat16", "recompute": True,
           "batch": list(OFFLOAD_BENCH_BATCH), "zero": "os_g", "graph": True,
           "knobs": OFFLOAD_KNOBS, "runs": runs}
    _emit(row)


def _offload_13b(seed):
    """(c) Llama-2 13B at full width, bf16, recompute, AdamW lr 3e-4 / wd
    0.1 under ClipGradByGlobalNorm(1.0), batch 1 x 4096, world-1
    ``ShardedTrainStep`` with the optimizer offloaded, three steps on one
    batch: a finite falling loss under 80 GiB on the card. The depth is
    cut where the host cannot hold the fp32 masters and moments (12 bytes
    a parameter) beside ``HOST_SPARE``. Returns its counters."""
    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.device import seed as pt_seed
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         llama_flops_per_token,
                                         llama_param_count)

    full = LlamaConfig(**LLAMA2_13B, dtype="bfloat16", use_recompute=True)
    one = LlamaConfig(**{**LLAMA2_13B, "num_hidden_layers": 1})
    per_layer = llama_param_count(one) - llama_param_count(
        LlamaConfig(**{**LLAMA2_13B, "num_hidden_layers": 0}))
    edge = llama_param_count(one) - per_layer
    avail = _mem_available()
    fit = int((avail - HOST_SPARE - 12 * edge) // (12 * per_layer))
    layers = max(1, min(full.num_hidden_layers, fit, L13B_MAX_LAYERS))
    cfg = LlamaConfig(**{**LLAMA2_13B, "num_hidden_layers": layers},
                      dtype="bfloat16", use_recompute=True)
    n_params = llama_param_count(cfg)
    _release()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=DEVICE,
                             generator=pt_seed(seed + 87, DEVICE))
    ids = _ids(cfg.vocab_size, L13B_BATCH, seed + 87)
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    os.environ["PT_OFFLOAD_OVERLAP"] = "1"
    opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                weight_decay=0.1, grad_clip=ClipGradByGlobalNorm(1.0))
    _m, opt = pdist.group_sharded_parallel(model, opt, level="os_g",
                                           offload=True, **OFFLOAD_KNOBS)
    step = pdist.ShardedTrainStep(model, lambda m, x, y: m(x, labels=y), opt)
    off = step._offloaded()
    setup_s = time.perf_counter() - t0
    kernels.reset_counters()
    losses, ms = [], []
    for _ in range(L13B_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = step(ids, ids)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(loss))
    counts = _reckoned(step)
    lane = off.lane.stats()
    off.lane.reset_stats()
    step(ids, ids)
    torch.cuda.synchronize()
    lane_step = off.lane.stats()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = L13B_BATCH[0] * L13B_BATCH[1]
    best = min(ms[1:]) if len(ms) > 1 else ms[0]
    flops = llama_flops_per_token(cfg, L13B_BATCH[1]) * tokens
    groups = len(off.groups)
    adam = counts["adam_update"]["launches"]
    resident = 8 * n_params  # bf16 params, grads and both moments
    row = {"phase": "offload-13b", "card": _nvidia_smi(),
           "model": "llama2-13b", "source": "Touvron et al. 2023 Table 1",
           "widths": LLAMA2_13B, "layers": layers,
           "layers_cut": None if layers == full.num_hidden_layers else
           f"{full.num_hidden_layers} -> {layers}",
           "host_mem_available_gb": avail / 2 ** 30,
           "params": n_params, "dtype": "bfloat16", "recompute": True,
           "batch": list(L13B_BATCH), "graph": True,
           "optimizer": "AdamW lr 3e-4 wd 0.1, ClipGradByGlobalNorm(1.0)",
           "losses": losses, "step_ms_each": ms, "step_ms": best,
           "tokens_per_s": tokens / best * 1e3,
           "mfu": flops / (best / 1e3) / PEAK_FLOPS["bfloat16"],
           "peak_device_gb": peak,
           "pinned_host_gb": off.host.numel() * 4 / 2 ** 30,
           "groups": groups, "knobs": OFFLOAD_KNOBS, "setup_s": setup_s,
           "lane_three_steps": lane, "lane_one_step": lane_step,
           "adam_update_calls": adam,
           "resident_bytes_reckoned_gb": resident / 2 ** 30,
           "resident_bytes_full_depth_gb":
               8 * llama_param_count(full) / 2 ** 30}
    _emit(row)
    off.close()
    del step, off, opt, model
    _release()
    finite = all(l == l and abs(l) != float("inf") for l in losses)
    if not finite or not losses[-1] < losses[0] or peak >= 80.0:
        raise RuntimeError(f"offload-13b: losses {losses} (finite, falling) "
                           f"and peak {peak:.2f} GiB (< 80)")
    # the walk: one adam_update a group a step, one clip sum a step
    want = L13B_STEPS * groups
    if adam != want or counts["multi_tensor_sumsq"]["launches"] != \
            L13B_STEPS:
        raise RuntimeError(f"offload-13b: adam_update {adam} calls (want "
                           f"{want}), multi_tensor_sumsq "
                           f"{counts['multi_tensor_sumsq']['launches']}")
    return counts


def phase_offload(seed):
    """Optimizer offload on one card over a world-1 NCCL group: (a) the
    fp32 check, (b) the bf16 "big" figures, (c) Llama-2 13B. Returns
    ({path: counters}, kernel rows)."""
    import tempfile

    import torch

    from paddle_tpu_torch import distributed as pdist

    store = torch.distributed.FileStore(
        os.path.join(tempfile.mkdtemp(prefix="chip_smoke_offload_"),
                     "store"), 1)
    pdist.init_parallel_env(backend="nccl", store=store, rank=0,
                            world_size=1)
    pdist.init_mesh()
    prior = os.environ.get("PT_OFFLOAD_OVERLAP")
    host = {"start": _mem_available() / 2 ** 30}
    try:
        _offload_check(seed)
        host["after_check"] = _mem_available() / 2 ** 30
        _offload_bench(seed)
        host["after_bench"] = _mem_available() / 2 ** 30
        counts = _offload_13b(seed)
        host["after_13b"] = _mem_available() / 2 ** 30
        _emit({"phase": "offload-host-memory", "mem_available_gib": host})
    finally:
        if prior is None:
            os.environ.pop("PT_OFFLOAD_OVERLAP", None)
        else:
            os.environ["PT_OFFLOAD_OVERLAP"] = prior
        pdist.reset_mesh()
        torch.distributed.destroy_process_group()
    return {"offload-13b": counts}


# -- phase: BERT-base finetuned on the paddle surface --------------------------

BERT_BATCH = (32, 128)   # the finetune recipe's batch x sequence
BERT_DATA = 2048         # surrogate sentences the steps walk through
BERT_SEED = 23
BERT_LR = 2e-5
BERT_CHECK_STEPS = 3     # (a): graphed against eager, bit for bit
BERT_STEPS = 30          # (b): graphed steps timed, per dtype
BERT_GRAD_TOL = PARITY_GRAD_TOL   # (d): fp32, ||g - ref|| / ||ref||
BERT_LOSS_RTOL = PARITY_LOSS_RTOL


def _bert_surrogate(n, seq, vocab, seed, k=8):
    """Sentences whose label is decided by which marker token dominates
    (the rule of ``examples/finetune_bert.py:26-34``)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    ids = rng.randint(min(1000, vocab // 2), vocab, (n, seq))
    labels = rng.randint(0, 2, (n,))
    for i, lab in enumerate(labels):
        pos = rng.choice(seq, k, replace=False)
        ids[i, pos] = 10 + lab
    return ids.astype("int64"), labels.astype("int64")


def _bert_model(dtype, seed):
    """BERT-base (``BertConfig()``: L 12, H 768, A 12, FFN 3072, vocab
    30522, 512 positions, dropout 0.1) with a 2-class head, its weights
    drawn on the card from ``seed`` by the paddle initializers."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.models import (BertConfig,
                                         BertForSequenceClassification)

    P.seed(seed)
    cfg = BertConfig(dtype=dtype)
    return cfg, BertForSequenceClassification(cfg, num_classes=2)


def _bert_step(model, graph):
    """The finetune recipe's step: AdamW 2e-5, ClipGradByGlobalNorm(1.0),
    CrossEntropyLoss, through ``jit.TrainStep``."""
    import paddle_tpu_torch.nn as pnn
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    loss_fn = pnn.CrossEntropyLoss()
    opt = AdamW(learning_rate=BERT_LR, parameters=model.parameters(),
                grad_clip=pnn.ClipGradByGlobalNorm(1.0))
    return TrainStep(model, lambda m, x, y: loss_fn(m(x), y), opt,
                     graph=graph)


def _bert_batches(data, n):
    ids, labels = data
    b = BERT_BATCH[0]
    for i in range(n):
        j = (i * b) % (ids.shape[0] - b)
        yield ids[j:j + b], labels[j:j + b]


def _bert_run(step, data, n):
    """(losses, host ms of each call ending in a synchronise)."""
    losses, ms = [], []
    for x, y in _bert_batches(data, n):
        t0 = time.perf_counter()
        losses.append(float(step(x, y)))
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def _bert_launches():
    """{counter: launches a training step}: AdamW's one update and the
    clip's one sum of squares. Training runs attention dropout 0.1, so
    attention is the JAX ``_sdpa_xla`` composition (no flash launch), as
    in the JAX package; every other counter reads 0."""
    from paddle_tpu_torch import kernels

    per_step = {n: 0 for n in kernels.counters()}
    per_step.update({"adam_update": 1, "multi_tensor_sumsq": 1})
    return per_step


def _bert_flops(cfg):
    """Model FLOPs a token, forward and backward: 6 N (N the 85.6M weights
    outside the embedding tables) + 12 L h s (attention's products)."""
    from paddle_tpu_torch.models import bert_param_count

    return 6 * bert_param_count(cfg)[1] + \
        12 * cfg.num_hidden_layers * cfg.hidden_size * BERT_BATCH[1]


def _add_counts(total, counts):
    for n, c in counts.items():
        t = total.setdefault(n, {"launches": 0, "plain_calls": 0})
        t["launches"] += c["launches"]
        t["plain_calls"] += c["plain_calls"]
    return total


def _bert_graph_check(data, state0, seed):
    """(a) fp32: the graphed step against ``graph=False`` for 3 steps from
    the same weights and default-generator state (dropout 0.1 draws from
    it), losses, parameters and AdamW state bit for bit; launches exact.

    torch's CUDA embedding backward sums the rows of repeated ids with
    atomics, so two eager runs differ in their last bits (the word and
    token-type tables; PR 20's first card run read 7.5e-5 of an update
    after 3 steps). The check therefore runs both under
    ``FLAGS_cudnn_deterministic`` (torch's strict deterministic mode: its
    sorted embedding backward), which makes it a comparison of the graph
    with eager; the eager-against-eager reading without it is reported
    beside."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import kernels

    _cfg, model = _bert_model("float32", seed)
    per_step = _bert_launches()

    def run(graph):
        model.load_state_dict(state0)
        P.seed(seed + 1)
        step = _bert_step(model, graph=graph)
        kernels.reset_counters()
        losses, _ = _bert_run(step, data, BERT_CHECK_STEPS)
        counts = _reckoned(step)
        snap = _snapshot(model, step.optimizer)
        del step
        _release()
        return losses, counts, snap

    # eager twice with torch's default (atomic) embedding backward
    _l, _c, ref0 = run(False)
    _l, _c, again = run(False)
    eager_same, eager_worst, _w = _agreement(again, ref0, state0)
    del ref0, again
    P.set_flags({"FLAGS_cudnn_deterministic": True})
    try:
        elosses, ecounts, ref = run(False)
        glosses, gcounts, got = run(True)
    finally:
        P.set_flags({"FLAGS_cudnn_deterministic": False})
    _exact("bert-graph-check-eager", ecounts, per_step, BERT_CHECK_STEPS)
    _exact("bert-graph-check-graph", gcounts, per_step,
           BERT_CHECK_STEPS + 1)
    same, worst, where = _agreement(got, ref, state0)
    row = {"phase": "bert-graph-check", "dtype": "float32",
           "steps": BERT_CHECK_STEPS, "eager_losses": elosses,
           "graph_losses": glosses, "flags_cudnn_deterministic": True,
           "bitwise": same and glosses == elosses, "max_rel_diff": worst,
           "max_rel_where": where,
           "eager_twice_bitwise_without_it": eager_same,
           "eager_twice_max_rel_diff_without_it": eager_worst}
    del got, ref, model
    _release()
    _emit(row)
    if not row["bitwise"]:
        raise RuntimeError(f"bert-graph-check: graph differs from eager "
                           f"{row}")
    return _add_counts(ecounts, gcounts)


def _bert_steps(dtype, data, seed):
    """(b) BERT_STEPS graphed steps: step ms, tokens/s, device ms and idle
    share of a profiled step, peak GiB, losses, MFU against ``dtype``'s
    peak; launches exact. Returns (counters, figures, model)."""
    import math

    import torch

    from paddle_tpu_torch import kernels

    cfg, model = _bert_model(dtype, seed)
    per_step = _bert_launches()
    _release()
    torch.cuda.reset_peak_memory_stats()
    step = _bert_step(model, graph=True)
    kernels.reset_counters()
    losses, ms = _bert_run(step, data, BERT_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = _reckoned(step)
    _exact(f"bert-steps-{dtype}", counts, per_step, BERT_STEPS + 1)
    x, y = next(_bert_batches(data, 1))
    prof = _step_profile(lambda: step(x, y))
    flops = _bert_flops(cfg)
    step_ms = sum(ms[2:]) / len(ms[2:])
    tok_s = BERT_BATCH[0] * BERT_BATCH[1] / step_ms * 1e3
    figures = {"dtype": dtype, "steps": BERT_STEPS,
               "step_ms": step_ms, "step_ms_each": ms,
               "tokens_per_s": tok_s, "flops_per_token": flops,
               "mfu": flops * tok_s / PEAK_FLOPS[dtype],
               "mfu_peak_tflops": PEAK_FLOPS[dtype] / 1e12,
               "device_ms": prof["device_ms"], "events_ms": prof["events_ms"],
               "idle_share": prof["idle_share"],
               "groups_ms": prof["groups_ms"], "top": prof["top"],
               "peak_mem_gb": peak, "loss_first": losses[0],
               "loss_last": losses[-1], "losses": losses,
               "captures": step.captures, "replays": step.replays}
    del step
    _release()
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"bert-steps-{dtype}: a loss is not finite "
                           f"{losses}")
    return counts, figures, model


def _bert_eval_check(model, dtype, data):
    """(c) ``eval()`` without a mask on the first batch: the flash forward
    launched exactly 12 times (``flash_fwd_tf32x3.cu`` in fp32,
    ``flash_fwd_sm90.cu`` in bf16), every call held against the plain
    version on fp32 copies of its inputs at the kernel's tolerance (fp32
    1e-4; bf16 ``sm90_fwd_bound``), and the logits against the forward
    through the plain versions: fp32 within 1e-4; bf16 within 2^-8 |ref|
    + L 2^-8 (|W| |pooled|) + 1e-4, the bound of the classifier's product
    whose input carries one bf16 rounding from each of the L layers'
    attention. Then a padded batch with ``attention_mask`` runs the
    composition: no flash launch, finite logits."""
    import torch

    from paddle_tpu_torch import kernels

    fa = _flash_module()
    x, _y = next(_bert_batches(data, 1))
    L = model.bert.config.num_hidden_layers
    want = "flash_attention_sm90" if dtype == "bfloat16" else \
        "flash_attention_tf32x3"
    calls = []
    real = fa.flash_attention_fwd

    def recorder(q, k, v, offset, causal, scale):
        o, lse = real(q, k, v, offset, causal, scale)
        calls.append((q, k, v, offset, causal, scale, o))
        return o, lse

    pooled = {}
    hook = model.classifier.register_forward_hook(
        lambda m, i, o: pooled.__setitem__("x", i[0]))
    model.eval()
    kernels.reset_counters()
    with torch.no_grad(), _swapped([(fa, "flash_attention_fwd", recorder)]):
        logits = model(x)
    torch.cuda.synchronize()
    counts = kernels.counters()
    wrong = {n: c for n, c in counts.items() if c["plain_calls"] or
             c["launches"] != (L if n == want else 0)}
    if wrong:
        raise RuntimeError(f"bert-eval-{dtype}: launches differ from {L} on "
                           f"{want}: {wrong}")
    errs, shares = [], []
    for q, k, v, off, causal, scale, o in calls:
        f32 = [t.float() for t in (q, k, v)]
        ref, _ = fa.flash_attention_plain(*f32, off, causal, scale)
        if dtype == "bfloat16":
            e, s = _compare_bound(f"bert-eval-{dtype} flash", o, ref,
                                  fa.sm90_fwd_bound(*f32, off, causal,
                                                    scale, ref))
            shares.append(s)
        else:
            e, _ = _compare(f"bert-eval-{dtype} flash", o, ref,
                            _tol(torch.float32))
        errs.append(e)
    shape = list(calls[0][0].shape)
    del calls
    with torch.no_grad(), _swapped(_plain_swaps()):
        ref_logits = model(x)
        pooled_ref = pooled["x"]
    hook.remove()
    ref32 = ref_logits.float()
    if dtype == "bfloat16":
        w = model.classifier.weight.float()
        bound = 2.0 ** -8 * ref32.abs() + L * 2.0 ** -8 * (
            pooled_ref.float().abs() @ w.abs()) + 1e-4
        logit_err, logit_share = _compare_bound(
            f"bert-eval-{dtype} logits", logits, ref32, bound)
    else:
        logit_err, _ = _compare(f"bert-eval-{dtype} logits", logits, ref32,
                                _tol(torch.float32))
        logit_share = None
    # a padded batch: attention_mask runs the composition
    mask = torch.ones_like(x)
    mask[::2, BERT_BATCH[1] // 2:] = 0
    kernels.reset_counters()
    with torch.no_grad():
        padded = model(x, attention_mask=mask)
    pcounts = kernels.counters()
    padded_ok = bool(torch.isfinite(padded.float()).all()) and all(
        c["launches"] == 0 and c["plain_calls"] == 0
        for c in pcounts.values()) and tuple(padded.shape) == (
        BERT_BATCH[0], 2)
    row = {"phase": f"bert-eval-{dtype}", "kernel": want,
           "launches_per_forward": counts[want]["launches"],
           "call_shape_bhsd": shape, "flash_max_abs_err": max(errs),
           "flash_bound_share_max": max(shares) if shares else None,
           "logits_max_abs_err": logit_err,
           "logits_bound_share_max": logit_share,
           "masked_composition_ok": padded_ok}
    _emit(row)
    if not padded_ok:
        raise RuntimeError(f"bert-eval-{dtype}: the masked forward {row}")
    model.train()
    return counts, max(errs)


def _bert_grad_check(seed, state0, data):
    """(d) fp32 with both dropouts at 0 and no mask, so the flash forward
    and both backward kernels run (12 launches each: the 3xTF32 forward,
    dK/dV and dQ): one step's loss and
    every gradient against the same step through the plain versions, and
    a planted fault (dQ without the softmax scale) that the check must
    catch."""
    import torch

    import paddle_tpu_torch.nn as pnn
    from paddle_tpu_torch import kernels

    _cfg, model = _bert_model("float32", seed)
    model.load_state_dict(state0)
    for m in model.modules():
        if isinstance(m, pnn.Dropout):
            m.p = 0.0
        if hasattr(m, "attn_dropout_p"):
            m.attn_dropout_p = 0.0
    x, y = next(_bert_batches(data, 1))
    loss_fn = pnn.CrossEntropyLoss()

    def loss_and_grads():
        model.train()
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model(x), y)
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return float(loss.detach()), grads

    with _swapped(_plain_swaps()):
        loss_p, grads_p = loss_and_grads()
    kernels.reset_counters()
    loss_k, grads_k = loss_and_grads()
    counts = kernels.counters()
    L = model.bert.config.num_hidden_layers
    want = {"flash_attention_tf32x3": L, "flash_attention_bwd_dkv_tf32x3": L,
            "flash_attention_bwd_dq_tf32x3": L}
    wrong = {n: c for n, c in counts.items() if c["plain_calls"] or
             c["launches"] != want.get(n, 0)}
    if wrong:
        raise RuntimeError(f"bert-grad-check: launches {wrong}")
    errs = _grad_errors(grads_k, grads_p)
    del grads_k
    with _swapped(_faulty("dq_unscaled")):
        _l, grads_f = loss_and_grads()
    fault = max(_grad_errors(grads_f, grads_p).values())
    del grads_f, grads_p, model
    _release()
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    row = {"phase": "bert-grad-check", "dtype": "float32",
           "batch": list(BERT_BATCH), "loss_kernels": loss_k,
           "loss_plain": loss_p, "loss_rel_err": loss_rel,
           "loss_rtol": BERT_LOSS_RTOL, "grad_rel_l2_max": max(errs.values()),
           "grad_worst": _worst(errs), "grad_tol": BERT_GRAD_TOL,
           "params_checked": len(errs),
           "fault_dq_unscaled_grad_rel_l2": fault,
           "fault_caught": fault > BERT_GRAD_TOL,
           "launches": {n: counts[n]["launches"] for n in want}}
    _emit(row)
    if not (loss_rel <= BERT_LOSS_RTOL and
            max(errs.values()) <= BERT_GRAD_TOL and row["fault_caught"]):
        raise RuntimeError(f"bert-grad-check: {row}")
    return counts


def phase_bert_finetune(seed):
    """BERT-base finetuned through the paddle surface (``models/bert.py``
    on ``nn.Layer``, the op functions, ``F.cross_entropy``): (a) graph =
    eager bit for bit, (b) graphed steps in fp32 and bf16 with their
    figures, (c) the eval forward's flash launches and agreement, (d) the
    fp32 gradient check with dropout 0; then the flash forward's kernel
    rows at BERT's attention shape (fp32 and bf16) and the fp32 backward's.
    Returns ({path: counters}, rows)."""
    import torch

    import paddle_tpu_torch as P
    from paddle_tpu_torch.models import bert_param_count

    t0 = time.perf_counter()
    prior = P.get_device()
    P.set_device("gpu")
    try:
        _release()
        ids, labels = _bert_surrogate(BERT_DATA, BERT_BATCH[1], 30522,
                                      seed + BERT_SEED)
        data = (torch.from_numpy(ids).to(DEVICE),
                torch.from_numpy(labels).to(DEVICE))
        s = seed + BERT_SEED
        cfg, model = _bert_model("float32", s)
        state0 = {k: v.detach().clone()
                  for k, v in model.state_dict().items()}
        del model
        total = _bert_graph_check(data, state0, s)
        figures, evals = {}, {}
        for dtype in ("float32", "bfloat16"):
            counts, figures[dtype], model = _bert_steps(dtype, data, s)
            _add_counts(total, counts)
            ecounts, evals[dtype] = _bert_eval_check(model, dtype, data)
            _add_counts(total, ecounts)
            del model
            _release()
        _add_counts(total, _bert_grad_check(s, state0, data))
        del state0
        _release()
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(seed + BERT_SEED)
        b, sq = BERT_BATCH
        bh = b * cfg.num_attention_heads
        d = cfg.hidden_size // cfg.num_attention_heads
        rows = [_flash_case(f"bert-{dt}", getattr(torch, dt), bh, sq, sq,
                            False, gen, d=d)
                for dt in ("float32", "bfloat16")]
        # the fp32 backward at BERT's shape: the 3xTF32 dK/dV and dQ (the
        # gradient check's kernels)
        rows += _flash_bwd_case("bert-float32", torch.float32, bh, sq, sq, 0,
                                False, gen, d=d)
        total_p, body_p = bert_param_count(cfg)
        _emit({"phase": "bert-finetune", "ok": True, "model": "bert-base",
               "card": _nvidia_smi(), "params": total_p,
               "params_outside_embeddings": body_p,
               "layers": cfg.num_hidden_layers, "hidden": cfg.hidden_size,
               "heads": cfg.num_attention_heads, "batch": list(BERT_BATCH),
               "recipe": "AdamW 2e-5, ClipGradByGlobalNorm(1.0), "
                         "CrossEntropyLoss, dropout 0.1/0.1",
               "peak_tflops": {k: v / 1e12 for k, v in PEAK_FLOPS.items()},
               "steps": figures,
               "eval_flash_max_abs_err": evals,
               "seconds": time.perf_counter() - t0})
    finally:
        P.set_device(prior)
    return {"bert-finetune": total}, rows


# -- DiT-XL/2 training and DDIM sampling ---------------------------------------

DIT_BATCH = 32            # cut from the paper's 256, as bench.py:2056's row
DIT_SEED = 31
DIT_LR = 1e-4             # bench.py:532-533: AdamW 1e-4, weight decay 0
DIT_CHECK_STEPS = 2       # graph = eager under FLAGS_cudnn_deterministic
DIT_GRAPH_STEPS = 8       # graphed calls timed (warm-up, capture, replays)
DIT_EAGER_STEPS = 3
DIT_SAMPLE_BATCH = 8
DIT_SAMPLE_STEPS = 50
DIT_GRAD_LAYERS = 2       # dit-grad-check: XL/2's widths, depth cut from 28
DIT_GRAD_BATCH = 8
DIT_GRAD_TOL = PARITY_GRAD_TOL    # fp32, ||g - ref|| / ||ref||
DIT_LOSS_RTOL = PARITY_LOSS_RTOL
# dit-sample: the first DDIM step's eps through the kernels against the
# plain versions, ||eps - ref|| / ||ref||: both fp32, differing by the
# attention's summation order through 28 layers
DIT_EPS_TOL = 1e-4


def _dit_model(cfg, seed):
    """``DiT(cfg)`` on the card from ``seed``, its adaLN-Zero parameters
    (each block's ``ada``, ``final_ada``, ``final_proj``: zeros in the
    recipe, so a fresh DiT outputs exactly 0 and its attention receives no
    gradient) overwritten with N(0, 0.02) draws from the seed."""
    import torch

    import paddle_tpu_torch as P
    from paddle_tpu_torch.models import DiT

    P.seed(seed)
    model = DiT(cfg)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 1)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.split(".")[-2] in ("ada", "final_ada", "final_proj"):
                p.copy_(0.02 * torch.randn(p.shape, generator=gen,
                                           device=DEVICE))
    return model


def _dit_data(cfg, batch, seed):
    """fp32 latents [batch, 4, 32, 32] and class labels from ``seed`` (the
    bench's inputs: ``paddle.randn`` and ``randint``)."""
    import torch

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    x = torch.randn(batch, cfg.in_channels, cfg.input_size, cfg.input_size,
                    generator=gen, device=DEVICE)
    y = torch.randint(0, cfg.num_classes, (batch,), generator=gen,
                      device=DEVICE)
    return x, y


def _dit_step(model, diffusion, graph):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(learning_rate=DIT_LR, parameters=model.parameters(),
                weight_decay=0.0)
    return TrainStep(model, lambda m, x, y: diffusion.training_loss(m, x, y),
                     opt, graph=graph)


def _dit_launches(L, train=True):
    """{counter: launches a step}: every attention call is fp32 at head
    dim 72 (the inputs and the timestep embedding are fp32, so the
    products promote), so L forwards, L dK/dV and L dQ on the 3xTF32
    kernels, none on the CUDA-core flash kernels, and AdamW's one update;
    every other counter 0. A forward alone (``train=False``): L."""
    from paddle_tpu_torch import kernels

    per = {n: 0 for n in kernels.counters()}
    per["flash_attention_tf32x3"] = L
    if train:
        per.update(flash_attention_bwd_dkv_tf32x3=L,
                   flash_attention_bwd_dq_tf32x3=L, adam_update=1)
    return per


def _dit_group(name):
    """DiT's device ms by group: the fp32 GEMMs, the flash kernels, AdamW
    and the elementwise passes (LayerNorm, GELU, the modulation, casts)."""
    g = _train_group(name)
    if g.startswith("flash"):
        return "flash"
    return {"gemm": "sgemm", "optimizer": "adamw"}.get(g, "elementwise")


def _dit_graph_check(cfg, state0, x, y, seed):
    """Graph = eager: DIT_CHECK_STEPS steps eager and graphed (warm-up,
    then the capture and its replay) from the same weights and default
    generator state, both under ``FLAGS_cudnn_deterministic``: losses,
    parameters and AdamW state bit for bit, launches exact; then one more
    replay on the same batch must draw fresh t, noise and label drops (its
    loss differs)."""
    import torch

    import paddle_tpu_torch as P
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import GaussianDiffusion

    model = _dit_model(cfg, seed)
    diffusion = GaussianDiffusion()
    per_step = _dit_launches(cfg.num_hidden_layers)

    def run(graph):
        model.load_state_dict(state0)
        torch.cuda.manual_seed(seed + 2)
        step = _dit_step(model, diffusion, graph)
        kernels.reset_counters()
        losses = [float(step(x, y)) for _ in range(DIT_CHECK_STEPS)]
        counts = _reckoned(step)
        snap = _snapshot(model, step.optimizer)
        fresh = float(step(x, y)) if graph else None
        del step
        _release()
        return losses, counts, snap, fresh

    P.set_flags({"FLAGS_cudnn_deterministic": True})
    try:
        elosses, ecounts, ref, _ = run(False)
        glosses, gcounts, got, fresh = run(True)
    finally:
        P.set_flags({"FLAGS_cudnn_deterministic": False})
    _exact("dit-graph-check-eager", ecounts, per_step, DIT_CHECK_STEPS)
    same, worst, where = _agreement(got, ref, state0)
    row = {"phase": "dit-graph-check", "steps": DIT_CHECK_STEPS,
           "eager_losses": elosses, "graph_losses": glosses,
           "flags_cudnn_deterministic": True,
           "bitwise": same and glosses == elosses, "max_rel_diff": worst,
           "max_rel_where": where, "replay_on_same_batch_loss": fresh,
           "fresh_draws": fresh != glosses[-1]}
    del got, ref, model
    _release()
    _emit(row)
    if not (row["bitwise"] and row["fresh_draws"]):
        raise RuntimeError(f"dit-graph-check: {row}")
    # the graph's reckoned launches: the warm-up step, the capture (the
    # wrappers run once while it records) and the replays
    _exact("dit-graph-check-graph", gcounts, per_step, DIT_CHECK_STEPS + 1)
    return _add_counts(ecounts, gcounts)


def _dit_train(cfg, state0, x, y, seed):
    """The main path: DIT_GRAPH_STEPS graphed calls, then DIT_EAGER_STEPS
    eager steps on the same optimizer, each with its launches exact; step
    ms, images/s, MFU by bench.py's FLOPs, peak GiB, device ms by group
    and idle share of a profiled replay and of a profiled eager step."""
    import math

    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GaussianDiffusion, dit_flops_per_image

    model = _dit_model(cfg, seed)
    model.load_state_dict(state0)
    diffusion = GaussianDiffusion()
    per_step = _dit_launches(cfg.num_hidden_layers)
    flops = dit_flops_per_image(cfg)
    _release()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.manual_seed(seed + 3)
    gstep = _dit_step(model, diffusion, graph=True)
    kernels.reset_counters()
    losses, ms = [], []
    for _ in range(DIT_GRAPH_STEPS):
        t0 = time.perf_counter()
        losses.append(float(gstep(x, y)))
        ms.append((time.perf_counter() - t0) * 1e3)
    gcounts = _reckoned(gstep)  # the capture's wrapper calls count once
    _exact("dit-train-graph", gcounts, per_step, DIT_GRAPH_STEPS + 1)
    gpeak = torch.cuda.max_memory_allocated() / 2 ** 30
    gprof = _step_profile(lambda: gstep(x, y), _dit_group)
    losses.append(float(gstep(x, y)))
    estep = TrainStep(model, gstep.loss_fn, gstep.optimizer, graph=False)
    del gstep
    _release()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    ems = []
    for _ in range(DIT_EAGER_STEPS):
        t0 = time.perf_counter()
        losses.append(float(estep(x, y)))
        ems.append((time.perf_counter() - t0) * 1e3)
    ecounts = kernels.counters()
    _exact("dit-train-eager", ecounts, per_step, DIT_EAGER_STEPS)
    epeak = torch.cuda.max_memory_allocated() / 2 ** 30
    eprof = _step_profile(lambda: estep(x, y), _dit_group)
    del estep, model
    _release()

    def figures(step_ms, peak, prof):
        ips = DIT_BATCH / step_ms * 1e3
        return {"step_ms": step_ms, "images_per_s": ips,
                "mfu": ips * flops / PEAK_FLOPS["bfloat16"],
                "mfu_fp32_peak": ips * flops / PEAK_FLOPS["float32"],
                "peak_mem_gb": peak, "device_ms": prof["device_ms"],
                "events_ms": prof["events_ms"],
                "idle_share": prof["idle_share"],
                "groups_ms": prof["groups_ms"], "top": prof["top"]}

    graph_ms = ms[2:]
    row = {"phase": "dit-train", "model": "DiT-XL/2",
           "card": _nvidia_smi(), "batch": DIT_BATCH,
           "latent": [cfg.in_channels, cfg.input_size, cfg.input_size],
           "layers": cfg.num_hidden_layers, "hidden": cfg.hidden_size,
           "heads": cfg.num_attention_heads, "dtype": cfg.dtype,
           "flops_per_image": flops, "losses": losses,
           "graph": figures(sum(graph_ms) / len(graph_ms), gpeak, gprof),
           "graph_step_ms_each": ms,
           "eager": figures(sum(ems[1:]) / len(ems[1:]), epeak, eprof),
           "eager_step_ms_each": ems,
           "launches_per_step": {n: c for n, c in per_step.items() if c}}
    _emit(row)
    tail = losses[-3:]
    if not all(math.isfinite(v) for v in losses) or \
            not sum(tail) / len(tail) < losses[0]:
        raise RuntimeError(f"dit-train: loss not finite and falling "
                           f"{losses}")
    return _add_counts(gcounts, ecounts), row


def _dit_sample(cfg, state0, seed):
    """``ddim_sample`` on DiT-XL/2, DIT_SAMPLE_STEPS steps at eta 0, batch
    DIT_SAMPLE_BATCH: images/s, exactly steps x L flash forward launches
    on the 3xTF32 kernel and nothing else, two runs of one seed equal
    bit for bit; then the first step's eps through the kernels against the
    same forward through the plain versions."""
    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import GaussianDiffusion

    model = _dit_model(cfg, seed)
    model.load_state_dict(state0)
    diffusion = GaussianDiffusion()
    L = cfg.num_hidden_layers
    shape = (DIT_SAMPLE_BATCH, cfg.in_channels, cfg.input_size,
             cfg.input_size)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 4)
    y = torch.randint(0, cfg.num_classes, (DIT_SAMPLE_BATCH,), generator=gen,
                      device=DEVICE)
    kernels.reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a = diffusion.ddim_sample(model, shape, y, steps=DIT_SAMPLE_STEPS,
                              eta=0.0, seed=seed)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = kernels.counters()
    per = _dit_launches(L, train=False)
    _exact("dit-sample", counts, per, DIT_SAMPLE_STEPS)
    b = diffusion.ddim_sample(model, shape, y, steps=DIT_SAMPLE_STEPS,
                              eta=0.0, seed=seed)
    same = torch.equal(a, b)
    finite = bool(torch.isfinite(a).all()) and tuple(a.shape) == shape
    # the first step: x_T as the sampler draws it, t = T - 1
    g2 = torch.Generator(device=DEVICE)
    g2.manual_seed(seed)
    xt = torch.randn(shape, generator=g2, device=DEVICE)
    t = torch.full((shape[0],), diffusion.T - 1, dtype=torch.int64,
                   device=DEVICE)
    model.eval()
    with torch.no_grad():
        eps = model(xt, t, y)
        with _swapped(_plain_swaps()):
            ref = model(xt, t, y)
    eps_rel = ((eps - ref).norm() / ref.norm()).item()
    del model, a, b, eps, ref
    _release()
    row = {"phase": "dit-sample", "model": "DiT-XL/2", "eta": 0.0,
           "steps": DIT_SAMPLE_STEPS, "batch": DIT_SAMPLE_BATCH,
           "seconds": secs, "images_per_s": DIT_SAMPLE_BATCH / secs,
           "ms_per_step": secs / DIT_SAMPLE_STEPS * 1e3,
           "flash_launches": counts["flash_attention_tf32x3"]["launches"],
           "flash_launches_expected": DIT_SAMPLE_STEPS * L,
           "same_seed_bitwise": same, "finite": finite,
           "first_eps_rel_l2": eps_rel, "eps_tol": DIT_EPS_TOL}
    _emit(row)
    if not (same and finite and eps_rel <= DIT_EPS_TOL):
        raise RuntimeError(f"dit-sample: {row}")
    return counts


def _dq_first64():
    """A planted fault on the d 72 path: a dQ kernel (the 3xTF32 one) that
    handles only the first 64 head dims (the rest of each row left 0)."""
    fa = _flash_module()
    real = fa.flash_attention_bwd_dq

    def first64(*a):
        dq = real(*a)
        dq[..., 64:] = 0
        return dq
    return [(fa, "flash_attention_bwd_dq", first64)]


def _dit_grad_check(seed):
    """fp32 at XL/2's widths, depth DIT_GRAD_LAYERS: one step's loss and
    every gradient through the kernels (t and noise drawn once, given to
    both) against the same step with every kernel wrapper swapped for its
    plain version, and the planted ``_dq_first64`` fault, which the check
    must catch."""
    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import DiTConfig, GaussianDiffusion

    cfg = DiTConfig.dit_xl_2(num_hidden_layers=DIT_GRAD_LAYERS)
    model = _dit_model(cfg, seed)
    diffusion = GaussianDiffusion()
    x, y = _dit_data(cfg, DIT_GRAD_BATCH, seed + 5)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 6)
    t = torch.randint(0, diffusion.T, (DIT_GRAD_BATCH,), generator=gen,
                      device=DEVICE)
    noise = torch.randn(x.shape, generator=gen, device=DEVICE)
    model.y_embed.dropout_prob = 0.0  # the same labels in both runs

    def loss_and_grads():
        model.train()
        model.zero_grad(set_to_none=True)
        loss = diffusion.training_loss(model, x, y, t, noise)
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return float(loss.detach()), grads

    with _swapped(_plain_swaps()):
        loss_p, grads_p = loss_and_grads()
    kernels.reset_counters()
    loss_k, grads_k = loss_and_grads()
    counts = kernels.counters()
    L = cfg.num_hidden_layers
    want = {"flash_attention_tf32x3": L, "flash_attention_bwd_dkv_tf32x3": L,
            "flash_attention_bwd_dq_tf32x3": L}
    wrong = {n: c for n, c in counts.items() if c["plain_calls"] or
             c["launches"] != want.get(n, 0)}
    if wrong:
        raise RuntimeError(f"dit-grad-check: launches {wrong}")
    errs = _grad_errors(grads_k, grads_p)
    del grads_k
    with _swapped(_dq_first64()):
        _l, grads_f = loss_and_grads()
    fault = max(_grad_errors(grads_f, grads_p).values())
    del grads_f, grads_p, model
    _release()
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    row = {"phase": "dit-grad-check", "dtype": "float32",
           "layers": L, "hidden": cfg.hidden_size,
           "head_dim": cfg.hidden_size // cfg.num_attention_heads,
           "batch": DIT_GRAD_BATCH, "loss_kernels": loss_k,
           "loss_plain": loss_p, "loss_rel_err": loss_rel,
           "loss_rtol": DIT_LOSS_RTOL,
           "grad_rel_l2_max": max(errs.values()),
           "grad_worst": _worst(errs), "grad_tol": DIT_GRAD_TOL,
           "params_checked": len(errs),
           "fault_dq_first64_grad_rel_l2": fault,
           "fault_caught": fault > DIT_GRAD_TOL,
           "launches": {n: counts[n]["launches"] for n in want}}
    _emit(row)
    if not (loss_rel <= DIT_LOSS_RTOL and
            max(errs.values()) <= DIT_GRAD_TOL and row["fault_caught"]):
        raise RuntimeError(f"dit-grad-check: {row}")
    return counts


def phase_dit(seed):
    """DiT-XL/2 (Peebles & Xie 2023 Table 1: 28 layers, hidden 1152, 16
    heads, patch 2, 32 x 32 x 4 latents; bench.py:1876-1878's
    ``dtype="bfloat16"``, fp32 inputs, AdamW 1e-4 with weight decay 0,
    batch 32): the graph = eager check, the graphed and eager steps, the
    DDIM sampler, the depth-2 fp32 gradient check, and the flash kernels'
    rows at DiT's attention shape (fp32, bh 512, 256 x 256, d 72) beside
    SDPA in fp32. Returns ({path: counters}, rows)."""
    import torch

    import paddle_tpu_torch as P
    from paddle_tpu_torch.models import DiTConfig, dit_param_count

    t0 = time.perf_counter()
    prior = P.get_device()
    P.set_device("gpu")
    try:
        _release()
        s = seed + DIT_SEED
        cfg = DiTConfig.dit_xl_2(dtype="bfloat16")
        model = _dit_model(cfg, s)
        state0 = {k: v.detach().clone()
                  for k, v in model.state_dict().items()}
        del model
        x, y = _dit_data(cfg, DIT_BATCH, s + 7)
        check = _dit_graph_check(cfg, state0, x, y, s)
        train, train_row = _dit_train(cfg, state0, x, y, s)
        sample = _dit_sample(cfg, state0, s)
        del state0, x, y
        _release()
        grad = _dit_grad_check(s)
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(s + 8)
        bh = DIT_BATCH * cfg.num_attention_heads
        n_tok = (cfg.input_size // cfg.patch_size) ** 2
        d = cfg.hidden_size // cfg.num_attention_heads
        rows = [_flash_case("dit-d72-float32", torch.float32, bh, n_tok,
                            n_tok, False, gen, d=d)]
        rows += _flash_bwd_case("dit-d72-float32", torch.float32, bh, n_tok,
                                n_tok, 0, False, gen, d=d)
        _release()
        _emit({"phase": "dit", "ok": True, "model": "DiT-XL/2",
               "card": _nvidia_smi(), "params": dit_param_count(cfg),
               "graph_step_ms": train_row["graph"]["step_ms"],
               "images_per_s": train_row["graph"]["images_per_s"],
               "mfu": train_row["graph"]["mfu"],
               "peak_mem_gb": train_row["graph"]["peak_mem_gb"],
               "seconds": time.perf_counter() - t0})
    finally:
        P.set_device(prior)
    return {"dit-graph-check": check, "dit-train": train,
            "dit-sample": sample, "dit-grad-check": grad}, rows


# -- bf16 flash at head dims other than 64 and 128 ------------------------------

# GPT-3 Large (Brown et al. 2020 Table 2.1: 24 layers of 1536, 16 heads of
# 96) at 2 layers: bf16 at head dim 96 runs the tensor-core forward, dK/dV
# and dQ at a padded head dim
D96_LAYERS = 2
D96_BATCH = (2, 2048)
D96_SEED = 61
D96_EAGER_STEPS, D96_GRAPH_STEPS = 3, 4
# GPT-3 2.7B's attention (Table 2.1: 32 heads of 80) at batch 2
D80_BH = 64
# Gemma 7B's attention (Gemma Team 2024 Table 1: 16 heads of 256) at batch
# 1, and a head dim of two whole 64-column chunks and 16 columns (136, DP
# 144) at the same bh: the tensor-core instances above 128
D256_BH = 16
# the repo's Llama at Gemma 2B's widths (Gemma Team 2024 Table 1: d_model
# 2048, 8 heads of 256, 1 key/value head, 18 layers, feed-forward 32768 =
# both halves of the gated unit, vocabulary 256128, context 8192): depth
# cut from 18 to 2 for time, bf16, recompute, batch 2 x 2048; SwiGLU where
# Gemma has GeGLU, no sqrt(d) embedding scale, the head untied
GEMMA2B = dict(vocab_size=256128, hidden_size=2048, intermediate_size=16384,
               num_hidden_layers=2, num_attention_heads=8,
               num_key_value_heads=1, max_position_embeddings=8192)
D256_BATCH = (2, 2048)
D256_SEED = 67
D256_EAGER_STEPS, D256_GRAPH_STEPS = 3, 4


def _d96_launches(L):
    """{counter: launches per step} of the bf16 GPT step at head dim 96;
    every other counter 0: 2L tensor-core forwards (recompute runs each
    layer's forward twice), L tensor-core dK/dV, L tensor-core dQ, one
    ``adam_update``, as at head dim 128: no CUDA-core flash kernel."""
    return _gpt_launches(L)


def _d256_launches(L):
    """{counter: launches per step} of the bf16 Llama step at head dim
    256; every other counter 0: the dense step's (``_dense_launches``: 2L
    tensor-core forwards, L tensor-core dK/dV, L tensor-core dQ, the
    RMSNorm, RoPE and AdamW launches): no CUDA-core flash kernel."""
    return _dense_launches(L)


def _first_columns_check(phase, label, bh, s, d, gen, kind, read):
    """The kernel-against-plain check of the forward (``kind`` "fwd"), of
    dK/dV ("dkv") or of dQ ("dq") at one causal shape, given a planted
    fault: the tensor-core kernel reading only the first ``read`` columns
    of its inputs (the rest zero), as a kernel that loaded too few 64-column
    chunks would. The check must find it past ``sm90_fwd_bound`` /
    ``sm90_dkv_bound`` / ``sm90_dq_bound``. Returns the check's line."""
    import torch

    fa = _flash_module()
    ins = [_rand(gen, (bh, s, d), torch.bfloat16)
           for _ in range(3 if kind == "fwd" else 4)]
    f32 = [t.float() for t in ins]
    scale = 1.0 / d ** 0.5
    ro, rl = fa.flash_attention_plain(*f32[:3], 0, True, scale)
    if kind != "fwd":
        args = (rl, (f32[3] * ro).sum(-1), 0, True, scale)
    if kind == "fwd":
        name, refs = "flash_attention_sm90", [ro]
        bounds = [fa.sm90_fwd_bound(*f32, 0, True, scale, ro)]
    elif kind == "dkv":
        name = "flash_attention_bwd_dkv_sm90"
        refs = list(fa.flash_attention_bwd_dkv_plain(*f32, *args))
        bounds = list(fa.sm90_dkv_bound(*f32, *args, *refs))
    else:
        name = "flash_attention_bwd_dq_sm90"
        refs = [fa.flash_attention_bwd_dq_plain(*f32, *args)]
        bounds = [fa.sm90_dq_bound(*f32, *args, refs[0])]
    for t in ins:
        t[..., read:] = 0
    if kind == "fwd":
        got = [fa.flash_attention_fwd_sm90(*ins, 0, True, scale)[0]]
    elif kind == "dkv":
        got = list(fa.flash_attention_bwd_dkv_sm90(*ins, *args))
    else:
        got = [fa.flash_attention_bwd_dq_sm90(*ins, *args)]
    torch.cuda.synchronize()
    excess = max(((g.float() - r).abs() - b).max().item()
                 for g, r, b in zip(got, refs, bounds))
    caught = False
    for g, r, b in zip(got, refs, bounds):
        try:
            _compare_bound(f"{name}[{label}]", g, r, b)
        except RuntimeError:
            caught = True
    del ins, f32, ro, rl, refs, bounds, got
    _release()
    row = {"phase": f"{phase}-fault", "case": label, "fault":
           f"{kind}_reads_first{read}", "bh": bh, "s": s, "d": d,
           "excess_over_bound": excess, "fault_caught": caught}
    _emit(row)
    if not caught:
        raise RuntimeError(f"{phase}: the planted fault was not caught "
                           f"{row}")
    return row


def _llama_d256(seed):
    """The repo's Llama at Gemma 2B's widths (GEMMA2B; head dim 256, one
    key/value head, repeated to the 8 query heads), bf16, recompute, batch
    D256_BATCH: one step's gradients against the plain-swapped step (within
    TRAIN_GRAD_TOL, the dense Llama step's), eager and graphed steps with
    exact launches (``_d256_launches``) and a falling loss. Returns its
    counters (eager and graphed added)."""
    import torch

    from paddle_tpu_torch.device import seed as pt_seed
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         llama_flops_per_token,
                                         llama_param_count)
    from paddle_tpu_torch.optimizer import AdamW

    _release()
    t0 = time.perf_counter()
    cfg = LlamaConfig(**GEMMA2B, dtype="bfloat16", use_recompute=True)
    model = LlamaForCausalLM(cfg, device=DEVICE,
                             generator=pt_seed(seed + D256_SEED, DEVICE))
    ids = _ids(cfg.vocab_size, D256_BATCH, seed + D256_SEED)
    L = cfg.num_hidden_layers
    with _swapped(_plain_swaps()):
        loss_p, grads_p = _loss_and_grads(model, ids)
    loss_k, grads_k = _loss_and_grads(model, ids)
    errs = _grad_errors(grads_k, grads_p)
    del grads_k, grads_p
    per_step = _d256_launches(L)
    opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                weight_decay=0.1)
    ecounts, gcounts, eager, graph, _nodes = _eager_then_graph(
        "llama-d256", model, opt, ids, per_step,
        llama_flops_per_token(cfg, D256_BATCH[1]), D256_EAGER_STEPS,
        D256_GRAPH_STEPS)
    del opt, model
    _release()
    row = {"phase": "llama-d256", "model": "llama-at-gemma-2b-widths",
           "deviations_from_gemma": [
               "SwiGLU where Gemma has GeGLU", "no sqrt(d) embedding scale",
               "untied head", f"{L} of 18 layers"],
           "card": _nvidia_smi(), "params": llama_param_count(cfg),
           "layers": L, "hidden": cfg.hidden_size,
           "heads": cfg.num_attention_heads,
           "kv_heads": cfg.num_key_value_heads,
           "head_dim": cfg.hidden_size // cfg.num_attention_heads,
           "intermediate": cfg.intermediate_size, "vocab": cfg.vocab_size,
           "dtype": "bfloat16", "batch": list(D256_BATCH),
           "loss_kernels": loss_k, "loss_plain": loss_p,
           "grad_rel_l2_max": max(errs.values()), "grad_worst": _worst(errs),
           "grad_tol": TRAIN_GRAD_TOL, "graph": graph, "eager": eager,
           "launches_per_step": {n: c for n, c in per_step.items() if c},
           "seconds": time.perf_counter() - t0}
    _emit(row)
    if not max(errs.values()) <= TRAIN_GRAD_TOL:
        raise RuntimeError(f"llama-d256: kernel gradients differ from plain "
                           f"{row}")
    return _add_counts(ecounts, gcounts)


def phase_gpt_d96(seed):
    """bf16 flash at head dims other than 64 and 128: GPT-3 Large's widths
    (head dim 96) at D96_LAYERS layers, bf16, recompute, batch D96_BATCH:
    one step's gradients against the plain-swapped step (within
    GPT_GRAD_TOL), eager and graphed steps with exact launches and a
    falling loss; the same for the repo's Llama at Gemma 2B's widths
    (``llama-d256`` lines, ``_llama_d256``: head dim 256 with one
    key/value head; not Gemma: SwiGLU for GeGLU, no sqrt(d) embedding
    scale, an untied head, 2 of 18 layers); then the kernels' rows at
    GPT-3 Large's attention shape, at GPT-3 2.7B's (head dim 80, bh
    D80_BH), at Gemma 7B's and 2B's head dim 256 (bh D256_BH; the
    tensor-core forward, dK/dV and dQ beside the CUDA-core kernels, which
    also get rows of their own there) and at head dim 136, and five planted
    faults (the forward and dQ reading 64 of d 96's columns, the forward,
    dK/dV and dQ reading 128 of d 256's), which each kernel's check against
    its plain version must catch (``_first_columns_check``). Returns
    ({path: counters}, rows)."""
    import torch

    from paddle_tpu_torch.optimizer import AdamW

    _release()
    t0 = time.perf_counter()
    cfg, model = _gpt_model(D96_LAYERS, seed + D96_SEED, hidden_size=1536,
                            num_attention_heads=16)
    ids = _ids(cfg.vocab_size, D96_BATCH, seed + D96_SEED)
    L = cfg.num_hidden_layers
    with _swapped(_plain_swaps()):
        loss_p, grads_p = _loss_and_grads(model, ids)
    loss_k, grads_k = _loss_and_grads(model, ids)
    errs = _grad_errors(grads_k, grads_p)
    del grads_k, grads_p
    per_step = _d96_launches(L)
    opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                weight_decay=0.1)
    ecounts, gcounts, eager, graph, _nodes = _eager_then_graph(
        "gpt-d96", model, opt, ids, per_step, _gpt_flops(cfg, D96_BATCH[1]),
        D96_EAGER_STEPS, D96_GRAPH_STEPS)
    del opt, model
    _release()
    row = {"phase": "gpt-d96", "model": "gpt3-large-widths",
           "card": _nvidia_smi(), "layers": L, "hidden": cfg.hidden_size,
           "heads": cfg.num_attention_heads,
           "head_dim": cfg.hidden_size // cfg.num_attention_heads,
           "dtype": "bfloat16", "batch": list(D96_BATCH),
           "loss_kernels": loss_k, "loss_plain": loss_p,
           "grad_rel_l2_max": max(errs.values()), "grad_worst": _worst(errs),
           "grad_tol": GPT_GRAD_TOL, "graph": graph, "eager": eager,
           "launches_per_step": {n: c for n, c in per_step.items() if c},
           "seconds": time.perf_counter() - t0}
    _emit(row)
    if not max(errs.values()) <= GPT_GRAD_TOL:
        raise RuntimeError(f"gpt-d96: kernel gradients differ from plain "
                           f"{row}")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + D96_SEED)
    bh = D96_BATCH[0] * cfg.num_attention_heads
    d, s = cfg.hidden_size // cfg.num_attention_heads, D96_BATCH[1]
    rows = []
    llama = _llama_d256(seed)
    for label, rbh, rd in (("gpt-d96-bfloat16", bh, d),
                           ("gpt-d80-bfloat16", D80_BH, 80),
                           ("d256-bfloat16", D256_BH, 256),
                           ("d136-bfloat16", D256_BH, 136)):
        core = rd == 256  # the CUDA-core kernels' rows
        fwd = _flash_case(label, torch.bfloat16, rbh, s, s, True, gen, d=rd,
                          cuda_core_row=core)
        rows += fwd if core else [fwd]
        rows += _flash_bwd_case(label, torch.bfloat16, rbh, s, s, 0, True,
                                gen, d=rd, cuda_core_row=core)
        _release()
    for kind in ("fwd", "dq"):
        _first_columns_check("gpt-d96", "gpt-d96-bfloat16", bh, s, d, gen,
                             kind, 64)
    for kind in ("fwd", "dkv", "dq"):
        _first_columns_check("llama-d256", "d256-bfloat16", D256_BH, s, 256,
                             gen, kind, 128)
    return {"gpt-d96": _add_counts(ecounts, gcounts),
            "llama-d256": llama}, rows


# -- ResNet-18 on CIFAR-10's shape ---------------------------------------------

RESNET_BATCH = 128        # bench.py:782-808's throughput batch
RESNET_LR = 0.05
RESNET_STEPS = 20         # graphed calls timed
RESNET_CURVE = (12, 32, 0.01)  # bench.py:750-777: steps, batch, lr
RESNET_SEED = 41


def _surrogate_cifar(n, seed):
    """The CIFAR-10 stand-in of ``bench.py:737-747``: 10 fixed class
    prototypes plus Gaussian noise, 32 x 32."""
    import numpy as np

    rng = np.random.RandomState(seed)
    protos = rng.randn(10, 3, 32, 32).astype("float32")
    ys = rng.randint(0, 10, n).astype("int64")
    xs = (protos[ys] + 0.7 * rng.randn(n, 3, 32, 32)).astype("float32")
    return xs, ys


def _resnet_group(name):
    """ResNet's device ms by group: cuDNN's convolutions (and the GEMMs it
    runs them as), the BatchNorm moments (reductions), pooling, the
    Momentum update, and the elementwise passes."""
    low = name.lower()
    if "rule_kernel" in low:
        return "momentum"
    if any(k in low for k in ("conv", "cudnn", "xmma", "implicit", "wgrad",
                              "dgrad", "fprop", "winograd", "gemm", "nvjet",
                              "cutlass", "sm90_", "sm80_")):
        return "cudnn_conv"
    if "reduce" in low:
        return "bn_moments"
    if "pool" in low:
        return "pool"
    return "elementwise"


def _resnet_step(model, lr, graph):
    import paddle_tpu_torch.nn.functional as PF
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum

    opt = Momentum(learning_rate=lr, momentum=0.9,
                   parameters=model.parameters())
    return TrainStep(model, lambda m, a, b: PF.cross_entropy(m(a), b), opt,
                     graph=graph)


def _resnet_launches():
    from paddle_tpu_torch import kernels

    per = {n: 0 for n in kernels.counters()}
    per["momentum_update"] = 1
    return per


def _resnet_curve(seed):
    """bench.py's CPU-reference curve (12 steps of batch 32, Momentum
    0.01) eager and graphed from the same weights under
    ``FLAGS_cudnn_deterministic``: losses, parameters and BatchNorm buffers
    bit for bit, launches exact."""
    import torch

    import paddle_tpu_torch as P
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.vision.models import resnet18

    steps, batch, lr = RESNET_CURVE
    xs, ys = _surrogate_cifar(steps * batch, seed)
    xs, ys = torch.from_numpy(xs).to(DEVICE), torch.from_numpy(ys).to(DEVICE)
    P.seed(seed)
    model = resnet18(num_classes=10)
    state0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    per = _resnet_launches()

    def run(graph):
        model.load_state_dict(state0)
        step = _resnet_step(model, lr, graph)
        kernels.reset_counters()
        losses = [float(step(xs[i * batch:(i + 1) * batch],
                             ys[i * batch:(i + 1) * batch]))
                  for i in range(steps)]
        counts = _reckoned(step)
        out = {k: v.detach().clone() for k, v in model.state_dict().items()}
        del step
        _release()
        return losses, counts, out

    P.set_flags({"FLAGS_cudnn_deterministic": True})
    try:
        elosses, ecounts, ref = run(False)
        glosses, gcounts, got = run(True)
    finally:
        P.set_flags({"FLAGS_cudnn_deterministic": False})
    _exact("resnet18-curve-eager", ecounts, per, steps)
    _exact("resnet18-curve-graph", gcounts, per, steps + 1)
    diff = [k for k in ref if not torch.equal(ref[k], got[k])]
    buffers = [k for k in ref if k.endswith(("_mean", "_variance"))]
    moved = [k for k in buffers if not torch.equal(ref[k], state0[k])]
    row = {"phase": "resnet18-curve", "steps": steps, "batch": batch,
           "lr": lr, "eager_losses": elosses, "graph_losses": glosses,
           "flags_cudnn_deterministic": True,
           "bitwise": not diff and elosses == glosses,
           "tensors_differing": diff[:5], "bn_buffers": len(buffers),
           "bn_buffers_equal": not any(k in diff for k in buffers),
           "bn_buffers_moved": len(moved)}
    _emit(row)
    if not (row["bitwise"] and len(moved) == len(buffers) and
            elosses[-1] < elosses[0]):
        raise RuntimeError(f"resnet18-curve: {row}")
    return _add_counts(ecounts, gcounts)


def phase_resnet(seed):
    """ResNet-18 on CIFAR-10's shape (bench.py:782-808: ``resnet18(
    num_classes=10)``, Momentum 0.05 / 0.9, batch 128 of 32 x 32 surrogate
    images from the seed, fp32 with TF32 off as ``main`` sets it),
    graphed: step ms, images/s, peak GiB, device ms by group and idle
    share, launches exact; the 12-step curve eager = graphed bit for bit
    under the flag with the BatchNorm buffers; ``pretrained=True``
    raises. Returns {path: counters}."""
    import math

    import torch

    import paddle_tpu_torch as P
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.vision.models import resnet18

    t0 = time.perf_counter()
    prior = P.get_device()
    P.set_device("gpu")
    try:
        _release()
        s = seed + RESNET_SEED
        curve = _resnet_curve(s)
        xs, ys = _surrogate_cifar(RESNET_BATCH, s + 1)
        x, y = torch.from_numpy(xs).to(DEVICE), torch.from_numpy(ys).to(
            DEVICE)
        P.seed(s)
        model = resnet18(num_classes=10)
        per = _resnet_launches()
        torch.cuda.reset_peak_memory_stats()
        step = _resnet_step(model, RESNET_LR, graph=True)
        kernels.reset_counters()
        losses, ms = [], []
        for _ in range(RESNET_STEPS):
            t1 = time.perf_counter()
            losses.append(float(step(x, y)))
            ms.append((time.perf_counter() - t1) * 1e3)
        counts = _reckoned(step)
        _exact("resnet18-cifar", counts, per, RESNET_STEPS + 1)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = _step_profile(lambda: step(x, y), _resnet_group)
        del step, model
        _release()
        try:
            resnet18(pretrained=True)
            refused = False
        except ValueError:
            refused = True
        step_ms = sum(ms[2:]) / len(ms[2:])
        row = {"phase": "resnet18-cifar", "card": _nvidia_smi(),
               "batch": RESNET_BATCH, "lr": RESNET_LR, "dtype": "float32",
               "tf32": torch.backends.cudnn.allow_tf32, "step_ms": step_ms,
               "step_ms_each": ms,
               "images_per_s": RESNET_BATCH / step_ms * 1e3,
               "peak_mem_gb": peak, "device_ms": prof["device_ms"],
               "events_ms": prof["events_ms"],
               "idle_share": prof["idle_share"],
               "groups_ms": prof["groups_ms"], "top": prof["top"],
               "losses": losses, "pretrained_refused": refused,
               "seconds": time.perf_counter() - t0}
        _emit(row)
        if not (refused and all(math.isfinite(v) for v in losses) and
                losses[-1] < losses[0]):
            raise RuntimeError(f"resnet18-cifar: {row}")
    finally:
        P.set_device(prior)
    return {"resnet18-curve": curve, "resnet18-cifar": counts}


def _kernels_line(rows, paths):
    """One entry per kernel for the ``kernels`` line: its representative
    case's times and bound, the largest error over all its cases, and its
    launches on the main paths (``paths``: {path: counters read after its
    run}): serving, the bf16 training steps, and the fp32 runs of the
    parity phases (the depth-2 engine, whose prefill windows run the
    general paged-attention kernel, and the depth-2 training steps, which
    run the 3xTF32 flash forward, dK/dV and dQ and the CUDA-core grouped
    GEMM kernels); the CUDA-core flash forward, dK/dV and dQ run on no
    main path now, and their rows are taken at head dim 256
    (``d256-bfloat16``) on the same inputs as the tensor-core kernels
    there. The flash kernels also carry their rows at DiT's (``dit``),
    GPT-3 Large's (``gpt_d96``), GPT-3 2.7B's (``gpt_d80``) and Gemma's
    (``d256``, with the ``llama-d256`` step's launches) attention shapes
    and at head dim 136 (``d136``)."""
    # (kernel, representative case, source, TPU kernel replaced, the
    # counters whose launches it sums)
    table = [
        ("paged_attention_decode", "decode-bfloat16",
         "paged_attention_decode.cu",
         "paddle_tpu/kernels/pallas/paged_attention.py:46",
         ["paged_attention_decode"]),
        ("paged_attention_sm90", "prefill512-bfloat16",
         "paged_attention_sm90.cu",
         "paddle_tpu/kernels/pallas/paged_attention.py:46",
         ["paged_attention_sm90"]),
        ("paged_attention", "prefill128-float32", "paged_attention.cu",
         "paddle_tpu/kernels/pallas/paged_attention.py:46",
         ["paged_attention"]),
        ("flash_attention", "d256-bfloat16", "flash_attention.cu",
         "paddle_tpu/kernels/flash_attention.py:64", ["flash_attention"]),
        ("flash_attention_tf32x3", "dit-d72-float32", "flash_fwd_tf32x3.cu",
         "paddle_tpu/kernels/flash_attention.py:64",
         ["flash_attention_tf32x3"]),
        ("flash_attention_sm90", "causal2048-bfloat16", "flash_fwd_sm90.cu",
         "paddle_tpu/kernels/flash_attention.py:64",
         ["flash_attention_sm90"]),
        ("flash_attention_decode", "decode1x640-bfloat16", "flash_decode.cu",
         "paddle_tpu/kernels/flash_attention.py:64",
         ["flash_attention_decode"]),
        ("flash_attention_bwd_dkv", "d256-bfloat16",
         "flash_attention_bwd.cu",
         "paddle_tpu/kernels/flash_attention.py:154",
         ["flash_attention_bwd_dkv"]),
        ("flash_attention_bwd_dkv_tf32x3", "dit-d72-float32",
         "flash_bwd_dkv_tf32x3.cu",
         "paddle_tpu/kernels/flash_attention.py:154",
         ["flash_attention_bwd_dkv_tf32x3"]),
        ("flash_attention_bwd_dkv_sm90", "train-bfloat16",
         "flash_bwd_dkv_sm90.cu",
         "paddle_tpu/kernels/flash_attention.py:154",
         ["flash_attention_bwd_dkv_sm90"]),
        ("flash_attention_bwd_dq", "d256-bfloat16",
         "flash_attention_bwd.cu",
         "paddle_tpu/kernels/flash_attention.py:206",
         ["flash_attention_bwd_dq"]),
        ("flash_attention_bwd_dq_tf32x3", "dit-d72-float32",
         "flash_bwd_dq_tf32x3.cu",
         "paddle_tpu/kernels/flash_attention.py:206",
         ["flash_attention_bwd_dq_tf32x3"]),
        ("flash_attention_bwd_dq_sm90", "train-bfloat16",
         "flash_bwd_dq_sm90.cu",
         "paddle_tpu/kernels/flash_attention.py:206",
         ["flash_attention_bwd_dq_sm90"]),
        ("rms_norm", "train-bfloat16", "rmsnorm.cu",
         "paddle_tpu/kernels/pallas/rmsnorm.py:57",
         ["rms_norm", "rms_norm_residual"]),
        ("rms_norm_bwd", "train-bfloat16", "rmsnorm.cu",
         "paddle_tpu/kernels/pallas/rmsnorm.py:147",
         ["rms_norm_bwd", "rms_norm_residual_bwd"]),
        ("rope", "train-bfloat16", "rope.cu",
         "paddle_tpu/kernels/pallas/rope.py:50", ["rope", "rope_inverse"]),
        ("moe_route", "moe-bfloat16", "moe_dispatch.cu",
         "paddle_tpu/kernels/pallas/moe_dispatch.py:59", ["moe_route"]),
        ("moe_gather", "moe-bfloat16", "moe_dispatch.cu",
         "paddle_tpu/kernels/pallas/moe_dispatch.py:235", ["moe_gather"]),
        ("moe_combine", "moe-bfloat16", "moe_dispatch.cu",
         "paddle_tpu/kernels/pallas/moe_dispatch.py:261", ["moe_combine"]),
        ("grouped_matmul", "moe-gate-float32", "grouped_matmul.cu",
         "paddle_tpu/kernels/grouped_matmul.py:55", ["grouped_matmul"]),
        ("grouped_matmul_dgrad", "moe-gate-float32", "grouped_matmul.cu",
         "paddle_tpu/kernels/grouped_matmul.py:55",
         ["grouped_matmul_dgrad"]),
        ("grouped_matmul_wgrad", "moe-gate-float32", "grouped_matmul.cu",
         "paddle_tpu/kernels/grouped_matmul.py:55",
         ["grouped_matmul_wgrad"]),
        ("grouped_matmul_sm90", "moe-gate-bfloat16", "grouped_matmul_sm90.cu",
         "paddle_tpu/kernels/grouped_matmul.py:55", ["grouped_matmul_sm90"]),
        ("grouped_matmul_dgrad_sm90", "moe-gate-bfloat16",
         "grouped_matmul_sm90.cu", "paddle_tpu/kernels/grouped_matmul.py:55",
         ["grouped_matmul_dgrad_sm90"]),
        ("grouped_matmul_wgrad_sm90", "moe-gate-bfloat16",
         "grouped_matmul_sm90.cu", "paddle_tpu/kernels/grouped_matmul.py:55",
         ["grouped_matmul_wgrad_sm90"]),
        # no Pallas kernel: XLA fuses the JAX package's update
        # (Optimizer._get_fused's fused, optimizer.py:127, and the clips)
        ("multi_tensor_sumsq", "dense-clip-bfloat16", "optimizer.cu",
         "paddle_tpu/nn/clip.py:48", ["multi_tensor_sumsq"]),
        ("adam_update", "dense-bfloat16", "optimizer.cu",
         "paddle_tpu/optimizer/optimizer.py:127", ["adam_update"]),
        ("adafactor_stats", "moe-bfloat16", "optimizer.cu",
         "paddle_tpu/optimizer/optimizer.py:443", ["adafactor_stats"]),
        ("adafactor_update", "moe-bfloat16", "optimizer.cu",
         "paddle_tpu/optimizer/optimizer.py:443", ["adafactor_update"]),
        ("sgd_update", "dense-sgd-bfloat16", "optimizer.cu",
         "paddle_tpu/optimizer/optimizer.py:214", ["sgd_update"]),
        ("momentum_update", "dense-momentum-bfloat16", "optimizer.cu",
         "paddle_tpu/optimizer/optimizer.py:228", ["momentum_update"]),
        ("adagrad_update", "dense-adagrad-bfloat16", "optimizer.cu",
         "paddle_tpu/optimizer/optimizer.py:248", ["adagrad_update"]),
        ("adamax_update", "dense-adamax-bfloat16", "optimizer.cu",
         "paddle_tpu/optimizer/optimizer.py:301", ["adamax_update"]),
        ("rmsprop_update", "dense-rmsprop-bfloat16", "optimizer.cu",
         "paddle_tpu/optimizer/optimizer.py:322", ["rmsprop_update"]),
        ("adadelta_update", "dense-adadelta-bfloat16", "optimizer.cu",
         "paddle_tpu/optimizer/optimizer.py:491", ["adadelta_update"]),
        ("lamb_update", "dense-lamb-bfloat16", "optimizer.cu",
         "paddle_tpu/optimizer/optimizer.py:351", ["lamb_update"]),
        ("lars_update", "dense-lars-bfloat16", "optimizer.cu",
         "paddle_tpu/optimizer/optimizer.py:396", ["lars_update"]),
        # GradScaler.unscale_: the jitted finiteness test and the unscale
        ("check_finite", "dense-unscale-bfloat16", "optimizer.cu",
         "paddle_tpu/amp/grad_scaler.py:21", ["check_finite"]),
        ("unscale", "dense-unscale-bfloat16", "optimizer.cu",
         "paddle_tpu/amp/grad_scaler.py:62", ["unscale"]),
    ]
    # a second function of the same kernel: (TPU kernel it replaces where
    # another, its name; launches from its own counter where it has one)
    # the optimizer's kernels with fp32 gradients beside bf16 parameters
    fp32_grad = {"multi_tensor_sumsq": "dense-fp32grad-bfloat16",
                 "adam_update": "dense-fp32grad-bfloat16",
                 "adafactor_stats": "moe-fp32grad-bfloat16",
                 "adafactor_update": "moe-fp32grad-bfloat16"}
    also = {"rms_norm": ("paddle_tpu/kernels/pallas/rmsnorm.py:47",
                         "rms_norm_residual"),
            "rms_norm_bwd": ("paddle_tpu/kernels/pallas/rmsnorm.py:127",
                             "rms_norm_residual_bwd"),
            "rope": (None, "rope_inverse"),
            "moe_gather": (None, "moe_gather_scaled")}
    out = []
    for name, case, src, replaces, counters in table:
        mine = [x for x in rows if x["kernel"] in counters]
        r = next(x for x in mine if x["kernel"] == name and
                 x["case"] == case)
        by_path = {p: sum(c[n]["launches"] for n in counters)
                   for p, c in paths.items()}
        entry = {
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/" + src,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(x["max_abs_err"] for x in mine),
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "case": case}
        extras = ("cuda_core_ms", "library_ms_spread", "graph_ms", "library",
                  "cuda_core_graph_ms", "library_graph_ms", "copy_graph_ms",
                  "copy_out_graph_ms", "composition_ms",
                  "composition_graph_ms", "earlier_ms", "earlier_graph_ms",
                  "design_floor_ms", "function_bound_ms", "bound_fp32_ms")
        for key in extras:
            if r.get(key) is not None:
                entry[key] = r[key]
        if name in also:
            also_replaces, variant = also[name]
            v = next(x for x in rows if x["kernel"] == variant and
                     x["case"] == case)
            entry["variant"] = {
                "name": variant, "replaces": also_replaces,
                "ms": v["kernel_ms"], "plain_ms": v["plain_ms"],
                "bound_ms": v["bound_ms"], "library_ms": v["library_ms"]}
            if variant in counters:
                entry["variant"]["launches"] = sum(
                    c[variant]["launches"] for c in paths.values())
            for key in extras:
                if v.get(key) is not None:
                    entry["variant"][key] = v[key]
        if name in fp32_grad:
            v = next(x for x in rows if x["kernel"] == name and
                     x["case"] == fp32_grad[name])
            entry["fp32_grad"] = {key: v[key] for key in (
                "case", "kernel_ms", "graph_ms", "plain_ms", "bound_ms",
                "max_ulps", "bitwise_share")}
        if name == "rmsprop_update":
            v = next(x for x in rows if x["kernel"] == name and
                     x["case"] == "dense-rmsprop-centered-bfloat16")
            entry["centered"] = {key: v[key] for key in (
                "case", "kernel_ms", "graph_ms", "plain_ms", "bound_ms",
                "library_ms", "library")}
        if name == "adam_update":
            # make_master_update's AdamW over fp32 masters
            v = next(x for x in rows if x["kernel"] == name and
                     x["case"] == "dense-master-fp32")
            entry["master_fp32"] = {key: v[key] for key in (
                "case", "kernel_ms", "plain_ms", "bound_ms", "bitwise",
                "max_abs_err")}
        bert = next((x for x in rows if x["kernel"] == name and
                     x["case"].startswith("bert-")), None)
        if bert is not None:
            # the kernel at BERT-base's attention (bh 384, 128 x 128, d 64)
            entry["bert"] = {key: bert[key] for key in (
                "case", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "max_abs_err", "cuda_core_ms", "graph_ms",
                "bound_fp32_ms") if bert.get(key) is not None}
        # the kernels at DiT-XL/2's attention (fp32, bh 512, 256 x 256,
        # d 72; beside SDPA in fp32 and both bounds), GPT-3 Large's (bf16,
        # bh 32, causal 2048, d 96), GPT-3 2.7B's (bh 64, d 80), Gemma's
        # (bh 16, d 256) and at d 136, beside the CUDA-core kernels on the
        # same inputs; with the launches of the main paths at that shape
        for key, prefix, path in (("dit", "dit-", "dit"),
                                  ("gpt_d96", "gpt-d96-", "gpt-d96"),
                                  ("gpt_d80", "gpt-d80-", None),
                                  ("d256", "d256-", "llama-d256"),
                                  ("d136", "d136-", None)):
            at = next((x for x in rows if x["kernel"] == name and
                       x["case"].startswith(prefix)), None)
            if at is None or at["case"] == case:
                continue
            entry[key] = {k: at[k] for k in (
                "case", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "max_abs_err", "cuda_core_ms", "graph_ms",
                "bound_fp32_ms") if at.get(k) is not None}
            entry[key]["launches"] = sum(
                c[n]["launches"] for p, c in paths.items()
                if path is not None and p.startswith(path)
                for n in counters)
        if name == "rope":
            # the inverse as the training step runs it: on the cotangent's
            # [b, s, h, d] view of [b, h, s, d], read in place
            v = next(x for x in rows if x["kernel"] == "rope_inverse" and
                     x["case"] == "train-bhsd-bfloat16")
            entry["inverse_strided"] = {
                key: v[key] for key in ("case", "kernel_ms", "graph_ms",
                                        "copy_graph_ms", "bound_ms")}
        out.append(entry)
    return out


def main() -> int:
    import torch

    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from paddle_tpu_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: paddle_tpu_torch not found beside the script "
              f"({e})", file=sys.stderr)
        return 2

    # device
    kind = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _emit({"phase": "device", "name": kind, "nvidia_smi": smi,
           "count": torch.cuda.device_count(), "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    # build (always: every later phase needs the library)
    info = _build.build_info()
    log = str(info["log"])
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    spills = [ln.strip() for ln in log.splitlines()
              if "spill" in ln and not ln.strip().startswith("0 bytes")
              and " 0 bytes spill stores, 0 bytes spill loads" not in ln]
    _emit({"phase": "build", "seconds": info["seconds"],
           "cached": info["cached"], "library": info["path"],
           "kernel_instances": len(regs),
           "max_registers": max((int(ln.split("Used ")[1].split()[0])
                                 for ln in regs if "Used " in ln),
                                default=None),
           "spill_lines": spills[:8]})

    phase_s = {}  # wall seconds of each phase, in the script line

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        phase_s[name] = time.perf_counter() - t0
        return out

    rows = timed("kernels", phase_kernels, SEED)
    rows += timed("train-kernels", phase_train_kernels, SEED)
    serving_fp32 = timed("parity", phase_parity, SEED)
    serving = timed("serving", phase_serving, SEED)
    serving_tier = timed("serving-tier", phase_serving_tier, SEED)
    serving_fleet = timed("serving-fleet", phase_serving_fleet, SEED)
    gpt, gpt_eager, gpt_graph_check = timed("gpt-train", phase_gpt_train,
                                            SEED)
    timed("gpt-dropout", phase_gpt_dropout, SEED)
    training_fp32, finetune_fp32 = timed("train-parity", phase_train_parity,
                                         SEED)
    (training, training_eager, accumulate, dense_shapes, rule_graphs,
     rule_steps, scaler) = timed("train", phase_train, SEED)
    rows += timed("optimizer-dense", phase_optimizer, "dense", dense_shapes,
                  "adam", SEED)
    rows += timed("rules", phase_rules, "dense", dense_shapes, SEED)
    rows += timed("master", phase_master, dense_shapes, SEED)
    rows += timed("moe-kernels", phase_moe_kernels, SEED)
    moe_fp32 = timed("moe-train-parity", phase_moe_train_parity, SEED)
    moe, moe_eager, moe_shapes = timed("moe-train", phase_moe_train, SEED)
    rows += timed("optimizer-moe", phase_optimizer, "moe", moe_shapes,
                  "adafactor", SEED)
    timed("moe-modes", phase_moe_modes, SEED)
    llama_cache = timed("llama-cache", phase_llama_cache, SEED)
    bench, bench_rows = timed("bench-configs", phase_bench_configs, SEED)
    rows += bench_rows
    distributed, dist_rows = timed("distributed", phase_distributed, SEED)
    rows += dist_rows
    pipeline = timed("pipeline", phase_pipeline, SEED)
    moe_mesh, mesh_rows = timed("moe-mesh", phase_moe_mesh, SEED)
    rows += mesh_rows
    offload = timed("offload", phase_offload, SEED)
    bert, bert_rows = timed("bert-finetune", phase_bert_finetune, SEED)
    rows += bert_rows
    dit, dit_rows = timed("dit", phase_dit, SEED)
    rows += dit_rows
    d96, d96_rows = timed("gpt-d96", phase_gpt_d96, SEED)
    rows += d96_rows
    resnet = timed("resnet", phase_resnet, SEED)

    _emit({"phase": "script", "seconds": time.perf_counter() - t_script,
           "phase_seconds": phase_s})
    _emit({"phase": "rule-steps", "model": "llama-1.16b",
           "batch": [4, 2048], "rules": rule_steps})
    _emit({"kernels": _kernels_line(rows, {
        "serving": serving, "serving-tier": serving_tier,
        "serving-fleet": serving_fleet,
        "serving-fp32": serving_fp32,
        "training": training, "moe-training": moe,
        "training-eager": training_eager, "moe-training-eager": moe_eager,
        "accumulate": accumulate, "rule-graphs": rule_graphs,
        "grad-scaler": scaler,
        "training-fp32": training_fp32, "moe-training-fp32": moe_fp32,
        "finetune-fp32": finetune_fp32, "gpt-training": gpt,
        "gpt-training-eager": gpt_eager, "gpt-graph-check": gpt_graph_check,
        "llama-cache": llama_cache, **bench, **distributed,
        **pipeline, **moe_mesh, **offload, **bert, **dit, **d96,
        **resnet})})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
