#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure, so the process exits non-zero and prints no
``ok`` line):

1. device  — card name and power limit; TF32 off for matmuls and cuDNN.
2. build   — builds the CUDA kernels from ``paddle_tpu_torch/kernels/csrc``.
3. kernels — each kernel at the serving path's shapes against its plain
             PyTorch version on the same inputs, with times of the kernel,
             the plain version and ``F.scaled_dot_product_attention`` (a
             yardstick the port never calls) and the least time the card
             could take (bound).
4. parity  — fp32, GPT-3 6.7B width at depth 2: the engine's greedy tokens
             (paged-attention kernel) equal ``model.generate``'s (flash
             kernel), and its logprobs match a teacher-forced forward.
5. serving — bf16, full 32-layer GPT-3 6.7B with random weights: an engine
             with 8 slots answers 16 requests (half share a 256-token
             prefix), then ``model.generate`` decodes two prompts; the
             kernels' counters are reset before and read after, and both
             kernels must have launched and no plain version run. Every
             answer is then checked against the model's own forward, and
             the same check must fail on answers served with a fault
             planted in the paged-attention kernel.

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
              "float32": 67e12}            # float32 outside the tensor cores
DEVICE = "cuda"
SEED = 0  # inputs and random weights are drawn from it
# serving check of the bf16 32-layer model against its own forward: about
# 3x the largest sound reading over all 16 requests and both generate rows
# (argmax gap 0.0625 = one bf16 ulp of logits in [8, 16), logprob 0.063);
# the planted faults read 1.0 and more
GAP_TOL, LP_TOL = 0.2, 0.2
FAULTS = ("shifted_tables", "unscaled")


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


def _paged_case(label, dtype, S, W, lengths, active, gen):
    """K1 at one path shape: lengths [S] window starts, `active` slots own
    real pages (the rest have all-zero tables, as in the engine)."""
    import torch
    import torch.nn.functional as TF

    from paddle_tpu_torch.kernels.paged_attention import (
        paged_attention, paged_attention_plain)

    nh = kvh = 32
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

    out = paged_attention(q, ka, va, tables, pos, scale)
    torch.cuda.synchronize()
    ref = paged_attention_plain(q.float(), ka.float(), va.float(), tables,
                                pos, scale)
    err, rel = _compare(f"paged_attention[{label}]", out, ref, _tol(dtype))
    del ref
    ms = _time_ms(lambda: paged_attention(q, ka, va, tables, pos, scale))
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
    lib_ms = _time_ms(lambda: TF.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask))
    del kd, vd
    # least work: every distinct visible key position (page id, offset)
    # read once for K and V — idle slots' all-zero tables see the scratch
    # page's 16 keys, however often — q read, out written; 4*hd FLOPs per
    # visible (row, key) pair
    esz = q.element_size()
    vis_rows = torch.clamp(pos.long() + 1, max=L)                # [S, W]
    vis_slot = vis_rows.max(dim=1).values                        # [S]
    j = torch.arange(L, device=dev)
    keys = tables.long()[:, j // PL] * PL + j % PL               # [S, L]
    n_keys = keys[j[None, :] < vis_slot[:, None]].unique().numel()
    nbytes = (2 * n_keys * kvh * hd * esz
              + 2 * q.numel() * esz + tables.numel() * 4 + pos.numel() * 4)
    flops = 4 * hd * nh * int(vis_rows.sum())
    bound_ms, bound_by = _bound(nbytes, flops, str(dtype).split(".")[1])
    row = {"phase": "kernel", "kernel": "paged_attention", "case": label,
           "dtype": str(dtype).split(".")[1], "S": S, "W": W,
           "distinct_keys": n_keys,
           "max_abs_err": err, "max_rel_err": rel, "tol": _tol(dtype),
           "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    _emit(row)
    return row


def _flash_case(label, dtype, bh, sq, sk, causal, gen):
    import torch
    import torch.nn.functional as TF

    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_plain, flash_attention_with_lse)

    d = 128
    dev = DEVICE
    q = torch.randn(bh, sq, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(bh, sk, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(bh, sk, d, generator=gen, device=dev).to(dtype)
    off = sk - sq if causal else 0
    scale = 1.0 / d ** 0.5
    o, lse = flash_attention_with_lse(q, k, v, off, causal, scale)
    torch.cuda.synchronize()
    ro, rlse = flash_attention_plain(q.float(), k.float(), v.float(), off,
                                     causal, scale)
    err, rel = _compare(f"flash_attention[{label}]", o, ro, _tol(dtype))
    lse_err, _ = _compare(f"flash_attention[{label}].lse", lse, rlse,
                          (0.0, 1e-3))
    del ro, rlse
    ms = _time_ms(lambda: flash_attention_with_lse(q, k, v, off, causal,
                                                      scale))
    plain_ms = _time_ms(lambda: flash_attention_plain(
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
    bound_ms, bound_by = _bound(nbytes, flops, str(dtype).split(".")[1])
    row = {"phase": "kernel", "kernel": "flash_attention", "case": label,
           "dtype": str(dtype).split(".")[1], "bh": bh, "sq": sq, "sk": sk,
           "causal": causal, "max_abs_err": err, "max_rel_err": rel,
           "lse_max_abs_err": lse_err, "tol": _tol(dtype), "kernel_ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
           "bound_by": bound_by}
    _emit(row)
    return row


def phase_kernels(seed):
    import numpy as np
    import torch

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
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
        torch.cuda.empty_cache()
    for sq in (128, 512, 2048):
        rows.append(_flash_case(f"causal{sq}-bfloat16", torch.bfloat16, 32,
                                sq, sq, True, gen))
    rows.append(_flash_case("causal512-float32", torch.float32, 32, 512, 512,
                            True, gen))
    rows.append(_flash_case("decode1x640-bfloat16", torch.bfloat16, 32, 1,
                            640, True, gen))
    rows.append(_flash_case("ragged300-bfloat16", torch.bfloat16, 32, 300,
                            300, True, gen))
    torch.cuda.empty_cache()
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
    ``unscaled`` drops the 1/sqrt(hd) of the scores."""
    import torch

    def faulty(q, k_arena, v_arena, tables, pos, scale):
        if fault == "shifted_tables":
            tables = torch.cat([tables[:, 1:], tables[:, :1] * 0], dim=1)
        else:
            scale = 1.0
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


def phase_parity(seed):
    import numpy as np
    import torch

    from paddle_tpu_torch import seed as pt_seed
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
    with eng:
        futs = [eng.submit(p, max_new_tokens=new, return_logprobs=True)
                for p in prompts]
        outs = [f.result(timeout=600) for f in futs]
    lp_errs = []
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
    st = eng.stats()
    if st["prefix_hit_rate"] <= 0:
        raise RuntimeError("parity: the shared prefix was not reused")
    _emit({"phase": "parity", "ok": True, "requests": len(prompts),
           "new_tokens": new, "logprob_max_abs_err": max(lp_errs),
           "logprob_tol": 2e-3, "prefix_hit_rate": st["prefix_hit_rate"]})
    del eng, model
    torch.cuda.empty_cache()


def phase_serving(seed):
    import numpy as np
    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch import seed as pt_seed
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
        if c["launches"] <= 0 or c["plain_calls"] != 0:
            raise RuntimeError(f"serving: kernel {name} counts {c}")
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
    torch.cuda.empty_cache()
    return counts


def _kernel_group(name):
    low = name.lower()
    if "paged_attention_kernel" in low:
        return "paged_attention"
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
        # device records only: a CPU op's device time is its kernels'
        # again, and CUPTI's "Command Buffer Full" record marks the host
        # waiting on a full launch queue, not device work
        by_name = {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA or \
                    e.name.startswith("Command Buffer"):
                continue
            ms = (e.time_range.end - e.time_range.start) / 1e3 / reps
            by_name[e.name] = by_name.get(e.name, 0.0) + ms
        device = sum(by_name.values())
        groups = {}
        for name, ms in by_name.items():
            g = _kernel_group(name)
            groups[g] = groups.get(g, 0.0) + ms
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        out[label] = {
            "wall_ms": wall, "device_ms": device or None,
            "idle_share": (1.0 - device / wall) if device else None,
            "groups_ms": groups or None,
            "top": [[name[:80], ms] for name, ms in top]}
    del pool
    return out


def main() -> int:
    import torch

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

    rows = phase_kernels(SEED)
    phase_parity(SEED)
    counts = phase_serving(SEED)

    reps = {"paged_attention": "decode-bfloat16",
            "flash_attention": "causal512-bfloat16"}
    meta = {"paged_attention": (
                "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
                "paddle_tpu/kernels/pallas/paged_attention.py:46"),
            "flash_attention": (
                "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
                "paddle_tpu/kernels/flash_attention.py:64")}
    out = []
    for name, case in reps.items():
        r = next(x for x in rows if x["kernel"] == name and x["case"] == case)
        out.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": counts[name]["launches"],
            "max_abs_err": max(x["max_abs_err"] for x in rows
                               if x["kernel"] == name),
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "case": case})
    _emit({"kernels": out})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
