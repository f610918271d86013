#!/usr/bin/env python3
"""The serving phase of ``chip_smoke.py`` from several checkouts in turn on
one CUDA card, so that two trees are compared within one call.

Run from the repository root on a machine with an NVIDIA card, with the
older tree unpacked beside it (``git archive <commit>`` into a directory
that ``.gitignore`` lists) and the roots ordered parent, change, change,
parent:

    python3 tools/torch_serving_ab.py _archive/parent . . _archive/parent

Each root runs in a process of its own: it builds that root's kernels and
runs that root's ``chip_smoke.phase_serving`` (GPT-3 6.7B, bf16, 16
requests of 64 new tokens through ``GenerationEngine``) ``--repeats`` times,
keeping each run's ``serving`` and ``serving-breakdown`` lines. Prints one
JSON object with every reading and, per root, the spread of tokens/s and
of the engine's mean decode step; exits non-zero without a card or when a
run fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

KEEP = ("tokens_per_s", "decode_step_ms_mean", "decode_steps",
        "prefill_ms_mean", "ttft_ms_p50", "ttft_ms_p99", "wall_s")


def _child(root: str, repeats: int) -> int:
    """Build ``root``'s kernels and run its serving phase ``repeats`` times
    (the phase prints its own JSON lines)."""
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_serving_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from paddle_tpu_torch.kernels import _build

    if os.path.dirname(os.path.abspath(chip_smoke.__file__)) != root:
        raise RuntimeError(f"chip_smoke imported from {chip_smoke.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = _build.build_info()
    print(json.dumps({"phase": "build", "seconds": info["seconds"]}),
          flush=True)
    for _ in range(repeats):
        chip_smoke.phase_serving(chip_smoke.SEED)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", help="checkout roots, in run order")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return _child(os.path.abspath(args.child), args.repeats)
    if not args.roots:
        ap.error("name at least one checkout root")
    runs = []
    for root in args.roots:
        root = os.path.abspath(root)
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", root,
             "--repeats", str(args.repeats)],
            capture_output=True, text=True, cwd=root)
        lines = [json.loads(ln) for ln in res.stdout.splitlines()
                 if ln.startswith("{")]
        if res.returncode != 0:
            sys.stderr.write(res.stderr[-4000:])
            print(json.dumps({"root": root, "rc": res.returncode}))
            return res.returncode or 1
        serving = [ln for ln in lines if ln.get("phase") == "serving"]
        breakdown = [ln for ln in lines
                     if ln.get("phase") == "serving-breakdown"]
        build = next(ln for ln in lines if ln.get("phase") == "build")
        runs.append({
            "root": os.path.relpath(root), "build_s": build["seconds"],
            "serving": [{k: s[k] for k in KEEP} for s in serving],
            "decode_step_wall_ms": [b["decode"]["wall_ms"]
                                    for b in breakdown],
            "decode_step_device_ms": [b["decode"]["device_ms"]
                                      for b in breakdown]})
    trees = {}
    for r in runs:
        t = trees.setdefault(r["root"], {"tokens_per_s": [],
                                         "decode_step_ms_mean": [],
                                         "decode_step_wall_ms": []})
        for s in r["serving"]:
            t["tokens_per_s"].append(s["tokens_per_s"])
            t["decode_step_ms_mean"].append(s["decode_step_ms_mean"])
        t["decode_step_wall_ms"] += r["decode_step_wall_ms"]
    for t in trees.values():
        for key in list(t):
            t[key + "_range"] = [min(t[key]), max(t[key])]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "runs": runs, "trees": trees}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
