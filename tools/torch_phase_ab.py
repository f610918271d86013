#!/usr/bin/env python3
"""Phases of ``chip_smoke.py`` from several checkouts in turn on one CUDA
card, so that two trees are compared within one call.

Run from the repository root on a machine with an NVIDIA card, with the
older tree unpacked beside it (``git archive <commit>`` into a directory
that ``.gitignore`` lists) and the roots ordered parent, change, change,
parent:

    python3 tools/torch_phase_ab.py _archive/parent . . _archive/parent \\
        --phases phase_kernels,phase_train_kernels,phase_gpt_d96
    python3 tools/torch_phase_ab.py _archive/parent . . _archive/parent \\
        --phases phase_serving,phase_serving

Each root runs in a process of its own: it builds that root's kernels and
calls each named phase function of that root's ``chip_smoke`` with its
seed. A name may list alternatives joined by ``|``
(``phase_gpt_d96|phase_cuda_core_route``): the first that the root's
script defines runs, for a phase renamed between the trees. Every JSON
line a run prints is written, with its root and turn, to ``--out``; the
last line of standard output is one JSON object with the card and, for
each run, its build seconds, the kernel rows' eager and graph-replay ms by
(kernel, case), the training phases' eager and graphed step ms, and the
serving lines' tokens/s, decode-step and TTFT figures. Exits non-zero
without a card or when a run fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# the numbers of a kernel row and of a serving line kept in the summary
ROW_KEYS = ("kernel_ms", "graph_ms", "cuda_core_ms", "library_ms")
SERVING_KEYS = ("tokens_per_s", "decode_step_ms_mean", "decode_steps",
                "prefill_ms_mean", "ttft_ms_p50", "ttft_ms_p99", "wall_s")


def _child(root: str, phases: str) -> int:
    """Build ``root``'s kernels and run its named phases (they print their
    own JSON lines)."""
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_phase_ab: no CUDA device", file=sys.stderr)
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
    for name in phases.split(","):
        fn = next((getattr(chip_smoke, n) for n in name.split("|")
                   if hasattr(chip_smoke, n)), None)
        if fn is None:
            raise RuntimeError(f"{root}/chip_smoke.py defines none of "
                               f"{name}")
        fn(chip_smoke.SEED)
    return 0


def _summary(lines):
    """Per (kernel, case) the row's times; per training phase the eager
    and graphed step ms; each serving line's figures, in order."""
    rows, steps, serving = {}, {}, []
    for ln in lines:
        if ln.get("phase") == "kernel" and "kernel_ms" in ln:
            rows[f"{ln['kernel']}[{ln['case']}]"] = {
                k: ln[k] for k in ROW_KEYS if ln.get(k) is not None}
        elif ln.get("phase") == "serving":
            serving.append({k: ln[k] for k in SERVING_KEYS})
        elif isinstance(ln.get("graph"), dict) and "step_ms" in ln["graph"]:
            steps[ln["phase"]] = {"graph_step_ms": ln["graph"]["step_ms"],
                                  "eager_step_ms": ln["eager"]["step_ms"]}
    return {"rows": rows, "steps": steps, "serving": serving}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", help="checkout roots, in run order")
    ap.add_argument("--phases", default="phase_kernels",
                    help="phase functions of chip_smoke.py, comma-joined")
    ap.add_argument("--out", default="chiprun_out/phase_ab.jsonl",
                    help="where every run's JSON lines are written")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return _child(os.path.abspath(args.child), args.phases)
    if not args.roots:
        ap.error("name at least one checkout root")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    runs = []
    with open(args.out, "w") as out:
        for turn, root in enumerate(args.roots):
            root = os.path.abspath(root)
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", root,
                 "--phases", args.phases],
                capture_output=True, text=True, cwd=root)
            lines = [json.loads(ln) for ln in res.stdout.splitlines()
                     if ln.startswith("{")]
            for ln in lines:
                out.write(json.dumps({"root": os.path.relpath(root),
                                      "turn": turn, **ln}) + "\n")
            if res.returncode != 0:
                sys.stderr.write(res.stderr[-4000:])
                print(json.dumps({"root": root, "rc": res.returncode}))
                return res.returncode or 1
            build = next(ln for ln in lines if ln.get("phase") == "build")
            runs.append({"root": os.path.relpath(root), "turn": turn,
                         "build_s": build["seconds"], **_summary(lines)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
