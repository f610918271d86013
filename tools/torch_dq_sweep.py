#!/usr/bin/env python3
"""Variants of a flash dQ kernel timed on one CUDA card: the exploration
behind the fp32 dQ's ``DqShape`` (``csrc/flash_bwd_dq_tf32x3.cu``, 3xTF32)
and the bf16 dQ's ring depth above head dim 128
(``csrc/flash_bwd_dq_sm90_wide.cu``).

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/torch_dq_sweep.py                    # the 3xTF32 dQ
    python3 tools/torch_dq_sweep.py --kernel sm90_wide # bf16, d 136-256

Each variant is the kernel's sources with one piece of text replaced
(3xTF32: ``DqShape``'s MT m-tiles of 16 query rows a warp and KT keys a
K / V tile; the wide bf16 dQ: ``kStages``, the K / V tiles in flight),
built by ``nvcc`` into a directory of its own under
``paddle_tpu_torch/kernels/_build/``, called through its C entry at the
shapes the main paths give dQ, checked against the plain version
(``flash_attention_bwd_dq_plain``: 3xTF32 within rtol 1e-4 + atol 1e-4,
bf16 within ``sm90_dq_bound``) and timed eager and in CUDA-graph replay
(``chip_smoke._time_ms`` / ``_graph_ms``). The package's own build is
timed on the same inputs (``package``). Prints one JSON object with each
variant's ``ptxas`` register and spill lines; exits non-zero without a
card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# what each kernel's variants replace, and where:
#   sources: the files built into a variant's library (the first is edited)
#   text: the piece of it a variant replaces; variants: {name: replacement}
#   cases: (label, bh, s, causal, d) at the shapes its main paths give it
KERNELS = {
    "tf32x3": {
        "sources": ["flash_bwd_dq_tf32x3.cu"],
        "entry": "pt_flash_attention_bwd_dq_tf32x3",
        "tag": "dq_tf32x3",
        "text": ("  static constexpr int MT = DN == 9 ? 2 : 1;\n"
                 "  static constexpr int KT = DN == 9 || DN == 16 ? 16 : "
                 "32;\n"),
        "variants": {
            f"mt{mt}_kt{kt}": (f"  static constexpr int MT = {mt};\n"
                               f"  static constexpr int KT = {kt};\n")
            for mt, kt in ((1, 16), (1, 32), (2, 16), (2, 32))},
        # DiT-XL/2, BERT-base, the parity steps' causal 2048 at d 128; d 96
        "cases": [("dit-d72", 512, 256, False, 72),
                  ("bert-d64", 384, 128, False, 64),
                  ("train-d128", 64, 2048, True, 128),
                  ("causal-d96", 32, 2048, True, 96)],
    },
    "sm90_wide": {
        "sources": ["flash_bwd_dq_sm90_wide.cu", "flash_bwd_dq_sm90.cu"],
        "entry": "pt_flash_attention_bwd_dq_sm90",
        "tag": "dq_sm90_wide",
        "text": "constexpr int kStages = 3;",
        "variants": {f"stages{n}": f"constexpr int kStages = {n};"
                     for n in (2, 3)},
        # the llama-d256 step's attention (Gemma 2B's 8 heads of 256, batch
        # 2), Gemma 7B's (16 heads, batch 1), d 136 and d 192 not causal
        "cases": [("llama-d256", 16, 2048, True, 256),
                  ("d136", 16, 2048, True, 136),
                  ("d192-full", 16, 1024, False, 192)],
    },
}


def _build_variants(kernel, build_root):
    """nvcc every variant's sources in parallel; {name: (library, ptxas
    lines of the kernel)}."""
    from paddle_tpu_torch.kernels import _build

    spec = KERNELS[kernel]
    csrc = os.path.join(ROOT, "paddle_tpu_torch", "kernels", "csrc")
    nvcc = _build._nvcc()
    procs = {}
    for name, replacement in spec["variants"].items():
        d = os.path.join(build_root, name)
        os.makedirs(d)
        first, *rest = spec["sources"]
        with open(os.path.join(csrc, first)) as f:
            text = f.read()
        if spec["text"] not in text:
            raise RuntimeError(f"{first}: no {spec['text']!r} to replace")
        src = os.path.join(d, first)
        with open(src, "w") as f:
            f.write(text.replace(spec["text"], replacement))
        procs[name] = subprocess.Popen(
            [nvcc, *_build._COMPILE_FLAGS, "-shared", "-I", csrc, src,
             *[os.path.join(csrc, r) for r in rest], "-o",
             os.path.join(d, "lib.so")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        lines = log.splitlines()
        ptxas = [re.sub(r"\s+", " ", ln.strip()) for i, ln in
                 enumerate(lines) if ("registers" in ln or "spill" in ln)
                 and any(spec["tag"] in x for x in lines[max(0, i - 3):i])]
        libs[name] = (ctypes.CDLL(os.path.join(build_root, name, "lib.so")),
                      ptxas)
    return libs


def _sweep(kernel, libs, out):
    import importlib

    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build

    fa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    spec = KERNELS[kernel]
    bf16 = kernel == "sm90_wide"
    wrapper = getattr(fa, "flash_attention_bwd_dq_" + kernel.split("_")[0])

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for label, bh, s, causal, d in spec["cases"]:
        q, k, v, do = (torch.randn(bh, s, d, generator=gen, device=dev)
                       for _ in range(4))
        if bf16:
            q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
        f32 = [t.float() for t in (q, k, v, do)]
        scale = d ** -0.5
        o, lse = fa.flash_attention_plain(*f32[:3], 0, causal, scale)
        delta = (f32[3] * o).sum(-1)
        args = (lse, delta, 0, causal, scale)
        ref = fa.flash_attention_bwd_dq_plain(*f32, *args)
        bound = (fa.sm90_dq_bound(*f32, *args, ref) if bf16
                 else 1e-4 * ref.abs() + 1e-4)
        del o, f32
        row = {}

        def pkg():
            return wrapper(q, k, v, do, *args)

        row["package"] = {"ms": cs._time_ms(pkg, 10),
                          "graph_ms": cs._graph_ms(pkg)}
        for name, (lib, _) in libs.items():
            fn = getattr(lib, spec["entry"])
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 +
                           [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            dq = torch.empty_like(q)

            def call(fn=fn, dq=dq):
                _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                do.data_ptr(), lse.data_ptr(),
                                delta.data_ptr(), dq.data_ptr(), bh, s, s, d,
                                0, int(causal), scale,
                                torch.cuda.current_stream().cuda_stream),
                             name)

            call()
            torch.cuda.synchronize()
            err = (dq.float() - ref).abs()
            row[name] = {"max_abs_err": err.max().item(),
                         "within_tol": bool((err - bound).max().item() <= 0),
                         "ms": cs._time_ms(call, 10),
                         "graph_ms": cs._graph_ms(call)}
        out["cases"][label] = row
        del q, k, v, do, ref, bound
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="tf32x3")
    kernel = ap.parse_args().kernel
    import torch

    if not torch.cuda.is_available():
        print("torch_dq_sweep: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {"device": torch.cuda.get_device_name(0), "card": smi,
           "kernel": kernel,
           "variants": {n: v for n, v in KERNELS[kernel]["variants"].items()},
           "cases": {}}
    build_root = os.path.join(ROOT, "paddle_tpu_torch", "kernels", "_build",
                              f"dq-sweep-{os.getpid()}")
    try:
        _build.library()
        libs = _build_variants(kernel, build_root)
        out["ptxas"] = {n: p for n, (_, p) in libs.items()}
        _sweep(kernel, libs, out)
    finally:
        shutil.rmtree(build_root, ignore_errors=True)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
