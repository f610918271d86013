#!/usr/bin/env python3
"""Tile shapes of the fp32 dQ kernel (``csrc/flash_bwd_dq_tf32x3.cu``,
3xTF32) timed on one CUDA card: the exploration behind its ``DqShape``.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/torch_dq_sweep.py

Each variant is the source with ``DqShape``'s two constants replaced (MT
m-tiles of 16 query rows a warp, KT keys a K / V tile), built by ``nvcc`` into
a directory of its own under ``paddle_tpu_torch/kernels/_build/``, called
through its C entry at the fp32 shapes the main paths give dQ (DiT-XL/2's
bh 512 x 256 x 256 at d 72, BERT-base's bh 384 x 128 x 128 at d 64, the
parity steps' causal 2048 at d 128, bh 64) and at d 96, checked against
the plain version (``flash_attention_bwd_dq_plain``, rtol 1e-4 + atol
1e-4) and timed eager and in CUDA-graph replay (``chip_smoke._time_ms`` /
``_graph_ms``). The package's own build is timed on the same inputs
(``package``). Prints one JSON object with each variant's ``ptxas``
register and spill lines; exits non-zero without a card.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCE = "flash_bwd_dq_tf32x3.cu"
SHAPE = ("  static constexpr int MT = DN == 9 ? 2 : 1;\n"
         "  static constexpr int KT = DN == 9 || DN == 16 ? 16 : 32;\n")
# name: (MT, KT)
VARIANTS = {"mt1_kt16": (1, 16), "mt1_kt32": (1, 32), "mt2_kt16": (2, 16),
            "mt2_kt32": (2, 32)}
# (label, bh, s, causal, d)
CASES = [("dit-d72", 512, 256, False, 72), ("bert-d64", 384, 128, False, 64),
         ("train-d128", 64, 2048, True, 128), ("causal-d96", 32, 2048, True,
                                                96)]


def _build_variants(build_root):
    """nvcc every variant's source in parallel; {name: (library, ptxas
    lines of the dQ kernel)}."""
    from paddle_tpu_torch.kernels import _build

    csrc = os.path.join(ROOT, "paddle_tpu_torch", "kernels", "csrc")
    nvcc = _build._nvcc()
    procs = {}
    for name, (mt, kt) in VARIANTS.items():
        d = os.path.join(build_root, name)
        os.makedirs(d)
        with open(os.path.join(csrc, SOURCE)) as f:
            text = f.read()
        if SHAPE not in text:
            raise RuntimeError(f"{SOURCE}: DqShape is not {SHAPE!r}")
        text = text.replace(SHAPE, (f"  static constexpr int MT = {mt};\n"
                                    f"  static constexpr int KT = {kt};\n"))
        src = os.path.join(d, SOURCE)
        with open(src, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build._COMPILE_FLAGS, "-shared", "-I", csrc, src, "-o",
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
                 and any("dq_tf32x3" in x for x in lines[max(0, i - 3):i])]
        libs[name] = (ctypes.CDLL(os.path.join(build_root, name, "lib.so")),
                      ptxas)
    return libs


def _sweep(libs, out):
    import importlib

    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build

    fa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for label, bh, s, causal, d in CASES:
        q, k, v, do = (torch.randn(bh, s, d, generator=gen, device=dev)
                       for _ in range(4))
        scale = d ** -0.5
        o, lse = fa.flash_attention_plain(q, k, v, 0, causal, scale)
        delta = (do * o).sum(-1)
        args = (lse, delta, 0, causal, scale)
        ref = fa.flash_attention_bwd_dq_plain(q, k, v, do, *args)
        del o
        row = {}

        def pkg():
            return fa.flash_attention_bwd_dq_tf32x3(q, k, v, do, *args)

        row["package"] = {"ms": cs._time_ms(pkg, 10),
                          "graph_ms": cs._graph_ms(pkg)}
        for name, (lib, _) in libs.items():
            fn = lib.pt_flash_attention_bwd_dq_tf32x3
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
            excess = ((dq - ref).abs() - (1e-4 * ref.abs() + 1e-4)).max()
            row[name] = {"max_abs_err": (dq - ref).abs().max().item(),
                         "within_tol": bool(excess.item() <= 0),
                         "ms": cs._time_ms(call, 10),
                         "graph_ms": cs._graph_ms(call)}
        out["cases"][label] = row
        del q, k, v, do, ref
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_dq_sweep: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {"device": torch.cuda.get_device_name(0), "card": smi,
           "variants": {n: list(v) for n, v in VARIANTS.items()},
           "cases": {}}
    build_root = os.path.join(ROOT, "paddle_tpu_torch", "kernels", "_build",
                              f"dq-sweep-{os.getpid()}")
    try:
        _build.library()
        libs = _build_variants(build_root)
        out["ptxas"] = {n: p for n, (_, p) in libs.items()}
        _sweep(libs, out)
    finally:
        shutil.rmtree(build_root, ignore_errors=True)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
