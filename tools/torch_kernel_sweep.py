#!/usr/bin/env python3
"""Variants of the port's MoE routing kernels and grids of its RMSNorm
backward, timed on one CUDA card (the exploration behind their designs).

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/torch_kernel_sweep.py

Routing: each variant is ``csrc/moe_dispatch.cu`` with a few source lines
replaced (the tensor-core instance's steps of x in flight, or the
CUDA-core instance forced, with its vectors a lane, tokens a warp and
resident blocks changed), built by ``nvcc`` into a directory of its own
under ``paddle_tpu_torch/kernels/_build/``, called through its C entry at
the MoE step's shape (x [8192, 1536] bf16, top-2 of 8 experts), checked
to route exactly as the package's kernel does, and timed eager and in
CUDA-graph replay (``chip_smoke._time_ms`` / ``_graph_ms``). The earlier
kernels (``pt_moe_route_earlier``) and a copy of x's bytes are timed on
the same inputs. RMSNorm backward: the package's kernels at 1, 2, 3, 4 and
6 blocks a SM at [8192, 2048] and [8192, 1536] bf16, beside the earlier
backward. Prints one JSON object; exits non-zero without a card.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# one bf16 instance's launch bounds, steps in flight and choice of kernel
_BOUNDS = "__launch_bounds__(kRouteWarps * 32, 2)"
_CUDA_CORES = {"if (e <= kMmaMostExperts &&": "if (false &&"}
# name: (source replacements, resident blocks a SM for the plan)
VARIANTS = {
    "tensor_cores": ({}, 2),
    "tensor_cores_ahead2": ({"kMmaAhead = 4;": "kMmaAhead = 2;"}, 2),
    "tensor_cores_ahead8": ({"kMmaAhead = 4;": "kMmaAhead = 8;"}, 2),
    "cuda_cores": (_CUDA_CORES, 2),
    "cuda_cores_nv8": ({**_CUDA_CORES, "kRouteNV = 4;": "kRouteNV = 8;"},
                       2),
    "cuda_cores_1_token_a_warp": ({**_CUDA_CORES,
                                   "kRouteTpw = 2;": "kRouteTpw = 1;"}, 2),
    "cuda_cores_1_block_a_sm": ({**_CUDA_CORES,
                                 _BOUNDS: _BOUNDS.replace("2)", "1)")}, 1),
    "cuda_cores_3_blocks_a_sm": ({**_CUDA_CORES,
                                  _BOUNDS: _BOUNDS.replace("2)", "3)")}, 3),
}


def _build_variants(build_root):
    """nvcc every variant's moe_dispatch.cu in parallel; {name: library}."""
    from paddle_tpu_torch.kernels import _build

    csrc = os.path.join(ROOT, "paddle_tpu_torch", "kernels", "csrc")
    nvcc = _build._nvcc()
    procs = {}
    for name, (swaps, _) in VARIANTS.items():
        d = os.path.join(build_root, name)
        shutil.copytree(csrc, d)
        src = os.path.join(d, "moe_dispatch.cu")
        with open(src) as f:
            text = f.read()
        for old, new in swaps.items():
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        with open(src, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build._COMPILE_FLAGS, "-shared", "-I", d, src, "-o",
             os.path.join(d, "lib.so")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(os.path.join(build_root, name, "lib.so"))
    return libs


def _route_sweep(libs, out):
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import moe_dispatch as md

    dev = torch.device("cuda", 0)
    sms = _build.sm_count(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n, h, e, k = 8192, 1536, 8, 2
    xt = torch.randn(n, h, generator=gen, device=dev).to(torch.bfloat16)
    wg = (0.3 * torch.randn(h, e, generator=gen, device=dev)).to(
        torch.bfloat16)
    ref = md.route(xt, wg, k)
    for name, (_, per_sm) in VARIANTS.items():
        fn = libs[name].pt_moe_route
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 +
                       [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        tokens = -(-n // (sms * per_sm))
        blocks = -(-n // tokens)
        outs = [torch.empty(n, k, device=dev),
                torch.empty(n, k, dtype=torch.int32, device=dev),
                torch.empty(n, k, dtype=torch.int32, device=dev),
                torch.empty(e, dtype=torch.int32, device=dev),
                torch.empty(e, device=dev), torch.empty(e, device=dev)]
        blk = torch.empty(3, blocks, e, dtype=torch.int32, device=dev)

        def call(fn=fn, tokens=tokens, outs=outs, blk=blk):
            _build.check(fn(xt.data_ptr(), wg.data_ptr(), n, h, e, k, tokens,
                            *[t.data_ptr() for t in outs], blk.data_ptr(), 1,
                            torch._C._cuda_getCurrentRawStream(0)), "route")

        call()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(outs[1:4], ref[1:4]))
        out["route"][name] = {
            "routes_alike": same,
            "gv_max_abs_diff": (outs[0] - ref[0]).abs().max().item(),
            "ms": cs._time_ms(call, 50), "graph_ms": cs._graph_ms(call)}
    earlier = cs._earlier_route(xt, wg, k)
    half = xt[:n // 2]
    buf = torch.empty_like(half)
    out["route"]["earlier"] = {"ms": cs._time_ms(earlier, 50),
                               "graph_ms": cs._graph_ms(earlier)}
    out["route"]["copy_of_x_bytes_graph_ms"] = cs._graph_ms(
        lambda: buf.copy_(half))


def _rmsnorm_sweep(out):
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    sms = _build.sm_count(dev)
    fn = _build.kernel("pt_rmsnorm_bwd", [ctypes.c_void_p] * 8 +
                       [ctypes.c_int] * 5 + [ctypes.c_void_p])
    for n, h, residual in ((8192, 2048, False), (8192, 2048, True),
                           (8192, 1536, False)):
        bf = dict(device=dev, dtype=torch.bfloat16)
        s, dy, dr = (torch.randn(n, h, **bf) for _ in range(3))
        w = torch.randn(h, **bf)
        rstd = torch.rand(n, device=dev)
        dx, dw = torch.empty_like(s), torch.empty(h, **bf)
        row = {}
        for per_sm in (1, 2, 3, 4, 6):
            part = torch.empty(sms * per_sm, h, device=dev)

            def call(part=part, blocks=sms * per_sm):
                _build.launch(fn, "pt_rmsnorm_bwd", dev, s.data_ptr(),
                              w.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
                              dr.data_ptr() if residual else None,
                              dx.data_ptr(), dw.data_ptr(), part.data_ptr(),
                              n, h, blocks, int(residual), 1)

            row[f"{per_sm}_blocks_a_sm"] = {"ms": cs._time_ms(call, 50),
                                            "graph_ms": cs._graph_ms(call)}
        earlier = cs._earlier_rms_bwd(s, w, rstd, dy, dr if residual else None)
        row["earlier"] = {"ms": cs._time_ms(earlier, 50),
                          "graph_ms": cs._graph_ms(earlier)}
        out["rms_norm_bwd"][f"{n}x{h}{'+residual' if residual else ''}"] = row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_sweep: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.kernels import _build

    out = {"device": torch.cuda.get_device_name(0), "route": {},
           "rms_norm_bwd": {}}
    build_root = os.path.join(ROOT, "paddle_tpu_torch", "kernels", "_build",
                              f"sweep-{os.getpid()}")
    try:
        _build.library()
        libs = _build_variants(build_root)
        _route_sweep(libs, out)
        _rmsnorm_sweep(out)
    finally:
        shutil.rmtree(build_root, ignore_errors=True)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
