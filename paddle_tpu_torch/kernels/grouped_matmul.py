"""Grouped (ragged) matrix product: per-expert row blocks through one call.

Port of ``paddle_tpu/kernels/grouped_matmul.py``: ``grouped_matmul(lhs[m,
k], rhs[g, k, n], group_sizes[g]) -> [m, n]``, where rows
``[sum(sizes[:i]), sum(sizes[:i+1]))`` of ``lhs`` multiply ``rhs[i]``,
with fp32 accumulation and the result in ``lhs.dtype``. Rows past
``sum(sizes)`` give zeros, as ``jax.lax.ragged_dot`` does. It is a
``torch.autograd.Function`` whose backward is two kernel calls, as
megablox's VJP is on the TPU:

- dgrad ``d_lhs = d_out @ rhs[g]^T``: :func:`gmm` with ``trans_rhs``;
- wgrad ``d_rhs[g] = lhs[rows_g]^T @ d_out[rows_g]``: :func:`tgmm`
  (zeros for an empty group).

On a CUDA tensor :func:`gmm` and :func:`tgmm` launch a hand-written
kernel or raise, chosen by dtype in plain code (:func:`takes_sm90`): bf16
goes to the tensor-core kernels (``csrc/grouped_matmul_sm90.cu``,
:func:`gmm_sm90`, :func:`tgmm_sm90`), fp32 to the CUDA-core ones
(``csrc/grouped_matmul.cu``, :func:`gmm_cuda_core`,
:func:`tgmm_cuda_core`). On a CPU tensor they run :func:`gmm_plain` and
:func:`tgmm_plain`, loops over the groups of fp32 ``torch.matmul``.
``group_sizes`` stays on the device: the kernels read it there, so a step
never waits for the host to learn the sizes (the plain versions do read
them on the host). The autograd Function looks the two wrappers up by
module attribute at call time.

Each kernel counts its own launches: ``COUNTS`` / ``COUNTS_SM90``
(forward), ``COUNTS_DGRAD`` / ``COUNTS_DGRAD_SM90``, ``COUNTS_WGRAD`` /
``COUNTS_WGRAD_SM90``; CPU calls count as plain calls of the CUDA-core
counters. Products of bf16 values are exact in fp32 and neither kernel
rounds anything but its result, so both keep one tolerance.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["grouped_matmul", "gmm", "tgmm", "gmm_plain", "tgmm_plain",
           "gmm_sm90", "tgmm_sm90", "gmm_cuda_core", "tgmm_cuda_core",
           "takes_sm90", "MAX_GROUPS", "TILE_ROWS", "COUNTS", "COUNTS_DGRAD",
           "COUNTS_WGRAD", "COUNTS_SM90", "COUNTS_DGRAD_SM90",
           "COUNTS_WGRAD_SM90"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUPS = 128  # the kernels scan the sizes in one block's shared memory
TILE_ROWS = 128   # rows of one group per forward/dgrad block
COUNTS = _build.Counts()             # forward, CUDA cores
COUNTS_DGRAD = _build.Counts()       # d_lhs (transposed rhs), CUDA cores
COUNTS_WGRAD = _build.Counts()       # d_rhs, CUDA cores
COUNTS_SM90 = _build.Counts()        # forward, tensor cores
COUNTS_DGRAD_SM90 = _build.Counts()  # d_lhs, tensor cores
COUNTS_WGRAD_SM90 = _build.Counts()  # d_rhs, tensor cores


def _ranges(group_sizes, m):
    """(group, start, end) row ranges on the host, as the kernels derive
    them: negative sizes count as 0, ranges are clamped to [0, m)."""
    out, start = [], 0
    for g, size in enumerate(group_sizes.tolist()):
        end = min(start + max(int(size), 0), m)
        out.append((g, start, end))
        start = end
    return out


def gmm_plain(lhs, rhs, group_sizes, trans_rhs=False):
    """``lhs[m, k] @ rhs[g]`` per group (``rhs[g]^T`` with ``trans_rhs``,
    ``rhs`` then [g, n, k]) in fp32, returned in lhs's dtype."""
    n = rhs.shape[1] if trans_rhs else rhs.shape[2]
    out = torch.zeros(lhs.shape[0], n, dtype=torch.float32,
                      device=lhs.device)
    for g, start, end in _ranges(group_sizes, lhs.shape[0]):
        if end > start:
            w = rhs[g].float()
            out[start:end] = lhs[start:end].float() @ (w.t() if trans_rhs
                                                       else w)
    return out.to(lhs.dtype)


def tgmm_plain(lhs, dout, group_sizes):
    """``d_rhs[g] = lhs[rows_g]^T @ dout[rows_g]`` in fp32 -> [g, k, n] in
    lhs's dtype; zeros for an empty group."""
    g_count = group_sizes.shape[0]
    out = torch.zeros(g_count, lhs.shape[1], dout.shape[1],
                      dtype=torch.float32, device=lhs.device)
    for g, start, end in _ranges(group_sizes, lhs.shape[0]):
        if end > start:
            out[g] = lhs[start:end].float().t() @ dout[start:end].float()
    return out.to(lhs.dtype)


def takes_sm90(dtype) -> bool:
    """Whether a CUDA call goes to the tensor-core kernels: bf16 operands;
    fp32 stays on the CUDA-core kernels."""
    return dtype == torch.bfloat16


def _kernel_operands(name, a, b, group_sizes, widths, sm90):
    """What the kernels take: one device, float32 or bfloat16 operands of
    one dtype (bfloat16 only for the tensor-core kernels, ``sm90``),
    ``widths`` (the k and n of the product) multiples of 8, 1..128 groups,
    a CUDA device; contiguous, 16-byte aligned operands and int32 sizes."""
    for t in (b, group_sizes):
        if t.device != a.device:
            raise ValueError(f"{name}: tensor on {t.device}, lhs on "
                             f"{a.device}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 operands "
                        f"of one dtype, got {a.dtype} and {b.dtype}")
    if sm90 and not takes_sm90(a.dtype):
        raise TypeError(f"{name}: the tensor-core kernel takes bfloat16 "
                        f"operands, got {a.dtype}")
    g = group_sizes.shape[0]
    if not 1 <= g <= MAX_GROUPS:
        raise ValueError(f"{name} kernel takes 1..{MAX_GROUPS} groups, got "
                         f"{g}")
    if any(w % 8 for w in widths):
        raise ValueError(f"{name} kernel takes k and n that are multiples "
                         f"of 8, got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.device.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on CUDA tensors, got "
                         f"{a.device}")

    def prep(t):
        t = t.contiguous()
        return t if t.data_ptr() % 16 == 0 else t.clone()

    return prep(a), prep(b), group_sizes.to(torch.int32).contiguous()


def gmm(lhs, rhs, group_sizes, trans_rhs=False):
    """Forward (or, with ``trans_rhs``, dgrad) product: on CUDA the
    tensor-core kernel where :func:`takes_sm90`, else the CUDA-core kernel;
    the plain version on the CPU."""
    if lhs.device.type == "cpu":
        (COUNTS_DGRAD if trans_rhs else COUNTS).plain()
        return gmm_plain(lhs, rhs, group_sizes, trans_rhs)
    if takes_sm90(lhs.dtype):
        return gmm_sm90(lhs, rhs, group_sizes, trans_rhs)
    return gmm_cuda_core(lhs, rhs, group_sizes, trans_rhs)


def _gmm_launch(entry, lhs, rhs, group_sizes, trans_rhs, sm90):
    lhs, rhs, sizes = _kernel_operands(entry, lhs, rhs, group_sizes,
                                       rhs.shape[1:], sm90)
    m, k = lhs.shape
    g = rhs.shape[0]
    n = rhs.shape[1] if trans_rhs else rhs.shape[2]
    out = torch.empty(m, n, dtype=lhs.dtype, device=lhs.device)
    args = [lhs.data_ptr(), rhs.data_ptr(), sizes.data_ptr(), out.data_ptr(),
            m, k, n, g, int(bool(trans_rhs))]
    if not sm90:
        args.append(_DTYPES[lhs.dtype])
    fn = _build.kernel(entry, [ctypes.c_void_p] * 4 +
                       [ctypes.c_int] * (len(args) - 4) + [ctypes.c_void_p])
    _build.launch(fn, entry, lhs.device, *args)
    return out


def gmm_cuda_core(lhs, rhs, group_sizes, trans_rhs=False):
    """Forward or dgrad from the CUDA-core kernel
    (``csrc/grouped_matmul.cu``): fp32 or bf16."""
    out = _gmm_launch("pt_gmm", lhs, rhs, group_sizes, trans_rhs, False)
    (COUNTS_DGRAD if trans_rhs else COUNTS).launched()
    return out


def gmm_sm90(lhs, rhs, group_sizes, trans_rhs=False):
    """Forward or dgrad from the tensor-core kernel
    (``csrc/grouped_matmul_sm90.cu``): bf16."""
    out = _gmm_launch("pt_gmm_sm90", lhs, rhs, group_sizes, trans_rhs, True)
    (COUNTS_DGRAD_SM90 if trans_rhs else COUNTS_SM90).launched()
    return out


def tgmm(lhs, dout, group_sizes):
    """wgrad ``[g, k, n]``: on CUDA the tensor-core kernel where
    :func:`takes_sm90`, else the CUDA-core kernel; the plain version on the
    CPU."""
    if lhs.device.type == "cpu":
        COUNTS_WGRAD.plain()
        return tgmm_plain(lhs, dout, group_sizes)
    if takes_sm90(lhs.dtype):
        return tgmm_sm90(lhs, dout, group_sizes)
    return tgmm_cuda_core(lhs, dout, group_sizes)


def _tgmm_launch(entry, lhs, dout, group_sizes, sm90):
    lhs, dout, sizes = _kernel_operands(entry, lhs, dout, group_sizes,
                                        (lhs.shape[1], dout.shape[1]), sm90)
    m, k = lhs.shape
    n = dout.shape[1]
    g = sizes.shape[0]
    out = torch.empty(g, k, n, dtype=lhs.dtype, device=lhs.device)
    args = [lhs.data_ptr(), dout.data_ptr(), sizes.data_ptr(),
            out.data_ptr(), m, k, n, g]
    if not sm90:
        args.append(_DTYPES[lhs.dtype])
    fn = _build.kernel(entry, [ctypes.c_void_p] * 4 +
                       [ctypes.c_int] * (len(args) - 4) + [ctypes.c_void_p])
    _build.launch(fn, entry, lhs.device, *args)
    return out


def tgmm_cuda_core(lhs, dout, group_sizes):
    """wgrad from the CUDA-core kernel (``csrc/grouped_matmul.cu``): fp32
    or bf16."""
    out = _tgmm_launch("pt_tgmm", lhs, dout, group_sizes, False)
    COUNTS_WGRAD.launched()
    return out


def tgmm_sm90(lhs, dout, group_sizes):
    """wgrad from the tensor-core kernel (``csrc/grouped_matmul_sm90.cu``):
    bf16."""
    out = _tgmm_launch("pt_tgmm_sm90", lhs, dout, group_sizes, True)
    COUNTS_WGRAD_SM90.launched()
    return out


class _GroupedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        return gmm(lhs, rhs, group_sizes)

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs, group_sizes = ctx.saved_tensors
        dout = dout.to(lhs.dtype)
        d_lhs = d_rhs = None
        if ctx.needs_input_grad[0]:
            d_lhs = gmm(dout, rhs, group_sizes, trans_rhs=True)
        if ctx.needs_input_grad[1]:
            d_rhs = tgmm(lhs, dout, group_sizes)
        return d_lhs, d_rhs, None


def grouped_matmul(lhs, rhs, group_sizes):
    """``lhs[m, k] @ rhs[g, k, n]`` per contiguous row group -> [m, n] in
    lhs's dtype (fp32 accumulation); differentiable in lhs and rhs."""
    if lhs.dim() != 2 or rhs.dim() != 3 or rhs.shape[1] != lhs.shape[1] \
            or group_sizes.dim() != 1 or group_sizes.shape[0] != rhs.shape[0]:
        raise ValueError(f"grouped_matmul: lhs {tuple(lhs.shape)}, rhs "
                         f"{tuple(rhs.shape)}, group_sizes "
                         f"{tuple(group_sizes.shape)} do not fit")
    if rhs.dtype != lhs.dtype:
        raise TypeError(f"grouped_matmul: lhs {lhs.dtype} and rhs "
                        f"{rhs.dtype} differ")
    if group_sizes.is_floating_point():
        raise TypeError("grouped_matmul: group_sizes must be integers")
    return _GroupedMatmul.apply(lhs, rhs, group_sizes)
