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

On a CUDA tensor :func:`gmm` and :func:`tgmm` launch the hand-written
kernels (``csrc/grouped_matmul.cu``) or raise; on a CPU tensor they run
:func:`gmm_plain` and :func:`tgmm_plain`, loops over the groups of fp32
``torch.matmul``. ``group_sizes`` stays on the device: the kernels read it
there, so a step never waits for the host to learn the sizes (the plain
versions do read them on the host). The autograd Function looks the two
wrappers up by module attribute at call time.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["grouped_matmul", "gmm", "tgmm", "gmm_plain", "tgmm_plain",
           "MAX_GROUPS", "TILE_ROWS", "COUNTS", "COUNTS_DGRAD",
           "COUNTS_WGRAD"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUPS = 128  # the kernels scan the sizes in one block's shared memory
TILE_ROWS = 128   # rows of one group per forward/dgrad block
COUNTS = _build.Counts()        # forward
COUNTS_DGRAD = _build.Counts()  # d_lhs (transposed rhs)
COUNTS_WGRAD = _build.Counts()  # d_rhs


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


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _kernel_operands(name, a, b, group_sizes, widths):
    """What the kernels take: one device, float32 or bfloat16 operands of
    one dtype, ``widths`` (the k and n of the product) multiples of 8,
    1..128 groups; contiguous, 16-byte aligned operands and int32
    sizes."""
    for t in (b, group_sizes):
        if t.device != a.device:
            raise ValueError(f"{name}: tensor on {t.device}, lhs on "
                             f"{a.device}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 operands "
                        f"of one dtype, got {a.dtype} and {b.dtype}")
    g = group_sizes.shape[0]
    if not 1 <= g <= MAX_GROUPS:
        raise ValueError(f"{name} kernel takes 1..{MAX_GROUPS} groups, got "
                         f"{g}")
    if any(w % 8 for w in widths):
        raise ValueError(f"{name} kernel takes k and n that are multiples "
                         f"of 8, got {tuple(a.shape)} and {tuple(b.shape)}")

    def prep(t):
        t = t.contiguous()
        return t if t.data_ptr() % 16 == 0 else t.clone()

    return prep(a), prep(b), group_sizes.to(torch.int32).contiguous()


def gmm(lhs, rhs, group_sizes, trans_rhs=False):
    """Forward (or, with ``trans_rhs``, dgrad) product: the kernel on CUDA,
    the plain version on the CPU."""
    counts = COUNTS_DGRAD if trans_rhs else COUNTS
    if lhs.device.type == "cpu":
        counts.plain()
        return gmm_plain(lhs, rhs, group_sizes, trans_rhs)
    if lhs.device.type != "cuda":
        raise ValueError(f"unsupported device {lhs.device}")
    lhs, rhs, sizes = _kernel_operands("gmm", lhs, rhs, group_sizes,
                                       rhs.shape[1:])
    m, k = lhs.shape
    g = rhs.shape[0]
    n = rhs.shape[1] if trans_rhs else rhs.shape[2]
    out = torch.empty(m, n, dtype=lhs.dtype, device=lhs.device)
    fn = _build.kernel("pt_gmm", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
    with torch.cuda.device(lhs.device):
        err = fn(lhs.data_ptr(), rhs.data_ptr(), sizes.data_ptr(),
                 out.data_ptr(), m, k, n, g, int(bool(trans_rhs)),
                 _DTYPES[lhs.dtype], _stream(lhs))
    _build.check(err, "pt_gmm")
    counts.launched()
    return out


def tgmm(lhs, dout, group_sizes):
    """wgrad ``[g, k, n]``: the kernel on CUDA, the plain version on the
    CPU."""
    if lhs.device.type == "cpu":
        COUNTS_WGRAD.plain()
        return tgmm_plain(lhs, dout, group_sizes)
    if lhs.device.type != "cuda":
        raise ValueError(f"unsupported device {lhs.device}")
    lhs, dout, sizes = _kernel_operands("tgmm", lhs, dout, group_sizes,
                                        (lhs.shape[1], dout.shape[1]))
    m, k = lhs.shape
    n = dout.shape[1]
    g = sizes.shape[0]
    out = torch.empty(g, k, n, dtype=lhs.dtype, device=lhs.device)
    fn = _build.kernel("pt_tgmm", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
    with torch.cuda.device(lhs.device):
        err = fn(lhs.data_ptr(), dout.data_ptr(), sizes.data_ptr(),
                 out.data_ptr(), m, k, n, g, _DTYPES[lhs.dtype],
                 _stream(lhs))
    _build.check(err, "pt_tgmm")
    COUNTS_WGRAD.launched()
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
