"""RMSNorm and RMSNorm+residual, forward and backward.

Port of ``paddle_tpu/kernels/pallas/rmsnorm.py``:

- ``rms_norm(x, w, eps)``: ``y = x * rsqrt(mean(x^2) + eps) * w``;
- ``rms_norm_residual(x, res, w, eps) -> (y, s)``: ``s = x + res`` (in
  fp32, stored in x's dtype), ``y = norm(s) * w``; ``s`` is the new
  residual stream and carries its own cotangent.

Both are ``torch.autograd.Function`` s over ``[..., h]`` whose forward saves
``s`` (the input itself for the plain variant), ``w`` and the fp32 row
``rstd``, and whose backward is one kernel call: ``dx`` (``= dres``) and
``dw`` summed over rows. On a CUDA tensor the wrappers :func:`rms_norm_fwd`
and :func:`rms_norm_bwd` launch the hand-written kernels
(``csrc/rmsnorm.cu``) or raise; on a CPU tensor they run
:func:`rms_norm_fwd_plain` and :func:`rms_norm_bwd_plain`, the JAX
package's composed twin (``_fwd_composed``, ``_bwd_body``).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["rms_norm", "rms_norm_residual", "rms_norm_fwd", "rms_norm_bwd",
           "rms_norm_fwd_plain", "rms_norm_bwd_plain", "rms_norm_bwd_plan",
           "BWD_BLOCKS_PER_SM", "BWD_WARPS", "BWD_WIDEST", "BWD_COL_GROUPS",
           "COUNTS", "COUNTS_RESIDUAL", "COUNTS_BWD", "COUNTS_RESIDUAL_BWD"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the backward's plan (csrc/rmsnorm.cu): resident blocks per SM, each
# writing one fp32 dw partial row; warps (rows in flight) per block of the
# vector instances; their widest row; row groups of the column sum
BWD_BLOCKS_PER_SM = 2
BWD_WARPS = 4
BWD_WIDEST = 8192
BWD_COL_GROUPS = 16
COUNTS = _build.Counts()               # forward, plain variant
COUNTS_RESIDUAL = _build.Counts()      # forward, +residual
COUNTS_BWD = _build.Counts()           # backward, plain variant
COUNTS_RESIDUAL_BWD = _build.Counts()  # backward, +residual


def rms_norm_fwd_plain(x2, res2, w, eps):
    """[n, h] rows -> (y, s, rstd [n] fp32); ``res2`` None for the plain
    variant, whose ``s`` is ``x2`` itself."""
    s = x2.float() if res2 is None else x2.float() + res2.float()
    rstd = torch.rsqrt((s * s).mean(dim=-1, keepdim=True) + eps)
    y = (s * rstd * w.float()).to(x2.dtype)
    return y, (x2 if res2 is None else s.to(x2.dtype)), rstd[:, 0]


def rms_norm_bwd_plain(s, w, rstd, dy, dr):
    """-> (dx [n, h] in s's dtype, dw [h] in w's dtype); ``dr`` is the
    cotangent of the +residual variant's ``s`` output (None: plain)."""
    sf, dyf, r = s.float(), dy.float(), rstd[:, None]
    g = dyf * w.float()
    ds = r * (g - sf * (r * r) * (g * sf).mean(dim=-1, keepdim=True))
    if dr is not None:
        ds = ds + dr.float()
    dw = (dyf * sf * r).sum(dim=0)
    return ds.to(s.dtype), dw.to(w.dtype)


def rms_norm_bwd_plan(n, h, itemsize, sms, aligned=True):
    """(blocks, rows per block, instance) of the backward on ``n`` rows of
    ``h`` values of ``itemsize`` bytes on a card of ``sms`` SMs: the
    resident blocks (at most one a row, at least one), each a contiguous
    chunk of rows (the last shorter, or none) and one dw partial row; the
    instance is ``"vector"`` (rows of whole 16-byte vectors, at most 8 a
    lane), ``"looping"`` (wider, up to ``BWD_WIDEST``) or ``"scalar"``
    (the rest, and operands off a 16-byte boundary)."""
    blocks = max(1, min(n, sms * BWD_BLOCKS_PER_SM))
    rows = -(-n // blocks)
    vec = 16 // itemsize
    if h % vec or h > BWD_WIDEST or not aligned:
        return blocks, rows, "scalar"
    per_lane = -(-(h // vec) // 32)
    return blocks, rows, "vector" if per_lane <= 8 else "looping"


def _check(name, rows, w, rstd, others):
    """What the kernels assume: [n, h] rows, a [h] weight and any other
    [n, h] operand of one dtype (float32 or bfloat16), a [n] rstd, and one
    device for all."""
    n, h = rows.shape
    if rows.dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got "
                        f"{rows.dtype}")
    for t in [w] + others + ([] if rstd is None else [rstd]):
        if t.device != rows.device:
            raise ValueError(f"{name}: tensor on {t.device}, rows on "
                             f"{rows.device}")
    if tuple(w.shape) != (h,) or w.dtype != rows.dtype:
        raise ValueError(f"{name}: weight {tuple(w.shape)} {w.dtype} does "
                         f"not fit rows {tuple(rows.shape)} {rows.dtype}")
    for t in others:
        if t.shape != rows.shape or t.dtype != rows.dtype:
            raise ValueError(f"{name}: operand {tuple(t.shape)} {t.dtype} "
                             f"!= rows {tuple(rows.shape)} {rows.dtype}")
    if rstd is not None and tuple(rstd.shape) != (n,):
        raise ValueError(f"{name}: rstd {tuple(rstd.shape)} != ({n},)")


def rms_norm_fwd(x2, res2, w, eps):
    """Forward on [n, h] rows: the kernel on CUDA, the plain version on
    the CPU. Returns (y, s, rstd)."""
    counts = COUNTS if res2 is None else COUNTS_RESIDUAL
    if x2.device.type == "cpu":
        counts.plain()
        return rms_norm_fwd_plain(x2, res2, w, eps)
    if x2.device.type != "cuda":
        raise ValueError(f"unsupported device {x2.device}")
    _check("rms_norm", x2, w, None, [] if res2 is None else [res2])
    n, h = x2.shape
    x2, w = x2.contiguous(), w.contiguous()
    y = torch.empty_like(x2)
    rstd = torch.empty(n, dtype=torch.float32, device=x2.device)
    if res2 is None:
        res_p, s = None, x2
    else:
        res2 = res2.contiguous()
        s = torch.empty_like(x2)
        res_p = res2.data_ptr()
    fn = _build.kernel("pt_rmsnorm_fwd", [ctypes.c_void_p] * 6 +
                       [ctypes.c_int] * 2 + [ctypes.c_float] +
                       [ctypes.c_int] * 2 + [ctypes.c_void_p])
    _build.launch(fn, "pt_rmsnorm_fwd", x2.device, x2.data_ptr(), res_p,
                  w.data_ptr(), y.data_ptr(), s.data_ptr(), rstd.data_ptr(), n,
                  h, float(eps), int(res2 is not None), _DTYPES[x2.dtype])
    counts.launched()
    return y, s, rstd


def rms_norm_bwd(s, w, rstd, dy, dr):
    """Backward on [n, h] rows: the kernel on CUDA, the plain version on
    the CPU. Returns (dx, dw)."""
    counts = COUNTS_BWD if dr is None else COUNTS_RESIDUAL_BWD
    if s.device.type == "cpu":
        counts.plain()
        return rms_norm_bwd_plain(s, w, rstd, dy, dr)
    if s.device.type != "cuda":
        raise ValueError(f"unsupported device {s.device}")
    _check("rms_norm_bwd", s, w, rstd, [dy] + ([] if dr is None else [dr]))
    n, h = s.shape
    s, w, dy = s.contiguous(), w.contiguous(), dy.contiguous()
    rstd = rstd.float().contiguous()
    dr_p = None if dr is None else dr.contiguous().data_ptr()
    dx = torch.empty_like(s)
    dw = torch.empty(h, dtype=w.dtype, device=s.device)
    n_blocks = rms_norm_bwd_plan(n, h, s.element_size(),
                                 _build.sm_count(s.device))[0]
    part = torch.empty(n_blocks, h, dtype=torch.float32, device=s.device)
    fn = _build.kernel("pt_rmsnorm_bwd", [ctypes.c_void_p] * 8 +
                       [ctypes.c_int] * 5 + [ctypes.c_void_p])
    _build.launch(fn, "pt_rmsnorm_bwd", s.device, s.data_ptr(), w.data_ptr(),
                  rstd.data_ptr(), dy.data_ptr(), dr_p, dx.data_ptr(),
                  dw.data_ptr(), part.data_ptr(), n, h, n_blocks,
                  int(dr is not None), _DTYPES[s.dtype])
    counts.launched()
    return dx, dw


def _check_args(x, w, res=None):
    h = x.shape[-1]
    if w.dim() != 1 or w.shape[0] != h:
        raise ValueError(f"weight {tuple(w.shape)} does not fit rows of "
                         f"width {h}")
    if res is not None and res.shape != x.shape:
        raise ValueError(f"residual {tuple(res.shape)} != x "
                         f"{tuple(x.shape)}")
    if w.dtype != x.dtype or (res is not None and res.dtype != x.dtype):
        raise TypeError("x, the residual and the weight must share a dtype")


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        h = x.shape[-1]
        y, s, rstd = rms_norm_fwd(x.reshape(-1, h), None, w, eps)
        ctx.save_for_backward(s, w, rstd)
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        s, w, rstd = ctx.saved_tensors
        dx, dw = rms_norm_bwd(s, w, rstd, dy.reshape(s.shape), None)
        return dx.view(dy.shape), dw, None


class _RMSNormResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, res, w, eps):
        h = x.shape[-1]
        y, s, rstd = rms_norm_fwd(x.reshape(-1, h), res.reshape(-1, h), w,
                                  eps)
        ctx.save_for_backward(s, w, rstd)
        return y.view(x.shape), s.view(x.shape)

    @staticmethod
    def backward(ctx, dy, ds):
        s, w, rstd = ctx.saved_tensors
        dx, dw = rms_norm_bwd(s, w, rstd, dy.reshape(s.shape),
                              ds.reshape(s.shape))
        dx = dx.view(dy.shape)
        # the add fans the same gradient to both of its inputs
        return dx, dx, dw, None


def rms_norm(x, w, eps: float = 1e-6):
    """RMSNorm over the last axis of ``x`` [..., h] with weight ``w`` [h]."""
    _check_args(x, w)
    return _RMSNorm.apply(x, w, float(eps))


def rms_norm_residual(x, res, w, eps: float = 1e-6):
    """``s = x + res; y = rmsnorm(s) * w`` -> ``(y, s)``."""
    _check_args(x, w, res)
    return _RMSNormResidual.apply(x, res, w, float(eps))
