"""Flash attention with per-row log-sum-exp, forward and backward.

Port of ``paddle_tpu/kernels/flash_attention.py``:
``flash_attention_with_lse`` over ``[bh, s, d]`` and ``flash_attention``
over the paddle layout ``[b, s, h, d]``. ``offset`` shifts q's global
positions for the causal mask and ``lse`` is returned, as ring attention
needs both. ``flash_attention_with_lse`` is a ``torch.autograd.Function``:
it saves q, k, v, o and lse and takes the cotangents of both o and lse,
folded into ``delta = rowsum(dO * O) - dlse`` (plain PyTorch, as in the JAX
``_flash_bwd``), which the two backward kernels read.

Each kernel has a wrapper that launches it on a CUDA tensor or raises, and
runs its plain version on a CPU tensor:

- :func:`flash_attention_fwd` / :func:`flash_attention_plain`. On CUDA it
  takes one of four kernels by (dtype, head dim, sq), which :func:`route`
  picks in plain code: a single query row in fp32 or bf16 whose head dim
  (up to 256) is whole 16-byte chunks goes to the split-K decode kernel
  (``csrc/flash_decode.cu``, :func:`flash_decode`, whose plain version
  :func:`flash_decode_plain` computes the same split plan, partials and
  merge); bf16 with a head dim that is a multiple of 8 up to 256 and more
  than one query row to the tensor-core kernel
  (``csrc/flash_fwd_sm90.cu``, whose head dims above 128 are the 64-key
  tiles of ``csrc/flash_fwd_sm90_wide.cu``;
  :func:`flash_attention_fwd_sm90`); fp32 with a head dim that is a
  multiple of 8 up to 128 to the fp32 tensor-core kernel
  (``csrc/flash_fwd_tf32x3.cu``, :func:`flash_attention_fwd_tf32x3`: three
  TF32 products a product, fp32 accuracy); everything else (other head
  dims) to the CUDA-core kernel (``csrc/flash_attention.cu``,
  :func:`flash_attention_fwd_cuda_core`);
- :func:`flash_attention_bwd_dkv` / :func:`flash_attention_bwd_dkv_plain`,
  likewise: bf16 where :func:`takes_sm90` (a head dim that is a multiple
  of 8 up to 256) goes to ``csrc/flash_bwd_dkv_sm90.cu`` (above 128
  ``csrc/flash_bwd_dkv_sm90_wide.cu``; :func:`flash_attention_bwd_dkv_sm90`),
  fp32 where :func:`takes_tf32x3` (up to 128) to
  ``csrc/flash_bwd_dkv_tf32x3.cu`` (:func:`flash_attention_bwd_dkv_tf32x3`),
  the rest to ``csrc/flash_attention_bwd.cu``
  (:func:`flash_attention_bwd_dkv_cuda_core`);
- :func:`flash_attention_bwd_dq` / :func:`flash_attention_bwd_dq_plain`,
  by the same rules: bf16 where :func:`takes_sm90` goes to
  ``csrc/flash_bwd_dq_sm90.cu`` (above 128 the 32-key tiles of
  ``csrc/flash_bwd_dq_sm90_wide.cu``; :func:`flash_attention_bwd_dq_sm90`),
  fp32 where :func:`takes_tf32x3` to ``csrc/flash_bwd_dq_tf32x3.cu``
  (:func:`flash_attention_bwd_dq_tf32x3`), the rest (d % 8 != 0, fp32
  d > 128) to ``csrc/flash_attention_bwd.cu``
  (:func:`flash_attention_bwd_dq_cuda_core`).

Each kernel counts its own launches (``COUNTS`` / ``COUNTS_SM90`` /
``COUNTS_TF32X3`` / ``COUNTS_DECODE`` for the forward, ``COUNTS_DKV`` /
``COUNTS_DKV_SM90`` / ``COUNTS_DKV_TF32X3`` for dK/dV, ``COUNTS_DQ`` /
``COUNTS_DQ_SM90`` / ``COUNTS_DQ_TF32X3`` for dQ), so a run shows which one
ran; CPU calls count as plain calls of the dispatching wrapper's CUDA-core
counter, and :func:`flash_decode`'s own as plain calls of
``COUNTS_DECODE``.

:func:`flash_attention` (paddle layout) sends a single query row that
needs no gradient straight to :func:`flash_decode`, which reads q, k and v
through their strides where they lie: a KV-cached decode step copies
nothing into ``[bh, s, d]``.

The backward plain versions are the explicit formulas of the JAX kernels
(``_bwd_dkv_kernel``, ``_bwd_dq_kernel``) over the dense score matrix.

The tensor-core kernels round P (forward and dV) and dS (dK, dQ) to bf16
as the A operands of their products, where the plain versions keep fp32.
:func:`sm90_fwd_bound`, :func:`sm90_dkv_bound` and :func:`sm90_dq_bound`
give the elementwise error bound that this rounding allows against the
fp32 plain version.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_with_lse",
           "flash_attention_fwd", "flash_attention_plain",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_plain",
           "flash_attention_bwd_dq", "flash_attention_bwd_dq_plain",
           "flash_attention_fwd_sm90", "flash_attention_fwd_cuda_core",
           "flash_attention_bwd_dkv_sm90",
           "flash_attention_bwd_dkv_cuda_core",
           "flash_attention_bwd_dq_sm90", "flash_attention_bwd_dq_cuda_core",
           "flash_attention_fwd_tf32x3", "flash_attention_bwd_dkv_tf32x3",
           "flash_attention_bwd_dq_tf32x3",
           "flash_decode", "flash_decode_plain", "decode_plan",
           "merge_partials_plain", "route", "takes_sm90", "takes_tf32x3",
           "sm90_fwd_bound", "sm90_dkv_bound", "sm90_dq_bound", "COUNTS",
           "COUNTS_SM90", "COUNTS_TF32X3", "COUNTS_DECODE", "COUNTS_DKV",
           "COUNTS_DKV_SM90", "COUNTS_DKV_TF32X3", "COUNTS_DQ",
           "COUNTS_DQ_SM90", "COUNTS_DQ_TF32X3"]

_NEG = -1e30
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the head dims of the tensor-core kernels, multiples of 8: the least, the
# most of the fp32 kernels, and the most of the bf16 ones
_TC_HEAD_DIMS = (8, 128)
_SM90_WIDEST = 256
# the decode kernel's split plan: about 2 blocks per SM, and at least 32
# keys a split (the keys a block folds per turn at bf16 head dim 128: 8
# side by side, 4 deep); the plain version plans for an H100's 132 SMs
_DECODE_BLOCKS_PER_SM = 2
_DECODE_SPLIT_KEYS = 32
_H100_SMS = 132
COUNTS = _build.Counts()           # forward, CUDA cores
COUNTS_SM90 = _build.Counts()      # forward, tensor cores
COUNTS_TF32X3 = _build.Counts()    # forward, fp32 on the tensor cores
COUNTS_DECODE = _build.Counts()    # forward, one row, split-K (+ its merge)
COUNTS_DKV = _build.Counts()       # backward dK/dV, CUDA cores
COUNTS_DKV_SM90 = _build.Counts()  # backward dK/dV, tensor cores
COUNTS_DKV_TF32X3 = _build.Counts()  # backward dK/dV, fp32, tensor cores
COUNTS_DQ = _build.Counts()        # backward dQ, CUDA cores
COUNTS_DQ_SM90 = _build.Counts()   # backward dQ, tensor cores
COUNTS_DQ_TF32X3 = _build.Counts()  # backward dQ, fp32, tensor cores


def _mask(sq, sk, offset, causal, device):
    """[sq, sk] visibility: key j is visible to row i iff j <= i + offset
    under ``causal``, always otherwise."""
    if not causal:
        return torch.ones(sq, sk, dtype=torch.bool, device=device)
    qpos = torch.arange(sq, device=device)[:, None] + int(offset)
    return torch.arange(sk, device=device)[None, :] <= qpos


def flash_attention_plain(q, k, v, offset, causal, scale):
    """Dense attention (the JAX ``_sdpa_xla`` math) plus the lse. A row
    that sees no key gives o = 0 and lse = -1e30, as the TPU kernel
    does."""
    mask = _mask(q.shape[1], k.shape[1], offset, causal, q.device)
    logits = torch.einsum("bqd,bkd->bqk", q, k).float() * scale
    logits = torch.where(mask, logits, _NEG)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bqk,bkd->bqd", (p / l).to(q.dtype), v)
    return o, (m + torch.log(l))[..., 0]


def _probs_plain(q, k, lse, offset, causal, scale):
    """p = exp(scale * q.k - lse) on visible pairs, exactly 0 elsewhere
    (fp32 [bh, sq, sk]); with ``lse`` None, the row's own log-sum-exp (the
    normalised probabilities)."""
    mask = _mask(q.shape[1], k.shape[1], offset, causal, q.device)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if lse is None:
        lse = torch.where(mask, s, _NEG).logsumexp(dim=-1)
    return torch.where(mask, torch.exp(s - lse[..., None]), 0.0)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, offset, causal,
                                  scale):
    """dK, dV of the JAX ``_bwd_dkv_kernel`` over the dense scores, fp32,
    returned in k's and v's dtype."""
    p = _probs_plain(q, k, lse, offset, causal, scale)
    dof = do.float()
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, v.float())
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, offset, causal,
                                 scale):
    """dQ of the JAX ``_bwd_dq_kernel`` over the dense scores, fp32,
    returned in q's dtype."""
    p = _probs_plain(q, k, lse, offset, causal, scale)
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * scale
    return torch.einsum("bqk,bkd->bqd", ds, k.float()).to(q.dtype)


def _tc_head_dim(head_dim, widest=_TC_HEAD_DIMS[1]) -> bool:
    """A head dim the tensor-core kernels take: a multiple of 8 from 8 to
    ``widest``."""
    return head_dim % 8 == 0 and _TC_HEAD_DIMS[0] <= head_dim <= widest


def takes_sm90(dtype, head_dim, sq=None) -> bool:
    """Whether a CUDA call goes to the bf16 tensor-core kernels: bf16, a
    head dim that is a multiple of 8 from 8 to 256, and (forward, ``sq``
    given) more than one query row; a single-row decode reads each key once
    and is bound by bytes, which the split-K decode kernel serves
    (:func:`route`). The backward (dK/dV and dQ) asks without ``sq``."""
    return (dtype == torch.bfloat16 and _tc_head_dim(head_dim, _SM90_WIDEST)
            and (sq is None or sq > 1))


def takes_tf32x3(dtype, head_dim, sq=None) -> bool:
    """Whether a CUDA call goes to the fp32 tensor-core kernels (3xTF32):
    fp32, a head dim that is a multiple of 8 from 8 to 128, and (forward,
    ``sq`` given) more than one query row. The backward (dK/dV and dQ)
    asks without ``sq``."""
    return (dtype == torch.float32 and _tc_head_dim(head_dim)
            and (sq is None or sq > 1))


def route(dtype, head_dim, sq) -> str:
    """Which forward kernel a CUDA call goes to: ``"decode"`` for one query
    row in fp32 or bf16 with head dim up to 256 whose rows are whole
    16-byte chunks, ``"sm90"`` where :func:`takes_sm90`, ``"tf32x3"``
    where :func:`takes_tf32x3`, ``"cuda_core"`` for the rest (whose kernel
    raises on a dtype or head dim it does not take)."""
    if sq == 1 and dtype in _DTYPES and head_dim <= 256 and \
            head_dim * dtype.itemsize % 16 == 0:
        return "decode"
    if takes_sm90(dtype, head_dim, sq):
        return "sm90"
    if takes_tf32x3(dtype, head_dim, sq):
        return "tf32x3"
    return "cuda_core"


def _visible_keys(sk, offset, causal):
    """Keys one query row at global position ``offset`` sees: the first
    ``offset + 1`` (none below 0) under ``causal``, all ``sk`` otherwise."""
    return max(0, min(sk, int(offset) + 1)) if causal else sk


def decode_plan(bh, n_keys, sms):
    """(n_split, split_len) of the decode kernel for ``bh`` rows that see
    ``n_keys`` keys on a card of ``sms`` SMs, from shapes alone: about 2
    blocks per SM, splits of at least 32 keys and a multiple of 32, and
    split i owning keys ``[i * split_len, (i + 1) * split_len)``; at least
    one split, which for ``n_keys`` 0 owns no key."""
    want = -(-_DECODE_BLOCKS_PER_SM * sms // max(bh, 1))
    per = -(-n_keys // want)
    split_len = max(1, -(-per // _DECODE_SPLIT_KEYS)) * _DECODE_SPLIT_KEYS
    return max(1, -(-n_keys // split_len)), split_len


def merge_partials_plain(o, m, l, dtype):
    """The split-K decode kernels' merge (``csrc/decode_common.cuh``) in
    PyTorch, over the splits in their fixed order: ``o`` [S, nh, n_split,
    hd] partial sums, ``m`` (log2 units) and ``l`` [S, nh, n_split]; M =
    max m_i, out = sum o_i exp2(m_i - M) / sum l_i exp2(m_i - M), and 0
    where that sum is 0 (a row that saw no key). Returns [S, 1, nh, hd] in
    ``dtype``."""
    M = m.amax(dim=-1, keepdim=True)
    c = torch.exp2(m - M)
    L = (l * c).sum(dim=-1)
    A = (o * c[..., None]).sum(dim=-2)
    out = torch.where(L[..., None] > 0, A / L.clamp_min(1e-30)[..., None],
                      0.0)
    return out[:, None].to(dtype)


def flash_decode_plain(q, k, v, offset, causal, scale, n_split=None,
                       split_len=None):
    """The decode kernel's two passes in PyTorch, paddle layout: ``q`` [b,
    1, h, d], ``k``/``v`` [b, sk, h, d] -> (o [b, 1, h, d] in q's dtype,
    lse [b, h] fp32). The keys a row sees are cut into the splits of
    :func:`decode_plan` (for an H100, unless ``n_split`` and ``split_len``
    are given); each split's partial (o, m, l in log2 units) is taken over
    its own keys, a split that owns none giving m = -1e30 and l = 0, and
    :func:`merge_partials_plain` merges them. lse = (M + log2 L) ln 2, and
    a row that sees no key gives o = 0 and lse = -1e30."""
    b, _one, h, d = q.shape
    sk = k.shape[1]
    n = _visible_keys(sk, offset, causal)
    if n_split is None:
        n_split, split_len = decode_plan(b * h, n, _H100_SMS)
    if n_split * split_len < n:
        raise ValueError(f"{n_split} splits of {split_len} keys do not cover "
                         f"{n} visible keys")
    s = torch.einsum("bhd,bkhd->bhk", q[:, 0].float(), k.float()) * \
        (scale * _LOG2E)
    j = torch.arange(sk, device=q.device)
    first = torch.arange(n_split, device=q.device)[:, None] * split_len
    own = (j >= first) & (j < torch.clamp(first + split_len, max=n))
    s = torch.where(own, s[:, :, None, :], _NEG)        # [b, h, n_split, sk]
    m = s.amax(dim=-1)
    p = torch.where(own, torch.exp2(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhnk,bkhd->bhnd", p, v.float())
    M = m.amax(dim=-1)
    L = (l * torch.exp2(m - M[..., None])).sum(dim=-1)
    lse = torch.where(L > 0, (M + torch.log2(L.clamp_min(1e-30))) * _LN2,
                      _NEG)
    return merge_partials_plain(o, m, l, q.dtype), lse


def sm90_fwd_bound(q, k, v, offset, causal, scale, o_ref):
    """Elementwise bound of |o - o_ref| for the tensor-core forward against
    the fp32 plain version ``o_ref`` on the same (fp32) inputs:
    ``2**-8 |o_ref| + 2**-8 (P |V|) + 1e-4``. The kernel rounds its result to
    bf16 once (half an ulp, 2**-9 of the value) and rounds each normalised
    probability to bf16 before P.V (2**-9 of each term of P |V|); each term
    gets twice its worst case, plus fp32 summation order."""
    p = _probs_plain(q, k, None, offset, causal, scale)
    return (2.0 ** -8 * o_ref.abs()
            + 2.0 ** -8 * torch.einsum("bqk,bkd->bqd", p, v.float().abs())
            + 1e-4)


def sm90_dkv_bound(q, k, v, do, lse, delta, offset, causal, scale, dk_ref,
                   dv_ref):
    """Elementwise bounds (dK, dV) for the tensor-core dK/dV kernel against
    the fp32 plain version (``dk_ref``, ``dv_ref``) on the same inputs:
    ``2**-8 |dK| + 2**-8 (|dS^T| |Q|) + 1e-4`` and ``2**-8 |dV| + 2**-8
    (P^T |dO|) + 1e-4``: one bf16 rounding of each result, and one of each
    p and ds before its product, each term at twice its worst case."""
    p = _probs_plain(q, k, lse, offset, causal, scale)
    dof = do.float()
    dp = torch.einsum("bqd,bkd->bqk", dof, v.float())
    ds = (p * (dp - delta[..., None]) * scale).abs()
    bdk = (2.0 ** -8 * dk_ref.abs()
           + 2.0 ** -8 * torch.einsum("bqk,bqd->bkd", ds, q.float().abs())
           + 1e-4)
    bdv = (2.0 ** -8 * dv_ref.abs()
           + 2.0 ** -8 * torch.einsum("bqk,bqd->bkd", p, dof.abs()) + 1e-4)
    return bdk, bdv


def sm90_dq_bound(q, k, v, do, lse, delta, offset, causal, scale, dq_ref):
    """Elementwise bound of |dQ - dq_ref| for the tensor-core dQ kernel
    against the fp32 plain version ``dq_ref`` on the same inputs:
    ``2**-8 |dQ| + 2**-8 (|dS| |K|) + 1e-4``: one bf16 rounding of the
    result, and one of each ds before dS.K, each at twice its worst case."""
    p = _probs_plain(q, k, lse, offset, causal, scale)
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    ds = (p * (dp - delta[..., None]) * scale).abs()
    return (2.0 ** -8 * dq_ref.abs()
            + 2.0 ** -8 * torch.einsum("bqk,bkd->bqd", ds, k.float().abs())
            + 1e-4)


def delta_error_bound(q, k, lse, d_delta, offset, causal, scale):
    """Elementwise bounds (dQ, dK) of how far the backward moves when its
    ``delta = rowsum(dO * O)`` is off by ``d_delta`` (taken from an O other
    than the reference's): dS moves by ``-P d_delta scale``, so dQ by at
    most ``scale |d_delta| (P |K|)`` and dK by at most ``scale P^T
    (|d_delta| |Q|)``; dV does not read delta. Each is given with its
    share of the ``sm90_*_bound`` rounding term of dS (``2**-8`` of it)."""
    p = _probs_plain(q, k, lse, offset, causal, scale)
    dd = d_delta.float().abs()[..., None]
    grow = (1.0 + 2.0 ** -8) * scale
    return (grow * dd * torch.einsum("bqk,bkd->bqd", p, k.float().abs()),
            grow * torch.einsum("bqk,bqd->bkd", p, dd * q.float().abs()))


def _check_kernel_inputs(name, q, tensors):
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name}: tensor on {t.device}, q on "
                             f"{q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.shape[2] > 256:
        raise ValueError(f"{name} kernel takes head_dim <= 256, got "
                         f"{q.shape[2]}")


def _on_cuda(name, q):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on CUDA tensors, got "
                         f"{q.device}")


def _tma_ready(t):
    """t contiguous with a 16-byte aligned start, as TMA and cp.async read
    it."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fwd_inputs(name, q, k, v):
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 or \
            k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2] or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q {tuple(q.shape)} {q.dtype}, k "
                         f"{tuple(k.shape)} {k.dtype}, v {tuple(v.shape)} "
                         f"{v.dtype} do not fit")
    _check_kernel_inputs(name, q, (k, v))


def _check_tf32x3(name, q, sq=None):
    if not takes_tf32x3(q.dtype, q.shape[2], sq):
        raise ValueError(f"{name}: the fp32 tensor-core kernel takes float32 "
                         f"with head_dim a multiple of 8 in "
                         f"[{_TC_HEAD_DIMS[0]}, {_TC_HEAD_DIMS[1]}]"
                         + ("" if sq is None else " and sq > 1") +
                         f", got {q.dtype} head_dim {q.shape[2]} sq "
                         f"{q.shape[1]}")


def _check_sm90(name, q):
    if not takes_sm90(q.dtype, q.shape[2]):
        raise ValueError(f"{name}: the tensor-core kernel takes bfloat16 "
                         f"with head_dim a multiple of 8 in "
                         f"[{_TC_HEAD_DIMS[0]}, {_SM90_WIDEST}], got "
                         f"{q.dtype} head_dim {q.shape[2]}")


def flash_attention_fwd(q, k, v, offset, causal, scale):
    """(o, lse): on CUDA the kernel :func:`route` names (the decode kernel
    on [bh, 1, 1, d] views of the [bh, s, d] inputs); the plain version on
    the CPU."""
    if q.device.type == "cpu":
        COUNTS.plain()
        return flash_attention_plain(q, k, v, offset, causal, scale)
    which = route(q.dtype, q.shape[2], q.shape[1])
    if which == "decode":
        o, lse = flash_decode(q[:, :, None], k[:, :, None], v[:, :, None],
                              offset, causal, scale)
        return o.view(q.shape), lse.view(q.shape[:2])
    if which == "sm90":
        return flash_attention_fwd_sm90(q, k, v, offset, causal, scale)
    if which == "tf32x3":
        return flash_attention_fwd_tf32x3(q, k, v, offset, causal, scale)
    return flash_attention_fwd_cuda_core(q, k, v, offset, causal, scale)


def _in_place(t):
    """``t`` [b, s, h, d] as the decode kernel reads it: the head dim
    contiguous, and the start and every other stride a multiple of 16
    bytes (a decode step's q, a view into its fused QKV projection, and
    its cache are such tensors); anything else is copied. The checks are
    few because this runs once per tensor on every decode step."""
    step = 16 // t.element_size()
    st = t.stride()
    if st[3] == 1 and t.data_ptr() % 16 == 0 and not (
            st[0] % step or st[1] % step or st[2] % step):
        return t
    return _tma_ready(t)


def flash_decode(q, k, v, offset, causal, scale, with_lse=True):
    """One query row per (batch, head), paddle layout: ``q`` [b, 1, h, d],
    ``k``/``v`` [b, sk, h, d] -> (o [b, 1, h, d] in q's dtype, lse [b, h]
    fp32, or None without ``with_lse``). Under ``causal`` key j is visible
    iff j <= ``offset``. On CUDA the split-K decode kernel and its merge
    (``csrc/flash_decode.cu``), reading q, k and v through their strides
    (copied only where a start or stride is not a multiple of 16 bytes),
    with the split plan of :func:`decode_plan` and one fp32 scratch tensor
    for the partials; the plain version on the CPU."""
    if q.device.type == "cpu":
        COUNTS_DECODE.plain()
        o, lse = flash_decode_plain(q, k, v, offset, causal, scale)
        return o, (lse if with_lse else None)
    _on_cuda("flash_attention_decode", q)
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or \
            v.shape != k.shape or k.shape[0] != q.shape[0] or \
            k.shape[2:] != q.shape[2:] or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"flash_attention_decode: q {tuple(q.shape)} "
                         f"{q.dtype}, k {tuple(k.shape)} {k.dtype}, v "
                         f"{tuple(v.shape)} {v.dtype} do not fit")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention_decode: k on {k.device}, v on "
                         f"{v.device}, q on {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention_decode kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    b, _one, h, d = q.shape
    if route(q.dtype, d, 1) != "decode":
        raise ValueError(f"flash_attention_decode takes head_dim up to 256 "
                         f"in whole 16-byte chunks, got {d} in {q.dtype}")
    q, k, v = _in_place(q), _in_place(k), _in_place(v)
    n = _visible_keys(k.shape[1], offset, causal)
    n_split, split_len = decode_plan(b * h, n, _build.sm_count(q.device))
    o = torch.empty(b, 1, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, dtype=torch.float32, device=q.device) \
        if with_lse else None
    # [bh, n_split, d] partial o, then [bh, n_split, 2] (m, l)
    n_o = b * h * n_split * d
    part = torch.empty(n_o + 2 * b * h * n_split, dtype=torch.float32,
                       device=q.device)
    fn = _build.kernel("pt_flash_decode", [ctypes.c_void_p] * 7 +
                       [ctypes.c_longlong] * 10 + [ctypes.c_int] * 6 +
                       [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    _build.launch(fn, "pt_flash_decode", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  None if lse is None else lse.data_ptr(), part.data_ptr(),
                  part.data_ptr() + 4 * n_o, q.stride(0), q.stride(2),
                  k.stride(0), k.stride(1), k.stride(2), v.stride(0),
                  v.stride(1), v.stride(2), o.stride(0), o.stride(2), b, h, d,
                  n, split_len, n_split, float(scale), _DTYPES[q.dtype])
    COUNTS_DECODE.launched()
    return o, lse


def flash_attention_fwd_cuda_core(q, k, v, offset, causal, scale):
    """(o, lse) from the CUDA-core kernel (``csrc/flash_attention.cu``):
    fp32 or bf16, head dim up to 256."""
    _on_cuda("flash_attention", q)
    _fwd_inputs("flash_attention", q, k, v)
    bh, sq, d = q.shape
    sk = k.shape[1]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty(bh, sq, dtype=torch.float32, device=q.device)
    fn = _build.kernel("pt_flash_attention_fwd", [ctypes.c_void_p] * 5 +
                       [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                             ctypes.c_void_p])
    _build.launch(fn, "pt_flash_attention_fwd", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh,
                  sq, sk, d, int(offset), int(bool(causal)), float(scale),
                  _DTYPES[q.dtype])
    COUNTS.launched()
    return o, lse


def flash_attention_fwd_sm90(q, k, v, offset, causal, scale):
    """(o, lse) from the tensor-core kernel (``csrc/flash_fwd_sm90.cu``;
    ``csrc/flash_fwd_sm90_wide.cu`` above 128): bf16, a head dim that is a
    multiple of 8 from 8 to 256."""
    _fwd_inputs("flash_attention_sm90", q, k, v)
    _check_sm90("flash_attention_sm90", q)
    _on_cuda("flash_attention_sm90", q)
    bh, sq, d = q.shape
    sk = k.shape[1]
    q, k, v = _tma_ready(q), _tma_ready(k), _tma_ready(v)
    o = torch.empty_like(q)
    lse = torch.empty(bh, sq, dtype=torch.float32, device=q.device)
    fn = _build.kernel("pt_flash_attention_fwd_sm90", [ctypes.c_void_p] * 5 +
                       [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    _build.launch(fn, "pt_flash_attention_fwd_sm90", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh,
                  sq, sk, d, int(offset), int(bool(causal)), float(scale))
    COUNTS_SM90.launched()
    return o, lse


def flash_attention_fwd_tf32x3(q, k, v, offset, causal, scale):
    """(o, lse) from the fp32 tensor-core kernel (``csrc/flash_fwd_tf32x3.cu``,
    3xTF32): float32, head dim a multiple of 8 from 8 to 128, more than one
    query row."""
    _fwd_inputs("flash_attention_tf32x3", q, k, v)
    _check_tf32x3("flash_attention_tf32x3", q, q.shape[1])
    _on_cuda("flash_attention_tf32x3", q)
    bh, sq, d = q.shape
    sk = k.shape[1]
    q, k, v = _tma_ready(q), _tma_ready(k), _tma_ready(v)
    o = torch.empty_like(q)
    lse = torch.empty(bh, sq, dtype=torch.float32, device=q.device)
    fn = _build.kernel("pt_flash_attention_fwd_tf32x3",
                       [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 +
                       [ctypes.c_float, ctypes.c_void_p])
    _build.launch(fn, "pt_flash_attention_fwd_tf32x3", q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), bh, sq, sk, d, int(offset),
                  int(bool(causal)), float(scale))
    COUNTS_TF32X3.launched()
    return o, lse


def _bwd_inputs(q, k, v, do, lse, delta):
    _check_kernel_inputs("flash_attention_bwd", q, (k, v, do, lse, delta))
    bh, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d or \
            do.shape != q.shape or tuple(lse.shape) != (bh, sq) or \
            tuple(delta.shape) != (bh, sq) or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention_bwd: q {tuple(q.shape)} {q.dtype}, k "
            f"{tuple(k.shape)} {k.dtype}, v {tuple(v.shape)} {v.dtype}, do "
            f"{tuple(do.shape)}, lse {tuple(lse.shape)}, delta "
            f"{tuple(delta.shape)} do not fit")
    return (q.contiguous(), k.contiguous(), v.contiguous(),
            do.to(q.dtype).contiguous(), lse.float().contiguous(),
            delta.float().contiguous())


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, offset, causal, scale):
    """(dK, dV): on CUDA the tensor-core kernel where :func:`takes_sm90`,
    the fp32 tensor-core kernel where :func:`takes_tf32x3`, else the
    CUDA-core kernel; the plain version on the CPU. ``delta`` =
    rowsum(dO * O) - dlse, fp32 [bh, sq]."""
    if q.device.type == "cpu":
        COUNTS_DKV.plain()
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, offset,
                                             causal, scale)
    if takes_sm90(q.dtype, q.shape[2]):
        return flash_attention_bwd_dkv_sm90(q, k, v, do, lse, delta, offset,
                                            causal, scale)
    if takes_tf32x3(q.dtype, q.shape[2]):
        return flash_attention_bwd_dkv_tf32x3(q, k, v, do, lse, delta,
                                              offset, causal, scale)
    return flash_attention_bwd_dkv_cuda_core(q, k, v, do, lse, delta, offset,
                                             causal, scale)


def flash_attention_bwd_dkv_cuda_core(q, k, v, do, lse, delta, offset,
                                      causal, scale):
    """(dK, dV) from the CUDA-core kernel (``csrc/flash_attention_bwd.cu``):
    fp32 or bf16, head dim up to 256."""
    _on_cuda("flash_attention_bwd_dkv", q)
    q, k, v, do, lse, delta = _bwd_inputs(q, k, v, do, lse, delta)
    bh, sq, d = q.shape
    sk = k.shape[1]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.kernel("pt_flash_attention_bwd_dkv", [ctypes.c_void_p] * 8 +
                       [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                             ctypes.c_void_p])
    _build.launch(fn, "pt_flash_attention_bwd_dkv", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                  delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, sq, sk,
                  d, int(offset), int(bool(causal)), float(scale),
                  _DTYPES[q.dtype])
    COUNTS_DKV.launched()
    return dk, dv


def flash_attention_bwd_dkv_sm90(q, k, v, do, lse, delta, offset, causal,
                                 scale):
    """(dK, dV) from the tensor-core kernel (``csrc/flash_bwd_dkv_sm90.cu``;
    ``csrc/flash_bwd_dkv_sm90_wide.cu`` above 128): bf16, a head dim that
    is a multiple of 8 from 8 to 256."""
    q, k, v, do, lse, delta = _bwd_inputs(q, k, v, do, lse, delta)
    _check_sm90("flash_attention_bwd_dkv_sm90", q)
    _on_cuda("flash_attention_bwd_dkv_sm90", q)
    q, k, v, do = (_tma_ready(t) for t in (q, k, v, do))
    bh, sq, d = q.shape
    sk = k.shape[1]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.kernel("pt_flash_attention_bwd_dkv_sm90",
                       [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 +
                       [ctypes.c_float, ctypes.c_void_p])
    _build.launch(fn, "pt_flash_attention_bwd_dkv_sm90", q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), bh, sq, sk, d, int(offset), int(bool(causal)),
                  float(scale))
    COUNTS_DKV_SM90.launched()
    return dk, dv


def flash_attention_bwd_dkv_tf32x3(q, k, v, do, lse, delta, offset, causal,
                                   scale):
    """(dK, dV) from the fp32 tensor-core kernel
    (``csrc/flash_bwd_dkv_tf32x3.cu``, 3xTF32): float32, head dim a multiple
    of 8 from 8 to 128."""
    q, k, v, do, lse, delta = _bwd_inputs(q, k, v, do, lse, delta)
    _check_tf32x3("flash_attention_bwd_dkv_tf32x3", q)
    _on_cuda("flash_attention_bwd_dkv_tf32x3", q)
    q, k, v, do = (_tma_ready(t) for t in (q, k, v, do))
    bh, sq, d = q.shape
    sk = k.shape[1]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.kernel("pt_flash_attention_bwd_dkv_tf32x3",
                       [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 +
                       [ctypes.c_float, ctypes.c_void_p])
    _build.launch(fn, "pt_flash_attention_bwd_dkv_tf32x3", q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), bh, sq, sk, d, int(offset),
                  int(bool(causal)), float(scale))
    COUNTS_DKV_TF32X3.launched()
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, offset, causal, scale):
    """dQ: on CUDA the tensor-core kernel where :func:`takes_sm90`, the
    fp32 tensor-core kernel where :func:`takes_tf32x3`, else the CUDA-core
    kernel; the plain version on the CPU."""
    if q.device.type == "cpu":
        COUNTS_DQ.plain()
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, offset,
                                            causal, scale)
    if takes_sm90(q.dtype, q.shape[2]):
        return flash_attention_bwd_dq_sm90(q, k, v, do, lse, delta, offset,
                                           causal, scale)
    if takes_tf32x3(q.dtype, q.shape[2]):
        return flash_attention_bwd_dq_tf32x3(q, k, v, do, lse, delta, offset,
                                             causal, scale)
    return flash_attention_bwd_dq_cuda_core(q, k, v, do, lse, delta, offset,
                                            causal, scale)


def flash_attention_bwd_dq_cuda_core(q, k, v, do, lse, delta, offset, causal,
                                     scale):
    """dQ from the CUDA-core kernel (``csrc/flash_attention_bwd.cu``): fp32
    or bf16, head dim up to 256."""
    _on_cuda("flash_attention_bwd_dq", q)
    q, k, v, do, lse, delta = _bwd_inputs(q, k, v, do, lse, delta)
    bh, sq, d = q.shape
    sk = k.shape[1]
    dq = torch.empty_like(q)
    fn = _build.kernel("pt_flash_attention_bwd_dq", [ctypes.c_void_p] * 7 +
                       [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                             ctypes.c_void_p])
    _build.launch(fn, "pt_flash_attention_bwd_dq", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                  delta.data_ptr(), dq.data_ptr(), bh, sq, sk, d, int(offset),
                  int(bool(causal)), float(scale), _DTYPES[q.dtype])
    COUNTS_DQ.launched()
    return dq


def flash_attention_bwd_dq_sm90(q, k, v, do, lse, delta, offset, causal,
                                scale):
    """dQ from the tensor-core kernel (``csrc/flash_bwd_dq_sm90.cu``;
    ``csrc/flash_bwd_dq_sm90_wide.cu`` above 128): bf16, a head dim that is
    a multiple of 8 from 8 to 256."""
    q, k, v, do, lse, delta = _bwd_inputs(q, k, v, do, lse, delta)
    _check_sm90("flash_attention_bwd_dq_sm90", q)
    _on_cuda("flash_attention_bwd_dq_sm90", q)
    q, k, v, do = (_tma_ready(t) for t in (q, k, v, do))
    bh, sq, d = q.shape
    sk = k.shape[1]
    dq = torch.empty_like(q)
    fn = _build.kernel("pt_flash_attention_bwd_dq_sm90",
                       [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 +
                       [ctypes.c_float, ctypes.c_void_p])
    _build.launch(fn, "pt_flash_attention_bwd_dq_sm90", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                  delta.data_ptr(), dq.data_ptr(), bh, sq, sk, d, int(offset),
                  int(bool(causal)), float(scale))
    COUNTS_DQ_SM90.launched()
    return dq


def flash_attention_bwd_dq_tf32x3(q, k, v, do, lse, delta, offset, causal,
                                  scale):
    """dQ from the fp32 tensor-core kernel (``csrc/flash_bwd_dq_tf32x3.cu``,
    3xTF32): float32, head dim a multiple of 8 from 8 to 128."""
    q, k, v, do, lse, delta = _bwd_inputs(q, k, v, do, lse, delta)
    _check_tf32x3("flash_attention_bwd_dq_tf32x3", q)
    _on_cuda("flash_attention_bwd_dq_tf32x3", q)
    q, k, v, do = (_tma_ready(t) for t in (q, k, v, do))
    bh, sq, d = q.shape
    sk = k.shape[1]
    dq = torch.empty_like(q)
    fn = _build.kernel("pt_flash_attention_bwd_dq_tf32x3",
                       [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 +
                       [ctypes.c_float, ctypes.c_void_p])
    _build.launch(fn, "pt_flash_attention_bwd_dq_tf32x3", q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, sq, sk,
                  d, int(offset), int(bool(causal)), float(scale))
    COUNTS_DQ_TF32X3.launched()
    return dq


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, offset, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, offset, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (offset, causal, scale)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        # the lse cotangent folds into the same ds formula (d lse / d s = p)
        delta = (do.float() * o.float()).sum(dim=-1) - dlse.float()
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, *ctx.args)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention_with_lse(q, k, v, offset=0, causal=False, scale=None):
    """q/k/v: [bh, s, d]. Returns (out [bh, sq, d] in q.dtype, lse [bh, sq]
    fp32), differentiable in q, k and v through both outputs. ``offset``
    shifts q's global positions for the causal mask."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape or \
            q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}"
                         f", v {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share a dtype")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, int(offset), bool(causal),
                                 float(scale))


def flash_attention(q, k, v, causal: bool = False, scale: float = None):
    """q/k/v: [batch, seq, heads, head_dim] (paddle layout)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)

    def bhsd(t, s):
        return t.transpose(1, 2).reshape(b * h, s, d)

    # self-attention with sk >= sq: rows see the key prefix plus the diagonal
    offset = sk - sq if causal else 0
    if sq == 1 and route(q.dtype, d, sq) == "decode" and not (
            torch.is_grad_enabled() and
            (q.requires_grad or k.requires_grad or v.requires_grad)):
        # a decode step: the kernel reads q, k and v where they lie
        return flash_decode(q, k, v, offset, causal, scale,
                            with_lse=False)[0]
    o, _ = flash_attention_with_lse(bhsd(q, sq), bhsd(k, sk), bhsd(v, sk),
                                    offset, causal, scale)
    return o.reshape(b, h, sq, d).transpose(1, 2)
