"""Fused MoE routing and dispatch: the kernels that feed the grouped GEMM.

Port of ``paddle_tpu/kernels/pallas/moe_dispatch.py``
(``FLAGS_moe_dispatch='fused'``). Three kernels, each with a wrapper that
launches it on a CUDA tensor or raises, and runs its plain PyTorch version
on a CPU tensor:

- :func:`route` (``csrc/moe_dispatch.cu``) / :func:`route_plain`: the whole
  router. Gate logits ``x @ wg`` in fp32, softmax, an iterative top-k whose
  ties go to the lowest expert, renormalisation, and each (token, choice)'s
  position in its expert's row block in token-major order (row ``t * k +
  c``): the order of a stable argsort of the experts, without a sort. Also
  the per-expert counts and the aux statistics ``me`` (probability sums)
  and ``ce`` (top-1 counts). Bitwise deterministic, so that activation
  recompute routes every token as the first forward did.
- :func:`gather_rows` / :func:`gather_rows_plain`: ``out[i] =
  src[idx[i]]`` (a zero row for an index outside the rows), optionally
  times an fp32 row scale rounded once to src's dtype (the combine's
  backward scales the gathered cotangent by the gates in the same pass).
- :func:`combine_rows` / :func:`combine_rows_plain`: ``out[t] = sum_c
  gates[t, c] * y[dest2[t, c]]`` in fp32.

Around them, the JAX module's structure: :func:`fused_route`, the dispatch
and combine autograd Functions with gather-only backwards (dispatch's is a
unit-gate combine; combine's is two gathers, a scale and a rowwise dot), the
router's backward a recompute of the differentiable chain
(:func:`route_stats_diff`) from the saved top-k pick, and
:func:`fused_moe_mlp`.
The int32 scatter that maps grouped rows back to flat rows and the
offsets cumsum stay plain PyTorch, as they sit outside any kernel in JAX.
The autograd Functions look the wrappers up by module attribute at call
time.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as TF

from . import _build
from .grouped_matmul import grouped_matmul

__all__ = ["fused_moe_mlp", "fused_route", "fused_route_stats",
           "route_stats_diff", "router_aux", "expert_swiglu", "route",
           "route_plain",
           "route_plan", "gather_rows", "gather_rows_plain", "combine_rows",
           "combine_rows_plain", "topk_first", "MAX_EXPERTS", "MAX_TOP_K",
           "ROUTE_BLOCKS_PER_SM", "COUNTS_ROUTE", "COUNTS_GATHER",
           "COUNTS_COMBINE"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_EXPERTS = 128       # as the JAX module: its expert axis rides the lanes
MAX_TOP_K = 8           # choices the routing kernel keeps per token
# routing blocks each SM keeps resident (the kernel's launch bounds)
ROUTE_BLOCKS_PER_SM = 2
COUNTS_ROUTE = _build.Counts()
COUNTS_GATHER = _build.Counts()
COUNTS_COMBINE = _build.Counts()


def _check_cuda(t, name):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")


def topk_first(p, k):
    """Top-k of ``p`` [n, e] >= 0 as the TPU kernel takes it: ``k`` rounds
    of ``argmax`` (the first maximum, so ties go to the lowest index, as
    ``lax.top_k`` does), each pick masked with -1. Returns (values, int64
    indices), descending; differentiable in ``p`` through the values."""
    with torch.no_grad():
        masked = p.detach().clone()
        idxs = []
        for _ in range(k):
            i = masked.argmax(dim=-1)
            idxs.append(i)
            masked.scatter_(1, i[:, None], -1.0)
    gi = torch.stack(idxs, 1)
    return p.gather(1, gi), gi


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def route_plain(xt, wg, top_k):
    """The JAX ``_routing_composed`` with the kernel's tie rule: (gv f32 [n,
    k], gi i32 [n, k], pos i32 [n, k], cnt i32 [e], me f32 [e], ce f32
    [e])."""
    n = xt.shape[0]
    e = wg.shape[1]
    p = torch.softmax(xt.float() @ wg.float(), dim=-1)
    gv, gi = topk_first(p, top_k)
    gv = gv / gv.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    flat_e = gi.reshape(n * top_k)                        # token-major
    oh = (flat_e[:, None] == torch.arange(e, device=xt.device)[None, :]
          ).to(torch.int32)
    pos = ((torch.cumsum(oh, dim=0) - 1) * oh).sum(dim=-1)
    cnt = oh.sum(dim=0)
    ce = (gi[:, 0][:, None] == torch.arange(e, device=xt.device)[None, :]
          ).float().sum(dim=0)
    return (gv, gi.to(torch.int32), pos.reshape(n, top_k).to(torch.int32),
            cnt.to(torch.int32), p.sum(dim=0), ce)


def route_plan(n, sms):
    """(blocks, tokens per block) of the routing kernel for ``n >= 1``
    tokens on a card of ``sms`` SMs: the blocks the card keeps resident,
    each routing a contiguous run of tokens (the last run shorter), so
    that a block's rows are token-major and the positions are its local
    ranks plus the counts of the blocks before it."""
    tokens = -(-n // (sms * ROUTE_BLOCKS_PER_SM))
    return -(-n // tokens), tokens


def route(xt, wg, top_k):
    """The routing kernels on CUDA, the plain version on the CPU; same
    outputs as :func:`route_plain`."""
    if xt.device.type == "cpu":
        COUNTS_ROUTE.plain()
        return route_plain(xt, wg, top_k)
    _check_cuda(xt, "route")
    n, h = xt.shape
    e = wg.shape[1]
    if xt.dtype not in _DTYPES or wg.dtype != xt.dtype or \
            wg.device != xt.device:
        raise TypeError(f"route kernel takes x and wg of one dtype (float32 "
                        f"or bfloat16) on one device, got {xt.dtype} on "
                        f"{xt.device} and {wg.dtype} on {wg.device}")
    if not 1 <= e <= MAX_EXPERTS or not 1 <= top_k <= min(e, MAX_TOP_K):
        raise ValueError(f"route kernel takes 1..{MAX_EXPERTS} experts and "
                         f"1..min(e, {MAX_TOP_K}) choices, got e={e}, "
                         f"top_k={top_k}")
    dev = xt.device
    if n == 0:
        return (torch.empty(0, top_k, device=dev),
                torch.empty(0, top_k, dtype=torch.int32, device=dev),
                torch.empty(0, top_k, dtype=torch.int32, device=dev),
                torch.zeros(e, dtype=torch.int32, device=dev),
                torch.zeros(e, device=dev), torch.zeros(e, device=dev))
    blocks, tokens = route_plan(n, _build.sm_count(dev))
    # one allocation, every entry written by the kernels: gv, gi, pos [n,
    # k], cnt, me, ce [e], then the scratch [3, blocks, e] (per block and
    # expert: counts, probability sums as fp32 bits, top-1 counts)
    nk = n * top_k
    buf = torch.empty(3 * nk + 3 * e + 3 * blocks * e, dtype=torch.int32,
                      device=dev)
    gv = buf[:nk].view(torch.float32).view(n, top_k)
    gi, pos = buf[nk:2 * nk].view(n, top_k), buf[2 * nk:3 * nk].view(n, top_k)
    cnt = buf[3 * nk:3 * nk + e]
    me = buf[3 * nk + e:3 * nk + 2 * e].view(torch.float32)
    ce = buf[3 * nk + 2 * e:3 * nk + 3 * e].view(torch.float32)
    blk = buf[3 * nk + 3 * e:]
    pad = -h % (16 // xt.element_size())
    if pad:  # the kernel reads whole 16-byte vectors; zeros add nothing
        xt, wg = TF.pad(xt, (0, pad)), TF.pad(wg, (0, 0, 0, pad))
    xt, wg = xt.contiguous(), wg.contiguous()
    if xt.data_ptr() % 16:  # a view that starts off a vector boundary
        xt = xt.clone()
    if wg.data_ptr() % 16:
        wg = wg.clone()
    fn = _build.kernel("pt_moe_route", [ctypes.c_void_p] * 2 +
                       [ctypes.c_int] * 5 + [ctypes.c_void_p] * 7 +
                       [ctypes.c_int, ctypes.c_void_p])
    _build.launch(fn, "pt_moe_route", dev, xt.data_ptr(), wg.data_ptr(), n,
                  h + pad, e, top_k, tokens, gv.data_ptr(), gi.data_ptr(),
                  pos.data_ptr(), cnt.data_ptr(), me.data_ptr(),
                  ce.data_ptr(), blk.data_ptr(), _DTYPES[xt.dtype])
    COUNTS_ROUTE.launched()
    return gv, gi, pos, cnt, me, ce


def route_stats_diff(xt, wg, gate_i, e):
    """The differentiable router chain recomputed from a top-k pick (the
    JAX ``_route_diff``): (renormalised gates [n, k] fp32, probability sums
    per expert ``me`` [e], differentiable; top-1 counts ``ce`` [e]), the
    aux's sufficient statistics, which a mesh sums over its data ranks
    before :func:`router_aux`."""
    p = torch.softmax(xt.float() @ wg.float(), dim=-1)
    v = p.gather(1, gate_i.long())
    gate = v / v.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    ce = TF.one_hot(gate_i[:, 0].long(), e).float().sum(dim=0)
    return gate, p.sum(dim=0), ce


def router_aux(me_sum, ce_cnt, n, e):
    """The Switch/GShard load-balancing loss ``e * sum(me * ce)`` of ``n``
    tokens from the sums ``me_sum`` (probabilities) and ``ce_cnt`` (top-1
    counts) per expert: ``me`` and ``ce`` are their means over the tokens
    (``paddle_tpu/nn/layer/moe.py:73-75``)."""
    return e * ((me_sum / n) * (ce_cnt / n)).sum()


class _FusedRoute(torch.autograd.Function):
    """The routing kernel with the aux's statistics as outputs: the
    probability sums (differentiable) and the top-1 counts."""

    @staticmethod
    def forward(ctx, xt, wg, top_k):
        gv, gi, pos, cnt, me, ce = route(xt, wg, top_k)
        ctx.save_for_backward(xt, wg, gi)
        ctx.mark_non_differentiable(gi, pos, cnt, ce)
        return gv, gi, pos, cnt, me, ce

    @staticmethod
    def backward(ctx, d_gv, _d_gi, _d_pos, _d_cnt, d_me, _d_ce):
        xt, wg, gi = ctx.saved_tensors
        with torch.enable_grad():
            x = xt.detach().requires_grad_()
            w = wg.detach().requires_grad_()
            gate, me, _ce = route_stats_diff(x, w, gi, wg.shape[1])
            dx, dw = torch.autograd.grad((gate, me), (x, w),
                                         (d_gv.float(), d_me.float()))
        return dx.to(xt.dtype), dw.to(wg.dtype), None


def fused_route_stats(xt, wg, top_k):
    """(gate_v f32 [n, k], gate_i i32, pos_in_expert i32, counts i32 [e],
    probability sums ``me`` f32 [e], top-1 counts ``ce`` f32 [e]): the
    router in one kernel call; differentiable in (xt, wg) through gate_v
    and ``me``."""
    return _FusedRoute.apply(xt, wg, int(top_k))


def fused_route(xt, wg, top_k):
    """(gate_v f32 [n, k], gate_i i32, pos_in_expert i32, counts i32 [e],
    aux): the router in one kernel call; differentiable in (xt, wg)
    through gate_v and aux."""
    gv, gi, pos, cnt, me, ce = fused_route_stats(xt, wg, top_k)
    return gv, gi, pos, cnt, router_aux(me, ce, xt.shape[0], wg.shape[1])


# ---------------------------------------------------------------------------
# row movement
# ---------------------------------------------------------------------------

def gather_rows_plain(src, idx, scale=None):
    """``src[idx]`` by rows, a zero row where an index lies outside
    ``[0, n_src)``; with ``scale`` [n] the rows times it in fp32, rounded
    once to src's dtype."""
    i = idx.long()
    inside = (i >= 0) & (i < src.shape[0])
    out = torch.where(inside[:, None], src[torch.where(inside, i, 0)],
                      src.new_zeros(()))
    if scale is None:
        return out
    return (out.float() * scale.float()[:, None]).to(src.dtype)


def gather_rows(src, idx, scale=None):
    """``out[i] = src[idx[i]]`` for ``src`` [n_src, h], ``idx`` [n], times
    ``scale[i]`` (fp32 [n], rounded once to src's dtype) when given: the
    gather kernel on CUDA (an index outside the rows gives a zero row), the
    plain version on the CPU."""
    if src.device.type == "cpu":
        COUNTS_GATHER.plain()
        return gather_rows_plain(src, idx, scale)
    _check_cuda(src, "gather_rows")
    if src.dim() != 2 or idx.dim() != 1 or idx.device != src.device:
        raise ValueError(f"gather_rows: src {tuple(src.shape)} on "
                         f"{src.device}, idx {tuple(idx.shape)} on "
                         f"{idx.device}")
    row_bytes = src.shape[1] * src.element_size()
    if row_bytes % 16:
        raise ValueError(f"gather_rows kernel moves rows of a multiple of "
                         f"16 bytes, got {row_bytes}")
    if scale is not None:
        if src.dtype not in _DTYPES:
            raise TypeError(f"gather_rows kernel scales float32 or bfloat16 "
                            f"rows, got {src.dtype}")
        if tuple(scale.shape) != tuple(idx.shape) or \
                scale.device != src.device:
            raise ValueError(f"gather_rows: scale {tuple(scale.shape)} on "
                             f"{scale.device} for idx {tuple(idx.shape)}")
        scale = scale.float().contiguous()
    src = src.contiguous()
    if src.data_ptr() % 16:  # a view that starts off a vector boundary
        src = src.clone()
    idx = idx.to(torch.int32).contiguous()
    out = torch.empty(idx.shape[0], src.shape[1], dtype=src.dtype,
                      device=src.device)
    fn = _build.kernel("pt_moe_gather_rows", [ctypes.c_void_p] * 4 +
                       [ctypes.c_int] * 5 + [ctypes.c_void_p])
    _build.launch(fn, "pt_moe_gather_rows", src.device, src.data_ptr(),
                  idx.data_ptr(), None if scale is None else scale.data_ptr(),
                  out.data_ptr(), idx.shape[0], src.shape[0], row_bytes,
                  _DTYPES.get(src.dtype, 0), _build.sm_count(src.device))
    COUNTS_GATHER.launched()
    return out


def combine_rows_plain(y, gates, dest2):
    """``sum_c gates[:, c] * y[dest2[:, c]]`` accumulated in fp32, in y's
    dtype."""
    acc = torch.zeros(dest2.shape[0], y.shape[1], dtype=torch.float32,
                      device=y.device)
    for c in range(dest2.shape[1]):
        acc = acc + gates[:, c:c + 1].float() * y[dest2[:, c].long()].float()
    return acc.to(y.dtype)


def combine_rows(y, gates, dest2):
    """Top-k weighted combine of ``y`` [n_y, h] rows into [n, h]: the
    combine kernel on CUDA, the plain version on the CPU."""
    if y.device.type == "cpu":
        COUNTS_COMBINE.plain()
        return combine_rows_plain(y, gates, dest2)
    _check_cuda(y, "combine_rows")
    if y.dtype not in _DTYPES:
        raise TypeError(f"combine_rows kernel takes float32 or bfloat16, got "
                        f"{y.dtype}")
    if y.dim() != 2 or dest2.dim() != 2 or gates.shape != dest2.shape or \
            y.shape[1] % 8 or gates.device != y.device or \
            dest2.device != y.device:
        raise ValueError(f"combine_rows: y {tuple(y.shape)}, gates "
                         f"{tuple(gates.shape)}, dest2 {tuple(dest2.shape)} "
                         f"(h a multiple of 8, one device)")
    n, k = dest2.shape
    y = y.contiguous()
    gates = gates.float().contiguous()
    dest2 = dest2.to(torch.int32).contiguous()
    out = torch.empty(n, y.shape[1], dtype=y.dtype, device=y.device)
    fn = _build.kernel("pt_moe_combine", [ctypes.c_void_p] * 4 +
                       [ctypes.c_int] * 5 + [ctypes.c_void_p])
    _build.launch(fn, "pt_moe_combine", y.device, y.data_ptr(),
                  gates.data_ptr(), dest2.data_ptr(), out.data_ptr(), n, k,
                  y.shape[1], y.shape[0], _DTYPES[y.dtype])
    COUNTS_COMBINE.launched()
    return out


class _FusedDispatch(torch.autograd.Function):
    """Grouped-layout gather ``xs[i] = xt[src_tok[i]]`` whose backward is a
    unit-gate combine through the same destination map."""

    @staticmethod
    def forward(ctx, xt, src_tok, dest2):
        ctx.save_for_backward(dest2)
        return gather_rows(xt, src_tok)

    @staticmethod
    def backward(ctx, g):
        (dest2,) = ctx.saved_tensors
        ones = torch.ones(dest2.shape, dtype=torch.float32,
                          device=dest2.device)
        return combine_rows(g.contiguous(), ones, dest2), None, None


class _FusedCombine(torch.autograd.Function):
    """Weighted scatter-back with a gather-only backward (``g2f`` maps each
    grouped row to its flat (token, choice) row; ``k * n`` marks a row that
    holds no choice, whose cotangent is zero)."""

    @staticmethod
    def forward(ctx, ys, gates, dest2, g2f):
        ctx.save_for_backward(ys, gates, dest2, g2f)
        return combine_rows(ys, gates, dest2)

    @staticmethod
    def backward(ctx, d_out):
        ys, gates, dest2, g2f = ctx.saved_tensors
        n, k = dest2.shape
        d_out = d_out.contiguous()
        # a row that holds no choice (k * n) reads gate 0
        gate_sorted = TF.pad(gates.reshape(n * k), (0, 1))[g2f.long()]
        # the gathered cotangent times each row's gate, in the gather's pass
        d_ys = gather_rows(d_out, g2f // k, gate_sorted).to(ys.dtype)
        y_rows = gather_rows(ys, dest2.reshape(n * k)).reshape(n, k, -1)
        d_gates = (d_out[:, None, :].float() * y_rows.float()).sum(dim=-1)
        return d_ys, d_gates.to(gates.dtype), None, None


# ---------------------------------------------------------------------------
# the fused dropless MoE MLP
# ---------------------------------------------------------------------------

def _group_ops(group):
    """(copy in, reduce out) over ``group``, the ranks that hold slices of
    the same experts (the identity without one): Megatron's conjugate
    pair, so a partial output is summed in the forward and a partial input
    gradient in the backward."""
    if group is None:
        return (lambda t: t), (lambda t: t)
    from ..distributed.meta_parallel.mp_layers import (copy_to_group,
                                                       reduce_from_group)

    return (lambda t: copy_to_group(t, group)), \
        (lambda t: reduce_from_group(t, group))


def expert_swiglu(xs, w_gate, w_up, w_down, counts):
    """The experts' SwiGLU over rows grouped by expert: three grouped
    GEMMs (rows past ``sum(counts)`` give zeros)."""
    act = TF.silu(grouped_matmul(xs, w_gate, counts)) * \
        grouped_matmul(xs, w_up, counts)
    return grouped_matmul(act, w_down, counts)


def fused_moe_mlp(x, wg, w_gate, w_up, w_down, *, top_k, group=None,
                  aux_of=None):
    """Dropless routed expert SwiGLU with fused dispatch: ``x`` [b, s, h],
    router ``wg`` [h, e], experts ``w_gate``/``w_up`` [e, h, i] and
    ``w_down`` [e, i, h] -> ([b, s, h], aux). Row order is the stable
    argsort's (token-major positions), so the result matches the ``gmm``
    dispatch; ``capacity_factor`` does not apply.

    ``group``: the process group of ranks that see the same tokens and
    hold other slices of the experts' intermediate dim (mp): the experts'
    partial output is summed over it, and the partial gradients of the
    dispatched rows and the gates too. ``aux_of(me, ce, n, e)``: the aux
    from the router's statistics (default :func:`router_aux`; a mesh sums
    them over its data ranks first)."""
    b, s, h = x.shape
    n = b * s
    e = wg.shape[1]
    if e > MAX_EXPERTS:
        raise ValueError(f"fused MoE dispatch supports <= {MAX_EXPERTS} "
                         f"experts, got {e}; use FLAGS_moe_dispatch='index'")
    kn = top_k * n
    xt = x.reshape(n, h)
    gate_v, gate_i, pos, counts, me, ce = fused_route_stats(xt, wg, top_k)
    aux = (aux_of or router_aux)(me, ce, n, e)
    copy_in, reduce_out = _group_ops(group)
    # grouped row of each flat (token, choice) row: the expert's block
    # offset plus the position in it (no argsort)
    offsets = torch.cumsum(counts, dim=0) - counts
    dest2 = (offsets[gate_i.long()] + pos).to(torch.int32)   # [n, k]
    dest = dest2.reshape(kn).long()
    rng = torch.arange(kn, dtype=torch.int32, device=x.device)
    # the one int32 scatter: grouped row -> flat row (token = row // k)
    g2f = torch.zeros(kn, dtype=torch.int32, device=x.device).scatter_(
        0, dest, rng)
    xs = _FusedDispatch.apply(copy_in(xt), g2f // top_k, dest2)  # grouped
    ys = expert_swiglu(xs, w_gate, w_up, w_down, counts)   # [kn, h]
    out = reduce_out(_FusedCombine.apply(ys, copy_in(gate_v), dest2, g2f))
    return out.reshape(b, s, h).to(x.dtype), aux
