"""Mixture-of-Experts layer (port of ``paddle_tpu/nn/layer/moe.py``).

``MoELayer`` is a top-k routed SwiGLU expert layer with the JAX package's
parameters and layouts: the router ``gate_weight`` [h, e] (used as
``x @ gate_weight``) and the experts' stacked ``gate``/``up`` [e, h, i] and
``down`` [e, i, h] (not ``nn.Linear``). ``FLAGS_moe_dispatch``
(``framework.flags``), read per call, picks how tokens reach the experts:

- ``fused``: :func:`paddle_tpu_torch.kernels.moe_dispatch.fused_moe_mlp`,
  the routing, gather and combine kernels around the grouped-GEMM kernel
  (dropless; above 128 experts it takes ``index``, as the JAX layer does);
- ``gmm``: router in plain PyTorch, rows sorted by a stable argsort, the
  grouped-GEMM kernel (dropless);
- ``index`` (default): capacity routing by a cumsum over the choice-major
  expert one-hot, dropped rows past ``capacity_factor``, batched expert
  products; plain PyTorch (the JAX package has no kernel there);
- ``sort``: taken by ``index``. The JAX package finds the same capacity
  slots with a stable sort by expert instead of a cumsum; the two give the
  same slots, drops and output, so the port keeps one of them;
- ``einsum``: GShard's one-hot dispatch and combine tensors [n, e, cap]
  and two einsums, O(n * e * cap); plain PyTorch, the JAX package's parity
  oracle.

``index`` and ``einsum`` share the slot-major drop rule (every token's
first choice outranks any second choice) and give the same output.

Each returns the layer output and the load-balancing aux loss ``e *
sum(me * ce)``. ``MoELayer.forward`` records the aux for an enclosing
:func:`collect_aux` (the JAX API); the decoder stack instead threads it out
of each layer with :meth:`MoELayer.forward_with_aux`, so that a layer
recomputed under activation checkpointing counts once.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as TF
from torch import nn

from ...framework.flags import get_flags
from ...kernels.grouped_matmul import grouped_matmul
from ...kernels.moe_dispatch import (MAX_EXPERTS, _route_diff,
                                     fused_moe_mlp, topk_first)

__all__ = ["MoELayer", "ExpertMLP", "collect_aux", "record_aux",
           "drain_aux"]

# -- aux-loss plumbing (the JAX package's side channel) ----------------------

_AUX_STACK = []


@contextlib.contextmanager
def collect_aux():
    """Collect the aux losses that MoE layers record inside the block."""
    bucket = []
    _AUX_STACK.append(bucket)
    try:
        yield bucket
    finally:
        _AUX_STACK.pop()


def record_aux(v):
    if _AUX_STACK:
        _AUX_STACK[-1].append(v)


def drain_aux(bucket):
    """Sum of the recorded aux losses, in order (None when none)."""
    if not bucket:
        return None
    total = bucket[0]
    for v in bucket[1:]:
        total = total + v
    return total


# -- routing and the dispatch modes ------------------------------------------

def _route(xt, wg, top_k):
    """Router: fp32 softmax, renormalised top-k (ties to the lowest
    expert), and the Switch/GShard aux ``e * sum(frac_probs *
    frac_top1)``: the fused router's differentiable chain on the pick."""
    with torch.no_grad():
        gate_i = topk_first(torch.softmax(xt.float() @ wg.float(), dim=-1),
                            top_k)[1]
    gate_v, aux = _route_diff(xt, wg, gate_i, wg.shape[1])
    return gate_v, gate_i, aux


def _expert_ffn(buf, w_gate, w_up, w_down):
    """Batched per-expert SwiGLU on [e, cap, h] buffers."""
    act = TF.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    return torch.bmm(act, w_down)


def _moe_mlp_index(x, wg, w_gate, w_up, w_down, *, top_k, capacity_factor):
    """Capacity dispatch: positions from a cumsum over the choice-major
    [k*n, e] one-hot (every token's first choice outranks any second
    choice), rows past ``cap`` dropped, a zero row for empty slots."""
    b, s, h = x.shape
    n = b * s
    e = wg.shape[1]
    kn = top_k * n
    cap = _capacity(n, e, top_k, capacity_factor)
    xt = x.reshape(n, h)
    gate_v, gate_i, aux = _route(xt, wg, top_k)
    flat_e = gate_i.t().reshape(kn)                        # choice-major
    flat_g = gate_v.t().reshape(kn)
    oh = (flat_e[:, None] == torch.arange(e, device=x.device)[None, :]
          ).to(torch.int64)
    pos_in_e = ((torch.cumsum(oh, dim=0) - 1) * oh).sum(dim=1)
    keep = pos_in_e < cap
    slot = torch.where(keep, flat_e * cap + pos_in_e, e * cap)
    # slot -> flat row (dropped rows all land on the scratch slot e*cap,
    # cut off after the scatter); token = row % n, n marks an empty slot
    rows = torch.arange(kn, device=x.device)
    slot_rowsrc = torch.full((e * cap + 1,), kn, dtype=torch.int64,
                             device=x.device).scatter_(0, slot, rows)[:-1]
    slot_src = torch.where(slot_rowsrc < kn, slot_rowsrc % n, n)
    xt_pad = torch.cat([xt, xt.new_zeros(1, h)])
    buf = xt_pad[slot_src].reshape(e, cap, h)
    y = _expert_ffn(buf, w_gate, w_up, w_down).reshape(e * cap, h)
    picked = y[slot.clamp(max=e * cap - 1)]
    contrib = torch.where(keep[:, None], picked, picked.new_zeros(())) * \
        flat_g[:, None].to(y.dtype)
    out = contrib.reshape(top_k, n, h).sum(dim=0)
    return out.reshape(b, s, h), aux


def _capacity(n, e, top_k, capacity_factor):
    return max(int(math.ceil(capacity_factor * top_k * n / e)), top_k)


def _moe_mlp_einsum(x, wg, w_gate, w_up, w_down, *, top_k,
                    capacity_factor):
    """GShard one-hot dispatch: fp32 dispatch and combine tensors [n, e,
    cap] from a cumsum over the choice-major one-hot, ``einsum`` into the
    expert buffers and back."""
    b, s, h = x.shape
    n = b * s
    e = wg.shape[1]
    cap = _capacity(n, e, top_k, capacity_factor)
    xt = x.reshape(n, h)
    gate_v, gate_i, aux = _route(xt, wg, top_k)
    oh = TF.one_hot(gate_i.t().reshape(top_k * n), e).float()  # [k*n, e]
    pos_in_e = ((torch.cumsum(oh, dim=0) - 1.0) * oh).sum(dim=-1)
    keep = (pos_in_e < cap).float()[:, None] * oh
    # one_hot of a position past the buffer is all zeros, as jax's
    cap_oh = (pos_in_e.long()[:, None] ==
              torch.arange(cap, device=x.device)[None, :]).float()
    disp = keep[:, :, None] * cap_oh[:, None, :]           # [k*n, e, cap]
    disp = disp.reshape(top_k, n, e, cap).transpose(0, 1)  # [n, k, e, cap]
    combine = (disp * gate_v[:, :, None, None]).sum(dim=1)
    disp = disp.sum(dim=1)
    expert_in = torch.einsum("nec,nh->ech", disp.to(x.dtype), xt)
    y = _expert_ffn(expert_in, w_gate, w_up, w_down)
    out = torch.einsum("ech,nec->nh", y, combine.to(x.dtype))
    return out.reshape(b, s, h), aux


def _moe_mlp_gmm(x, wg, w_gate, w_up, w_down, *, top_k):
    """Dropless: the k*n (token, choice) rows sorted by expert with a stable
    argsort, one grouped GEMM per projection."""
    b, s, h = x.shape
    n = b * s
    e = wg.shape[1]
    kn = top_k * n
    xt = x.reshape(n, h)
    gate_v, gate_i, aux = _route(xt, wg, top_k)
    flat_e = gate_i.reshape(kn)           # token-major: row t*k + c
    order = torch.argsort(flat_e, stable=True)
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(kn, device=x.device))
    group_sizes = torch.zeros(e, dtype=torch.int32, device=x.device
                              ).scatter_add_(0, flat_e, torch.ones_like(
                                  flat_e, dtype=torch.int32))
    xs = xt[order // top_k]
    act = TF.silu(grouped_matmul(xs, w_gate, group_sizes)) * \
        grouped_matmul(xs, w_up, group_sizes)
    ys = grouped_matmul(act, w_down, group_sizes)
    y_tok = ys[inv].reshape(n, top_k, h)
    out = (y_tok * gate_v[:, :, None].to(x.dtype)).sum(dim=1)
    return out.reshape(b, s, h), aux


def moe_mlp(x, wg, w_gate, w_up, w_down, *, top_k, capacity_factor,
            dispatch="index"):
    """Routed expert FFN: [b, s, h] -> ([b, s, h], aux) by ``dispatch``
    (``index`` | ``sort`` | ``gmm`` | ``fused`` | ``einsum``)."""
    if dispatch == "fused" and wg.shape[1] <= MAX_EXPERTS:
        return fused_moe_mlp(x, wg, w_gate, w_up, w_down, top_k=top_k)
    if dispatch == "gmm":
        return _moe_mlp_gmm(x, wg, w_gate, w_up, w_down, top_k=top_k)
    impl = _moe_mlp_einsum if dispatch == "einsum" else _moe_mlp_index
    return impl(x, wg, w_gate, w_up, w_down, top_k=top_k,
                capacity_factor=capacity_factor)


class ExpertMLP(nn.Module):
    """Stacked per-expert SwiGLU weights in the JAX layout: ``gate`` and
    ``up`` [e, h, i], ``down`` [e, i, h]; Xavier-uniform."""

    def __init__(self, num_experts, hidden_size, intermediate_size):
        super().__init__()
        e, h, i = num_experts, hidden_size, intermediate_size
        self.gate = nn.Parameter(torch.empty(e, h, i))
        self.up = nn.Parameter(torch.empty(e, h, i))
        self.down = nn.Parameter(torch.empty(e, i, h))
        for p, (fan_in, fan_out) in ((self.gate, (h, i)), (self.up, (h, i)),
                                     (self.down, (i, h))):
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            nn.init.uniform_(p, -bound, bound)


class MoELayer(nn.Module):
    """Top-k routed expert layer: router ``gate_weight`` [d_model, e] and
    :class:`ExpertMLP` experts (``intermediate_size`` defaults to 4 *
    d_model)."""

    def __init__(self, d_model, num_experts, intermediate_size=None, top_k=2,
                 capacity_factor=1.25):
        super().__init__()
        self.d_model = d_model
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = float(capacity_factor)
        intermediate_size = intermediate_size or 4 * d_model
        self.gate_weight = nn.Parameter(torch.empty(d_model, num_experts))
        bound = math.sqrt(6.0 / (d_model + num_experts))
        nn.init.uniform_(self.gate_weight, -bound, bound)
        self.experts = ExpertMLP(num_experts, d_model, intermediate_size)

    def forward_with_aux(self, x):
        """[b, s, d_model] -> (output, aux loss)."""
        mode = get_flags("FLAGS_moe_dispatch")["FLAGS_moe_dispatch"]
        return moe_mlp(x, self.gate_weight, self.experts.gate,
                       self.experts.up, self.experts.down, top_k=self.top_k,
                       capacity_factor=self.capacity_factor, dispatch=mode)

    def forward(self, x):
        out, aux = self.forward_with_aux(x)
        record_aux(aux)
        return out
