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
from ...kernels.moe_dispatch import (MAX_EXPERTS, _FusedCombine,
                                     _FusedDispatch, _group_ops,
                                     expert_swiglu, fused_moe_mlp,
                                     route_stats_diff, router_aux,
                                     topk_first)

__all__ = ["MoELayer", "ExpertMLP", "MoEMesh", "moe_mesh", "moe_mlp",
           "capacity_positions", "collect_aux", "record_aux", "drain_aux"]

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


# -- the mesh ------------------------------------------------------------------

class MoEMesh:
    """What an MoE layer needs of the installed mesh (the JAX layer's
    ``ep_degree`` and GSPMD's global view, made explicit per rank):

    - ``data``: the group over dp x sdp x cp, the ranks that see
      different tokens (``n_data`` of them), over which the aux's
      statistics and the capacity's counts are global; None at one. The
      batch's rows split over dp x sdp (``n_blocks`` blocks, this rank's
      at ``data_rank`` in batch order) and each row's positions over cp
      (``cp`` chunks, this rank's ``cp_rank``): the global token order,
      as the JAX layer sees the global ``[b, s]`` batch flattened, is
      block, row, chunk, position;
    - ``experts``: the group over ep x mp, the ranks that see the same
      tokens and hold different slices of the experts (``e / ep`` experts
      each, their ``i / mp`` columns), over which the experts' partial
      output and the partial gradients of its inputs are summed; None at
      one."""

    def __init__(self, env):
        self.env = env
        self.n_data = env.size_over(("dp", "sdp", "cp"))
        self.data = _group(env, ("dp", "sdp", "cp"))
        self.n_blocks = env.size_over(("dp", "sdp"))
        self.data_rank = env.coord("dp") * env.get_dim("sdp") + \
            env.coord("sdp")
        self.cp, self.cp_rank = env.get_dim("cp"), env.coord("cp")
        self.ep, self.ep_rank = env.get_dim("ep"), env.coord("ep")
        self.mp = env.get_dim("mp")
        self.experts = _group(env, ("ep", "mp"))


def _group(env, axes):
    """The group over those of ``axes`` of degree > 1, None at one rank."""
    used = [ax for ax in axes if env.get_dim(ax) > 1]
    return env.group_over(used) if used else None


_MESHES = {}


def moe_mesh(env=None):
    """The :class:`MoEMesh` of ``env`` (default: the installed mesh), None
    without a mesh of more than one rank. Its groups are made at the first
    call for a mesh (collective: every rank calls it in the same order;
    the layers call it when they are built)."""
    if env is None:
        from ...distributed.mesh import get_mesh_env

        env = get_mesh_env()
    if env is None or env.nranks == 1:
        return None
    m = _MESHES.get(id(env))
    if m is None or m.env is not env:
        m = _MESHES[id(env)] = MoEMesh(env)
    return m


def _global_aux(mesh):
    """``aux_of(me, ce, n, e)`` for ``mesh``: the statistics summed over
    its data ranks (a psum: the backward sums the cotangents), then the
    aux over the global tokens."""
    if mesh is None or mesh.data is None:
        return router_aux
    from ...distributed.collective import _PSum

    def aux_of(me, ce, n, e):
        both = _PSum.apply(torch.stack([me, ce.to(me.dtype)]), mesh.data)
        return router_aux(both[0], both[1], n * mesh.n_data, e)

    return aux_of


# -- routing and the dispatch modes ------------------------------------------

def _route(xt, wg, top_k, aux_of=router_aux):
    """Router: fp32 softmax, renormalised top-k (ties to the lowest
    expert), and the Switch/GShard aux ``e * sum(frac_probs *
    frac_top1)``: the fused router's differentiable chain on the pick."""
    with torch.no_grad():
        gate_i = topk_first(torch.softmax(xt.float() @ wg.float(), dim=-1),
                            top_k)[1]
    gate_v, me, ce = route_stats_diff(xt, wg, gate_i, wg.shape[1])
    return gate_v, gate_i, aux_of(me, ce, xt.shape[0], wg.shape[1])


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
    pos_in_e = ((_cumsum(oh, 0) - 1) * oh).sum(dim=1)
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


def _cumsum(t, dim):
    """``torch.cumsum(t, dim)`` of a one-hot, taken along the contiguous
    dim of a copy: CUDA scans an outer dim with a thread a column over
    every row (one [65536, 2] int64 scan took 3.9 ms on an H100, half the
    MoE step at ep 4), an inner dim with a block a row."""
    return torch.cumsum(t.movedim(dim, -1).contiguous(), dim=-1).movedim(
        -1, dim)


def _capacity(n, e, top_k, capacity_factor):
    return max(int(math.ceil(capacity_factor * top_k * n / e)), top_k)


def capacity_positions(gate_i, e, data=None, n_data=1, data_rank=0,
                       rows=1, cp=1, cp_rank=0):
    """Each (choice, token)'s place in its expert's capacity buffer, in the
    JAX package's order over the global tokens (``moe.py:221-247``): every
    first choice before any second choice, the tokens in the global
    batch's order. ``gate_i`` [n, k] (this rank's ``rows`` batch rows of
    ``n / rows`` positions each) -> (flat experts [k*n] choice-major,
    positions [k*n]). Across ranks (``data``; the batch's rows split into
    ``n_data`` blocks, this rank's ``data_rank``, each row's positions
    into ``cp`` chunks, this rank's ``cp_rank``) the place of a token at
    choice c is: the counts of the choices before c over every rank, the
    earlier blocks' at c, the earlier rows of its block at c (every
    chunk), the earlier chunks of its row at c, and the cumsum within its
    own chunk. Each rank's [k, rows, e] counts are all-gathered as an
    all-reduce of a buffer with one slot a rank (a few hundred bytes;
    every backend's CUDA path has the all-reduce)."""
    n, top_k = gate_i.shape
    kn = top_k * n
    per = n // rows
    flat_e = gate_i.t().reshape(kn).long()
    oh = (flat_e[:, None] == torch.arange(e, device=gate_i.device)[None, :]
          ).to(torch.int64)
    oh4 = oh.reshape(top_k, rows, per, e)
    local = (_cumsum(oh4, 2) - 1).reshape(kn, e)
    counts = oh4.sum(dim=2)                                  # [k, rows, e]
    every = torch.zeros((n_data, cp) + tuple(counts.shape),
                        dtype=counts.dtype, device=counts.device)
    every[data_rank, cp_rank] = counts
    if data is not None:
        import torch.distributed as dist

        dist.all_reduce(every, group=data)
    total = every.sum(dim=(0, 1, 3))                         # [k, e]
    mine = every[data_rank]                                  # [cp, k, rows, e]
    row_total = mine.sum(dim=0)                              # [k, rows, e]
    before = ((torch.cumsum(total, dim=0) - total) +
              every[:data_rank].sum(dim=(0, 1, 3)))[:, None, :] + \
        (torch.cumsum(row_total, dim=1) - row_total) + \
        mine[:cp_rank].sum(dim=0)                            # [k, rows, e]
    start = before.repeat_interleave(per, dim=1).reshape(kn, e)
    return flat_e, ((start + local) * oh).sum(dim=1)


def _moe_mlp_kept(x, wg, w_gate, w_up, w_down, *, top_k, capacity_factor,
                  mesh):
    """The capacity dispatch (``index``) over a mesh: the capacity and every
    token's place from the global tokens (:func:`capacity_positions`), so
    each drop is the reference's; this rank runs the kept rows bound for
    its own experts (``e / ep`` of them) through the grouped-GEMM kernel,
    grouped by local expert, with no capacity padding; its partial
    combine is summed over the expert group (ep x mp) by an all-reduce,
    whose conjugate sums the partial gradients of the dispatched rows and
    the gates. The router runs whole on every rank, so a replicated
    parameter ends with its full gradient, counted once."""
    b, s, h = x.shape
    n = b * s
    e = wg.shape[1]
    kn = top_k * n
    e_loc = w_gate.shape[0]
    lo = mesh.ep_rank * e_loc
    xt = x.reshape(n, h)
    gate_v, gate_i, aux = _route(xt, wg, top_k, _global_aux(mesh))
    cap = _capacity(n * mesh.n_data, e, top_k, capacity_factor)
    with torch.no_grad():
        flat_e, pos = capacity_positions(gate_i, e, mesh.data,
                                         mesh.n_blocks, mesh.data_rank, b,
                                         mesh.cp, mesh.cp_rank)
        mine = (pos < cap) & (flat_e >= lo) & (flat_e < lo + e_loc)
        local_e = torch.where(mine, flat_e - lo, 0)
        oh = (local_e[:, None] == torch.arange(
            e_loc, device=x.device)[None, :]) & mine[:, None]
        oh = oh.to(torch.int64)
        slot = ((_cumsum(oh, 0) - 1) * oh).sum(dim=1)
        sizes = oh.sum(dim=0)                                 # [e_loc]
        rows = min(kn, e_loc * cap) + 1  # the last row stays zero: a pad
        offsets = torch.cumsum(sizes, dim=0) - sizes
        dest = torch.where(mine, offsets[local_e] + slot, rows - 1)
        dest2 = dest.reshape(top_k, n).t().contiguous().to(torch.int32)
        # grouped row -> flat token-major row (t * k + c); k * n: none
        tok_major = (torch.arange(kn, device=x.device) % n) * top_k + \
            torch.arange(kn, device=x.device) // n
        g2f = torch.full((rows,), kn, dtype=torch.int64, device=x.device)
        g2f = g2f.scatter(0, torch.where(mine, dest, rows - 1),
                          torch.where(mine, tok_major, kn)).to(torch.int32)
        gates_on = mine.reshape(top_k, n).t()                 # [n, k]
    copy_in, reduce_out = _group_ops(mesh.experts)
    xs = _FusedDispatch.apply(copy_in(xt), g2f // top_k, dest2)
    ys = expert_swiglu(xs, w_gate, w_up, w_down, sizes.to(torch.int32))
    gates = copy_in(gate_v) * gates_on
    out = reduce_out(_FusedCombine.apply(ys, gates, dest2, g2f))
    return out.reshape(b, s, h).to(x.dtype), aux


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


def _moe_mlp_gmm(x, wg, w_gate, w_up, w_down, *, top_k, mesh=None):
    """Dropless: the k*n (token, choice) rows sorted by expert with a stable
    argsort, one grouped GEMM per projection."""
    b, s, h = x.shape
    n = b * s
    e = wg.shape[1]
    kn = top_k * n
    xt = x.reshape(n, h)
    gate_v, gate_i, aux = _route(xt, wg, top_k, _global_aux(mesh))
    copy_in, reduce_out = _group_ops(None if mesh is None else mesh.experts)
    flat_e = gate_i.reshape(kn)           # token-major: row t*k + c
    order = torch.argsort(flat_e, stable=True)
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(kn, device=x.device))
    group_sizes = torch.zeros(e, dtype=torch.int32, device=x.device
                              ).scatter_add_(0, flat_e, torch.ones_like(
                                  flat_e, dtype=torch.int32))
    xs = copy_in(xt)[order // top_k]
    ys = expert_swiglu(xs, w_gate, w_up, w_down, group_sizes)
    y_tok = ys[inv].reshape(n, top_k, h)
    out = (y_tok * copy_in(gate_v)[:, :, None].to(x.dtype)).sum(dim=1)
    return reduce_out(out).reshape(b, s, h), aux


def moe_mlp(x, wg, w_gate, w_up, w_down, *, top_k, capacity_factor,
            dispatch="index", mesh=None):
    """Routed expert FFN: [b, s, h] -> ([b, s, h], aux) by ``dispatch``
    (``index`` | ``sort`` | ``gmm`` | ``fused`` | ``einsum``). Under a
    mesh (``mesh``, a :class:`MoEMesh`) the aux is over the global tokens;
    with ``ep > 1`` every mode takes ``index``, as the JAX layer does
    (``moe.py:133-143``), and the capacity modes run
    :func:`_moe_mlp_kept` (the global capacity and places)."""
    if mesh is not None and mesh.ep > 1:
        dispatch = "index"
    if dispatch == "fused" and wg.shape[1] <= MAX_EXPERTS:
        return fused_moe_mlp(x, wg, w_gate, w_up, w_down, top_k=top_k,
                             group=None if mesh is None else mesh.experts,
                             aux_of=_global_aux(mesh))
    if dispatch == "gmm":
        return _moe_mlp_gmm(x, wg, w_gate, w_up, w_down, top_k=top_k,
                            mesh=mesh)
    if mesh is not None:
        return _moe_mlp_kept(x, wg, w_gate, w_up, w_down, top_k=top_k,
                             capacity_factor=capacity_factor, mesh=mesh)
    impl = _moe_mlp_einsum if dispatch == "einsum" else _moe_mlp_index
    return impl(x, wg, w_gate, w_up, w_down, top_k=top_k,
                capacity_factor=capacity_factor)


class ExpertMLP(nn.Module):
    """Stacked per-expert SwiGLU weights in the JAX layout: ``gate`` and
    ``up`` [e, h, i], ``down`` [e, i, h]; Xavier-uniform. Under a mesh
    (``ep``, ``mp``) a rank holds its ``e / ep`` experts and their ``i /
    mp`` columns, as the JAX specs ``P("ep", None, "mp")`` / ``P("ep",
    "mp", None)`` place them (``moe.py:444-446``): each tensor carries
    ``ep_dim`` (0) and ``mp_dim`` (2 for ``gate``/``up``, 1 for
    ``down``)."""

    def __init__(self, num_experts, hidden_size, intermediate_size, ep=1,
                 mp=1):
        super().__init__()
        for what, total, n in (("num_experts", num_experts, ep),
                               ("intermediate_size", intermediate_size, mp)):
            if total % n:
                raise ValueError(f"{what} ({total}) must divide by its "
                                 f"mesh degree {n}")
        e, h, i = num_experts // ep, hidden_size, intermediate_size // mp
        self._ep, self._mp = ep, mp
        self.gate = nn.Parameter(torch.empty(e, h, i))
        self.up = nn.Parameter(torch.empty(e, h, i))
        self.down = nn.Parameter(torch.empty(e, i, h))
        for p, (fan_in, fan_out) in ((self.gate, (h, i)), (self.up, (h, i)),
                                     (self.down, (i, h))):
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            nn.init.uniform_(p, -bound, bound)
        self._mark_params()

    def _mark_params(self):
        for p, mp_dim in ((self.gate, 2), (self.up, 2), (self.down, 1)):
            p.ep_dim = 0 if self._ep > 1 else None
            p.mp_dim = mp_dim if self._mp > 1 else None
            p.is_distributed = self._ep > 1 or self._mp > 1


class MoELayer(nn.Module):
    """Top-k routed expert layer: router ``gate_weight`` [d_model, e] and
    :class:`ExpertMLP` experts (``intermediate_size`` defaults to 4 *
    d_model). Built under a mesh, it holds its ranks' experts and takes
    the mesh's groups (:func:`moe_mesh`)."""

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
        mesh = moe_mesh()
        self.experts = ExpertMLP(num_experts, d_model, intermediate_size,
                                 ep=1 if mesh is None else mesh.ep,
                                 mp=1 if mesh is None else mesh.mp)

    def forward_with_aux(self, x):
        """[b, s, d_model] -> (output, aux loss over the global tokens)."""
        mode = get_flags("FLAGS_moe_dispatch")["FLAGS_moe_dispatch"]
        return moe_mlp(x, self.gate_weight, self.experts.gate,
                       self.experts.up, self.experts.down, top_k=self.top_k,
                       capacity_factor=self.capacity_factor, dispatch=mode,
                       mesh=moe_mesh())

    def forward(self, x):
        out, aux = self.forward_with_aux(x)
        record_aux(aux)
        return out
