"""Tensor-parallel layers (port of
``paddle_tpu/distributed/meta_parallel/mp_layers.py``).

The JAX layers hold GSPMD shard specs and XLA inserts the collectives. Here
each rank holds its shard of the weight and the layers issue Megatron's
conjugate collectives over the mp group explicitly, as autograd
functions: ``copy_to_group`` (identity forward, all-reduce backward) before
a column-parallel product, ``reduce_from_group`` (all-reduce forward,
identity backward) after a row-parallel one, ``gather_from_group`` /
``scatter_to_group`` (all-gather / split of the last dim, each the other's
backward).

Weights keep torch's ``[out, in]`` layout (``models/convert.py`` transposes
the JAX ``[in, out]`` weight): ``ColumnParallelLinear`` holds rows ``[r *
out/mp, (r + 1) * out/mp)`` of it, ``RowParallelLinear`` the same columns
of ``in``, ``VocabParallelEmbedding`` those rows of the vocabulary. Each
sharded parameter carries ``is_distributed = True`` and ``mp_dim``, the
dim it is split on (read ``mp_dim``: on a parameter no mp layer marked,
``is_distributed`` is ``torch.Tensor``'s method); ``mark_parameters(model)``
sets them again on the parameters a module holds now (``to_empty`` and
``to`` make new ones). A parameter whose split dim is made of equal blocks
split each over mp (GPT's fused q/k/v projection: ``[3][heads][head_dim]``
rows, a rank holding its heads' rows of each) carries ``mp_blocks``
(:func:`mp_shard`, :func:`mp_unshard`).

At mp = 1 each layer is exactly ``F.linear`` / ``F.embedding``: it issues
no collective and makes the same call as ``nn.Linear`` / ``nn.Embedding``
(which they subclass), so a model built from them steps bit for bit as
one built from torch's layers. An input whose float dtype differs from
the weight's is promoted first, as the JAX layers' ``jnp.matmul`` does
(``ops.linalg.linear_out_in``: an fp32 input against a bf16 weight gives
fp32, and a bf16 gradient for the weight).

``weight_attr`` / ``bias_attr`` (a ``ParamAttr``, an initializer or a name;
``bias_attr=False``: no bias) draw the parameter through
``attr.initializer`` at the full weight's JAX shape (``[in, out]`` for the
linears, ``[vocab, dim]`` for the embedding), so the fans are the full
weight's; each rank keeps its shard of that draw (ranks seeded alike draw
alike). Without an initializer a parameter keeps torch's default draw.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize

from ...ops.linalg import linear_out_in
from ..collective import Group, all_gather_dim
from ..mesh import get_mesh_env

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "copy_to_group",
           "reduce_from_group", "gather_from_group", "scatter_to_group",
           "vocab_parallel_cross_entropy", "mp_info", "mark_parameters",
           "mp_shard", "mp_unshard"]


def mp_shard(full: torch.Tensor, n: int, r: int, dim: int,
             blocks: int = 1) -> torch.Tensor:
    """Rank ``r``'s shard of ``full`` split over ``n`` ranks on ``dim``:
    the ``r``-th contiguous chunk, or with ``blocks`` > 1 (``dim`` made of
    that many equal blocks, as a fused q/k/v projection's rows are) the
    ``r``-th chunk of every block, in block order."""
    if n == 1:
        return full
    if blocks == 1:
        return full.chunk(n, dim=dim)[r]
    shape = list(full.shape)
    per = shape[dim] // (blocks * n)
    v = full.reshape(shape[:dim] + [blocks, n, per] + shape[dim + 1:])
    return v.select(dim + 1, r).reshape(
        shape[:dim] + [blocks * per] + shape[dim + 1:])


def mp_unshard(parts, dim: int, blocks: int = 1) -> torch.Tensor:
    """The inverse of :func:`mp_shard` over every rank's shard, in rank
    order."""
    if len(parts) == 1:
        return parts[0]
    if blocks == 1:
        return torch.cat(list(parts), dim=dim)
    shape = list(parts[0].shape)
    per = shape[dim] // blocks
    split = [t.reshape(shape[:dim] + [blocks, per] + shape[dim + 1:])
             for t in parts]
    return torch.stack(split, dim=dim + 1).reshape(
        shape[:dim] + [blocks * len(parts) * per] + shape[dim + 1:])


def mp_info(mp_group=None):
    """(process group or None at degree 1, degree, this rank's index) of
    ``mp_group`` (a :class:`Group` or process group), else of the
    installed mesh's mp axis."""
    if mp_group is not None:
        pg = mp_group.process_group if isinstance(mp_group, Group) \
            else mp_group
        n = dist.get_world_size(pg)
        return (pg if n > 1 else None), n, dist.get_rank(pg)
    env = get_mesh_env()
    if env is None or env.get_dim("mp") == 1:
        return None, 1, 0
    return env.group("mp"), env.get_dim("mp"), env.coord("mp")


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.pg)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=pg)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        n = dist.get_world_size(pg)
        ctx.args = (n, dist.get_rank(pg))
        return all_gather_dim(x, pg, n, x.dim() - 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        n, r = ctx.args
        return g.chunk(n, dim=-1)[r].contiguous(), None


class _ScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        n = dist.get_world_size(pg)
        ctx.args = (pg, n)
        return x.chunk(n, dim=-1)[dist.get_rank(pg)].contiguous()

    @staticmethod
    def backward(ctx, g):
        pg, n = ctx.args
        return all_gather_dim(g, pg, n, g.dim() - 1).contiguous(), None


def copy_to_group(x, pg):
    return x if pg is None else _CopyToGroup.apply(x, pg)


def reduce_from_group(x, pg):
    return x if pg is None else _ReduceFromGroup.apply(x, pg)


def gather_from_group(x, pg):
    return x if pg is None else _GatherFromGroup.apply(x, pg)


def scatter_to_group(x, pg):
    return x if pg is None else _ScatterToGroup.apply(x, pg)


def _divide(n_total, n, what):
    if n_total % n:
        raise ValueError(f"{what} ({n_total}) must divide by the mp degree "
                         f"{n}")
    return n_total // n


def _mark(p, mp_dim, n):
    p.is_distributed = n > 1
    p.mp_dim = mp_dim if n > 1 else None


def mark_parameters(model: nn.Module) -> nn.Module:
    """Sets ``is_distributed`` and ``mp_dim`` (an MoE layer's experts also
    ``ep_dim``) on the parameters every tensor- or expert-parallel layer
    of ``model`` holds now (a ZeRO-3 shard has them from its parameter
    already)."""
    for m in model.modules():
        if callable(getattr(m, "_mark_params", None)) and \
                not parametrize.is_parametrized(m):
            m._mark_params()
    return model


def _draw_attr(param, attr, full_shape, to_port, dim, n, r):
    """Sets ``param`` to this rank's shard (on ``dim``, of ``n``) of a draw
    of the full JAX-shaped weight through ``attr``'s initializer
    (``to_port`` maps that weight to the port's layout); takes its
    ``trainable``. Nothing for an attr without an initializer."""
    from ...nn.layer.layers import ParamAttr

    attr = ParamAttr._to_attr(attr)
    if not attr:
        return
    if attr.initializer is not None:
        full = attr.initializer(full_shape, param.dtype, param.device)
        with torch.no_grad():
            param.copy_(mp_shard(to_port(full), n, r, dim))
    if attr.trainable is False:
        param.requires_grad_(False)


def _same(t):
    return t


def _transposed(t):
    return t.t()


class VocabParallelEmbedding(nn.Embedding):
    """Embedding with the vocabulary split over mp: each rank looks up the
    ids in its rows (others give zero rows), then an all-reduce."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, device=None, dtype=None):
        self._pg, self._mp, self._mp_rank = mp_info(mp_group)
        per = _divide(num_embeddings, self._mp, "num_embeddings")
        super().__init__(per, embedding_dim, device=device, dtype=dtype)
        _draw_attr(self.weight, weight_attr, [num_embeddings, embedding_dim],
                   _same, 0, self._mp, self._mp_rank)
        self.vocab_start = self._mp_rank * per
        self._mark_params()

    def _mark_params(self):
        _mark(self.weight, 0, self._mp)

    def forward(self, x):
        if self._pg is None:
            return F.embedding(x, self.weight)
        per = self.weight.shape[0]
        local = x - self.vocab_start
        inside = (local >= 0) & (local < per)
        out = F.embedding(torch.where(inside, local, 0), self.weight)
        out = out.masked_fill(~inside[..., None], 0.0)
        return reduce_from_group(out, self._pg)


class ColumnParallelLinear(nn.Linear):
    """``y = x W^T + b`` with W's output rows (and b) split over mp; with
    ``gather_output`` the output is all-gathered on its last dim."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, device=None, dtype=None,
                 bias_attr=None):
        self._pg, self._mp, self._mp_rank = mp_info(mp_group)
        per = _divide(out_features, self._mp, "out_features")
        has_bias = bool(has_bias) and bias_attr is not False
        super().__init__(in_features, per, bias=has_bias, device=device,
                         dtype=dtype)
        n, r = self._mp, self._mp_rank
        _draw_attr(self.weight, weight_attr, [in_features, out_features],
                   _transposed, 0, n, r)
        if has_bias:
            _draw_attr(self.bias, bias_attr, [out_features], _same, 0, n, r)
        self.gather_output = gather_output
        self._mark_params()

    def _mark_params(self):
        _mark(self.weight, 0, self._mp)
        if self.bias is not None:
            _mark(self.bias, 0, self._mp)

    def forward(self, x):
        if self._pg is None:
            return linear_out_in(x, self.weight, self.bias)
        y = linear_out_in(copy_to_group(x, self._pg), self.weight, self.bias)
        return gather_from_group(y, self._pg) if self.gather_output else y


class RowParallelLinear(nn.Linear):
    """``y = x W^T + b`` with W's input columns split over mp: the partial
    products are all-reduced, then the (replicated) bias is added. Without
    ``input_is_parallel`` the input is split on its last dim first."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 device=None, dtype=None, bias_attr=None):
        self._pg, self._mp, self._mp_rank = mp_info(mp_group)
        per = _divide(in_features, self._mp, "in_features")
        has_bias = bool(has_bias) and bias_attr is not False
        super().__init__(per, out_features, bias=has_bias, device=device,
                         dtype=dtype)
        _draw_attr(self.weight, weight_attr, [in_features, out_features],
                   _transposed, 1, self._mp, self._mp_rank)
        if has_bias:  # replicated
            _draw_attr(self.bias, bias_attr, [out_features], _same, 0, 1, 0)
        self.input_is_parallel = input_is_parallel
        self._mark_params()

    def _mark_params(self):
        _mark(self.weight, 1, self._mp)

    def forward(self, x):
        if self._pg is None:
            return linear_out_in(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = scatter_to_group(x, self._pg)
        y = reduce_from_group(linear_out_in(x, self.weight), self._pg)
        return y if self.bias is None else y + self.bias


class _VocabParallelCE(torch.autograd.Function):
    """Cross entropy over logits whose vocabulary is split over the group:
    the row max, the sum of exponentials and the target's logit are
    all-reduced; the gradient is softmax - onehot on this rank's columns.
    Rows whose label is ``ignore_index`` give 0."""

    @staticmethod
    def forward(ctx, logits, labels, start, pg, ignore_index):
        x = logits.float()
        per = x.shape[-1]
        m = x.amax(dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=pg)
        e = torch.exp(x - m[:, None])
        s = e.sum(dim=-1)
        dist.all_reduce(s, group=pg)
        valid = labels != ignore_index
        local = labels - start
        inside = valid & (local >= 0) & (local < per)
        local = torch.where(inside, local, 0)
        t = torch.where(inside, x.gather(1, local[:, None])[:, 0], 0.0)
        dist.all_reduce(t, group=pg)
        loss = torch.where(valid, torch.log(s) + m - t, 0.0)
        ctx.save_for_backward(e, s, local, inside, valid)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, dloss):
        e, s, local, inside, valid = ctx.saved_tensors
        grad = e / s[:, None]
        grad.scatter_add_(1, local[:, None], -inside.float()[:, None])
        grad = grad * torch.where(valid, dloss, 0.0)[:, None]
        return grad.to(ctx.dtype), None, None, None, None


def vocab_parallel_cross_entropy(logits, labels, pg, start,
                                 ignore_index=-100):
    """Per-row CE of ``logits`` [N, vocab/mp] (this rank's columns, from
    ``start``) against global ``labels`` [N]; 0 where ignored."""
    return _VocabParallelCE.apply(logits, labels, int(start), pg,
                                  int(ignore_index))


class ParallelCrossEntropy(nn.Module):
    """CE over mp-split logits (reduction none): ``forward(input [...,
    vocab/mp], label [...])``; at mp = 1 ``F.cross_entropy``."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self._pg, self._mp, self._mp_rank = mp_info(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        lead = label.shape
        x = input.reshape(-1, input.shape[-1])
        lab = label.reshape(-1)
        if self._pg is None:
            loss = F.cross_entropy(x.float(), lab, reduction="none",
                                   ignore_index=self.ignore_index)
        else:
            loss = vocab_parallel_cross_entropy(
                x, lab, self._pg, self._mp_rank * x.shape[-1],
                self.ignore_index)
        return loss.reshape(lead)
