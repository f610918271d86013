"""Collective communication (port of ``paddle_tpu/distributed/collective.py``).

The JAX package runs one controller over every device, so its collectives
take one global tensor whose leading dim indexes the group's ranks. Here
each process is one rank and holds its own tensor, as in Paddle and
PyTorch: the functions take paddle's signatures and call
``torch.distributed`` over a process group. ``src``/``dst`` are global
ranks, as in both. The backend is the caller's: ``nccl`` on the card,
``gloo`` on the CPU.

The axis helpers (``psum``, ``pmean``, ``ppermute``, ``all_to_all_axis``,
``all_gather_axis``, ``reduce_scatter_axis``) take a mesh axis by name and
are differentiable, each backward the transpose of its forward as in JAX:
``psum``'s is ``psum`` (the cotangents of every rank summed),
``all_gather_axis``'s a reduce-scatter, ``ppermute``'s the inverse
permutation, ``all_to_all_axis``'s the all-to-all with the split and
concat dims swapped. On an axis of degree 1 each is the identity and
issues no collective. JAX's store-based point-to-point channel
(``collective.py:343-475``) works around a JAX limit; the port uses
``torch.distributed`` send and receive.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import get_mesh_env, require_mesh_env

__all__ = ["ReduceOp", "Group", "new_group", "get_group", "is_initialized",
           "init_parallel_env", "get_rank", "get_world_size", "all_reduce",
           "all_gather", "broadcast", "reduce", "reduce_scatter", "alltoall",
           "scatter", "barrier", "send", "recv", "isend", "irecv", "psum",
           "pmean", "ppermute", "axis_index", "all_to_all_axis",
           "all_gather_axis", "reduce_scatter_axis", "STORE_ENV"]

# the file a spawned rank joins its process group through
STORE_ENV = "PADDLE_TPU_TORCH_FILESTORE"


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT,
              ReduceOp.AVG: dist.ReduceOp.SUM}  # AVG: the sum, divided


class Group:
    """A process group and its ranks (paddle's ``Group``): ``nranks``,
    ``rank`` (this process's index in it, -1 outside), ``ranks`` (global),
    ``axis`` (the mesh axis it belongs to, if any)."""

    def __init__(self, process_group=None, axis: str = None, id: int = 0):
        self.process_group = process_group
        self.axis = axis
        self.id = id
        pg = process_group if process_group is not None else dist.group.WORLD
        self.ranks = list(dist.get_process_group_ranks(pg))

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    world_size = nranks

    @property
    def rank(self) -> int:
        return self.get_group_rank(dist.get_rank())

    def get_group_rank(self, rank: int) -> int:
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return (f"Group(axis={self.axis!r}, nranks={self.nranks}, "
                f"ranks={self.ranks})")


def _pg(group):
    """The torch process group of ``group`` (None = the default one)."""
    if isinstance(group, Group):
        return group.process_group
    return group


def init_parallel_env(backend: str = None, store=None, rank: int = None,
                      world_size: int = None, init_method: str = None,
                      timeout=None) -> Group:
    """Initialises the default process group once and returns it as a
    :class:`Group`. The rank and world size come from the arguments, else
    ``RANK``/``WORLD_SIZE`` (or paddle's ``PADDLE_TRAINER_ID``/
    ``PADDLE_TRAINERS_NUM``), else 0 and 1. The rendezvous: ``store``, else
    ``init_method``, else the file named by ``PADDLE_TPU_TORCH_FILESTORE``
    (what :func:`spawn` sets), else an in-process store for a world of one,
    else ``env://``. ``backend`` defaults to ``nccl`` where CUDA is
    available, ``gloo`` otherwise; under ``nccl`` the rank takes the card
    ``LOCAL_RANK`` (or the rank modulo the cards)."""
    if not dist.is_initialized():
        env = os.environ
        if rank is None:
            rank = int(env.get("RANK", env.get("PADDLE_TRAINER_ID", 0)))
        if world_size is None:
            world_size = int(env.get("WORLD_SIZE",
                                     env.get("PADDLE_TRAINERS_NUM", 1)))
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if store is None and init_method is None:
            if env.get(STORE_ENV):
                store = dist.FileStore(env[STORE_ENV], world_size)
            elif world_size == 1:
                store = dist.HashStore()
            else:
                init_method = "env://"
        if backend == "nccl":
            local = int(env.get("LOCAL_RANK",
                                rank % max(torch.cuda.device_count(), 1)))
            torch.cuda.set_device(local)
        kw = {} if timeout is None else {"timeout": timeout}
        dist.init_process_group(backend, init_method=init_method, store=store,
                                rank=rank, world_size=world_size, **kw)
    return Group(None)


def new_group(ranks: Optional[Sequence[int]] = None, backend: str = None,
              axis: str = None) -> Group:
    """A group over ``ranks`` (collective: every rank calls it), or with
    ``axis`` the installed mesh's group of that axis that holds this
    rank."""
    if axis is not None:
        env = require_mesh_env()
        return Group(env.group(axis), axis=axis)
    return Group(dist.new_group(ranks, backend=backend))


def get_group(id: int = 0) -> Group:
    return Group(None, id=id)


def is_initialized() -> bool:
    return dist.is_initialized()


def get_rank(group=None) -> int:
    if not dist.is_initialized():
        return 0
    if isinstance(group, Group):
        return group.rank
    return dist.get_rank(group)


def get_world_size(group=None) -> int:
    if not dist.is_initialized():
        return 1
    if isinstance(group, Group):
        return group.nranks
    return dist.get_world_size(group)


# -- collectives (paddle's signatures) ---------------------------------------

def _finish(work, sync_op):
    if sync_op:
        return None
    return work


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """In place: every rank's ``tensor`` becomes the reduction."""
    work = dist.all_reduce(tensor, _TORCH_OPS[op], group=_pg(group),
                           async_op=not sync_op and op != ReduceOp.AVG)
    if op == ReduceOp.AVG:
        tensor.div_(get_world_size(group))
        return None
    return _finish(work, sync_op)


def all_gather(tensor_list: List, tensor, group=None, sync_op=True):
    """Fills ``tensor_list`` (emptied first) with every rank's ``tensor``."""
    n = get_world_size(group)
    out = [torch.empty_like(tensor) for _ in range(n)]
    dist.all_gather(out, tensor.contiguous(), group=_pg(group))
    tensor_list.clear()
    tensor_list.extend(out)
    return tensor_list


def broadcast(tensor, src=0, group=None, sync_op=True):
    work = dist.broadcast(tensor, src, group=_pg(group), async_op=not sync_op)
    return _finish(work, sync_op)


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """``tensor`` on rank ``dst`` becomes the reduction."""
    dist.reduce(tensor, dst, _TORCH_OPS[op], group=_pg(group))
    if op == ReduceOp.AVG and dist.get_rank() == dst:
        tensor.div_(get_world_size(group))


def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """``tensor`` becomes the reduction over ranks of their
    ``tensor_list[my group rank]``."""
    n = get_world_size(group)
    parts = [t.reshape(tensor.shape) for t in tensor_list]
    flat = torch.cat(parts) if tensor.dim() else torch.stack(parts)
    dist.reduce_scatter_tensor(tensor, flat, _TORCH_OPS[op], group=_pg(group))
    if op == ReduceOp.AVG:
        tensor.div_(n)


def alltoall(in_tensor_list, out_tensor_list: List, group=None,
             sync_op=True):
    """Rank i's ``in_tensor_list[j]`` lands in rank j's
    ``out_tensor_list[i]`` (equal shapes)."""
    send = torch.stack([t.contiguous() for t in in_tensor_list])
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=_pg(group))
    out_tensor_list.clear()
    out_tensor_list.extend(recv.unbind(0))
    return out_tensor_list


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """``tensor`` on rank i becomes ``tensor_list[i]`` of rank ``src``."""
    parts = list(tensor_list) if dist.get_rank() == src else None
    dist.scatter(tensor, parts, src, group=_pg(group))


def barrier(group=None):
    dist.barrier(group=_pg(group))


class _Task:
    """A paddle task over a torch ``Work``: ``wait()``, ``is_completed()``."""

    def __init__(self, work):
        self._work = work

    def wait(self, timeout=None):
        self._work.wait()
        return True

    def is_completed(self):
        return self._work.is_completed()


def send(tensor, dst=0, group=None, sync_op=True):
    if sync_op:
        dist.send(tensor.contiguous(), dst, group=_pg(group))
        return None
    return _Task(dist.isend(tensor.contiguous(), dst, group=_pg(group)))


def recv(tensor, src=0, group=None, sync_op=True):
    if sync_op:
        dist.recv(tensor, src, group=_pg(group))
        return None
    return _Task(dist.irecv(tensor, src, group=_pg(group)))


def isend(tensor, dst=0, group=None):
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src=0, group=None):
    return recv(tensor, src, group, sync_op=False)


# -- differentiable axis helpers ---------------------------------------------

def _axis(axis: str):
    """(process group, degree, this rank's index) of a mesh axis."""
    env = require_mesh_env()
    return env.group(axis), env.get_dim(axis), env.coord(axis)


def axis_index(axis: str) -> int:
    """This rank's index on ``axis`` (0 without a mesh)."""
    env = get_mesh_env()
    return 0 if env is None else env.coord(axis)


def all_gather_dim(x, pg, n: int, dim: int):
    """Every rank's ``x`` concatenated along ``dim``, in group rank order."""
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, xt, group=pg)
    return out.movedim(0, dim)


def reduce_scatter_dim(x, pg, n: int, dim: int):
    """The sum over ranks of ``x``, this rank's 1/n slice along ``dim``."""
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, xt, group=pg)
    return out.movedim(0, dim)


def all_to_all_dim(x, pg, n: int, split_axis: int, concat_axis: int):
    """Tiled all-to-all: ``x`` split in n along ``split_axis``, chunk j to
    rank j; the chunks received concatenated along ``concat_axis`` in
    rank order."""
    chunks = torch.stack([c.contiguous()
                          for c in x.chunk(n, dim=split_axis)])
    recv = torch.empty_like(chunks)
    dist.all_to_all_single(recv, chunks, group=pg)
    return torch.cat(recv.unbind(0), dim=concat_axis)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        y = x.clone()
        dist.all_reduce(y, group=pg)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.pg)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, n, dim):
        ctx.args = (pg, n, dim)
        return all_gather_dim(x, pg, n, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, *ctx.args), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, n, dim):
        ctx.args = (pg, n, dim)
        return reduce_scatter_dim(x, pg, n, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, *ctx.args), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, n, split_axis, concat_axis):
        ctx.args = (pg, n, concat_axis, split_axis)
        return all_to_all_dim(x, pg, n, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_dim(g, *ctx.args), None, None, None, None


def permute_ranks(x, pg, me: int, perm: Sequence[Tuple[int, int]]):
    """``x`` sent along ``perm`` (pairs of group indices (src, dst)): this
    rank gets the tensor of its source, zeros where it has none."""
    out = torch.zeros_like(x)
    ops = []
    x = x.contiguous()
    for s, d in perm:
        if s == me and d == me:
            out.copy_(x)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(pg, d), pg))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(pg, s), pg))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, me, perm):
        ctx.args = (pg, me, [(d, s) for s, d in perm])
        return permute_ranks(x, pg, me, perm)

    @staticmethod
    def backward(ctx, g):
        return permute_ranks(g, *ctx.args), None, None, None


def psum(x, axis: str):
    pg, n, _ = _axis(axis)
    return x if n == 1 else _PSum.apply(x, pg)


def pmean(x, axis: str):
    pg, n, _ = _axis(axis)
    return x if n == 1 else _PSum.apply(x, pg) / n


def ppermute(x, axis: str, perm):
    pg, n, me = _axis(axis)
    if n == 1:
        return x if (0, 0) in [tuple(p) for p in perm] else torch.zeros_like(x)
    return _PPermute.apply(x, pg, me, [tuple(p) for p in perm])


def all_to_all_axis(x, axis: str, split_axis: int, concat_axis: int):
    pg, n, _ = _axis(axis)
    if n == 1:
        return x
    return _AllToAll.apply(x, pg, n, split_axis, concat_axis)


def all_gather_axis(x, axis: str, dim: int = 0):
    """Tiled all-gather along ``dim``; backward a reduce-scatter."""
    pg, n, _ = _axis(axis)
    return x if n == 1 else _AllGather.apply(x, pg, n, dim)


def reduce_scatter_axis(x, axis: str, dim: int = 0):
    """Sum over the axis, this rank's slice along ``dim``; backward an
    all-gather."""
    pg, n, _ = _axis(axis)
    return x if n == 1 else _ReduceScatter.apply(x, pg, n, dim)
