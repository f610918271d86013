"""Context parallelism: ring and Ulysses attention over the ``cp`` axis
(port of ``paddle_tpu/distributed/context_parallel.py``).

The sequence is split over cp; each rank holds its chunk of q, k and v.

**Ring.** Each rank keeps its queries and passes K/V chunks around the
ring, one hop a step; step ``r`` attends to the chunk that started on rank
``src = (idx - r) mod cp`` through the flash kernels with the global
causal ``offset = (idx - src) * s_loc`` (``context_parallel.py:52-59``):
a chunk wholly in the future gives o = 0, lse = -1e30, one wholly in the
past is fully visible. Every step calls the kernel, masked ones too, as
the JAX ring does. The partials merge in log-sum-exp space in fp32 and are
cast once at the end (``:30-36, 80``). The ring is one
``torch.autograd.Function`` that saves q, its own k and v, o and the
global lse, so a rank's memory stays O(s / cp): its backward runs the ring
again and calls the dK/dV and dQ kernels at each step with the saved
global lse and ``delta = rowsum(dO * O)``, exact since ``p = exp(s -
lse_global)``; the dK/dV sums travel the ring with their chunk and one
last hop takes them to their owners (JAX recomputes each step under
``jax.checkpoint`` and sends them back through ppermute's transpose).

The per-rank body (the kernel calls at their offsets and the merge) is
kept apart from the transport (the hop): a body is a generator that yields
what it sends and is sent what it receives. :func:`ring_attention_bhsd`
drives one body per process over the cp group's send/receive;
:func:`ring_attention_local` drives all cp bodies in lock step on one
device, each hop a rotation of their list, which is how one card runs the
same body at full width.

**Ulysses.** One all-to-all turns the sequence split into a head split
(each rank then holds every position of h/cp heads), flash attention runs
on the whole sequence, and a second all-to-all turns it back; it raises
``ValueError`` when the heads do not divide by cp (``:157-161``). Its
per-rank body is a generator too, yielding each all-to-all:
:func:`ulysses_attention_bshd` sends them over the cp group,
:func:`ulysses_attention_local` exchanges the pieces between all cp
bodies on one device.

The kernel wrappers launch on CUDA tensors or raise; on CPU tensors they
run their plain versions.
"""
from __future__ import annotations

import math
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist

from ..kernels.flash_attention import (flash_attention,
                                       flash_attention_bwd_dkv,
                                       flash_attention_bwd_dq,
                                       flash_attention_fwd,
                                       flash_attention_with_lse)
from .collective import all_to_all_axis
from .mesh import MeshEnv, get_mesh_env

__all__ = ["ring_attention_bhsd", "ring_attention", "ring_attention_local",
           "ulysses_attention_bshd", "ulysses_attention",
           "ulysses_attention_local", "ring_offset", "ring_forward_body",
           "ring_backward_body", "ulysses_body", "merge_partials"]


def ring_offset(idx: int, r: int, cp: int, s_loc: int) -> int:
    """The causal offset of ring step ``r`` on rank ``idx``: q's global
    positions start at ``idx * s_loc``, the chunk held then at ``src *
    s_loc`` with ``src = (idx - r) mod cp``."""
    return (idx - (idx - r) % cp) * s_loc


def merge_partials(o, lse, o_r, lse_r):
    """Two partial attentions of the same queries merged in lse space, in
    fp32: ``o`` fp32, ``o_r`` in any dtype."""
    new = torch.logaddexp(lse, lse_r)
    return (o * torch.exp(lse - new)[..., None]
            + o_r.float() * torch.exp(lse_r - new)[..., None]), new


def ring_forward_body(q, k, v, idx, cp, causal, scale):
    """Rank ``idx``'s forward: yields its K/V pair to pass on and is sent
    the previous rank's; returns (o in q's dtype, lse fp32)."""
    s_loc = q.shape[1]
    kv = (k, v)
    o = lse = None
    for r in range(cp):
        if r:
            kv = yield kv
        off = ring_offset(idx, r, cp, s_loc) if causal else 0
        o_r, lse_r = flash_attention_fwd(q, kv[0], kv[1], off, causal, scale)
        if r == 0:
            o, lse = o_r.float(), lse_r
        else:
            o, lse = merge_partials(o, lse, o_r, lse_r)
    return o.to(q.dtype), lse


def ring_backward_body(q, k, v, o, lse, do, idx, cp, causal, scale):
    """Rank ``idx``'s backward: the K/V chunks travel the ring again with
    their fp32 dK/dV sums, which a last hop hands to their owners; returns
    (dq, dk, dv) in the inputs' dtypes."""
    s_loc = q.shape[1]
    do = do.contiguous()
    delta = (do.float() * o.float()).sum(dim=-1)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    kc, vc = k, v
    for r in range(cp):
        if r:
            kc, vc, dk, dv = yield (kc, vc, dk, dv)
        off = ring_offset(idx, r, cp, s_loc) if causal else 0
        dk_r, dv_r = flash_attention_bwd_dkv(q, kc, vc, do, lse, delta, off,
                                             causal, scale)
        dq_r = flash_attention_bwd_dq(q, kc, vc, do, lse, delta, off, causal,
                                      scale)
        dq += dq_r.float()
        dk += dk_r.float()
        dv += dv_r.float()
    if cp > 1:
        dk, dv = yield (dk, dv)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _drive(bodies, shift: Callable[[List[tuple]], List[tuple]]):
    """Runs per-rank bodies in lock step: what they yield goes through
    ``shift`` (a list in, the list each receives out) until all return."""
    results = [None] * len(bodies)
    received = None
    while True:
        sends = []
        for i, body in enumerate(bodies):
            try:
                sends.append(body.send(None if received is None
                                       else received[i]))
            except StopIteration as stop:
                results[i] = stop.value
        if not sends:
            return results
        if len(sends) != len(bodies):
            raise RuntimeError("per-rank bodies out of step")
        received = shift(sends)


class _LocalRing:
    """Every rank of the ring in this process, on one device: a hop
    passes rank i's payload to rank i + 1."""

    def __init__(self, cp):
        self.idxs = list(range(cp))
        self.cp = cp

    def shift(self, sends):
        return [sends[(i - 1) % self.cp] for i in range(self.cp)]


class _GroupRing:
    """This process's rank of the ring over a process group: a hop sends
    to the next rank and receives from the previous one."""

    def __init__(self, pg, idx, cp):
        self.idxs = [idx]
        self.cp = cp
        self.pg = pg
        self.nxt = dist.get_global_rank(pg, (idx + 1) % cp)
        self.prv = dist.get_global_rank(pg, (idx - 1) % cp)

    def shift(self, sends):
        (payload,) = sends
        out = tuple(torch.empty_like(t) for t in payload)
        ops = []
        for t, o in zip(payload, out):
            ops.append(dist.P2POp(dist.isend, t.contiguous(), self.nxt,
                                  self.pg))
            ops.append(dist.P2POp(dist.irecv, o, self.prv, self.pg))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return [out]


class _RingAttention(torch.autograd.Function):
    """The ring over the ranks ``ring.idxs`` this process drives, their
    q, k, v given in that order: saves each rank's q, own k and v, o and
    lse, nothing else."""

    @staticmethod
    def forward(ctx, ring, causal, scale, *qkv):
        n = len(ring.idxs)
        qs, ks, vs = qkv[:n], qkv[n:2 * n], qkv[2 * n:]
        res = _drive([ring_forward_body(q, k, v, i, ring.cp, causal, scale)
                      for q, k, v, i in zip(qs, ks, vs, ring.idxs)],
                     ring.shift)
        os_ = [o for o, _ in res]
        ctx.save_for_backward(*qs, *ks, *vs, *os_, *[l for _, l in res])
        ctx.args = (ring, causal, scale)
        return tuple(os_)

    @staticmethod
    def backward(ctx, *dos):
        ring, causal, scale = ctx.args
        n = len(ring.idxs)
        t = ctx.saved_tensors
        qs, ks, vs, os_, lses = (t[i * n:(i + 1) * n] for i in range(5))
        dos = [torch.zeros_like(o) if d is None else d
               for d, o in zip(dos, os_)]
        res = _drive([ring_backward_body(qs[j], ks[j], vs[j], os_[j],
                                         lses[j], dos[j], ring.idxs[j],
                                         ring.cp, causal, scale)
                      for j in range(n)], ring.shift)
        return (None, None, None, *[r[0] for r in res],
                *[r[1] for r in res], *[r[2] for r in res])


def _scale(scale, d):
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def _cp(env: MeshEnv, axis):
    env = env or get_mesh_env()
    return env, (env.get_dim(axis) if env is not None else 1)


def ring_attention_bhsd(q, k, v, causal=True, scale=None,
                        env: MeshEnv = None, axis: str = "cp"):
    """This rank's chunks q/k/v [bh, s_loc, d] of a sequence split over
    ``axis`` -> its chunk of the output [bh, s_loc, d]. Differentiable."""
    env, cp = _cp(env, axis)
    scale = _scale(scale, q.shape[-1])
    if cp <= 1:
        return flash_attention_with_lse(q, k, v, 0, causal, scale)[0]
    ring = _GroupRing(env.group(axis), env.coord(axis), cp)
    return _RingAttention.apply(ring, bool(causal), scale, q, k, v)[0]


def ring_attention_local(qs: Sequence, ks: Sequence, vs: Sequence,
                         causal=True, scale=None) -> List[torch.Tensor]:
    """The ring over ``len(qs)`` chunks on one device (chunk i the rank
    i's, [bh, s_loc, d]) through the same per-rank body -> the output
    chunks. Differentiable."""
    cp = len(qs)
    scale = _scale(scale, qs[0].shape[-1])
    return list(_RingAttention.apply(_LocalRing(cp), bool(causal), scale,
                                     *qs, *ks, *vs))


def _bhsd(t):
    b, s, h, d = t.shape
    return t.transpose(1, 2).reshape(b * h, s, d)


def ring_attention(q, k, v, causal=True, scale=None, env: MeshEnv = None):
    """Paddle layout [b, s_loc, h, d], the sequence split over ``cp``."""
    b, s, h, d = q.shape
    o = ring_attention_bhsd(_bhsd(q), _bhsd(k), _bhsd(v), causal, scale, env)
    return o.reshape(b, h, s, d).transpose(1, 2)


def _check_heads(h, cp):
    if h % cp:
        raise ValueError(
            f"ulysses needs num_heads ({h}) divisible by cp={cp}; use ring "
            f"attention (cp_impl='ring') for this head count")


def ulysses_body(q, k, v, causal, scale):
    """One rank's Ulysses on its chunks [b, s_loc, h, d]: yields each
    all-to-all it needs as (tensors, split dim, concat dim) and is sent
    the tensors that come back; returns its output chunk."""
    qh, kh, vh = yield (q, k, v), 2, 1  # sequence split -> head split
    oh = flash_attention(qh, kh, vh, causal=causal, scale=scale)
    (o,) = yield (oh,), 1, 2  # and back
    return o


def _local_all_to_all(sends):
    """Every rank's all-to-all in this process: rank j gets piece j of each
    rank's tensor along the split dim, concatenated in rank order."""
    cp = len(sends)
    _, split, cat = sends[0]
    # one chunk call a tensor: its backward then joins the pieces' gradients
    pieces = [[t.chunk(cp, dim=split) for t in ts] for ts, _, _ in sends]
    return [tuple(torch.cat([p[n][j] for p in pieces], dim=cat)
                  for n in range(len(pieces[0])))
            for j in range(cp)]


def ulysses_attention_bshd(q, k, v, causal=True, scale=None,
                           env: MeshEnv = None, axis: str = "cp"):
    """This rank's chunks q/k/v [b, s_loc, h, d] -> its output chunk, by
    two all-to-alls around flash attention over h/cp heads."""
    env, cp = _cp(env, axis)
    scale = _scale(scale, q.shape[-1])
    if cp <= 1:
        return flash_attention(q, k, v, causal=causal, scale=scale)
    _check_heads(q.shape[2], cp)

    def all_to_all(sends):
        ((ts, split, cat),) = sends
        return [tuple(all_to_all_axis(t, axis, split, cat) for t in ts)]

    return _drive([ulysses_body(q, k, v, causal, scale)], all_to_all)[0]


ulysses_attention = ulysses_attention_bshd


def ulysses_attention_local(qs: Sequence, ks: Sequence, vs: Sequence,
                            causal=True, scale=None) -> List[torch.Tensor]:
    """Ulysses over ``len(qs)`` chunks [b, s_loc, h, d] on one device
    through the same per-rank body, the all-to-alls exchanging pieces
    between the chunks in this process. Differentiable."""
    _check_heads(qs[0].shape[2], len(qs))
    scale = _scale(scale, qs[0].shape[-1])
    return _drive([ulysses_body(q, k, v, causal, scale)
                   for q, k, v in zip(qs, ks, vs)], _local_all_to_all)
