"""The pipeline schedule over the ``pp`` axis (port of
``paddle_tpu/distributed/meta_parallel/pipeline.py``).

The JAX package runs the pipeline as one compiled program: a ``lax.scan``
of ticks with ``lax.ppermute`` as the stage handoff, whose autodiff is the
cooldown (``ppermute_pipeline``). Here each pp rank is a process that
holds one stage, and the schedule is the one the tick scan stands for,
Paddle's 1F1B (``fleet/meta_parallel/pipeline_parallel.py:80``
``forward_backward_pipeline``): stage ``r`` of ``pp`` runs ``pp - 1 - r``
warm-up forwards, then alternates one forward and one backward, then
cools down with the backwards left. The bubble is the same
``(pp - 1) / (M + pp - 1)``.

A stage's schedule is a per-rank body (:func:`stage_body`), a generator
that yields each hop it needs (send an activation forward, receive one,
send a gradient back, receive one, or a send and a receive as one pair)
and is sent what it receives, as ``context_parallel.py`` does for the
ring. Two transports drive it:

- :class:`P2PTransport` over the pp group: each hop is one
  ``batch_isend_irecv`` (a pair in one call, so neighbours never deadlock
  on their order), NCCL on the card, gloo on the CPU. The first call
  sends the activation's shape and dtype ahead of it, the SendRecvMeta
  handshake (``p2p_communication.py:38``): every stage must map one fixed
  (shape, dtype) to the same, and anything else raises.
- :func:`run_local`: every stage's body in one process, each hop a
  hand-over through a mailbox; how one card runs the whole pipeline
  (:func:`pipeline_local`).

A stage is a module with ``pipeline_forward(inp, *microbatch)``: ``inp``
is the activation received (None on the first stage, which reads the
microbatch), the result the activation to send on, or on the last stage
the microbatch's loss (``LlamaForCausalLM``, ``PipelineLayer``). Each
stage sums its parameters' gradients in fp32 in microbatch order, as
``jit.AccumulateStep`` does.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from ..mesh import get_mesh_env

__all__ = ["bubble_fraction", "choose_microbatches", "microbatch",
           "unmicrobatch", "one_f_one_b", "stage_body", "StageRun",
           "P2PTransport", "run_local", "pipeline_local", "pipeline_meta"]


def _batch_shard_degree(env) -> int:
    env = env if env is not None else get_mesh_env()
    if env is None:
        return 1
    d = 1
    for ax in ("dp", "sdp"):
        d *= max(env.get_dim(ax), 1)
    return d


def bubble_fraction(num_microbatches: int, pp: int) -> float:
    """Fill/drain idle share of the pipeline: ``(pp - 1) / (M + pp - 1)``,
    the 1F1B schedule's bubble."""
    return (pp - 1) / (num_microbatches + pp - 1)


def choose_microbatches(batch: int, desired: int, env=None) -> int:
    """The largest ``M <= desired`` with ``batch % (M * d) == 0``, ``d`` the
    data ranks (dp x sdp): each data rank's local batch splits into M whole
    microbatches (Paddle's ``micro_batch_size * accumulate_steps`` = local
    batch). Falls back to the largest divisor of ``batch``; warns whenever
    the answer differs from ``desired``, naming the batch that keeps it
    (JAX ``pipeline.py:87-120``)."""
    d = _batch_shard_degree(env)
    chosen = 1
    for m in range(min(desired, max(batch // d, 1)), 0, -1):
        if batch % (m * d) == 0:
            chosen = m
            break
    else:
        for m in range(min(desired, batch), 0, -1):
            if batch % m == 0:
                chosen = m
                break
    if chosen != desired:
        e = env if env is not None else get_mesh_env()
        pp = max(e.get_dim("pp"), 1) if e is not None else 1
        warnings.warn(
            f"pipeline microbatches clamped {desired} -> {chosen}: each "
            f"microbatch must hold >=1 row from every one of the {d} data "
            f"shards (each rank's local batch splits into M microbatches), "
            f"which batch {batch} cannot satisfy for M={desired}. Bubble "
            f"fraction {bubble_fraction(desired, pp):.0%} -> "
            f"{bubble_fraction(chosen, pp):.0%}; use a global batch that "
            f"is a multiple of {desired * d} to keep M={desired}")
    return chosen


def microbatch(x, num_microbatches: int):
    """This rank's local batch ``[b, ...]`` -> ``[M, b / M, ...]``. The
    JAX package interleaves the data shards into every microbatch, a GSPMD
    layout matter (its ``pipeline.py:135-157``); a rank here holds only its
    own rows, so the split is a plain reshape. Non-tensors pass through."""
    if not isinstance(x, torch.Tensor):
        return x
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} not divisible by {num_microbatches} "
                         f"microbatches")
    return x.reshape((num_microbatches, b // num_microbatches)
                     + tuple(x.shape[1:]))


def unmicrobatch(x_mb):
    """The inverse of :func:`microbatch`."""
    return x_mb.reshape((x_mb.shape[0] * x_mb.shape[1],)
                        + tuple(x_mb.shape[2:]))


def one_f_one_b(pp: int, rank: int, m: int) -> List[tuple]:
    """Stage ``rank``'s op order: ``("F", i)`` and ``("B", i)``, the
    warm-up forwards, the one-forward-one-backward steady state, the
    cooldown backwards."""
    warm = min(pp - rank - 1, m)
    ops = [("F", i) for i in range(warm)]
    for j in range(m - warm):
        ops += [("F", warm + j), ("B", j)]
    ops += [("B", j) for j in range(m - warm, m)]
    return ops


def stage_body(run: "StageRun", pp: int, rank: int, m: int):
    """Stage ``rank``'s 1F1B schedule as a generator: it yields ``(hop,
    tensor)`` and is sent what the hop receives. Hops: ``recv_fwd``,
    ``send_fwd``, ``recv_bwd``, ``send_bwd``, ``send_fwd_recv_bwd``,
    ``send_bwd_recv_fwd``; a transport skips the side a first or last
    stage has no neighbour on (and sends back None for it)."""
    warm = min(pp - rank - 1, m)
    rest = m - warm
    for i in range(warm):
        x = yield ("recv_fwd", None)
        y = run.forward(i, x)
        yield ("send_fwd", y)
    x = (yield ("recv_fwd", None)) if rest else None
    for j in range(rest):
        y = run.forward(warm + j, x)
        dy = yield ("send_fwd_recv_bwd", y)
        dx = run.backward(j, dy)
        if j == rest - 1:
            x = None
            yield ("send_bwd", dx)
        else:
            x = yield ("send_bwd_recv_fwd", dx)
    for j in range(rest, m):
        dy = yield ("recv_bwd", None)
        dx = run.backward(j, dy)
        yield ("send_bwd", dx)


def pipeline_meta(t: torch.Tensor) -> tuple:
    return (tuple(t.shape), t.dtype)


class StageRun:
    """One stage's share of one step: ``forward(i, inp)`` runs microbatch
    ``i`` through ``stage.pipeline_forward`` and keeps what its backward
    needs; ``backward(i, dout)`` returns the gradient of the stage's input
    (None on the first stage) and adds each parameter's gradient, in fp32
    and times ``grad_scale``, into ``acc`` (one tensor per entry of
    ``params``), microbatch by microbatch in order.

    ``mbs``: the microbatches, a list of tuples; ``first`` / ``last``: the
    stage's place; ``seed``: what the last stage's loss is multiplied by
    before its backward (a loss scale, as a tensor, or None); ``meta``:
    the (shape, dtype) every activation must have, None until the first
    one fixes it.

    A stage whose ``pipeline_forward`` returns ``(result, aux)`` adds the
    scalar ``aux`` (an MoE stage's aux-loss share) to its own objective:
    its backward seeds it as the loss is seeded, whatever stage it is, and
    its values are kept in ``aux``, in microbatch order."""

    def __init__(self, stage, mbs: Sequence[tuple], params, acc, first: bool,
                 last: bool, seed=None, grad_scale=None, meta=None):
        self.stage = stage
        self.mbs = list(mbs)
        self.params = list(params)
        self.acc = acc
        self.first, self.last = first, last
        self.seed = seed
        self.grad_scale = grad_scale
        self.meta = meta
        self.losses: List[torch.Tensor] = []
        self.aux: List[torch.Tensor] = []
        self._saved: Dict[int, tuple] = {}

    def _check(self, t, what):
        got = pipeline_meta(t)
        if self.meta is None:
            self.meta = got
        elif got != self.meta:
            raise ValueError(
                f"pipeline: {what} {got[0]} {got[1]} breaks the SendRecvMeta "
                f"contract: every stage maps one fixed (shape, dtype) "
                f"{self.meta[0]} {self.meta[1]} to the same")

    def forward(self, i: int, inp):
        if inp is not None:
            self._check(inp, "a received activation")
            inp = inp.detach().requires_grad_(True)
        out = self.stage.pipeline_forward(inp, *self.mbs[i])
        aux = None
        if isinstance(out, tuple):
            out, aux = out
            self.aux.append(aux.detach().float())
        if self.last:
            self.losses.append(out.detach().float())
        else:
            self._check(out, "a stage's output")
        self._saved[i] = (inp, out, aux)
        return None if self.last else out.detach()

    def _seeded(self, t):
        return torch.ones_like(t) if self.seed is None else \
            self.seed.reshape(t.shape).to(t.dtype)

    def backward(self, i: int, dout):
        inp, out, aux = self._saved.pop(i)
        if self.last:
            dout = None if self.seed is None and aux is None else \
                self._seeded(out)
        elif dout is None:
            raise RuntimeError("pipeline: a stage's backward got no "
                               "gradient from the next stage")
        outs, douts = out, dout
        if aux is not None:
            outs, douts = [out, aux], [dout, self._seeded(aux)]
        wrt = ([inp] if inp is not None else []) + self.params
        grads = torch.autograd.grad(outs, wrt, grad_outputs=douts,
                                    allow_unused=True)
        din = grads[0] if inp is not None else None
        with torch.no_grad():
            for a, g in zip(self.acc, grads[len(grads) - len(self.params):]):
                if g is not None:
                    a.add_(g.float() if self.grad_scale is None
                           else g.float() * self.grad_scale)
        return din


_META_WORDS = 10  # ndim, up to 8 dims, dtype code
_DTYPE_CODES = [torch.float32, torch.bfloat16, torch.float16, torch.float64]


def _meta_tensor(meta, device):
    shape, dtype = meta
    words = [len(shape)] + list(shape) + [0] * (8 - len(shape)) + \
        [_DTYPE_CODES.index(dtype)]
    return torch.tensor(words, dtype=torch.int64, device=device)


def _meta_of(words) -> tuple:
    w = [int(x) for x in words.tolist()]
    return (tuple(w[1:1 + w[0]]), _DTYPE_CODES[w[9]])


class P2PTransport:
    """The hops of :func:`stage_body` over the pp group ``pg`` (this rank
    ``rank`` of ``pp``): every hop one ``dist.batch_isend_irecv`` call, a
    send and a receive of a pair in the same call. Received tensors take
    the activation's (shape, dtype), which the first send of a signature
    carries ahead of it (``meta``; :class:`StageRun` holds every stage to
    it)."""

    def __init__(self, pg, rank: int, pp: int, device):
        self.pg, self.rank, self.pp = pg, rank, pp
        self.device = device
        self.meta = None
        self._told_next = False  # the meta went ahead of the first send
        self._prev = dist.get_global_rank(pg, rank - 1) if rank > 0 else None
        self._next = dist.get_global_rank(pg, rank + 1) \
            if rank < pp - 1 else None

    def _exchange(self, sends, recv_from):
        ops = [dist.P2POp(dist.isend, t.contiguous(), dst, self.pg)
               for t, dst in sends]
        buf = None
        if recv_from is not None:
            buf = torch.empty(self.meta[0], dtype=self.meta[1],
                              device=self.device)
            ops.append(dist.P2POp(dist.irecv, buf, recv_from, self.pg))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return buf

    def _handshake_send(self, t):
        if not self._told_next:
            if self.meta is None:
                self.meta = pipeline_meta(t)
            self._exchange([(_meta_tensor(pipeline_meta(t), self.device),
                             self._next)], None)
            self._told_next = True

    def _handshake_recv(self):
        if self.meta is None:
            words = torch.empty(_META_WORDS, dtype=torch.int64,
                                device=self.device)
            for w in dist.batch_isend_irecv([dist.P2POp(
                    dist.irecv, words, self._prev, self.pg)]):
                w.wait()
            self.meta = _meta_of(words)

    def __call__(self, hop: str, t):
        nxt, prev = self._next, self._prev
        if hop == "recv_fwd":
            if prev is None:
                return None
            self._handshake_recv()
            return self._exchange([], prev)
        if hop == "send_fwd":
            if nxt is not None:
                self._handshake_send(t)
                self._exchange([(t, nxt)], None)
            return None
        if hop == "recv_bwd":
            return None if nxt is None else self._exchange([], nxt)
        if hop == "send_bwd":
            if prev is not None:
                self._exchange([(t, prev)], None)
            return None
        if hop == "send_fwd_recv_bwd":
            if nxt is None:
                return None
            self._handshake_send(t)
            return self._exchange([(t, nxt)], nxt)
        if hop == "send_bwd_recv_fwd":
            if prev is None:
                return None
            return self._exchange([(t, prev)], prev)
        raise ValueError(f"unknown pipeline hop {hop!r}")


def drive(body, transport) -> None:
    """Runs one stage's body over ``transport`` to its end."""
    got = None
    while True:
        try:
            hop, t = body.send(got)
        except StopIteration:
            return
        got = transport(hop, t)


def run_local(runs: Sequence[StageRun], m: int) -> None:
    """Every stage's body on this process: each hop a hand-over through
    per-stage mailboxes (forward activations to stage r + 1, input
    gradients to r - 1), the bodies advanced in turn, each as far as its
    receives allow. Raises where no body can move (a schedule that would
    deadlock)."""
    pp = len(runs)
    fwd: List[List[torch.Tensor]] = [[] for _ in range(pp)]
    bwd: List[List[torch.Tensor]] = [[] for _ in range(pp)]
    bodies = [stage_body(r, pp, i, m) for i, r in enumerate(runs)]
    pending = [None] * pp  # (hop, tensor, sent) a body waits on
    got = [None] * pp
    done = [False] * pp

    def step(r):
        """Advances body r until it blocks or ends; True where it moved."""
        moved = False
        while not done[r]:
            if pending[r] is None:
                try:
                    hop, t = bodies[r].send(got[r])
                except StopIteration:
                    done[r] = True
                    return True
                got[r] = None
                pending[r] = [hop, t, False]
                moved = True
            hop, t, sent = pending[r]
            first, last = r == 0, r == pp - 1
            if hop in ("send_fwd", "send_fwd_recv_bwd") and not sent:
                if not last:
                    fwd[r + 1].append(t)
                pending[r][2] = True
            if hop in ("send_bwd", "send_bwd_recv_fwd") and not sent:
                if not first:
                    bwd[r - 1].append(t)
                pending[r][2] = True
            if hop in ("recv_fwd", "send_bwd_recv_fwd"):
                if first:
                    got[r] = None
                elif fwd[r]:
                    got[r] = fwd[r].pop(0)
                else:
                    return moved
            elif hop in ("recv_bwd", "send_fwd_recv_bwd"):
                if last:
                    got[r] = None
                elif bwd[r]:
                    got[r] = bwd[r].pop(0)
                else:
                    return moved
            pending[r] = None
            moved = True
        return moved

    while not all(done):
        if not any([step(r) for r in range(pp)]):
            raise RuntimeError("pipeline_local: no stage can move (the "
                               "schedule deadlocks)")


def _fp32_acc(params):
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in params]


def pipeline_local(stages: Sequence[torch.nn.Module], *batch,
                   num_microbatches: int, seed=None, grad_scale=None):
    """Every stage of a pipeline on this process (one device), the 1F1B
    bodies driven by :func:`run_local`: ``batch`` splits on dim 0 into
    ``num_microbatches``; each stage gets every microbatch (a stage's
    ``pipeline_forward`` reads what it needs). Calls each stage's
    ``pipeline_prepare(*batch)`` where it has one first. Returns (the
    losses of the microbatches, fp32 [M]; per stage the fp32 gradient sums
    of its trainable parameters, None where a parameter got none). The
    stages' aux shares (:class:`StageRun`) are added to the losses of
    their microbatches."""
    m = int(num_microbatches)
    mbs = list(zip(*[microbatch(a, m) if isinstance(a, torch.Tensor)
                     else [a] * m for a in batch]))
    runs = []
    pp = len(stages)
    for r, st in enumerate(stages):
        if hasattr(st, "pipeline_prepare"):
            st.pipeline_prepare(*batch)
        params = [p for p in st.parameters() if p.requires_grad]
        runs.append(StageRun(st, mbs, params, _fp32_acc(params), r == 0,
                             r == pp - 1, seed=seed, grad_scale=grad_scale))
    run_local(runs, m)
    losses = torch.stack(runs[-1].losses)
    for r in runs:
        if r.aux:
            losses = losses + torch.stack(r.aux)
    return losses, [r.acc for r in runs]
