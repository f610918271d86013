"""Data parallelism and the sharded training step (port of
``paddle_tpu/distributed/parallel.py``).

The JAX package compiles forward, backward and update over the mesh as one
program and GSPMD inserts the reductions. Here each process is one rank
and the reductions are explicit:

- :class:`DataParallel` is Paddle's: a bucketed gradient all-reduce
  (``comm_buffer_size`` MB a bucket) launched in the backward as each
  bucket's gradients are ready and averaged over the group, which
  ``no_sync`` pauses. The JAX wrapper is a no-op with a warning
  (``parallel.py:36-52``) because its compiled step reduces.
- :class:`ShardedTrainStep` takes the global batch, keeps this rank's
  slice (dim 0 over dp x sdp, dim 1 over cp), runs the forward and
  backward, reduces the gradients over the data ranks (dp x sdp x cp),
  applies the optimizer's fused update to this rank's shards and
  gathers what ZeRO split. On a CUDA model with ``graph`` it is one
  captured CUDA graph a step, collectives included (``jit.TrainStep``'s
  machinery). Under pp it runs the 1F1B pipeline of this rank's stage;
  with a ``GradScaler`` its loss-scale state machine runs on the device;
  ``accum_steps`` merges gradients across calls.
- :class:`ShardedAccumulateStep` (``ShardedTrainStep.accumulate``): k
  microbatches of the global batch in one call, one update.

What must agree with the JAX ``ShardedTrainStep`` is the global result:
the losses, and the parameters once gathered.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..jit import _Step, _active_generators
from ..kernels import optimizer as _kopt
from ..nn.functional.common import rewinding
from .collective import _pg, all_gather_dim, reduce_scatter_dim
from .mesh import MESH_ORDER, MeshEnv, get_mesh_env, require_mesh_env
from .meta_parallel.mp_layers import mark_parameters

__all__ = ["DataParallel", "ShardedTrainStep", "ShardedAccumulateStep",
           "param_sharding",
           "zero_partition_spec", "place_model", "default_batch_sharding",
           "shard_batch", "DATA_AXES"]

DATA_AXES = ("dp", "sdp", "cp")  # the ranks that see different data
_BUCKET_BYTES = 25 * 2 ** 20  # a gradient all-reduce's bucket, as Paddle's


def _buckets(tensors, limit_bytes):
    """Consecutive runs of ``tensors`` of one dtype and device, each at
    most ``limit_bytes`` (a larger tensor alone)."""
    out, cur, size = [], [], 0
    for t in tensors:
        nb = t.numel() * t.element_size()
        if cur and (t.dtype != cur[0].dtype or t.device != cur[0].device
                    or size + nb > limit_bytes):
            out.append(cur)
            cur, size = [], 0
        cur.append(t)
        size += nb
    if cur:
        out.append(cur)
    return out


def _flat(bucket):
    return torch.cat([t.reshape(-1) for t in bucket])


def _unflat(flat, bucket):
    off = 0
    for t in bucket:
        n = t.numel()
        t.copy_(flat[off:off + n].view(t.shape))
        off += n


def all_reduce_bucketed(tensors, pg, limit_bytes: int, scale=None):
    """Sums ``tensors`` in place over ``pg``, a flat all-reduce a bucket,
    each then multiplied by ``scale`` (None: not)."""
    for bucket in _buckets(tensors, limit_bytes):
        flat = _flat(bucket)
        dist.all_reduce(flat, group=pg)
        if scale is not None:
            flat.mul_(scale)
        _unflat(flat, bucket)


class DataParallel(nn.Module):
    """Paddle's ``DataParallel`` (reference ``parallel.py:410``): wraps
    ``layers``; each backward all-reduces the gradients bucket by bucket
    over ``group`` (default: the mesh's data ranks, else the world) and
    averages them, so every rank holds the gradient of the mean loss over
    their batches. ``no_sync()`` pauses it: gradients accumulate locally
    and the first backward after it reduces the sums."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        if group is not None:
            self._group = _pg(group)
        else:
            env = get_mesh_env()
            self._group = env.group_over(DATA_AXES) if env is not None \
                else None
        self._n = dist.get_world_size(self._group)
        self._sync = True
        params = [p for p in layers.parameters() if p.requires_grad]
        self._bucket_of: Dict[int, int] = {}
        self._plan = _buckets(list(reversed(params)),
                              int(comm_buffer_size * 2 ** 20))
        for bi, bucket in enumerate(self._plan):
            for p in bucket:
                self._bucket_of[id(p)] = bi
                p.register_post_accumulate_grad_hook(self._ready)
        self._reset()

    def _reset(self):
        self._seen = [0] * len(self._plan)
        self._works = {}
        self._queued = False

    def _ready(self, p):
        if not self._sync:
            return
        if not self._queued:
            torch.autograd.Variable._execution_engine.queue_callback(
                self._finish)
            self._queued = True
        bi = self._bucket_of[id(p)]
        self._seen[bi] += 1
        if self._seen[bi] == len(self._plan[bi]):
            self._launch(bi)

    def _launch(self, bi):
        have = [p.grad for p in self._plan[bi] if p.grad is not None]
        if have:
            flat = _flat(have)
            self._works[bi] = (have, flat, dist.all_reduce(
                flat, group=self._group, async_op=True))

    def _finish(self):
        for bi in range(len(self._plan)):  # buckets with an unused parameter
            if bi not in self._works and self._seen[bi]:
                self._launch(bi)
        for have, flat, work in self._works.values():
            work.wait()
            flat.div_(self._n)
            _unflat(flat, have)
        self._reset()

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    @contextlib.contextmanager
    def no_sync(self):
        """Pauses the gradient all-reduce (reference ``parallel.py:540``)."""
        prev, self._sync = self._sync, False
        try:
            yield
        finally:
            self._sync = prev

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        """Averages every gradient over the group now (after backwards run
        under ``no_sync``)."""
        grads = [p.grad for p in self._layers.parameters()
                 if p.grad is not None]
        all_reduce_bucketed(grads, self._group, _BUCKET_BYTES,
                            scale=1.0 / self._n)

    def parameters(self, recurse=True):
        return self._layers.parameters(recurse)

    def named_parameters(self, *a, **k):
        return self._layers.named_parameters(*a, **k)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def load_state_dict(self, *a, **k):
        return self._layers.load_state_dict(*a, **k)

    set_state_dict = load_state_dict


def zero_partition_spec(shape, env: MeshEnv, axis="sdp"):
    """The ZeRO split of a tensor over ``axis`` (JAX ``parallel.py:95-110``):
    a spec tuple with ``axis`` on the largest dim that divides by the
    degree (the first of equals), None where nothing divides or the
    degree is 1."""
    deg = env.get_dim(axis)
    if deg <= 1:
        return None
    best = None
    for i, s in enumerate(shape):
        if s % deg == 0 and (best is None or s > shape[best]):
            best = i
    if best is None:
        return None
    spec = [None] * len(shape)
    spec[best] = axis
    return tuple(spec)


def _zero_dim(shape, env):
    spec = zero_partition_spec(shape, env)
    return None if spec is None else spec.index("sdp")


def param_sharding(p, env: MeshEnv):
    """Where ``p``'s dims are split: a tuple over its dims of None or the
    axis (``"ep"`` for an expert-parallel shard, ``"mp"`` for a
    tensor-parallel one, ``"sdp"`` for a ZeRO-3 one)."""
    spec = [None] * p.dim()
    if getattr(p, "ep_dim", None) is not None:
        spec[p.ep_dim] = "ep"
    if getattr(p, "mp_dim", None) is not None:
        spec[p.mp_dim] = "mp"
    if getattr(p, "zero3_dim", None) is not None:
        spec[p.zero3_dim] = "sdp"
    return tuple(spec)


def place_model(model: nn.Module, env: Optional[MeshEnv] = None):
    """Makes every replica equal: each parameter is broadcast from the
    first rank of the ranks that hold the same shard of it, each buffer
    from rank 0 (the broadcast-at-init of Paddle's wrappers)."""
    env = env or require_mesh_env()
    mark_parameters(model)
    with torch.no_grad():
        for p in model.parameters():
            split = {ax for ax in param_sharding(p, env) if ax}
            pg = env.group_over([ax for ax in MESH_ORDER if ax not in split])
            dist.broadcast(p.data, dist.get_global_rank(pg, 0), group=pg)
        for b in model.buffers():
            dist.broadcast(b, 0)
    return model


def default_batch_sharding(env: Optional[MeshEnv] = None):
    """A callable giving a batch leaf's default split (``ShardedTrainStep``'s
    own): dim 0 over the data axes dp and sdp that are used, dim 1 over
    cp when it is used."""
    env = env or require_mesh_env()

    def spec_of(arr):
        nd = getattr(arr, "dim", lambda: 0)()
        if nd == 0:
            return ()
        spec = [None] * nd
        data = tuple(ax for ax in ("dp", "sdp") if env.get_dim(ax) > 1)
        if data:
            spec[0] = data
        if nd >= 2 and env.get_dim("cp") > 1:
            spec[1] = "cp"
        return tuple(spec)

    return spec_of


def shard_batch(arr, spec, env: MeshEnv):
    """This rank's slice of ``arr``: dim i split over ``spec[i]`` (an axis,
    a tuple of axes taken row-major, or None)."""
    if not isinstance(arr, torch.Tensor) or not spec:
        return arr
    for dim, axes in enumerate(spec):
        if not axes:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n = env.size_over(axes)
        if n == 1:
            continue
        if arr.shape[dim] % n:
            raise ValueError(f"batch dim {dim} of {tuple(arr.shape)} does "
                             f"not divide over {axes} ({n})")
        per = arr.shape[dim] // n
        idx = 0
        for ax in axes:
            idx = idx * env.get_dim(ax) + env.coord(ax)
        arr = arr.narrow(dim, idx * per, per)
    return arr


def _mp_split(p) -> bool:
    """Whether ``p`` is a tensor-parallel shard. Read from ``mp_dim``:
    ``is_distributed`` is also the name of a ``torch.Tensor`` method,
    which a parameter no mp layer marked still has (and is truthy)."""
    return getattr(p, "mp_dim", None) is not None


class _Entry:
    """One tensor the optimizer updates: ``full`` the model's parameter
    (None for a ZeRO-3 shard, which is the model's own), ``opt`` the
    tensor updated, ``zdim`` the dim split over sdp (None: whole),
    ``mp`` whether it is a tensor-parallel shard, ``ep`` whether an
    expert-parallel one; ``dims`` the dim each axis splits."""

    def __init__(self, full, opt, zdim, stage3, mp):
        self.full, self.opt, self.zdim = full, opt, zdim
        self.stage3, self.mp = stage3, mp
        marked = opt if full is None else full
        self.dims = {"sdp": zdim, "ep": getattr(marked, "ep_dim", None),
                     "mp": getattr(marked, "mp_dim", None)}
        self.ep = self.dims["ep"] is not None


class _AmpState:
    """The in-graph loss-scale state and the gradient-merge window, on the
    device. With a scaler: ``scale`` fp32 [1], ``good`` / ``bad`` int32 [1]
    (the finite and non-finite steps in a row) and ``found`` int32 [1]
    (the last step's gradients were not finite), the scaler's own
    (``GradScaler.device_state``), and ``updates`` int32 [1], the
    optimizer's count of applied updates (Adam's t;
    ``Optimizer.device_updates``). ``goodw`` int32 [1] (finite calls in
    the open window) and ``acc``, the window's fp32 sums (``accum_steps >
    1``), are the step's."""

    def __init__(self, device, acc_shapes, scaler, optimizer):
        if scaler is not None:
            self.scale, self.good, self.bad, self.found = \
                scaler.device_state(device)
            self.updates = optimizer.device_updates(device)
        self.goodw = torch.zeros(1, dtype=torch.int32, device=device)
        self.acc = [None if s is None else
                    torch.zeros(s, dtype=torch.float32, device=device)
                    for s in acc_shapes]


class _Pending:
    """What an offloaded step's body leaves for the walk: the reduced
    gradients (a captured graph rewrites them on each replay). Its
    ``set_step`` is the optimizer table's, of which it has none."""

    def __init__(self, grads):
        self.grads = grads

    def set_step(self, lr, step):
        pass


class ShardedTrainStep(_Step):
    """``step = ShardedTrainStep(model, loss_fn, optimizer); loss =
    step(*global_batch)`` over the installed mesh (or ``env``).

    Each call keeps this rank's slice of every batch tensor (dim 0 over dp
    x sdp, dim 1 over cp, or ``batch_specs``: per leaf a tuple over its
    dims of an axis, a tuple of axes or None), runs ``loss_fn(model,
    *local)`` and its backward, and reduces the gradients over the data
    ranks as the model's ``loss_reduction`` attribute says: ``"mean"``
    (the default) takes each rank's loss as the mean over its equal slice
    and averages, ``"sum"`` (``LlamaForCausalLM``) takes it as the rank's
    share of the global loss and sums. It returns the global loss. ZeRO
    (``group_sharded_parallel``, whose optimizer is built over this
    rank's slices): stage 1 all-reduces then slices, stage 2
    reduce-scatters over sdp, stage 3 parameters are sdp shards gathered
    in the forward (their gradients reduce-scattered by its backward);
    the optimizer updates the slices (its state is 1/sdp) and stages 1
    and 2 all-gather them back. A global-norm clip counts every element
    once (tensor- and ZeRO-split parameters' sums of squares are
    all-reduced over their axis, the stages' totals over pp), through the
    clip the step hands the optimizer's update. Lamb, LARS and Adafactor
    take statistics over a whole tensor: over a split one they are
    summed over its axes between the kernels' partial and finish passes
    (``kernels.optimizer.TensorSplits``).

    **ep > 1.** An MoE model's experts are split over ep (its
    ``MoELayer``s hold ``e / ep`` each); the ranks of one ep group see the
    same tokens, and every parameter ends the backward with its full
    gradient there, so gradients are reduced over the data ranks only.

    **pp > 1.** A model built as one stage of a pipeline (its
    ``pipelined`` attribute: ``LlamaForCausalLM`` and ``PipelineLayer``
    under a mesh with pp > 1) runs the 1F1B schedule
    (``meta_parallel.pipeline``) over ``num_microbatches`` microbatches of
    this rank's local batch (the model's ``pp_microbatches``, 0 meaning 2
    pp), its activations and their gradients sent to the neighbouring pp
    ranks over P2P. Its loss is the model's own (``pipeline_forward`` on
    the last stage; ``loss_fn`` is not called). Each stage sums its
    gradients in fp32 in microbatch order, the gradients of a weight tied
    across stages (``pp_shared``) are all-reduced over pp, then reduced
    over the data ranks; each stage updates its own parameters.

    **scaler** (an ``amp.GradScaler``): the loss-scale state machine runs
    inside the step, as the JAX package's (``parallel.py:420-441``): the
    scale, the good and bad counts and the finite flag live in device
    tensors; the loss is multiplied by the scale, ``check_finite`` writes
    its flag on the device (summed over the world), ``unscale`` reads the
    scale there, and a non-finite step skips the update: the optimizer's
    kernels read the skip flag and the count of applied updates (Adam's t)
    from the device (``Optimizer._apply(device_step=)``). That state is
    the scaler's and the optimizer's own, held on the device from the
    first call (``GradScaler.device_state``, ``Optimizer.device_updates``):
    their fields read it when used. **accum_steps = k**: the
    gradient-merge window across k calls: fp32 sums persist between
    calls, and only the k-th call reduces them over the data ranks and
    applies the update, averaged over the window's finite calls when
    ``accum_avg``; under a scaler a non-finite call adds nothing
    (``discard_accum_window`` drops a window). :meth:`accumulate` (``ShardedAccumulateStep``) takes k
    microbatches of the global batch in one call.

    On a CUDA model the step is one captured CUDA graph a call, NCCL
    collectives and P2P included, as ``jit.TrainStep`` (``graph=False``:
    eager); a window's accumulating call and its boundary call are two
    graphs. ``donate`` is the JAX signature's: the update writes the
    parameters and state in place whatever it says.

    **Offload** (``group_sharded_parallel(..., offload=True)``; JAX
    ``parallel.py:205-256, 671-860``): the fp32 masters and the
    optimizer's state of this rank's tensors rest in host memory and the
    update streams per group through a double-buffered lane, on the card
    (``distributed.offload``); the graph holds the forward, the backward
    and the reduction, the walk runs after it. ``stream_stats()`` and
    ``stream_schedule()`` read the lane. It raises with an in-graph
    scaler or ``accum_steps > 1``, as the reference does.
    """

    def __init__(self, model: nn.Module, loss_fn: Callable, optimizer,
                 batch_specs=None, env: Optional[MeshEnv] = None,
                 donate=True, scaler=None, accum_steps=1, accum_avg=True,
                 graph: bool = True, num_microbatches: int = None):
        env = env or require_mesh_env()
        if int(accum_steps) < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        inner = mark_parameters(getattr(model, "_layers", model))
        super().__init__(inner, loss_fn, optimizer, graph=graph)
        self.env = env
        self.batch_specs = batch_specs
        self.scaler = scaler if (scaler is not None and
                                 getattr(scaler, "_enable", True)) else None
        self.accum_steps = int(accum_steps)
        self.accum_avg = bool(accum_avg)
        self.offload = bool(getattr(optimizer, "_offload", False))
        if self.offload and (self.scaler is not None or self.accum_steps > 1):
            from .offload import OFFLOAD_AMP_ERROR

            raise NotImplementedError(OFFLOAD_AMP_ERROR)
        self._off = None  # the offloaded state, made at the first call
        self.loss_reduction = getattr(inner, "loss_reduction", "mean")
        if self.loss_reduction not in ("mean", "sum"):
            raise ValueError(f"loss_reduction {self.loss_reduction!r}: "
                             f"'mean' or 'sum'")
        self.pp = env.get_dim("pp")
        self.pipelined = self.pp > 1 and bool(getattr(inner, "pipelined",
                                                      False))
        if self.pipelined and env.get_dim("cp") > 1:
            raise NotImplementedError(
                "the pipeline with context parallelism (pp x cp) is not "
                "ported: the JAX reference fails there itself (its pipeline "
                "raises 'The context mesh ... should match the mesh passed "
                "to shard_map' at pp 2 x cp 2), so there is no oracle; see "
                "ROADMAP Queue 3, oracle caveats")
        m = num_microbatches or getattr(inner, "pp_microbatches", 0) or \
            2 * self.pp
        self.num_microbatches = int(m)
        self.zero_stage = int(getattr(optimizer, "_zero_stage", 0))
        self._data = env.group_over(DATA_AXES)
        self._n_data = env.size_over(DATA_AXES)
        self._dpcp = env.group_over(("dp", "cp"))
        self._sdp_pg, self._sdp = env.group("sdp"), env.get_dim("sdp")
        self._sdp_rank = env.coord("sdp")
        self._mp_pg = env.group("mp") if env.get_dim("mp") > 1 else None
        self._pp_pg = env.group("pp") if self.pp > 1 else None
        self._pp_rank = env.coord("pp")
        self._ep_pg = env.group("ep") if env.get_dim("ep") > 1 else None
        self._plan = self._entries()
        self._split_norms = any(e.zdim is not None or e.mp or e.ep
                                for e in self._plan)
        # the per-tensor statistics of Adafactor, Lamb and LARS over split
        # tensors: summed over sdp, ep, mp in that order
        self._splits = _kopt.TensorSplits(
            [(pg, env.get_dim(ax),
              {id(e.opt): e.dims[ax] for e in self._plan
               if e.dims[ax] is not None})
             for ax, pg in (("sdp", self._sdp_pg), ("ep", self._ep_pg),
                            ("mp", self._mp_pg)) if env.get_dim(ax) > 1]) \
            if self._split_norms else None
        self._masks: Dict[tuple, torch.Tensor] = {}
        self._amp: Optional[_AmpState] = None
        self._win_count = 0     # calls into the open window (host)
        self._boundary = True   # whether this call applies the update
        self._transports: Dict[tuple, object] = {}
        self._check_words: Dict[tuple, int] = {}  # finiteness tables' sizes
        self._check_reserved = None

    @property
    def _amp_mode(self) -> bool:
        return self.scaler is not None or self.accum_steps > 1

    def accumulate(self, steps: int, remat: bool = False,
                   average: bool = True) -> "ShardedAccumulateStep":
        """Gradient accumulation over the mesh in one call (the JAX
        ``ShardedTrainStep.accumulate``, ``parallel.py:390-406``): the
        global batch splits on dim 0 into ``steps`` microbatches, their
        gradients sum in fp32 in order (scaled 1/steps when ``average``),
        then one reduction over the data ranks, one clip and one update.
        Raises under a scaler, as the JAX step does."""
        if self.scaler is not None:
            raise NotImplementedError(
                "ShardedTrainStep.accumulate: fused accumulation does not "
                "compose with the in-graph GradScaler; use accum_steps for "
                "the scaler path")
        return ShardedAccumulateStep(self, steps, remat=remat,
                                     average=average)

    def __call__(self, *batch):
        if self.offload:
            self._offloaded().prefetch()
        if not self._amp_mode:
            return self._run(*batch)
        if self._amp is None:
            shapes = [tuple(self._held(e).shape)
                      if self._held(e).requires_grad else None
                      for e in self._plan] if self.accum_steps > 1 else []
            self._amp = _AmpState(self._device(), shapes, self.scaler,
                                  self.optimizer)
        k = self.accum_steps
        self._boundary = (self._win_count + 1) % k == 0
        loss = self._run(self._boundary, *batch)
        self._win_count = 0 if self._boundary else self._win_count + 1
        return loss

    # -- the step count and the tables the graph replays ----------------------
    def _header_step(self) -> int:
        if self.scaler is not None:
            return 1  # the kernels read count + 1 from the device
        return super()._header_step()

    def _advance(self) -> None:
        if self.offload:
            self._walk(self._last_out)
        if not self._amp_mode:
            super()._advance()
        elif self.scaler is None and self._boundary:
            self.optimizer._global_step += 1

    def _reserve(self, key) -> None:
        if not self.offload:  # the offloaded update runs outside the graph
            super()._reserve(key)
        words = self._check_words.get(key)
        self._check_reserved = None if words is None else torch.empty(
            words, dtype=torch.int64, device=self._device())

    # -- ZeRO ----------------------------------------------------------------
    def _entries(self) -> List[_Entry]:
        """One entry per optimizer tensor: a ZeRO-3 shard, a ZeRO stage 1
        or 2 slice of a model parameter (``group_sharded_parallel`` made
        it: ``zero_full``, ``zero_dim``) or a whole parameter."""
        plan = []
        for p in self.optimizer._parameter_list:
            if getattr(p, "zero3_dim", None) is not None:
                plan.append(_Entry(None, p, p.zero3_dim, True, _mp_split(p)))
                continue
            full = getattr(p, "zero_full", None)
            whole = full if full is not None else p
            plan.append(_Entry(whole, p, getattr(p, "zero_dim", None), False,
                               _mp_split(whole)))
        return plan

    def _slice(self, t, dim):
        per = t.shape[dim] // self._sdp
        return t.narrow(dim, self._sdp_rank * per, per)

    def _held(self, e: _Entry):
        """The tensor the model's backward gives a gradient: the ZeRO-3
        shard itself, else the whole parameter."""
        return e.opt if e.stage3 else e.full

    # -- the step ------------------------------------------------------------
    def local_batch(self, batch) -> list:
        spec_of = default_batch_sharding(self.env)
        specs = self.batch_specs or [None] * len(batch)
        return [shard_batch(a, s if s is not None else spec_of(a), self.env)
                for a, s in zip(batch, specs)]

    def _model_grads(self) -> List[Optional[torch.Tensor]]:
        return [self._held(e).grad for e in self._plan]

    def _reduce(self, raw) -> List[Optional[torch.Tensor]]:
        """``raw`` (one local gradient per entry, each the shape of
        :meth:`_held`, or None) reduced over the data ranks and sliced as
        each optimizer tensor is."""
        scale = None if self.loss_reduction == "sum" or self._n_data == 1 \
            else 1.0 / self._n_data
        over_data, over_dpcp = [], []
        for j, (e, g) in enumerate(zip(self._plan, raw)):
            if g is None:
                continue
            if e.stage3 or (e.zdim is not None and self.zero_stage == 2):
                over_dpcp.append((j, g))
            else:
                over_data.append((j, g))
        all_reduce_bucketed([g for _, g in over_data], self._data,
                            _BUCKET_BYTES, scale)
        all_reduce_bucketed([g for _, g in over_dpcp], self._dpcp,
                            _BUCKET_BYTES, scale)
        grads: List[Optional[torch.Tensor]] = [None] * len(self._plan)
        for j, g in over_data:
            e = self._plan[j]
            grads[j] = g if e.zdim is None else \
                self._slice(g, e.zdim).contiguous()
        for j, g in over_dpcp:
            e = self._plan[j]
            grads[j] = g if e.stage3 else reduce_scatter_dim(
                g, self._sdp_pg, self._sdp, e.zdim).contiguous()
        return grads

    def _local_grads(self, local, scale=None, remat=False):
        """This rank's forward and backward over ``local``: (its loss, fp32,
        the loss scale not applied; one gradient per entry, as
        :meth:`_held`, None where none). ``scale``: an fp32 [1] device
        tensor the loss is multiplied by before the backward. A pipelined
        model runs the 1F1B schedule and gives fp32 sums."""
        if self.pipelined:
            return self._pipeline_grads(local, scale)
        from .sharding import gather_once

        with gather_once():  # a tied ZeRO-3 shard is gathered once
            if remat:
                gens = _active_generators(self.model, self._device())
                loss = checkpoint(rewinding(self._loss, gens), *local,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                loss = self.loss_fn(self.model, *local)
        (loss if scale is None else loss * scale.reshape(())).backward()
        raw = self._model_grads()
        for p in self.model.parameters():
            p.grad = None
        return loss.detach().float(), raw

    def _loss(self, *local):
        return self.loss_fn(self.model, *local)

    def _pipeline_grads(self, local, scale):
        """The 1F1B schedule of this rank's stage over the pp group: fp32
        gradient sums per entry (the tied weights' all-reduced over pp)
        and this rank's loss (the last stage's; 0 on the others)."""
        from .meta_parallel.pipeline import (P2PTransport, StageRun, drive,
                                             microbatch, stage_body)

        m = self.num_microbatches
        model = self.model
        if hasattr(model, "pipeline_prepare"):
            model.pipeline_prepare(*local)
        mbs = list(zip(*[microbatch(a, m) if isinstance(a, torch.Tensor)
                         else [a] * m for a in local]))
        held = [self._held(e) for e in self._plan]
        live = [j for j, t in enumerate(held) if t.requires_grad]
        acc = [torch.zeros(held[j].shape, dtype=torch.float32,
                           device=held[j].device) for j in live]
        first, last = self._pp_rank == 0, self._pp_rank == self.pp - 1
        key = tuple((tuple(a.shape), a.dtype) for a in local
                    if isinstance(a, torch.Tensor))
        transport = self._transports.get(key)
        if transport is None:
            transport = self._transports[key] = P2PTransport(
                self._pp_pg, self._pp_rank, self.pp, self._device())
        mean = self.loss_reduction != "sum"
        run = StageRun(model, mbs, [held[j] for j in live], acc, first, last,
                       seed=scale, grad_scale=(1.0 / m) if mean else None,
                       meta=transport.meta)
        drive(stage_body(run, self.pp, self._pp_rank, m), transport)
        if last:
            losses = torch.stack(run.losses)
            loss = losses.mean() if mean else losses.sum()
        else:
            loss = torch.zeros((), dtype=torch.float32, device=self._device())
        if run.aux:  # this stage's aux shares, in the reported loss too
            aux = torch.stack(run.aux)
            loss = loss + (aux.mean() if mean else aux.sum())
        raw: List[Optional[torch.Tensor]] = [None] * len(self._plan)
        for j, a in zip(live, acc):
            raw[j] = a
        self._shared_all_reduce(raw)
        return loss, raw

    def _shared_all_reduce(self, raw):
        """Each weight tied across stages (``pp_shared``, by key; the
        model's ``pp_shared_shapes()`` gives every key's shape) has its
        fp32 gradient sum all-reduced over pp, stages that hold no copy
        adding zeros: Paddle's shared-weight all-reduce."""
        shapes = getattr(self.model, "pp_shared_shapes", lambda: {})()
        if not shapes:
            return
        mine = {}
        for j, e in enumerate(self._plan):
            key = getattr(self._held(e), "pp_shared", None)
            if key is not None and raw[j] is not None:
                mine[key] = raw[j]
        for key in sorted(shapes):
            t = mine.get(key)
            if t is None:
                t = torch.zeros(shapes[key], dtype=torch.float32,
                                device=self._device())
            dist.all_reduce(t, group=self._pp_pg)

    def _gather_zero(self):
        with torch.no_grad():
            for e in self._plan:  # ZeRO 1/2: the updated slices back
                if e.full is not None and e.zdim is not None:
                    e.full.copy_(all_gather_dim(e.opt.detach(), self._sdp_pg,
                                                self._sdp, e.zdim))

    def _global_loss(self, loss):
        loss = loss.detach().float().clone()
        if self.pipelined:  # the last stage's loss to every stage
            dist.all_reduce(loss, group=self._pp_pg)
        dist.all_reduce(loss, group=self._data)
        if self.loss_reduction == "mean" and self._n_data > 1:
            loss = loss / self._n_data
        return loss

    def _update(self, grads):
        """The update from the reduced ``grads``: the optimizer's kernels
        and ZeRO's gather (returns the batch a graph replays); offloaded,
        the gradients, which the walk after the call takes."""
        if self.offload:
            return _Pending(grads)
        opt_batch = self.optimizer._apply(grads, clip=self._clip,
                                          split=self._splits)
        self._gather_zero()
        return opt_batch

    def _body(self, *batch):
        if self._amp_mode:
            return self._amp_body(batch[0], *batch[1:])
        loss, raw = self._local_grads(self.local_batch(batch))
        return self._global_loss(loss), self._update(self._reduce(raw))

    def eager_window(self, steps: int, scaler, *batch):
        """The reference's eager microbatch loop (``PipelineParallel.
        _eager_accum_batch``, JAX ``wrappers.py:214-240``), which it takes
        where a scaler or an offloaded optimizer meets ``accumulate_steps``:
        the global batch split on dim 0 into ``steps`` microbatches, each
        one's forward and the backward of ``scale * loss / steps`` (each
        rank on its slice), the fp32 sums reduced over the data ranks; then
        ``scaler.step``'s semantics on the device kernels: the unscale and
        the finite check over every rank, the update (the walk, offloaded)
        only where all is finite, one loss-scale update. Eager on the card
        too. Returns the mean of the microbatches' global losses."""
        k = int(steps)
        sc = scaler if (scaler is not None and
                        getattr(scaler, "_enable", True)) else None
        self.model.train()
        if self.offload:
            self._offloaded().prefetch()
        dev = self._device()
        factor = torch.tensor([(1.0 / k) * (float(sc._scale) if sc else 1.0)],
                              dtype=torch.float32, device=dev)
        micro = [a.reshape((k, a.shape[0] // k) + tuple(a.shape[1:]))
                 if isinstance(a, torch.Tensor) else a for a in batch]
        acc: List[Optional[torch.Tensor]] = [None] * len(self._plan)
        losses = []
        for i in range(k):
            mb = [m[i] if isinstance(m, torch.Tensor) else m for m in micro]
            loss, raw = self._local_grads(self.local_batch(mb), factor)
            with torch.no_grad():
                for j, g in enumerate(raw):
                    if g is None:
                        continue
                    if acc[j] is None:
                        acc[j] = torch.zeros(g.shape, dtype=torch.float32,
                                             device=g.device)
                    acc[j].add_(g.float())
            losses.append(loss)
        grads = self._reduce(acc)
        found = False
        if sc is not None:
            pairs = [(e.opt, g) for e, g in zip(self._plan, grads)
                     if g is not None]
            n = len(pairs)
            gb = _kopt.StepBatch([t for t, _ in pairs], [g for _, g in pairs],
                                 [[None] * n] * 3, [True] * n, 0.0, 1,
                                 rule="grads")
            inv = 1.0 / float(sc._scale)
            flag = _kopt.check_finite(gb, inv)
            if dist.get_world_size() > 1:
                dist.all_reduce(flag)
            found = bool(flag.item())
            if not found:
                _kopt.unscale(gb, inv)
        if not found:
            if self.offload:
                self._walk(_Pending(grads))
            else:
                self.optimizer._apply(grads, clip=self._clip,
                                      split=self._splits)
                self._gather_zero()
            self.optimizer._global_step += 1
        if sc is not None:
            sc._found_inf = found
            sc._update_scale()
        return self._global_loss(torch.stack(losses).mean())

    # -- offload ------------------------------------------------------------------
    def _offloaded(self):
        """The offloaded state (made at the first call, from the tensors as
        they are then)."""
        if self._off is None:
            from .offload import OffloadedState, _env_on

            opt = self.optimizer
            self._off = OffloadedState(
                self, int(getattr(opt, "_stream_segment_size", 2 ** 20)),
                int(getattr(opt, "_stream_buffer_max_size", 2 ** 23)),
                _env_on("PT_OFFLOAD_OVERLAP"))
        return self._off

    def _walk(self, pending):
        """After the call's forward and backward: the clip over every
        reduced gradient, then the streamed update and ZeRO's gather."""
        off = self._offloaded()
        grads = [pending.grads[j] for j in off.live]
        have = [k for k, g in enumerate(grads) if g is not None]
        clip, norms = ("none",), None
        if have and self.optimizer._grad_clip is not None:
            n = len(have)
            cb = _kopt.StepBatch([off.entries[k].opt for k in have],
                                 [grads[k] for k in have], [[None] * n] * 3,
                                 [True] * n, 0.0, 1, rule="grads")
            clip, got = self._clip(cb)
            if got is not None:  # rows by entry: the walk slices them
                pos = torch.full((len(grads),), n, dtype=torch.long,
                                 device=got.device)
                pos[have] = torch.arange(n, device=got.device)
                pad = torch.zeros(1, dtype=got.dtype, device=got.device)
                sums = torch.cat([got[:n], pad])[pos]
                scales = torch.cat([got[n:2 * n], pad])[pos]
                norms = torch.cat([sums, scales, got[2 * n:]])
        opt = self.optimizer
        off.walk(grads, opt.get_lr(), opt._global_step + 1, clip, norms)
        self._gather_zero()

    def stream_stats(self):
        """The offload lane's counters (bytes each way, transfers, transfer
        and stall ms, ``overlap_efficiency``); None before the first
        offloaded call."""
        return None if self._off is None else self._off.lane.stats()

    def stream_schedule(self):
        """The lane's submissions in order, ``(kind, group)``: per step
        ("h2d", 0), ("h2d", 1), then per group i ("d2h", i) and ("h2d", i +
        2). None before the first offloaded call."""
        return None if self._off is None else list(self._off.lane.events)

    def offload_masters(self) -> List[torch.Tensor]:
        """The fp32 masters in host memory, one per tensor the walk updates
        (a host read)."""
        return self._offloaded().masters()

    # -- the in-graph scaler and the gradient-merge window ----------------------
    def _finite_flag(self, pairs, inv, key):
        """int32 [1]: the number of ranks where some ``g * inv`` of
        ``pairs`` ((tensor, gradient)) is not finite, and the gradient
        batch (whose table a captured graph replays)."""
        n = len(pairs)
        gb = _kopt.StepBatch([t for t, _ in pairs], [g for _, g in pairs],
                             [[None] * n] * 3, [True] * n, 0.0, 1,
                             rule="grads")
        if gb.device.type == "cuda":
            if torch.cuda.is_current_stream_capturing():
                gb.reserve(self._check_reserved)
            else:
                self._check_words[key] = gb.words()
        flag = _kopt.check_finite(gb, inv)
        if dist.get_world_size() > 1:
            dist.all_reduce(flag)
        return flag, gb

    def _scale_update(self, fin):
        """The dynamic loss-scale state machine (JAX ``_amp_update``,
        ``parallel.py:420-441``; the eager ``GradScaler._update_scale``) on
        the device: ``fin`` a bool [1]."""
        sc, a = self.scaler, self._amp
        a.found.copy_((~fin).to(torch.int32))
        if not getattr(sc, "_dynamic", True):
            return
        good2 = torch.where(fin, a.good + 1, 0)
        bad2 = torch.where(fin, 0, a.bad + 1)
        incr = fin & (good2 >= sc._incr_every_n_steps)
        decr = ~fin & (bad2 >= sc._decr_every_n_nan_or_inf)
        scale = torch.where(incr, a.scale * float(sc._incr_ratio),
                            torch.where(decr, torch.clamp_min(
                                a.scale * float(sc._decr_ratio), 1.0),
                                a.scale))
        a.scale.copy_(scale)
        a.good.copy_(torch.where(incr, 0, good2))
        a.bad.copy_(torch.where(decr, 0, bad2))

    def _amp_body(self, boundary, *batch):
        """One call of the scaler / gradient-merge step: the forward and
        backward (the loss scaled), the finite flag on the device, this
        call's gradients added into the window's sums (or, with k = 1,
        reduced and unscaled in place), and at the window's end the
        reduction, the average and the update, skipped on the device where
        nothing finite came."""
        a, opt = self._amp, self.optimizer
        k = self.accum_steps
        has_scaler = self.scaler is not None
        key = self._signature((boundary,) + tuple(batch))
        local = self.local_batch(batch)
        inv = (1.0 / a.scale) if has_scaler else None
        loss, raw = self._local_grads(local, a.scale if has_scaler else None)
        batches, opt_batch, skip = [], None, None
        if k == 1:  # a scaler: k = 1 without one is not the amp mode
            grads = self._reduce(raw)
            pairs = [(e.opt, g) for e, g in zip(self._plan, grads)
                     if g is not None]
            flag, gb = self._finite_flag(pairs, inv, key)
            batches.append(gb)
            _kopt.unscale(gb, inv)
            skip = flag.clamp(max=1)
            self._scale_update(skip == 0)
            opt_batch = opt._apply(grads, clip=self._clip,
                                   device_step=(a.updates, skip),
                                   split=self._splits)
            a.updates.add_(1 - skip)
        else:
            with torch.no_grad():
                if has_scaler:
                    pairs = [(self._held(e), g)
                             for e, g in zip(self._plan, raw)
                             if g is not None]
                    flag, gb = self._finite_flag(pairs, inv, key)
                    batches.append(gb)
                    fin = flag == 0
                    for acc, g in zip(a.acc, raw):
                        if g is not None:
                            acc.add_(torch.where(fin, g.float() * inv, 0.0))
                    a.goodw.add_(fin.to(torch.int32))
                    self._scale_update(fin)
                else:
                    for acc, g in zip(a.acc, raw):
                        if g is not None:
                            acc.add_(g.float())
                    a.goodw.add_(1)
            if boundary:
                grads = self._reduce(list(a.acc))
                if self.accum_avg:
                    denom = a.goodw.clamp_min(1).float()
                    grads = [None if g is None else g / denom for g in grads]
                if has_scaler:
                    skip = (a.goodw == 0).to(torch.int32)
                    opt_batch = opt._apply(grads, clip=self._clip,
                                           device_step=(a.updates, skip),
                                           split=self._splits)
                    a.updates.add_(1 - skip)
                else:
                    opt_batch = opt._apply(grads, clip=self._clip,
                                           split=self._splits)
                with torch.no_grad():
                    for acc in a.acc:
                        if acc is not None:
                            acc.zero_()
                    a.goodw.zero_()
        if opt_batch is not None:
            self._gather_zero()
            batches.insert(0, opt_batch)
        return self._global_loss(loss), (batches or None)

    def discard_accum_window(self):
        """Drops the open gradient-merge window (the compiled twin of
        ``HybridParallelOptimizer.discard_merge_window``): the fp32 sums
        and the window's finite count zeroed, the window rewound."""
        if self._amp is not None:
            with torch.no_grad():
                for acc in self._amp.acc:
                    if acc is not None:
                        acc.zero_()
                self._amp.goodw.zero_()
        self._win_count = 0

    def amp_state(self):
        """The in-graph scaler's state (a host read): ``loss_scale``,
        ``good_steps``, ``bad_steps``, ``found_inf``, ``updates``; None
        without a scaler or before the first call."""
        if self.scaler is None or self._amp is None:
            return None
        a = self._amp
        return {"loss_scale": float(a.scale.item()),
                "good_steps": int(a.good.item()),
                "bad_steps": int(a.bad.item()),
                "found_inf": bool(a.found.item()),
                "updates": int(a.updates.item())}

    # -- the clip over the mesh ------------------------------------------------
    def _split_masks(self, params) -> torch.Tensor:
        """[4, n] fp32: which of ``params`` are ZeRO slices, which
        tensor-parallel shards, which count toward the global norm on this
        stage (a weight tied across stages counts on its first holder
        only), and which are expert-parallel shards; made once per tensor
        list, before any capture reads them."""
        key = tuple(id(p) for p in params)
        m = self._masks.get(key)
        if m is None:
            kind = {id(e.opt): e for e in self._plan}
            first_holder = self._pp_rank == 0
            m = torch.tensor([[float(kind[id(p)].zdim is not None)
                               for p in params],
                              [float(kind[id(p)].mp) for p in params],
                              [0.0 if getattr(self._held(kind[id(p)]),
                                              "pp_shared", None) is not None
                               and self.pipelined and not first_holder
                               else 1.0 for p in params],
                              [float(kind[id(p)].ep) for p in params]],
                             device=params[0].device)
            self._masks[key] = m
        return m

    def _clip(self, batch):
        """The update's (clip, norms) over the mesh, in place of the
        optimizer's ``_clip``: each tensor's sum of squares all-reduced
        over the axes that split it (sdp, then ep, then mp; a tensor
        replicated over an axis is not summed over it), the global sum
        over every tensor this rank updates, and under the pipeline over
        the stages (each parameter lives on one)."""
        c = self.optimizer._grad_clip
        if c is None:
            return ("none",), None
        spec = c._spec()
        if spec[0] == "value":
            return spec, None
        if not self._split_norms and not self.pipelined:
            return ("scale",), _kopt.multi_tensor_sumsq(batch, spec[1],
                                                        spec[2])
        n = len(batch.params)
        s = _kopt.multi_tensor_sumsq(batch, 0.0, 0)[:n]
        masks = self._split_masks(batch.params)
        for mask, pg, deg in ((masks[0], self._sdp_pg, self._sdp),
                              (masks[3], self._ep_pg,
                               self.env.get_dim("ep")),
                              (masks[1], self._mp_pg,
                               self.env.get_dim("mp"))):
            if deg > 1:
                t = s * mask
                dist.all_reduce(t, group=pg)
                s = t + s * (1.0 - mask)
        if self.pipelined:
            total = (s * masks[2]).sum()
            dist.all_reduce(total, group=self._pp_pg)
        else:
            total = s.sum()
        norm = total.sqrt().expand(n) if spec[2] == 2 else s.sqrt()
        scales = (spec[1] / norm.clamp_min(1e-12)).clamp_max(1.0)
        return ("scale",), torch.cat([s, scales, total.reshape(1)])


class ShardedAccumulateStep(_Step):
    """``ShardedTrainStep.accumulate(k)`` (JAX ``parallel.py:915-1130``):
    one call takes the global batch, splits it on dim 0 into k
    microbatches (each sliced over the data ranks as the step slices a
    batch), runs each one's forward and backward (under
    ``torch.utils.checkpoint`` when ``remat``; the whole pipeline under
    pp), adds its gradients into fp32 sums in microbatch order (times 1/k
    when ``average``), then reduces once over the data ranks and applies
    one clip and one update; it composes with ZeRO 1-3 and the mesh clip.
    Returns the mean of the microbatches' global losses. On a CUDA model
    one captured graph a call."""

    def __init__(self, step: ShardedTrainStep, steps: int,
                 remat: bool = False, average: bool = True):
        if int(steps) < 1:
            raise ValueError(f"accumulate: steps must be >= 1, got {steps}")
        super().__init__(step.model, step.loss_fn, step.optimizer,
                         graph=step.graph)
        self._step = step
        self.env = step.env
        self.steps = int(steps)
        self.remat = bool(remat)
        self.average = bool(average)

    def _body(self, *batch):
        outer, k = self._step, self.steps
        scale = 1.0 / k if self.average else None
        micro = [a.reshape((k, a.shape[0] // k) + tuple(a.shape[1:]))
                 if isinstance(a, torch.Tensor) else a for a in batch]
        acc: List[Optional[torch.Tensor]] = [None] * len(outer._plan)
        losses = []
        for i in range(k):
            mb = [m[i] if isinstance(m, torch.Tensor) else m for m in micro]
            loss, raw = outer._local_grads(outer.local_batch(mb),
                                           remat=self.remat)
            with torch.no_grad():
                for j, g in enumerate(raw):
                    if g is None:
                        continue
                    if acc[j] is None:
                        acc[j] = torch.zeros(g.shape, dtype=torch.float32,
                                             device=g.device)
                    acc[j].add_(g.float() if scale is None
                                else g.float() * scale)
            losses.append(loss)
        opt_batch = outer._update(outer._reduce(acc))
        return outer._global_loss(torch.stack(losses).mean()), opt_batch

    def _advance(self) -> None:
        if self._step.offload:
            self._step._walk(self._last_out)
        super()._advance()

    def _reserve(self, key) -> None:
        if not self._step.offload:
            super()._reserve(key)

    def __call__(self, *batch):
        if self._step.offload:
            self._step._offloaded().prefetch()
        for a in batch:
            if isinstance(a, torch.Tensor) and (
                    a.dim() == 0 or a.shape[0] % self.steps != 0):
                raise ValueError(
                    f"accumulate({self.steps}): batch dim {tuple(a.shape)} "
                    f"must divide by the microbatch count")
        return self._run(*batch)
