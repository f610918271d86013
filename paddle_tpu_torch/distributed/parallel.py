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
  machinery).

What must agree with the JAX ``ShardedTrainStep`` is the global result:
the losses, and the parameters once gathered.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..jit import _Step
from ..kernels import optimizer as _kopt
from .collective import _pg, all_gather_dim, reduce_scatter_dim
from .mesh import MESH_ORDER, MeshEnv, get_mesh_env, require_mesh_env
from .meta_parallel.mp_layers import mark_parameters

__all__ = ["DataParallel", "ShardedTrainStep", "param_sharding",
           "zero_partition_spec", "place_model", "default_batch_sharding",
           "shard_batch", "DATA_AXES"]

DATA_AXES = ("dp", "sdp", "cp")  # the ranks that see different data
_BUCKET_BYTES = 25 * 2 ** 20  # a gradient all-reduce's bucket, as Paddle's
_DEFERRED = ("{} is not ported yet (ROADMAP Queue 1 item 3, what the "
             "distributed slice still lacks)")


def _deferred(what):
    return NotImplementedError(_DEFERRED.format(what))


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
    axis (``"mp"`` for a tensor-parallel shard, ``"sdp"`` for a ZeRO-3
    one)."""
    spec = [None] * p.dim()
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
    ``mp`` whether it is a tensor-parallel shard."""

    def __init__(self, full, opt, zdim, stage3, mp):
        self.full, self.opt, self.zdim = full, opt, zdim
        self.stage3, self.mp = stage3, mp


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
    all-reduced over their axis), through the clip the step hands the
    optimizer's update. Lamb, LARS and Adafactor take statistics over a
    whole tensor and raise under a split.

    On a CUDA model the step is one captured CUDA graph a call, NCCL
    collectives included, as ``jit.TrainStep`` (``graph=False``: eager).
    ``scaler``, ``accum_steps > 1``, optimizer offload, ``accumulate`` and
    ``pp`` or ``ep`` above 1 raise ``NotImplementedError``. ``donate`` and
    ``accum_avg`` are the JAX signature's: the update writes the
    parameters and state in place whatever ``donate`` says.
    """

    def __init__(self, model: nn.Module, loss_fn: Callable, optimizer,
                 batch_specs=None, env: Optional[MeshEnv] = None,
                 donate=True, scaler=None, accum_steps=1, accum_avg=True,
                 graph: bool = True):
        if scaler is not None and getattr(scaler, "_enable", True):
            raise _deferred("ShardedTrainStep's in-graph GradScaler")
        if int(accum_steps) != 1:
            raise _deferred("ShardedTrainStep(accum_steps > 1)")
        if getattr(optimizer, "_offload", False):
            raise _deferred("optimizer offload")
        env = env or require_mesh_env()
        for ax, what in (("pp", "the pipeline (pp > 1)"),
                         ("ep", "expert parallelism (ep > 1)")):
            if env.get_dim(ax) > 1:
                raise _deferred(what)
        inner = mark_parameters(getattr(model, "_layers", model))
        super().__init__(inner, loss_fn, optimizer, graph=graph)
        self.env = env
        self.batch_specs = batch_specs
        self.loss_reduction = getattr(inner, "loss_reduction", "mean")
        if self.loss_reduction not in ("mean", "sum"):
            raise ValueError(f"loss_reduction {self.loss_reduction!r}: "
                             f"'mean' or 'sum'")
        self.zero_stage = int(getattr(optimizer, "_zero_stage", 0))
        self._data = env.group_over(DATA_AXES)
        self._n_data = env.size_over(DATA_AXES)
        self._dpcp = env.group_over(("dp", "cp"))
        self._sdp_pg, self._sdp = env.group("sdp"), env.get_dim("sdp")
        self._sdp_rank = env.coord("sdp")
        self._mp_pg = env.group("mp") if env.get_dim("mp") > 1 else None
        self._plan = self._entries()
        self._split_norms = any(e.zdim is not None or e.mp
                                for e in self._plan)
        from ..optimizer import Adafactor, Lamb, LarsMomentum

        if self._split_norms and isinstance(
                optimizer, (Lamb, LarsMomentum, Adafactor)):
            raise _deferred(f"{type(optimizer).__name__} over tensor- or "
                            f"ZeRO-split parameters (per-tensor statistics)")
        self._masks: Dict[tuple, torch.Tensor] = {}

    def accumulate(self, steps: int, remat: bool = False,
                   average: bool = True):
        raise _deferred("ShardedAccumulateStep (ShardedTrainStep."
                        "accumulate)")

    def __call__(self, *batch):
        return self._run(*batch)

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

    # -- the step ------------------------------------------------------------
    def local_batch(self, batch) -> list:
        spec_of = default_batch_sharding(self.env)
        specs = self.batch_specs or [None] * len(batch)
        return [shard_batch(a, s if s is not None else spec_of(a), self.env)
                for a, s in zip(batch, specs)]

    def _gradients(self) -> List[Optional[torch.Tensor]]:
        """Each optimizer tensor's gradient reduced over the data ranks
        (and scaled for ``"mean"``), sliced as the tensor is."""
        scale = None if self.loss_reduction == "sum" or self._n_data == 1 \
            else 1.0 / self._n_data
        over_data, over_dpcp = [], []
        for j, e in enumerate(self._plan):
            g = e.opt.grad if e.stage3 else e.full.grad
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

    def _body(self, *batch):
        local = self.local_batch(batch)
        loss = self.loss_fn(self.model, *local)
        loss.backward()
        grads = self._gradients()
        for p in self.model.parameters():
            p.grad = None
        opt_batch = self.optimizer._apply(grads, clip=self._clip)
        with torch.no_grad():
            for e in self._plan:  # ZeRO 1/2: the updated slices back
                if e.full is not None and e.zdim is not None:
                    e.full.copy_(all_gather_dim(e.opt.detach(), self._sdp_pg,
                                                self._sdp, e.zdim))
        loss = loss.detach().float().clone()
        dist.all_reduce(loss, group=self._data)
        if self.loss_reduction == "mean" and self._n_data > 1:
            loss = loss / self._n_data
        return loss, opt_batch

    # -- the clip over the mesh ------------------------------------------------
    def _split_masks(self, params) -> torch.Tensor:
        """[2, n] fp32: which of ``params`` are ZeRO slices, which
        tensor-parallel shards (made once per tensor list, before any
        capture reads them)."""
        key = tuple(id(p) for p in params)
        m = self._masks.get(key)
        if m is None:
            kind = {id(e.opt): e for e in self._plan}
            m = torch.tensor([[float(kind[id(p)].zdim is not None)
                               for p in params],
                              [float(kind[id(p)].mp) for p in params]],
                             device=params[0].device)
            self._masks[key] = m
        return m

    def _clip(self, batch):
        """The update's (clip, norms) over the mesh, in place of the
        optimizer's ``_clip``: each tensor's sum of squares all-reduced
        over the axes that split it (sdp, then mp), the global sum over
        every tensor this rank updates."""
        c = self.optimizer._grad_clip
        if c is None:
            return ("none",), None
        spec = c._spec()
        if spec[0] == "value":
            return spec, None
        if not self._split_norms:
            return ("scale",), _kopt.multi_tensor_sumsq(batch, spec[1],
                                                        spec[2])
        n = len(batch.params)
        s = _kopt.multi_tensor_sumsq(batch, 0.0, 0)[:n]
        masks = self._split_masks(batch.params)
        for mask, pg, deg in ((masks[0], self._sdp_pg, self._sdp),
                              (masks[1], self._mp_pg,
                               self.env.get_dim("mp"))):
            if deg > 1:
                t = s * mask
                dist.all_reduce(t, group=pg)
                s = t + s * (1.0 - mask)
        total = s.sum()
        norm = total.sqrt().expand(n) if spec[2] == 2 else s.sqrt()
        scales = (spec[1] / norm.clamp_min(1e-12)).clamp_max(1.0)
        return ("scale",), torch.cat([s, scales, total.reshape(1)])
