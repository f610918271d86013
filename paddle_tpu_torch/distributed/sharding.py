"""ZeRO group sharding (port of ``paddle_tpu/distributed/sharding.py``).

``group_sharded_parallel(model, optimizer, level)`` sets the ZeRO stage
that :class:`~paddle_tpu_torch.distributed.ShardedTrainStep` applies over
the ``sdp`` axis, as the JAX one does (``sharding.py:54-58``): ``"os"``
stage 1 (optimizer state split), ``"os_g"`` stage 2 (+ gradients
reduce-scattered), ``"p_g_os"`` stage 3 (+ parameters split). At stage 3
each parameter that splits (the largest dim that divides by the degree,
``zero_partition_spec``) becomes this rank's shard: a parametrization
(``torch.nn.utils.parametrize``) all-gathers it whenever the module reads
it, and its backward reduce-scatters the gradient into the shard. A
parameter tied across modules (a head that is the embedding) is one shard
under one parametrization on each module that holds it; inside
``ShardedTrainStep``'s forward every read of a shard gives the one
gathered tensor (:func:`gather_once`), so its gradient is reduce-scattered
once. ``offload=True`` marks the optimizer for the step's optimizer
offload (``distributed.offload``), ``segment_size`` and
``buffer_max_size`` sizing its stream groups. The
optimizer it returns is a new one over the shards (stage 3) or over this
rank's slices of the parameters (stages 1 and 2, which the step copies
back after each update); the caller's optimizer is left as it was.
"""
from __future__ import annotations

import contextlib
import copy

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

from .collective import _AllGather, all_gather_dim
from .mesh import MeshEnv, require_mesh_env
from .meta_parallel.mp_layers import mp_unshard
from .parallel import _zero_dim

__all__ = ["group_sharded_parallel", "save_group_sharded_model",
           "gather_full_state", "gather_once"]

_LEVELS = {"os": 1, "os_g": 2, "p_g_os": 3}
_GATHERED = []  # the open gather_once scopes: {id(shard): full}


@contextlib.contextmanager
def gather_once():
    """Inside, each ZeRO-3 shard is all-gathered at its first read and
    every later read (another module's tied use) takes that tensor."""
    _GATHERED.append({})
    try:
        yield
    finally:
        _GATHERED.pop()


class _SdpGather(nn.Module):
    """The full parameter from this rank's shard along ``dim``. ``tied``:
    registered on a second module that holds the same parameter, already
    a shard (its right inverse keeps it)."""

    def __init__(self, dim, pg, n, rank, tied=False):
        super().__init__()
        self.dim, self.pg, self.n, self.rank = dim, pg, n, rank
        self.tied = tied

    def forward(self, shard):
        seen = _GATHERED[-1] if _GATHERED else None
        if seen is not None and id(shard) in seen:
            return seen[id(shard)]
        full = _AllGather.apply(shard, self.pg, self.n, self.dim)
        if seen is not None:
            seen[id(shard)] = full
        return full

    def right_inverse(self, full):
        if self.tied:
            return full
        per = full.shape[self.dim] // self.n
        return full.narrow(self.dim, self.rank * per, per).clone()


def _shard_parameters(model: nn.Module, env: MeshEnv) -> dict:
    """Stage 3: every parameter that splits over sdp becomes its shard;
    returns {id(parameter): shard}."""
    n = env.get_dim("sdp")
    if n == 1:
        return {}
    pg, rank = env.group("sdp"), env.coord("sdp")
    remap = {}
    for mod in list(model.modules()):
        for name, p in list(mod._parameters.items()):
            if p is None:
                continue
            if id(p) in remap:  # tied: the same shard, gathered alike
                parametrize.register_parametrization(
                    mod, name, _SdpGather(p.zero3_dim, pg, n, rank,
                                          tied=True), unsafe=True)
                continue
            dim = _zero_dim(p.shape, env)
            if dim is None:
                continue
            parametrize.register_parametrization(
                mod, name, _SdpGather(dim, pg, n, rank), unsafe=True)
            shard = mod.parametrizations[name].original
            assert shard is p  # the parameter keeps its identity
            shard.zero3_dim = dim
            for attr in ("is_distributed", "mp_dim", "ep_dim",
                         "mp_blocks"):  # the marks
                if attr in vars(p):
                    setattr(shard, attr, vars(p)[attr])
            remap[id(p)] = shard
    return remap


def _slices(params, env: MeshEnv) -> dict:
    """Stages 1 and 2: this rank's slice of every parameter that splits
    over sdp, a tensor of its own (``zero_full`` the parameter,
    ``zero_dim`` the dim); returns {id(parameter): slice}."""
    n, rank = env.get_dim("sdp"), env.coord("sdp")
    out = {}
    for p in params:
        dim = _zero_dim(p.shape, env)
        if dim is None:
            continue
        per = p.shape[dim] // n
        piece = nn.Parameter(p.detach().narrow(dim, rank * per, per).clone(),
                             requires_grad=p.requires_grad)
        piece.zero_full, piece.zero_dim = p, dim
        out[id(p)] = piece
    return out


def _over(optimizer, params, stage: int):
    """A copy of ``optimizer`` (its rule, hyperparameters, names and
    learning rate or schedule) over ``params``, without state."""
    new = copy.copy(optimizer)
    new._parameter_list = list(params)
    new._state = {}
    new._batch = new._batch_key = new._reserved = None
    new._zero_stage = stage
    return new


def group_sharded_parallel(model: nn.Module, optimizer, level: str = "p_g_os",
                           scaler=None, group=None, offload=False,
                           sync_buffers=False, buffer_max_size=2 ** 23,
                           segment_size=2 ** 20, sync_comm=False):
    """Reference ``group_sharded.py:group_sharded_parallel`` (``level`` in
    ``{"os", "os_g", "p_g_os"}``); returns ``(model, optimizer)``, with
    ``scaler`` ``(model, optimizer, scaler)``: the optimizer a copy of the
    one given (which stays as it was) over this rank's slices of the
    parameters that split over sdp (stage 3: the model's shards) and the
    others whole. ``offload=True``: the optimizer's masters and state rest
    in host memory (``ShardedTrainStep``'s offload), its stream groups
    sized by ``segment_size`` and ``buffer_max_size`` bytes."""
    if level not in _LEVELS:
        raise ValueError(f"bad sharding level {level!r}")
    if optimizer._state:
        raise ValueError("group_sharded_parallel takes an optimizer that has "
                         "not stepped yet")
    env = require_mesh_env()
    stage = _LEVELS[level]
    if stage == 3:
        remap = _shard_parameters(model, env)
    else:
        remap = _slices(optimizer._parameter_list, env)
    optimizer = _over(optimizer, [remap.get(id(p), p)
                                  for p in optimizer._parameter_list], stage)
    optimizer._offload = bool(offload)
    optimizer._stream_segment_size = int(segment_size)
    optimizer._stream_buffer_max_size = int(buffer_max_size)
    if scaler is not None:
        return model, optimizer, scaler
    return model, optimizer


def gather_full_state(model: nn.Module, env: MeshEnv = None):
    """The model's state with every ZeRO-3, tensor- and expert-parallel
    shard gathered, under the unparametrized names (collective: every rank
    calls it; every rank gets it)."""
    env = env or require_mesh_env()
    out = {}
    with torch.no_grad():
        for name, t in model.state_dict().items():
            key = name.replace(".parametrizations.", ".")
            if key.endswith(".original"):
                key = key[:-len(".original")]
            p = _find(model, name)
            dim = getattr(p, "zero3_dim", None)
            if dim is not None:
                t = all_gather_dim(t, env.group("sdp"), env.get_dim("sdp"),
                                   dim)
            mp_dim = getattr(p, "mp_dim", None)
            if mp_dim is not None and env.get_dim("mp") > 1:
                n = env.get_dim("mp")
                t = mp_unshard(all_gather_dim(t, env.group("mp"), n,
                                              mp_dim).chunk(n, dim=mp_dim),
                               mp_dim, getattr(p, "mp_blocks", 1))
            ep_dim = getattr(p, "ep_dim", None)
            if ep_dim is not None and env.get_dim("ep") > 1:
                t = all_gather_dim(t, env.group("ep"), env.get_dim("ep"),
                                   ep_dim)
            out[key] = t.contiguous().clone()
    return out


def _find(model, name):
    obj = model
    for part in name.split("."):
        indexed = part.isdigit() and isinstance(obj, (nn.ModuleList,
                                                      nn.Sequential))
        obj = obj[int(part)] if indexed else getattr(obj, part)
    return obj


def save_group_sharded_model(model, output, optimizer=None):
    """Rank 0 writes the gathered parameters to ``output + ".pdparams"``;
    with ``optimizer`` each rank writes its own state (its shards) to
    ``output + ".pdopt.<rank>"``."""
    state = gather_full_state(model)
    if dist.get_rank() == 0:
        torch.save({k: v.cpu() for k, v in state.items()},
                   output + ".pdparams")
    if optimizer is not None:
        torch.save(optimizer.state_dict(),
                   f"{output}.pdopt.{dist.get_rank()}")
    dist.barrier()
