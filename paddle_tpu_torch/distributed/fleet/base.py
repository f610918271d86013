"""fleet facade: init / distributed_model / distributed_optimizer (port of
``paddle_tpu/distributed/fleet/base.py``; reference ``fleet_base.py:170,
839, 896`` and ``distributed_strategy.py:109``).
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch.distributed as dist

from ..collective import init_parallel_env
from ..mesh import get_mesh_env, init_mesh
from .topology import HybridCommunicateGroup

__all__ = ["ParallelMode", "DistributedStrategy", "init", "is_initialized",
           "get_hybrid_communicate_group", "distributed_model",
           "distributed_optimizer", "worker_index", "worker_num",
           "barrier_worker"]


class ParallelMode:
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


class DistributedStrategy:
    """The strategy's attribute tree (``distributed_strategy.proto``'s
    sections). Each field is either used by the port or warns when set:
    none is ignored without a word."""

    # knobs that rewrite the reduction's payload; the port reduces in the
    # gradients' dtype, bucket by bucket
    _UNSUPPORTED = {
        "dgc": "deep-gradient-compression rewrites the all-reduce payloads; "
               "the port all-reduces the gradients as they are",
        "fp16_allreduce": "the port already reduces in the model's dtype",
        "a_sync": "parameter-server async mode is not ported",
    }
    # accepted for compatibility; changing them changes nothing
    _COMPAT_DEFAULTS = {
        "find_unused_parameters": False,
        "fuse_all_reduce_ops": True,
        "fuse_grad_size_in_MB": 32,
        "nccl_comm_num": 1,
    }
    _PIPELINE_KEYS = frozenset(
        {"accumulate_steps", "micro_batch_size", "schedule_mode"})
    _PIPELINE_POSITIVE = ("accumulate_steps", "micro_batch_size")

    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
            "sharding_degree": 1, "cp_degree": 1, "ep_degree": 1,
        }
        self.amp = False
        self.amp_configs = {"init_loss_scaling": 65536.0,
                            "use_pure_fp16": False,
                            "custom_white_list": [], "custom_black_list": []}
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.sharding = False
        self.sharding_configs = {"stage": 1, "offload": False, "degree": 1}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1,
                                 "schedule_mode": "1F1B"}
        self.lamb = False
        self.lars = False
        self.dgc = False
        self.fp16_allreduce = False
        self.a_sync = False
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 1, "begin_step": 1}
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.gradient_scale_configs = {"scale_strategy": "avg"}

    @classmethod
    def _validate_pipeline_configs(cls, cfg):
        if not isinstance(cfg, dict):
            raise TypeError(
                f"pipeline_configs must be a dict, got {type(cfg).__name__}")
        unknown = set(cfg) - cls._PIPELINE_KEYS
        if unknown:
            raise ValueError(
                f"pipeline_configs: unknown key(s) {sorted(unknown)}; "
                f"valid keys: {sorted(cls._PIPELINE_KEYS)}")
        for key in cls._PIPELINE_POSITIVE:
            if key in cfg:
                v = cfg[key]
                if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                    raise ValueError(f"pipeline_configs[{key!r}] must be a "
                                     f"positive int, got {v!r}")

    def __setattr__(self, k, v):
        if k == "pipeline_configs":
            self._validate_pipeline_configs(v)
            v = _PipelineConfigs(v)
        if k in self._UNSUPPORTED and v:
            warnings.warn(f"DistributedStrategy.{k} has no effect in the "
                          f"port: {self._UNSUPPORTED[k]}", stacklevel=2)
        elif k in self._COMPAT_DEFAULTS and k in self.__dict__ \
                and v != self._COMPAT_DEFAULTS[k]:
            warnings.warn(f"DistributedStrategy.{k} is compat-only; "
                          f"changing it from {self._COMPAT_DEFAULTS[k]!r} "
                          f"does not alter execution", stacklevel=2)
        object.__setattr__(self, k, v)

    def __repr__(self):
        live = {k: v for k, v in self.__dict__.items() if v}
        return f"DistributedStrategy({live})"


class _PipelineConfigs(dict):
    """pipeline_configs whose item assignment is validated too."""

    def __setitem__(self, key, value):
        DistributedStrategy._validate_pipeline_configs({key: value})
        super().__setitem__(key, value)

    def update(self, *args, **kwargs):
        incoming = dict(*args, **kwargs)
        DistributedStrategy._validate_pipeline_configs(incoming)
        super().update(incoming)


class _FleetState:
    def __init__(self):
        self.initialized = False
        self.strategy: Optional[DistributedStrategy] = None
        self.hcg: Optional[HybridCommunicateGroup] = None


_STATE = _FleetState()


def init(role_maker=None, is_collective=True, strategy=None,
         log_level="INFO"):
    """``fleet.init`` (reference ``fleet_base.py:170``): the process group
    (``init_parallel_env``), then the mesh from the strategy's degrees, dp
    filled with what the others leave of the world size; raises
    ``ValueError`` when the degrees do not multiply to it (reference
    ``topology.py:191``)."""
    strategy = strategy or DistributedStrategy()
    h = strategy.hybrid_configs
    init_parallel_env()
    if get_mesh_env() is None:
        n = dist.get_world_size()
        degrees = dict(dp=h["dp_degree"], mp=h["mp_degree"],
                       pp=h["pp_degree"], sharding=h["sharding_degree"],
                       cp=h.get("cp_degree", 1), ep=h.get("ep_degree", 1))
        rest = 1
        for k, v in degrees.items():
            if k != "dp":
                rest *= v
        if degrees["dp"] == 1 and n % rest == 0:
            degrees["dp"] = n // rest
        if degrees["dp"] * rest != n:
            raise ValueError(f"hybrid degrees {degrees} do not multiply to "
                             f"the world size {n} (reference check: "
                             f"topology.py:191)")
        init_mesh(**degrees)
    _STATE.initialized = True
    _STATE.strategy = strategy
    _STATE.hcg = HybridCommunicateGroup(strategy=strategy)


def is_initialized():
    return _STATE.initialized


def get_hybrid_communicate_group() -> HybridCommunicateGroup:
    if _STATE.hcg is None:
        _STATE.hcg = HybridCommunicateGroup()
    return _STATE.hcg


def distributed_model(model):
    """``fleet_base.py:896`` (JAX ``fleet/base.py:194-211``): pure data
    parallel wraps the model in :class:`DataParallel`; tensor parallelism
    in ``TensorParallel`` and sharding in ``ShardingParallel`` (each
    making the model's replicas equal: ``place_model``; its mp layers
    communicate, ``ShardedTrainStep`` reduces); the pipeline in
    ``PipelineParallel``, whose ``train_batch`` runs the step."""
    from ..meta_parallel import (PipelineParallel, ShardingParallel,
                                 TensorParallel)
    from ..parallel import DataParallel

    hcg = get_hybrid_communicate_group()
    mode = hcg.get_parallel_mode()
    if mode == ParallelMode.PIPELINE_PARALLEL:
        return PipelineParallel(model, hcg, strategy=_STATE.strategy)
    if mode == ParallelMode.TENSOR_PARALLEL:
        return TensorParallel(model, hcg, strategy=_STATE.strategy)
    if mode == ParallelMode.SHARDING_PARALLEL:
        return ShardingParallel(model, hcg, strategy=_STATE.strategy)
    return DataParallel(model, strategy=_STATE.strategy)


def distributed_optimizer(optimizer, strategy=None):
    """``fleet_base.py:839`` (JAX ``fleet/base.py:214-221``): the optimizer
    in a ``HybridParallelOptimizer`` (the strategy's lamb / lars rule swap,
    gradient merge and localsgd); the gradient reduction and the ZeRO split
    are the step's."""
    from ..meta_parallel import HybridParallelOptimizer

    return HybridParallelOptimizer(optimizer, get_hybrid_communicate_group(),
                                   strategy or _STATE.strategy)


def worker_index():
    return dist.get_rank() if dist.is_initialized() else 0


def worker_num():
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier_worker():
    if dist.is_initialized():
        dist.barrier()
