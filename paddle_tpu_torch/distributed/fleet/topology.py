"""The hybrid topology over the mesh (port of
``paddle_tpu/distributed/fleet/topology.py``).

``CommunicateTopology`` is the cartesian rank grid (reference
``topology.py:36``). ``HybridCommunicateGroup`` (``:117``) answers the
degree and group queries from the installed mesh. Unlike the JAX one,
whose single controller sees every shard (its ranks are all 0), the
ranks are this process's: ``get_global_rank()`` is its rank in the world,
``get_model_parallel_rank()`` its index on mp, and each group is the
process group of that axis that holds it.
"""
from __future__ import annotations

import math

import numpy as np
import torch.distributed as dist

from ..collective import Group
from ..mesh import MeshEnv, get_mesh_env, init_mesh

__all__ = ["CommunicateTopology", "HybridCommunicateGroup"]


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding",
                                           "model"), dims=(1, 1, 1, 1)):
        self._names = list(hybrid_group_names)
        self._dims = list(dims)
        self._world = np.arange(math.prod(dims)).reshape(dims)

    def get_hybrid_group_names(self):
        return self._names

    def get_dim(self, axis_name):
        return self._dims[self._names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return int(self._world.size)

    def get_rank(self, **axis_coords):
        return int(self._world[tuple(axis_coords[n] for n in self._names)])

    def get_coord(self, rank):
        return tuple(int(c) for c in np.unravel_index(rank,
                                                      self._world.shape))

    def get_axis_list(self, axis_name, index):
        ax = self._names.index(axis_name)
        sl = [slice(None)] * len(self._names)
        sl[ax] = index
        return sorted(int(r) for r in self._world[tuple(sl)].reshape(-1))

    def get_comm_list(self, axis_name):
        ax = self._names.index(axis_name)
        moved = np.moveaxis(self._world, ax, -1).reshape(-1, self._dims[ax])
        return [list(map(int, row)) for row in moved]


class HybridCommunicateGroup:
    """Degrees, this process's coordinates and per-axis groups of the
    installed mesh (one is built from ``strategy``'s degrees when none
    is)."""

    def __init__(self, topology: CommunicateTopology = None, strategy=None):
        env = get_mesh_env()
        if env is None:
            degrees = {}
            if strategy is not None:
                h = strategy.hybrid_configs
                degrees = dict(dp=h["dp_degree"], mp=h["mp_degree"],
                               pp=h["pp_degree"],
                               sharding=h["sharding_degree"],
                               cp=h.get("cp_degree", 1),
                               ep=h.get("ep_degree", 1))
            env = init_mesh(**degrees)
        self._env = env
        self._topo = topology or CommunicateTopology(
            ("data", "pipe", "sharding", "model"),
            tuple(env.get_dim(ax) for ax in ("dp", "pp", "sdp", "mp")))

    @property
    def mesh_env(self) -> MeshEnv:
        return self._env

    def get_parallel_mode(self):
        from . import base

        for ax, mode in (("pp", base.ParallelMode.PIPELINE_PARALLEL),
                         ("sdp", base.ParallelMode.SHARDING_PARALLEL),
                         ("mp", base.ParallelMode.TENSOR_PARALLEL)):
            if self._env.get_dim(ax) > 1:
                return mode
        return base.ParallelMode.DATA_PARALLEL

    def topology(self):
        return self._topo

    def get_global_rank(self):
        return dist.get_rank()

    def get_rank_from_stage(self, stage_id, **kwargs):
        return stage_id

    # degrees
    def get_data_parallel_world_size(self):
        return self._env.get_dim("dp")

    def get_model_parallel_world_size(self):
        return self._env.get_dim("mp")

    def get_pipe_parallel_world_size(self):
        return self._env.get_dim("pp")

    def get_sharding_parallel_world_size(self):
        return self._env.get_dim("sdp")

    def get_context_parallel_world_size(self):
        return self._env.get_dim("cp")

    def get_expert_parallel_world_size(self):
        return self._env.get_dim("ep")

    # this process's coordinates
    def get_data_parallel_rank(self):
        return self._env.coord("dp")

    def get_model_parallel_rank(self):
        return self._env.coord("mp")

    def get_stage_id(self):
        return self._env.coord("pp")

    def get_sharding_parallel_rank(self):
        return self._env.coord("sdp")

    def get_context_parallel_rank(self):
        return self._env.coord("cp")

    # groups
    def _group(self, axis):
        return Group(self._env.group(axis), axis=axis)

    def get_data_parallel_group(self) -> Group:
        return self._group("dp")

    def get_model_parallel_group(self) -> Group:
        return self._group("mp")

    def get_pipe_parallel_group(self) -> Group:
        return self._group("pp")

    def get_sharding_parallel_group(self) -> Group:
        return self._group("sdp")

    def get_context_parallel_group(self) -> Group:
        return self._group("cp")

    def get_expert_parallel_group(self) -> Group:
        return self._group("ep")

    def get_check_parallel_group(self):
        return self._group("dp")

    def get_data_parallel_group_src_rank(self):
        return self.get_data_parallel_group().ranks[0]

    def get_model_parallel_group_src_rank(self):
        return self.get_model_parallel_group().ranks[0]

    def get_p2p_groups(self):
        return None
