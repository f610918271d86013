"""paddle_tpu_torch.distributed: the collective stack, one process per rank
(port of ``paddle_tpu/distributed``).

The JAX package is single-controller SPMD: one process sees every device
through a ``jax.sharding.Mesh`` and GSPMD inserts the collectives. The
port follows PyTorch's idiom and Paddle's own: each rank is a process,
``torch.distributed`` process groups are built per mesh axis
(:mod:`.mesh`), and the collectives are explicit, inside
``torch.autograd.Function``s where a gradient flows through them. What
agrees with the reference is the global result. The backend is the
caller's: ``nccl`` on the card, ``gloo`` on the CPU.

The pipeline (``meta_parallel``: ``PipelineLayer``, the 1F1B schedule
over P2P, ``PipelineParallel``, ``pipeline_local``) runs through
``ShardedTrainStep``, which also carries the in-graph ``GradScaler``,
gradient merge (``accum_steps``) and ``accumulate``; ``checkpoint``
saves each rank's shards and reshards them on load; an MoE model splits
its experts over ``ep`` (``models.moe``: ``global_scatter`` /
``global_gather``); ``offload`` keeps an offloaded optimizer's masters and
state in host memory and streams its update. The serving fleet's control
plane is here too: ``store`` (``TCPStore``), ``fleet.runtime`` (the
supervisor's ``FleetStateMachine``) and ``resilience`` (``FaultInjector``,
``PT_FAULTS``). Not ported yet (ROADMAP Queue 1 items 6 and 8): the
elastic training fleet, the parameter server, the launcher and the
auto-parallel planner.
"""
from __future__ import annotations

import os
import tempfile

from . import checkpoint, fleet  # noqa: F401
from .collective import (Group, ReduceOp, all_gather, all_gather_axis,
                         all_reduce, all_to_all_axis, alltoall, axis_index,
                         barrier, broadcast, get_group, get_rank,
                         get_world_size, init_parallel_env, irecv,
                         is_initialized, isend, new_group, pmean, ppermute,
                         psum, recv, reduce, reduce_scatter,
                         reduce_scatter_axis, scatter, send, STORE_ENV)
from .context_parallel import (ring_attention, ring_attention_bhsd,
                               ring_attention_local, ulysses_attention,
                               ulysses_attention_bshd,
                               ulysses_attention_local)
from .mesh import (MeshEnv, get_mesh_env, init_mesh, require_mesh_env,
                   reset_mesh)
from .models.moe import global_gather, global_scatter, number_count
from .parallel import (DataParallel, ShardedAccumulateStep, ShardedTrainStep,
                       default_batch_sharding, param_sharding, place_model,
                       shard_batch, zero_partition_spec)
from .sharding import group_sharded_parallel, save_group_sharded_model

__all__ = ["fleet", "checkpoint", "ShardedAccumulateStep", "Group", "ReduceOp", "new_group", "get_group",
           "is_initialized", "init_parallel_env", "get_rank",
           "get_world_size", "all_reduce", "all_gather", "broadcast",
           "reduce", "reduce_scatter", "alltoall", "scatter", "barrier",
           "send", "recv", "isend", "irecv", "psum", "pmean", "ppermute",
           "axis_index", "all_to_all_axis", "all_gather_axis",
           "reduce_scatter_axis", "MeshEnv", "init_mesh", "get_mesh_env",
           "require_mesh_env", "reset_mesh", "DataParallel",
           "ShardedTrainStep", "place_model", "param_sharding",
           "zero_partition_spec", "default_batch_sharding", "shard_batch",
           "group_sharded_parallel", "save_group_sharded_model",
           "ring_attention", "ring_attention_bhsd", "ring_attention_local",
           "ulysses_attention", "ulysses_attention_bshd",
           "ulysses_attention_local", "global_scatter", "global_gather",
           "number_count", "spawn", "ParallelEnv"]


def _spawn_entry(i, func, args, nprocs, store_path):
    os.environ.update({"RANK": str(i), "WORLD_SIZE": str(nprocs),
                       "LOCAL_RANK": str(i), "PADDLE_TRAINER_ID": str(i),
                       "PADDLE_TRAINERS_NUM": str(nprocs),
                       STORE_ENV: store_path})
    func(*args)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Runs ``func(*args)`` in ``nprocs`` new processes (reference
    ``spawn.py``), each a rank: ``init_parallel_env()`` there joins the
    others through a file store. ``nprocs=-1`` takes one process a
    visible CUDA card (at least one card is needed for it).
    ``options["store_dir"]`` is where the store's file goes (default: a
    new temporary directory). ``func`` must be importable (the processes
    are spawned, not forked)."""
    import torch
    import torch.multiprocessing as tmp

    if nprocs == -1:
        nprocs = torch.cuda.device_count()
        if nprocs < 1:
            raise ValueError("spawn(nprocs=-1) takes one process a CUDA "
                             "card and there is none; pass nprocs")
    store_dir = options.get("store_dir") or tempfile.mkdtemp(
        prefix="pt_spawn_")
    path = os.path.join(store_dir, "filestore")
    return tmp.start_processes(_spawn_entry, args=(func, tuple(args), nprocs,
                                                   path),
                               nprocs=nprocs, join=join, daemon=daemon,
                               start_method="spawn")


class ParallelEnv:
    """Reference ``parallel.py`` ``ParallelEnv``: the launch environment."""

    def __init__(self):
        env = os.environ
        self.rank = get_rank()
        self.world_size = get_world_size()
        self.nranks = self.world_size
        self.local_rank = int(env.get("LOCAL_RANK", 0))
        self.device_id = self.local_rank
        self.current_endpoint = env.get("PADDLE_CURRENT_ENDPOINT", "")
        self.trainer_endpoints = [
            e for e in env.get("PADDLE_TRAINER_ENDPOINTS", "").split(",") if e]
