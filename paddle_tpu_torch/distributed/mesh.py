"""The device mesh: one process per rank, a process group per axis (port of
``paddle_tpu/distributed/mesh.py``).

The JAX package drives every device from one process through a
``jax.sharding.Mesh`` whose named axes are the parallelism dimensions, and
GSPMD inserts the collectives. The port follows PyTorch's idiom and
Paddle's own: one process per rank, a ``torch.distributed`` process group
per mesh axis (``torch.distributed.device_mesh.init_device_mesh``), and
explicit collectives. The axes and their order are the JAX package's::

    pp   pipeline stages          dp   data parallel
    sdp  ZeRO sharding            ep   expert parallel
    cp   context (sequence)       mp   tensor (model) parallel, innermost

so a rank's coordinate is its place in the row-major grid
``(pp, dp, sdp, ep, cp, mp)``. ``shard_map_compat`` and
``shard_map_requires_native`` are JAX-only and have no counterpart.

A mesh's process groups live as long as the world: ``reset_mesh``
uninstalls the mesh and keeps its groups, and ``init_mesh`` with the same
degrees installs the same ``MeshEnv`` again, so a world may go from mesh
to mesh and back in one set of processes. Destroying a mesh's NCCL
groups after a graphed step hung on every rank on four H100s: destroying
a group while a CUDA graph that captured collectives over it is still
alive does not return (a graphed step keeps its graphs), while the same
destroys after plain all-reduces return on every rank, whatever their
order. The groups are freed with the world, by
``torch.distributed.destroy_process_group()``, PyTorch's idiom: process
groups are made once.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch.distributed as dist

__all__ = ["AXES", "MESH_ORDER", "MeshEnv", "init_mesh", "get_mesh_env",
           "require_mesh_env", "reset_mesh"]

AXES = ("dp", "pp", "sdp", "mp", "cp", "ep")
MESH_ORDER = ("pp", "dp", "sdp", "ep", "cp", "mp")  # mp innermost

_GLOBAL: Dict[str, Optional["MeshEnv"]] = {"env": None}
# every mesh built in the current world, by (degrees, device type); the
# world they were built in (a new default group starts a new cache)
_BUILT: Dict[tuple, "MeshEnv"] = {}
_WORLD: Dict[str, object] = {"pg": None}


class MeshEnv:
    """The live mesh: axis degrees, this rank's coordinate on each axis, and
    a process group per axis (the ``HybridCommunicateGroup`` role).
    Needs an initialised default process group (``init_parallel_env``);
    raises ``ValueError`` when the degrees do not multiply to its size."""

    def __init__(self, degrees: Dict[str, int], device_type: str = None):
        from torch.distributed.device_mesh import init_device_mesh

        if not dist.is_initialized():
            raise RuntimeError("MeshEnv needs a process group: call "
                               "paddle_tpu_torch.distributed."
                               "init_parallel_env() first")
        full = {ax: int(degrees.get(ax, 1)) for ax in AXES}
        n = math.prod(full.values())
        world = dist.get_world_size()
        if n != world:
            raise ValueError(f"product of axis degrees {full} = {n} != "
                             f"world size {world}")
        self.degrees = full
        self.axis_names = MESH_ORDER
        if device_type is None:
            device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        self.device_type = device_type
        self.mesh = init_device_mesh(
            device_type, tuple(full[ax] for ax in MESH_ORDER),
            mesh_dim_names=MESH_ORDER)
        self.rank = dist.get_rank()
        self._coord = dict(zip(MESH_ORDER, self.mesh.get_coordinate()))
        self._combined: Dict[Tuple[str, ...], object] = {}

    # -- queries (CommunicateTopology's shape) --------------------------------
    def get_dim(self, axis: str) -> int:
        return self.degrees[axis]

    @property
    def nranks(self) -> int:
        return math.prod(self.degrees.values())

    def coord(self, axis: str) -> int:
        """This rank's index on ``axis``."""
        return int(self._coord[axis])

    def size_over(self, axes: Sequence[str]) -> int:
        return math.prod(self.degrees[ax] for ax in axes)

    def group(self, axis: str):
        """The process group of ``axis`` that holds this rank."""
        return self.mesh.get_group(axis)

    @staticmethod
    def _ordered(axes) -> Tuple[str, ...]:
        return tuple(ax for ax in MESH_ORDER if ax in axes)

    def group_over(self, axes: Sequence[str]):
        """The process group over several axes at once (the ranks that
        share this rank's coordinate on every other axis), in row-major
        order of ``axes``. Collective on its first call for a set of axes:
        every rank must ask for the same sets in the same order."""
        key = self._ordered(axes)
        if len(key) == 1:
            return self.group(key[0])
        pg = self._combined.get(key)
        if pg is None:
            if self.size_over(key) == self.nranks:
                pg = dist.group.WORLD
            else:
                grid = self.mesh.mesh  # ranks, shape MESH_ORDER
                dims = [MESH_ORDER.index(ax) for ax in key]
                rest = [i for i in range(len(MESH_ORDER)) if i not in dims]
                lists = grid.permute(rest + dims).reshape(
                    -1, self.size_over(key)).tolist()
                pg, _ = dist.new_subgroups_by_enumeration(lists)
            self._combined[key] = pg
        return pg

    def __repr__(self):
        used = {k: v for k, v in self.degrees.items() if v > 1}
        return f"MeshEnv({used or 'single-rank'}, ranks={self.nranks})"


def init_mesh(dp=1, mp=1, pp=1, sharding=1, cp=1, ep=1,
              device_type: str = None) -> MeshEnv:
    """Creates and installs the global mesh (the JAX ``init_mesh``). The
    default process group must exist; a mesh installed before is
    uninstalled first. A mesh of the same degrees built before in this
    world is installed again, groups and all (collective only when it is
    new: every rank must build the same meshes in the same order)."""
    reset_mesh()
    degrees = {"dp": dp, "mp": mp, "pp": pp, "sdp": sharding, "cp": cp,
               "ep": ep}
    if dist.is_initialized() and _WORLD["pg"] is not dist.group.WORLD:
        _BUILT.clear()  # a new world: the old groups went with the old one
        _WORLD["pg"] = dist.group.WORLD
    key = (tuple(int(degrees[ax]) for ax in AXES), device_type)
    env = _BUILT.get(key)
    if env is None:
        env = MeshEnv(degrees, device_type)
        _BUILT[key] = env
    _GLOBAL["env"] = env
    return env


def get_mesh_env() -> Optional[MeshEnv]:
    return _GLOBAL["env"]


def require_mesh_env() -> MeshEnv:
    """The installed mesh, or one with every rank on dp (the JAX
    ``auto_mesh``) over the default process group."""
    env = _GLOBAL["env"]
    if env is None:
        env = init_mesh(dp=dist.get_world_size())
    return env


def reset_mesh():
    """Uninstalls the mesh. Its process groups stay for the life of the
    world (the module docstring says why); ``init_mesh`` with the same
    degrees reuses them."""
    _GLOBAL["env"] = None
