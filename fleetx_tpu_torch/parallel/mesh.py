"""The named mesh over ranks (port of ``fleetx_tpu/parallel/mesh.py``).

JAX lays devices out in a ``Mesh`` with the axes ``(pipe, data, fsdp,
seq, tensor)`` and lets GSPMD insert the collectives. Here the mesh is a
layout of the process group's ranks in the same shape and order (rank
``r`` sits where ``build_mesh(..., devices=jax.devices()[:n])`` puts
device ``r``: ``tensor`` innermost), with one process group per axis
(the ranks that differ only on that axis) and one CPU gloo group for the
host messages a serving leader broadcasts. The collectives a sharded
forward and a sharded training step call are the counterparts of
``jax.lax.axis_index``, ``pmax``, ``psum``, ``all_gather`` and
``psum_scatter`` (``reduce_scatter``) over a named axis, and a
``barrier``; each is the identity at axis size 1, so one-rank code runs
unchanged.

Gloo has no reduce-scatter: there ``reduce_scatter`` is an all-reduce
that keeps the rank's block. Under NCCL it is ``reduce_scatter_tensor``
(that branch runs only on a host with a card per rank).

A collective runs on the tensor where it lies: a CUDA tensor over gloo
(ranks sharing one card) is staged by gloo itself through pinned host
memory, for f32 and bf16 alike. A backend's error propagates: a rank
whose collective fails stops, it never reruns the collective alone.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Optional

import numpy as np
import torch

from fleetx_tpu_torch.parallel.rules import MESH_AXES
from fleetx_tpu_torch.utils.log import logger

#: how long a rank of the CPU group waits for the next host message (a
#: serving follower idles in a broadcast while its leader has no work)
CPU_GROUP_TIMEOUT = datetime.timedelta(days=7)

_global_mesh: Optional["Mesh"] = None


@dataclasses.dataclass
class Mesh:
    """Ranks laid out over ``MESH_AXES``.

    ``shape`` maps each axis to its size (in ``MESH_AXES`` order),
    ``ranks`` is the rank array of that shape, ``rank`` this process's
    rank; ``groups`` maps an axis above size 1 to its process group (None
    for a layout built without a process group), ``cpu_group`` is the
    gloo group for host messages.
    """

    shape: dict
    ranks: np.ndarray
    rank: int = 0
    groups: dict = dataclasses.field(default_factory=dict)
    cpu_group: Any = None

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def coords(self, rank: Optional[int] = None) -> dict:
        """Axis → index of ``rank`` (default this rank)."""
        r = self.rank if rank is None else int(rank)
        where = np.argwhere(self.ranks == r)[0]
        return {a: int(i) for a, i in zip(MESH_AXES, where)}

    def axis_index(self, axis: str) -> int:
        """This rank's index along ``axis`` (``jax.lax.axis_index``)."""
        return self.coords()[axis]

    @property
    def is_leader(self) -> bool:
        return self.rank == 0


@dataclasses.dataclass(frozen=True)
class MeshEnv:
    """The reference's hybrid-communicate-group view of the mesh."""

    mesh: Mesh

    def axis_size(self, name: str) -> int:
        return self.mesh.shape[name]

    @property
    def dp_world_size(self) -> int:
        # the reference treats dp x sharding as the data axis
        return self.axis_size("data") * self.axis_size("fsdp")

    @property
    def mp_world_size(self) -> int:
        return self.axis_size("tensor")

    @property
    def pp_world_size(self) -> int:
        return self.axis_size("pipe")

    @property
    def sp_world_size(self) -> int:
        return self.axis_size("seq")


def mesh_shape(dist_config: Optional[dict], n: int) -> tuple:
    """``(pipe, data, fsdp, seq, tensor)`` for ``n`` ranks: JAX's degree
    math, ``data`` absorbing what is left. A shape that does not cover
    ``n`` raises JAX's message."""
    cfg = dist_config or {}
    pp = int(cfg.get("pp_degree") or 1)
    fsdp = int(cfg.get("fsdp_degree") or 1)
    seq = int(cfg.get("seq_degree") or 1)
    mp = int(cfg.get("mp_degree") or 1)
    fixed = pp * fsdp * seq * mp
    dp = int(cfg.get("dp_degree") or 0)
    if dp <= 0:  # unset / 0 / -1: derive
        dp = n // fixed
    shape = (pp, dp, fsdp, seq, mp)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return shape


def _new_groups(ranks: np.ndarray, rank: int) -> dict:
    """One process group per axis above size 1. Every rank creates every
    group, in one order (``new_group`` is collective over the world), and
    keeps those it belongs to."""
    import torch.distributed as dist

    groups = {}
    for k, axis in enumerate(MESH_AXES):
        if ranks.shape[k] == 1:
            continue
        lines = np.moveaxis(ranks, k, -1).reshape(-1, ranks.shape[k])
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = group
    return groups


def build_mesh(dist_config: Optional[dict] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> Mesh:
    """The named mesh of a ``Distributed`` section over the world.

    Without arguments the world is the process group's (one rank without
    one), and every axis above size 1 gets its process group; a
    ``world_size`` other than the process group's builds the layout
    alone (no groups), as a device list does for JAX's ``build_mesh``.
    """
    import torch.distributed as dist

    from fleetx_tpu_torch.utils.env import get_rank, get_world_size

    live = dist.is_available() and dist.is_initialized()
    n = int(world_size) if world_size is not None else get_world_size()
    shape = mesh_shape(dist_config, n)
    ranks = np.arange(n).reshape(shape)
    grouped = live and n == get_world_size() and n > 1
    me = int(rank) if rank is not None else (get_rank() if grouped else 0)
    mesh = Mesh(shape=dict(zip(MESH_AXES, shape)), ranks=ranks, rank=me)
    if grouped:
        mesh.groups = _new_groups(ranks, me)
        mesh.cpu_group = dist.new_group(backend="gloo",
                                        timeout=CPU_GROUP_TIMEOUT)
    logger.info("mesh: %s over %d ranks", mesh.shape, n)
    return mesh


def set_mesh(mesh: Mesh) -> Mesh:
    """Install ``mesh`` as the process-global default."""
    global _global_mesh
    _global_mesh = mesh
    return mesh


def get_mesh() -> Mesh:
    """The process-global mesh (built over the world on first use)."""
    global _global_mesh
    if _global_mesh is None:
        _global_mesh = build_mesh()
    return _global_mesh


# ------------------------------------------------------------ collectives

def _group(mesh: Optional[Mesh], axis: str):
    """The process group of ``axis``, or None when the axis is trivial."""
    if mesh is None or mesh.shape.get(axis, 1) == 1:
        return None
    group = mesh.groups.get(axis)
    if group is None:
        raise RuntimeError(f"mesh axis {axis!r} has size "
                           f"{mesh.shape[axis]} but no process group: "
                           f"build the mesh inside the process group")
    return group


def axis_index(axis: str, mesh: Optional[Mesh]) -> int:
    """This rank's index along ``axis`` (0 without a mesh)."""
    return 0 if mesh is None else mesh.axis_index(axis)


def _all_reduce(op, x: torch.Tensor, axis: str,
                mesh: Optional[Mesh]) -> torch.Tensor:
    group = _group(mesh, axis)
    if group is None:
        return x
    import torch.distributed as dist

    t = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, op=op, group=group)
    return t


def psum(x: torch.Tensor, axis: str, mesh: Optional[Mesh]) -> torch.Tensor:
    """Sum over the ranks of ``axis`` (``jax.lax.psum``); a new tensor."""
    import torch.distributed as dist

    return _all_reduce(dist.ReduceOp.SUM, x, axis, mesh)


def pmax(x: torch.Tensor, axis: str, mesh: Optional[Mesh]) -> torch.Tensor:
    """Elementwise max over the ranks of ``axis`` (``jax.lax.pmax``)."""
    import torch.distributed as dist

    return _all_reduce(dist.ReduceOp.MAX, x, axis, mesh)


def all_gather(x: torch.Tensor, axis: str, mesh: Optional[Mesh],
               dim: int = 0) -> torch.Tensor:
    """The ranks' tensors of ``axis`` concatenated along ``dim`` in axis
    order (``jax.lax.all_gather(..., tiled=True)``); every rank's tensor
    has one shape."""
    group = _group(mesh, axis)
    if group is None:
        return x
    import torch.distributed as dist

    t = x.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def psum_axes(x: torch.Tensor, axes, mesh: Optional[Mesh]) -> torch.Tensor:
    """Sum over the ranks of every axis in ``axes``, in turn."""
    for axis in axes:
        x = psum(x, axis, mesh)
    return x


def reduce_scatter(x: torch.Tensor, axis: str, mesh: Optional[Mesh],
                   dim: int = 0) -> torch.Tensor:
    """Sum over the ranks of ``axis`` and keep this rank's block of
    ``dim`` (``jax.lax.psum_scatter(..., tiled=True)``); ``dim`` must
    split evenly."""
    group = _group(mesh, axis)
    if group is None:
        return x
    import torch.distributed as dist

    from fleetx_tpu_torch.utils.env import get_backend

    n = mesh.shape[axis]
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks of {axis!r}")
    at = mesh.axis_index(axis)
    if get_backend() == "nccl":
        t = x.movedim(dim, 0).contiguous()
        out = torch.empty((t.shape[0] // n, *t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.reduce_scatter_tensor(out, t, group=group)
        return out.movedim(0, dim)
    total = _all_reduce(dist.ReduceOp.SUM, x, axis, mesh)
    return total.narrow(dim, at * (x.shape[dim] // n),
                        x.shape[dim] // n).contiguous()


def barrier(mesh: Optional[Mesh]) -> None:
    """Every rank of the mesh reaches this point (over the CPU group)."""
    if mesh is None or mesh.cpu_group is None:
        return
    import torch.distributed as dist

    dist.barrier(group=mesh.cpu_group)


def broadcast_object(obj: Any, mesh: Mesh) -> Any:
    """Rank 0's ``obj`` on every rank, over the mesh's CPU group."""
    if mesh.cpu_group is None:
        return obj
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.cpu_group)
    return box[0]


def gather_objects(obj: Any, mesh: Mesh) -> list:
    """Every rank's ``obj``, in rank order, over the CPU group."""
    if mesh.cpu_group is None:
        return [obj]
    import torch.distributed as dist

    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.cpu_group)
    return out
