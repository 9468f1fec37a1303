"""Device-mesh helpers: the DP analog (batch/channel sharding).

Counterpart of ``pffft_tpu/parallel/mesh.py``.  PFFFT scales throughput
by calling its thread-shareable plan from many CPU threads; here the
batch axis of an array is sharded over the ranks of a process group, and
every rank transforms its own rows: no collective on the FFT path at all
(each transform is independent).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
ranks of the default process group, and a sharded array a
:class:`torch.distributed.tensor.DTensor`.  Nothing here starts a process
group: the caller runs ``torch.distributed.init_process_group`` in every
rank first (NCCL for CUDA meshes, gloo for CPU ones).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor

__all__ = ["make_mesh", "batch_sharding", "shard_batch"]

# the process-group backend each mesh device type needs
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Tuple[str, ...] = ("data",),
    shape: Optional[Tuple[int, ...]] = None,
    device_type: str = "cuda",
) -> DeviceMesh:
    """Build a mesh over the ranks of the default process group.

    Default is a 1-D ``('data',)`` mesh of every rank; pass ``shape`` and
    ``axis_names`` for 2-D (e.g. ``('data', 'seq')``) layouts.  The mesh
    spans the whole group, so ``n_devices`` (default: the world size) must
    equal the world size.  A CUDA mesh needs a group with an NCCL backend,
    a CPU mesh one with gloo: a mesh never changes its backend."""

    if not dist.is_initialized():
        raise ValueError(
            "make_mesh needs a process group: call torch.distributed."
            "init_process_group(backend, init_method=..., rank=..., world_size=...) "
            "in every rank first (nccl for a CUDA mesh, gloo for a CPU one)")
    want = _BACKENDS.get(device_type)
    backend = str(dist.get_backend())
    if want is None or want not in backend:
        raise ValueError(
            f"a {device_type!r} mesh needs a process group with the {want or 'nccl/gloo'} "
            f"backend; the default group's is {backend!r}")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"a mesh spans every rank of the process group: n_devices="
                         f"{n_devices}, world size {world}")
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def _mesh_dim(mesh: DeviceMesh, mesh_axis: Optional[str]) -> int:
    if mesh_axis is None:
        return 0
    return mesh.mesh_dim_names.index(mesh_axis)


def batch_sharding(mesh: DeviceMesh, ndim: int, axis: int = 0,
                   mesh_axis: Optional[str] = None) -> Tuple[Placement, ...]:
    """DTensor placements that split array axis ``axis`` over one mesh
    axis (the first by default) and replicate over the others."""

    out = [Replicate()] * mesh.ndim
    out[_mesh_dim(mesh, mesh_axis)] = Shard(axis % ndim)
    return tuple(out)


def check_device(x: torch.Tensor, mesh: DeviceMesh) -> None:
    """Raise unless ``x`` lies on the mesh's device type: a tensor is never
    moved between the CPU and the card behind the caller's back."""

    if x.device.type != mesh.device_type:
        raise ValueError(f"a {x.device.type} tensor given to a {mesh.device_type} mesh")


def shard_batch(x: torch.Tensor, mesh: DeviceMesh, axis: int = 0,
                mesh_axis: Optional[str] = None) -> DTensor:
    """Place ``x`` (the same global tensor on every rank) with its ``axis``
    sharded over the mesh (DP placement)."""

    check_device(x, mesh)
    return distribute_tensor(x, mesh, batch_sharding(mesh, x.ndim, axis, mesh_axis))
