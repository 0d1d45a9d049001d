"""Device meshes of the launch stack, for the H100.

Functions, never module-level meshes (as `repro.launch.mesh` insists):
importing this module touches no device and forms no process group, so
tests and single-card runs keep seeing what they set up themselves.

The production shapes are H100 shapes, not the reference's TPU v5e pod
slices (16, 16) and (2, 16, 16). A node of the H100 holds 8 cards joined
all to all by NVLink (900 GB/s a card) and talks to other nodes over the
much slower network, so tensor parallelism ("model", an all-reduce or two
per layer) stays inside a node and FSDP + data parallelism ("data", one
all-gather and one reduce-scatter a weight per step) goes across nodes:

  * single: (32, 8) — 256 cards as 32 nodes of 8, ("data", "model");
  * multi:  (2, 32, 8) — two such clusters, ("pod", "data", "model"),
    "pod" pure data parallelism as in the reference.

These shapes are a choice of layout for 256 and 512 cards, not a
measurement: no run of this repository has had more than 4 cards.

A spec function of `launch.shardings` takes a `DeviceMesh` or a shape-only
`MeshShape` (axis names and sizes), so the rules can be checked at 256 or
512 devices without any (`production_shape`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

SINGLE_POD = (32, 8)              # 256 cards: 32 nodes x 8 (NVLink within a node)
MULTI_POD = (2, 32, 8)            # 2 x 256 cards
SINGLE_AXES = ("data", "model")
MULTI_AXES = ("pod", "data", "model")


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, without devices (the reference tests'
    `FakeMesh`): `shape` maps each axis name to its size."""
    shape: dict

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @classmethod
    def of(cls, sizes, names) -> "MeshShape":
        return cls(dict(zip(names, (int(n) for n in sizes))))


def production_shape(multi_pod: bool = False) -> MeshShape:
    """The production mesh's names and sizes, without devices."""
    if multi_pod:
        return MeshShape.of(MULTI_POD, MULTI_AXES)
    return MeshShape.of(SINGLE_POD, SINGLE_AXES)


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """The production `DeviceMesh` over the process group (which must have
    formed, with world size 256, or 512 with `multi_pod`): one card a
    rank, on the CUDA devices unless `device_type` says otherwise."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = production_shape(multi_pod)
    return init_device_mesh(device_type or _device_type(), tuple(shape.shape.values()),
                            mesh_dim_names=shape.axis_names)


def make_mesh(shape, axis_names=SINGLE_AXES, device_type: str | None = None):
    """A `DeviceMesh` of `shape` named `axis_names` over the process group
    (the launcher's 1 x 1 mesh on one card, the tests' 2 x 2 over gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type or _device_type(), tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def make_worker_mesh(rows: int, cols: int, device=None):
    """The mesh of the sharded work-stealing executor (one worker a shard,
    axes ("row", "col"), `core.scheduler.build_sharded_run`): a
    `DeviceMesh` of one worker a rank when `torch.distributed`'s process
    group has formed, else a `core.mesh_comm.LocalMesh` holding every
    worker on `device` (the CUDA device by default)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
        return make_mesh((rows, cols), ("row", "col"), kind)
    from ..core.mesh_comm import LocalMesh

    return LocalMesh((rows, cols), device=device)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a `DeviceMesh` or a `MeshShape`."""
    if isinstance(mesh, MeshShape):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def axis_names(mesh) -> tuple:
    return tuple(mesh_shape(mesh))


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (pod folds into DP)."""
    return tuple(n for n in axis_names(mesh) if n in ("pod", "data"))


def n_chips(mesh) -> int:
    return math.prod(mesh_shape(mesh).values())
