"""The mesh and its collectives, in torch: what `jax.lax` gives the
reference's `shard_map` code (`axis_index`, `axis_size`, `ppermute`,
`all_gather`, `psum`), over two meshes behind one interface.

Code written against a mesh sees per-shard values with a leading *shard
axis* of `mesh.shards` entries, in worker-id (row-major) order, where the
reference's per-device code sees one device's slice:

  * `LocalMesh` holds every worker on one device: the shard axis has one
    entry a worker. `ppermute` is an index move along a mesh axis (zeros
    where nothing arrives), `all_gather` a broadcast of the shard axis,
    `psum` a sum. This is how the sharded executor runs on one card, and
    on the CPU in the tests: it plays the part of the reference's forced
    host devices.
  * `DistMesh` wraps a `torch.distributed.device_mesh.DeviceMesh`, one
    worker a rank: the shard axis has one entry. `ppermute` is one
    `batch_isend_irecv` within the axis's group, `all_gather` and `psum`
    the group's `all_gather` and `all_reduce`. Rank r is the worker at its
    mesh coordinate, which for a ("row", "col") mesh is r = row·C + col,
    the reference's ``my_id()``.

`as_mesh` takes either (a `DeviceMesh` is wrapped). Semantics follow
`jax.lax`: `ppermute(x, axis, pairs)` sends shard i's value to shard j for
each (i, j) along `axis` (each source and each destination at most once)
and gives zeros where nothing arrives; `all_gather(x, axis)` gives each
shard the values of its axis group, stacked on a new axis after the shard
axis; `psum(x, axis)` sums within the group, in the value's own dtype (an
int32 sum wraps, as XLA's does).
"""

from __future__ import annotations

import math

import torch

from . import resolve_device


def _check_pairs(pairs, n: int, axis: str):
    """`jax.lax.ppermute`'s rule: indices in range, no source and no
    destination twice."""
    src = [s for s, _ in pairs]
    dst = [d for _, d in pairs]
    if any(not 0 <= i < n for i in src + dst):
        raise ValueError(f"ppermute along {axis!r} (size {n}): pair out of range in {pairs}")
    if len(set(src)) != len(src) or len(set(dst)) != len(dst):
        raise ValueError(f"ppermute along {axis!r}: a source or destination "
                         f"repeats in {pairs}")


def _runs(pairs) -> list:
    """`pairs` as maximal runs [src, dst, length] of consecutive sources
    sent to consecutive destinations: a shift along an axis is one run, or
    two on a ring."""
    runs = []
    for s, d in sorted(pairs):
        if runs and s == runs[-1][0] + runs[-1][2] and d == runs[-1][1] + runs[-1][2]:
            runs[-1][2] += 1
        else:
            runs.append([s, d, 1])
    return runs


class LocalMesh:
    """Every worker of a mesh of `shape` (axes `axis_names`) on one
    `device` (default: the CUDA device; raises if there is none — pass
    ``device="cpu"`` for the plain PyTorch path)."""

    local = True

    def __init__(self, shape, axis_names=("row", "col"), device=None):
        self.shape = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axis names "
                             f"{self.axis_names} differ in length")
        self.device = resolve_device(device, "repro_torch's local mesh runs")
        self.shards = math.prod(self.shape)
        coords = torch.unravel_index(torch.arange(self.shards, device=self.device),
                                     self.shape)
        self._index = {name: c.to(torch.int32) for name, c in zip(self.axis_names, coords)}

    def _dim(self, axis: str) -> int:
        return self.axis_names.index(axis)

    def axis_size(self, axis: str) -> int:
        return self.shape[self._dim(axis)]

    def axis_index(self, axis: str) -> torch.Tensor:
        """(shards,) int32: each shard's coordinate along `axis`."""
        return self._index[axis]

    def ppermute(self, x: torch.Tensor, axis: str, pairs) -> torch.Tensor:
        ax, n = self._dim(axis), self.axis_size(axis)
        _check_pairs(pairs, n, axis)
        xs = x.unflatten(0, self.shape)
        out = torch.zeros_like(xs)
        for s, d, length in _runs(pairs):
            out.narrow(ax, d, length).copy_(xs.narrow(ax, s, length))
        return out.flatten(0, len(self.shape) - 1)

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        ax, nd = self._dim(axis), len(self.shape)
        xs = x.unflatten(0, self.shape)
        # shard c's row: xs with c's coordinate along `axis` running over it
        g = xs.movedim(ax, nd - 1).unsqueeze(ax).expand(
            *self.shape, self.shape[ax], *xs.shape[nd:])
        return g.flatten(0, nd - 1)

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        xs = x.unflatten(0, self.shape)
        s = xs.sum(self._dim(axis), keepdim=True, dtype=x.dtype).expand_as(xs)
        return s.flatten(0, len(self.shape) - 1)


class DistMesh:
    """A `DeviceMesh` of `torch.distributed` ranks, one worker a rank. Its
    groups must have formed (`init_process_group` first); raises where
    they have not."""

    local = False

    def __init__(self, device_mesh):
        import torch.distributed as dist

        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("a DeviceMesh mesh needs torch.distributed's default "
                               "process group (init_process_group) to have formed")
        names = device_mesh.mesh_dim_names
        if not names:
            raise ValueError("the DeviceMesh needs mesh_dim_names, e.g. ('row', 'col')")
        self._dist = dist
        self.axis_names = tuple(names)
        self.shape = tuple(int(n) for n in device_mesh.shape)
        self.shards = 1
        coord = device_mesh.get_coordinate()
        if coord is None:
            raise RuntimeError(f"rank {dist.get_rank()} is not part of the DeviceMesh")
        self._coord = dict(zip(self.axis_names, coord))
        try:
            self._groups = {n: device_mesh.get_group(n) for n in self.axis_names}
        except (RuntimeError, ValueError) as e:
            raise RuntimeError(f"the DeviceMesh's axis groups did not form: {e}") from e
        kind = device_mesh.device_type
        self.device = (torch.device(kind, torch.cuda.current_device()) if kind == "cuda"
                       else torch.device(kind))
        self._index = {n: torch.tensor([c], dtype=torch.int32, device=self.device)
                       for n, c in self._coord.items()}

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def axis_index(self, axis: str) -> torch.Tensor:
        return self._index[axis]

    def ppermute(self, x: torch.Tensor, axis: str, pairs) -> torch.Tensor:
        dist, group, me = self._dist, self._groups[axis], self._coord[axis]
        _check_pairs(pairs, self.axis_size(axis), axis)
        x = x.contiguous()
        out = torch.zeros_like(x)
        p2p = []
        for s, d in pairs:
            if s == me and d == me:
                out.copy_(x)
            elif s == me:
                p2p.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, d), group))
            elif d == me:
                p2p.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, s), group))
        if p2p:
            for req in dist.batch_isend_irecv(p2p):
                req.wait()
        return out

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.axis_size(axis))]
        self._dist.all_gather(parts, x, group=self._groups[axis])
        return torch.stack(parts, dim=1)

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        out = x.clone()
        self._dist.all_reduce(out, op=self._dist.ReduceOp.SUM, group=self._groups[axis])
        return out

    def gather_shards(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's value, in worker-id order, on every rank: one
        all_gather an axis (the result's axes come out last axis first)."""
        for name in self.axis_names:
            x = self.all_gather(x, name)
        nd = len(self.axis_names)
        return x[0].permute(*range(nd - 1, -1, -1), *range(nd, x.dim() - 1)).flatten(0, nd - 1)


def as_mesh(mesh):
    """A `LocalMesh` or `DistMesh` as it is (or a wrapper of either, such as
    a counting one); a `torch.distributed` `DeviceMesh` wrapped in a
    `DistMesh`."""
    if hasattr(mesh, "ppermute"):
        return mesh
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(mesh, DeviceMesh):
        return DistMesh(mesh)
    raise TypeError(f"expected a LocalMesh or a DeviceMesh, got {type(mesh).__name__}")
