"""2D mesh / torus topology of the constellation (paper §2.1, §4.1).

Worker coordinates, the radius-1 neighbor table and the hop helpers
(`hops`, `hop_matrix`, `mean_hops`: what Table 1's measured column reads)
are host numpy, built once at initialization; `hop_dist` prices
thief→victim distances on tensors from the (W, 2) coordinate table, so the
simulator never builds a dense (W, W) matrix.

Workers 0..C-1 fill a ⌈√C⌉-wide grid row-major; the last row may be ragged.
With `torus=True` a row wraps when it is fully populated and a column wraps
when it reaches the last row. The routing patches and the detour oracle of
the link-state model come with the link-state simulator.
"""

from __future__ import annotations

import dataclasses
import math
from functools import cached_property

import numpy as np
import torch

# Direction encoding used across the simulator: N, S, W, E.
DIRECTIONS: tuple[tuple[int, int], ...] = ((-1, 0), (1, 0), (0, -1), (0, 1))
NUM_DIRECTIONS = len(DIRECTIONS)
NO_NEIGHBOR = -1

# Path cost of a worker pair with no live route between them: small enough
# that sums with real link latencies never overflow int32, large enough that
# `cost < UNREACHABLE` separates routable pairs.
UNREACHABLE = np.int32(1 << 28)


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """A (possibly partial) 2D mesh of `num_workers` workers on a
    `rows` x `cols` bounding grid, filled row-major."""

    num_workers: int
    rows: int
    cols: int
    torus: bool = False

    def __post_init__(self):
        if self.num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if self.rows * self.cols < self.num_workers:
            raise ValueError(
                f"grid {self.rows}x{self.cols} too small for {self.num_workers} workers"
            )

    @staticmethod
    def square(num_workers: int, torus: bool = False) -> "MeshTopology":
        """Paper §4.1 mapping: side length ⌈√C⌉, rows filled in order."""
        side = math.isqrt(num_workers)
        if side * side < num_workers:
            side += 1
        rows = (num_workers + side - 1) // side
        return MeshTopology(num_workers=num_workers, rows=rows, cols=side, torus=torus)

    @staticmethod
    def grid(rows: int, cols: int, torus: bool = False) -> "MeshTopology":
        return MeshTopology(num_workers=rows * cols, rows=rows, cols=cols, torus=torus)

    def coords_of(self, worker: int) -> tuple[int, int]:
        return divmod(worker, self.cols)

    def worker_at(self, r: int, c: int) -> int:
        w = r * self.cols + c
        inside = 0 <= r < self.rows and 0 <= c < self.cols
        return w if inside and w < self.num_workers else NO_NEIGHBOR

    @cached_property
    def coords(self) -> np.ndarray:
        """(num_workers, 2) int32 array of (row, col)."""
        ws = np.arange(self.num_workers)
        return np.stack([ws // self.cols, ws % self.cols], axis=1).astype(np.int32)

    @cached_property
    def neighbor_table(self) -> np.ndarray:
        """(num_workers, 4) int32: neighbor id per direction or NO_NEIGHBOR."""
        tab = np.full((self.num_workers, NUM_DIRECTIONS), NO_NEIGHBOR, dtype=np.int32)
        full_rows = self.num_workers // self.cols  # rows that are completely filled
        for w in range(self.num_workers):
            r, c = divmod(w, self.cols)
            for d, (dr, dc) in enumerate(DIRECTIONS):
                rr, cc = r + dr, c + dc
                if self.torus:
                    if dc != 0 and r < full_rows:
                        cc %= self.cols
                    if dr != 0:
                        # the column wraps at the last row it reaches
                        full_col = self.worker_at(self.rows - 1, c) != NO_NEIGHBOR
                        rr %= self.rows if full_col else self.rows - 1
                tab[w, d] = self.worker_at(rr, cc)
        return tab

    @cached_property
    def neighbor_counts(self) -> np.ndarray:
        return (self.neighbor_table != NO_NEIGHBOR).sum(axis=1).astype(np.int32)

    def neighbors_of(self, worker: int) -> list[int]:
        return [int(n) for n in self.neighbor_table[worker] if n != NO_NEIGHBOR]

    def hops(self, a: int, b: int) -> int:
        """Manhattan hops between workers a and b (paper §3.3 ii: shortest
        paths); only an exact torus wraps."""
        ra, ca = self.coords_of(a)
        rb, cb = self.coords_of(b)
        dr, dc = abs(ra - rb), abs(ca - cb)
        if self.torus_full():
            dr = min(dr, self.rows - dr)
            dc = min(dc, self.cols - dc)
        return dr + dc

    @cached_property
    def hop_matrix(self) -> np.ndarray:
        """(num_workers, num_workers) int32 Manhattan hop distances."""
        rc = self.coords
        dr = np.abs(rc[:, None, 0] - rc[None, :, 0])
        dc = np.abs(rc[:, None, 1] - rc[None, :, 1])
        if self.torus_full():
            dr = np.minimum(dr, self.rows - dr)
            dc = np.minimum(dc, self.cols - dc)
        return (dr + dc).astype(np.int32)

    def mean_hops(self) -> float:
        """Average hop count between two distinct uniform-random workers;
        (2/3)·√N on a full √N×√N mesh as N grows."""
        n = self.num_workers
        if n == 1:
            return 0.0
        return float(self.hop_matrix.sum() / (n * (n - 1)))

    def torus_full(self) -> bool:
        """Whether the hop metric wraps (exact torus: every grid slot filled)."""
        return self.torus and self.num_workers == self.rows * self.cols


def hop_dist(mesh: MeshTopology, coords: torch.Tensor,
             victim: torch.Tensor) -> torch.Tensor:
    """(W,) int32 Manhattan hop count from worker w to ``victim[w]``
    (torus-aware). `coords` is the (W, 2) int32 coordinate tensor; victims
    are clipped, so NO_NEIGHBOR lanes give an in-range distance the caller
    masks."""
    v = victim.clamp(0, mesh.num_workers - 1).long()
    dr = (coords[:, 0] - coords[v, 0]).abs()
    dc = (coords[:, 1] - coords[v, 1]).abs()
    if mesh.torus_full():
        dr = torch.minimum(dr, mesh.rows - dr)
        dc = torch.minimum(dc, mesh.cols - dc)
    return (dr + dc).to(torch.int32)


# Default edge length of a routing patch of the sparse link-state backend:
# an axis shorter than twice the target is one patch, so every ring arc of a
# same-patch pair stays inside it; otherwise a patch spans at most half the
# axis, so the shorter ring arc of a same-patch pair is the direct one.
PATCH_TARGET = 32


def patch_dims(mesh: MeshTopology, target: int = PATCH_TARGET) -> tuple[int, int]:
    """(patch_rows, patch_cols) block shape for hierarchical routing."""
    if target < 1:
        raise ValueError("patch target must be >= 1")

    def pick(n: int) -> int:
        return n if n < 2 * target else target

    return pick(mesh.rows), pick(mesh.cols)


def patch_ids(mesh: MeshTopology, pr: int, pc: int) -> tuple[np.ndarray, int]:
    """((W,) int32 patch index per worker, number of patches): (pr, pc)
    blocks tiling the grid row-major, the trailing ones ragged."""
    if not (1 <= pr <= mesh.rows and 1 <= pc <= mesh.cols):
        raise ValueError(f"patch dims ({pr}, {pc}) outside grid "
                         f"{mesh.rows}x{mesh.cols}")
    npc = -(-mesh.cols // pc)
    r, c = mesh.coords[:, 0], mesh.coords[:, 1]
    pid = ((r // pr) * npc + (c // pc)).astype(np.int32)
    npr = -(-mesh.rows // pr)
    return pid, int(npr * npc)


def patch_centers(mesh: MeshTopology, pr: int, pc: int) -> np.ndarray:
    """(P,) int32 worker at the center of each patch, in patch-id order:
    the sparse routing backend's base landmarks."""
    npr = -(-mesh.rows // pr)
    npc = -(-mesh.cols // pc)
    out = np.empty(npr * npc, np.int32)
    for i in range(npr):
        r0, r1 = i * pr, min((i + 1) * pr, mesh.rows)
        rc = (r0 + r1 - 1) // 2
        for j in range(npc):
            c0, c1 = j * pc, min((j + 1) * pc, mesh.cols)
            cc = (c0 + c1 - 1) // 2
            out[i * npc + j] = rc * mesh.cols + cc
    return out


def detour_matrix(mesh: MeshTopology, link_tau: np.ndarray,
                  link_up: np.ndarray) -> np.ndarray:
    """(W, W) all-pairs shortest-path costs over live links: the dense
    Floyd–Warshall oracle (O(W^3), host side) of the link-state tables.
    `link_tau`/`link_up` are (W, 4) rows in `DIRECTIONS` order; dead or
    missing links add no edge; pairs with no live route cost
    `UNREACHABLE`."""
    W = mesh.num_workers
    inf = np.int64(1) << 40
    d = np.full((W, W), inf, np.int64)
    np.fill_diagonal(d, 0)
    nbr = mesh.neighbor_table
    for w in range(W):
        for k in range(NUM_DIRECTIONS):
            v = int(nbr[w, k])
            if v != NO_NEIGHBOR and bool(link_up[w, k]):
                d[w, v] = min(d[w, v], int(link_tau[w, k]))
    for k in range(W):
        d = np.minimum(d, d[:, k : k + 1] + d[k : k + 1, :])
    return np.minimum(d, UNREACHABLE).astype(np.int32)


def theoretical_mean_hops(n: int) -> float:
    """Paper §3.3: average hops between two random nodes of a √N×√N mesh ≈ (2/3)√N."""
    return (2.0 / 3.0) * math.sqrt(n)
