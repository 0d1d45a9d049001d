"""2D mesh / torus topology of the constellation (paper §2.1, §4.1).

Worker coordinates and the radius-1 neighbor table are host numpy, built
once at initialization; `hop_dist` prices thief→victim distances on tensors
from the (W, 2) coordinate table, so no dense (W, W) matrix is ever built.

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
