"""Time-varying link state of the constellation's mesh (paper §2.1).

Time is split into epochs at `epoch_starts` (ticks, the first 0); within an
epoch every link's one-hop latency ``link_tau[e, w, d]`` (ticks, >= 1, in
`topology.DIRECTIONS` order N, S, W, E), its availability ``link_up[e, w,
d]`` and every worker's straggler divisor ``speed[e, w]`` are constant.
Links are undirected: each entry agrees with the reverse entry on the
neighbor's side (`LinkStateSchedule.validate`).

A flight that departs at tick t costs the latency of its path in the epoch
of t. With every link of the epoch up, the path is dimension-order: the
source's column first, then the destination's row, the shorter ring arc of
each axis on a full torus (ties to the direct side); `build_tables` keeps
per-epoch prefix sums along both axes, so a price is a few gathers. Epochs
with a dead link price flights over live links only, from tables built once
per distinct link state:

  * dense: one (W, W) shortest-path table per distinct (τ, up) state
    (`live_path_costs`, checked against `topology.detour_matrix`);
  * sparse: the grid is cut into patches (`topology.patch_dims`); a
    same-patch pair in a patch with no dead inner link keeps its
    dimension-order price where that is cheaper, and every pair is priced
    through landmarks (each patch's center, plus one worker of each live
    component no center lands in): ``min_l lm[l, s] + lm[l, d]``, at most
    ``stretch_add`` above the true cost.

Per-epoch connected-component ids (`comp`, each component named by its
lowest worker id, identical under both backends) say which pairs are
reachable: a flight to another component never departs, and a reply whose
path an epoch change severed is denied its grant; the tables mark such pairs
`UNREACHABLE`, and `flight_ticks` prices them at the dimension-order cost
(the thief's timeout). Structure (components, patch flags, landmarks) is
deduplicated on `link_up` alone, costs on the full (τ, up) state.

The host side is numpy, with scipy's graph routines where they import and a
pure-numpy fallback otherwise; `build_tables` returns `LinkStateArrays` of
torch tensors on a device, built once per run. The device side (`epoch_index`,
`next_change`, `min_link_tau`, `flight_ticks`, `same_component`) takes an
epoch index that is a Python int, a 0-d tensor, or a per-point column (G, 1)
beside (G, W) workers, and never builds a (W, W) intermediate.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from . import topology as topo

try:  # the pure-numpy fallback below runs where scipy does not import
    from scipy.sparse import csr_matrix as _csr
    from scipy.sparse.csgraph import (connected_components as _scipy_cc,
                                      dijkstra as _scipy_dijkstra)
    _HAVE_SCIPY = True
except Exception:  # pragma: no cover - exercised by forcing the flag off
    _HAVE_SCIPY = False

# Direction indices into topology.DIRECTIONS ((-1,0),(1,0),(0,-1),(0,1)).
NORTH, SOUTH, WEST, EAST = range(topo.NUM_DIRECTIONS)
OPPOSITE = (SOUTH, NORTH, EAST, WEST)

UNREACHABLE = topo.UNREACHABLE

# Landmark costs hold uint16 values (2 bytes an entry in `table_bytes`);
# this is their no-route sentinel, mapped to UNREACHABLE where they are
# read. On the device they sit in int32 tensors (values 0..0xFFFF), since
# CUDA has no general uint16 arithmetic.
_LM_INF = 0xFFFF

# Meshes of at least this many workers get the sparse backend under "auto".
SPARSE_AUTO_MIN_WORKERS = 4096


def resolve_routing(routing: str, num_workers: int) -> str:
    """Resolve a ``routing`` argument ('auto' | 'dense' | 'sparse')."""
    if routing == "auto":
        return ("sparse" if num_workers >= SPARSE_AUTO_MIN_WORKERS
                else "dense")
    if routing not in ("dense", "sparse"):
        raise ValueError(
            f"routing must be 'auto', 'dense', or 'sparse', got {routing!r}")
    return routing


@dataclasses.dataclass(frozen=True)
class LinkStateSchedule:
    """Piecewise-constant link state, plain numpy (host side)."""

    epoch_starts: np.ndarray   # (E,) int32, epoch_starts[0] == 0, increasing
    link_tau: np.ndarray       # (E, W, 4) int32 one-hop latency, >= 1
    link_up: np.ndarray        # (E, W, 4) bool
    speed: np.ndarray          # (E, W) int32 straggler divisors, >= 1

    @property
    def num_epochs(self) -> int:
        return int(self.epoch_starts.shape[0])

    def epoch_of(self, t: int) -> int:
        return int(np.searchsorted(self.epoch_starts, t, side="right") - 1)

    def tau_at(self, t: int) -> np.ndarray:
        """(W, 4) link latencies active at tick `t`."""
        return self.link_tau[self.epoch_of(t)]

    def up_at(self, t: int) -> np.ndarray:
        """(W, 4) link availability active at tick `t`."""
        return self.link_up[self.epoch_of(t)]

    def speed_at(self, t: int) -> np.ndarray:
        return self.speed[self.epoch_of(t)]

    def mean_tau(self, mesh: topo.MeshTopology, horizon_ticks: int) -> float:
        """Duration-weighted mean latency of the existing links over
        `horizon_ticks`: the scalar τ a static baseline collapses to."""
        starts = self.epoch_starts.astype(np.int64)
        ends = np.append(starts[1:], max(horizon_ticks, int(starts[-1]) + 1))
        spans = np.maximum(ends - starts, 0).astype(np.float64)  # (E,)
        exists = mesh.neighbor_table != topo.NO_NEIGHBOR         # (W, 4)
        per_epoch = (self.link_tau * exists[None]).sum(axis=(1, 2)) / max(
            exists.sum(), 1)
        return float((per_epoch * spans).sum() / max(spans.sum(), 1.0))

    def validate(self, mesh: topo.MeshTopology) -> "LinkStateSchedule":
        E = self.num_epochs
        W = mesh.num_workers
        if self.epoch_starts.shape != (E,) or E == 0:
            raise ValueError("epoch_starts must be a non-empty 1D array")
        if int(self.epoch_starts[0]) != 0:
            raise ValueError("epoch_starts must begin at tick 0")
        if E > 1 and not (np.diff(self.epoch_starts) > 0).all():
            raise ValueError("epoch_starts must be strictly increasing")
        if self.link_tau.shape != (E, W, topo.NUM_DIRECTIONS):
            raise ValueError(f"link_tau must be (E, W, 4), got {self.link_tau.shape}")
        if self.link_up.shape != (E, W, topo.NUM_DIRECTIONS):
            raise ValueError(f"link_up must be (E, W, 4), got {self.link_up.shape}")
        if self.speed.shape != (E, W):
            raise ValueError(f"speed must be (E, W), got {self.speed.shape}")
        if (self.link_tau < 1).any():
            raise ValueError("link_tau entries must be >= 1 tick")
        if (self.speed < 1).any():
            raise ValueError("speed divisors must be >= 1")
        # undirected links: each existing link agrees with its reverse
        nbr = mesh.neighbor_table
        nbr_c = np.clip(nbr, 0, W - 1)
        for d in range(topo.NUM_DIRECTIONS):
            has = nbr[:, d] != topo.NO_NEIGHBOR
            rev_tau = self.link_tau[:, nbr_c[:, d], OPPOSITE[d]]
            rev_up = self.link_up[:, nbr_c[:, d], OPPOSITE[d]]
            if (has & (self.link_tau[:, :, d] != rev_tau)).any():
                raise ValueError(f"asymmetric link_tau along direction {d}")
            if (has & (self.link_up[:, :, d] != rev_up)).any():
                raise ValueError(f"asymmetric link_up along direction {d}")
        return self

    @staticmethod
    def static(mesh: topo.MeshTopology, tau: int,
               speed: np.ndarray | None = None) -> "LinkStateSchedule":
        """One epoch of uniform τ with every link up: the same run as the
        scalar ``hop_ticks=τ`` path."""
        W = mesh.num_workers
        sp = (np.ones((1, W), np.int32) if speed is None
              else np.asarray(speed, np.int32).reshape(1, W))
        return LinkStateSchedule(
            epoch_starts=np.zeros(1, np.int32),
            link_tau=np.full((1, W, topo.NUM_DIRECTIONS), int(tau), np.int32),
            link_up=np.ones((1, W, topo.NUM_DIRECTIONS), bool),
            speed=sp,
        ).validate(mesh)


class LinkStateArrays(NamedTuple):
    """A compiled schedule as device tensors (`build_tables`).

    `cum_v[e, k, c]` is the prefix sum of the southward latencies of rows
    < k in column c (row R-1 holds the ring-wrap link), `cum_h` the eastward
    one. `detour_idx[e]` is epoch e's row of the outage cost tables (-1:
    every link up, dimension-order pricing); `comp[e, w]` worker w's
    live-link component (its lowest worker id; all 0 in an all-up epoch).
    Dense backend: `detour[k]` a (W, W) live shortest-path table. Sparse
    backend: `lm_cost[k, l, w]` landmark l's live cost to w (uint16 values,
    `_LM_INF` for no route and for padding landmarks, held in int32),
    `patch_id[w]` and `patch_clean[k, p]` (no dead link inside patch p).
    Fields of the other backend, and all outage fields of a schedule
    without outages, are None."""
    epoch_starts: torch.Tensor   # (E,) int32
    link_tau: torch.Tensor       # (E, W, 4) int32
    link_up: torch.Tensor        # (E, W, 4) bool
    speed: torch.Tensor          # (E, W) int32
    cum_v: torch.Tensor          # (E, R+1, C) int32
    cum_h: torch.Tensor          # (E, R, C+1) int32
    detour: torch.Tensor | None  # (K, W, W) int32
    detour_idx: torch.Tensor     # (E,) int32
    comp: torch.Tensor           # (E, W) int32
    lm_cost: torch.Tensor | None = None      # (K, L, W) int32 holding uint16
    patch_id: torch.Tensor | None = None     # (W,) int32
    patch_clean: torch.Tensor | None = None  # (K, P) bool


def has_outage_tables(tbl: LinkStateArrays) -> bool:
    """Host fact: does the schedule carry outage routing tables (of either
    backend), i.e. has some epoch a dead link?"""
    return tbl.detour is not None or tbl.lm_cost is not None


def table_bytes(tbl: LinkStateArrays) -> int:
    """Bytes of the outage routing tables as the reference counts them:
    the epoch→row index and component rows at 4 bytes an entry, dense rows
    at 4, landmark entries at 2 (uint16), patch flags at 1 and patch ids at
    4. `resident_bytes` counts what the tensors hold."""
    n = tbl.detour_idx.numel() * 4 + tbl.comp.numel() * 4
    if tbl.detour is not None:
        n += tbl.detour.numel() * 4
    if tbl.lm_cost is not None:
        n += (tbl.lm_cost.numel() * 2 + tbl.patch_clean.numel()
              + tbl.patch_id.numel() * 4)
    return int(n)


def resident_bytes(tbl: LinkStateArrays) -> int:
    """Bytes the tensors of `tbl` hold on their device, every field."""
    return int(sum(x.numel() * x.element_size() for x in tbl if x is not None))


@dataclasses.dataclass(frozen=True)
class RoutingBuildStats:
    """Build report of `build_tables` (host side)."""
    routing: str               # "dense" | "sparse" (resolved)
    num_epochs: int
    outage_epochs: int
    struct_classes: int        # distinct link_up states among outage epochs
    cost_classes: int          # distinct (τ, up) states among outage epochs
    struct_dedup_hits: int     # outage epochs that reused a struct class
    cost_dedup_hits: int       # outage epochs that reused a cost class
    table_bytes: int           # routing-table bytes (see table_bytes)
    dense_equiv_bytes: int     # cost_classes · W² · 4 — what dense would cost
    build_seconds: float
    num_landmarks: int = 0     # sparse: padded landmark count L
    num_patches: int = 0       # sparse: patch count P
    patch_shape: tuple[int, int] = (0, 0)
    stretch_add: int = 0       # sparse: max additive stretch 2ρ over classes


def _live(mesh: topo.MeshTopology, up_row) -> np.ndarray:
    return (mesh.neighbor_table != topo.NO_NEIGHBOR) & np.asarray(up_row, bool)


def live_path_costs(mesh: topo.MeshTopology, tau_row: np.ndarray,
                    up_row: np.ndarray) -> np.ndarray:
    """(W, W) int32 all-pairs shortest-path costs over live links, by
    repeated min-plus relaxation of every live edge at once (it converges
    in at most the live graph's diameter of sweeps); unreachable pairs are
    `UNREACHABLE`."""
    W = mesh.num_workers
    inf = np.int64(1) << 40
    nbr_c = np.clip(mesh.neighbor_table, 0, W - 1)
    live = _live(mesh, up_row)
    tau = np.asarray(tau_row, np.int64)
    d = np.full((W, W), inf, np.int64)
    np.fill_diagonal(d, 0)
    for _ in range(W):
        nd = d
        for k in range(topo.NUM_DIRECTIONS):
            cand = np.where(live[:, k, None], tau[:, k, None] + d[nbr_c[:, k]],
                            inf)
            nd = np.minimum(nd, cand)
        if (nd == d).all():
            break
        d = nd
    return np.minimum(d, UNREACHABLE).astype(np.int32)


def _live_graph(mesh: topo.MeshTopology, tau_row, up_row):
    """Directed edge list (both arcs of each live link) of the live graph."""
    live = _live(mesh, up_row)
    src, d = np.nonzero(live)
    return (src, mesh.neighbor_table[src, d],
            np.asarray(tau_row)[src, d].astype(np.int64))


def live_components(mesh: topo.MeshTopology, up_row: np.ndarray) -> np.ndarray:
    """(W,) int32 live-link component ids, each component labeled by its
    lowest worker id: scipy's connected components where scipy imports,
    min-label propagation otherwise."""
    W = mesh.num_workers
    if _HAVE_SCIPY:
        src, dst, _ = _live_graph(mesh, np.ones((W, 4), np.int64), up_row)
        g = _csr((np.ones(len(src), np.int8), (src, dst)), shape=(W, W))
        _, labels = _scipy_cc(g, directed=False)
        lowest = np.full(labels.max() + 1 if W else 1, W, np.int64)
        np.minimum.at(lowest, labels, np.arange(W))
        return lowest[labels].astype(np.int32)
    nbr_c = np.clip(mesh.neighbor_table, 0, W - 1)
    live = _live(mesh, up_row)
    comp = np.arange(W)
    while True:
        nc = comp
        for k in range(topo.NUM_DIRECTIONS):
            nc = np.where(live[:, k], np.minimum(nc, comp[nbr_c[:, k]]), nc)
        if (nc == comp).all():
            return comp.astype(np.int32)
        comp = nc


def landmark_costs(mesh: topo.MeshTopology, tau_row: np.ndarray,
                   up_row: np.ndarray, landmarks: np.ndarray) -> np.ndarray:
    """(L, W) int32 live shortest-path costs from each landmark to every
    worker (`UNREACHABLE` where no route): multi-source Dijkstra where scipy
    imports, an (L, W) min-plus relaxation otherwise."""
    W = mesh.num_workers
    L = len(landmarks)
    if L == 0:
        return np.empty((0, W), np.int32)
    if _HAVE_SCIPY:
        src, dst, wts = _live_graph(mesh, tau_row, up_row)
        g = _csr((wts.astype(np.float64), (src, dst)), shape=(W, W))
        d = _scipy_dijkstra(g, directed=True, indices=np.asarray(landmarks))
        d = d.reshape(L, W)
        return np.where(np.isfinite(d), d, float(UNREACHABLE)).astype(np.int32)
    inf = np.int64(1) << 40
    nbr_c = np.clip(mesh.neighbor_table, 0, W - 1)
    live = _live(mesh, up_row)
    tau = np.asarray(tau_row, np.int64)
    d = np.full((L, W), inf, np.int64)
    d[np.arange(L), np.asarray(landmarks)] = 0
    for _ in range(W):
        nd = d
        for k in range(topo.NUM_DIRECTIONS):
            cand = np.where(live[None, :, k], tau[None, :, k] + d[:, nbr_c[:, k]],
                            inf)
            nd = np.minimum(nd, cand)
        if (nd == d).all():
            break
        d = nd
    return np.minimum(d, UNREACHABLE).astype(np.int32)


class _StructClass:
    """The routing structure of one distinct `link_up` state, reused while
    only τ changes: components and, under the sparse backend, the patches'
    cleanliness, the landmarks and the workers the stretch bound covers."""

    __slots__ = ("comp", "covered", "landmarks", "clean")

    def __init__(self, mesh, up_row, pid, n_patch, base_lm, sparse: bool):
        W = mesh.num_workers
        self.comp = live_components(mesh, up_row)
        self.landmarks = self.clean = self.covered = None
        if not sparse:
            return
        # a dead link with both ends inside one patch makes the patch dirty
        nbr = mesh.neighbor_table
        dead = (nbr != topo.NO_NEIGHBOR) & ~np.asarray(up_row, bool)
        clean = np.ones(n_patch, bool)
        w_idx, d_idx = np.nonzero(dead)
        v_idx = nbr[w_idx, d_idx]
        in_patch = pid[w_idx] == pid[v_idx]
        clean[pid[w_idx[in_patch]]] = False
        self.clean = clean
        # landmarks: the patch centers, plus the lowest worker of each
        # multi-worker component no center lands in (a component's id is
        # its lowest worker); isolated workers need none
        sizes = np.bincount(self.comp, minlength=W)
        multi = np.unique(self.comp[sizes[self.comp] > 1])
        covered = set(self.comp[base_lm].tolist())
        extras = np.asarray(sorted(set(multi.tolist()) - covered), np.int32)
        self.landmarks = np.concatenate([base_lm, extras]).astype(np.int32)
        self.covered = sizes[self.comp] > 1


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch builds link-state tables on the CUDA device by "
            "default and none is available; pass device='cpu'")
    return dev


def build_tables(schedule: LinkStateSchedule, mesh: topo.MeshTopology,
                 routing: str = "dense", patch: tuple[int, int] | None = None,
                 device=None) -> tuple[LinkStateArrays, RoutingBuildStats]:
    """Validate and compile a schedule into `LinkStateArrays` on `device`
    (default: the CUDA device), with its build report. ``routing``:
    "dense" (exact (W, W) tables per distinct outage state), "sparse"
    (landmark vectors, bounded stretch) or "auto" (`resolve_routing`);
    `patch` overrides the sparse patch shape (`topology.patch_dims`)."""
    t_begin = time.perf_counter()
    dev = _resolve_device(device)
    if mesh.num_workers != mesh.rows * mesh.cols:
        raise ValueError(
            "link-state simulation requires a fully populated grid "
            f"({mesh.rows}x{mesh.cols} vs {mesh.num_workers} workers)")
    schedule.validate(mesh)
    routing = resolve_routing(routing, mesh.num_workers)
    sparse = routing == "sparse"
    E = schedule.num_epochs
    W = mesh.num_workers
    R, C = mesh.rows, mesh.cols
    grid = np.arange(R * C).reshape(R, C)
    tau_v = schedule.link_tau[:, grid, SOUTH]                     # (E, R, C)
    tau_h = schedule.link_tau[:, grid, EAST]                      # (E, R, C)
    cum_v = np.concatenate([np.zeros((E, 1, C), np.int32),
                            np.cumsum(tau_v, axis=1, dtype=np.int32)], axis=1)
    cum_h = np.concatenate([np.zeros((E, R, 1), np.int32),
                            np.cumsum(tau_h, axis=2, dtype=np.int32)], axis=2)

    pid = n_patch = base_lm = None
    pr = pc = 0
    if sparse:
        pr, pc = patch if patch is not None else topo.patch_dims(mesh)
        pid, n_patch = topo.patch_ids(mesh, pr, pc)
        base_lm = np.unique(topo.patch_centers(mesh, pr, pc)).astype(np.int32)

    # one cost row per distinct outage state (a dead existing link); all-up
    # epochs keep dimension-order pricing and build nothing
    exists = mesh.neighbor_table != topo.NO_NEIGHBOR
    has_outage = (exists[None] & ~schedule.link_up).any(axis=(1, 2))  # (E,)
    detour_idx = np.full(E, -1, np.int32)
    comp = np.zeros((E, W), np.int32)
    structs: dict[bytes, _StructClass] = {}
    cost_classes: dict[bytes, int] = {}
    mats: list[np.ndarray] = []        # dense: (W, W); sparse: (L_s, W)
    cost_clean: list[np.ndarray] = []  # sparse: patch flags per cost class
    rhos: list[int] = []               # sparse: per-class coverage radius ρ
    struct_hits = cost_hits = 0
    for e in range(E):
        if not has_outage[e]:
            continue
        up_key = schedule.link_up[e].tobytes()
        sc = structs.get(up_key)
        if sc is None:
            sc = structs[up_key] = _StructClass(mesh, schedule.link_up[e], pid,
                                                n_patch, base_lm, sparse)
        else:
            struct_hits += 1
        comp[e] = sc.comp
        cost_key = schedule.link_tau[e].tobytes() + up_key
        k = cost_classes.get(cost_key)
        if k is None:
            k = cost_classes[cost_key] = len(mats)
            if sparse:
                d = landmark_costs(mesh, schedule.link_tau[e],
                                   schedule.link_up[e], sc.landmarks)
                mats.append(d)
                cost_clean.append(sc.clean)
                near = np.where(d < UNREACHABLE, d, np.int64(UNREACHABLE))
                cover = near.min(axis=0, initial=np.int64(UNREACHABLE))
                rhos.append(int(cover[sc.covered].max(initial=0)))
            else:
                mats.append(live_path_costs(mesh, schedule.link_tau[e],
                                            schedule.link_up[e]))
        else:
            cost_hits += 1
        detour_idx[e] = k

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=dev, dtype=dtype)

    detour = lm_cost = patch_clean = patch_id = None
    Lmax = 0
    if mats and not sparse:
        detour = t(np.stack(mats))
    elif mats:
        Lmax = max(m.shape[0] for m in mats)
        lm = np.full((len(mats), Lmax, W), _LM_INF, np.int32)
        for k, m in enumerate(mats):
            finite = m < UNREACHABLE
            if (m[finite] >= _LM_INF).any():
                raise ValueError(
                    "landmark cost exceeds the uint16 storage range — "
                    "link_tau values are implausibly large for this mesh")
            lm[k, :m.shape[0]] = np.where(finite, m, _LM_INF)
        lm_cost = t(lm)
        patch_clean = t(np.stack(cost_clean), torch.bool)
        patch_id = t(pid)
    arrays = LinkStateArrays(
        epoch_starts=t(schedule.epoch_starts),
        link_tau=t(schedule.link_tau),
        link_up=t(schedule.link_up, torch.bool),
        speed=t(schedule.speed),
        cum_v=t(cum_v), cum_h=t(cum_h),
        detour=detour, detour_idx=t(detour_idx), comp=t(comp),
        lm_cost=lm_cost, patch_id=patch_id, patch_clean=patch_clean)
    stats = RoutingBuildStats(
        routing=routing,
        num_epochs=E,
        outage_epochs=int(has_outage.sum()),
        struct_classes=len(structs),
        cost_classes=len(mats),
        struct_dedup_hits=struct_hits,
        cost_dedup_hits=cost_hits,
        table_bytes=table_bytes(arrays),
        dense_equiv_bytes=len(mats) * W * W * 4,
        build_seconds=time.perf_counter() - t_begin,
        num_landmarks=Lmax,
        num_patches=n_patch or 0,
        patch_shape=(pr, pc),
        stretch_add=2 * max(rhos, default=0),
    )
    return arrays, stats


def device_tables(schedule: LinkStateSchedule, mesh: topo.MeshTopology,
                  routing: str = "dense", patch: tuple[int, int] | None = None,
                  device=None) -> LinkStateArrays:
    """`build_tables` without the build report."""
    return build_tables(schedule, mesh, routing=routing, patch=patch,
                        device=device)[0]


def to_device(tbl: LinkStateArrays, device) -> LinkStateArrays:
    """`tbl` with every tensor on `device` (no copy where it is there)."""
    return LinkStateArrays(*(None if x is None else x.to(device) for x in tbl))


# --------------------------------------------------------------------------- #
# Device side: epoch indices are ints, 0-d tensors or per-point columns
# --------------------------------------------------------------------------- #
def epoch_index(epoch_starts: torch.Tensor, t) -> torch.Tensor:
    """Index of the epoch containing tick `t` (int32, `t`'s shape; t >= 0)."""
    t = torch.as_tensor(t, device=epoch_starts.device)
    return ((epoch_starts <= t[..., None]).sum(-1) - 1).to(torch.int32)


def next_change(epoch_starts: torch.Tensor, t, never) -> torch.Tensor:
    """First epoch boundary strictly after `t` (`never` if none is left),
    `t`'s shape."""
    t = torch.as_tensor(t, device=epoch_starts.device)
    return torch.where(epoch_starts > t[..., None], epoch_starts,
                       int(never)).amin(-1).to(torch.int32)


def min_link_tau(tbl: LinkStateArrays, eidx) -> torch.Tensor:
    """Cheapest one-hop latency anywhere in epoch `eidx` (entries of absent
    links included: they only lower the bound)."""
    e = torch.as_tensor(eidx, device=tbl.link_tau.device).long()
    return tbl.link_tau.flatten(1).amin(1)[e]


def _axis_cost(flat, base, lo, hi, stride: int, n: int, torus_full: bool):
    """Path cost along one axis from index lo to hi, read from the flat
    prefix sums `flat` at `base + index·stride` (the flight's epoch and
    lane), the shorter ring arc (by hops, ties to the direct side) on a full
    torus."""
    def at(k):
        return flat[base + (k if stride == 1 else k * stride)]

    direct = at(hi) - at(lo)
    if not torus_full:
        return direct
    ring = flat[base + n * stride]
    span = hi - lo
    return torch.where(n - span < span, ring - direct, direct)


def flight_ticks(tbl: LinkStateArrays, eidx, src, dst, rows: int, cols: int,
                 torus_full: bool) -> torch.Tensor:
    """Ticks of the flights src → dst departing in epoch `eidx` (int32, the
    broadcast shape of `src`, `dst` and `eidx`; a per-point column (G, 1)
    beside (G, W) workers gives each point its own epoch).

    All-up epochs price dimension-order paths (vertical hops in the
    source's column, then horizontal ones in the destination's row) at the
    epoch's `link_tau`. Epochs with a dead link price live detours: the
    dense table, or the sparse landmark triangle tightened to the
    dimension-order price for same-patch pairs of a clean patch. Pairs with
    no live route fall back to the dimension-order price (callers gate
    departures on `same_component`; the fallback prices a severed reply).
    Every table is read by one gather from its flat storage."""
    W = rows * cols
    e = torch.as_tensor(eidx, device=tbl.cum_v.device).long()
    s = src.clamp(0, W - 1).long()
    d = dst.clamp(0, W - 1).long()
    s, d, e = torch.broadcast_tensors(s, d, e)
    rs, cs = s // cols, s % cols
    rd, cd = d // cols, d % cols
    # cum_v (E, rows+1, cols) read down the source's column, cum_h (E, rows,
    # cols+1) along the destination's row
    vert = _axis_cost(tbl.cum_v.reshape(-1), e * ((rows + 1) * cols) + cs,
                      torch.minimum(rs, rd), torch.maximum(rs, rd), cols, rows,
                      torus_full)
    horz = _axis_cost(tbl.cum_h.reshape(-1), (e * rows + rd) * (cols + 1),
                      torch.minimum(cs, cd), torch.maximum(cs, cd), 1, cols,
                      torus_full)
    base = vert + horz
    if not has_outage_tables(tbl):
        return base
    k = tbl.detour_idx[e]
    kc = k.clamp(min=0).long()
    if tbl.detour is not None:
        det = tbl.detour.reshape(-1)[(kc * W + s) * W + d]
        det = torch.where(det < UNREACHABLE, det, base)
        return torch.where(k >= 0, det, base)
    # sparse: min over landmarks of lm[l, s] + lm[l, d], the landmark axis
    # just before the workers'
    L = tbl.lm_cost.shape[1]
    lm = tbl.lm_cost.reshape(-1)
    row = (kc * (L * W)).unsqueeze(-2) + torch.arange(0, L * W, W, device=s.device)[:, None]
    lm_s = lm[row + s.unsqueeze(-2)]
    lm_d = lm[row + d.unsqueeze(-2)]
    lm_s = torch.where(lm_s == _LM_INF, UNREACHABLE, lm_s)
    lm_d = torch.where(lm_d == _LM_INF, UNREACHABLE, lm_d)
    cost = (lm_s + lm_d).amin(-2)
    pid = tbl.patch_id
    ps = pid[s]
    clean = tbl.patch_clean.reshape(-1)[kc * tbl.patch_clean.shape[1] + ps]
    exact = (ps == pid[d]) & clean
    cost = torch.where(exact, torch.minimum(base, cost), cost)
    cost = torch.where(s == d, 0, cost)
    cost = torch.where(cost < UNREACHABLE, cost, base)
    return torch.where(k >= 0, cost, base)


def same_component(tbl: LinkStateArrays, eidx, a, b) -> torch.Tensor:
    """Is there a live route between a and b in epoch `eidx` (bool, the
    broadcast shape; per-point epochs as in `flight_ticks`)?"""
    a = torch.as_tensor(a, device=tbl.comp.device)
    b = torch.as_tensor(b, device=tbl.comp.device)
    if not has_outage_tables(tbl):
        return torch.ones(torch.broadcast_shapes(a.shape, b.shape),
                          dtype=torch.bool, device=tbl.comp.device)
    e = torch.as_tensor(eidx, device=tbl.comp.device).long()
    W = tbl.comp.shape[1]
    comp = tbl.comp.reshape(-1)
    row = e * W
    return comp[row + a.clamp(0, W - 1)] == comp[row + b.clamp(0, W - 1)]
