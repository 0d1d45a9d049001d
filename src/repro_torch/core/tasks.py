"""Task-tree workloads of the simulator (paper §4.1): FIB and UTS.

Task records are `[kind, a, b, c]` int32:
    FIB   : [1, n,      0,     0]
    UTS   : [2, depth,  seed,  0]
    CHUNK : [3, depth,  seed,  start*256 + count]   (continuation of a UTS expand)
    REQ   : [4, cost,   inject_tick, task_id]       (open-loop user request)

FIB uses the leaf-sum formulation: fib(n) is the sum of fib(k) over the
leaves (k <= cutoff) of the recursion tree; a leaf keeps its worker busy for
a cost proportional to its naive subtree size. UTS is the geometric variant
with linear branching decay b(d) = b0·(1 − d/d_max); the child count is drawn
from a splittable uint32 hash of the node seed and children are emitted in
chunks of EXPAND_K − 1 per expansion.

`expand` is a pure function of a (W, 4) batch of records; uint32 hashing is
carried in int64 masked to 32 bits.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from .f32math import log_f32

KIND_NONE = 0
KIND_FIB = 1
KIND_UTS = 2
KIND_CHUNK = 3
KIND_REQ = 4

EXPAND_K = 8          # staging slots per expansion (children + continuation)
CHILD_CAP = 64        # max children of a UTS node (geometric tail cut)
RESULT_MOD = 2**31 - 1  # accumulators are checksums mod a Mersenne prime

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2**32 for uint32 values held in int64, without int64
    overflow: the constant is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash2(x, y):
    """Mix two uint32 streams into one uint32 (lowbias32-style). Accepts
    int tensors (any signed width, reinterpreted as uint32) or Python ints;
    returns int64 values in [0, 2**32)."""
    if isinstance(x, torch.Tensor):
        x = x.to(torch.int64)
    x = x & _M32
    y = (y.to(torch.int64) if isinstance(y, torch.Tensor) else y) & _M32
    h = (_mul32(x, 0x9E3779B9) + _mul32(y, 0x85EBCA6B) + 0x27220A95) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def child_seed(seed, index):
    """Seed of the `index`-th child of a node with `seed` (non-negative int32)."""
    h = _hash2(seed, index) >> 1
    return h.to(torch.int32) if isinstance(h, torch.Tensor) else int(h)


@lru_cache(maxsize=None)
def fib_mod_table(n_max: int = 94) -> np.ndarray:
    t = np.zeros(n_max + 1, dtype=np.int64)
    t[1] = 1
    for i in range(2, n_max + 1):
        t[i] = (t[i - 1] + t[i - 2]) % RESULT_MOD
    return t.astype(np.int32)


@lru_cache(maxsize=None)
def fib_seq_nodes(n_max: int = 94) -> np.ndarray:
    """Nodes in the naive fib recursion tree: s(n) = 1 + s(n-1) + s(n-2)."""
    t = np.ones(n_max + 1, dtype=np.float64)
    for i in range(2, n_max + 1):
        t[i] = 1.0 + t[i - 1] + t[i - 2]
    return t


def _tensor_tables(fib_cost, cutoff: int, b0: float, d_max: int, device):
    return {
        "fib_mod": torch.as_tensor(fib_mod_table(), device=device),
        "fib_cost": torch.as_tensor(fib_cost, dtype=torch.int32, device=device),
        "fib_cutoff": int(cutoff),
        "uts_b0": float(np.float32(b0)),
        "uts_dmax": int(d_max),
    }


@dataclasses.dataclass(frozen=True)
class FibWorkload:
    """FIB(n) with sequential cutoff; leaf cost ∝ naive subtree size, scaled
    into `max_leaf_cost` work units."""

    n: int = 34
    cutoff: int = 18
    max_leaf_cost: int = 64

    def __post_init__(self):
        if not (2 <= self.cutoff <= self.n <= 94):
            raise ValueError("require 2 <= cutoff <= n <= 94")

    def root_task(self) -> np.ndarray:
        return np.array([KIND_FIB, self.n, 0, 0], dtype=np.int32)

    def cost_table(self) -> np.ndarray:
        costs = fib_seq_nodes()[: self.cutoff + 1]
        scale = self.max_leaf_cost / max(costs.max(), 1.0)
        cost_tab = np.maximum(1, np.round(costs * scale)).astype(np.int32)
        cost_full = np.zeros(95, dtype=np.int32)
        cost_full[: self.cutoff + 1] = cost_tab
        return cost_full

    def tables(self, device="cpu"):
        return _tensor_tables(self.cost_table(), self.cutoff, 0.0, 0, device)

    def expected_result(self) -> int:
        return int(fib_mod_table()[self.n])

    def expected_nodes(self) -> int:
        @lru_cache(maxsize=None)
        def nodes(n):
            return 1 if n <= self.cutoff else 1 + nodes(n - 1) + nodes(n - 2)
        return nodes(self.n)

    def expected_work_units(self) -> int:
        cost = fib_seq_nodes()
        scale = self.max_leaf_cost / max(cost[: self.cutoff + 1].max(), 1.0)
        cost_tab = np.maximum(1, np.round(cost * scale)).astype(np.int64)

        @lru_cache(maxsize=None)
        def work(n):
            if n <= self.cutoff:
                return int(cost_tab[n])
            return 1 + work(n - 1) + work(n - 2)
        return work(self.n)


@dataclasses.dataclass(frozen=True)
class UtsWorkload:
    """UTS geometric tree, linear branching decay b(d) = b0·(1 − d/d_max).

    The child count of a node at depth d with hash-uniform u ∈ (0,1] is
    floor(log u / log q_d) with q_d = b(d)/(1 + b(d)), capped at CHILD_CAP.
    """

    b0: float = 4.0
    d_max: int = 10
    root_seed: int = 19

    def root_task(self) -> np.ndarray:
        return np.array([KIND_UTS, 0, self.root_seed, 0], dtype=np.int32)

    def tables(self, device="cpu"):
        return _tensor_tables(np.ones(95, np.int32), 0, self.b0, self.d_max,
                              device)

    def count_tree(self, max_nodes: int = 5_000_000) -> int:
        """Exact node count by vectorized BFS (test/benchmark oracle)."""
        depths = torch.zeros(1, dtype=torch.int32)
        seeds = torch.tensor([self.root_seed], dtype=torch.int32)
        n = 0
        while seeds.numel():
            n += seeds.numel()
            if n > max_nodes:
                raise RuntimeError("tree larger than max_nodes")
            ms = _uts_child_count(depths, seeds, float(np.float32(self.b0)),
                                  self.d_max).long()
            total = int(ms.sum())
            if total == 0:
                break
            parent = torch.repeat_interleave(torch.arange(seeds.numel()), ms)
            starts = torch.repeat_interleave(torch.cumsum(ms, 0) - ms, ms)
            child_ix = torch.arange(total) - starts
            seeds = child_seed(seeds[parent], child_ix)
            depths = depths[parent] + 1
        return n


def _uts_child_count(depth: torch.Tensor, seed: torch.Tensor, b0: float,
                     d_max: int) -> torch.Tensor:
    """Vectorized geometric child count with linear decay (float32 math, as
    the reference computes it, its `log` included)."""
    dev = seed.device

    def f32(v):  # a float32 constant made on the device (no host copy)
        return torch.full((), v, dtype=torch.float32, device=dev)

    h = _hash2(seed, 0xFFFF)
    u = (h.to(torch.float32) + 1.0) * f32(2.0**-32)
    frac = 1.0 - depth.to(torch.float32) / f32(max(float(d_max), 1.0))
    b_d = f32(b0) * frac
    q = b_d / (1.0 + b_d)
    safe_q = torch.minimum(torch.maximum(q, f32(1e-9)), f32(1.0 - 1e-9))
    tiny = f32(1e-38)
    # the reference's float32 log, bit for bit (`torch.log` rounds some
    # results an ulp apart, and a ratio on a floor boundary would flip)
    ratio = torch.floor(log_f32(torch.maximum(u, tiny)) / log_f32(safe_q))
    # clamp in float before the cast (the cast of ±inf is undefined in C++);
    # the int clip below gives the reference's values either way
    m = ratio.clamp(-1.0, CHILD_CAP + 1.0).to(torch.int32).clamp(0, CHILD_CAP)
    return torch.where((depth >= d_max) | (b_d <= 0.0), 0, m)


def expand(task: torch.Tensor, active: torch.Tensor, tables) -> dict:
    """Expand one task per worker.

    Args:
      task: (W, 4) int32 records.
      active: (W,) bool — workers actually expanding this step.
      tables: workload tables from `*Workload.tables(device)`.

    Returns dict with children (W, EXPAND_K, 4), n_children, value, cost and
    nodes (all (W,) int32), as the reference's `tasks.expand`.
    """
    dev = task.device
    i32 = torch.int32
    kind = task[:, 0]
    a, b, c = task[:, 1], task[:, 2], task[:, 3]
    W = task.shape[0]

    # ---------------- FIB ------------------------------------------------- #
    is_fib = active & (kind == KIND_FIB)
    n = a.clamp(0, 94)
    fib_leaf = n <= tables["fib_cutoff"]
    zero = torch.zeros_like(n)
    fib_children = torch.zeros((W, EXPAND_K, 4), dtype=i32, device=dev)
    fib_children[:, 0] = torch.stack([zero + KIND_FIB, n - 1, zero, zero], 1)
    fib_children[:, 1] = torch.stack([zero + KIND_FIB, n - 2, zero, zero], 1)
    nl = n.long()
    fib_n_children = torch.where(fib_leaf, 0, 2)
    fib_value = torch.where(fib_leaf, tables["fib_mod"][nl], 0)
    fib_cost = torch.where(fib_leaf, tables["fib_cost"][nl], 1)

    # ---------------- UTS node / chunk continuation ----------------------- #
    is_uts = active & (kind == KIND_UTS)
    if tables["uts_b0"] == 0.0:
        # b(d) = 0 at every depth: no UTS node has children (a FIB run's
        # tables), and the float32 logs need not run
        m = torch.zeros_like(a)
    else:
        m = _uts_child_count(a, b, tables["uts_b0"], tables["uts_dmax"])
    is_chunk = active & (kind == KIND_CHUNK)
    ch_start = torch.div(c, 256, rounding_mode="floor")
    ch_count = torch.remainder(c, 256)
    # a UTS node is a chunk with start=0, count=m
    start = torch.where(is_chunk, ch_start, 0)
    count = torch.where(is_chunk, ch_count, m)

    emit = count.clamp(max=EXPAND_K - 1)
    ranks = torch.arange(EXPAND_K, dtype=i32, device=dev)[None, :]
    seeds = child_seed(b[:, None], start[:, None] + ranks)       # (W, K)
    zk = torch.zeros((W, EXPAND_K), dtype=i32, device=dev)
    uts_children = torch.stack([zk + KIND_UTS, (a + 1)[:, None] + zk, seeds, zk], 2)
    uts_children[:, EXPAND_K - 1] = 0      # only K-1 children per expansion
    rem = count - emit
    cont = torch.stack([zero + KIND_CHUNK, a, b, (start + emit) * 256 + rem], 1)
    has_cont = rem > 0
    # the continuation goes right after the emitted children
    at_cont = (ranks == emit[:, None]) & has_cont[:, None]
    uts_children = torch.where(at_cont[:, :, None], cont[:, None, :], uts_children)
    uts_n_children = emit + has_cont.to(i32)

    # ---------------- REQ leaf (open-loop arrival) ------------------------- #
    is_req = active & (kind == KIND_REQ)

    # ---------------- combine --------------------------------------------- #
    children = torch.where(is_fib[:, None, None], fib_children, uts_children)
    n_children = torch.where(is_fib, fib_n_children,
                             torch.where(is_uts | is_chunk, uts_n_children, 0))
    value = torch.where(is_fib, fib_value,
                        torch.where(is_uts, 1, torch.where(is_req, c, 0)))
    cost = torch.where(is_fib, fib_cost,
                       torch.where(is_uts | is_chunk, 1,
                                   torch.where(is_req, a.clamp(min=1), 0)))
    nodes = (is_fib | is_uts | is_req).to(i32)
    return {"children": children,
            "n_children": torch.where(active, n_children, 0).to(i32),
            "value": torch.where(active, value, 0).to(i32),
            "cost": torch.where(active, cost, 0).to(i32),
            "nodes": torch.where(active, nodes, 0)}
