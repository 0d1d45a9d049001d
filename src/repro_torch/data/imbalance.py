"""Workload-imbalance generators for balancer benchmarks/tests.

Mirrors the paper's two regimes: *balanced* (FIB-like — near-uniform costs)
and *irregular* (UTS-like — heavy-tailed costs concentrated on few shards).

The port's own copy of `repro.data.imbalance` (pure numpy, line for line), so the
port imports nothing of the reference package.
"""

from __future__ import annotations

import numpy as np


def balanced_costs(n_shards: int, slots: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(90, 110, size=(n_shards, slots)).astype(np.int32)


def irregular_costs(n_shards: int, slots: int, seed: int = 0,
                    alpha: float = 1.2, cap: int = 400) -> np.ndarray:
    """Pareto-tailed costs; a few shards carry most of the work.

    Costs are capped so no single *atomic* item dominates a whole shard's
    load — an uncappable single task is unbalanceable by any stealer (the
    paper's tasks are fine-grained by construction)."""
    rng = np.random.default_rng(seed)
    base = rng.pareto(alpha, size=(n_shards, slots)) * 50 + 1
    base = np.minimum(base, cap)
    hot = rng.choice(n_shards, max(n_shards // 8, 1), replace=False)
    base[hot] *= 8.0
    return np.minimum(base, 8 * cap).astype(np.int32)


def root_loaded(n_shards: int, slots: int, total: int = 10_000) -> np.ndarray:
    """All work starts on shard 0 — the paper's initial-phase shape."""
    c = np.zeros((n_shards, slots), np.int32)
    per = max(total // slots, 1)
    c[0, :] = per
    return c


def imbalance_ratio(costs: np.ndarray, valid: np.ndarray | None = None) -> float:
    loads = (costs if valid is None else costs * valid).sum(axis=1)
    return float(loads.max() / max(loads.mean(), 1e-9))
