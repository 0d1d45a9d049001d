"""Analytical model of steal-attempt latency (paper §3.3).

Assumptions (paper):
  (i)   √N×√N 2D mesh, four neighbors per node (boundary shrinks with N);
  (ii)  fixed single-hop ISL latency τ, shortest paths, no congestion;
  (iii) independent attempts; each attempt costs the thief↔victim round trip.

Derived quantities:
  * neighbor-only round trip:           RT_n = 2τ                      (constant)
  * global round trip (expected):       RT_g = (4/3)·√N·τ              (mean hops (2/3)√N)
  * expected time-to-task:              E[T_s] = RT_s / P_s             (Eq. 1)
  * neighbor-only wins iff:             P_g / P_n < (2/3)·√N            (Ineq. 2)
  * initial-phase duration (neighbor):  ≈ 4·√N·τ                        (2√N rounds × 2τ)

All functions accept scalars or numpy arrays of N. This is the port's own
copy of the reference's `latency` (numpy only), held equal to it by the
port's tests; the port's crossover benchmark reads the analytic bounds here.
"""

from __future__ import annotations

import dataclasses

import numpy as np

DEFAULT_TAU_S = 5e-3  # paper Table 1: τ = 5 ms


def neighbor_round_trip(tau: float = DEFAULT_TAU_S):
    """Round-trip time of one neighbor-only steal attempt: 2τ."""
    return 2.0 * tau


def global_mean_hops(n):
    """Expected hops between two uniform-random nodes on a √N×√N mesh: (2/3)√N."""
    return (2.0 / 3.0) * np.sqrt(np.asarray(n, dtype=np.float64))


def global_round_trip(n, tau: float = DEFAULT_TAU_S):
    """Expected round trip of one global steal attempt: (4/3)√N·τ."""
    return 2.0 * global_mean_hops(n) * tau


def threshold(n):
    """Ineq. 2 threshold (2/3)√N: the factor by which global stealing must find
    work more often per attempt to offset its latency disadvantage."""
    return (2.0 / 3.0) * np.sqrt(np.asarray(n, dtype=np.float64))


def expected_time_to_task(round_trip, p_success):
    """Eq. 1: E[T] = per-attempt cost / success probability.

    A strategy that never succeeds has infinite expected time-to-task:
    p_success == 0 returns exact inf (elementwise), never a NaN or an
    arbitrary 1e-12-scaled blow-up value."""
    p = np.asarray(p_success, dtype=np.float64)
    rt = np.asarray(round_trip, dtype=np.float64)
    rt, p = np.broadcast_arrays(rt, p)
    out = np.full(p.shape, np.inf)
    np.divide(rt, p, out=out, where=p > 0)
    return out


def neighbor_expected_time(p_neighbor, tau: float = DEFAULT_TAU_S):
    return expected_time_to_task(neighbor_round_trip(tau), p_neighbor)


def global_expected_time(n, p_global, tau: float = DEFAULT_TAU_S):
    return expected_time_to_task(global_round_trip(n, tau), p_global)


def neighbor_wins(n, p_global, p_neighbor) -> np.ndarray:
    """Ineq. 2: neighbor-only faster ⇔ P_g/P_n < (2/3)√N.

    p_neighbor == 0 means neighbor-only never finds work (E[T_n] = inf):
    it cannot win, regardless of p_global — the ratio is +inf, below no
    finite threshold (division guarded, no NaN warnings)."""
    pg = np.asarray(p_global, dtype=np.float64)
    pn = np.asarray(p_neighbor, dtype=np.float64)
    pg, pn = np.broadcast_arrays(pg, pn)
    ratio = np.full(pn.shape, np.inf)
    np.divide(pg, pn, out=ratio, where=pn > 0)
    return ratio < threshold(n)


def initial_phase_duration(n, tau: float = DEFAULT_TAU_S):
    """Paper §3.3 Initial Phase: ≈ 2√N rounds × 2τ each = 4√N·τ."""
    return 4.0 * np.sqrt(np.asarray(n, dtype=np.float64)) * tau


def speedup_per_attempt(n):
    """RT_g / RT_n = (2/3)√N — e.g. ≈13.3× for N=400 (paper §4.2 says ~13×)."""
    return global_round_trip(n, 1.0) / neighbor_round_trip(1.0)


@dataclasses.dataclass(frozen=True)
class Table1Row:
    nodes: int
    threshold: float
    neighbor_rt_ms: float
    global_rt_ms: float


def table1(sizes=(25, 100, 400, 1600), tau: float = DEFAULT_TAU_S) -> list[Table1Row]:
    """Reproduce paper Table 1 exactly."""
    rows = []
    for n in sizes:
        rows.append(
            Table1Row(
                nodes=n,
                threshold=float(threshold(n)),
                neighbor_rt_ms=float(neighbor_round_trip(tau) * 1e3),
                global_rt_ms=float(global_round_trip(n, tau) * 1e3),
            )
        )
    return rows
