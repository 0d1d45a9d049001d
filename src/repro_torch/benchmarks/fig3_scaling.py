"""Paper Fig. 3 + Table 2: strong scaling of FIB and UTS under global vs
neighbor-only stealing on an emulated uniform-low-latency mesh, on the port
(the reference's `benchmarks/fig3_scaling.py`, the same workloads, worker
counts, rows and `emit` lines).

"Execution time" is steal rounds (one round = one leaf work unit; spawns
are ~free, steal RTT ⋘ unit — see `scheduler.SchedulerConfig`); averages
over `--runs` seeds. Every (strategy × seed) point of a worker count runs
in one `scheduler.run_sweep` call: on the card one captured CUDA graph.
The rounds are exact, so every row equals the reference's. The paper's
runs give each core minutes of work; these trees give each worker ~10^3–10^4
rounds, so the neighbor-only lag of the initial phase shows at the larger
worker counts (the slack column says how much work each worker had).

    python -m repro_torch.benchmarks.fig3_scaling --small --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..core import scheduler, stealing, tasks, topology
from .common import device_name, emit

# Calibrated workloads: deep spines (divisible subtrees), leaf-dominated.
FIB_QUICK = tasks.FibWorkload(n=44, cutoff=24, max_leaf_cost=32)
UTS_QUICK = tasks.UtsWorkload(b0=4.0, d_max=16, root_seed=19)  # paper params
EXPANSIONS = {"FIB": 8, "UTS": 2}  # UTS node visits are the work itself

QUICK_WORKERS = (25, 49, 100)
FULL_WORKERS = (25, 49, 100, 160, 320, 640)


def run(worker_counts=QUICK_WORKERS, runs: int = 3, small: bool = True,
        device=None):
    results = {}
    strategies = (stealing.Strategy.GLOBAL, stealing.Strategy.NEIGHBOR)
    for wl_name, wl in (("FIB", FIB_QUICK), ("UTS", UTS_QUICK)):
        for workers in worker_counts:
            mesh = topology.MeshTopology.square(workers)
            cfg = scheduler.SchedulerConfig(
                capacity=4096, max_rounds=2_000_000,
                expansions_per_round=EXPANSIONS[wl_name])
            # every (strategy × seed) point in one core call
            pts = [cfg.params._replace(strategy=stealing.strategy_code(st), seed=s)
                   for st in strategies for s in range(runs)]
            all_rs = scheduler.run_sweep(wl, mesh, cfg, pts, device=device)
            per = {}
            for i, strat in enumerate(strategies):
                rs = all_rs[i * runs:(i + 1) * runs]
                for r in rs:
                    assert r.overflow == 0
                if wl_name == "FIB":
                    assert all(r.result == wl.expected_result() for r in rs)
                rounds = [r.rounds for r in rs]
                ps = [r.p_success for r in rs]
                per[strat.value] = (float(np.mean(rounds)), float(np.mean(ps)))
            tg, pg = per["global"]
            tn, pn = per["neighbor"]
            rel = (tn - tg) / tg
            results[(wl_name, workers)] = dict(
                global_rounds=tg, neighbor_rounds=tn, rel=rel,
                p_global=pg, p_neighbor=pn, slack=tg)
            emit(f"fig3/{wl_name}/W={workers}", 0.0,
                 f"global={tg:.0f};neighbor={tn:.0f};rel={rel*100:+.2f}%;"
                 f"Pg={pg:.3f};Pn={pn:.3f};slack_rounds={tg:.0f}")
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--workers", type=int, nargs="+", default=None)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()
    workers = tuple(args.workers) if args.workers else \
        (QUICK_WORKERS if args.small else FULL_WORKERS)
    print("# Fig 3 / Table 2 — strong scaling, uniform low latency")
    t0 = time.perf_counter()
    run(workers, args.runs, args.small, device=args.device)
    print(f"# wall {time.perf_counter() - t0:.3f} s on {device_name(args.device)}")


if __name__ == "__main__":
    main()
