"""Beyond the paper: the high-latency-mesh evaluation it defers to future
work (§6) — neighbor-only vs global stealing in the tick simulator with
real per-hop ISL latency — on the port (the reference's
`benchmarks/mesh_latency.py`, the same workloads, rows and `emit` lines).

For each constellation size N and hop latency τ (in work-unit ticks), runs
FIB and UTS and reports makespan ticks, P_success ratio against the Ineq. 2
threshold, and bytes×hops congestion; ADAPTIVE (radius escalation, §6's
other suggestion) rides along. Each size's whole (τ × strategy × seed)
factorial is one `simulate_sweep` (`sweep.run_grid`).

    python -m repro_torch.benchmarks.mesh_latency --small --sizes 16 --taus 2 --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..core import latency, simulator, stealing, tasks, topology
from .common import device_name, emit
from .sweep import run_grid

STRATS = {
    "neighbor": stealing.Strategy.NEIGHBOR,
    "global": stealing.Strategy.GLOBAL,
    "adaptive": stealing.Strategy.ADAPTIVE,
}


def _mean_result(rs):
    """Average the scalar stats of per-seed SimResults into one view."""
    first = rs[0]
    if len(rs) == 1:
        return first

    def mean(f):
        return float(np.mean([getattr(r, f) for r in rs]))
    return first._replace(
        ticks=int(mean("ticks")), attempts=int(mean("attempts")),
        successes=int(mean("successes")), p_success=mean("p_success"),
        busy_ticks=int(mean("busy_ticks")),
        steal_wait_ticks=int(mean("steal_wait_ticks")),
        bytes_hops=mean("bytes_hops"), utilization=mean("utilization"))


def run(sizes=(25, 64, 100, 196), hop_ticks=(2, 5, 10), small: bool = False,
        strategies=("neighbor", "global", "adaptive"), runs: int = 1,
        device=None):
    fib = tasks.FibWorkload(n=30 if not small else 26, cutoff=12,
                            max_leaf_cost=16)
    uts = tasks.UtsWorkload(b0=3.5 if not small else 3.0,
                            d_max=10 if not small else 8, root_seed=19)
    results = {}
    codes = {s: stealing.strategy_code(STRATS[s]) for s in strategies}
    for wl_name, wl in (("FIB", fib), ("UTS", uts)):
        for n in sizes:
            mesh = topology.MeshTopology.square(n)
            cfg = simulator.SimConfig(capacity=2048, max_ticks=5_000_000)
            # the whole (τ × strategy × seed) factorial of this size in one
            # core call
            grid = run_grid(wl, mesh, cfg, dict(
                hop_ticks=list(hop_ticks),
                strategy=[codes[s] for s in strategies],
                seed=range(runs)), device=device)
            for tau in hop_ticks:
                per = {}
                for sname in strategies:
                    rs = [g["result"] for g in grid
                          if g["hop_ticks"] == tau
                          and g["strategy"] == codes[sname]]
                    assert all(r.overflow == 0 for r in rs)
                    per[sname] = _mean_result(rs)
                rn, rg = per["neighbor"], per["global"]
                ratio = (rg.p_success / max(rn.p_success, 1e-9))
                th = float(latency.threshold(n))
                speedup = rg.ticks / rn.ticks
                results[(wl_name, n, tau)] = per
                extra = ""
                if "adaptive" in per:
                    extra = f";adaptive={per['adaptive'].ticks}"
                emit(f"mesh_latency/{wl_name}/N={n}/tau={tau}", 0.0,
                     f"neighbor={rn.ticks};global={rg.ticks};"
                     f"speedup={speedup:.2f}x;Pg/Pn={ratio:.2f};"
                     f"threshold={th:.1f};"
                     f"byteshops_ratio={rg.bytes_hops/max(rn.bytes_hops,1):.2f}"
                     f"{extra}")
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--sizes", type=int, nargs="+", default=[25, 64, 100, 196])
    ap.add_argument("--taus", type=int, nargs="+", default=[2, 5, 10])
    ap.add_argument("--runs", type=int, default=1,
                    help="seeds per config (one core call per size)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()
    print("# mesh-latency study (paper future work §6)")
    t0 = time.perf_counter()
    run(tuple(args.sizes), tuple(args.taus), args.small, runs=args.runs,
        device=args.device)
    print(f"# wall {time.perf_counter() - t0:.3f} s on {device_name(args.device)}")


if __name__ == "__main__":
    main()
