"""The load–latency curve on the port: open-loop traffic, tail-latency
SLOs, and each stealing strategy's saturation knee.

A makespan says nothing about serving real traffic; a user of an open
constellation asks how much offered load a strategy carries before its
tail latency blows up. `run_curve` drives the simulator's arrival stream
(`core/arrivals.py`) across an offered-load axis and reports the sojourn
percentiles (p50/p90/p99/p99.9, from the flight recorder's EV_SOJOURN
events) per (strategy, load) cell, and each strategy's knee: the highest
load whose median-across-seeds p99 stays within `--knee-factor`× of its
light-load p99.

The whole (strategy × load × τ × seed) grid is one `simulate_sweep` call
on `device` (default: the CUDA device): the offered load is the per-point
`SimParams.arrival_gap_q8`, so the grid is one `_sim_core` call, on the
card one captured CUDA graph (`--assert-single-compile` checks it). Every
headline number is a tick count. The document (strict JSON, no NaN or
Infinity) is written only where `--out` says, the figure where `--plot`
says.

    python -m repro_torch.benchmarks.load_latency --quick --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..core import arrivals, jsonio, simulator, stealing, tasks, topology, tracing
from .common import device_name, emit

DEFAULT_LOADS = (0.05, 0.1, 0.2, 0.3, 0.45, 0.6, 0.8, 1.0, 1.25)
QUICK_LOADS = (0.1, 0.4, 0.8)
PCTS = ("p50", "p90", "p99", "p999")


def run_curve(side: int = 6, taus=(3,), loads=DEFAULT_LOADS,
              strategies=("neighbor", "global", "adaptive"), runs: int = 3,
              task_cost: int = 64, num_stations: int = 0,
              zipf_s: float = 0.0, horizon: int = 20_000,
              ring_capacity: int = 1 << 17,
              knee_factor: float = 3.0,
              assert_single_compile: bool = False, device=None) -> dict:
    """Sweep offered load per strategy and locate the saturation knee.

    Offered load is in expected work units per worker-tick: load =
    cost/(gap·W), so at load 1.0 arrivals alone demand every worker's full
    capacity and the system saturates just above it.
    """
    W = side * side
    mesh = topology.MeshTopology.square(W)
    wl = tasks.FibWorkload(n=8, cutoff=4, max_leaf_cost=4)  # a tiny seed root
    acfg = arrivals.ArrivalConfig(task_cost=task_cost,
                                  num_stations=num_stations, zipf_s=zipf_s)
    codes = [stealing.strategy_code(s) for s in strategies]
    names = {c: stealing.CODE_STRATEGIES[c].value for c in codes}
    # the task rate (tasks a tick) that delivers `load` work units a worker-tick
    gaps = {ld: arrivals.gap_q8_for_load(ld * W / task_cost) for ld in loads}
    trc = tracing.TraceConfig(ring_capacity=ring_capacity, bins=128,
                              bin_ticks=max(horizon // 128, 1))
    cfg = simulator.SimConfig(max_ticks=horizon, trace=trc,
                              capacity=4096, arrival_batch=1)
    scfg, base = cfg.split()
    pts, coords = [], []
    for c in codes:
        for ld in loads:
            for tau in taus:
                for s in range(runs):
                    pts.append(base._replace(strategy=c, hop_ticks=tau, seed=s,
                                             arrival_gap_q8=gaps[ld]))
                    coords.append((c, ld, tau, s))
    before = simulator.core_count()
    results = simulator.simulate_sweep(wl, mesh, scfg, pts, arrivals=acfg,
                                       device=device)
    traces = simulator.core_count() - before
    if assert_single_compile and traces > 1:
        raise AssertionError(
            f"expected <=1 _sim_core call for the {len(pts)}-point "
            f"load grid, got {traces}")
    doc = {
        "schema": "loadlat/v1",
        "W": W, "taus": [int(t) for t in taus],
        "strategies": [names[c] for c in codes],
        "loads": [float(ld) for ld in loads], "runs": int(runs),
        "task_cost": int(task_cost), "horizon": int(horizon),
        "num_stations": int(num_stations), "zipf_s": float(zipf_s),
        "knee_factor": float(knee_factor), "traces": int(traces),
        "points": [], "knees": [],
    }
    cells = {}
    for (c, ld, tau, s), r in zip(coords, results):
        if r.trace is not None and r.trace.dropped:
            raise AssertionError(
                f"trace ring dropped {r.trace.dropped} events at "
                f"(strategy={names[c]}, load={ld}, tau={tau}, seed={s}); "
                f"raise --ring-capacity for exact percentiles")
        soj = r.sojourn or {}
        point = dict(
            strategy=names[c], load=float(ld), tau=int(tau), seed=int(s),
            gap_q8=int(gaps[ld]), ticks=int(r.ticks),
            injected=int(r.arrivals_injected),
            dropped=int(r.arrivals_dropped), done=int(r.requests_done),
            utilization=float(r.utilization),
            sojourn={k: soj.get(k) for k in
                     ("count", "mean", "max") + PCTS} if soj else None)
        doc["points"].append(point)
        cells.setdefault((c, ld, tau), []).append(point)
    for c in codes:
        for tau in taus:
            base_p99 = None
            knee = None
            for ld in loads:
                sel = cells.get((c, ld, tau), [])
                p99s = [p["sojourn"]["p99"] for p in sel
                        if p["sojourn"] and p["sojourn"]["p99"] is not None]
                if not p99s:
                    continue
                med = float(np.median(p99s))
                if base_p99 is None:
                    base_p99 = med
                if med <= knee_factor * base_p99:
                    knee = float(ld)
                emit(f"loadlat/{names[c]}/tau={tau}/load={ld}", 0.0,
                     f"p99={med:.0f};done={sum(p['done'] for p in sel)};"
                     f"drop={sum(p['dropped'] for p in sel)}")
            doc["knees"].append(dict(
                strategy=names[c], tau=int(tau), knee_load=knee,
                baseline_p99=base_p99))
            emit(f"loadlat/{names[c]}/tau={tau}/knee", 0.0,
                 f"knee_load={knee};baseline_p99={base_p99}")
    return doc


def plot_curve(doc: dict, path: str) -> bool:
    """Median p99 sojourn against offered load, one line per (strategy, τ),
    the knee marked. Returns False when matplotlib is unavailable."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    fig, ax = plt.subplots(figsize=(6.5, 4.2))
    for knee in doc["knees"]:
        sname, tau = knee["strategy"], knee["tau"]
        pts = {}
        for p in doc["points"]:
            if (p["strategy"] == sname and p["tau"] == tau
                    and p["sojourn"] and p["sojourn"]["p99"] is not None):
                pts.setdefault(p["load"], []).append(p["sojourn"]["p99"])
        if not pts:
            continue
        loads = sorted(pts)
        med = [float(np.median(pts[ld])) for ld in loads]
        line, = ax.plot(loads, med, "o-", label=f"{sname} τ={tau}")
        if knee["knee_load"] is not None:
            ax.axvline(knee["knee_load"], color=line.get_color(),
                       ls=":", alpha=0.5)
    ax.set_xlabel("offered load (work units / worker-tick)")
    ax.set_ylabel("p99 sojourn (ticks, median over seeds)")
    ax.set_yscale("log")
    ax.set_title(f"Load–latency, W={doc['W']} (dotted: saturation knee)")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return True


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--side", type=int, default=6,
                    help="mesh side (W = side^2)")
    ap.add_argument("--taus", type=int, nargs="+", default=[3])
    ap.add_argument("--strategies", nargs="+",
                    default=["neighbor", "global", "adaptive"])
    ap.add_argument("--loads", type=float, nargs="+", default=None)
    ap.add_argument("--runs", type=int, default=3, help="seeds per point")
    ap.add_argument("--task-cost", type=int, default=64)
    ap.add_argument("--num-stations", type=int, default=0,
                    help="ground stations (0 = every worker)")
    ap.add_argument("--zipf-s", type=float, default=0.0,
                    help="station hot-spot skew (0 = uniform)")
    ap.add_argument("--horizon", type=int, default=20_000)
    ap.add_argument("--ring-capacity", type=int, default=1 << 17)
    ap.add_argument("--knee-factor", type=float, default=3.0)
    ap.add_argument("--quick", action="store_true",
                    help="small mesh, 2 strategies x 3 loads (CI smoke)")
    ap.add_argument("--out", default=None, help="write the JSON document here")
    ap.add_argument("--plot", default=None, help="write the figure here")
    ap.add_argument("--assert-single-compile", action="store_true",
                    help="fail unless the grid is one _sim_core call")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()
    if args.quick:
        side = 4
        loads = tuple(args.loads) if args.loads else QUICK_LOADS
        strategies = (args.strategies if args.strategies != [
            "neighbor", "global", "adaptive"] else ["neighbor", "global"])
        horizon = min(args.horizon, 4_000)
        runs = min(args.runs, 2)
    else:
        side, loads = args.side, tuple(args.loads or DEFAULT_LOADS)
        strategies, horizon, runs = args.strategies, args.horizon, args.runs
    print(f"# load-latency sweep (one core, "
          f"{len(strategies)}x{len(loads)}x{len(args.taus)}x{runs} grid)")
    t0 = time.perf_counter()
    doc = run_curve(side=side, taus=tuple(args.taus), loads=loads,
                    strategies=tuple(strategies), runs=runs,
                    task_cost=args.task_cost,
                    num_stations=args.num_stations, zipf_s=args.zipf_s,
                    horizon=horizon, ring_capacity=args.ring_capacity,
                    knee_factor=args.knee_factor,
                    assert_single_compile=args.assert_single_compile,
                    device=args.device)
    print(f"# wall {time.perf_counter() - t0:.3f} s on {device_name(args.device)}")
    if args.out:
        jsonio.write(args.out, doc, indent=2)
        print(f"# wrote {args.out}")
    if args.plot:
        if plot_curve(doc, args.plot):
            print(f"# wrote {args.plot}")
        else:
            print("# matplotlib unavailable; plot skipped")


if __name__ == "__main__":
    main()
