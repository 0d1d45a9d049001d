"""One core, whole grid: the factorial sweep engine and the paper's
crossover curve (§4, Ineq. 2), on the port.

`param_grid` / `run_grid` stack `SimParams` axes (strategy × τ × seed × …)
into a single `simulator.simulate_sweep` call: the whole factorial grid
runs through ONE `_sim_core` call per constellation size, on the card one
captured CUDA graph whose every replay advances every point. `crossover`
runs the headline experiment on top — NEIGHBOR/GLOBAL makespan ratio vs W
with the analytic `latency.py` bound as overlay — and writes one
`BENCH_crossover_torch.json` (and the figure), with, per strategy, the
measured per-attempt RTT distribution from the flight recorder
(`tracing.attempt_latency_hist`, one traced grid at the largest N and the
middle τ) against the §3.3 analytic round trip.

Every headline number is a seed-matched ratio or a tick count
(deterministic), never a wall-clock time; seeds are summarised as median +
IQR.

    python -m repro_torch.benchmarks.sweep --quick --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import time

import numpy as np
import torch

from ..core import jsonio, latency, simulator, stealing, tasks, topology, tracing
from .common import emit

DEFAULT_SIZES = (16, 25, 36, 64, 100)
QUICK_SIZES = (9, 16, 25)


# --------------------------------------------------------------------------
# Factorial grid engine
# --------------------------------------------------------------------------

def param_grid(base: simulator.SimParams | None = None, **axes):
    """Factorial product of `SimParams` axes.

    `axes` maps SimParams field names to value sequences; `strategy`
    values may be `Strategy` enums, their name strings, or raw codes.
    Returns `[(coords, SimParams), ...]` in row-major order of the axes
    as given (itertools.product semantics), `coords` being the axis-value
    dict of that point (strategy normalised to its code).
    """
    base = base if base is not None else simulator.SimParams()
    names = list(axes)
    vals = []
    for name in names:
        vs = list(axes[name])
        if name == "strategy":
            vs = [stealing.strategy_code(v) for v in vs]
        vals.append(vs)
    out = []
    for combo in itertools.product(*vals):
        coords = dict(zip(names, combo))
        out.append((coords, base._replace(**coords)))
    return out


def run_grid(workload, mesh, cfg, axes: dict, base=None, **sweep_kw):
    """Run a factorial `SimParams` grid in ONE `simulate_sweep` call.

    Returns one dict per point, `{**coords, "params": p, "result": r}`,
    in grid order. `cfg` supplies the static half; `base` (default:
    `cfg.params` when `cfg` is a SimConfig) supplies off-axis values.
    `sweep_kw` goes to `simulate_sweep` (`device=` among it).
    """
    if base is None:
        base = (cfg.params if isinstance(cfg, simulator.SimConfig)
                else simulator.SimParams())
    pts = param_grid(base, **axes)
    results = simulator.simulate_sweep(workload, mesh, cfg,
                                       [p for _, p in pts], **sweep_kw)
    return [dict(coords, params=p, result=r)
            for (coords, p), r in zip(pts, results)]


# --------------------------------------------------------------------------
# Crossover study
# --------------------------------------------------------------------------

def _median_iqr(xs, what: str = "selection"):
    """Median + interquartile range. An empty selection raises a clear
    error naming the grid cell."""
    xs = np.asarray(xs, dtype=np.float64)
    if xs.size == 0:
        raise ValueError(f"no runs in {what}: cannot take median/IQR "
                         "of an empty selection")
    return float(np.median(xs)), float(
        np.percentile(xs, 75) - np.percentile(xs, 25))


def _finite_ratio(num: float, den: float):
    """num/den when both are finite and den is nonzero, else None (JSON
    null): the analytic Eq. 1 expectation is exactly `inf` at P_s == 0
    (`latency.expected_time_to_task`)."""
    if not (np.isfinite(num) and np.isfinite(den)) or den == 0:
        return None
    return float(num / den)


def _fmt(x, spec: str = ".3f") -> str:
    return "undef" if x is None else format(x, spec)


def _group(rows, strategy_code, tau):
    return [r for r in rows
            if r["strategy"] == strategy_code and r["hop_ticks"] == tau]


def crossover(sizes=DEFAULT_SIZES, taus=(2, 5, 10),
              strategies=("neighbor", "global"), runs: int = 3,
              workload: tasks.FibWorkload | None = None,
              capacity: int = 2048, max_ticks: int = 5_000_000,
              assert_single_compile: bool = False,
              rtt_hists: bool = True, device=None) -> dict:
    """The paper's crossover experiment on the sweep engine.

    For each constellation size N runs the full (strategy × τ × seed)
    factorial in one `simulate_sweep` call on `device` (default: the CUDA
    device), then reports per τ the seed-matched NEIGHBOR/GLOBAL makespan
    ratio (median + IQR) against the Ineq. 2 analytic prediction, and with
    `rtt_hists` each strategy's measured RTT distribution (`_measure_rtt`).
    Returns the JSON document, in the reference's schema.
    """
    wl = workload if workload is not None else tasks.FibWorkload(
        n=26, cutoff=12, max_leaf_cost=16)
    codes = [stealing.strategy_code(s) for s in strategies]
    names = {c: stealing.CODE_STRATEGIES[c].value for c in codes}
    doc = {
        "schema": "crossover/v1",
        "workload": {"kind": type(wl).__name__,
                     **dataclasses.asdict(wl)},
        "sizes": [int(n) for n in sizes], "taus": [int(t) for t in taus],
        "strategies": [names[c] for c in codes], "runs": int(runs),
        "points": [], "crossover": [], "rtt": [],
        "traces_per_size": {},
    }
    for n in sizes:
        mesh = topology.MeshTopology.square(n)
        cfg = simulator.SimConfig(capacity=capacity, max_ticks=max_ticks)
        before = simulator.core_count()
        grid = run_grid(wl, mesh, cfg, dict(
            strategy=codes, hop_ticks=list(taus), seed=range(runs)),
            device=device)
        cores = simulator.core_count() - before
        doc["traces_per_size"][str(n)] = cores
        if assert_single_compile and cores > 1:
            raise AssertionError(
                f"W={n}: expected one _sim_core call for the whole "
                f"{len(grid)}-point grid, got {cores}")
        rows = []
        for g in grid:
            r = g["result"]
            assert r.overflow == 0, f"overflow at W={n}: {g}"
            rows.append(dict(strategy=g["strategy"],
                             hop_ticks=g["hop_ticks"], seed=g["seed"],
                             ticks=int(r.ticks),
                             p_success=float(r.p_success)))
        for tau in taus:
            per = {}
            for c in codes:
                sel = _group(rows, c, tau)
                cell = f"cell (W={n}, strategy={names[c]}, tau={tau})"
                if not sel:
                    print(f"# sweep: {cell} has no runs; skipping")
                    continue
                med_t, iqr_t = _median_iqr([s["ticks"] for s in sel], cell)
                med_p, _ = _median_iqr([s["p_success"] for s in sel], cell)
                per[c] = sel
                doc["points"].append(dict(
                    N=int(n), tau=int(tau), strategy=names[c],
                    median_ticks=med_t, iqr_ticks=iqr_t,
                    median_p_success=med_p,
                    ticks=[s["ticks"] for s in sel]))
            gcode = stealing.strategy_code(stealing.Strategy.GLOBAL)
            ncode = stealing.strategy_code(stealing.Strategy.NEIGHBOR)
            if gcode not in per or ncode not in per:
                continue
            # seed-matched NEIGHBOR/GLOBAL makespan ratios (< 1 ⇒
            # neighbor-only wins), then the analytic Eq. 1 prediction of
            # the same ratio using the measured median P_s of each side:
            # E[T_n]/E[T_g] = (2τ/P_n) / ((4/3)√N·τ/P_g)
            ratios = [sn["ticks"] / sg["ticks"] for sn, sg in zip(
                sorted(per[ncode], key=lambda s: s["seed"]),
                sorted(per[gcode], key=lambda s: s["seed"]))]
            med_r, iqr_r = _median_iqr(
                ratios, f"cell (W={n}, tau={tau}) ratio set")
            pn = float(np.median([s["p_success"] for s in per[ncode]]))
            pg = float(np.median([s["p_success"] for s in per[gcode]]))
            # undefined Eq. 1 ratios (P_s == 0) are emitted as null
            analytic_ratio = _finite_ratio(
                latency.expected_time_to_task(
                    latency.neighbor_round_trip(tau), pn),
                latency.expected_time_to_task(
                    latency.global_round_trip(n, tau), pg))
            pg_over_pn = _finite_ratio(pg, pn)
            doc["crossover"].append(dict(
                N=int(n), tau=int(tau),
                ratio_neighbor_over_global=med_r, iqr_ratio=iqr_r,
                ratios=ratios, p_neighbor=pn, p_global=pg,
                pg_over_pn=pg_over_pn,
                analytic_threshold=float(latency.threshold(n)),
                analytic_rtt_ratio=float(latency.speedup_per_attempt(n)),
                analytic_ratio=analytic_ratio,
                neighbor_wins=bool(
                    latency.neighbor_wins(n, pg, pn))))
            emit(f"crossover/N={n}/tau={tau}", 0.0,
                 f"ratio_n_over_g={med_r:.3f};iqr={iqr_r:.3f};"
                 f"analytic={_fmt(analytic_ratio)};"
                 f"Pg/Pn={_fmt(pg_over_pn, '.2f')};"
                 f"threshold={float(latency.threshold(n)):.2f}")
    if rtt_hists:
        doc["rtt"] = _measure_rtt(wl, max(sizes), sorted(taus)[len(taus) // 2],
                                  codes, capacity, max_ticks, device)
    return doc


def _measure_rtt(wl, n, tau, codes, capacity, max_ticks, device=None):
    """One traced run per strategy at (N, τ), the strategies as one grid (one
    `simulate_sweep`, on the card one captured graph): the measured
    per-attempt RTT distribution against the §3.3 analytic expectation."""
    mesh = topology.MeshTopology.square(n)
    tc = tracing.TraceConfig(ring_capacity=1 << 15, bins=128, bin_ticks=64)
    cfg = simulator.SimConfig(hop_ticks=tau, capacity=capacity, max_ticks=max_ticks,
                              trace=tc)
    results = simulator.simulate_sweep(
        wl, mesh, cfg, [cfg.params._replace(strategy=c) for c in codes], device=device)
    hists = []
    for c, r in zip(codes, results):
        strat = stealing.CODE_STRATEGIES[c]
        h = tracing.attempt_latency_hist(r.trace, strategy=strat,
                                         num_workers=n, tau=tau)
        hists.append(h)
        emit(f"crossover/rtt/{strat.value}/N={n}/tau={tau}", 0.0,
             f"mean_rtt={h['measured_mean_rtt']:.1f};"
             f"analytic={h['analytic_rtt']:.1f};"
             f"p={h['p_success']:.3f};n={h['resolved_attempts']}")
    return hists


# --------------------------------------------------------------------------
# Plot
# --------------------------------------------------------------------------

def plot_crossover(doc: dict, path: str) -> bool:
    """Ratio-vs-W crossover curve (+ analytic overlay) and the measured
    per-strategy RTT distributions. Returns False when matplotlib is
    unavailable (plot skipped, JSON still complete)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    has_rtt = bool(doc.get("rtt"))
    fig, axs = plt.subplots(1, 2 if has_rtt else 1,
                            figsize=(11 if has_rtt else 6, 4.2))
    ax = axs[0] if has_rtt else axs
    for tau in doc["taus"]:
        pts = sorted((c for c in doc["crossover"] if c["tau"] == tau),
                     key=lambda c: c["N"])
        if not pts:
            continue
        ns = [c["N"] for c in pts]
        med = [c["ratio_neighbor_over_global"] for c in pts]
        iqr = [c["iqr_ratio"] for c in pts]
        line, = ax.plot(ns, med, "o-", label=f"measured τ={tau}")
        ax.errorbar(ns, med, yerr=np.asarray(iqr) / 2, fmt="none",
                    ecolor=line.get_color(), alpha=0.5, capsize=3)
        # analytic_ratio is null where Eq. 1 is undefined (P_s == 0)
        apts = [(c["N"], c["analytic_ratio"]) for c in pts
                if c["analytic_ratio"] is not None]
        if apts:
            ax.plot([a[0] for a in apts], [a[1] for a in apts], "--",
                    color=line.get_color(), alpha=0.7,
                    label=f"Eq. 1 bound τ={tau}")
    ax.axhline(1.0, color="k", lw=0.8, ls=":")
    ax.set_xlabel("constellation size W")
    ax.set_ylabel("NEIGHBOR / GLOBAL makespan")
    ax.set_title("Crossover: neighbor-only wins below 1.0")
    ax.legend(fontsize=8)
    if has_rtt:
        axr = axs[1]
        for h in doc["rtt"]:
            edges = np.asarray(h["edges"])
            counts = np.asarray(h["counts"], dtype=np.float64)
            total = counts.sum()
            if total > 0:
                counts = counts / total
            line, = axr.step(edges[:-1], counts, where="post",
                             label=f"{h['strategy']} (p={h['p_success']:.2f})")
            axr.axvline(h["analytic_rtt"], color=line.get_color(),
                        ls="--", alpha=0.7)
        axr.set_xlabel("per-attempt RTT (ticks)")
        axr.set_ylabel("fraction of resolved attempts")
        axr.set_title(f"Measured RTT vs §3.3 analytic (dashed), "
                      f"W={max(doc['sizes'])}")
        axr.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return True


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def _device_name(device) -> str:
    dev = torch.device("cuda" if device is None else device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=None)
    ap.add_argument("--taus", type=int, nargs="+", default=[2, 5, 10])
    ap.add_argument("--strategies", nargs="+",
                    default=["neighbor", "global"])
    ap.add_argument("--runs", type=int, default=3, help="seeds per point")
    ap.add_argument("--quick", action="store_true",
                    help="small sizes + small workload (CI smoke)")
    ap.add_argument("--out", default="BENCH_crossover_torch.json")
    ap.add_argument("--plot", default="crossover_torch.png")
    ap.add_argument("--no-plot", action="store_true")
    ap.add_argument("--no-rtt", action="store_true",
                    help="skip the traced RTT-distribution runs")
    ap.add_argument("--assert-single-compile", action="store_true",
                    help="fail unless each size's grid is one _sim_core call")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()
    sizes = tuple(args.sizes) if args.sizes else (
        QUICK_SIZES if args.quick else DEFAULT_SIZES)
    wl = (tasks.FibWorkload(n=20, cutoff=12, max_leaf_cost=8) if args.quick
          else tasks.FibWorkload(n=26, cutoff=12, max_leaf_cost=16))
    print("# crossover sweep (one core per size, "
          f"{len(args.strategies)}x{len(args.taus)}x{args.runs} grid)")
    t0 = time.perf_counter()
    doc = crossover(sizes, tuple(args.taus), tuple(args.strategies),
                    runs=args.runs, workload=wl,
                    assert_single_compile=args.assert_single_compile,
                    rtt_hists=not args.no_rtt, device=args.device)
    print(f"# wall {time.perf_counter() - t0:.3f} s on {_device_name(args.device)}")
    jsonio.write(args.out, doc, indent=2)
    print(f"# wrote {args.out}")
    if not args.no_plot:
        if plot_crossover(doc, args.plot):
            print(f"# wrote {args.plot}")
        else:
            print("# matplotlib unavailable; plot skipped")


if __name__ == "__main__":
    main()
