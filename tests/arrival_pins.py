"""Print the reference's pins of `chip_smoke.py`'s `[arrivals]` phase.

Runs `repro.core.simulator` (JAX, on the CPU) at the phase's settings —
the (strategy x load) grid traced as one `simulate_sweep`, the NEIGHBOR 0.5
point untraced at famine batch 64 and 0, the open constellation — and
prints each run's `result_digest` (every `SimResult`
field) and the numbers the phase prints beside it. Not a test; run from the
repository root:

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/arrival_pins.py grid
    (or: modes, constellation)
"""

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as c  # noqa: E402  (the recipe's constants; no JAX there)

from benchmarks.bench_sim_throughput import _dynamic_constellation  # noqa: E402
from repro.core import arrivals, simulator, tasks, topology, tracing  # noqa: E402


def _show(label, r):
    soj = r.sojourn or {}
    print(f"{label}: events={r.events} ticks={r.ticks} injected={r.arrivals_injected} "
          f"dropped={r.arrivals_dropped} done={r.requests_done} "
          f"soj_sum={r.sojourn_sum_ticks} p50={soj.get('p50')} p99={soj.get('p99')} "
          f"p999={soj.get('p999')} ring_dropped={r.trace.dropped if r.trace else None} "
          f"digest={c.result_digest(np, r)}", flush=True)


def grid(ring_rows):
    mesh = topology.MeshTopology.square(c.W_MAIN)
    wl = tasks.FibWorkload(**c.ARR_ROOT)
    acfg = arrivals.ArrivalConfig(**c.ARR_SHAPE)
    trc = tracing.TraceConfig(ring_rows, *c.ARR_TRACE[1:])
    pts = [c.arr_config(simulator, s, ld, arrivals, trace=trc)
           for s in c.ARR_STRATEGIES for ld in c.ARR_LOADS]
    t0 = time.perf_counter()
    res = simulator.simulate_sweep(wl, mesh, pts[0].static, pts, arrivals=acfg)
    print(f"# grid, ring {ring_rows}: {time.perf_counter() - t0:.1f} s")
    for p, r in zip(pts, res):
        _show(f"{p.strategy.value} {c.ARR_LOADS[pts.index(p) % len(c.ARR_LOADS)]}", r)


def modes():
    mesh = topology.MeshTopology.square(c.W_MAIN)
    wl = tasks.FibWorkload(**c.ARR_ROOT)
    acfg = arrivals.ArrivalConfig(**c.ARR_SHAPE)
    for fb in (64, 0):
        r = simulator.simulate(wl, mesh, c.arr_config(simulator, "neighbor", 0.5, arrivals,
                                                      famine_batch=fb), arrivals=acfg)
        _show("untraced neighbor 0.5" + (" fb=0" if fb == 0 else ""), r)


def constellation():
    con, sched, _ = _dynamic_constellation(c.W_MAIN, c.LINK_TAU, c.ARR_ORBITS)
    starts, scale = con.traffic_schedule(c.ARR_ORBITS * con.cfg.orbit_ticks)
    acfg = arrivals.ArrivalConfig(**c.ARR_SHAPE, rate_starts=starts, rate_scale=scale)
    cfg = c.arr_config(simulator, "neighbor", 0.5, arrivals, preshed=True,
                       warn_ticks=con.cfg.warn_ticks)
    t0 = time.perf_counter()
    r = simulator.simulate(tasks.FibWorkload(**c.ARR_ROOT), con.mesh, cfg,
                           fail_time=np.where(sched.predictable, sched.fail_time,
                                              -1).astype(np.int32),
                           wake_time=sched.wake_time, fail_period=sched.fail_period,
                           linkstate=sched.linkstate, arrivals=acfg)
    print(f"# constellation: {time.perf_counter() - t0:.1f} s")
    _show("constellation", r)


if __name__ == "__main__":
    what = sys.argv[1]
    if what == "grid":
        grid(int(sys.argv[2]) if len(sys.argv) > 2 else c.ARR_TRACE[0])
    elif what == "modes":
        modes()
    else:
        constellation()
