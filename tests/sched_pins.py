"""Print the reference's pins of `chip_smoke.py`'s `[scheduler]` phase and
its Fig. 3 / Table 2 rows.

Runs `repro.core.scheduler.run_sweep` (JAX, on the CPU) at the phase's
settings — capacity 4096, 2,000,000 rounds at most, GLOBAL and NEIGHBOR x
the workload's seeds (`sched_grid`) as one sweep on
`MeshTopology.square(W)` — for one of the
phase's workloads (`FIB`, `UTS`: Fig. 3's trees; `FIB_STEADY`:
paper_mesh's `fib`) and prints, per worker count, each point's
`sched_row` (the SCHED_PINS row: result, rounds, nodes, attempts,
successes, overflow and the per-worker arrays' sha256 prefixes) and the
Fig. 3 row the port's `benchmarks.fig3_scaling` emits. Not a test; run
from the repository root (each worker count takes minutes):

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/sched_pins.py FIB 640
    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/sched_pins.py UTS 25,49,100,160,320,640
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as c  # noqa: E402  (the recipe's constants; no JAX there)

from repro.core import scheduler, stealing, tasks, topology  # noqa: E402


def main(name: str, workers: str):
    kind, fields, expansions = c.SCHED_WORKLOADS[name]
    wl = (tasks.FibWorkload if kind == "fib" else tasks.UtsWorkload)(**fields)
    for W in (int(w) for w in workers.split(",")):
        mesh = topology.MeshTopology.square(W)
        cfg = scheduler.SchedulerConfig(capacity=c.SCHED_CAP,
                                        max_rounds=c.SCHED_MAX_ROUNDS,
                                        expansions_per_round=expansions)
        pts = [cfg.params._replace(strategy=stealing.strategy_code(s), seed=seed)
               for s, seed in c.sched_grid(name)]
        t0 = time.perf_counter()
        rs = scheduler.run_sweep(wl, mesh, cfg, pts)
        dt = time.perf_counter() - t0
        rows = [list(c.sched_row(np, r)) for r in rs]
        tg, tn, rel = c.sched_gap(np, name, [r.rounds for r in rs])
        grid = c.sched_grid(name)
        pg = np.mean([r.p_success for (s, _), r in zip(grid, rs) if s == "global"])
        pn = np.mean([r.p_success for (s, _), r in zip(grid, rs) if s == "neighbor"])
        print(f"{name} W={W} ({dt:.1f} s): {json.dumps(rows)}")
        print(f"fig3/{name}/W={W},0.00,global={tg:.0f};neighbor={tn:.0f};"
              f"rel={rel*100:+.2f}%;Pg={pg:.3f};Pn={pn:.3f};slack_rounds={tg:.0f}",
              flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:3])
