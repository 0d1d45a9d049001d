"""The round executor's deque layer two ways, on one grid: the in-place
pushes `core.scheduler` runs (`deque.push_top_many_` and `push_top_`, each
export through `deque.export_bottom`: the `steal_compact` kernel on the
card) against the staged push log (one `deque.stage` a round, its
`stage_pop`, `stage_push_many`, `stage_export` and `stage_push`, one
`deque.apply` commit: the `deque_apply` kernel on the card, and no
`steal_compact`). Both give the same `RunResult`s, held here. Prints ms a
round of each over a window of rounds, set-up apart, run in turns (in
place, staged, staged, in place), and on the card each one's device
activities a round.

    python -m repro_torch.benchmarks.sched_backends               # W=640, the card
    python -m repro_torch.benchmarks.sched_backends --device cpu --workers 16 \\
        --capacity 256 --rounds 40 --small
"""

from __future__ import annotations

import argparse
import contextlib
import time
import types

import numpy as np
import torch

from ..core import deque as dq
from ..core import scheduler, stealing, tasks, topology
from .common import device_name, emit

# paper_mesh's steady-phase FIB, and the W=16 tree of the scheduler's tests
FIB_STEADY = tasks.FibWorkload(n=44, cutoff=24, max_leaf_cost=192)
FIB_SMALL = tasks.FibWorkload(n=24, cutoff=10, max_leaf_cost=8)


@contextlib.contextmanager
def staged_rounds(cfg: scheduler.SchedulerConfig):
    """Run `scheduler._round` on the staged push log: `_rows` opens one
    `stage` a round (a lane for each expansion's children and each
    sub-round's loot), the round's deque calls go to their staged mirrors,
    and `_grid` commits the log with one `apply`."""
    lanes = cfg.expansions_per_round * tasks.EXPAND_K + cfg.steal_subrounds

    def export_bottom(ops, grants, width):
        ops, stolen = dq.stage_export(ops, grants, width)
        return stolen, ops

    layer = types.SimpleNamespace(**vars(dq))
    layer.pop_top, layer.push_top_many_ = dq.stage_pop, dq.stage_push_many
    layer.push_top_, layer.export_bottom = dq.stage_push, export_bottom
    rows, grid = scheduler._rows, scheduler._grid

    def staged_grid(d, G, W):
        return grid(dq.apply(d) if isinstance(d, dq.DequeOps) else d, G, W)

    saved = scheduler.dq, scheduler._rows, scheduler._grid
    scheduler.dq = layer
    scheduler._rows = lambda d: dq.stage(rows(d), lanes)
    scheduler._grid = staged_grid
    try:
        yield
    finally:
        scheduler.dq, scheduler._rows, scheduler._grid = saved


def _activities(fn) -> int:
    """Device activities (kernels, copies, memsets) while `fn` runs."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type() == torch.autograd.DeviceType.CUDA
               for e in prof.profiler.kineto_results.events())


def run(workload=FIB_STEADY, workers: int = 640, capacity: int = 4096,
        rounds: int = 297, seeds=(0,), device=None) -> dict:
    """Both backends on the (GLOBAL, NEIGHBOR) × `seeds` grid, cut at
    `rounds`. Returns {backend: {"ms_round": [two turns], "activities":
    per round or None}}; raises if the backends' results differ."""
    dev = torch.device("cuda" if device is None else device)
    mesh = topology.MeshTopology.square(workers)
    cfg = scheduler.SchedulerConfig(capacity=capacity, max_rounds=rounds)
    pts = [cfg.params._replace(strategy=stealing.strategy_code(st), seed=s)
           for st in (stealing.Strategy.GLOBAL, stealing.Strategy.NEIGHBOR)
           for s in seeds]
    one = scheduler.SchedulerConfig(capacity=capacity, max_rounds=1)

    def grid(c):
        return lambda: scheduler.run_sweep(workload, mesh, c, pts, device=dev)

    def timed(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def backend(name):
        return staged_rounds(cfg) if name == "staged" else contextlib.nullcontext()

    out = {b: {"ms_round": [], "activities": None} for b in ("in_place", "staged")}
    results = {}
    for name in ("in_place", "staged", "staged", "in_place"):
        with backend(name):
            _, setup = timed(grid(one))
            rs, wall = timed(grid(cfg))
        n = max(r.rounds for r in rs)
        out[name]["ms_round"].append((wall - setup) / (n - 1) * 1e3)
        results.setdefault(name, rs)
    for a, b in zip(results["in_place"], results["staged"]):
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            if not (np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y):
                raise AssertionError(f"staged round differs in {f}: {y!r} vs {x!r}")
    if dev.type == "cuda":
        for name in out:
            with backend(name):
                fn = grid(cfg)
                fn()
                out[name]["activities"] = _activities(fn) / rounds
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workers", type=int, default=640)
    ap.add_argument("--capacity", type=int, default=4096)
    ap.add_argument("--rounds", type=int, default=297)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--small", action="store_true",
                    help="the scheduler tests' FIB (n 24, cutoff 10, leaf 8)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    a = ap.parse_args(argv)
    t0 = time.perf_counter()
    out = run(FIB_SMALL if a.small else FIB_STEADY, a.workers, a.capacity, a.rounds,
              tuple(a.seeds), a.device)
    for name, r in out.items():
        emit(f"sched_backend/{name}/W={a.workers}/C={a.capacity}",
             float(np.mean(r["ms_round"])) * 1e3,
             f"ms_round={r['ms_round']} activities_round={r['activities']}")
    print(f"# wall {time.perf_counter() - t0:.3f} s on {device_name(a.device)}; "
          f"staged == in place in every RunResult field")
    return out


if __name__ == "__main__":
    main()
