"""Run the sharded executor (`core.scheduler.build_sharded_run`: one worker
a shard of a ("row", "col") mesh) on a FIB workload and print its result.

On a local mesh (every worker on one device: the CUDA device by default,
``--device cpu`` for the plain PyTorch path):

    PYTHONPATH=src python -m repro_torch.launch.sharded --rows 4 --cols 4 \\
        --strategy neighbor --device cpu

One worker a process, over `torch.distributed` with gloo (rank r is the
worker at row r // cols, column r % cols):

    PYTHONPATH=src torchrun --nproc-per-node 16 -m repro_torch.launch.sharded \\
        --rows 4 --cols 4 --strategy neighbor --backend gloo

NCCL needs one card a rank, so a machine with one card runs the executor
on the local mesh. `dist_worker` is the same path for
`torch.multiprocessing` spawn (the tests' way in).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..core import scheduler, stealing, tasks
from .mesh import make_worker_mesh


def job(strategy: str = "neighbor", torus: bool = False, n: int = 20, cutoff: int = 10,
        max_leaf_cost: int = 8, capacity: int = 128, max_rounds: int = 50_000,
        seed: int = 0) -> dict:
    """One run's settings (the defaults: tests/test_scheduler.py's sharded
    FIB)."""
    return dict(strategy=strategy, torus=torus, n=n, cutoff=cutoff,
                max_leaf_cost=max_leaf_cost, capacity=capacity,
                max_rounds=max_rounds, seed=seed)


def run(mesh, spec: dict):
    """`spec` (a `job`) on `mesh` (a `LocalMesh` or a `DeviceMesh`):
    (WorkerState, rounds)."""
    wl = tasks.FibWorkload(n=spec["n"], cutoff=spec["cutoff"],
                           max_leaf_cost=spec["max_leaf_cost"])
    cfg = scheduler.SchedulerConfig(strategy=stealing.Strategy(spec["strategy"]),
                                    capacity=spec["capacity"],
                                    max_rounds=spec["max_rounds"], seed=spec["seed"])
    return scheduler.build_sharded_run(mesh, cfg, wl, torus=spec["torus"])()


def arrays(state: scheduler.WorkerState) -> dict:
    """Every leaf of a run's state as a host numpy array, by name."""
    d = state.deque
    leaves = dict(state._asdict(), buf=d.buf, bot=d.bot, size=d.size)
    del leaves["deque"]
    return {k: v.cpu().numpy() for k, v in leaves.items()}


def summary(state: scheduler.WorkerState, rounds: int) -> dict:
    a = arrays(state)
    return dict(rounds=rounds,
                result=int(a["acc"].astype(np.int64).sum() % int(tasks.RESULT_MOD)),
                nodes=int(a["nodes"].sum()), attempts=int(a["attempts"].sum()),
                successes=int(a["successes"].sum()), overflow=int(a["overflow"].sum()))


def dist_worker(rank: int, world_size: int, init_method: str, rows: int, cols: int,
                specs: list, out: str):
    """One rank of a gloo run of every `job` in `specs` on a rows x cols
    `DeviceMesh`; rank 0 writes each run's arrays and rounds to `out` (an
    .npz, keys ``"<i>/<leaf>"`` and ``"<i>/rounds"``)."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, world_size=world_size,
                            rank=rank)
    try:
        mesh = make_worker_mesh(rows, cols)
        saved = {}
        for i, spec in enumerate(specs):
            state, rounds = run(mesh, spec)
            saved.update({f"{i}/{k}": v for k, v in arrays(state).items()})
            saved[f"{i}/rounds"] = np.asarray(rounds)
        if rank == 0:
            np.savez(out, **saved)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--cols", type=int, default=4)
    ap.add_argument("--strategy", choices=("neighbor", "global"), default="neighbor")
    ap.add_argument("--torus", action="store_true")
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--cutoff", type=int, default=10)
    ap.add_argument("--max-leaf-cost", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=128)
    ap.add_argument("--max-rounds", type=int, default=50_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the local mesh's device (default: the CUDA device)")
    ap.add_argument("--backend", choices=("gloo",), default=None,
                    help="one worker a rank over torch.distributed (under torchrun)")
    args = ap.parse_args(argv)
    spec = job(args.strategy, args.torus, args.n, args.cutoff, args.max_leaf_cost,
               args.capacity, args.max_rounds, args.seed)
    if args.backend is None:
        mesh = make_worker_mesh(args.rows, args.cols, device=args.device)
        where = f"local mesh on {mesh.device}"
        rank = 0
    else:
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group(args.backend)
        rank = dist.get_rank()
        mesh = make_worker_mesh(args.rows, args.cols)
        where = f"{dist.get_world_size()} ranks over {args.backend}"
    try:
        state, rounds = run(mesh, spec)
        if rank == 0:
            wl = tasks.FibWorkload(n=args.n, cutoff=args.cutoff,
                                   max_leaf_cost=args.max_leaf_cost)
            s = summary(state, rounds)
            exact = (s["result"] == wl.expected_result() and s["nodes"] == wl.expected_nodes()
                     and s["overflow"] == 0)
            print(f"[sharded] {args.rows}x{args.cols} {args.strategy}"
                  f"{' torus' if args.torus else ''}, {where}: {json.dumps(s)} exact={exact}")
    finally:
        if args.backend is not None:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
