"""The collective schedule of the sharded executor's steal round on the
production worker mesh: the paper's core claim made structural.

One round of `core.scheduler.make_sharded_round` runs on a 16x16 local mesh
(one worker a shard) under both strategies, through a mesh that records
each collective's kind and bytes (`CountingMesh`):

  * NEIGHBOR — only collective-permutes (single-hop ISL traffic, constant
    payload: the 2τ side of §3.3) plus the termination psum;
  * GLOBAL — all-gathers whose payload grows with the worker count (the
    multi-hop (4/3)√N·τ side).

The numbers follow the reference's convention (`repro.launch.dryrun.
collective_bytes`, `repro.launch.dryrun_runtime`): result bytes a device,
an all-reduce counted twice (a ring moves ~2x its buffer), the loop body —
one round — counted once, bytes at the reference's dtypes (a pred is one
byte); the same JSON layout (`collective-permute`, `all-gather`,
`all-reduce`, `total`, `op_counts`). The reference counts ops in XLA's
compiled HLO, and XLA may merge or split collectives, so the op counts
need not equal the reference's; the port counts the calls its round
makes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_runtime --device cpu
"""

from __future__ import annotations

import argparse
import json
import os

from ..core import mesh_comm, rng, scheduler, stealing, tasks

# the reference's settings (`repro.launch.dryrun_runtime.lower_steal_round`)
DRYRUN_WORKLOAD = dict(n=30, cutoff=12)
DRYRUN_CAPACITY = 256


class CountingMesh:
    """A mesh (`LocalMesh` or `DistMesh`) that records, for each collective
    called through it, its kind (XLA's name) and one shard's result bytes
    (all-reduce twice)."""

    def __init__(self, inner):
        self.inner = inner
        self.ops: list[tuple[str, int]] = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _record(self, kind: str, out, factor: int = 1):
        self.ops.append((kind, factor * out[0].numel() * out.element_size()))
        return out

    def ppermute(self, x, axis, pairs):
        return self._record("collective-permute", self.inner.ppermute(x, axis, pairs))

    def all_gather(self, x, axis):
        return self._record("all-gather", self.inner.all_gather(x, axis))

    def psum(self, x, axis):
        return self._record("all-reduce", self.inner.psum(x, axis), factor=2)


def collective_bytes(ops) -> dict:
    """(kind, bytes) records summed by kind, in the reference's layout."""
    out, counts = {}, {}
    for kind, nbytes in ops:
        out[kind] = out.get(kind, 0.0) + float(nbytes)
        counts[kind] = counts.get(kind, 0) + 1
    out["total"] = sum(out.values())
    out["op_counts"] = counts
    return out


def count_round(strategy: stealing.Strategy, rows: int = 16, cols: int = 16,
                capacity: int = DRYRUN_CAPACITY, workload=None, device=None) -> dict:
    """The collectives of one round of the sharded executor, one worker's
    share, on a rows x cols local mesh on `device` (default: the CUDA
    device; ``"cpu"`` for the plain path)."""
    workload = workload or tasks.FibWorkload(**DRYRUN_WORKLOAD)
    mesh = CountingMesh(mesh_comm.LocalMesh((rows, cols), device=device))
    cfg = scheduler.SchedulerConfig(strategy=strategy, capacity=capacity, max_rounds=64,
                                    steal_subrounds=1, expansions_per_round=1)
    round_fn = scheduler.make_sharded_round((rows, cols), cfg, workload.tables(mesh.device),
                                            mesh=mesh)
    state = scheduler._sharded_init(mesh.inner, cfg, workload)
    round_fn(state, rng.fold_in(rng.PRNGKey(cfg.seed), 0))
    return collective_bytes(mesh.ops)


def schedules(rows: int = 16, cols: int = 16, device=None) -> dict:
    """{strategy value: `count_round`} for NEIGHBOR and GLOBAL."""
    return {s.value: count_round(s, rows, cols, device=device)
            for s in (stealing.Strategy.NEIGHBOR, stealing.Strategy.GLOBAL)}


def report(out: dict) -> list[str]:
    """The reference's printed lines for a `schedules` result."""
    lines = []
    for name, coll in out.items():
        lines.append(f"[paper-runtime] {name:9s} op_counts={coll.get('op_counts', {})} "
                     f"permute_bytes={coll.get('collective-permute', 0):.2e} "
                     f"allgather_bytes={coll.get('all-gather', 0):.2e}")
    n, g = out["neighbor"], out["global"]
    single_hop_only = n.get("all-gather", 0) == 0 and n.get("all-to-all", 0) == 0
    lines.append(f"[paper-runtime] neighbor single-hop-only (no gathers): {single_hop_only}")
    lines.append(f"[paper-runtime] global gather bytes / neighbor permute bytes = "
                 f"{g.get('all-gather', 1) / max(n.get('collective-permute', 1), 1):.1f}x")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=16)
    ap.add_argument("--cols", type=int, default=16)
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    ap.add_argument("--out", default=None, help="write the JSON here")
    args = ap.parse_args(argv)
    out = schedules(args.rows, args.cols, args.device)
    for line in report(out):
        print(line)
    print(json.dumps(out))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
