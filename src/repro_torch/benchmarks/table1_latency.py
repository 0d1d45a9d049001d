"""Paper Table 1: expected round-trip time of one steal attempt and the
Ineq. 2 threshold, per constellation size (τ = 5 ms), on the port (the
reference's `benchmarks/table1_latency.py`).

Purely analytical (`core.latency`), digit for digit the paper's; the last
column re-derives the global round trip from the measured mean hop count
of the actual finite grid (`MeshTopology.mean_hops`, boundary effects
included). No device is involved.

    python -m repro_torch.benchmarks.table1_latency
"""

from __future__ import annotations

from ..core import latency, topology
from .common import emit


def run(csv: bool = True):
    rows = latency.table1()
    out = []
    for r in rows:
        mesh = topology.MeshTopology.square(r.nodes)
        measured_rt = 2 * mesh.mean_hops() * latency.DEFAULT_TAU_S * 1e3
        out.append((r.nodes, r.threshold, r.neighbor_rt_ms, r.global_rt_ms,
                    measured_rt))
        if csv:
            emit(f"table1/N={r.nodes}", 0.0,
                 f"threshold={r.threshold:.1f};neighbor_rt_ms="
                 f"{r.neighbor_rt_ms:.0f};global_rt_ms={r.global_rt_ms:.0f};"
                 f"grid_measured_rt_ms={measured_rt:.0f}")
    return out


def main():
    print("# Table 1 — steal-attempt RTT and threshold (tau=5ms)")
    print(f"{'N':>6} {'thresh':>8} {'RT_n(ms)':>9} {'RT_g(ms)':>9} "
          f"{'RT_g measured(ms)':>18}")
    for n, th, rn, rg, rm in run(csv=False):
        print(f"{n:>6} {th:>8.1f} {rn:>9.0f} {rg:>9.0f} {rm:>18.1f}")


if __name__ == "__main__":
    main()
