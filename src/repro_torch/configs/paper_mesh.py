"""The paper's own experimental configuration (§4.1) — not an LM config.

Goethe-NHR: 40 cores/node, 1–16 nodes → 40–640 workers on a ⌈√C⌉-wide grid;
FIB n=62 cutoff 32; UTS geometric b0=4, d=16, r=19; τ=5 ms for the model.
CPU-scale defaults shrink the trees but keep the structure; the paper-parity
parameters are kept alongside for reference.
"""
import dataclasses

from repro_torch.core import constellation, tasks


@dataclasses.dataclass(frozen=True)
class PaperMeshConfig:
    node_cores: int = 40
    node_counts: tuple = (1, 2, 4, 8, 16)
    tau_s: float = 5e-3
    # paper-parity workloads (HPC scale — hours on CPU):
    fib_paper: tasks.FibWorkload = tasks.FibWorkload(n=62, cutoff=32)
    uts_paper_b0: float = 4.0
    uts_paper_depth: int = 16
    uts_paper_seed: int = 19
    # CPU-scale equivalents used by benchmarks. Sized so the steady phase
    # dominates at 640 workers (~2.9M / 251k work units -- the paper's HPC
    # runs are likewise steady-phase-dominated; undersized trees measure
    # only the initial phase, where neighbor diffusion is *expected* to
    # lag -- see the reference's Fig3 sizing note). UTS keeps the paper's
    # exact parameters (b0=4, d=16, r=19) under the linear-decay shape.
    fib: tasks.FibWorkload = tasks.FibWorkload(n=44, cutoff=24, max_leaf_cost=192)
    uts: tasks.UtsWorkload = tasks.UtsWorkload(b0=4.0, d_max=16, root_seed=19)
    # Granularity-faithful variant for the latency simulator: leaf cost >>
    # steal RTT, the paper's actual regime (its fib(32) leaves are ~7 ms of
    # work vs µs-scale steal RTTs). `fib` above compresses leaf costs to
    # keep the one-tick stepper tractable; the event-leaping stepper makes
    # this uncompressed shape affordable (bench_sim_throughput).
    fib_granular: tasks.FibWorkload = tasks.FibWorkload(n=48, cutoff=28,
                                                        max_leaf_cost=2048)
    # Orbit presets for the time-varying link-state subsystem (§2.1): an
    # 8x8 wraparound constellation whose inter-plane τ oscillates over one
    # orbital period, with eclipse shutdowns and cross-seam handovers —
    # the setting of the reference's benchmarks/orbit_dynamics.py and
    # examples/constellation_sim.py.
    orbit: constellation.ConstellationConfig = constellation.ConstellationConfig(
        planes=8, sats_per_plane=8, orbit_ticks=4_000, tau_base=5,
        interplane_amp=0.6, eclipse_fraction=0.35, battery_limited_frac=0.12,
        warn_ticks=40, wraparound=True, epochs_per_orbit=32,
        seam_outage_frac=0.1, seed=7)
    # CI-smoke scale: one short orbit of a 5x5 torus
    orbit_quick: constellation.ConstellationConfig = constellation.ConstellationConfig(
        planes=5, sats_per_plane=5, orbit_ticks=600, tau_base=4,
        interplane_amp=0.6, eclipse_fraction=0.35, battery_limited_frac=0.15,
        warn_ticks=25, wraparound=True, epochs_per_orbit=12,
        seam_outage_frac=0.1, seed=7)


CONFIG = PaperMeshConfig()
