"""What the port's benchmark scripts share: one CSV row per measurement,
and the full-constellation dynamic scenario."""

from ..core import constellation


def emit(name: str, us_per_call: float, derived: str = ""):
    print(f"{name},{us_per_call:.2f},{derived}", flush=True)


def dynamic_constellation(W: int, tau_base: int, orbits: int):
    """The full-constellation dynamic scenario of a square W (the reference's
    benchmarks/bench_sim_throughput.py `_dynamic_constellation`): a
    wraparound torus of sqrt(W) planes, eclipse cycles (periodic per-worker
    (fail, wake) schedules) and seam handover outages over `orbits` orbits.
    The orbit is 16 ticks a plane, so the seam's handover cycle is 16 ticks
    and the second orbit's epochs dedup against the first's. Returns
    (constellation, schedule, orbit_ticks)."""
    side = int(round(W ** 0.5))
    if side * side != W:
        raise ValueError(f"the dynamic scenario needs a square worker count, got {W}")
    orbit_ticks = 16 * side
    ccfg = constellation.ConstellationConfig(
        planes=side, sats_per_plane=side, orbit_ticks=orbit_ticks,
        tau_base=tau_base, wraparound=True, epochs_per_orbit=32,
        eclipse_fraction=0.35, battery_limited_frac=0.1,
        seam_outage_frac=0.1, warn_ticks=min(50, orbit_ticks // 8))
    con = constellation.Constellation(ccfg)
    return con, con.schedule(horizon_ticks=orbits * orbit_ticks), orbit_ticks
