"""LEO constellation model: orbital planes, ISLs, eclipses, failures (§2.1).

Maps a physical constellation onto the abstract `MeshTopology`:

  * `planes` orbital planes × `sats_per_plane` satellites → rows × cols of
    the 2D mesh (intra-plane links along rows, inter-plane along columns).
  * Intra-plane ISL latency is constant (ring of evenly spaced satellites).
  * Inter-plane ISL distance varies with orbital phase: adjacent planes
    converge near the poles and diverge at the equator, so the link latency
    oscillates over one orbital period (§2.1 challenge 2). We model it as
    τ(t) = τ_base · (1 + amp·|sin(2π t/T + φ_plane)|).
  * Eclipse: a contiguous fraction of each orbit is in Earth's shadow;
    battery-limited satellites power down during eclipse — a *predictable*
    shutdown (§5 malleability) with `warn_ticks` of lead time; from the
    entry tick on their ISLs are marked down so neighbors stop probing them.
    Eclipse *exits* are just as predictable: the satellite wakes when its
    slot leaves the shadow (`wake_time = entry + eclipse_fraction · orbit`),
    its links come back up at the wake epoch, and the simulator's elastic
    grow path re-arms it as a fresh victim mid-horizon.
  * Cross-seam handovers: with `wraparound=True` the planes close into a
    torus; the seam links between the last and first plane (where relative
    motion is highest) re-acquire periodically and are dark for a fraction
    of each handover cycle.
  * Random failures: radiation/hardware faults at Poisson times. These are
    *unpredictable*, so they do NOT appear in the link-state schedule —
    probes to a radiation-dead satellite fail at grant time instead.

`schedule()` compiles all of this into the plain numpy arrays the
simulator (`repro_torch.core.simulator`) consumes: `fail_time` /
`predictable` / `speed` for the failure machinery plus a full
`linkstate.LinkStateSchedule` — per-epoch per-link latency, link up/down
intervals, and per-epoch speeds — keeping the simulator itself
orbital-mechanics-free. `mean_hop_ticks` (the orbit-averaged τ of a static
baseline) is kept for the §3.3 analytical model.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import linkstate as lstate
from .topology import MeshTopology


@dataclasses.dataclass(frozen=True)
class ConstellationConfig:
    planes: int = 8                  # orbital planes (mesh rows)
    sats_per_plane: int = 8          # satellites per plane (mesh cols)
    orbit_ticks: int = 5_000         # ticks per orbital period
    tau_base: int = 5                # single-hop latency in ticks (τ)
    interplane_amp: float = 0.6      # inter-plane latency oscillation amplitude
    eclipse_fraction: float = 0.35   # fraction of the orbit in shadow
    battery_limited_frac: float = 0.1  # fraction of sats that sleep in eclipse
    warn_ticks: int = 50             # lead time before predictable shutdown
    failure_rate: float = 0.0        # random failures per worker per orbit
    wraparound: bool = False         # ring planes (torus)
    seed: int = 0
    # link-state schedule resolution / seam handovers
    epochs_per_orbit: int = 32       # τ-oscillation sampling epochs per orbit
    seam_outage_frac: float = 0.1    # fraction of a handover cycle seam is dark


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Arrays consumed by `simulator.simulate`."""
    fail_time: np.ndarray          # (W,) first shutdown tick (-1 = never)
    predictable: np.ndarray        # (W,) bool — eclipse (True) vs radiation
    speed: np.ndarray              # (W,) straggler divisors
    mean_hop_ticks: float          # orbit-averaged τ for the analytical model
    linkstate: lstate.LinkStateSchedule  # time-varying per-link latency/state
    # (W,) eclipse-exit tick (-1 = no mid-horizon rejoin): set only for
    # predictable (eclipse) shutdowns whose shadow ends inside the horizon;
    # radiation deaths stay permanent
    wake_time: np.ndarray = None
    # (W,) eclipse cycle length (-1 = one-shot): set to `orbit_ticks` for
    # battery-limited satellites whose shadow recurs inside the horizon —
    # the worker then dies at fail + k·period and wakes at wake + k·period
    # every orbit, so multi-orbit horizons run end-to-end
    fail_period: np.ndarray = None


class Constellation:
    def __init__(self, cfg: ConstellationConfig):
        self.cfg = cfg
        self.mesh = MeshTopology.grid(cfg.planes, cfg.sats_per_plane,
                                      torus=cfg.wraparound)

    # ------------------------------------------------------------------ #
    # Time-varying link latency
    # ------------------------------------------------------------------ #
    def interplane_tau(self, t: int, plane: int) -> float:
        """τ of the ISL between `plane` and `plane + 1` (mod planes) at t."""
        cfg = self.cfg
        phase = 2 * np.pi * (t / cfg.orbit_ticks) + np.pi * plane / cfg.planes
        return cfg.tau_base * (1.0 + cfg.interplane_amp * abs(np.sin(phase)))

    def intraplane_tau(self, t: int = 0) -> float:
        return float(self.cfg.tau_base)

    def mean_tau(self) -> float:
        """Orbit-average of the mixed link latency (2/π mean of |sin|)."""
        cfg = self.cfg
        inter = cfg.tau_base * (1.0 + cfg.interplane_amp * 2.0 / np.pi)
        # half the links are intra-plane (constant), half inter-plane
        return 0.5 * cfg.tau_base + 0.5 * inter

    def handover_cycle(self) -> int:
        """Ticks between successive cross-seam handovers: one in-plane slot."""
        return max(self.cfg.orbit_ticks // self.cfg.sats_per_plane, 2)

    def traffic_schedule(self, horizon_ticks: int, peak: float = 1.0,
                         trough: float = 0.25,
                         epochs_per_orbit: int | None = None):
        """Diurnal arrival-rate schedule: ``(rate_starts, rate_scale)`` for
        `arrivals.ArrivalConfig` — a raised-cosine swing between `peak`
        (day side, most ground stations in view) and `trough` (night side)
        once per orbit, sampled on the same `epochs_per_orbit` grid the
        link-state schedule uses so both piecewise-constant processes
        change on aligned boundaries."""
        cfg = self.cfg
        if not 0.0 <= trough <= peak <= 1.0:
            raise ValueError("need 0 <= trough <= peak <= 1 (Q16 rate scale)")
        epochs = epochs_per_orbit if epochs_per_orbit else cfg.epochs_per_orbit
        step = max(int(round(cfg.orbit_ticks / max(epochs, 1))), 1)
        starts = list(range(0, max(horizon_ticks, 1), step))
        phase = 2 * np.pi * np.asarray(starts) / cfg.orbit_ticks
        scale = trough + (peak - trough) * 0.5 * (1.0 + np.cos(phase))
        return tuple(starts), tuple(float(s) for s in scale)

    # ------------------------------------------------------------------ #
    # Outage / failure schedule
    # ------------------------------------------------------------------ #
    def schedule(self, horizon_ticks: int) -> Schedule:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        W = self.mesh.num_workers
        fail = -np.ones(W, np.int64)
        wake = -np.ones(W, np.int64)
        predictable = np.zeros(W, bool)

        # eclipse shutdowns: battery-limited satellites sleep when their
        # orbital slot enters shadow. Entry tick depends on the in-plane
        # position (cols spread around the orbit). Every predictable
        # shutdown keeps a full `warn_ticks` of lead time so the malleable
        # pre-shed window never starts before tick 0. The shadow ends
        # `eclipse_fraction` of an orbit later: exits inside the horizon
        # become wake-ups (the satellite rejoins the victim set and its
        # links come back up at the wake epoch).
        eclipse_len = max(int(round(cfg.eclipse_fraction * cfg.orbit_ticks)), 1)
        eclipse_len = min(eclipse_len, cfg.orbit_ticks - 1)
        n_weak = int(round(cfg.battery_limited_frac * W))
        weak = rng.choice(W, size=n_weak, replace=False) if n_weak else []
        period = -np.ones(W, np.int64)
        for w in weak:
            _, c = self.mesh.coords_of(int(w))
            slot_phase = c / cfg.sats_per_plane
            entry = int(((1.0 - slot_phase) % 1.0) * cfg.orbit_ticks)
            if entry == 0:
                entry = cfg.orbit_ticks
            entry = max(entry, cfg.warn_ticks + 1)
            if entry < horizon_ticks:
                fail[w] = entry
                predictable[w] = True
                exit_t = entry + eclipse_len
                if exit_t < horizon_ticks:
                    wake[w] = exit_t
                # the shadow recurs every orbit: emit the periodic form when
                # the second entry is still inside the horizon (the wake is
                # then always set — the exit precedes it by construction)
                if entry + cfg.orbit_ticks < horizon_ticks:
                    period[w] = cfg.orbit_ticks

        # radiation / hardware faults: Poisson per orbit
        if cfg.failure_rate > 0:
            lam = cfg.failure_rate * horizon_ticks / cfg.orbit_ticks
            for w in range(W):
                if predictable[w]:
                    continue
                if rng.random() < 1.0 - np.exp(-lam):
                    t = int(rng.integers(1, max(horizon_ticks, 2)))
                    fail[w] = t
        # keep the root worker (ground-station adjacent) up
        fail[0] = -1
        wake[0] = -1
        period[0] = -1
        predictable[0] = False

        fail = fail.astype(np.int32)
        wake = wake.astype(np.int32)
        period = period.astype(np.int32)
        speed = np.ones(W, np.int32)
        link = self.linkstate_schedule(horizon_ticks, fail, predictable, wake,
                                       period)
        return Schedule(fail_time=fail,
                        predictable=predictable,
                        speed=speed,
                        mean_hop_ticks=self.mean_tau(),
                        linkstate=link,
                        wake_time=wake,
                        fail_period=period)

    # ------------------------------------------------------------------ #
    # Link-state schedule compilation
    # ------------------------------------------------------------------ #
    def linkstate_schedule(self, horizon_ticks: int, fail_time: np.ndarray,
                           predictable: np.ndarray,
                           wake_time: np.ndarray | None = None,
                           fail_period: np.ndarray | None = None
                           ) -> lstate.LinkStateSchedule:
        """Compile the orbit into a piecewise-constant `LinkStateSchedule`.

        Epoch boundaries are the union of the uniform τ-oscillation sampling
        grid (`epochs_per_orbit` per orbit), each predictable shutdown's
        entry tick (its links go dark with it) and wake tick (its links
        come back up with it) — repeated at every `fail_period` cycle for
        periodic eclipse schedules — and, with `wraparound`, every seam
        handover on/off transition, so the piecewise-constant arrays change
        exactly where the modeled state does.
        """
        cfg = self.cfg
        mesh = self.mesh
        W = mesh.num_workers
        R, C = cfg.planes, cfg.sats_per_plane
        if wake_time is None:
            wake_time = -np.ones(W, np.int64)
        if fail_period is None:
            fail_period = -np.ones(W, np.int64)

        bounds = {0}
        step = max(int(round(cfg.orbit_ticks / max(cfg.epochs_per_orbit, 1))), 1)
        bounds.update(range(0, horizon_ticks, step))
        sleeps = predictable & (fail_time >= 0)
        for w in np.where(sleeps)[0]:
            reps = (range(1) if fail_period[w] <= 0 else
                    range(-(-(horizon_ticks - int(fail_time[w]))
                            // int(fail_period[w]))))
            for k in reps:
                off = k * int(fail_period[w]) if k else 0
                bounds.add(int(fail_time[w]) + off)
                if wake_time[w] >= 0:
                    bounds.add(int(wake_time[w]) + off)
        cycle = self.handover_cycle()
        dark_len = 0
        if cfg.wraparound and cfg.seam_outage_frac > 0:
            dark_len = min(max(int(round(cfg.seam_outage_frac * cycle)), 1),
                           cycle - 1)
            for k in range(0, horizon_ticks, cycle):
                bounds.update((k, k + dark_len))
        starts = np.asarray(sorted(b for b in bounds if 0 <= b < horizon_ticks),
                            np.int32)
        E = len(starts)
        rows = mesh.coords[:, 0]

        # inter-plane τ per boundary b (between plane b and b+1 mod R),
        # sampled at each epoch start — matches `interplane_tau`
        phase = (2 * np.pi * starts[:, None] / cfg.orbit_ticks
                 + np.pi * np.arange(R)[None, :] / R)           # (E, R)
        tau_b = np.maximum(np.rint(cfg.tau_base * (
            1.0 + cfg.interplane_amp * np.abs(np.sin(phase)))), 1).astype(np.int32)
        link_tau = np.full((E, W, 4), max(cfg.tau_base, 1), np.int32)
        link_tau[:, :, lstate.SOUTH] = tau_b[:, rows]
        link_tau[:, :, lstate.NORTH] = tau_b[:, (rows - 1) % R]

        # availability: a sleeping satellite's links are down from its entry
        # tick until its wake tick — eclipse exits bring them back up (both
        # endpoints see the predictable outage either way). Periodic
        # schedules sleep in [fail + kP, wake + kP) every cycle; the cycle
        # phase reduces to the plain interval comparison when P is unset.
        up = np.ones((E, W, 4), bool)
        ft = fail_time[None, :].astype(np.int64)
        wt = wake_time[None, :].astype(np.int64)
        pp = fail_period[None, :].astype(np.int64)
        rel = starts[:, None].astype(np.int64) - ft
        phase = np.where(pp > 0, rel % np.maximum(pp, 1), rel)
        dur = np.where(wt >= 0, wt - ft, np.int64(1) << 40)
        asleep = sleeps[None, :] & (rel >= 0) & (phase < dur)
        up &= ~asleep[:, :, None]
        nbr = mesh.neighbor_table
        nbr_c = np.clip(nbr, 0, W - 1)
        up &= ~(asleep[:, nbr_c] & (nbr >= 0)[None])
        if dark_len:
            dark = (starts % cycle) < dark_len                  # (E,)
            seam_n = rows == 0
            seam_s = rows == R - 1
            up[:, :, lstate.NORTH] &= ~(dark[:, None] & seam_n[None, :])
            up[:, :, lstate.SOUTH] &= ~(dark[:, None] & seam_s[None, :])

        speed = np.ones((E, W), np.int32)
        return lstate.LinkStateSchedule(
            epoch_starts=starts, link_tau=link_tau, link_up=up,
            speed=speed).validate(mesh)
