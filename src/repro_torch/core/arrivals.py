"""Open-loop arrival traffic: the request stream the simulator injects.

The counterpart of `repro.core.arrivals`. Ground stations inject user
requests into the constellation continuously, and what a user of an open
system reads is each strategy's load–latency curve (offered load against
sojourn percentiles), not a makespan. Candidate k of one global stream
fires at

    T_k = T_{k-1} + gap_k,   gap_k = max(1, round(-ln(u_k) · gap/256))

with ``gap`` the mean gap in ticks × 256 (`SimParams.arrival_gap_q8`, per
point, so an offered-load sweep is one grid) and u_k a hash of (seed, k)
(`tasks._hash2`, the mixer UTS uses). Everything about candidate k — its
gap, its acceptance, its station — is a pure function of k and the run's
seed, never of how the simulator reached T_k: the next candidate's tick is
a horizon the leap and famine windows clip at, and tick and leap mode stay
equal. The log is `f32math.log_f32`, the reference's float32 `log` bit for
bit (a gap one ulp off moves every later candidate).

A candidate is thinned by data (`ArrivalArrays`): a per-epoch Q16 rate
gate (its own `rate_starts`, read by `linkstate.epoch_index`) and an
on/off burst window (``on = off = 0``: always on, plain Poisson). An
accepted candidate injects `SimParams.arrival_batch` (≤ `ARRIVAL_K`)
records ``[tasks.KIND_REQ, cost, inject_tick, task_id]`` at its station,
a worker drawn from a CDF of Zipf weights over shuffled station ranks; the
sojourn ledger prices a request when it is popped.

uint32 hashing is carried in int64 values in [0, 2^32), as in `tasks`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import linkstate as lstate
from . import tasks
from .f32math import log_f32

# most request records injected per accepted candidate (the injection's lane
# width; `SimParams.arrival_batch` selects 1..ARRIVAL_K)
ARRIVAL_K = 8

# Q16 acceptance scale: rate_q16 == RATE_ONE accepts every candidate
RATE_ONE = 1 << 16

# substream salts: gap, acceptance and station draws come from decorrelated
# hash streams of the same run seed
_SALT_SEED = 0x4F50454E    # "OPEN"
_SALT_GAP = 0x41525231
_SALT_ACCEPT = 0x41525232
_SALT_STATION = 0x41525233

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class ArrivalConfig:
    """The shape of the traffic, on the host (the offered load is the
    per-point `SimParams.arrival_gap_q8` / `arrival_batch` pair).

    ``num_stations = 0`` makes every worker a ground station; otherwise
    `num_stations` workers are picked by `station_seed`. ``zipf_s`` skews
    the stations' weights (0: uniform). ``on_ticks``/``off_ticks`` gate
    candidates through a periodic burst window (both 0: always on).
    ``rate_starts``/``rate_scale`` is a piecewise-constant acceptance
    schedule (fractions of the base rate in [0, 1]; default 1.0 always)."""
    task_cost: int = 16
    num_stations: int = 0
    zipf_s: float = 0.0
    station_seed: int = 0
    on_ticks: int = 0
    off_ticks: int = 0
    rate_starts: tuple = ()
    rate_scale: tuple = ()

    def validate(self) -> "ArrivalConfig":
        if self.task_cost < 1:
            raise ValueError("arrival task_cost must be >= 1")
        if self.num_stations < 0:
            raise ValueError("num_stations must be >= 0 (0 = all workers)")
        if self.zipf_s < 0:
            raise ValueError("zipf_s must be >= 0")
        if self.on_ticks < 0 or self.off_ticks < 0:
            raise ValueError("on_ticks/off_ticks must be >= 0")
        if self.off_ticks > 0 and self.on_ticks == 0:
            raise ValueError(
                "off_ticks > 0 with on_ticks == 0 would accept nothing; "
                "set on_ticks >= 1 (or both 0 for an always-on process)")
        rs, sc = list(self.rate_starts), list(self.rate_scale)
        if len(rs) != len(sc):
            raise ValueError("rate_starts and rate_scale must have equal length")
        if rs:
            if rs[0] != 0:
                raise ValueError("rate_starts must begin at tick 0")
            if any(b <= a for a, b in zip(rs, rs[1:])):
                raise ValueError("rate_starts must be strictly increasing")
            if any(not 0.0 <= s <= 1.0 for s in sc):
                raise ValueError("rate_scale entries must lie in [0, 1]")
        return self


class ArrivalArrays(NamedTuple):
    """An `ArrivalConfig` on a device: int32 tensors."""
    station_cdf: torch.Tensor   # (W,) inclusive cumulative station weights
    rate_starts: torch.Tensor   # (E,) epoch boundaries of the rate schedule
    rate_q16: torch.Tensor      # (E,) acceptance scale, RATE_ONE = 1.0
    on_ticks: torch.Tensor      # () burst-on window length
    cycle_ticks: torch.Tensor   # () on + off cycle length (0: always on)
    task_cost: torch.Tensor     # () work units per injected request


def station_weights(acfg: ArrivalConfig, num_workers: int) -> np.ndarray:
    """(W,) int64 station weights: Zipf over shuffled station ranks, zero
    for workers that are no station. Deterministic in `station_seed`."""
    W = num_workers
    ns = acfg.num_stations if acfg.num_stations > 0 else W
    if ns > W:
        raise ValueError(f"num_stations {ns} exceeds num_workers {W}")
    rng = np.random.default_rng(acfg.station_seed)
    stations = (np.arange(W) if ns == W
                else np.sort(rng.choice(W, size=ns, replace=False)))
    ranks = rng.permutation(ns)  # which station is the hot one
    w = np.maximum(np.round(65536.0 / np.power(ranks + 1.0, acfg.zipf_s)), 1.0)
    weights = np.zeros(W, np.int64)
    weights[stations] = w.astype(np.int64)
    return weights


def device_tables(acfg: ArrivalConfig, mesh, device="cpu") -> ArrivalArrays:
    """The tables of `acfg` for `mesh` on `device` (validated on the host)."""
    acfg.validate()
    cdf = np.cumsum(station_weights(acfg, mesh.num_workers))
    if cdf[-1] >= 2**31:
        raise ValueError("total station weight must stay below 2**31")
    if acfg.rate_starts:
        rs = np.asarray(acfg.rate_starts, np.int32)
        rq = np.round(np.asarray(acfg.rate_scale, np.float64)
                      * RATE_ONE).astype(np.int32)
    else:
        rs = np.zeros(1, np.int32)
        rq = np.full(1, RATE_ONE, np.int32)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)
    return ArrivalArrays(station_cdf=t(cdf), rate_starts=t(rs), rate_q16=t(rq),
                         on_ticks=t(acfg.on_ticks),
                         cycle_ticks=t(acfg.on_ticks + acfg.off_ticks),
                         task_cost=t(acfg.task_cost))


def to_device(ar: ArrivalArrays, device) -> ArrivalArrays:
    """`ar` with every tensor on `device` as int32 (no copy where it is)."""
    return ArrivalArrays(*(torch.as_tensor(x).to(device=device, dtype=_I32) for x in ar))


# --------------------------------------------------------------------------- #
# The candidate stream: pure functions of (seed, k)
# --------------------------------------------------------------------------- #
def stream_seed(seed):
    """The arrival stream's seed, decorrelated from the victim draws: a
    hash of the run seed (int64 in [0, 2^32), `seed`'s shape)."""
    return tasks._hash2(seed, _SALT_SEED)


def _stream_u32(aseed, salt: int, k):
    return tasks._hash2(tasks._hash2(aseed, salt), k)


def substreams(aseed) -> torch.Tensor:
    """The gap, acceptance and station substream seeds of the stream seed
    `aseed` (a tensor), stacked on a new last axis (int64 in [0, 2^32)).
    Candidate k's three draws are then one hash of these against k:
    ``tasks._hash2(substreams(aseed), k)``, read by the ``*_of_draw``
    functions."""
    salts = torch.tensor([_SALT_GAP, _SALT_ACCEPT, _SALT_STATION], device=aseed.device)
    return tasks._hash2(aseed[..., None], salts)


def gap_of_draw(h, gap_q8) -> torch.Tensor:
    """The gap of a candidate whose gap draw is `h`: an exponential variate
    of mean ``gap_q8 / 256`` ticks, rounded half to even and floored at 1
    (at most one candidate a tick), in the reference's float32 order."""
    u = (h.to(torch.float32) + 1.0) * 2.0**-32                      # (0, 1]
    gap = torch.as_tensor(gap_q8, device=u.device).to(torch.float32)
    g = -log_f32(u) * gap * (1 / 256)
    return torch.round(g).clamp(1.0, float(1 << 29)).to(_I32)


def accepted_of_draw(ar: ArrivalArrays, h, t) -> torch.Tensor:
    """Thinning of a candidate whose acceptance draw is `h`, at its fire
    tick t: the rate gate of t's epoch and the burst window."""
    u16 = (h & 0xFFFF).to(_I32)
    t = torch.as_tensor(t, device=ar.rate_q16.device)
    thin_ok = u16 < ar.rate_q16[lstate.epoch_index(ar.rate_starts, t).long()]
    cyc = ar.cycle_ticks.clamp(min=1)
    return thin_ok & ((ar.cycle_ticks <= 0) | (torch.remainder(t, cyc) < ar.on_ticks))


def station_of_draw(ar: ArrivalArrays, h) -> torch.Tensor:
    """The ground station of a candidate whose station draw is `h`: the CDF
    of the station weights inverted at a modulo draw."""
    r = torch.remainder(h, ar.station_cdf[-1].to(torch.int64)).to(_I32)
    return torch.searchsorted(ar.station_cdf, r, right=True).to(_I32)


def gap_ticks(aseed, k, gap_q8) -> torch.Tensor:
    """The gap before candidate k (int32, the broadcast shape)."""
    return gap_of_draw(_stream_u32(aseed, _SALT_GAP, k), gap_q8)


def accepted(ar: ArrivalArrays, aseed, k, t) -> torch.Tensor:
    """Thinning of candidate k at its fire tick t (bool)."""
    return accepted_of_draw(ar, _stream_u32(aseed, _SALT_ACCEPT, k), t)


def station_of(ar: ArrivalArrays, aseed, k) -> torch.Tensor:
    """The ground station (worker id) of candidate k (int32)."""
    return station_of_draw(ar, _stream_u32(aseed, _SALT_STATION, k))


# --------------------------------------------------------------------------- #
# Load and gap, and the host replay of the stream
# --------------------------------------------------------------------------- #
def gap_q8_for_load(load_per_tick: float, batch: int = 1) -> int:
    """`SimParams.arrival_gap_q8` of an offered load in accepted tasks a
    tick (before thinning): a mean gap of batch / load ticks."""
    if load_per_tick <= 0:
        raise ValueError("offered load must be positive")
    return max(int(round(256.0 * batch / load_per_tick)), 1)


def offered_load(gap_q8: int, batch: int = 1) -> float:
    """Offered load (tasks a tick, before thinning) of a gap/batch pair."""
    return 256.0 * batch / gap_q8 if gap_q8 > 0 else 0.0


def host_arrival_schedule(seed: int, gap_q8: int, ar: ArrivalArrays,
                          max_ticks: int, block: int = 4096):
    """The candidate stream up to `max_ticks`, replayed through the stream
    functions above `block` candidates at a time: (ticks, stations,
    accepted) numpy arrays, one entry per candidate."""
    dev = ar.station_cdf.device
    aseed = stream_seed(torch.tensor(int(seed), dtype=torch.int64, device=dev))
    gap = torch.tensor(int(gap_q8), dtype=_I32, device=dev)
    out, t0, k0 = [], 0, 0
    while t0 < max_ticks:
        k = torch.arange(k0, k0 + block, device=dev)
        ticks = t0 + torch.cumsum(gap_ticks(aseed, k, gap).to(torch.int64), 0)
        n = int((ticks < max_ticks).sum())   # gaps >= 1: a prefix
        k, ticks = k[:n], ticks[:n]
        out.append((ticks, station_of(ar, aseed, k), accepted(ar, aseed, k, ticks)))
        t0 = int(ticks[-1]) if n == block else max_ticks
        k0 += block
    ticks, stations, acc = (torch.cat(x).cpu().numpy() for x in zip(*out))
    return ticks.astype(np.int64), stations.astype(np.int64), acc.astype(bool)
