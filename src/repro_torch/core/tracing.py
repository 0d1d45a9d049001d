"""Flight recorder: on-device steal-attempt tracing + binned time series.

The simulator's end-of-run scalars (`attempts`, `successes`, total wait
ticks) say *how much* stealing happened, never *when* famine hit, *which*
links priced an attempt, or how imbalance evolved across eclipse / seam
epochs — yet per-attempt steal latency is the paper's central quantity
(§3.3 Eq. 1 prices a strategy by the distribution of attempt round trips).
This module records both views inside the simulator's run loop, on the
device, for every point of a grid at once (a leading axis G, as every
state leaf of the simulator has):

  * an **event ring** — a fixed-capacity buffer of int32 lanes
    ``(tick, kind, worker, victim, hops, rtt_ticks, epoch)`` capturing every
    steal attempt with an outcome code plus the lifecycle events around
    them (deaths, wake-ups, link-state epoch flips, famine-window
    enter/exit, overflow drops). The emit counter `n` is monotonic and
    counts every event *including* the ones a full ring rejects, so
    ``dropped = max(n - capacity, 0)`` — truncation is never silent, and
    the drop counter is the ring-sizing guidance (re-run with a bigger
    ring until it reads 0). The ring has one row more than its capacity:
    writes past capacity (and the rows of candidates that emit nothing)
    land there, since a torch scatter has no "drop" mode; that row is never
    read back;
  * a **binned time series** — a ``(bins, NUM_CHANNELS)`` scatter-add of
    per-interval busy worker-ticks, end-of-tick total queue depth,
    in-flight flight-ticks, attempts, successes, and alive worker-ticks
    (the busy-fraction denominator).

Both are written in place (a scatter into the ring, a scatter-add into the
time series), each point's writes masked by its flag `run`: a point that
has stopped keeps its ring and bins as its own run left them, and the run
loop has no ring to copy or mask afterwards.

Leap ≡ tick trace equality
--------------------------
``step_mode="leap"`` emits the **same trace** as the one-tick stepper —
elementwise on the ring — and the same trace as the reference simulator
(`repro.core.simulator` with `repro.core.tracing`). Every emitting tick is
an event tick the leap stepper executes with the full tick; the famine fast
path re-emits the failed-attempt events of the ticks it collapses
(unreachable draws, empty-victim and severed-denial arrivals) with identical
lane values, in the order the ticks would have emitted them; an
unreachable-draw event (`EV_NO_LIVE_VICTIM`) is emitted only for workers
that *could* attempt under the current link state; time-series bins join
the leap horizons, so each window's bulk contribution lands in one bin.

Per-tick emission order (fixed, so rings compare elementwise): DEATH,
WAKE, EPOCH, NO_LIVE_VICTIM, ARRIVAL, SOJOURN, attempt resolutions
(SEVERED / EMPTY / GRANTED), OVERFLOW, FAMINE_ENTER / FAMINE_EXIT. After
the loop, attempts still in their request flight emit one `EV_PENDING`
each. Under `Recovery.TC` the trace does not roll back with the snapshot:
the timeline keeps both the discarded and the replayed attempts, and a
rollback tick can contribute negative busy/attempt deltas to its bin.

``SimConfig.trace`` is branched on the host: with ``trace=None`` the
simulator never calls into this module.

The schema, `TraceConfig` and the host views are the reference's; the
device side is written in PyTorch operations (an append is one exclusive
cumulative sum and one scatter; the simulator appends each tick's and each
famine window's candidates as one `Block`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import jsonio
from . import latency
from . import stealing

# --------------------------------------------------------------------------- #
# Event schema
# --------------------------------------------------------------------------- #
# Steal-attempt outcome codes (one event per attempt, stamped at the tick
# the outcome is decided):
EV_NO_LIVE_VICTIM = 0   # drawn victim has no live route (other component):
                        # the flight never departs, no attempt is counted.
                        # Stamped at the draw tick; rtt = 0.
EV_EMPTY_VICTIM = 1     # request arrived, victim alive & reachable, but its
                        # deque was empty (or the per-round grant budget was
                        # exhausted). Stamped at the arrival tick.
EV_SEVERED_DENIAL = 2   # request arrived but no grant is possible: the
                        # victim died, or an epoch flip severed the reply
                        # path mid-flight (the thief waits out the nominal
                        # RTT as a timeout). Stamped at the arrival tick.
EV_GRANTED = 3          # request arrived and a bottom task was granted.
                        # Stamped at the arrival tick.
EV_PENDING = 4          # attempt still in its request flight when the run
                        # ended (counted in `attempts`, outcome unknown);
                        # rtt lane holds the request leg only.
# Lifecycle events (worker = the subject, victim = -1 unless noted):
EV_DEATH = 5            # scheduled failure / shutdown fired
EV_WAKE = 6             # eclipse exit: dead worker rejoined
EV_EPOCH = 7            # link-state epoch flip (worker = -1, epoch = new)
EV_FAMINE_ENTER = 8     # total stealable supply hit 0 (worker = -1)
EV_FAMINE_EXIT = 9      # supply became nonzero again (worker = -1)
EV_OVERFLOW = 10        # worker's deque rejected pushes this tick;
                        # rtt lane = number of records dropped
# Open-loop traffic events: together they form the per-task sojourn ledger
# — ARRIVAL stamps injection, SOJOURN stamps completion with the priced
# sojourn in the rtt lane.
EV_ARRIVAL = 11         # request injected at a ground station
                        # (worker = station, hops = task_id, rtt = 0)
EV_SOJOURN = 12         # request popped & served: rtt lane = sojourn ticks
                        # (pop_tick - inject_tick + service cost),
                        # victim = inject tick, hops = task_id

NUM_KINDS = 13
KIND_NAMES = {
    EV_NO_LIVE_VICTIM: "no_live_victim",
    EV_EMPTY_VICTIM: "empty_victim",
    EV_SEVERED_DENIAL: "severed_denial",
    EV_GRANTED: "granted",
    EV_PENDING: "pending",
    EV_DEATH: "death",
    EV_WAKE: "wake",
    EV_EPOCH: "epoch",
    EV_FAMINE_ENTER: "famine_enter",
    EV_FAMINE_EXIT: "famine_exit",
    EV_OVERFLOW: "overflow",
    EV_ARRIVAL: "arrival",
    EV_SOJOURN: "sojourn",
}
# attempt-kind events: one per steal attempt the thief resolved (or left
# pending); NO_LIVE_VICTIM draws never departed, so they are *not* part of
# the `attempts` counter reconciliation
RESOLVED_ATTEMPT_KINDS = (EV_EMPTY_VICTIM, EV_SEVERED_DENIAL, EV_GRANTED)
ATTEMPT_KINDS = RESOLVED_ATTEMPT_KINDS + (EV_PENDING,)

# Ring lanes (columns of the (capacity, NUM_LANES) int32 buffer)
LANE_TICK = 0
LANE_KIND = 1
LANE_WORKER = 2   # the acting worker (thief for attempts)
LANE_VICTIM = 3   # attempt victim; -1 for lifecycle events
LANE_HOPS = 4     # nominal thief↔victim Manhattan hops (one-way); for
                  # EV_OVERFLOW: 0
LANE_RTT = 5      # priced round-trip ticks (request + response leg, incl.
                  # route-around detours); EV_OVERFLOW: records dropped
LANE_EPOCH = 6    # link-state epoch index at the stamp tick (0 if static)
NUM_LANES = 7

# Time-series channels
CH_BUSY = 0        # busy worker-ticks (burn or expand) per bin
CH_QUEUE = 1       # sum over ticks of end-of-tick total queue depth
CH_INFLIGHT = 2    # worker-ticks spent in REQ/RESP flights per bin
CH_ATTEMPTS = 3    # steal attempts launched per bin
CH_SUCCESSES = 4   # granted-loot deliveries per bin
CH_ALIVE = 5       # alive worker-ticks per bin (busy-fraction denominator)
NUM_CHANNELS = 6
CHANNEL_NAMES = ("busy", "queue_depth", "inflight", "attempts", "successes",
                 "alive")

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Static flight-recorder shape. `ring_capacity` bounds the event ring —
    size it from the reported drop counter (0 drops = complete trace).
    `bins` × `bin_ticks` is the covered horizon; later ticks clamp into the
    last bin (int32 channels: keep `bin_ticks · W · capacity` < 2^31 so the
    queue-depth channel cannot wrap)."""
    ring_capacity: int = 4096
    bins: int = 256
    bin_ticks: int = 64

    def validate(self) -> "TraceConfig":
        if self.ring_capacity <= 0:
            raise ValueError("trace ring_capacity must be positive")
        if self.bins <= 0 or self.bin_ticks <= 0:
            raise ValueError("trace bins and bin_ticks must be positive")
        return self


class TraceState(NamedTuple):
    """Device-side recorder state of a grid of G points, threaded through
    the simulator loop OUTSIDE `SimState`, so TC snapshots never roll it
    back."""
    ev: torch.Tensor         # (G, ring_capacity + 1, NUM_LANES) int32 event
                             # ring; the last row takes the writes that are
                             # dropped and is never read
    n: torch.Tensor          # (G, 1) int32 events emitted, incl. dropped ones
    req_ticks: torch.Tensor  # (G, W) int32 request-leg flight ticks of each
                             # worker's in-flight attempt (for the rtt lane)
    ts: torch.Tensor         # (G, bins, NUM_CHANNELS) int32 time series
    famine: torch.Tensor     # (G, 1) bool end-of-tick famine flag (supply == 0)


def init(tcfg: TraceConfig, num_workers: int, famine0: torch.Tensor) -> TraceState:
    """A fresh recorder for the grid whose per-point famine flags at tick 0
    are `famine0` ((G, 1) bool)."""
    G, dev = famine0.shape[0], famine0.device
    return TraceState(
        ev=torch.full((G, tcfg.ring_capacity + 1, NUM_LANES), -1, dtype=_I32, device=dev),
        n=torch.zeros((G, 1), dtype=_I32, device=dev),
        req_ticks=torch.zeros((G, num_workers), dtype=_I32, device=dev),
        ts=torch.zeros((G, tcfg.bins, NUM_CHANNELS), dtype=_I32, device=dev),
        famine=famine0.to(torch.bool).clone())


def _lane(x, shape, device) -> torch.Tensor:
    """A lane value (an int, or a tensor broadcastable to `shape`) as an
    int32 tensor of `shape` (a broadcast view where it can be one)."""
    if not isinstance(x, torch.Tensor):
        x = torch.full((), int(x), dtype=_I32, device=device)  # a fill: no copy
    return x.to(_I32).expand(shape)


def append(ev: torch.Tensor, n: torch.Tensor, capacity: int, mask: torch.Tensor,
           rows: torch.Tensor, rank: torch.Tensor | None = None) -> torch.Tensor:
    """The core append: one event per True entry of `mask` ((G, K)), the
    rows `rows` ((G, K, NUM_LANES) int32), written in place into `ev` at
    slot ``n + rank`` — `rank` the entry's exclusive rank among the set
    entries of its point (None: their order along K). Entries whose slot is
    past `capacity`, and unset ones, are routed to the ring's last row.
    Returns the new counter ``n + Σ mask``."""
    m32 = mask.to(_I32)
    if rank is None:
        rank = torch.cumsum(m32, 1, dtype=_I32) - m32
    slot = n + rank
    idx = torch.where(mask & (slot < capacity), slot, capacity)
    ev.scatter_(1, idx.long()[..., None].expand(rows.shape), rows)
    return n + m32.sum(1, keepdim=True, dtype=_I32)


def emit_raw(ev, n, capacity: int, mask, *, tick, kind, worker, victim,
             hops=0, rtt=0, epoch=0):
    """Append one event per True entry of `mask` ((G, K), entry order) to the
    bare (ring, counter) pair, in place; returns (ev, new counter). Events
    past `capacity` are counted but not written. The lanes are ints or
    tensors broadcastable to (G, K)."""
    mask = torch.as_tensor(mask, device=ev.device).to(torch.bool)
    lanes = (tick, kind, worker, victim, hops, rtt, epoch)
    rows = torch.stack([_lane(x, mask.shape, ev.device) for x in lanes], -1)
    return ev, append(ev, n, capacity, mask, rows)


def emit(tr: TraceState, tcfg: TraceConfig, mask, *, tick, kind, worker,
         victim, hops=0, rtt=0, epoch=0) -> TraceState:
    """Append one event per True entry of `mask` ((G, K)), bumping the
    monotonic counter (drops counted, never silent)."""
    ev, n = emit_raw(tr.ev, tr.n, tcfg.ring_capacity, mask, tick=tick, kind=kind,
                     worker=worker, victim=victim, hops=hops, rtt=rtt, epoch=epoch)
    return tr._replace(ev=ev, n=n)


def emit1(tr: TraceState, tcfg: TraceConfig, pred, *, tick, kind,
          worker=-1, victim=-1, hops=0, rtt=0, epoch=0) -> TraceState:
    """Append a single global event per point where `pred` ((G, 1)) holds
    (epoch flips, famine transitions)."""
    return emit(tr, tcfg, pred, tick=tick, kind=kind, worker=worker,
                victim=victim, hops=hops, rtt=rtt, epoch=epoch)


class Block:
    """A fixed layout of candidate events appended as one block every loop
    iteration (one cumulative sum, one scatter): groups of k candidates in a
    fixed order, each with lanes that never change (written once, here)
    and lanes that `set` writes each time. The rows live in one buffer for
    the whole run, so a captured CUDA graph writes the same memory at every
    replay and no lane is rebuilt from constants. `groups` is a sequence of
    (k, {lane: int or (k,) tensor}) of the constant lanes."""

    def __init__(self, G: int, groups, device):
        K = sum(k for k, _ in groups)
        self.rows = torch.zeros((G, K, NUM_LANES), dtype=_I32, device=device)
        self.spans, off = [], 0
        for k, consts in groups:
            for lane, v in consts.items():
                self.rows[:, off:off + k, lane] = v
            self.spans.append((off, off + k))
            off += k

    def set(self, lane: int, value, group: int | None = None, shape=None) -> None:
        """Write `value` (broadcast to the span, seen as (G, *shape) when
        `shape` is given) into `lane` of one group's candidates, or of every
        candidate when `group` is None."""
        a, b = (0, self.rows.shape[1]) if group is None else self.spans[group]
        dst = self.rows[:, a:b, lane]
        if shape is not None:
            dst = dst.view(dst.shape[0], *shape)
        if isinstance(value, torch.Tensor):
            dst.copy_(value)
        else:
            dst.fill_(value)

    def append(self, tr: TraceState, tcfg: TraceConfig, masks, run=None,
               rank=None) -> TraceState:
        """Append the candidates whose entry of `masks` (one (G, k) or (G, 1)
        bool a group, in order; or one (G, K) mask) is set, at the points
        whose flag `run` is set; `rank` as in `append`."""
        mask = masks if isinstance(masks, torch.Tensor) else torch.cat(
            [m.expand(m.shape[0], b - a) for m, (a, b) in zip(masks, self.spans)], 1)
        if run is not None:
            mask = mask & run
        return tr._replace(n=append(tr.ev, tr.n, tcfg.ring_capacity, mask, self.rows, rank))


def ts_add(tr: TraceState, tcfg: TraceConfig, t, *, busy, queue, inflight,
           attempts, successes, alive, run=None) -> TraceState:
    """Scatter-add one contribution per point into the bin containing its
    tick `t` ((G, 1)), in place. The values are (G, 1) integer columns (or
    ints), taken modulo 2^32 as int32 sums wrap; only points whose flag
    `run` is set add. The simulator guarantees every bulk window lies inside
    one bin (bin boundaries are leap horizons), so callers pass whole-window
    sums."""
    G, dev = tr.n.shape[0], tr.n.device
    row = torch.cat([_lane(x, (G, 1), dev) if not isinstance(x, torch.Tensor)
                     else x.expand(G, 1)
                     for x in (busy, queue, inflight, attempts, successes, alive)], 1)
    return ts_add_row(tr, tcfg, t, row, run)


def ts_add_row(tr: TraceState, tcfg: TraceConfig, t, row: torch.Tensor,
               run=None) -> TraceState:
    """`ts_add` of a whole (G, NUM_CHANNELS) integer row, channels in
    `CHANNEL_NAMES` order (int64 sums wrap to int32 here)."""
    G = tr.n.shape[0]
    b = torch.clamp(torch.div(t, tcfg.bin_ticks, rounding_mode="floor"),
                    max=tcfg.bins - 1)
    row = row.to(_I32)
    if run is not None:
        row = row * run
    tr.ts.scatter_add_(1, b.long()[..., None].expand(G, 1, NUM_CHANNELS),
                       row[:, None, :])
    return tr


def next_bin_boundary(tcfg: TraceConfig, t, never):
    """First bin boundary > t, or `never` once every later tick clamps into
    the last bin (no more horizons needed). Leap and famine windows clip
    here so window contributions stay within one bin."""
    bt = tcfg.bin_ticks
    nb = (torch.div(t, bt, rounding_mode="floor") + 1) * bt
    return torch.where(nb <= (tcfg.bins - 1) * bt, nb, never)


# --------------------------------------------------------------------------- #
# Host-side views
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Trace:
    """Finalized event ring: `events` is the (n_written, NUM_LANES) int32
    array in emission order; `emitted` counts every event including the
    `dropped` ones a full ring rejected (size the ring until dropped == 0)."""
    events: np.ndarray
    emitted: int
    dropped: int
    ring_capacity: int

    def lane(self, lane: int) -> np.ndarray:
        return self.events[:, lane]

    def of_kind(self, *kinds: int) -> np.ndarray:
        sel = np.isin(self.events[:, LANE_KIND], kinds)
        return self.events[sel]

    def counts(self) -> dict[str, int]:
        k = self.events[:, LANE_KIND]
        return {name: int((k == kind).sum())
                for kind, name in KIND_NAMES.items()}


@dataclasses.dataclass(frozen=True)
class TimeSeries:
    """Finalized (bins, NUM_CHANNELS) time series (int64 host copy)."""
    data: np.ndarray
    bin_ticks: int

    def channel(self, ch: int) -> np.ndarray:
        return self.data[:, ch]

    def busy_fraction(self) -> np.ndarray:
        alive = np.maximum(self.data[:, CH_ALIVE], 1)
        return self.data[:, CH_BUSY] / alive

    def mean_queue_depth(self) -> np.ndarray:
        """Per-bin mean end-of-tick total queue depth. The queue channel
        sums one constellation-wide total per simulated tick; dividing by
        `bin_ticks` gives the per-tick mean (edge bins of a run that ends
        mid-bin read proportionally low)."""
        return self.data[:, CH_QUEUE] / float(self.bin_ticks)


def finalize(tr, tcfg: TraceConfig) -> tuple[Trace, TimeSeries]:
    """Build host-side views from ONE point's recorder state (its `ev` ring,
    with or without the dump row, its counter `n` and its `ts`), fetched to
    the host."""
    emitted = int(tr.n)
    written = min(emitted, tcfg.ring_capacity)
    events = np.asarray(tr.ev)[:written]
    return (Trace(events=events, emitted=emitted,
                  dropped=max(emitted - tcfg.ring_capacity, 0),
                  ring_capacity=tcfg.ring_capacity),
            TimeSeries(data=np.asarray(tr.ts, np.int64),
                       bin_ticks=tcfg.bin_ticks))


# --------------------------------------------------------------------------- #
# Perfetto / Chrome-trace export
# --------------------------------------------------------------------------- #
def to_chrome_trace(trace: Trace, *, mesh_rows: int, mesh_cols: int,
                    row_block: int = 1,
                    timeseries: TimeSeries | None = None,
                    tick_us: float = 1.0) -> dict:
    """Render the ring as Chrome-trace JSON (load in Perfetto / chrome://
    tracing). One process ("track") per block of `row_block` mesh rows with
    one thread per worker, a separate process for link-state epochs, and —
    when `timeseries` is given — counter tracks for busy fraction, queue
    depth, and in-flight flights. Attempt events draw as complete spans at
    their resolution tick with the priced round trip as the duration;
    lifecycle events draw as instants. One simulated tick maps to
    `tick_us` microseconds of trace time."""
    ev = trace.events
    out: list[dict] = []
    pid_of = lambda w: 1 + (w // mesh_cols) // max(row_block, 1)  # noqa: E731
    seen_pids: set[int] = set()

    def meta(pid, tid, name, kind):
        out.append(dict(ph="M", pid=pid, tid=tid, name=kind,
                        args=dict(name=name)))

    for row in ev:
        t, kind, w, v, hops, rtt, ep = (int(x) for x in row)
        ts = t * tick_us
        if kind in (EV_EPOCH, EV_FAMINE_ENTER, EV_FAMINE_EXIT):
            out.append(dict(ph="i", pid=0, tid=0, ts=ts, s="g",
                            name=KIND_NAMES[kind], args=dict(epoch=ep)))
            continue
        pid = pid_of(w)
        if pid not in seen_pids:
            seen_pids.add(pid)
            blk = (w // mesh_cols) // max(row_block, 1)
            meta(pid, 0, f"mesh rows {blk * row_block}-"
                         f"{min((blk + 1) * row_block, mesh_rows) - 1}",
                 "process_name")
        if kind in ATTEMPT_KINDS:
            # span ends at the stamp (resolution) tick: start it rtt ago
            dur = max(rtt, 1) * tick_us
            out.append(dict(ph="X", pid=pid, tid=w, ts=ts - dur, dur=dur,
                            name=f"steal:{KIND_NAMES[kind]}",
                            args=dict(victim=v, hops=hops, rtt_ticks=rtt,
                                      epoch=ep)))
        else:
            out.append(dict(ph="i", pid=pid, tid=w, ts=ts, s="t",
                            name=KIND_NAMES[kind],
                            args=dict(epoch=ep, count=rtt)))
    # link-state epoch track: spans between consecutive flips
    flips = [(int(r[LANE_TICK]), int(r[LANE_EPOCH]))
             for r in ev if int(r[LANE_KIND]) == EV_EPOCH]
    meta(0, 0, "link-state epochs / constellation", "process_name")
    for i, (t, ep) in enumerate(flips):
        end = flips[i + 1][0] if i + 1 < len(flips) else t
        out.append(dict(ph="X", pid=0, tid=1, ts=t * tick_us,
                        dur=max(end - t, 1) * tick_us, name=f"epoch {ep}"))
    if timeseries is not None:
        bt = timeseries.bin_ticks
        frac = timeseries.busy_fraction()
        for b in range(timeseries.data.shape[0]):
            ts = b * bt * tick_us
            out.append(dict(ph="C", pid=0, tid=0, ts=ts, name="busy_fraction",
                            args=dict(value=float(frac[b]))))
            out.append(dict(ph="C", pid=0, tid=0, ts=ts, name="queue_depth",
                            args=dict(value=int(timeseries.data[b, CH_QUEUE])
                                      // max(bt, 1))))
            out.append(dict(ph="C", pid=0, tid=0, ts=ts, name="inflight",
                            args=dict(value=int(
                                timeseries.data[b, CH_INFLIGHT]) // max(bt, 1))))
    return dict(traceEvents=out, displayTimeUnit="ms",
                otherData=dict(emitted=trace.emitted, dropped=trace.dropped,
                               ring_capacity=trace.ring_capacity))


def write_chrome_trace(path: str, trace: Trace, **kw) -> None:
    jsonio.write(path, to_chrome_trace(trace, **kw))


# --------------------------------------------------------------------------- #
# Measured attempt-latency histogram vs the paper's analytic model
# --------------------------------------------------------------------------- #
def analytic_round_trip(strategy, num_workers: int, tau: float) -> float:
    """The §3.3 expected per-attempt round trip in tick currency: 2τ for
    neighbor-only strategies (ADAPTIVE's un-escalated steady state),
    (4/3)·√N·τ for GLOBAL's uniform multi-hop draw."""
    if strategy == stealing.Strategy.GLOBAL:
        return float(latency.global_round_trip(num_workers, tau))
    return float(latency.neighbor_round_trip(tau))


def attempt_latency_hist(trace: Trace, *, strategy, num_workers: int,
                         tau: float, bins: int = 32) -> dict:
    """Per-attempt RTT histogram of every resolved attempt in the ring,
    with the `core/latency.py` analytic expectation as the overlay — the
    direct, measured check of the paper's model (Eq. 1) inside a run.

    Returns a plain dict (JSON-ready): histogram counts/edges, measured
    mean RTT and per-attempt success probability, the analytic expected
    RTT for `strategy`, and both the measured and analytic expected
    time-to-task E[T] = RTT / p."""
    res = trace.of_kind(*RESOLVED_ATTEMPT_KINDS)
    rtt = res[:, LANE_RTT].astype(np.float64)
    granted = int((res[:, LANE_KIND] == EV_GRANTED).sum())
    n = int(res.shape[0])
    p = granted / n if n else 0.0
    a_rtt = analytic_round_trip(strategy, num_workers, tau)
    if n:
        hi = max(float(rtt.max()), a_rtt, 1.0)
        counts, edges = np.histogram(rtt, bins=bins, range=(0.0, hi))
        measured_mean = float(rtt.mean())
    else:
        counts, edges = np.zeros(bins, np.int64), np.linspace(0, 1, bins + 1)
        measured_mean = 0.0
    strat_name = getattr(strategy, "value", str(strategy))
    # E[T] = RTT / p is exactly inf at p == 0 (the analytic model's honest
    # answer) — but JSON has no Infinity, so the undefined case exports as
    # null rather than the non-spec literal `json.dump` would emit.
    finite = lambda x: float(x) if np.isfinite(x) else None  # noqa: E731
    return dict(
        strategy=strat_name, num_workers=num_workers, tau=float(tau),
        resolved_attempts=n, granted=granted, p_success=p,
        counts=counts.tolist(), edges=edges.tolist(),
        measured_mean_rtt=measured_mean, analytic_rtt=a_rtt,
        measured_expected_time_to_task=finite(
            latency.expected_time_to_task(measured_mean, p)),
        analytic_expected_time_to_task=finite(
            latency.expected_time_to_task(a_rtt, p)))


def write_attempt_latency_hist(path: str, trace: Trace, **kw) -> None:
    jsonio.write(path, attempt_latency_hist(trace, **kw), indent=2)


# --------------------------------------------------------------------------- #
# Sojourn ledger (open-loop traffic)
# --------------------------------------------------------------------------- #
def sojourn_stats(trace: Trace) -> dict | None:
    """Tail-latency percentiles of every completed request in the ring.

    Each `EV_SOJOURN` event carries one request's sojourn (queue wait +
    nominal service, in ticks) in the rtt lane. Returns nearest-rank
    p50/p90/p99/p999 plus count/mean/max — the SLO quantities of the
    load–latency study — or None when the ring holds no completions.
    Percentiles are exact order statistics of the *recorded* events; size
    the ring until `trace.dropped == 0` for exact run-level numbers."""
    soj = np.sort(trace.of_kind(EV_SOJOURN)[:, LANE_RTT].astype(np.int64))
    n = int(soj.size)
    if n == 0:
        return None
    rank = lambda p: int(soj[max(int(np.ceil(p / 100.0 * n)), 1) - 1])  # noqa: E731
    return dict(count=n, p50=rank(50), p90=rank(90), p99=rank(99),
                p999=rank(99.9), mean=float(soj.mean()), max=int(soj[-1]))
