"""Tick-level simulator of work stealing on a high-latency 2D mesh, in torch.

One tick is one work unit of task execution; each mesh hop costs
`hop_ticks` ticks (τ), so a steal attempt occupies the thief for a
request flight and a response flight. Steal requests resolve when they
arrive: a victim serves the requests that arrive in the same tick in
deterministic (priority, worker id) order, one bottom task each while tasks
and its per-round budget last (paper §3.1, §3.3).

This module runs one root task with the reference's fault model — deaths
by schedule (one-shot or periodic) under `Recovery.NONE`, `Recovery.TC`
(coordinated snapshots, rollback, the dead's deques transplanted to their
heirs) and `Recovery.SUPERVISION` (victims re-push what a dead thief took),
wake-ups, straggler speeds and malleable pre-shed with a warning — and
time-varying link state (`core.linkstate`: per-epoch link latencies,
outages and speeds; flights priced along live routes, victims masked to
live links and reachable workers, flights to another live-link component
never launched, a severed reply denied its grant) — and, with
``SimConfig(trace=tracing.TraceConfig(...))``, the flight recorder
(`core.tracing`: the event ring and the binned time series) — and open-loop
arrivals (`core.arrivals`: with ``arrivals=`` and ``arrival_gap_q8 > 0`` a
request stream injects records at ground stations, a sojourn ledger prices
each when it is popped, and traced runs fill `SimResult.sojourn`). It
reproduces the reference JAX simulator
(`repro.core.simulator.simulate`) field for field on those inputs: the
randomness is a pure function of ``(seed, tick)`` (`rng.fold_in`), every
quantity is int32 with the same wrap-around, and the deque, selection,
grant and recovery logic mirror the reference step by step. Every write of
records to computed places (a transplant, the supervision ledger) has one
writer a destination, found by a scatter-max of the writers' indices, so
no result depends on the order of a scatter.

Each loop iteration is one function of device tensors (`iteration`):

  * ``step_mode="tick"`` runs one tick;
  * ``step_mode="leap"`` runs one full tick, then the famine fast path
    (``famine_batch`` > 0: up to that many ticks of steal probes that
    provably fail, advanced at once), then advances the clock in one fused
    step to the next tick at which any worker does more than burn down
    work or wait out a flight (`_next_event`, `leap`). Results equal tick
    mode's and do not depend on `famine_batch`, except `events`, the count
    of loop iterations, which equals the reference's.

The core runs a grid of G points at once (`simulate_sweep`,
`simulate_batch`; `simulate` is a grid of one): every state leaf has a
leading G axis, the deques enter the deque layer and its kernels as G·W
rows, each point has its own clock, liveness flag and iteration count
((G, 1) columns), its own key, strategy, τ, escalation threshold, grant
budget and checkpoint interval, and every reduction and cross-worker index
stays inside its point. The grid's strategies are known on the host: only
their branches run. Each tick's key is derived on the device, so nothing in
an iteration waits for the host; a point whose condition ``live & (t <
max_ticks)`` turned false keeps its state, so it stays as its own run left
it while the others run on. The host reads whether any point is live once
every `DONE_EVERY` iterations. On the CPU the iterations run eagerly (the
plain path); on the card they are captured once as a CUDA graph and
replayed (`_replay_loop`).

Deque backends: ``deque_backend="loop"`` commits each deque mutation on its
own, exporting grants through the `steal_compact` kernel; ``"staged"``
records a tick's mutations in a `deque.DequeOps` delta and commits them once
through the `deque_apply` kernel, in place into the running points' rows of
the ring. Auto (None) picks loop on every device:
on the card, under the captured loop, it took less time than staged at
every measured point (PERF.md). The kernels' wrappers run their plain
versions for CPU
tensors, so on the card the simulator always runs the kernels, and
``use_steal_kernel=False`` there raises. A grid sharded over several
devices is not ported yet: it raises `NotImplementedError` and names the
ROADMAP item that brings it.

The flight recorder rides the loop's carry beside the state (a TC rollback
never rewinds it). Each tick emits its events in the reference's order as
one block of candidates (one cumulative sum, one scatter into the ring, in
place); the famine replay, which has no per-tick loop, builds its window's
events from each worker's rounds and orders them by (tick, group, worker),
the order the reference's replayed ticks emit them in. With ``trace=None``
no function of `core.tracing` is called.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
from typing import NamedTuple

import numpy as np
import torch

from . import arrivals as arr_lib
from . import deque as dq
from . import linkstate as lstate
from . import resolve_device
from . import rng, stealing, tasks
from . import topology as topo
from . import tracing

PHASE_RUN = 0
PHASE_REQ = 1   # steal request in flight (thief → victim)
PHASE_RESP = 2  # steal response in flight (victim → thief)

STEAL_MSG_BYTES = 32  # request+reply payload estimate (task record + header)

# Exact hop accounting: low lane holds 30 bits, high lane the carries.
_HOP_LANE_BITS = 30
_HOP_LANE_MASK = (1 << _HOP_LANE_BITS) - 1

# Next-event sentinel: beyond any reachable tick (max_ticks stays below).
_NEVER = 1 << 30

ARRIVAL_K = arr_lib.ARRIVAL_K  # request records per accepted candidate, at most

# The run loop reads its done flag once every DONE_EVERY iterations (on the
# card, one iteration a captured graph: PERF.md has the measurements)
DONE_EVERY = 8

_I32 = torch.int32


class Recovery(enum.Enum):
    NONE = "none"
    TC = "tc"
    SUPERVISION = "supervision"


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Simulator knobs; field names, meanings and defaults follow the
    reference's `SimConfig`. `famine_batch` (leap mode only) changes no
    result except `events`; 0 turns the famine fast path off."""

    strategy: stealing.Strategy = stealing.Strategy.NEIGHBOR
    hop_ticks: int = 5                 # τ in work-unit ticks
    capacity: int = 1024
    max_grants_per_victim: int = 4     # per-round budget, <= stealing.GRANT_WIDTH
    escalate_after: int = 4
    max_ticks: int = 2_000_000
    seed: int = 0
    step_mode: str = "leap"            # "leap" or "tick"
    famine_batch: int = 64
    # grant-export (loop backend) / staged-commit (staged backend) kernels:
    # always on the card (False raises there); on the CPU both values run
    # the kernels' plain versions
    use_steal_kernel: bool | None = None
    # "staged", "loop", or None = auto (loop)
    deque_backend: str | None = None
    recovery: Recovery = Recovery.NONE
    ckpt_interval: int = 0
    supervision_slots: int = 64
    warn_ticks: int = 0
    preshed: bool = False
    arrival_gap_q8: int = 0
    arrival_batch: int = 1
    # the flight recorder: None = off (no function of `core.tracing` is
    # called); a `tracing.TraceConfig` turns on the event ring and the
    # binned time series
    trace: "tracing.TraceConfig | None" = None

    @property
    def static(self) -> "StaticConfig":
        return StaticConfig(
            capacity=self.capacity, max_ticks=self.max_ticks,
            step_mode=self.step_mode, famine_batch=self.famine_batch,
            use_steal_kernel=self.use_steal_kernel,
            deque_backend=self.deque_backend, recovery=self.recovery,
            supervision_slots=self.supervision_slots, preshed=self.preshed,
            trace=self.trace)

    @property
    def params(self) -> "SimParams":
        return SimParams(
            strategy=stealing.strategy_code(self.strategy),
            hop_ticks=self.hop_ticks, escalate_after=self.escalate_after,
            max_grants_per_victim=self.max_grants_per_victim,
            warn_ticks=self.warn_ticks, ckpt_interval=self.ckpt_interval,
            seed=self.seed, arrival_gap_q8=self.arrival_gap_q8,
            arrival_batch=self.arrival_batch)

    def split(self) -> "tuple[StaticConfig, SimParams]":
        return self.static, self.params


@dataclasses.dataclass(frozen=True)
class StaticConfig:
    """The shape/program-structure half of a `SimConfig`."""
    capacity: int = 1024
    max_ticks: int = 2_000_000
    step_mode: str = "leap"
    famine_batch: int = 64
    use_steal_kernel: bool | None = None
    deque_backend: str | None = None
    recovery: Recovery = Recovery.NONE
    supervision_slots: int = 64
    preshed: bool = False
    trace: "tracing.TraceConfig | None" = None


class SimParams(NamedTuple):
    """The data half of a `SimConfig`: plain ints for one point, (G,) int32
    tensors for a grid (`stack_params`)."""
    strategy: int = stealing.NEIGHBOR_CODE
    hop_ticks: int = 5
    escalate_after: int = 4
    max_grants_per_victim: int = 4
    warn_ticks: int = 0
    ckpt_interval: int = 0
    seed: int = 0
    arrival_gap_q8: int = 0
    arrival_batch: int = 1


class SimState(NamedTuple):
    """The loop's state. Inside the core every leaf has a leading grid axis
    G: (G, W, ...) for the per-worker leaves below, (G, 1) for the
    per-point scalars (shown as ())."""
    deque: dq.DequeState
    acc: torch.Tensor          # (W,) int32 mod-RESULT_MOD checksum
    work: torch.Tensor         # (W,) int32 remaining ticks on current expansion
    fails: torch.Tensor        # (W,) consecutive failed attempts
    phase: torch.Tensor        # (W,) PHASE_*
    timer: torch.Tensor        # (W,) ticks left in current phase
    victim: torch.Tensor       # (W,) in-flight victim id
    loot: torch.Tensor         # (W, T) in-flight stolen record
    got: torch.Tensor          # (W,) bool steal granted (valid in PHASE_RESP)
    alive: torch.Tensor        # (W,) bool
    sup_buf: torch.Tensor      # (W, S, T) supervision ledger (recovery slice)
    sup_thief: torch.Tensor    # (W, S)
    sup_n: torch.Tensor        # (W,)
    attempts: torch.Tensor     # (W,) steal attempts launched per thief
    successes: torch.Tensor    # (W,) granted-loot deliveries per thief
    nodes: torch.Tensor        # (W,) tree nodes expanded
    busy: torch.Tensor         # (W,) ticks spent working
    steal_wait: torch.Tensor   # (W,) ticks spent in REQ/RESP
    hops_lo: torch.Tensor      # () int32: Σ msg hops, low 30-bit lane (exact)
    hops_hi: torch.Tensor      # () int32: Σ msg hops, carry lane
    ckpt_count: torch.Tensor   # () int32 checkpoints taken
    overflow: torch.Tensor     # (W,) int32 dropped-task count per worker
    stolen_from: torch.Tensor  # (W,) int32 tasks granted out of each bottom
    hiwater: torch.Tensor      # (W,) int32 running max end-of-tick occupancy
    arr_t: torch.Tensor        # () int32 next arrival candidate (_NEVER: off)
    arr_k: torch.Tensor        # () int32 arrival-stream cursor
    arr_injected: torch.Tensor
    arr_dropped: torch.Tensor
    arr_done: torch.Tensor
    soj_lo: torch.Tensor
    soj_hi: torch.Tensor


class SimResult(NamedTuple):
    result: int
    ticks: int
    nodes: int
    attempts: int
    successes: int
    p_success: float
    busy_ticks: int
    steal_wait_ticks: int
    bytes_hops: float
    ckpt_bytes: float
    overflow: int
    utilization: float
    per_worker_busy: np.ndarray
    events: int = 0
    per_worker_overflow: np.ndarray | None = None
    per_worker_stolen: np.ndarray | None = None
    per_worker_hiwater: np.ndarray | None = None
    per_worker_attempts: np.ndarray | None = None
    per_worker_successes: np.ndarray | None = None
    # the flight recorder's output (None unless cfg.trace is set)
    trace: "tracing.Trace | None" = None
    timeseries: "tracing.TimeSeries | None" = None
    arrivals_injected: int = 0
    arrivals_dropped: int = 0
    requests_done: int = 0
    sojourn_sum_ticks: int = 0
    sojourn_mean: float = 0.0
    sojourn: dict | None = None


def _mesh_tables(mesh: topo.MeshTopology, device) -> dict:
    """Victim-set tables for every strategy plus the (W, 2) coordinates
    hop distances are priced from."""
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=_I32,
                               device=device)
    return {
        "neighbors": t(stealing.neighbor_list(mesh)),
        "coords": t(mesh.coords),
        "radius2": t(stealing.radius2_list(mesh)),
        "lifelines": t(stealing.lifeline_list(mesh.num_workers)),
    }


def _lane_budget(cfg: StaticConfig, arrivals_on: bool = False) -> int:
    """Push-log width of the staged backend: an upper bound on the staged
    pushes any worker can accept in one tick. Accepted pushes are bounded by
    free room plus the slots freed mid-tick (one expansion pop and at most
    GRANT_WIDTH exported grants), so transplants never append more than
    capacity + GRANT_WIDTH + 1 on top of the expansion children and the loot
    import; supervision re-pushes at most its ledger; open-loop injection
    lands up to ARRIVAL_K records on a station in the tick of its expansion
    push."""
    L = tasks.EXPAND_K + 1          # expansion children + thief-side loot import
    if arrivals_on:
        L += ARRIVAL_K
    if cfg.recovery == Recovery.SUPERVISION:
        L += min(cfg.supervision_slots, cfg.capacity)
    if cfg.preshed or cfg.recovery == Recovery.TC:
        # pre-shed / rollback transplants plus the dying worker's loot bank
        L += cfg.capacity + stealing.GRANT_WIDTH + 2
    return L


def _nearest_alive_neighbor(nbrs: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Each worker's first live mesh neighbor (worker 0 when none is alive):
    the heir of its deque and accumulator. `alive` (G, W); returns (G, W)
    worker ids within the point."""
    W = nbrs.shape[0]
    valid = (nbrs >= 0) & alive[:, nbrs.clamp(0, W - 1).long()]      # (G, W, 4)
    first = valid.to(_I32).argmax(-1, keepdim=True)
    heir = nbrs.expand(valid.shape).gather(-1, first)[..., 0]
    return torch.where(valid.any(-1), heir, 0)


def _transplant_plan(size: torch.Tensor, src_mask: torch.Tensor,
                     heir: torch.Tensor, cap: int):
    """Where every transplanted record lands on its heir, which records the
    heir's capacity rejects, and the per-worker size delta, per point ((G,
    W) inputs). Heir h receives its sources' records in worker-id order: a
    source's offset is the summed counts of its heir's earlier sources (a
    segment prefix). Shared by both deque backends."""
    ranks = torch.arange(cap, device=size.device)
    src_counts = torch.where(src_mask, size, 0)
    offset = stealing.segment_prefix(heir, src_mask, src_counts)
    live = src_mask[..., None] & (ranks < src_counts[..., None])
    # drop writes that would overflow the heir; charge drops to the heir
    room = cap - size.gather(-1, heir.long()) - offset
    write = live & (ranks < room[..., None])
    dropped = (live & ~write).sum(-1, dtype=_I32)
    written = torch.where(src_mask, write.sum(-1, dtype=_I32), 0)
    added = torch.zeros_like(size).scatter_add_(-1, heir.long(), written)
    return ranks, offset, write, dropped, added


def _transplant_acc(acc, src_mask, heir):
    new = acc.scatter_add(-1, heir.long(), torch.where(src_mask, acc, 0))
    return torch.remainder(torch.where(src_mask, 0, new), tasks.RESULT_MOD)


class _Deques:
    """One tick's view of the grid's (G, W, ...) deques, which the
    deque layer sees as G·W rows. Loop backend (`lanes` None): every
    mutation commits its own buffer. Staged backend: mutations accumulate
    in a `deque.DequeOps` delta with an `lanes`-wide push log, and
    `finish()` commits the tick in one pass, in place into the ring it
    started from (a view of `state.deque.buf`, or the fresh ring a rollback
    put there), and only into the rows of the points whose per-point flag
    `run` ((G, 1), None: every point) is set: a stopped point's ring stays
    bit for bit, so the loop has no ring to mask afterwards."""

    def __init__(self, state: dq.DequeState, lanes: int | None, run=None):
        self.gw = tuple(state.size.shape)
        rows = dq.DequeState(*(x.flatten(0, 1) for x in state))
        self.staged = lanes is not None
        self.st = dq.stage(rows, lanes) if self.staged else rows
        self.keep = (None if run is None or not self.staged
                     else run.expand(self.gw).flatten())

    @property
    def size(self):
        return self.st.size.view(self.gw)

    def push(self, task, mask):
        fn = dq.stage_push if self.staged else dq.push_top
        self.st, ok = fn(self.st, task.flatten(0, 1), mask.flatten())
        return ok.view(self.gw)

    def push_many(self, tasks_, counts):
        fn = dq.stage_push_many if self.staged else dq.push_top_many
        self.st, over = fn(self.st, tasks_.flatten(0, 1), counts.flatten())
        return over.view(self.gw)

    def pop(self, mask):
        fn = dq.stage_pop if self.staged else dq.pop_top
        self.st, task, ok = fn(self.st, mask.flatten())
        return task.unflatten(0, self.gw), ok.view(self.gw)

    def export(self, grants, width):
        if self.staged:
            self.st, stolen = dq.stage_export(self.st, grants.flatten(), width)
        else:
            stolen, self.st = dq.export_bottom(self.st, grants.flatten(), width)
        return stolen.unflatten(0, self.gw)

    def clear(self, mask):
        self.st = self.st._replace(size=torch.where(mask.flatten(), 0, self.st.size))

    def select(self, pred, other: dq.DequeState):
        """Where the per-point flag `pred` ((G, 1)), restart from `other`."""
        rows = pred.expand(self.gw).flatten()
        other = dq.DequeState(*(x.flatten(0, 1) for x in other))
        if self.staged:
            self.st = dq.stage_select(self.st, rows, other)
        else:
            self.st = dq.DequeState(
                torch.where(rows[:, None, None], other.buf, self.st.buf),
                torch.where(rows, other.bot, self.st.bot),
                torch.where(rows, other.size, self.st.size))

    def transplant(self, acc, src_mask, heir, overflow):
        """Move every `src_mask` worker's deque and accumulator onto its
        heir (`heir`: worker ids within the point), emptying the sources.
        Returns (acc, overflow); records an heir has no room for are
        dropped and charged to its overflow."""
        G, W = self.gw
        cap = self.st.buf0.shape[1] if self.staged else self.st.buf.shape[1]
        ranks, offset, write, dropped, added = _transplant_plan(
            self.size, src_mask, heir, cap)
        overflow = overflow + torch.zeros_like(overflow).scatter_add_(
            -1, heir.long(), torch.where(src_mask, dropped, 0))
        # an heir's row among the G·W rows: its point's base plus its id
        base = torch.arange(G, device=heir.device)[:, None] * W
        heir_row = (heir + base).flatten().long()
        dst = heir_row[:, None].expand(-1, cap)
        write = write.flatten(0, 1)
        if self.staged:
            src = dq.stage_window(self.st, cap)
            self.st = dq.stage_place(self.st, dst, offset.flatten()[:, None] + ranks,
                                     src, write)
            self.st = dq.stage_clear(self.st, src_mask.flatten())
        else:
            st = self.st
            src = dq.peek_bottom_window(st, cap)
            heir_base = (self.size.gather(-1, heir.long()) + offset).flatten()
            slot = torch.remainder(st.bot[heir_row][:, None] + heir_base[:, None]
                                   + ranks, cap)
            self.st = dq.DequeState(
                dq.place(st, dst, slot, src, write), st.bot,
                torch.where(src_mask, 0, self.size + added).flatten())
        return _transplant_acc(acc, src_mask, heir), overflow

    def finish(self) -> dq.DequeState:
        rows = dq.apply(self.st, self.keep) if self.staged else self.st
        return dq.DequeState(*(x.unflatten(0, self.gw) for x in rows))


class _Faults(NamedTuple):
    """The schedules on the device: per worker (W,), shared by every point
    of a grid, as in the reference; `warn` per point ((G, 1)), None when
    pre-shed is off; `wake` None when no worker wakes."""
    fail: torch.Tensor    # death tick (-1: immortal)
    wake: torch.Tensor | None    # rejoin tick of a dead worker (-1: never)
    period: torch.Tensor  # cycle of a periodic (fail, wake) schedule (-1: one-shot)
    warn: torch.Tensor | None


def _fires_now(base, period, t):
    """Does the periodic event anchored at `base` with cycle `period` fire
    at tick t? period == -1 is the one-shot case (``base == t``); period > 0
    fires at ``base + k * period``, k >= 0. `base < 0` never fires."""
    hit = torch.where(period > 0,
                      torch.remainder(t - base, period.clamp(min=1)) == 0,
                      t == base)
    return (base >= 0) & (t >= base) & hit


def _next_fire(base, period, t):
    """First fire tick >= t of the event (base, period), `_NEVER` when none
    remains. int32 floor division as the reference's (period < 2**29 and t
    <= max_ticks < 2**30 keep it in range)."""
    pp = period.clamp(min=1)
    k = torch.div(t - base + pp - 1, pp, rounding_mode="floor").clamp(min=0)
    one_shot = torch.where(base >= t, base, _NEVER)
    return torch.where(base < 0, _NEVER,
                       torch.where(period > 0, base + k * pp, one_shot))


def _retired_mask(faults: _Faults | None, t):
    """Pre-shed retirement: a warned worker idles from its next death's tick
    less `warn` until that death and pulls no work back in. None when
    pre-shed is off (no worker is ever retired)."""
    if faults is None or faults.warn is None:
        return None
    nf = _next_fire(faults.fail, faults.period, t)
    return (nf < _NEVER) & (t >= nf - faults.warn)


def _first_active(x, sp):
    """Each worker's first straggler-active tick >= x (a speed-s worker
    acts at the ticks divisible by s); x itself when every speed is 1."""
    if sp is None:
        return x
    return x + torch.remainder(sp - torch.remainder(x, sp), sp)


def _scheduled_horizons(ne: torch.Tensor, t: torch.Tensor, ckpt,
                        faults: _Faults | None = None, alive=None,
                        starts: torch.Tensor | None = None,
                        trace: tracing.TraceConfig | None = None,
                        arr_t: torch.Tensor | None = None) -> torch.Tensor:
    """Clip `ne` at each point's scheduled events: deaths (and pre-shed
    warnings) of alive workers, wake-ups of dead ones — every cycle of a
    periodic schedule — the next periodic checkpoint and the next link-state
    epoch boundary after t (`starts`, the schedule's epoch starts; None
    without a schedule): τ, links and speeds change there, so no leap or
    famine window crosses one. `ckpt` is None when no point of the grid
    checkpoints, else per point (interval clamped to >= 1, interval > 0).
    With the flight recorder (`trace`) the next time-series bin boundary
    clips too, and an epoch boundary at t itself: the EPOCH event is stamped
    by the tick at the flip, so a window never starts at a boundary the
    stepper has not run (a window of 0 ticks, then the tick). With open-loop
    arrivals the next candidate's tick `arr_t` clips too: the tick injects,
    so no leap jumps it, and an injection changes deque sizes, so a famine
    window ends there."""
    if faults is not None:
        never = torch.full_like(alive, _NEVER, dtype=_I32)
        nf = _next_fire(faults.fail, faults.period, t)
        ne = torch.minimum(ne, torch.where(alive, nf, never).amin(-1, keepdim=True))
        if faults.wake is not None:
            nw = _next_fire(faults.wake, faults.period, t)
            ne = torch.minimum(ne, torch.where(alive, never, nw).amin(-1, keepdim=True))
        if faults.warn is not None:
            warn_at = nf - faults.warn
            ne = torch.minimum(ne, torch.where(
                alive & (nf < _NEVER) & (warn_at >= t), warn_at,
                never).amin(-1, keepdim=True))
    if ckpt is not None:
        every, on = ckpt
        ne = torch.where(on, torch.minimum(ne, t + ((every - t % every) % every)), ne)
    if starts is not None:
        # traced: the first boundary at or after t (after t - 1)
        ne = torch.minimum(ne, lstate.next_change(
            starts, t if trace is None else t - 1, _NEVER))
    if trace is not None:
        ne = torch.minimum(ne, tracing.next_bin_boundary(trace, t, _NEVER))
    if arr_t is not None:
        ne = torch.minimum(ne, arr_t)
    return ne


def _next_event(state: SimState, t: torch.Tensor, ckpt, W: int, sp=None,
                faults: _Faults | None = None, can_try=None,
                starts: torch.Tensor | None = None,
                trace: tracing.TraceConfig | None = None,
                arrivals: bool = False) -> torch.Tensor:
    """Per point, the first tick >= t at which any of its workers does more
    than a bulk decrement ((G, 1) int32, as `t`). Conservative: an early
    answer costs one loop iteration, never correctness. `sp`: the straggler
    speeds ((W,), or (G, W) from a link-state epoch), None when all are 1;
    `can_try`: which idle workers could launch a steal flight at t (under a
    link-state schedule, the reference's `_can_attempt`), None when any
    other worker is a reachable victim; `starts` the schedule's epoch
    starts; `trace` the flight recorder's configuration (None: off);
    `arrivals` whether the run's arrival cursor `state.arr_t` clips."""
    alive = state.alive
    run = (state.phase == PHASE_RUN) & alive
    t0 = _first_active(t, sp)
    # burning workers: event when work hits 0 on their work-th active tick
    burn_ev = t0 + state.work * (1 if sp is None else sp)
    # work-exhausted workers expand (deque nonempty) or start a steal where
    # a victim is reachable, unless retired by a pre-shed warning
    retired = _retired_mask(faults, t)
    if can_try is None:
        can_try = W > 1
    if retired is not None:
        can_try = ~retired & can_try
    idle_acts = (state.deque.size > 0) | can_try
    never = torch.full_like(state.work, _NEVER)
    run_ev = torch.where(state.work > 0, burn_ev,
                         torch.where(idle_acts, t0, never))
    ev = torch.where(run, run_ev, never)
    # in-flight steal messages arrive when the timer reaches 0
    flight = (state.phase != PHASE_RUN) & alive
    ev = torch.where(flight, t + (state.timer - 1).clamp(min=0), ev)
    return _scheduled_horizons(ev.amin(-1, keepdim=True), t, ckpt, faults, alive,
                               starts, trace, state.arr_t if arrivals else None)


def _famine_horizon(state: SimState, t: torch.Tensor, ckpt, W: int, probe,
                    back: torch.Tensor, sp=None, faults: _Faults | None = None,
                    starts: torch.Tensor | None = None,
                    trace: tracing.TraceConfig | None = None,
                    arrivals: bool = False) -> torch.Tensor:
    """Per point, the first tick >= t at which any deque size can change (or
    a death, wake, pre-shed warning or checkpoint fires): the famine
    window's horizon ((G, 1) int32).

    Within ``[t, horizon)`` no worker with a nonempty deque reaches an
    expansion, no request arrives at a nonempty victim, no granted loot is
    delivered, and no thief whose drawable victims could hold work
    (`probe`, the point's `stealing.probe_may_succeed`) starts a probe. So
    every deque size stays frozen and every attempt in the window fails: the
    stretch reduces to burn-downs, flight timers and failing probe cycles,
    which the famine replay advances. Probe starts, arrivals and deliveries
    of those failing cycles are not events here. `back` is the ticks of each
    worker's reply flight from its current victim, priced at t.
    """
    alive = state.alive
    nonempty = state.deque.size > 0
    risky = probe(nonempty, state.fails)
    retired = _retired_mask(faults, t)
    if retired is not None:
        risky = risky & ~retired
    never = torch.full_like(state.work, _NEVER)
    t0 = _first_active(t, sp)
    # holders expand when their burn ends; risky thieves (a drawable victim
    # may be nonempty) end the window at their next probe opportunity
    run_ev = torch.where(state.work > 0,
                         t0 + state.work * (1 if sp is None else sp), t0)
    ev = torch.where((state.phase == PHASE_RUN) & alive & (nonempty | risky),
                     run_ev, never)
    # in flight: a request arriving at a nonempty victim may be granted, a
    # response carrying granted loot delivers into a deque, and a flier whose
    # own deque is nonempty (a re-push or transplant landed on it) expands
    # right after its delivery
    is_req = state.phase == PHASE_REQ
    v = state.victim.clamp(0, W - 1).long()
    flight_risky = torch.where(is_req, nonempty.gather(-1, v), state.got) | nonempty
    arrive = t + (state.timer - 1).clamp(min=0)
    flight_ev = torch.where(flight_risky, arrive, never)
    # a risky flier fails its present attempt, but its next draw may hit a
    # nonempty deque: the window ends before that probe starts, at its first
    # active tick after the delivery
    deliver = torch.where(is_req, arrive + (back - 1).clamp(min=0), arrive)
    flight_ev = torch.minimum(flight_ev, torch.where(
        risky, _first_active(deliver + 1, sp), never))
    ev = torch.where((state.phase != PHASE_RUN) & alive, flight_ev, ev)
    return _scheduled_horizons(ev.amin(-1, keepdim=True), t, ckpt, faults, alive,
                               starts, trace, state.arr_t if arrivals else None)


def _min_draw_hops(mesh: topo.MeshTopology, code: int) -> int:
    """Fewest hops between a thief and any victim it can draw (host side,
    once per run): it bounds how many probe cycles fit in a famine window."""
    if code == stealing.GLOBAL_CODE:
        return 1  # distinct workers sit on distinct grid slots
    tables = [stealing.neighbor_list(mesh)]
    if code == stealing.ADAPTIVE_CODE:
        tables.append(stealing.radius2_list(mesh))
    coords = torch.as_tensor(mesh.coords)
    hops = torch.cat([topo.hop_dist(mesh, coords, col)[col >= 0]
                      for tab in tables for col in torch.as_tensor(tab).unbind(1)])
    return int(hops.min()) if hops.numel() else 1


def _lead(run: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The per-point flag `run` ((G, 1)) shaped to broadcast along the
    leading (grid) axis of `x`, whatever its trailing axes."""
    return run.reshape(run.shape[:1] + (1,) * (x.dim() - 1))


def _same_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Are `a` and `b` one tensor's memory (the same object, or views of the
    same elements with the same layout)? Then a masked select between them
    is a no-op: the staged commit writes a point's ring in place and leaves
    a stopped point's rows as they were."""
    return a is b or (a.data_ptr() == b.data_ptr() and a.dtype == b.dtype
                      and a.shape == b.shape and a.stride() == b.stride())


def _masked(run: torch.Tensor, new, old, lifted: dict | None = None):
    """`new` where `run`, else `old`, per point and leaf by leaf through the
    state's named tuples; a leaf whose two sides share their memory
    (`_same_storage`) is kept. `lifted` caches `run` shaped for each leaf
    rank."""
    lifted = {} if lifted is None else lifted
    if isinstance(old, tuple):
        leaves = [_masked(run, n, o, lifted) for n, o in zip(new, old)]
        return type(old)(*leaves) if hasattr(old, "_fields") else tuple(leaves)
    if _same_storage(new, old):
        return old
    if new.dtype != old.dtype:  # the card's loop writes `new` into `old`
        raise TypeError(f"an iteration turned a {old.dtype} leaf into {new.dtype}")
    if old.dim() not in lifted:
        lifted[old.dim()] = _lead(run, old)
    return torch.where(lifted[old.dim()], new, old)


def _leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [x for sub in tree for x in _leaves(sub)]
    return [tree]


def _map(fn, tree):
    """`fn` applied to every tensor of a tree of named tuples."""
    if isinstance(tree, tuple):
        leaves = [_map(fn, x) for x in tree]
        return type(tree)(*leaves) if hasattr(tree, "_fields") else tuple(leaves)
    return fn(tree)


# options not ported yet: what each is, and its ROADMAP Queue 1 item
_NOT_PORTED = {
    "devices": ("a grid sharded over several devices (devices)", "13b"),
}


def _not_ported(what: str):
    desc, item = _NOT_PORTED[what]
    return NotImplementedError(f"{desc} is not ported to repro_torch yet "
                               f"(ROADMAP.md, Queue 1 item {item})")


def _check_static(cfg: StaticConfig):
    if cfg.step_mode not in ("leap", "tick"):
        raise ValueError(f"step_mode must be 'leap' or 'tick', got {cfg.step_mode!r}")
    if cfg.deque_backend not in (None, "staged", "loop"):
        raise ValueError(
            "deque_backend must be 'staged', 'loop', or None (auto), "
            f"got {cfg.deque_backend!r}")
    if cfg.max_ticks >= _NEVER:
        raise ValueError(f"max_ticks must stay below {_NEVER}")
    if cfg.famine_batch < 0:
        raise ValueError("famine_batch must be >= 0 (0 disables the fast path)")
    if not isinstance(cfg.recovery, Recovery):
        raise ValueError(f"recovery must be a Recovery, got {cfg.recovery!r}")
    if cfg.trace is not None:
        if not isinstance(cfg.trace, tracing.TraceConfig):
            raise TypeError("trace must be a repro_torch.core.tracing.TraceConfig "
                            f"or None, got {type(cfg.trace).__name__}")
        cfg.trace.validate()


def _check_params(p: SimParams):
    if int(p.max_grants_per_victim) > stealing.GRANT_WIDTH:
        raise ValueError(
            "max_grants_per_victim must be <= stealing.GRANT_WIDTH "
            f"({stealing.GRANT_WIDTH}), got {int(p.max_grants_per_victim)}")
    if not 0 <= stealing.strategy_code(p.strategy) < len(stealing.CODE_STRATEGIES):
        raise ValueError(f"unknown strategy code {stealing.strategy_code(p.strategy)}")
    if int(p.hop_ticks) < 0:
        raise ValueError("hop_ticks must be >= 0")
    if not 0 <= int(p.arrival_gap_q8) < (1 << 31):
        raise ValueError(
            "arrival_gap_q8 must be a non-negative int32 (mean gap ticks "
            f"x 256; 0 = closed system), got {int(p.arrival_gap_q8)}")
    if not 1 <= int(p.arrival_batch) <= ARRIVAL_K:
        raise ValueError(f"arrival_batch must be in [1, {ARRIVAL_K}], "
                         f"got {int(p.arrival_batch)}")


def _check_arrivals(arrivals, p: SimParams):
    """`arrival_gap_q8 > 0` (the stream on) needs the traffic's shape; a
    shape with the stream off is legal (tables built, no candidate fires)."""
    if int(p.arrival_gap_q8) > 0 and arrivals is None:
        raise ValueError(
            "cfg.arrival_gap_q8 > 0 turns the open-loop request stream on; "
            "pass arrivals=ArrivalConfig(...) to describe it")
    if isinstance(arrivals, arr_lib.ArrivalConfig):
        arrivals.validate()
    elif arrivals is not None and not isinstance(arrivals, arr_lib.ArrivalArrays):
        raise TypeError("arrivals must be a repro_torch.core.arrivals.ArrivalConfig "
                        f"or ArrivalArrays, got {type(arrivals).__name__}")


def _arrival_tables(arrivals, mesh: topo.MeshTopology, device: torch.device):
    """The run's arrival tables on `device`: a config is built
    (`arrivals.device_tables`), prebuilt `ArrivalArrays` pass through (moved
    to `device`); None without arrivals."""
    if arrivals is None:
        return None
    if isinstance(arrivals, arr_lib.ArrivalArrays):
        return arr_lib.to_device(arrivals, device)
    return arr_lib.device_tables(arrivals, mesh, device)


def _check_linkstate(linkstate, speed):
    """A schedule carries its own per-epoch speeds: the static `speed`
    argument beside it is refused, as the reference refuses it."""
    if linkstate is None:
        return
    if speed is not None:
        raise ValueError(
            "pass straggler speeds through the LinkStateSchedule's per-epoch "
            "`speed` field, not the static `speed` argument, when simulating "
            "under a link-state schedule")
    if not isinstance(linkstate, (lstate.LinkStateSchedule, lstate.LinkStateArrays)):
        raise TypeError("linkstate must be a LinkStateSchedule or LinkStateArrays, "
                        f"got {type(linkstate).__name__}")


def _linkstate_tables(linkstate, mesh: topo.MeshTopology, routing: str,
                      device: torch.device):
    """The run's link-state tables on `device`: a schedule is compiled
    (`linkstate.build_tables` under `routing`), prebuilt `LinkStateArrays`
    pass through (moved to `device`); None without a schedule."""
    if linkstate is None:
        return None
    if isinstance(linkstate, lstate.LinkStateArrays):
        return lstate.to_device(linkstate, device)
    return lstate.device_tables(linkstate, mesh, routing=routing, device=device)


class _Schedules(NamedTuple):
    """The failure, wake-up and straggler schedules of a run, host-side
    (W,) int32 arrays, validated as the reference validates them
    (`_schedules`)."""
    fail_time: np.ndarray
    wake_time: np.ndarray
    fail_period: np.ndarray
    speed: np.ndarray


def _schedules(W: int, fail_time=None, speed=None, wake_time=None,
               fail_period=None) -> _Schedules:
    """Check and fill the schedule arguments of `simulate`: -1 (never,
    one-shot) where not given, speeds of 1. A wake needs an earlier death of
    its worker; a periodic schedule needs a positive cycle below 2**29 that
    holds the wake strictly inside it."""
    def arr(x, fill):
        a = np.asarray(np.full(W, fill) if x is None else x)
        if a.shape != (W,):
            raise ValueError(f"expected a schedule of shape ({W},), got {a.shape}")
        return a.astype(np.int32)

    ft, wt = arr(fail_time, -1), arr(wake_time, -1)
    fp, sp = arr(fail_period, -1), arr(speed, 1)
    bad = (wt >= 0) & ((ft < 0) | (wt <= ft))
    if bad.any():
        raise ValueError(
            "wake_time must be strictly after the worker's fail_time (and "
            f"only set for workers that fail); offending workers: "
            f"{np.where(bad)[0].tolist()}")
    per = fp != -1
    bad_p = per & (fp <= 0)
    # int32 fire arithmetic (`_next_fire`) needs period < 2**29; a worker
    # must die and wake exactly once per cycle, so the wake offset has to
    # land strictly inside it
    bad_p |= per & (fp >= (1 << 29))
    bad_p |= per & ((ft < 0) | (wt < 0) | (wt - ft >= fp))
    if bad_p.any():
        raise ValueError(
            "fail_period must be -1 (one-shot) or a positive cycle length "
            "< 2**29 with fail_time >= 0 and fail_time < wake_time < "
            f"fail_time + fail_period; offending workers: "
            f"{np.where(bad_p)[0].tolist()}")
    if (sp < 1).any():
        raise ValueError(f"speed must be >= 1; offending workers: "
                         f"{np.where(sp < 1)[0].tolist()}")
    return _Schedules(ft, wt, fp, sp)


def _resolve_device(device, cfg: StaticConfig) -> torch.device:
    dev = resolve_device(device, "repro_torch's simulator runs")
    if dev.type == "cuda" and cfg.use_steal_kernel is False:
        raise ValueError(
            "use_steal_kernel=False asks for the kernels' plain versions, "
            "which run only for CPU tensors: on a CUDA device the simulator "
            "always runs the hand-written kernels; pass device='cpu' for "
            "the plain path")
    return dev


# Bumped once per `_sim_core` call, i.e. per grid: on the card, one CUDA
# graph capture. Read via `core_count()`, the port's mirror of the
# reference's `trace_count()`.
_CORE_COUNT = 0


def core_count() -> int:
    """Number of `_sim_core` calls in this process: one per `simulate`,
    `simulate_batch` or `simulate_sweep` call, whatever the grid's size."""
    return _CORE_COUNT


class _Link(NamedTuple):
    """A link-state schedule's tables on the device, for one run: the
    compiled `ls`, and per epoch (leading axis E) the victim tables the
    reference masks at every tick — built once, before the loop — and the
    rows the horizons read. None where the run needs none (no ADAPTIVE
    point, no outage epoch, every speed 1)."""
    ls: lstate.LinkStateArrays
    nbr: torch.Tensor              # (E, W, 4) neighbors over live links
    near: torch.Tensor | None      # (E, W, 4) ADAPTIVE: the cheapest of them
    r2: torch.Tensor               # (E, W, 12) radius-2, same component; (W, 12)
    nbr_live: torch.Tensor         # (E, W) some live neighbor
    r2_any: torch.Tensor | None    # (E, W) ADAPTIVE: some reachable radius-2 worker
    multi: torch.Tensor | None     # (E, W) component of more than one worker
    tau_min: torch.Tensor          # (E,) least link τ of the epoch
    speed: torch.Tensor | None     # (E, W) straggler divisors
    outage: bool                   # some epoch has a dead link
    partitioned: bool              # some epoch has more than one component


def _link_tables(ls: lstate.LinkStateArrays, tbl: dict, adaptive: bool) -> _Link:
    """The per-epoch tables of `_Link` from the compiled schedule `ls` and
    the mesh's victim tables `tbl` (host facts read once, here)."""
    nbrs = tbl["neighbors"]
    E = ls.epoch_starts.shape[0]
    outage = lstate.has_outage_tables(ls)
    nbr = torch.where(ls.link_up & (nbrs >= 0), nbrs, topo.NO_NEIGHBOR)
    r2 = tbl["radius2"]
    multi = None
    if outage:
        r2 = stealing.mask_reachable(r2.expand(E, -1, -1), ls.comp)
        comp = ls.comp.long()
        size = torch.zeros_like(ls.comp).scatter_add_(-1, comp, torch.ones_like(ls.comp))
        multi = size.gather(-1, comp) > 1
    return _Link(
        ls=ls, nbr=nbr,
        near=stealing.cheapest_live_table(nbr, ls.link_tau) if adaptive else None,
        r2=r2, nbr_live=(nbr >= 0).any(-1),
        r2_any=(r2 >= 0).any(-1).expand(E, -1) if adaptive else None,
        multi=multi, tau_min=ls.link_tau.flatten(1).amin(1),
        speed=ls.speed if bool((ls.speed != 1).any()) else None,
        outage=outage, partitioned=outage and bool((ls.comp != 0).any()))


def _at(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Each point's row of a per-epoch table `x` (E, ...) at its epoch `e`
    ((G, 1)): (G, ...), and (G, 1) for an (E,) table."""
    if x.dim() == 1:
        return x[e.long()]
    return x.index_select(0, e.flatten().long())


def _sim_core(workload, mesh: topo.MeshTopology, cfg: StaticConfig,
              p: SimParams, device: torch.device, sched: _Schedules | None = None,
              ls: lstate.LinkStateArrays | None = None,
              ar: arr_lib.ArrivalArrays | None = None):
    """Run the grid `p` (`stack_params`: G points) through one loop on
    `device`, every point under the schedules `sched` (None: no failure,
    wake-up or straggler) and the link state `ls` (compiled on `device`;
    None: every link up at each point's τ), each point in the epoch of its
    own clock, and with the arrival tables `ar` (on `device`; None: a closed
    system) each point's own request stream. Returns (state, ticks, iters,
    tr): every state leaf with a leading G axis, per-point scalars as (G, 1)
    columns; ticks and iters (G,); `tr` the flight recorder's
    `tracing.TraceState` (() when `cfg.trace` is None)."""
    global _CORE_COUNT
    _CORE_COUNT += 1
    W = mesh.num_workers
    G = int(p.strategy.shape[0])
    tbl = _mesh_tables(mesh, device)
    coords, nbrs = tbl["coords"], tbl["neighbors"]
    tables = workload.tables(device)
    S = cfg.supervision_slots

    def col(x):  # a per-point parameter as a (G, 1) column on the device
        return x.to(device=device, dtype=_I32)[:, None]

    def dev_i32(a):
        return torch.as_tensor(a, dtype=_I32, device=device)

    # the grid's strategies, known on the host: only their branches run
    codes, taus = p.strategy.tolist(), p.hop_ticks.tolist()
    present = sorted(set(codes))
    drawn = [c for c in present if c != stealing.LIFELINE_CODE]
    lifeline = stealing.LIFELINE_CODE in present
    code, hop_ticks = col(p.strategy), col(p.hop_ticks)
    escalate_after = col(p.escalate_after)
    max_grants = col(p.max_grants_per_victim)
    key0 = rng.PRNGKey(col(p.seed))
    gidx = torch.arange(G, device=device)[:, None]
    # each drawn strategy draws for its own points only (LIFELINE points,
    # whose rows are never read, ride with the first): `rows` lists the
    # points in the order the strategies' blocks are joined, `order` puts
    # them back in grid order (None when they already are)
    groups = {c: [g for g, x in enumerate(codes)
                  if x == c or (c == drawn[0] and x == stealing.LIFELINE_CODE)]
              for c in drawn}
    rows = [g for c in drawn for g in groups[c]]
    order = (None if rows == sorted(rows)
             else torch.as_tensor(np.argsort(rows), device=device))
    sel = {c: None if len(groups[c]) == G
           else torch.as_tensor(groups[c], device=device) for c in drawn}
    keys = {c: key0 if sel[c] is None else (0, key0[1][sel[c]]) for c in drawn}
    ckpt = None
    if max(p.ckpt_interval.tolist()) > 0:
        every = col(p.ckpt_interval)
        ckpt = (every.clamp(min=1), every > 0)

    # the schedules, on the device only where they can act: `faults` when
    # some worker dies, `sp` when some worker is a straggler. Their absence
    # changes no result: a run with no death never transplants, rolls back,
    # re-pushes or retires a worker
    faults = sp = None
    if sched is not None and (sched.fail_time >= 0).any():
        faults = _Faults(
            fail=dev_i32(sched.fail_time),
            wake=dev_i32(sched.wake_time) if (sched.wake_time >= 0).any() else None,
            period=dev_i32(sched.fail_period),
            warn=col(p.warn_ticks) if cfg.preshed else None)
    if sched is not None and (sched.speed != 1).any():
        sp = dev_i32(sched.speed)
    link = (None if ls is None
            else _link_tables(ls, tbl, stealing.ADAPTIVE_CODE in present))
    starts = None if ls is None else ls.epoch_starts
    outage = link is not None and link.outage
    warr = torch.arange(W, dtype=_I32, device=device)
    torus_full = mesh.torus_full()

    def epoch(t):  # each point's epoch at its tick t ((G, 1))
        return None if ls is None else lstate.epoch_index(starts, t)

    def speed_at(e):
        """The straggler speeds at epoch `e`: the schedule's row per point,
        or the static (W,) speeds without one; None when all are 1."""
        if link is None:
            return sp
        return None if link.speed is None else _at(link.speed, e)

    def flight(e, src, dst):  # ticks of the flights src → dst from epoch e
        return lstate.flight_ticks(ls, e, src, dst, mesh.rows, mesh.cols, torus_full)

    def flight_pair(e, src1, dst1, src2, dst2):
        """The flights src1 → dst1 and src2 → dst2 from epoch e, priced in
        one call (one set of launches for both)."""
        a = torch.broadcast_tensors(src1, dst1, src2, dst2)
        out = flight(e[None], torch.stack([a[0], a[2]]), torch.stack([a[1], a[3]]))
        return out[0], out[1]

    def reachable(e, a, b):
        return lstate.same_component(ls, e, a, b)

    def can_attempt(e, fails):
        """Which idle workers could launch a steal flight in epoch `e` (the
        reference's `_can_attempt`, by each point's strategy): radius-1
        strategies need a live neighbor, ADAPTIVE's escalated thieves a
        reachable radius-2 worker, multi-hop strategies another worker in
        their component. None without a schedule (any other worker)."""
        if link is None:
            return None
        multi = (_at(link.multi, e) if outage
                 else torch.full_like(fails, W > 1, dtype=torch.bool))
        out = None
        for c in present:
            if c == stealing.NEIGHBOR_CODE:
                v = _at(link.nbr_live, e)
            elif c == stealing.ADAPTIVE_CODE:
                v = _at(link.nbr_live, e) | (_at(link.r2_any, e)
                                              & (fails >= escalate_after))
            else:
                v = multi
            out = v if out is None else torch.where(code == c, v, out)
        return out

    preshed = faults is not None and cfg.preshed
    recovery = cfg.recovery if faults is not None else Recovery.NONE
    # TC rolls back only at points that checkpoint: with no such point it
    # leaves the dead as they fell, and carries no snapshot
    tc = recovery == Recovery.TC and ckpt is not None
    supervision = recovery == Recovery.SUPERVISION

    on_cuda = device.type == "cuda"
    staged = cfg.deque_backend == "staged"
    lanes_full = _lane_budget(cfg, ar is not None) if staged else None
    lanes_common = (tasks.EXPAND_K + 1 + (ARRIVAL_K if ar is not None else 0)
                    if staged else None)
    leap_mode = cfg.step_mode == "leap"
    # the famine fast path runs in leap mode; the reference gates it off per
    # point for LIFELINE (its thieves park on lifelines: no probe churn to
    # collapse), so a LIFELINE point replays no tick
    FB = cfg.famine_batch if leap_mode and drawn else 0
    # each probe cycle takes >= 2·h·τ − 1 ticks (>= 1), so a famine window of
    # FB ticks holds at most `rounds` reachable draws per worker; the
    # shortest cycle of the grid's famine points sets it (extra rounds draw
    # nothing). Under a schedule τ is the least link τ of any epoch: a
    # flight of h hops costs at least h·τ there (a draw in another
    # component launches nothing and the replay skips it)
    h_min = {c: _min_draw_hops(mesh, c) for c in drawn}
    if ls is not None:
        taus = [int(link.tau_min.min())] * len(codes)
    min_cycle = min((max(2 * h_min[c] * tau - 1, 1)
                     for c, tau in zip(codes, taus) if c in h_min), default=1)
    rounds = -(-FB // min_cycle)
    # GLOBAL's draws into another live-link component launch nothing: the
    # famine replay skips them (and, traced, replays them as NO_LIVE events)
    skips = link is not None and link.partitioned and stealing.GLOBAL_CODE in drawn
    # the reference's bound on a probe cycle, per point, and 2·τ against the
    # (G, FB, W) draws
    probe_cycle = (2 * hop_ticks - 1).clamp(min=1)
    tau2 = 2 * hop_ticks[..., None]

    deques = dq.make(G * W, cfg.capacity, device=device)
    T = deques.buf.shape[2]
    root = torch.as_tensor(workload.root_task(), device=device)
    assert root.shape[-1] == T, (
        f"root task width {root.shape[-1]} != deque record width {T}")
    # each point's root task on its worker 0
    deques, _ = dq.push_top(deques, root[None].expand(G * W, T),
                            torch.arange(G * W, device=device) % W == 0)
    deques = dq.DequeState(*(x.unflatten(0, (G, W)) for x in deques))

    def zeros(*shape, dtype=_I32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def scalar(v):  # a per-point scalar leaf: a (G, 1) column
        return torch.full((G, 1), v, dtype=_I32, device=device)

    # the open-loop stream: each point's first candidate tick, from its own
    # seed and mean gap (`_NEVER` at gap 0: no candidate fires). The stream
    # is a pure function of (seed, candidate index), so the cursor (arr_t,
    # arr_k) is its only state and arr_t doubles as a horizon
    arr_t0 = scalar(_NEVER)
    if ar is not None:
        aseed = arr_lib.stream_seed(col(p.seed))
        # each point's (gap, acceptance, station) substream seeds: a tick's
        # three draws are one hash against (arr_k + 1, arr_k, arr_k)
        subs = arr_lib.substreams(aseed[:, 0])                       # (G, 3)
        draw_k = torch.tensor([[1, 0, 0]], dtype=_I32, device=device)
        gap_q8 = col(p.arrival_gap_q8)
        a_batch = col(p.arrival_batch).clamp(1, ARRIVAL_K)
        a_lanes = torch.arange(ARRIVAL_K, device=device)
        arr_t0 = torch.where(gap_q8 > 0,
                             arr_lib.gap_ticks(aseed, 0, gap_q8).clamp(max=_NEVER),
                             _NEVER)

    z = zeros(G, W)
    state0 = SimState(
        deque=deques, acc=z, work=z, fails=z, phase=z, timer=z, victim=z - 1,
        loot=zeros(G, W, T), got=zeros(G, W, dtype=torch.bool),
        alive=torch.ones((G, W), dtype=torch.bool, device=device),
        sup_buf=zeros(G, W, S, T), sup_thief=zeros(G, W, S) - 1, sup_n=z,
        attempts=z, successes=z, nodes=z, busy=z, steal_wait=z,
        hops_lo=scalar(0), hops_hi=scalar(0), ckpt_count=scalar(0),
        overflow=z, stolen_from=z, hiwater=deques.size,
        arr_t=arr_t0, arr_k=scalar(0), arr_injected=scalar(0),
        arr_dropped=scalar(0), arr_done=scalar(0), soj_lo=scalar(0),
        soj_hi=scalar(0))
    # the flight recorder: () when off, and every use below sits behind a
    # host-side `if trc is not None`. It rides the carry beside the state,
    # so a TC rollback keeps the discarded timeline
    trc = cfg.trace
    tr0 = (tracing.init(trc, W, deques.size.sum(-1, keepdim=True) == 0)
           if trc is not None else ())
    if trc is not None:
        # a tick's candidate events in the reference's order — DEATH, WAKE,
        # EPOCH, NO_LIVE_VICTIM, ARRIVAL (the injected records, ARRIVAL_K at
        # the station) and SOJOURN (the requests popped), the attempt
        # resolutions, OVERFLOW, FAMINE_ENTER, FAMINE_EXIT — the groups this
        # run can produce, each with its lanes that never change
        life = {tracing.LANE_VICTIM: -1}
        layout = {}
        if faults is not None:
            layout["death"] = (W, {tracing.LANE_KIND: tracing.EV_DEATH,
                                   tracing.LANE_WORKER: warr, **life})
            if faults.wake is not None:
                layout["wake"] = (W, {tracing.LANE_KIND: tracing.EV_WAKE,
                                      tracing.LANE_WORKER: warr, **life})
        if ls is not None:
            layout["epoch"] = (1, {tracing.LANE_KIND: tracing.EV_EPOCH,
                                   tracing.LANE_WORKER: -1, **life})
        if outage:
            layout["no_live"] = (W, {tracing.LANE_KIND: tracing.EV_NO_LIVE_VICTIM,
                                     tracing.LANE_WORKER: warr})
        if ar is not None:
            layout["arrival"] = (ARRIVAL_K, {tracing.LANE_KIND: tracing.EV_ARRIVAL,
                                             **life})
            layout["sojourn"] = (W, {tracing.LANE_KIND: tracing.EV_SOJOURN,
                                     tracing.LANE_WORKER: warr})
        layout["resolved"] = (W, {tracing.LANE_WORKER: warr})
        layout["overflow"] = (W, {tracing.LANE_KIND: tracing.EV_OVERFLOW,
                                  tracing.LANE_WORKER: warr, **life})
        for name, kind in (("enter", tracing.EV_FAMINE_ENTER),
                           ("exit", tracing.EV_FAMINE_EXIT)):
            layout[name] = (1, {tracing.LANE_KIND: kind, tracing.LANE_WORKER: -1, **life})
        tick_block = tracing.Block(G, layout.values(), device)
        tick_group = {name: i for i, name in enumerate(layout)}
        if FB:
            # a famine window's candidates: the unreachable draws (one a
            # worker a replayed tick) and the resolutions (the flight under
            # way, then one a round)
            layout = [((rounds + 1) * W, {tracing.LANE_WORKER: warr.repeat(rounds + 1)})]
            if skips:
                layout.insert(0, (FB * W, {tracing.LANE_KIND: tracing.EV_NO_LIVE_VICTIM,
                                           tracing.LANE_WORKER: warr.repeat(FB)}))
            window_block = tracing.Block(G, layout, device)

    def probe(e):
        """Each point's `stealing.probe_may_succeed` at its epoch `e`, by
        its strategy (LIFELINE points take the first strategy's: their
        famine replay is gated off): a function of (nonempty, fails)."""
        nbr_tab, r2_tab, comp_row, cycle = (tbl["neighbors"], tbl["radius2"],
                                            None, probe_cycle)
        if link is not None:
            nbr_tab = _at(link.nbr, e)
            if outage:
                r2_tab, comp_row = _at(link.r2, e), _at(ls.comp, e)
            # the reference's bound on a probe cycle in the epoch
            cycle = (2 * _at(link.tau_min, e) - 1).clamp(min=1)

        def risky_of(nonempty, fails):
            risky = None
            for c in drawn:
                r = stealing.probe_may_succeed(
                    stealing.CODE_STRATEGIES[c], nonempty, fails, nbr_tab,
                    r2_tab, escalate_after=escalate_after, window=FB,
                    min_cycle=cycle, num_workers=W, comp_row=comp_row)
                risky = r if risky is None else torch.where(code == c, r, risky)
            return risky
        return risky_of

    # the tables each drawn strategy reads: (near, far) by table name
    draw_names = {stealing.NEIGHBOR_CODE: ("neighbors", "radius2"),
                  stealing.ADAPTIVE_CODE: ("near", "radius2"),
                  stealing.GLOBAL_CODE: ("neighbors", "radius2")}

    def draw_tables(e0, e1):
        """The victim tables of the draws' rows under a link-state schedule,
        per point: row 0 (this tick) at epoch `e0`, rows 1.. (the famine
        window from the next tick) at `e1`; a pair of (G, 1, W, D) tables
        each, by table name, for the drawn strategies that read them (GLOBAL
        reads none). The rows' uniforms are drawn once and mapped through
        them (`stealing._pick_from_list`)."""
        def rows(x):
            if x.dim() == 2:  # the same in every epoch
                return x
            first = _at(x, e0)[:, None]
            return first if not FB else (first, _at(x, e1)[:, None])
        src = {"neighbors": link.nbr, "near": link.near, "radius2": link.r2}
        used = {n for c in drawn if c != stealing.GLOBAL_CODE for n in draw_names[c]}
        return {n: rows(src[n]) if n in used else tbl[n] if n in tbl else None
                for n in src}

    def draws(t: torch.Tensor, e0=None, e1=None):
        """All-thieves victim draws of ticks t .. t + FB, one (G, 1 + FB, W)
        block by each point's strategy, key and tick
        (`stealing.batched_victim_draws`, each strategy on its own points):
        row 0 serves this tick, rows 1.. the famine replay; under a
        link-state schedule through the masked tables of epochs `e0` (row 0)
        and `e1` (rows 1..). `far`, ADAPTIVE's escalated draws (the near
        ones for the other points), is None when no point is ADAPTIVE;
        (None, None) when every point is LIFELINE, which selects per tick
        with its own key."""
        if not drawn:
            return None, None
        tabs = {"neighbors": tbl["neighbors"], "radius2": tbl["radius2"]}
        if link is not None:
            tabs = draw_tables(e0, e1)

        def table(name, c):
            x = tabs.get(name)
            if x is None:  # ADAPTIVE without a schedule: the plain neighbors
                x = tabs["neighbors"]
            if isinstance(x, tuple):
                return tuple(table_of(y, c) for y in x)
            return table_of(x, c)

        def table_of(x, c):  # the table rows of strategy c's points
            return x if x.dim() == 2 or sel[c] is None else x[sel[c]]

        blocks = {c: stealing.batched_victim_draws(
            stealing.CODE_STRATEGIES[c], keys[c],
            t if sel[c] is None else t[sel[c]], 1 + FB,
            *(table(n, c) for n in draw_names[c]), num_workers=W)
            for c in drawn}

        def join(parts):
            out = parts[0] if len(parts) == 1 else torch.cat(parts)
            return out if order is None else out[order]

        near = join([b[0] for b in blocks.values()])
        if stealing.ADAPTIVE_CODE not in blocks:
            return near, None
        return near, join([b[1] if b[1] is not None else b[0]
                           for b in blocks.values()])

    def chosen(near, far, fails):
        """The drawn victim by the fail count (ADAPTIVE escalates)."""
        if far is None:
            return near
        return torch.where(fails >= escalate_after, far, near)

    def expand(task, popped):
        ex = tasks.expand(task.flatten(0, 1), popped.flatten(), tables)
        return {k: v.unflatten(0, (G, W)) for k, v in ex.items()}

    def void(state, mask, timer=False):
        """A dead worker's in-flight state voided: no phase, work or granted
        loot (and no timer, where the reference clears it)."""
        out = state._replace(work=torch.where(mask, 0, state.work),
                             phase=torch.where(mask, 0, state.phase),
                             got=torch.where(mask, False, state.got))
        if timer:
            out = out._replace(timer=torch.where(mask, 0, state.timer))
        return out

    def apply_tc(state, snap, ses, dying, alive):
        """Roll every point with a death back to its last coordinated
        snapshot (a consistent cut: the in-flight steal state is part of it),
        then move each dead worker's snapshot deque, accumulator and
        in-flight loot onto its heir. The snapshot may predate earlier
        deaths, so every dead worker transplants. The high-water mark and
        the arrival fields are not simulation state: they survive."""
        rb = dying.any(-1, keepdim=True) & ckpt[1]
        # the session owns the live deque: on rollback it discards what was
        # staged this tick (pre-shed moves included) and restarts from the
        # snapshot
        ses.select(rb, snap.deque)
        merged = _masked(rb, snap, state._replace(deque=snap.deque))
        heir = _nearest_alive_neighbor(nbrs, alive)
        dead = ~alive & rb
        # bank a dead worker's in-flight loot into its own deque first
        want_bank = dead & merged.got
        banked = ses.push(merged.loot, want_bank)
        ovf = merged.overflow + (want_bank & ~banked).to(_I32)
        acc, ovf = ses.transplant(merged.acc, dead, heir, ovf)
        keep = {f: getattr(state, f) for f in (
            "hiwater", "arr_t", "arr_k", "arr_injected", "arr_dropped",
            "arr_done", "soj_lo", "soj_hi")}
        return void(merged._replace(acc=acc, overflow=ovf, alive=alive, **keep),
                    dead, timer=True)

    def apply_supervision(state, ses, dying, alive):
        """Victims re-push the records whose thief just died (a live victim
        pushes; every victim forgets them), and the dead worker's own state
        is lost."""
        thief = state.sup_thief
        dead_thief = dying.gather(-1, thief.clamp(0, W - 1).long().flatten(1))
        repush = (thief >= 0) & dead_thief.view(thief.shape)
        pushing = repush & (state.alive & ~dying)[..., None]
        # each victim's re-pushed records to the front, in slot order
        slot_order = torch.sort((~pushing).to(_I32), dim=-1, stable=True).indices
        recs = state.sup_buf.gather(2, slot_order[..., None].expand(-1, -1, -1, T))
        ovf = state.overflow + ses.push_many(recs, pushing.sum(-1, dtype=_I32))
        ses.clear(dying)
        return void(state._replace(
            acc=torch.where(dying, 0, state.acc), overflow=ovf, alive=alive,
            sup_thief=torch.where(repush, -1, thief)), dying)

    def supervise(state, v, rank, got, stolen):
        """The victims' ledger of granted steals: each granted (record,
        thief) in its victim's slot sup_n + rank, clipped to the last slot,
        where the highest thief of a slot wins (the reference's scatter
        order)."""
        vslot = (state.sup_n.gather(-1, v) + rank).clamp(0, S - 1)
        cell = ((gidx * W + v) * S + vslot)
        win = dq.winner_map((G, W, S), cell, got)
        hit = win >= 0
        sup_thief = torch.where(hit, win % W, state.sup_thief).to(_I32)
        sup_buf = torch.where(hit[..., None], dq.winners(stolen, win), state.sup_buf)
        sup_n = state.sup_n + torch.zeros_like(state.sup_n).scatter_add_(
            -1, v, got.to(_I32))
        return state._replace(sup_buf=sup_buf, sup_thief=sup_thief,
                              sup_n=sup_n.clamp(max=S - 1))

    def tick_fn(state: SimState, snap, tr, t: torch.Tensor, near, far, run, e):
        """One tick with full semantics at each point's tick `t` ((G, 1)),
        in its link-state epoch `e` (None without a schedule), drawing from
        row 0 of `draws(t)`; returns (state, snap, tr, live). The staged
        commits write `state.deque`'s ring in place, and the flight recorder
        `tr` its ring and time series, in the rows of the points whose flag
        `run` ((G, 1)) is set."""
        st_in = state  # the tick's entry state: its time-series baseline
        dying = waking = None
        alive = state.alive
        sp = speed_at(e)
        ses = _Deques(state.deque, lanes_full, run)

        # ------------- scheduled failures / shutdowns --------------------- #
        if faults is not None:
            # periodic schedules fire at base + k·period (one-shot: base == t)
            dying = alive & _fires_now(faults.fail, faults.period, t)
            acc, overflow = state.acc, state.overflow
            if preshed:
                # malleable pre-shed: a warned worker moves its deque and
                # accumulator one warn window early; at its death tick it
                # banks in-flight loot and moves again (the final flush)
                warned = alive & _fires_now(faults.fail, faults.period, t + faults.warn)
                heir = _nearest_alive_neighbor(nbrs, alive & ~warned & ~dying)
                acc, overflow = ses.transplant(acc, warned, heir, overflow)
                want_bank = dying & state.got
                banked = ses.push(state.loot, want_bank)
                overflow = overflow + (want_bank & ~banked).to(_I32)
                acc, overflow = ses.transplant(acc, dying, heir, overflow)
                state = state._replace(got=torch.where(dying, False, state.got))
            state = state._replace(acc=acc, overflow=overflow)
            alive = alive & ~dying
            if tc:
                state = apply_tc(state, snap, ses, dying, alive)
            elif supervision:
                state = apply_supervision(state, ses, dying, alive)
            elif recovery == Recovery.TC:
                # no point checkpoints: nothing to roll back to
                state = state._replace(alive=alive)
            else:
                ses.clear(dying)
                state = void(state._replace(
                    alive=alive, acc=torch.where(dying, 0, state.acc)), dying)
            alive = state.alive

            # ------------- eclipse exits: wake-ups (elastic grow) --------- #
            # a dead worker whose wake tick arrives rejoins as a fresh
            # citizen: its deque is empty (every recovery path leaves a dead
            # deque empty), no fail count, ledger or in-flight state
            if faults.wake is not None:
                waking = ~alive & _fires_now(faults.wake, faults.period, t)
                alive = alive | waking
                state = state._replace(
                    alive=alive,
                    phase=torch.where(waking, PHASE_RUN, state.phase),
                    timer=torch.where(waking, 0, state.timer),
                    victim=torch.where(waking, -1, state.victim),
                    work=torch.where(waking, 0, state.work),
                    fails=torch.where(waking, 0, state.fails),
                    got=torch.where(waking, False, state.got),
                    sup_thief=torch.where(waking[..., None], -1, state.sup_thief),
                    sup_n=torch.where(waking, 0, state.sup_n))

        # ------------- periodic checkpoint -------------------------------- #
        if ckpt is not None:
            every, on = ckpt
            take = on & (t % every == 0)
            if tc:
                # the snapshot cut sees the deque after recovery: the staged
                # ops commit here and a fresh session at the common lane
                # budget carries the rest of the tick (two commits a tick)
                deq_mid = ses.finish()
                ses = _Deques(deq_mid, lanes_common, run)
                state = state._replace(deque=deq_mid)
                snap = _masked(take, state, snap)
            state = state._replace(ckpt_count=state.ckpt_count + take.to(_I32))

        # ------------- open-loop arrival injection ------------------------- #
        # candidate arr_k fires when its tick arr_t comes; arr_t is a
        # horizon, so both step modes run this tick here. After the snapshot
        # cut (no checkpoint holds half an injection) and before the RUN
        # phase (an idle station pops the request in the same tick)
        if ar is not None:
            a_fire = run & (t == state.arr_t)
            draws = tasks._hash2(subs, state.arr_k + draw_k)             # (G, 3)
            a_station = arr_lib.station_of_draw(ar, draws[:, 2:])
            a_accept = a_fire & arr_lib.accepted_of_draw(ar, draws[:, 1:2], t)
            # a dead station drops the uplink (pushed onto a dead deque, the
            # work would keep the run live forever): counted, not pushed
            st_alive = alive.gather(-1, a_station.long())
            at_station = warr == a_station                           # (G, W)
            # task ids arr_k·ARRIVAL_K + lane, wrapped to non-negative int32
            a_ids = ((state.arr_k.to(torch.int64) * ARRIVAL_K + a_lanes)
                     & 0x7FFFFFFF).to(_I32)                          # (G, K)
            a_recs = torch.stack(torch.broadcast_tensors(
                torch.full_like(a_ids, tasks.KIND_REQ), ar.task_cost, t, a_ids), -1)
            a_counts = torch.where(at_station & a_accept & st_alive, a_batch, 0)
            a_over = ses.push_many(
                torch.where(at_station[..., None, None], a_recs[:, None], 0), a_counts)
            a_pushed = a_counts - a_over
            nxt = arr_lib.gap_of_draw(draws[:, :1], gap_q8)
            state = state._replace(
                arr_t=torch.where(a_fire, (t + nxt).clamp(max=_NEVER), state.arr_t),
                arr_k=state.arr_k + a_fire.to(_I32),
                arr_injected=state.arr_injected + a_pushed.sum(-1, keepdim=True,
                                                               dtype=_I32),
                arr_dropped=(state.arr_dropped + a_over.sum(-1, keepdim=True, dtype=_I32)
                             + torch.where(a_accept & ~st_alive, a_batch, 0)),
                overflow=state.overflow + a_over)

        # ------------- phase RUN: work / expand / start steal -------------- #
        # a speed-s straggler acts only at ticks divisible by s
        active = alive if sp is None else alive & (t % sp == 0)
        running = (state.phase == PHASE_RUN) & active
        burning = running & (state.work > 0)
        work = state.work - burning.to(_I32)

        can_expand = running & ~burning & (ses.size > 0)
        task, popped = ses.pop(can_expand)
        ex = expand(task, popped)
        over = ses.push_many(ex["children"], ex["n_children"])
        # int32 add wraps before the floor-mod, as in the reference
        acc = torch.remainder(state.acc + ex["value"], tasks.RESULT_MOD)
        work = work + (ex["cost"] - 1).clamp(min=0) * popped.to(_I32)
        nodes = state.nodes + ex["nodes"]
        busy = state.busy + (burning | popped).to(_I32)
        overflow = state.overflow + over.to(_I32)

        if ar is not None:
            # the sojourn ledger: a popped request ends its wait here, priced
            # with its service (the burn that follows is exactly its cost);
            # injected and popped in one tick, it costs its cost. Two int32
            # lanes hold the sum exactly
            is_req = popped & (task[..., 0] == tasks.KIND_REQ)
            soj = torch.where(is_req, t - task[..., 2] + ex["cost"], 0)
            s_lo = state.soj_lo + soj.sum(-1, keepdim=True, dtype=_I32)
            state = state._replace(
                arr_done=state.arr_done + is_req.sum(-1, keepdim=True, dtype=_I32),
                soj_hi=state.soj_hi + (s_lo >> _HOP_LANE_BITS),
                soj_lo=s_lo & _HOP_LANE_MASK)

        # idle workers become thieves: request departs now, arrives in h·τ
        idle = running & ~burning & ~popped & (ses.size == 0)
        retired = _retired_mask(faults, t)
        if retired is not None:
            # retired workers (warned of shutdown) pull no work back in
            idle = idle & ~retired
        victim_new = None
        if near is not None:
            victim_new = torch.where(
                idle, chosen(near[:, 0], None if far is None else far[:, 0],
                             state.fails), topo.NO_NEIGHBOR)
        if lifeline:
            parked = stealing.choose_lifeline(rng.fold_in(key0, t),
                                              tbl["lifelines"], state.fails,
                                              W, idle)
            victim_new = (parked if victim_new is None else torch.where(
                code == stealing.LIFELINE_CODE, parked, victim_new))
        has_victim = victim_new >= 0
        fails_sel = state.fails  # the fail counts the draw saw
        reach = None
        if outage:
            # route-around: a victim in another live-link component is
            # unreachable, so the flight never departs (no attempt) and the
            # thief draws again at its next active tick
            reach = reachable(e, warr, victim_new)
            has_victim = has_victim & reach
        vhops = torch.where(has_victim, topo.hop_dist(mesh, coords, victim_new), 0)
        start_req = idle & has_victim & alive
        victim = torch.where(start_req, victim_new, state.victim)
        if ls is None:
            req_ticks = vhops * hop_ticks
        else:
            # both legs in this tick's epoch: a request departing now, and
            # the reply of a request arriving now (victim → thief)
            req_fl, back_fl = flight_pair(e, warr, victim_new, victim, warr)
            req_ticks = torch.where(has_victim, req_fl, 0)
        phase = torch.where(start_req, PHASE_REQ, state.phase)
        timer = torch.where(start_req, req_ticks, state.timer)
        attempts = state.attempts + start_req.to(_I32)
        hop_units = torch.where(start_req, vhops, 0).sum(-1, keepdim=True)

        # ------------- phase REQ: in flight / arrival ----------------------- #
        in_req = (phase == PHASE_REQ) & alive
        timer = torch.where(in_req, (timer - 1).clamp(min=0), timer)
        arriving = in_req & (timer == 0)
        # victims must be alive to grant (dead satellites drop requests)
        valid_victim = arriving & alive.gather(-1, victim.clamp(0, W - 1).long())
        if outage:
            # an epoch change mid-request severed the reply path: no grant
            # (the empty-handed reply is priced as the timeout below)
            valid_victim = valid_victim & reachable(e, victim, warr)
        plan = stealing.resolve_grants(torch.where(valid_victim, victim, -1),
                                       ses.size, max_grants)
        v = plan.victim.clamp(0, W - 1).long()
        stolen_blk = ses.export(plan.taken, stealing.GRANT_WIDTH)
        stolen = stolen_blk[gidx, v,
                            plan.rank.clamp(0, stealing.GRANT_WIDTH - 1).long()]
        got = plan.got
        stolen_from = state.stolen_from + plan.taken
        if supervision:
            state = supervise(state, v, plan.rank, got, stolen)
        # response departs: travel back
        resp_start = arriving
        phase = torch.where(resp_start, PHASE_RESP, phase)
        back_hops = torch.where(resp_start, topo.hop_dist(mesh, coords, victim), 0)
        if ls is None:
            back_ticks = back_hops * hop_ticks
        else:  # priced victim → thief in the arrival epoch
            back_ticks = torch.where(resp_start, back_fl, 0)
        timer = torch.where(resp_start, back_ticks, timer)
        hop_units = hop_units + torch.where(resp_start, back_hops, 0).sum(-1, keepdim=True)
        loot = torch.where(resp_start[..., None], stolen, state.loot)
        got_flight = torch.where(resp_start, got, state.got)

        # exact 62-bit hop accumulation (int32 lanes with explicit carry)
        lo = state.hops_lo + hop_units.to(_I32)
        hops_hi = state.hops_hi + (lo >> _HOP_LANE_BITS)
        hops_lo = lo & _HOP_LANE_MASK

        # ------------- phase RESP: in flight / delivery --------------------- #
        in_resp = (phase == PHASE_RESP) & alive
        timer = torch.where(in_resp, (timer - 1).clamp(min=0), timer)
        delivered = in_resp & (timer == 0)
        # thief-side import: a delivery landing on a full deque is a task loss
        want_import = delivered & got_flight
        imported = ses.push(loot, want_import)
        overflow = overflow + (want_import & ~imported).to(_I32)
        successes = state.successes + want_import.to(_I32)
        fails = torch.where(want_import, 0,
                            state.fails + (delivered & ~got_flight).to(_I32))
        phase = torch.where(delivered, PHASE_RUN, phase)
        steal_wait = state.steal_wait + (in_req | in_resp).to(_I32)

        # the one commit of every staged deque mutation this tick (loop
        # backend: already committed, a no-op here)
        deque_ = ses.finish()

        if trc is not None:
            # the tick's events, one block in the reference's fixed order
            # (`tick_block`): only the lanes that change are written
            blk, grp = tick_block, tick_group
            blk.set(tracing.LANE_TICK, t)
            masks = []
            if dying is not None:
                masks.append(dying)
            if waking is not None:
                masks.append(waking)
            if ls is not None:
                blk.set(tracing.LANE_EPOCH, e)
                masks.append((t > 0) & (starts == t[..., None]).any(-1))
            if outage:
                # a draw into another component never departs; it is an event
                # only for workers that could attempt in this epoch (the
                # reference's `_can_attempt`, with the fails the draw saw)
                masks.append(idle & (victim_new >= 0) & ~reach & can_attempt(e, fails_sel))
                blk.set(tracing.LANE_VICTIM, victim_new, grp["no_live"])
                blk.set(tracing.LANE_HOPS, topo.hop_dist(mesh, coords, victim_new),
                        grp["no_live"])
            if ar is not None:
                # one ARRIVAL a record pushed (its task id in the hops lane),
                # one SOJOURN a request popped (inject tick, task id, sojourn)
                blk.set(tracing.LANE_WORKER, a_station, grp["arrival"])
                blk.set(tracing.LANE_HOPS, a_ids, grp["arrival"])
                masks.append(a_lanes < a_pushed.gather(-1, a_station.long()))
                blk.set(tracing.LANE_VICTIM, task[..., 2], grp["sojourn"])
                blk.set(tracing.LANE_HOPS, task[..., 3], grp["sojourn"])
                blk.set(tracing.LANE_RTT, soj, grp["sojourn"])
                masks.append(is_req)
            # a resolution at request arrival prices the whole round trip:
            # the request leg was banked at departure
            req_lane = torch.where(start_req, req_ticks, tr.req_ticks)
            blk.set(tracing.LANE_KIND, torch.where(
                valid_victim, torch.where(got, tracing.EV_GRANTED, tracing.EV_EMPTY_VICTIM),
                tracing.EV_SEVERED_DENIAL), grp["resolved"])
            blk.set(tracing.LANE_VICTIM, victim, grp["resolved"])
            blk.set(tracing.LANE_HOPS, back_hops, grp["resolved"])
            blk.set(tracing.LANE_RTT, req_lane + back_ticks, grp["resolved"])
            masks.append(arriving)
            # the net increase only: a TC rollback can rewind the counter
            ovf_delta = overflow - st_in.overflow
            blk.set(tracing.LANE_RTT, ovf_delta, grp["overflow"])
            masks.append(ovf_delta > 0)
            famine_now = deque_.size.sum(-1, keepdim=True) == 0
            masks += [famine_now & ~tr.famine, ~famine_now & tr.famine]
            tr = blk.append(tr._replace(req_ticks=req_lane, famine=famine_now), trc,
                            masks, run)
            # the tick's time-series deltas against its entry state (under
            # TC a rollback makes them negative, as in the reference)
            tot = torch.stack([busy - st_in.busy, deque_.size,
                               steal_wait - st_in.steal_wait,
                               attempts - st_in.attempts,
                               successes - st_in.successes, alive.to(_I32)],
                              1).sum(-1)
            tr = tracing.ts_add_row(tr, trc, t, tot, run)

        got_left = got_flight & ~delivered
        new_state = state._replace(
            deque=deque_, acc=acc, work=work, fails=fails, phase=phase,
            timer=timer, victim=victim, loot=loot, got=got_left,
            alive=alive, attempts=attempts, successes=successes, nodes=nodes,
            busy=busy, steal_wait=steal_wait, hops_lo=hops_lo, hops_hi=hops_hi,
            overflow=overflow, stolen_from=stolen_from,
            hiwater=torch.maximum(state.hiwater, deque_.size))
        live = (deque_.size.sum(-1, keepdim=True) + work.sum(-1, keepdim=True)
                + got_left.sum(-1, keepdim=True)) > 0
        if ar is not None:
            # an open system stays live through a transient drain while its
            # stream has a candidate to come
            live = live | (state.arr_t < _NEVER)
        return new_state, snap, tr, live

    def active_in(t, a, b, sp):
        """Each worker's straggler-active ticks in [t + a, t + b)."""
        if sp is None:
            return b - a
        return (torch.div(t + b + sp - 1, sp, rounding_mode="floor")
                - torch.div(t + a + sp - 1, sp, rounding_mode="floor"))

    def leap(state: SimState, tr, t, live, ne, sp, run):
        """Fused fast-forward over the dead ticks in [t, ne), per point, at
        the speeds `sp` (one epoch covers the window: `ne` stops at the next
        boundary). Returns (state, tr, t, live). If the window's bulk burn
        consumes a point's LAST pending work, land right after the final
        burn tick (where the one-tick stepper exits) and clear its live
        flag. The window's time-series contribution lands in t's bin (`ne`
        stops at the next bin boundary too), at the points whose flag `run`
        is set."""
        delta = (ne.clamp(max=cfg.max_ticks) - t).clamp(min=0)
        delta = torch.where(live, delta, 0)
        burning = (state.phase == PHASE_RUN) & state.alive & (state.work > 0)
        # burners: one work unit per straggler-active tick in the window
        nact = torch.where(burning, torch.minimum(active_in(t, 0, delta, sp),
                                                  state.work), 0)
        drained = (state.deque.size.sum(-1, keepdim=True)
                   + (state.work - nact).sum(-1, keepdim=True)
                   + state.got.sum(-1, keepdim=True)) == 0
        if ar is not None:  # a pending candidate keeps an open system live
            drained = drained & (state.arr_t >= _NEVER)
        # tick right after the last burn of the burners that finish in-window
        last = _first_active(t, sp) + (state.work - 1) * (1 if sp is None else sp) + 1
        exit_t = torch.where(burning & (nact == state.work), last,
                             0).amax(-1, keepdim=True)
        delta = torch.where(live & drained,
                            torch.minimum(delta, (exit_t - t).clamp(min=0)),
                            delta)
        nact = torch.where(burning, torch.minimum(active_in(t, 0, delta, sp),
                                                  state.work), 0)
        # in-flight messages: timers tick down, thieves accumulate wait
        flight_ = (state.phase != PHASE_RUN) & state.alive
        dflt = torch.where(flight_, delta, 0)
        if trc is not None:
            # sizes and liveness are frozen over the window
            tot = torch.stack([nact, state.deque.size * delta, dflt,
                               torch.zeros_like(nact), torch.zeros_like(nact),
                               state.alive * delta], 1).sum(-1)
            tr = tracing.ts_add_row(tr, trc, t, tot, run)
        return state._replace(
            timer=state.timer - dflt, steal_wait=state.steal_wait + dflt,
            work=state.work - nact, busy=state.busy + nact), \
            tr, t + delta, live & ~drained

    def next_event(state: SimState, t, e):
        """`_next_event` at each point's tick `t`, in its epoch `e`."""
        return _next_event(state, t, ckpt, W, speed_at(e), faults,
                           can_attempt(e, state.fails), starts, trc, ar is not None)

    def famine_ff(state: SimState, tr, t, live, ne_all, near, far, e, run):
        """Advance up to FB ticks of deterministically failing probe cycles
        in this iteration (the famine fast path), per point, in its epoch
        `e` (the window never crosses an epoch boundary). Returns (state, tr,
        t, live, ne, e): the flight recorder `tr` written at the points whose
        flag `run` is set, `ne` the `_next_event` horizon of the returned
        state and `e` the epoch of its tick.

        `_famine_horizon` certifies that deque sizes are frozen over the
        window, so only burn-downs, probe flights and their counters move;
        deaths, wake-ups and pre-shed warnings end it, so who is alive and
        who is retired holds over it. The reference replays the window tick
        by tick (`lax.scan` over FB ticks under `lax.cond`); here the replay
        is worked out per worker, with no branch: a live worker's window is
        its flight under way (or its idle start), its burn — one unit at each
        straggler-active tick — then, unless it is retired, probe cycles: a
        draw at an active tick d from row d of `near`/`far`
        (`stealing.batched_victim_draws`, the same ``fold_in(key0, t)`` keys
        as the per-tick path), the request arriving at d + max(Lq − 1, 0)
        and the empty-handed reply landing max(Lr − 1, 0) later — Lq and Lr
        the request's and the reply's flight ticks, h·τ each without a
        schedule, `flight_ticks` in the window's epoch with one — the next
        draw at the first active tick after. A draw into another live-link
        component (GLOBAL's, under a partition) launches nothing: the thief
        draws again at its next active tick, so each worker takes the next
        reachable draw at or after its tick. Each round below takes every
        worker's next draw at once; `rounds` bounds the draws a window
        holds. The number of replayed ticks `n` is where the reference's
        scan stops (its `act = pred & live & (j < delta)`): 0 when the gate
        `pred` is closed, which leaves everything as it was.
        """
        sp = speed_at(e)
        # the reply flight of every worker's current victim, priced now
        hv = topo.hop_dist(mesh, coords, state.victim)
        back = hv * hop_ticks if ls is None else flight(e, state.victim, warr)
        ne_risky = _famine_horizon(state, t, ckpt, W, probe(e), back, sp,
                                   faults, starts, trc, ar is not None)
        hi = ne_risky.clamp(max=cfg.max_ticks)
        delta = (hi - t).clamp(0, FB)
        # profitable only when probe-cycle events (counted by _next_event
        # but not by the famine horizon) fall inside the batch range
        pred = live & (delta > 0) & (ne_all < torch.minimum(hi, t + FB))
        if lifeline:
            pred = pred & (code != stealing.LIFELINE_CODE)

        phase, timer, work, fails = (state.phase, state.timer, state.work,
                                     state.fails)
        alive = state.alive
        frozen = (state.deque.size.sum(-1, keepdim=True)
                  + state.got.sum(-1, keepdim=True))
        # what keeps a point live whatever burns: frozen deques or loot, or
        # (open system) a candidate to come — the window ends at or before
        # arr_t, so that holds over it
        held = frozen > 0
        if ar is not None:
            held = held | (state.arr_t < _NEVER)
        in_flight = (phase != PHASE_RUN) & alive
        is_req = (phase == PHASE_REQ) & alive
        # the flight under way: arrival a0 and delivery dv0 (relative ticks;
        # a reply already in flight arrived before the window, a0 = -1)
        t_arr = (timer - 1).clamp(min=0)
        a0 = torch.where(is_req, t_arr, -1)
        dv0 = torch.where(is_req, t_arr + (back - 1).clamp(min=0), t_arr)
        # a worker may burn from b0 (after its delivery if in flight); it
        # burns at its active ticks from b1 on and has no work left after
        # tick `last_burn` - 1. A dead worker's work never burns
        b0 = torch.where(in_flight, dv0 + 1, 0)
        b1 = b0 if sp is None else _first_active(t + b0, sp) - t
        spw = work if sp is None else work * sp
        last_burn = torch.where(work > 0, torch.where(alive, b1 + spw - (
            0 if sp is None else sp - 1), _NEVER), 0).amax(-1, keepdim=True)
        # ticks replayed: the window, cut where the last work burns out
        # unless `held` keeps the system live
        n = torch.where(pred, torch.where(held, delta,
                                          torch.minimum(delta, last_burn)), 0)
        burned = torch.where(alive, torch.minimum(active_in(t, b0, n, sp).clamp(min=0),
                                                  work), 0)

        # the flight under way: its reply, its delivery, where it stands
        arrived = is_req & (a0 < n)
        delivered = in_flight & (dv0 < n)
        hop_w = torch.where(arrived, hv, 0)
        loot_zero = arrived
        fails = fails + (delivered & ~state.got).to(_I32)
        steal_wait = state.steal_wait + torch.where(
            in_flight, torch.minimum(dv0 + 1, n), 0)
        resp_len = torch.where(is_req, back, timer + 1)
        # (PHASE_RESP = PHASE_REQ + 1: a flight that has arrived replies)
        phase = torch.where(in_flight, torch.where(
            delivered, PHASE_RUN, PHASE_REQ + (a0 < n).to(_I32)), phase)
        timer = torch.where(in_flight, torch.where(
            delivered, 0, torch.where(a0 < n, resp_len - (n - a0), timer - n)),
            timer)

        # probe cycles: an idle worker with an empty deque draws at tick d
        # from row d; the request flies Lq ticks and the reply Lr, so the
        # draw is back max(Lq − 1, 0) + max(Lr − 1, 0) ticks later and the
        # next follows at the first active tick after: a cycle of that + 1
        # ticks. A worker whose table row is empty draws no victim all
        # window (the window's tables are one epoch's).
        e3 = None if e is None else e[..., None]

        def cycles(draw):  # (G, FB, W, F): victim, hops, cycle[, Lq, Lr]
            h = topo.hop_dist(mesh, coords, draw)
            if ls is None:  # both legs h·τ: a cycle of max(2·h·τ − 1, 1)
                return torch.stack([draw, h, (h * tau2 - 1).clamp(min=1)], -1)
            lq, lr = flight_pair(e3, warr, draw, draw, warr)
            return torch.stack([draw, h, (lq - 1).clamp(min=0)
                                + (lr - 1).clamp(min=0) + 1, lq, lr], -1)

        near_c, has_near = cycles(near), near[:, 0] >= 0
        idle = alive & (state.deque.size == 0)
        retired = _retired_mask(faults, t)
        if retired is not None:
            idle = idle & ~retired
        if far is None:
            idle = idle & has_near
        else:
            far_c, has_far = cycles(far), far[:, 0] >= 0
        next_ok = reach_rows = active_rows = None
        if skips:
            # each worker's next row at or after j whose draw it can launch
            # (reachable, and at an active tick of a straggler): the
            # radius-1 and radius-2 tables are masked already, so only
            # GLOBAL's draws skip
            rows = torch.arange(FB, device=device)
            reach_rows = ok = reachable(e3, warr, near)
            if sp is not None:
                active_rows = (t[..., None] + rows[:, None]) % sp[:, None] == 0
                ok = ok & active_rows
            idx = torch.where(ok, rows[:, None].to(_I32), _NEVER)
            next_ok = torch.flip(torch.cummin(torch.flip(idx, [1]), 1).values, [1])
        gaps = sp is not None or next_ok is not None

        def first_ok(d):  # the next launchable draw at or after d
            if next_ok is None:
                return d
            j = next_ok.gather(1, d.clamp(max=FB - 1).long()[:, None])[:, 0]
            return torch.where(d < FB, j, d)

        c0 = torch.where(idle, b1 + spw, _NEVER)
        d0 = first_ok(c0)
        d, attempts, victim = d0, state.attempts, state.victim
        # for the flight recorder: each round's draw, and (where draws skip)
        # the stretches [candidate, draw) an idle worker spends redrawing
        drawn_rounds = [] if trc is not None else None
        redraw = ([c0], [d0]) if trc is not None and skips else None
        hops_sum = torch.zeros_like(d)
        d_last, h_last, q_last, r_last = d0, hops_sum, hops_sum, hops_sum
        flown, c_last = hops_sum, hops_sum
        F = near_c.shape[-1]
        for r in range(rounds):
            # each worker's next draw: row d of its own point's block
            row = d.clamp(max=FB - 1).long()[:, None, :, None].expand(G, 1, W, F)
            g = near_c.gather(1, row)[:, 0]
            ok = d < n
            if far is not None:
                # every earlier draw was delivered before this one: r more
                # failures than after the flight under way
                esc = fails >= escalate_after - r
                g = torch.where(esc[..., None], far_c.gather(1, row)[:, 0], g)
                ok = ok & torch.where(esc, has_far, has_near)
            ch, h, cycle = g.unbind(-1)[:3]
            attempts = attempts + ok
            hops_sum = hops_sum + h * ok
            victim = torch.where(ok, ch, victim)
            d_last = torch.where(ok, d, d_last)
            h_last = torch.where(ok, h, h_last)
            if ls is not None:  # (without one, both legs are h·τ)
                q_last = torch.where(ok, g[..., 3], q_last)
                r_last = torch.where(ok, g[..., 4], r_last)
            if gaps:
                # a straggler idles between a delivery and its next active
                # tick, and a thief skips unreachable draws: the flights'
                # ticks are summed apart from the draws'
                flown = flown + cycle * ok
                c_last = torch.where(ok, cycle, c_last)
            if drawn_rounds is not None:
                drawn_rounds.append((d, ok, g))
            if sp is not None:
                cycle = torch.div(cycle + sp - 1, sp, rounding_mode="floor") * sp
            cand = d + cycle
            d = torch.where(ok, first_ok(cand), _NEVER)
            if redraw is not None:
                redraw[0].append(torch.where(ok, cand, _NEVER))
                redraw[1].append(d)
        # every draw but the last was delivered (the next followed it): the
        # counters telescope, and the last draw's flight is where it stands
        draws_n = attempts - state.attempts
        drew = draws_n > 0
        if ls is None:
            q_last = r_last = h_last * hop_ticks
        wait_q = (q_last - 1).clamp(min=0)
        a = d_last + wait_q
        dv = a + (wait_q if ls is None else (r_last - 1).clamp(min=0))
        fails = fails + draws_n - (drew & (dv >= n)).to(_I32)
        hop_w = hop_w + 2 * hops_sum - torch.where(drew & (a >= n), h_last, 0)
        loot_zero = loot_zero | (drew & ((draws_n > 1) | (a < n)))
        before = d_last - (flown - c_last) if gaps else d0
        steal_wait = steal_wait + torch.where(drew, torch.minimum(dv + 1, n) - before, 0)
        phase = torch.where(drew, torch.where(
            dv < n, PHASE_RUN, PHASE_REQ + (a < n).to(_I32)), phase)
        timer = torch.where(drew, torch.where(
            dv < n, 0, torch.where(a < n, r_last - (n - a),
                                   q_last - (n - d_last))), timer)

        # hop units: the reference adds each tick's sum to the low lane and
        # carries; adding the window's sum at once gives the same lanes
        lo = state.hops_lo.to(torch.int64) + hop_w.sum(-1, keepdim=True)
        new_state = state._replace(
            phase=phase, timer=timer, victim=victim, fails=fails,
            work=work - burned, busy=state.busy + burned,
            loot=torch.where(loot_zero[..., None], 0, state.loot),
            attempts=attempts, steal_wait=steal_wait,
            hops_lo=(lo & _HOP_LANE_MASK).to(_I32),
            hops_hi=state.hops_hi + (lo >> _HOP_LANE_BITS).to(_I32))
        if trc is not None:
            tr = window_events(tr, state, t, n, run, e, a0, arrived, hv, back, drawn_rounds,
                               redraw, near, reach_rows, active_rows)
            # the request leg of each worker's last draw, banked at departure
            tr = tr._replace(req_ticks=torch.where(drew, q_last, tr.req_ticks))
            # the window's bulk time series: sizes, liveness and (by the
            # certificate) successes are frozen, and the window ends at the
            # next bin boundary, so it lands in t's bin
            tot = torch.stack([burned, state.deque.size * n, steal_wait - state.steal_wait,
                               attempts - state.attempts, torch.zeros_like(burned),
                               alive * n], 1).sum(-1)
            tr = tracing.ts_add_row(tr, trc, t, tot, run)
        t_out = t + n
        live_out = torch.where(n > 0, held | (n < last_burn), live)
        e_out = epoch(t_out)
        return (new_state, tr, t_out, live_out, next_event(new_state, t_out, e_out),
                e_out)

    def window_events(tr, state, t, n, run, e, a0, arrived, hv, back, drawn_rounds,
                      redraw, near, reach_rows, active_rows):
        """The events of a famine window of n ticks from t, in the order the
        reference's replayed ticks emit them: tick by tick, first the
        unreachable draws (EV_NO_LIVE_VICTIM), then the resolutions of the
        requests arriving, each group in worker order. A worker has at most
        one event of a group a tick, so the order is that of the key (j·2 +
        group)·W + w over the window's relative ticks j; each event's slot is
        its rank among the keys of its point's events. Every arrival fails
        (the window's certificate): EV_EMPTY_VICTIM where the victim is
        alive and in the thief's component, else EV_SEVERED_DENIAL. The
        rows are `window_block`'s: the unreachable draws (FB·W candidates,
        where GLOBAL draws across a partition) and the resolutions ((R + 1)·W:
        the flight under way, then each round's draw)."""
        blk, R1 = window_block, (rounds + 1, W)
        res_g = len(blk.spans) - 1
        if ls is not None:
            blk.set(tracing.LANE_EPOCH, e)
        # the flight under way (its request leg banked at departure), then
        # each round's draw, arriving max(Lq − 1, 0) after it; the rounds as
        # one (G, R, W) block
        d = torch.stack([x[0] for x in drawn_rounds], 1)
        g = torch.stack([x[2] for x in drawn_rounds], 1)        # (G, R, W, F)
        lq = g[..., 1] * hop_ticks[..., None] if ls is None else g[..., 3]
        at = torch.cat([a0[:, None], d + (lq - 1).clamp(min=0)], 1)   # (G, R + 1, W)
        vic = torch.cat([state.victim[:, None], g[..., 0]], 1)
        blk.set(tracing.LANE_TICK, t[..., None] + at, res_g, R1)
        blk.set(tracing.LANE_VICTIM, vic, res_g, R1)
        blk.set(tracing.LANE_HOPS, torch.cat([hv[:, None], g[..., 1]], 1), res_g, R1)
        blk.set(tracing.LANE_RTT, torch.cat([(tr.req_ticks + back)[:, None],
                                             2 * lq if ls is None else lq + g[..., 4]], 1),
                res_g, R1)
        valid = state.alive.gather(-1, vic.clamp(0, W - 1).long().flatten(1)).view(vic.shape)
        if outage:
            valid = valid & reachable(e[..., None], warr, vic)
        blk.set(tracing.LANE_KIND, torch.where(valid, tracing.EV_EMPTY_VICTIM,
                                               tracing.EV_SEVERED_DENIAL), res_g, R1)
        res = (torch.cat([arrived[:, None], torch.stack([x[1] for x in drawn_rounds], 1)], 1)
               & (at < n[..., None]) & run[..., None])
        # each resolution's cell in a (G, FB, groups, W) grid of the window
        at = torch.where(res, at, FB)
        occ = torch.zeros((G, FB + 1, W), dtype=_I32, device=device).scatter_(
            1, at.long(), 1)[:, :FB]
        key = at.clamp(max=FB - 1) * W + warr
        if redraw is not None:
            # the unreachable draws: the rows an idle worker spends in
            # [candidate, draw) at its active ticks, by GLOBAL's points only
            # (the radius tables are masked to reachable victims), where it
            # could attempt at all
            lo = torch.stack(redraw[0], 1).clamp(max=FB).long()
            hi = torch.stack(redraw[1], 1).clamp(max=FB).long()
            span = torch.zeros((G, FB + 1, W), dtype=_I32, device=device)
            span.scatter_add_(1, lo, torch.ones_like(lo, dtype=_I32))
            span.scatter_add_(1, hi, torch.full_like(hi, -1, dtype=_I32))
            rows = torch.arange(FB, device=device)
            no_live = ((span.cumsum(1, dtype=_I32)[:, :FB] > 0) & (near >= 0)
                       & ~reach_rows & (rows[:, None] < n[..., None])
                       & can_attempt(e, state.fails)[:, None] & run[..., None])
            if active_rows is not None:
                no_live = no_live & active_rows
            occ = torch.stack([no_live.to(_I32), occ], 2)          # (G, FB, 2, W)
            key = key + (at.clamp(max=FB - 1) + 1) * W
        flat = occ.flatten(1)
        rank = flat.cumsum(1, dtype=_I32) - flat
        res_rank = rank.gather(1, key.flatten(1).long())
        if redraw is None:
            return blk.append(tr, trc, res.flatten(1), rank=res_rank)
        blk.set(tracing.LANE_TICK, t[..., None] + rows[:, None], 0, (FB, W))
        blk.set(tracing.LANE_VICTIM, near, 0, (FB, W))
        blk.set(tracing.LANE_HOPS, topo.hop_dist(mesh, coords, near), 0, (FB, W))
        return blk.append(tr, trc, torch.cat([no_live.flatten(1), res.flatten(1)], 1),
                          rank=torch.cat([rank.view(G, FB, 2, W)[:, :, 0].flatten(1),
                                          res_rank], 1))

    def iteration(carry):
        """One loop iteration of device tensors only — tick, next event,
        famine replay, leap — for every point at once, with no host sync.
        Returns the carry after it and the per-point flag ``live & (t <
        max_ticks)`` of the carry before it: the loop keeps a point's new
        carry only where its flag is set, so a finished point's fields, its
        iteration count `events` included, stay as they were."""
        state, snap, t, live, iters, tr = carry
        run = live & (t < cfg.max_ticks)
        e0, e1 = epoch(t), epoch(t + 1)
        near, far = draws(t, e0, e1)
        new, snap, tr, live_n = tick_fn(state, snap, tr, t, near, far, run, e0)
        t_n, e_n = t + 1, e1
        if leap_mode:
            ne = next_event(new, t_n, e_n)
            if FB:
                new, tr, t_n, live_n, ne, e_n = famine_ff(
                    new, tr, t_n, live_n, ne, near[:, 1:],
                    None if far is None else far[:, 1:], e_n, run)
            new, tr, t_n, live_n = leap(new, tr, t_n, live_n, ne, speed_at(e_n), run)
        return (new, snap, t_n, live_n, iters + 1, tr), run

    # only TC consumes snapshots: other runs carry none
    snap0 = _map(torch.clone, state0) if tc else ()
    carry = (state0, snap0, scalar(0),
             torch.ones((G, 1), dtype=torch.bool, device=device), scalar(0), tr0)
    loop = _replay_loop if on_cuda else _eager_loop
    state, _, t, _, iters, tr = loop(iteration, carry, cfg.max_ticks)
    if trc is not None:
        # attempts still in their request flight when the run ended, stamped
        # at the end tick in its epoch; the rtt lane holds the request leg
        tr = tracing.emit(tr, trc, (state.phase == PHASE_REQ) & state.alive, tick=t,
                          kind=tracing.EV_PENDING, worker=warr, victim=state.victim,
                          hops=topo.hop_dist(mesh, coords, state.victim),
                          rtt=tr.req_ticks, epoch=0 if ls is None else epoch(t))
    return state, t[:, 0], iters[:, 0], tr


def _loop_done(carry, max_ticks: int) -> bool:
    """The host's read of the loop's done flag, true when no point is live
    (one device-to-host sync)."""
    t, live = carry[2], carry[3]
    return not bool((live & (t < max_ticks)).any())


def _eager_loop(body, carry, max_ticks: int):
    """The plain path: `body` run eagerly, the done flag read every
    DONE_EVERY iterations. An iteration in which every point runs keeps its
    new carry whole (the host reads the flags: on the CPU that costs no
    wait). Inference mode spares each of an iteration's ~1,100 small
    operations autograd's bookkeeping."""
    with torch.inference_mode():
        while True:
            for _ in range(DONE_EVERY):
                new, run = body(carry)
                carry = new if bool(run.all()) else _masked(run, new, carry)
            if _loop_done(carry, max_ticks):
                return carry


@contextlib.contextmanager
def _no_host_sync():
    """Make any host-device synchronization inside raise (CUDA's sync debug
    mode)."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _replay_loop(body, carry, max_ticks: int):
    """The card's path: one iteration of `body` captured as a CUDA graph
    over static buffers (each replay writes its masked outputs back into
    them, per point) and replayed, the done flag read every DONE_EVERY
    iterations. One iteration runs eagerly first, to warm up. The warm-up
    and the replays run with host syncs made errors; a failed capture or
    replay raises, never falling back to the eager loop."""
    from ..kernels import ops

    static = _map(torch.clone, carry)

    def step():  # the masked commit, written into the static buffers
        new, run = body(static)
        for src, dst in zip(_leaves(new), _leaves(static)):
            if not _same_storage(src, dst):
                torch.where(_lead(run, dst), src, dst, out=dst)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), _no_host_sync():
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with ops.recording() as per_replay:
        with torch.cuda.graph(graph):
            step()
    while not _loop_done(static, max_ticks):
        with _no_host_sync():
            for _ in range(DONE_EVERY):
                graph.replay()
        ops.add_replays(per_replay, DONE_EVERY)
    return static


def _ckpt_state_bytes(mesh: topo.MeshTopology, cfg: StaticConfig) -> int:
    return mesh.num_workers * cfg.capacity * 4 * 4 + mesh.num_workers * 4


def _finalize(state: SimState, ticks: int, iters: int,
              mesh: topo.MeshTopology, cfg: StaticConfig,
              trace: tracing.Trace | None = None,
              timeseries: tracing.TimeSeries | None = None) -> SimResult:
    """One point's `SimResult` from its slice of the state (host tensors)
    and its flight recorder's views (None when untraced)."""
    def np_(x):
        return x.numpy()

    busy_w = np_(state.busy)
    att_w, suc_w = np_(state.attempts), np_(state.successes)
    att, suc = int(att_w.sum()), int(suc_w.sum())
    busy = int(busy_w.astype(np.int64).sum())
    alive_n = int(np_(state.alive).sum())
    hop_units = (int(state.hops_hi) << _HOP_LANE_BITS) + int(state.hops_lo)
    soj_sum = (int(state.soj_hi) << _HOP_LANE_BITS) + int(state.soj_lo)
    req_done = int(state.arr_done)
    overflow_w = np_(state.overflow)
    return SimResult(
        result=int(np_(state.acc).astype(np.int64).sum() % tasks.RESULT_MOD),
        ticks=ticks, nodes=int(np_(state.nodes).sum()), attempts=att,
        successes=suc, p_success=suc / max(att, 1), busy_ticks=busy,
        steal_wait_ticks=int(np_(state.steal_wait).astype(np.int64).sum()),
        bytes_hops=float(hop_units * STEAL_MSG_BYTES),
        ckpt_bytes=float(int(state.ckpt_count) * _ckpt_state_bytes(mesh, cfg)),
        overflow=int(overflow_w.astype(np.int64).sum()),
        utilization=busy / max(ticks * max(alive_n, 1), 1),
        per_worker_busy=busy_w,
        events=iters,
        per_worker_overflow=overflow_w,
        per_worker_stolen=np_(state.stolen_from),
        per_worker_hiwater=np_(state.hiwater),
        per_worker_attempts=att_w,
        per_worker_successes=suc_w,
        trace=trace, timeseries=timeseries,
        arrivals_injected=int(state.arr_injected),
        arrivals_dropped=int(state.arr_dropped),
        requests_done=req_done,
        sojourn_sum_ticks=soj_sum,
        sojourn_mean=soj_sum / max(req_done, 1),
        sojourn=tracing.sojourn_stats(trace) if trace is not None else None)


def stack_params(params_list) -> SimParams:
    """Stack `SimParams` points (or `SimConfig`s, whose `params` are taken)
    into one `SimParams` of (G,) int32 host tensors: the grid argument of
    the simulator's core, which moves it to its device. Strategies may be
    `Strategy` enums, their value strings or codes."""
    pts = [p.params if isinstance(p, SimConfig) else p for p in params_list]
    if not pts:
        raise ValueError("stack_params needs at least one SimParams point")
    pts = [p._replace(strategy=stealing.strategy_code(p.strategy)) for p in pts]
    return SimParams(*(torch.tensor([int(x) for x in leaf], dtype=_I32)
                       for leaf in zip(*pts)))


def _run_grid(workload, mesh: topo.MeshTopology, cfg: StaticConfig,
              points: list, device, sched: _Schedules, linkstate=None,
              routing: str = "auto", arrivals=None) -> list[SimResult]:
    """Check and run a grid of `SimParams` points in one `_sim_core` call,
    every point under the schedules `sched`, the link state `linkstate` (a
    schedule compiled under `routing`, or prebuilt tables) and the traffic
    `arrivals` (an `ArrivalConfig` or prebuilt `ArrivalArrays`; None: a
    closed system); one `SimResult` per point, in order."""
    _check_static(cfg)
    for p in points:
        _check_params(p)
        _check_arrivals(arrivals, p)
    dev = _resolve_device(device, cfg)
    ls = _linkstate_tables(linkstate, mesh, routing, dev)
    ar = _arrival_tables(arrivals, mesh, dev)
    state, ticks, iters, tr = _sim_core(workload, mesh, cfg, stack_params(points),
                                        dev, sched, ls, ar)
    # to the host: what the results read (not the rings, loot or ledger)
    host = _map(torch.Tensor.cpu, state._replace(
        deque=(), loot=(), sup_buf=(), sup_thief=(), sup_n=()))
    ticks, iters = ticks.tolist(), iters.tolist()
    views = [(None, None)] * len(points)
    if cfg.trace is not None:
        # the event rings up to the longest written prefix, and the bins
        n = tr.n[:, 0].cpu()
        ev = tr.ev[:, :int(n.clamp(max=cfg.trace.ring_capacity).max())].cpu().numpy()
        ts = tr.ts.cpu().numpy()
        views = [tracing.finalize(tracing.TraceState(ev=ev[g], n=n[g], req_ticks=None,
                                                     ts=ts[g], famine=None), cfg.trace)
                 for g in range(len(points))]
    return [_finalize(_map(lambda x: x[g], host), ticks[g], iters[g], mesh, cfg, *views[g])
            for g in range(len(points))]


def simulate(workload, mesh: topo.MeshTopology, cfg: SimConfig | None = None,
             fail_time=None, speed=None, linkstate=None, wake_time=None,
             fail_period=None, routing_backend: str = "auto", arrivals=None,
             *, device=None) -> SimResult:
    """Run the simulator on `device` (default: the CUDA device; raises if
    there is none — pass ``device="cpu"`` for the plain PyTorch path): a
    grid of one point on the core `simulate_sweep` runs. Arguments follow
    the reference's `simulate`: `fail_time[w]` is worker w's death tick (-1:
    immortal), `wake_time[w]` the tick a dead worker rejoins with an empty
    deque (-1: never; after its death), `fail_period[w]` the cycle of a
    periodic (fail, wake) schedule (-1: one-shot), `speed[w]` its straggler
    divisor (1: nominal); `cfg.recovery`, `cfg.preshed` and
    `cfg.warn_ticks` say what a death costs. With `linkstate` (a
    `linkstate.LinkStateSchedule`, or prebuilt `LinkStateArrays` taken as
    they are) hop latency, link availability and speeds follow the
    piecewise-constant schedule instead of `cfg.hop_ticks` (then unused;
    `speed` must be None), and `routing_backend` picks the outage tables'
    layout ('dense', 'sparse', or 'auto': sparse from
    `linkstate.SPARSE_AUTO_MIN_WORKERS` workers). With `arrivals` (an
    `arrivals.ArrivalConfig`, or prebuilt `ArrivalArrays` taken as they are)
    and ``cfg.arrival_gap_q8 > 0`` an open-loop request stream feeds the
    root workload: requests of `task_cost` work units land on ground-station
    workers at exponential gaps (mean ``arrival_gap_q8 / 256`` ticks,
    thinned by the rate schedule and the burst window), `SimResult` counts
    them and, traced, gives their sojourn percentiles."""
    cfg = cfg or SimConfig()
    _check_linkstate(linkstate, speed)
    sched = _schedules(mesh.num_workers, fail_time, speed, wake_time, fail_period)
    return _run_grid(workload, mesh, cfg.static, [cfg.params], device, sched,
                     linkstate, routing_backend, arrivals)[0]


def simulate_batch(workload, mesh: topo.MeshTopology,
                   cfg: SimConfig | None = None, seeds=(0,), fail_time=None,
                   speed=None, linkstate=None, wake_time=None,
                   fail_period=None, routing_backend: str = "auto",
                   arrivals=None, *, device=None) -> list[SimResult]:
    """One simulation per seed, all in one grid: every seed shares `cfg`
    (whose own `seed` is ignored), the schedules and the link state; the
    grid runs until its slowest seed ends. Returns one `SimResult` per seed,
    each equal to `simulate` with that seed, `events` included. Other
    arguments as `simulate`'s."""
    cfg = cfg or SimConfig()
    _check_linkstate(linkstate, speed)
    sched = _schedules(mesh.num_workers, fail_time, speed, wake_time, fail_period)
    return _run_grid(workload, mesh, cfg.static,
                     [cfg.params._replace(seed=int(s)) for s in seeds], device, sched,
                     linkstate, routing_backend, arrivals)


def simulate_sweep(workload, mesh: topo.MeshTopology, cfg, params_list,
                   fail_time=None, speed=None, linkstate=None, wake_time=None,
                   fail_period=None, routing_backend: str = "auto",
                   devices=None, arrivals=None, *, device=None) -> list[SimResult]:
    """Run a whole grid of points in one `_sim_core` call: one loop (on the
    card, one captured CUDA graph) advances every point, each with its own
    clock, and a point that has ended stays as it was while the rest run
    on. `cfg` supplies the static half (a `StaticConfig`, or a `SimConfig`
    whose per-point fields are ignored); `params_list` is the grid, a
    sequence of `SimParams` or `SimConfig`s, whose `warn_ticks` and
    `ckpt_interval` are per point; every point shares the failure, wake-up
    and straggler schedules, the link state (each point in the epoch of
    its own clock) and the arrivals' shape (each point's stream from its own
    seed, `arrival_gap_q8` and `arrival_batch`). Returns one `SimResult` per point, in order,
    each equal to `simulate` of that point, `events` included. `devices`
    may name one device (it then stands for `device`); a grid sharded over
    several raises `NotImplementedError` (ROADMAP Queue 1 item 13b). Other
    arguments as `simulate`'s."""
    scfg = cfg.static if isinstance(cfg, SimConfig) else cfg
    _check_linkstate(linkstate, speed)
    sched = _schedules(mesh.num_workers, fail_time, speed, wake_time, fail_period)
    if devices is not None:
        devices = list(devices)
        if len(devices) > 1:
            raise _not_ported("devices")
        if devices and device is None:
            device = devices[0]
    pts = [p.params if isinstance(p, SimConfig) else p for p in params_list]
    if not pts:
        return []
    return _run_grid(workload, mesh, scfg, pts, device, sched, linkstate,
                     routing_backend, arrivals)
