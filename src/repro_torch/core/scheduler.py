"""Bulk-synchronous round executor of work stealing (uniform-latency
setting, paper §4), in torch.

The asynchronous runtime is emulated in *steal rounds*: per round every
worker either (a) burns one unit of sequential leaf work, (b) pops and
expands task nodes (`expansions_per_round` of them: spawns are ~free next to
leaf work), or (c) — if its deque is empty — makes `steal_subrounds` steal
attempts under the configured strategy. A granted steal delivers the
victim's bottom task in the same sub-round. This is the executor the
paper's own experiments run on (Fig. 3, Table 2, Fig. 4: the
`benchmarks.fig3_scaling` and `fig4_relative` scripts); the latency-aware
variant is `simulator`.

It reproduces the reference's `repro.core.scheduler.run_vectorized` /
`run_vectorized_batch` / `run_sweep` field for field, per-worker arrays
included: each round's key is ``fold_in(PRNGKey(seed), round)`` and each
sub-round's ``fold_in(key, sub)`` (`core.rng`, bit-exact threefry), every
quantity is int32 with the reference's wrap-around, and the round follows
the reference step by step — including two of its behaviours the port keeps
as they are: the thief mask reads only the *last* expansion's pop (a worker
that popped a leaf of cost > 1 in an earlier expansion and then found its
deque empty steals in the same round), and a thief's loot push drops its
overflow flag (`overflow` counts only the expansions' pushes).

The core runs a grid of G points at once (`run_sweep`, `run_vectorized_batch`;
`run_vectorized` is a grid of one), as the simulator's does: every state leaf
has a leading G axis, the deques enter the deque layer and the
`steal_compact` kernel as G·W rows, and each point has its own round count
and liveness flag ((G, 1) columns), key, strategy, escalation threshold and
grant budget. The grid's strategies are known on the host: each present
strategy draws for every point on the point's own key, and each point takes
its own strategy's victims (the reference's `lax.switch` under `vmap`
evaluates every branch on the same key). A point whose condition ``live &
(rounds < max_rounds)`` turned false keeps its state while the others run
on. The loop is the simulator's: eager on the CPU (`_eager_loop`), on the
card one round captured as a CUDA graph and replayed, the done flag read
every `simulator.DONE_EVERY` rounds (`_replay_loop`).

Each steal sub-round exports the victims' granted bottom records through
`deque.export_bottom`: the hand-written `steal_compact` kernel on the card,
its plain version for CPU tensors. The pushes write the ring in place
(`deque.push_top_`, `push_top_many_`: only the pushed records move, where a
functional push would pass over every ring — 4,096 slots a worker at Fig.
3's capacity; the staged push log, one `deque.apply` a round, runs more
operations a round and exports without `steal_compact`:
`benchmarks.sched_backends` times both), and a point that has stopped
neither pops nor steals, so its ring stays as its run left it.

The sharded executor (`make_sharded_round`, `build_sharded_run`) is the
reference's `shard_map` one: one worker a shard of a ("row", "col") mesh
(`mesh_comm`: every worker on one device, or one a `torch.distributed`
rank), one pop/expand and one steal a round whatever `expansions_per_round`
and `steal_subrounds` say, NEIGHBOR through single-hop ppermutes (a request
and a reply a direction, each shard drawing its direction on its own key
``fold_in(key, my_id)``, a victim serving its requesters in direction
order), GLOBAL through all_gathers of the sizes, thief flags and bottom
windows and `resolve_grants` on every shard, and a termination psum. Its
rounds are not `run_vectorized`'s: it is held to the reference's
`build_sharded_run`, leaf by leaf.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import deque as dq
from . import mesh_comm, resolve_device
from . import rng, stealing, tasks
from . import topology as topo
from .simulator import _eager_loop, _map, _replay_loop

_I32 = torch.int32


class WorkerState(NamedTuple):
    """The executor's state; in the core every leaf has a leading G axis:
    (G, W) per-worker leaves, an (G, 1) overflow column."""
    deque: dq.DequeState
    acc: torch.Tensor        # (W,) int32 result checksum (mod RESULT_MOD)
    work: torch.Tensor       # (W,) int32 remaining sequential work units
    fails: torch.Tensor      # (W,) int32 consecutive failed steal attempts
    # stats
    attempts: torch.Tensor   # (W,) int32 steal attempts
    successes: torch.Tensor  # (W,) int32 granted steals
    nodes: torch.Tensor      # (W,) int32 tree nodes expanded
    busy: torch.Tensor       # (W,) int32 busy (work/expand) rounds
    overflow: torch.Tensor   # () int32 dropped pushes (must stay 0)


class RunResult(NamedTuple):
    result: int
    rounds: int
    nodes: int
    attempts: int
    successes: int
    overflow: int
    p_success: float
    per_worker_busy: np.ndarray
    per_worker_attempts: np.ndarray
    per_worker_successes: np.ndarray


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    strategy: stealing.Strategy = stealing.Strategy.NEIGHBOR
    capacity: int = 1024
    max_grants_per_victim: int = 4
    escalate_after: int = 4       # ADAPTIVE only
    max_rounds: int = 1_000_000
    seed: int = 0
    # steal attempts per work round (steal RTT ⋘ task time on the paper's
    # interconnect; the latency-aware simulator prices attempts in ticks)
    steal_subrounds: int = 8
    # task expansions (spawns) per round: a worker unwinds internal nodes
    # until it reaches leaf work
    expansions_per_round: int = 8

    @property
    def static(self) -> "SchedStatic":
        """The half that sets shapes and unrolled loop counts."""
        return SchedStatic(capacity=self.capacity, max_rounds=self.max_rounds,
                           steal_subrounds=self.steal_subrounds,
                           expansions_per_round=self.expansions_per_round)

    @property
    def params(self) -> "SchedParams":
        """The per-point half: the sweep axes (strategy as its
        `stealing.*_CODE` int)."""
        return SchedParams(strategy=stealing.strategy_code(self.strategy),
                           escalate_after=self.escalate_after,
                           max_grants_per_victim=self.max_grants_per_victim,
                           seed=self.seed)

    def split(self) -> "tuple[SchedStatic, SchedParams]":
        return self.static, self.params


@dataclasses.dataclass(frozen=True)
class SchedStatic:
    """Static half of a `SchedulerConfig`: the fields every point of a grid
    shares (ring capacity, the round cap, unrolled loop counts)."""
    capacity: int = 1024
    max_rounds: int = 1_000_000
    steal_subrounds: int = 8
    expansions_per_round: int = 8


class SchedParams(NamedTuple):
    """Per-point half of a `SchedulerConfig`: int leaves, stacked into (G,)
    int32 tensors by `stack_sched_params` for `run_sweep`."""
    strategy: int = stealing.NEIGHBOR_CODE
    escalate_after: int = 4
    max_grants_per_victim: int = 4
    seed: int = 0


def stack_sched_params(params_list) -> SchedParams:
    """Stack `SchedParams` points into one `SchedParams` of (G,) int32 host
    tensors; strategies may be `Strategy` enums, value strings or codes."""
    params_list = list(params_list)
    if not params_list:
        raise ValueError("stack_sched_params needs at least one point")
    pts = [p._replace(strategy=stealing.strategy_code(p.strategy)) for p in params_list]
    return SchedParams(*(torch.tensor([int(x) for x in leaf], dtype=_I32)
                         for leaf in zip(*pts)))


def _check_sched_params(p: SchedParams):
    if int(p.max_grants_per_victim) > stealing.GRANT_WIDTH:
        raise ValueError(
            f"max_grants_per_victim={int(p.max_grants_per_victim)} exceeds "
            f"the grant/export staging width GRANT_WIDTH="
            f"{stealing.GRANT_WIDTH}: thieves ranked beyond the staging "
            "block would receive duplicate records while the victim loses "
            "the real tasks")
    code = stealing.strategy_code(p.strategy)
    if not 0 <= code < len(stealing.CODE_STRATEGIES):
        raise ValueError(f"unknown strategy code {code}")


def _init_state(workload, num_workers: int, capacity: int, points: int = 1,
                device="cpu") -> WorkerState:
    """`points` fresh states, each with the root task on its worker 0."""
    G, W = points, num_workers
    deques = dq.make(G * W, capacity, device=device)
    root = torch.as_tensor(workload.root_task(), device=device)
    deques, _ = dq.push_top(deques, root[None].expand(G * W, root.shape[-1]),
                            torch.arange(G * W, device=device) % W == 0)
    z = torch.zeros((G, W), dtype=_I32, device=device)
    return WorkerState(deque=_grid(deques, G, W), acc=z, work=z.clone(),
                       fails=z.clone(), attempts=z.clone(),
                       successes=z.clone(), nodes=z.clone(), busy=z.clone(),
                       overflow=torch.zeros((G, 1), dtype=_I32, device=device))


def _rows(d: dq.DequeState) -> dq.DequeState:
    """The grid's (G, W, ...) deques as the deque layer's G·W rows."""
    return dq.DequeState(*(x.flatten(0, 1) for x in d))


def _grid(d: dq.DequeState, G: int, W: int) -> dq.DequeState:
    return dq.DequeState(*(x.unflatten(0, (G, W)) for x in d))


def _draws(present, keys, mesh_tables, W: int) -> dict:
    """The all-thieves victim draws of every strategy in `present` (host
    codes) under `keys` (a pair of (..., S, 1) tensors: one key a
    sub-round), in one threefry pass each: {code: (near, far)} with (..., S,
    W) blocks. `far` is ADAPTIVE's radius-2 draw (None otherwise);
    LIFELINE's `near` is its global fallback. A draw depends on the key
    alone, so a round draws all its sub-rounds at once; `_pick` applies the
    thief mask and the fail counts."""
    nbrs, r2 = mesh_tables["neighbors"], mesh_tables["radius2"]
    all_thieves = torch.ones((W,), dtype=torch.bool, device=nbrs.device)
    out = {}
    for c in present:
        if c == stealing.GLOBAL_CODE:
            out[c] = (stealing.choose_global(keys, W, all_thieves), None)
        elif c == stealing.NEIGHBOR_CODE:
            out[c] = (stealing.choose_neighbor(keys, nbrs, all_thieves), None)
        elif c == stealing.LIFELINE_CODE:
            _, k2 = rng.split(keys)
            out[c] = (stealing.choose_global(k2, W, all_thieves), None)
        else:
            k1, k2 = rng.split(keys)
            out[c] = (stealing.choose_neighbor(k1, nbrs, all_thieves),
                      stealing.choose_neighbor(k2, r2, all_thieves))
    return out


def _pick(code, escalate_after, mesh_tables, draws: dict, sub: int, is_thief,
          fails):
    """Sub-round `sub`'s victims from a round's `_draws`, per point by its
    strategy `code` ((G, 1)): exactly what `stealing.choose_*` draws on the
    sub-round's key for the thieves `is_thief`."""
    victim = None
    for c, (near, far) in draws.items():
        v = near[..., sub, :]
        if c == stealing.ADAPTIVE_CODE:
            v = torch.where(fails >= escalate_after, far[..., sub, :], v)
        elif c == stealing.LIFELINE_CODE:
            # lifelines round-robin by fail count, then the global fallback
            lifelines = mesh_tables["lifelines"]
            W, L = lifelines.shape
            lane = lifelines[torch.arange(W, device=fails.device),
                             fails.clamp(0, L - 1).long()]
            v = torch.where((fails >= L) | (lane == topo.NO_NEIGHBOR), v, lane)
        v = torch.where(is_thief, v, topo.NO_NEIGHBOR)
        victim = v if victim is None else torch.where(code == c, v, victim)
    return victim


def _select_victims(code, escalate_after, mesh_tables, key, is_thief, fails,
                    W, present=None):
    """Each point's victims under one sub-round key (a pair of (G, 1)
    tensors) by its strategy `code` ((G, 1)): every strategy in `present`
    (host codes; default all four) draws on every point's key, as the
    reference's `lax.switch` branches do under `vmap`, and each point takes
    its own strategy's draw."""
    present = sorted(stealing.CODE_STRATEGIES) if present is None else present
    keys = tuple(k[..., None] for k in key)
    return _pick(code, escalate_after, mesh_tables,
                 _draws(present, keys, mesh_tables, W), 0, is_thief, fails)


def _round(state: WorkerState, key, tables, mesh_tables, cfg: SchedStatic,
           p: SchedParams, present=None, run=None):
    """One bulk-synchronous round of every point. `p` holds (G, 1) device
    columns, `key` each point's round key (a pair of (G, 1) tensors),
    `present` the grid's strategy codes (default all four). The pushes
    write the ring in place (`deque.push_top_`, `push_top_many_`): where
    the per-point flag `run` ((G, 1); None: every point) is false no worker
    pops or steals, so a stopped point's ring stays bit for bit (the loop
    masks its other leaves). Returns (state, any_live (G, 1))."""
    G, W = state.acc.shape
    present = sorted(stealing.CODE_STRATEGIES) if present is None else present
    i32 = _I32

    # (a) workers with pending sequential work burn one unit.
    burning = state.work > 0
    idle = ~burning if run is None else (~burning) & run
    work = state.work - burning.to(i32)

    # (b) free workers unwind tasks until they hit leaf work.
    rows = _rows(state.deque)
    acc, nodes, overflow = state.acc, state.nodes, state.overflow
    did_work = burning
    popped = None
    for _ in range(max(cfg.expansions_per_round, 1)):
        can_expand = idle & (work == 0) & (rows.size.view(G, W) > 0)
        rows, task, ok = dq.pop_top(rows, can_expand.flatten())
        popped = ok.view(G, W)
        ex = tasks.expand(task, ok, tables)
        rows, over = dq.push_top_many_(rows, ex["children"], ex["n_children"])
        acc = torch.remainder(acc + ex["value"].view(G, W), tasks.RESULT_MOD)
        work = work + (ex["cost"].view(G, W) - 1).clamp(min=0) * popped.to(i32)
        nodes = nodes + ex["nodes"].view(G, W)
        did_work = did_work | popped
        overflow = overflow + over.view(G, W).sum(-1, keepdim=True, dtype=i32)
    busy = state.busy + did_work.to(i32)

    # (c) empty workers steal, `steal_subrounds` attempts a round; the thief
    # mask reads the last expansion's pop, as the reference's does
    attempts, successes, fails = state.attempts, state.successes, state.fails
    can_thieve = idle & (~popped)
    gidx = torch.arange(G, device=acc.device)[:, None]
    S = max(cfg.steal_subrounds, 1)
    # every sub-round's key, fold_in(key, sub), and its draws, in one pass
    subs = torch.arange(S, device=acc.device)[:, None]
    draws = _draws(present, rng.fold_in(tuple(k[..., None] for k in key), subs),
                   mesh_tables, W)
    for sub in range(S):
        size = rows.size.view(G, W)
        is_thief = can_thieve & (size == 0)
        victim = _pick(p.strategy, p.escalate_after, mesh_tables, draws, sub,
                       is_thief, fails)
        plan = stealing.resolve_grants(victim, size, p.max_grants_per_victim)
        # victims export their granted bottom records as a dense staging
        # block (the `steal_compact` kernel on the card) and advance
        v = plan.victim.clamp(0, W - 1).long()
        stolen_blk, rows = dq.export_bottom(rows, plan.taken.flatten(),
                                            stealing.GRANT_WIDTH)
        stolen = stolen_blk.unflatten(0, (G, W))[
            gidx, v, plan.rank.clamp(0, stealing.GRANT_WIDTH - 1).long()]
        # thieves push their loot; the push's overflow flag is dropped
        rows, _ = dq.push_top_(rows, stolen.flatten(0, 1), plan.got.flatten())
        attempts = attempts + is_thief.to(i32)
        successes = successes + plan.got.to(i32)
        fails = torch.where(plan.got, 0, fails + is_thief.to(i32))

    deque_ = _grid(rows, G, W)
    new_state = WorkerState(deque=deque_, acc=acc, work=work, fails=fails,
                            attempts=attempts, successes=successes, nodes=nodes,
                            busy=busy, overflow=overflow)
    any_live = (deque_.size.sum(-1, keepdim=True, dtype=i32)
                + work.sum(-1, keepdim=True, dtype=i32)) > 0
    return new_state, any_live


def _mesh_tables(mesh: topo.MeshTopology, device, link_up=None) -> dict:
    neighbors = torch.as_tensor(stealing.neighbor_list(mesh), device=device)
    if link_up is not None:
        # a frozen link-state snapshot (one epoch's `up_at`): dead links drop
        # out of the radius-1 victim set for the whole run; ADAPTIVE's
        # radius-2 table and LIFELINE's lifelines stay unmasked
        up = torch.as_tensor(np.asarray(link_up, bool), device=device)
        neighbors = torch.where(up & (neighbors >= 0), neighbors, topo.NO_NEIGHBOR)
    return {"neighbors": neighbors,
            "radius2": torch.as_tensor(stealing.radius2_list(mesh), device=device),
            "lifelines": torch.as_tensor(stealing.lifeline_list(mesh.num_workers),
                                         device=device)}


# Bumped once per `_run_core` call, i.e. per grid: on the card, one CUDA
# graph capture. Read via `run_trace_count()`, the port's mirror of the
# reference's count of `_run_core` traces.
_RUN_CORE_COUNT = 0


def run_trace_count() -> int:
    """Number of `_run_core` calls in this process: one per `run_vectorized`,
    `run_vectorized_batch` or `run_sweep` call, whatever the grid's size."""
    return _RUN_CORE_COUNT


def _run_core(workload, mesh: topo.MeshTopology, cfg: SchedStatic,
              p: SchedParams, link_up=None, device="cpu"):
    """Run the grid `p` (`stack_sched_params`: G points) through one loop
    on `device`. Returns (state, rounds): every state leaf with a leading G
    axis, rounds (G,)."""
    global _RUN_CORE_COUNT
    _RUN_CORE_COUNT += 1
    device = torch.device(device)
    W = mesh.num_workers
    G = int(p.strategy.shape[0])
    present = sorted(set(p.strategy.tolist()))
    pc = SchedParams(*(x.to(device=device, dtype=_I32)[:, None] for x in p))
    key0 = rng.PRNGKey(pc.seed)
    tables = workload.tables(device)
    mesh_tables = _mesh_tables(mesh, device, link_up)
    state0 = _init_state(workload, W, cfg.capacity, G, device)

    def body(carry):
        state, _, rounds, live = carry
        run = live & (rounds < cfg.max_rounds)
        state, live = _round(state, rng.fold_in(key0, rounds), tables,
                             mesh_tables, cfg, pc, present, run)
        return (state, (), rounds + 1, live), run

    carry = (state0, (), torch.zeros((G, 1), dtype=_I32, device=device),
             torch.ones((G, 1), dtype=torch.bool, device=device))
    loop = _replay_loop if device.type == "cuda" else _eager_loop
    state, _, rounds, _ = loop(body, carry, cfg.max_rounds)
    return state, rounds[:, 0]


def _finalize_run(state: WorkerState, rounds: int) -> RunResult:
    """One point's `RunResult` from its slice of the state (host tensors)."""
    attempts = int(state.attempts.sum())
    successes = int(state.successes.sum())
    return RunResult(
        result=int(state.acc.numpy().astype(np.int64).sum() % int(tasks.RESULT_MOD)),
        rounds=int(rounds),
        nodes=int(state.nodes.sum()),
        attempts=attempts,
        successes=successes,
        overflow=int(state.overflow),
        p_success=successes / max(attempts, 1),
        per_worker_busy=state.busy.numpy(),
        per_worker_attempts=state.attempts.numpy(),
        per_worker_successes=state.successes.numpy(),
    )


def _run_grid(workload, mesh: topo.MeshTopology, scfg: SchedStatic, pts: list,
              link_up, device) -> list[RunResult]:
    for p in pts:
        _check_sched_params(p)
    dev = resolve_device(device, "repro_torch's scheduler runs")
    state, rounds = _run_core(workload, mesh, scfg, stack_sched_params(pts),
                              link_up, dev)
    host = _map(torch.Tensor.cpu, state._replace(deque=()))
    rounds = rounds.tolist()
    return [_finalize_run(_map(lambda x: x[g], host), rounds[g])
            for g in range(len(pts))]


def run_vectorized(workload, mesh: topo.MeshTopology,
                   cfg: SchedulerConfig | None = None, link_up=None, *,
                   device=None) -> RunResult:
    """Execute `workload` on `mesh` and return aggregate statistics, on
    `device` (default: the CUDA device; raises if there is none — pass
    ``device="cpu"`` for the plain PyTorch path).

    `link_up` — optional (W, 4) bool link-availability snapshot (a single
    epoch of a `linkstate.LinkStateSchedule`); down links are removed from
    radius-1 victim selection for the whole run."""
    cfg = cfg or SchedulerConfig()
    scfg, p = cfg.split()
    return _run_grid(workload, mesh, scfg, [p], link_up, device)[0]


def run_vectorized_batch(workload, mesh: topo.MeshTopology,
                         cfg: SchedulerConfig | None = None,
                         seeds=(0,), link_up=None, *, device=None) -> list[RunResult]:
    """One executor run per seed, all in one grid (one `_run_core` call).
    `cfg.seed` is ignored; returns one `RunResult` per seed, identical to
    `run_vectorized` with that seed."""
    cfg = cfg or SchedulerConfig()
    scfg, p = cfg.split()
    return _run_grid(workload, mesh, scfg, [p._replace(seed=int(s)) for s in seeds],
                     link_up, device)


def run_sweep(workload, mesh: topo.MeshTopology, cfg, params_list,
              link_up=None, *, device=None) -> list[RunResult]:
    """Run a whole grid of `SchedParams` points (strategy × grants × seed ×
    ...) in one `_run_core` call: on the card, one captured CUDA graph whose
    every replay advances every point. `cfg` supplies the static half (a
    `SchedStatic`, or a `SchedulerConfig` whose per-point fields are
    ignored); results equal per-point `run_vectorized` calls, in
    `params_list` order."""
    scfg = cfg.static if isinstance(cfg, SchedulerConfig) else cfg
    pts = [p.params if isinstance(p, SchedulerConfig) else p for p in params_list]
    if not pts:
        return []
    return _run_grid(workload, mesh, scfg, pts, link_up, device)


# =========================================================================== #
# The sharded executor — one worker a shard of a ("row", "col") mesh
# =========================================================================== #
def _dir_axis(direction: int) -> tuple[str, int]:
    """Map topology.DIRECTIONS index → (mesh axis name, shift)."""
    return [("row", -1), ("row", 1), ("col", -1), ("col", 1)][direction]


def _shift_perm(n: int, shift: int, torus: bool) -> list[tuple[int, int]]:
    """(src, dst) pairs sending each index to index+shift along one axis."""
    pairs = []
    for i in range(n):
        j = i + shift
        if torus:
            j %= n
        if 0 <= j < n:
            pairs.append((i, j))
    return pairs


def _opposite(direction: int) -> int:
    return {0: 1, 1: 0, 2: 3, 3: 2}[direction]


def make_sharded_round(mesh_shape: tuple[int, int], cfg: SchedulerConfig,
                       tables, torus: bool = False, *, mesh):
    """The per-shard round body of the sharded executor on `mesh` (a
    `mesh_comm.LocalMesh` or `DistMesh` of axes "row", "col"). The state is
    a `WorkerState` whose every leaf has the mesh's shard axis in front
    (`overflow` too: one count a worker); the body reuses the deque and
    expand helpers as they are. Returns ``round_fn(state, key) -> (state,
    any_live)``, `any_live` a (shards,) bool. Only NEIGHBOR and GLOBAL have
    a sharded round; other strategies raise `ValueError`."""
    if cfg.strategy not in (stealing.Strategy.NEIGHBOR, stealing.Strategy.GLOBAL):
        raise ValueError("sharded executor supports NEIGHBOR and GLOBAL")
    mesh = mesh_comm.as_mesh(mesh)
    R, C = mesh_shape
    W = R * C
    G = cfg.max_grants_per_victim
    i32 = _I32

    def my_id():
        return mesh.axis_index("row") * C + mesh.axis_index("col")

    def neighbor_valid(direction):
        ax, shift = _dir_axis(direction)
        idx = mesh.axis_index(ax)
        if torus:
            return torch.ones_like(idx, dtype=torch.bool)
        n = R if ax == "row" else C
        return (idx + shift >= 0) & (idx + shift < n)

    def send(x, direction):
        """Single-hop ppermute of x to the `direction` neighbor."""
        ax, shift = _dir_axis(direction)
        n = R if ax == "row" else C
        return mesh.ppermute(x, ax, _shift_perm(n, shift, torus))

    def neighbor_steal(deque_, is_thief, key):
        """Paper §3.1 on mesh links: a request and a reply ppermute a
        direction."""
        S = is_thief.shape[0]
        rows = torch.arange(S, device=is_thief.device)
        # a uniformly random valid direction, each shard on its own key
        valid = torch.stack([neighbor_valid(d) for d in range(4)], -1)
        nvalid = valid.sum(-1, dtype=i32).clamp(min=1)
        k = rng.fold_in(key, my_id())
        r = rng.uniform(tuple(x[:, None] for x in k), 1, is_thief.device)[:, 0]
        pick = torch.minimum((r * nvalid.to(torch.float32)).to(i32), nvalid - 1)
        order = torch.cumsum(valid, -1, dtype=i32) - 1
        chosen = (valid & (order == pick[:, None])).to(i32).argmax(-1)
        # requests: a thief that chose d sends toward d; its victim receives
        # it from its opposite(d) side
        reqs_in = torch.stack(
            [send((is_thief & (chosen == d) & valid[:, d]).to(i32), d) for d in range(4)], -1)
        # the victim serves up to min(size, budget) requesters in direction order
        budget = deque_.size.clamp(max=cfg.max_grants_per_victim)
        ranks = torch.cumsum(reqs_in, -1, dtype=i32) - reqs_in
        grant = (reqs_in > 0) & (ranks < budget[:, None])
        cap = dq.capacity(deque_)
        replies = []
        for d in range(4):
            slot = torch.remainder(deque_.bot + ranks[:, d], cap).long()
            rec = torch.where(grant[:, d, None], deque_.buf[rows, slot], 0)
            payload = torch.cat([rec, grant[:, d, None].to(i32)], -1)
            # the thief that chose d sits on the victim's opposite(d) side
            replies.append(send(payload, _opposite(d)))
        deque_ = dq.steal_bottom(deque_, grant.sum(-1, dtype=i32))
        # the thief's reply is the one from the neighbor it targeted
        mine = torch.stack(replies, 1)[rows, chosen]
        got = is_thief & (mine[:, 4] > 0)
        deque_, _ = dq.push_top(deque_, mine[:, :4], got)
        return deque_, got

    def global_steal(deque_, is_thief, key):
        """The paper's baseline: a uniform random victim, all_gathers over
        the mesh."""
        S = is_thief.shape[0]
        rows = torch.arange(S, device=is_thief.device)
        # (shards, C, R) → worker-id order
        sizes = mesh.all_gather(mesh.all_gather(deque_.size, "row"), "col")
        sizes = sizes.transpose(1, 2).reshape(S, W)
        thief_flags = mesh.all_gather(mesh.all_gather(is_thief, "row"), "col")
        thief_flags = thief_flags.transpose(1, 2).reshape(S, W)
        victims = stealing.choose_global(key, W, thief_flags)  # the same on every shard
        plan = stealing.resolve_grants(victims, sizes, G)
        # every worker's bottom window (G, T)
        window = dq.peek_bottom_window(deque_, G)
        windows = mesh.all_gather(mesh.all_gather(window, "row"), "col")
        windows = windows.transpose(1, 2).reshape(S, W, G, window.shape[-1])
        me = my_id().long()[:, None]
        deque_ = dq.steal_bottom(deque_, plan.taken.gather(-1, me)[:, 0])
        got = plan.got.gather(-1, me)[:, 0]
        v = plan.victim.gather(-1, me)[:, 0].clamp(0, W - 1).long()
        rank = plan.rank.gather(-1, me)[:, 0].clamp(0, G - 1).long()
        deque_, _ = dq.push_top(deque_, windows[rows, v, rank], got)
        return deque_, got

    steal = neighbor_steal if cfg.strategy == stealing.Strategy.NEIGHBOR else global_steal

    def round_fn(state: WorkerState, key):
        key = tuple(x.reshape(()) if isinstance(x, torch.Tensor) else x for x in key)
        burning = state.work > 0
        work = state.work - burning.to(i32)
        can_expand = (~burning) & (state.deque.size > 0)
        deque_, task, popped = dq.pop_top(state.deque, can_expand)
        ex = tasks.expand(task, popped, tables)
        deque_, over = dq.push_top_many(deque_, ex["children"], ex["n_children"])
        acc = torch.remainder(state.acc + ex["value"], tasks.RESULT_MOD)
        work = work + (ex["cost"] - 1).clamp(min=0) * popped.to(i32)
        nodes = state.nodes + ex["nodes"]
        busy = state.busy + (burning | popped).to(i32)
        overflow = state.overflow + over

        is_thief = (~burning) & (~popped) & (deque_.size == 0)
        deque_, got = steal(deque_, is_thief, key)

        attempts = state.attempts + is_thief.to(i32)
        successes = state.successes + got.to(i32)
        fails = torch.where(got, 0, state.fails + is_thief.to(i32))
        new_state = WorkerState(deque=deque_, acc=acc, work=work, fails=fails,
                                attempts=attempts, successes=successes,
                                nodes=nodes, busy=busy, overflow=overflow)
        live_local = deque_.size + work
        live = mesh.psum(mesh.psum(live_local, "row"), "col") > 0
        return new_state, live

    return round_fn


def _sharded_init(mesh, cfg: SchedulerConfig, workload) -> WorkerState:
    """A mesh's shards' initial state: empty deques but for the root task
    on worker 0."""
    S, C, dev = mesh.shards, mesh.axis_size("col"), mesh.device
    root = torch.as_tensor(workload.root_task(), device=dev)
    me = mesh.axis_index("row") * C + mesh.axis_index("col")
    deques, _ = dq.push_top(dq.make(S, cfg.capacity, device=dev),
                            root[None].expand(S, root.shape[-1]), me == 0)
    z = torch.zeros((S,), dtype=_I32, device=dev)
    return WorkerState(deque=deques, acc=z, work=z.clone(), fails=z.clone(),
                       attempts=z.clone(), successes=z.clone(), nodes=z.clone(),
                       busy=z.clone(), overflow=z.clone())


def build_sharded_run(device_mesh, cfg: SchedulerConfig, workload,
                      torus: bool = False):
    """Return ``fn() -> (WorkerState, rounds)``: the sharded executor, one
    worker a shard of `device_mesh` (axes "row", "col"): a
    `mesh_comm.LocalMesh` (every worker on its device) or a
    `torch.distributed` `DeviceMesh` (one worker a rank; every rank returns
    the whole state). The state's leaves are in worker-id order, `overflow`
    one count a worker, as the reference's `out_specs` give them; `rounds`
    is an int. On a local mesh on the card the loop is the simulator's
    captured one (`_replay_loop`: one round a CUDA graph replay, the done
    flag read every `simulator.DONE_EVERY` rounds), on the CPU the eager
    one; a run that has stopped neither pops nor steals. A `DeviceMesh`
    runs round by round, every rank reading the termination psum."""
    mesh = mesh_comm.as_mesh(device_mesh)
    if tuple(mesh.axis_names) != ("row", "col"):
        raise ValueError(f"the sharded executor needs a ('row', 'col') mesh, got "
                         f"axes {mesh.axis_names}")
    R, C = mesh.shape
    dev = mesh.device
    tables = workload.tables(dev)
    round_fn = make_sharded_round((R, C), cfg, tables, torus, mesh=mesh)
    key0 = rng.PRNGKey(cfg.seed)

    def run_local():
        def body(carry):
            state, _, rounds, live = carry
            run = live & (rounds < cfg.max_rounds)
            state, any_live = round_fn(state, rng.fold_in(key0, rounds))
            return (state, (), rounds + 1, any_live[:1, None]), run

        carry = (_sharded_init(mesh, cfg, workload), (),
                 torch.zeros((1, 1), dtype=_I32, device=dev),
                 torch.ones((1, 1), dtype=torch.bool, device=dev))
        loop = _replay_loop if dev.type == "cuda" else _eager_loop
        state, _, rounds, _ = loop(body, carry, cfg.max_rounds)
        return state, int(rounds)

    def run_dist():
        state, rounds, live = _sharded_init(mesh, cfg, workload), 0, True
        with torch.inference_mode():
            while live and rounds < cfg.max_rounds:
                state, any_live = round_fn(state, rng.fold_in(key0, rounds))
                live, rounds = bool(any_live[0]), rounds + 1
            return _map(mesh.gather_shards, state), rounds

    return run_local if mesh.local else run_dist
