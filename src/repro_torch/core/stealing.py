"""Victim-selection strategies and steal-conflict resolution (paper §3.1).

  * GLOBAL   — victim uniform at random over all other workers.
  * NEIGHBOR — victim uniform at random over the thief's direct mesh
               neighbors (the paper's contribution).
  * LIFELINE — hypercube lifelines tried first, then global random.
  * ADAPTIVE — neighbor-only, widening to radius-2 after `escalate_after`
               consecutive failed attempts (paper §6).

Selection is vectorized over workers and keyed by a threefry key
(`core.rng`, ints or device tensors), drawing exactly the victims
`jax.random` draws. Conflicts are resolved by `resolve_grants`: thieves
that pick the same victim are ranked by (priority, worker id) and served one
bottom task each while the victim's tasks and per-round budget last. Under a
time-varying link state (`core.linkstate`) victim tables are masked: dead
links out of the radius-1 set (ADAPTIVE's near draw prefers the cheapest live
neighbor, `cheapest_live_table`) and unreachable workers out of the radius-2
set (`mask_reachable`). The famine fast path's support — which workers'
probes may succeed, and a batch of consecutive ticks' victim draws in one
pass — closes the module.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np
import torch

from . import rng
from . import topology as topo


class Strategy(enum.Enum):
    GLOBAL = "global"
    NEIGHBOR = "neighbor"
    LIFELINE = "lifeline"
    ADAPTIVE = "adaptive"


GLOBAL_CODE, NEIGHBOR_CODE, LIFELINE_CODE, ADAPTIVE_CODE = range(4)
STRATEGY_CODES = {
    Strategy.GLOBAL: GLOBAL_CODE,
    Strategy.NEIGHBOR: NEIGHBOR_CODE,
    Strategy.LIFELINE: LIFELINE_CODE,
    Strategy.ADAPTIVE: ADAPTIVE_CODE,
}
CODE_STRATEGIES = {c: s for s, c in STRATEGY_CODES.items()}


def strategy_code(strategy) -> int:
    """Dispatch code of `strategy` (a Strategy, its value string, or an
    already-encoded int, passed through)."""
    if isinstance(strategy, Strategy):
        return STRATEGY_CODES[strategy]
    if isinstance(strategy, str):
        return STRATEGY_CODES[Strategy(strategy)]
    return int(strategy)


# Staging width of the grant/export path: the most bottom tasks a victim can
# hand out in one steal round. One constant shared by the export of both
# deque backends and the steal_compact kernel (its compile-time width,
# checked by the wrapper); `max_grants_per_victim` must stay <= it.
GRANT_WIDTH = 8


class StealPlan(NamedTuple):
    victim: torch.Tensor   # (..., W) int32 chosen victim, -1 for non-thieves
    rank: torch.Tensor     # (..., W) int32 rank among same-victim requesters
    got: torch.Tensor      # (..., W) bool steal granted
    taken: torch.Tensor    # (..., W) int32 tasks taken from this worker (victim view)
    hops: torch.Tensor     # (..., W) int32 thief→victim hop distance


# --------------------------------------------------------------------------- #
# Victim-set tables (host numpy, precomputed at init — paper §3.1 step 1)
# --------------------------------------------------------------------------- #
def neighbor_list(mesh: topo.MeshTopology) -> np.ndarray:
    """(W, 4) neighbor ids, NO_NEIGHBOR-padded (radius-1 victim set)."""
    return mesh.neighbor_table


def radius2_list(mesh: topo.MeshTopology) -> np.ndarray:
    """(W, 12) ids of workers within <= 2 hops (excluding self), ascending,
    deduplicated, padded with NO_NEIGHBOR."""
    W = mesh.num_workers
    R, C = mesh.rows, mesh.cols
    offs = np.asarray([(dr, dc)
                       for dr in range(-2, 3) for dc in range(-2, 3)
                       if 0 < abs(dr) + abs(dc) <= 2], np.int64)   # (12, 2)
    r = mesh.coords[:, 0:1].astype(np.int64) + offs[None, :, 0]    # (W, 12)
    c = mesh.coords[:, 1:2].astype(np.int64) + offs[None, :, 1]
    if mesh.torus and W == R * C:  # the hop metric wraps only on exact tori
        r %= R
        c %= C
        ok = np.ones_like(r, bool)
    else:
        ok = (r >= 0) & (r < R) & (c >= 0) & (c < C)
    cand = np.where(ok, r * C + c, W)
    cand = np.where(cand >= W, W, cand)              # ragged last row
    cand = np.where(cand == np.arange(W)[:, None], W, cand)  # wraps onto self
    cand.sort(axis=1)
    dup = np.zeros_like(cand, bool)
    dup[:, 1:] = cand[:, 1:] == cand[:, :-1]
    cand[dup] = W
    cand.sort(axis=1)
    return np.where(cand == W, topo.NO_NEIGHBOR, cand).astype(np.int32)


def lifeline_list(num_workers: int, degree: int = 0) -> np.ndarray:
    """Hypercube lifelines: worker w's lifelines are w with one base-2 digit
    toggled (Saraswat et al. PPoPP'11), padded to a fixed width."""
    if degree == 0:
        degree = max(1, int(np.ceil(np.log2(max(num_workers, 2)))))
    out = np.full((num_workers, degree), topo.NO_NEIGHBOR, dtype=np.int32)
    for w in range(num_workers):
        k = 0
        for b in range(degree):
            partner = w ^ (1 << b)
            if partner < num_workers:
                out[w, k] = partner
                k += 1
    return out


# --------------------------------------------------------------------------- #
# Selection (vectorized; `key` is the round's threefry key: a key of (F, 1)
# tensors draws F rounds at once, giving (F, W) victims)
# --------------------------------------------------------------------------- #
def _pick_from_list(key, table, is_thief: torch.Tensor):
    """Uniform choice among the valid (!= -1) entries of each worker's row.
    `table` is (W, D), or (..., W, D) with leading axes that broadcast
    against the key's (per-point tables), or a pair ``(first, rest)`` of
    such tables for a batch of rows (the key's second-to-last axis): the
    first maps row 0, the second every row after it. The uniforms are drawn
    once, whatever the tables."""
    if isinstance(table, tuple):
        first, rest = table
        r = rng.uniform(key, first.shape[-2], first.device)
        return torch.cat([_pick_uniform(r[..., :1, :], first, is_thief),
                          _pick_uniform(r[..., 1:, :], rest, is_thief)], dim=-2)
    r = rng.uniform(key, table.shape[-2], table.device)
    return _pick_uniform(r, table, is_thief)


def _pick_uniform(r: torch.Tensor, table: torch.Tensor, is_thief: torch.Tensor):
    """The entry of each worker's row of `table` that the uniform `r[..., w]`
    picks among its valid ones (`_pick_from_list` after its draw)."""
    valid = table != topo.NO_NEIGHBOR
    n_valid = valid.sum(dim=-1, dtype=torch.int32).clamp(min=1)
    pick = torch.minimum((r * n_valid).to(torch.int32), n_valid - 1)
    # rank of each valid slot (on the table's own shape, before it meets
    # the draws' rows); the pick-th valid entry of each row
    order = torch.cumsum(valid, dim=-1, dtype=torch.int32) - 1
    hit = valid & (order == pick[..., None])
    victim = torch.where(hit, table, topo.NO_NEIGHBOR).amax(dim=-1)
    return torch.where(is_thief & (victim >= 0), victim, topo.NO_NEIGHBOR)


def choose_global(key, num_workers: int, is_thief: torch.Tensor):
    """Uniform over all other workers (paper's global strategy)."""
    W = num_workers
    r = rng.randint(key, W, 0, max(W - 1, 1), is_thief.device)
    me = torch.arange(W, dtype=torch.int32, device=is_thief.device)
    victim = torch.where(r >= me, r + 1, r).clamp(0, W - 1)
    return torch.where(is_thief & (W > 1), victim, topo.NO_NEIGHBOR)


def choose_neighbor(key, neighbor_table: torch.Tensor, is_thief: torch.Tensor):
    """Uniform over the thief's directly connected neighbors."""
    return _pick_from_list(key, neighbor_table, is_thief)


def choose_lifeline(key, lifelines: torch.Tensor, fails: torch.Tensor,
                    num_workers: int, is_thief: torch.Tensor):
    """Try lifelines round-robin by fail count; fall back to global random."""
    W, L = lifelines.shape
    use_global = fails >= L
    _, k2 = rng.split(key)
    slot = fails.clamp(0, L - 1).long()
    lane = lifelines[torch.arange(W, device=fails.device), slot]
    fallback = choose_global(k2, num_workers, is_thief)
    victim = torch.where(use_global | (lane == topo.NO_NEIGHBOR), fallback, lane)
    return torch.where(is_thief, victim, topo.NO_NEIGHBOR)


def choose_adaptive(key, neighbor_table: torch.Tensor,
                    radius2_table: torch.Tensor, fails: torch.Tensor,
                    is_thief: torch.Tensor, escalate_after: int = 4):
    """Neighbor-only, escalating to radius-2 after repeated failures."""
    k1, k2 = rng.split(key)
    near = _pick_from_list(k1, neighbor_table, is_thief)
    far = _pick_from_list(k2, radius2_table, is_thief)
    return torch.where(is_thief & (fails >= escalate_after), far, near)


def _row_gather(row: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """row[..., table[..., w, d]]: a (..., W) row read at every entry of a
    (W, D) or (..., W, D) table of worker ids (clipped to the row)."""
    idx = table.clamp(0, row.shape[-1] - 1).long()
    lead = torch.broadcast_shapes(row.shape[:-1], idx.shape[:-2])
    idx = idx.expand(*lead, *idx.shape[-2:])
    return row.expand(*lead, row.shape[-1]).gather(
        -1, idx.flatten(-2)).view(idx.shape)


def cheapest_live_table(neighbor_table: torch.Tensor,
                        link_tau: torch.Tensor) -> torch.Tensor:
    """`neighbor_table` (dead links already NO_NEIGHBOR) masked down to each
    worker's live neighbors of least τ (`link_tau`, the epoch's (W, 4)
    latencies): ADAPTIVE's near set under a link-state schedule. Leading
    axes broadcast."""
    valid = neighbor_table != topo.NO_NEIGHBOR
    cost = torch.where(valid, link_tau, torch.iinfo(torch.int32).max)
    cheapest = valid & (cost == cost.amin(dim=-1, keepdim=True))
    return torch.where(cheapest, neighbor_table, topo.NO_NEIGHBOR)


def mask_reachable(table: torch.Tensor, comp_row: torch.Tensor) -> torch.Tensor:
    """A (W, D) victim table masked down to the entries in the thief's
    live-link component (`comp_row`, (W,) component ids); a table and
    component rows with leading axes ((..., W, D) and (..., W)) are masked
    row by row."""
    ok = ((table != topo.NO_NEIGHBOR)
          & (_row_gather(comp_row, table) == comp_row[..., None]))
    return torch.where(ok, table, topo.NO_NEIGHBOR)


def choose_adaptive_linkaware(key, neighbor_table: torch.Tensor,
                              radius2_table: torch.Tensor,
                              link_tau: torch.Tensor, fails: torch.Tensor,
                              is_thief: torch.Tensor, escalate_after: int = 4):
    """ADAPTIVE under a link-state schedule: uniform among the cheapest live
    neighbors (`neighbor_table` with dead links masked, `link_tau` the
    epoch's (W, 4) latencies), escalating to radius-2 after
    `escalate_after` consecutive failures. Under uniform τ it draws what
    `choose_adaptive` draws."""
    k1, k2 = rng.split(key)
    near = _pick_from_list(k1, cheapest_live_table(neighbor_table, link_tau),
                           is_thief)
    far = _pick_from_list(k2, radius2_table, is_thief)
    return torch.where(is_thief & (fails >= escalate_after), far, near)


# --------------------------------------------------------------------------- #
# Conflict resolution
# --------------------------------------------------------------------------- #
def segment_prefix(key: torch.Tensor, active: torch.Tensor,
                   weights: torch.Tensor | None = None,
                   priority: torch.Tensor | None = None) -> torch.Tensor:
    """Exclusive prefix sum of `weights` within equal-`key` segments.

    Workers are ordered inside a segment by (priority, worker id); worker
    w's result is the sum of the weights of same-key active workers that
    precede it. Inactive workers sort last and return 0. Every argument may
    carry leading axes (a grid of points, shape (..., W)): each row along
    the last axis is ranked on its own.

    Args:
      key: (..., W) segment id per active worker, in [0, W].
      active: (..., W) bool.
      weights: (..., W) int summands; defaults to ones (prefix = rank).
      priority: (..., W) optional within-segment order in [0, W) (lower =
        first); worker id breaks ties. Defaults to worker id.
    """
    W = key.shape[-1]
    dev = key.device
    ids = torch.arange(W, dtype=torch.int64, device=dev)
    if weights is None:
        weights = torch.ones_like(key, dtype=torch.int32)
    pri = ids if priority is None else priority.to(torch.int64)
    skey = torch.where(active, key.to(torch.int64), W)  # inactive sort last
    # one composite key (segment, priority, id) < W^3: total, so no reliance
    # on sort stability; it replaces the reference's three-key lexsort (int64
    # holds it for W < 2^21)
    _, order = torch.sort((skey * W + pri) * W + ids, dim=-1)
    skey_sorted = skey.gather(-1, order)
    w_sorted = torch.where(active, weights, 0).gather(-1, order).to(torch.int32)
    excl = torch.cumsum(w_sorted, -1).to(torch.int32) - w_sorted
    is_start = torch.ones_like(skey_sorted, dtype=torch.bool)
    is_start[..., 1:] = skey_sorted[..., 1:] != skey_sorted[..., :-1]
    seg_first, _ = torch.cummax(torch.where(is_start, ids, 0), -1)
    prefix_sorted = excl - excl.gather(-1, seg_first)
    # `order` is a permutation of each row: no duplicates
    prefix = torch.empty_like(prefix_sorted).scatter_(-1, order, prefix_sorted)
    return torch.where(active, prefix, 0)


def resolve_grants(victim: torch.Tensor, sizes: torch.Tensor,
                   max_grants_per_victim=4,
                   priority: torch.Tensor | None = None) -> StealPlan:
    """Deterministically match thieves to victim deque-bottom slots.

    Sort-based segment ranking (O(W log W)); `resolve_grants_pairwise` is
    the O(W^2) oracle. `rank[w]` is w's position in its victim's service
    order, `got[w]` whether a task is granted (rank < min(size, budget)),
    `taken[v]` how many tasks leave victim v's bottom this round. With
    leading axes (a grid: victims, sizes (..., W) and a budget that
    broadcasts, e.g. (G, 1)) each point's requests are ranked and served
    apart from the others'.
    """
    W = victim.shape[-1]
    req = victim >= 0
    rank = segment_prefix(victim, req, priority=priority)
    vc = victim.clamp(0, W - 1).long()
    vsize = torch.where(req, sizes.gather(-1, vc), 0)
    budget = vsize.clamp(max=max_grants_per_victim)
    got = req & (rank < budget)
    # integer adds: any order
    taken = torch.zeros_like(victim, dtype=torch.int32).scatter_add_(
        -1, vc, got.to(torch.int32))
    return StealPlan(victim=torch.where(req, victim, topo.NO_NEIGHBOR),
                     rank=rank, got=got, taken=taken,
                     hops=torch.zeros_like(taken))


def resolve_grants_pairwise(victim: torch.Tensor, sizes: torch.Tensor,
                            max_grants_per_victim: int = 4,
                            priority: torch.Tensor | None = None) -> StealPlan:
    """O(W^2) pairwise-rank reference for `resolve_grants` (test oracle)."""
    W = victim.shape[0]
    req = victim >= 0
    ids = torch.arange(W, device=victim.device)
    if priority is None:
        priority = ids
    same = (victim[:, None] == victim[None, :]) & req[:, None] & req[None, :]
    ahead = same & ((priority[None, :] < priority[:, None])
                    | ((priority[None, :] == priority[:, None])
                       & (ids[None, :] < ids[:, None])))
    rank = ahead.sum(dim=1).to(torch.int32)
    vc = victim.clamp(0, W - 1).long()
    vsize = torch.where(req, sizes[vc], 0)
    got = req & (rank < vsize.clamp(max=max_grants_per_victim))
    taken = torch.zeros((W,), dtype=torch.int32, device=victim.device)
    taken.index_add_(0, vc, got.to(torch.int32))
    return StealPlan(victim=torch.where(req, victim, topo.NO_NEIGHBOR),
                     rank=rank, got=got, taken=taken,
                     hops=torch.zeros_like(taken))


# --------------------------------------------------------------------------- #
# Famine fast path support (the simulator's probe-cycle replay)
# --------------------------------------------------------------------------- #
def _any_nonempty(table: torch.Tensor, nonempty: torch.Tensor) -> torch.Tensor:
    """Per worker: does any valid (!= NO_NEIGHBOR) entry of `table` (W, D),
    or per point (G, W, D), index a worker of the same point with a
    nonempty deque? `nonempty` is (..., W)."""
    valid = table != topo.NO_NEIGHBOR
    return (_row_gather(nonempty, table) & valid).any(dim=-1)


def probe_may_succeed(strategy: Strategy, nonempty: torch.Tensor,
                      fails: torch.Tensor, neighbor_table: torch.Tensor,
                      radius2_table: torch.Tensor | None, *,
                      escalate_after, window: int, min_cycle,
                      num_workers: int, comp_row=None) -> torch.Tensor:
    """Per worker: could a steal probe drawn within the next `window` ticks
    land on a victim whose deque is nonempty now? Where it could not, and
    deque sizes are frozen over the window (the simulator's famine horizon
    makes sure of that), every probe the worker issues in the window fails,
    so its probe cycles can be replayed without deque operations.

    GLOBAL: a nonempty deque of another worker (in the thief's live-link
    component, given `comp_row`: a probe to another component never
    departs). NEIGHBOR: a nonempty direct neighbor. ADAPTIVE: a nonempty
    neighbor, or a nonempty radius-2 worker when the thief can escalate
    inside the window (each failed attempt takes at least `min_cycle` ticks,
    so a thief `k` failures short of escalating draws no radius-2 victim
    before (k - 1)·min_cycle ticks). LIFELINE falls back to global draws and
    is always risky. Under a link-state schedule the tables come with dead
    links and unreachable victims masked. A grid of points gives `nonempty`,
    `fails` and `comp_row` leading axes, (G, W), the tables per-point ones
    ((G, W, D)) or none, and per-point `escalate_after` and `min_cycle` of
    shape (G, 1); each point's workers see only its own deques."""
    W = num_workers
    if strategy == Strategy.GLOBAL:
        if comp_row is None:
            return (nonempty.any(-1, keepdim=True) & (W > 1)).expand_as(nonempty)
        ne = nonempty.to(torch.int32)
        comp = comp_row.long().expand_as(ne)
        in_comp = torch.zeros_like(ne).scatter_add_(-1, comp, ne)
        return (in_comp.gather(-1, comp) - ne) > 0
    if strategy == Strategy.LIFELINE:
        return torch.ones_like(nonempty, dtype=torch.bool)
    near = _any_nonempty(neighbor_table, nonempty)
    if strategy == Strategy.NEIGHBOR:
        return near
    if strategy == Strategy.ADAPTIVE:
        to_go = escalate_after - fails
        may_escalate = (to_go - 1) * min_cycle < window
        return near | (_any_nonempty(radius2_table, nonempty) & may_escalate)
    raise ValueError(strategy)


def probe_may_succeed_code(code, nonempty: torch.Tensor, fails: torch.Tensor,
                           neighbor_table: torch.Tensor,
                           radius2_table: torch.Tensor, *, escalate_after,
                           window: int, min_cycle, num_workers: int,
                           comp_row=None) -> torch.Tensor:
    """`probe_may_succeed` by strategy code. An int code dispatches to the
    enum version; a code tensor computes every strategy's predicate and
    selects per code, as the reference's traced version does (LIFELINE and
    unknown codes answer all-True)."""
    kw = dict(escalate_after=escalate_after, window=window,
              min_cycle=min_cycle, num_workers=num_workers, comp_row=comp_row)
    if not isinstance(code, torch.Tensor):
        return probe_may_succeed(CODE_STRATEGIES[int(code)], nonempty, fails,
                                 neighbor_table, radius2_table, **kw)
    glob, near, adapt = (
        probe_may_succeed(s, nonempty, fails, neighbor_table, radius2_table,
                          **kw)
        for s in (Strategy.GLOBAL, Strategy.NEIGHBOR, Strategy.ADAPTIVE))
    return torch.where(code == GLOBAL_CODE, glob,
                       torch.where(code == NEIGHBOR_CODE, near,
                                   torch.where(code == ADAPTIVE_CODE, adapt,
                                               True)))


def _per_point(x):
    """A per-point column (G, 1) lifted to (G, 1, 1), so that it broadcasts
    against (G, count, W) blocks; ints and 0-d tensors pass through."""
    if isinstance(x, torch.Tensor) and x.dim() > 0:
        return x[..., None]
    return x


def batched_victim_draws(strategy: Strategy, key0, t0, count: int,
                         neighbor_table: torch.Tensor,
                         radius2_table: torch.Tensor | None, *,
                         num_workers: int, link_tau_row=None):
    """The victim draws of `count` consecutive ticks in one pass.

    Returns ``(near, far)`` of shape (count, W): row j holds what the
    per-tick selection draws at tick ``t0 + j`` (key ``fold_in(key0, t0 +
    j)``) for an all-thieves mask. `far` is None except for ADAPTIVE, whose
    caller picks per worker between the near and the escalated draw by its
    fail count at probe time. `t0` is a Python int or a 0-d device tensor.
    For a grid of G points, `t0` and the key's words are per-point columns
    of shape (G, 1): the keys are then (G, count, 1) and the draws (G,
    count, W), point g's rows drawn with its own key from its own tick.
    Under a link-state schedule the tables come masked (dead links, and for
    ADAPTIVE's radius-2 set unreachable victims) and ADAPTIVE takes the
    epoch's `link_tau_row` (its near draw prefers the cheapest live
    neighbor); tables and τ rows may carry leading axes that broadcast
    against the draws' (G, count), per point, and a table (with its τ row)
    may be a pair ``(first, rest)``: row 0 through the first, the rows after
    it through the second (a tick's epoch and the next tick's), all from one
    draw of uniforms (`_pick_from_list`)."""
    W = num_workers
    dev = (neighbor_table[0] if isinstance(neighbor_table, tuple)
           else neighbor_table).device
    all_thieves = torch.ones((W,), dtype=torch.bool, device=dev)
    ticks = t0 + torch.arange(count, dtype=torch.int64, device=dev)
    # (count, 1), or (G, count, 1) for a grid
    keys = rng.fold_in(tuple(_per_point(k) for k in key0), ticks[..., None])
    if strategy == Strategy.GLOBAL:
        return choose_global(keys, W, all_thieves), None
    if strategy == Strategy.NEIGHBOR:
        return choose_neighbor(keys, neighbor_table, all_thieves), None
    if strategy == Strategy.ADAPTIVE:
        near_tab = neighbor_table
        if link_tau_row is not None and isinstance(near_tab, tuple):
            near_tab = tuple(cheapest_live_table(n, t)
                             for n, t in zip(near_tab, link_tau_row))
        elif link_tau_row is not None:
            near_tab = cheapest_live_table(near_tab, link_tau_row)
        k1, k2 = rng.split(keys)
        return (_pick_from_list(k1, near_tab, all_thieves),
                _pick_from_list(k2, radius2_table, all_thieves))
    raise ValueError(f"no batched draws for {strategy}")


def batched_victim_draws_code(code, key0, t0, count: int,
                              neighbor_table: torch.Tensor,
                              radius2_table: torch.Tensor, *,
                              num_workers: int, link_tau_row=None):
    """`batched_victim_draws` by strategy code; always ``(near, far)`` of
    shape (count, W), `far` a copy of `near` for the single-draw strategies.
    LIFELINE gives global draws as a placeholder (the famine path is gated
    off for it). An int code dispatches; a code tensor draws every branch
    and selects per code, as the reference's switch does under vmap. A
    grid's codes are a (G, 1) column beside its (G, 1) keys and ticks (see
    `batched_victim_draws`), giving (G, count, W) draws."""
    kw = dict(num_workers=num_workers, link_tau_row=link_tau_row)
    branch = {GLOBAL_CODE: Strategy.GLOBAL, NEIGHBOR_CODE: Strategy.NEIGHBOR,
              LIFELINE_CODE: Strategy.GLOBAL, ADAPTIVE_CODE: Strategy.ADAPTIVE}

    def draw(strategy):
        near, far = batched_victim_draws(strategy, key0, t0, count,
                                         neighbor_table, radius2_table, **kw)
        return near, near if far is None else far

    if not isinstance(code, torch.Tensor):
        return draw(branch[int(code)])
    (g, _), (n, _), (an, af) = (draw(s) for s in (
        Strategy.GLOBAL, Strategy.NEIGHBOR, Strategy.ADAPTIVE))
    code = _per_point(code)
    near = torch.where(code == ADAPTIVE_CODE, an,
                       torch.where(code == NEIGHBOR_CODE, n, g))
    far = torch.where(code == ADAPTIVE_CODE, af, near)
    return near, far


def attach_hops(plan: StealPlan, mesh) -> StealPlan:
    """`plan` with each thief's hop distance to its victim (0 without one).
    `mesh` is a `topology.MeshTopology` (hops priced from its coordinates,
    no (W, W) table), or a dense (W, W) distance matrix, deprecated."""
    W = plan.victim.shape[-1]
    if isinstance(mesh, topo.MeshTopology):
        coords = torch.as_tensor(mesh.coords, device=plan.victim.device)
        hops = topo.hop_dist(mesh, coords, plan.victim)
    else:
        import warnings

        warnings.warn(
            "attach_hops(plan, <dense distance matrix>) is deprecated; pass "
            "the MeshTopology instead (hops are priced from coordinates)",
            DeprecationWarning, stacklevel=2)
        v = plan.victim.clamp(0, W - 1).long()
        hops = torch.as_tensor(np.asarray(mesh), device=v.device)[
            torch.arange(W, device=v.device), v].to(torch.int32)
    return plan._replace(hops=torch.where(plan.victim >= 0, hops, 0))
