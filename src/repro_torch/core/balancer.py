"""Neighbor-only steal-rebalancing of work items across shards, in torch.

Mirrors `repro.core.balancer`: the queue type, donation and insertion
steps, the collectives on one axis of a mesh (`steal_shift`, `rebalance`,
`global_rebalance`: two single-hop ppermute rounds against the all-gather
baseline) and the vectorized `rebalance_reference`, integer-exact. Every
function works on one queue or on a leading shard axis alike (the
reference vmaps its per-shard functions over shards). The collectives take
the mesh as a keyword (`mesh=`: a `mesh_comm.LocalMesh`, or a `DeviceMesh`
of one shard a rank) and run once for every shard the mesh holds here; the
load trigger compares in float32, as the reference's
``my_load < trigger * nbr_load`` does under JAX.

Work items are fixed-size records (slots, item_w) with a validity mask and
an int32 cost; transfers preserve the multiset of valid items exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import mesh_comm

_INT32_MAX = 2**31 - 1


class ShardQueue(NamedTuple):
    """A shard's pool of work items (requests / sequences)."""
    items: torch.Tensor   # (..., slots, item_w) payload records
    valid: torch.Tensor   # (..., slots) bool
    cost: torch.Tensor    # (..., slots) int32 work estimate per item


def make_queue(items, valid, cost) -> ShardQueue:
    return ShardQueue(torch.as_tensor(items), torch.as_tensor(valid),
                      torch.as_tensor(cost))


def load_of(q: ShardQueue) -> torch.Tensor:
    """The queue's load: an int32 sum of its valid costs (wrapping as the
    reference's does)."""
    return torch.where(q.valid, q.cost, 0).sum(-1, dtype=torch.int32)


def _below(load: torch.Tensor, nbr_load: torch.Tensor, trigger: float) -> torch.Tensor:
    """The reference's ``load < trigger * nbr_load`` for int loads and a
    Python float: JAX computes it in float32 (the weakly typed float meets
    int32), which at loads past 2^24 differs from an exact compare."""
    f32 = torch.float32
    return load.to(f32) < torch.tensor(trigger, dtype=f32) * nbr_load.to(f32)


def _compact_indices(valid: torch.Tensor) -> torch.Tensor:
    """Stable order: valid slots first (by index), then invalid."""
    return torch.argsort(torch.where(valid, 0, 1), dim=-1, stable=True)


def _gather_items(items: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(items, -2, idx[..., None].expand(*idx.shape, items.shape[-1]))


def select_donations(q: ShardQueue, want_cost, max_items: int, max_count=None):
    """Pick up to `max_items` items, cheapest-first, whose cumulative cost
    does not exceed `want_cost`; never the last item; at most `max_count`.
    Returns (records, valid, cost, taken_mask), as the reference does."""
    slots = q.valid.shape[-1]
    key = torch.where(q.valid, q.cost, _INT32_MAX)
    order = torch.argsort(key, dim=-1, stable=True)
    sorted_valid = torch.gather(q.valid, -1, order)
    sorted_cost = torch.where(sorted_valid, torch.gather(q.cost, -1, order), 0)
    n_valid = q.valid.sum(-1, dtype=torch.int32)
    csum = torch.cumsum(sorted_cost, dim=-1)
    idx = torch.arange(slots, device=q.valid.device)
    limit = torch.as_tensor(max_items if max_count is None else max_count,
                            device=q.valid.device).clamp(max=max_items)
    want = torch.as_tensor(want_cost, device=q.valid.device)
    donate_sorted = (sorted_valid
                     & (csum <= want[..., None])
                     & (idx < limit[..., None])
                     & (idx < (n_valid - 1)[..., None]))  # keep one
    taken = torch.zeros_like(q.valid).scatter(-1, order, donate_sorted)
    recs = _gather_items(q.items, order)[..., :max_items, :]
    rcost = torch.where(donate_sorted, sorted_cost, 0)[..., :max_items]
    rvalid = donate_sorted[..., :max_items]
    return recs, rvalid, rcost.to(q.cost.dtype), taken


def insert_items(q: ShardQueue, recs, rvalid, rcost) -> tuple[ShardQueue, torch.Tensor]:
    """Insert incoming records (k <= slots of them, as `select_donations`
    gives) into free slots. Returns (queue, dropped)."""
    k = rvalid.shape[-1]
    free_order = torch.argsort(torch.where(q.valid, 1, 0), dim=-1, stable=True)
    n_free = (~q.valid).sum(-1)
    j = torch.arange(k, device=q.valid.device)
    dst = free_order[..., :k]
    ok = rvalid & (j < n_free[..., None])
    old_items = _gather_items(q.items, dst)
    new_items = torch.where(ok[..., None], recs, old_items)
    items = q.items.scatter(-2, dst[..., None].expand_as(new_items), new_items)
    valid = q.valid.scatter(-1, dst, ok | torch.gather(q.valid, -1, dst))
    cost = q.cost.scatter(-1, dst, torch.where(ok, rcost, torch.gather(q.cost, -1, dst)))
    dropped = (rvalid & ~ok).sum(-1)
    return ShardQueue(items, valid, cost), dropped


def steal_shift(q: ShardQueue, axis_name: str, shift: int, max_items: int,
                trigger: float = 0.25, link_ok=None, *, mesh) -> tuple[ShardQueue, dict]:
    """One neighbor-only steal round along `axis_name` of `mesh` (direction
    `shift`): a shard whose load is below `trigger` x its -shift
    neighbor's, and that has a free slot, requests half the difference; the
    neighbor donates items covering it. ppermutes only (single-hop, fixed
    payload). `link_ok` — optional per-shard bool: a shard whose link is
    down neither requests nor donates. Returns (queue, {"moved",
    "dropped", "load"}), each a per-shard value."""
    mesh = mesh_comm.as_mesh(mesh)
    n = mesh.axis_size(axis_name)
    fwd = [(i, (i + shift) % n) for i in range(n)]
    bwd = [((i + shift) % n, i) for i in range(n)]

    my_load = load_of(q)
    my_free = (~q.valid).sum(-1, dtype=torch.int32)
    nbr_load = mesh.ppermute(my_load, axis_name, fwd)  # load of my -shift nbr
    # bounded by my free slots: a full queue must not request
    deficit = torch.clamp((nbr_load - my_load) // 2, min=0)
    want = torch.where(_below(my_load, nbr_load, trigger) & (my_free > 0), deficit, 0)
    if link_ok is not None:
        want = torch.where(link_ok, want, 0)
    # tell the neighbor (travel +shift: back to the load's owner)
    want_from_me = mesh.ppermute(want, axis_name, bwd)
    free_of_requester = mesh.ppermute(my_free, axis_name, bwd)
    if link_ok is not None:  # a dark donor keeps its items too
        want_from_me = torch.where(link_ok, want_from_me, 0)

    recs, rvalid, rcost, taken = select_donations(
        q, want_from_me, max_items, max_count=free_of_requester)
    q = ShardQueue(q.items, q.valid & ~taken, q.cost)
    # the donation travels +shift: the requester sits at -shift of the donor
    recs_in = mesh.ppermute(recs, axis_name, fwd)
    rvalid_in = mesh.ppermute(rvalid, axis_name, fwd)
    rcost_in = mesh.ppermute(rcost, axis_name, fwd)
    q, dropped = insert_items(q, recs_in, rvalid_in, rcost_in)
    moved = rvalid_in.sum(-1, dtype=torch.int32)
    return q, {"moved": moved, "dropped": dropped.to(torch.int32), "load": load_of(q)}


def rebalance(q: ShardQueue, axis_name: str, rounds: int = 2, max_items: int = 8,
              trigger: float = 0.5, link_ok=None, *, mesh) -> tuple[ShardQueue, dict]:
    """Iterated neighbor-only rebalancing: `rounds` sweeps of a +1 and a -1
    `steal_shift` along the axis. `link_ok` gates each shard's
    participation."""
    moved = dropped = 0
    for _ in range(rounds):
        for shift in (1, -1):
            q, s = steal_shift(q, axis_name, shift, max_items, trigger, link_ok, mesh=mesh)
            moved, dropped = moved + s["moved"], dropped + s["dropped"]
    return q, {"moved": moved, "dropped": dropped, "load": load_of(q)}


def global_rebalance(q: ShardQueue, axis_name: str, max_items: int = 8, *,
                     mesh) -> tuple[ShardQueue, dict]:
    """The all-gather baseline: every shard sees every load; the first
    most-loaded shard donates to the first least-loaded through a full
    exchange (O(shards x payload) bytes a round)."""
    mesh = mesh_comm.as_mesh(mesh)
    idx = mesh.axis_index(axis_name).long()
    loads = mesh.all_gather(load_of(q), axis_name)  # (shards, n)
    rich = loads.argmax(-1)  # the first maximum, as jnp.argmax
    poor = loads.argmin(-1)
    spread = loads.gather(-1, rich[:, None]) - loads.gather(-1, poor[:, None])
    want = torch.clamp(spread[:, 0] // 2, min=0)
    recs, rvalid, rcost, taken = select_donations(
        q, torch.where(idx == rich, want, 0), max_items)
    q = ShardQueue(q.items, q.valid & ~taken, q.cost)
    # broadcast the donation to everyone; only `poor` keeps it
    shards = torch.arange(idx.shape[0], device=idx.device)
    all_recs = mesh.all_gather(recs, axis_name)[shards, rich]
    all_valid = mesh.all_gather(rvalid, axis_name)[shards, rich]
    all_cost = mesh.all_gather(rcost, axis_name)[shards, rich]
    q, dropped = insert_items(q, all_recs, all_valid & (idx == poor)[:, None], all_cost)
    moved = all_valid.sum(-1, dtype=torch.int32)
    return q, {"moved": moved, "dropped": dropped.to(torch.int32), "load": load_of(q)}


def rebalance_reference(items, valid, cost, rounds: int = 2, max_items: int = 8,
                        trigger: float = 0.5, link_ok=None):
    """The reference's vectorized rebalance over a leading shard axis:
    `rounds` x (shift +1, shift -1) neighbor rounds on a ring of shards.
    Shapes: items (S, slots, w), valid (S, slots), cost alike; `link_ok`
    optionally (S,) bool, as in `steal_shift`. A shard whose load is below
    half its neighbor's, and that has a free slot, asks for half the
    difference: the threshold is 0.5 whatever `trigger` says, as in the
    reference (which accepts `trigger` and does not read it). Returns
    (items, valid, cost, dropped_total)."""
    dropped_total = torch.zeros((), dtype=torch.int64, device=valid.device)
    for _ in range(rounds):
        for shift in (1, -1):
            loads = load_of(ShardQueue(items, valid, cost))
            free = (~valid).sum(1).to(torch.int32)
            # requester i compares to its -shift neighbor
            nbr_load = torch.roll(loads, shift)
            deficit = torch.clamp((nbr_load - loads) // 2, min=0)
            want = torch.where(_below(loads, nbr_load, 0.5) & (free > 0), deficit, 0)
            if link_ok is not None:
                want = torch.where(link_ok, want, 0)
            want_from_me = torch.roll(want, -shift)
            free_of_requester = torch.roll(free, -shift)
            if link_ok is not None:
                want_from_me = torch.where(link_ok, want_from_me, 0)
            recs, rvalid, rcost, taken = select_donations(
                ShardQueue(items, valid, cost), want_from_me, max_items,
                max_count=free_of_requester)
            valid = valid & ~taken
            q, dropped = insert_items(
                ShardQueue(items, valid, cost), torch.roll(recs, shift, 0),
                torch.roll(rvalid, shift, 0), torch.roll(rcost, shift, 0))
            items, valid, cost = q
            dropped_total = dropped_total + dropped.sum()
    return items, valid, cost, dropped_total
