"""Neighbor-only steal-rebalancing of work items across shards, in torch:
the single-device part that the serving simulation needs.

Mirrors `repro.core.balancer`'s queue type, donation and insertion steps
and its vectorized `rebalance_reference`, integer-exact. Every function
works on one queue or on a leading shard axis alike (the reference vmaps
its per-shard functions over shards). The collectives (`steal_shift`,
`rebalance`, `global_rebalance`) are ROADMAP Queue 1 item 14.

Work items are fixed-size records (slots, item_w) with a validity mask and
an int32 cost; transfers preserve the multiset of valid items exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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
    return torch.where(q.valid, q.cost, 0).sum(-1)


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


def rebalance_reference(items, valid, cost, rounds: int = 2, max_items: int = 8):
    """The reference's vectorized rebalance over a leading shard axis:
    `rounds` x (shift +1, shift -1) neighbor rounds on a ring of shards.
    Shapes: items (S, slots, w), valid (S, slots), cost alike. A shard whose
    load is below half its neighbor's, and that has a free slot, asks for
    half the difference. Returns (items, valid, cost, dropped_total)."""
    dropped_total = torch.zeros((), dtype=torch.int64, device=valid.device)
    for _ in range(rounds):
        for shift in (1, -1):
            loads = torch.where(valid, cost, 0).sum(1)
            free = (~valid).sum(1).to(torch.int32)
            # requester i compares to its -shift neighbor
            nbr_load = torch.roll(loads, shift)
            deficit = torch.clamp((nbr_load - loads) // 2, min=0)
            # the reference's `loads < 0.5 * nbr_load`, exact in integers
            want = torch.where((2 * loads < nbr_load) & (free > 0), deficit, 0)
            want_from_me = torch.roll(want, -shift)
            free_of_requester = torch.roll(free, -shift)
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
