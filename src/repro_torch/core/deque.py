"""Fixed-capacity work-stealing deques, vectorized over workers, in torch.

The owner pushes and pops at the top; thieves steal from the bottom. Each
worker's deque is a ring buffer of capacity C holding [kind, a, b, c] int32
records; the constellation's deques are one (W, C, T) tensor plus (W,)
bottom indices and sizes. Every operation is masked per worker and
functional: it returns new tensors and leaves its inputs untouched — all
but `apply`, the staged commit, which writes into its base buffer, and
the in-place pushes `push_top_` and `push_top_many_`, which write only the
pushed records into the ring they are given (the round executor's pushes:
a ring pass a push is what its wide rings cannot afford).

Writes use a dense formulation: each ring slot (or push-log lane) works out
which record, if any, lands on it, and the result is a `torch.where` over
the whole buffer. Writes from many sources at computed places (`place`,
`stage_place`: the transplants) find each cell's writer by a scatter-max of
the writers' indices (`winner_map`), which any order of duplicates leaves
the same. So the result is the same on every device and in every order.

Staged mutations (`DequeOps`)
-----------------------------
`stage()` opens a delta against a frozen base buffer; the `stage_*` mirrors
of the direct operations move *virtual* bottom/size cursors and record every
push in a bounded per-worker log of (slot, record) lanes. `apply()` commits
the whole log in one pass, in place into the base buffer — the
hand-written `deque_apply` kernel on the card, which writes only the slots
the log names instead of copying the ring. Mid-tick reads see pushes staged
earlier in the same tick, so a staged sequence leaves exactly the deque the
direct sequence leaves.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

TASK_WIDTH = 4  # [kind, a, b, c] int32 record


class DequeState(NamedTuple):
    buf: torch.Tensor   # (W, C, T) int32 ring buffers
    bot: torch.Tensor   # (W,) int32 index of bottom element
    size: torch.Tensor  # (W,) int32 number of live tasks


def make(num_workers: int, capacity: int, width: int = TASK_WIDTH,
         device="cpu") -> DequeState:
    z = torch.zeros((num_workers,), dtype=torch.int32, device=device)
    return DequeState(
        buf=torch.zeros((num_workers, capacity, width), dtype=torch.int32,
                        device=device),
        bot=z, size=z.clone())


def capacity(state: DequeState) -> int:
    return state.buf.shape[1]


def _rows(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[0], device=x.device)


def _gather_rows(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """buf (W, C, T), idx (W, K) int → (W, K, T) records buf[w, idx[w, k]]."""
    T = buf.shape[2]
    return torch.gather(buf, 1, idx.long()[:, :, None].expand(-1, -1, T))


def push_top(state: DequeState, task: torch.Tensor, mask: torch.Tensor):
    """Push `task[w]` onto worker w's top where `mask[w]`.

    Returns (state, ok) — ok[w] False when the deque was full (push dropped).
    """
    cap = capacity(state)
    ok = mask & (state.size < cap)
    idx = torch.remainder(state.bot + state.size, cap)
    cols = torch.arange(cap, device=idx.device)[None, :]
    hit = (cols == idx[:, None]) & ok[:, None]
    buf = torch.where(hit[:, :, None], task[:, None, :], state.buf)
    return DequeState(buf, state.bot, state.size + ok.to(torch.int32)), ok


def push_top_many(state: DequeState, tasks: torch.Tensor, counts: torch.Tensor):
    """Push `tasks[w, :counts[w]]` (K-slot staging block) onto worker w's top.

    Returns (state, overflowed) where overflowed[w] counts dropped tasks.
    """
    k_max = tasks.shape[1]
    cap = capacity(state)
    pushed = torch.minimum(counts, cap - state.size)
    overflow = counts - pushed
    # rank of each ring slot above the current top; slot c receives
    # tasks[w, r] iff r < pushed (ranks < pushed <= cap are distinct slots)
    cols = torch.arange(cap, device=counts.device)[None, :]
    r = torch.remainder(cols - (state.bot + state.size)[:, None], cap)
    hit = (r < pushed[:, None]) & (r < k_max)
    recs = _gather_rows(tasks, r.clamp(max=k_max - 1))
    buf = torch.where(hit[:, :, None], recs, state.buf)
    return DequeState(buf, state.bot, state.size + pushed), overflow


def push_top_(state: DequeState, task: torch.Tensor, mask: torch.Tensor):
    """`push_top` in place: one record a worker written into `state.buf`
    itself (a worker that does not push writes its slot's own record back),
    so the ring equals `push_top`'s. Returns (state whose `buf` is
    `state.buf`, ok)."""
    cap = capacity(state)
    ok = mask & (state.size < cap)
    idx = torch.remainder(state.bot + state.size, cap).long()
    rows = _rows(idx)
    state.buf[rows, idx] = torch.where(ok[:, None], task, state.buf[rows, idx])
    return DequeState(state.buf, state.bot, state.size + ok.to(torch.int32)), ok


def push_top_many_(state: DequeState, tasks: torch.Tensor, counts: torch.Tensor):
    """`push_top_many` in place: the K-slot staging block's lanes written
    into `state.buf` itself, each at its own slot above the top (a lane
    past the pushed count writes its slot's own record back), so the ring
    equals `push_top_many`'s. Returns (state whose `buf` is `state.buf`,
    overflowed)."""
    cap = capacity(state)
    pushed = torch.minimum(counts, cap - state.size)
    overflow = counts - pushed
    # lanes >= cap would alias lower ones; pushed <= cap never reaches them
    k = torch.arange(min(tasks.shape[1], cap), device=counts.device)[None, :]
    idx = torch.remainder((state.bot + state.size)[:, None] + k, cap).long()
    rows = _rows(idx)[:, None]
    hit = (k < pushed[:, None])[:, :, None]
    state.buf[rows, idx] = torch.where(hit, tasks[:, :k.shape[1]], state.buf[rows, idx])
    return DequeState(state.buf, state.bot, state.size + pushed), overflow


def pop_top(state: DequeState, mask: torch.Tensor):
    """Pop worker w's top task where `mask[w]` and size > 0.

    Returns (state, task, ok). `task[w]` is garbage when not ok[w].
    """
    cap = capacity(state)
    ok = mask & (state.size > 0)
    new_size = state.size - ok.to(torch.int32)
    idx = torch.remainder(state.bot + new_size, cap)
    task = state.buf[_rows(idx), idx.long()]
    return DequeState(state.buf, state.bot, new_size), task, ok


def peek_bottom(state: DequeState, rank: torch.Tensor) -> torch.Tensor:
    """Read the task `rank` positions above worker w's bottom (no removal)."""
    idx = torch.remainder(state.bot + rank, capacity(state))
    return state.buf[_rows(idx), idx.long()]


def peek_bottom_window(state: DequeState, window: int) -> torch.Tensor:
    """(W, window, T) view of each worker's bottom `window` slots (cyclic).

    Entries beyond `size` are garbage; callers mask with `state.size`.
    """
    ranks = torch.arange(window, device=state.bot.device)[None, :]
    idx = torch.remainder(state.bot[:, None] + ranks, capacity(state))
    return _gather_rows(state.buf, idx)


def export_bottom(state: DequeState, grants: torch.Tensor, width: int):
    """Extract `grants[w]` bottom records into a dense staging block and
    advance each deque's bottom — the victim side of a steal round.

    Returns (stolen, state): `stolen` is (W, width, T) with the first
    min(grants, size)[w] rows of worker w's bottom window and zeros beyond.
    The extraction is `kernels.ops.steal_compact`: the CUDA kernel on the
    card, its plain version for CPU tensors. It clamps each grant to
    `width` itself, so the bottom never advances past what the staging
    block exports; a width above its staging width raises.
    """
    from ..kernels import ops as kernel_ops

    stolen, new_bot, new_size = kernel_ops.steal_compact(
        state.buf, state.bot, state.size, grants, width)
    return stolen, DequeState(state.buf, new_bot, new_size)


def steal_bottom(state: DequeState, counts: torch.Tensor) -> DequeState:
    """Remove `counts[w]` tasks from worker w's bottom (already handed out)."""
    taken = torch.minimum(counts, state.size)
    return DequeState(state.buf,
                      torch.remainder(state.bot + taken, capacity(state)),
                      state.size - taken)


def total_tasks(state: DequeState) -> int:
    return int(state.size.sum())


def to_list(state: DequeState, worker: int) -> list[tuple[int, ...]]:
    """Debug/test helper: materialize worker's deque bottom→top as tuples."""
    buf = state.buf[worker].cpu().tolist()
    bot, size = int(state.bot[worker]), int(state.size[worker])
    cap = len(buf)
    return [tuple(buf[(bot + i) % cap]) for i in range(size)]


# --------------------------------------------------------------------------- #
# Staged mutations: record one tick's deque ops, commit them in one pass
# --------------------------------------------------------------------------- #
class DequeOps(NamedTuple):
    """Delta record of staged mutations against a frozen base buffer.

    `buf0` is the ring buffer at `stage()` time. Nothing writes it before
    `apply`, which commits the log into it in place (so a caller that still
    needs the tick-start ring keeps a copy); `bot`/`size` are the virtual
    cursors. Lane ``l < n[w]`` of the push log
    holds a record staged for ring slot `slot[w, l]`, in staging order —
    a later lane to the same slot wins.
    """

    buf0: torch.Tensor  # (W, C, T) frozen tick-start ring buffers
    bot: torch.Tensor   # (W,) virtual bottom cursor
    size: torch.Tensor  # (W,) virtual live-task count
    slot: torch.Tensor  # (W, L) absolute ring slot of each staged push
    rec: torch.Tensor   # (W, L, T) staged records
    n: torch.Tensor     # (W,) staged push count (lanes >= n are dead)


def stage(state: DequeState, lanes: int) -> DequeOps:
    """Open a staged-mutation record with an `lanes`-entry push log."""
    W, _, T = state.buf.shape
    dev = state.buf.device
    return DequeOps(
        buf0=state.buf, bot=state.bot, size=state.size,
        slot=torch.zeros((W, lanes), dtype=torch.int32, device=dev),
        rec=torch.zeros((W, lanes, T), dtype=torch.int32, device=dev),
        n=torch.zeros((W,), dtype=torch.int32, device=dev))


def _lanes(ops: DequeOps) -> torch.Tensor:
    return torch.arange(ops.slot.shape[1], device=ops.n.device)[None, :]


def stage_read(ops: DequeOps, idx: torch.Tensor) -> torch.Tensor:
    """Overlay-aware gather: the record at ring slot `idx[w]` (or
    `idx[w, k]`) as the direct path would read it mid-tick — the latest
    staged push to that slot if one exists, else the base buffer."""
    squeeze = idx.ndim == 1
    if squeeze:
        idx = idx[:, None]
    lanes = _lanes(ops)
    live = lanes < ops.n[:, None]                                  # (W, L)
    match = (ops.slot[:, None, :] == idx[:, :, None]) & live[:, None, :]
    # last matching lane (later stages overwrite earlier ones), -1 if none
    last = torch.where(match, lanes[:, None, :], -1).amax(dim=-1)  # (W, K)
    staged = _gather_rows(ops.rec, last.clamp(min=0))
    base = _gather_rows(ops.buf0, idx)
    out = torch.where((last >= 0)[:, :, None], staged, base)
    return out[:, 0] if squeeze else out


def _last_lane_map(ops: DequeOps) -> torch.Tensor:
    """(W, C) map: highest live lane staged for each ring slot, -1 where no
    push is staged. A scatter-max: max is commutative, so duplicate slots
    give the same result in any order."""
    W, C = ops.buf0.shape[:2]
    lanes = _lanes(ops)
    src = torch.where(lanes < ops.n[:, None], lanes, -1).to(torch.int32)
    neg = torch.full((W, C), -1, dtype=torch.int32, device=ops.n.device)
    return neg.scatter_reduce_(1, ops.slot.long(), src, reduce="amax")


def stage_push(ops: DequeOps, task: torch.Tensor, mask: torch.Tensor):
    """Staged `push_top`. Returns (ops, ok). A push past the lane budget is
    refused (ok=False), so an undersized budget never mints phantom tasks."""
    cap = ops.buf0.shape[1]
    L = ops.slot.shape[1]
    ok = mask & (ops.size < cap) & (ops.n < L)
    slot = torch.remainder(ops.bot + ops.size, cap)
    hit = (_lanes(ops) == ops.n[:, None]) & ok[:, None]
    ops = ops._replace(
        slot=torch.where(hit, slot[:, None], ops.slot),
        rec=torch.where(hit[:, :, None], task[:, None, :], ops.rec))
    inc = ok.to(torch.int32)
    return ops._replace(size=ops.size + inc, n=ops.n + inc), ok


def stage_push_many(ops: DequeOps, tasks: torch.Tensor, counts: torch.Tensor):
    """Staged `push_top_many` (K-slot staging block). Returns (ops, overflow);
    pushes past the lane budget are dropped and counted as overflow."""
    k_max = tasks.shape[1]
    cap = ops.buf0.shape[1]
    L = ops.slot.shape[1]
    pushed = torch.minimum(torch.minimum(counts, cap - ops.size), L - ops.n)
    overflow = counts - pushed
    # lane l holds staged rank r = l - n; it is written iff 0 <= r < pushed
    r = _lanes(ops) - ops.n[:, None]
    hit = (r >= 0) & (r < pushed[:, None]) & (r < k_max)
    slot = torch.remainder((ops.bot + ops.size)[:, None] + r, cap)
    recs = _gather_rows(tasks, r.clamp(0, k_max - 1))
    ops = ops._replace(slot=torch.where(hit, slot, ops.slot).to(torch.int32),
                       rec=torch.where(hit[:, :, None], recs, ops.rec))
    return ops._replace(size=ops.size + pushed, n=ops.n + pushed), overflow


def stage_pop(ops: DequeOps, mask: torch.Tensor):
    """Staged `pop_top`. Returns (ops, task, ok); the popped record may have
    been staged earlier in the same tick (overlay-aware read)."""
    cap = ops.buf0.shape[1]
    ok = mask & (ops.size > 0)
    new_size = ops.size - ok.to(torch.int32)
    task = stage_read(ops, torch.remainder(ops.bot + new_size, cap))
    return ops._replace(size=new_size), task, ok


def stage_window(ops: DequeOps, window: int) -> torch.Tensor:
    """Staged `peek_bottom_window`: (W, window, T) overlay-aware view, read
    through the O(W·C) last-lane map."""
    cap = ops.buf0.shape[1]
    ranks = torch.arange(window, device=ops.bot.device)[None, :]
    idx = torch.remainder(ops.bot[:, None] + ranks, cap).long()
    lane = torch.gather(_last_lane_map(ops), 1, idx)             # (W, window)
    staged = _gather_rows(ops.rec, lane.clamp(min=0))
    base = _gather_rows(ops.buf0, idx)
    return torch.where((lane >= 0)[:, :, None], staged, base)


def stage_export(ops: DequeOps, grants: torch.Tensor, width: int):
    """Staged `export_bottom`: gather the granted bottom records (zeros
    beyond each worker's grant) and advance the virtual bottom. Returns
    (ops, stolen (W, width, T))."""
    cap = ops.buf0.shape[1]
    g = torch.minimum(grants.clamp(max=width), ops.size)
    ranks = torch.arange(width, device=g.device)[None, :]
    rows = stage_window(ops, width)
    stolen = torch.where((ranks < g[:, None])[:, :, None], rows, 0)
    return ops._replace(bot=torch.remainder(ops.bot + g, cap),
                        size=ops.size - g), stolen


def stage_clear(ops: DequeOps, mask: torch.Tensor) -> DequeOps:
    """Empty `mask` workers' deques (bottom cursor unchanged)."""
    return ops._replace(size=torch.where(mask, 0, ops.size))


def stage_select(ops: DequeOps, pred: torch.Tensor, other: DequeState) -> DequeOps:
    """Where `pred` (per worker (W,), or one flag), discard everything staged
    and restart from `other`: the staged mirror of a rollback's wholesale
    `torch.where(pred, snapshot, current)` over the deque."""
    pred = torch.as_tensor(pred, device=ops.n.device)
    p3 = pred.reshape(-1, 1, 1) if pred.dim() else pred
    return DequeOps(
        buf0=torch.where(p3, other.buf, ops.buf0),
        bot=torch.where(pred, other.bot, ops.bot),
        size=torch.where(pred, other.size, ops.size),
        slot=ops.slot, rec=ops.rec,
        n=torch.where(pred, 0, ops.n))


def winner_map(shape: tuple, dst: torch.Tensor, write: torch.Tensor) -> torch.Tensor:
    """For a batch of (R, K) writes into cells of a `shape`-sized table at
    flat indices `dst`, the flat index r·K + k of the write that lands on
    each cell, -1 where none does. Written cells are unique by the callers'
    contract; the map is a scatter-max, which any order of duplicates
    leaves the same, and unwritten entries add -1 wherever they point."""
    src = torch.arange(dst.numel(), device=dst.device).view(dst.shape)
    numel = 1
    for s in shape:
        numel *= s
    m = torch.full((numel,), -1, dtype=torch.int64, device=dst.device)
    m.scatter_reduce_(0, dst.reshape(-1), torch.where(write, src, -1).reshape(-1),
                      reduce="amax")
    return m.view(shape)


def winners(recs: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """The records `winner_map` chose: `recs` is the (R, K, T) block of the
    writes, `win` flat indices r·K + k, -1 where a cell has no writer (those
    cells read distinct rows, discarded by the caller). Indexed by (row,
    column): one index tensor over the R·K rows of 16 bytes takes a gather
    kernel that is far slower on the H100."""
    R, K = recs.shape[:2]
    spread = torch.arange(win.numel(), device=win.device).view(win.shape) % (R * K)
    w = torch.where(win >= 0, win, spread)
    return recs[w // K, w % K]


def place(state: DequeState, dst_w: torch.Tensor, dst_slot: torch.Tensor,
          recs: torch.Tensor, write: torch.Tensor) -> torch.Tensor:
    """The direct path's multi-source write: `recs[r, k]` into ring slot
    `dst_slot[r, k]` of worker `dst_w[r, k]` where `write[r, k]`. Returns
    the new buffer. Caller contract: written (worker, slot) pairs are
    unique; entries that do not write may point anywhere in range."""
    W, cap = state.buf.shape[:2]
    win = winner_map((W, cap), dst_w.long() * cap + dst_slot.long(), write)
    return torch.where((win >= 0)[..., None], winners(recs, win), state.buf)


def stage_place(ops: DequeOps, dst_w: torch.Tensor, rel_pos: torch.Tensor,
                recs: torch.Tensor, write: torch.Tensor) -> DequeOps:
    """Stage records at positions `rel_pos` above each destination's current
    virtual top (a multi-source write: the transplant path). `dst_w`,
    `rel_pos`, `write` are (R, K), `recs` (R, K, T).

    Caller contract: per destination worker, the written `rel_pos` values
    are collectively gap-free 0..k-1 and `write` already excludes records
    beyond the destination's remaining room. Writes past the lane budget are
    dropped and left out of each destination's size and lane advance, so an
    undersized budget never mints phantom tasks."""
    W, cap = ops.buf0.shape[:2]
    L = ops.slot.shape[1]
    dst = dst_w.long()
    n_d = ops.n[dst]
    lane = n_d + rel_pos
    write = write & (lane < L)
    win = winner_map((W, L), dst * L + lane.clamp(0, L - 1), write)
    hit = win >= 0
    lanes = _lanes(ops)
    # the slot of lane l of worker w is its top then: rel_pos = l - n[w]
    slot = torch.remainder((ops.bot + ops.size - ops.n)[:, None] + lanes, cap)
    added = torch.zeros_like(ops.n).scatter_add_(
        0, dst.reshape(-1), write.reshape(-1).to(torch.int32))
    return ops._replace(
        slot=torch.where(hit, slot, ops.slot).to(torch.int32),
        rec=torch.where(hit[..., None], winners(recs, win), ops.rec),
        size=ops.size + added, n=ops.n + added)


def apply(ops: DequeOps, keep: torch.Tensor | None = None) -> DequeState:
    """Commit all staged mutations in one pass, lanes in staging order (the
    last write to a slot wins), in place into `ops.buf0`, through
    `kernels.ops.deque_apply_`: the CUDA kernel on the card, its plain
    version for CPU tensors. Where the per-row mask `keep` is false the row
    counts as having staged nothing, so its ring stays bit for bit (its
    cursors are returned as staged: the caller masks those). Returns the
    state whose `buf` is `ops.buf0`."""
    from ..kernels import ops as kernel_ops

    n = ops.n if keep is None else torch.where(keep, ops.n, 0)
    buf = kernel_ops.deque_apply_(ops.buf0, ops.slot, ops.rec, n)
    return DequeState(buf, ops.bot, ops.size)
