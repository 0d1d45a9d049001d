"""Port parity: `repro_torch.core.deque` against `repro.core.deque` — the
direct ops on random rings and the staged-against-direct sequences of the
reference's deque tests (wraparound included), each run through both
packages and compared buffer for buffer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same, np_rng, to_jax, to_torch

from repro.core import deque as rdq
from repro_torch import convert
from repro_torch.core import deque as pdq

W, C, T = 24, 8, 4


def random_state(rs, W=W, C=C):
    buf = rs.integers(-1000, 1000, (W, C, T))
    bot = rs.integers(0, C, W)
    size = rs.integers(0, C + 1, W)
    return buf, bot, size


def both(buf, bot, size):
    return (rdq.DequeState(to_jax(buf), to_jax(bot), to_jax(size)),
            convert.deque_state(buf, bot, size))


def assert_state(r, p, what=""):
    assert_same(r.buf, p.buf, f"{what} buf")
    assert_same(r.bot, p.bot, f"{what} bot")
    assert_same(r.size, p.size, f"{what} size")


@pytest.mark.parametrize("seed", range(4))
def test_direct_ops_random(seed):
    rs = np_rng(seed)
    r, p = both(*random_state(rs))
    mask = rs.random(W) < 0.7
    task = rs.integers(0, 99, (W, T))
    (r1, ok_r), (p1, ok_p) = (rdq.push_top(r, to_jax(task), jnp.asarray(mask)),
                              pdq.push_top(p, to_torch(task), torch.as_tensor(mask)))
    assert_same(ok_r, ok_p, "push ok")
    assert_state(r1, p1, "push_top")

    k = 8
    tasks = rs.integers(0, 99, (W, k, T))
    counts = rs.integers(0, k + 1, W)
    (r2, ov_r), (p2, ov_p) = (rdq.push_top_many(r, to_jax(tasks), to_jax(counts)),
                              pdq.push_top_many(p, to_torch(tasks), to_torch(counts)))
    assert_same(ov_r, ov_p, "push_many overflow")
    assert_state(r2, p2, "push_top_many")

    (r3, t_r, k_r), (p3, t_p, k_p) = (rdq.pop_top(r, jnp.asarray(mask)),
                                      pdq.pop_top(p, torch.as_tensor(mask)))
    assert_same(k_r, k_p, "pop ok")
    assert_same(t_r, t_p, "popped")
    assert_state(r3, p3, "pop_top")

    rank = rs.integers(0, C, W)
    assert_same(rdq.peek_bottom(r, to_jax(rank)), pdq.peek_bottom(p, to_torch(rank)))
    for window in (1, 5, C):
        assert_same(rdq.peek_bottom_window(r, window),
                    pdq.peek_bottom_window(p, window), f"window {window}")

    grants = rs.integers(0, 12, W)
    for width in (4, 8):
        (s_r, r4), (s_p, p4) = (rdq.export_bottom(r, to_jax(grants), width),
                                pdq.export_bottom(p, to_torch(grants), width))
        assert_same(s_r, s_p, "stolen")
        assert_state(r4, p4, "export_bottom")
        s_k, p5 = pdq.export_bottom(p, to_torch(grants), width)
        assert_same(rdq.export_bottom(r, to_jax(grants), width, use_kernel=True)[0],
                    s_k, "stolen (Pallas kernel path)")
        assert_state(r4, p5, "export_bottom again")
    counts = rs.integers(0, C + 1, W)
    assert_state(rdq.steal_bottom(r, to_jax(counts)),
                 pdq.steal_bottom(p, to_torch(counts)), "steal_bottom")
    for w in (0, 7, W - 1):
        assert rdq.to_list(r, w) == pdq.to_list(p, w)
    assert int(rdq.total_tasks(r)) == pdq.total_tasks(p)


def test_ring_wraparound():
    ref, port = rdq.make(1, 4), pdq.make(1, 4)
    for i in range(4):
        ref, _ = rdq.push_top(ref, jnp.asarray([[0, i, 0, 0]]), jnp.asarray([True]))
        port, _ = pdq.push_top(port, torch.tensor([[0, i, 0, 0]], dtype=torch.int32),
                               torch.tensor([True]))
    ref = rdq.steal_bottom(ref, jnp.asarray([2]))
    port = pdq.steal_bottom(port, torch.tensor([2], dtype=torch.int32))
    for i in (4, 5):
        ref, _ = rdq.push_top(ref, jnp.asarray([[0, i, 0, 0]]), jnp.asarray([True]))
        port, ok = pdq.push_top(port, torch.tensor([[0, i, 0, 0]], dtype=torch.int32),
                                torch.tensor([True]))
        assert bool(ok[0])
    assert [x[1] for x in pdq.to_list(port, 0)] == [2, 3, 4, 5]
    assert_state(ref, port)


def _full_ring(cap, n, bot):
    buf = np.zeros((1, cap, T), np.int32)
    for i in range(n):
        buf[0, (bot + i) % cap] = (9, i, 0, 0)
    return buf, np.asarray([bot]), np.asarray([n])


def test_wraparound_export_plus_push_many_same_tick():
    """`bot` near capacity with an export and a push crossing the wrap in
    one tick, direct and staged, in both packages."""
    cap = 8
    r, p = both(*_full_ring(cap, 5, bot=6))
    grants = np.asarray([3])
    pushes = np.asarray([[(7, i, 0, 0) for i in range(6)]])
    counts = np.asarray([6])
    out = {}
    for name, dq, st, cv in (("ref", rdq, r, to_jax), ("port", pdq, p, to_torch)):
        stolen_d, mid = dq.export_bottom(st, cv(grants), 4)
        direct, over_d = dq.push_top_many(mid, cv(pushes), cv(counts))
        ops = dq.stage(st, lanes=8)
        ops, stolen_s = dq.stage_export(ops, cv(grants), 4)
        ops, over_s = dq.stage_push_many(ops, cv(pushes), cv(counts))
        out[name] = (stolen_d, direct, over_d, stolen_s, dq.apply(ops), over_s)
    expect = [(9, 3, 0, 0), (9, 4, 0, 0)] + [(7, i, 0, 0) for i in range(6)]
    for (a, b) in zip(out["ref"], out["port"]):
        if isinstance(a, rdq.DequeState):
            assert_state(a, b)
        else:
            assert_same(a, b)
    assert pdq.to_list(out["port"][1], 0) == expect
    assert pdq.to_list(out["port"][4], 0) == expect
    assert_state(out["port"][1], out["port"][4], "direct vs staged")


def test_staged_ops_match_direct_sequence():
    """Push, pop of the record staged the same tick, export, re-push over
    exported slots (last write wins), clear — staged ≡ direct in the port,
    and each equal to the reference."""
    cap = 6
    res = {}
    for name, dq, cv, mk in (("ref", rdq, to_jax, lambda b: jnp.asarray(b)),
                             ("port", pdq, to_torch, lambda b: torch.as_tensor(b))):
        buf, bot, size = _full_ring(cap, 4, bot=4)
        state = (rdq.DequeState(to_jax(buf), to_jax(bot), to_jax(size))
                 if name == "ref" else convert.deque_state(buf, bot, size))
        on = mk(np.asarray([True]))
        direct, ops = state, dq.stage(state, lanes=8)
        rec = cv(np.asarray([[8, 77, 0, 0]]))
        direct, ok_d = dq.push_top(direct, rec, on)
        ops, ok_s = dq.stage_push(ops, rec, on)
        direct, task_d, _ = dq.pop_top(direct, on)
        ops, task_s, _ = dq.stage_pop(ops, on)
        assert int(task_s[0, 1]) == 77
        stolen_d, direct = dq.export_bottom(direct, cv(np.asarray([2])), 4)
        ops, stolen_s = dq.stage_export(ops, cv(np.asarray([2])), 4)
        pushes = cv(np.asarray([[(6, i, 0, 0) for i in range(3)]]))
        direct, _ = dq.push_top_many(direct, pushes, cv(np.asarray([3])))
        ops, _ = dq.stage_push_many(ops, pushes, cv(np.asarray([3])))
        staged = dq.apply(ops)
        ops2 = dq.stage_clear(dq.stage(staged, lanes=4), on)
        res[name] = (task_d, task_s, stolen_d, stolen_s, direct, staged,
                     dq.apply(ops2))
    for a, b in zip(res["ref"], res["port"]):
        if isinstance(a, rdq.DequeState):
            assert_state(a, b)
        else:
            assert_same(a, b)
    assert_state(res["port"][4], res["port"][5], "direct vs staged")


@pytest.mark.parametrize("seed", range(3))
def test_random_staged_sequences(seed):
    """Random mixes of staged pushes, pops, exports and clears on random
    rings: the port's staged record, overlay reads and commit (plain and
    kernel path) equal the reference's at every step."""
    rs = np_rng(50 + seed)
    L = 9
    r, p = both(*random_state(rs))
    ro, po = rdq.stage(r, L), pdq.stage(p, L)
    for step in range(10):
        op = rs.integers(0, 4)
        mask = rs.random(W) < 0.6
        if op == 0:
            task = rs.integers(0, 99, (W, T))
            ro, ok_r = rdq.stage_push(ro, to_jax(task), jnp.asarray(mask))
            po, ok_p = pdq.stage_push(po, to_torch(task), torch.as_tensor(mask))
            assert_same(ok_r, ok_p, f"step {step} push ok")
        elif op == 1:
            tasks = rs.integers(0, 99, (W, 8, T))
            counts = rs.integers(0, 9, W)
            ro, ov_r = rdq.stage_push_many(ro, to_jax(tasks), to_jax(counts))
            po, ov_p = pdq.stage_push_many(po, to_torch(tasks), to_torch(counts))
            assert_same(ov_r, ov_p, f"step {step} overflow")
        elif op == 2:
            ro, t_r, k_r = rdq.stage_pop(ro, jnp.asarray(mask))
            po, t_p, k_p = pdq.stage_pop(po, torch.as_tensor(mask))
            assert_same(k_r, k_p)
            assert_same(t_r, t_p, f"step {step} popped")
        else:
            grants = rs.integers(0, 10, W)
            ro, s_r = rdq.stage_export(ro, to_jax(grants), 8)
            po, s_p = pdq.stage_export(po, to_torch(grants), 8)
            assert_same(s_r, s_p, f"step {step} stolen")
        for f in ("bot", "size", "slot", "rec", "n"):
            assert_same(getattr(ro, f), getattr(po, f), f"step {step} {f}")
        assert_same(rdq.stage_window(ro, C), pdq.stage_window(po, C))
    idx = rs.integers(0, C, (W, 3))
    assert_same(rdq.stage_read(ro, to_jax(idx)), pdq.stage_read(po, to_torch(idx)))
    assert_same(rdq._last_lane_map(ro), pdq._last_lane_map(po))
    want = rdq.apply(ro)
    assert_state(want, pdq.apply(po), "apply")
    assert_state(rdq.apply(ro, use_kernel=True), pdq.apply(po),
                 "apply (Pallas kernel path)")
    clear = rs.random(W) < 0.5
    assert_same(rdq.stage_clear(ro, jnp.asarray(clear)).size,
                pdq.stage_clear(po, torch.as_tensor(clear)).size)


def _transplant_inputs(rs, W=W, C=C):
    """A random ring set, sources (a few workers) and heirs: each source's
    heir is a random non-source worker, several sources per heir."""
    buf, bot, size = random_state(rs, W, C)
    src = rs.random(W) < 0.3
    heir = rs.choice(np.flatnonzero(~src), W)
    acc = rs.integers(0, 1000, W)
    ovf = rs.integers(0, 3, W)
    return buf, bot, size, src, heir, acc, ovf


@pytest.mark.parametrize("seed", range(4))
def test_stage_place_and_select_match_reference(seed):
    """`stage_place` at a transplant plan's (heir, rel_pos) places, after a
    few staged pushes, and `stage_select` against a snapshot, each equal to
    the reference's on random rings; both kernel-path commits equal."""
    from repro.core import simulator as rsim
    rs = np_rng(70 + seed)
    buf, bot, size, src, heir, _, _ = _transplant_inputs(rs)
    r, p = both(buf, bot, size)
    L = 9 + C + 10
    ro, po = rdq.stage(r, L), pdq.stage(p, L)
    task = rs.integers(0, 99, (W, T))
    mask = rs.random(W) < 0.5
    ro, _ = rdq.stage_push(ro, to_jax(task), jnp.asarray(mask))
    po, _ = pdq.stage_push(po, to_torch(task), torch.as_tensor(mask))
    ranks, offset, write, _, _ = rsim._transplant_plan(ro.size, jnp.asarray(src),
                                                       to_jax(heir), C)
    dst = np.broadcast_to(heir[:, None], (W, C))
    rel = np.asarray(offset)[:, None] + np.asarray(ranks)
    recs = rdq.stage_window(ro, C)
    ro = rdq.stage_place(ro, to_jax(dst), to_jax(rel), recs, write)
    po = pdq.stage_place(po, to_torch(dst), to_torch(rel),
                         pdq.stage_window(po, C), torch.as_tensor(np.array(write)))
    for f in ("bot", "size", "slot", "rec", "n"):
        assert_same(getattr(ro, f), getattr(po, f), f"stage_place {f}")
    # the port's commit writes into buf0 in place: commit into a copy, so
    # that stage_select below still starts from the tick-start ring
    assert_state(rdq.apply(ro), pdq.apply(po._replace(buf0=po.buf0.clone())),
                 "apply after stage_place")
    snap_buf, snap_bot, snap_size = random_state(rs)
    rsnap, psnap = both(snap_buf, snap_bot, snap_size)
    for pred in (True, False):
        rs_, ps_ = (rdq.stage_select(ro, jnp.asarray(pred), rsnap),
                    pdq.stage_select(po, torch.tensor(pred), psnap))
        for f in ("buf0", "bot", "size", "n"):
            assert_same(getattr(rs_, f), getattr(ps_, f), f"stage_select {pred} {f}")
    rows = rs.random(W) < 0.5
    ps_ = pdq.stage_select(po, torch.as_tensor(rows), psnap)
    for w in range(W):
        one = pdq.stage_select(po, torch.tensor(bool(rows[w])), psnap)
        for f in ("buf0", "bot", "size", "n"):
            assert_same(getattr(one, f)[w], getattr(ps_, f)[w], f"row {w} {f}")


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("staged", [False, True])
def test_transplant_matches_reference(seed, staged):
    """The simulator's transplant on both backends (`place` on the ring
    buffer, `stage_place` into the push log) against the reference's
    `_transplant` / `_stage_transplant`: rings, accumulators and overflow
    equal, heirs short of room included (full rings)."""
    from repro.core import simulator as rsim
    from repro_torch.core import simulator as psim
    rs = np_rng(90 + seed)
    buf, bot, size, src, heir, acc, ovf = _transplant_inputs(rs)
    r, p = both(buf, bot, size)
    args = (to_jax(acc), jnp.asarray(src), to_jax(heir), to_jax(ovf))
    ses = psim._Deques(pdq.DequeState(*(x[None] for x in p)),
                       9 + C + 10 if staged else None)
    acc_p, ovf_p = ses.transplant(to_torch(acc)[None], torch.as_tensor(src)[None],
                                  to_torch(heir)[None].long(), to_torch(ovf)[None])
    if staged:
        ops, acc_r, ovf_r = rsim._stage_transplant(rdq.stage(r, 9 + C + 10), *args)
        want = rdq.apply(ops)
    else:
        want, acc_r, ovf_r = rsim._transplant(r, *args)
    got = ses.finish()
    assert_state(want, pdq.DequeState(*(x[0] for x in got)), "transplant")
    assert_same(acc_r, acc_p[0], "acc")
    assert_same(ovf_r, ovf_p[0], "overflow")


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("C", [8, 3])
def test_inplace_pushes_random(seed, C):
    """`push_top_` and `push_top_many_` leave exactly the reference's ring
    (the round executor's pushes), written into the buffer they are given;
    C = 3 is below the 8-lane staging block."""
    rs = np_rng(100 + seed)
    buf, bot, size = random_state(rs, C=C)
    mask = rs.random(W) < 0.7
    task = rs.integers(0, 99, (W, T))
    tasks = rs.integers(0, 99, (W, 8, T))
    counts = rs.integers(0, 9, W)
    r = rdq.DequeState(to_jax(buf), to_jax(bot), to_jax(size))
    r1, ok_r = rdq.push_top(r, to_jax(task), jnp.asarray(mask))
    p = convert.deque_state(buf, bot, size)
    p1, ok_p = pdq.push_top_(p, to_torch(task), torch.as_tensor(mask))
    assert p1.buf is p.buf
    assert_same(ok_r, ok_p, "push ok")
    assert_state(r1, p1, "push_top_")
    r2, ov_r = rdq.push_top_many(r1, to_jax(tasks), to_jax(counts))
    p2, ov_p = pdq.push_top_many_(p1, to_torch(tasks), to_torch(counts))
    assert p2.buf is p.buf
    assert_same(ov_r, ov_p, "push_many overflow")
    assert_state(r2, p2, "push_top_many_")
