"""Port parity of the in-place staged commit and the one-launch grant export.

`ref.deque_apply_` (the plain version of the CUDA kernel, which writes into
the ring it is given) against the reference's oracle and the Pallas kernel
in interpret mode, over push-log widths, capacities, repeated and
out-of-range slots and empty and full logs; that it writes through the
buffer's own storage and that `deque.apply` leaves gated rows bit for bit;
staged grids whose points stop at different iterations (a TC grid commits
twice a tick) against each point's reference `simulate`; and `steal_compact`
at an export width below its staging width against the reference's
`export_bottom`."""

import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import assert_results_equal, assert_same, np_rng, to_jax, to_torch
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import deque as rdq
from repro.core import simulator as rsim
from repro.core import stealing as rst
from repro.core import tasks as rtasks
from repro.core import topology as rtopo
from repro.kernels import ref as rref
from repro.kernels.deque_apply import deque_apply as pallas_deque_apply
from repro_torch import convert
from repro_torch.core import deque as pdq
from repro_torch.core import simulator as psim
from repro_torch.core import stealing as pst
from repro_torch.kernels import ops, ref

W9 = 9
FIB = rtasks.FibWorkload(n=20, cutoff=9, max_leaf_cost=8)
MESH = rtopo.MeshTopology.square(W9)
PWL = convert.workload("FibWorkload", dataclasses.asdict(FIB))
PMESH = convert.mesh(W9, 3, 3)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread a test process: the plain path runs many small
    operations, and parallel test workers must not oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def push_log(rs, W, C, L):
    """A ring set and an L-lane push log: slots drawn from a few ring
    positions around a base (lanes repeat slots), one lane in eight out of
    [0, C) on either side; live counts mixing 0, L and values between."""
    buf = rs.integers(-1000, 1000, (W, C, 4))
    base = rs.integers(0, C, (W, 1))
    slot = (base + rs.integers(0, 3, (W, L))) % C
    out = rs.random((W, L)) < 1 / 8
    slot[out] = rs.choice([-1, C, C + 5, -7], int(out.sum()))
    rec = rs.integers(-1000, 1000, (W, L, 4))
    n = rs.integers(0, L + 1, W)
    n[::4], n[1::4] = 0, L
    return buf, slot, rec, n


@pytest.mark.parametrize("C", [8, 64])
@pytest.mark.parametrize("L", [1, 9, 33, 83])
def test_inplace_plain_matches_reference_and_pallas(L, C):
    W = 16
    buf, slot, rec, n = push_log(np_rng(L * 100 + C), W, C, L)
    args = (to_jax(buf), to_jax(slot), to_jax(rec), to_jax(n))
    target = to_torch(buf)
    got = ref.deque_apply_(target, to_torch(slot), to_torch(rec), to_torch(n))
    assert got is target
    assert_same(rref.deque_apply_ref(*args), got, "vs ref")
    assert_same(pallas_deque_apply(*args, interpret=True), got, "vs pallas")
    # the out-of-place plain version and the wrapper agree with it
    assert_same(ref.deque_apply(*map(to_torch, (buf, slot, rec, n))), got)
    assert_same(ops.deque_apply(*map(to_torch, (buf, slot, rec, n))), got)
    # rows with n = 0 are untouched
    assert_same(buf[n == 0], got[torch.as_tensor(n == 0)])


def test_inplace_commit_writes_through_the_buffer_storage():
    """`ref.deque_apply_` and `ops.deque_apply_` return the tensor they were
    given, written through its storage: a view of a larger buffer (the
    simulator's (G, W, C, 4) ring flattened to rows) sees the commit, and
    the out-of-place wrapper leaves its input alone."""
    buf, slot, rec, n = push_log(np_rng(3), 12, 16, 9)
    want = ref.deque_apply(*map(to_torch, (buf, slot, rec, n)))
    for fn in (ref.deque_apply_, ops.deque_apply_):
        grid = to_torch(buf).view(3, 4, 16, 4)
        rows = grid.flatten(0, 1)
        out = fn(rows, to_torch(slot), to_torch(rec), to_torch(n))
        assert out is rows and out.data_ptr() == grid.data_ptr()
        assert_same(want, grid.flatten(0, 1))
    before = to_torch(buf)
    ops.deque_apply(before, to_torch(slot), to_torch(rec), to_torch(n))
    assert_same(buf, before)


def test_gated_rows_stay_bit_for_bit():
    """`deque.apply` with a per-row `keep` mask commits the kept rows as a
    full commit does and leaves every other row of the ring as it was."""
    rs = np_rng(11)
    W, C, L = 24, 16, 9
    buf, slot, rec, n = push_log(rs, W, C, L)
    keep = rs.random(W) < 0.5
    d = pdq.DequeOps(buf0=to_torch(buf), bot=to_torch(rs.integers(0, C, W)),
                     size=to_torch(rs.integers(0, C + 1, W)), slot=to_torch(slot),
                     rec=to_torch(rec), n=to_torch(n))
    full = ref.deque_apply(d.buf0, d.slot, d.rec, d.n)
    out = pdq.apply(d, torch.as_tensor(keep))
    assert out.buf is d.buf0
    assert_same(full[torch.as_tensor(keep)], out.buf[torch.as_tensor(keep)])
    assert_same(buf[~keep], out.buf[torch.as_tensor(~keep)])
    assert_same(d.bot, out.bot)
    assert_same(d.size, out.size)


def test_stopped_points_rings_stay_bit_for_bit():
    """The simulator's staged session commits into the grid's own ring, in
    the rows of the running points only: a stopped point's ring is left as
    it was, so the loop has nothing to mask there."""
    rs = np_rng(12)
    G, W, C = 3, 4, 8
    buf = rs.integers(-1000, 1000, (G, W, C, 4))
    state = pdq.DequeState(to_torch(buf), to_torch(rs.integers(0, C, (G, W))),
                           to_torch(rs.integers(0, C // 2, (G, W))))
    run = torch.tensor([[True], [False], [True]])
    ses = psim._Deques(state, 9, run)
    ses.push(to_torch(rs.integers(0, 99, (G, W, 4))), torch.ones((G, W), dtype=torch.bool))
    ses.push_many(to_torch(rs.integers(0, 99, (G, W, 8, 4))), to_torch(np.full((G, W), 3)))
    out = ses.finish()
    assert out.buf.data_ptr() == state.buf.data_ptr()
    assert psim._same_storage(out.buf, state.buf)
    assert_same(buf[1], out.buf[1])
    assert not np.array_equal(buf[0], out.buf[0].numpy())
    assert not np.array_equal(buf[2], out.buf[2].numpy())


def _schedule():
    ft = -np.ones(W9, np.int32)
    ft[2], ft[5] = 70, 150
    return {"fail_time": ft}


@pytest.mark.parametrize("grid", ["batch", "sweep"])
def test_staged_grid_points_equal_reference_runs(grid):
    """Staged grids, whose commits write each running point's ring in
    place, against each point's own reference `simulate`, `events`
    included. "batch": a TC `simulate_batch` over seeds with two deaths
    (rollbacks; a checkpoint cut commits twice a tick) whose points stop at
    different iterations; "sweep": points of other strategies and τ under
    TC where one point checkpoints and the others do not, with no deaths
    (a point that never checkpoints would lose the dead's work and run to
    `max_ticks`)."""
    sched = _schedule() if grid == "batch" else {}
    base = rsim.SimConfig(hop_ticks=3, capacity=64, max_ticks=200_000,
                          recovery=rsim.Recovery.TC, ckpt_interval=30)
    pbase = convert.sim_config({**dataclasses.asdict(base), "deque_backend": "staged"})
    if grid == "batch":
        seeds = (0, 1, 2)
        got = psim.simulate_batch(PWL, PMESH, pbase, seeds=seeds, device="cpu", **sched)
        cfgs = [dataclasses.replace(base, seed=s) for s in seeds]
    else:
        pts = [(rst.Strategy.NEIGHBOR, 3, 0), (rst.Strategy.GLOBAL, 1, 30),
               (rst.Strategy.NEIGHBOR, 6, 0)]
        cfgs = [dataclasses.replace(base, strategy=s, hop_ticks=tau, ckpt_interval=ck)
                for s, tau, ck in pts]
        got = psim.simulate_sweep(
            PWL, PMESH, pbase,
            [dataclasses.replace(pbase, strategy=pst.Strategy(c.strategy.value),
                                 hop_ticks=c.hop_ticks, ckpt_interval=c.ckpt_interval)
             for c in cfgs], device="cpu", **sched)
    for cfg, g in zip(cfgs, got):
        assert_results_equal(rsim.simulate(FIB, MESH, cfg, **sched), g)
    assert len({g.events for g in got}) > 1
    assert [g.ckpt_bytes > 0 for g in got] == [c.ckpt_interval > 0 for c in cfgs]


@pytest.mark.parametrize("width", [1, 3, 4])
def test_steal_compact_clamps_to_a_narrow_width(width):
    """`steal_compact` at an export width below its staging width, with
    grants above the width: the stolen block, bottoms and sizes equal the
    reference's `export_bottom`, which clamps before its kernel."""
    rs = np_rng(40 + width)
    W, C = 32, 16
    buf = rs.integers(-1000, 1000, (W, C, 4))
    bot, size = rs.integers(0, C, W), rs.integers(0, C + 1, W)
    grants = rs.integers(0, 12, W)
    grants[::3] = width + rs.integers(1, 5, len(grants[::3]))
    state = rdq.DequeState(to_jax(buf), to_jax(bot), to_jax(size))
    want, want_state = rdq.export_bottom(state, to_jax(grants), width)
    stolen, new_bot, new_size = ref.steal_compact(
        *map(to_torch, (buf, bot, size, grants)), width)
    assert tuple(stolen.shape) == (W, width, 4)
    assert_same(want, stolen, "stolen")
    assert_same(want_state.bot, new_bot, "bot")
    assert_same(want_state.size, new_size, "size")
    got, got_state = pdq.export_bottom(
        pdq.DequeState(*map(to_torch, (buf, bot, size))), to_torch(grants), width)
    assert_same(want, got, "export_bottom stolen")
    assert_same(want_state.bot, got_state.bot, "export_bottom bot")
    assert_same(want_state.size, got_state.size, "export_bottom size")
    with pytest.raises(ValueError, match="staging width"):
        ops.steal_compact(*map(to_torch, (buf, bot, size, grants)),
                          width=ref.GRANT_WIDTH + 1)
