"""Port parity: FIB/UTS workloads, `_uts_child_count` and `expand` against
`repro.core.tasks` (exact: all integer, except the float32 UTS child count,
checked over a large (depth, seed) grid)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same, np_rng, to_jax, to_torch
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import tasks as rtasks
from repro_torch import convert
from repro_torch.core import tasks as ptasks


def test_constants_and_tables():
    for name in ("KIND_NONE", "KIND_FIB", "KIND_UTS", "KIND_CHUNK", "KIND_REQ",
                 "EXPAND_K", "CHILD_CAP"):
        assert getattr(rtasks, name) == getattr(ptasks, name), name
    assert int(rtasks.RESULT_MOD) == ptasks.RESULT_MOD
    assert_same(rtasks.fib_mod_table(), ptasks.fib_mod_table())
    for wl in (rtasks.FibWorkload(), rtasks.FibWorkload(n=48, cutoff=28,
                                                        max_leaf_cost=2048),
               rtasks.UtsWorkload(b0=4.0, d_max=16)):
        pw = convert.workload(type(wl).__name__, dataclasses.asdict(wl))
        assert_same(wl.root_task(), pw.root_task())
        rt, pt = wl.tables(), pw.tables()
        assert_same(rt["fib_mod"], pt["fib_mod"])
        assert_same(rt["fib_cost"], pt["fib_cost"])
        assert int(rt["fib_cutoff"]) == pt["fib_cutoff"]
        assert np.float32(rt["uts_b0"]) == np.float32(pt["uts_b0"])
        assert int(rt["uts_dmax"]) == pt["uts_dmax"]
        if isinstance(wl, rtasks.FibWorkload):
            assert wl.expected_result() == pw.expected_result()
            assert wl.expected_nodes() == pw.expected_nodes()
            assert wl.expected_work_units() == pw.expected_work_units()


# (depth, seed) points at d_max 16 where a float32 log one ulp off the
# reference's flips the child count (found over the wide grid below)
UTS_FLIP_POINTS = ((4, 501288650), (3, 550108876), (6, 609191051), (5, 1214513702))


def _uts_grid(b0, d_max, wide):
    """The grid's (depth, seed) pairs: 200k random seeds (and 0..63), each
    at one depth in turn; wide: seeds arange(2^22)·509 mod 2^31, each at
    every depth below d_max."""
    if not wide:
        rs = np_rng(17)
        seeds = np.concatenate([rs.integers(0, 2**31, 200_000), np.arange(64)])
        depth = np.tile(np.arange(d_max + 2), seeds.size // (d_max + 2) + 1)[:seeds.size]
        return depth, seeds
    seeds = (np.arange(1 << 22, dtype=np.int64) * 509) % 2**31
    return (np.repeat(np.arange(d_max)[:, None], seeds.size, 1).ravel(),
            np.tile(seeds, d_max))


@pytest.mark.parametrize("b0,d_max,wide", [(4.0, 16, False), (4.0, 10, False),
                                           (3.0, 6, False), (2.5, 40, False),
                                           (8.0, 12, False), (4.0, 16, True)],
                         ids=["4.0-16", "4.0-10", "3.0-6", "2.5-40", "8.0-12",
                              "4.0-16-wide"])
def test_uts_child_count_grid(b0, d_max, wide):
    """Every (depth, seed) pair of a grid per shape: a float32 `log` an ulp
    off the reference's flips a node on a floor() boundary; the grid must
    show 0 mismatches. The wide grid (67M pairs, in chunks) holds the four
    points where `torch.log` flips (`UTS_FLIP_POINTS`)."""
    depth, seeds = _uts_grid(b0, d_max, wide)
    if wide:  # the flip points are pairs of the grid
        for d, s in UTS_FLIP_POINTS:
            assert s % 509 == 0 and s // 509 < (1 << 22) and d < d_max
    # the wide grid takes the reference's count jitted, as its simulator does
    ref = jax.jit(rtasks._uts_child_count) if wide else rtasks._uts_child_count
    mismatches = 0
    step = 1 << 23
    for i in range(0, seeds.size, step):
        d, s = depth[i:i + step], seeds[i:i + step]
        want = np.asarray(ref(to_jax(d), to_jax(s), jnp.float32(b0), jnp.int32(d_max)))
        got = ptasks._uts_child_count(to_torch(d), to_torch(s),
                                      float(np.float32(b0)), d_max).numpy()
        mismatches += int((want != got).sum())
    assert mismatches == 0, f"{mismatches} UTS child-count mismatches"


def test_uts_child_count_flip_points():
    """The four points where the C library's float32 log gives another
    child count than the reference's: the port gives the reference's."""
    d = np.array([p[0] for p in UTS_FLIP_POINTS])
    s = np.array([p[1] for p in UTS_FLIP_POINTS])
    want = np.asarray(rtasks._uts_child_count(to_jax(d), to_jax(s), jnp.float32(4.0),
                                              jnp.int32(16)))
    got = ptasks._uts_child_count(to_torch(d), to_torch(s), 4.0, 16).numpy()
    assert_same(want, got)
    assert want.tolist() == [1, 5, 3, 7]


def test_count_tree():
    wl = rtasks.UtsWorkload(b0=4.0, d_max=6)
    pw = convert.workload("UtsWorkload", dataclasses.asdict(wl))
    assert wl.count_tree() == pw.count_tree()


def _random_batch(rs, W):
    kind = rs.integers(0, 5, W)
    a = np.where(kind == rtasks.KIND_FIB, rs.integers(0, 95, W),
                 np.where(kind == rtasks.KIND_REQ, rs.integers(-3, 500, W),
                          rs.integers(0, 14, W)))
    b = rs.integers(0, 2**31, W)
    count = rs.integers(0, 65, W)
    c = np.where(kind == rtasks.KIND_CHUNK,
                 rs.integers(0, 60, W) * 256 + count, rs.integers(0, 2**20, W))
    return np.stack([kind, a, b, c], 1).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("wl", [rtasks.FibWorkload(n=30, cutoff=12),
                                rtasks.UtsWorkload(b0=4.0, d_max=10)],
                         ids=["fib", "uts"])
def test_expand_random_batches(seed, wl):
    rs = np_rng(100 + seed)
    W = 512
    task = _random_batch(rs, W)
    active = rs.random(W) < 0.8
    pw = convert.workload(type(wl).__name__, dataclasses.asdict(wl))
    want = rtasks.expand(to_jax(task), jnp.asarray(active), wl.tables())
    got = ptasks.expand(to_torch(task), torch.as_tensor(active), pw.tables())
    assert set(want) == set(got)
    for k in want:
        assert got[k].dtype == torch.int32, k
        assert_same(want[k], got[k], k)
