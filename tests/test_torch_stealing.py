"""Port parity: `repro_torch.core.stealing` against `repro.core.stealing` —
victim tables, every `choose_*` at fixed keys, `segment_prefix` and
`resolve_grants` (against the reference and the pairwise oracle)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same, np_rng, to_jax, to_torch
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import stealing as rst
from repro.core import topology as rtopo
from repro_torch.core import rng
from repro_torch.core import stealing as pst
from repro_torch.core import topology as ptopo

MESHES = [(9, False), (36, False), (23, True), (100, False)]


def test_constants():
    assert rst.GRANT_WIDTH == pst.GRANT_WIDTH
    for s in rst.Strategy:
        assert rst.strategy_code(s) == pst.strategy_code(pst.Strategy(s.value))
        assert rst.strategy_code(s.value) == pst.strategy_code(s.value)


@pytest.mark.parametrize("W,torus", MESHES)
def test_victim_tables(W, torus):
    rm, pm = rtopo.MeshTopology.square(W, torus), ptopo.MeshTopology.square(W, torus)
    assert_same(rst.neighbor_list(rm), pst.neighbor_list(pm))
    assert_same(rst.radius2_list(rm), pst.radius2_list(pm))
    assert_same(rst.lifeline_list(W), pst.lifeline_list(W))


def keys(seed, t):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), t),
            rng.fold_in(rng.PRNGKey(seed), t))


@pytest.mark.parametrize("W,torus", MESHES)
def test_choose_strategies_at_fixed_keys(W, torus):
    rm, pm = rtopo.MeshTopology.square(W, torus), ptopo.MeshTopology.square(W, torus)
    rs = np_rng(W)
    nbr, r2, ll = (pst.neighbor_list(pm), pst.radius2_list(pm),
                   pst.lifeline_list(W))
    for seed, t in ((0, 0), (7, 59), (123456, 4095)):
        kj, kt = keys(seed, t)
        thief = rs.random(W) < 0.7
        fails = rs.integers(0, 9, W)
        tj, tt = jnp.asarray(thief), torch.as_tensor(thief)
        assert_same(rst.choose_global(kj, W, tj), pst.choose_global(kt, W, tt))
        assert_same(rst.choose_neighbor(kj, to_jax(nbr), tj),
                    pst.choose_neighbor(kt, to_torch(nbr), tt))
        assert_same(rst.choose_lifeline(kj, to_jax(ll), to_jax(fails), W, tj),
                    pst.choose_lifeline(kt, to_torch(ll), to_torch(fails), W, tt))
        for esc in (1, 4):
            assert_same(
                rst.choose_adaptive(kj, to_jax(nbr), to_jax(r2), to_jax(fails),
                                    tj, esc),
                pst.choose_adaptive(kt, to_torch(nbr), to_torch(r2),
                                    to_torch(fails), tt, esc))


@pytest.mark.parametrize("seed", range(6))
def test_segment_prefix(seed):
    rs = np_rng(200 + seed)
    W = int(rs.integers(2, 200))
    key = rs.integers(0, max(W // 8, 1) + 1, W)
    active = rs.random(W) < 0.6
    weights = rs.integers(0, 20, W)
    priority = rs.integers(0, W, W)
    for kw in ({}, {"weights": weights}, {"priority": priority},
               {"weights": weights, "priority": priority}):
        want = rst.segment_prefix(to_jax(key), jnp.asarray(active),
                                  **{k: to_jax(v) for k, v in kw.items()})
        got = pst.segment_prefix(to_torch(key), torch.as_tensor(active),
                                 **{k: to_torch(v) for k, v in kw.items()})
        assert got.dtype == torch.int32
        assert_same(want, got, str(sorted(kw)))


@pytest.mark.parametrize("seed", range(6))
def test_resolve_grants(seed):
    rs = np_rng(300 + seed)
    W = int(rs.integers(2, 150))
    victim = np.where(rs.random(W) < 0.6, rs.integers(0, max(W // 6, 1), W), -1)
    sizes = rs.integers(0, 7, W)
    priority = rs.integers(0, W, W)
    for budget in (1, 4, 8):
        for pri in (None, priority):
            kw = {} if pri is None else {"priority": pri}
            want = rst.resolve_grants(to_jax(victim), to_jax(sizes), budget,
                                      **{k: to_jax(v) for k, v in kw.items()})
            got = pst.resolve_grants(to_torch(victim), to_torch(sizes), budget,
                                     **{k: to_torch(v) for k, v in kw.items()})
            oracle = pst.resolve_grants_pairwise(
                to_torch(victim), to_torch(sizes), budget,
                **{k: to_torch(v) for k, v in kw.items()})
            for f in rst.StealPlan._fields:
                assert_same(getattr(want, f), getattr(got, f), f)
                assert_same(getattr(oracle, f), getattr(got, f), f"pairwise {f}")
