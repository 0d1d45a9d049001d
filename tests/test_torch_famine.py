"""Port parity of the famine fast path's parts: batched threefry keys and
draws against `jax.random` row for row, `probe_may_succeed(_code)` and
`batched_victim_draws(_code)` against `repro.core.stealing`, the done-flag
interval of the run loop, the defaults, and (on a card) the captured loop
against the CPU path with no host sync inside. The end-to-end runs against
the reference are in test_torch_famine_e2e.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_results_equal, assert_same, np_rng, to_jax, to_torch
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import simulator as rsim
from repro.core import stealing as rst
from repro_torch.core import rng
from repro_torch.core import simulator as psim
from repro_torch.core import stealing as pst
from repro_torch.core import tasks as ptasks
from repro_torch.core import topology as ptopo

T0S = (0, 1234, 2**31 - 70)
FBS = (1, 7, 64)
# a square mesh, a ragged torus (a 5x5 grid holding 23) and a full torus
MESHES = [(9, False), (23, True), (36, True)]


def _key_rows(key):
    return np.stack([np.asarray(key[0]).reshape(-1), np.asarray(key[1]).reshape(-1)], 1)


@pytest.mark.parametrize("t0", T0S)
@pytest.mark.parametrize("fb", FBS)
def test_batched_keys_and_draws_match_jax_row_for_row(t0, fb):
    """fold_in on a column of ticks, split, and one (FB, W) threefry pass of
    bits, uniform and randint equal jax.random's draws tick by tick; a 0-d
    tensor tick gives the int path's key."""
    W, seed = 37, 11
    key0 = rng.PRNGKey(seed)
    ticks = torch.tensor(t0, dtype=torch.int32) + torch.arange(fb)[:, None]
    keys = rng.fold_in(key0, ticks)
    k1, k2 = rng.split(keys)
    bits = rng.random_bits(keys, W, "cpu")
    uni = rng.uniform(keys, W, "cpu")
    ints = rng.randint(keys, W, 0, W - 1, "cpu")
    assert bits.shape == uni.shape == ints.shape == (fb, W)
    kj0 = jax.random.PRNGKey(seed)
    want_keys, want_split, want = [], [], {"bits": [], "uniform": [], "randint": []}
    for j in range(fb):
        kj = jax.random.fold_in(kj0, t0 + j)
        want_keys.append(np.asarray(kj))
        want_split.append(np.asarray(jax.random.split(kj)))
        want["bits"].append(np.asarray(jax.random.bits(kj, (W,))).astype(np.int64))
        want["uniform"].append(np.asarray(jax.random.uniform(kj, (W,))).view(np.int32))
        want["randint"].append(np.asarray(jax.random.randint(kj, (W,), 0, W - 1)))
    assert_same(np.stack(want_keys).astype(np.int64), _key_rows(keys), "fold_in")
    assert_same(np.stack(want_split)[:, 0].astype(np.int64), _key_rows(k1), "split[0]")
    assert_same(np.stack(want_split)[:, 1].astype(np.int64), _key_rows(k2), "split[1]")
    assert_same(np.stack(want["bits"]), bits, "bits")
    assert_same(np.stack(want["uniform"]), uni.numpy().view(np.int32), "uniform")
    assert_same(np.stack(want["randint"]), ints, "randint")
    # a 0-d device tick: the same key as the host's ints, and its draws
    k_t = rng.fold_in(key0, torch.tensor(t0 + fb - 1, dtype=torch.int32))
    assert tuple(int(x) for x in k_t) == rng.fold_in(key0, t0 + fb - 1)
    assert_same(want["randint"][-1], rng.randint(k_t, W, 0, W - 1, "cpu"), "0-d")


def _tables(W, torus):
    mesh = ptopo.MeshTopology.square(W, torus)
    return pst.neighbor_list(mesh), pst.radius2_list(mesh)


@pytest.mark.parametrize("W,torus", MESHES)
def test_probe_may_succeed_matches_reference(W, torus):
    """Every strategy, by enum and by code (int and tensor), on random
    nonempty/fails, over windows and cycle lengths."""
    nbr, r2 = _tables(W, torus)
    rs = np_rng(W + 100 * torus)
    for density in (0.0, 0.05, 0.3):
        nonempty = rs.random(W) < density
        fails = rs.integers(0, 9, W)
        nj, fj = jnp.asarray(nonempty), to_jax(fails)
        nt, ft = torch.as_tensor(nonempty), to_torch(fails)
        for window, min_cycle, esc in ((0, 1, 4), (7, 9, 4), (64, 9, 4),
                                       (64, 1, 1), (30, 5, 6)):
            kw = dict(escalate_after=esc, window=window, min_cycle=min_cycle,
                      num_workers=W)
            for s in rst.Strategy:
                ps = pst.Strategy(s.value)
                want = rst.probe_may_succeed(s, nj, fj, to_jax(nbr), to_jax(r2), **kw)
                assert_same(want, pst.probe_may_succeed(
                    ps, nt, ft, to_torch(nbr), to_torch(r2), **kw), s.value)
                code = rst.strategy_code(s)
                want_c = rst.probe_may_succeed_code(
                    jnp.int32(code), nj, fj, to_jax(nbr), to_jax(r2), **kw)
                assert_same(want, want_c)
                for c in (code, torch.tensor(code)):
                    assert_same(want_c, pst.probe_may_succeed_code(
                        c, nt, ft, to_torch(nbr), to_torch(r2), **kw),
                        f"{s.value} code {c!r}")


@pytest.mark.parametrize("W,torus", MESHES)
def test_batched_victim_draws_match_reference(W, torus):
    """(near, far) of GLOBAL, NEIGHBOR and ADAPTIVE by enum, and of every
    code (LIFELINE: the global placeholder) by int and tensor code, from an
    int and a 0-d tensor t0."""
    nbr, r2 = _tables(W, torus)
    seed, t0, count = 5, 977, 9
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    for s in (rst.Strategy.GLOBAL, rst.Strategy.NEIGHBOR, rst.Strategy.ADAPTIVE):
        wn, wf = rst.batched_victim_draws(s, kj, t0, count, to_jax(nbr),
                                          to_jax(r2), num_workers=W)
        for t in (t0, torch.tensor(t0, dtype=torch.int32)):
            gn, gf = pst.batched_victim_draws(pst.Strategy(s.value), kt, t, count,
                                              to_torch(nbr), to_torch(r2),
                                              num_workers=W)
            assert_same(wn, gn, f"{s.value} near")
            assert (wf is None) == (gf is None)
            if wf is not None:
                assert_same(wf, gf, f"{s.value} far")
    for s in rst.Strategy:
        code = rst.strategy_code(s)
        wn, wf = rst.batched_victim_draws_code(jnp.int32(code), kj, t0, count,
                                               to_jax(nbr), to_jax(r2),
                                               num_workers=W)
        for c in (code, torch.tensor(code)):
            gn, gf = pst.batched_victim_draws_code(c, kt, t0, count, to_torch(nbr),
                                                   to_torch(r2), num_workers=W)
            assert_same(wn, gn, f"{s.value} code near")
            assert_same(wf, gf, f"{s.value} code far")


def test_link_state_arguments_raise_naming_item_10():
    """The three link-state calls that raised (naming ROADMAP item 10)
    before the link-state slice was ported — `probe_may_succeed` and
    `probe_may_succeed_code` with a component row, the batched ADAPTIVE
    draws with an epoch's τ row — now equal the reference on the same
    inputs."""
    nbr, r2 = _tables(9, False)
    rs = np_rng(19)
    nonempty = rs.random(9) < 0.3
    fails = rs.integers(0, 6, 9).astype(np.int32)
    comp = np.asarray([0, 0, 0, 0, 4, 0, 0, 0, 0], np.int32)
    tau = rs.integers(1, 5, (9, 4)).astype(np.int32)
    kw = dict(escalate_after=4, window=8, min_cycle=1, num_workers=9)
    want = rst.probe_may_succeed(rst.Strategy.GLOBAL, jnp.asarray(nonempty),
                                 to_jax(fails), to_jax(nbr), to_jax(r2),
                                 comp_row=to_jax(comp), **kw)
    assert_same(want, pst.probe_may_succeed(
        pst.Strategy.GLOBAL, torch.as_tensor(nonempty), to_torch(fails),
        to_torch(nbr), to_torch(r2), comp_row=to_torch(comp), **kw))
    want = rst.probe_may_succeed_code(jnp.int32(0), jnp.asarray(nonempty),
                                      to_jax(fails), to_jax(nbr), to_jax(r2),
                                      comp_row=to_jax(comp), **kw)
    assert_same(want, pst.probe_may_succeed_code(
        0, torch.as_tensor(nonempty), to_torch(fails), to_torch(nbr), to_torch(r2),
        comp_row=to_torch(comp), **kw))
    wn, wf = rst.batched_victim_draws(rst.Strategy.ADAPTIVE, jax.random.PRNGKey(0),
                                      0, 4, to_jax(nbr), to_jax(r2), num_workers=9,
                                      link_tau_row=to_jax(tau))
    gn, gf = pst.batched_victim_draws(pst.Strategy.ADAPTIVE, rng.PRNGKey(0), 0, 4,
                                      to_torch(nbr), to_torch(r2), num_workers=9,
                                      link_tau_row=to_torch(tau))
    assert_same(wn, gn, "near")
    assert_same(wf, gf, "far")


def test_defaults_match_reference():
    """Every `SimConfig` default, `famine_batch` 64 included, is the
    reference's."""
    def plain(cfg):
        return {k: getattr(v, "value", v) for k, v in dataclasses.asdict(cfg).items()}
    assert plain(psim.SimConfig()) == plain(rsim.SimConfig())
    assert psim.SimConfig().famine_batch == 64
    assert plain(psim.StaticConfig()) == plain(rsim.StaticConfig())


FIB = ptasks.FibWorkload(n=16, cutoff=12, max_leaf_cost=96)


@pytest.mark.parametrize("strategy", ["neighbor", "adaptive"])
def test_done_flag_interval_changes_nothing(monkeypatch, strategy):
    """The host reads the done flag every DONE_EVERY iterations; iterations
    past the end change nothing, so K in {1, 3, 64} gives one result,
    `events` included, in leap mode (famine on and off) and tick mode."""
    mesh = ptopo.MeshTopology.square(9)
    for extra in ({}, {"famine_batch": 0}, {"step_mode": "tick"}):
        cfg = psim.SimConfig(strategy=pst.Strategy(strategy), hop_ticks=5,
                             capacity=64, **extra)
        runs = []
        for k in (1, 3, 64):
            monkeypatch.setattr(psim, "DONE_EVERY", k)
            runs.append(psim.simulate(FIB, mesh, cfg, device="cpu"))
        for r in runs[1:]:
            assert_results_equal(runs[0], r)
        assert runs[0].result == FIB.expected_result()


def test_negative_famine_batch_rejected():
    with pytest.raises(ValueError, match="famine_batch"):
        psim.simulate(FIB, ptopo.MeshTopology.square(4),
                      psim.SimConfig(famine_batch=-1), device="cpu")


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_captured_loop_matches_cpu_without_host_sync(monkeypatch):
    """On the card each iteration is a replay of a captured CUDA graph: its
    result equals the CPU path's, `events` included, at famine_batch 0 and
    64 on both backends, and the replays run under CUDA's sync debug mode
    set to "error" (a host sync inside them would raise)."""
    modes = []
    replay = torch.cuda.CUDAGraph.replay

    def checked_replay(self):
        modes.append(torch.cuda.get_sync_debug_mode())
        return replay(self)

    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", checked_replay)
    mesh = ptopo.MeshTopology.square(36)
    wl = ptasks.FibWorkload(n=20, cutoff=10, max_leaf_cost=64)
    for fb in (0, 64):
        for backend in ("loop", "staged"):
            cfg = psim.SimConfig(hop_ticks=5, capacity=64, famine_batch=fb,
                                 deque_backend=backend)
            got = psim.simulate(wl, mesh, cfg, device="cuda")
            want = psim.simulate(wl, mesh, cfg, device="cpu")
            assert_results_equal(want, got)
            assert got.result == wl.expected_result()
    assert modes and all(m == 2 for m in modes), modes
