"""Port parity of the grid axis: `repro_torch`'s `simulate_sweep`,
`simulate_batch` and `stack_params` on the CPU against the reference's
(`repro.core.simulator`, vmapped JAX), every `SimResult` field with
`events` included, in tick and leap mode on both deque backends; a sweep
against the port's own per-point `simulate` on a grid that mixes every
per-point parameter; the grid's `resolve_grants`, victim draws and probe
predicate against per-point calls; one `_sim_core` call per sweep; and what
the sweep refuses."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st
from torch_parity import assert_results_equal, assert_same, np_rng, to_jax, to_torch
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import simulator as rsim
from repro.core import stealing as rst
from repro.core import tasks as rtasks
from repro.core import topology as rtopo
from repro_torch import convert
from repro_torch.core import rng
from repro_torch.core import simulator as psim
from repro_torch.core import stealing as pst
from repro_torch.core import tasks as ptasks
from repro_torch.core import topology as ptopo
from repro_torch.core import tracing as ptracing

# the reference's own sweep grid (tests/test_sweep.py): G = 16 points on W = 9
WL = rtasks.FibWorkload(n=20, cutoff=12, max_leaf_cost=8)
MESH = rtopo.MeshTopology.grid(3, 3)
PWL = convert.workload("FibWorkload", dataclasses.asdict(WL))
PMESH = convert.mesh(9, 3, 3)
CODES = [rst.strategy_code(s) for s in rst.Strategy]
STATIC = dict(capacity=128, max_ticks=200_000)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's CPU path runs many small operations: one intra-op thread
    a test process keeps parallel workers from oversubscribing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _grid(params_cls):
    return [params_cls(strategy=c, hop_ticks=t, seed=s)
            for c in CODES for t in (1, 4) for s in (0, 7)]


@pytest.fixture(scope="module")
def reference_sweeps():
    """The reference's vmapped sweep of the grid, one compile per step mode
    (its `simulate_batch` shares the leap mode's compile)."""
    cache = {}

    def get(step_mode):
        if step_mode not in cache:
            cfg = rsim.SimConfig(step_mode=step_mode, **STATIC)
            cache[step_mode] = rsim.simulate_sweep(WL, MESH, cfg, _grid(rsim.SimParams))
        return cache[step_mode]
    return get


@pytest.mark.parametrize("backend", ["loop", "staged"])
@pytest.mark.parametrize("step_mode", ["tick", "leap"])
def test_sweep_matches_reference_sweep(reference_sweeps, step_mode, backend):
    """Every point of the port's sweep equals the reference's sweep point in
    every field, `events` included (leap mode at the default famine batch
    64), and the whole grid is one `_sim_core` call."""
    cfg = psim.SimConfig(step_mode=step_mode, deque_backend=backend, **STATIC)
    before = psim.core_count()
    got = psim.simulate_sweep(PWL, PMESH, cfg, _grid(psim.SimParams), device="cpu")
    assert psim.core_count() - before == 1
    want = reference_sweeps(step_mode)
    assert len(got) == len(want) == 16
    for p, r, w in zip(_grid(psim.SimParams), got, want):
        assert_results_equal(w, r)
        assert r.result == WL.expected_result(), p


def test_simulate_batch_matches_reference(reference_sweeps):
    """`simulate_batch` over seeds equals the reference's `simulate_batch`,
    `events` included; the config's own seed is ignored."""
    # 16 seeds: the reference reuses its leap sweep's compile (same shapes)
    seeds = tuple(range(16))
    kw = dict(strategy=rst.Strategy.ADAPTIVE, hop_ticks=2, escalate_after=2,
              seed=99, **STATIC)
    want = rsim.simulate_batch(WL, MESH, rsim.SimConfig(**kw), seeds=seeds)
    cfg = convert.sim_config({**kw, "strategy": "adaptive"})
    before = psim.core_count()
    got = psim.simulate_batch(PWL, PMESH, cfg, seeds=seeds, device="cpu")
    assert psim.core_count() - before == 1
    for w, r in zip(want, got):
        assert_results_equal(w, r)


# a grid that mixes every per-point parameter the core once took as a Python
# int: strategy (LIFELINE in a leap grid at famine batch 64), τ 1 against 10
# (points that end far apart), escalate_after, the grant budget and the
# checkpoint interval; G = 7 points on W = 16 workers
FIB_MIX = ptasks.FibWorkload(n=18, cutoff=10, max_leaf_cost=16)
MIX = [psim.SimParams(strategy=pst.NEIGHBOR_CODE, hop_ticks=1, seed=1),
       psim.SimParams(strategy=pst.LIFELINE_CODE, hop_ticks=3, seed=2,
                      ckpt_interval=17),
       psim.SimParams(strategy=pst.ADAPTIVE_CODE, hop_ticks=2,
                      escalate_after=1, max_grants_per_victim=1, seed=3),
       psim.SimParams(strategy=pst.GLOBAL_CODE, hop_ticks=10, seed=4,
                      max_grants_per_victim=8),
       psim.SimParams(strategy=pst.ADAPTIVE_CODE, hop_ticks=10,
                      escalate_after=6, ckpt_interval=50, seed=5),
       psim.SimParams(strategy=pst.NEIGHBOR_CODE, hop_ticks=0, seed=6),
       psim.SimParams(strategy=pst.GLOBAL_CODE, hop_ticks=1, seed=7,
                      max_grants_per_victim=2)]


def _per_point(cfg, p, W=16, wl=FIB_MIX):
    return psim.simulate(wl, ptopo.MeshTopology.square(W), dataclasses.replace(
        cfg, strategy=pst.CODE_STRATEGIES[p.strategy], hop_ticks=p.hop_ticks,
        escalate_after=p.escalate_after, ckpt_interval=p.ckpt_interval,
        max_grants_per_victim=p.max_grants_per_victim, seed=p.seed), device="cpu")


@pytest.mark.parametrize("max_ticks", [200_000, 150], ids=["drained", "cut"])
def test_mixed_grid_equals_per_point_runs(max_ticks):
    """Each point of a mixed grid equals the port's own run of that point,
    `events` included: points that end early stay as they were while the
    others run on, and with `max_ticks` 150 some points drain before the cut
    and the rest stop at it, each at its own run's tick."""
    cfg = psim.SimConfig(capacity=64, max_ticks=max_ticks)
    got = psim.simulate_sweep(FIB_MIX, ptopo.MeshTopology.square(16), cfg, MIX,
                              device="cpu")
    ticks = []
    for p, r in zip(MIX, got):
        assert_results_equal(_per_point(cfg, p), r)
        ticks.append(r.ticks)
    assert len(set(ticks)) > 3  # the points end far apart
    if max_ticks == 150:
        assert 150 in ticks and min(ticks) < 150
    else:
        assert all(r.result == FIB_MIX.expected_result() for r in got)
    assert any(r.ckpt_bytes > 0 for r in got) and any(r.ckpt_bytes == 0 for r in got)


def test_lifeline_points_beside_one_drawn_strategy():
    """LIFELINE points ahead of the grid's one drawing strategy (whose
    draws then cover every point) keep each point's own result: a grid
    hypothesis found, in both step modes."""
    pts = [psim.SimParams(strategy=pst.LIFELINE_CODE, hop_ticks=0, escalate_after=1,
                          max_grants_per_victim=1, seed=0),
           psim.SimParams(strategy=pst.GLOBAL_CODE, hop_ticks=0, escalate_after=1,
                          max_grants_per_victim=1, seed=1)]
    for step_mode in ("tick", "leap"):
        cfg = psim.SimConfig(capacity=64, max_ticks=100_000, step_mode=step_mode)
        got = psim.simulate_sweep(FIB_MIX, ptopo.MeshTopology.square(9), cfg, pts,
                                  device="cpu")
        for p, r in zip(pts, got):
            assert_results_equal(_per_point(cfg, p, W=9), r)


def test_sweep_of_configs_and_stack_params():
    """`params_list` may hold `SimConfig`s (their per-point fields are
    taken), `cfg` a `StaticConfig`; `stack_params` gives (G,) int32 host
    tensors in the reference's field order and refuses an empty grid."""
    cfgs = [psim.SimConfig(strategy=s, hop_ticks=3, seed=i, capacity=64)
            for i, s in enumerate(pst.Strategy)]
    stacked = psim.stack_params(cfgs)
    assert stacked._fields == rsim.SimParams._fields
    for leaf in stacked:
        assert leaf.dtype == torch.int32 and tuple(leaf.shape) == (4,)
    assert stacked.strategy.tolist() == [0, 1, 2, 3]
    want = rsim.stack_params([rsim.SimConfig(strategy=rst.Strategy(s.value), hop_ticks=3,
                                             seed=i).params
                              for i, s in enumerate(pst.Strategy)])
    for a, b in zip(want, stacked):
        assert_same(a, b)
    with pytest.raises(ValueError, match="at least one"):
        psim.stack_params([])
    mesh, wl = ptopo.MeshTopology.square(9), ptasks.FibWorkload(n=14, cutoff=8)
    got = psim.simulate_sweep(wl, mesh, cfgs[0].static, cfgs, device="cpu")
    for c, r in zip(cfgs, got):
        assert_results_equal(psim.simulate(wl, mesh, c, device="cpu"), r)
    assert psim.simulate_sweep(wl, mesh, cfgs[0], [], device="cpu") == []


@settings(max_examples=4, deadline=None)
@given(st.data())
def test_property_random_grids_equal_per_point_runs(data):
    """Any small random grid of points equals the port's per-point runs,
    in either step mode. Skips when hypothesis is absent."""
    step_mode = data.draw(st.sampled_from(["tick", "leap"]), label="mode")
    npts = data.draw(st.integers(min_value=1, max_value=4), label="npts")
    wl = ptasks.FibWorkload(n=14, cutoff=8, max_leaf_cost=16)
    cfg = psim.SimConfig(capacity=64, max_ticks=100_000, step_mode=step_mode)
    pts = [psim.SimParams(
        strategy=data.draw(st.sampled_from(CODES), label=f"strat{i}"),
        hop_ticks=data.draw(st.integers(0, 6), label=f"tau{i}"),
        escalate_after=data.draw(st.integers(1, 6), label=f"esc{i}"),
        max_grants_per_victim=data.draw(st.integers(1, 4), label=f"grants{i}"),
        ckpt_interval=data.draw(st.sampled_from([0, 0, 37]), label=f"ckpt{i}"),
        seed=data.draw(st.integers(0, 2**20), label=f"seed{i}"))
        for i in range(npts)]
    got = psim.simulate_sweep(wl, ptopo.MeshTopology.square(9), cfg, pts,
                              device="cpu")
    for p, r in zip(pts, got):
        assert_results_equal(_per_point(cfg, p, W=9, wl=wl), r)


@pytest.mark.parametrize("seed", range(3))
def test_grid_resolve_grants_equals_per_point(seed):
    """G points' requests ranked and served in one call (leading axis, a
    per-point budget) equal each point's own `resolve_grants` and the
    pairwise oracle."""
    rs = np_rng(seed)
    G, W = 5, 13
    victim = np.where(rs.random((G, W)) < 0.6, rs.integers(0, W, (G, W)), -1)
    sizes = rs.integers(0, 6, (G, W))
    budget = rs.integers(1, 9, (G, 1))
    plan = pst.resolve_grants(to_torch(victim), to_torch(sizes), to_torch(budget))
    for g in range(G):
        for fn in (pst.resolve_grants, pst.resolve_grants_pairwise):
            one = fn(to_torch(victim[g]), to_torch(sizes[g]), int(budget[g, 0]))
            for f in pst.StealPlan._fields:
                assert_same(getattr(one, f), getattr(plan, f)[g], f"{fn.__name__} {f}")
        ref = rst.resolve_grants(to_jax(victim[g]), to_jax(sizes[g]), int(budget[g, 0]))
        for f in ("victim", "rank", "got", "taken"):
            assert_same(getattr(ref, f), getattr(plan, f)[g], f"reference {f}")


def test_per_point_draws_and_probe_equal_reference():
    """Per-point keys, ticks and codes ((G, 1) columns) give (G, count, W)
    draws whose block g equals the reference's draws of point g; the probe
    predicate on (G, W) deques equals each point's."""
    mesh = ptopo.MeshTopology.square(23, torus=True)
    nbr, r2 = pst.neighbor_list(mesh), pst.radius2_list(mesh)
    W, count = 23, 9
    seeds, t0s = [5, 17, 2**30 + 3, 0], [977, 0, 41, 2**31 - 20]
    codes = [pst.ADAPTIVE_CODE, pst.GLOBAL_CODE, pst.NEIGHBOR_CODE, pst.LIFELINE_CODE]
    key = rng.PRNGKey(torch.tensor(seeds)[:, None])
    t0 = torch.tensor(t0s, dtype=torch.int32)[:, None]
    code = torch.tensor(codes, dtype=torch.int32)[:, None]
    near, far = pst.batched_victim_draws_code(code, key, t0, count, to_torch(nbr),
                                              to_torch(r2), num_workers=W)
    assert tuple(near.shape) == tuple(far.shape) == (4, count, W)
    for g in range(4):
        wn, wf = rst.batched_victim_draws_code(
            jax.numpy.int32(codes[g]), jax.random.PRNGKey(seeds[g]), t0s[g], count,
            to_jax(nbr), to_jax(r2), num_workers=W)
        assert_same(wn, near[g], f"near {g}")
        assert_same(wf, far[g], f"far {g}")
    rs = np_rng(4)
    nonempty = rs.random((4, W)) < 0.1
    fails = rs.integers(0, 9, (4, W))
    esc, cyc = rs.integers(1, 7, (4, 1)), rs.integers(1, 10, (4, 1))
    got = pst.probe_may_succeed_code(code, torch.as_tensor(nonempty), to_torch(fails),
                                     to_torch(nbr), to_torch(r2),
                                     escalate_after=to_torch(esc), window=30,
                                     min_cycle=to_torch(cyc), num_workers=W)
    for g in range(4):
        want = rst.probe_may_succeed_code(
            jax.numpy.int32(codes[g]), jax.numpy.asarray(nonempty[g]), to_jax(fails[g]),
            to_jax(nbr), to_jax(r2), escalate_after=int(esc[g, 0]), window=30,
            min_cycle=int(cyc[g, 0]), num_workers=W)
        assert_same(want, got[g], f"probe {g}")


def test_sweep_refuses_what_is_not_ported(monkeypatch):
    """With no CUDA device the entry points raise; on a card the plain
    kernels are refused; two devices give each point's own result; the
    arrival stream on without its shape gets the
    reference's refusal; a schedule with no death (item 9, ported) changes
    nothing."""
    mesh, cfg = ptopo.MeshTopology.square(4), psim.SimConfig(capacity=16)
    wl = ptasks.FibWorkload(n=10, cutoff=5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        psim.simulate_sweep(wl, mesh, cfg, [cfg.params])
    with pytest.raises(RuntimeError, match="CUDA"):
        psim.simulate_batch(wl, mesh, cfg, seeds=(0, 1))
    one = psim.simulate_sweep(wl, mesh, cfg, [cfg.params], device="cpu")[0]
    (two,) = psim.simulate_sweep(wl, mesh, cfg, [cfg.params], devices=["cpu", "cpu"])
    assert_results_equal(one, two)
    assert_results_equal(
        one, psim.simulate_sweep(wl, mesh, cfg, [cfg.params], device="cpu",
                                 fail_time=np.full(4, -1))[0])
    # open-loop arrivals (item 12) are ported: the stream on without its
    # shape gets the reference's refusal
    with pytest.raises(ValueError, match=r"arrival_gap_q8 > 0 turns the open-loop"):
        psim.simulate_sweep(wl, mesh, cfg, [cfg.params._replace(arrival_gap_q8=256)],
                            device="cpu")
    # the flight recorder (item 11) is ported: the same call runs traced and
    # equals `simulate`, its ring and time series included
    traced = dataclasses.replace(cfg, trace=ptracing.TraceConfig(
        ring_capacity=512, bins=16, bin_ticks=32))
    (rb,) = psim.simulate_batch(wl, mesh, traced, device="cpu")
    assert_results_equal(psim.simulate(wl, mesh, traced, device="cpu"), rb)
    assert rb.trace.emitted > 0 and rb.trace.dropped == 0
    r = psim.simulate_sweep(wl, mesh, cfg, [cfg.params], devices=["cpu"])[0]
    assert r.result == wl.expected_result()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="plain versions"):
        psim.simulate_sweep(wl, mesh, dataclasses.replace(cfg, use_steal_kernel=False),
                            [cfg.params])


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_card_sweep_matches_cpu_sweep(monkeypatch):
    """On the card a mixed grid is one captured loop whose every point
    equals the CPU sweep's, on both backends, with one graph capture."""
    mesh = ptopo.MeshTopology.square(16)
    captures = []
    graph = torch.cuda.graph

    def counted(*a, **kw):
        captures.append(1)
        return graph(*a, **kw)

    monkeypatch.setattr(torch.cuda, "graph", counted)
    for backend in ("loop", "staged"):
        cfg = psim.SimConfig(capacity=64, deque_backend=backend)
        captures.clear()
        got = psim.simulate_sweep(FIB_MIX, mesh, cfg, MIX, device="cuda")
        assert len(captures) == 1
        for w, r in zip(psim.simulate_sweep(FIB_MIX, mesh, cfg, MIX, device="cpu"), got):
            assert_results_equal(w, r)
