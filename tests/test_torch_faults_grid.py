"""Port parity of the fault model across a grid: `repro_torch.simulate_sweep`
and `simulate_batch` with failure, wake-up and straggler schedules (shared
by every point, as in the reference) and per-point `warn_ticks` and
`ckpt_interval`. The reference's conformance points run here as two-point
grids on the port's staged backend and in tick mode against the live
reference (`repro.core.simulator`, JAX on the CPU);
a grid that mixes checkpoint intervals 0 and > 0 against the port's own
per-point runs; and `simulate_batch` against the reference's."""

import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import assert_results_equal
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import simulator as rsim
from repro.core import stealing as rst
from repro.core import tasks as rtasks
from repro.core import topology as rtopo
from repro_torch import convert
from repro_torch.core import simulator as psim
from repro_torch.core import stealing as pst

EQ_FIB = rtasks.FibWorkload(n=20, cutoff=9, max_leaf_cost=8)
EQ_MESH = rtopo.MeshTopology.square(9)
PWL = convert.workload("FibWorkload", dataclasses.asdict(EQ_FIB))
PMESH = convert.mesh(9, 3, 3)
W = 9
STRATEGIES = [rst.Strategy.NEIGHBOR, rst.Strategy.GLOBAL, rst.Strategy.LIFELINE,
              rst.Strategy.ADAPTIVE]
RECOVERIES = [rsim.Recovery.NONE, rsim.Recovery.TC, rsim.Recovery.SUPERVISION]
# (recovery, modifier) -> the two strategies of tests/test_simulator.py's
# EQ_MATRIX at it, and the port's mode for them: the staged backend under
# pre-shed (its transplants go through `stage_place`), tick mode with
# stragglers
COMBOS = [(rec, mod, [s for si, s in enumerate(STRATEGIES)
                      if ("preshed" if (si + ri) % 2 == 0 else "stragglers") == mod])
          for ri, rec in enumerate(RECOVERIES) for mod in ("preshed", "stragglers")]
# a TC pre-shed grid mixing strategy, τ, warning, checkpoint interval (0
# included) and seed
MIXED = [psim.SimParams(strategy=pst.strategy_code(s), hop_ticks=tau,
                        warn_ticks=warn, ckpt_interval=ck, seed=seed)
         for s, tau, warn, ck, seed in (("neighbor", 3, 8, 30, 0),
                                        ("global", 2, 4, 0, 1),
                                        ("adaptive", 3, 0, 40, 2),
                                        ("lifeline", 1, 12, 30, 3))]
MODES = {"preshed": ("leap", "staged", 64), "stragglers": ("tick", "loop", 64)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's CPU path runs many small operations: one intra-op thread
    a test process keeps parallel workers from oversubscribing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _schedule(modifier):
    """Failures at 70 and 150; worker 5 wakes at 190 under pre-shed;
    workers 1 and 4 at speed 3 otherwise."""
    ft = -np.ones(W, np.int32)
    ft[2], ft[5] = 70, 150
    if modifier == "stragglers":
        speed = np.ones(W, np.int32)
        speed[[1, 4]] = 3
        return {"fail_time": ft, "speed": speed}
    wt = -np.ones(W, np.int32)
    wt[5] = 190
    return {"fail_time": ft, "wake_time": wt}


def _cfg(recovery, modifier, **kw):
    preshed = modifier == "preshed"
    return rsim.SimConfig(
        hop_ticks=3, capacity=128, max_ticks=200_000, recovery=recovery,
        ckpt_interval=30 if recovery is rsim.Recovery.TC else 0,
        preshed=preshed, warn_ticks=8 if preshed else 0, **kw)


@pytest.mark.parametrize("recovery,modifier,strategies", COMBOS,
                         ids=[f"{r.value}-{m}" for r, m, _ in COMBOS])
def test_conformance_pairs_as_grids(recovery, modifier, strategies):
    """Each (recovery, modifier) pair's two strategies as one two-point
    sweep of the port in its other mode: each point equals the reference's
    leap run of it in every field, `events` aside (tick mode counts one a
    tick)."""
    sched = _schedule(modifier)
    mode, backend, fb = MODES[modifier]
    pcfg = convert.sim_config({**dataclasses.asdict(_cfg(recovery, modifier)),
                               "step_mode": mode, "deque_backend": backend,
                               "famine_batch": fb})
    pts = [dataclasses.replace(pcfg, strategy=pst.Strategy(s.value)) for s in strategies]
    grid = psim.simulate_sweep(PWL, PMESH, pcfg, pts, device="cpu", **sched)
    for s, got in zip(strategies, grid):
        want = rsim.simulate(EQ_FIB, EQ_MESH, _cfg(recovery, modifier, strategy=s),
                             **sched)
        assert_results_equal(want, got, skip=("events",))
        if mode == "tick":
            assert got.events == got.ticks


def test_mixed_grid_equals_its_points():
    """A TC pre-shed grid whose points differ in strategy, τ, warning,
    checkpoint interval (0 included: that point never rolls back) and
    seed: every point equals the port's own `simulate` of it, `events`
    included."""
    sched = _schedule("preshed")
    cfg = psim.SimConfig(capacity=128, max_ticks=600, recovery=psim.Recovery.TC,
                         preshed=True, deque_backend="loop")
    pts = MIXED
    grid = psim.simulate_sweep(PWL, PMESH, cfg, pts, device="cpu", **sched)
    for p, got in zip(pts, grid):
        one = dataclasses.replace(
            cfg, strategy=pst.CODE_STRATEGIES[p.strategy], hop_ticks=p.hop_ticks,
            warn_ticks=p.warn_ticks, ckpt_interval=p.ckpt_interval, seed=p.seed)
        assert_results_equal(psim.simulate(PWL, PMESH, one, device="cpu", **sched), got)
    assert [r.ckpt_bytes > 0 for r in grid] == [p.ckpt_interval > 0 for p in pts]
    assert grid[0].result == EQ_FIB.expected_result()


def test_simulate_batch_matches_reference():
    """`simulate_batch` over seeds under supervision with a periodic
    eclipse, pre-shed and stragglers: each seed equals the reference's
    `simulate_batch`, `events` included."""
    ft, wt, fp = (-np.ones(W, np.int32) for _ in range(3))
    ft[[3, 6]], wt[[3, 6]], fp[[3, 6]] = [40, 90], [80, 120], [150, 150]
    speed = np.ones(W, np.int32)
    speed[0] = 2
    sched = {"fail_time": ft, "wake_time": wt, "fail_period": fp, "speed": speed}
    cfg = rsim.SimConfig(strategy=rst.Strategy.ADAPTIVE, hop_ticks=2,
                         capacity=128, max_ticks=200_000,
                         recovery=rsim.Recovery.SUPERVISION, preshed=True,
                         warn_ticks=6)
    want = rsim.simulate_batch(EQ_FIB, EQ_MESH, cfg, seeds=(0, 5), **sched)
    got = psim.simulate_batch(PWL, PMESH, convert.sim_config(dataclasses.asdict(cfg)),
                              seeds=(0, 5), device="cpu", **sched)
    for w, g in zip(want, got):
        assert_results_equal(w, g)


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
@pytest.mark.parametrize("backend", ["loop", "staged"])
def test_card_mixed_fault_grid_matches_cpu(backend):
    """The mixed TC pre-shed grid on the card, one captured loop: every
    point equals the CPU sweep's, `events` included."""
    sched = _schedule("preshed")
    cfg = psim.SimConfig(capacity=128, max_ticks=600, recovery=psim.Recovery.TC,
                         preshed=True, deque_backend=backend)
    want = psim.simulate_sweep(PWL, PMESH, cfg, MIXED, device="cpu", **sched)
    got = psim.simulate_sweep(PWL, PMESH, cfg, MIXED, device="cuda", **sched)
    for w, g in zip(want, got):
        assert_results_equal(w, g)
