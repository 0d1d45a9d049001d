"""Port parity of the round executor's grids and options:
`repro_torch.core.scheduler` on the CPU against the reference's
(`repro.core.scheduler`, JAX), exact equality of every `RunResult` field.

  * a mixed (strategy × seed) `run_sweep` on tests/test_sweep.py's 3×3
    fixture: one core call, each point equal to its own `run_vectorized`
    and to the reference's sweep;
  * a `link_up` snapshot: all up ≡ unmasked, all down (neighbor-only never
    succeeds, the result still exact; ADAPTIVE's radius-2 table unmasked);
  * a run cut by `max_rounds`.
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_scheduler import FIB, MESH, PFIB, PMESH, _cfgs
from torch_parity import assert_results_equal
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import scheduler as rsch
from repro.core import stealing as rst
from repro.core import tasks as rtasks
from repro.core import topology as rtopo
from repro_torch import convert
from repro_torch.core import scheduler as psch
from repro_torch.core import stealing as pst


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_mixed_sweep_one_core_call_equals_points():
    """tests/test_sweep.py's scheduler grid: every strategy × seeds (0, 2)
    on a 3×3 mesh in one core call; each point equals its own
    `run_vectorized` and the reference's sweep point."""
    wl = rtasks.FibWorkload(n=24, cutoff=18, max_leaf_cost=8)
    mesh = rtopo.MeshTopology.grid(3, 3)
    pwl = convert.workload("FibWorkload", dataclasses.asdict(wl))
    pmesh = convert.mesh(9, 3, 3)
    rcfg = rsch.SchedulerConfig(capacity=160, max_rounds=500_000)
    pcfg = psch.SchedulerConfig(capacity=160, max_rounds=500_000)
    codes = [rst.strategy_code(s) for s in rst.Strategy]
    ref = rsch.run_sweep(wl, mesh, rcfg, [rcfg.params._replace(strategy=c, seed=s)
                                          for c in codes for s in (0, 2)])
    pts = [pcfg.params._replace(strategy=c, seed=s) for c in codes for s in (0, 2)]
    before = psch.run_trace_count()
    port = psch.run_sweep(pwl, pmesh, pcfg, pts, device="cpu")
    assert psch.run_trace_count() - before == 1
    for p, a, b in zip(pts, ref, port):
        assert_results_equal(a, b)
        own = psch.run_vectorized(pwl, pmesh, dataclasses.replace(
            pcfg, strategy=pst.CODE_STRATEGIES[p.strategy], seed=p.seed),
            device="cpu")
        assert_results_equal(own, b)
    # a static half alone, and an empty grid
    assert_results_equal(port[0], psch.run_sweep(pwl, pmesh, pcfg.static, pts[:1],
                                                 device="cpu")[0])
    assert psch.run_sweep(pwl, pmesh, pcfg, [], device="cpu") == []


# the link-state snapshot's runs: FIB n = 18 (377 rounds with every link
# down; the fixture's n = 24 runs 6,765), one reference compile for all
LINK_WL = rtasks.FibWorkload(n=18, cutoff=10, max_leaf_cost=8)
PLINK_WL = convert.workload("FibWorkload", dataclasses.asdict(LINK_WL))
LINK_STATIC = dict(capacity=1024, max_rounds=200_000)


def test_link_up_all_up_equals_unmasked():
    rc, pc = _cfgs("neighbor", **LINK_STATIC)
    up = np.ones((MESH.num_workers, 4), bool)
    ref = rsch.run_vectorized(LINK_WL, MESH, rc, link_up=up)
    port = psch.run_vectorized(PLINK_WL, PMESH, pc, link_up=up, device="cpu")
    assert_results_equal(ref, port)
    assert_results_equal(psch.run_vectorized(PLINK_WL, PMESH, pc, device="cpu"), port)
    assert port.successes > 0


@pytest.mark.parametrize("strategy", ["neighbor", "adaptive"])
def test_link_up_all_down(strategy):
    """Every link down: neighbor-only stealing never succeeds and worker 0
    works alone, exactly; ADAPTIVE's radius-2 table stays unmasked, so it
    still steals once it escalates."""
    rc, pc = _cfgs(strategy, **LINK_STATIC)
    dark = np.zeros((MESH.num_workers, 4), bool)
    ref = rsch.run_vectorized(LINK_WL, MESH, rc, link_up=dark)
    port = psch.run_vectorized(PLINK_WL, PMESH, pc, link_up=torch.as_tensor(dark),
                               device="cpu")
    assert_results_equal(ref, port)
    assert port.result == LINK_WL.expected_result()
    if strategy == "neighbor":
        assert port.successes == 0 and (port.per_worker_busy[1:] == 0).all()
    else:
        assert port.successes > 0


def test_max_rounds_cut():
    rc, pc = _cfgs("global", max_rounds=57)
    ref = rsch.run_vectorized(FIB, MESH, rc)
    port = psch.run_vectorized(PFIB, PMESH, pc, device="cpu")
    assert_results_equal(ref, port)
    assert port.rounds == 57 and port.result != FIB.expected_result()
