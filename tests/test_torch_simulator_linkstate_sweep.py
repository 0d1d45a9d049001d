"""Port parity of the grid entry points under link state (ROADMAP Queue 1
item 10): `simulate_batch` on tests/test_simulator.py's dynamic schedule
and a mixed-strategy `simulate_sweep` under its periodic eclipse with link
epochs (one schedule shared by every point, each point in the epoch of its
own clock), on the CPU against the reference's batch and sweep point for
point, every `SimResult` field with `events` included."""

import dataclasses

import pytest
import torch
from test_simulator import EQ_FIB, EQ_MESH, _conf_second_cycle_wake, _dynamic_schedule
from torch_parity import assert_results_equal, port_linkstate
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import simulator as rsim
from repro.core import stealing as rst
from repro_torch import convert
from repro_torch.core import simulator as psim


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_simulate_batch_with_link_state():
    """tests/test_simulator.py::test_simulate_batch_matches_serial_with_linkstate:
    the port's batch equals the reference's batch, seed by seed."""
    ls, ft = _dynamic_schedule()
    cfg = rsim.SimConfig(strategy=rst.Strategy.NEIGHBOR, capacity=128, max_ticks=200_000)
    want = rsim.simulate_batch(EQ_FIB, EQ_MESH, cfg, seeds=[0, 3], fail_time=ft,
                               linkstate=ls)
    got = psim.simulate_batch(
        convert.workload("FibWorkload", dataclasses.asdict(EQ_FIB)),
        convert.mesh(9, 3, 3), convert.sim_config(dataclasses.asdict(cfg)),
        seeds=[0, 3], fail_time=ft, linkstate=port_linkstate(ls), device="cpu")
    for w, g in zip(want, got):
        assert_results_equal(w, g)


@pytest.mark.parametrize("backend,fb", [("loop", 64), ("staged", 7)])
def test_simulate_sweep_mixed_grid(backend, fb):
    """One grid of every strategy, several seeds and escalation thresholds
    under the periodic-eclipse schedule (a worker cut off in two epochs):
    each point in the epoch of its own clock; equal to the reference's
    sweep point for point, `events` included."""
    mesh, wl, ls, ft, wt, fp = _conf_second_cycle_wake(5)
    code = rst.strategy_code
    pts = [rsim.SimParams(strategy=code(s), seed=seed, escalate_after=esc)
           for s, seed, esc in ((rst.Strategy.GLOBAL, 0, 4), (rst.Strategy.NEIGHBOR, 1, 4),
                                (rst.Strategy.ADAPTIVE, 2, 2), (rst.Strategy.LIFELINE, 0, 4),
                                (rst.Strategy.GLOBAL, 3, 4))]
    cfg = rsim.SimConfig(capacity=128, max_ticks=200_000, preshed=True, warn_ticks=2,
                         deque_backend=backend, famine_batch=fb)
    sched = dict(fail_time=ft, wake_time=wt, fail_period=fp)
    want = rsim.simulate_sweep(wl, mesh, cfg, pts, linkstate=ls, **sched)
    got = psim.simulate_sweep(
        convert.workload("FibWorkload", dataclasses.asdict(wl)),
        convert.mesh(mesh.num_workers, mesh.rows, mesh.cols, mesh.torus),
        convert.sim_config(dataclasses.asdict(cfg)),
        [psim.SimParams(*p) for p in pts], linkstate=port_linkstate(ls), device="cpu",
        **sched)
    assert len(want) == len(got) == len(pts)
    for w, g in zip(want, got):
        assert_results_equal(w, g)
