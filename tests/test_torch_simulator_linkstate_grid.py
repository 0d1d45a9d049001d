"""Port parity of the simulator under link state (ROADMAP Queue 1 item 10),
continued: the sparse routing backend on tests/test_simulator.py's seam and
multi-cycle eclipse scenarios, prebuilt sparse tables with small patches,
and a partition that GLOBAL's famine replay must skip draws across (with
stragglers) — all on the CPU against the live reference, every `SimResult`
field with `events` included. The grid entry points are in
tests/test_torch_simulator_linkstate_sweep.py, the card against the CPU in
tests/test_torch_linkstate_gpu.py."""

import dataclasses

import numpy as np
import pytest
import torch
from test_simulator import CONF_SCENARIOS, FAMINE_WL, _conf_second_cycle_wake
from torch_parity import assert_results_equal, port_linkstate, port_simulate
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import linkstate as rls
from repro.core import simulator as rsim
from repro.core import stealing as rst
from repro.core import topology as rtopo
from repro_torch import convert
from repro_torch.core import linkstate as pls
from repro_torch.core import simulator as psim
from repro_torch.core import topology as ptopo

STRATEGIES = [rst.Strategy.NEIGHBOR, rst.Strategy.GLOBAL, rst.Strategy.ADAPTIVE]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _sparse_scenario(name, tau):
    if name == "seam_detour":
        mesh, wl, ls, ft, wt = CONF_SCENARIOS[name](tau)
        return mesh, wl, ls, ft, wt, None
    return _conf_second_cycle_wake(tau)


MODES = [("leap", "loop", 64), ("leap", "staged", 64), ("tick", "staged", 64),
         ("leap", "loop", 1)]
SPARSE_CASES = [(n, s, tau) for n in ("seam_detour", "multi_cycle_eclipse")
                for s in STRATEGIES for tau in (1, 5)]


@pytest.mark.parametrize("name,strategy,tau", SPARSE_CASES,
                         ids=[f"{n}-{s.value}-tau{t}" for n, s, t in SPARSE_CASES])
def test_sparse_backend(name, strategy, tau):
    """tests/test_simulator.py::test_leap_equals_tick_under_sparse_backend:
    outage pricing through the sparse landmark tables; the port (its mode
    turned over the cases) equals the reference's leap run."""
    mesh, wl, ls, ft, wt, fp = _sparse_scenario(name, tau)
    preshed = ft is not None
    cfg = rsim.SimConfig(strategy=strategy, capacity=128, max_ticks=200_000,
                         preshed=preshed, warn_ticks=2 if preshed else 0)
    sched = {"fail_time": ft, "wake_time": wt, "fail_period": fp, "linkstate": ls,
             "routing_backend": "sparse"}
    ref = rsim.simulate(wl, mesh, cfg, **sched)
    mode, backend, fb = MODES[SPARSE_CASES.index((name, strategy, tau)) % len(MODES)]
    got = port_simulate(wl, mesh, cfg, sched, step_mode=mode, deque_backend=backend,
                        famine_batch=fb)
    assert_results_equal(ref, got, skip=() if (mode, fb) == ("leap", 64) else ("events",))


def _partition(tau):
    """A 4x4 mesh whose 2x2 corner is cut off for ticks [30, 90), with slower
    inter-row links there and stragglers in two epochs, under the famine
    workload: GLOBAL thieves draw across the cut in famine windows."""
    mesh = rtopo.MeshTopology.square(16)
    W = 16
    starts = np.asarray([0, 30, 90], np.int32)
    tau_tab = np.full((3, W, 4), tau, np.int32)
    tau_tab[1, :, rls.NORTH] = tau_tab[1, :, rls.SOUTH] = tau + 2
    up = np.ones((3, W, 4), bool)
    nbr = mesh.neighbor_table
    corner = (mesh.coords[:, 0] < 2) & (mesh.coords[:, 1] < 2)
    for w in range(W):
        for d in range(4):
            if nbr[w, d] >= 0 and corner[w] != corner[nbr[w, d]]:
                up[1, w, d] = False
    speed = np.ones((3, W), np.int32)
    speed[1, [3, 9]] = 2
    speed[2, 5] = 3
    return mesh, rls.LinkStateSchedule(starts, tau_tab, up, speed).validate(mesh)


@pytest.mark.parametrize("strategy,tau,routing", [
    (rst.Strategy.GLOBAL, 1, "dense"), (rst.Strategy.GLOBAL, 5, "sparse"),
    (rst.Strategy.ADAPTIVE, 5, "dense")], ids=["global-1-dense", "global-5-sparse",
                                               "adaptive-5-dense"])
def test_partition_famine_replay_skips_unreachable_draws(strategy, tau, routing):
    """A GLOBAL draw into the other component launches nothing: the famine
    replay takes each thief's next reachable draw (at an active tick of a
    straggler); equal to the reference at famine batch 64, `events`
    included, and with the fast path firing."""
    mesh, ls = _partition(tau)
    cfg = rsim.SimConfig(strategy=strategy, capacity=64, max_ticks=100_000)
    sched = {"linkstate": ls, "routing_backend": routing}
    ref = rsim.simulate(FAMINE_WL, mesh, cfg, **sched)
    got = port_simulate(FAMINE_WL, mesh, cfg, sched)
    assert_results_equal(ref, got)
    assert got.events < got.ticks


def test_prebuilt_sparse_tables_with_small_patches():
    """Prebuilt tables pass through: the reference's and the port's
    `build_tables` of one schedule under sparse routing with (2, 2) patches
    (landmark prices across patches), run by both simulators."""
    mesh, wl, ls, ft, wt, fp = _conf_second_cycle_wake(5)
    ra, rs = rls.build_tables(ls, mesh, routing="sparse", patch=(2, 2))
    pmesh = ptopo.MeshTopology.grid(mesh.rows, mesh.cols, mesh.torus)
    pa, ps = pls.build_tables(port_linkstate(ls), pmesh, routing="sparse", patch=(2, 2),
                              device="cpu")
    assert ps.num_landmarks == rs.num_landmarks > 1
    for strategy in (rst.Strategy.GLOBAL, rst.Strategy.NEIGHBOR):
        cfg = rsim.SimConfig(strategy=strategy, capacity=128, max_ticks=200_000,
                             preshed=True, warn_ticks=2)
        sched = {"fail_time": ft, "wake_time": wt, "fail_period": fp}
        ref = rsim.simulate(wl, mesh, cfg, linkstate=ra, **sched)
        got = psim.simulate(convert.workload("FibWorkload", dataclasses.asdict(wl)),
                            pmesh, convert.sim_config(dataclasses.asdict(cfg)),
                            linkstate=pa, device="cpu", **sched)
        assert_results_equal(ref, got)
