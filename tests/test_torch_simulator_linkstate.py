"""Port parity of the simulator under time-varying link state (ROADMAP
Queue 1 item 10): `repro_torch.simulate(linkstate=...)` on the CPU against
the live reference (`repro.core.simulator.simulate`, JAX on the CPU), every
`SimResult` field with `events` included, on tests/test_simulator.py's
link-state fixtures: the dynamic schedule (oscillating τ, a link-down
epoch, an eclipse death with pre-shed, speed epochs), a static schedule
against the scalar `hop_ticks` path, speed epochs, a constellation's own
schedule, partitioned workers and LIFELINE. The famine regime with epoch
flips at every `famine_batch` is in tests/test_torch_simulator_linkstate_famine.py,
the route-around conformance scenarios in `..._conf.py`, the sparse
backend and partitions in `..._grid.py`, the grid entry points in
`..._sweep.py`."""

import dataclasses

import numpy as np
import pytest
import torch
from test_simulator import EQ_FIB, EQ_MESH, _dynamic_schedule
from torch_parity import assert_results_equal, port_linkstate, port_simulate
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import constellation as rcon
from repro.core import linkstate as rls
from repro.core import simulator as rsim
from repro.core import stealing as rst
from repro.core import topology as rtopo
from repro_torch import convert
from repro_torch.core import constellation as pcon
from repro_torch.core import linkstate as pls
from repro_torch.core import simulator as psim
from repro_torch.core import tasks as ptasks
from repro_torch.core import topology as ptopo

STRATEGIES = [rst.Strategy.NEIGHBOR, rst.Strategy.GLOBAL, rst.Strategy.ADAPTIVE]
_REF = {}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def reference(key, wl, mesh, cfg, **kw):
    """The reference's run, once a module, by a key naming its inputs."""
    if key not in _REF:
        _REF[key] = rsim.simulate(wl, mesh, cfg, **kw)
    return _REF[key]


def _check(ref, got, mode):
    """`got` equals `ref` (a leap-mode reference run) in every field; in tick
    mode `events` is the tick count instead."""
    if mode == "tick":
        assert_results_equal(ref, got, skip=("events",))
        assert got.events == got.ticks
    else:
        assert_results_equal(ref, got)


@pytest.mark.parametrize("strategy", STRATEGIES, ids=lambda s: s.value)
def test_dynamic_schedule(strategy):
    """tests/test_simulator.py::test_leap_equals_tick_dynamic_linkstate's
    schedule: leap/loop at the default famine batch equals the reference,
    `events` included; NEIGHBOR also in tick mode on the staged backend."""
    ls, ft = _dynamic_schedule()
    cfg = rsim.SimConfig(strategy=strategy, capacity=128, max_ticks=200_000,
                         preshed=True, warn_ticks=8)
    ref = reference(("dynamic", strategy), EQ_FIB, EQ_MESH, cfg, fail_time=ft,
                    linkstate=ls)
    assert ref.result == EQ_FIB.expected_result()
    modes = [("leap", "loop")]
    if strategy == rst.Strategy.NEIGHBOR:
        modes.append(("tick", "staged"))
    for mode, backend in modes:
        got = port_simulate(EQ_FIB, EQ_MESH, cfg, {"fail_time": ft, "linkstate": ls},
                            step_mode=mode, deque_backend=backend)
        _check(ref, got, mode)


@pytest.mark.parametrize("strategy", STRATEGIES, ids=lambda s: s.value)
def test_static_schedule_equals_scalar_hop_ticks(strategy):
    """One uniform epoch (τ 3, every link up) gives the scalar `hop_ticks`
    run of the reference, `events` included (ADAPTIVE too: under uniform τ
    the cheapest live neighbor is any neighbor)."""
    cfg = rsim.SimConfig(strategy=strategy, hop_ticks=3, capacity=128,
                         max_ticks=200_000)
    ref = reference(("scalar", strategy), EQ_FIB, EQ_MESH, cfg)
    ls = rls.LinkStateSchedule.static(EQ_MESH, 3)
    got = port_simulate(EQ_FIB, EQ_MESH, cfg, {"linkstate": ls}, hop_ticks=7)
    assert_results_equal(ref, got)


def test_speed_epochs_replace_the_speed_argument():
    """Straggler divisors ride in the schedule's per-epoch `speed` (equal to
    the reference's run and to the port's static-speed run); the static
    `speed` argument beside a schedule is refused by every entry point, as
    by the reference."""
    W = EQ_MESH.num_workers
    sp = np.ones(W, np.int32)
    sp[[2, 5]] = 4
    ls = rls.LinkStateSchedule.static(EQ_MESH, 3, speed=sp)
    cfg = rsim.SimConfig(strategy=rst.Strategy.NEIGHBOR, hop_ticks=3, capacity=128,
                         max_ticks=200_000)
    ref = reference("speed_epochs", EQ_FIB, EQ_MESH, cfg, linkstate=ls)
    got = port_simulate(EQ_FIB, EQ_MESH, cfg, {"linkstate": ls})
    assert_results_equal(ref, got)
    assert_results_equal(ref, port_simulate(EQ_FIB, EQ_MESH, cfg, {"speed": sp}))
    with pytest.raises(ValueError) as want:
        rsim.simulate(EQ_FIB, EQ_MESH, cfg, speed=sp, linkstate=ls)
    wl = ptasks.FibWorkload(n=20, cutoff=9, max_leaf_cost=8)
    mesh = ptopo.MeshTopology.square(9)
    pcfg = psim.SimConfig(capacity=128)
    calls = (lambda: psim.simulate(wl, mesh, pcfg, speed=sp, linkstate=port_linkstate(ls),
                                   device="cpu"),
             lambda: psim.simulate_batch(wl, mesh, pcfg, seeds=(0, 1), speed=sp,
                                         linkstate=port_linkstate(ls), device="cpu"),
             lambda: psim.simulate_sweep(wl, mesh, pcfg, [pcfg], speed=sp,
                                         linkstate=port_linkstate(ls), device="cpu"))
    for call in calls:
        with pytest.raises(ValueError) as got_err:
            call()
        assert str(got_err.value) == str(want.value)
    with pytest.raises(TypeError, match="LinkStateSchedule"):
        psim.simulate(wl, mesh, pcfg, linkstate=object(), device="cpu")
    with pytest.raises(ValueError, match="routing must be"):
        psim.simulate(wl, mesh, pcfg, linkstate=port_linkstate(ls),
                      routing_backend="floyd", device="cpu")


def test_constellation_schedule_with_preshed():
    """tests/test_simulator.py::test_constellation_schedule_exact_with_preshed:
    a constellation's own schedule (oscillation, eclipse darkness, seam
    handovers) under ADAPTIVE with pre-shed, built by the port's
    `Constellation` from the same config; exact, and tick mode equal."""
    ccfg = rcon.ConstellationConfig(
        planes=3, sats_per_plane=3, orbit_ticks=400, tau_base=3,
        battery_limited_frac=0.3, warn_ticks=20, wraparound=True,
        epochs_per_orbit=8, seam_outage_frac=0.15, seed=5)
    sched = rcon.Constellation(ccfg).schedule(horizon_ticks=800)
    pred_fail = np.where(sched.predictable, sched.fail_time, -1).astype(np.int32)
    cfg = rsim.SimConfig(strategy=rst.Strategy.ADAPTIVE, capacity=128,
                         max_ticks=200_000, preshed=True, warn_ticks=ccfg.warn_ticks)
    ref = reference("constellation", EQ_FIB, rcon.Constellation(ccfg).mesh, cfg,
                    fail_time=pred_fail, linkstate=sched.linkstate)
    assert ref.result == EQ_FIB.expected_result()
    pcon_ = pcon.Constellation(convert.constellation_config(dataclasses.asdict(ccfg)))
    psched = pcon_.schedule(horizon_ticks=800)
    for mode, backend in (("leap", "loop"), ("tick", "staged")):
        got = psim.simulate(
            convert.workload("FibWorkload", dataclasses.asdict(EQ_FIB)), pcon_.mesh,
            convert.sim_config({**dataclasses.asdict(cfg), "step_mode": mode,
                                "deque_backend": backend}),
            fail_time=np.where(psched.predictable, psched.fail_time, -1).astype(np.int32),
            linkstate=psched.linkstate, device="cpu")
        _check(ref, got, mode)


def test_partitioned_workers_are_unreachable():
    """tests/test_simulator.py::test_partitioned_workers_are_unreachable_not_cheap:
    a dead link cuts a 1x4 line in two; GLOBAL's flights to the far side
    never depart, so it stays idle, and the run is exact on the near side."""
    mesh = rtopo.MeshTopology.grid(1, 4)
    W = 4
    lt = np.full((1, W, 4), 2, np.int32)
    lu = np.ones((1, W, 4), bool)
    lu[0, 1, rls.EAST] = False
    lu[0, 2, rls.WEST] = False
    ls = rls.LinkStateSchedule(np.zeros(1, np.int32), lt, lu,
                               np.ones((1, W), np.int32)).validate(mesh)
    cfg = rsim.SimConfig(strategy=rst.Strategy.GLOBAL, capacity=128, max_ticks=200_000)
    ref = reference("partitioned", EQ_FIB, mesh, cfg, linkstate=ls)
    got = port_simulate(EQ_FIB, mesh, cfg, {"linkstate": ls})
    assert_results_equal(ref, got)
    assert got.result == EQ_FIB.expected_result()
    assert got.per_worker_busy[2] == 0 and got.per_worker_busy[3] == 0


def test_lifeline_under_link_state():
    """LIFELINE draws over all workers and is gated at departure like
    GLOBAL; its points replay no famine window."""
    ls, ft = _dynamic_schedule()
    cfg = rsim.SimConfig(strategy=rst.Strategy.LIFELINE, capacity=128,
                         max_ticks=200_000, preshed=True, warn_ticks=8)
    ref = reference("lifeline", EQ_FIB, EQ_MESH, cfg, fail_time=ft, linkstate=ls)
    got = port_simulate(EQ_FIB, EQ_MESH, cfg, {"fail_time": ft, "linkstate": ls},
                        deque_backend="staged")
    assert_results_equal(ref, got)


def test_link_state_arguments_no_longer_refused():
    """`linkstate` and `routing_backend` are ported: the simulator keeps no
    registry of refused options (`_NOT_PORTED` went with the last, several
    devices), and prebuilt tables pass through."""
    assert not hasattr(psim, "_NOT_PORTED")
    mesh = ptopo.MeshTopology.grid(1, 4)
    tbl = pls.device_tables(pls.LinkStateSchedule.static(mesh, 2), mesh, device="cpu")
    wl = ptasks.FibWorkload(n=10, cutoff=5)
    a = psim.simulate(wl, mesh, psim.SimConfig(capacity=32, hop_ticks=2), device="cpu")
    b = psim.simulate(wl, mesh, psim.SimConfig(capacity=32), linkstate=tbl, device="cpu")
    assert_results_equal(a, b)
