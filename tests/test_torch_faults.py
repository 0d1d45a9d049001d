"""Port parity of the fault model (ROADMAP Queue 1 item 9): deaths by
schedule under each recovery, pre-shed with its warning, wake-ups, periodic
eclipses and stragglers, `repro_torch.simulate` on the CPU against the live
reference (`repro.core.simulator.simulate`, JAX on the CPU), every
`SimResult` field with `events` included, on the reference's own fixtures
(tests/test_torch_faults_grid.py runs the conformance matrix's points on
the staged backend and in tick mode); the schedules' validation; and the
fault paths on the card against the CPU (`gpu` tests, skipped without
one)."""

import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import assert_results_equal, port_simulate
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import simulator as rsim
from repro.core import stealing as rst
from repro.core import tasks as rtasks
from repro.core import topology as rtopo
from repro_torch import convert
from repro_torch.core import simulator as psim

# tests/test_simulator.py's fixtures
FIB = rtasks.FibWorkload(n=24, cutoff=10, max_leaf_cost=8)
MESH = rtopo.MeshTopology.square(16)
EQ_FIB = rtasks.FibWorkload(n=20, cutoff=9, max_leaf_cost=8)
EQ_MESH = rtopo.MeshTopology.square(9)
CONF_WAKE_WL = rtasks.FibWorkload(n=16, cutoff=12, max_leaf_cost=96)
EQ_MATRIX = [
    (strat, rec, "preshed" if (si + ri) % 2 == 0 else "stragglers")
    for si, strat in enumerate([rst.Strategy.NEIGHBOR, rst.Strategy.GLOBAL,
                                rst.Strategy.LIFELINE, rst.Strategy.ADAPTIVE])
    for ri, rec in enumerate([rsim.Recovery.NONE, rsim.Recovery.TC,
                              rsim.Recovery.SUPERVISION])]
TC_SCHEDULES = [[(1, 50), (2, 51), (3, 52)],
                [(4, 80), (8, 80), (12, 80)],
                [(1, 50), (2, 50), (5, 90), (6, 130), (9, 170)]]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's CPU path runs many small operations: one intra-op thread
    a test process keeps parallel workers from oversubscribing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def reference():
    """The reference's runs, each once: `reference(wl, mesh, cfg, **sched)`.
    The reference compiles once per (workload, mesh, static config)."""
    cache = {}

    def get(wl, mesh, cfg, **sched):
        key = (wl, mesh, cfg, tuple(sorted(
            (k, None if v is None else tuple(np.asarray(v).tolist()))
            for k, v in sched.items())))
        if key not in cache:
            cache[key] = rsim.simulate(wl, mesh, cfg, **sched)
        return cache[key]

    return get


def _fails(W, pairs):
    ft = -np.ones(W, np.int32)
    for w, t in pairs:
        ft[w] = t
    return ft


def _eq_case(strategy, recovery, modifier):
    """tests/test_simulator.py's `test_leap_equals_tick_oracle` point:
    failures at 70 and 150, pre-shed with an 8-tick warning or stragglers."""
    W = EQ_MESH.num_workers
    sched = {"fail_time": _fails(W, [(2, 70), (5, 150)])}
    preshed, warn = False, 0
    if modifier == "stragglers":
        speed = np.ones(W, np.int32)
        speed[[1, 4]] = 3
        sched["speed"] = speed
    else:
        preshed, warn = True, 8
    cfg = rsim.SimConfig(
        strategy=strategy, hop_ticks=3, capacity=128, max_ticks=200_000,
        recovery=recovery,
        ckpt_interval=30 if recovery is rsim.Recovery.TC else 0,
        preshed=preshed, warn_ticks=warn)
    return cfg, sched


def _port_modes_agree(wl, mesh, cfg, sched, base, modes):
    """The port in each of `modes` ((step_mode, deque_backend,
    famine_batch)) equals its leap/loop run `base` in every field, `events`
    aside; tick mode counts one event a tick."""
    for mode, backend, fb in modes:
        got = port_simulate(wl, mesh, cfg, sched, step_mode=mode,
                            deque_backend=backend, famine_batch=fb)
        assert_results_equal(base, got, skip=("events",))
        if mode == "tick":
            assert got.events == got.ticks


@pytest.mark.parametrize("i", range(len(EQ_MATRIX)),
                         ids=[f"{s.value}-{r.value}-{m}" for s, r, m in EQ_MATRIX])
def test_eq_matrix_matches_reference(reference, i):
    """Every strategy x recovery x {pre-shed, stragglers} point of the
    reference's conformance matrix, failures included: the port's leap/loop
    run equals the reference's, `events` included (the staged backend, tick
    mode and the famine path off run these points in
    tests/test_torch_faults_grid.py)."""
    cfg, sched = _eq_case(*EQ_MATRIX[i])
    want = reference(EQ_FIB, EQ_MESH, cfg, **sched)
    assert_results_equal(want, port_simulate(EQ_FIB, EQ_MESH, cfg, sched,
                                             deque_backend="loop"))


@pytest.mark.parametrize("schedule", TC_SCHEDULES,
                         ids=["cascade", "simultaneous", "spread"])
def test_tc_adversarial_schedules(reference, schedule):
    """The reference's adversarial TC schedules (a rollback cascade that
    resurrects the long dead, deaths at a checkpoint boundary): equal to
    the reference and exact."""
    cfg = rsim.SimConfig(strategy=rst.Strategy.NEIGHBOR, hop_ticks=3,
                         capacity=256, recovery=rsim.Recovery.TC,
                         ckpt_interval=40, max_ticks=500_000)
    sched = {"fail_time": _fails(MESH.num_workers, schedule)}
    want = reference(FIB, MESH, cfg, **sched)
    got = port_simulate(FIB, MESH, cfg, sched)
    assert_results_equal(want, got)
    assert got.result == FIB.expected_result() and got.ckpt_bytes > 0


@pytest.mark.parametrize("recovery", [rsim.Recovery.NONE, rsim.Recovery.SUPERVISION])
def test_supervision_single_early_failure(reference, recovery):
    """Worker 1 dies at tick 16 holding stolen work: NONE loses it, the
    supervision re-push restores it — in the port as in the reference."""
    cfg = rsim.SimConfig(strategy=rst.Strategy.NEIGHBOR, hop_ticks=3,
                         capacity=256, recovery=recovery, max_ticks=500_000)
    sched = {"fail_time": _fails(MESH.num_workers, [(1, 16)])}
    want = reference(FIB, MESH, cfg, **sched)
    got = port_simulate(FIB, MESH, cfg, sched)
    assert_results_equal(want, got)
    exact = got.result == FIB.expected_result()
    assert exact == (recovery is rsim.Recovery.SUPERVISION)


@pytest.mark.parametrize("mode", ["leap", "tick"])
def test_supervision_nested_resteal_matches_live_reference(reference, mode):
    """The nested re-steal schedule (worker 7 dies at 60) held against the
    reference's live output, not the constants its own test pins (ROADMAP
    Queue 3): every field equal, in both step modes."""
    cfg = rsim.SimConfig(strategy=rst.Strategy.NEIGHBOR, hop_ticks=3,
                         capacity=256, recovery=rsim.Recovery.SUPERVISION,
                         max_ticks=500_000, step_mode=mode)
    sched = {"fail_time": _fails(MESH.num_workers, [(7, 60)])}
    want = reference(FIB, MESH, cfg, **sched)
    assert_results_equal(want, port_simulate(FIB, MESH, cfg, sched))


def test_supervision_ledger_wraps_at_its_last_slot(reference):
    """A 2-slot ledger fills at once, so later grants all land on its last
    slot, where the highest thief of a tick wins as in the reference."""
    cfg = rsim.SimConfig(strategy=rst.Strategy.GLOBAL, hop_ticks=2,
                         capacity=128, recovery=rsim.Recovery.SUPERVISION,
                         supervision_slots=2, max_ticks=200_000)
    sched = {"fail_time": _fails(EQ_MESH.num_workers, [(3, 60), (6, 90)])}
    want = reference(EQ_FIB, EQ_MESH, cfg, **sched)
    got = port_simulate(EQ_FIB, EQ_MESH, cfg, sched)
    assert_results_equal(want, got)
    _port_modes_agree(EQ_FIB, EQ_MESH, cfg, sched, got, [("leap", "staged", 64)])


def _second_cycle_wake():
    """tests/test_simulator.py's `_conf_second_cycle_wake` schedule without
    its link-state epochs (the whole scenario, epochs included, is in
    tests/test_torch_simulator_linkstate_conf.py): worker 5 sleeps in [5,
    40) and again from 75 (period 70)."""
    W = EQ_MESH.num_workers
    ft, wt, fp = (-np.ones(W, np.int32) for _ in range(3))
    ft[5], wt[5], fp[5] = 5, 40, 70
    return {"fail_time": ft, "wake_time": wt, "fail_period": fp}


@pytest.mark.parametrize("strategy", [rst.Strategy.NEIGHBOR, rst.Strategy.GLOBAL,
                                      rst.Strategy.ADAPTIVE])
@pytest.mark.parametrize("tau", [1, 5])
def test_second_cycle_wake_matches_reference(reference, strategy, tau):
    """A periodic eclipse on the famine-churn workload (the scenario of the
    reference's `test_second_cycle_wake_clips_famine_window`): the port's
    leap run equals the reference's, `events` included; tick mode equals it."""
    cfg = rsim.SimConfig(strategy=strategy, hop_ticks=tau, capacity=128,
                         max_ticks=200_000, preshed=True, warn_ticks=2)
    sched = _second_cycle_wake()
    want = reference(CONF_WAKE_WL, EQ_MESH, cfg, **sched)
    got = port_simulate(CONF_WAKE_WL, EQ_MESH, cfg, sched)
    assert_results_equal(want, got)
    assert got.ticks > 75 and got.events < got.ticks  # the famine path ran
    _port_modes_agree(CONF_WAKE_WL, EQ_MESH, cfg, sched, got, [("tick", "loop", 64)])


def test_one_shot_wake_matches_reference(reference):
    """tests/test_simulator.py's elastic grow on a 1x3 line: the middle
    worker dies at 2 and wakes at 40; equal to the reference, exact, and
    the woken worker is stolen from. A single periodic cycle whose second
    lies past the run is the same schedule."""
    mesh = rtopo.MeshTopology.grid(1, 3)
    wl = rtasks.FibWorkload(n=18, cutoff=9, max_leaf_cost=12)
    ft, wt = _fails(3, [(1, 2)]), _fails(3, [(1, 40)])
    cfg = rsim.SimConfig(strategy=rst.Strategy.NEIGHBOR, hop_ticks=2,
                         capacity=128, max_ticks=200_000, preshed=True,
                         warn_ticks=1)
    want = reference(wl, mesh, cfg, fail_time=ft, wake_time=wt)
    got = port_simulate(wl, mesh, cfg, {"fail_time": ft, "wake_time": wt})
    assert_results_equal(want, got)
    assert got.result == wl.expected_result() and got.per_worker_stolen[1] > 0
    fp = _fails(3, [(1, 1 << 20)])
    periodic = port_simulate(wl, mesh, cfg, {"fail_time": ft, "wake_time": wt,
                                             "fail_period": fp})
    assert_results_equal(got, periodic)


def test_stragglers_without_failures(reference):
    """Speeds alone (no death): equal to the reference, exact."""
    W = EQ_MESH.num_workers
    speed = np.ones(W, np.int32)
    speed[[0, 4, 7]] = [2, 4, 3]
    cfg = rsim.SimConfig(strategy=rst.Strategy.ADAPTIVE, hop_ticks=2,
                         capacity=128, max_ticks=200_000)
    want = reference(EQ_FIB, EQ_MESH, cfg, speed=speed)
    got = port_simulate(EQ_FIB, EQ_MESH, cfg, {"speed": speed})
    assert_results_equal(want, got)
    assert got.result == EQ_FIB.expected_result()


def _validation_cases(W):
    ft = _fails(W, [(2, 10)])
    wt = _fails(W, [(2, 20)])
    cases = [{"wake_time": np.full(W, 5, np.int32)},          # wake, no death
             {"fail_time": ft, "wake_time": _fails(W, [(2, 10)])}]  # wake == fail
    for bad in (0, -3, 5, 1 << 29):  # zero/negative, wake outside, int32-unsafe
        cases.append({"fail_time": ft, "wake_time": wt,
                      "fail_period": _fails(W, [(2, bad)])})
    cases.append({"fail_time": ft, "fail_period": _fails(W, [(2, 50)])})  # no wake
    return cases


@pytest.mark.parametrize("case", range(7))
def test_schedule_validation_matches_reference(case):
    """The schedules the reference refuses, the port refuses, with the same
    message."""
    W = EQ_MESH.num_workers
    sched = _validation_cases(W)[case]
    cfg = rsim.SimConfig(strategy=rst.Strategy.NEIGHBOR, max_ticks=100)
    with pytest.raises(ValueError) as ref_err:
        rsim.simulate(EQ_FIB, EQ_MESH, cfg, **sched)
    with pytest.raises(ValueError) as port_err:
        port_simulate(EQ_FIB, EQ_MESH, cfg, sched)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("kwargs,cfg_kw", [
    ({}, {"recovery": psim.Recovery.TC, "ckpt_interval": 5}),
    ({}, {"recovery": psim.Recovery.SUPERVISION}),
    ({}, {"preshed": True, "warn_ticks": 3}),
    ({"fail_time": np.full(4, -1, np.int32)}, {}),
    ({"wake_time": np.full(4, -1, np.int32)}, {}),
    ({"fail_period": np.full(4, -1, np.int32)}, {}),
    ({"speed": np.ones(4, np.int32)}, {}),
], ids=["tc", "supervision", "preshed", "fail_time", "wake_time", "fail_period",
        "speed"])
def test_fault_options_without_a_fault_change_nothing(kwargs, cfg_kw):
    """Each fault option is accepted; with no worker dying or straggling it
    leaves the closed system's result as it was (checkpoints aside: they
    count their bytes and end leaps, so `events` grows)."""
    from repro_torch.core import tasks as ptasks
    from repro_torch.core import topology as ptopo

    wl, mesh = ptasks.FibWorkload(n=10, cutoff=5), ptopo.MeshTopology.square(4)
    plain = psim.simulate(wl, mesh, psim.SimConfig(capacity=16), device="cpu")
    got = psim.simulate(wl, mesh, psim.SimConfig(capacity=16, **cfg_kw),
                        device="cpu", **kwargs)
    assert_results_equal(plain, got, skip=("ckpt_bytes", "events"))
    assert (got.events == plain.events) == ("ckpt_interval" not in cfg_kw)
    assert got.result == wl.expected_result()


def test_bad_speed_and_shape_raise():
    from repro_torch.core import tasks as ptasks
    from repro_torch.core import topology as ptopo

    wl, mesh = ptasks.FibWorkload(n=10, cutoff=5), ptopo.MeshTopology.square(4)
    with pytest.raises(ValueError, match="speed must be >= 1"):
        psim.simulate(wl, mesh, psim.SimConfig(capacity=16), device="cpu",
                      speed=np.zeros(4, np.int32))
    with pytest.raises(ValueError, match="shape"):
        psim.simulate(wl, mesh, psim.SimConfig(capacity=16), device="cpu",
                      fail_time=np.full(5, -1, np.int32))


# --------------------------------------------------------------------------- #
# On the card: the fault paths against the port on the CPU
# --------------------------------------------------------------------------- #
def _port_objects(wl, mesh):
    return (convert.workload(type(wl).__name__, dataclasses.asdict(wl)),
            convert.mesh(mesh.num_workers, mesh.rows, mesh.cols, mesh.torus))


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
@pytest.mark.parametrize("backend", ["loop", "staged"])
@pytest.mark.parametrize("i", [1, 4, 5, 8])
def test_card_fault_paths_match_cpu(i, backend):
    """TC (stragglers; pre-shed), SUPERVISION (stragglers; pre-shed) on the
    card, one captured loop with sync debug mode "error" around its
    replays: every field equal to the CPU run, `events` included."""
    cfg, sched = _eq_case(*EQ_MATRIX[i])
    wl, mesh = _port_objects(EQ_FIB, EQ_MESH)
    pcfg = convert.sim_config({**dataclasses.asdict(cfg), "deque_backend": backend})
    want = psim.simulate(wl, mesh, pcfg, device="cpu", **sched)
    assert_results_equal(want, psim.simulate(wl, mesh, pcfg, device="cuda", **sched))


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
@pytest.mark.parametrize("mode", ["leap", "tick"])
def test_card_periodic_eclipse_matches_cpu(mode):
    """A periodic eclipse with its second-cycle death, pre-shed, on the
    card: equal to the CPU run, `events` included."""
    wl, mesh = _port_objects(CONF_WAKE_WL, EQ_MESH)
    cfg = psim.SimConfig(hop_ticks=1, capacity=128, max_ticks=200_000,
                         preshed=True, warn_ticks=2, step_mode=mode)
    sched = _second_cycle_wake()
    want = psim.simulate(wl, mesh, cfg, device="cpu", **sched)
    assert_results_equal(want, psim.simulate(wl, mesh, cfg, device="cuda", **sched))
