"""Port parity of the simulator's route-around semantics (ROADMAP Queue 1
item 10): tests/test_simulator.py's conformance scenarios — a seam outage
repriced along detours, an eclipse with its wake, a wake mid-famine, and a
periodic eclipse whose second-cycle wake lands in a famine window, with its
link epochs — for NEIGHBOR, GLOBAL and ADAPTIVE at τ 1 and 5:
`repro_torch.simulate` on the CPU against the live reference, every
`SimResult` field with `events` included, over the loop and staged
backends, both step modes and the famine path off."""

import pytest
import torch
from test_simulator import CONF_SCENARIOS, _conf_second_cycle_wake
from torch_parity import assert_results_equal, port_simulate
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import simulator as rsim
from repro.core import stealing as rst

STRATEGIES = [rst.Strategy.NEIGHBOR, rst.Strategy.GLOBAL, rst.Strategy.ADAPTIVE]
_REF = {}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _scenario(name, tau):
    if name == "second_cycle_wake":
        return _conf_second_cycle_wake(tau)
    mesh, wl, ls, ft, wt = CONF_SCENARIOS[name](tau)
    return mesh, wl, ls, ft, wt, None


# the port's mode for each case: (step_mode, deque_backend, famine_batch),
# turned over the cases so that every scenario meets each axis
MODES = [("leap", "loop", 64), ("leap", "staged", 64), ("leap", "loop", 0),
         ("tick", "staged", 64), ("leap", "staged", 7), ("tick", "loop", 64)]
CASES = [(name, s, tau) for name in list(CONF_SCENARIOS) + ["second_cycle_wake"]
         for s in STRATEGIES for tau in (1, 5)]


@pytest.mark.parametrize("name,strategy,tau", CASES,
                         ids=[f"{n}-{s.value}-tau{t}" for n, s, t in CASES])
def test_conformance_scenario(name, strategy, tau):
    """The port in one mode (turned over the cases) equals the reference's
    leap run at the default famine batch, `events` included where the port
    runs that batch in leap mode (the famine batch changes `events` only;
    tick mode counts one event a tick)."""
    mesh, wl, ls, ft, wt, fp = _scenario(name, tau)
    preshed = ft is not None
    cfg = rsim.SimConfig(strategy=strategy, capacity=128, max_ticks=200_000,
                         preshed=preshed, warn_ticks=2 if preshed else 0)
    sched = {"fail_time": ft, "wake_time": wt, "fail_period": fp, "linkstate": ls}
    key = (name, strategy, tau)
    if key not in _REF:
        _REF[key] = rsim.simulate(wl, mesh, cfg, **sched)
    ref = _REF[key]
    mode, backend, fb = MODES[CASES.index((name, strategy, tau)) % len(MODES)]
    got = port_simulate(wl, mesh, cfg, sched, step_mode=mode, deque_backend=backend,
                        famine_batch=fb)
    if mode == "leap" and fb == 64:
        assert_results_equal(ref, got)
    else:
        assert_results_equal(ref, got, skip=("events",))
        if mode == "tick":
            assert got.events == got.ticks
    if name == "eclipse_cycle":
        assert got.result == wl.expected_result()
        assert got.per_worker_stolen[4] > 0
    if name == "second_cycle_wake" and mode == "leap" and fb == 64:
        # the second-cycle wake clips a famine window: the fast path ran
        assert got.events < got.ticks
