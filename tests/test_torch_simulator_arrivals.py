"""Port parity of open-loop arrivals (ROADMAP Queue 1 item 12):
`repro_torch.simulate(arrivals=...)` on the CPU against the live reference
on tests/test_arrivals.py's fixtures (FIB n=12 on a 16-worker mesh, a ring
of 2^13 rows) and its four `ARRIVAL_SCENARIOS` — Poisson onto every
worker, on/off bursts onto 6 stations, a Zipf hot spot at batch 8 (drops
and overflow), a rate schedule flipping inside famine windows — in tick
and leap mode: every `SimResult` field equal with no tolerance, `events`,
the injection and sojourn counters, the event ring elementwise (ARRIVAL
and SOJOURN events included) and the `sojourn` percentiles."""

import numpy as np
import pytest
import torch
from test_arrivals import ARRIVAL_SCENARIOS, MESH, TRC, WL
from torch_parity import assert_results_equal, port_simulate
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import simulator as rsim
from repro.core import tracing as rtr


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def scenario_cfg(name, mode, max_ticks=1200, **extra):
    """tests/test_arrivals.py's `_run` configuration of a scenario."""
    acfg, gap, kw = ARRIVAL_SCENARIOS[name]
    cfg = rsim.SimConfig(seed=kw.get("seed", 3), step_mode=mode, capacity=1024,
                         arrival_gap_q8=gap, arrival_batch=kw.get("batch", 1),
                         max_ticks=max_ticks, trace=TRC, **extra)
    return acfg, cfg


@pytest.mark.parametrize("mode", ["tick", "leap"])
@pytest.mark.parametrize("name", list(ARRIVAL_SCENARIOS))
def test_scenario_equals_reference(name, mode):
    acfg, cfg = scenario_cfg(name, mode)
    ref = rsim.simulate(WL, MESH, cfg, arrivals=acfg)
    got = port_simulate(WL, MESH, cfg, {"arrivals": acfg})
    assert_results_equal(ref, got)
    assert got.arrivals_injected > 0 and got.sojourn["count"] == got.requests_done
    assert got.trace.dropped == 0
    kinds = got.trace.counts()
    assert kinds["arrival"] == got.arrivals_injected
    assert kinds["sojourn"] == got.requests_done
    if mode == "tick":
        assert got.events == got.ticks
    if name == "zipf_hot":  # the hot station's deque overflows
        assert got.arrivals_dropped > 0 and kinds["overflow"] > 0
    # every sojourn prices its request's wait plus its cost
    soj = got.trace.of_kind(rtr.EV_SOJOURN)
    assert np.array_equal(soj[:, rtr.LANE_RTT], soj[:, rtr.LANE_TICK]
                          - soj[:, rtr.LANE_VICTIM] + acfg.task_cost)
