"""Port parity of the famine fast path under link state (ROADMAP Queue 1
item 10): tests/test_simulator.py's famine regime with epoch flips and a
death mid-famine, and its dynamic schedule at capacity 2 with an outage
epoch, `repro_torch.simulate` on the CPU against the live reference at the
same `famine_batch` (0, 1, 7 and 64), every `SimResult` field with
`events` included."""

import numpy as np
import pytest
import torch
from test_simulator import (EQ_FIB, EQ_MESH, FAMINE_WL, _dynamic_schedule,
                            _famine_linkstate)
from torch_parity import assert_results_equal, port_simulate
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import simulator as rsim
from repro.core import stealing as rst


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


FAMINE_CASES = [(s, tau, fb) for s in (rst.Strategy.NEIGHBOR, rst.Strategy.ADAPTIVE)
                for tau, fb in ((1, 64), (1, 7), (5, 64), (5, 1), (5, 0))]


@pytest.mark.parametrize("strategy,tau,fb", FAMINE_CASES,
                         ids=[f"{s.value}-tau{t}-fb{f}" for s, t, f in FAMINE_CASES])
def test_famine_regime_epoch_flips(strategy, tau, fb):
    """tests/test_simulator.py::test_leap_equals_tick_famine_regime: epoch
    flips and a death mid-famine; the port at famine batch `fb` equals the
    reference at the same batch, `events` included, and the fast path
    collapses iterations."""
    W = EQ_MESH.num_workers
    ft = -np.ones(W, np.int32)
    ft[5] = 70
    ls = _famine_linkstate(tau)
    cfg = rsim.SimConfig(strategy=strategy, capacity=64, max_ticks=100_000,
                         famine_batch=fb)
    ref = rsim.simulate(FAMINE_WL, EQ_MESH, cfg, fail_time=ft, linkstate=ls)
    got = port_simulate(FAMINE_WL, EQ_MESH, cfg, {"fail_time": ft, "linkstate": ls},
                        deque_backend="staged" if fb == 7 else "loop")
    assert_results_equal(ref, got)
    if fb == 64:
        assert got.events < got.ticks // 2


@pytest.mark.parametrize("fb", [0, 1, 7, 64])
def test_overflow_under_outage_at_every_famine_batch(fb):
    """tests/test_simulator.py::
    test_per_worker_overflow_sums_and_famine_batch_invariant_linkstate: the
    dynamic schedule at capacity 2 (tasks really dropped) at famine batch
    0, 1, 7 and 64, each equal to the reference at that batch."""
    ls, ft = _dynamic_schedule()
    cfg = rsim.SimConfig(strategy=rst.Strategy.NEIGHBOR, capacity=2,
                         max_ticks=200_000, preshed=True, warn_ticks=8,
                         famine_batch=fb)
    ref = rsim.simulate(EQ_FIB, EQ_MESH, cfg, fail_time=ft, linkstate=ls)
    got = port_simulate(EQ_FIB, EQ_MESH, cfg, {"fail_time": ft, "linkstate": ls})
    assert got.overflow > 0
    assert_results_equal(ref, got)
