"""Port parity of the round executor's other entry points:
`repro_torch.core.scheduler` on the CPU against the reference's
(`repro.core.scheduler`, JAX), exact equality of every `RunResult` field.

  * tests/test_scheduler.py's UTS under NEIGHBOR and GLOBAL through
    `run_vectorized` itself;
  * `run_vectorized_batch` for seeds (0, 1, 2): one core call.
"""

import dataclasses

import pytest
import torch
from test_torch_scheduler import FIB, MESH, PFIB, PMESH, _cfgs
from torch_parity import assert_results_equal
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import scheduler as rsch
from repro.core import tasks as rtasks
from repro_torch import convert
from repro_torch.core import scheduler as psch

# tests/test_scheduler.py's UTS fixture
UTS = rtasks.UtsWorkload(b0=3.0, d_max=8, root_seed=19)
PUTS = convert.workload("UtsWorkload", dataclasses.asdict(UTS))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("strategy", ["neighbor", "global"])
def test_uts_run_vectorized(strategy):
    rc, pc = _cfgs(strategy, capacity=512, max_rounds=200_000)
    ref = rsch.run_vectorized(UTS, MESH, rc)
    port = psch.run_vectorized(PUTS, PMESH, pc, device="cpu")
    assert_results_equal(ref, port)
    assert port.nodes == UTS.count_tree()


def test_run_vectorized_batch_seeds():
    rc, pc = _cfgs("neighbor")
    ref = rsch.run_vectorized_batch(FIB, MESH, rc, seeds=(0, 1, 2))
    before = psch.run_trace_count()
    port = psch.run_vectorized_batch(PFIB, PMESH, pc, seeds=(0, 1, 2), device="cpu")
    assert psch.run_trace_count() - before == 1
    assert len(port) == 3
    for a, b in zip(ref, port):
        assert_results_equal(a, b)
