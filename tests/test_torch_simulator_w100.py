"""Port parity of the closed-system simulator at W=100 (FIB) and at a UTS
point (W=36): `repro_torch` on the CPU against
`repro.core.simulator.simulate`, every `SimResult` field, all four
strategies, tick/leap x loop/staged."""

import pytest
from torch_parity import check_against_reference
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import simulator as rsim
from repro.core import stealing as rst
from repro.core import tasks as rtasks
from repro.core import topology as rtopo
from repro_torch.core import tasks as ptasks

FIB = rtasks.FibWorkload(n=16, cutoff=8, max_leaf_cost=8)
MESH = rtopo.MeshTopology.square(100)
UTS = rtasks.UtsWorkload(b0=4.0, d_max=6)


@pytest.mark.parametrize("strategy", list(rst.Strategy), ids=lambda s: s.value)
def test_fib_w100_matches_reference(strategy):
    cfg = rsim.SimConfig(strategy=strategy, hop_ticks=3, capacity=32,
                         famine_batch=0, max_ticks=5000)
    ref = rsim.simulate(FIB, MESH, cfg)
    assert ref.result == FIB.expected_result() and ref.overflow == 0
    check_against_reference(ref, FIB, MESH, cfg)


@pytest.mark.parametrize("strategy", list(rst.Strategy), ids=lambda s: s.value)
def test_uts_matches_reference(strategy):
    mesh = rtopo.MeshTopology.square(36)
    cfg = rsim.SimConfig(strategy=strategy, hop_ticks=3, capacity=32,
                         famine_batch=0, max_ticks=5000)
    ref = rsim.simulate(UTS, mesh, cfg)
    # the port's tree oracle (checked against the reference's in
    # test_torch_tasks.py; the reference's recompiles at every level)
    assert ref.nodes == ptasks.UtsWorkload(b0=UTS.b0, d_max=UTS.d_max).count_tree()
    check_against_reference(ref, UTS, mesh, cfg)
