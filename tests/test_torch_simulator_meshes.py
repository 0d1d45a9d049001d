"""Port parity of the closed-system simulator on other mesh shapes: a full
torus, a ragged torus and a single worker — `repro_torch` on the CPU
against `repro.core.simulator.simulate`, every `SimResult` field,
tick/leap x loop/staged."""

import pytest
from torch_parity import check_against_reference
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import simulator as rsim
from repro.core import stealing as rst
from repro.core import tasks as rtasks
from repro.core import topology as rtopo

FIB = rtasks.FibWorkload(n=16, cutoff=8, max_leaf_cost=8)


@pytest.mark.parametrize("mesh,workload,strategies", [
    (rtopo.MeshTopology.grid(4, 6, torus=True), FIB,
     (rst.Strategy.GLOBAL, rst.Strategy.ADAPTIVE)),
    (rtopo.MeshTopology.square(23, torus=True), FIB,
     (rst.Strategy.GLOBAL, rst.Strategy.ADAPTIVE)),
    (rtopo.MeshTopology.square(1), rtasks.FibWorkload(n=10, cutoff=5),
     (rst.Strategy.NEIGHBOR,)),
], ids=["torus4x6", "ragged23", "single"])
def test_torus_ragged_and_single_worker_meshes(mesh, workload, strategies):
    """Wrap-around hop pricing, a ragged last row, and a lone worker (no
    victim exists), one reference compile per mesh."""
    for strategy in strategies:
        cfg = rsim.SimConfig(strategy=strategy, hop_ticks=2, capacity=32,
                             famine_batch=0, max_ticks=5000)
        ref = rsim.simulate(workload, mesh, cfg)
        assert ref.result == workload.expected_result()
        check_against_reference(ref, workload, mesh, cfg)
