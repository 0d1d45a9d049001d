"""Port parity of the famine fast path end to end: `repro_torch.simulate`
on the CPU against `repro.core.simulator.simulate` at the reference's own
`famine_batch`, every `SimResult` field and `events`, on both deque
backends — FIB n=16 cutoff=12 max_leaf_cost=96 at W=9 (the reference's
famine workload) for every strategy, τ and batch size, and one W=100 point
at the defaults."""

import pytest
from torch_parity import assert_results_equal, port_simulate
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import simulator as rsim
from repro.core import stealing as rst
from repro.core import tasks as rtasks
from repro.core import topology as rtopo

FAMINE_WL = rtasks.FibWorkload(n=16, cutoff=12, max_leaf_cost=96)
MESH = rtopo.MeshTopology.square(9)


@pytest.mark.parametrize("tau", [1, 5])
@pytest.mark.parametrize("strategy", list(rst.Strategy), ids=lambda s: s.value)
def test_famine_batches_match_reference(strategy, tau):
    """famine_batch 1, 7 and 64: the port equals the reference run at the
    same batch in every field, `events` included, on both backends; where
    the reference's own acceptance holds (NEIGHBOR, ADAPTIVE), the fast path
    fires: events < ticks // 2 at the default batch."""
    first = None
    for fb in (1, 7, 64):
        cfg = rsim.SimConfig(strategy=strategy, hop_ticks=tau, capacity=64,
                             famine_batch=fb)
        ref = rsim.simulate(FAMINE_WL, MESH, cfg)
        assert ref.result == FAMINE_WL.expected_result()
        for backend in ("loop", "staged"):
            assert_results_equal(ref, port_simulate(FAMINE_WL, MESH, cfg,
                                                    deque_backend=backend))
        # the port's result does not depend on famine_batch, events aside
        first = first or ref
        assert_results_equal(first, ref, skip=("events",))
    if strategy in (rst.Strategy.NEIGHBOR, rst.Strategy.ADAPTIVE):
        assert ref.events < ref.ticks // 2, (ref.events, ref.ticks)


def test_w100_defaults_match_reference():
    """W=100 at the default SimConfig but capacity (famine_batch 64): the
    port equals the reference in every field, `events` included, on both
    backends."""
    wl = rtasks.FibWorkload(n=24, cutoff=12, max_leaf_cost=64)
    mesh = rtopo.MeshTopology.square(100)
    cfg = rsim.SimConfig(capacity=64)
    ref = rsim.simulate(wl, mesh, cfg)
    assert ref.result == wl.expected_result() and ref.overflow == 0
    for backend in ("loop", "staged"):
        assert_results_equal(ref, port_simulate(wl, mesh, cfg,
                                                deque_backend=backend))


@pytest.mark.parametrize("mesh,strategies,tau", [
    (rtopo.MeshTopology.grid(4, 1, torus=True),
     (rst.Strategy.NEIGHBOR, rst.Strategy.ADAPTIVE), 5),
    (rtopo.MeshTopology.square(23, torus=True),
     (rst.Strategy.GLOBAL, rst.Strategy.ADAPTIVE), 2),
], ids=["torus4x1", "ragged23"])
def test_meshes_match_reference(mesh, strategies, tau):
    """Meshes that change how many probe cycles fit in a window: a one-column
    torus, whose row neighbors are the worker itself (0-hop draws, 1-tick
    cycles), and a ragged torus. The port equals the reference at the
    default batch, `events` included, on both backends."""
    for strategy in strategies:
        cfg = rsim.SimConfig(strategy=strategy, hop_ticks=tau, capacity=64)
        ref = rsim.simulate(FAMINE_WL, mesh, cfg)
        assert ref.result == FAMINE_WL.expected_result()
        for backend in ("loop", "staged"):
            assert_results_equal(ref, port_simulate(FAMINE_WL, mesh, cfg,
                                                    deque_backend=backend))
