"""The link-state path on a CUDA card against the port's own CPU path
(`gpu` tests; each skips where torch sees no card, deciding inside the
test). No JAX here: the schedules are made with numpy, as in
tests/test_simulator.py, and the card is held to the plain PyTorch path.

  * `build_tables` on the card equals the CPU build, and `flight_ticks` /
    `same_component` of random pairs under per-point epochs agree;
  * a drained run under a periodic eclipse with its link epochs (GLOBAL,
    sparse tables; the loop captured as a CUDA graph, the backend's kernel
    launched) and a 4-strategy sweep equal the CPU runs in every field.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import paper_mesh
from repro_torch.core import constellation as pcon
from repro_torch.core import linkstate as pls
from repro_torch.core import simulator as psim
from repro_torch.core import tasks as ptasks
from repro_torch.core import topology as ptopo

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _orbit_quick():
    """The paper mesh's `orbit_quick` preset (a 5x5 torus) over 1200 ticks."""
    con = pcon.Constellation(paper_mesh.CONFIG.orbit_quick)
    return con.mesh, con.schedule(1200).linkstate


def _second_cycle_wake(tau):
    """tests/test_simulator.py's `_conf_second_cycle_wake`: worker 5 of a
    3x3 mesh sleeps in [5, 40) and [75, 110), its links dark then; the
    inter-row τ alternates by epoch."""
    mesh = ptopo.MeshTopology.square(9)
    W = 9
    starts = np.asarray([0, 5, 40, 75, 110, 145, 180], np.int32)
    E = len(starts)
    tau_tab = np.full((E, W, 4), tau, np.int32)
    for e in range(E):
        tau_tab[e, :, pls.NORTH] = tau_tab[e, :, pls.SOUTH] = tau + (e % 2)
    up = np.ones((E, W, 4), bool)
    nbr = mesh.neighbor_table
    for e in (1, 3):
        for d in range(4):
            if nbr[5, d] >= 0:
                up[e, 5, d] = False
                up[e, nbr[5, d], pls.OPPOSITE[d]] = False
    ls = pls.LinkStateSchedule(starts, tau_tab, up, np.ones((E, W), np.int32)).validate(mesh)
    ft, wt, fp = (np.full(W, -1, np.int32) for _ in range(3))
    ft[5], wt[5], fp[5] = 5, 40, 70
    return mesh, ls, {"fail_time": ft, "wake_time": wt, "fail_period": fp}


def _fields_equal(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


@pytest.mark.parametrize("routing,patch", [("dense", None), ("sparse", None),
                                           ("sparse", (2, 2))])
def test_flight_ticks_card_equals_cpu(routing, patch):
    _need_card()
    mesh, ls = _orbit_quick()
    cpu, cs = pls.build_tables(ls, mesh, routing=routing, patch=patch, device="cpu")
    card, gs = pls.build_tables(ls, mesh, routing=routing, patch=patch, device="cuda")
    assert cs.table_bytes == gs.table_bytes
    for a, b in zip(cpu, card):
        assert (a is None) == (b is None)
        if a is not None:
            assert b.is_cuda and torch.equal(a, b.cpu())
    W = mesh.num_workers
    rs = np.random.default_rng(13)
    E = ls.num_epochs
    eg = torch.as_tensor(rs.integers(0, E, (7, 1)).astype(np.int32))
    sg = torch.as_tensor(rs.integers(-1, W, (7, W)).astype(np.int32))
    dg = torch.as_tensor(rs.integers(-1, W, (7, W)).astype(np.int32))
    args = (mesh.rows, mesh.cols, mesh.torus_full())
    assert torch.equal(pls.flight_ticks(cpu, eg, sg, dg, *args),
                       pls.flight_ticks(card, eg.cuda(), sg.cuda(), dg.cuda(), *args).cpu())
    assert torch.equal(pls.same_component(cpu, eg, sg, dg),
                       pls.same_component(card, eg.cuda(), sg.cuda(), dg.cuda()).cpu())


@pytest.mark.parametrize("backend", ["loop", "staged"])
def test_drained_run_card_equals_cpu(backend):
    _need_card()
    from repro_torch.kernels import ops

    mesh, ls, sched = _second_cycle_wake(5)
    wl = ptasks.FibWorkload(n=16, cutoff=12, max_leaf_cost=96)
    cfg = psim.SimConfig(strategy=psim.stealing.Strategy.GLOBAL, capacity=128,
                         preshed=True, warn_ticks=2, deque_backend=backend)
    kw = dict(linkstate=ls, routing_backend="sparse", **sched)
    ops.reset_launch_counts()
    card = psim.simulate(wl, mesh, cfg, device="cuda", **kw)
    kernel = "deque_apply" if backend == "staged" else "steal_compact"
    assert ops.LAUNCHES[kernel] > 0
    _fields_equal(psim.simulate(wl, mesh, cfg, device="cpu", **kw), card)
    pts = [psim.SimParams(strategy=c, seed=c, escalate_after=2 + c) for c in range(4)]
    for a, b in zip(psim.simulate_sweep(wl, mesh, cfg, pts, device="cpu", **kw),
                    psim.simulate_sweep(wl, mesh, cfg, pts, device="cuda", **kw)):
        _fields_equal(a, b)
