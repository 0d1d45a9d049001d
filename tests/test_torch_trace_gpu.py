"""The flight recorder on a CUDA card against the port's own CPU path (`gpu`
tests; each skips where torch sees no card, deciding inside the test). No
JAX here: the schedules are made with numpy.

  * traced runs on the card (the loop captured as a CUDA graph, host syncs
    made errors) equal the CPU runs in every field, the event ring
    elementwise: NEIGHBOR on both deque backends, GLOBAL across a partition
    at famine batch 64 (the closed-form replay's EV_NO_LIVE_VICTIM events),
    and a traced 3-point sweep;
  * the captured loop writes the ring in place: its commit finds the ring's
    new value sharing the static buffer's storage and skips the masked
    `where` over it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import linkstate as pls
from repro_torch.core import simulator as psim
from repro_torch.core import stealing as pst
from repro_torch.core import tasks as ptasks
from repro_torch.core import topology as ptopo
from repro_torch.core import tracing as ptr

pytestmark = pytest.mark.gpu

TC = ptr.TraceConfig(ring_capacity=1 << 14, bins=128, bin_ticks=64)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _assert_same_result(a, b, what):
    """Every field equal; the `Trace` and `TimeSeries` field by field."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f in ("trace", "timeseries") and x is not None:
            for name in x.__dataclass_fields__:
                u, v = getattr(x, name), getattr(y, name)
                if isinstance(u, np.ndarray):
                    assert u.shape == v.shape and np.array_equal(u, v), f"{what}: {f}.{name}"
                else:
                    assert u == v, f"{what}: {f}.{name} {u!r} != {v!r}"
        elif isinstance(x, np.ndarray):
            assert np.array_equal(x, y), f"{what}: {f}"
        else:
            assert x == y, f"{what}: {f} {x!r} != {y!r}"


def _partition(mesh):
    """The 2x2 corner of a 4x4 mesh cut off for ticks [30, 90)."""
    W = mesh.num_workers
    up = np.ones((3, W, 4), bool)
    nbr = mesh.neighbor_table
    corner = (mesh.coords[:, 0] < 2) & (mesh.coords[:, 1] < 2)
    for w in range(W):
        for d in range(4):
            if nbr[w, d] >= 0 and corner[w] != corner[nbr[w, d]]:
                up[1, w, d] = False
    return pls.LinkStateSchedule(np.asarray([0, 30, 90], np.int32),
                                 np.full((3, W, 4), 1, np.int32), up,
                                 np.ones((3, W), np.int32)).validate(mesh)


CASES = {
    "neighbor-loop": (ptasks.FibWorkload(n=26, cutoff=14), 100,
                      dict(strategy=pst.Strategy.NEIGHBOR), {}),
    "neighbor-staged": (ptasks.FibWorkload(n=26, cutoff=14), 100,
                        dict(strategy=pst.Strategy.NEIGHBOR, deque_backend="staged"), {}),
    "global-partition": (ptasks.FibWorkload(n=16, cutoff=12, max_leaf_cost=96), 16,
                         dict(strategy=pst.Strategy.GLOBAL, hop_ticks=1), "partition"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_traced_card_run_equals_cpu(case):
    _need_card()
    wl, W, fields, extra = CASES[case]
    mesh = ptopo.MeshTopology.square(W)
    kw = {"linkstate": _partition(mesh)} if extra == "partition" else {}
    cfg = psim.SimConfig(capacity=64, max_ticks=100_000, trace=TC, **fields)
    card = psim.simulate(wl, mesh, cfg, **kw)
    cpu = psim.simulate(wl, mesh, cfg, device="cpu", **kw)
    _assert_same_result(cpu, card, case)
    assert card.trace.dropped == 0 and card.trace.emitted > 0
    if extra == "partition":
        assert len(card.trace.of_kind(ptr.EV_NO_LIVE_VICTIM)) > 0


def test_traced_sweep_on_card_equals_cpu():
    _need_card()
    wl, mesh = ptasks.FibWorkload(n=24, cutoff=12), ptopo.MeshTopology.square(64)
    cfg = psim.SimConfig(capacity=64, max_ticks=100_000, trace=TC)
    pts = [psim.SimParams(strategy=pst.strategy_code(s), hop_ticks=tau, seed=seed)
           for s, tau, seed in (("neighbor", 5, 0), ("global", 2, 1), ("adaptive", 5, 2))]
    card = psim.simulate_sweep(wl, mesh, cfg, pts)
    cpu = psim.simulate_sweep(wl, mesh, cfg, pts, device="cpu")
    for i, (a, b) in enumerate(zip(cpu, card)):
        _assert_same_result(a, b, f"point {i}")


def test_captured_loop_writes_the_ring_in_place(monkeypatch):
    """The captured iteration's commit skips the ring (and the time series):
    both are written in place, each point masked by its own flag."""
    _need_card()
    seen = []
    same = psim._same_storage

    def spy(a, b):
        out = same(a, b)
        if out and a.dim() == 3 and a.shape[1:] == (TC.ring_capacity + 1, ptr.NUM_LANES):
            seen.append("ring")
        if out and a.dim() == 3 and a.shape[1:] == (TC.bins, ptr.NUM_CHANNELS):
            seen.append("ts")
        return out

    monkeypatch.setattr(psim, "_same_storage", spy)
    wl, mesh = ptasks.FibWorkload(n=20, cutoff=9), ptopo.MeshTopology.square(16)
    cfg = psim.SimConfig(capacity=64, trace=TC)
    r = psim.simulate_batch(wl, mesh, cfg, seeds=(0, 1))
    assert "ring" in seen and "ts" in seen
    monkeypatch.undo()
    for seed, got in zip((0, 1), r):
        _assert_same_result(psim.simulate(wl, mesh, dataclasses.replace(cfg, seed=seed),
                                          device="cpu"), got, f"seed {seed}")
