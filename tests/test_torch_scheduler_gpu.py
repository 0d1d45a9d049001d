"""The round executor on a CUDA card against the port's own CPU path
(`gpu` tests; each skips where torch sees no card, deciding inside the
test). No JAX here.

  * a mixed (strategy × seed) grid at W = 100 on the card equals the CPU
    grid in every `RunResult` field, through one core call, with
    `steal_compact` launched on the path;
  * the card's loop is the captured one (`_replay_loop`, host syncs made
    errors around its warm-up and replays), not the eager loop;
  * a `link_up` snapshot and a `max_rounds` cut, card == CPU.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import scheduler as psch
from repro_torch.core import stealing as pst
from repro_torch.core import tasks as ptasks
from repro_torch.core import topology as ptopo
from repro_torch.kernels import ops

pytestmark = pytest.mark.gpu

WL = ptasks.FibWorkload(n=24, cutoff=10, max_leaf_cost=8)
MESH = ptopo.MeshTopology.square(100)
CFG = psch.SchedulerConfig(capacity=256, max_rounds=100_000)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _same(a, b, what):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        same = (np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y)
        assert same, f"{what}: {f} {x!r} vs {y!r}"


def test_mixed_grid_card_equals_cpu(monkeypatch):
    _need_card()
    loops, captured = [], psch._replay_loop

    def replay(body, carry, max_ticks):
        loops.append(max_ticks)
        return captured(body, carry, max_ticks)

    monkeypatch.setattr(psch, "_replay_loop", replay)
    monkeypatch.setattr(psch, "_eager_loop", None)  # the card never runs it
    pts = [CFG.params._replace(strategy=c, seed=s) for c in range(4) for s in (0, 1)]
    ops.reset_launch_counts()
    before = psch.run_trace_count()
    card = psch.run_sweep(WL, MESH, CFG, pts)
    assert psch.run_trace_count() - before == 1 and loops == [CFG.max_rounds]
    assert ops.LAUNCHES["steal_compact"] > 0
    monkeypatch.undo()
    cpu = psch.run_sweep(WL, MESH, CFG, pts, device="cpu")
    for p, a, b in zip(pts, card, cpu):
        _same(a, b, f"point {p}")
        assert a.result == WL.expected_result() and a.overflow == 0


def test_loop_raises_on_host_sync():
    """A host sync inside the captured round raises: the executor's
    iteration never waits for the host."""
    _need_card()

    def body(carry):
        state, _, rounds, live = carry
        bool(live.any())  # a device-to-host read
        return (state, (), rounds + 1, live), live

    carry = (torch.zeros((1, 4), device="cuda"), (),
             torch.zeros((1, 1), dtype=torch.int32, device="cuda"),
             torch.ones((1, 1), dtype=torch.bool, device="cuda"))
    with pytest.raises(RuntimeError):
        psch._replay_loop(body, carry, 10)


@pytest.mark.parametrize("what", ["link_up", "max_rounds"])
def test_snapshot_and_cut_card_equals_cpu(what):
    _need_card()
    if what == "link_up":
        up = np.random.default_rng(0).random((100, 4)) < 0.7
        cfg, kw = CFG, dict(link_up=up)
    else:
        cfg = psch.SchedulerConfig(strategy=pst.Strategy.ADAPTIVE, capacity=256,
                                   max_rounds=41)
        kw = {}
    ops.reset_launch_counts()
    card = psch.run_vectorized(WL, MESH, cfg, **kw)
    assert ops.LAUNCHES["steal_compact"] > 0
    _same(card, psch.run_vectorized(WL, MESH, cfg, device="cpu", **kw), what)
