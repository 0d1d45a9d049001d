"""Open-loop arrivals on a CUDA card against the port's own CPU path (`gpu`
tests; each skips where torch sees no card, deciding inside the test). No
JAX here: tests/test_arrivals.py's four scenarios are written out in the
port's terms.

  * `f32math.log_f32` on the card equals the CPU bit for bit on 2^22
    sampled u in (0, 1], and `arrivals.gap_ticks` on 2^20 candidates at
    five mean gaps;
  * each scenario (Poisson, bursts, a Zipf hot spot at batch 8, a rate
    flip inside famine windows; FIB n=12 on 16 workers, traced) and a TC
    rollback with the stream on, run on the card (the loop captured as a
    CUDA graph, host syncs made errors), equals its CPU run in every field,
    the event ring elementwise; the staged backend's `deque_apply` and the
    loop backend's `steal_compact` launch in those runs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import arrivals as parr
from repro_torch.core import simulator as psim
from repro_torch.core import tasks as ptasks
from repro_torch.core import topology as ptopo
from repro_torch.core import tracing as ptr
from repro_torch.core.f32math import log_f32

pytestmark = pytest.mark.gpu

MESH = ptopo.MeshTopology.square(16)
WL = ptasks.FibWorkload(n=12, cutoff=6, max_leaf_cost=8)
TRC = ptr.TraceConfig(ring_capacity=1 << 13)
# tests/test_arrivals.py's ARRIVAL_SCENARIOS: (shape, gap_q8, config fields)
SCENARIOS = {
    "poisson": (parr.ArrivalConfig(task_cost=7), 5 * 256, dict(seed=3)),
    "bursty": (parr.ArrivalConfig(task_cost=5, num_stations=6, on_ticks=40,
                                  off_ticks=160), 2 * 256, dict(seed=3)),
    "zipf_hot": (parr.ArrivalConfig(task_cost=9, num_stations=2, zipf_s=2.0), 256,
                 dict(seed=3, arrival_batch=8)),
    "rate_flip_midfamine": (
        parr.ArrivalConfig(task_cost=5, num_stations=3, zipf_s=1.5,
                           rate_starts=(0, 400, 800), rate_scale=(1.0, 0.05, 1.0)),
        30 * 256, dict(seed=5)),
}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _assert_same_result(a, b, what):
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


def test_log_and_gaps_card_equals_cpu():
    _need_card()
    gen = torch.Generator().manual_seed(0)
    h = torch.randint(0, 2**32, (1 << 22,), generator=gen, dtype=torch.int64)
    u = (h.to(torch.float32) + 1.0) * 2.0**-32
    assert torch.equal(log_f32(u.cuda()).cpu().view(torch.int32),
                       log_f32(u).view(torch.int32))
    k = torch.arange(1 << 20, dtype=torch.int32)
    for seed in (0, 3):
        aseed = parr.stream_seed(torch.tensor(seed))
        for g in (8, 256, 1280, 7680, 12345):
            gap = torch.tensor(g, dtype=torch.int32)
            assert torch.equal(parr.gap_ticks(aseed.cuda(), k.cuda(), gap.cuda()).cpu(),
                               parr.gap_ticks(aseed, k, gap)), (seed, g)


@pytest.mark.parametrize("backend", ["loop", "staged"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_card_equals_cpu(name, backend):
    _need_card()
    from repro_torch.kernels import ops

    acfg, gap, kw = SCENARIOS[name]
    cfg = psim.SimConfig(arrival_gap_q8=gap, max_ticks=1200, capacity=1024, trace=TRC,
                         deque_backend=backend, **kw)
    cpu = psim.simulate(WL, MESH, cfg, arrivals=acfg, device="cpu")
    ops.reset_launch_counts()
    card = psim.simulate(WL, MESH, cfg, arrivals=acfg)
    kernel = "deque_apply" if backend == "staged" else "steal_compact"
    assert ops.LAUNCHES[kernel] > 0
    _assert_same_result(cpu, card, f"{name} {backend}")
    assert card.arrivals_injected > 0


def test_tc_rollback_card_equals_cpu():
    """Deaths at 70 and 150 under TC with snapshots every 30 on 9 workers,
    staged (the push log after the snapshot cut holds the arrival lanes too)."""
    _need_card()
    mesh = ptopo.MeshTopology.square(9)
    wl = ptasks.FibWorkload(n=14, cutoff=7, max_leaf_cost=8)
    ft = -np.ones(9, np.int32)
    ft[2], ft[5] = 70, 150
    cfg = psim.SimConfig(seed=2, arrival_gap_q8=4 * 256, max_ticks=1000,
                         recovery=psim.Recovery.TC, ckpt_interval=30, trace=TRC,
                         deque_backend="staged")
    acfg = parr.ArrivalConfig(task_cost=6, num_stations=3)
    cpu = psim.simulate(wl, mesh, cfg, arrivals=acfg, fail_time=ft, device="cpu")
    card = psim.simulate(wl, mesh, cfg, arrivals=acfg, fail_time=ft)
    _assert_same_result(cpu, card, "tc")
    tick = psim.simulate(wl, mesh, dataclasses.replace(cfg, step_mode="tick"),
                         arrivals=acfg, fail_time=ft)
    _assert_same_result(cpu, tick._replace(events=cpu.events), "tc tick")
