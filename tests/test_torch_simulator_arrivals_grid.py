"""Port parity of open-loop arrivals beyond the scenarios
(test_torch_simulator_arrivals.py): the staged deque backend with the
famine path off, an offered-load sweep (`simulate_sweep` over
`arrival_gap_q8`, a closed point among them) on the staged backend,
`simulate_batch`, TC rollback keeping the stream's cursor (loop and staged,
tick and leap), records dropped at a dead station and at a tiny capacity,
the famine window clipped at the next candidate, and the ARRIVAL events
against the host replay of the stream — every `SimResult` field against the
live reference, `events` and the ring included."""

import dataclasses

import numpy as np
import pytest
import torch
from test_arrivals import MESH, TRC, WL
from test_torch_simulator_arrivals import scenario_cfg
from torch_parity import assert_results_equal, port_simulate
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import arrivals as rarr
from repro.core import simulator as rsim
from repro.core import stealing as rst
from repro.core import tasks as rtasks
from repro.core import topology as rtopo
from repro_torch import convert
from repro_torch.core import arrivals as parr
from repro_torch.core import simulator as psim
from repro_torch.core import tracing as ptr


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_world(wl=WL, mesh=MESH):
    return (convert.workload(type(wl).__name__, dataclasses.asdict(wl)),
            convert.mesh(mesh.num_workers, mesh.rows, mesh.cols, mesh.torus))


def _port_acfg(acfg):
    return convert.arrival_config(dataclasses.asdict(acfg))


def test_staged_famine_off():
    """The hot spot (drops, overflow in the push log's arrival lanes) on the
    staged backend with the famine path off."""
    acfg, cfg = scenario_cfg("zipf_hot", "leap", max_ticks=600, deque_backend="staged",
                             famine_batch=0)
    ref = rsim.simulate(WL, MESH, cfg, arrivals=acfg)
    got = port_simulate(WL, MESH, cfg, {"arrivals": acfg})
    assert_results_equal(ref, got)
    assert got.arrivals_dropped > 0


def test_load_sweep_equals_reference():
    """tests/test_arrivals.py's offered-load sweep (and a closed point, gap
    0: tables built, no candidate) as one staged grid, traced, against the
    reference's sweep, in one core call, with the tables prebuilt."""
    acfg = rarr.ArrivalConfig(task_cost=5, num_stations=4)
    base = rsim.SimConfig(seed=7, max_ticks=500, deque_backend="staged", trace=TRC)
    scfg, p0 = base.split()
    pts = [p0._replace(arrival_gap_q8=g) for g in (256, 0, 4096)]
    refs = rsim.simulate_sweep(WL, MESH, scfg, pts, arrivals=acfg)
    pcfg = convert.sim_config(dataclasses.asdict(base))
    pwl, pmesh = _port_world()
    before = psim.core_count()
    got = psim.simulate_sweep(pwl, pmesh, pcfg.static, [
        pcfg.params._replace(arrival_gap_q8=p.arrival_gap_q8) for p in pts],
        arrivals=parr.device_tables(_port_acfg(acfg), pmesh), device="cpu")
    assert psim.core_count() - before == 1
    for r, g in zip(refs, got):
        assert_results_equal(r, g)
    assert got[1].arrivals_injected == 0 and got[1].requests_done == 0
    assert got[0].arrivals_injected > got[2].arrivals_injected > 0


def test_batch_equals_reference():
    """`simulate_batch` over seeds with the bursty stream: each seed's
    stream from its own seed."""
    acfg, cfg = scenario_cfg("bursty", "leap", max_ticks=300)
    refs = rsim.simulate_batch(WL, MESH, cfg, seeds=(1, 2), arrivals=acfg)
    pwl, pmesh = _port_world()
    got = psim.simulate_batch(pwl, pmesh, convert.sim_config(dataclasses.asdict(cfg)),
                              seeds=(1, 2), arrivals=_port_acfg(acfg), device="cpu")
    for r, g in zip(refs, got):
        assert_results_equal(r, g)
    assert got[0].arrivals_injected != got[1].arrivals_injected


TC_MESH = rtopo.MeshTopology.square(9)
TC_WL = rtasks.FibWorkload(n=14, cutoff=7, max_leaf_cost=8)


@pytest.mark.parametrize("mode,backend", [("tick", "loop"), ("leap", "staged")])
def test_tc_rollback_keeps_cursor(mode, backend):
    """tests/test_arrivals.py's TC run, cut at 400 ticks: deaths at 70 and
    150, snapshots every 30; the cursor and the ledger survive each
    rollback."""
    acfg = rarr.ArrivalConfig(task_cost=6, num_stations=3)
    ft = -np.ones(9, np.int32)
    ft[2], ft[5] = 70, 150
    cfg = rsim.SimConfig(seed=2, strategy=rst.Strategy.NEIGHBOR, step_mode=mode,
                         arrival_gap_q8=4 * 256, max_ticks=400,
                         recovery=rsim.Recovery.TC, ckpt_interval=30, trace=TRC,
                         deque_backend=backend)
    ref = rsim.simulate(TC_WL, TC_MESH, cfg, arrivals=acfg, fail_time=ft)
    got = port_simulate(TC_WL, TC_MESH, cfg, {"arrivals": acfg, "fail_time": ft})
    assert_results_equal(ref, got)
    assert got.arrivals_injected > 0 and got.ckpt_bytes > 0


def test_dead_station_drops():
    """A candidate accepted at a dead station is dropped and counted."""
    acfg = rarr.ArrivalConfig(task_cost=4, num_stations=1)
    w = int(np.argmax(rarr.station_weights(acfg, MESH.num_workers)))
    ft = -np.ones(MESH.num_workers, np.int32)
    ft[w] = 1
    cfg = rsim.SimConfig(seed=3, arrival_gap_q8=2 * 256, max_ticks=400, trace=TRC)
    ref = rsim.simulate(WL, MESH, cfg, arrivals=acfg, fail_time=ft)
    got = port_simulate(WL, MESH, cfg, {"arrivals": acfg, "fail_time": ft})
    assert_results_equal(ref, got)
    assert got.arrivals_dropped > 0 and got.arrivals_injected <= 1


def test_tiny_capacity_drops():
    """Records past a 16-slot deque overflow: injected + dropped accounts
    for every accepted record."""
    acfg = rarr.ArrivalConfig(task_cost=16, num_stations=1)
    cfg = rsim.SimConfig(seed=3, arrival_gap_q8=256, arrival_batch=8, capacity=16,
                         max_ticks=600, trace=TRC)
    ref = rsim.simulate(WL, MESH, cfg, arrivals=acfg)
    got = port_simulate(WL, MESH, cfg, {"arrivals": acfg})
    assert_results_equal(ref, got)
    assert got.arrivals_dropped > 0 and got.requests_done <= got.arrivals_injected


def test_famine_clips_at_next_arrival():
    """A sparse stream over a drained system: famine windows end at each
    candidate, `events` the reference's (far fewer than the ticks)."""
    acfg = rarr.ArrivalConfig(task_cost=4, num_stations=1)
    cfg = rsim.SimConfig(seed=9, arrival_gap_q8=200 * 256, max_ticks=4000, trace=TRC)
    ref = rsim.simulate(WL, MESH, cfg, arrivals=acfg)
    got = port_simulate(WL, MESH, cfg, {"arrivals": acfg})
    assert_results_equal(ref, got)
    assert got.arrivals_injected >= 3 and got.events < got.ticks // 4


def test_arrival_events_match_host_replay():
    """The ARRIVAL events' ticks and stations are the accepted candidates of
    the port's host replay of the stream."""
    acfg = parr.ArrivalConfig(task_cost=5, num_stations=3, zipf_s=1.0, on_ticks=50,
                              off_ticks=70)
    pwl, pmesh = _port_world()
    cfg = psim.SimConfig(seed=13, arrival_gap_q8=3 * 256, max_ticks=900,
                         trace=ptr.TraceConfig(ring_capacity=1 << 13))
    r = psim.simulate(pwl, pmesh, cfg, arrivals=acfg, device="cpu")
    assert r.trace.dropped == 0
    ticks, stations, acc = parr.host_arrival_schedule(
        13, 3 * 256, parr.device_tables(acfg, pmesh), r.ticks)
    arr = r.trace.of_kind(ptr.EV_ARRIVAL)
    assert [(int(e[ptr.LANE_TICK]), int(e[ptr.LANE_WORKER])) for e in arr] == [
        (int(t), int(s)) for t, s, a in zip(ticks, stations, acc) if a]
