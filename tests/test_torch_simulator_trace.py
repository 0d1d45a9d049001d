"""Port parity of the traced simulator (ROADMAP Queue 1 item 11):
`repro_torch.simulate` with `SimConfig(trace=TraceConfig(...))` on the CPU
against the live reference on tests/test_tracing.py's fixtures (EQ_FIB on
EQ_MESH, the dynamic schedule with its outage epoch, eclipse death and speed
epochs, the `TC` recorder shape), every `SimResult` field equal with no
tolerance: the event ring elementwise, `emitted`, `dropped`, the time series,
`sojourn` and `events`. NEIGHBOR, GLOBAL and ADAPTIVE in leap mode, both
deque backends, tick mode, a static mesh (NEIGHBOR's round trip exactly 2τ,
the attempt-latency histogram the reference's), a 16-row ring (drops
counted, the first rows verbatim, the time series unaffected) and a
`simulate_batch` with a ring per seed. One reference run a scenario,
shared through a module-scoped cache."""

import dataclasses

import numpy as np
import pytest
import torch
from test_simulator import EQ_FIB, EQ_MESH, _dynamic_schedule
from torch_parity import assert_results_equal, port_simulate
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import simulator as rsim
from repro.core import stealing as rst
from repro.core import tracing as rtr
from repro_torch import convert
from repro_torch.core import simulator as psim
from repro_torch.core import stealing as pst
from repro_torch.core import tracing as ptr

TC = rtr.TraceConfig(ring_capacity=8192, bins=128, bin_ticks=32)
SMALL = rtr.TraceConfig(ring_capacity=16, bins=TC.bins, bin_ticks=TC.bin_ticks)
STRATEGIES = [rst.Strategy.NEIGHBOR, rst.Strategy.GLOBAL, rst.Strategy.ADAPTIVE]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(strategy, trace=TC, dynamic=True, **kw):
    """tests/test_tracing.py's `_run` configuration: the dynamic schedule
    under pre-shed with an 8-tick warning, or a static mesh."""
    return rsim.SimConfig(strategy=strategy, capacity=128, max_ticks=200_000,
                          preshed=dynamic, warn_ticks=8 if dynamic else 0, trace=trace, **kw)


def _sched(dynamic=True):
    if not dynamic:
        return {}
    ls, ft = _dynamic_schedule()
    return {"linkstate": ls, "fail_time": ft}


_REFS: dict = {}


def reference(key, cfg, dynamic=True):
    """The reference's run of `cfg`, once per module."""
    if key not in _REFS:
        _REFS[key] = rsim.simulate(EQ_FIB, EQ_MESH, cfg, **_sched(dynamic))
    return _REFS[key]


@pytest.mark.parametrize("strategy", STRATEGIES, ids=[s.value for s in STRATEGIES])
def test_leap_trace_matches_reference(strategy):
    """Leap mode, famine batch 64, loop backend: the ring, the time series
    and every other field equal the reference's; the ring decomposes the
    counters (every attempt an attempt-kind event, no drop)."""
    ref = reference(strategy.value, _cfg(strategy))
    got = port_simulate(EQ_FIB, EQ_MESH, _cfg(strategy), _sched())
    assert_results_equal(ref, got)
    tr = got.trace
    assert tr.dropped == 0 and tr.emitted == len(tr.events) > 0
    assert len(tr.of_kind(*ptr.ATTEMPT_KINDS)) == got.attempts
    assert len(tr.of_kind(ptr.EV_GRANTED)) == got.successes
    assert len(tr.of_kind(ptr.EV_DEATH)) == 1 and len(tr.of_kind(ptr.EV_EPOCH)) > 0
    assert got.sojourn is None  # closed system: no completed request


@pytest.mark.parametrize("strategy", [rst.Strategy.NEIGHBOR, rst.Strategy.ADAPTIVE],
                         ids=["neighbor", "adaptive"])
def test_staged_backend_trace_matches_reference(strategy):
    """The staged deque backend (`deque_apply`'s plain version on the CPU)
    records the same trace as the reference, `events` included."""
    ref = reference(strategy.value, _cfg(strategy))
    got = port_simulate(EQ_FIB, EQ_MESH, _cfg(strategy), _sched(), deque_backend="staged")
    assert_results_equal(ref, got)


def test_tick_mode_trace_matches_reference():
    """Tick mode records the reference's (leap-mode) ring and time series:
    leap ≡ tick; `events` there counts ticks."""
    ref = reference("global", _cfg(rst.Strategy.GLOBAL))
    got = port_simulate(EQ_FIB, EQ_MESH, _cfg(rst.Strategy.GLOBAL), _sched(),
                        step_mode="tick", deque_backend="staged")
    assert_results_equal(ref, got, skip=("events",))
    assert got.events == got.ticks


def test_static_neighbor_round_trip_and_histogram():
    """A static mesh at τ = 5: the run equals the reference's, every resolved
    NEIGHBOR attempt prices exactly 2τ over one hop, and the port's
    attempt-latency histogram and Chrome-trace document of the run equal the
    reference's."""
    cfg = _cfg(rst.Strategy.NEIGHBOR, dynamic=False, hop_ticks=5)
    ref = reference("static", cfg, dynamic=False)
    got = port_simulate(EQ_FIB, EQ_MESH, cfg)
    assert_results_equal(ref, got)
    res = got.trace.of_kind(*ptr.RESOLVED_ATTEMPT_KINDS)
    assert len(res) > 0 and (res[:, ptr.LANE_RTT] == 10).all()
    assert (res[:, ptr.LANE_HOPS] == 1).all()
    kw = dict(num_workers=EQ_MESH.num_workers, tau=5.0)
    h = ptr.attempt_latency_hist(got.trace, strategy=pst.Strategy.NEIGHBOR, **kw)
    assert h == rtr.attempt_latency_hist(ref.trace, strategy=rst.Strategy.NEIGHBOR, **kw)
    assert h["measured_mean_rtt"] == h["analytic_rtt"] == 10.0
    assert ptr.to_chrome_trace(got.trace, mesh_rows=EQ_MESH.rows, mesh_cols=EQ_MESH.cols,
                               timeseries=got.timeseries) == rtr.to_chrome_trace(
        ref.trace, mesh_rows=EQ_MESH.rows, mesh_cols=EQ_MESH.cols, timeseries=ref.timeseries)


def test_overflowing_ring_counts_drops():
    """A 16-row ring: equal to the reference's run at that size; against the
    port's own full ring, the first 16 rows verbatim, every event counted in
    `emitted` and the rest in `dropped`, the time series unaffected."""
    strategy = rst.Strategy.NEIGHBOR
    ref = reference("small", _cfg(strategy, trace=SMALL))
    got = port_simulate(EQ_FIB, EQ_MESH, _cfg(strategy, trace=SMALL), _sched())
    assert_results_equal(ref, got)
    big = port_simulate(EQ_FIB, EQ_MESH, _cfg(strategy), _sched())
    assert got.trace.dropped == big.trace.emitted - 16 > 0
    assert got.trace.emitted == big.trace.emitted and len(got.trace.events) == 16
    np.testing.assert_array_equal(got.trace.events, big.trace.events[:16])
    np.testing.assert_array_equal(got.timeseries.data, big.timeseries.data)
    assert_results_equal(big, got, skip=("trace",))


def test_trace_config_type_is_checked():
    """The port takes its own `TraceConfig` (or a dict of its fields through
    `convert.sim_config`); anything else is refused before a run."""
    from repro_torch.core import tasks as ptasks
    from repro_torch.core import topology as ptopo

    wl, mesh = ptasks.FibWorkload(n=10, cutoff=5), ptopo.MeshTopology.square(4)
    with pytest.raises(TypeError, match="TraceConfig"):
        psim.simulate(wl, mesh, psim.SimConfig(capacity=16, trace=object()), device="cpu")
    with pytest.raises(ValueError, match="ring_capacity"):
        psim.simulate(wl, mesh, psim.SimConfig(
            capacity=16, trace=ptr.TraceConfig(ring_capacity=0)), device="cpu")
    r = port_simulate(EQ_FIB, EQ_MESH, dataclasses.replace(
        _cfg(rst.Strategy.NEIGHBOR, dynamic=False), max_ticks=40))
    assert isinstance(r.trace, ptr.Trace) and isinstance(r.timeseries, ptr.TimeSeries)
    assert r.ticks == 40 and r.timeseries.data.shape == (TC.bins, ptr.NUM_CHANNELS)


def test_batch_rings_are_per_seed():
    """tests/test_tracing.py::test_batch_traces_are_per_seed: three seeds in
    one grid, each point's ring, bins and fields the reference's
    `simulate_batch`'s, and the seed-1 point its own traced `simulate`."""
    tc = rtr.TraceConfig(ring_capacity=2048, bins=32, bin_ticks=32)
    cfg = rsim.SimConfig(strategy=rst.Strategy.NEIGHBOR, capacity=64, max_ticks=50_000,
                         trace=tc)
    refs = rsim.simulate_batch(EQ_FIB, EQ_MESH, cfg, seeds=[0, 1, 2])
    wl = convert.workload("FibWorkload", dataclasses.asdict(EQ_FIB))
    mesh = convert.mesh(EQ_MESH.num_workers, EQ_MESH.rows, EQ_MESH.cols, EQ_MESH.torus)
    got = psim.simulate_batch(wl, mesh, convert.sim_config(dataclasses.asdict(cfg)),
                              seeds=[0, 1, 2], device="cpu")
    for r, g in zip(refs, got):
        assert_results_equal(r, g)
        assert len(g.trace.of_kind(*ptr.ATTEMPT_KINDS)) == g.attempts
    one = port_simulate(EQ_FIB, EQ_MESH, cfg, seed=1)
    assert_results_equal(one, got[1])
    assert not np.array_equal(got[0].trace.events[:50], got[1].trace.events[:50])
