"""Port parity of the traced famine replay and the traced grid (ROADMAP
Queue 1 item 11): `repro_torch`'s famine fast path has no per-tick loop, so
it builds a window's events from each worker's rounds and orders them as
the reference's replayed ticks emit them. On the CPU against the live
reference, every `SimResult` field with `events` and the ring elementwise:

  * tests/test_tracing.py's famine regime (`_famine_linkstate(5)`, worker 5
    dying at tick 70) at famine batch 0, 7 and 64, NEIGHBOR and ADAPTIVE;
  * GLOBAL across a partition at batch 64, whose unreachable draws the
    replay re-emits as EV_NO_LIVE_VICTIM;
  * a TC rollback, whose discarded timeline the ring keeps;
  * a mixed `simulate_sweep` under the dynamic schedule, a ring per point;
  * with `trace=None` no function of `repro_torch.core.tracing` is called,
    and the traced ring is written in place (never through the loop's
    masked select)."""

import dataclasses

import numpy as np
import pytest
import torch
from test_simulator import EQ_FIB, EQ_MESH, FAMINE_WL, _dynamic_schedule, _famine_linkstate
from test_torch_simulator_linkstate_grid import _partition
from torch_parity import assert_results_equal, port_linkstate, port_simulate
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import simulator as rsim
from repro.core import stealing as rst
from repro.core import tracing as rtr
from repro_torch import convert
from repro_torch.core import simulator as psim
from repro_torch.core import tracing as ptr

TC = rtr.TraceConfig(ring_capacity=8192, bins=128, bin_ticks=32)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


FAMINE_CASES = [(s, fb) for s in (rst.Strategy.NEIGHBOR, rst.Strategy.ADAPTIVE)
                for fb in (0, 7, 64)]


@pytest.mark.parametrize("strategy,fb", FAMINE_CASES,
                         ids=[f"{s.value}-fb{fb}" for s, fb in FAMINE_CASES])
def test_famine_regime_trace(strategy, fb):
    """tests/test_tracing.py::test_trace_equality_famine_fast_path: epoch
    flips and a death mid-famine; the port at famine batch `fb` (the staged
    backend at 7) equals the reference at that batch, ring and `events`
    included, and at 64 the replay collapses iterations."""
    ft = -np.ones(EQ_MESH.num_workers, np.int32)
    ft[5] = 70
    sched = {"fail_time": ft, "linkstate": _famine_linkstate(5)}
    cfg = rsim.SimConfig(strategy=strategy, capacity=64, max_ticks=100_000,
                         famine_batch=fb, trace=TC)
    ref = rsim.simulate(FAMINE_WL, EQ_MESH, cfg, **sched)
    got = port_simulate(FAMINE_WL, EQ_MESH, cfg, sched,
                        deque_backend="staged" if fb == 7 else "loop")
    assert_results_equal(ref, got)
    if fb == 64:
        assert got.events < got.ticks // 2


@pytest.mark.parametrize("tau,routing", [(1, "dense"), (5, "sparse")])
def test_partition_no_live_events_from_the_replay(tau, routing):
    """GLOBAL on a 4x4 mesh whose corner is cut off for a while, at famine
    batch 64: thieves draw across the cut in famine windows, and the closed
    form replays those draws as EV_NO_LIVE_VICTIM events between the
    resolutions, in the reference's order (some of the run's NO_LIVE events
    come out of the replay: counted at its appends, which pass ranks)."""
    mesh, ls = _partition(tau)
    cfg = rsim.SimConfig(strategy=rst.Strategy.GLOBAL, capacity=64, max_ticks=100_000,
                         trace=TC)
    sched = {"linkstate": ls, "routing_backend": routing}
    ref = rsim.simulate(FAMINE_WL, mesh, cfg, **sched)
    calls = []
    append = ptr.append

    def counting(ev, n, capacity, mask, rows, rank=None):
        if rank is not None:  # the famine window's append (ranks given)
            calls.append(int((rows[..., ptr.LANE_KIND][mask]
                              == ptr.EV_NO_LIVE_VICTIM).sum()))
        return append(ev, n, capacity, mask, rows, rank)

    ptr.append = counting
    try:
        got = port_simulate(FAMINE_WL, mesh, cfg, sched)
    finally:
        ptr.append = append
    assert_results_equal(ref, got)
    no_live = len(got.trace.of_kind(ptr.EV_NO_LIVE_VICTIM))
    assert 0 < sum(calls) <= no_live
    assert got.events < got.ticks


def test_tc_rollback_keeps_the_discarded_timeline():
    """Two deaths under TC (checkpoint every 40): the ring is not rolled back
    (more attempt events than the final `attempts`), while the time series'
    deltas, negative at a rollback, still sum to the counters; both
    backends equal the reference."""
    ft = -np.ones(EQ_MESH.num_workers, np.int32)
    ft[2], ft[5] = 70, 150
    cfg = rsim.SimConfig(strategy=rst.Strategy.NEIGHBOR, capacity=128, max_ticks=200_000,
                         recovery=rsim.Recovery.TC, ckpt_interval=40, trace=TC)
    ref = rsim.simulate(EQ_FIB, EQ_MESH, cfg, fail_time=ft)
    for backend in ("loop", "staged"):
        got = port_simulate(EQ_FIB, EQ_MESH, cfg, {"fail_time": ft}, deque_backend=backend)
        assert_results_equal(ref, got)
    assert len(got.trace.of_kind(*ptr.ATTEMPT_KINDS)) > got.attempts
    assert got.timeseries.channel(ptr.CH_ATTEMPTS).sum() == got.attempts
    assert got.timeseries.channel(ptr.CH_BUSY).sum() == got.busy_ticks


def _port_cfg(cfg):
    return convert.sim_config(dataclasses.asdict(cfg))


def _port_args(mesh, wl):
    return (convert.workload(type(wl).__name__, dataclasses.asdict(wl)),
            convert.mesh(mesh.num_workers, mesh.rows, mesh.cols, mesh.torus))


def test_sweep_rings_are_per_point():
    """A mixed grid (strategy, τ, seed, escalation) under the dynamic schedule
    with its death, traced: every point equals the reference's vmapped
    `simulate_sweep` point, ring and `events` included."""
    ls, ft = _dynamic_schedule()
    cfg = rsim.SimConfig(capacity=128, max_ticks=200_000, preshed=True, warn_ticks=8,
                         trace=TC)
    pts = [rsim.SimParams(strategy=rst.strategy_code(s), hop_ticks=tau, seed=seed,
                          escalate_after=esc, warn_ticks=8)
           for s, tau, seed, esc in ((rst.Strategy.GLOBAL, 5, 0, 4),
                                     (rst.Strategy.NEIGHBOR, 5, 1, 4),
                                     (rst.Strategy.ADAPTIVE, 5, 2, 2),
                                     (rst.Strategy.NEIGHBOR, 5, 3, 4))]
    refs = rsim.simulate_sweep(EQ_FIB, EQ_MESH, cfg, pts, fail_time=ft, linkstate=ls)
    wl, mesh = _port_args(EQ_MESH, EQ_FIB)
    got = psim.simulate_sweep(wl, mesh, _port_cfg(cfg),
                              [psim.SimParams(*(int(x) for x in p)) for p in pts],
                              fail_time=ft, linkstate=port_linkstate(ls), device="cpu")
    for r, g in zip(refs, got):
        assert_results_equal(r, g)
    assert len({g.trace.emitted for g in got}) > 1


def test_trace_none_calls_no_tracing_function(monkeypatch):
    """tests/test_tracing.py::test_trace_none_is_statically_branched_out:
    with `trace=None` the simulator calls no function of
    `repro_torch.core.tracing` — every one, and every class, is made to
    raise — and the results are those of a run before the patch (a death,
    pre-shed, link epochs and the famine path: every branch the traced run
    takes)."""
    ls, ft = _dynamic_schedule()
    cfg = _port_cfg(rsim.SimConfig(strategy=rst.Strategy.ADAPTIVE, capacity=128,
                                   max_ticks=200_000, preshed=True, warn_ticks=8))
    wl, mesh = _port_args(EQ_MESH, EQ_FIB)
    kw = dict(fail_time=ft, linkstate=port_linkstate(ls), device="cpu")
    before = psim.simulate(wl, mesh, cfg, **kw)
    names = [n for n, f in vars(ptr).items()
             if callable(f) and getattr(f, "__module__", None) == ptr.__name__]
    assert {"init", "append", "emit", "Block", "ts_add", "ts_add_row", "TraceState",
            "next_bin_boundary", "finalize", "sojourn_stats"} <= set(names)
    for name in names:
        monkeypatch.setattr(ptr, name, lambda *a, _n=name, **k: pytest.fail(
            f"tracing.{_n} reached with trace=None"))
    after = psim.simulate(wl, mesh, cfg, **kw)
    assert_results_equal(before, after)
    assert after.trace is None and after.timeseries is None and after.sojourn is None


def test_ring_is_written_in_place(monkeypatch):
    """The ring is written in place at the running points: when one point of
    a grid has stopped and another runs on, the loop's masked select finds
    the ring's new value sharing the old one's storage and skips it (no
    (G, capacity + 1, 7) `where` an iteration); the stopped point's ring
    stays as its own run left it."""
    cfg = _port_cfg(rsim.SimConfig(strategy=rst.Strategy.NEIGHBOR, capacity=64,
                                   max_ticks=50_000, trace=TC))
    wl, mesh = _port_args(EQ_MESH, EQ_FIB)
    shared = []
    same = psim._same_storage

    def spy(a, b):
        out = same(a, b)
        if out and a.dim() == 3 and a.shape[1:] == (TC.ring_capacity + 1, ptr.NUM_LANES):
            shared.append(tuple(a.shape))
        return out

    monkeypatch.setattr(psim, "_same_storage", spy)
    got = psim.simulate_batch(wl, mesh, cfg, seeds=[0, 1], device="cpu")
    assert got[0].ticks != got[1].ticks and shared
    monkeypatch.undo()
    for seed, r in zip((0, 1), got):
        assert_results_equal(psim.simulate(wl, mesh, dataclasses.replace(cfg, seed=seed),
                                           device="cpu"), r)
