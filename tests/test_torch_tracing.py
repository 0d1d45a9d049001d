"""Port parity of the flight recorder's module (`repro_torch.core.tracing`,
ROADMAP Queue 1 item 11) against the reference's `repro.core.tracing`, on
rings made with numpy from a seed: the schema, `TraceConfig.validate`, the
device-side appends (`emit` / `emit_raw` / `emit1` and the simulator's
`Block` on a grid of points, writes past capacity counted), `ts_add` and the bin horizon, and
the host views (`finalize`, `Trace`, `TimeSeries`, the Chrome-trace export
under strict JSON, the attempt-latency histogram, the sojourn ledger)."""

import json

import numpy as np
import pytest
import torch
from torch_parity import assert_same, np_rng, to_jax, to_torch
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import stealing as rst
from repro.core import tracing as rtr
from repro_torch.core import jsonio as pjsonio
from repro_torch.core import stealing as pst
from repro_torch.core import tracing as ptr

W, CAP = 9, 24


def _ring(seed: int, n: int, kinds=None, W: int = 16):
    """A (n, NUM_LANES) int32 ring of plausible events: nondecreasing ticks,
    kinds drawn from `kinds` (default: every kind), workers, victims, hops,
    round trips and epochs."""
    rs = np_rng(seed)
    kinds = np.arange(rtr.NUM_KINDS) if kinds is None else np.asarray(kinds)
    ev = np.stack([np.sort(rs.integers(0, 500, n)), rs.choice(kinds, n),
                   rs.integers(-1, W, n), rs.integers(-1, W, n), rs.integers(0, 8, n),
                   rs.integers(0, 60, n), rs.integers(0, 4, n)], 1)
    return ev.astype(np.int32)


def _state(mod, ev, emitted, ts):
    return mod.TraceState(ev=ev, n=np.int32(emitted), req_ticks=None, ts=ts, famine=None)


def test_schema_is_the_references():
    for name in ("NUM_KINDS", "KIND_NAMES", "RESOLVED_ATTEMPT_KINDS", "ATTEMPT_KINDS",
                 "NUM_LANES", "NUM_CHANNELS", "CHANNEL_NAMES"):
        assert getattr(ptr, name) == getattr(rtr, name), name
    for mod_name in dir(rtr):
        if mod_name.startswith(("EV_", "LANE_", "CH_")):
            assert getattr(ptr, mod_name) == getattr(rtr, mod_name), mod_name


@pytest.mark.parametrize("kw", [dict(ring_capacity=0), dict(bins=0), dict(bin_ticks=-1),
                                dict(ring_capacity=-3, bins=2), {}, dict(bins=1, bin_ticks=1)])
def test_validate_matches_reference(kw):
    """`TraceConfig.validate` refuses what the reference refuses, with the
    same message, and returns the config otherwise."""
    try:
        want = rtr.TraceConfig(**kw).validate()
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            ptr.TraceConfig(**kw).validate()
    else:
        got = ptr.TraceConfig(**kw).validate()
        assert (got.ring_capacity, got.bins, got.bin_ticks) == (
            want.ring_capacity, want.bins, want.bin_ticks)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_emit_matches_reference_per_point(seed):
    """A sequence of appends with random masks on a grid of G = 3 points,
    crossing the ring's capacity, equals the reference's `emit_raw` /
    `emit1` run point by point: the written rows, and `n` counting the
    dropped ones. The port's last row (the dump row) is never compared."""
    rs = np_rng(seed)
    G = 3
    ev = torch.full((G, CAP + 1, ptr.NUM_LANES), -1, dtype=torch.int32)
    n = torch.zeros((G, 1), dtype=torch.int32)
    refs = [(to_jax(np.full((CAP, rtr.NUM_LANES), -1)), to_jax(0)) for _ in range(G)]
    for step in range(12):
        mask = rs.random((G, W)) < 0.6
        tick = rs.integers(0, 100, (G, 1))
        victim = rs.integers(-1, W, (G, W))
        rtt = rs.integers(0, 40, (G, W))
        epoch = rs.integers(0, 3, (G, 1))
        kind = int(rs.integers(0, ptr.NUM_KINDS))
        if step % 3 == 2:  # a single global event per point
            pred = rs.random((G, 1)) < 0.6
            n = ptr.emit1(ptr.TraceState(ev, n, None, None, None), ptr.TraceConfig(CAP),
                          to_torch(pred, torch.bool), tick=to_torch(tick), kind=kind,
                          epoch=to_torch(epoch)).n
            for g in range(G):
                e_, n_ = refs[g]
                st = rtr.TraceState(e_, n_, None, None, None)
                st = rtr.emit1(st, rtr.TraceConfig(CAP), bool(pred[g, 0]), tick=int(tick[g, 0]),
                               kind=kind, epoch=int(epoch[g, 0]))
                refs[g] = (st.ev, st.n)
            continue
        ev, n = ptr.emit_raw(ev, n, CAP, to_torch(mask, torch.bool), tick=to_torch(tick),
                             kind=kind, worker=torch.arange(W), victim=to_torch(victim),
                             hops=3, rtt=to_torch(rtt), epoch=to_torch(epoch))
        for g in range(G):
            e_, n_ = refs[g]
            refs[g] = rtr.emit_raw(e_, n_, CAP, to_jax(mask[g], bool), tick=int(tick[g, 0]),
                                   kind=kind, worker=np.arange(W), victim=victim[g],
                                   hops=3, rtt=rtt[g], epoch=int(epoch[g, 0]))
    assert int(n.max()) > CAP  # some point wrote past its capacity
    for g in range(G):
        assert_same(refs[g][0], ev[g, :CAP], f"ring of point {g}")
        assert int(refs[g][1]) == int(n[g, 0])


def test_block_is_sequential_emits():
    """A `Block` append (constant lanes written once, the rest set each
    time) equals its groups emitted one after the other (the reference's
    sequence of `emit` calls), masked per point by `run`, twice in a row on
    the same block."""
    rs = np_rng(7)
    G, cfg = 4, ptr.TraceConfig(ring_capacity=40)
    blk = ptr.Block(G, [(W, {ptr.LANE_KIND: 1, ptr.LANE_WORKER: torch.arange(W)}),
                        (1, {ptr.LANE_KIND: ptr.EV_EPOCH, ptr.LANE_WORKER: -1,
                             ptr.LANE_VICTIM: -1}),
                        (W, {ptr.LANE_WORKER: torch.arange(W), ptr.LANE_VICTIM: -1})],
                    torch.device("cpu"))
    one = ptr.init(cfg, W, torch.zeros((G, 1), dtype=torch.bool))
    seq = ptr.init(cfg, W, torch.zeros((G, 1), dtype=torch.bool))
    for _ in range(2):
        masks = [rs.random((G, W)) < 0.5, rs.random((G, 1)) < 0.5, rs.random((G, W)) < 0.3]
        run = rs.random((G, 1)) < 0.75
        victim, rtt = to_torch(rs.integers(0, W, (G, W))), to_torch(rs.integers(0, 9, (G, W)))
        kind, hops = to_torch(rs.integers(1, 4, (G, W))), to_torch(rs.integers(0, 5, (G, W)))
        tick, epoch = to_torch(rs.integers(0, 50, (G, 1))), to_torch(rs.integers(0, 3, (G, 1)))
        blk.set(ptr.LANE_TICK, tick)
        blk.set(ptr.LANE_EPOCH, epoch)
        blk.set(ptr.LANE_VICTIM, victim, 0)
        blk.set(ptr.LANE_RTT, rtt, 0)
        blk.set(ptr.LANE_KIND, kind.view(G, 1, W), 2, shape=(1, W))
        blk.set(ptr.LANE_HOPS, hops, 2)
        one = blk.append(one, cfg, [to_torch(m, torch.bool) for m in masks],
                         run=to_torch(run, torch.bool))
        for m, kw in zip(masks, [dict(kind=1, worker=torch.arange(W), victim=victim, rtt=rtt),
                                 dict(kind=ptr.EV_EPOCH, worker=-1, victim=-1),
                                 dict(kind=kind, worker=torch.arange(W), victim=-1,
                                      hops=hops)]):
            seq = ptr.emit(seq, cfg, to_torch(m & run, torch.bool), tick=tick, epoch=epoch,
                           **kw)
    assert_same(one.n, seq.n)
    assert_same(one.ev[:, :cfg.ring_capacity], seq.ev[:, :cfg.ring_capacity])


def test_ts_add_and_bin_boundary_match_reference():
    """`ts_add` into each point's bin (ticks past the last bin clamp into it;
    points whose `run` flag is clear add nothing) and `next_bin_boundary`
    equal the reference's, point by point."""
    rs = np_rng(3)
    cfg_p, cfg_r = ptr.TraceConfig(bins=5, bin_ticks=7), rtr.TraceConfig(bins=5, bin_ticks=7)
    G = 3
    tr = ptr.init(cfg_p, W, torch.zeros((G, 1), dtype=torch.bool))
    refs = [rtr.init(cfg_r, W, False) for _ in range(G)]
    for _ in range(12):
        t = rs.integers(0, 60, (G, 1))
        vals = rs.integers(-50, 400, (6, G, 1))
        run = rs.random((G, 1)) < 0.8
        tr = ptr.ts_add(tr, cfg_p, to_torch(t), busy=to_torch(vals[0]),
                        queue=to_torch(vals[1], torch.int64), inflight=to_torch(vals[2]),
                        attempts=to_torch(vals[3]), successes=int(vals[4, 0, 0]),
                        alive=to_torch(vals[5]), run=to_torch(run, torch.bool))
        for g in range(G):
            if run[g, 0]:
                refs[g] = rtr.ts_add(refs[g], cfg_r, int(t[g, 0]), busy=int(vals[0, g, 0]),
                                     queue=int(vals[1, g, 0]), inflight=int(vals[2, g, 0]),
                                     attempts=int(vals[3, g, 0]),
                                     successes=int(vals[4, 0, 0]), alive=int(vals[5, g, 0]))
    for g in range(G):
        assert_same(refs[g].ts, tr.ts[g], f"time series of point {g}")
    t = np.arange(0, 45).reshape(-1, 1)
    assert_same(rtr.next_bin_boundary(cfg_r, to_jax(t), 1 << 30),
                ptr.next_bin_boundary(cfg_p, to_torch(t), 1 << 30))


@pytest.mark.parametrize("emitted", [0, 11, CAP, CAP + 9])
def test_finalize_and_views_match_reference(emitted):
    """`finalize` of the same ring and bins (written prefix, `dropped`), and
    the views `Trace.counts` / `of_kind` / `lane` and `TimeSeries.channel` /
    `busy_fraction` / `mean_queue_depth`, equal the reference's. The port's
    ring carries its dump row, which `finalize` never reads."""
    ring = _ring(emitted, CAP)
    ts = np_rng(emitted).integers(0, 90, (6, rtr.NUM_CHANNELS)).astype(np.int32)
    ts[2, rtr.CH_ALIVE] = 0
    dump = np.concatenate([ring, np.full((1, rtr.NUM_LANES), 77, np.int32)])
    rt, rts = rtr.finalize(_state(rtr, ring, emitted, ts), rtr.TraceConfig(CAP, 6, 5))
    pt, pts = ptr.finalize(_state(ptr, dump, emitted, ts), ptr.TraceConfig(CAP, 6, 5))
    assert (pt.emitted, pt.dropped, pt.ring_capacity) == (rt.emitted, rt.dropped,
                                                          rt.ring_capacity)
    assert_same(rt.events, pt.events)
    assert pt.counts() == rt.counts()
    for kinds in ((rtr.EV_GRANTED,), rtr.ATTEMPT_KINDS, (rtr.EV_DEATH, rtr.EV_EPOCH)):
        assert_same(rt.of_kind(*kinds), pt.of_kind(*kinds))
    assert_same(rt.lane(rtr.LANE_RTT), pt.lane(ptr.LANE_RTT))
    assert pts.bin_ticks == rts.bin_ticks and pts.data.dtype == rts.data.dtype
    assert_same(rts.data, pts.data)
    assert_same(rts.channel(rtr.CH_QUEUE), pts.channel(ptr.CH_QUEUE))
    assert_same(rts.busy_fraction(), pts.busy_fraction())
    assert_same(rts.mean_queue_depth(), pts.mean_queue_depth())


@pytest.mark.parametrize("with_ts", [False, True])
def test_chrome_trace_matches_reference_and_parses_strictly(with_ts, tmp_path):
    """`to_chrome_trace` of the same ring equals the reference's document
    (epoch spans, lifecycle instants, steal spans, counters), and the file
    `write_chrome_trace` writes parses under `jsonio.load_strict`."""
    ring = _ring(11, 60)
    ts = np_rng(12).integers(0, 50, (4, rtr.NUM_CHANNELS)).astype(np.int32)
    rt, rts = rtr.finalize(_state(rtr, ring, 60, ts), rtr.TraceConfig(60, 4, 16))
    pt, pts = ptr.finalize(_state(ptr, ring, 60, ts), ptr.TraceConfig(60, 4, 16))
    kw = dict(mesh_rows=4, mesh_cols=4, row_block=2, tick_us=2.5)
    want = rtr.to_chrome_trace(rt, timeseries=rts if with_ts else None, **kw)
    got = ptr.to_chrome_trace(pt, timeseries=pts if with_ts else None, **kw)
    assert got == want
    path = tmp_path / "trace.perfetto.json"
    ptr.write_chrome_trace(str(path), pt, timeseries=pts if with_ts else None, **kw)
    assert pjsonio.load_strict(path) == json.loads(json.dumps(want))


@pytest.mark.parametrize("case", ["mixed", "none_granted", "empty"])
@pytest.mark.parametrize("strategy", ["neighbor", "global"])
def test_attempt_latency_hist_matches_reference(case, strategy, tmp_path):
    """The measured RTT histogram against the analytic round trip equals the
    reference's: resolved attempts of every kind, none granted (p = 0: the
    expected times to a task are null, not inf) and no resolved attempt."""
    kinds = {"mixed": None, "none_granted": (rtr.EV_EMPTY_VICTIM, rtr.EV_SEVERED_DENIAL,
                                             rtr.EV_PENDING, rtr.EV_DEATH),
             "empty": (rtr.EV_PENDING, rtr.EV_EPOCH)}[case]
    ring = _ring(5, 80, kinds)
    rt, _ = rtr.finalize(_state(rtr, ring, 80, np.zeros((1, 6), np.int32)),
                         rtr.TraceConfig(80, 1, 1))
    pt, _ = ptr.finalize(_state(ptr, ring, 80, np.zeros((1, 6), np.int32)),
                         ptr.TraceConfig(80, 1, 1))
    kw = dict(num_workers=64, tau=5, bins=12)
    want = rtr.attempt_latency_hist(rt, strategy=rst.Strategy(strategy), **kw)
    got = ptr.attempt_latency_hist(pt, strategy=pst.Strategy(strategy), **kw)
    assert got == want
    assert ptr.analytic_round_trip(pst.Strategy(strategy), 64, 5.0) == \
        rtr.analytic_round_trip(rst.Strategy(strategy), 64, 5.0)
    if case == "none_granted":
        assert got["p_success"] == 0 and got["measured_expected_time_to_task"] is None
    path = tmp_path / "hist.json"
    ptr.write_attempt_latency_hist(str(path), pt, strategy=pst.Strategy(strategy), **kw)
    assert pjsonio.load_strict(path) == json.loads(json.dumps(want))


@pytest.mark.parametrize("n_soj", [0, 1, 7, 1000])
def test_sojourn_stats_matches_reference(n_soj):
    """Nearest-rank sojourn percentiles of the SOJOURN rows of a ring (none:
    None) equal the reference's."""
    ring = _ring(n_soj, 1200, (rtr.EV_GRANTED, rtr.EV_ARRIVAL))
    rows = np_rng(n_soj + 1).choice(1200, n_soj, replace=False)
    ring[rows, rtr.LANE_KIND] = rtr.EV_SOJOURN
    rt, _ = rtr.finalize(_state(rtr, ring, 1200, np.zeros((1, 6), np.int32)),
                         rtr.TraceConfig(1200, 1, 1))
    pt, _ = ptr.finalize(_state(ptr, ring, 1200, np.zeros((1, 6), np.int32)),
                         ptr.TraceConfig(1200, 1, 1))
    assert ptr.sojourn_stats(pt) == rtr.sojourn_stats(rt)
    assert (ptr.sojourn_stats(pt) is None) == (n_soj == 0)
