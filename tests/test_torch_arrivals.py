"""Port parity: `repro_torch.core.arrivals` against `repro.core.arrivals` —
the station weights and device tables, the candidate stream (seeds, gaps,
thinning, stations) over grids of candidates and ticks, the host replay of
the stream, load and gap conversion, and the validation messages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same, np_rng
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import arrivals as rarr
from repro.core import constellation as rcon
from repro.core import topology as rtopo
from repro_torch import convert
from repro_torch.core import arrivals as parr

CONFIGS = {
    "poisson": rarr.ArrivalConfig(task_cost=7),
    "bursty": rarr.ArrivalConfig(task_cost=5, num_stations=6, on_ticks=40,
                                 off_ticks=160),
    "zipf_hot": rarr.ArrivalConfig(task_cost=9, num_stations=2, zipf_s=2.0),
    "rate_flip": rarr.ArrivalConfig(task_cost=5, num_stations=3, zipf_s=1.5,
                                    rate_starts=(0, 400, 800),
                                    rate_scale=(1.0, 0.05, 1.0)),
    "stations_64": rarr.ArrivalConfig(task_cost=512, num_stations=64, zipf_s=1.0,
                                      station_seed=0),
}


def _port(acfg):
    return convert.arrival_config(dataclasses.asdict(acfg))


def _same_tables(r, p):
    assert r._fields == p._fields
    for f in r._fields:
        assert_same(getattr(r, f), getattr(p, f), f)


def test_constants():
    for name in ("ARRIVAL_K", "RATE_ONE", "_SALT_SEED", "_SALT_GAP",
                 "_SALT_ACCEPT", "_SALT_STATION"):
        assert getattr(rarr, name) == getattr(parr, name), name


@pytest.mark.parametrize("name,W", [(n, W) for W in (16, 100, 4096) for n in CONFIGS
                                    if CONFIGS[n].num_stations <= W])
def test_station_weights_and_tables(name, W):
    acfg = CONFIGS[name]
    assert_same(rarr.station_weights(acfg, W), parr.station_weights(_port(acfg), W))
    mesh = rtopo.MeshTopology.square(W)
    _same_tables(rarr.device_tables(acfg, mesh), parr.device_tables(_port(acfg), mesh))


def test_traffic_schedule_tables():
    """A constellation's diurnal rate schedule as the arrivals' thinning."""
    con = rcon.Constellation(rcon.ConstellationConfig(planes=4, sats_per_plane=4,
                                                      orbit_ticks=1000))
    starts, scale = con.traffic_schedule(2500, peak=1.0, trough=0.2)
    acfg = rarr.ArrivalConfig(task_cost=3, rate_starts=starts, rate_scale=scale)
    mesh = rtopo.MeshTopology.square(16)
    _same_tables(rarr.device_tables(acfg, mesh), parr.device_tables(_port(acfg), mesh))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stream_over_candidates(name):
    """Every stream function over 2^14 candidates, each at a tick of the
    rate schedule's and the burst window's edges and at random ticks, for
    several run seeds."""
    acfg = CONFIGS[name]
    mesh = rtopo.MeshTopology.square(100)
    rt, pt = rarr.device_tables(acfg, mesh), parr.device_tables(_port(acfg), mesh)
    rs = np_rng(3)
    k = np.arange(1 << 14, dtype=np.int32)
    edges = np.array([0, 1, 39, 40, 199, 200, 399, 400, 401, 799, 800, 2**29], np.int64)
    ticks = np.concatenate([edges, rs.integers(0, 5000, k.size - edges.size)])
    for seed in (0, 3, 7, 2**31 - 1):
        r_seed = rarr.stream_seed(jnp.int32(seed) if seed < 2**31 else seed)
        p_seed = parr.stream_seed(torch.tensor(seed))
        assert int(r_seed) == int(p_seed)
        kj, kt = jnp.asarray(k), torch.from_numpy(k)
        tj, tt = jnp.asarray(ticks, jnp.int32), torch.from_numpy(ticks.astype(np.int32))
        for g in (1, 256, 1280, 30 * 256):
            assert_same(rarr.gap_ticks(r_seed, kj, jnp.int32(g)),
                        parr.gap_ticks(p_seed, kt, torch.tensor(g)), f"gap {g}")
        # the reference's epoch lookup takes one tick: map it over the pairs
        r_acc = jax.vmap(lambda k1, t1: rarr.accepted(rt, r_seed, k1, t1))(kj, tj)
        assert_same(r_acc, parr.accepted(pt, p_seed, kt, tt), "accepted")
        assert_same(rarr.station_of(rt, r_seed, kj), parr.station_of(pt, p_seed, kt),
                    "station")


def test_stream_per_point_columns():
    """The simulator's shapes: a (G, 1) column of seeds and cursors, with
    per-point gaps and ticks, equals each point's scalars."""
    acfg = CONFIGS["rate_flip"]
    mesh = rtopo.MeshTopology.square(16)
    rt, pt = rarr.device_tables(acfg, mesh), parr.device_tables(_port(acfg), mesh)
    seeds = torch.tensor([[0], [5], [9]])
    aseed = parr.stream_seed(seeds)
    k = torch.tensor([[0], [17], [400]], dtype=torch.int32)
    t = torch.tensor([[3], [401], [799]], dtype=torch.int32)
    gap = torch.tensor([[256], [7680], [12345]], dtype=torch.int32)
    got = (parr.gap_ticks(aseed, k, gap), parr.accepted(pt, aseed, k, t),
           parr.station_of(pt, aseed, k))
    for g in range(3):
        rs_ = rarr.stream_seed(jnp.int32(int(seeds[g, 0])))
        want = (rarr.gap_ticks(rs_, jnp.int32(int(k[g, 0])), jnp.int32(int(gap[g, 0]))),
                rarr.accepted(rt, rs_, jnp.int32(int(k[g, 0])), jnp.int32(int(t[g, 0]))),
                rarr.station_of(rt, rs_, jnp.int32(int(k[g, 0]))))
        for w, x in zip(want, got):
            assert x.shape == (3, 1)
            assert int(w) == int(x[g, 0])


@pytest.mark.parametrize("name,seed,gap,ticks", [
    ("bursty", 13, 3 * 256, 900), ("rate_flip", 5, 30 * 256, 1500),
    ("poisson", 0, 12345, 20000), ("zipf_hot", 3, 7680, 20000)])
def test_host_arrival_schedule(name, seed, gap, ticks):
    acfg = CONFIGS[name]
    mesh = rtopo.MeshTopology.square(16)
    want = rarr.host_arrival_schedule(seed, gap, rarr.device_tables(acfg, mesh), ticks)
    got = parr.host_arrival_schedule(seed, gap, parr.device_tables(_port(acfg), mesh),
                                     ticks, block=97)
    for w, g, what in zip(want, got, ("ticks", "stations", "accepted")):
        assert w.dtype == g.dtype, what
        assert_same(w, g, what)
    assert want[0].size > 0


def test_gap_load_conversion():
    for load in (0.01, 0.2, 0.5, 0.8, 1.0, 4.0, 6.4, 0.8 * 4096 / 512):
        for batch in (1, 4, 8):
            assert rarr.gap_q8_for_load(load, batch) == parr.gap_q8_for_load(load, batch)
    for g in (0, 1, 320, 512, 1280):
        for batch in (1, 8):
            assert rarr.offered_load(g, batch) == parr.offered_load(g, batch)
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError, match="positive"):
            parr.gap_q8_for_load(bad)


BAD_CONFIGS = [
    dict(task_cost=0), dict(num_stations=-1), dict(zipf_s=-0.5),
    dict(on_ticks=-1), dict(off_ticks=5),
    dict(rate_starts=(0, 10, 10), rate_scale=(1, 1, 1)),
    dict(rate_starts=(5,), rate_scale=(1,)),
    dict(rate_starts=(0,), rate_scale=()),
    dict(rate_starts=(0,), rate_scale=(1.5,)),
]


@pytest.mark.parametrize("fields", BAD_CONFIGS, ids=lambda f: ",".join(f))
def test_validation_messages(fields):
    with pytest.raises(ValueError) as want:
        rarr.ArrivalConfig(**fields).validate()
    with pytest.raises(ValueError) as got:
        parr.ArrivalConfig(**fields).validate()
    assert str(want.value) == str(got.value)


def test_table_refusals():
    """Too many stations, and a total weight past int32, as the reference."""
    for mod in (rarr, parr):
        with pytest.raises(ValueError, match="exceeds num_workers 16"):
            mod.station_weights(mod.ArrivalConfig(num_stations=17), 16)
    big = rtopo.MeshTopology.square(65536)
    with pytest.raises(ValueError, match="below 2\\*\\*31"):
        rarr.device_tables(rarr.ArrivalConfig(), big)
    with pytest.raises(ValueError, match="below 2\\*\\*31"):
        parr.device_tables(parr.ArrivalConfig(), big)
