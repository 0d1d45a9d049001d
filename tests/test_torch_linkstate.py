"""Port parity of the link-state model (ROADMAP Queue 1 item 10):
`repro_torch.core.linkstate`, topology's routing patches and detour oracle,
and the link-aware parts of `repro_torch.core.stealing`, against
`repro.core.linkstate` / `topology` / `stealing` on the same numpy inputs.
The host side (schedules, validation, table builds and their stats) must be
equal array for array, with scipy and with the pure-numpy fallback; the
device side (epoch index, next change, least τ, flight prices, components)
equal on random pairs, with a scalar epoch and with per-point (G, 1) epochs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, assert_same, np_rng, to_jax, to_torch
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import constellation as rcon
from repro.core import linkstate as rls
from repro.core import stealing as rst
from repro.core import topology as rtopo
from repro_torch import convert
from repro_torch.core import linkstate as pls
from repro_torch.core import rng
from repro_torch.core import stealing as pst
from repro_torch.core import topology as ptopo


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _meshes(rows, cols, torus):
    return rtopo.MeshTopology.grid(rows, cols, torus), ptopo.MeshTopology.grid(rows, cols, torus)


def _down(up, mesh, a, b):
    nbr = mesh.neighbor_table
    for d in range(4):
        if nbr[a, d] == b:
            up[a, d] = False
            up[b, rls.OPPOSITE[d]] = False


def _mixed(mesh, uniform_tau=False):
    """tests/test_linkstate_sparse.py's 3-epoch schedule: a clean epoch,
    scattered outages, an isolated corner; oscillating inter-row τ."""
    W = mesh.num_workers
    E = 3
    tau = np.full((E, W, 4), 3, np.int32)
    if not uniform_tau:
        rows = mesh.coords[:, 0]
        for e in range(E):
            tau[e, :, rls.SOUTH] = 3 + (rows + e) % 3
            tau[e, :, rls.NORTH] = 3 + ((rows - 1) % mesh.rows + e) % 3
    up = np.ones((E, W, 4), bool)
    for a, b in [(9, 10), (17, 25), (35, 36), (0, 8)]:
        _down(up[1], mesh, a, b)
    for d in range(4):
        v = mesh.neighbor_table[W - 1, d]
        if v >= 0:
            _down(up[2], mesh, W - 1, v)
    return np.asarray([0, 40, 90], np.int32), tau, up, np.ones((E, W), np.int32)


def _orbit_quick(horizon=1200):
    from repro.configs import paper_mesh
    con = rcon.Constellation(paper_mesh.CONFIG.orbit_quick)
    ls = con.schedule(horizon).linkstate
    return con.mesh, (ls.epoch_starts, ls.link_tau, ls.link_up, ls.speed)


def _pair(mesh_r, arrays):
    ref = rls.LinkStateSchedule(*(np.array(a) for a in arrays)).validate(mesh_r)
    port = convert.linkstate_schedule(*arrays)
    return ref, port


SCHEDULES = {
    "mixed_torus": lambda: (_meshes(8, 8, True), _mixed),
    "mixed_grid": lambda: (_meshes(8, 8, False), _mixed),
    "orbit_quick": lambda: None,
}


def _schedule(name):
    if name == "orbit_quick":
        mesh_r, arrays = _orbit_quick()
        mesh_p = ptopo.MeshTopology.grid(mesh_r.rows, mesh_r.cols, mesh_r.torus)
        return mesh_r, mesh_p, _pair(mesh_r, arrays)
    (mesh_r, mesh_p), make = SCHEDULES[name]()
    return mesh_r, mesh_p, _pair(mesh_r, make(mesh_r))


_BUILDS = {}


def _built(name, routing, patch):
    """Both packages' tables and stats of a schedule, built once a module."""
    key = (name, routing, patch)
    if key not in _BUILDS:
        mesh_r, mesh_p, (sr, sp) = _schedule(name)
        ra, rs = rls.build_tables(sr, mesh_r, routing=routing, patch=patch)
        pa, ps = pls.build_tables(sp, mesh_p, routing=routing, patch=patch,
                                  device="cpu")
        _BUILDS[key] = (mesh_r, mesh_p, ra, rs, pa, ps)
    return _BUILDS[key]


BUILD_CASES = [(n, r, p) for n in ("mixed_torus", "mixed_grid", "orbit_quick")
               for r, p in (("dense", None), ("sparse", None), ("sparse", (2, 2)))]


def test_routing_policy_and_constants():
    assert pls.SPARSE_AUTO_MIN_WORKERS == rls.SPARSE_AUTO_MIN_WORKERS
    assert int(pls.UNREACHABLE) == int(rls.UNREACHABLE) == int(rtopo.UNREACHABLE)
    assert pls._LM_INF == int(rls._LM_INF)
    assert (pls.NORTH, pls.SOUTH, pls.WEST, pls.EAST, pls.OPPOSITE) == \
        (rls.NORTH, rls.SOUTH, rls.WEST, rls.EAST, rls.OPPOSITE)
    assert ptopo.PATCH_TARGET == rtopo.PATCH_TARGET
    for W in (1, 100, 4095, 4096, 16384):
        for routing in ("auto", "dense", "sparse"):
            assert pls.resolve_routing(routing, W) == rls.resolve_routing(routing, W)
    with pytest.raises(ValueError, match="routing must be"):
        pls.resolve_routing("floyd", 9)


def _bad(mesh_r):
    """Schedules the reference's `validate` refuses, by name."""
    W = mesh_r.num_workers
    ok = (np.asarray([0, 5], np.int32), np.full((2, W, 4), 2, np.int32),
          np.ones((2, W, 4), bool), np.ones((2, W), np.int32))
    asym_tau = ok[1].copy()
    asym_tau[0, 0, rls.EAST] = 3
    asym_up = ok[2].copy()
    asym_up[1, 0, rls.SOUTH] = False
    return {
        "empty": (np.zeros(0, np.int32), ok[1][:0], ok[2][:0], ok[3][:0]),
        "not_zero": (np.asarray([1, 5], np.int32),) + ok[1:],
        "not_increasing": (np.asarray([0, 0], np.int32),) + ok[1:],
        "tau_shape": (ok[0], ok[1][:, :, :3], ok[2], ok[3]),
        "up_shape": (ok[0], ok[1], ok[2][:, :-1], ok[3]),
        "speed_shape": (ok[0], ok[1], ok[2], ok[3][:, :-1]),
        "tau_zero": (ok[0], ok[1] * 0, ok[2], ok[3]),
        "speed_zero": (ok[0], ok[1], ok[2], ok[3] * 0),
        "asym_tau": (ok[0], asym_tau, ok[2], ok[3]),
        "asym_up": (ok[0], ok[1], asym_up, ok[3]),
    }


@pytest.mark.parametrize("case", list(_bad(rtopo.MeshTopology.grid(3, 3))))
def test_validate_refuses_what_the_reference_refuses(case):
    mesh_r, mesh_p = _meshes(3, 3, True)
    arrays = _bad(mesh_r)[case]
    with pytest.raises(ValueError) as want:
        rls.LinkStateSchedule(*arrays).validate(mesh_r)
    with pytest.raises(ValueError) as got:
        convert.linkstate_schedule(*arrays).validate(mesh_p)
    assert str(got.value) == str(want.value)


def test_static_schedule_and_host_queries():
    mesh_r, mesh_p = _meshes(4, 5, True)
    speed = np_rng(1).integers(1, 4, 20).astype(np.int32)
    for sp in (None, speed):
        ref = rls.LinkStateSchedule.static(mesh_r, 4, speed=sp)
        port = pls.LinkStateSchedule.static(mesh_p, 4, speed=sp)
        for f in ("epoch_starts", "link_tau", "link_up", "speed"):
            assert_same(getattr(ref, f), getattr(port, f), f)
    _, _, (ref, port) = _schedule("orbit_quick")
    mesh_r, mesh_p = _schedule("orbit_quick")[:2]
    assert ref.num_epochs == port.num_epochs
    for t in (0, 1, 49, 50, 51, 599, 1199, 5000):
        assert ref.epoch_of(t) == port.epoch_of(t)
        assert_same(ref.tau_at(t), port.tau_at(t))
        assert_same(ref.up_at(t), port.up_at(t))
        assert_same(ref.speed_at(t), port.speed_at(t))
    for h in (1, 600, 1200, 4000):
        assert ref.mean_tau(mesh_r, h) == port.mean_tau(mesh_p, h)


@pytest.mark.parametrize("name,routing,patch", BUILD_CASES,
                         ids=[f"{n}-{r}-{p}" for n, r, p in BUILD_CASES])
def test_build_tables_equal_reference(name, routing, patch):
    mesh_r, mesh_p, ra, rs, pa, ps = _built(name, routing, patch)
    assert ra._fields == pa._fields
    for f in ra._fields:
        a, b = getattr(ra, f), getattr(pa, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert b.device.type == "cpu"
            np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                          b.numpy().astype(np.int64), err_msg=f)
    want, got = dataclasses.asdict(rs), dataclasses.asdict(ps)
    want.pop("build_seconds")
    got.pop("build_seconds")
    assert got == want
    assert pls.table_bytes(pa) == rls.table_bytes(ra)
    assert pls.has_outage_tables(pa) == rls.has_outage_tables(ra)
    assert pls.resident_bytes(pa) >= pls.table_bytes(pa)
    # `device_tables` is the build without its report
    again = pls.device_tables(convert.linkstate_schedule(
        *(np.asarray(getattr(ra, f)) for f in ("epoch_starts", "link_tau",
                                               "link_up", "speed"))),
        mesh_p, routing=routing, patch=patch, device="cpu")
    for a, b in zip(pa, again):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def test_build_refuses_ragged_mesh_and_defaults_to_cuda():
    mesh_p = ptopo.MeshTopology.square(10)       # 4x3 grid, last row partial
    sched = pls.LinkStateSchedule.static(ptopo.MeshTopology.grid(2, 5), 2)
    with pytest.raises(ValueError, match="fully populated"):
        pls.build_tables(sched, mesh_p, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pls.build_tables(sched, ptopo.MeshTopology.grid(2, 5))


@pytest.mark.parametrize("torus", [False, True])
def test_live_path_costs_against_detour_oracle(torus):
    mesh_r, mesh_p = _meshes(5, 6, torus)
    rs = np_rng(3)
    W = mesh_r.num_workers
    tau = rs.integers(1, 7, (W, 4)).astype(np.int32)
    up = rs.random((W, 4)) > 0.25
    # symmetric: each link takes its lower-id end's entries
    nbr = mesh_r.neighbor_table
    for w in range(W):
        for d in range(4):
            v = nbr[w, d]
            if v > w:
                tau[v, rls.OPPOSITE[d]] = tau[w, d]
                up[v, rls.OPPOSITE[d]] = up[w, d]
    for d in range(4):                               # an isolated corner
        if nbr[W - 1, d] >= 0:
            _down(up, mesh_r, W - 1, nbr[W - 1, d])
    want = rtopo.detour_matrix(mesh_r, tau, up)
    assert_same(want, ptopo.detour_matrix(mesh_p, tau, up), "detour_matrix")
    assert_same(want, pls.live_path_costs(mesh_p, tau, up), "live_path_costs")
    assert_same(rls.live_path_costs(mesh_r, tau, up), pls.live_path_costs(mesh_p, tau, up))
    assert (want >= rtopo.UNREACHABLE).any()    # some pair really is cut off


@pytest.mark.parametrize("scipy", [True, False], ids=["scipy", "numpy"])
def test_components_and_landmarks(monkeypatch, scipy):
    """Both graph routines equal the reference's, with scipy and with the
    pure-numpy fallback (forced off on both sides)."""
    monkeypatch.setattr(pls, "_HAVE_SCIPY", scipy and pls._HAVE_SCIPY)
    monkeypatch.setattr(rls, "_HAVE_SCIPY", scipy and rls._HAVE_SCIPY)
    for name in ("mixed_torus", "mixed_grid", "orbit_quick"):
        mesh_r, mesh_p, (sr, sp) = _schedule(name)
        lm = np.unique(ptopo.patch_centers(mesh_p, *ptopo.patch_dims(mesh_p, 2)))
        lm = np.concatenate([lm, [mesh_p.num_workers - 1]]).astype(np.int32)
        for e in range(sr.num_epochs):
            assert_same(rls.live_components(mesh_r, sr.link_up[e]),
                        pls.live_components(mesh_p, sp.link_up[e]), f"{name} comp {e}")
            assert_same(rls.landmark_costs(mesh_r, sr.link_tau[e], sr.link_up[e], lm),
                        pls.landmark_costs(mesh_p, sp.link_tau[e], sp.link_up[e], lm),
                        f"{name} landmarks {e}")
        assert pls.landmark_costs(mesh_p, sp.link_tau[0], sp.link_up[0],
                                  np.zeros(0, np.int32)).shape == (0, mesh_p.num_workers)
    # a whole sparse build on the fallback too
    mesh_r, mesh_p, (sr, sp) = _schedule("mixed_torus")
    ra, rs_ = rls.build_tables(sr, mesh_r, routing="sparse", patch=(2, 2))
    pa, ps_ = pls.build_tables(sp, mesh_p, routing="sparse", patch=(2, 2), device="cpu")
    assert_same(np.asarray(ra.lm_cost).astype(np.int32), pa.lm_cost)
    assert ps_.stretch_add == rs_.stretch_add


@pytest.mark.parametrize("rows,cols,torus", [(8, 8, True), (5, 7, False), (64, 64, True),
                                             (3, 70, True)])
def test_patches(rows, cols, torus):
    mesh_r, mesh_p = _meshes(rows, cols, torus)
    for target in (1, 2, 3, ptopo.PATCH_TARGET):
        dims = rtopo.patch_dims(mesh_r, target)
        assert ptopo.patch_dims(mesh_p, target) == dims
        pid_r, n_r = rtopo.patch_ids(mesh_r, *dims)
        pid_p, n_p = ptopo.patch_ids(mesh_p, *dims)
        assert n_r == n_p
        assert_same(pid_r, pid_p)
        assert_same(rtopo.patch_centers(mesh_r, *dims), ptopo.patch_centers(mesh_p, *dims))
    with pytest.raises(ValueError):
        ptopo.patch_dims(mesh_p, 0)
    with pytest.raises(ValueError):
        ptopo.patch_ids(mesh_p, rows + 1, 1)


def test_epoch_index_next_change_min_tau():
    mesh_r, mesh_p, ra, _, pa, _ = _built("orbit_quick", "dense", None)
    starts_r = ra.epoch_starts
    ts = np_rng(7).integers(0, 1500, 64).astype(np.int32)
    for t in list(ts[:8]) + [0, int(starts_r[-1]), int(starts_r[-1]) + 1]:
        e = rls.epoch_index(starts_r, jnp.int32(t))
        assert int(pls.epoch_index(pa.epoch_starts, int(t))) == int(e)
        assert int(pls.epoch_index(pa.epoch_starts, torch.tensor(t))) == int(e)
        assert int(pls.next_change(pa.epoch_starts, int(t), 1 << 30)) == \
            int(rls.next_change(starts_r, jnp.int32(t), 1 << 30))
        assert int(pls.min_link_tau(pa, int(e))) == int(rls.min_link_tau(ra, e))
    col = torch.as_tensor(ts)[:, None]                       # per-point (G, 1)
    want = np.asarray([int(rls.epoch_index(starts_r, jnp.int32(t))) for t in ts])
    got = pls.epoch_index(pa.epoch_starts, col)
    assert got.shape == (64, 1) and got.dtype == torch.int32
    assert_same(want[:, None], got)
    want_nc = np.asarray([int(rls.next_change(starts_r, jnp.int32(t), 1 << 30))
                          for t in ts])
    assert_same(want_nc[:, None], pls.next_change(pa.epoch_starts, col, 1 << 30))
    assert_same(np.asarray([int(rls.min_link_tau(ra, int(e))) for e in want])[:, None],
                pls.min_link_tau(pa, got))


FLIGHT_CASES = [(n, r, p) for n in ("mixed_torus", "mixed_grid")
                for r, p in (("dense", None), ("sparse", None), ("sparse", (2, 2)))]


@pytest.mark.parametrize("name,routing,patch", FLIGHT_CASES,
                         ids=[f"{n}-{r}-{p}" for n, r, p in FLIGHT_CASES])
def test_flight_ticks_and_same_component(name, routing, patch):
    """Random pairs (NO_NEIGHBOR and self pairs among them), every epoch as
    an int and as a 0-d tensor, and a grid of per-point epochs ((G, 1)
    beside (G, W) pairs)."""
    mesh_r, mesh_p, ra, _, pa, _ = _built(name, routing, patch)
    W = mesh_r.num_workers
    rs = np_rng(11)
    src = rs.integers(-1, W, W).astype(np.int32)
    dst = rs.integers(-1, W, W).astype(np.int32)
    dst[:8] = src[:8]
    args = (mesh_r.rows, mesh_r.cols, mesh_r.torus_full())
    E = int(ra.epoch_starts.shape[0])
    for e in range(E):
        want = rls.flight_ticks(ra, e, to_jax(src), to_jax(dst), *args)
        for ep in (e, torch.tensor(e)):
            got = pls.flight_ticks(pa, ep, to_torch(src), to_torch(dst), *args)
            assert got.dtype == torch.int32
            assert_same(want, got, f"flight epoch {e}")
            assert_same(rls.same_component(ra, e, to_jax(src), to_jax(dst)),
                        pls.same_component(pa, ep, to_torch(src), to_torch(dst)),
                        f"same_component epoch {e}")
    G = 5
    eg = rs.integers(0, E, (G, 1)).astype(np.int32)
    sg = rs.integers(0, W, (G, W)).astype(np.int32)
    dg = rs.integers(0, W, (G, W)).astype(np.int32)
    want = np.stack([np.asarray(rls.flight_ticks(ra, int(eg[g, 0]), to_jax(sg[g]),
                                                 to_jax(dg[g]), *args)) for g in range(G)])
    assert_same(want, pls.flight_ticks(pa, to_torch(eg), to_torch(sg), to_torch(dg), *args))
    want = np.stack([np.asarray(rls.same_component(ra, int(eg[g, 0]), to_jax(sg[g]),
                                                   to_jax(dg[g]))) for g in range(G)])
    assert_same(want, pls.same_component(pa, to_torch(eg), to_torch(sg), to_torch(dg)))
    # the uniform case prices hops x τ, and without outages every pair is
    # reachable
    static_r = rls.device_tables(rls.LinkStateSchedule.static(mesh_r, 3), mesh_r)
    static_p = pls.device_tables(pls.LinkStateSchedule.static(mesh_p, 3), mesh_p,
                                 device="cpu")
    assert_same(rls.flight_ticks(static_r, 0, to_jax(src), to_jax(dst), *args),
                pls.flight_ticks(static_p, 0, to_torch(src), to_torch(dst), *args))
    assert bool(pls.same_component(static_p, 0, to_torch(src), to_torch(dst)).all())


def _keys(seed):
    return jax.random.PRNGKey(seed), rng.PRNGKey(seed)


def _epoch_tables(ra, pa, mesh_r, e):
    """The reference's link-masked victim tables at epoch e (as the
    simulator builds them), numpy."""
    nbr = mesh_r.neighbor_table
    up = np.asarray(ra.link_up[e])
    masked = np.where(up & (nbr >= 0), nbr, -1).astype(np.int32)
    return masked, np.array(ra.link_tau[e]), np.array(ra.comp[e])


def test_link_aware_stealing_functions():
    """`cheapest_live_table`, `mask_reachable` (one row and per point),
    `choose_adaptive_linkaware`, `probe_may_succeed(_code)` with
    `comp_row`, and the batched draws with `link_tau_row`, against the
    reference on the mixed schedule's epochs."""
    mesh_r, mesh_p, ra, _, pa, _ = _built("mixed_torus", "dense", None)
    W = mesh_r.num_workers
    r2 = rst.radius2_list(mesh_r)
    rs = np_rng(5)
    kj, kt = _keys(3)
    for e in range(3):
        nbr, tau, comp = _epoch_tables(ra, pa, mesh_r, e)
        assert_same(rst.cheapest_live_table(to_jax(nbr), to_jax(tau)),
                    pst.cheapest_live_table(to_torch(nbr), to_torch(tau)), "cheapest")
        r2m_want = rst.mask_reachable(to_jax(r2), to_jax(comp))
        assert_same(r2m_want, pst.mask_reachable(to_torch(r2), to_torch(comp)), "mask")
        r2m = np.array(as_np(r2m_want))
        fails = rs.integers(0, 8, W).astype(np.int32)
        thief = rs.random(W) > 0.3
        for k in range(3):
            kj_t, kt_t = jax.random.fold_in(kj, 17 * e + k), rng.fold_in(kt, 17 * e + k)
            assert_same(rst.choose_adaptive_linkaware(
                kj_t, to_jax(nbr), to_jax(r2m), to_jax(tau), to_jax(fails),
                jnp.asarray(thief), escalate_after=4),
                pst.choose_adaptive_linkaware(
                    kt_t, to_torch(nbr), to_torch(r2m), to_torch(tau), to_torch(fails),
                    torch.as_tensor(thief), escalate_after=4), "adaptive linkaware")
        nonempty = rs.random(W) > 0.85
        kw = dict(escalate_after=4, window=16, min_cycle=5, num_workers=W)
        for s in rst.Strategy:
            want = rst.probe_may_succeed(s, jnp.asarray(nonempty), to_jax(fails),
                                         to_jax(nbr), to_jax(r2m), comp_row=to_jax(comp),
                                         **kw)
            got = pst.probe_may_succeed(pst.Strategy(s.value), torch.as_tensor(nonempty),
                                        to_torch(fails), to_torch(nbr), to_torch(r2m),
                                        comp_row=to_torch(comp), **kw)
            assert_same(want, got, f"probe {s.value}")
            code = rst.strategy_code(s)
            want = rst.probe_may_succeed_code(jnp.int32(code), jnp.asarray(nonempty),
                                              to_jax(fails), to_jax(nbr), to_jax(r2m),
                                              comp_row=to_jax(comp), **kw)
            for c in (code, torch.tensor(code)):
                assert_same(want, pst.probe_may_succeed_code(
                    c, torch.as_tensor(nonempty), to_torch(fails), to_torch(nbr),
                    to_torch(r2m), comp_row=to_torch(comp), **kw), f"probe code {s.value}")
        for s in (rst.Strategy.NEIGHBOR, rst.Strategy.ADAPTIVE, rst.Strategy.GLOBAL):
            wn, wf = rst.batched_victim_draws(s, kj, 40 * e, 6, to_jax(nbr), to_jax(r2m),
                                              num_workers=W, link_tau_row=to_jax(tau))
            gn, gf = pst.batched_victim_draws(pst.Strategy(s.value), kt, 40 * e, 6,
                                              to_torch(nbr), to_torch(r2m), num_workers=W,
                                              link_tau_row=to_torch(tau))
            assert_same(wn, gn, f"draws {s.value} near")
            assert (wf is None) == (gf is None)
            if wf is not None:
                assert_same(wf, gf, f"draws {s.value} far")
            code = rst.strategy_code(s)
            wn, wf = rst.batched_victim_draws_code(jnp.int32(code), kj, 40 * e, 6,
                                                   to_jax(nbr), to_jax(r2m), num_workers=W,
                                                   link_tau_row=to_jax(tau))
            gn, gf = pst.batched_victim_draws_code(torch.tensor(code), kt, 40 * e, 6,
                                                   to_torch(nbr), to_torch(r2m),
                                                   num_workers=W, link_tau_row=to_torch(tau))
            assert_same(wn, gn, f"code draws {s.value} near")
            assert_same(wf, gf, f"code draws {s.value} far")


def test_per_point_tables_map_one_draw():
    """The simulator's form: per-point, per-row victim tables ((G, rows, W,
    D)) mapped through one draw of uniforms equal each point's own draw
    with its own epoch's table; per-point `mask_reachable` and
    `probe_may_succeed` equal the row-by-row calls."""
    mesh_r, mesh_p, ra, _, pa, _ = _built("mixed_torus", "dense", None)
    W = mesh_r.num_workers
    r2 = pst.radius2_list(mesh_p)
    tabs = [_epoch_tables(ra, pa, mesh_r, e) for e in range(3)]
    nbr_e = torch.stack([to_torch(t[0]) for t in tabs])          # (E, W, 4)
    comp_e = torch.stack([to_torch(t[2]) for t in tabs])         # (E, W)
    r2_e = pst.mask_reachable(to_torch(r2).expand(3, -1, -1), comp_e)
    for e in range(3):
        assert torch.equal(r2_e[e], pst.mask_reachable(to_torch(r2), comp_e[e]))
    seeds, t0 = torch.tensor([[4], [9]]), torch.tensor([[30], [77]])
    key = rng.PRNGKey(seeds)
    ep = [(0, 1), (2, 2)]                                        # (row 0, rows 1..)
    rows = torch.stack([torch.cat([nbr_e[a][None], nbr_e[b][None].expand(4, -1, -1)])
                        for a, b in ep])                         # (G, 5, W, 4)
    near, _ = pst.batched_victim_draws(pst.Strategy.NEIGHBOR, key, t0, 5, rows,
                                       None, num_workers=W)
    for g, (a, b) in enumerate(ep):
        kg = rng.PRNGKey(int(seeds[g, 0]))
        want0, _ = pst.batched_victim_draws(pst.Strategy.NEIGHBOR, kg, int(t0[g, 0]), 1,
                                            nbr_e[a], None, num_workers=W)
        want1, _ = pst.batched_victim_draws(pst.Strategy.NEIGHBOR, kg, int(t0[g, 0]) + 1,
                                            4, nbr_e[b], None, num_workers=W)
        assert torch.equal(near[g], torch.cat([want0, want1]))
    # the same rows from a pair of per-point tables (row 0, the rest)
    pair = (nbr_e[[a for a, _ in ep]][:, None], nbr_e[[b for _, b in ep]][:, None])
    near_pair, _ = pst.batched_victim_draws(pst.Strategy.NEIGHBOR, key, t0, 5, pair,
                                            None, num_workers=W)
    assert torch.equal(near, near_pair)
    tau_e = torch.stack([to_torch(t[1]) for t in tabs])
    r2_pair = (r2_e[[a for a, _ in ep]][:, None], r2_e[[b for _, b in ep]][:, None])
    tau_pair = (tau_e[[a for a, _ in ep]][:, None], tau_e[[b for _, b in ep]][:, None])
    an, af = pst.batched_victim_draws(pst.Strategy.ADAPTIVE, key, t0, 5, pair, r2_pair,
                                      num_workers=W, link_tau_row=tau_pair)
    for g, (a, b) in enumerate(ep):
        kg = rng.PRNGKey(int(seeds[g, 0]))
        for lo, n, e in ((0, 1, a), (1, 4, b)):
            wn, wf = pst.batched_victim_draws(pst.Strategy.ADAPTIVE, kg,
                                              int(t0[g, 0]) + lo, n, nbr_e[e], r2_e[e],
                                              num_workers=W, link_tau_row=tau_e[e])
            assert torch.equal(an[g, lo:lo + n], wn)
            assert torch.equal(af[g, lo:lo + n], wf)
    nonempty = torch.as_tensor(np_rng(2).random((2, W)) > 0.8)
    fails = torch.zeros((2, W), dtype=torch.int32)
    e_col = torch.tensor([[1], [2]])
    kw = dict(escalate_after=torch.tensor([[4], [2]]), window=16,
              min_cycle=torch.tensor([[5], [3]]), num_workers=W)
    for s in pst.Strategy:
        got = pst.probe_may_succeed(s, nonempty, fails, nbr_e[e_col[:, 0]],
                                    r2_e[e_col[:, 0]], comp_row=comp_e[e_col[:, 0]], **kw)
        for g in range(2):
            e = int(e_col[g, 0])
            one = pst.probe_may_succeed(
                s, nonempty[g], fails[g], nbr_e[e], r2_e[e], comp_row=comp_e[e],
                escalate_after=int(kw["escalate_after"][g, 0]), window=16,
                min_cycle=int(kw["min_cycle"][g, 0]), num_workers=W)
            assert torch.equal(got[g], one), s


def test_attach_hops():
    mesh_r, mesh_p = _meshes(6, 6, True)
    W = 36
    rs = np_rng(8)
    victim = rs.integers(-1, W, W).astype(np.int32)
    sizes = rs.integers(0, 5, W).astype(np.int32)
    want = rst.attach_hops(rst.resolve_grants(to_jax(victim), to_jax(sizes)), mesh_r)
    got = pst.attach_hops(pst.resolve_grants(to_torch(victim), to_torch(sizes)), mesh_p)
    assert_same(want.hops, got.hops)
    assert got.hops.dtype == torch.int32
    with pytest.warns(DeprecationWarning):
        dense = pst.attach_hops(pst.resolve_grants(to_torch(victim), to_torch(sizes)),
                                rtopo.MeshTopology.grid(6, 6, True).hop_matrix)
    assert_same(want.hops, dense.hops)
