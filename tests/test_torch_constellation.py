"""Port parity of the constellation model (ROADMAP Queue 1 item 10):
`repro_torch.core.constellation.Constellation` and its schedules, and
`repro_torch.configs.paper_mesh`'s orbit presets, against
`repro.core.constellation` and `repro.configs.paper_mesh`, array for array:
the paper mesh's `orbit_quick` preset, a config without wraparound (no seam
handovers) and one with Poisson radiation failures."""

import dataclasses

import numpy as np
import pytest
from torch_parity import assert_same
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.configs import paper_mesh as rpm
from repro.core import constellation as rcon
from repro_torch import convert
from repro_torch.configs import paper_mesh as ppm
from repro_torch.core import constellation as pcon

BASE = rcon.ConstellationConfig(
    planes=4, sats_per_plane=5, orbit_ticks=600, tau_base=4,
    interplane_amp=0.5, battery_limited_frac=0.25, warn_ticks=30,
    epochs_per_orbit=12, seed=11)

CONFIGS = {
    "orbit_quick": (rpm.CONFIG.orbit_quick, 1200),
    "orbit": (rpm.CONFIG.orbit, 8000),
    "no_wraparound": (dataclasses.replace(BASE, wraparound=False), 1800),
    "poisson": (dataclasses.replace(BASE, failure_rate=2.0, wraparound=True,
                                    seam_outage_frac=0.2), 1200),
    "one_orbit": (dataclasses.replace(BASE, battery_limited_frac=0.5, warn_ticks=50), 500),
}


def _pair(name):
    cfg, horizon = CONFIGS[name]
    port_cfg = convert.constellation_config(dataclasses.asdict(cfg))
    return rcon.Constellation(cfg), pcon.Constellation(port_cfg), horizon


@pytest.mark.parametrize("name", list(CONFIGS))
def test_schedule_equals_reference(name):
    ref, port, horizon = _pair(name)
    assert (ref.mesh.num_workers, ref.mesh.rows, ref.mesh.cols, ref.mesh.torus) == \
        (port.mesh.num_workers, port.mesh.rows, port.mesh.cols, port.mesh.torus)
    want, got = ref.schedule(horizon), port.schedule(horizon)
    for f in ("fail_time", "predictable", "speed", "wake_time", "fail_period"):
        assert_same(getattr(want, f), getattr(got, f), f)
        assert getattr(want, f).dtype == getattr(got, f).dtype, f
    assert want.mean_hop_ticks == got.mean_hop_ticks
    for f in ("epoch_starts", "link_tau", "link_up", "speed"):
        a, b = getattr(want.linkstate, f), getattr(got.linkstate, f)
        assert_same(a, b, f"linkstate.{f}")
        assert a.dtype == b.dtype, f
    if name == "poisson":  # radiation deaths really are drawn
        assert (got.fail_time[~got.predictable] >= 0).any()
    if name == "no_wraparound":
        assert not port.mesh.torus
    # the other schedules and the orbit's scalar views
    for t in (0, 37, horizon // 3, horizon - 1):
        assert ref.interplane_tau(t, 1) == port.interplane_tau(t, 1)
        assert ref.intraplane_tau(t) == port.intraplane_tau(t)
    assert ref.mean_tau() == port.mean_tau()
    assert ref.handover_cycle() == port.handover_cycle()
    for kw in ({}, {"peak": 0.9, "trough": 0.1, "epochs_per_orbit": 5}):
        assert ref.traffic_schedule(horizon, **kw) == port.traffic_schedule(horizon, **kw)
    with pytest.raises(ValueError) as w:
        ref.traffic_schedule(horizon, peak=0.2, trough=0.5)
    with pytest.raises(ValueError) as g:
        port.traffic_schedule(horizon, peak=0.2, trough=0.5)
    assert str(w.value) == str(g.value)


def test_linkstate_schedule_of_given_deaths():
    """`linkstate_schedule` from hand-made death, wake and period arrays."""
    ref, port, horizon = _pair("orbit_quick")
    W = ref.mesh.num_workers
    ft = np.full(W, -1, np.int32)
    wt = np.full(W, -1, np.int32)
    fp = np.full(W, -1, np.int32)
    ft[[3, 7, 12]] = [100, 250, 400]
    wt[[3, 7]] = [180, 300]
    fp[3] = 500
    pred = ft >= 0
    for args in ((ft, pred), (ft, pred, wt), (ft, pred, wt, fp)):
        a, b = ref.linkstate_schedule(horizon, *args), port.linkstate_schedule(horizon, *args)
        for f in ("epoch_starts", "link_tau", "link_up", "speed"):
            assert_same(getattr(a, f), getattr(b, f), f)


def test_paper_mesh_presets():
    for f in dataclasses.fields(rpm.PaperMeshConfig):
        want, got = getattr(rpm.CONFIG, f.name), getattr(ppm.CONFIG, f.name)
        if dataclasses.is_dataclass(want):
            assert dataclasses.asdict(want) == dataclasses.asdict(got), f.name
            assert type(want).__name__ == type(got).__name__
        else:
            assert want == got, f.name
    assert isinstance(ppm.CONFIG.orbit, pcon.ConstellationConfig)
    assert dataclasses.asdict(pcon.ConstellationConfig()) == \
        dataclasses.asdict(rcon.ConstellationConfig())
