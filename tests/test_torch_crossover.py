"""Port parity of the crossover benchmark and the numpy modules it reads: the
port's copies of `jsonio` and `latency` against the reference's functions on
a grid of inputs, `repro_torch.benchmarks.sweep` (`param_grid`, `crossover`,
its CLI) against `benchmarks.sweep` on the CPU."""

import json

import numpy as np
import pytest
import torch
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from benchmarks import sweep as rsweep
from repro.core import jsonio as rjsonio
from repro.core import latency as rlatency
from repro.core import stealing as rst
from repro.core import tasks as rtasks
from repro_torch.benchmarks import sweep as psweep
from repro_torch.core import jsonio as pjsonio
from repro_torch.core import latency as platency
from repro_torch.core import simulator as psim
from repro_torch.core import tasks as ptasks

DOCS = [{"a": float("inf"), "b": [float("nan"), -0.0, 2], "c": {3: np.float32(1.5)}},
        {"x": np.arange(4), "y": np.array([1.0, np.inf]), "z": (np.int64(7), None)},
        [np.float64("-inf"), {"k": [np.bool_(True), "s", 1e308]}], 5, "plain"]


@pytest.mark.parametrize("doc", range(len(DOCS)))
def test_jsonio_copy_matches_reference(doc, tmp_path):
    """sanitize, dumps, write and the strict readers give the reference's
    output on the same documents, and both refuse the same literals."""
    d = DOCS[doc]
    assert pjsonio.sanitize(d) == rjsonio.sanitize(d)
    for kw in ({}, {"indent": 2, "sort_keys": True}):
        s = pjsonio.dumps(d, **kw)
        assert s == rjsonio.dumps(d, **kw)
        assert pjsonio.loads_strict(s) == rjsonio.loads_strict(s)
    pjsonio.write(tmp_path / "p.json", d, indent=2)
    rjsonio.write(tmp_path / "r.json", d, indent=2)
    assert (tmp_path / "p.json").read_text() == (tmp_path / "r.json").read_text()
    assert pjsonio.load_strict(tmp_path / "p.json") == rjsonio.load_strict(tmp_path / "r.json")
    for bad in ("NaN", "[Infinity]", '{"a": -Infinity}'):
        with pytest.raises(ValueError):
            pjsonio.loads_strict(bad)
        with pytest.raises(ValueError):
            rjsonio.loads_strict(bad)


def test_latency_copy_matches_reference():
    """Every function of the analytic model on a grid of sizes, τ and
    success probabilities (0 included) equals the reference's."""
    ns = np.array([1, 4, 9, 16, 25, 36, 64, 100, 400, 1600, 4096, 16384])
    taus = (5e-3, 2.0, 5, 10)
    ps = np.array([0.0, 1e-3, 0.25, 0.5, 1.0])
    same = np.testing.assert_array_equal
    for tau in taus:
        same(platency.neighbor_round_trip(tau), rlatency.neighbor_round_trip(tau))
        same(platency.global_round_trip(ns, tau), rlatency.global_round_trip(ns, tau))
        same(platency.initial_phase_duration(ns, tau),
             rlatency.initial_phase_duration(ns, tau))
        for p in ps:
            same(platency.neighbor_expected_time(p, tau),
                 rlatency.neighbor_expected_time(p, tau))
            same(platency.global_expected_time(ns, p, tau),
                 rlatency.global_expected_time(ns, p, tau))
    for fn in ("global_mean_hops", "threshold", "speedup_per_attempt"):
        same(getattr(platency, fn)(ns), getattr(rlatency, fn)(ns))
    with np.errstate(divide="ignore", invalid="ignore"):
        same(platency.expected_time_to_task(ns[:, None], ps[None]),
             rlatency.expected_time_to_task(ns[:, None], ps[None]))
    for pg in ps:
        same(platency.neighbor_wins(ns[:, None], pg, ps[None]),
             rlatency.neighbor_wins(ns[:, None], pg, ps[None]))
    assert platency.table1() == [platency.Table1Row(**vars(r)) for r in rlatency.table1()]
    assert platency.DEFAULT_TAU_S == rlatency.DEFAULT_TAU_S


def test_param_grid_matches_reference():
    axes = dict(hop_ticks=(2, 5), strategy=("neighbor", rst.Strategy.GLOBAL),
                seed=range(2))
    want = rsweep.param_grid(**axes)
    got = psweep.param_grid(**{**axes, "strategy": ("neighbor", "global")})
    assert [c for c, _ in got] == [c for c, _ in want]
    assert [tuple(p) for _, p in got] == [tuple(int(x) for x in p) for _, p in want]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's CPU path runs many small operations: one intra-op thread
    a test process keeps parallel workers from oversubscribing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_crossover_matches_reference():
    """The quick crossover (sizes 9, 16, 25; τ 2, 5; 2 runs) equals the
    reference's in its points and its crossover rows; each size is one
    `_sim_core` call, and the RTT rows are empty. Both sides run with rings
    of 256 (the benchmark's default is 2048): `crossover` asserts that no
    task overflows, and without overflow the ring's capacity changes no
    tick (the card's `[crossover]` phase runs the default)."""
    kw = dict(taus=(2, 5), runs=2, capacity=256, rtt_hists=False)
    want = rsweep.crossover(rsweep.QUICK_SIZES, workload=rtasks.FibWorkload(
        n=20, cutoff=12, max_leaf_cost=8), **kw)
    got = psweep.crossover(psweep.QUICK_SIZES, workload=ptasks.FibWorkload(
        n=20, cutoff=12, max_leaf_cost=8), device="cpu", **kw)
    for key in ("schema", "workload", "sizes", "taus", "strategies", "runs",
                "points", "crossover"):
        assert got[key] == want[key], key
    assert got["rtt"] == []
    assert got["traces_per_size"] == {"9": 1, "16": 1, "25": 1}
    # the document goes out strict: no NaN or Infinity
    assert pjsonio.loads_strict(pjsonio.dumps(got)) == json.loads(pjsonio.dumps(got))


def test_crossover_cli_and_rtt_refusal(tmp_path, monkeypatch, capsys):
    """`python -m repro_torch.benchmarks.sweep` writes a strict document
    with one core per size; with `rtt_hists=True` (the flight recorder,
    ROADMAP item 11) the RTT rows equal the reference's."""
    out = tmp_path / "x.json"
    monkeypatch.setattr("sys.argv", [
        "sweep", "--quick", "--sizes", "4", "--taus", "3", "--runs", "2", "--no-plot",
        "--no-rtt", "--assert-single-compile", "--device", "cpu", "--out", str(out)])
    before = psim.core_count()
    psweep.main()
    assert psim.core_count() - before == 1
    doc = pjsonio.load_strict(out)
    assert doc["traces_per_size"] == {"4": 1} and doc["rtt"] == []
    assert len(doc["points"]) == 2 and len(doc["crossover"]) == 1
    assert "crossover/N=4/tau=3" in capsys.readouterr().out
    kw = dict(taus=(2, 3, 5), runs=1, capacity=256, rtt_hists=True)
    want = rsweep.crossover((4, 9), workload=rtasks.FibWorkload(
        n=16, cutoff=8, max_leaf_cost=8), **kw)["rtt"]
    got = psweep.crossover((4, 9), workload=ptasks.FibWorkload(
        n=16, cutoff=8, max_leaf_cost=8), device="cpu", **kw)["rtt"]
    assert got == want and [h["strategy"] for h in got] == ["neighbor", "global"]
    assert got[0]["measured_mean_rtt"] == 2 * 3 and got[0]["resolved_attempts"] > 0
    assert "crossover/rtt/global/N=9/tau=3" in capsys.readouterr().out
