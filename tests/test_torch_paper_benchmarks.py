"""Port parity of the paper's benchmark scripts: `repro_torch.benchmarks`'
`table1_latency`, `fig3_scaling`, `fig4_relative` and `mesh_latency`
against the reference's `benchmarks` modules on the CPU — the returned
rows and results, and every `emit` line.

Fig. 3 runs both packages' scripts with their `FIB_QUICK` / `UTS_QUICK`
swapped for tests/test_scheduler.py's W = 16 fixtures (the scripts' own
trees take minutes a worker count on the CPU), at W = 16 and three seeds;
Fig. 4 reads those runs. Every number is a round or tick count or a ratio
of them: exact equality.
"""

import contextlib
import dataclasses
import io

import pytest
import torch
from torch_parity import assert_results_equal
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from benchmarks import fig3_scaling as rfig3
from benchmarks import fig4_relative as rfig4
from benchmarks import mesh_latency as rmesh
from benchmarks import table1_latency as rtable1
from repro.core import tasks as rtasks
from repro_torch import convert
from repro_torch.benchmarks import fig3_scaling as pfig3
from repro_torch.benchmarks import fig4_relative as pfig4
from repro_torch.benchmarks import mesh_latency as pmesh
from repro_torch.benchmarks import table1_latency as ptable1

FIB = rtasks.FibWorkload(n=24, cutoff=10, max_leaf_cost=8)
UTS = rtasks.UtsWorkload(b0=3.0, d_max=8, root_seed=19)
WORKERS = (16,)
RUNS = 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _lines(text: str) -> list:
    return [ln for ln in text.splitlines() if not ln.startswith("#")]


def test_table1(capsys):
    ref = rtable1.run(csv=True)
    ref_out = capsys.readouterr().out
    port = ptable1.run(csv=True)
    assert port == ref
    assert _lines(capsys.readouterr().out) == _lines(ref_out)


def _fig4_with_fig3(fig3, fig4, fib, uts, **kw):
    """Fig. 4's band and emitted lines, and the Fig. 3 results it ran on,
    from one `fig4.run` with the fixtures in place of the scripts' trees."""
    seen = {}
    run3 = fig3.run

    def recording(*a, **k):
        seen["fig3"] = run3(*a, **k)
        return seen["fig3"]

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(fig3, "FIB_QUICK", fib)
        mp.setattr(fig3, "UTS_QUICK", uts)
        mp.setattr(fig3, "run", recording)
        band = fig4.run(WORKERS, runs=RUNS, **kw)
    return band, seen["fig3"], _lines(out.getvalue())


@pytest.fixture(scope="module")
def fig_runs():
    ref = _fig4_with_fig3(rfig3, rfig4, FIB, UTS)
    port = _fig4_with_fig3(
        pfig3, pfig4, convert.workload("FibWorkload", dataclasses.asdict(FIB)),
        convert.workload("UtsWorkload", dataclasses.asdict(UTS)), device="cpu")
    return ref, port


def test_fig3_results(fig_runs):
    (_, ref, _), (_, port, _) = fig_runs
    assert sorted(port) == sorted(ref) == [("FIB", 16), ("UTS", 16)]
    for k in ref:
        assert port[k] == ref[k], k


def test_fig4_band_and_rows(fig_runs):
    (ref_band, _, ref_lines), (band, _, lines) = fig_runs
    assert band == ref_band
    assert lines == ref_lines
    assert any(ln.startswith("fig3/FIB/W=16,") for ln in lines)
    assert lines[-1].startswith("fig4/max_abs_band_all,")


def test_mesh_latency(capsys):
    kw = dict(sizes=(16,), hop_ticks=(2,), small=True)
    ref = rmesh.run(**kw)
    ref_out = capsys.readouterr().out
    port = pmesh.run(**kw, device="cpu")
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert sorted(port[k]) == sorted(ref[k])
        for s in ref[k]:
            assert_results_equal(ref[k][s], port[k][s])
    assert _lines(capsys.readouterr().out) == _lines(ref_out)
