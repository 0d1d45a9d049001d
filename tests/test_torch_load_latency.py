"""Port parity of the load–latency benchmark: `repro_torch.benchmarks.
load_latency.run_curve` on the CPU against the reference's
`benchmarks/load_latency.run_curve` (side 4, NEIGHBOR and GLOBAL, two
loads, one seed: every point's ticks, counters and sojourn percentiles and
every knee equal), and its command line writing strict JSON only where
`--out` says."""

import sys

import pytest
import torch
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from benchmarks import load_latency as rll
from repro_torch.benchmarks import load_latency as pll
from repro_torch.core import jsonio


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_run_curve_equals_reference():
    kw = dict(side=4, loads=(0.1, 0.8), strategies=("neighbor", "global"), runs=1,
              horizon=1000, assert_single_compile=True)
    want = rll.run_curve(**kw)
    got = pll.run_curve(**kw, device="cpu")
    # the reference counts jit traces (0 where cached), the port core calls
    assert got.pop("traces") == 1
    want.pop("traces")
    assert got == want
    assert [p["dropped"] for p in got["points"]] == [0] * 4
    assert all(p["sojourn"]["count"] == p["done"] > 0 for p in got["points"])


def test_cli_writes_only_where_asked(tmp_path, monkeypatch, capsys):
    out = tmp_path / "loadlat.json"
    args = ["--side", "3", "--loads", "0.5", "--strategies", "neighbor", "--runs", "1",
            "--horizon", "200", "--device", "cpu", "--assert-single-compile"]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["load_latency"] + args)
    pll.main()
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setattr(sys, "argv", ["load_latency"] + args + ["--out", str(out)])
    pll.main()
    doc = jsonio.load_strict(out)
    assert doc["schema"] == "loadlat/v1" and doc["W"] == 9 and len(doc["points"]) == 1
    assert "loadlat/neighbor/tau=3/knee" in capsys.readouterr().out
