"""Port parity of the closed-system simulator: `repro_torch` on the CPU
against `repro.core.simulator.simulate`, every `SimResult` field, for FIB at
W ∈ {9, 36}, all four strategies, tick/leap x loop/staged (W=100 and the
UTS point are in test_torch_simulator_w100.py, other mesh shapes in
test_torch_simulator_meshes.py). Also: the port never imports JAX, runs on
CUDA by default, and refuses what it has not ported."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity import check_against_reference
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import simulator as rsim
from repro.core import stealing as rst
from repro.core import tasks as rtasks
from repro.core import topology as rtopo
from repro_torch import convert
from repro_torch.core import simulator as psim
from repro_torch.core import tasks as ptasks
from repro_torch.core import topology as ptopo

FIB = rtasks.FibWorkload(n=16, cutoff=8, max_leaf_cost=8)
STRATEGIES = list(rst.Strategy)


def _cfg(strategy, **kw):
    base = dict(strategy=strategy, hop_ticks=3, capacity=32, famine_batch=0,
                max_ticks=5000)
    return rsim.SimConfig(**{**base, **kw})


@pytest.fixture(scope="module")
def reference_runs():
    """Reference results, one compile per (workload, W): the strategy is a
    traced parameter of the reference."""
    cache = {}

    def get(workload, W, strategy, **kw):
        key = (workload, W, strategy, tuple(sorted(kw.items())))
        if key not in cache:
            mesh = rtopo.MeshTopology.square(W)
            cfg = _cfg(strategy, **kw)
            cache[key] = (rsim.simulate(workload, mesh, cfg), mesh, cfg)
        return cache[key]
    return get


@pytest.mark.parametrize("strategy", STRATEGIES, ids=lambda s: s.value)
@pytest.mark.parametrize("W", [9, 36])
def test_fib_matches_reference(reference_runs, W, strategy):
    ref, mesh, cfg = reference_runs(FIB, W, strategy)
    assert ref.result == FIB.expected_result() and ref.nodes == FIB.expected_nodes()
    check_against_reference(ref, FIB, mesh, cfg)


def test_overflow_checkpoints_and_truncation_match_reference(reference_runs):
    """Tiny rings that drop tasks, the checkpoint counter, a grant budget of
    one, and a run cut at max_ticks before it drains; also with the famine
    fast path at the reference's default batch, whose windows end at
    checkpoints and at max_ticks."""
    small = {"capacity": 3, "ckpt_interval": 7, "max_grants_per_victim": 1}
    cut = {"max_ticks": 40, "escalate_after": 1}
    for strategy, kw in ((rst.Strategy.NEIGHBOR, small),
                         (rst.Strategy.ADAPTIVE, cut)):
        ref, mesh, _ = reference_runs(FIB, 9, strategy, **kw)
        famine_ref, _, cfg = reference_runs(FIB, 9, strategy, famine_batch=64, **kw)
        check_against_reference(ref, FIB, mesh, cfg, own_famine_ref=famine_ref)
        assert famine_ref.events < ref.events
    assert reference_runs(FIB, 9, rst.Strategy.NEIGHBOR, **small)[0].overflow > 0
    assert reference_runs(FIB, 9, rst.Strategy.ADAPTIVE, **cut)[0].ticks == 40


def test_port_imports_no_jax():
    """`import repro_torch`, its sweep benchmark and whole CPU simulate and
    sweep runs (closed, and under TC and SUPERVISION with pre-shed and
    stragglers) leave JAX and the reference package out of sys.modules."""
    code = (
        "import sys, repro_torch\n"
        "from repro_torch.core import simulator as s, tasks as t, topology as m\n"
        "import repro_torch.convert, repro_torch.kernels.ops\n"
        "import repro_torch.launch.serve, repro_torch.runtime.serve_loop\n"
        "import repro_torch.models.transformer\n"
        "import repro_torch.benchmarks.sweep, repro_torch.core.jsonio\n"
        "import repro_torch.core.latency\n"
        "r = s.simulate(t.FibWorkload(n=12, cutoff=6), m.MeshTopology.square(9),\n"
        "               s.SimConfig(capacity=16), device='cpu')\n"
        "assert r.result == t.FibWorkload(n=12, cutoff=6).expected_result()\n"
        "rs = s.simulate_sweep(t.FibWorkload(n=12, cutoff=6), m.MeshTopology.square(9),\n"
        "                      s.SimConfig(capacity=16), [s.SimParams(seed=1),\n"
        "                      s.SimParams(strategy=0)], device='cpu')\n"
        "assert [x.result for x in rs] == [r.result] * 2\n"
        "import numpy as np\n"
        "ft = np.full(9, -1, np.int32); ft[4] = 30\n"
        "for rec in (s.Recovery.TC, s.Recovery.SUPERVISION):\n"
        "    s.simulate(t.FibWorkload(n=12, cutoff=6), m.MeshTopology.square(9),\n"
        "               s.SimConfig(capacity=16, recovery=rec, ckpt_interval=10,\n"
        "                           preshed=True, warn_ticks=3,\n"
        "                           deque_backend='staged'), fail_time=ft,\n"
        "               speed=np.full(9, 2, np.int32), device='cpu')\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": src}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wl, mesh = ptasks.FibWorkload(n=10, cutoff=5), ptopo.MeshTopology.square(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        psim.simulate(wl, mesh, psim.SimConfig(capacity=16))
    with pytest.raises(RuntimeError, match="CUDA"):
        psim.simulate(wl, mesh, psim.SimConfig(capacity=16), device="cuda")


def test_plain_kernels_refused_on_cuda(monkeypatch):
    """On a CUDA device the simulator has no path to the kernels' plain
    versions: `use_steal_kernel=False` raises before any tensor is made."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    wl, mesh = ptasks.FibWorkload(n=10, cutoff=5), ptopo.MeshTopology.square(4)
    for backend in ("loop", "staged", None):
        cfg = psim.SimConfig(capacity=16, use_steal_kernel=False,
                             deque_backend=backend)
        with pytest.raises(ValueError, match="plain versions"):
            psim.simulate(wl, mesh, cfg, device="cuda")


@pytest.mark.parametrize("with_shape,cfg_kw", [
    (False, {"arrival_gap_q8": 256}),
    (True, {"arrival_gap_q8": 256, "arrival_batch": 99}),
], ids=["arrivals_gap", "arrivals"])
def test_unported_options_raise(with_shape, cfg_kw):
    """Open-loop arrivals are ported (ROADMAP Queue 1 item 12): the options
    that once raised `NotImplementedError` now get the reference's refusals
    — the stream on without its shape, a batch past ARRIVAL_K — with the
    reference's messages; a shape of another type is refused."""
    from repro.core import arrivals as rarr
    from repro_torch.core import arrivals as parr

    with pytest.raises(ValueError) as want:
        rsim.simulate(rtasks.FibWorkload(n=10, cutoff=5), rtopo.MeshTopology.square(4),
                      rsim.SimConfig(capacity=16, **cfg_kw),
                      arrivals=rarr.ArrivalConfig() if with_shape else None)
    with pytest.raises(ValueError) as got:
        psim.simulate(ptasks.FibWorkload(n=10, cutoff=5), ptopo.MeshTopology.square(4),
                      psim.SimConfig(capacity=16, **cfg_kw), device="cpu",
                      arrivals=parr.ArrivalConfig() if with_shape else None)
    assert str(got.value) == str(want.value)
    with pytest.raises(TypeError, match="ArrivalConfig or ArrivalArrays"):
        psim.simulate(ptasks.FibWorkload(n=10, cutoff=5), ptopo.MeshTopology.square(4),
                      psim.SimConfig(capacity=16), device="cpu", arrivals=object())


def test_config_split_mirrors_reference():
    ref = rsim.SimConfig(strategy=rst.Strategy.ADAPTIVE, hop_ticks=2, seed=9)
    got = convert.sim_config(dataclasses.asdict(ref))
    assert tuple(got.params) == tuple(ref.params)
    assert rsim.SimParams._fields == psim.SimParams._fields
    assert rsim.SimState._fields == psim.SimState._fields
    assert rsim.SimResult._fields == psim.SimResult._fields
    assert ({f.name for f in dataclasses.fields(rsim.SimConfig)}
            == {f.name for f in dataclasses.fields(psim.SimConfig)})
    assert ({f.name for f in dataclasses.fields(rsim.StaticConfig)}
            == {f.name for f in dataclasses.fields(psim.StaticConfig)})
