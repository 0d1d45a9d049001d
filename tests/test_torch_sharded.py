"""Port parity of the sharded executor (`repro_torch.core.scheduler.
build_sharded_run`) and its mesh (`core.mesh_comm`) against the reference's
`shard_map` executor, and of the simulator's grid over several devices.

  * The reference's runs come from one child process with 16 forced host
    devices (`tests/sharded_reference.py`): 4x4 NEIGHBOR and GLOBAL, a 4x4
    torus, and a 2x3 mesh (the first 6 devices), on tests/test_scheduler.py's
    sharded FIB; with `jax.lax`'s collectives on a 2x3 mesh.
  * The port's local mesh on the CPU equals them in `rounds` and in every
    state leaf (the deque's ring, bottoms and sizes included); its
    collectives equal `jax.lax`'s.
  * The `DeviceMesh` path, one worker a process over gloo
    (`torch.multiprocessing` spawn, one intra-op thread, a free port),
    equals the local mesh at 4x4 (16 processes) and 2x3 (6 processes).
  * `simulate_sweep(devices=["cpu", "cpu"])` on tests/test_sweep.py's five
    points (3x3 mesh: odd, so the grid pads) equals per-point `simulate`.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch_parity import assert_results_equal, assert_same

import sharded_reference as sr
from repro_torch.core import mesh_comm
from repro_torch.core import scheduler as psch
from repro_torch.core import simulator as psim
from repro_torch.core import stealing as pst
from repro_torch.core import tasks as ptasks
from repro_torch.core import topology as ptopo
from repro_torch.launch import sharded as launcher

ROOT = Path(__file__).resolve().parents[1]
REF_TIMEOUT = 300  # seconds for the reference's child process
SPAWN_TIMEOUT = 240  # seconds for one gloo run of every case on a mesh


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference output this file needs, from one child process."""
    out = tmp_path_factory.mktemp("sharded_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={sr.DEVICES}",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(ROOT / "tests" / "sharded_reference.py"),
                           "sharded", str(out)], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=REF_TIMEOUT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(out))


def _spec(strategy: str, torus: bool) -> dict:
    return launcher.job(strategy, torus, **sr.SHARDED_FIB, **sr.SHARDED_CFG)


@pytest.fixture(scope="module")
def local():
    """The port's local-mesh runs of every case on the CPU: {case: (leaves,
    rounds)}."""
    out = {}
    for name, (shape, strategy, torus) in sr.SHARDED_CASES.items():
        state, rounds = launcher.run(mesh_comm.LocalMesh(shape, device="cpu"),
                                     _spec(strategy, torus))
        out[name] = (launcher.arrays(state), rounds)
    return out


@pytest.mark.parametrize("case", list(sr.SHARDED_CASES))
def test_local_mesh_equals_reference(ref, local, case):
    leaves, rounds = local[case]
    assert rounds == int(ref[f"{case}/rounds"])
    assert sorted(leaves) == sorted(k.split("/")[1] for k in ref
                                    if k.startswith(f"{case}/") and not k.endswith("/rounds"))
    for k, v in leaves.items():
        assert_same(ref[f"{case}/{k}"], v, f"{case} {k}")
    wl = ptasks.FibWorkload(**sr.SHARDED_FIB)
    assert (int(leaves["acc"].astype(np.int64).sum() % ptasks.RESULT_MOD),
            int(leaves["nodes"].sum()), int(leaves["overflow"].sum())) == (
        wl.expected_result(), wl.expected_nodes(), 0)


@pytest.mark.parametrize("case", list(sr.COLLECTIVE_CASES))
def test_local_collectives_equal_jax(ref, case):
    op, axis, pairs = sr.COLLECTIVE_CASES[case]
    mesh = mesh_comm.LocalMesh((2, 3), device="cpu")
    x = torch.arange(12, dtype=torch.int32).reshape(6, 2) * 10 + 1
    got = (mesh.ppermute(x, axis, list(pairs)) if op == "ppermute"
           else getattr(mesh, op)(x, axis))
    assert_same(ref[f"collective/{case}"], got, case)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _gloo_runs(shape, cases) -> dict:
    """Every case in `cases` run one worker a process over gloo on a
    `DeviceMesh` of `shape`: {case: (leaves, rounds)} from rank 0."""
    world = shape[0] * shape[1]
    specs = [_spec(*sr.SHARDED_CASES[c][1:]) for c in cases]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "dist.npz")
        ctx = mp.start_processes(
            launcher.dist_worker, nprocs=world, join=False, start_method="spawn",
            args=(world, f"tcp://localhost:{_free_port()}", shape[0], shape[1], specs, out))
        deadline = time.monotonic() + SPAWN_TIMEOUT
        try:
            while not ctx.join(timeout=5):
                assert time.monotonic() < deadline, f"gloo run on {shape} timed out"
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        got = dict(np.load(out))
    return {c: ({k.split("/")[1]: v for k, v in got.items()
                 if k.startswith(f"{i}/") and not k.endswith("/rounds")},
                int(got[f"{i}/rounds"])) for i, c in enumerate(cases)}


@pytest.mark.parametrize("shape", [(4, 4), (2, 3)], ids=["4x4", "2x3"])
def test_device_mesh_equals_local(local, shape):
    cases = [c for c, (s, _, _) in sr.SHARDED_CASES.items() if s == shape]
    for case, (leaves, rounds) in _gloo_runs(shape, cases).items():
        want, want_rounds = local[case]
        assert rounds == want_rounds, case
        assert sorted(leaves) == sorted(want)
        for k, v in leaves.items():
            assert_same(want[k], v, f"{case} {k} (gloo)")


def test_sharded_refusals(monkeypatch):
    """Strategies without a sharded round, a mesh of other axes, a
    `DeviceMesh` with no process group, `jax.lax`'s ppermute rule, and the
    local mesh's CUDA default without a card."""
    wl = ptasks.FibWorkload(**sr.SHARDED_FIB)
    mesh = mesh_comm.LocalMesh((2, 2), device="cpu")
    for s in (pst.Strategy.ADAPTIVE, pst.Strategy.LIFELINE):
        with pytest.raises(ValueError, match="NEIGHBOR and GLOBAL"):
            psch.build_sharded_run(mesh, psch.SchedulerConfig(strategy=s), wl)
    with pytest.raises(ValueError, match="'row', 'col'"):
        psch.build_sharded_run(mesh_comm.LocalMesh((2, 2), ("a", "b"), device="cpu"),
                               psch.SchedulerConfig(), wl)
    with pytest.raises(TypeError, match="LocalMesh or a DeviceMesh"):
        psch.build_sharded_run((2, 2), psch.SchedulerConfig(), wl)
    with pytest.raises(ValueError, match="repeats"):
        mesh.ppermute(torch.zeros(4), "row", [(0, 1), (1, 1)])
    with pytest.raises(ValueError, match="out of range"):
        mesh.ppermute(torch.zeros(4), "col", [(0, 2)])
    from torch.distributed.device_mesh import DeviceMesh

    fake = DeviceMesh.__new__(DeviceMesh)
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh_comm.as_mesh(fake)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_comm.LocalMesh((2, 2))


def test_sweep_over_two_devices_equals_per_point():
    """tests/test_sweep.py's sharded sweep: five points on a 3x3 mesh over
    two devices (the grid padded to six by repeating the last point, then
    trimmed), each equal to its own `simulate`, `events` included."""
    mesh = ptopo.MeshTopology.grid(3, 3)
    wl = ptasks.FibWorkload(20, 12, 8)
    cfg = psim.SimConfig(hop_ticks=3, capacity=128, max_ticks=200000)
    pts = [cfg.params._replace(strategy=c, seed=s)
           for c in (pst.GLOBAL_CODE, pst.NEIGHBOR_CODE, pst.ADAPTIVE_CODE)
           for s in (0, 1)][:5]
    before = psim.core_count()
    rs = psim.simulate_sweep(wl, mesh, cfg, pts, devices=["cpu", "cpu"])
    assert psim.core_count() - before == 2 and len(rs) == len(pts)
    for p, r in zip(pts, rs):
        full = dataclasses.replace(cfg, strategy=pst.CODE_STRATEGIES[int(p.strategy)],
                                   seed=int(p.seed))
        assert_results_equal(psim.simulate(wl, mesh, full, device="cpu"), r)
