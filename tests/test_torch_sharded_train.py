"""Port parity of the sharded train step (`repro_torch.launch.train.
build_sharded_train`: FSDP + TP on a `DeviceMesh`, parameters, AdamW's
moments and the batch as DTensors) against the reference's
`build_sharded_train` (GSPMD).

  * The reference runs in one child process with 4 forced host devices on
    a (2, 2) ("data", "model") mesh (`tests/sharded_train_reference.py`):
    the reduced configs in fp32, 3 steps.
  * The port runs the same in 4 gloo processes on a 2 x 2 `DeviceMesh`
    (`torch.multiprocessing` spawn, one intra-op thread, a free port) from
    the reference's initial parameters (`convert.master_params`).
  * The 1 x 1 mesh (one process) against the unsharded `make_train_step`,
    and the launcher on it with a checkpoint and a restart.
  * Every family: the dense qwen2 (one micro-batch, and two with full
    remat, and one with the sequence-parallel residual, `seq_shard_axis`
    "model" on both sides), rwkv6, the RG-LRU hybrid, the qwen2-moe MoE
    (its experts over "model" in the port, two router columns scaled so
    that the neighbor steal moves slots across that boundary), the VLM (llava, with its
    prefix embeddings) and the encoder-decoder (whisper, with its frames).

Tolerances: every step's loss within rtol 1e-5 (tests/test_torch_train.py's);
AdamW's first moment after the first step, (1 - b1)·g, within 2e-5 ·
max|reference leaf| (the gradients' tolerance there); the first moment
after steps 2 and 3 and the parameters after 3 steps within a few times
the worst gap measured on the CPU (`LIMITS`): Adam's step is ~lr·g/|g|, so
where |g| is within a few eps of 0 the gradients' last-bit differences
move a parameter by a share of lr, and the gradients of the later steps
see those parameters. A leaf whose gradient is zero in exact arithmetic
(`ZERO_GRAD`: the encoder-decoder's key biases, which softmax cancels
without RoPE) has moments of rounding noise alone, so its scale is the
case's largest leaf. Every leaf's placements equal its spec's before and
after the steps.
"""

import dataclasses
import io
import os
import socket
import subprocess
import sys
import time
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import sharded_train_reference as sr
from torch_parity import run_once
from repro_torch import convert
from repro_torch.data import synthetic
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import shardings as sh
from repro_torch.launch import train as plt
from repro_torch.models import registry as preg
from repro_torch.optim import adamw as padam
from repro_torch.runtime import train_loop as ptl

ROOT = Path(__file__).resolve().parents[1]
REF_TIMEOUT = 300     # seconds for the reference's child process
SPAWN_TIMEOUT = 240   # seconds for the port's 4 gloo processes
LOSS_RTOL, GRAD_RTOL = 1e-5, 2e-5
# case -> (the first moment after steps 2-3, relative to max|reference
# leaf|; the parameters after 3 steps, a share of the summed lr): 3.5-6.2x
# the worst gaps measured here (first moments 2.0e-6 - 5.2e-5, parameters
# 7.2e-4 - 2.9e-3; rwkv6 and the hybrid the largest)
LIMITS = {"plain": (2e-5, 3e-3), "mb2-full": (1e-5, 3e-3), "rwkv6": (5e-5, 1e-2),
          "hybrid": (2e-4, 1e-2), "moe": (4e-5, 3e-3),
          # 5.2x and 4.5x / 5.2x the gaps measured here (vlm 5.8e-6, 4.5e-4;
          # encdec 2.9e-6, 2.9e-4)
          "vlm": (3e-5, 2e-3), "encdec": (1.5e-5, 1.5e-3),
          # the dense case with the sequence-parallel residual: plain's
          "seqpar": (2e-5, 3e-3)}
# leaves whose gradient is zero in exact arithmetic, by case: a key bias
# without RoPE, which softmax cancels (its moments are rounding noise of
# ~1e-14); their moments are held against the case's largest leaf
ZERO_GRAD = {"encdec": "wk/b"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_both(tmp):
    """The reference's child and the port's 4 gloo processes, writing
    ref.npz and port.npz into `tmp`: the port starts from the initial
    parameters the child writes first, and runs while the child steps."""
    ref_out, port_out = tmp / "ref.npz", tmp / "port.npz"
    init = Path(sr.init_path(str(ref_out)))
    # LLVM's optimization level 0 halves the child's compile CPU (~100 s
    # → ~55 s); its results move in the last bits, within the tolerances
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={sr.DEVICES} "
                         "--xla_backend_optimization_level=0",
               PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{os.environ.get('PYTHONPATH', '')}")
    child = subprocess.Popen([sys.executable, str(ROOT / "tests" / "sharded_train_reference.py"),
                              str(ref_out)], env=env)
    ctx = None
    try:
        deadline = time.monotonic() + REF_TIMEOUT
        while not init.exists():
            assert child.poll() in (None, 0), f"the reference's child failed: {child.returncode}"
            assert time.monotonic() < deadline, "the reference's child timed out"
            time.sleep(0.5)
        ctx = mp.start_processes(
            sr.port_worker, nprocs=4, join=False, start_method="spawn",
            args=(4, f"tcp://localhost:{_free_port()}", str(init), str(port_out)))
        spawn_deadline = time.monotonic() + SPAWN_TIMEOUT
        while not ctx.join(timeout=5):
            assert time.monotonic() < spawn_deadline, "the port's gloo run timed out"
        assert child.wait(timeout=max(1.0, deadline - time.monotonic())) == 0
    finally:
        if child.poll() is None:
            child.kill()
        for p in ctx.processes if ctx is not None else ():
            if p.is_alive():
                p.kill()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, port outputs) of every case, made once a session."""
    tmp = run_once(tmp_path_factory, "sharded_train", _run_both)
    return dict(np.load(tmp / "ref.npz")), dict(np.load(tmp / "port.npz"))


def _port_tree(ref: dict, case: str, what: str):
    cfg = sr.port_cfg(sr.CASES[case][0])
    return convert.master_params(cfg, sr._nested(ref, f"{case}/{what}/"))


@pytest.mark.parametrize("case", list(sr.CASES))
def test_sharded_step_equals_reference(runs, case):
    ref, port = runs
    np.testing.assert_allclose(port[f"{case}/loss"], ref[f"{case}/loss"], rtol=LOSS_RTOL)
    assert int(port[f"{case}/misplaced"]) == 0
    m_rtol, p_share = LIMITS[case]
    sum_lr = sum(sr.OPT["lr_peak"] * min((s + 1) / sr.OPT["warmup_steps"], 1.0)
                 for s in range(sr.STEPS))
    for what in [f"m{s}" for s in range(sr.STEPS)] + ["p"]:
        want = sh.named_leaves(_port_tree(ref, case, what))
        assert len(want) == len([k for k in port if k.startswith(f"{case}/{what}/")])
        big = max(float(w.abs().max()) for _, w in want)
        for path, w in want:
            got, w = port[f"{case}/{what}/{path}"], w.numpy()
            zero = case in ZERO_GRAD and path.endswith(ZERO_GRAD[case])
            scale = big if zero else float(np.abs(w).max())
            tol = (GRAD_RTOL * scale if what == "m0" else m_rtol * scale if what != "p"
                   else p_share * sum_lr)
            np.testing.assert_allclose(got, w, rtol=0, atol=tol, err_msg=f"{what} {path}")


def test_steal_crossings_counted_in_the_two_by_two_run(runs):
    """The 2 x 2 gloo run's MoE case (3 steps of 2 layers, the router's
    columns of experts 3 and 7 x 3 on both sides: `sr.ROUTER_SCALE`)
    counts, at each layer call, the slots
    that the neighbor steal moves from one "model" rank's experts to the
    other's: some do, so the parity above holds with slots crossing the
    expert-parallel boundary, and only the MoE case calls the layer."""
    crossings = runs[1]["moe/crossings"]
    assert crossings.shape == (3 * 2,)
    assert ((crossings >= 0) & (crossings <= 8 * 32 * 2)).all(), crossings
    assert crossings.sum() > 0, crossings
    assert not [k for k in runs[1] if k.endswith("/crossings") and k != "moe/crossings"
                and runs[1][k].size]


@pytest.fixture(scope="module")
def one_rank():
    """A gloo process group of one, in this process."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    yield pmesh.make_mesh((1, 1), device_type="cpu")
    dist.destroy_process_group()


def test_one_by_one_mesh_equals_unsharded_step(one_rank):
    cfg = sr.port_cfg()
    fns = preg.get_fns(cfg)
    opt_cfg = padam.AdamWConfig(**sr.OPT)
    init_fn, step_fn, specs = plt.build_sharded_train(sr.ARCH, one_rank, model_cfg=cfg,
                                                      opt_cfg=opt_cfg)
    params = fns.init(cfg, seed=0, device="cpu", masters=True)
    opt = padam.init(params)
    # init_fn's own draws, each leaf placed as it is made, are init's
    for a, b in zip(padam.leaves((params, opt)), padam.leaves(init_fn(0))):
        assert torch.equal(b.full_tensor(), a)
    sp, so = init_fn(state=padam.tree_map(lambda t: t.clone(), (params, opt)))
    step = ptl.make_train_step(cfg, fns, opt_cfg)
    dc = synthetic.DataConfig(vocab=cfg.vocab, **sr.DATA)
    for i in range(sr.STEPS):
        batch = ptl._make_batch(cfg, dc, i, ptl.TrainConfig())
        params, opt, m = step(params, opt, batch)
        sp, so, ms = step_fn(sp, so, batch)
        np.testing.assert_allclose(float(ms["loss"].full_tensor()), float(m["loss"]),
                                   rtol=1e-6)
    for a, b in zip(padam.leaves((params, opt)), padam.leaves((sp, so))):
        np.testing.assert_allclose(b.full_tensor().detach().numpy(),
                                   a.detach().numpy(), rtol=0, atol=1e-6)


def test_launcher_on_one_by_one_mesh(one_rank, tmp_path):
    """The launcher inside a process group that has formed uses it (a 1 x 1
    mesh): it trains, saves the reference's checkpoint labels and
    restarts."""
    argv = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu", "--batch", "4",
            "--seq", "16", "--ckpt", str(tmp_path), "--ckpt-every", "2"]
    for steps, first in ((3, "[launch/train] step     0 loss "),
                         (6, "[launch/train] restored step 3")):
        out = io.StringIO()
        with redirect_stdout(out):
            plt.main(argv + ["--steps", str(steps)])
        lines = out.getvalue().splitlines()
        assert lines[0].startswith(first), lines
        assert lines[-1].endswith("on cpu, mesh 1x1"), lines
    # mid-run saves after steps 2 and 4 (step > start, step % 2 == 0), final
    # ones at 3 and 6; the oldest pruned (keep 3)
    assert ptl.Checkpointer(str(tmp_path)).all_steps() == [3, 4, 6]


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "whisper-tiny"])
def test_unported_families_name_their_item(one_rank, arch):
    """The VLM and encoder-decoder families build on a mesh and step there
    as the unsharded step does (on the 1 x 1 mesh: equal; on 2 x 2, cases
    "vlm" and "encdec" of `test_sharded_step_equals_reference`)."""
    cfg = sr.port_cfg(arch)
    fns = preg.get_fns(cfg)
    opt_cfg = padam.AdamWConfig(**sr.OPT)
    _, step_fn, _ = plt.build_sharded_train(arch, one_rank, model_cfg=cfg, opt_cfg=opt_cfg)
    params = fns.init(cfg, seed=0, device="cpu", masters=True)
    opt = padam.init(params)
    sp, so = plt.build_sharded_train(arch, one_rank, model_cfg=cfg, opt_cfg=opt_cfg)[0](
        state=padam.tree_map(lambda t: t.clone(), (params, opt)))
    step = ptl.make_train_step(cfg, fns, opt_cfg)
    batch = ptl._make_batch(cfg, synthetic.DataConfig(vocab=cfg.vocab, **sr.DATA), 0,
                            ptl.TrainConfig())
    params, opt, m = step(params, opt, batch)
    sp, so, ms = step_fn(sp, so, batch)
    np.testing.assert_allclose(float(ms["loss"].full_tensor()), float(m["loss"]), rtol=1e-6)
    for a, b in zip(padam.leaves((params, opt)), padam.leaves((sp, so))):
        np.testing.assert_allclose(b.full_tensor().detach().numpy(), a.detach().numpy(),
                                   rtol=0, atol=1e-6)


def test_training_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plt.launch_mesh(None)


def test_micro_batches_stay_sharded(one_rank):
    """Each micro-batch of a DTensor batch is sharded over the data axes
    again (on the 1 x 1 mesh: Shard(0) on "data"), with the reference's
    rows."""
    from torch.distributed.tensor import Replicate, Shard

    tokens = torch.arange(24).reshape(6, 4)
    batch = sh.with_shardings({"tokens": tokens}, {"tokens": ("data", None)}, one_rank)
    mbs = ptl.microbatches(batch, 3)
    for i, mb in enumerate(mbs):
        assert mb["tokens"].placements == (Shard(0), Replicate())
        assert torch.equal(mb["tokens"].full_tensor(), tokens[2 * i:2 * i + 2])
