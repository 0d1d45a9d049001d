"""Elastic restore (`repro_torch.runtime.elastic`, `Checkpointer.restore(
shardings=...)`, `Checkpointer.save` of DTensors): the sharded train
step's state saved from a 2 x 2 ("data", "model") `DeviceMesh` (4 gloo
processes, rank 0 writing the whole tensors) restores onto 1 x 4 and
4 x 1 meshes of the same processes and onto a 1 x 1 mesh in this process:
every leaf bit-equal to what was saved, every placement its spec's on the
new mesh. `reshard_plan` (numpy) equals the reference's. The same
processes hold `init_fn`'s peak memory at 2 x 2 to about a quarter of the
(params, AdamW state) tree plus a few whole leaves.
"""

import dataclasses
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import sharded_train_reference as sr
from torch_parity import run_once
from repro.runtime import elastic as relastic
from repro_torch.checkpoint import Checkpointer
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import shardings as sh
from repro_torch.models import registry as preg
from repro_torch.optim import adamw as padam
from repro_torch.runtime import elastic as pelastic

SPAWN_TIMEOUT = 240   # seconds for the 4 gloo processes
NEW_SHAPES = ((1, 4), (4, 1))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _abstract(cfg):
    """The (params, AdamW state) tree on the meta device (shapes only)."""
    params = preg.get_fns(cfg).init(cfg, device="meta", masters=True)
    return params, padam.init(params)


def _rules(cfg, mesh):
    pspecs = sh.param_specs(_abstract(cfg)[0], mesh, cfg)
    return pspecs, sh.opt_specs(pspecs)


def _check(restored, cfg, mesh, saved: dict) -> list:
    """Paths of the leaves of `restored` that differ from `saved` (by
    checkpoint path) or whose placements are not their spec's on `mesh`."""
    bad = []
    leaves, paths = _ckpt_paths(restored)
    specs = []
    sh.zip_specs(lambda x, s: specs.append(s), restored, _rules(cfg, mesh))
    for leaf, path, spec in zip(leaves, paths, specs):
        if not (torch.equal(leaf.full_tensor(), torch.from_numpy(saved[path]))
                and leaf.placements == sh.placements(spec, mesh)):
            bad.append(path)
    return bad


def _ckpt_paths(tree):
    """(leaves, checkpoint paths) in `optim.adamw.leaves` order."""
    from repro_torch.checkpoint.checkpointer import _flatten

    leaves, paths = _flatten(tree)
    by_id = {id(x): p for x, p in zip(leaves, paths)}
    ordered = padam.leaves(tree)
    return ordered, [by_id[id(x)] for x in ordered]


# the model whose `init_fn` peak is measured: ~124 MB of fp32 masters, the
# largest leaf the 16.8 MB table (tied)
PEAK_CFG = dict(n_layers=12, d_model=512, vocab=8192)
PEAK_SLACK = 48 << 20   # bytes: allocator and gloo buffers


def _status(key: str) -> int:
    """A size in bytes from /proc/self/status: "VmRSS" (resident now) or
    "VmHWM" (the peak of this process image; `getrusage`'s peak is not
    used, as a spawned child inherits its parent's)."""
    with open("/proc/self/status") as f:
        line = next(x for x in f if x.startswith(key + ":"))
    return int(line.split()[1]) * 1024


def _init_peak(mesh) -> tuple:
    """(the growth of this process's peak resident bytes over `init_fn(0)`
    on `mesh` for PEAK_CFG's model, the (params, AdamW state) tree's bytes,
    its largest leaf's bytes). Measured from the resident bytes before the
    call to the peak after it, which is an upper bound on the call's own
    peak."""
    from repro_torch.launch import train as plt

    cfg = dataclasses.replace(preg.reduced(preg.get_config(sr.ARCH), **PEAK_CFG),
                              dtype="float32")
    init_fn, _, _ = plt.build_sharded_train(sr.ARCH, mesh, model_cfg=cfg)
    sizes = [t.numel() * 4 for t in padam.leaves(_abstract(cfg)[0])]
    before = _status("VmRSS")
    state = init_fn(0)
    grew = _status("VmHWM") - before
    del state
    return grew, 3 * sum(sizes), max(sizes)


def elastic_worker(rank: int, world: int, init_method: str, ckpt_dir: str, out: str):
    """One rank: a 2 x 2 sharded step from seed 0, saved; restored onto
    each of NEW_SHAPES and checked; `init_fn`'s peak memory (`_init_peak`);
    rank 0 writes the bad paths and every rank's peak."""
    import torch.distributed as dist

    from repro_torch.data import synthetic
    from repro_torch.launch import train as plt
    from repro_torch.runtime import train_loop as ptl

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, world_size=world, rank=rank)
    try:
        cfg = sr.port_cfg()
        mesh = pmesh.make_mesh((2, 2), device_type="cpu")
        init_fn, step_fn, _ = plt.build_sharded_train(
            sr.ARCH, mesh, model_cfg=cfg, opt_cfg=padam.AdamWConfig(**sr.OPT))
        state = init_fn(0)
        batch = ptl._make_batch(cfg, synthetic.DataConfig(vocab=cfg.vocab, **sr.DATA), 0,
                                ptl.TrainConfig())
        state = step_fn(*state, batch)[:2]
        ckpt = Checkpointer(ckpt_dir)
        ckpt.save(1, state)
        ckpt.wait()
        dist.barrier()
        saved = ckpt.read(1)
        bad = {}
        for shape in NEW_SHAPES:
            new = pmesh.make_mesh(shape, device_type="cpu")
            restored, step = pelastic.elastic_restore(ckpt, state, new, _rules(cfg, new))
            bad[f"{shape[0]}x{shape[1]}"] = np.asarray(
                [f"step {step}"] * (step != 1) + _check(restored, cfg, new, saved), dtype=str)
        peaks = [None] * world
        dist.all_gather_object(peaks, _init_peak(mesh))
        bad["peaks"] = np.asarray(peaks)
        if rank == 0:
            np.savez(out, **bad)
    finally:
        dist.destroy_process_group()


def _run_elastic(tmp):
    """The 4 gloo processes of `elastic_worker`, writing into `tmp`."""
    ctx = mp.start_processes(elastic_worker, nprocs=4, join=False, start_method="spawn",
                             args=(4, f"tcp://localhost:{_free_port()}",
                                   str(tmp / "ckpt"), str(tmp / "bad.npz")))
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "the gloo run timed out"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The checkpoint directory of the 2 x 2 run, and the 4 processes'
    findings on NEW_SHAPES and `init_fn`'s peaks; made once a session."""
    tmp = run_once(tmp_path_factory, "elastic", _run_elastic)
    return str(tmp / "ckpt"), dict(np.load(tmp / "bad.npz"))


def test_init_holds_a_quarter_of_the_tree(saved):
    """`init_fn` at 2 x 2 draws and places one leaf at a time and makes
    AdamW's moments on the placed parameters: each rank's peak grows by a
    quarter of the (params, m, v) tree, a few whole leaves in flight, and
    slack (a whole tree on each rank first would be 4x the quarter)."""
    _, found = saved
    for grew, tree, leaf in found["peaks"]:
        assert grew <= tree / 4 + 3 * leaf + PEAK_SLACK, (grew, tree, leaf)


@pytest.mark.parametrize("shape", ["1x4", "4x1"])
def test_restore_onto_other_meshes(saved, shape):
    _, bad = saved
    assert bad[shape].size == 0, bad[shape]


def test_restore_onto_one_device(saved):
    import torch.distributed as dist

    ckpt_dir, _ = saved
    ckpt = Checkpointer(ckpt_dir)
    assert ckpt.all_steps() == [1]
    cfg = sr.port_cfg()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = pmesh.make_mesh((1, 1), device_type="cpu")
        restored, step = pelastic.elastic_restore(ckpt, _abstract(cfg), mesh,
                                                  _rules(cfg, mesh))
        assert step == 1
        assert _check(restored, cfg, mesh, ckpt.read(1)) == []
        # the AdamW count is replicated, and the step it saved is the first
        assert int(restored[1].count.full_tensor()) == 1
    finally:
        dist.destroy_process_group()


def test_checkpoint_manifest_holds_whole_leaves(saved):
    """The manifest records logical (whole) shapes, in the reference's
    spelling of a (params, AdamWState) pair."""
    ckpt_dir, _ = saved
    leaves = Checkpointer(ckpt_dir).read(1)
    cfg = sr.port_cfg()
    assert leaves["0/embed/table"].shape == (cfg.vocab, cfg.d_model)
    assert leaves["1/.m/layers/0/attn/wq/w"].shape == (cfg.d_model, cfg.n_heads * cfg.hd)
    assert int(leaves["1/.count"]) == 1


def test_reshard_plan_equals_reference():
    rs = np.random.default_rng(0)
    leaves = {f"leaf{i}": (tuple(int(d) for d in rs.integers(1, 64, rs.integers(0, 4))),
                           int(rs.choice([2, 4])), bool(rs.integers(0, 2)))
              for i in range(40)}
    for old, new in (((2, 2), (1, 4)), ((2, 2), (2, 2)), ((16, 16), (2, 16, 16)),
                     ((32, 8), (16, 8))):
        assert pelastic.reshard_plan(old, new, leaves) == \
            relastic.reshard_plan(old, new, leaves)
