"""Training launcher: the port of `repro.launch.train`, with the same flags,
`--device`, restart from the latest checkpoint and the same log lines.

Builds the FSDP + TP train step for a `DeviceMesh` (`build_sharded_train`)
with the parameter, optimizer and batch specs of `launch.shardings`, and
runs it:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --steps 20 --batch 8 --seq 512                      # one card, 1 x 1 mesh
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --steps 20 --reduced --batch 8 --seq 64 --device cpu --ckpt /tmp/ckpt
  PYTHONPATH=src torchrun --nproc-per-node 8 --nnodes 32 ... \\
      -m repro_torch.launch.train --arch granite-3-8b     # the production mesh

In one process the mesh is 1 x 1 ("data", "model") over a process group of
one (NCCL on the card, gloo with `--device cpu`); under `torchrun` with
more than one rank it is `launch.mesh.make_production_mesh()` (256 cards,
one a rank). Either way the parameters, AdamW's moments and the batch are
DTensors placed by their specs, and the step is `make_train_step` on them.

The model starts from the family's random fp32 masters (seed 0) and AdamW
state, the batches from the deterministic synthetic corpus
(`data.synthetic`). `--reduced` shrinks the model to head dim 8 (qwen2),
16 (rwkv head dim 16) or 32, which the CUDA attention and `wkv6` kernels
(head dims 64, 128 and 256; `wkv6` 64) refuse: use it with `--device cpu`.
A last line gives the steps' wall and tokens a second, the first step
(warm-up) apart.
"""

from __future__ import annotations

import argparse
import os
import socket
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.data import synthetic
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shardings as sh
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import TrainConfig, _make_batch, make_train_step

def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def build_sharded_train(arch: str, mesh, model_cfg=None, num_microbatches=1,
                        remat: str = "none", opt_cfg: adamw.AdamWConfig | None = None):
    """Returns (init_fn, step_fn, specs) with all shardings applied, as the
    reference's does.

    `init_fn(seed=0, state=None)` → (params, opt_state) as DTensors on
    `mesh`, each leaf placed by its spec (AdamW's m and v as their
    parameter, `count` replicated: ZeRO): the family's fp32 masters from
    `seed`, each leaf placed as soon as it is drawn (a rank holds its
    shards and at most one whole leaf, never the tree: `_placed_init`),
    and AdamW's zero state made on the placed parameters; or `state`, a
    whole (params, opt_state) pair alike on every rank (e.g. the
    reference's, through `convert`), of which each rank keeps its shards.

    `step_fn(params, opt_state, batch)` → (params, opt_state, metrics):
    `make_train_step` on the DTensors, the batch (whole tensors, alike on
    every rank) placed by `batch_specs` first. DTensor does what GSPMD does
    for the reference: weights sharded over "data" are gathered at use
    (FSDP, `layers.cast`), "model" shards heads and hidden units (TP: each
    product Megatron's on a rank's rows, `layers.dense`, a row-parallel
    partial sum reduced at the residual add, `layers.residual`), gradients
    come back reduced to the parameters' placements. The hand-written
    kernels run on each rank's local rows and
    heads or channels (`layers.local_shards`: `flash_attention`, `wkv6`,
    `rglru`); an MoE layer runs each "model" rank's E / tp experts
    (`layers.expert_shards`: expert parallelism over "model"), their
    places and the shared experts' tokens split again over "data", its
    routing over all B·S tokens as the reference's, its experts gathered
    over "data" only and again in the backward rather than kept; the
    cross entropy keeps
    the vocabulary sharded over "model" (`layers.vocab_nll`); with
    `cfg.seq_shard_axis` the residual's sequence is sharded between blocks.

    `specs`: {"params", "opt": trees of `shardings.NamedSharding`, "cfg"}.
    """
    cfg = model_cfg or registry.get_config(arch)
    fns = registry.get_fns(cfg)
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    drawn = []    # the leaves in the order `init` makes them
    abstract = fns.init(cfg, device="meta", masters=True,
                        place=lambda t: drawn.append(t) or t)
    pspecs = sh.param_specs(abstract, mesh, cfg)
    ospecs = sh.opt_specs(pspecs)

    def init_fn(seed: int = 0, state=None):
        if state is None:
            params = _placed_init(fns, cfg, seed, _mesh_device(mesh), mesh, abstract,
                                  drawn, pspecs)
            return params, sh.with_shardings(adamw.init(params), ospecs, mesh)
        params, opt_state = state
        return (sh.with_shardings(params, pspecs, mesh),
                sh.with_shardings(opt_state, ospecs, mesh))

    step = make_train_step(cfg, fns, opt_cfg, num_microbatches, remat)

    def step_fn(params, opt_state, batch):
        batch = sh.with_shardings(batch, sh.batch_specs(batch, mesh), mesh)
        return step(params, opt_state, batch)

    return init_fn, step_fn, {"params": sh.named_shardings(pspecs, mesh),
                              "opt": sh.named_shardings(ospecs, mesh), "cfg": cfg}


def _placed_init(fns, cfg, seed, dev, mesh, abstract, drawn, pspecs):
    """The family's fp32 masters from `seed`, `fns.init`'s own draws, each
    leaf distributed under its spec as soon as it is made (`init`'s
    `place`), so that the whole leaf can be freed before the next is drawn.
    `drawn` is the meta run's leaves in the order they were made, which
    maps the n-th leaf made to its spec in `pspecs` (the tree of
    `abstract`, the meta run's)."""
    spec_of = {}
    sh.zip_specs(lambda x, s: spec_of.__setitem__(id(x), s), abstract, pspecs)
    specs = iter([spec_of[id(t)] for t in drawn])
    return fns.init(cfg, seed=seed, device=dev, masters=True,
                    place=lambda t: sh.distribute(t, mesh, next(specs)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_mesh(device):
    """(mesh, whether this call formed the process group): the
    production mesh under `torchrun` with more than one rank, else a 1 x 1
    mesh over a process group of one."""
    import torch.distributed as dist

    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError("repro_torch trains on a CUDA device by default and none is "
                           "available; pass device='cpu' to run the plain PyTorch path")
    kind = "cpu" if cpu else "cuda"
    formed = not dist.is_initialized()
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if kind == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        if formed:
            dist.init_process_group("gloo" if cpu else "nccl")
        return mesh_lib.make_production_mesh(device_type=kind), formed
    if kind == "cuda":
        torch.cuda.set_device(torch.device(device) if device is not None
                              else torch.cuda.current_device())
    if formed:
        dist.init_process_group("gloo" if cpu else "nccl",
                                init_method=f"tcp://localhost:{_free_port()}",
                                world_size=1, rank=0)
    return mesh_lib.make_mesh((1, 1), device_type=kind), formed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale model (keeps family structure)")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    cfg = registry.get_config(args.arch)
    if args.reduced:
        cfg = registry.reduced(cfg)
    mesh, formed = launch_mesh(args.device)
    try:
        _run(args, cfg, mesh)
    finally:
        if formed:
            dist.destroy_process_group()


def _run(args, cfg, mesh):
    opt_cfg = adamw.AdamWConfig(lr_peak=args.lr, warmup_steps=10,
                                total_steps=args.steps)
    init_fn, step_fn, specs = build_sharded_train(
        args.arch, mesh, model_cfg=cfg, num_microbatches=args.microbatches,
        remat=args.remat, opt_cfg=opt_cfg)
    dev = _mesh_device(mesh)
    params, opt_state = init_fn(0)
    ckpt = Checkpointer(args.ckpt) if args.ckpt else None
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        (params, opt_state), start = ckpt.restore(
            (params, opt_state), shardings=(specs["params"], specs["opt"]))
        print(f"[launch/train] restored step {start}")

    dc = synthetic.DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                              global_batch=args.batch)
    tc = TrainConfig(steps=args.steps)
    t0 = time.time()
    t_first = None
    try:
        for step in range(start, args.steps):
            batch = _make_batch(cfg, dc, step, tc, dev)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if step % 10 == 0 or step == args.steps - 1:
                print(f"[launch/train] step {step:5d} "
                      f"loss {float(metrics['loss'].full_tensor()):.4f} "
                      f"({time.time()-t0:.1f}s)", flush=True)
            if t_first is None:
                float(metrics["loss"].full_tensor())
                t_first = time.time()
            if ckpt and step > start and step % args.ckpt_every == 0:
                ckpt.save(step, (params, opt_state))
        if ckpt:
            ckpt.save(args.steps, (params, opt_state))
    finally:
        if ckpt:
            ckpt.wait()
    n = args.steps - start - 1
    if n > 0:
        wall = time.time() - t_first
        shape = "x".join(str(s) for s in mesh.shape)
        print(f"[launch/train] {n} steps after the first in {wall:.3f} s "
              f"({n * args.batch * args.seq / wall:.1f} tokens/s) on {dev}, "
              f"mesh {shape}")


if __name__ == "__main__":
    main()
