"""Training launcher: the port of `repro.launch.train` on one device, with
the same flags, `--device`, restart from the latest checkpoint and the same
log lines.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --steps 20 --batch 8 --seq 512                      # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --steps 20 --reduced --batch 8 --seq 64 --device cpu --ckpt /tmp/ckpt

The model starts from the family's random fp32 masters (seed 0) and AdamW
state, the batches from the deterministic synthetic corpus
(`data.synthetic`). `--reduced` shrinks the model to head dim 8 (qwen2),
16 (rwkv head dim 16) or 32, which the CUDA attention and `wkv6` kernels
(head dims 64, 128 and 256; `wkv6` 64) refuse: use it with `--device cpu`.
The reference's FSDP + TP placement over a device mesh
(`build_sharded_train`) comes with `launch/shardings.py` (ROADMAP.md,
Queue 1 item 15.8). A last line gives the steps' wall and tokens a second,
the first step (warm-up) apart.
"""

from __future__ import annotations

import argparse
import time

from repro_torch import core
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import synthetic
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import TrainConfig, _make_batch, load_into, make_train_step


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

    cfg = registry.get_config(args.arch)
    if args.reduced:
        cfg = registry.reduced(cfg)
    fns = registry.get_fns(cfg)
    dev = core.resolve_device(args.device, "repro_torch trains")
    opt_cfg = adamw.AdamWConfig(lr_peak=args.lr, warmup_steps=10,
                                total_steps=args.steps)
    step_fn = make_train_step(cfg, fns, opt_cfg, args.microbatches, args.remat)
    params = fns.init(cfg, seed=0, device=dev, masters=True)
    opt_state = adamw.init(params)
    ckpt = Checkpointer(args.ckpt) if args.ckpt else None
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        restored, start = ckpt.restore((params, opt_state))
        load_into((params, opt_state), restored)
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
                      f"loss {float(metrics['loss']):.4f} ({time.time()-t0:.1f}s)",
                      flush=True)
            if t_first is None:
                float(metrics["loss"])
                t_first = time.time()
            done = step + 1
            if ckpt and done < args.steps and done % args.ckpt_every == 0:
                ckpt.save(done, (params, opt_state))
        if ckpt:
            ckpt.save(args.steps, (params, opt_state))
    finally:
        if ckpt:
            ckpt.wait()
    n = args.steps - start - 1
    if n > 0:
        wall = time.time() - t_first
        print(f"[launch/train] {n} steps after the first in {wall:.3f} s "
              f"({n * args.batch * args.seq / wall:.1f} tokens/s) on {dev}")


if __name__ == "__main__":
    main()
