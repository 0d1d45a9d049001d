"""Serving launcher: prefill + decode, then the steal-rebalancing occupancy
study — the port of `repro.launch.serve`, with the same flags and
`--device`.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --requests 8 --prompt-len 512 --max-new 64          # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --reduced --device cpu                               # plain path
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \\
      --requests 8 --prompt-len 512 --max-new 64          # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b \\
      --reduced --device cpu

Part 1 decodes a batch end to end with random weights (the family's
`init`, seed 0). The prompts are drawn by numpy from seed 0, so they are
not the reference script's prompts, which come from `jax.random`. Part 2 runs
`simulate_serving` on the same Pareto request lengths as the reference
script (numpy, seed 0); with `--strategy global` it runs the neighbor
rebalancer too, as the reference does, and `none` turns rebalancing off.
`--reduced` shrinks the model to head dim 8 (qwen2-0.5b, phi3.5-moe), an
rwkv head dim of 16 (rwkv6-1.6b), head dim 16 (recurrentgemma-9b) or 32
(qwen2-moe), which the CUDA attention and `wkv6` kernels (head dims 64, 128
and 256; `wkv6` 64) refuse: use it with `--device cpu`. At full size
qwen2-moe-a2.7b (15.1 B parameters in the tree, ~30 GB in bf16) fits one
80 GB card; phi3.5-moe-42b-a6.6b (~84 GB) does not. llava-next-mistral-7b
serves the text alone, without prefix embeddings, as the reference's
launcher does; whisper-tiny is refused (its prefill needs frames, which
the reference's serving loop does not pass: ROADMAP Queue 3).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.models import registry
from repro_torch.runtime import serve_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--strategy", default="neighbor",
                    choices=["neighbor", "global", "none"])
    ap.add_argument("--rebalance-every", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    cfg = registry.get_config(args.arch)
    if args.reduced:
        cfg = registry.reduced(cfg)
    fns = registry.get_fns(cfg)
    params = fns.init(cfg, seed=0, device=args.device)

    sc = serve_loop.ServeConfig(
        batch_slots=args.slots, n_shards=args.shards,
        max_new_tokens=args.max_new, prompt_len=args.prompt_len,
        cache_len=args.prompt_len + args.max_new + 8,
        rebalance=(args.strategy != "none"),
        rebalance_every=args.rebalance_every)

    # 1) real-model path: decode a batch end to end
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (min(args.requests, 8), args.prompt_len), dtype=np.int64)
    t0 = time.time()
    outs, info = serve_loop.serve_requests(cfg, params, sc, prompts, fns,
                                           device=args.device)
    first = outs[0].cpu().numpy()
    print(f"[serve] decoded {info['decoded']} tokens in {time.time()-t0:.1f}s")
    print(f"[serve] first output: {first[:12]}")

    # 2) slot-level occupancy study with uneven request lengths
    rng = np.random.default_rng(0)
    lens = np.minimum(
        (rng.pareto(1.2, (args.shards, args.slots * 4)) * 16 + 4), 64
    ).astype(np.int32)
    stats = serve_loop.simulate_serving(cfg, sc, lens, device=args.device)
    print(f"[serve] occupancy={stats.occupancy:.3f} moved={stats.moved} "
          f"steps={stats.steps} completed={stats.completed} "
          f"(strategy={args.strategy})")


if __name__ == "__main__":
    main()
