"""MoE neighbor-steal overflow on the port: drop rate against capacity
factor, the ``drop`` policy against ``neighbor_steal`` (the paper's
technique inside the dispatch path), the reference's
`benchmarks/moe_overflow.py`.

One MoE layer (E 16 experts, top-2, d 64, d_ff_expert 4·d, no shared
experts) on 2048 tokens skewed by a shared offset (skewed routing, the
worst case for capacity), at capacity factors 0.5, 0.75, 1.0 and 1.25.
Weights and tokens come from a seeded `torch.Generator` on the device (not
the reference's `jax.random` draws); `run` also takes given parameters and
tokens, so that the reference's can be fed to both.

    python -m repro_torch.benchmarks.moe_overflow              # on the card
    python -m repro_torch.benchmarks.moe_overflow --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..core import resolve_device
from ..models import moe
from ..models.config import MoEConfig
from .common import device_name, emit

POLICIES = ("drop", "neighbor_steal")


def base_config(E: int = 16, k: int = 2, d: int = 64) -> MoEConfig:
    return MoEConfig(n_experts=E, top_k=k, n_shared=0, d_ff_expert=4 * d)


def make_inputs(E: int = 16, k: int = 2, d: int = 64, tokens: int = 2048,
                seed: int = 0, device=None):
    """(params, x (1, tokens, d)) in fp32 on `device`: weights normal(0,
    0.02) (`moe.moe_init`), tokens N(0, 1) plus one N(0, 4) offset shared by
    all, from a `torch.Generator` seeded with `seed`."""
    dev = resolve_device(device, "moe_overflow runs")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev) * 0.02

    params = moe.moe_init(d, base_config(E, k, d), normal)
    x = torch.randn((1, tokens, d), generator=gen, device=dev)
    x = x + torch.randn((1, 1, d), generator=gen, device=dev) * 2.0
    return params, x


def run(E: int = 16, k: int = 2, d: int = 64, tokens: int = 2048,
        cfs=(0.5, 0.75, 1.0, 1.25), params=None, x=None, device=None,
        seed: int = 0, csv: bool = True) -> dict:
    """{capacity factor: {policy: dropped fraction of the token slots}};
    the inputs are `make_inputs`'s unless `params` and `x` are given."""
    if params is None or x is None:
        params, x = make_inputs(E, k, d, tokens, seed, device)
    base = base_config(E, k, d)
    out = {}
    for cf in cfs:
        drops = {}
        for policy in POLICIES:
            cfg = dataclasses.replace(base, capacity_factor=cf, overflow=policy)
            _, m = moe.moe_apply(params, x, cfg)
            drops[policy] = float(m["moe_dropped"])
        out[cf] = drops
        if csv:
            saved = drops["drop"] - drops["neighbor_steal"]
            emit(f"moe_overflow/cf={cf}", 0.0,
                 f"drop={drops['drop']*100:.2f}%;"
                 f"neighbor_steal={drops['neighbor_steal']*100:.2f}%;"
                 f"saved={saved*100:.2f}pp")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print("# MoE overflow: drop vs neighbor_steal")
    t0 = time.perf_counter()
    out = run(device=args.device, seed=args.seed)
    print(f"# wall {time.perf_counter() - t0:.3f} s on {device_name(args.device)}")
    return out


if __name__ == "__main__":
    main()
