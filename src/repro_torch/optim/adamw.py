"""AdamW with decoupled weight decay, global-norm clipping, fp32 state, in
torch.

Mirrors `repro.optim.adamw` operation for operation: the moments are fp32
trees of the parameters' structure (dicts and lists of tensors), `count` an
int32 scalar tensor, the bias corrections computed in fp32 from `count`,
and every leaf updated by the reference's sequence of elementwise ops,
each rounded to fp32 (no fused multiply-add across them). `update` works
under `torch.no_grad()` and writes the parameters and moments in place; it
returns them, with the new state and the metrics, as the reference does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    lr_min_ratio: float = 0.1


class AdamWState(NamedTuple):
    m: dict
    v: dict
    count: torch.Tensor


def tree_map(fn, *trees, leaf=()):
    """`fn` over the leaves of trees of one structure (dicts, lists, tuples
    and NamedTuples of tensors); nodes of a type in `leaf` count as
    leaves."""
    first = trees[0]
    if isinstance(first, leaf):
        return fn(*trees)
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees), leaf=leaf) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(tree_map(fn, *xs, leaf=leaf) for xs in zip(*trees)))
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *xs, leaf=leaf) for xs in zip(*trees))
    return fn(*trees)


def leaves(tree) -> list:
    """The tensors of a tree, dict keys in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    device = leaves(params)[0].device
    return AdamWState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                      count=torch.zeros((), dtype=torch.int32, device=device))


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to lr_min_ratio·lr_peak (fp32)."""
    step = step.to(torch.float32)
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr_min_ratio + (1 - cfg.lr_min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr_peak * cos)


def global_norm(tree) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """Returns (new_params, new_state, metrics). The parameters and moments
    are written in place (the returned trees are the given ones)."""
    grads = tree_map(lambda g: g.to(torch.float32), grads)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    count = state.count + 1
    lr = cosine_lr(cfg, count)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - torch.pow(b1, count.to(torch.float32))
    bc2 = 1 - torch.pow(b2, count.to(torch.float32))

    def upd(p, g, m, v):
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        mh = m / bc1
        vh = v / bc2
        step = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * step).to(p.dtype))

    tree_map(upd, params, grads, state.m, state.v)
    return params, AdamWState(state.m, state.v, count), {"lr": lr, "grad_norm": gnorm}
