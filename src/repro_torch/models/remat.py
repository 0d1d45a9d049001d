"""Activation recomputation ("remat") of a layer, the counterpart of the
reference's `jax.checkpoint` around its scanned layer body.

  * ``none`` — the layer as it is: autograd keeps its intermediates;
  * ``full`` — `torch.utils.checkpoint` around the layer: only its inputs
    are kept, and the backward pass runs the layer again;
  * ``dots`` — a selective checkpoint that keeps the outputs of the
    layer's plain matrix products (`aten.mm`, `aten.addmm`: a product with
    no batch dimension) and recomputes everything else, the counterpart of
    `jax.checkpoint_policies.dots_with_no_batch_dims_saveable`.

Remat changes what the backward pass holds and recomputes, never a value.
A hand-written kernel inside a recomputed layer is launched again in the
backward pass.
"""

from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as ckpt

MODES = ("none", "full", "dots")
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_PRODUCTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return ckpt.create_selective_checkpoint_contexts(_dots_policy)


def wrap(layer, remat: str):
    """`layer` (a function of tensors and trees of them) under `remat`."""
    if remat not in MODES:
        raise ValueError(f"remat {remat!r}: expected one of {MODES}")
    if remat == "none":
        return layer
    context = _dots_context if remat == "dots" else ckpt.noop_context_fn

    @functools.wraps(layer)
    def run(*args, **kwargs):
        if not torch.is_grad_enabled():
            return layer(*args, **kwargs)
        return ckpt.checkpoint(layer, *args, use_reentrant=False, context_fn=context,
                               **kwargs)
    return run
