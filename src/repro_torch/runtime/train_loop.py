"""Training step factory + driver loop, in torch.

Mirrors `repro.runtime.train_loop`:

  * `make_train_step` builds a step with gradient accumulation over
    `num_microbatches` (fp32 sums in micro-batch order from zeros, then
    divided; the loss and metrics are means over the micro-batches), the
    remat policy forwarded into the model stack (`models.remat`), and the
    AdamW update (fp32 state, global-norm clipping) in place;
  * `train` is the host loop: deterministic data, periodic checkpoints
    (async), restart from the latest, and optionally the neighbor-steal
    token rebalancing of packed batches before each step (the paper's
    technique in the data path, through `core.balancer.rebalance_reference`).

The parameters are fp32 masters (the family's `init(..., masters=True)`,
or the reference's through `convert.master_params`), which every use casts
to cfg.dtype. On the card the forward runs the hand-written kernels under
autograd (`kernels.ops`). `train` runs on the CUDA device unless it is
given another, and raises when there is no card; there is no `jit`.

Checkpoints are the reference's: a mid-run save comes after step s has
run, for s > start and s % ckpt_every == 0, under the label s; the final
one under `steps`. A restart from a mid-run checkpoint therefore runs step
s again (its batch twice, the schedule one step on), as the reference's
does.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from .. import core
from ..checkpoint import Checkpointer
from ..core import balancer, rng
from ..data import packing, synthetic
from ..models import layers as L
from ..models import registry
from ..optim import adamw


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    num_microbatches: int = 1
    remat: str = "none"            # none | full | dots
    ckpt_dir: str = ""
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0
    balance_tokens: bool = False   # neighbor-steal packing balance
    rebalance_rounds: int = 2


def _unflatten(tree, values):
    """`tree`'s structure with its leaves taken in order from `values`."""
    it = iter(values)
    return adamw.tree_map(lambda _: next(it), tree)


def loss_and_grads(model_fns: registry.ModelFns, cfg, params, batch,
                   remat: str = "none"):
    """(loss, metrics, grads) of `model_fns.loss_fn` at `params`, the
    reference's `value_and_grad` with `has_aux`: the loss and metrics
    detached, the grads a tree of the parameters' structure (zeros for a
    leaf the loss does not reach)."""
    flat = adamw.leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, metrics = model_fns.loss_fn(params, cfg, batch, remat=remat)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            _unflatten(params, grads))


def make_train_step(cfg, model_fns: registry.ModelFns, opt_cfg: adamw.AdamWConfig,
                    num_microbatches: int = 1, remat: str = "none"):
    """Returns train_step(params, opt_state, batch) → (params, opt_state,
    metrics), the parameters and state updated in place. batch leaves have
    a leading global-batch dim divisible by num_microbatches."""

    def train_step(params, opt_state, batch):
        if num_microbatches == 1:
            loss, metrics, grads = loss_and_grads(model_fns, cfg, params, batch, remat)
        else:
            n = num_microbatches
            acc = adamw.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                                 params)
            l_sum = None
            per_mb = []
            for mb in microbatches(batch, n):
                loss, metrics, g = loss_and_grads(model_fns, cfg, params, mb, remat)
                adamw.tree_map(lambda a, b: a.add_(b.to(torch.float32)), acc, g)
                del g
                # 0 + loss is loss: the sum from zeros, in micro-batch order
                l_sum = loss if l_sum is None else l_sum + loss
                per_mb.append(metrics)
            grads = adamw.tree_map(lambda g: g / n, acc)
            loss = l_sum / n
            metrics = {k: torch.mean(torch.stack([m[k] for m in per_mb]))
                       for k in per_mb[0]}
        params, opt_state, opt_metrics = adamw.update(opt_cfg, grads, opt_state, params)
        metrics = dict(metrics, **opt_metrics, loss=loss)
        return params, opt_state, metrics

    return train_step


def microbatches(batch: dict, n: int) -> list:
    """The n micro-batches of `batch`, the reference's split: micro-batch i
    is rows [i·B/n, (i+1)·B/n) of every leaf. A DTensor leaf (the sharded
    step's batch, its rows over the data-parallel mesh dims) is gathered
    whole (token ids and the loss mask, B x S), and each micro-batch's rows
    are sharded over those mesh dims again (`layers.batch_rows`), so every
    micro-batch's activations stay sharded."""
    whole = {k: L.gathered(v) for k, v in batch.items()}
    whole = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:]) for k, v in whole.items()}
    return [{k: L.row_sharded(v[i]) for k, v in whole.items()} for i in range(n)]


@torch.no_grad()
def load_into(tree, arrays):
    """Write a restored tree of numpy arrays into `tree`'s tensors, in place."""
    adamw.tree_map(lambda t, a: t.copy_(torch.from_numpy(np.asarray(a))), tree, arrays)


def train(arch: str, train_cfg: TrainConfig, opt_cfg: adamw.AdamWConfig,
          data_cfg: synthetic.DataConfig, model_cfg=None, hooks=None, device=None,
          init_state=None):
    """End-to-end single-device training driver. Returns (params, history).

    The initial state is the family's `init(seed=train_cfg.seed,
    masters=True)` and `adamw.init`, or `init_state`, a (params, opt_state)
    pair on `device` (e.g. the reference's, through `convert`), which is
    updated in place. `hooks` are called as hook(step, params, metrics)
    after each step. The sharded step (FSDP + TP on a `DeviceMesh`) is
    `launch.train.build_sharded_train`."""
    model_cfg = model_cfg or registry.get_config(arch)
    fns = registry.get_fns(model_cfg)
    dev = core.resolve_device(device, "repro_torch trains")
    if init_state is None:
        params = fns.init(model_cfg, seed=train_cfg.seed, device=dev, masters=True)
        opt_state = adamw.init(params)
    else:
        params, opt_state = init_state
    step_fn = make_train_step(model_cfg, fns, opt_cfg, train_cfg.num_microbatches,
                              train_cfg.remat)

    ckpt = Checkpointer(train_cfg.ckpt_dir) if train_cfg.ckpt_dir else None
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        restored, start = ckpt.restore((params, opt_state))
        load_into((params, opt_state), restored)
        print(f"[train] restored step {start}")

    history = []
    t0 = time.time()
    try:
        for step in range(start, train_cfg.steps):
            batch = _make_batch(model_cfg, data_cfg, step, train_cfg, dev)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if hooks:
                for h in hooks:
                    h(step, params, metrics)
            if step % train_cfg.log_every == 0 or step == train_cfg.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                history.append({"step": step, **m})
                dt = time.time() - t0
                print(f"[train] step {step:5d} loss {m['loss']:.4f} "
                      f"lr {m.get('lr', 0):.2e} ({dt:.1f}s)")
            if ckpt and step > start and step % train_cfg.ckpt_every == 0:
                ckpt.save(step, (params, opt_state))
        if ckpt:
            ckpt.save(train_cfg.steps, (params, opt_state))
    finally:
        if ckpt:
            ckpt.wait()
    return params, history


def _make_batch(model_cfg, data_cfg, step: int, train_cfg: TrainConfig, device="cpu"):
    """The step's batch on `device`: {tokens (B, S) int64, loss_mask (B, S)
    fp32} from the synthetic corpus, or from `balance_packed_batch`; the
    VLM family adds `prefix_embeds` and the encoder-decoder `frames`
    (`frontend_inputs` from the data seed), as the reference's does."""
    d = synthetic.token_batch(
        dataclasses.replace(data_cfg, vocab=model_cfg.vocab), 0, 1, step)
    if train_cfg.balance_tokens:
        d = balance_packed_batch(model_cfg, data_cfg, step, train_cfg, device)
    batch = {"tokens": torch.as_tensor(d["tokens"], device=device).long(),
             "loss_mask": torch.as_tensor(d["loss_mask"], device=device)}
    return dict(batch, **frontend_inputs(model_cfg, batch["tokens"].shape[0],
                                         data_cfg.seed, step, device))


def frontend_inputs(model_cfg, batch: int, seed: int, step: int, device="cpu") -> dict:
    """The stub frontend's output of a step: a VLM's `prefix_embeds` or an
    encoder-decoder's `frames`, (batch, n_frontend_tokens, d_model) fp32,
    normal · 0.02 from fold_in(PRNGKey(seed), step) (`core.rng.normal`:
    the reference's `jax.random.normal` draw); {} for the other families."""
    name = {"vlm": "prefix_embeds", "encdec": "frames"}.get(model_cfg.family)
    if name is None:
        return {}
    shape = (batch, model_cfg.n_frontend_tokens, model_cfg.d_model)
    key = rng.fold_in(rng.PRNGKey(seed), step)
    return {name: (rng.normal(key, math.prod(shape), device) * 0.02).view(shape)}


def balance_packed_batch(model_cfg, data_cfg, step: int, train_cfg: TrainConfig,
                         device="cpu"):
    """Pack variable-length docs per shard, then neighbor-steal-rebalance the
    sequences across shards (`balancer.rebalance_reference` on `device`).
    Returns a merged global batch dict of numpy arrays (tokens, loss_mask),
    the reference's."""
    n_shards = 4
    local = data_cfg.global_batch // n_shards
    packs = []
    for sh in range(n_shards):
        docs = synthetic.documents(
            dataclasses.replace(data_cfg, vocab=model_cfg.vocab),
            sh, step, n_docs=local * 2)
        p, _ = packing.pack_documents(docs, local, data_cfg.seq_len)
        packs.append(p)
    # items = row indices packed as payload; we rebalance row costs
    items = np.stack([np.stack([p["tokens"][r] for r in range(local)])
                      for p in packs])                       # (S, local, seq)
    costs = np.stack([p["row_cost"] for p in packs])
    valid = costs > 0
    it, _, _, _ = balancer.rebalance_reference(
        torch.as_tensor(items.reshape(n_shards, local, -1), device=device),
        torch.as_tensor(valid, device=device), torch.as_tensor(costs, device=device),
        rounds=train_cfg.rebalance_rounds)
    toks = it.cpu().numpy().reshape(n_shards * local, data_cfg.seq_len)
    mask = (toks != 0).astype(np.float32)
    return {"tokens": toks.astype(np.int32), "loss_mask": mask}
