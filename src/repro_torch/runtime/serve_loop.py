"""Batched serving with neighbor-steal request rebalancing, in torch.

Mirrors `repro.runtime.serve_loop`:

  * `serve_requests` runs the real model — prefill of every prompt, then
    greedy decode to EOS or `max_new_tokens` — on one device, through the
    model family's kernels (`registry.get_fns`): for the dense transformer
    `flash_attention` (prefill) and `decode_attention` (decode), for the
    MoE transformer (qwen2-moe, phi3.5-moe) the same kernels at head dim
    128 around the neighbor-steal expert dispatch, for rwkv6
    `wkv6` (both), for the RG-LRU hybrid (recurrentgemma) `rglru` (both)
    with windowed `flash_attention` and `decode_attention` on a ring KV
    cache;
  * `simulate_serving` is the slot-level serving simulation that measures
    the occupancy won by steal-rebalancing request backlogs between shards
    (`core.balancer`), integer-exact against the reference.

Both run on the CUDA device unless the caller passes ``device="cpu"``, and
raise when no card is there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import balancer
from ..models import registry
from ..models.transformer import resolve_device


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_slots: int = 8           # decode slots per shard
    n_shards: int = 4
    max_new_tokens: int = 32
    prompt_len: int = 16
    cache_len: int = 128
    eos_id: int = 1
    rebalance_every: int = 4
    rebalance: bool = True
    seed: int = 0


@dataclasses.dataclass
class ServeStats:
    steps: int = 0
    completed: int = 0
    moved: int = 0
    idle_slot_steps: int = 0
    busy_slot_steps: int = 0

    @property
    def occupancy(self) -> float:
        tot = self.idle_slot_steps + self.busy_slot_steps
        return self.busy_slot_steps / max(tot, 1)


def simulate_serving(model_cfg, serve_cfg: ServeConfig,
                     request_lengths: np.ndarray, device=None) -> ServeStats:
    """Slot-level serving simulation (the reference's, step for step).

    Each shard owns `batch_slots` active decode slots plus a backlog of
    admitted-but-waiting requests. A decode step advances every occupied
    slot one token; completed slots refill from the shard's own backlog
    (on the host, as the reference does); every `rebalance_every` steps the
    shards run one neighbor-only steal round over their backlogs.

    request_lengths: (n_shards, requests_per_shard) decode lengths; the
    first `batch_slots` start active, the rest are backlog.
    """
    dev = resolve_device(device)
    S, R = request_lengths.shape
    K = min(serve_cfg.batch_slots, R)
    lens = np.asarray(request_lengths, np.int32)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    active = t(lens[:, :K])
    a_valid = active > 0
    back_items = t(lens[:, K:, None])
    back_cost = t(lens[:, K:])
    back_valid = back_cost > 0
    stats = ServeStats()

    def refill(active, a_valid, b_valid, b_cost):
        """Move backlog items into free active slots (local, per shard)."""
        active, a_valid = active.cpu().numpy().copy(), a_valid.cpu().numpy().copy()
        b_valid, b_cost = b_valid.cpu().numpy().copy(), b_cost.cpu().numpy()
        for s in range(S):
            free = np.where(~a_valid[s])[0]
            avail = np.where(b_valid[s])[0]
            for j in range(min(len(free), len(avail))):
                active[s, free[j]] = b_cost[s, avail[j]]
                a_valid[s, free[j]] = True
                b_valid[s, avail[j]] = False
        return t(active), t(a_valid, torch.bool), t(b_valid, torch.bool)

    for step in range(100_000):
        active, a_valid, back_valid = refill(active, a_valid, back_valid, back_cost)
        if not bool(a_valid.any()) and not bool(back_valid.any()):
            break
        stats.steps += 1
        stats.busy_slot_steps += int(a_valid.sum())
        stats.idle_slot_steps += int((~a_valid).sum())
        active = torch.where(a_valid, active - 1, 0)
        done = a_valid & (active == 0)
        stats.completed += int(done.sum())
        a_valid = a_valid & ~done
        if serve_cfg.rebalance and step % serve_cfg.rebalance_every == 0 \
                and back_items.shape[1] > 0:
            before = back_valid.sum(1)
            back_items, back_valid, back_cost, _ = balancer.rebalance_reference(
                back_items, back_valid, back_cost, rounds=1)
            stats.moved += int((back_valid.sum(1) - before).abs().sum()) // 2
    return stats


def serve_requests(arch_cfg, params, serve_cfg: ServeConfig, prompts,
                   fns: registry.ModelFns | None = None, device=None):
    """Real-model serving: prefill each prompt, decode greedily to EOS or
    `max_new_tokens`.

    prompts: (N, prompt_len) int (numpy or tensor); `params` must already
    lie on `device` (default: the CUDA device). The model's cache (the KV
    cache, rwkv6's fixed-size state, or the hybrid's recurrent states and
    ring caches) is whatever its `prefill` returns. Returns (outputs (N,
    max_new_tokens) int32 on the device, {"decoded": token count}). Single
    shard: the multi-shard slot logic is `simulate_serving`'s.
    """
    dev = resolve_device(device)
    fns = fns or registry.get_fns(arch_cfg)
    # the encoder-decoder's embedding lies in its decoder's tree
    table = params.get("decoder", params)["embed"]["table"]
    if table.device.type != dev.type:
        raise ValueError(f"params lie on {table.device}, serving on {dev}")
    tokens = torch.as_tensor(prompts).to(device=dev, dtype=torch.long)
    N = tokens.shape[0]
    logits, cache, pos = fns.prefill(params, arch_cfg, tokens, serve_cfg.cache_len)
    tok = torch.argmax(logits, -1).to(torch.int32)
    outs = [tok]
    alive = torch.ones((N,), dtype=torch.bool, device=dev)
    for _ in range(serve_cfg.max_new_tokens - 1):
        lg, cache, pos = fns.decode_step(params, arch_cfg, tok.long(), cache, pos)
        tok = torch.argmax(lg, -1).to(torch.int32)
        alive = alive & (tok != serve_cfg.eos_id)
        outs.append(torch.where(alive, tok, serve_cfg.eos_id))
    return torch.stack(outs, dim=1), {"decoded": len(outs) * N}
