"""Mixture-of-Experts layer with capacity-bounded dispatch and the paper's
neighbor-steal overflow policy, in torch.

Mirrors `repro.models.moe` (`moe_init`, `_positions_in_expert`,
`moe_apply`) step for step:

  1. router logits (in the activations' type, then fp32) → softmax →
     top-k experts per token, ties to the lower expert index (a stable
     descending sort, as `jax.lax.top_k` breaks them), gates renormalised;
  2. token-slots are sorted by expert id (a stable sort); each expert
     keeps the first C = ceil(T·k / E_real · capacity_factor) slots,
     clamped to [1, T] and computed in Python floats, as the reference
     does (at decode, T = batch 8, that is C = 1 for qwen2-moe);
  3. overflow ``drop`` drops the rest; ``neighbor_steal`` offers each
     overflowing slot to the ring neighbour (e + 1) mod E_real, which takes
     it into its spare capacity after its own kept slots, in sorted order:
     the paper's single-hop stealing inside the dispatch;
  4. the experts run as three batched products over the (E, C, D) dispatch
     buffer (`torch.bmm`, as the reference leaves its einsums to XLA; no
     Pallas kernel is on this path); every dropped slot writes the pad row
     E·C, which is thrown away;
  5. the combine weights each slot's expert output by its gate and sums a
     token's k slots in fp32 (the reference scatter-adds them in the
     activations' type; the order is the port's own and deterministic on
     the card, where an atomic scatter-add would not be).

Shared experts run densely on every token. Padded experts (`ep_pad_to`)
get NEG_INF router logits, so no token routes to them. `routing`, when
given, replaces the top-k choice by the given expert ids (the gates are
still the router's probabilities of those experts): a caller that holds a
run's choices can replay them through a path whose attention rounds
differently, since a top-k choice over many experts can flip on one bf16
rounding. The serving path never passes it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .config import MoEConfig

NEG_INF = -1e30


def moe_init(d_model: int, cfg: MoEConfig, normal) -> dict:
    """The MoE parameters: `normal(*shape)` draws each weight (the
    transformer's init passes normal(0, 0.02) in cfg.dtype, the reference's
    distribution). E = n_experts + ep_pad_to experts."""
    E = cfg.n_experts + cfg.ep_pad_to
    p = {"router": {"w": normal(d_model, E)},
         "wg": normal(E, d_model, cfg.d_ff_expert),
         "wu": normal(E, d_model, cfg.d_ff_expert),
         "wd": normal(E, cfg.d_ff_expert, d_model)}
    if cfg.n_shared:
        dff_s = cfg.d_ff_shared or cfg.d_ff_expert
        p["shared"] = {"wg": normal(cfg.n_shared, d_model, dff_s),
                       "wu": normal(cfg.n_shared, d_model, dff_s),
                       "wd": normal(cfg.n_shared, dff_s, d_model)}
    return p


def capacity_of(T: int, cfg: MoEConfig, capacity: int | None = None) -> int:
    """Slots an expert keeps: `capacity` if given, else ceil(T·k / E_real ·
    capacity_factor) in Python floats; clamped to [1, T]."""
    C = capacity if capacity is not None else int(
        np.ceil(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(min(C, T), 1)


def _positions_in_expert(sorted_eid: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Rank of each sorted slot within its expert segment."""
    experts = torch.arange(n_experts, device=sorted_eid.device, dtype=sorted_eid.dtype)
    starts = torch.searchsorted(sorted_eid, experts, right=False)
    return (torch.arange(sorted_eid.shape[0], device=sorted_eid.device)
            - starts[sorted_eid.clamp(0, n_experts - 1)])


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """How often each of 0..n-1 occurs in `ids` (int64). Not `bincount`,
    which reads the largest id back to the host on the card."""
    return torch.zeros(n, dtype=torch.long, device=ids.device).index_add_(
        0, ids, torch.ones_like(ids))


def route(params, xf: torch.Tensor, cfg: MoEConfig, routing=None):
    """Router of `moe_apply` on xf (T, D): (fp32 probabilities (T, E), gates
    (T, k) renormalised, expert ids (T, k) int64). With `routing` (T, k)
    the given ids are taken in place of the top-k choice."""
    E_real = cfg.n_experts
    E = E_real + cfg.ep_pad_to
    logits = torch.matmul(xf, params["router"]["w"].to(xf.dtype)).float()
    if cfg.ep_pad_to:
        pad = torch.arange(E, device=xf.device) >= E_real
        logits = logits.masked_fill(pad, NEG_INF)
    probs = torch.softmax(logits, dim=-1)                         # (T, E)
    if routing is None:
        # lax.top_k: descending, ties to the lower index
        gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate_vals, expert_ids = gate_vals[:, :cfg.top_k], expert_ids[:, :cfg.top_k]
    else:
        expert_ids = torch.as_tensor(routing, device=xf.device).long()
        gate_vals = probs.gather(1, expert_ids)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gate_vals, expert_ids


def moe_apply(params, x, cfg: MoEConfig, capacity: int | None = None, routing=None):
    """x (B, S, D) → (y (B, S, D), metrics): `moe_dropped` and
    `moe_dropped_pre_steal` (fractions of the T·k slots, fp32 scalars) and
    `moe_aux` (the Switch-style load-balance loss over the real experts).
    `routing` (B·S, k) expert ids replaces the router's choice (see the
    module docstring)."""
    B, S, D = x.shape
    T = B * S
    E_real = cfg.n_experts
    E = E_real + cfg.ep_pad_to
    k = cfg.top_k
    dev = x.device
    xf = x.reshape(T, D)
    probs, gate_vals, expert_ids = route(params, xf, cfg, routing)
    C = capacity_of(T, cfg, capacity)

    eid = expert_ids.reshape(T * k)
    gates = gate_vals.reshape(T * k)
    token_of = torch.arange(T * k, device=dev) // k

    order = torch.argsort(eid, stable=True)
    sorted_eid = eid[order]
    pos = _positions_in_expert(sorted_eid, E)
    keep = pos < C
    final_eid, final_pos = sorted_eid, pos

    dropped_first = (~keep).sum()
    if cfg.overflow == "neighbor_steal":
        # overflow slots go to the ring neighbour e + 1 (a single hop on the
        # EP mesh) and fill its spare capacity after its own kept slots
        kept_per_e = _counts(torch.where(keep, sorted_eid, E), E + 1)[:E]
        steal_eid = (sorted_eid + 1) % E_real
        steal_key = torch.where(keep, E, steal_eid)               # sentinel E for kept
        order2 = torch.argsort(steal_key, stable=True)
        sorted2 = steal_key[order2]
        pos2 = _positions_in_expert(sorted2, E)
        base = kept_per_e[sorted2.clamp(0, E - 1)]
        keep2 = torch.zeros_like(keep)
        keep2[order2] = (sorted2 < E) & (base + pos2 < C)
        pos_steal = torch.zeros_like(pos)
        pos_steal[order2] = base + pos2
        final_eid = torch.where(keep2, steal_eid, final_eid)
        final_pos = torch.where(keep2, pos_steal, final_pos)
        keep = keep | keep2
    dropped = (~keep).sum()

    # dispatch: an (E·C + 1, D) buffer; dropped slots write the pad row E·C
    dst = torch.where(keep, final_eid * C + final_pos.clamp(0, C - 1), E * C)
    src_tok = token_of[order]
    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=dev)
    buf[dst] = xf[src_tok]
    hbuf = buf[:E * C].view(E, C, D)

    g = torch.bmm(hbuf, params["wg"].to(x.dtype))
    u = torch.bmm(hbuf, params["wu"].to(x.dtype))
    o = torch.bmm(F.silu(g) * u, params["wd"].to(x.dtype))

    # combine: slot i of the sorted order is slot order[i] of (token, j);
    # its output weighted by its gate (0 if dropped), a token's k slots
    # summed in fp32
    flat_o = torch.cat([o.reshape(E * C, D), torch.zeros((1, D), dtype=x.dtype, device=dev)])
    contrib = flat_o[dst] * (gates[order] * keep).to(x.dtype)[:, None]
    by_slot = torch.empty_like(contrib)
    by_slot[order] = contrib
    yf = by_slot.view(T, k, D).float().sum(1).to(x.dtype)

    if cfg.n_shared:
        sp = params["shared"]
        n, _, dff = sp["wg"].shape
        g = torch.matmul(xf, sp["wg"].to(x.dtype))                # (n, T, F)
        u = torch.matmul(xf, sp["wu"].to(x.dtype))
        h = (F.silu(g) * u).permute(1, 0, 2).reshape(T, n * dff)
        yf = yf + torch.matmul(h, sp["wd"].to(x.dtype).reshape(n * dff, D))

    # Switch-style load-balance auxiliary loss (over real experts only)
    me = probs[:, :E_real].mean(0)
    ce = _counts(expert_ids[:, 0], E)[:E_real].float() / T
    aux = (me * ce).sum() * E_real * cfg.router_aux_weight

    # the reference's fractions as XLA compiles them: count x fp32(1 / (T·k))
    inv = torch.tensor(1.0 / (T * k), dtype=torch.float32, device=dev)
    metrics = {"moe_dropped": dropped.float() * inv,
               "moe_dropped_pre_steal": dropped_first.float() * inv,
               "moe_aux": aux}
    return yf.view(B, S, D), metrics
