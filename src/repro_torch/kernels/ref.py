"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its CUDA kernel computes, at the same
interface: the simulator's kernels exactly, the attention kernels up to the
order of float sums, where p is rounded to v's type and the last bits of
`exp`, `wkv6` up to the order of float sums, `rglru` up to the last ulp of
`exp` and `log1p` (at the serving shapes not even that). The wrappers in
`ops` run these for CPU tensors; on the card they serve only as the
yardstick `chip_smoke.py` and the `gpu`-marked tests hold each kernel
against.
"""

from __future__ import annotations

import torch

# the one staging width of the grant export, shared with the kernel's
# compile-time constant (checked by the wrapper)
from ..core.stealing import GRANT_WIDTH

NEG_INF = -1e30


def steal_compact(buf, bot, size, grants, width: int = GRANT_WIDTH):
    """Extract `grants[w]` records, at most `width`, from each deque's bottom
    and advance it.

    buf: (W, C, T) int32 ring buffers; bot, size, grants: (W,) int32.
    Returns (stolen (W, width, T) zero-padded, new_bot, new_size).
    """
    C, T = buf.shape[1:]
    g = torch.minimum(grants.clamp(max=width), size)
    ranks = torch.arange(width, device=buf.device)[None, :]
    idx = torch.remainder(bot[:, None] + ranks, C).long()
    rows = torch.gather(buf, 1, idx[:, :, None].expand(-1, -1, T))
    stolen = torch.where((ranks < g[:, None])[:, :, None], rows, 0)
    return stolen, torch.remainder(bot + g, C), size - g


def deque_apply(buf, slot, rec, n):
    """Commit a staged push log into the ring buffers, lanes in order.

    buf: (W, C, T) int32; slot: (W, L) ring slots; rec: (W, L, T) records;
    n: (W,) live-lane count. Lane l is committed iff l < n[w]; ascending lane
    order means a later push to a re-used slot wins. Returns a new buffer.
    """
    C = buf.shape[1]
    cols = torch.arange(C, device=buf.device)[None, :]
    out = buf
    for lane in range(slot.shape[1]):
        hit = (cols == slot[:, lane][:, None]) & (lane < n)[:, None]
        out = torch.where(hit[:, :, None], rec[:, lane][:, None, :], out)
    return out


def deque_apply_(buf, slot, rec, n):
    """`deque_apply` written into `buf` (contiguous), which it returns.

    Each slot's writer is its last live lane (lane l < n[w] with the slot in
    [0, C)), found by a scatter-max of lane indices. Every lane then writes
    at its own slot (clamped into the ring) the record that slot ends up
    with — its writer's record, else the slot as it was — so writes that
    land on one slot carry one value and the scatter's order cannot change
    the result. No host sync: the card can capture it in a graph.
    """
    W, C, T = buf.shape
    dev = buf.device
    lanes = torch.arange(slot.shape[1], device=dev)
    live = (lanes < n[:, None]) & (slot >= 0) & (slot < C)
    cell = torch.arange(W, device=dev)[:, None] * C + slot.long().clamp(0, C - 1)
    last = torch.full((W * C,), -1, dtype=torch.long, device=dev).scatter_reduce_(
        0, cell.flatten(), torch.where(live, lanes, -1).flatten(), reduce="amax")
    lane = last[cell]                                                # (W, L)
    flat = buf.view(W * C, T)
    staged = torch.gather(rec, 1, lane.clamp(min=0)[:, :, None].expand(-1, -1, T))
    val = torch.where((lane >= 0)[:, :, None], staged, flat[cell])
    flat[cell.flatten()] = val.flatten(0, 1)
    return buf


def _softmax_pv(s, v, eq: str, out_dtype):
    """Masked softmax over the last axis of fp32 scores `s` (masked entries
    hold NEG_INF), normalised, cast to v's type, then the PV product: the
    order of the reference's oracles. A row with no visible key gives 0."""
    m = s.amax(-1, keepdim=True)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    return torch.einsum(eq, (p / l.clamp(min=1e-30)).to(v.dtype), v).to(out_dtype)


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """Causal or windowed grouped-query attention, positions from 0.

    q: (B, KV, G, Sq, hd); k, v: (B, KV, Sk, hd) → (B, KV, G, Sq, hd) in
    q's type. Key s is visible to query i iff (not causal or i >= s) and
    (window == 0 or i - s < window). Scores are taken in fp32, as the
    kernel's are.
    """
    Sq, hd = q.shape[-2:]
    Sk = k.shape[-2]
    s = torch.einsum("bkgqh,bksh->bkgqs", q.float(), k.float()) * hd ** -0.5
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= (qp - kp) < window
    s = torch.where(mask, s, NEG_INF)
    return _softmax_pv(s, v, "bkgqs,bksh->bkgqh", q.dtype)


def decode_attention(q, k_cache, v_cache, lengths):
    """One query position per GQA group against a KV cache.

    q: (B, KV, G, hd); caches: (B, KV, T, hd); lengths: (B,) int32, the
    visible prefix of each row's cache. Returns (B, KV, G, hd) in q's type.
    """
    T, hd = k_cache.shape[-2:]
    s = torch.einsum("bkgh,bkth->bkgt", q.float(), k_cache.float()) * hd ** -0.5
    valid = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    return _softmax_pv(s, v_cache, "bkgt,bkth->bkgh", q.dtype)


def wkv6(r, k, v, w, u, state=None):
    """The RWKV-6 WKV recurrence, sequential over S in fp32.

    r, k, v, w: (B, S, H, hd) (w the decay, in (0, 1)); u: (H, hd);
    state: (B, H, hd, hd) [key dim x value dim], or None for zeros. Per
    step: o_t = r_t . (S + diag(u) k_t^T v_t), then S <- diag(w_t) S +
    k_t^T v_t. Returns (out (B, S, H, hd) fp32, final state (B, H, hd, hd)
    fp32) — the reference oracle's interface; with a zero state, `out` is
    what the TPU kernel returns.
    """
    B, S, H, hd = r.shape
    r, k, v, w, u = (t.float() for t in (r, k, v, w, u))
    st = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
          if state is None else state.float())
    outs = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], st + u[None, :, :, None] * kv))
        st = w[:, t, :, :, None] * st + kv
    return torch.stack(outs, dim=1), st


RGLRU_C = 8.0


def softplus(x):
    """max(x, 0) + log1p(exp(-|x|)): `jax.nn.softplus`'s `logaddexp(x, 0)`
    at every x (`F.softplus` switches to the identity above 20)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def rglru(x, r, i, lam, h0=None):
    """The RG-LRU recurrence, sequential over S in fp32.

    x, r, i: (B, S, W), one type; lam: (W,); h0: (B, W) or None for zeros.
    With log a_t = -8 softplus(lam) r_t: h_t = a_t h_{t-1} + sqrt(max(1 -
    exp(2 log a_t), 1e-12)) (i_t x_t). The product i_t x_t is taken in the
    inputs' type and rounded there before it goes to fp32, as the
    reference's model and oracle do (`ref.rglru_ref`). Returns (h (B, S,
    W) fp32, final h (B, W) fp32).
    """
    log_a = -RGLRU_C * softplus(lam.float()) * r.float()
    a = torch.exp(log_a)
    gated = (i * x).float() * torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                                     min=1e-12))
    h = (torch.zeros(x.shape[0], x.shape[2], dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    outs = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + gated[:, t]
        outs.append(h)
    return torch.stack(outs, dim=1), h
