"""Building blocks of the serving paths (dense transformer, rwkv6 and the
RG-LRU hybrid), in torch.

Mirrors `repro.models.layers` function by function, with two differences
of form:

  * every weight is cast to the activations' type at use, as the
    reference casts its fp32 masters (`cast`): training holds fp32
    masters, which AdamW updates, and the serving parameters are stored
    in the compute type already, where the cast returns the tensor itself
    (no copy, no op); norm scales and biases stay fp32, as the reference
    multiplies and adds them in fp32;
  * attention runs through the hand-written kernels (`kernels.ops`):
    `flash_attention` for prefill, `decode_attention` for decode, which on
    CPU tensors run their plain versions. Keys and values come back in the
    kernels' layout (B, KV, S, hd), which is also the KV cache's layout.
    With a sliding window the cache is a ring of T = min(cache_len,
    window) slots (`ring_len`): position p lives in slot p % T.

The large projections, the MLP and the unembedding are `torch.matmul`, as
the reference leaves them to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import ops

# compute types of the port (the attention kernels take these two)
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def cast(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A weight in `dtype` at its use: `w` itself when it is stored in that
    type (the serving parameters), else a cast copy (fp32 masters)."""
    return w.to(dtype)


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #
def rmsnorm(params, x, eps: float = 1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(x.dtype)


def layernorm(params, x, eps: float = 1e-5):
    """Mean and population variance in fp32, `y * scale + bias` in fp32,
    cast back to x's type (the reference's `layers.layernorm`)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


# --------------------------------------------------------------------------- #
# Rotary position embeddings (split halves, fp32)
# --------------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # (hd/2,)
    angles = positions[..., None].float() * freqs           # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# Dense projections
# --------------------------------------------------------------------------- #
def dense(params, x):
    y = torch.matmul(x, cast(params["w"], x.dtype))
    if "b" in params:
        y = y + cast(params["b"], x.dtype)
    return y


# --------------------------------------------------------------------------- #
# Attention (GQA; head h = kv * G + g)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False


def attention_apply(params, dims: AttnDims, x, rope_theta: Optional[float],
                    causal: bool = True, window: Optional[int] = None):
    """Self-attention block body over positions 0..S-1 (no norm/residual):
    projections, RoPE and `kernels.ops.flash_attention`.

    x: (B, S, D). Returns (out (B, S, D), (k, v)) with k, v of shape
    (B, KV, S, hd) — the rotated keys and the values, in the cache layout.
    The kernel takes query and key positions from 0, so this is prefill
    from an empty cache (the reference's `attention_apply` with
    q_pos = k_pos = arange(S) and kv_x = x).
    """
    B, S, _ = x.shape
    H, KV, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    q = dense(params["wq"], x).view(B, S, H, hd)
    k = dense(params["wk"], x).view(B, S, KV, hd)
    v = dense(params["wv"], x).view(B, S, KV, hd)
    if rope_theta is not None:
        pos = torch.arange(S, device=x.device)
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    qg = q.view(B, S, KV, H // KV, hd).permute(0, 2, 3, 1, 4).contiguous()
    k = k.permute(0, 2, 1, 3).contiguous()
    v = v.permute(0, 2, 1, 3).contiguous()
    o = ops.flash_attention(qg, k, v, causal=causal, window=window or 0)
    o = o.permute(0, 3, 1, 2, 4).reshape(B, S, H * hd)
    return dense(params["wo"], o), (k, v)


def ring_len(cache_len: int, window: Optional[int]) -> int:
    """Slots of a KV cache: min(cache_len, window) with a sliding window (a
    ring, position p in slot p % T), else cache_len (the reference's T)."""
    return min(cache_len, window) if window else cache_len


def write_prefill(cache_k, cache_v, k, v) -> None:
    """Write a prefill's keys and values (B, KV, S, hd) into one layer's
    (B, KV, T, hd) caches IN PLACE: all S at slots 0..S-1 when S <= T, else
    the last T positions, position p at slot p % T (the reference's
    prefill placement)."""
    S, T = k.shape[2], cache_k.shape[2]
    if S <= T:
        cache_k[:, :, :S] = k
        cache_v[:, :, :S] = v
    else:
        slots = torch.arange(S - T, S, device=k.device) % T
        cache_k[:, :, slots] = k[:, :, S - T:]
        cache_v[:, :, slots] = v[:, :, S - T:]


def attention_decode(params, dims: AttnDims, x, cache_k, cache_v, pos,
                     rope_theta: Optional[float]):
    """Single-token decode against a (B, KV, T, hd) cache.

    `pos` is the current position (B,) int; the new key and value are
    written at slot pos % T of the caches IN PLACE, then the token attends
    to slots < min(pos + 1, T) through `kernels.ops.decode_attention`. On a
    full cache (pos < T) that is the reference's mask `slot <= pos`; on a
    ring of T = min(cache_len, window) slots it is the same set of
    positions as the reference's window mask, pos - window < p <= pos, in
    slot order rather than position order (softmax does not care).
    Returns (out (B, 1, D), cache_k, cache_v).
    """
    B = x.shape[0]
    T = cache_k.shape[2]
    H, KV, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    q = dense(params["wq"], x).view(B, 1, H, hd)
    k = dense(params["wk"], x).view(B, 1, KV, hd)
    v = dense(params["wv"], x).view(B, 1, KV, hd)
    if rope_theta is not None:
        q = apply_rope(q, pos[:, None], rope_theta)
        k = apply_rope(k, pos[:, None], rope_theta)
    bidx = torch.arange(B, device=x.device)
    slot = (pos % T).long()
    cache_k[bidx, :, slot] = k[:, 0]
    cache_v[bidx, :, slot] = v[:, 0]
    lengths = torch.clamp(pos + 1, max=T).to(torch.int32)
    o = ops.decode_attention(q.view(B, KV, H // KV, hd), cache_k, cache_v, lengths)
    return dense(params["wo"], o.reshape(B, 1, H * hd)), cache_k, cache_v


# --------------------------------------------------------------------------- #
# MLP (swiglu)
# --------------------------------------------------------------------------- #
def mlp_apply(params, x):
    return dense(params["wd"], F.silu(dense(params["wg"], x)) * dense(params["wu"], x))


# --------------------------------------------------------------------------- #
# Embedding / unembedding
# --------------------------------------------------------------------------- #
def embed(params, tokens, dtype: torch.dtype):
    """The table's rows of `tokens`, in `dtype`."""
    return cast(params["table"][tokens], dtype)


def unembed(params, x):
    return torch.matmul(x, cast(params["table"], x.dtype).t())


def softmax_xent(logits, labels, mask=None, z_weight: float = 0.0):
    """Mean next-token cross entropy: an fp32 logsumexp over the vocabulary,
    optionally + z_weight·lse², the mean over positions where `mask` (if
    given) is set — the reference's `layers.softmax_xent`."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if z_weight:
        nll = nll + z_weight * lse ** 2
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
