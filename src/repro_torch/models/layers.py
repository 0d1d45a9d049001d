"""Building blocks of the serving paths (the transformer and its
encoder-decoder, rwkv6 and the RG-LRU hybrid), in torch.

Mirrors `repro.models.layers` function by function, with two differences
of form:

  * every weight is cast to the activations' type at use, as the
    reference casts its fp32 masters (`cast`): training holds fp32
    masters, which AdamW updates, and the serving parameters are stored
    in the compute type already, where the cast returns the tensor itself
    (no copy, no op); norm scales and biases stay fp32, as the reference
    multiplies and adds them in fp32;
  * attention runs through the hand-written kernels (`kernels.ops`):
    `flash_attention` for prefill (cross-attention: the text's queries
    against the encoder's frames, not causal), `decode_attention` for
    decode (cross-attention: over all the frames), which on CPU tensors
    run their plain versions. Keys and values come back in the
    kernels' layout (B, KV, S, hd), which is also the KV cache's layout.
    With a sliding window the cache is a ring of T = min(cache_len,
    window) slots (`ring_len`): position p lives in slot p % T.

The large projections, the MLP and the unembedding are `torch.matmul`, as
the reference leaves them to XLA.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
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
                    causal: bool = True, window: Optional[int] = None, kv_x=None):
    """Attention block body over positions 0..S-1 (no norm/residual):
    projections, RoPE (None: none) and `kernels.ops.flash_attention`.

    x: (B, S, D); kv_x: (B, F, D), the encoder's states for cross-attention
    (not causal, no RoPE), or None for self-attention over x. Returns
    (out (B, S, D), (k, v)) with k, v of shape (B, KV, F, hd) — the
    rotated keys and the values, in the cache layout. The kernel takes
    query and key positions from 0, so this is prefill from an empty cache
    (the reference's `attention_apply` with q_pos = arange(S), k_pos =
    arange(F)). On DTensors (the sharded train step) RoPE and the kernel
    run on each rank's local batch rows and heads (`local_shards`).
    """
    B, S, _ = x.shape
    kv_x = x if kv_x is None else kv_x
    Sk = kv_x.shape[1]
    H, KV, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    q = dense(params["wq"], x).view(B, S, H, hd)
    k = dense(params["wk"], kv_x).view(B, Sk, KV, hd)
    v = dense(params["wv"], kv_x).view(B, Sk, KV, hd)

    def core(q, k, v):
        b, s, h, kv = q.shape[0], q.shape[1], q.shape[2], k.shape[2]
        if rope_theta is not None:
            q = apply_rope(q, torch.arange(s, device=q.device), rope_theta)
            k = apply_rope(k, torch.arange(k.shape[1], device=q.device), rope_theta)
        qg = q.view(b, s, kv, h // kv, hd).permute(0, 2, 3, 1, 4).contiguous()
        k = k.permute(0, 2, 1, 3).contiguous()
        v = v.permute(0, 2, 1, 3).contiguous()
        o = ops.flash_attention(qg, k, v, causal=causal, window=window or 0)
        return o.permute(0, 3, 1, 2, 4).reshape(b, s, h * hd), k, v

    o, k, v = local_shards(core, (q, k, v), ((0, 2),) * 3, ((0, 2), (0, 1), (0, 1)))
    return dense(params["wo"], o), (k, v)


def init_leaf(place, gen, shape, dtype, device, value=None):
    """One leaf of a family's `init`: normal(0, 0.02) drawn in fp32 from
    `gen` and cast to `dtype`, or with `value` filled with it; with no `gen`
    (the meta device: shapes only) nothing is drawn. `place`, if given,
    takes the leaf as soon as it is made and returns what the tree holds
    (the sharded step keeps only this rank's shards, so no more than one
    whole leaf is held at a time: `launch.train.build_sharded_train`)."""
    if value is not None:
        t = torch.full(shape, value, dtype=dtype, device=device)
    elif gen is None:
        t = torch.empty(shape, dtype=dtype, device=device)
    else:
        t = (torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
             * 0.02).to(dtype)
    return t if place is None else place(t)


# --------------------------------------------------------------------------- #
# DTensors (the sharded train step). Each helper is the identity, or calls
# `fn` as is, when no argument is a DTensor: one device, serving.
# --------------------------------------------------------------------------- #
def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def replicated(t: torch.Tensor, like):
    """`t` (alike on every rank, e.g. zeros) as a replicated DTensor on the
    mesh of `like` when `like` is a DTensor, without communication; else
    `t`."""
    if not is_dtensor(like):
        return t
    from torch.distributed.tensor import DTensor

    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, replicated_placements(mesh), run_check=False)


def gathered(t):
    """A DTensor `t` replicated on every rank; a tensor as it is."""
    return t.redistribute(t.device_mesh, replicated_placements(t.device_mesh)) \
        if is_dtensor(t) else t


def row_sharded(t):
    """A DTensor `t` with its rows (dim 0) sharded as `batch_rows` says; a
    tensor as it is."""
    return t.redistribute(t.device_mesh, batch_rows(t.device_mesh, t.shape[0])[0]) \
        if is_dtensor(t) else t


def replicated_call(fn, args, n_out: int):
    """`fn(*args)` whole on every rank (`local_map`): every DTensor among
    `args` (a tree) gathered to a replicated tensor, the `n_out` tensors
    out replicated; each rank computes the same values, gradients
    included. The call is checkpointed (`torch.utils.checkpoint`): autograd
    keeps the sharded inputs and the gather is redone in the backward, so
    no more than one call's gathered weights (an MoE layer's experts) are
    whole at a time."""
    import torch.utils._pytree as pytree

    leaves = pytree.tree_leaves(args)
    dts = [a for a in leaves if is_dtensor(a)]
    if not dts:
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    from torch.utils.checkpoint import checkpoint

    mesh = dts[0].device_mesh
    whole = replicated_placements(mesh)
    call = local_map(fn, out_placements=(whole,) * n_out,
                     in_placements=tuple(whole if is_dtensor(a) else None for a in leaves),
                     device_mesh=mesh, redistribute_inputs=True)
    return checkpoint(call, *args, use_reentrant=False)


def replicated_placements(mesh) -> tuple:
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim


def local_shards(fn, args, dims, out_dims):
    """`fn(*args)` on each rank's shard of DTensors (`torch.distributed.
    tensor.experimental.local_map`; a None arg passes through). `dims[i]`
    is (rows, channels) of args[i]: the dim of its batch rows, sharded
    over the data-parallel mesh dims ("pod", "data") when the batch divides
    by their product, and the dim of its heads or channels, sharded over
    "model" when every arg's divides by its size (a rank's query heads
    are then the groups of its KV heads); either may be None, and every
    other mesh dim is replicated. `out_dims` the same for each output.
    Inputs are redistributed to those placements first. The gradient of an
    arg without rows (a weight such as wkv6's u) is a partial sum over the
    mesh dims that shard the rows: its grad placements say so."""
    first = next(a for a in args if a is not None)
    if not is_dtensor(first):
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = first.device_mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    rows = batch_rows(mesh, first.shape[dims[0][0]])[0]
    split = "model" in sizes and all(
        a.shape[c] % sizes["model"] == 0
        for a, (_, c) in zip(args, dims) if a is not None and c is not None)

    def place(row, chan):
        return tuple(Shard(chan) if n == "model" and split and chan is not None
                     else Shard(row) if row is not None and isinstance(r, Shard)
                     else Replicate() for n, r in zip(sizes, rows))

    def grad_place(row, chan):
        return tuple(Partial() if row is None and isinstance(r, Shard) else p
                     for p, r in zip(place(row, chan), rows))

    return local_map(fn, out_placements=tuple(place(*d) for d in out_dims),
                     in_placements=tuple(None if a is None else place(*d)
                                         for a, d in zip(args, dims)),
                     in_grad_placements=tuple(None if a is None else grad_place(*d)
                                              for a, d in zip(args, dims)),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


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
    `rope_theta` None: no RoPE (the reference's `rope = None`).
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


def cross_attention_decode(params, dims: AttnDims, x, xk, xv):
    """One query step of cross-attention against the encoder's keys and
    values, xk and xv (B, KV, F, hd): the query projected from x (B, 1, D),
    every one of the F frames visible (`kernels.ops.decode_attention` with
    lengths F; the reference's `mha(..., causal=False)` over all frames).
    Returns (B, 1, D)."""
    B, F_ = x.shape[0], xk.shape[2]
    H, KV, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    q = dense(params["wq"], x).view(B, KV, H // KV, hd)
    lengths = torch.full((B,), F_, dtype=torch.int32, device=x.device)
    o = ops.decode_attention(q, xk, xv, lengths)
    return dense(params["wo"], o.reshape(B, 1, H * hd))


# --------------------------------------------------------------------------- #
# MLPs: swiglu, or gelu with biases (the reference's `mlp_apply`)
# --------------------------------------------------------------------------- #
def mlp_apply(params, x, act: str = "swiglu"):
    """swiglu: wd(silu(wg x) * wu x); any other `act` is the reference's
    gelu MLP, wd(gelu(wu x + b) + b), gelu the tanh approximation that
    `jax.nn.gelu` defaults to, in x's type."""
    if act == "swiglu":
        return dense(params["wd"], F.silu(dense(params["wg"], x)) * dense(params["wu"], x))
    return dense(params["wd"], F.gelu(dense(params["wu"], x), approximate="tanh"))


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (n, d) float32: the
    reference's float64 numpy table, cast once (bit-equal to it)."""
    pos = np.arange(n)[:, None]
    i = np.arange(d // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / d)
    out = np.concatenate([np.sin(angle), np.cos(angle)], axis=1)
    return torch.from_numpy(out.astype(np.float32)).to(device)


# rows of the table decode takes its positions from (the reference's T_abs)
SINUSOID_ROWS = 8192


@functools.lru_cache(maxsize=16)
def sinusoidal_table(n: int, d: int, device) -> torch.Tensor:
    """`sinusoidal_positions(n, d)` on `device`, made once: decode adds a
    row of the SINUSOID_ROWS-row table every step."""
    return sinusoidal_positions(n, d, device)


# --------------------------------------------------------------------------- #
# Embedding / unembedding
# --------------------------------------------------------------------------- #
def embed(params, tokens, dtype: torch.dtype):
    """The table's rows of `tokens`, in `dtype` (`column_gather`)."""
    return column_gather(lambda t, i: cast(t[i], dtype), params["table"], tokens)


def column_gather(fn, table, tokens):
    """`fn(table, tokens)`, a gather of the table's rows. On a DTensor table
    (the sharded train step) the gather is local: each rank takes its slice
    of d_model for every token (the tokens gathered whole, a vocab-sharded
    table gathered over the vocabulary), the rows sharded over d_model as
    the table is — the reference's reason for sharding the table so."""
    if not is_dtensor(table):
        return fn(table, tokens)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    cols = tuple(p if isinstance(p, Shard) and p.dim == 1 else Replicate()
                 for p in table.placements)
    rows = tuple(Shard(tokens.dim()) if isinstance(p, Shard) else Replicate() for p in cols)
    return local_map(fn, out_placements=(rows,),
                     in_placements=(cols, replicated_placements(mesh)),
                     device_mesh=mesh, redistribute_inputs=True)(table, tokens)


def unembed(params, x):
    return torch.matmul(x, cast(params["table"], x.dtype).t())


def _nll(logits, labels, z_weight: float):
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if z_weight:
        nll = nll + z_weight * lse ** 2
    return nll


def softmax_xent(logits, labels, mask=None, z_weight: float = 0.0):
    """Mean next-token cross entropy: an fp32 logsumexp over the vocabulary,
    optionally + z_weight·lse², the mean over positions where `mask` (if
    given) is set — the reference's `layers.softmax_xent`, as a sum over
    positions over their count (`row_sums`)."""
    def sums(logits, labels, mask):
        nll = _nll(logits, labels, z_weight)
        if mask is None:
            return torch.sum(nll), torch.full((), float(nll.numel()), device=nll.device)
        mask = mask.float()
        return torch.sum(nll * mask), torch.sum(mask)

    num, den = row_sums(sums, (logits, labels, mask))
    return num / torch.clamp(den, min=1.0)


def batch_rows(mesh, batch: int):
    """(placements of a tensor whose dim 0 is `batch` rows: sharded over
    the data-parallel mesh dims ("pod", "data") when `batch` divides by
    their product, every other mesh dim replicated; the placements of a sum
    over those rows: `Partial` where the rows are sharded)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    dp = [n for n in sizes if n in ("pod", "data")]
    split = batch % math.prod(sizes[n] for n in dp) == 0
    rows = tuple(Shard(0) if n in dp and split else Replicate() for n in sizes)
    sums = tuple(Partial() if n in dp and split else Replicate() for n in sizes)
    return rows, sums


def row_sums(fn, args):
    """`fn(*args)`, sums over the batch rows of `args` (dim 0; an arg may be
    None). On DTensors (the sharded train step) each rank sums its rows
    (`batch_rows`), each with its whole last dim (the logits' vocabulary),
    and the sums are reduced across ranks to replicated ones."""
    first = args[0]
    if not is_dtensor(first):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    mesh = first.device_mesh
    rows, sums = batch_rows(mesh, first.shape[0])
    outs = local_map(fn, out_placements=(sums,) * 2,
                     in_placements=tuple(None if a is None else rows for a in args),
                     device_mesh=mesh, redistribute_inputs=True)(*args)
    return tuple(gathered(t) for t in outs)
