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
    type (the serving parameters), else a cast copy (fp32 masters). On a
    DTensor (the sharded step) the cast weight is then gathered over the
    data-parallel mesh dims ("pod", "data") and keeps its "model" shard:
    FSDP's gather at use, whose backward reduce-scatters the gradient.
    Left to itself DTensor may rather split a product's contraction over
    the FSDP dim and move the activations instead."""
    w = w.to(dtype)
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    want = tuple(Replicate() if n in ("pod", "data") else p
                 for n, p in zip(w.device_mesh.mesh_dim_names, w.placements))
    return w if want == tuple(w.placements) else w.redistribute(w.device_mesh, want)


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
    """x @ w (+ b). On DTensors (the sharded step) the product is
    Megatron's on each rank's rows (`_tp_matmul`), w gathered over the
    data dims at use (`cast`)."""
    w = cast(params["w"], x.dtype)
    y = _tp_matmul(x, w) if is_dtensor(x) else torch.matmul(x, w)
    if "b" in params:
        y = y + cast(params["b"], x.dtype)
    return y


def _tp_matmul(x, w):
    """x (..., K) @ w (K, N) for DTensors, x's rows placed as `batch_rows`
    says: on each rank's rows (`local_map`), column-parallel where w's N is
    split over "model" (x whole there; y split there), row-parallel where
    w's K is (x split there, as a column-parallel product leaves it; y a
    partial sum over "model"), or whole. So every rank does its rows' share
    of the product and no more, whatever DTensor would choose (left to
    itself it may keep a partial x partial by gathering w whole, or split
    a replicated batch's tokens for free and then fail to regroup rows
    that do not divide over the data ranks: yi-34b's 16-row micro-batches
    over 32). Any other placement: DTensor's own matmul."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    rows, sums = batch_rows(mesh, x.shape[0])
    last = x.dim() - 1
    if "model" not in names:
        return torch.matmul(x, w)
    m = names.index("model")

    def on_model(p, other):
        return tuple(p if i == m else o for i, o in enumerate(other))

    xm, wm = x.placements[m], w.placements[m]
    if xm == Replicate() and wm == Shard(0):
        # a whole x (attention whose heads do not divide over "model")
        # against a row-parallel w: this rank's slice of x, taken locally
        x, xm = x.redistribute(mesh, on_model(Shard(last), x.placements)), Shard(last)
    if xm == Replicate() and wm == Shard(1):
        out, x_grad = Shard(last), Partial()
    elif xm == Shard(last) and wm == Shard(0):
        out, x_grad = Partial(), Shard(last)
    elif xm == Replicate() and wm == Replicate():
        out, x_grad = Replicate(), Replicate()
    else:
        return torch.matmul(x, w)
    if any(p != r for i, (p, r) in enumerate(zip(x.placements, rows)) if i != m) or any(
            p != Replicate() for i, p in enumerate(w.placements) if i != m):
        return torch.matmul(x, w)
    return local_map(torch.matmul, out_placements=(on_model(out, rows),),
                     in_placements=(on_model(xm, rows), on_model(wm, w.placements)),
                     in_grad_placements=(on_model(x_grad, rows), on_model(wm, sums)),
                     device_mesh=mesh, redistribute_inputs=False)(x, w)


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
    q = split_heads(dense(params["wq"], x), B, S, H, hd)
    k = split_heads(dense(params["wk"], kv_x), B, Sk, KV, hd)
    v = split_heads(dense(params["wv"], kv_x), B, Sk, KV, hd)

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


def split_heads(t, *shape):
    """`t.view(*shape)`: its last dim split into (heads, head dim). On a
    DTensor whose last dim is sharded over a mesh dim that the heads do not
    divide by (qwen2-0.5b's 14 heads, whisper's 6, over "model" 8), that
    dim is gathered first: DTensor views no uneven split of a dim."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard

        last, mesh = t.dim() - 1, t.device_mesh
        want = tuple(Replicate() if isinstance(p, Shard) and p.dim == last
                     and shape[-2] % mesh.size(i) else p for i, p in enumerate(t.placements))
        if want != tuple(t.placements):
            t = t.redistribute(mesh, want)
    return t.view(*shape)


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


def expert_shards(fn, params, x, cfg):
    """The MoE layer `fn` (`models.moe.moe_apply`) on x (B, S, D) with its
    `params` → (y, metrics). On DTensors (the sharded train step) the
    experts are split over "model" (expert parallelism, the reference's
    rule for `moe/w[gud]`): every rank takes the tokens whole (x gathered)
    and the router whole, so that the routing, the capacities and the
    neighbor-steal assignment are the reference's over all B·S tokens, and
    runs only its E / tp experts' slots (`moe_apply(experts=(lo, hi))`)
    with its experts' weights gathered over the other mesh dims (FSDP) and
    its slice of the shared experts' hidden units. The ranks of the dims
    over which x's rows are split (dp of them) split that work again
    (`moe_apply(part=(i, dp))`): each runs 1/dp of its experts' places and
    of the shared experts' tokens; a dim that holds x's rows whole ("pod"
    when they do not divide over it) repeats it rather than pay an
    all-reduce there. y and the load-balance loss are partial sums over
    "model" and those dims, and y is reduced onto x's own placements (a
    reduce-scatter over the batch dims, then a sum over "model").
    Gradients follow: x's and the router's are partial sums there, each
    expert's and shared slice's its "model" rank's own and partial over
    the batch dims. When the experts or the shared hidden units do not
    divide over "model" (the reference's rule then replicates them), every
    "model" rank runs every expert. On plain tensors: `fn(params, x, cfg)`."""
    if not is_dtensor(x):
        return fn(params, x, cfg)
    import torch.utils._pytree as pytree
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from torch.utils.checkpoint import checkpoint

    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    tp = dict(zip(names, mesh.shape)).get("model", 1)
    E = cfg.n_experts + cfg.ep_pad_to
    shared = params.get("shared")
    split = tp > 1 and E % tp == 0 and (
        shared is None or shared["wg"].shape[2] % tp == 0)

    # the dims over which x's rows are split: their ranks split the work
    rows = {n for n, q in zip(names, x.placements) if n != "model" and q.is_shard()}

    def on_model(p, other=Replicate()):
        return tuple((p if split else Replicate()) if n == "model" else
                     other if n in rows else Replicate() for n in names)

    whole, partial = on_model(Replicate()), on_model(Partial(), Partial())

    def place(path):
        keys = [getattr(k, "key", None) for k in path]
        if keys[-1] in ("wg", "wu", "wd"):
            if "shared" in keys:
                return on_model(Shard(1 if keys[-1] == "wd" else 2))
            return on_model(Shard(0))
        return whole

    flat = pytree.tree_flatten_with_path(params)[0]
    in_p = tuple(place(path) for path, _ in flat) + (whole,)
    # a replicated input's gradient: a partial sum over "model" and the
    # row dims; an expert weight's: its "model" shard, partial over the
    # row dims
    grad_p = tuple(partial if p == whole else
                   tuple(Partial() if n in rows else q for n, q in zip(names, p))
                   for p in in_p)
    spec = pytree.tree_structure(params)

    def local(*leaves):
        p = pytree.tree_unflatten(list(leaves[:-1]), spec)
        rank = mesh.get_local_rank("model") if split else 0
        lo = rank * (E // tp) if split else 0
        i, dp = 0, 1
        for n, size in zip(names, mesh.shape):
            if n in rows:
                i, dp = i * size + mesh.get_local_rank(n), dp * size
        y, m = fn(p, leaves[-1], cfg,
                  experts=(lo, lo + E // tp) if split else None,
                  part=(i, dp) if dp > 1 else None)
        return y, m["moe_dropped"], m["moe_dropped_pre_steal"], m["moe_aux"]

    call = local_map(local, out_placements=(partial, whole, whole, partial),
                     in_placements=in_p, in_grad_placements=grad_p, device_mesh=mesh,
                     redistribute_inputs=True)
    # checkpointed: the backward gathers the experts again rather than keep
    # them, so one layer's gathered experts are whole at a time
    y, dropped, pre, aux = checkpoint(call, *[t for _, t in flat], x, use_reentrant=False)
    # the batch dims first (a reduce-scatter onto x's rows), then the sum
    # over "model"
    y = y.redistribute(mesh, tuple(q if n != "model" else p
                                   for n, q, p in zip(names, x.placements, partial)))
    y = y.redistribute(mesh, x.placements)
    return y, {"moe_dropped": dropped, "moe_dropped_pre_steal": pre,
               "moe_aux": gathered(aux)}


def residual(x, a):
    """x + a, the residual add. On DTensors a partial sum in `a` (a
    row-parallel product's output) is first reduced onto x's placements:
    an all-reduce where x is whole over "model" (Megatron's), a
    reduce-scatter where its sequence is sharded there (`seq_sharded`).
    Left partial, DTensor carries it into the next norm, which then sums
    it in fp32 and holds several copies of the residual."""
    if is_dtensor(a) and any(p.is_partial() for p in a.placements):
        a = a.redistribute(a.device_mesh, x.placements if is_dtensor(x) else
                           replicated_placements(a.device_mesh))
    return x + a


def seq_sharded(x, axis: str):
    """The residual x (B, S, D) with its sequence sharded over the mesh dim
    `axis` (and its batch rows as before) between blocks: the reference's
    `_seq_constraint` (sequence-parallel residual: the per-block "model"
    all-reduce becomes a reduce-scatter and an all-gather). The identity
    on a plain tensor, with no `axis`, or when S < 2 or S does not divide
    over `axis`."""
    if not axis or not is_dtensor(x) or x.dim() != 3 or x.shape[1] < 2:
        return x
    from torch.distributed.tensor import Shard

    names = tuple(x.device_mesh.mesh_dim_names)
    if axis not in names or x.shape[1] % x.device_mesh.size(names.index(axis)):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Shard(1) if n == axis else p for n, p in zip(names, x.placements)))


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
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = first.device_mesh
    rows = batch_rows(mesh, first.shape[dims[0][0]])[0]
    place = _placer(mesh, rows, [a.shape[c] for a, (_, c) in zip(args, dims)
                                 if a is not None and c is not None])

    def grad_place(row, chan):
        return tuple(Partial() if row is None and isinstance(r, Shard) else p
                     for p, r in zip(place(row, chan), rows))

    return local_map(fn, out_placements=tuple(place(*d) for d in out_dims),
                     in_placements=tuple(None if a is None else place(*d)
                                         for a, d in zip(args, dims)),
                     in_grad_placements=tuple(None if a is None else grad_place(*d)
                                              for a, d in zip(args, dims)),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def _placer(mesh, rows: tuple, channels: list):
    """`local_shards`' placements: place(row, chan) → a tensor's placements
    with its rows as `rows` says and its dim `chan` over "model" when every
    count in `channels` divides by that dim's size."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    split = "model" in sizes and all(c % sizes["model"] == 0 for c in channels)

    def place(row, chan):
        return tuple(Shard(chan) if n == "model" and split and chan is not None
                     else Shard(row) if row is not None and isinstance(r, Shard)
                     else Replicate() for n, r in zip(sizes, rows))
    return place


def sharded_zeros(shape, dtype, like, row: int, chan: int):
    """Zeros of `shape` on `like`'s device. When `like` is a DTensor, a
    DTensor on its mesh placed as `local_shards` places an argument whose
    rows are dim `row` and whose heads are dim `chan` (a serving cache the
    kernels then write and read in place), of which only the local shard
    is made."""
    if not is_dtensor(like):
        return torch.zeros(shape, dtype=dtype, device=like.device)
    mesh = like.device_mesh
    pl = _placer(mesh, batch_rows(mesh, shape[row])[0], [shape[chan]])(row, chan)
    return placed_zeros(shape, dtype, like.to_local().device, mesh, pl)


def placed_zeros(shape, dtype, device, mesh, placements):
    """A DTensor of zeros of the global `shape` on `mesh` under
    `placements` (even shards), of which only this rank's local shard is
    made on `device`: no data moves."""
    from torch.distributed.tensor import DTensor, Shard

    local = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    stride = [1] * len(shape)       # the global tensor's, contiguous
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device), mesh,
                              placements, run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def ring_len(cache_len: int, window: Optional[int]) -> int:
    """Slots of a KV cache: min(cache_len, window) with a sliding window (a
    ring, position p in slot p % T), else cache_len (the reference's T)."""
    return min(cache_len, window) if window else cache_len


def write_prefill(cache_k, cache_v, k, v) -> None:
    """Write a prefill's keys and values (B, KV, S, hd) into one layer's
    (B, KV, T, hd) caches IN PLACE: all S at slots 0..S-1 when S <= T, else
    the last T positions, position p at slot p % T (the reference's
    prefill placement). On DTensors each rank writes its own rows and
    heads (caches from `sharded_zeros`)."""
    def write(cache_k, cache_v, k, v):
        S, T = k.shape[2], cache_k.shape[2]
        if S <= T:
            cache_k[:, :, :S] = k
            cache_v[:, :, :S] = v
        else:
            slots = torch.arange(S - T, S, device=k.device) % T
            cache_k[:, :, slots] = k[:, :, S - T:]
            cache_v[:, :, slots] = v[:, :, S - T:]
        return cache_k

    if is_dtensor(k) and tuple(cache_k.placements) != tuple(k.placements):
        raise ValueError(f"a cache placed {cache_k.placements} takes no keys placed "
                         f"{k.placements} in place")
    local_shards(write, (cache_k, cache_v, k, v), ((0, 1),) * 4, ((0, 1),))


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
    q = split_heads(dense(params["wq"], x), B, 1, H, hd)
    k = split_heads(dense(params["wk"], x), B, 1, KV, hd)
    v = split_heads(dense(params["wv"], x), B, 1, KV, hd)

    def core(q, k, v, cache_k, cache_v, pos):
        # on DTensors each rank's rows and heads, its caches written in place
        b, kv = q.shape[0], k.shape[2]
        if rope_theta is not None:
            q = apply_rope(q, pos[:, None], rope_theta)
            k = apply_rope(k, pos[:, None], rope_theta)
        bidx = torch.arange(b, device=q.device)
        slot = (pos % T).long()
        cache_k[bidx, :, slot] = k[:, 0]
        cache_v[bidx, :, slot] = v[:, 0]
        lengths = torch.clamp(pos + 1, max=T).to(torch.int32)
        o = ops.decode_attention(q.view(b, kv, q.shape[2] // kv, hd), cache_k, cache_v,
                                 lengths)
        return o.reshape(b, 1, -1)

    o = local_shards(core, (q, k, v, cache_k, cache_v, pos),
                     ((0, 2),) * 3 + ((0, 1),) * 2 + ((0, None),), ((0, 2),))
    return dense(params["wo"], o), cache_k, cache_v


def cross_attention_decode(params, dims: AttnDims, x, xk, xv):
    """One query step of cross-attention against the encoder's keys and
    values, xk and xv (B, KV, F, hd): the query projected from x (B, 1, D),
    every one of the F frames visible (`kernels.ops.decode_attention` with
    lengths F; the reference's `mha(..., causal=False)` over all frames).
    Returns (B, 1, D)."""
    B, F_ = x.shape[0], xk.shape[2]
    H, KV, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    q = split_heads(dense(params["wq"], x), B, KV, H // KV, hd)

    def core(q, xk, xv):
        lengths = torch.full((q.shape[0],), F_, dtype=torch.int32, device=q.device)
        return ops.decode_attention(q, xk, xv, lengths).reshape(q.shape[0], 1, -1)

    o = local_shards(core, (q, xk, xv), ((0, 1),) * 3, ((0, 2),))
    return dense(params["wo"], o)


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
    (the sharded step) the gather is local (`local_map`: torch 2.11 has no
    DTensor rule for its backward, `index_put`): each rank takes its own
    batch rows of `tokens` (`batch_rows`) from the table gathered whole at
    use (FSDP's gather, as `cast` gathers a weight), and its rows come out
    whole in d_model, replicated over "model"; the table's gradient is a
    partial sum over the rows' mesh dims. Taking every token's slice of a
    d_model-sharded table instead (the reference's reason for sharding the
    table so) leaves the rows sharded over d_model on both mesh dims,
    which DTensor regroups only by gathering the whole batch's activations
    on every device (~26 GB a device at mistral-large's prefill_32k, the
    dry run's count)."""
    if not is_dtensor(table):
        return fn(table, tokens)
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    rows, sums = batch_rows(mesh, tokens.shape[0])
    return local_map(fn, out_placements=(rows,),
                     in_placements=(replicated_placements(mesh), rows),
                     in_grad_placements=(sums, rows), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


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
    positions over their count (`row_sums`). On DTensors the vocabulary
    stays sharded over "model" (`vocab_nll`)."""
    def sums(nll, mask):
        if mask is None:
            return torch.sum(nll), torch.full((), float(nll.numel()), device=nll.device)
        mask = mask.float()
        return torch.sum(nll * mask), torch.sum(mask)

    nll = vocab_nll(logits, labels, z_weight) if is_dtensor(logits) else \
        _nll(logits, labels, z_weight)
    num, den = row_sums(sums, (nll, mask))
    return num / torch.clamp(den, min=1.0)


def vocab_nll(logits, labels, z_weight: float):
    """`_nll` of DTensor logits (B, S, V) with the vocabulary sharded over
    "model" (the head's rule, `head/table` over "model"; whole when V does
    not divide) and the rows over the batch dims (`batch_rows`): the
    max, the sum of exponentials and the label's logit are each a local
    reduction over this rank's vocabulary, combined over "model" (a max,
    then two sums of B x S floats), in fp32, so no rank holds a row's whole
    vocabulary; where the vocabulary is whole, each rank's rows through
    `_nll` as on one device. Returns the (B, S) fp32 nll with the rows'
    placements."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    names = tuple(mesh.mesh_dim_names)
    tp = dict(zip(names, mesh.shape)).get("model", 1)
    V = logits.shape[-1]
    split = tp > 1 and V % tp == 0
    rows = batch_rows(mesh, logits.shape[0])[0]

    if not split:      # each rank's rows with their whole vocabulary: `_nll`
        return local_map(lambda lg, lab: _nll(lg, lab, z_weight), out_placements=(rows,),
                         in_placements=(rows, rows), device_mesh=mesh,
                         redistribute_inputs=True)(logits, labels)

    def on_model(p):
        return tuple(p if n == "model" else r for n, r in zip(names, rows))

    vocab = on_model(Shard(logits.dim() - 1))
    lf = logits.redistribute(mesh, vocab).float()

    def run(fn, out, *args, grads=None):
        return local_map(fn, out_placements=(out,), in_placements=tuple(
            vocab if a is lf else rows for a in args), in_grad_placements=grads,
            device_mesh=mesh, redistribute_inputs=True)(*args).redistribute(mesh, rows)

    m = run(lambda lg: lg.detach().amax(-1), on_model(Partial("max")), lf)
    s = run(lambda lg, m: torch.exp(lg - m[..., None]).sum(-1), on_model(Partial()), lf, m)
    lse = m + torch.log(s)

    def pick(lg, lab):
        n = lg.shape[-1]
        idx = lab.long() - mesh.get_local_rank("model") * n
        inside = (idx >= 0) & (idx < n)
        got = torch.gather(lg, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
        return torch.where(inside, got, torch.zeros_like(got))

    ll = run(pick, on_model(Partial()), lf, labels)
    nll = lse - ll
    if z_weight:
        nll = nll + z_weight * lse ** 2
    return nll


def batch_rows(mesh, batch: int):
    """(placements of a tensor whose dim 0 is `batch` rows: sharded over
    the data-parallel mesh dims ("pod", "data") when `batch` divides by
    their product, else over "data" alone when it divides by that (a
    micro-batch of 32 rows on 2 x 32 x 8: each pod's ranks take the rows
    again), every other mesh dim replicated; the placements of a sum over
    those rows: `Partial` where the rows are sharded)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    dp = [n for n in sizes if n in ("pod", "data")]
    if batch % math.prod(sizes[n] for n in dp):
        dp = [n for n in dp if n == "data" and batch % sizes[n] == 0]
    rows = tuple(Shard(0) if n in dp else Replicate() for n in sizes)
    sums = tuple(Partial() if n in dp else Replicate() for n in sizes)
    return rows, sums


def row_sums(fn, args):
    """`fn(*args)`, sums over the batch rows of `args` (dim 0; an arg may be
    None). On DTensors (the sharded train step) each rank sums its rows
    (`batch_rows`), and the sums are reduced across ranks to replicated
    ones."""
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
