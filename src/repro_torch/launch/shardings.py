"""Sharding rules: parameter / optimizer / batch / cache specs, and their
placement on a `DeviceMesh` as DTensors. The port of
`repro.launch.shardings`.

Strategy (the reference's):
  * TP over "model": attention heads, FFN hidden, experts (EP), vocab;
  * FSDP over "data": the d_model axis of every weight (ZeRO-3-style —
    optimizer state inherits the same specs, giving ZeRO sharding for free);
  * "pod" is pure DP: params replicated across pods, batch sharded over
    ("pod", "data");
  * decode caches: batch over "data"; the *time* axis of long dense caches
    over "model"; recurrent states shard heads/width over "model".

A spec is a tuple with one entry per leading tensor dim (dims past its end
are unsharded): None, an axis name, or a tuple of axis names — the entries
of the reference's `PartitionSpec`, so the two compare entry by entry.
`placements(spec, mesh)` turns a spec into DTensor placements, one a mesh
dim: `Shard(d)` on each mesh dim that the entry of tensor dim d names (a
tuple such as ("data", "model") shards dim d over both, data first, as
GSPMD orders them), `Replicate()` on the others.

Rules are the reference's `_PARAM_RULES`, unchanged, matched against each
leaf's path *in the reference's tree*. The reference stacks its layers
(`layers/attn/wq/w` has a leading n_layers dim; the RG-LRU hybrid's
`rec/...` and `attn/...` have two stack dims, (n_groups, per_group), and
its remainder layers are `rem/<j>/...` unstacked; the encoder-decoder's
two stacks are `encoder/layers/...` and `decoder/layers/...`); the port
keeps one dict a layer (`layers/<i>/...`, `encoder/layers/<i>/...`). So
`reference_path` maps a port path to the reference's (the leaf
correspondence `convert.lm_params`, `rwkv6_params` and `rglru_params`
use), the rule gives the reference's spec, and its
leading stack-dim entries (always None) are dropped: the anchored rules
(`^layers/u$`, the hybrid's `rec/.*out$` that its remainder layers do not
match) give exactly the reference's specs.

Every spec function takes a `DeviceMesh` or a shape-only
`launch.mesh.MeshShape` (axis names and sizes), so the rules are checked
at 256 or 512 devices without any.
"""

from __future__ import annotations

import dataclasses
import math
import re

import numpy as np
import torch

from ..optim import adamw
from .mesh import dp_axes, mesh_shape

_PARAM_RULES = [
    # attention / generic dense projections:  (D, out) and (in, D)
    (r"attn/wq/w$", ("data", "model")),
    (r"attn/wk/w$", ("data", "model")),
    (r"attn/wv/w$", ("data", "model")),
    (r"attn/wo/w$", ("model", "data")),
    (r"xattn/w[qkv]/w$", ("data", "model")),
    (r"xattn/wo/w$", ("model", "data")),
    (r"attn/w[qkv]/b$", ("model",)),
    (r"attn/wo/b$", ("data",)),
    (r"xattn/w[qkv]/b$", ("model",)),
    # dense MLP
    (r"mlp/wg/w$", ("data", "model")),
    (r"mlp/wu/w$", ("data", "model")),
    (r"mlp/wd/w$", ("model", "data")),
    (r"mlp/wu/b$", ("model",)),
    (r"mlp/wd/b$", ("data",)),
    # MoE: experts over "model" (EP), d_model over "data" (FSDP)
    (r"moe/router/w$", ("data", "model")),
    (r"moe/wg$", ("model", "data", None)),
    (r"moe/wu$", ("model", "data", None)),
    (r"moe/wd$", ("model", None, "data")),
    (r"moe/shared/wg$", (None, "data", "model")),
    (r"moe/shared/wu$", (None, "data", "model")),
    (r"moe/shared/wd$", (None, "model", "data")),
    # embeddings / unembedding: the input gather wants d_model sharded (a
    # vocab-sharded table makes XLA rematerialize it whole, the reference
    # found), the unembed head vocab TP
    (r"embed/table$", (None, ("data", "model"))),
    (r"head/table$", ("model", "data")),
    # rwkv6 time/channel mix
    (r"w[rkvgo]$", ("data", "model")),
    (r"w_lora_a$", ("data", None)),
    (r"w_lora_b$", (None, "model")),
    (r"^layers/u$", ("model", None)),
    (r"c[kr]$", ("data", "model")),
    (r"cv$", ("model", "data")),
    (r"w0$", ("model",)),
    # rg-lru recurrent blocks
    (r"in_[xg]$", ("data", "model")),
    (r"rec/.*out$", ("model", "data")),
    (r"conv_w$", (None, "model")),
    (r"conv_b$", ("model",)),
    (r"w[ax]$", ("data", "model")),
    (r"b[ax]$", ("model",)),
    (r"lam$", ("model",)),
]

_EMBED_CANDIDATES = [
    # preferred: d_model over both axes (local gather)
    (None, ("data", "model")),
    # fallback for small d_model: vocab over data, d over model
    ("data", "model"),
    # last resort: d over model only
    (None, "model"),
]


# --------------------------------------------------------------------------- #
# Paths
# --------------------------------------------------------------------------- #
def named_leaves(tree, prefix: str = "") -> list:
    """(path, leaf) of every tensor of a tree of dicts, lists and tuples, in
    `optim.adamw.leaves` order; paths join keys and indices with "/"."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in named_leaves(v, f"{prefix}/{k}" if prefix else str(k))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, f"{prefix}/{i}" if prefix else str(i))]
    return [(prefix, tree)]


def _is_hybrid(params) -> bool:
    return any(isinstance(lp, dict) and "in_x" in lp for lp in params.get("layers", ()))


def reference_path(path: str, cfg=None) -> tuple:
    """(the reference's path of the port's leaf `path`, the number of stack
    dims the reference's leaf has in front of the port's). The hybrid's
    layout needs `cfg` (its pattern and depth)."""
    m = re.match(r"^((?:encoder/|decoder/)?)layers/(\d+)/(.*)$", path)
    if m is None:
        return path, 0
    stack, i, rest = m.group(1), int(m.group(2)), m.group(3)
    if cfg is None or cfg.family != "hybrid":
        return f"{stack}layers/{rest}", 1
    p = len(cfg.pattern)
    n_full = cfg.n_layers // p * p
    if i >= n_full:
        return f"rem/{i - n_full}/{rest}", 0
    kind = cfg.pattern[i % p]
    return f"{kind}/{rest}", 2


# --------------------------------------------------------------------------- #
# Parameter rules
# --------------------------------------------------------------------------- #
def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = mesh_shape(mesh)
    if isinstance(axis, (tuple, list)):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def sanitize(spec: tuple, shape, mesh) -> tuple:
    """Drop spec axes that do not evenly divide the dim (the reference's
    divisibility semantics; e.g. whisper/granite vocabs)."""
    out = []
    for i, ax in enumerate(spec):
        size = _axis_size(mesh, ax)
        out.append(ax if (size > 1 and shape[i] % size == 0) or size == 1 else None)
    return tuple(out)


def param_spec(path: str, ndim: int) -> tuple:
    """The reference's rule for a leaf of the reference's tree (`path` and
    `ndim` the reference's)."""
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path):
            skip = ndim - len(spec)
            if skip < 0:
                raise ValueError(f"{path}: spec {spec} too long for ndim {ndim}")
            return tuple([None] * skip + list(spec))
    return ()  # norms, lerp coefficients, u/bonus vectors: replicated


def port_param_spec(path: str, ndim: int, cfg=None) -> tuple:
    """The spec of the port's leaf `path` (`ndim` its dims): the reference's
    rule on the reference's path, its stack dims dropped."""
    ref_path, n_stack = reference_path(path, cfg)
    spec = param_spec(ref_path, ndim + n_stack)
    if any(ax is not None for ax in spec[:n_stack]):
        raise ValueError(f"{path}: a stack dim of {ref_path} is sharded: {spec}")
    return spec[n_stack:]


def _map_named(fn, tree, prefix: str = ""):
    """`fn(path, leaf)` over a tree, keeping its structure."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_named(fn, v, f"{prefix}/{i}" if prefix else str(i))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def param_specs(params, mesh=None, cfg=None):
    """A tree of specs matching `params` (tensors: meta, CPU or CUDA). With
    a mesh, each spec is sanitized for divisibility, and `embed/table`
    takes the first of `_EMBED_CANDIDATES` that divides evenly. The hybrid
    family's tree needs `cfg`."""
    if cfg is None and _is_hybrid(params):
        raise ValueError("the RG-LRU hybrid's tree needs cfg (its layer layout)")

    def spec(path, leaf):
        s = port_param_spec(path, leaf.dim(), cfg)
        if mesh is None:
            return s
        if path.endswith("embed/table"):
            for cand in _EMBED_CANDIDATES:
                if sanitize(cand, leaf.shape, mesh) == cand:
                    return cand
        return sanitize(s, leaf.shape, mesh)

    return _map_named(spec, params)


def opt_specs(param_specs_tree) -> adamw.AdamWState:
    """AdamW state: m/v mirror params; count replicated."""
    return adamw.AdamWState(m=param_specs_tree, v=param_specs_tree, count=())


# --------------------------------------------------------------------------- #
# Batch / cache rules
# --------------------------------------------------------------------------- #
def batch_specs(batch, mesh):
    """Shard the leading batch dim over the DP axes (pod folds in)."""
    dp = dp_axes(mesh)
    dp_size = _axis_size(mesh, dp)
    entry = dp[0] if len(dp) == 1 else dp   # PartitionSpec's spelling

    def spec(path, leaf):
        if leaf.dim() == 0:
            return ()
        if leaf.shape[0] % dp_size == 0:
            return (entry,) + (None,) * (leaf.dim() - 1)
        return ()  # unshardable batch (e.g. B=1): replicate
    return _map_named(spec, batch)


def cache_specs(cache, mesh, time_axis_model: bool = True):
    """Decode caches: (L, B, KV, T, hd) (the port's layout) → B over data,
    T over model (long dense caches); recurrent states: heads/width over
    model. The reference's rules, with T and KV in the port's order."""
    sizes = mesh_shape(mesh)
    data_size, model_size = sizes["data"], sizes["model"]

    def spec(path, leaf):
        nd, shape = leaf.dim(), leaf.shape
        b = "data" if nd >= 2 and shape[1] % data_size == 0 else None
        if nd >= 5 and path.split("/")[-1] in ("k", "v", "xk", "xv"):
            t_ok = time_axis_model and shape[3] % model_size == 0 and shape[3] >= 4096
            return (None, b, None, "model" if t_ok else None, None)
        if path.endswith("wkv"):          # (L, B, H, hdk, hdv)
            return (None, b, "model" if shape[2] % model_size == 0 else None, None, None)
        if path.endswith("shift_att") or path.endswith("shift_ffn") or path.endswith("h"):
            return (None, b, "model" if shape[2] % model_size == 0 else None)
        if path.endswith("conv"):         # (R, B, K-1, W)
            return (None, b, None, "model" if shape[3] % model_size == 0 else None)
        return ()
    return _map_named(spec, cache)


# --------------------------------------------------------------------------- #
# Placement on a DeviceMesh
# --------------------------------------------------------------------------- #
def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements (one a mesh dim) of `spec` on `mesh`."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh_shape(mesh))
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry}: axes out of the mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's `jax.sharding.NamedSharding`)."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def is_spec(x) -> bool:
    return isinstance(x, NamedSharding) or (
        isinstance(x, tuple) and not hasattr(x, "_fields") and all(
            e is None or isinstance(e, (str, tuple)) for e in x))


def zip_specs(fn, tree, specs):
    """`fn(leaf, spec)` over a tree and its spec tree (a spec or a
    `NamedSharding` is a leaf of the spec tree)."""
    if is_spec(specs):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: zip_specs(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(zip_specs(fn, t, s) for t, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(zip_specs(fn, t, s) for t, s in zip(tree, specs))
    raise TypeError(f"no spec for a leaf of type {type(tree).__name__}")


def named_shardings(spec_tree, mesh):
    """A tree of `NamedSharding`s of `spec_tree`'s specs on `mesh`."""
    return zip_specs(lambda s, _: NamedSharding(mesh, s), spec_tree, spec_tree)


def distribute(x, mesh, spec):
    """A tensor or numpy array placed on `mesh` under `spec`: a DTensor
    (`distribute_tensor`: each rank keeps its shards, scattered from rank
    0's copy, of the whole tensor every rank holds; a DTensor already so
    placed as it is)."""
    from torch.distributed.tensor import distribute_tensor

    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))   # a copy; keeps a 0-d array 0-d
    return distribute_tensor(x.detach(), mesh, placements(spec, mesh))


def with_shardings(tree, spec_tree, mesh):
    """Every leaf of `tree` (tensors or numpy arrays) placed on `mesh`
    under its spec (`distribute`)."""
    return zip_specs(lambda x, s: distribute(x, mesh, s), tree, spec_tree)


def place(x, sharding: NamedSharding):
    """A leaf placed under its `NamedSharding` (`distribute`)."""
    return distribute(x, sharding.mesh, sharding.spec)
