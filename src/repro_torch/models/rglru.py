"""RecurrentGemma-style hybrid (the hybrid family): RG-LRU recurrent blocks
and local attention, init, forward and the serving path (prefill +
single-token decode), in torch.

Mirrors `repro.models.rglru`. The layer pattern cycles ("rec", "rec",
"attn"):

  * recurrent block — rmsnorm, an input projection to `lru_width` twice (a
    value branch and a gate branch through tanh-approximated GeLU, which is
    `jax.nn.gelu`'s default); the value branch goes through a short causal
    conv1d (width 4) and the RG-LRU, whose recurrence runs in the
    hand-written `rglru` kernel (`kernels.ops.rglru`, its plain version for
    CPU tensors), in prefill from zeros and in decode from the carried
    state; merged with the gate branch and projected back to d_model;
  * attention block — MQA with a sliding window and RoPE, prefill through
    `flash_attention` with the window, decode through `decode_attention`
    against a ring KV cache of T = min(cache_len, window) slots (`layers`);
  * every block is followed by a swiglu MLP block (the reference's
    docstring says GeGLU; its code builds and applies swiglu, which the port
    copies).

The embedding is not scaled and the head is a table of its own, as in the
reference's code. The layer stack is a Python list of per-layer parameter
dicts in `cfg.block_kinds()` order (the reference groups them into
(n_groups, per_group, ...) stacks plus a `rem` list; `convert.rglru_params`
carries its tree across). Weights are stored in cfg.dtype (or, for
training, as fp32 masters; every use casts them to the activations' type,
as the reference casts its masters); norm scales and `lam` stay fp32, as
the reference computes with them in fp32. `loss_fn` is the reference's,
with `remat` (`models.remat`) around each layer.

The decode state is {"h": (n_rec, B, W) fp32, "conv": (n_rec, B, K-1, W)
in cfg.dtype, "k", "v": (n_att, B, KV, T, hd) in cfg.dtype}: each recurrent
layer's RG-LRU state and last K-1 conv inputs, each attention layer's ring
cache (the reference's k/v are (n_att, B, T, KV, hd), the same values
permuted). `decode_step` updates it IN PLACE and returns it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from . import layers as L
from . import remat as remat_lib
from .config import ModelConfig
from .transformer import resolve_device


def _lru_width(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


def _dims(cfg: ModelConfig) -> L.AttnDims:
    return L.AttnDims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, False)


def check_config(cfg: ModelConfig) -> None:
    """Raise for any part of `cfg` this port does not serve as the hybrid."""
    if cfg.dtype not in L.DTYPES:
        raise ValueError(f"dtype {cfg.dtype!r}: the port computes in "
                         f"{sorted(L.DTYPES)}")
    if any(k not in ("rec", "attn") for k in cfg.pattern):
        raise ValueError(f"block pattern {cfg.pattern}: the hybrid family has "
                         f"'rec' and 'attn' blocks")
    if cfg.n_layers < len(cfg.pattern):
        raise ValueError(f"{cfg.n_layers} layers hold no whole group of the "
                         f"pattern {cfg.pattern}")
    if cfg.rope_theta <= 0:
        # the reference's hybrid has no sinusoidal positions: it passes
        # rope_theta to `apply_rope` as it is, where 0 makes 1/0 frequencies
        raise ValueError(f"rope_theta {cfg.rope_theta}: the hybrid family rotates "
                         f"its queries and keys by RoPE and needs rope_theta > 0")


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #
def init(cfg: ModelConfig, seed: int = 0, device=None, masters: bool = False,
         place=None):
    """Random weights on `device` (default: the CUDA device; raises if there
    is none): normal(0, 0.02) from a seeded `torch.Generator` on that device
    for the matrices and tables, and the reference's constants for the rest
    (norm scales 1, biases 0, lam 2) — the reference's distributions, not its
    `jax.random` draws (`convert.rglru_params` carries the reference's own
    weights across). With `masters` every leaf is fp32 (training's master
    weights). `place`, if given, takes each leaf as it is made and returns
    what the tree holds (`L.init_leaf`)."""
    check_config(cfg)
    dev = resolve_device(device)
    dt = torch.float32 if masters else L.dtype_of(cfg.dtype)
    # the meta device holds shapes only (the abstract tree of
    # `launch.shardings`): nothing is drawn there
    gen = None if dev.type == "meta" else torch.Generator(device=dev)
    if gen is not None:
        gen.manual_seed(seed)
    D, W, K = cfg.d_model, _lru_width(cfg), cfg.conv1d_width
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def normal(*shape):
        return L.init_leaf(place, gen, shape, dt, dev)

    def full(shape, value, dtype=dt):
        return L.init_leaf(place, None, shape, dtype, dev, value)

    def norm_p():
        return {"scale": full((D,), 1.0, torch.float32)}

    def mlp_p():
        return {"wg": {"w": normal(D, cfg.d_ff)}, "wu": {"w": normal(D, cfg.d_ff)},
                "wd": {"w": normal(cfg.d_ff, D)}}

    def rec():
        return {"ln1": norm_p(), "in_x": normal(D, W), "in_g": normal(D, W),
                "conv_w": normal(K, W), "conv_b": full((W,), 0.0),
                "wa": normal(W, W), "ba": full((W,), 0.0),
                "wx": normal(W, W), "bx": full((W,), 0.0),
                "lam": full((W,), 2.0, torch.float32), "out": normal(W, D),
                "ln2": norm_p(), "mlp": mlp_p()}

    def attn():
        return {"ln1": norm_p(),
                "attn": {"wq": {"w": normal(D, H * hd)}, "wk": {"w": normal(D, KV * hd)},
                         "wv": {"w": normal(D, KV * hd)}, "wo": {"w": normal(H * hd, D)}},
                "ln2": norm_p(), "mlp": mlp_p()}

    return {"embed": {"table": normal(cfg.vocab, D)},
            "layers": [rec() if k == "rec" else attn() for k in cfg.block_kinds()],
            "final_norm": norm_p(), "head": {"table": normal(cfg.vocab, D)}}


# --------------------------------------------------------------------------- #
# Blocks
# --------------------------------------------------------------------------- #
def rglru_scan(x, r, i, lam, h0):
    """x, r, i: (B, S, W); lam: (W,) fp32; h0: (B, W) fp32 → (h (B, S, W) in
    x's type, final h (B, W) fp32), through `kernels.ops.rglru`."""
    # on DTensors (the sharded step) each rank's rows and channels
    h, hT = L.local_shards(ops.rglru, (x, r, i, lam, h0),
                           ((0, 2),) * 3 + ((None, 0), (0, 1)), ((0, 2), (0, 1)))
    return h.to(x.dtype), hT


def _causal_conv(x, w, b, state):
    """Short causal conv along S, as the reference sums it: the K products
    in x's type, added one by one in k order (each add rounded), then + b.
    x: (B, S, W); w: (K, W); b: (W,); state: (B, K-1, W), the K-1 inputs
    before x. Returns (y (B, S, W), new state: the last K-1 rows of the
    concatenation)."""
    K, S = w.shape[0], x.shape[1]
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = xp[:, 0:S] * w[0].to(x.dtype)
    for k in range(1, K):
        y = y + xp[:, k:k + S] * w[k].to(x.dtype)
    return y + b.to(x.dtype), xp[:, xp.shape[1] - (K - 1):]


def _rec_block(lp, x, cfg: ModelConfig, h0, conv_state):
    """x: (B, S, D); h0: (B, W) fp32; conv_state (B, K-1, W). Returns (x,
    final h, new conv state)."""
    dt = x.dtype
    y = L.rmsnorm(lp["ln1"], x)
    vx = y @ L.cast(lp["in_x"], dt)
    g = F.gelu(y @ L.cast(lp["in_g"], dt), approximate="tanh")
    vx, conv_state = _causal_conv(vx, lp["conv_w"], lp["conv_b"], conv_state)
    r = torch.sigmoid(vx @ L.cast(lp["wa"], dt) + L.cast(lp["ba"], dt))
    i = torch.sigmoid(vx @ L.cast(lp["wx"], dt) + L.cast(lp["bx"], dt))
    h, hT = rglru_scan(vx, r, i, lp["lam"], h0)
    x = L.residual(x, (h * g) @ L.cast(lp["out"], dt))
    x = L.residual(x, L.mlp_apply(lp["mlp"], L.rmsnorm(lp["ln2"], x)))
    return x, hT, conv_state


def _attn_block(lp, x, cfg: ModelConfig):
    """x: (B, S, D) at positions 0..S-1. Returns (x, (k, v)) with k, v of
    shape (B, KV, S, hd)."""
    a, kv = L.attention_apply(lp["attn"], _dims(cfg), L.rmsnorm(lp["ln1"], x),
                              cfg.rope_theta, causal=True, window=cfg.window)
    x = L.residual(x, a)
    x = L.residual(x, L.mlp_apply(lp["mlp"], L.rmsnorm(lp["ln2"], x)))
    return x, kv


def make_state(cfg: ModelConfig, batch: int, cache_len: int, device=None, like=None):
    """The decode state of a batch, zeros (see the module docstring), on
    `device` (the card when None, as `init`). With `like` a DTensor (a
    prefill on a mesh) each leaf is a DTensor placed as the kernels take
    it: rows over the data dims, the width or the KV heads over "model"
    (`layers.sharded_zeros`)."""
    check_config(cfg)
    device = resolve_device(device)
    kinds = cfg.block_kinds()
    n_rec, n_att = kinds.count("rec"), kinds.count("attn")
    W, dt = _lru_width(cfg), L.dtype_of(cfg.dtype)
    kv = (n_att, batch, cfg.n_kv_heads, L.ring_len(cache_len, cfg.window), cfg.hd)
    like = like if like is not None else torch.empty((), device=device)
    return {
        "h": L.sharded_zeros((n_rec, batch, W), torch.float32, like, 1, 2),
        "conv": L.sharded_zeros((n_rec, batch, cfg.conv1d_width - 1, W), dt, like, 1, 3),
        "k": L.sharded_zeros(kv, dt, like, 1, 2),
        "v": L.sharded_zeros(kv, dt, like, 1, 2),
    }


def _trunk(params, cfg: ModelConfig, tokens, state=None, remat: str = "none"):
    """Embedding, the layer stack and the final norm over positions 0..S-1,
    every recurrent layer from zeros; fills `state` (in place) when one is
    given; `remat` wraps each layer (`models.remat`). Returns the final
    hidden states (B, S, D)."""
    check_config(cfg)
    x = L.embed(params["embed"], tokens, L.dtype_of(cfg.dtype))
    B = x.shape[0]
    W, K = _lru_width(cfg), cfg.conv1d_width
    h0 = L.replicated(torch.zeros((B, W), dtype=torch.float32, device=x.device), x)
    conv0 = L.replicated(torch.zeros((B, K - 1, W), dtype=x.dtype, device=x.device), x)
    rec_block, attn_block = remat_lib.wrap(_rec_block, remat), remat_lib.wrap(
        _attn_block, remat)
    ri = ai = 0
    for lp, kind in zip(params["layers"], cfg.block_kinds()):
        if kind == "rec":
            x, hT, conv = rec_block(lp, x, cfg, h0, conv0)
            if state is not None:
                state["h"][ri] = hT
                state["conv"][ri] = conv
            ri += 1
        else:
            x, (k, v) = attn_block(lp, x, cfg)
            if state is not None:
                L.write_prefill(state["k"][ai], state["v"][ai], k, v)
            ai += 1
    return L.rmsnorm(params["final_norm"], x)


def forward(params, cfg: ModelConfig, tokens):
    """tokens (B, S) → logits (B, S, V)."""
    return L.unembed(params["head"], _trunk(params, cfg, tokens))


def loss_fn(params, cfg: ModelConfig, batch, remat: str = "none"):
    """Next-token LM loss → (loss, {"xent": loss}). batch: {tokens (B, S),
    loss_mask (B, S)?}."""
    tokens = batch["tokens"]
    logits = L.unembed(params["head"], _trunk(params, cfg, tokens, remat=remat))
    mask = batch.get("loss_mask")
    loss = L.softmax_xent(logits[:, :-1], tokens[:, 1:],
                          None if mask is None else mask[:, 1:])
    return loss, {"xent": loss}


# --------------------------------------------------------------------------- #
# Serving: prefill fills the recurrent states and the ring caches; decode
# carries them one token at a time
# --------------------------------------------------------------------------- #
def prefill(params, cfg: ModelConfig, tokens, cache_len: int):
    """Run the prompt from position 0; return (last-token logits (B, V),
    decode state, next_pos (B,) int32). The ring caches keep the prompt's
    last T = min(cache_len, window) positions, position p at slot p % T.
    Only the last position is unembedded (the reference unembeds it
    alone too)."""
    B, S = tokens.shape
    state = make_state(cfg, B, cache_len, device=tokens.device, like=tokens)
    x = _trunk(params, cfg, tokens, state)
    logits = L.unembed(params["head"], x[:, -1])
    return logits, state, torch.full((B,), S, dtype=torch.int32, device=tokens.device)


def decode_step(params, cfg: ModelConfig, token, state, pos):
    """token (B,) int, pos (B,) int32 → (logits (B, V), state, pos + 1). The
    state is updated in place (and returned, as the reference returns its
    new state)."""
    dims = _dims(cfg)
    x = L.embed(params["embed"], token[:, None], L.dtype_of(cfg.dtype))  # (B, 1, D)
    ri = ai = 0
    for lp, kind in zip(params["layers"], cfg.block_kinds()):
        if kind == "rec":
            x, hT, conv = _rec_block(lp, x, cfg, state["h"][ri], state["conv"][ri])
            state["h"][ri] = hT
            state["conv"][ri] = conv
            ri += 1
        else:
            a, _, _ = L.attention_decode(lp["attn"], dims, L.rmsnorm(lp["ln1"], x),
                                         state["k"][ai], state["v"][ai], pos,
                                         cfg.rope_theta)
            x = L.residual(x, a)
            x = L.residual(x, L.mlp_apply(lp["mlp"], L.rmsnorm(lp["ln2"], x)))
            ai += 1
    x = L.rmsnorm(params["final_norm"], x)
    return L.unembed(params["head"], x)[:, 0], state, pos + 1
