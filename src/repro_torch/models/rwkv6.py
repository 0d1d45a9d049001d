"""RWKV-6 "Finch" (the ssm family): init, forward, and the serving path
(prefill + single-token decode carrying an O(1) state), in torch.

Mirrors `repro.models.rwkv6`. Per block:

  * time mix — token-shift lerps give r, k, v, g and the decay input; the
    decay is data dependent, w_t = exp(-exp(w0 + lora(x_t))); the WKV
    recurrence runs in the hand-written `wkv6` kernel (`kernels.ops.wkv6`,
    its plain version for CPU tensors), in prefill from zeros and in decode
    from the carried state; then an rmsnorm over the whole d_model
    (`gn`, as the reference's code computes it), SiLU(g) gating and the
    output projection;
  * channel mix — token-shift lerps, k = relu(x Wk)^2, out = sigmoid(x Wr) *
    (k Wv).

The layer stack is a Python loop over per-layer parameter dicts (the
reference scans stacked leaves). Weights are stored in cfg.dtype (or, for
training, as fp32 masters; every use casts them to the activations' type,
as the reference casts its masters); the layernorms' scale and bias,
`gn`'s scale, `w0` and `u` stay fp32, as the reference computes with them
in fp32. `loss_fn` is the reference's, with `remat` (`models.remat`) around
each layer. The reference runs its chunk-parallel
`wkv_chunked` when S is a multiple of 256 above 256 and the sequential scan
otherwise; the port has the kernel's one path (the two agree to fp32
rounding). `wkv_chunked` itself, the form for context parallelism, is not
ported (ROADMAP.md, Queue 1 item 15.3).

The decode state is {"shift_att", "shift_ffn": (L, B, D) in cfg.dtype,
"wkv": (L, B, H, hd, hd) fp32}: each mix's last layernormed input row and
each layer's WKV state. Functions return a new state and leave the one
they are given unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from . import layers as L
from . import remat as remat_lib
from .config import ModelConfig
from .transformer import not_ported, resolve_device

LORA_RANK = 64


def _n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


def check_config(cfg: ModelConfig) -> None:
    """Raise for any part of `cfg` this port does not serve as rwkv6."""
    if cfg.dtype not in L.DTYPES:
        raise ValueError(f"dtype {cfg.dtype!r}: the port computes in "
                         f"{sorted(L.DTYPES)}")
    if cfg.norm != "layernorm" or any(k != "rwkv" for k in cfg.block_kinds()):
        raise not_ported(f"ssm family with norm={cfg.norm!r}, pattern "
                         f"{cfg.pattern}", "15.3")
    if cfg.d_model % cfg.rwkv_head_dim:
        raise ValueError(f"d_model {cfg.d_model} is not a multiple of "
                         f"rwkv_head_dim {cfg.rwkv_head_dim}")


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #
def init(cfg: ModelConfig, seed: int = 0, device=None, masters: bool = False,
         place=None):
    """Random weights on `device` (default: the CUDA device; raises if there
    is none): normal(0, 0.02) from a seeded `torch.Generator` on that
    device for the matrices and tables, and the reference's constants for
    the rest (layernorms 1 and 0, lerp coefficients 0.5, w0 -6, u 0, gn
    scale 1) — the reference's distributions, not its `jax.random` draws
    (`convert.rwkv6_params` carries the reference's own weights across).
    With `masters` every leaf is fp32 (training's master weights). `place`,
    if given, takes each leaf as it is made and returns what the tree holds
    (`L.init_leaf`)."""
    check_config(cfg)
    dev = resolve_device(device)
    dt = torch.float32 if masters else L.dtype_of(cfg.dtype)
    # the meta device holds shapes only (the abstract tree of
    # `launch.shardings`): nothing is drawn there
    gen = None if dev.type == "meta" else torch.Generator(device=dev)
    if gen is not None:
        gen.manual_seed(seed)
    D, dff = cfg.d_model, cfg.d_ff
    H, hd = _n_heads(cfg), cfg.rwkv_head_dim

    def normal(*shape):
        return L.init_leaf(place, gen, shape, dt, dev)

    def full(shape, value, dtype=torch.float32):
        return L.init_leaf(place, None, shape, dtype, dev, value)

    def layernorm_p():
        return {"scale": full((D,), 1.0), "bias": full((D,), 0.0)}

    def layer():
        lp = {"ln1": layernorm_p(),
              "mix": {m: full((D,), 0.5, dt)
                      for m in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w")}}
        for name in ("wr", "wk", "wv", "wg", "wo"):
            lp[name] = normal(D, D)
        lp["w0"] = full((D,), -6.0)
        lp["w_lora_a"] = normal(D, LORA_RANK)
        lp["w_lora_b"] = normal(LORA_RANK, D)
        lp["u"] = full((H, hd), 0.0)
        lp["gn"] = {"scale": full((D,), 1.0)}
        lp["ln2"] = layernorm_p()
        lp["cmix"] = {m: full((D,), 0.5, dt) for m in ("mu_k", "mu_r")}
        lp["ck"] = normal(D, dff)
        lp["cv"] = normal(dff, D)
        lp["cr"] = normal(D, D)
        return lp

    embed = {"table": normal(cfg.vocab, D)}
    layers = [layer() for _ in range(cfg.n_layers)]
    return {"embed": embed, "layers": layers, "final_norm": layernorm_p(),
            "head": {"table": normal(cfg.vocab, D)}}


# --------------------------------------------------------------------------- #
# Blocks
# --------------------------------------------------------------------------- #
def _token_shift(x, prev):
    """x: (B, S, D); prev: (B, D), the last row of the previous chunk."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _lerp(x, xs, mu):
    return x + (xs - x) * L.cast(mu, x.dtype)


def _time_mix(lp, x, cfg: ModelConfig, shift_state, wkv_state):
    """x: (B, S, D) layernormed; shift_state (B, D); wkv_state (B, H, hd,
    hd) fp32. Returns (out (B, S, D), new_shift (B, D),
    new wkv state)."""
    B, S, D = x.shape
    H, hd = _n_heads(cfg), cfg.rwkv_head_dim
    xs = _token_shift(x, shift_state)
    new_shift = x[:, -1, :]
    mix = lp["mix"]
    xr, xk, xv, xg, xw = (_lerp(x, xs, mix[m])
                          for m in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"))
    dt = x.dtype
    r = L.split_heads(xr @ L.cast(lp["wr"], dt), B, S, H, hd)
    k = L.split_heads(xk @ L.cast(lp["wk"], dt), B, S, H, hd)
    v = L.split_heads(xv @ L.cast(lp["wv"], dt), B, S, H, hd)
    g = xg @ L.cast(lp["wg"], dt)
    # data-dependent decay (Finch): w = exp(-exp(w0 + lora(xw))), in fp32
    dlog = lp["w0"] + ((xw @ L.cast(lp["w_lora_a"], dt))
                       @ L.cast(lp["w_lora_b"], dt)).float()
    w = L.split_heads(torch.exp(-torch.exp(dlog)), B, S, H, hd)
    # r, k, v go in as the projections made them (the kernel converts bf16
    # to fp32 inside, exactly); w, u and the state are fp32
    # on DTensors (the sharded step) each rank's rows and heads
    out, wkv_state = L.local_shards(ops.wkv6, (r, k, v, w, lp["u"], wkv_state),
                                    ((0, 2),) * 4 + ((None, 0), (0, 1)), ((0, 2), (0, 1)))
    out = L.rmsnorm(lp["gn"], out.view(B, S, D)).to(dt) * F.silu(g)
    return out @ L.cast(lp["wo"], dt), new_shift, wkv_state


def _channel_mix(lp, x, shift_state):
    xs = _token_shift(x, shift_state)
    new_shift = x[:, -1, :]
    xk = _lerp(x, xs, lp["cmix"]["mu_k"])
    xr = _lerp(x, xs, lp["cmix"]["mu_r"])
    k = torch.square(torch.relu(xk @ L.cast(lp["ck"], x.dtype)))
    return (torch.sigmoid(xr @ L.cast(lp["cr"], x.dtype))
            * (k @ L.cast(lp["cv"], x.dtype)), new_shift)


def _empty_state(cfg: ModelConfig, B: int, device=None):
    H, hd = _n_heads(cfg), cfg.rwkv_head_dim
    dt = L.dtype_of(cfg.dtype)
    shift = (cfg.n_layers, B, cfg.d_model)
    return {"shift_att": torch.zeros(shift, dtype=dt, device=device),
            "shift_ffn": torch.zeros(shift, dtype=dt, device=device),
            "wkv": torch.zeros((cfg.n_layers, B, H, hd, hd), dtype=torch.float32,
                               device=device)}


def _layer(lp, x, cfg: ModelConfig, shift_att, shift_ffn, wkv):
    """One block → (x, new shift_att, new shift_ffn, new wkv state); the
    residual's sequence sharded between blocks as the transformer's
    (`layers.seq_sharded`)."""
    x = L.seq_sharded(x, cfg.seq_shard_axis)
    a, s_a, s_wkv = _time_mix(lp, L.layernorm(lp["ln1"], x), cfg, shift_att, wkv)
    x = L.residual(x, a)
    x = L.seq_sharded(x, cfg.seq_shard_axis)
    c, s_f = _channel_mix(lp, L.layernorm(lp["ln2"], x), shift_ffn)
    return L.residual(x, c), s_a, s_f, s_wkv


def _trunk(params, cfg: ModelConfig, tokens, state=None, remat: str = "none"):
    """Embedding, the layer stack and the final layernorm, from `state` or,
    with none, from zeros (`_empty_state`); `remat` wraps each layer
    (`models.remat`). Returns (final hidden states (B, S, D), new state)."""
    check_config(cfg)
    x = L.embed(params["embed"], tokens, L.dtype_of(cfg.dtype))
    if state is None:
        state = {k: L.replicated(v, x)
                 for k, v in _empty_state(cfg, x.shape[0], x.device).items()}
    layer = remat_lib.wrap(_layer, remat)
    sa, sf, wkv = [], [], []
    for i, lp in enumerate(params["layers"]):
        x, s_a, s_f, s_wkv = layer(lp, x, cfg, state["shift_att"][i],
                                   state["shift_ffn"][i], state["wkv"][i])
        sa.append(s_a)
        sf.append(s_f)
        wkv.append(s_wkv)
    new_state = {"shift_att": torch.stack(sa), "shift_ffn": torch.stack(sf),
                 "wkv": torch.stack(wkv)}
    return L.layernorm(params["final_norm"], x), new_state


def forward(params, cfg: ModelConfig, tokens, state=None):
    """tokens (B, S) → (logits (B, S, V), new state)."""
    x, new_state = _trunk(params, cfg, tokens, state)
    return L.unembed(params["head"], x), new_state


def loss_fn(params, cfg: ModelConfig, batch, remat: str = "none"):
    """Next-token LM loss → (loss, {"xent": loss}), from a zero state.
    batch: {tokens (B, S), loss_mask (B, S)?}."""
    tokens = batch["tokens"]
    x, _ = _trunk(params, cfg, tokens, remat=remat)
    logits = L.unembed(params["head"], x)
    mask = batch.get("loss_mask")
    loss = L.softmax_xent(logits[:, :-1], tokens[:, 1:],
                          None if mask is None else mask[:, 1:])
    return loss, {"xent": loss}


# --------------------------------------------------------------------------- #
# Serving: the state is the cache — prefill is a forward from zeros, decode
# a one-token forward from the carried state
# --------------------------------------------------------------------------- #
def prefill(params, cfg: ModelConfig, tokens, cache_len: int = 0):
    """Run the prompt from a zero state; return (last-token logits (B, V),
    state, next_pos (B,) int32). `cache_len` is unused: the state has a
    fixed size. Only the last position is unembedded (the reference
    unembeds all and keeps the last)."""
    x, state = _trunk(params, cfg, tokens)
    B, S = tokens.shape
    logits = L.unembed(params["head"], x[:, -1])
    return logits, state, torch.full((B,), S, dtype=torch.int32, device=tokens.device)


def decode_step(params, cfg: ModelConfig, token, state, pos):
    """token (B,) int, pos (B,) int32 → (logits (B, V), new state, pos + 1)."""
    logits, state = forward(params, cfg, token[:, None], state)
    return logits[:, 0], state, pos + 1
