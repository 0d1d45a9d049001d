"""Decoder-only transformer: init, forward, and the serving path (prefill +
single-token decode with a KV cache), in torch.

Mirrors `repro.models.transformer` for the dense family (qwen2, mistral,
granite, yi), the MoE family (qwen2-moe, phi3.5-moe: a per-layer `"moe"`
FFN, `models.moe`, in place of the dense MLP), the VLM family (llava:
`prefix_embeds` (B, P, D) in front of the embedded tokens, positions over
P + S, the loss over the text only) and the encoder-decoder's decoder
(whisper, `models.encdec`: cross-attention to the encoder's states after
self-attention, the gelu MLP with biases, sinusoidal positions in place
of RoPE when rope_theta <= 0). The layer stack is a Python loop over a
list of per-layer parameter dicts (the reference scans stacked leaves);
there is no sequence-sharding constraint, a no-op on one device.
Training (`loss_fn`) takes fp32 master weights, which every use casts to
cfg.dtype, and `remat` (`models.remat`) around each layer. Prefill
attention runs the `flash_attention` kernel (cross-attention too: not
causal, Sq = the text, Sk = the frames), decode attention the
`decode_attention` kernel (cross-attention over all F frames) (`layers`).
The KV cache is (L, B, KV, T, hd), so one layer's slice is the decode
kernel's (B, KV, T, hd) operand without a copy; the reference's cache is
(L, B, T, KV, hd), the same values permuted; the cross cache `xk`/`xv` is
(L, B, KV, F, hd) likewise. With a sliding window the cache is a ring of
T = min(cache_len, window) slots, as the reference's is.

Norms are rmsnorm or layernorm, as the reference's `make_norm` picks them;
the MLP is swiglu or gelu. A block pattern other than attention layers is
not this family's: the hybrid family (`rglru`) serves it.
"""

from __future__ import annotations

import torch

from .. import core
from . import layers as L
from . import moe, remat as remat_lib
from .config import ModelConfig


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, Queue 1 item {item})")


def check_config(cfg: ModelConfig) -> None:
    """Raise for any part of `cfg` this family does not compute."""
    if cfg.dtype not in L.DTYPES:
        raise ValueError(f"dtype {cfg.dtype!r}: the port computes in "
                         f"{sorted(L.DTYPES)}")
    if cfg.act not in ("swiglu", "gelu"):
        raise ValueError(f"act {cfg.act!r}: the MLP is 'swiglu' or 'gelu'")
    if any(k != "attn" for k in cfg.block_kinds()):
        raise ValueError(f"block pattern {cfg.pattern} is not the dense "
                         f"family's (the hybrid family serves it)")


def resolve_device(device) -> torch.device:
    return core.resolve_device(device, "repro_torch serves")


def _dims(cfg: ModelConfig) -> L.AttnDims:
    return L.AttnDims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.qkv_bias)


def _norm(cfg: ModelConfig):
    """The reference's `make_norm`: rmsnorm, else layernorm."""
    return L.rmsnorm if cfg.norm == "rmsnorm" else L.layernorm


def _ffn(lp, cfg: ModelConfig, x):
    """The block's FFN on the normed x → (out, metrics): the MoE layer's
    (`moe_dropped`, `moe_dropped_pre_steal`, `moe_aux`), or the dense MLP
    with none. Prefill and decode drop them, as the reference's do."""
    if cfg.moe is not None:
        # on DTensors (the sharded step) the layer is whole on every rank (its
        # tokens and experts gathered), so routing and capacities are the
        # reference's over all B·S tokens; out: y and 3 metrics
        return L.replicated_call(moe.moe_apply, (lp["moe"], x, cfg.moe), n_out=4)
    return L.mlp_apply(lp["mlp"], x, cfg.act), {}


def _rope(cfg: ModelConfig):
    """RoPE's theta, or None where positions are sinusoidal (rope_theta <= 0)."""
    return cfg.rope_theta if cfg.rope_theta > 0 else None


def _add_positions(x, cfg: ModelConfig, n: int, rows=None):
    """x + the n-row sinusoidal table (its rows `rows`, indices, when given)
    in x's type when rope_theta <= 0 (the reference adds it in cfg.dtype),
    else x."""
    if cfg.rope_theta > 0:
        return x
    pe = L.sinusoidal_table(n, cfg.d_model, x.device)
    pe = (pe if rows is None else pe[rows]).to(x.dtype)
    return x + L.replicated(pe, x)


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #
def init(cfg: ModelConfig, seed: int = 0, device=None, masters: bool = False,
         place=None):
    """Random weights on `device` (default: the CUDA device; raises if there
    is none): normal(0, 0.02) from a seeded `torch.Generator` on that
    device, ones for norm scales, zeros for biases and layernorm's shifts —
    the reference's distributions, not its `jax.random` draws
    (`convert.lm_params` carries the reference's own weights across).
    Weights are stored in cfg.dtype (the serving parameters), or with
    `masters` in fp32 (training's master weights, the same draws before
    the cast); norm scales and shifts in fp32. `place`, if given, takes
    each leaf as it is made and returns what the tree holds (`L.init_leaf`).
    A layer holds the reference's leaves: ln1, attn, ln2, the FFN (`moe`,
    or `mlp`: swiglu's wg, wu, wd, or gelu's wu, wd with biases), and with
    cross-attention lnx and xattn."""
    check_config(cfg)
    make = LeafMaker(cfg, seed, device, masters, place)
    # the layers are drawn first, then the embedding
    layers = [make.layer(cfg.norm, cfg.act, cfg.moe, cfg.cross_attention)
              for _ in range(cfg.n_layers)]
    params = {"embed": {"table": make.normal(cfg.vocab, cfg.d_model)}, "layers": layers,
              "final_norm": make.norm(cfg.norm)}
    if not cfg.tie_embeddings:
        params["head"] = {"table": make.normal(cfg.vocab, cfg.d_model)}
    return params


class LeafMaker:
    """The leaves of one `init` on `device`, drawn in the order they are
    made from a `torch.Generator` seeded with `seed` (none on the meta
    device, which holds shapes only: the abstract tree of
    `launch.shardings`), stored in fp32 with `masters` else in cfg.dtype,
    each handed to `place` when given (`L.init_leaf`)."""

    def __init__(self, cfg: ModelConfig, seed: int, device, masters: bool, place):
        self.cfg, self.place = cfg, place
        self.dev = resolve_device(device)
        self.dt = torch.float32 if masters else L.dtype_of(cfg.dtype)
        self.gen = None if self.dev.type == "meta" else torch.Generator(device=self.dev)
        if self.gen is not None:
            self.gen.manual_seed(seed)

    def normal(self, *shape):
        return L.init_leaf(self.place, self.gen, shape, self.dt, self.dev)

    def full(self, shape, value, dtype=None):
        return L.init_leaf(self.place, None, shape, dtype or self.dt, self.dev, value)

    def dense(self, d_in, d_out, bias=False):
        p = {"w": self.normal(d_in, d_out)}
        if bias:
            p["b"] = self.full((d_out,), 0.0)
        return p

    def norm(self, kind: str):
        """rmsnorm's scale, or layernorm's scale and shift, in fp32."""
        D = self.cfg.d_model
        p = {"scale": self.full((D,), 1.0, torch.float32)}
        if kind != "rmsnorm":
            p["bias"] = self.full((D,), 0.0, torch.float32)
        return p

    def attention(self):
        c = self.cfg
        D, H, KV, hd = c.d_model, c.n_heads, c.n_kv_heads, c.hd
        return {"wq": self.dense(D, H * hd, c.qkv_bias),
                "wk": self.dense(D, KV * hd, c.qkv_bias),
                "wv": self.dense(D, KV * hd, c.qkv_bias),
                "wo": self.dense(H * hd, D)}

    def layer(self, norm: str, act: str, moe_cfg=None, cross: bool = False):
        """A block's leaves: ln1, attn, ln2, the FFN (`moe`, or `mlp`:
        swiglu's wg, wu, wd, or gelu's wu, wd with biases), and with
        `cross` lnx and xattn."""
        D, F = self.cfg.d_model, self.cfg.d_ff
        p = {"ln1": self.norm(norm), "attn": self.attention(), "ln2": self.norm(norm)}
        if moe_cfg is not None:
            p["moe"] = moe.moe_init(D, moe_cfg, self.normal)
        elif act == "swiglu":
            p["mlp"] = {"wg": self.dense(D, F), "wu": self.dense(D, F), "wd": self.dense(F, D)}
        else:
            p["mlp"] = {"wu": self.dense(D, F, True), "wd": self.dense(F, D, True)}
        if cross:
            p["lnx"] = self.norm(norm)
            p["xattn"] = self.attention()
        return p


# --------------------------------------------------------------------------- #
# Forward (prefill)
# --------------------------------------------------------------------------- #
def _layer(lp, x, cfg: ModelConfig, enc_out=None):
    """One block over positions 0..S-1 → (x, (k, v), (xk, xv) or None, the
    FFN's metrics): self-attention, cross-attention to `enc_out` (B, F, D)
    when the config has it, the FFN."""
    norm, dims = _norm(cfg), _dims(cfg)
    a, kv = L.attention_apply(lp["attn"], dims, norm(lp["ln1"], x), _rope(cfg),
                              causal=True, window=cfg.window)
    x = x + a
    xkv = None
    if cfg.cross_attention:
        c, xkv = L.attention_apply(lp["xattn"], dims, norm(lp["lnx"], x), None,
                                   causal=False, kv_x=enc_out)
        x = x + c
    f, metrics = _ffn(lp, cfg, norm(lp["ln2"], x))
    return x + f, kv, xkv, metrics


def _check_inputs(cfg: ModelConfig, enc_out) -> None:
    if cfg.cross_attention and enc_out is None:
        raise ValueError(f"{cfg.name}: a cross-attention decoder needs enc_out "
                         f"(the encoder's states)")


def _trunk(params, cfg: ModelConfig, tokens, cache=None, remat: str = "none",
           metrics=None, prefix_embeds=None, enc_out=None):
    """Embedding (after `prefix_embeds` (B, P, D), cast to cfg.dtype, when
    given), positions 0..P+S-1 (sinusoidal ones added when rope_theta <=
    0), the layer stack and the final norm; writes each layer's keys and
    values into `cache` (in place) when one is given, its cross keys and
    values too, and appends each layer's metrics to the list `metrics`
    when one is given. `remat` wraps each layer (`models.remat`). Returns
    the final hidden states (B, P + S, D)."""
    _check_inputs(cfg, enc_out)
    x = L.embed(params["embed"], tokens, L.dtype_of(cfg.dtype))
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    x = _add_positions(x, cfg, x.shape[1])
    layer = remat_lib.wrap(_layer, remat)
    for i, lp in enumerate(params["layers"]):
        x, (k, v), xkv, m = layer(lp, x, cfg, enc_out)
        if cache is not None:
            L.write_prefill(cache["k"][i], cache["v"][i], k, v)
            if xkv is not None:
                cache["xk"][i].copy_(xkv[0])
                cache["xv"][i].copy_(xkv[1])
        if metrics is not None:
            metrics.append(m)
    return _norm(cfg)(params["final_norm"], x)


def _head(params):
    return params.get("head", params["embed"])


def forward(params, cfg: ModelConfig, tokens, prefix_embeds=None, enc_out=None):
    """tokens (B, S) → logits (B, P + S, V). prefix_embeds (B, P, D): VLM
    image embeddings in front of the text; enc_out (B, F, D): the encoder's
    states for a cross-attention decoder."""
    check_config(cfg)
    return L.unembed(_head(params), _trunk(params, cfg, tokens, prefix_embeds=prefix_embeds,
                                           enc_out=enc_out))


def aggregate(per_layer: list) -> dict:
    """The reference's per-forward metrics from per-layer ones: `moe_aux`
    summed over the layers, every other metric averaged."""
    if not per_layer or not per_layer[0]:
        return {}
    return {k: (torch.sum if k == "moe_aux" else torch.mean)(
        torch.stack([m[k] for m in per_layer])) for k in per_layer[0]}


def loss_fn(params, cfg: ModelConfig, batch, remat: str = "none"):
    """Next-token LM loss → (loss, metrics). batch: {tokens (B, S),
    loss_mask (B, S)?, prefix_embeds (B, P, D)?, enc_out (B, F, D)?}; with
    a prefix the loss is over the text's logits only (`logits[:, P:]`).
    The MoE family adds `moe_aux` (summed over the layers) to the cross
    entropy; `metrics` holds the layers' aggregated metrics and `xent`, the
    returned loss (the reference's `loss_fn`)."""
    check_config(cfg)
    tokens = batch["tokens"]
    per_layer = []
    x = _trunk(params, cfg, tokens, remat=remat, metrics=per_layer,
               prefix_embeds=batch.get("prefix_embeds"), enc_out=batch.get("enc_out"))
    P = x.shape[1] - tokens.shape[1]
    logits = L.unembed(_head(params), x[:, P:] if P else x)
    mask = batch.get("loss_mask")
    loss = L.softmax_xent(logits[:, :-1], tokens[:, 1:],
                          None if mask is None else mask[:, 1:])
    metrics = aggregate(per_layer)
    if "moe_aux" in metrics:
        loss = loss + metrics["moe_aux"]
    metrics["xent"] = loss
    return loss, metrics


# --------------------------------------------------------------------------- #
# Serving: prefill + single-token decode with KV cache
# --------------------------------------------------------------------------- #
def make_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None,
               enc_frames: int = 0):
    """KV cache: k/v (L, B, KV, T, hd) zeros in cfg.dtype, T =
    `layers.ring_len(cache_len, cfg.window)`, and with cross-attention and
    `enc_frames` F > 0 xk/xv (L, B, KV, F, hd), on `device` (the card when
    None, as `init`)."""
    check_config(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, L.ring_len(cache_len, cfg.window),
             cfg.hd)
    dt = L.dtype_of(cfg.dtype)
    cache = {"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev)}
    if cfg.cross_attention and enc_frames:
        xshape = (cfg.n_layers, batch, cfg.n_kv_heads, enc_frames, cfg.hd)
        cache["xk"] = torch.zeros(xshape, dtype=dt, device=dev)
        cache["xv"] = torch.zeros(xshape, dtype=dt, device=dev)
    return cache


def prefill(params, cfg: ModelConfig, tokens, cache_len: int,
            prefix_embeds=None, enc_out=None):
    """Run the prompt (after `prefix_embeds` (B, P, D) when given) from
    position 0; return (last-token logits (B, V), populated cache, next_pos
    (B,) int32 = P + S). Only the last position is unembedded (the
    reference unembeds all and keeps the last). With a window the prompt
    may be longer than the ring: its last T positions are kept; without
    one, P + S must fit the cache (the reference writes a longer one as a
    ring). A cross-attention decoder takes the encoder's states `enc_out`
    (B, F, D), whose keys and values fill the cross cache."""
    check_config(cfg)
    _check_inputs(cfg, enc_out)
    B, S = tokens.shape
    P = 0 if prefix_embeds is None else prefix_embeds.shape[1]
    if P + S > cache_len and not cfg.window:
        raise ValueError(f"prompt length {P + S} ({P} prefix embeddings + {S} tokens) "
                         f"exceeds cache_len {cache_len}")
    frames = enc_out.shape[1] if cfg.cross_attention else 0
    cache = make_cache(cfg, B, cache_len, device=tokens.device, enc_frames=frames)
    x = _trunk(params, cfg, tokens, cache, prefix_embeds=prefix_embeds, enc_out=enc_out)
    logits = L.unembed(_head(params), x[:, -1])
    next_pos = torch.full((B,), P + S, dtype=torch.int32, device=tokens.device)
    return logits, cache, next_pos


def decode_step(params, cfg: ModelConfig, token, cache, pos):
    """token (B,) int, pos (B,) int32 → (logits (B, V), cache, pos + 1).
    The cache is updated in place (and returned, as the reference's is).
    Sinusoidal positions come from the reference's 8,192-row table at
    clip(pos); a cache with `xk`/`xv` adds cross-attention over its F
    frames after self-attention."""
    dims, norm = _dims(cfg), _norm(cfg)
    x = L.embed(params["embed"], token[:, None], L.dtype_of(cfg.dtype))  # (B, 1, D)
    x = _add_positions(x, cfg, L.SINUSOID_ROWS,
                       torch.clamp(pos, 0, L.SINUSOID_ROWS - 1).long()[:, None])
    cross = "xk" in cache
    for i, lp in enumerate(params["layers"]):
        a, _, _ = L.attention_decode(lp["attn"], dims, norm(lp["ln1"], x),
                                     cache["k"][i], cache["v"][i], pos, _rope(cfg))
        x = x + a
        if cross:
            x = x + L.cross_attention_decode(lp["xattn"], dims, norm(lp["lnx"], x),
                                             cache["xk"][i], cache["xv"][i])
        x = x + _ffn(lp, cfg, norm(lp["ln2"], x))[0]
    x = norm(params["final_norm"], x)
    return L.unembed(_head(params), x)[:, 0], cache, pos + 1
