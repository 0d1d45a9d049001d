"""Decoder-only transformer: init, forward, and the serving path (prefill +
single-token decode with a KV cache), in torch.

Mirrors `repro.models.transformer` for the dense family (qwen2, mistral,
granite, yi) and the MoE family (qwen2-moe, phi3.5-moe: a per-layer
`"moe"` FFN, `models.moe`, in place of the dense MLP). The layer stack is
a Python loop over a list of per-layer parameter dicts (the reference
scans stacked leaves); there is no sequence-sharding constraint, a no-op
on one device. Training (`loss_fn`) takes fp32 master weights, which every
use casts to cfg.dtype, and `remat` (`models.remat`) around each layer.
Prefill attention runs the `flash_attention` kernel, decode attention the
`decode_attention` kernel (`layers`). The KV cache is (L, B, KV, T, hd), so
one layer's slice is the decode kernel's (B, KV, T, hd) operand without a
copy; the reference's cache is (L, B, T, KV, hd), the same values permuted.
With a sliding window the cache is a ring of T = min(cache_len, window)
slots, as the reference's is.

What the port does not serve yet raises `NotImplementedError` naming its
ROADMAP item: VLM prefix embeddings, cross-attention decoders, and
activations and positions other than swiglu / RoPE. Norms are rmsnorm or
layernorm, as the reference's `make_norm` picks them. A block pattern
other than attention layers is not this family's: the hybrid family
(`rglru`) serves it.
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
    """Raise for any part of `cfg` this port does not serve."""
    if cfg.dtype not in L.DTYPES:
        raise ValueError(f"dtype {cfg.dtype!r}: the port computes in "
                         f"{sorted(L.DTYPES)}")
    if cfg.cross_attention or cfg.n_encoder_layers:
        raise not_ported("encoder-decoder cross-attention", "15.6")
    if cfg.act != "swiglu" or cfg.rope_theta <= 0:
        raise not_ported(f"act={cfg.act!r}, rope_theta={cfg.rope_theta}", "15.6")
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
    return L.mlp_apply(lp["mlp"], x), {}


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
    each leaf as it is made and returns what the tree holds (`L.init_leaf`)."""
    check_config(cfg)
    dev = resolve_device(device)
    dt = torch.float32 if masters else L.dtype_of(cfg.dtype)
    # the meta device holds shapes only (the abstract tree of
    # `launch.shardings`): nothing is drawn there
    gen = None if dev.type == "meta" else torch.Generator(device=dev)
    if gen is not None:
        gen.manual_seed(seed)

    def normal(*shape):
        return L.init_leaf(place, gen, shape, dt, dev)

    def full(shape, value, dtype=dt):
        return L.init_leaf(place, None, shape, dtype, dev, value)

    def dense_p(d_in, d_out, bias=False):
        p = {"w": normal(d_in, d_out)}
        if bias:
            p["b"] = full((d_out,), 0.0)
        return p

    def norm_p():
        p = {"scale": full((cfg.d_model,), 1.0, torch.float32)}
        if cfg.norm != "rmsnorm":
            p["bias"] = full((cfg.d_model,), 0.0, torch.float32)
        return p

    def ffn_p():
        if cfg.moe is not None:
            return {"moe": moe.moe_init(D, cfg.moe, normal)}
        return {"mlp": {"wg": dense_p(D, cfg.d_ff), "wu": dense_p(D, cfg.d_ff),
                        "wd": dense_p(cfg.d_ff, D)}}

    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    layers = [{
        "ln1": norm_p(),
        "attn": {"wq": dense_p(D, H * hd, cfg.qkv_bias),
                 "wk": dense_p(D, KV * hd, cfg.qkv_bias),
                 "wv": dense_p(D, KV * hd, cfg.qkv_bias),
                 "wo": dense_p(H * hd, D)},
        "ln2": norm_p(),
        **ffn_p(),
    } for _ in range(cfg.n_layers)]
    params = {"embed": {"table": normal(cfg.vocab, D)}, "layers": layers,
              "final_norm": norm_p()}
    if not cfg.tie_embeddings:
        params["head"] = {"table": normal(cfg.vocab, D)}
    return params


# --------------------------------------------------------------------------- #
# Forward (prefill)
# --------------------------------------------------------------------------- #
def _layer(lp, x, cfg: ModelConfig):
    """One block over positions 0..S-1 → (x, (k, v), the FFN's metrics)."""
    norm = _norm(cfg)
    a, kv = L.attention_apply(lp["attn"], _dims(cfg), norm(lp["ln1"], x),
                              cfg.rope_theta, causal=True, window=cfg.window)
    x = x + a
    f, metrics = _ffn(lp, cfg, norm(lp["ln2"], x))
    return x + f, kv, metrics


def _trunk(params, cfg: ModelConfig, tokens, cache=None, remat: str = "none",
           metrics=None):
    """Embedding, the layer stack and the final norm over positions
    0..S-1; writes each layer's keys and values into `cache` (in place)
    when one is given, and appends each layer's metrics to the list
    `metrics` when one is given. `remat` wraps each layer
    (`models.remat`). Returns the final hidden states (B, S, D)."""
    x = L.embed(params["embed"], tokens, L.dtype_of(cfg.dtype))
    layer = remat_lib.wrap(_layer, remat)
    for i, lp in enumerate(params["layers"]):
        x, (k, v), m = layer(lp, x, cfg)
        if cache is not None:
            L.write_prefill(cache["k"][i], cache["v"][i], k, v)
        if metrics is not None:
            metrics.append(m)
    return _norm(cfg)(params["final_norm"], x)


def _head(params):
    return params.get("head", params["embed"])


def forward(params, cfg: ModelConfig, tokens, prefix_embeds=None, enc_out=None):
    """tokens (B, S) → logits (B, S, V)."""
    check_config(cfg)
    if prefix_embeds is not None:
        raise not_ported("VLM prefix embeddings", "15.5")
    if enc_out is not None:
        raise not_ported("encoder output for cross-attention", "15.6")
    return L.unembed(_head(params), _trunk(params, cfg, tokens))


def aggregate(per_layer: list) -> dict:
    """The reference's per-forward metrics from per-layer ones: `moe_aux`
    summed over the layers, every other metric averaged."""
    if not per_layer or not per_layer[0]:
        return {}
    return {k: (torch.sum if k == "moe_aux" else torch.mean)(
        torch.stack([m[k] for m in per_layer])) for k in per_layer[0]}


def loss_fn(params, cfg: ModelConfig, batch, remat: str = "none"):
    """Next-token LM loss → (loss, metrics). batch: {tokens (B, S),
    loss_mask (B, S)?}. The MoE family adds `moe_aux` (summed over the
    layers) to the cross entropy; `metrics` holds the layers' aggregated
    metrics and `xent`, the returned loss (the reference's `loss_fn`)."""
    check_config(cfg)
    if batch.get("prefix_embeds") is not None:
        raise not_ported("VLM prefix embeddings", "15.5")
    if batch.get("enc_out") is not None:
        raise not_ported("encoder output for cross-attention", "15.6")
    tokens = batch["tokens"]
    per_layer = []
    x = _trunk(params, cfg, tokens, remat=remat, metrics=per_layer)
    logits = L.unembed(_head(params), x)
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
def make_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None):
    """KV cache: k/v (L, B, KV, T, hd) zeros in cfg.dtype, T =
    `layers.ring_len(cache_len, cfg.window)`, on `device` (the card when
    None, as `init`)."""
    check_config(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, L.ring_len(cache_len, cfg.window),
             cfg.hd)
    dt = L.dtype_of(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def prefill(params, cfg: ModelConfig, tokens, cache_len: int,
            prefix_embeds=None, enc_out=None):
    """Run the prompt from position 0; return (last-token logits (B, V),
    populated cache, next_pos (B,) int32). Only the last position is
    unembedded (the reference unembeds all and keeps the last). With a
    window the prompt may be longer than the ring: its last T positions
    are kept."""
    check_config(cfg)
    if prefix_embeds is not None:
        raise not_ported("VLM prefix embeddings", "15.5")
    if enc_out is not None:
        raise not_ported("encoder output for cross-attention", "15.6")
    B, S = tokens.shape
    if S > cache_len and not cfg.window:
        raise ValueError(f"prompt length {S} exceeds cache_len {cache_len}")
    cache = make_cache(cfg, B, cache_len, device=tokens.device)
    x = _trunk(params, cfg, tokens, cache)
    logits = L.unembed(_head(params), x[:, -1])
    next_pos = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    return logits, cache, next_pos


def decode_step(params, cfg: ModelConfig, token, cache, pos):
    """token (B,) int, pos (B,) int32 → (logits (B, V), cache, pos + 1).
    The cache is updated in place (and returned, as the reference's is)."""
    dims, norm = _dims(cfg), _norm(cfg)
    x = L.embed(params["embed"], token[:, None], L.dtype_of(cfg.dtype))  # (B, 1, D)
    for i, lp in enumerate(params["layers"]):
        a, _, _ = L.attention_decode(lp["attn"], dims, norm(lp["ln1"], x),
                                     cache["k"][i], cache["v"][i], pos,
                                     cfg.rope_theta)
        x = x + a
        x = x + _ffn(lp, cfg, norm(lp["ln2"], x))[0]
    x = norm(params["final_norm"], x)
    return L.unembed(_head(params), x)[:, 0], cache, pos + 1
