"""Decoder-only dense transformer: init, forward, and the serving path
(prefill + single-token decode with a KV cache), in torch.

Mirrors `repro.models.transformer` for the dense family (qwen2, mistral,
granite, yi). The layer stack is a Python loop over a list of per-layer
parameter dicts (the reference scans stacked leaves); there is no remat
and no sequence-sharding constraint, which are no-ops on one device.
Prefill attention runs the `flash_attention` kernel, decode attention the
`decode_attention` kernel (`layers`). The KV cache is (L, B, KV, T, hd), so
one layer's slice is the decode kernel's (B, KV, T, hd) operand without a
copy; the reference's cache is (L, B, T, KV, hd), the same values permuted.
With a sliding window the cache is a ring of T = min(cache_len, window)
slots, as the reference's is.

What the port does not serve yet raises `NotImplementedError` naming its
ROADMAP item: MoE FFNs, VLM prefix embeddings, cross-attention decoders,
and norms, activations and positions other than rmsnorm / swiglu / RoPE.
A block pattern other than attention layers is not this family's: the
hybrid family (`rglru`) serves it.
"""

from __future__ import annotations

import torch

from .. import core
from . import layers as L
from .config import ModelConfig


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, Queue 1 item {item})")


def check_config(cfg: ModelConfig) -> None:
    """Raise for any part of `cfg` this port does not serve."""
    if cfg.dtype not in L.DTYPES:
        raise ValueError(f"dtype {cfg.dtype!r}: the port computes in "
                         f"{sorted(L.DTYPES)}")
    if cfg.moe is not None:
        raise not_ported("MoE FFN", "15.4")
    if cfg.cross_attention or cfg.n_encoder_layers:
        raise not_ported("encoder-decoder cross-attention", "15.6")
    if cfg.norm != "rmsnorm" or cfg.act != "swiglu" or cfg.rope_theta <= 0:
        raise not_ported(f"norm={cfg.norm!r}, act={cfg.act!r}, "
                         f"rope_theta={cfg.rope_theta}", "15.6")
    if any(k != "attn" for k in cfg.block_kinds()):
        raise ValueError(f"block pattern {cfg.pattern} is not the dense "
                         f"family's (the hybrid family serves it)")


def resolve_device(device) -> torch.device:
    return core.resolve_device(device, "repro_torch serves")


def _dims(cfg: ModelConfig) -> L.AttnDims:
    return L.AttnDims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.qkv_bias)


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #
def init(cfg: ModelConfig, seed: int = 0, device=None):
    """Random weights on `device` (default: the CUDA device; raises if there
    is none): normal(0, 0.02) from a seeded `torch.Generator` on that
    device, ones for norm scales, zeros for biases — the reference's
    distributions, not its `jax.random` draws (`convert.lm_params` carries
    the reference's own weights across). Weights are stored in cfg.dtype,
    norm scales in fp32."""
    check_config(cfg)
    dev = resolve_device(device)
    dt = L.dtype_of(cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def normal(*shape):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w * 0.02).to(dt)

    def dense_p(d_in, d_out, bias=False):
        p = {"w": normal(d_in, d_out)}
        if bias:
            p["b"] = torch.zeros(d_out, dtype=dt, device=dev)
        return p

    def norm_p():
        return {"scale": torch.ones(cfg.d_model, dtype=torch.float32, device=dev)}

    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    layers = [{
        "ln1": norm_p(),
        "attn": {"wq": dense_p(D, H * hd, cfg.qkv_bias),
                 "wk": dense_p(D, KV * hd, cfg.qkv_bias),
                 "wv": dense_p(D, KV * hd, cfg.qkv_bias),
                 "wo": dense_p(H * hd, D)},
        "ln2": norm_p(),
        "mlp": {"wg": dense_p(D, cfg.d_ff), "wu": dense_p(D, cfg.d_ff),
                "wd": dense_p(cfg.d_ff, D)},
    } for _ in range(cfg.n_layers)]
    params = {"embed": {"table": normal(cfg.vocab, D)}, "layers": layers,
              "final_norm": norm_p()}
    if not cfg.tie_embeddings:
        params["head"] = {"table": normal(cfg.vocab, D)}
    return params


# --------------------------------------------------------------------------- #
# Forward (prefill)
# --------------------------------------------------------------------------- #
def _trunk(params, cfg: ModelConfig, tokens, cache=None):
    """Embedding, the layer stack and the final norm over positions
    0..S-1; writes each layer's keys and values into `cache` (in place)
    when one is given. Returns the final hidden states (B, S, D)."""
    dims = _dims(cfg)
    x = L.embed(params["embed"], tokens)
    for i, lp in enumerate(params["layers"]):
        a, (k, v) = L.attention_apply(lp["attn"], dims, L.rmsnorm(lp["ln1"], x),
                                      cfg.rope_theta, causal=True,
                                      window=cfg.window)
        x = x + a
        if cache is not None:
            L.write_prefill(cache["k"][i], cache["v"][i], k, v)
        x = x + L.mlp_apply(lp["mlp"], L.rmsnorm(lp["ln2"], x))
    return L.rmsnorm(params["final_norm"], x)


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
    dims = _dims(cfg)
    x = L.embed(params["embed"], token[:, None])             # (B, 1, D)
    for i, lp in enumerate(params["layers"]):
        a, _, _ = L.attention_decode(lp["attn"], dims, L.rmsnorm(lp["ln1"], x),
                                     cache["k"][i], cache["v"][i], pos,
                                     cfg.rope_theta)
        x = x + a
        x = x + L.mlp_apply(lp["mlp"], L.rmsnorm(lp["ln2"], x))
    x = L.rmsnorm(params["final_norm"], x)
    return L.unembed(_head(params), x)[:, 0], cache, pos + 1
