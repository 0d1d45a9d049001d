"""Assigned input shapes × per-arch `input_specs()`, as tensors on the meta
device (shape and dtype only — never allocates). The port of
`repro.launch.shapes`.

  train_4k     seq 4096,    global_batch 256   → train_step
  prefill_32k  seq 32768,   global_batch 32    → prefill (serve)
  decode_32k   cache 32768, global_batch 128   → serve_step (1 new token)
  long_500k    cache 524288, global_batch 1    → serve_step, sub-quadratic
                                                 archs only

Token ids are int32 here, as the reference's; the port's entry points take
int64 as well. Decode caches are in the port's layouts: an attention
cache's k and v are (L, B, KV, T, hd), the reference's (L, B, T, KV, hd)
with T and KV swapped (`models.transformer`); the recurrent states are the
reference's shapes.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import registry
from ..models.config import ModelConfig
from ..models.layers import dtype_of


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCase("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCase("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCase("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCase("long_500k", "decode", 524288, 1),
}

# microbatch counts for train_4k, sized so per-device activations stay sane
TRAIN_MICROBATCHES = {
    "mistral-large-123b": 16,
    "yi-34b": 16,
    "phi3.5-moe-42b-a6.6b": 8,
    "recurrentgemma-9b": 8,
    "granite-3-8b": 8,
    "llava-next-mistral-7b": 8,
    "qwen2-moe-a2.7b": 8,
    "rwkv6-1.6b": 4,
    "qwen2-0.5b": 4,
    "whisper-tiny": 4,
}


def runnable(arch: str, shape: str) -> bool:
    cfg = registry.get_config(arch)
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False  # pure full attention
    return True


def cases(arch: str) -> list:
    return [s for s in SHAPES if runnable(arch, s)]


def shape_overrides(cfg: ModelConfig, shape: ShapeCase) -> ModelConfig:
    """Per-shape config adjustments (attention chunking for long prefill)."""
    upd = {}
    if shape.kind in ("train", "prefill") and shape.seq_len >= 8192:
        upd = dict(attn_chunk_q=1024, attn_chunk_k=1024)
    return dataclasses.replace(cfg, **upd) if upd else cfg


def abstract(shape, dtype) -> torch.Tensor:
    """A tensor of `shape` and `dtype` on the meta device."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def f32(shape):
    return abstract(shape, torch.float32)


def i32(shape):
    return abstract(shape, torch.int32)


def input_specs(cfg: ModelConfig, shape: ShapeCase) -> dict:
    """Abstract model inputs for one (arch × shape) cell.

    train → {"batch": {...}}; prefill → {"tokens", ...};
    decode → {"token", "cache", "pos"}. Modality frontends are stubs:
    frames/prefix_embeds arrive pre-embedded (B, N, d_model).
    """
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        batch = {"tokens": i32((B, S)), "loss_mask": f32((B, S))}
        if cfg.family == "vlm":
            batch["prefix_embeds"] = f32((B, cfg.n_frontend_tokens, cfg.d_model))
        if cfg.family == "encdec":
            batch["frames"] = f32((B, cfg.n_frontend_tokens, cfg.d_model))
        return {"batch": batch}

    if shape.kind == "prefill":
        out = {"tokens": i32((B, S))}
        if cfg.family == "vlm":
            out["prefix_embeds"] = f32((B, cfg.n_frontend_tokens, cfg.d_model))
        if cfg.family == "encdec":
            out["frames"] = f32((B, cfg.n_frontend_tokens, cfg.d_model))
        return out

    # decode: one new token against a seq_len-deep cache
    cache = cache_specs_abstract(cfg, B, S)
    return {"token": i32((B,)), "cache": cache, "pos": i32((B,))}


def cache_specs_abstract(cfg: ModelConfig, B: int, cache_len: int) -> dict:
    """Abstract decode cache matching each family's layout in the port."""
    dt = dtype_of(cfg.dtype)
    if cfg.family in ("dense", "moe", "vlm"):
        T = min(cache_len, cfg.window) if cfg.window else cache_len
        kv = (cfg.n_layers, B, cfg.n_kv_heads, T, cfg.hd)
        return {"k": abstract(kv, dt), "v": abstract(kv, dt)}
    if cfg.family == "encdec":
        kv = (cfg.n_layers, B, cfg.n_kv_heads, cache_len, cfg.hd)
        x = (cfg.n_layers, B, cfg.n_kv_heads, cfg.n_frontend_tokens, cfg.hd)
        return {"k": abstract(kv, dt), "v": abstract(kv, dt),
                "xk": abstract(x, dt), "xv": abstract(x, dt)}
    if cfg.family == "ssm":
        H = cfg.d_model // cfg.rwkv_head_dim
        return {
            "shift_att": abstract((cfg.n_layers, B, cfg.d_model), dt),
            "shift_ffn": abstract((cfg.n_layers, B, cfg.d_model), dt),
            "wkv": f32((cfg.n_layers, B, H, cfg.rwkv_head_dim, cfg.rwkv_head_dim)),
        }
    if cfg.family == "hybrid":
        kinds = cfg.block_kinds()
        n_rec = sum(1 for k in kinds if k == "rec")
        n_att = sum(1 for k in kinds if k == "attn")
        W = cfg.lru_width or cfg.d_model
        T = min(cache_len, cfg.window) if cfg.window else cache_len
        return {
            "h": f32((n_rec, B, W)),
            "conv": abstract((n_rec, B, cfg.conv1d_width - 1, W), dt),
            "k": abstract((n_att, B, cfg.n_kv_heads, T, cfg.hd), dt),
            "v": abstract((n_att, B, cfg.n_kv_heads, T, cfg.hd), dt),
        }
    raise ValueError(cfg.family)
