"""Architecture registry: `--arch <id>` → (config, model functions), for
the architectures the port serves.

Mirrors `repro.models.registry`: `ModelFns` (init, loss_fn, prefill,
decode_step, in the reference's field order), `get_config`, `get_fns`,
`list_archs` and `reduced` (copied verbatim, so tests shrink a config
exactly as the reference does). Every architecture and family of the
reference is served: `_ARCH_ITEMS` and `_FAMILY_ITEMS`, which map one the
port does not serve to its ROADMAP item, are empty.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, NamedTuple

from . import encdec, rglru, rwkv6, transformer
from .config import ModelConfig


class ModelFns(NamedTuple):
    init: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable


_FAMILY_FNS = {
    "dense": ModelFns(transformer.init, transformer.loss_fn,
                      transformer.prefill, transformer.decode_step),
    "moe": ModelFns(transformer.init, transformer.loss_fn,
                    transformer.prefill, transformer.decode_step),
    "ssm": ModelFns(rwkv6.init, rwkv6.loss_fn, rwkv6.prefill, rwkv6.decode_step),
    "vlm": ModelFns(transformer.init, transformer.loss_fn,
                    transformer.prefill, transformer.decode_step),
    "hybrid": ModelFns(rglru.init, rglru.loss_fn, rglru.prefill,
                       rglru.decode_step),
    "encdec": ModelFns(encdec.init, encdec.loss_fn, encdec.prefill,
                       encdec.decode_step),
}
# families of the reference not served yet → ROADMAP Queue 1 item
_FAMILY_ITEMS: dict[str, str] = {}

ARCH_MODULES = {
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe_42b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "yi-34b": "repro_torch.configs.yi_34b",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
}
# the reference's architectures not served yet → ROADMAP Queue 1 item
_ARCH_ITEMS: dict[str, str] = {}


def list_archs() -> list[str]:
    return list(ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch in _ARCH_ITEMS:
        raise transformer.not_ported(f"architecture {arch!r}", _ARCH_ITEMS[arch])
    mod = importlib.import_module(ARCH_MODULES[arch])
    return mod.CONFIG


def get_fns(cfg: ModelConfig) -> ModelFns:
    if cfg.family in _FAMILY_ITEMS:
        raise transformer.not_ported(f"model family {cfg.family!r}",
                                     _FAMILY_ITEMS[cfg.family])
    return _FAMILY_FNS[cfg.family]


def reduced(cfg: ModelConfig, n_layers: int = 2, d_model: int = 64,
            vocab: int = 128, seq_hint: int = 64) -> ModelConfig:
    """Shrink a config to smoke-test size, preserving family structure."""
    ratio = max(cfg.n_heads // cfg.n_kv_heads, 1)
    n_kv = 2 if cfg.n_kv_heads > 1 else 1
    n_heads = n_kv * min(ratio, 4)
    head_dim = max(d_model // n_heads, 8)
    updates = dict(
        n_layers=max(n_layers, len(cfg.pattern)),
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=d_model * 2,
        vocab=vocab,
        window=min(cfg.window, seq_hint // 2) if cfg.window else None,
        lru_width=d_model if cfg.lru_width else 0,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        n_frontend_tokens=min(cfg.n_frontend_tokens, 16) if cfg.n_frontend_tokens else 0,
        rwkv_head_dim=16,
    )
    if cfg.moe is not None:
        updates["moe"] = dataclasses.replace(
            cfg.moe, n_experts=8, top_k=min(cfg.moe.top_k, 2),
            n_shared=min(cfg.moe.n_shared, 1), d_ff_expert=d_model,
            d_ff_shared=d_model if cfg.moe.d_ff_shared else 0, ep_pad_to=0)
    return dataclasses.replace(cfg, **updates)
