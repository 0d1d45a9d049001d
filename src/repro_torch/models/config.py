"""Unified model configuration, the port's own copy of the reference's
(`ModelConfig`, `MoEConfig`, field for field).

One frozen dataclass describes every family (dense / MoE / SSM / hybrid /
enc-dec / VLM); the per-arch instances live in `repro_torch.configs.<id>`
and are resolved by `repro_torch.models.registry`. The port serves every
family: dense, moe (qwen2-moe, phi3.5-moe), ssm (rwkv6), hybrid
(recurrentgemma), vlm (llava) and encdec (whisper).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_ff_expert: int = 0           # per-expert hidden size
    d_ff_shared: int = 0           # per-shared-expert hidden size
    capacity_factor: float = 1.25
    overflow: str = "drop"         # "drop" | "neighbor_steal" (paper technique)
    router_aux_weight: float = 0.001
    ep_pad_to: int = 0             # pad expert count for even EP sharding


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 → d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1_000_000.0
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "swiglu"            # swiglu | gelu
    window: Optional[int] = None   # sliding-window attention (tokens)
    pattern: tuple = ("attn",)     # per-layer block cycle, e.g. ("rec","rec","attn")
    moe: Optional[MoEConfig] = None
    # --- rwkv6 (ssm) ---
    rwkv_head_dim: int = 64
    # --- recurrentgemma (hybrid) ---
    lru_width: int = 0             # 0 → d_model
    conv1d_width: int = 4
    # --- enc-dec / multimodal ---
    n_encoder_layers: int = 0
    cross_attention: bool = False
    frontend: Optional[str] = None # "audio-stub" | "vision-stub"
    n_frontend_tokens: int = 0     # frames (audio) or image patches (vision)
    # --- attention memory/compute shaping (overridable per input shape) ---
    attn_chunk_q: int = 0          # 0 → dense attention
    attn_chunk_k: int = 0
    attn_skip_masked: bool = False # skip fully-masked causal blocks (§Perf)
    # --- distribution shaping (§Perf) ---
    seq_shard_axis: str = ""       # "model" → sequence-parallel residual
                                   # stream (TP all-reduce → RS+AG, ~½ wire)
    # --- numerics ---
    dtype: str = "bfloat16"        # compute dtype (the port stores weights in it)
    # --- notes for DESIGN.md §Arch-applicability ---
    sub_quadratic: bool = False    # supports long_500k decode

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def block_kinds(self) -> list:
        """Per-layer block kinds, cycling `pattern` over n_layers."""
        p = self.pattern
        return [p[i % len(p)] for i in range(self.n_layers)]

    def n_params(self) -> int:
        """Analytic parameter count, the reference's formula (pinned equal to
        it). It does not match what `init` builds: for rwkv6-1.6b it gives
        1,835,108,352 against the tree's 1,584,041,984 (+15.8%: it counts the
        channel mix as 3·D·d_ff where the tree holds 2·D·d_ff + D²); for
        recurrentgemma-9b 9,572,462,592 against 10,444,984,320 (−8.4%: it
        leaves out the gates' wa and wx); for qwen2-moe-a2.7b 14,315,735,040
        against 15,146,403,840 (−5.5%: it counts the 60 real experts, the
        tree holds the 64 of `ep_pad_to`); for phi3.5-moe-42b-a6.6b
        41,872,527,360 against 41,872,793,600 (it leaves out layernorm's
        shifts). Size nothing from it: count the initialised tree."""
        d, hd = self.d_model, self.hd
        qkv = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads + hd * self.n_heads * d
        if self.qkv_bias:
            qkv += hd * (self.n_heads + 2 * self.n_kv_heads)
        mlp_dense = 3 * d * self.d_ff if self.act == "swiglu" else 2 * d * self.d_ff
        norms = 2 * d

        kinds = self.block_kinds()
        total = 0
        for k in kinds:
            if k == "attn":
                total += qkv + norms
                if self.moe is not None:
                    m = self.moe
                    total += d * m.n_experts                      # router
                    total += m.n_experts * 3 * d * m.d_ff_expert  # experts
                    total += m.n_shared * 3 * d * (m.d_ff_shared or m.d_ff_expert)
                else:
                    total += mlp_dense
            elif k == "rec":
                w = self.lru_width or d
                total += 2 * d * w + w * d + self.conv1d_width * w + 3 * w + norms
                total += mlp_dense
            elif k == "rwkv":
                # time-mix: r,k,v,g,o projections + decay lora + channel-mix
                total += 5 * d * d + 2 * d * 64 + norms
                total += 2 * d * self.d_ff + self.d_ff * d
        # embeddings + final norm (+ head unless tied)
        total += self.vocab * d + d
        if not self.tie_embeddings:
            total += self.vocab * d
        # encoder stack (enc-dec): self-attn + mlp per encoder layer, plus
        # decoder cross-attention added per decoder layer
        if self.n_encoder_layers:
            total += self.n_encoder_layers * (qkv + mlp_dense + norms)
        if self.cross_attention:
            total += self.n_layers * (qkv + d)
        return int(total)

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only top-k + shared experts)."""
        if self.moe is None:
            return self.n_params()
        m = self.moe
        d = self.d_model
        per_layer_all = m.n_experts * 3 * d * m.d_ff_expert
        per_layer_active = m.top_k * 3 * d * m.d_ff_expert
        kinds = self.block_kinds()
        n_moe_layers = sum(1 for k in kinds if k == "attn")
        return self.n_params() - n_moe_layers * (per_layer_all - per_layer_active)
