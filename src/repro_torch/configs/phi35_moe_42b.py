"""phi3.5-moe-42b-a6.6b [moe] — hf:microsoft/Phi-3.5-MoE-instruct (hf-verified).

32L, d_model 4096, 32H (GQA kv=8), vocab 32064.
MoE: 16 experts top-2, d_ff_expert 6400 — 16 experts = exactly 1 per
model-axis shard (clean EP).
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab=32064,
    rope_theta=10_000.0,
    norm="layernorm",
    act="swiglu",
    moe=MoEConfig(
        n_experts=16,
        top_k=2,
        n_shared=0,
        d_ff_expert=6400,
        capacity_factor=1.25,
        overflow="neighbor_steal",
        ep_pad_to=0,
    ),
    sub_quadratic=False,
)
