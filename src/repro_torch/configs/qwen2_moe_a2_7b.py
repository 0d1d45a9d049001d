"""qwen2-moe-a2.7b [moe] — hf:Qwen/Qwen1.5-MoE-A2.7B (hf-verified).

24L, d_model 2048, 16H (GQA kv=16), vocab 151936.
MoE: 60 routed experts top-4 (d_ff_expert 1408) + 4 shared experts.
Experts padded 60 → 64 for even EP over the 16-way model axis (padded
experts get -inf router logits, `models.moe`; numerics unchanged).
Overflow policy: neighbor_steal (the paper's technique in the dispatch).
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,             # per-expert hidden (routed)
    vocab=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    act="swiglu",
    moe=MoEConfig(
        n_experts=60,
        top_k=4,
        n_shared=4,
        d_ff_expert=1408,
        d_ff_shared=1408,
        capacity_factor=1.25,
        overflow="neighbor_steal",
        ep_pad_to=4,       # 60 + 4 = 64 experts = 4 per model-axis shard
    ),
    sub_quadratic=False,
)
