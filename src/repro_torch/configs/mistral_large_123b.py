"""mistral-large-123b [dense] — hf:mistralai/Mistral-Large-Instruct-2407 (unverified).

88L, d_model 12288, 96 heads (GQA kv=8), d_ff 28672, vocab 32768.
Pure full attention → long_500k is skipped (DESIGN.md §6).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=32768,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    act="swiglu",
    sub_quadratic=False,
)
