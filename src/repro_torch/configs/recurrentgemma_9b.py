"""recurrentgemma-9b [hybrid] — RG-LRU + local attention 1:2; arXiv:2402.19427.

38L (pattern rec,rec,attn → 12 groups + 2 remainder rec layers),
d_model 4096, 16H MQA (kv=1), d_ff 12288, vocab 256000, window 2048.
O(window) decode state → runs long_500k.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    rope_theta=10_000.0,
    norm="rmsnorm",
    act="swiglu",
    window=2048,
    pattern=("rec", "rec", "attn"),
    lru_width=4096,
    conv1d_width=4,
    sub_quadratic=True,
)
