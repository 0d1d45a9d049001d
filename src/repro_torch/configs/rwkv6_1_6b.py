"""rwkv6-1.6b "Finch" [ssm] — attn-free, data-dependent decay; arXiv:2404.05892.

24L, d_model 2048, d_ff 7168, vocab 65536. Head dim 64 (32 heads).
O(1) decode state → runs long_500k.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,          # d_model / rwkv_head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    norm="layernorm",
    pattern=("rwkv",),
    rwkv_head_dim=64,
    sub_quadratic=True,
)
