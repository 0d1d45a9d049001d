"""whisper-tiny [audio] — enc-dec; arXiv:2212.04356 (unverified).

4 encoder + 4 decoder layers, d_model 384, 6 heads (kv=6), d_ff 1536,
vocab 51865. Conv frontend is a STUB: input_specs() provides precomputed
frame embeddings (1500 frames, d_model). Absolute sinusoidal positions
(rope_theta = 0 disables RoPE).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab=51865,
    qkv_bias=True,
    rope_theta=0.0,          # sinusoidal absolute positions
    norm="layernorm",
    act="gelu",
    n_encoder_layers=4,
    cross_attention=True,
    frontend="audio-stub",
    n_frontend_tokens=1500,
    sub_quadratic=False,
)
