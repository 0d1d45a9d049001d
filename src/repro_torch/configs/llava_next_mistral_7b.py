"""llava-next-mistral-7b [vlm] — hf:llava-hf/llava-v1.6-mistral-7b-hf (unverified).

Mistral-7B backbone: 32L, d_model 4096, 32H (GQA kv=8), d_ff 14336, vocab 32000.
Anyres tiling is a STUB: input_specs() provides pre-projected patch embeddings
(n_frontend_tokens, d_model) prepended to the text sequence.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    act="swiglu",
    frontend="vision-stub",
    n_frontend_tokens=576,   # one 24x24 CLIP grid (anyres tiles stubbed)
    sub_quadratic=False,
)
