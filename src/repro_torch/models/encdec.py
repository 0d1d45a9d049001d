"""Whisper-style encoder-decoder backbone (arXiv:2212.04356), in torch.

Mirrors `repro.models.encdec`. The conv frontend is a stub there and here:
the inputs are precomputed frame embeddings (B, F, d_model), the output
the two strided conv1d layers would give. The backbone is real:

  * encoder: bidirectional self-attention (`flash_attention`, not causal)
    and the gelu MLP, layernorm, sinusoidal positions added in cfg.dtype;
  * decoder: `models.transformer` with cross-attention to the encoder's
    states and sinusoidal positions (rope_theta <= 0).

The tree is the reference's: {"encoder": {"layers": [...], "final_norm"},
"decoder": the transformer's tree}, one dict a layer (the reference stacks
them).
"""

from __future__ import annotations

from . import layers as L
from . import transformer
from .config import ModelConfig


def init(cfg: ModelConfig, seed: int = 0, device=None, masters: bool = False,
         place=None):
    """Random weights on `device` (the CUDA device by default), the
    transformer's distributions (`transformer.init`, whose docstring says
    how they are drawn and stored): the encoder's layers (ln1, attn, ln2,
    the gelu mlp; layernorm's scale and bias fp32) and final norm from
    `seed`, the decoder (`transformer.init`) from seed + 1."""
    transformer.check_config(cfg)
    make = transformer.LeafMaker(cfg, seed, device, masters, place)
    encoder = {"layers": [make.layer("layernorm", "gelu")
                          for _ in range(cfg.n_encoder_layers)],
               "final_norm": make.norm("layernorm")}
    decoder = transformer.init(cfg, seed=seed + 1, device=make.dev, masters=masters,
                               place=place)
    return {"encoder": encoder, "decoder": decoder}


def _enc_layer(lp, x, cfg: ModelConfig):
    dims = transformer._dims(cfg)
    a, _ = L.attention_apply(lp["attn"], dims, L.layernorm(lp["ln1"], x), None,
                             causal=False)
    x = x + a
    return x + L.mlp_apply(lp["mlp"], L.layernorm(lp["ln2"], x), "gelu")


def encode(params, cfg: ModelConfig, frames):
    """frames (B, F, D), the stub frontend's output → the encoder's states
    (B, F, D) in cfg.dtype."""
    if frames is None:
        raise ValueError(f"{cfg.name}: the encoder needs frames (B, F, d_model), the "
                         f"audio frontend's output")
    x = frames.to(L.dtype_of(cfg.dtype))
    # sinusoidal positions, added in cfg.dtype whatever rope_theta says
    x = x + L.replicated(L.sinusoidal_table(x.shape[1], cfg.d_model, x.device).to(x.dtype), x)
    for lp in params["encoder"]["layers"]:
        x = _enc_layer(lp, x, cfg)
    return L.layernorm(params["encoder"]["final_norm"], x)


def loss_fn(params, cfg: ModelConfig, batch, remat: str = "none"):
    """The decoder's next-token loss given the encoder's states of
    batch["frames"] (the reference's `loss_fn`; `remat` wraps the decoder's
    layers, as the reference's does)."""
    enc_out = encode(params, cfg, batch.get("frames"))
    dec_batch = {k: v for k, v in batch.items() if k != "frames"}
    return transformer.loss_fn(params["decoder"], cfg, dict(dec_batch, enc_out=enc_out),
                               remat=remat)


def prefill(params, cfg: ModelConfig, tokens, cache_len: int, frames=None):
    """Encode `frames` (B, F, D) — required: the reference's serving loop
    passes none and cannot serve this family — then the decoder's prefill,
    which fills the cross cache from the encoder's states."""
    enc_out = encode(params, cfg, frames)
    return transformer.prefill(params["decoder"], cfg, tokens, cache_len, enc_out=enc_out)


def decode_step(params, cfg: ModelConfig, token, cache, pos):
    return transformer.decode_step(params["decoder"], cfg, token, cache, pos)
