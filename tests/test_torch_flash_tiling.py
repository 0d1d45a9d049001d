"""The arithmetic order of the tensor-core `flash_attention` kernel, emulated
on the CPU and held against the plain version (`repro_torch.kernels.ref`)
and the Pallas kernel (`repro.kernels.ops`, interpret mode).

The bf16 kernel (`kernels/csrc/flash_attention.cu`) walks the keys in tiles
of KEY_TILE[hd] (128 at head dim 64 and 128, 64 at 256), keeps a running max per
row over the tiles seen so far, takes p = exp(s - max) against that running
max, rounds p to bf16 for the PV product (fp32 accumulation), sums the
unrounded p in fp32, and divides at the end. The plain version instead
normalises first and rounds the normalised p. The emulation below follows
the kernel's order, so these tests show on the CPU how far that order moves
the output from the yardsticks the card holds the kernel to.

Tolerance: the one `chip_smoke.py` holds the kernel to on the card,
|emulation - yardstick| <= 2e-2 + 2^-7 |yardstick| elementwise: outputs are
O(1) and bf16, and p is rounded to bf16 at different points (about two bf16
ulps of the value, plus an absolute term for values near 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import np_rng
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.kernels import ops as rops
from repro_torch.kernels import ref

ATTN_ATOL_BF16, ATTN_RTOL_BF16 = 2e-2, 2 ** -7
KEY_TILE = {64: 128, 128: 128, 256: 64}
NEG_INF = -1e30


def emulate_kernel(q, k, v, causal: bool, window: int):
    """The kernel's order on bf16 inputs: q (B, KV, G, Sq, hd), k and v
    (B, KV, Sk, hd) → bf16 like q."""
    Sq, hd = q.shape[-2:]
    Sk = k.shape[-2]
    bk = KEY_TILE[hd]
    qf, kf, vf = q.float(), k.float(), v.float()
    rows = q.shape[:-1]
    m = torch.full(rows + (1,), NEG_INF)
    l = torch.zeros(rows + (1,))
    acc = torch.zeros(q.shape)
    qp = torch.arange(Sq)[:, None]
    for kt in range(0, Sk, bk):
        kp = torch.arange(kt, min(kt + bk, Sk))[None, :]
        s = torch.einsum("bkgqh,bksh->bkgqs", qf, kf[:, :, kt:kt + bk]) * hd ** -0.5
        mask = torch.ones((Sq, kp.shape[1]), dtype=torch.bool)
        if causal:
            mask &= qp >= kp
        if window > 0:
            mask &= (qp - kp) < window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(torch.clamp(m - m_new, min=-80.0))
        p = torch.where(s > NEG_INF / 2, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = torch.einsum("bkgqs,bksh->bkgqh", p.to(torch.bfloat16).float(),
                          vf[:, :, kt:kt + bk])
        acc = acc * alpha + pv
        m = m_new
    return (acc / l.clamp(min=1e-30)).to(torch.bfloat16)


def _close(want, got, what: str):
    want = np.asarray(want, np.float32)
    got = np.asarray(got.float(), np.float32)
    assert np.isfinite(got).all(), what
    excess = np.abs(got - want) - (ATTN_ATOL_BF16 + ATTN_RTOL_BF16 * np.abs(want))
    assert excess.max() <= 0, f"{what}: worst excess over the tolerance {excess.max()}"


def _pallas_block(S: int, tile: int) -> int:
    """A block size the Pallas kernel takes (it must divide S): the kernel's
    tile where it does, else the largest divisor of S up to 64."""
    if S % tile == 0:
        return tile
    return max(d for d in range(1, 65) if S % d == 0)


# (head dim, S, q scale): S is ragged (not a multiple of the key tile); q x 8
# spreads the scores wide, so the running max moves by large steps and p is
# rounded against a stale max; head dim 128 is the MoE models' (qwen2-moe
# at G 1, phi3.5-moe at G 4)
SHAPES = [(64, 200, 1), (256, 150, 1), (64, 256, 8), (256, 192, 8), (128, 176, 1),
          (128, 320, 8)]


@pytest.mark.parametrize("G", [1, 7, 16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48), (False, 0)])
@pytest.mark.parametrize("hd,S,qscale", SHAPES)
def test_kernel_order_matches_plain_and_pallas(hd, S, qscale, causal, window, G):
    rs = np_rng(1500 + hd + G + window)
    B, KV = 1, 2 if G < 16 else 1
    q = rs.standard_normal((B, KV, G, S, hd)) * qscale
    k = rs.standard_normal((B, KV, S, hd))
    v = rs.standard_normal((B, KV, S, hd))
    qt, kt, vt = (torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
                  for a in (q, k, v))
    got = emulate_kernel(qt, kt, vt, causal, window)
    assert got.dtype == torch.bfloat16 and got.shape == qt.shape
    _close(ref.flash_attention(qt, kt, vt, causal=causal, window=window).float(), got,
           "vs the plain version")
    qj, kj, vj = (jnp.asarray(a, jnp.float32).astype(jnp.bfloat16) for a in (q, k, v))
    block = _pallas_block(S, KEY_TILE[hd])
    pallas = rops.flash_attention(qj, kj, vj, causal=causal, window=window,
                                  block_q=block, block_k=block)
    _close(np.asarray(pallas, np.float32), got, "vs the Pallas kernel")


def test_kernel_order_is_not_the_plain_order():
    """The emulation rounds p against a running max per tile, the plain
    version after normalising: on several tiles of spread scores the two
    differ (so the tests above compare two orders, not one)."""
    rs = np_rng(1501)
    q, k, v = (torch.as_tensor(rs.standard_normal(shape), dtype=torch.float32)
               .to(torch.bfloat16) for shape in ((1, 1, 4, 300, 64), (1, 1, 300, 64),
                                                 (1, 1, 300, 64)))
    q = (q.float() * 8).to(torch.bfloat16)
    got = emulate_kernel(q, k, v, True, 0)
    assert not torch.equal(got, ref.flash_attention(q, k, v, causal=True))


def test_fully_masked_rows_give_zero():
    """With fewer keys than queries and a window, the queries past the last
    key's window see nothing: the kernel's order gives exactly 0 there, as
    the plain version does."""
    rs = np_rng(1502)
    q = torch.as_tensor(rs.standard_normal((1, 1, 3, 200, 64)), dtype=torch.float32)
    k = torch.as_tensor(rs.standard_normal((1, 1, 60, 64)), dtype=torch.float32)
    q, k = q.to(torch.bfloat16), k.to(torch.bfloat16)
    got = emulate_kernel(q, k, k, True, 50)
    assert torch.all(got[..., 109:, :] == 0)
    assert torch.all(got[..., :109, :].float().abs().sum(-1) > 0)
    assert torch.equal(got[..., 109:, :], ref.flash_attention(q, k, k, window=50)[..., 109:, :])


@pytest.mark.parametrize("Sq,Sk", [(64, 384), (37, 250)])
def test_cross_attention_order_matches_plain_and_pallas(Sq, Sk):
    """Cross-attention's shape (whisper's decoder: Sq text positions against
    Sk encoder frames, not causal, head dim 64, G 1), aligned and ragged:
    the kernel's order against both yardsticks."""
    rs = np_rng(1503 + Sq)
    B, KV, G, hd = 2, 3, 1, 64
    q = rs.standard_normal((B, KV, G, Sq, hd)) * 2
    k = rs.standard_normal((B, KV, Sk, hd))
    v = rs.standard_normal((B, KV, Sk, hd))
    qt, kt, vt = (torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
                  for a in (q, k, v))
    got = emulate_kernel(qt, kt, vt, False, 0)
    assert got.shape == qt.shape
    _close(ref.flash_attention(qt, kt, vt, causal=False).float(), got,
           "vs the plain version")
    qj, kj, vj = (jnp.asarray(a, jnp.float32).astype(jnp.bfloat16) for a in (q, k, v))
    pallas = rops.flash_attention(qj, kj, vj, causal=False, window=0,
                                  block_q=_pallas_block(Sq, KEY_TILE[hd]),
                                  block_k=_pallas_block(Sk, KEY_TILE[hd]))
    _close(np.asarray(pallas, np.float32), got, "vs the Pallas kernel")
