"""The arithmetic order of the tensor-core `decode_attention` kernel,
emulated on the CPU and held against the plain version
(`repro_torch.kernels.ref`) and the Pallas kernel (`repro.kernels.ops`,
interpret mode).

The bf16 kernel (`kernels/csrc/decode_attention.cu`) splits the cache into
chunks of CHUNK[hd] positions (128 at head dim 64 and 128, 256 at 256), one block
each. A block has WARPS[hd] warps (4); warp w of a block owns the
16-position tiles at t0 + (i * WARPS + w) * 16 of its chunk (t0 the chunk's
first position, i = 0, 1, ...) and keeps its own running max over them:
p = exp(s - running max) is rounded to bf16 for the PV product (fp32
accumulation) and summed unrounded into l, and earlier sums are rescaled by
exp(max(m_old - m_new, -80)). The warps' (m, l, acc) merge with weights
exp(max(m_w - m, -80)); then the blocks' the same way within a cluster of
CL = min(MAX_CLUSTER[hd], chunks) consecutive chunks (16 at head dim 64, 8
at 128 and 256), a cluster past the cache padded with empty partials; then the
clusters'; and the output is acc / max(l, 1e-30) rounded to bf16. The
plain version instead normalises
first and rounds the normalised p. The emulation below follows the kernel's
order, so these tests show on the CPU how far that order moves the output
from the yardsticks the card holds the kernel to.

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
from repro_torch.kernels import ops, ref

ATTN_ATOL_BF16, ATTN_RTOL_BF16 = 2e-2, 2 ** -7
CHUNK = {64: 128, 128: 128, 256: 256}
WARPS = {64: 4, 128: 4, 256: 4}
MAX_CLUSTER = {64: 16, 128: 8, 256: 8}
TILE = 16
NEG_INF = -1e30


def cluster_size(hd: int, T: int) -> int:
    return min(MAX_CLUSTER[hd], max(1, -(-T // CHUNK[hd])))


def _merge(m, l, acc, dim: int):
    """Merge partials (m, l, acc) along `dim` of m and l (dim - 1 of acc's
    leading axes is the same axis) with weights exp(max(m_i - m, -80))."""
    mm = m.amax(dim, keepdim=True)
    e = torch.exp(torch.clamp(m - mm, min=-80.0))
    return (mm.squeeze(dim), (e * l).sum(dim),
            (e.unsqueeze(-1) * acc).sum(dim))


def emulate_kernel(q, k_cache, v_cache, lengths):
    """The kernel's order on bf16 inputs: q (B, KV, G, hd), caches (B, KV,
    T, hd), lengths (B,) → bf16 (B, KV, G, hd)."""
    B, KV, G, hd = q.shape
    T = k_cache.shape[2]
    C, NW = CHUNK[hd], WARPS[hd]
    tiles = C // (NW * TILE)
    nc = max(1, -(-T // C))
    pad = nc * C - T
    kf = torch.nn.functional.pad(k_cache.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v_cache.float(), (0, 0, 0, pad))
    s = torch.einsum("bkgh,bkth->bkgt", q.float(), kf) * hd ** -0.5
    valid = torch.arange(nc * C)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    # position c*C + (i*NW + w)*TILE + r → axes (chunk, tile i, warp w, r)
    s = s.reshape(B, KV, G, nc, tiles, NW, TILE)
    vf = vf.reshape(B, KV, nc, tiles, NW, TILE, hd)
    m = torch.full((B, KV, G, nc, NW), NEG_INF)
    l = torch.zeros((B, KV, G, nc, NW))
    acc = torch.zeros((B, KV, G, nc, NW, hd))
    for i in range(tiles):  # each warp's online softmax over its tiles
        si = s[:, :, :, :, i]                                  # (B, KV, G, nc, NW, TILE)
        m_new = torch.maximum(m, si.amax(-1))
        alpha = torch.exp(torch.clamp(m - m_new, min=-80.0))
        p = torch.where(si > NEG_INF / 2, torch.exp(si - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bkgcwr,bkcwrh->bkgcwh", p.to(torch.bfloat16).float(),
                          vf[:, :, :, i])
        acc = acc * alpha[..., None] + pv
        m = m_new
    m, l, acc = _merge(m, l, acc, 4)      # the block's warps
    CL = cluster_size(hd, T)
    ncl = -(-nc // CL)
    extra = ncl * CL - nc                 # blocks of the last cluster past the cache
    m = torch.cat([m, torch.full((B, KV, G, extra), NEG_INF)], 3)
    l = torch.cat([l, torch.zeros((B, KV, G, extra))], 3)
    acc = torch.cat([acc, torch.zeros((B, KV, G, extra, hd))], 3)
    m, l, acc = _merge(m.reshape(B, KV, G, ncl, CL), l.reshape(B, KV, G, ncl, CL),
                       acc.reshape(B, KV, G, ncl, CL, hd), 4)   # a cluster's blocks
    m, l, acc = _merge(m, l, acc, 3)      # the clusters
    return (acc / l.clamp(min=1e-30)[..., None]).to(torch.bfloat16)


def _close(want, got, what: str):
    want = np.asarray(want, np.float32)
    got = np.asarray(got.float(), np.float32)
    assert np.isfinite(got).all(), what
    excess = np.abs(got - want) - (ATTN_ATOL_BF16 + ATTN_RTOL_BF16 * np.abs(want))
    assert excess.max() <= 0, f"{what}: worst excess over the tolerance {excess.max()}"


def _pallas_block(T: int) -> int:
    """A block size the Pallas kernel takes (it must divide T): its default
    512 where it does, else the largest divisor of T up to 512."""
    return max(d for d in range(1, 513) if T % d == 0)


def _lengths(hd: int, T: int) -> list:
    """Lengths at the kernel's edges: 0, 1, a tile +-1, a chunk +-1, a
    chunk and a tile + 1, a cluster + 1 where the cache holds more than one,
    and the whole cache (T not a multiple of a chunk)."""
    c = CHUNK[hd]
    n = [0, 1, TILE - 1, TILE, TILE + 1, c - 1, c, c + 1, c + TILE + 1]
    if T > MAX_CLUSTER[hd] * c:
        n.append(MAX_CLUSTER[hd] * c + 1)
    return [min(x, T) for x in n + [T]]


# (head dim, G, KV, T, q scale): qwen2's shape of group (hd 64, G 7),
# recurrentgemma's (hd 256, G 16 over one KV head) and the MoE models' (hd
# 128: qwen2-moe's G 1 over 16 KV heads, phi3.5-moe's G 4 over 8), T ragged
# against the chunk, in one cluster and (T 2100 at hd 64, 2600 at hd 256,
# 1100 at hd 128) in two; q x 8 spreads the scores wide, so the running max
# moves by large steps and p is rounded against a stale max
CASES = [(64, 7, 2, 300, 1), (64, 7, 2, 300, 8), (256, 16, 1, 600, 1),
         (256, 16, 1, 600, 8), (64, 7, 1, 2100, 1), (256, 16, 1, 2600, 8),
         (128, 1, 16, 584, 1), (128, 4, 8, 1100, 8)]


@pytest.mark.parametrize("hd,G,KV,T,qscale", CASES)
def test_kernel_order_matches_plain_and_pallas(hd, G, KV, T, qscale):
    lengths = _lengths(hd, T)
    B = len(lengths)
    rs = np_rng(1600 + hd + qscale)
    q = rs.standard_normal((B, KV, G, hd)) * qscale
    k = rs.standard_normal((B, KV, T, hd))
    v = rs.standard_normal((B, KV, T, hd))
    qt, kt, vt = (torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
                  for a in (q, k, v))
    ln = torch.tensor(lengths, dtype=torch.int32)
    got = emulate_kernel(qt, kt, vt, ln)
    assert got.dtype == torch.bfloat16 and got.shape == qt.shape
    assert torch.all(got[0] == 0), "a row of length 0 gives 0"
    _close(ref.decode_attention(qt, kt, vt, ln).float(), got, "vs the plain version")
    qj, kj, vj = (jnp.asarray(a, jnp.float32).astype(jnp.bfloat16) for a in (q, k, v))
    pallas = rops.decode_attention(qj, kj, vj, jnp.asarray(lengths, jnp.int32),
                                   block_t=_pallas_block(T))
    _close(np.asarray(pallas, np.float32), got, "vs the Pallas kernel")


def test_kernel_order_is_not_the_plain_order():
    """The emulation rounds p against each warp's running max, the plain
    version after normalising: on several chunks of spread scores the two
    differ (so the test above compares two orders, not one)."""
    rs = np_rng(1601)
    q, k, v = (torch.as_tensor(rs.standard_normal(shape), dtype=torch.float32)
               .to(torch.bfloat16) for shape in ((2, 1, 16, 256), (2, 1, 700, 256),
                                                 (2, 1, 700, 256)))
    q = (q.float() * 8).to(torch.bfloat16)
    ln = torch.tensor([700, 451], dtype=torch.int32)
    assert not torch.equal(emulate_kernel(q, k, v, ln), ref.decode_attention(q, k, v, ln))


def test_positions_past_the_length_change_nothing():
    """Cache rows at or past the length change nothing, bit for bit: the
    same cache cut to its visible rows (padded to the chunk with zeros, as
    the kernel zero-fills rows past the length) gives the same output."""
    rs = np_rng(1602)
    q = torch.as_tensor(rs.standard_normal((1, 2, 7, 64)), dtype=torch.float32).to(torch.bfloat16)
    k = torch.as_tensor(rs.standard_normal((1, 2, 64, 64)), dtype=torch.float32).to(torch.bfloat16)
    v = torch.as_tensor(rs.standard_normal((1, 2, 64, 64)), dtype=torch.float32).to(torch.bfloat16)
    ln = torch.tensor([37], dtype=torch.int32)
    whole = emulate_kernel(q, k, v, ln)
    cut = emulate_kernel(q, k[:, :, :37], v[:, :, :37], ln)
    assert torch.equal(whole, cut)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_built_kernel_has_the_emulated_tiling(cuda_device):
    """The built library's chunk, warps and tile are the emulation's, and
    the bf16 kernel stays within the tolerance of the emulation itself at
    the edge lengths."""
    from repro_torch.kernels import build

    lib = build.load("decode_attention")
    for hd in (64, 128, 256):
        assert lib.decode_attention_chunk(hd) == CHUNK[hd]
        assert lib.decode_attention_warps(hd) == WARPS[hd]
        for T in (1, 100, 584, 2048, 2600, 4096):
            assert lib.decode_attention_cluster(hd, T) == cluster_size(hd, T)
    assert lib.decode_attention_tile() == TILE
    for hd, G, KV, T, qscale in CASES:
        lengths = _lengths(hd, T)
        rs = np_rng(1603 + hd)
        q, k, v = (torch.as_tensor(np.asarray(rs.standard_normal(shape) * sc, np.float32))
                   .to(torch.bfloat16) for shape, sc in
                   (((len(lengths), KV, G, hd), qscale), ((len(lengths), KV, T, hd), 1),
                    ((len(lengths), KV, T, hd), 1)))
        ln = torch.tensor(lengths, dtype=torch.int32)
        want = emulate_kernel(q, k, v, ln)
        got = ops.decode_attention(q.to(cuda_device), k.to(cuda_device),
                                   v.to(cuda_device), ln.to(cuda_device)).cpu()
        _close(want.float(), got, f"hd={hd} q x {qscale}: the card vs the emulation")
        assert torch.all(got[0] == 0)
