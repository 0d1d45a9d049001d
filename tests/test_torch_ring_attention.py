"""Port parity of attention at recurrentgemma's shape and of the ring KV
cache: the plain `flash_attention` and `decode_attention`
(`repro_torch.kernels.ref`) at head dim 256 with 16 query heads over one KV
head, against the Pallas kernels (`repro.kernels.ops`, interpret mode on the
CPU) and their oracles; `layers.attention_decode` on a wrapped ring against
`repro.models.layers.attention_decode` with a window; the prefill's slot
placement; and, on a CUDA card only, both kernels at head dim 256 against
their plain versions.

Tolerances. fp32: atol = rtol = 1e-5 (kernels; the same function summed in
another order) or 1e-4 relative to max|reference| (layers: projections and
RoPE as well). bf16: 2e-2 + 2^-7 * max|reference|, rtol 0 — the port takes
scores in fp32 as the TPU kernels do, the oracles round them to bf16
first, and p is rounded to bf16 at different points.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, np_rng
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.models import layers as rL
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as pL

HD, G, KV = 256, 16, 1


def _pair(a, dtype: str):
    """The same numpy array as a jax and a torch array of `dtype`."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.as_tensor(np.asarray(a, np.float32)).to(getattr(torch, dtype))
    return j, t


def _close(want, got, dtype: str, what: str, rel: float = 0.0):
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        tol = (dict(atol=rel * float(np.abs(want).max()), rtol=0) if rel
               else dict(atol=1e-5, rtol=1e-5))
    else:
        tol = dict(atol=2e-2 + 2 ** -7 * float(np.abs(want).max()), rtol=0)
    np.testing.assert_allclose(want, as_np(got.float()), err_msg=what, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24), (False, 24)])
def test_flash_attention_hd256_matches_pallas_and_oracle(dtype, causal, window):
    rs = np_rng(900 + window)
    B, S = 2, 64
    qj, qt = _pair(rs.standard_normal((B, KV, G, S, HD)), dtype)
    kj, kt = _pair(rs.standard_normal((B, KV, S, HD)), dtype)
    vj, vt = _pair(rs.standard_normal((B, KV, S, HD)), dtype)
    got = ref.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    pallas = rops.flash_attention(qj, kj, vj, causal=causal, window=window,
                                  block_q=32, block_k=32)
    _close(pallas, got, dtype, "vs pallas")
    _close(rref.mha_ref(qj, kj, vj, causal=causal, window=window), got, dtype,
           "vs oracle")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_hd256_matches_pallas_and_oracle(dtype):
    rs = np_rng(910)
    B, T = 4, 64
    qj, qt = _pair(rs.standard_normal((B, KV, G, HD)), dtype)
    kj, kt = _pair(rs.standard_normal((B, KV, T, HD)), dtype)
    vj, vt = _pair(rs.standard_normal((B, KV, T, HD)), dtype)
    lengths = np.array([0, 1, 40, T], np.int32)        # one empty row
    got = ref.decode_attention(qt, kt, vt, torch.as_tensor(lengths))
    assert got.dtype == qt.dtype and got.shape == qt.shape
    assert torch.all(got[0] == 0)
    pallas = rops.decode_attention(qj, kj, vj, jnp.asarray(lengths), block_t=32)
    _close(pallas, got, dtype, "vs pallas")
    _close(rref.decode_attention_ref(qj, kj, vj, jnp.asarray(lengths)), got,
           dtype, "vs oracle")


def _attn_params(rs, D: int, H: int, kv: int, hd: int):
    """One attention layer's weights, N(0, 0.1^2), as both packages take
    them (fp32 numpy)."""
    return {n: {"w": (0.1 * rs.standard_normal(shape)).astype(np.float32)}
            for n, shape in (("wq", (D, H * hd)), ("wk", (D, kv * hd)),
                             ("wv", (D, kv * hd)), ("wo", (H * hd, D)))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,cache_len", [(8, 30), (8, 6), (12, 12)])
def test_attention_decode_on_a_wrapped_ring(dtype, window, cache_len):
    """A ring of T = min(cache_len, window) slots, filled by earlier
    positions, decoded at positions pos >= T (the ring has wrapped, slot
    pos % T overwritten): the port's lengths = min(pos + 1, T) against the
    reference's window mask, output and cache. The ring holds positions
    pos - T .. pos - 1 at slot p % T; slots are filled in the reference's
    layout (B, T, KV, hd) and permuted for the port."""
    rs = np_rng(920 + window + cache_len)
    B, D, H, kv, hd, theta = 3, 32, 4, 1, 16, 1e4
    T = pL.ring_len(cache_len, window)
    assert T == min(cache_len, window)
    w = _attn_params(rs, D, H, kv, hd)
    pos = np.array([T, T + 5, 3 * T + 1], np.int32)
    ck = rs.standard_normal((B, T, kv, hd)).astype(np.float32)
    cv = rs.standard_normal((B, T, kv, hd)).astype(np.float32)
    x = rs.standard_normal((B, 1, D)).astype(np.float32)
    dims_r = rL.AttnDims(D, H, kv, hd)
    dims_p = pL.AttnDims(D, H, kv, hd)
    tt = getattr(torch, dtype)
    o_r, ck_r, cv_r = rL.attention_decode(
        {n: {"w": jnp.asarray(p["w"])} for n, p in w.items()}, dims_r,
        jnp.asarray(x).astype(dtype), jnp.asarray(ck).astype(dtype),
        jnp.asarray(cv).astype(dtype), jnp.asarray(pos), theta, window)
    ck_t = torch.as_tensor(ck.transpose(0, 2, 1, 3).copy()).to(tt)
    cv_t = torch.as_tensor(cv.transpose(0, 2, 1, 3).copy()).to(tt)
    o_p, ck_p, cv_p = pL.attention_decode(
        {n: {"w": torch.as_tensor(p["w"]).to(tt)} for n, p in w.items()}, dims_p,
        torch.as_tensor(x).to(tt), ck_t, cv_t, torch.as_tensor(pos), theta)
    _close(o_r, o_p, dtype, "attention_decode", rel=1e-4)
    _close(np.asarray(ck_r, np.float32).transpose(0, 2, 1, 3), ck_p, dtype, "cache k",
           rel=1e-4)
    _close(np.asarray(cv_r, np.float32).transpose(0, 2, 1, 3), cv_p, dtype, "cache v",
           rel=1e-4)


@pytest.mark.parametrize("S,T", [(5, 8), (8, 8), (21, 8), (40, 16)])
def test_write_prefill_places_positions_at_p_mod_t(S, T):
    """Prefill keeps min(S, T) positions: all S at slots 0..S-1 when they
    fit, else the last T with position p at slot p % T (what the
    reference's prefill does, and what decode's slot pos % T continues)."""
    B, kv, hd = 2, 1, 4
    pos = torch.arange(S, dtype=torch.float32)
    k = pos[None, None, :, None].expand(B, kv, S, hd).contiguous()
    ck = torch.full((B, kv, T, hd), -1.0)
    cv = torch.full((B, kv, T, hd), -1.0)
    pL.write_prefill(ck, cv, k, -k)
    for p in range(max(0, S - T), S):
        assert torch.all(ck[:, :, p % T] == p) and torch.all(cv[:, :, p % T] == -p)
    if S < T:
        assert torch.all(ck[:, :, S:] == -1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_attention_hd256_matches_plain_versions(cuda_device, dtype):
    """Head dim 256, 16 query heads per KV head: fp32 atol 1e-4, bf16 atol
    2e-2 plus about two bf16 ulps of the value (rtol 2^-7), as at hd 64."""
    atol, rtol = (1e-4, 0) if dtype == torch.float32 else (2e-2, 2 ** -7)
    gen = torch.Generator(device=cuda_device).manual_seed(1)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(dtype)

    ops.reset_launch_counts()
    # the last four: shorter than a 64-key tile, window 1 one past a 128-row
    # tile, one query head per KV head, scores spread wide (q x 8)
    for B, S, g, causal, window, qscale in (
            (2, 300, G, True, 0, 1), (1, 333, G, True, 64, 1), (1, 130, G, False, 0, 1),
            (2, 200, G, False, 50, 1), (1, 40, G, True, 0, 1), (2, 129, G, True, 1, 1),
            (2, 257, 1, True, 100, 1), (1, 300, G, False, 0, 8)):
        q = (rnd(B, KV, g, S, HD).float() * qscale).to(dtype)
        k, v = rnd(B, KV, S, HD), rnd(B, KV, S, HD)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    # 60 keys under 200 queries, window 50: queries from 109 on see no key
    # and give exactly 0
    q, k, v = rnd(1, KV, G, 200, HD), rnd(1, KV, 60, HD), rnd(1, KV, 60, HD)
    got = ops.flash_attention(q, k, v, causal=True, window=50)
    torch.testing.assert_close(got.float(), ref.flash_attention(q, k, v, window=50).float(),
                               atol=atol, rtol=rtol)
    assert torch.all(got[..., 109:, :] == 0) and torch.all(got[..., :109, :].abs().sum(-1) > 0)
    # lengths at the bf16 decode kernel's edges: a 16-position tile, a
    # 256-position chunk and a cluster of 8 chunks +-1
    for B, T, lengths in ((4, 2048, [2048, 2048, 1, 1500]), (2, 100, [0, 100]),
                          (10, 2048, [1, 16, 17, 63, 64, 65, 255, 256, 257, 2048]),
                          (4, 2600, [2047, 2048, 2049, 2600])):
        q = rnd(B, KV, G, HD)
        kc, vc = rnd(B, KV, T, HD), rnd(B, KV, T, HD)
        ln = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
        got = ops.decode_attention(q, kc, vc, ln)
        want = ref.decode_attention(q, kc, vc, ln)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 9
    assert ops.LAUNCHES["decode_attention"] == 4
