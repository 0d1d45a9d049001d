"""Port parity of the attention kernels: the plain PyTorch versions of
`flash_attention` and `decode_attention` (`repro_torch.kernels.ref`)
against the Pallas kernels themselves (`repro.kernels.ops`, interpret mode
on the CPU) and against their oracles (`repro.kernels.ref`); the wrappers'
CPU dispatch; and, on a CUDA card only, the CUDA kernels against their
plain versions.

Tolerances. fp32: atol = rtol = 1e-5 — the same function, summed in
another order. bf16: atol 2e-2, rtol 0 — inputs are N(0, 1) rounded to
bf16, outputs are O(1) and bf16 (one ulp is 2^-8 of the value); the port
takes the scores in fp32 as the TPU kernel does, while the reference's
oracle rounds them to bf16 first, and p is rounded to bf16 before the PV
product at different points (normalised in the oracles, per block in the
kernels).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, np_rng
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import ops, ref

TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=0)}
HD = 64


def _pair(a, dtype: str):
    """The same numpy array as a jax and a torch array of `dtype`."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.as_tensor(np.asarray(a, np.float32)).to(getattr(torch, dtype))
    return j, t


def _close(want, got, dtype: str, what: str):
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               as_np(got.float()), err_msg=what, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 7])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 16),
                                           (False, 16)])
def test_flash_attention_plain_matches_pallas_and_oracle(dtype, G, causal, window):
    rs = np_rng(100 + G)
    B, KV, S = 2, 2, 64
    qj, qt = _pair(rs.standard_normal((B, KV, G, S, HD)), dtype)
    kj, kt = _pair(rs.standard_normal((B, KV, S, HD)), dtype)
    vj, vt = _pair(rs.standard_normal((B, KV, S, HD)), dtype)
    got = ref.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    # 32-wide blocks: the Pallas kernel sweeps two k blocks per q block
    pallas = rops.flash_attention(qj, kj, vj, causal=causal, window=window,
                                  block_q=32, block_k=32)
    _close(pallas, got, dtype, "vs pallas")
    _close(rref.mha_ref(qj, kj, vj, causal=causal, window=window), got, dtype,
           "vs oracle")


def test_flash_attention_fully_masked_rows_give_zero():
    """With Sk < Sq, a query whose window lies past the last key sees no
    key at all, and its output is 0."""
    rs = np_rng(5)
    q = torch.as_tensor(rs.standard_normal((1, 1, 2, 8, HD)), dtype=torch.float32)
    k = torch.as_tensor(rs.standard_normal((1, 1, 3, HD)), dtype=torch.float32)
    out = ref.flash_attention(q, k, k, causal=True, window=2)
    assert torch.all(out[..., 4:, :] == 0)
    assert torch.all(out[..., :4, :].abs().sum(-1) > 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 7])
def test_decode_attention_plain_matches_pallas_and_oracle(dtype, G):
    rs = np_rng(200 + G)
    B, KV, T = 4, 2, 96
    qj, qt = _pair(rs.standard_normal((B, KV, G, HD)), dtype)
    kj, kt = _pair(rs.standard_normal((B, KV, T, HD)), dtype)
    vj, vt = _pair(rs.standard_normal((B, KV, T, HD)), dtype)
    lengths = np.array([0, 1, 50, T], np.int32)        # one empty row
    got = ref.decode_attention(qt, kt, vt, torch.as_tensor(lengths))
    assert got.dtype == qt.dtype and got.shape == qt.shape
    assert torch.all(got[0] == 0)
    # block_t 32 divides T: three sequential blocks on the Pallas side
    pallas = rops.decode_attention(qj, kj, vj, jnp.asarray(lengths), block_t=32)
    _close(pallas, got, dtype, "vs pallas")
    _close(rref.decode_attention_ref(qj, kj, vj, jnp.asarray(lengths)), got,
           dtype, "vs oracle")


def test_cpu_wrappers_are_the_plain_versions():
    """On CPU tensors `ops` returns exactly `ref`'s result and counts no
    launch."""
    rs = np_rng(9)
    ops.reset_launch_counts()
    q = torch.as_tensor(rs.standard_normal((1, 2, 3, 20, HD))).to(torch.bfloat16)
    k = torch.as_tensor(rs.standard_normal((1, 2, 20, HD))).to(torch.bfloat16)
    for causal, window in ((True, 0), (False, 5)):
        assert torch.equal(ops.flash_attention(q, k, k, causal=causal, window=window),
                           ref.flash_attention(q, k, k, causal=causal, window=window))
    lengths = torch.tensor([7], dtype=torch.int32)
    assert torch.equal(ops.decode_attention(q[:, :, :, 0], k, k, lengths),
                       ref.decode_attention(q[:, :, :, 0], k, k, lengths))
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)


def test_wrappers_refuse_non_cuda_devices():
    """Off the CPU a wrapper launches its kernel or raises: a tensor on
    another device is refused before any build."""
    q = torch.zeros((1, 2, 7, 4, HD), device="meta")
    k = torch.zeros((1, 2, 4, HD), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(q[:, :, :, 0], k, k,
                             torch.zeros((1,), dtype=torch.int32, device="meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_attention_kernels_match_plain_versions(cuda_device, dtype):
    """Tolerances: fp32 atol 1e-4 (summation order; exp on the card);
    bf16 atol 2e-2 plus about two bf16 ulps of the value (rtol 2^-7): the
    card's outputs reach ~4, and in [2, 4) one ulp is 2^-6."""
    atol, rtol = (1e-4, 0) if dtype == torch.float32 else (2e-2, 2 ** -7)
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(dtype)

    ops.reset_launch_counts()
    # the last three: shorter than a 128-key tile, window 1 one past a
    # 128-row tile, scores spread wide (q x 8)
    for B, S, G, causal, window, qscale in (
            (2, 500, 7, True, 0, 1), (1, 130, 7, False, 0, 1), (2, 300, 7, True, 128, 1),
            (1, 64, 1, True, 0, 1), (1, 40, 7, True, 0, 1), (2, 129, 7, True, 1, 1),
            (1, 257, 7, False, 0, 8)):
        q = (rnd(B, 2, G, S, HD).float() * qscale).to(dtype)
        k, v = rnd(B, 2, S, HD), rnd(B, 2, S, HD)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    # 60 keys under 200 queries, window 50: queries from 109 on see no key
    # and give exactly 0
    q, k, v = rnd(2, 2, 7, 200, HD), rnd(2, 2, 60, HD), rnd(2, 2, 60, HD)
    got = ops.flash_attention(q, k, v, causal=True, window=50)
    torch.testing.assert_close(got.float(), ref.flash_attention(q, k, v, window=50).float(),
                               atol=atol, rtol=rtol)
    assert torch.all(got[..., 109:, :] == 0) and torch.all(got[..., :109, :].abs().sum(-1) > 0)
    # then lengths at the bf16 decode kernel's edges (a 16-position tile, a
    # 128-position chunk and a cluster of 16 chunks +-1) and a cache that is
    # not a whole number of chunks
    for B, T, lengths in ((8, 584, [512, 530, 575, 560, 513, 544, 571, 520]),
                          (2, 4096, [0, 4000]), (8, 584, [1, 15, 16, 17, 127, 128, 129, 584]),
                          (2, 300, [129, 300]), (4, 4096, [2047, 2048, 2049, 4096])):
        q = rnd(B, 2, 7, HD)
        kc, vc = rnd(B, 2, T, HD), rnd(B, 2, T, HD)
        ln = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
        got = ops.decode_attention(q, kc, vc, ln)
        want = ref.decode_attention(q, kc, vc, ln)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    # head dim 128 (the MoE models): qwen2-moe's G 1 over 16 KV heads,
    # phi3.5-moe's G 4 over 8, causal, windowed and not; decode lengths at
    # the kernel's edges and over two clusters of 8 chunks
    for B, KV, G, S, causal, window in ((2, 16, 1, 300, True, 0), (1, 8, 4, 333, False, 0),
                                        (2, 8, 4, 257, True, 100)):
        q = rnd(B, KV, G, S, 128)
        k, v = rnd(B, KV, S, 128), rnd(B, KV, S, 128)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    for B, KV, G, T, lengths in ((8, 16, 1, 584, [513, 1, 16, 17, 127, 128, 129, 584]),
                                 (3, 8, 4, 1100, [0, 1025, 1100])):
        q = rnd(B, KV, G, 128)
        kc, vc = rnd(B, KV, T, 128), rnd(B, KV, T, 128)
        ln = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
        got = ops.decode_attention(q, kc, vc, ln)
        want = ref.decode_attention(q, kc, vc, ln)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 11
    assert ops.LAUNCHES["decode_attention"] == 7
    # a head dim no kernel was built for raises; it never falls back
    with pytest.raises(ValueError, match="head dim 96"):
        ops.flash_attention(rnd(1, 1, 1, 8, 96), rnd(1, 1, 8, 96), rnd(1, 1, 8, 96))
    with pytest.raises(ValueError, match="head dim 96"):
        ops.decode_attention(rnd(1, 1, 1, 96), rnd(1, 1, 8, 96), rnd(1, 1, 8, 96),
                             torch.ones((1,), dtype=torch.int32, device=cuda_device))
