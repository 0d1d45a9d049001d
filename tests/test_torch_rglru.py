"""Port parity of the `rglru` kernel: its plain PyTorch version
(`repro_torch.kernels.ref.rglru`) against the Pallas kernel itself
(`repro.kernels.ops.rglru`, interpret mode on the CPU), against the
reference's oracle (`repro.kernels.ref.rglru_ref`) and against the model's
own scan (`repro.models.rglru.rglru_scan`); the wrapper's CPU dispatch and
its refusals; and, on a CUDA card only, the CUDA kernel against its plain
version.

Tolerances, over each compared array. fp32: |port - reference| <= 1e-4 *
max|reference| — the same recurrence, with `exp`, `log1p` and the update
a*h + g possibly fused or rounded elsewhere. bf16 inputs (outputs and
states are fp32): 2e-2 + 2^-7 * max|reference| — i*x is rounded to bf16
in both, but the frameworks may keep a fused elementwise chain in fp32
where the other rounds, about one bf16 ulp of a gated input, carried
through the recurrence.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, np_rng, other_device
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.models import rglru as rrg
from repro_torch.kernels import ops, ref


def _close(want, got, dtype, what):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    atol = 1e-4 * scale if dtype == "float32" else 2e-2 + 2 ** -7 * scale
    np.testing.assert_allclose(want, as_np(got.float()), atol=atol, rtol=0,
                               err_msg=what)


def _inputs(seed: int, B: int, S: int, W: int, h0: bool):
    """x ~ N(0, 1); r, i uniform in (0, 1), the sigmoid gates' range; lam ~
    N(0, 2^2), so softplus meets large and negative arguments; h0 ~ N(0,
    1) or None. fp32 numpy arrays."""
    rs = np_rng(seed)
    f32 = np.float32
    x = rs.standard_normal((B, S, W)).astype(f32)
    r = rs.uniform(0, 1, (B, S, W)).astype(f32)
    i = rs.uniform(0, 1, (B, S, W)).astype(f32)
    lam = (2 * rs.standard_normal(W)).astype(f32)
    h = rs.standard_normal((B, W)).astype(f32) if h0 else None
    return x, r, i, lam, h


def _port(x, r, i, lam, h0, dtype="float32", fn=ref.rglru):
    t = [torch.as_tensor(a).to(getattr(torch, dtype)) for a in (x, r, i)]
    return fn(*t, torch.as_tensor(lam), None if h0 is None else torch.as_tensor(h0))


@pytest.mark.parametrize("B,S,W,chunk,block_w", [
    (1, 128, 256, 64, 128),
    (2, 256, 512, 128, 512),
    (1, 64, 1024, 64, 256),
])
def test_rglru_plain_matches_pallas(B, S, W, chunk, block_w):
    """The shapes of the reference's own kernel test, zero initial state
    (the Pallas kernel's only case): S = 256 with chunk 128 carries h
    across two sequential chunks in scratch."""
    x, r, i, lam, _ = _inputs(600 + S + W, B, S, W, h0=False)
    out, final = _port(x, r, i, lam, None)
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, S, W)
    assert tuple(final.shape) == (B, W)
    pallas = rops.rglru(*(jnp.asarray(a) for a in (x, r, i, lam)), chunk=chunk,
                        block_w=block_w)
    _close(pallas, out, "float32", "vs pallas")
    _close(np.asarray(pallas)[:, -1], final, "float32", "final state vs pallas")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 9])
@pytest.mark.parametrize("h0", [False, True])
def test_rglru_plain_matches_oracle_and_model_scan(dtype, S, h0):
    """Output and final state from a zero or a given state, S = 1 (one
    decode step) included, in both compute types."""
    x, r, i, lam, h = _inputs(700 + S, 2, S, 48, h0=h0)
    out, final = _port(x, r, i, lam, h, dtype)
    hj = jnp.zeros((2, 48), jnp.float32) if h is None else jnp.asarray(h)
    args = [jnp.asarray(a).astype(dtype) for a in (x, r, i)]
    o_j, s_j = rref.rglru_ref(*args, jnp.asarray(lam), hj)
    _close(o_j, out, dtype, "oracle out")
    _close(s_j, final, dtype, "oracle final state")
    # the model's scan returns h in the inputs' type
    o_m, s_m = rrg.rglru_scan(*args, jnp.asarray(lam), hj)
    _close(o_m, out.to(getattr(torch, dtype)), dtype, "model scan out")
    _close(s_m, final, dtype, "model scan final state")


def test_rglru_state_carries_across_calls():
    """Two calls (S = 5, then 3 from the first's final state) equal one
    call of 8: how decode continues a prefill."""
    x, r, i, lam, h = _inputs(11, 2, 8, 40, h0=True)
    out, final = _port(x, r, i, lam, h)
    o1, f1 = _port(x[:, :5], r[:, :5], i[:, :5], lam, h)
    o2, f2 = _port(x[:, 5:], r[:, 5:], i[:, 5:], lam, as_np(f1))
    torch.testing.assert_close(torch.cat([o1, o2], dim=1), out, atol=0, rtol=0)
    torch.testing.assert_close(f2, final, atol=0, rtol=0)


def test_softplus_is_jax_softplus():
    """The plain version's softplus is `jax.nn.softplus` (logaddexp(x, 0))
    where `F.softplus` is not: above 20 it switches to the identity."""
    import jax

    x = np.array([-80.0, -20.0, -1.5, 0.0, 0.3, 19.5, 20.5, 35.0, 90.0], np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(want, as_np(ref.softplus(torch.as_tensor(x))),
                               rtol=1e-6, atol=0)


def test_cpu_wrapper_is_the_plain_version():
    """On CPU tensors `ops.rglru` returns exactly `ref.rglru`'s result, in
    both compute types, leaves the given state as it was, and counts no
    launch."""
    x, r, i, lam, h = _inputs(12, 2, 6, 32, h0=True)
    keep = h.copy()
    ops.reset_launch_counts()
    for dtype in ("float32", "bfloat16"):
        for state in (None, h):
            got = _port(x, r, i, lam, state, dtype, fn=ops.rglru)
            want = _port(x, r, i, lam, state, dtype)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            assert got[0].dtype == torch.float32
    np.testing.assert_array_equal(h, keep)
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)


@pytest.mark.parametrize("bad", ["device", "dtype", "lam_dtype", "shape"])
def test_wrapper_refuses_bad_inputs(bad):
    """Off the CPU and the meta device (the dry run's) the wrapper launches
    its kernel or raises: a tensor on another device (torch's lazy one),
    an element type the kernel does not take, an fp16
    lam or a mismatched shape are refused before any build."""
    x = torch.zeros((1, 3, 8), device=other_device())
    lam = torch.zeros((8,), device=other_device())
    args = {"device": (x, x, x, lam),
            "dtype": (x.half(), x.half(), x.half(), lam),
            "lam_dtype": (x, x, x, lam.half()),
            "shape": (x, x[:, :2], x, lam)}[bad]
    with pytest.raises(ValueError):
        ops.rglru(*args)
    if bad == "device":
        with pytest.raises(ValueError, match="CUDA"):
            ops.rglru(*args)
    assert ops.LAUNCHES["rglru"] == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_rglru_matches_plain_version(cuda_device):
    """Output and final state within 1e-5 * max|plain| + 1e-6: the same
    operations in the same order, `exp` and `log1p` within an ulp or two
    of torch's; bf16 and fp32 inputs, zero and given states, S = 1, 7 and
    300, S at the sequence kernel's ring edges (a tile of 16 steps, 3 tiles
    in the ring, +-1) with W not a multiple of its 32 channels, and W = 300,
    whose bf16 rows are not whole 16-byte units (the per-channel kernel)."""
    ops.reset_launch_counts()
    n = 0
    for B, S, W, h0 in ((2, 1, 300, True), (2, 7, 4096, False), (1, 300, 64, True),
                        (2, 15, 1000, True), (2, 16, 1000, False), (2, 17, 1000, True),
                        (1, 47, 1000, True), (1, 48, 1000, False), (1, 49, 1000, True),
                        (2, 20, 300, True)):
        for dtype in (torch.float32, torch.bfloat16):
            x, r, i, lam, h = _inputs(800 + S, B, S, W, h0=h0)
            t = [torch.as_tensor(a, device=cuda_device).to(dtype) for a in (x, r, i)]
            lam_t = torch.as_tensor(lam, device=cuda_device)
            h_t = None if h is None else torch.as_tensor(h, device=cuda_device)
            got = ops.rglru(*t, lam_t, h_t)
            want = ref.rglru(*t, lam_t, h_t)
            n += 1
            for g, p in zip(got, want):
                tol = 1e-5 * float(p.abs().max()) + 1e-6
                torch.testing.assert_close(g, p, atol=tol, rtol=0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rglru"] == n
