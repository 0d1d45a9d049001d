"""Port parity of the `wkv6` kernel: its plain PyTorch version
(`repro_torch.kernels.ref.wkv6`) against the Pallas kernel itself
(`repro.kernels.ops.wkv6`, interpret mode on the CPU), against the
reference's oracle (`repro.kernels.ref.wkv6_ref`) and against the model's
own scan (`repro.models.rwkv6.wkv_scan`); the wrapper's CPU dispatch; and,
on a CUDA card only, the CUDA kernel against its plain version.

Tolerance: fp32, atol = rtol = 1e-5 — the same recurrence, summed in
another order (outputs here are O(1)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, np_rng, other_device
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.models import rwkv6 as rrwkv
from repro_torch.kernels import ops, ref

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(seed: int, B: int, S: int, H: int, hd: int, state: bool):
    """r ~ N(0, 1); k, v ~ N(0, 0.2^2); w = exp(-exp(N(-1.5, 1))) in (0, 1),
    as the model makes its decay; u ~ N(0, 0.1^2); an optional state ~
    N(0, 0.1^2). All fp32 numpy arrays."""
    rs = np_rng(seed)
    f32 = np.float32
    r = rs.standard_normal((B, S, H, hd)).astype(f32)
    k = (0.2 * rs.standard_normal((B, S, H, hd))).astype(f32)
    v = (0.2 * rs.standard_normal((B, S, H, hd))).astype(f32)
    w = np.exp(-np.exp(rs.normal(-1.5, 1.0, (B, S, H, hd)))).astype(f32)
    u = (0.1 * rs.standard_normal((H, hd))).astype(f32)
    s0 = (0.1 * rs.standard_normal((B, H, hd, hd))).astype(f32) if state else None
    return r, k, v, w, u, s0


def _port(r, k, v, w, u, s0, fn=ref.wkv6):
    t = [torch.as_tensor(a) for a in (r, k, v, w, u)]
    return fn(*t, None if s0 is None else torch.as_tensor(s0))


def _close(want, got, what):
    np.testing.assert_allclose(np.asarray(want, np.float32), as_np(got),
                               err_msg=what, **TOL)


@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("S,chunk", [(64, 64), (128, 32)])
def test_wkv6_plain_matches_pallas(hd, S, chunk):
    """Zero initial state, the Pallas kernel's only case; `chunk` divides S,
    so S=128 runs four sequential chunks carrying the state in scratch."""
    r, k, v, w, u, _ = _inputs(300 + hd + S, 2, S, 2, hd, state=False)
    out, final = _port(r, k, v, w, u, None)
    assert out.dtype == torch.float32 and tuple(out.shape) == r.shape
    assert tuple(final.shape) == (2, 2, hd, hd)
    pallas = rops.wkv6(*(jnp.asarray(a) for a in (r, k, v, w, u)), chunk=chunk)
    _close(pallas, out, "vs pallas")


@pytest.mark.parametrize("S", [1, 7, 64])
@pytest.mark.parametrize("state", [False, True])
def test_wkv6_plain_matches_oracle_and_model_scan(S, state):
    """Output and final state, from a zero or a given state, S = 1 (one
    decode step) included."""
    r, k, v, w, u, s0 = _inputs(400 + S, 2, S, 3, 16, state=state)
    out, final = _port(r, k, v, w, u, s0)
    s0j = jnp.zeros((2, 3, 16, 16), jnp.float32) if s0 is None else jnp.asarray(s0)
    args = [jnp.asarray(a) for a in (r, k, v, w, u)]
    for name, fn in (("oracle", rref.wkv6_ref), ("wkv_scan", rrwkv.wkv_scan)):
        o_j, s_j = fn(*args, s0j)
        _close(o_j, out, f"{name} out")
        _close(s_j, final, f"{name} final state")


def test_wkv6_state_carries_across_calls():
    """Two calls, the second from the first's final state, equal one call
    over the whole sequence: how decode continues a prefill."""
    r, k, v, w, u, s0 = _inputs(7, 2, 20, 2, 16, state=True)
    out, final = _port(r, k, v, w, u, s0)
    cut = 13
    o1, f1 = _port(*(a[:, :cut] for a in (r, k, v, w)), u, s0)
    o2, f2 = _port(*(a[:, cut:] for a in (r, k, v, w)), u, as_np(f1))
    torch.testing.assert_close(torch.cat([o1, o2], dim=1), out, **TOL)
    torch.testing.assert_close(f2, final, **TOL)


def test_cpu_wrapper_is_the_plain_version():
    """On CPU tensors `ops.wkv6` returns exactly `ref.wkv6`'s result, leaves
    the given state as it was, and counts no launch."""
    r, k, v, w, u, s0 = _inputs(9, 1, 5, 2, 64, state=True)
    keep = s0.copy()
    ops.reset_launch_counts()
    for state in (None, s0):
        got = _port(r, k, v, w, u, state, fn=ops.wkv6)
        want = _port(r, k, v, w, u, state)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    np.testing.assert_array_equal(s0, keep)
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)


def test_wrapper_refuses_non_cuda_devices():
    """Off the CPU and the meta device (the dry run's) the wrapper launches
    its kernel or raises: a tensor on another device (torch's lazy one)
    is refused before any build."""
    x = torch.zeros((1, 3, 2, 64), device=other_device())
    u = torch.zeros((2, 64), device=other_device())
    with pytest.raises(ValueError, match="CUDA"):
        ops.wkv6(x, x, x, x, u)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_wkv6_matches_plain_version(cuda_device):
    """Output and final state within 1e-4 * max|plain| + 1e-5 (fp32, sums
    in another order over up to 1000 steps), zero and given states."""
    ops.reset_launch_counts()
    for B, S, H, state in ((2, 1, 3, True), (2, 7, 3, False), (1, 300, 4, True)):
        r, k, v, w, u, s0 = _inputs(500 + S, B, S, H, 64, state=state)
        t = [torch.as_tensor(a, device=cuda_device) for a in (r, k, v, w, u)]
        st = None if s0 is None else torch.as_tensor(s0, device=cuda_device)
        got = ops.wkv6(*t, st)
        want = ref.wkv6(*t, st)
        for g, p in zip(got, want):
            tol = 1e-4 * float(p.abs().max()) + 1e-5
            torch.testing.assert_close(g, p, atol=tol, rtol=0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["wkv6"] == 3
