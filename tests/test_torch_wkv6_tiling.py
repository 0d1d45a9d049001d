"""The arithmetic order of the `wkv6` CUDA kernels, emulated on the CPU in
float32 and held against the plain version (`repro_torch.kernels.ref`), the
Pallas kernel (`repro.kernels.ops`, interpret mode) and the reference
model's scan (`repro.models.rwkv6.wkv_scan`).

The sequence kernel (`kernels/csrc/wkv6.cu`, S > 1) splits each head's
64 x 64 state over four warps of 16 key rows, lane l holding value columns
2l and 2l + 1. It walks each 16-step tile in quads t .. t + 3 with W_j =
w_{t+j}, prefix products P_j = W_0 .. W_{j-1}, suffix products Q_s =
W_{s+1} .. W_3 and d_{j,s} = sum_i r_{t+j} k_{t+s} W_{s+1} .. W_{j-1}:

    o_{t+j} = (r_{t+j} P_j) . S + sum_{s<j} d_{j,s} v_{t+s} + c_{t+j} v_{t+j}
    S      <- P_4 S + sum_s (k_{t+s} Q_s) v_{t+s}^T

and the last one to three steps of a tile that ends inside a quad one at a
time (S <- w S + k v). Each warp sums r.S over its 16 rows in order; the four
warps' sums are added in warp order. The bonus c_t = sum_i r_i u_i k_i and
the d_{j,s} are summed over 32 lanes (rows 2l and 2l + 1 in lane l) in
butterfly order. The step kernel (S = 1) sums r.S over 4 rows a thread,
then two row groups, then 8 warps in order. FMAs are emulated in float64
and rounded once to float32 (a double rounding may differ from the card's
fused rounding in the last bit, far inside the tolerance).

Tolerance: that of `tests/test_torch_wkv6.py`, atol = rtol = 1e-5: the same
recurrence with its sums in another order (outputs here are O(1)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, np_rng
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.kernels import ops as rops
from repro.models import rwkv6 as rrwkv
from repro_torch.kernels import build, ops, ref

TOL = dict(atol=1e-5, rtol=1e-5)
HD = 64        # the kernels' head dim
STEPS = 16     # steps of the sequence kernel's tile
WARPS = 4      # state warps of a head, 16 key rows each
LANE_MASKS = (16, 8, 4, 2, 1)


def fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def lane_tree(x):
    """(..., 32) lane values → (...): pairs of lanes added level by level
    over the masks 16, 8, 4, 2, 1, as the kernels' butterflies add them."""
    for m in LANE_MASKS:
        x = x + x[..., torch.arange(32) ^ m]
    return x[..., 0]


def warp_sums(x, st):
    """r.S of each state warp over its 16 rows, summed in row order:
    x (B, H, 64), st (B, H, 64, 64) → (B, H, WARPS, 64)."""
    B, H = x.shape[:2]
    xw = x.view(B, H, WARPS, HD // WARPS)
    sw = st.view(B, H, WARPS, HD // WARPS, HD)
    acc = torch.zeros((B, H, WARPS, HD))
    for e in range(HD // WARPS):
        acc = fma(xw[..., e, None], sw[..., e, :], acc)
    return acc


def in_warp_order(p):
    o = p[..., 0, :]
    for w in range(1, p.shape[-2]):
        o = o + p[..., w, :]
    return o


def lane_dot(a, b):
    """sum_i a_i b_i as the kernels sum it: a b for row 2l, fmaf(a, b, .)
    for row 2l + 1 in lane l, then the lane tree."""
    ev, od = slice(0, None, 2), slice(1, None, 2)
    return lane_tree(fma(a[..., od], b[..., od], a[..., ev] * b[..., ev]))


def bonus(r, k, u):
    """c = sum_i r_i u_i k_i as the kernels sum it: the lane dot of r u and k."""
    return lane_dot(r * u, k)


def emulate_seq(r, k, v, w, u, st):
    """The sequence kernel's order: fp32 (B, S, H, 64) inputs, u (H, 64),
    state (B, H, 64, 64) → (out, final state)."""
    B, S, H, _ = r.shape
    out = torch.zeros((B, S, H, HD))
    c = bonus(r, k, u[None, None])  # (B, S, H)
    for n0 in range(0, S, STEPS):
        end = min(n0 + STEPS, S)
        t = n0
        while t + 3 < end:
            R, K, V, W = ([x[:, t + j] for j in range(4)] for x in (r, k, v, w))
            # d_{j,s} in the order (1,0), (2,0), (2,1), (3,0), (3,1), (3,2)
            d = [lane_dot(R[1], K[0]), lane_dot(R[2] * W[1], K[0]), lane_dot(R[2], K[1]),
                 lane_dot(R[3] * (W[1] * W[2]), K[0]), lane_dot(R[3] * W[2], K[1]),
                 lane_dot(R[3], K[2])]
            p2 = W[0] * W[1]
            p3 = p2 * W[2]
            q1 = W[2] * W[3]
            rq = [R[0], R[1] * W[0], R[2] * p2, R[3] * p3]
            kq = [K[0] * (W[1] * q1), K[1] * q1, K[2] * W[3], K[3]]
            for j in range(4):
                o = in_warp_order(warp_sums(rq[j], st))
                for i in range(j):
                    o = fma(d[j * (j - 1) // 2 + i][..., None], V[i], o)
                out[:, t + j] = fma(c[:, t + j, :, None], V[j], o)
            x = kq[0][..., :, None] * V[0][..., None, :]
            for j in range(1, 4):
                x = fma(kq[j][..., :, None], V[j][..., None, :], x)
            st = fma((p3 * W[3])[..., :, None], st, x)
            t += 4
        for t in range(t, end):  # the last steps of a tile that ends inside a quad
            p = in_warp_order(warp_sums(r[:, t], st))
            out[:, t] = fma(c[:, t, :, None], v[:, t], p)
            st = fma(w[:, t, :, :, None], st, k[:, t, :, :, None] * v[:, t, :, None, :])
    return out, st


def emulate_step(r, k, v, w, u, st):
    """The step kernel's order (S = 1)."""
    B, _, H, _ = r.shape
    r0, k0, v0, w0 = r[:, 0], k[:, 0], v[:, 0], w[:, 0]
    rg = r0.view(B, H, 16, 4)
    sg = st.view(B, H, 16, 4, HD)
    part = torch.zeros((B, H, 16, HD))
    for e in range(4):  # a thread's 4 rows
        part = fma(rg[..., e, None], sg[..., e, :], part)
    pairs = part[..., 0::2, :] + part[..., 1::2, :]  # the two row groups of a warp
    o = in_warp_order(pairs)
    c = bonus(r0, k0, u[None])
    out = fma(c[..., None], v0, o)[:, None]
    st = fma(w0[..., :, None], st, k0[..., :, None] * v0[..., None, :])
    return out, st


def emulate(r, k, v, w, u, state=None):
    """`ops.wkv6`'s kernels in their arithmetic order, picked by S as the
    launch picks them; inputs of any float type, taken as fp32."""
    r, k, v, w, u = (t.float() for t in (r, k, v, w, u))
    B, S, H, _ = r.shape
    st = torch.zeros((B, H, HD, HD)) if state is None else state.float()
    return (emulate_step if S == 1 else emulate_seq)(r, k, v, w, u, st)


def _inputs(seed: int, B: int, S: int, H: int, state: bool):
    """As `tests/test_torch_wkv6.py` makes them: r ~ N(0, 1); k, v ~
    N(0, 0.2^2); w = exp(-exp(N(-1.5, 1))); u ~ N(0, 0.1^2); a state ~
    N(0, 0.1^2) or none."""
    rs = np_rng(seed)
    f32 = np.float32
    r = rs.standard_normal((B, S, H, HD)).astype(f32)
    k = (0.2 * rs.standard_normal((B, S, H, HD))).astype(f32)
    v = (0.2 * rs.standard_normal((B, S, H, HD))).astype(f32)
    w = np.exp(-np.exp(rs.normal(-1.5, 1.0, (B, S, H, HD)))).astype(f32)
    u = (0.1 * rs.standard_normal((H, HD))).astype(f32)
    s0 = (0.1 * rs.standard_normal((B, H, HD, HD))).astype(f32) if state else None
    return r, k, v, w, u, s0


def _close(want, got, what):
    np.testing.assert_allclose(np.asarray(want, np.float32), as_np(got), err_msg=what, **TOL)


# (B, S, H, given state): whole tiles, a ragged S whose last tile ends
# inside a quad, one past a tile, S below a quad, a single quad, decode
# (S = 1), and the longest case
CASES = [(2, 48, 2, True), (1, 39, 3, False), (1, 17, 2, True), (2, 3, 4, True),
         (1, 4, 2, False), (2, 1, 4, True), (3, 1, 2, False), (1, 256, 2, True),
         (2, 64, 2, False)]


@pytest.mark.parametrize("B,S,H,state", CASES)
def test_emulation_matches_plain_and_references(B, S, H, state):
    """The kernels' order against the plain version, the reference model's
    scan (output and final state) and, from a zero state with S a multiple
    of its chunk, the Pallas kernel."""
    r, k, v, w, u, s0 = _inputs(700 + 7 * S + B + H, B, S, H, state)
    t = [torch.as_tensor(a) for a in (r, k, v, w, u)]
    st = None if s0 is None else torch.as_tensor(s0)
    out, final = emulate(*t, st)
    assert tuple(out.shape) == (B, S, H, HD) and tuple(final.shape) == (B, H, HD, HD)
    want_out, want_final = ref.wkv6(*t, st)
    torch.testing.assert_close(out, want_out, **TOL)
    torch.testing.assert_close(final, want_final, **TOL)
    s0j = jnp.zeros((B, H, HD, HD), jnp.float32) if s0 is None else jnp.asarray(s0)
    o_j, s_j = rrwkv.wkv_scan(*(jnp.asarray(a) for a in (r, k, v, w, u)), s0j)
    _close(o_j, out, "wkv_scan out")
    _close(s_j, final, "wkv_scan final state")
    if s0 is None and S > 1 and S % STEPS == 0:
        pallas = rops.wkv6(*(jnp.asarray(a) for a in (r, k, v, w, u)), chunk=STEPS)
        _close(pallas, out, "pallas")


def test_emulation_of_the_quad_form_is_not_the_sequential_order():
    """The quad form is a different order from the plain version's (so the
    tests above hold the kernels' order, not the plain one's): its outputs
    differ from the sequential recurrence's in the last bits somewhere."""
    r, k, v, w, u, s0 = _inputs(11, 1, 32, 2, True)
    t = [torch.as_tensor(a) for a in (r, k, v, w, u)]
    out, _ = emulate(*t, torch.as_tensor(s0))
    want, _ = ref.wkv6(*t, torch.as_tensor(s0))
    assert not torch.equal(out, want)
    torch.testing.assert_close(out, want, **TOL)


@pytest.mark.parametrize("S,state", [(1, True), (20, True), (20, False)])
def test_bf16_inputs_equal_fp32_after_cast(S, state):
    """On the CPU `ops.wkv6` dispatches bf16 r, k, v to the plain version,
    which casts them to fp32: the result is the fp32 path's on the cast
    values, bit for bit, in fp32, and no kernel launch is counted. (The
    kernel's own conversion is held bit for bit on the card below.)"""
    r, k, v, w, u, s0 = _inputs(900 + S, 2, S, 3, state)
    bf = [torch.as_tensor(a).to(torch.bfloat16) for a in (r, k, v)]
    rest = [torch.as_tensor(a) for a in (w, u)]
    st = None if s0 is None else torch.as_tensor(s0)
    before = ops.LAUNCHES["wkv6"]
    got = ops.wkv6(*bf, *rest, st)
    assert ops.LAUNCHES["wkv6"] == before
    want = ref.wkv6(*(x.float() for x in bf), *rest, st)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].dtype == torch.float32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_wkv6_bf16_matches_plain_version_and_emulation(cuda_device):
    """bf16 r, k, v on the card: output and final state within 1e-4 *
    max|plain| + 1e-5 of the plain version and of the emulated order, at
    both kernels' shapes (S = 1, a ragged S, whole tiles); the kernel's
    in-kernel conversion is exact, so they equal the fp32 kernel on the same
    values cast to fp32 bit for bit; a repeated call equals the first bit
    for bit. The built kernel's tile is the emulation's."""
    assert build.load("wkv6").wkv6_tile() == STEPS
    for B, S, H, state in ((2, 1, 3, True), (2, 39, 3, False), (1, 64, 4, True)):
        r, k, v, w, u, s0 = _inputs(600 + S, B, S, H, state)
        dev = [torch.as_tensor(a, device=cuda_device) for a in (r, k, v)]
        dev = [x.to(torch.bfloat16) for x in dev]
        rest = [torch.as_tensor(a, device=cuda_device) for a in (w, u)]
        st = None if s0 is None else torch.as_tensor(s0, device=cuda_device)
        got = ops.wkv6(*dev, *rest, st)
        again = ops.wkv6(*dev, *rest, st)
        want = ref.wkv6(*dev, *rest, st)
        emu = emulate(*(x.cpu() for x in dev + rest), None if st is None else st.cpu())
        for g, p, e in zip(got, want, emu):
            tol = 1e-4 * float(p.abs().max()) + 1e-5
            torch.testing.assert_close(g, p, atol=tol, rtol=0)
            torch.testing.assert_close(g.cpu(), e, atol=tol, rtol=0)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        cast = ops.wkv6(*(x.float() for x in dev), *rest, st)
        assert all(torch.equal(a, b) for a, b in zip(got, cast))
