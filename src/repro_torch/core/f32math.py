"""float32 transcendentals that give the reference's bits (`log_f32`), or
come within a few ulps of them (`erf_inv_f32`).

The reference computes float32 `jnp.log` through XLA, whose CPU backend
expands it into its own polynomial (Cephes style) with the multiply-adds
contracted into fused multiply-adds; the C library's `logf`, which
`torch.log` calls, rounds differently in about one result of seven by one
ulp. Where a float32 log sits under a floor or a round (UTS child counts,
arrival gaps), one ulp changes a node's children or a request's tick, so
the port reproduces XLA's expansion op by op.

Every step below is its own eager torch op, so no compiler can contract or
reorder it; fma(a, b, c) is done in float64 — the product of two float32
values is exact there — and rounded once to float32 (`_fma`). That float64
sum can round twice (to float64, then to float32); checked against
`jnp.log` over every float32 in [2^-32, 1] (CHANGES.md), no result differs.
"""

from __future__ import annotations

import numpy as np
import torch


def _f32(bits: int) -> float:
    """The float32 with the given bit pattern, as a Python float (exact)."""
    return float(np.array([bits], np.uint32).view(np.float32)[0])


_MIN_NORMAL = _f32(0x00800000)
_SQRT_HALF = _f32(0x3F3504F3)
# the polynomial's coefficients and ln 2's split, as XLA's CPU backend has
# them (float32 bit patterns)
_A1, _A0, _A2 = _f32(0x3D9021BB), _f32(0xBDEBD1B8), _f32(0x3DEF251A)
_B1, _B0, _B2 = _f32(0xBDFE5D4F), _f32(0x3E11E9BF), _f32(0xBE2AAE50)
_D1, _D0, _D2 = _f32(0x3E4CCEAC), _f32(0xBE7FFFFC), _f32(0x3EAAAAAA)
_LN2_LO, _LN2_HI = _f32(0xB95E8083), _f32(0x3F318000)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a·b + c rounded once from float64 (`a`, and `b`, `c` where
    tensors, float32; the product is exact in float64)."""
    def d(v):
        return v.to(torch.float64) if isinstance(v, torch.Tensor) else v
    return (d(a) * d(b) + d(c)).to(torch.float32)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """Natural log of a float32 tensor of positive normal values, bit for
    bit XLA-CPU's float32 `log` (inputs below the smallest normal are taken
    as it). Any device."""
    x = torch.clamp(x.to(torch.float32), min=_MIN_NORMAL)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x807FFFFF) | 0x3F000000).view(torch.float32)   # [0.5, 1)
    lt = m < _SQRT_HALF
    y = (m - 1.0) + torch.where(lt, m, 0.0)
    e = e - lt.to(torch.float32)
    y2 = y * y
    y3 = y2 * y
    a = _fma(y, _A1, _A0)
    b = _fma(y, _B1, _B0)
    d = _fma(y, _D1, _D0)
    a = _fma(a, y, _A2)
    b = _fma(b, y, _B2)
    d = _fma(d, y, _D2)
    p = _fma(a, y3, b)
    p = _fma(p, y3, d)
    q = _fma(p, y3, e * _LN2_LO)     # the product rounded to float32 first
    r = _fma(y2, -0.5, y)
    return _fma(e, _LN2_HI, r + q)


# XLA's float32 erf_inv (Giles' single-precision approximation): Horner
# coefficients, highest first, for w = -log1p(-x²) < 5 (in w - 2.5) and
# w >= 5 (in sqrt(w) - 3)
_ERF_INV_SMALL = tuple(float(np.float32(c)) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
    -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))
_ERF_INV_LARGE = tuple(float(np.float32(c)) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
    -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 erf⁻¹ of x in (-1, 1), XLA's expansion (`jax.lax.erf_inv`):
    w = -log1p(-x²), a degree-8 polynomial in w - 2.5 or sqrt(w) - 3, times
    x; ±1 give ±inf. Horner's steps are fused multiply-adds (`_fma`), as
    XLA's CPU backend contracts them; its log1p is torch's. Within 3 ulps
    of `jax.random.normal`'s draws over 2^20 of them (CHANGES.md). Any
    device."""
    x = x.to(torch.float32)
    w = -torch.log1p(x * -x)
    small = w < 5.0
    t = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(small, _ERF_INV_SMALL[i], _ERF_INV_LARGE[i])

    p = coef(0)
    for i in range(1, len(_ERF_INV_SMALL)):
        p = _fma(p, t, coef(i))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)
