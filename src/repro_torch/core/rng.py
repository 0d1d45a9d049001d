"""Bit-exact mirror of `jax.random`'s threefry generator in torch.

The simulator's randomness is a pure function of ``(seed, tick)``: each tick
draws its victims from ``fold_in(PRNGKey(seed), t)``. The port must draw the
identical victims, so it cannot use `torch.Generator`; it recomputes
Threefry-2x32 exactly as jax does under ``jax_threefry_partitionable=True``
(the default since jax 0.5):

  * ``PRNGKey(seed) = (0, seed)``;
  * ``fold_in(k, d) = threefry2x32(k, (0, d))``;
  * ``split(k, n)[i] = threefry2x32(k, (0, i))``;
  * 32-bit bits of element i are ``x0 ^ x1`` of ``threefry2x32(k, (0, i))``;
  * ``uniform = f32((bits >> 9) | 0x3F800000) - 1``;
  * ``randint`` draws hi and lo bits from the two halves of ``split(k)``.

A key is a pair ``(k0, k1)`` of Python ints or of int64 tensors holding
uint32 values. `fold_in` takes its data as a Python int or as an integer
tensor (a 0-d tick on the device, or a column of F ticks), so the
simulator derives each tick's key on the device with no host round trip.
The draws broadcast a key against the (n,) counters: a key of shape (F, 1)
draws an (F, n) block in one threefry pass, whose row j equals the draw of
the key in row j; leading axes broadcast too, so a grid of G points' keys
of shape (G, F, 1) draws a (G, F, n) block. `PRNGKey` of a tensor of seeds
gives one key per seed. uint32 arithmetic is carried in int64 and masked with
``& 0xFFFFFFFF`` (CUDA tensors have no general uint32 arithmetic); the same
functions work on Python ints.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pair ``(x0, x1)`` under
    ``key = (k0, k1)``. Counters are Python ints or int64 tensors holding
    uint32 values; returns the output pair in the same form. Only the low
    32 bits of x0 matter until the end, so x0 is masked once, at the end
    (it stays below 2^37), and x1 after each rotation."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = x0 + ks[0]
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & MASK32
        x0 = x0 + ks[(i + 1) % 3]
        # the constant joins the key word first: one add on the counters
        x1 = (x1 + (ks[(i + 2) % 3] + (i + 1))) & MASK32
    return x0 & MASK32, x1


def PRNGKey(seed):
    """``jax.random.PRNGKey(seed)`` for a non-negative seed: a pair of ints,
    or for an integer tensor of seeds ``(0, seeds)`` with `seeds` as int64."""
    if isinstance(seed, torch.Tensor):
        return (0, seed.to(torch.int64) & MASK32)
    return (0, int(seed) & MASK32)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``. `data` is a Python int (the key
    comes back as two ints when `key` holds ints) or an integer tensor of
    any shape (the key comes back as two int64 tensors of that shape)."""
    if isinstance(data, torch.Tensor):
        return threefry2x32(key, 0, data.to(torch.int64) & MASK32)
    return threefry2x32(key, 0, int(data) & MASK32)


def split(key, num: int = 2) -> list:
    """``jax.random.split(key, num)``, for int keys and tensor keys alike (a
    tensor key is 0-d or has a trailing axis of 1: its subkeys keep its
    shape, all drawn in one threefry pass)."""
    k0 = key[0]
    if not isinstance(k0, torch.Tensor):
        return [threefry2x32(key, 0, i) for i in range(num)]
    i = torch.arange(num, dtype=torch.int64, device=k0.device)
    y0, y1 = threefry2x32(key, torch.zeros_like(i), i)
    if k0.dim() == 0:
        return [(y0[j], y1[j]) for j in range(num)]
    return [(y0[..., j:j + 1], y1[..., j:j + 1]) for j in range(num)]


def random_bits(key, n: int, device) -> torch.Tensor:
    """int64 tensor of the 32-bit draws ``jax.random.bits(key, (n,))``:
    shape (n,) for a key of ints or of 0-d tensors, (F, n) for a key of
    (F, 1) tensors (row j drawn with the key in row j)."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key, torch.zeros_like(i), i)
    return y0 ^ y1


def uniform(key, n: int, device) -> torch.Tensor:
    """float32 draws of ``jax.random.uniform(key, (n,))`` in [0, 1), shaped
    as `random_bits`'s."""
    bits = (random_bits(key, n, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def normal(key, n: int, device) -> torch.Tensor:
    """float32 draws of ``jax.random.normal(key, (n,))``: a uniform on
    (nextafter(-1, 0), 1) — `uniform`'s draw times 2 plus the lower bound,
    clamped to it — then sqrt(2)·erf⁻¹ (`f32math.erf_inv_f32`, within 3
    ulps of XLA's), shaped as `random_bits`'s. A draw of shape (a, b, ...)
    is this one's n = a·b·... values in row-major order."""
    from .f32math import erf_inv_f32

    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    # maxval - minval is 2 - 2^-24, 2.0 in float32
    u = torch.clamp(uniform(key, n, device) * 2.0 + lo, min=lo)
    return erf_inv_f32(u) * float(np.float32(np.sqrt(2.0)))


def randint(key, n: int, minval: int, maxval: int, device) -> torch.Tensor:
    """int32 draws of ``jax.random.randint(key, (n,), minval, maxval)`` for
    int32 bounds, shaped as `random_bits`'s."""
    k1, k2 = split(key)
    if isinstance(k1[0], torch.Tensor):  # both halves in one pass
        pair = tuple(torch.stack([a, b])[..., None] if a.dim() == 0
                     else torch.stack([a, b]) for a, b in zip(k1, k2))
        hi, lo = random_bits(pair, n, device).unbind(0)
    else:
        hi, lo = random_bits(k1, n, device), random_bits(k2, n, device)
    span = (maxval - minval) & MASK32 if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK32) % span  # uint32 product, wrapping
    off = (((hi % span) * mult) & MASK32) + lo % span
    off = (off & MASK32) % span
    return (minval + off).to(torch.int32)
