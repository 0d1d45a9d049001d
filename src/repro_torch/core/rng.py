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

Keys are host tuples of two Python ints: the per-tick key is derived on the
host, and only the per-worker bit draws run on tensors. uint32 arithmetic is
carried in int64 and masked with ``& 0xFFFFFFFF`` (CUDA tensors have no
general uint32 arithmetic); the same functions work on Python ints.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & MASK32


def _round(x0, x1, rots):
    for r in rots:
        x0 = (x0 + x1) & MASK32
        x1 = _rotl(x1, r) ^ x0
    return x0, x1


def threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pair ``(x0, x1)`` under
    ``key = (k0, k1)``. Counters are Python ints or int64 tensors holding
    uint32 values; returns the output pair in the same form."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        x0, x1 = _round(x0, x1, _ROT[i % 2])
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def PRNGKey(seed: int) -> tuple[int, int]:
    return (0, int(seed) & MASK32)


def fold_in(key, data: int) -> tuple[int, int]:
    return threefry2x32(key, 0, int(data) & MASK32)


def split(key, num: int = 2) -> list[tuple[int, int]]:
    return [threefry2x32(key, 0, i) for i in range(num)]


def random_bits(key, n: int, device) -> torch.Tensor:
    """(n,) int64 tensor of the 32-bit draws ``jax.random.bits(key, (n,))``."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key, torch.zeros_like(i), i)
    return y0 ^ y1


def uniform(key, n: int, device) -> torch.Tensor:
    """(n,) float32 draws of ``jax.random.uniform(key, (n,))`` in [0, 1)."""
    bits = (random_bits(key, n, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def randint(key, n: int, minval: int, maxval: int, device) -> torch.Tensor:
    """(n,) int32 draws of ``jax.random.randint(key, (n,), minval, maxval)``
    for int32 bounds."""
    k1, k2 = split(key)
    hi, lo = random_bits(k1, n, device), random_bits(k2, n, device)
    span = (maxval - minval) & MASK32 if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK32) % span  # uint32 product, wrapping
    off = (((hi % span) * mult) & MASK32) + lo % span
    off = (off & MASK32) % span
    return (minval + off).to(torch.int32)
