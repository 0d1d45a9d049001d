"""Port parity: `f32math.log_f32` against the reference's float32 `jnp.log`
(XLA's own polynomial on the CPU, not the C library's `logf`) bit for bit,
and the arrival stream's gaps (`arrivals.gap_ticks`, a log under a round)
against the reference's, candidate for candidate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same, np_rng
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import arrivals as rarr
from repro_torch.core import arrivals as parr
from repro_torch.core.f32math import log_f32

GAPS_Q8 = (8, 256, 1280, 7680, 12345)


def _u_from_hash(h: np.ndarray) -> np.ndarray:
    """u = (h + 1)·2^-32 in float32, as the stream and UTS draw it."""
    return ((h.astype(np.float32) + np.float32(1.0)) * np.float32(2.0**-32))


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_log_f32_equals_jnp_log(jit):
    """~2^20 u of the draws' form (the first 2^19 hashes and 2^19 random
    ones), and float32 values of every binade in [2^-32, 1], at an odd
    length (a vector loop's tail too)."""
    rs = np_rng(5)
    h = np.concatenate([np.arange(1 << 19), rs.integers(0, 2**32, 1 << 19)])
    u = _u_from_hash(h.astype(np.uint64))
    lo, hi = 0x2F800000, 0x3F800000
    x = rs.integers(lo, hi + 1, (1 << 18) + 7).astype(np.uint32).view(np.float32)
    x = np.concatenate([u, x, np.float32([1.0, 2.0**-32, 0.5, 0.70710677])])
    fn = jax.jit(jnp.log) if jit else jnp.log
    want = np.asarray(fn(jnp.asarray(x)))
    got = log_f32(torch.from_numpy(x)).numpy()
    assert_same(_bits(want), _bits(got), "log bits")
    # the C library's log differs in the last bit somewhere here: the test
    # can tell the two apart
    assert (_bits(torch.log(torch.from_numpy(x)).numpy()) != _bits(want)).any()


def _safe_q(b0: float, d_max: int) -> np.ndarray:
    """The UTS ratio q_d of every depth, as the reference computes it."""
    depth = jnp.arange(d_max, dtype=jnp.int32)
    frac = 1.0 - depth.astype(jnp.float32) / jnp.maximum(jnp.float32(d_max), 1.0)
    b_d = jnp.float32(b0) * frac
    return np.asarray(jnp.clip(b_d / (1.0 + b_d), 1e-9, 1.0 - 1e-9))


def test_log_f32_on_uts_ratios():
    """The UTS workloads of the repo (configs, benchmarks, examples, tests):
    log of each depth's q_d, as `_uts_child_count` takes it."""
    shapes = ((4.0, 16), (4.0, 10), (3.5, 10), (3.5, 16), (3.0, 14), (3.0, 9), (3.0, 8),
              (4.0, 6), (2.0, 6), (2.5, 40), (8.0, 12))
    q = np.concatenate([_safe_q(b0, d) for b0, d in shapes])
    assert_same(_bits(jnp.log(jnp.asarray(q))), _bits(log_f32(torch.from_numpy(q))))
    assert_same(_bits(jax.jit(jnp.log)(jnp.asarray(q))),
                _bits(log_f32(torch.from_numpy(q))))


@pytest.mark.parametrize("seed", [0, 3])
def test_gap_ticks_equal(seed):
    """2^20 candidates at each of five mean gaps: the reference's jitted
    `gap_ticks` against the port's, gap for gap (the C library's log gives
    another gap at (12345, seed 0) and (7680, seed 3))."""
    k = np.arange(1 << 20, dtype=np.int32)
    ref = jax.jit(rarr.gap_ticks)
    r_seed = rarr.stream_seed(jnp.int32(seed))
    p_seed = parr.stream_seed(torch.tensor(seed))
    assert int(r_seed) == int(p_seed)
    kt = torch.from_numpy(k)
    for g in GAPS_Q8:
        want = np.asarray(ref(r_seed, jnp.asarray(k), jnp.int32(g)))
        got = parr.gap_ticks(p_seed, kt, torch.tensor(g, dtype=torch.int32)).numpy()
        assert_same(want, got, f"gap_q8 {g}")
