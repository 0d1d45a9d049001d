"""Port parity: `repro_torch.core.rng` against `jax.random`, and the task
hash against `repro.core.tasks`, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same, np_rng
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import tasks as rtasks
from repro_torch.core import rng
from repro_torch.core import tasks as ptasks

SEEDS = (0, 7, 123456)
TICKS = (0, 1, 59, 4095)
WIDTHS = (9, 36, 100, 4096)


def key_tuple(k):
    return tuple(int(x) for x in np.asarray(k))


def test_partitionable_threefry_is_on():
    """The mirror implements the partitionable bit layout only."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_fold_in_split(seed):
    k = jax.random.PRNGKey(seed)
    assert key_tuple(k) == rng.PRNGKey(seed)
    for t in TICKS:
        kf = jax.random.fold_in(k, t)
        assert key_tuple(kf) == rng.fold_in(rng.PRNGKey(seed), t)
        for num in (2, 3):
            assert [key_tuple(s) for s in jax.random.split(kf, num)] \
                == rng.split(rng.fold_in(rng.PRNGKey(seed), t), num)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("W", WIDTHS)
def test_uniform_and_randint_bits(seed, W):
    for t in TICKS:
        kj = jax.random.fold_in(jax.random.PRNGKey(seed), t)
        kt = rng.fold_in(rng.PRNGKey(seed), t)
        u_j = np.asarray(jax.random.uniform(kj, (W,)))
        u_t = rng.uniform(kt, W, "cpu").numpy()
        assert u_t.dtype == np.float32
        assert_same(u_j.view(np.int32), u_t.view(np.int32), "uniform bits")
        hi = max(W - 1, 1)
        assert_same(jax.random.randint(kj, (W,), 0, hi),
                    rng.randint(kt, W, 0, hi, "cpu"), "randint")
        assert_same(jax.random.bits(kj, (W,)).astype(jnp.int64)
                    if jax.config.jax_enable_x64 else
                    np.asarray(jax.random.bits(kj, (W,))).astype(np.int64),
                    rng.random_bits(kt, W, "cpu"), "bits")


def test_randint_odd_spans():
    kj, kt = jax.random.PRNGKey(3), rng.PRNGKey(3)
    for lo, hi in ((0, 1), (0, 3), (5, 17), (-4, 1000), (0, 65537), (7, 7)):
        assert_same(jax.random.randint(kj, (257,), lo, hi),
                    rng.randint(kt, 257, lo, hi, "cpu"), f"[{lo}, {hi})")


def test_hash2_and_child_seed_grid():
    rs = np_rng(11)
    x = np.concatenate([rs.integers(-2**31, 2**31, 20000),
                        [0, 1, -1, 2**31 - 1, -2**31]]).astype(np.int32)
    y = rs.integers(0, 2**31, x.size).astype(np.int32)
    h_ref = np.asarray(rtasks._hash2(jnp.asarray(x), jnp.asarray(y)))
    h_port = ptasks._hash2(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    assert_same(h_ref.astype(np.int64), h_port, "_hash2")
    assert_same(rtasks.child_seed(jnp.asarray(x), jnp.asarray(y)),
                ptasks.child_seed(torch.as_tensor(x), torch.as_tensor(y)),
                "child_seed")
    # the scalar (Python int) path agrees with the host oracle
    for s, i in ((19, 0), (19, 63), (123456789, 7), (2**31 - 1, 2)):
        assert ptasks.child_seed(s, i) == rtasks.host_child_seed(s, i)
