"""Port parity of the optimizers: `repro_torch.optim.adamw` and
`grad_compress` against `repro.optim` on the CPU, from the same numpy
inputs.

Tolerances. AdamW in fp32: the same elementwise ops in the same order, but
`cos`, `pow` and the norm's sums come from another library: rtol 2e-6 on
the learning rate, norms and moments, atol 1e-7 + rtol 2e-6 on the updated
parameters (one step moves them by ~lr). `quantize` is bit-equal (int8 and
the error; `round` half to even on both sides). `compressed_psum` on a
4-shard `LocalMesh` against the reference under `jax.vmap(...,
axis_name="dp")`: `allgather_int8` within 2 fp32 ulps of the result (a
4-term sum in another order); `psum_bf16` within half a bf16 ulp of each of
the 3 partial sums the reference rounds one by one (XLA adds the shards in
bf16 in turn, the port's sum rounds once), i.e. 3 · 2^-9 · Σ|shard| / 4;
the errors bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.optim import adamw as radam
from repro.optim import grad_compress as rgc
from repro_torch.core import mesh_comm
from repro_torch.optim import adamw as padam
from repro_torch.optim import grad_compress as pgc

torch.set_num_threads(1)
RTOL = 2e-6

CFGS = [padam.AdamWConfig(),
        padam.AdamWConfig(lr_peak=1e-3, warmup_steps=3, total_steps=20, clip_norm=0.5,
                          weight_decay=0.0),
        padam.AdamWConfig(warmup_steps=0, total_steps=1, lr_min_ratio=0.0)]


def _ref_cfg(c):
    import dataclasses
    return radam.AdamWConfig(**dataclasses.asdict(c))


def _tree(rng, scale=1.0):
    """A parameter-shaped tree of numpy arrays: dicts and a list of layers,
    as the port's parameter trees hold them."""
    return {"embed": {"table": rng.standard_normal((11, 6)).astype(np.float32) * scale},
            "layers": [{"w": rng.standard_normal((6, 5)).astype(np.float32) * scale,
                        "b": rng.standard_normal((5,)).astype(np.float32) * scale}
                       for _ in range(3)],
            "final": {"scale": rng.standard_normal((6,)).astype(np.float32) * scale}}


def _torch(tree):
    return padam.tree_map(lambda a: torch.tensor(a), tree)


def _leaves(tree) -> list:
    """A port tree's leaves as numpy arrays in the reference's order (dict
    keys sorted)."""
    return jax.tree.leaves(padam.tree_map(lambda t: t.numpy(), tree))


def _close(want, got, what, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("cfg", CFGS)
def test_cosine_lr(cfg):
    rc = _ref_cfg(cfg)
    steps = np.array([0, 1, 2, 3, 5, 50, 99, 100, 101, 5000, 9999, 10_000, 20_000],
                     np.int32)
    want = radam.cosine_lr(rc, jnp.asarray(steps))
    got = padam.cosine_lr(cfg, torch.tensor(steps))
    assert got.dtype == torch.float32
    _close(want, got, "cosine_lr")


@pytest.mark.parametrize("scale,max_norm", [(1.0, 1.0), (0.01, 1.0), (3.0, 0.5)])
def test_global_norm_and_clipping(scale, max_norm):
    tree = _tree(np.random.default_rng(1), scale)
    _close(radam.global_norm(tree), padam.global_norm(_torch(tree)), "global_norm")
    rg, rn = radam.clip_by_global_norm(tree, max_norm)
    pg, pn = padam.clip_by_global_norm(_torch(tree), max_norm)
    _close(rn, pn, "norm")
    for a, b in zip(jax.tree.leaves(rg), _leaves(pg)):
        _close(a, b, "clipped")


@pytest.mark.parametrize("cfg", CFGS)
@pytest.mark.parametrize("count", [0, 1, 7, 150])
def test_update_matches_reference(cfg, count):
    rng = np.random.default_rng(count)
    params, grads = _tree(rng), _tree(rng, 0.3)
    m, v = _tree(rng, 0.01), padam.tree_map(np.abs, _tree(rng, 0.001))
    rstate = radam.AdamWState(m=m, v=v, count=jnp.int32(count))
    rp, rs, rmet = radam.update(_ref_cfg(cfg), grads, rstate, params)
    pstate = padam.AdamWState(m=_torch(m), v=_torch(v),
                              count=torch.tensor(count, dtype=torch.int32))
    pp, ps, pmet = padam.update(cfg, _torch(grads), pstate, _torch(params))
    assert ps.count.dtype == torch.int32 and int(ps.count) == count + 1
    _close(rmet["lr"], pmet["lr"], "lr")
    _close(rmet["grad_norm"], pmet["grad_norm"], "grad_norm")
    for name, want, got in (("m", rs.m, ps.m), ("v", rs.v, ps.v), ("params", rp, pp)):
        for a, b in zip(jax.tree.leaves(want), _leaves(got)):
            assert b.dtype == np.float32
            _close(a, b, name, atol=1e-7)


def test_init_and_in_place_update():
    params = _torch(_tree(np.random.default_rng(0)))
    state = padam.init(params)
    assert int(state.count) == 0 and state.count.dtype == torch.int32
    assert all(float(t.abs().max()) == 0 for t in padam.leaves(state.m) + padam.leaves(state.v))
    w = params["layers"][0]["w"]
    grads = padam.tree_map(torch.ones_like, params)
    out, new, _ = padam.update(padam.AdamWConfig(warmup_steps=0), grads, state, params)
    assert out["layers"][0]["w"] is w and new.m is state.m  # written in place
    assert int(new.count) == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_bit_equal(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((7, 33)).astype(np.float32) * 10 ** rng.uniform(-3, 2)
    e = (rng.standard_normal((7, 33)) * 1e-3).astype(np.float32)
    rq, rs, re = rgc.quantize(jnp.asarray(x), jnp.asarray(e))
    pq, ps, pe = pgc.quantize(torch.tensor(x), torch.tensor(e))
    assert pq.dtype == torch.int8
    assert_same(rq, pq, "q")
    assert_same(rs, ps, "scale")
    assert_same(re, pe, "error")
    assert_same(rgc.dequantize(rq, rs), pgc.dequantize(pq, ps), "dequantize")


def test_round_half_to_even():
    """Values that land exactly on .5 after scaling: both round to even."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 63.5, -126.5], np.float32)
    zero = np.zeros_like(x)
    rq, _, _ = rgc.quantize(jnp.asarray(x), jnp.asarray(zero))
    pq, _, _ = pgc.quantize(torch.tensor(x), torch.tensor(zero))
    assert_same(rq, pq, "q")
    assert pq[1:7].tolist() == [0, 2, 2, 0, -2, -2]


@pytest.mark.parametrize("transport", ["psum_bf16", "allgather_int8"])
@pytest.mark.parametrize("seed", [0, 1])
def test_compressed_psum_local_mesh(transport, seed):
    rng = np.random.default_rng(seed)
    n = 4
    grads = {"a": rng.standard_normal((n, 16, 5)).astype(np.float32),
             "layers": [{"w": rng.standard_normal((n, 9)).astype(np.float32) * 3}]}
    errs = padam.tree_map(lambda a: (rng.standard_normal(a.shape) * 0.01).astype(np.float32),
                          grads)

    def f(g, e):
        return rgc.compressed_psum(g, e, "dp", transport)

    rred, rerr = jax.vmap(f, axis_name="dp")(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, errs))
    mesh = mesh_comm.LocalMesh((n,), ("dp",), device="cpu")
    pred, perr = pgc.compressed_psum(_torch(grads), _torch(errs), "dp", transport,
                                     mesh=mesh)
    for g, a, b in zip(jax.tree.leaves(grads), jax.tree.leaves(rred), _leaves(pred)):
        a = np.asarray(a)
        assert b.dtype == np.float32 and b.shape == a.shape
        if transport == "allgather_int8":
            tol = 2 * np.spacing(np.abs(a).max())
        else:
            tol = 3 * 2.0 ** -9 * np.abs(g).sum(0).max() / n
        assert np.abs(a - b).max() <= tol, (transport, np.abs(a - b).max(), tol)
        assert np.abs(b - g.mean(0)).max() < 0.05      # the mean, within int8 error
    for a, b in zip(jax.tree.leaves(rerr), _leaves(perr)):
        assert_same(a, b, "error")


def test_error_feedback_preserves_convergence():
    """SGD on a quadratic with int8-compressed grads and error feedback
    converges (tests/test_optim.py's case, on the port)."""
    target = torch.tensor([0.7, -1.3])
    w, err = torch.zeros(2), torch.zeros(2)
    for _ in range(400):
        q, s, err = pgc.quantize(2 * (w - target), err)
        w = w - 0.05 * pgc.dequantize(q, s)
    np.testing.assert_allclose(w.numpy(), target.numpy(), atol=1e-2)


@pytest.mark.parametrize("transport,axis", [("psum_bf16", 8), ("allgather_int8", 4),
                                            ("allgather_int8", 16)])
def test_compression_ratio(transport, axis):
    assert pgc.compression_ratio(transport, axis) == rgc.compression_ratio(transport, axis)
