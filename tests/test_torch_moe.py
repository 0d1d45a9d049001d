"""Port parity of the MoE layer: `repro_torch.models.moe.moe_apply` on the
CPU against `repro.models.moe.moe_apply`, on the same numpy tokens and the
reference's own `moe_init` weights (carried across by `convert.moe_params`),
and the `moe_overflow` benchmark's mirror against the reference's.

Exact: the dropped fractions before and after the steal (an integer count
times fp32(1 / (T·k)) on both sides: XLA compiles the reference's division
so) and the chosen experts (the
fp32 top-k, ties to the lower index). Within a tolerance, fp32: y and
`moe_aux` to rtol 1e-5, atol 1e-6 — the same products summed in another
order (a token's k slots: the reference scatter-adds them, the port sums
them; the shared experts' contraction over (n, f) in one product); y is
O(1e-3) here (weights N(0, 0.02^2)), so atol 1e-6 is ~1e-3 of it, far
above fp32's ~1e-7 relative error and far below a wrong slot's share.

Where parity is likely to break, each named in a test: the sort's
stability (`test_moe_apply_matches_reference`: many slots of one expert,
at capacity factors that drop), top-k ties (`test_top_k_ties_go_to_the_
lower_expert`), the capacity's Python-float formula and its clamp
(`test_capacity_formula_and_decode_c1`), the steal ring modulo E_real with
padded experts (`ep_pad` cases), the pad row of the dispatch (every case
that drops), and the router's types (fp32 logits after a product in the
activations' type).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, np_rng
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from benchmarks import moe_overflow as rbench
from repro.models import layers as rL
from repro.models import moe as rmoe
from repro.models.config import MoEConfig as RMoEConfig
from repro_torch import convert
from repro_torch.benchmarks import moe_overflow as pbench
from repro_torch.models import moe as pmoe
from repro_torch.models.config import MoEConfig as PMoEConfig

TOL = dict(rtol=1e-5, atol=1e-6)
D = 32

torch.set_num_threads(1)


def _configs(**fields):
    return RMoEConfig(**fields), PMoEConfig(**fields)


def _ref_apply(params, x, cfg, capacity=None):
    return jax.jit(rmoe.moe_apply, static_argnums=(2, 3))(params, x, cfg, capacity)


def _ref_experts(params, x, cfg):
    """The reference's chosen experts, by its own router lines."""
    E = cfg.n_experts + cfg.ep_pad_to
    xf = x.reshape(-1, x.shape[-1])
    logits = jnp.einsum("td,de->te", xf, rL.cast(params["router"]["w"], x.dtype))
    logits = logits.astype(jnp.float32)
    if cfg.ep_pad_to:
        logits = jnp.where((jnp.arange(E) >= cfg.n_experts)[None, :], rL.NEG_INF, logits)
    return jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)[1]


def _run_both(fields, shape, seed, capacity=None, router_w=None):
    """(reference (y, metrics, experts), port (y, metrics, experts)) of one
    MoE layer on numpy tokens of `shape`."""
    rc, pc = _configs(**fields)
    rp = rmoe.moe_init(jax.random.PRNGKey(seed), shape[-1], rc)
    if router_w is not None:
        rp["router"]["w"] = jnp.asarray(router_w)
    x = np_rng(seed).standard_normal(shape).astype(np.float32)
    pp = convert.moe_params(jax.tree.map(np.asarray, rp))
    ry, rm = _ref_apply(rp, jnp.asarray(x), rc, capacity)
    py, pm = pmoe.moe_apply(pp, torch.as_tensor(x), pc, capacity)
    _, _, pe = pmoe.route(pp, torch.as_tensor(x).reshape(-1, shape[-1]), pc)
    return ((ry, rm, _ref_experts(rp, jnp.asarray(x), rc)), (py, pm, pe))


def _check(ref, port, what=""):
    (ry, rm, re), (py, pm, pe) = ref, port
    np.testing.assert_array_equal(np.asarray(re), as_np(pe), err_msg=f"{what} experts")
    for key in ("moe_dropped", "moe_dropped_pre_steal"):
        assert float(rm[key]) == float(pm[key]), f"{what} {key}"
    np.testing.assert_allclose(np.asarray(ry), as_np(py), err_msg=f"{what} y", **TOL)
    np.testing.assert_allclose(float(rm["moe_aux"]), float(pm["moe_aux"]),
                               err_msg=f"{what} aux", **TOL)


@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
@pytest.mark.parametrize("n_shared", [0, 2])
@pytest.mark.parametrize("ep_pad", [0, 3])
@pytest.mark.parametrize("policy", ["drop", "neighbor_steal"])
def test_moe_apply_matches_reference(policy, ep_pad, n_shared, cf):
    """Both policies, padded experts or none, shared experts or none, at
    capacity factors that drop many slots (0.5: the stable sort decides
    which of an expert's slots it keeps), a few (1.25) and none (4.0)."""
    fields = dict(n_experts=8, top_k=2, n_shared=n_shared, d_ff_expert=48,
                  d_ff_shared=40 if n_shared else 0, capacity_factor=cf,
                  overflow=policy, ep_pad_to=ep_pad)
    ref, port = _run_both(fields, (2, 24, D), seed=100 + 10 * ep_pad + n_shared)
    _check(ref, port, f"{policy} pad {ep_pad} shared {n_shared} cf {cf}")
    dropped = float(port[1]["moe_dropped"])
    pre = float(port[1]["moe_dropped_pre_steal"])
    if cf == 4.0:
        assert pre == 0.0
    assert (dropped <= pre) if policy == "neighbor_steal" else (dropped == pre)
    if cf == 0.5:
        assert dropped > 0.0


@pytest.mark.parametrize("capacity", [1, 5, 1000])
@pytest.mark.parametrize("policy", ["drop", "neighbor_steal"])
def test_explicit_capacity_matches_reference(policy, capacity):
    """An explicit capacity, below a slot an expert, in between, and above T
    (clamped to T)."""
    fields = dict(n_experts=6, top_k=3, n_shared=1, d_ff_expert=24, overflow=policy,
                  ep_pad_to=2)
    ref, port = _run_both(fields, (3, 10, D), seed=7, capacity=capacity)
    _check(ref, port, f"{policy} capacity {capacity}")


@pytest.mark.parametrize("policy", ["drop", "neighbor_steal"])
def test_capacity_formula_and_decode_c1(policy):
    """The decode case of qwen2-moe: T = batch 8, top-4 of 60 experts padded
    to 64, capacity factor 1.25: C = ceil(8·4/60·1.25) = 1, the
    reference's behaviour, mirrored (two slots of one expert collide)."""
    fields = dict(n_experts=60, top_k=4, n_shared=4, d_ff_expert=16, d_ff_shared=16,
                  capacity_factor=1.25, overflow=policy, ep_pad_to=4)
    rc, pc = _configs(**fields)
    assert pmoe.capacity_of(8, pc) == 1
    assert pmoe.capacity_of(4096, pc) == int(np.ceil(4096 * 4 / 60 * 1.25)) == 342
    assert pmoe.capacity_of(8, pc, capacity=100) == 8
    assert pmoe.capacity_of(8, dataclasses.replace(pc, capacity_factor=1e-6)) == 1
    ref, port = _run_both(fields, (8, 1, D), seed=11)
    _check(ref, port, f"decode {policy}")
    assert float(port[1]["moe_dropped_pre_steal"]) > 0.0


def test_top_k_ties_go_to_the_lower_expert():
    """Router columns repeated, so probabilities tie exactly: the chosen
    experts are the lower indices of each tie, as `jax.lax.top_k` picks,
    and everything downstream agrees."""
    fields = dict(n_experts=8, top_k=3, d_ff_expert=24, overflow="neighbor_steal",
                  capacity_factor=1.0)
    w = np_rng(5).standard_normal((D, 4)).astype(np.float32) * 0.3
    w = np.concatenate([w, w], axis=1)                 # expert e and e + 4 tie
    ref, port = _run_both(fields, (2, 16, D), seed=5, router_w=w)
    _check(ref, port, "ties")
    experts = as_np(port[2])
    assert (experts[:, 1] == experts[:, 0] + 4).all()  # each tie, lower first


def test_replayed_routing_is_the_free_choice():
    """`routing` given the router's own choice gives the same output bit for
    bit; given another choice, the gates are that choice's probabilities."""
    _, pc = _configs(n_experts=8, top_k=2, n_shared=1, d_ff_expert=24,
                     overflow="neighbor_steal", ep_pad_to=2, capacity_factor=1.0)
    rp = rmoe.moe_init(jax.random.PRNGKey(3), D, _configs(**dataclasses.asdict(pc))[0])
    pp = convert.moe_params(jax.tree.map(np.asarray, rp))
    x = torch.as_tensor(np_rng(3).standard_normal((2, 12, D)).astype(np.float32))
    y, m = pmoe.moe_apply(pp, x, pc)
    _, _, ids = pmoe.route(pp, x.reshape(-1, D), pc)
    y2, m2 = pmoe.moe_apply(pp, x, pc, routing=ids)
    assert torch.equal(y, y2) and float(m["moe_dropped"]) == float(m2["moe_dropped"])
    other = (ids + 1) % 8
    probs, gates, got = pmoe.route(pp, x.reshape(-1, D), pc, routing=other)
    assert torch.equal(got, other)
    want = probs.gather(1, other)
    torch.testing.assert_close(gates, want / want.sum(-1, keepdim=True))


def test_positions_in_expert_matches_reference():
    rs = np_rng(9)
    eid = np.sort(rs.integers(0, 6, 50))
    for n in (6, 8):
        want = rmoe._positions_in_expert(jnp.asarray(eid), n)
        got = pmoe._positions_in_expert(torch.as_tensor(eid), n)
        np.testing.assert_array_equal(np.asarray(want), as_np(got))


def test_moe_overflow_mirror_matches_reference():
    """The benchmark's drop fractions on the reference's own weights and
    skewed tokens (its `jax.random` draws), exactly equal, every capacity
    factor and policy; and the port's own seeded inputs give the same
    ordering (neighbor_steal drops no more than drop)."""
    want = rbench.run()
    key = jax.random.PRNGKey(0)
    base = rmoe.MoEConfig(n_experts=16, top_k=2, n_shared=0, d_ff_expert=4 * 64)
    rp = rmoe.moe_init(key, 64, base)
    x = jax.random.normal(jax.random.fold_in(key, 1), (1, 2048, 64))
    x = x + jax.random.normal(jax.random.fold_in(key, 2), (1, 1, 64)) * 2.0
    got = pbench.run(params=convert.moe_params(jax.tree.map(np.asarray, rp)),
                     x=torch.as_tensor(np.array(x)), csv=False)
    assert got == want
    own = pbench.run(device="cpu", csv=False)
    assert list(own) == [0.5, 0.75, 1.0, 1.25]
    for drops in own.values():
        assert drops["neighbor_steal"] <= drops["drop"]
