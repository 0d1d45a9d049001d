"""Expert parallelism of the MoE layer: `repro_torch.models.moe.moe_apply`
with `experts=(lo, hi)` (what each "model" rank runs in the sharded train
step, `layers.expert_shards`) against the reference's whole layer
(`repro.models.moe.moe_apply`), and the neighbor steal across the ranks'
boundary.

  * Each of 2 or 4 shards takes the router and the tokens whole and its
    own E / shards experts and slice of the shared experts' hidden units;
    the shards' outputs and load-balance losses summed equal the
    reference's layer (tests/test_torch_moe.py's tolerance: the same
    products summed in another order), the dropped fractions exactly, the
    routing being global on every shard.
  * The neighbor steal from expert e to e + 1 crosses from one shard to the
    next at a boundary (the paper's single hop on the ring of expert-
    parallel ranks): such slots occur here, and in the 2 x 2 gloo run of
    tests/test_torch_sharded_train.py's MoE case.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, np_rng
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.models import moe as rmoe
from repro.models.config import MoEConfig as RMoEConfig
from repro_torch import convert
from repro_torch.models import moe as pmoe
from repro_torch.models.config import MoEConfig as PMoEConfig
from test_torch_moe import TOL

D = 32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _shard(params, lo: int, hi: int, r: int, shards: int):
    """Shard r's parameters: the router whole, experts lo..hi-1, its slice
    of the shared experts' hidden units."""
    out = {"router": params["router"],
           **{k: params[k][lo:hi] for k in ("wg", "wu", "wd")}}
    if "shared" in params:
        sp = params["shared"]
        f = sp["wg"].shape[2] // shards
        cut = slice(r * f, (r + 1) * f)
        out["shared"] = {"wg": sp["wg"][:, :, cut], "wu": sp["wu"][:, :, cut],
                         "wd": sp["wd"][:, cut]}
    return out


# (policy, ep_pad_to, capacity factor, seed): the router's weights x 25,
# so routing is peaked, experts overflow and (under the steal) some slots
# cross a shard boundary, at 2 and at 4 shards, in every steal case
CASES = [("neighbor_steal", 0, 1.0, 313), ("neighbor_steal", 0, 1.25, 313),
         ("neighbor_steal", 4, 1.0, 313), ("neighbor_steal", 4, 1.25, 306),
         ("drop", 0, 1.25, 313), ("drop", 4, 0.5, 306)]
ROUTER_SCALE = 25.0


@functools.cache
def _reference(policy, ep_pad, cf, seed):
    """(port config, port parameters, x, the reference's y and metrics) of
    one case, made once a worker."""
    fields = dict(n_experts=8, top_k=2, n_shared=1, d_ff_expert=48, d_ff_shared=40,
                  capacity_factor=cf, overflow=policy, ep_pad_to=ep_pad)
    rc, pc = RMoEConfig(**fields), PMoEConfig(**fields)
    rp = rmoe.moe_init(jax.random.PRNGKey(seed), D, rc)
    rp["router"]["w"] = rp["router"]["w"] * ROUTER_SCALE
    x = np_rng(seed).standard_normal((2, 24, D)).astype(np.float32)
    ry, rm = jax.jit(rmoe.moe_apply, static_argnums=(2,))(rp, jnp.asarray(x), rc)
    pp = convert.moe_params(jax.tree.map(np.asarray, rp))
    return pc, pp, torch.as_tensor(x), np.asarray(ry), jax.tree.map(float, rm)


def _summed_shards(pc, pp, xt, rm, shards, parts):
    """The sum of every (expert shard, part) rank's y and load-balance
    loss; each rank's dropped fractions equal the reference's exactly."""
    E = pc.n_experts + pc.ep_pad_to
    per = E // shards
    y, aux = 0, 0
    for r in range(shards):
        for i in range(parts):
            yr, mr = pmoe.moe_apply(_shard(pp, r * per, (r + 1) * per, r, shards), xt, pc,
                                    experts=(r * per, (r + 1) * per),
                                    part=None if parts == 1 else (i, parts))
            for key in ("moe_dropped", "moe_dropped_pre_steal"):
                assert float(mr[key]) == rm[key], (r, i, key)
            y, aux = y + yr, aux + mr["moe_aux"]
    return y, aux


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("policy,ep_pad,cf,seed", CASES)
def test_expert_shards_sum_to_reference_layer(policy, ep_pad, cf, seed, shards):
    pc, pp, xt, ry, rm = _reference(policy, ep_pad, cf, seed)
    y, aux = _summed_shards(pc, pp, xt, rm, shards, 1)
    np.testing.assert_allclose(as_np(y), ry, **TOL)
    np.testing.assert_allclose(float(aux), rm["moe_aux"], **TOL)
    crossed = pmoe.cross_shard_steals(pp, xt, pc, shards)
    assert crossed > 0 if policy == "neighbor_steal" else crossed == 0


@pytest.mark.parametrize("shards,parts", [(2, 3), (4, 2)])
@pytest.mark.parametrize("policy,ep_pad,cf,seed", CASES)
def test_expert_shards_split_over_data_sum_to_reference_layer(policy, ep_pad, cf, seed,
                                                              shards, parts):
    """Each expert shard's places and shared tokens split again over
    `parts` data-parallel ranks (`part=(i, parts)`; 3 does not divide C or
    T, so the last range is short): the shards' sum is the reference's
    layer, and rank 0's dispatch holds ceil(C / parts) places an expert."""
    pc, pp, xt, ry, rm = _reference(policy, ep_pad, cf, seed)
    y, aux = _summed_shards(pc, pp, xt, rm, shards, parts)
    np.testing.assert_allclose(as_np(y), ry, **TOL)
    np.testing.assert_allclose(float(aux), rm["moe_aux"], **TOL)
    C = pmoe.capacity_of(xt.shape[0] * xt.shape[1], pc)
    assert pmoe._part_range(C, (0, parts)) == (0, -(-C // parts))
    assert pmoe._part_range(C, (parts - 1, parts))[1] == C
