"""Port parity of the balancer's collectives (`repro_torch.core.balancer`:
`steal_shift`, `rebalance`, `global_rebalance` on a `mesh_comm.LocalMesh`)
against the reference's under `shard_map` on a 1-D mesh of 8 (one child
process, `tests/sharded_reference.py`), and of `rebalance_reference` with
`link_ok` against the reference's (in this process).

Queues are made from a seed: a `small` set (costs 1-100) and a `large` one
(costs near 2^23, so loads pass 2^24, where the float32 trigger compare and
an exact one part), each at triggers 0.25 and 0.5, with and without a
`link_ok` mask; an `edge` set puts one shard's load a hair under half its
neighbour's past 2^25, where only the float32 compare says no.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same, np_rng
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

import sharded_reference as sr
from repro.core import balancer as rbal
from repro_torch.core import balancer as pbal
from repro_torch.core import mesh_comm

ROOT = Path(__file__).resolve().parents[1]
REF_TIMEOUT = 300  # seconds for the reference's child process
S, SLOTS, ITEM_W = sr.BALANCER_SHARDS, 12, 3


def _queues(rng, lo: int, hi: int) -> dict:
    fill = rng.integers(0, SLOTS + 1, S)
    fill[0], fill[3] = SLOTS, 0  # a full shard, an empty one
    valid = np.arange(SLOTS)[None, :] < fill[:, None]
    valid = np.take_along_axis(valid, rng.permuted(np.tile(np.arange(SLOTS), (S, 1)),
                                                   axis=1), 1)
    return {"items": rng.integers(0, 1000, (S, SLOTS, ITEM_W)).astype(np.int32),
            "valid": valid,
            "cost": rng.integers(lo, hi, (S, SLOTS)).astype(np.int32),
            "link_ok": rng.random(S) < 0.7}


def _edge() -> dict:
    """Shard 1's load (2^25 + 1) is below half of shard 0's (2^26 + 4)
    exactly, but not in float32 (both round to a tie)."""
    cost = np.zeros((S, SLOTS), np.int32)
    valid = np.zeros((S, SLOTS), bool)
    for shard, costs in ((0, (2**24, 2**26 + 4 - 2**24)), (1, (2**25 + 1,))):
        cost[shard, :len(costs)] = costs
        valid[shard, :len(costs)] = True
    return {"items": np.arange(S * SLOTS * ITEM_W, dtype=np.int32).reshape(S, SLOTS, ITEM_W),
            "valid": valid, "cost": cost, "link_ok": np.ones(S, bool)}


@pytest.fixture(scope="module")
def data():
    rng = np_rng(20261018)
    return {"small": _queues(rng, 1, 100), "large": _queues(rng, 2**23 - 64, 2**23 + 64),
            "edge": _edge()}


@pytest.fixture(scope="module")
def ref(data, tmp_path_factory):
    """Every call of `sr.BALANCER_CALLS` on every data set, with and without
    `link_ok`, from one child process with 8 forced host devices."""
    tmp = tmp_path_factory.mktemp("balancer_ref")
    np.savez(tmp / "in.npz", **{f"{ds}/{k}": v for ds, d in data.items()
                                for k, v in d.items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={S}",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(ROOT / "tests" / "sharded_reference.py"),
                           "balancer", str(tmp / "in.npz"), str(tmp / "out.npz")],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=REF_TIMEOUT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(tmp / "out.npz"))


def _port_call(name: str, d: dict, link: str):
    fn, arg, trigger = sr.BALANCER_CALLS[name]
    mesh = mesh_comm.LocalMesh((S,), ("x",), device="cpu")
    q = pbal.make_queue(*(torch.as_tensor(d[k]) for k in ("items", "valid", "cost")))
    ok = torch.as_tensor(d["link_ok"]) if link == "on" else None
    if fn == "steal_shift":
        return pbal.steal_shift(q, "x", arg, sr.BALANCER_MAX_ITEMS, trigger, ok, mesh=mesh)
    if fn == "rebalance":
        return pbal.rebalance(q, "x", arg, sr.BALANCER_MAX_ITEMS, trigger, ok, mesh=mesh)
    return pbal.global_rebalance(q, "x", sr.BALANCER_MAX_ITEMS, mesh=mesh)


CASES = [(ds, name, link) for ds in ("small", "large", "edge") for name in sr.BALANCER_CALLS
         for link in (("on", "off") if name != "global_rebalance" else ("off",))]


@pytest.mark.parametrize("ds,name,link", CASES)
def test_collectives_equal_reference(data, ref, ds, name, link):
    q, stats = _port_call(name, data[ds], link)
    got = dict(zip(("items", "valid", "cost"), q), **stats)
    for key, v in got.items():
        assert_same(ref[f"{ds}/{name}/{link}/{key}"], v, f"{ds} {name} link {link}: {key}")


def test_edge_moves_only_under_an_exact_compare(data, ref):
    """The float32 trigger matters: at trigger 0.5 the reference moves
    nothing on `edge`, where an exact integer compare would move an item."""
    d = data["edge"]
    assert int(ref["edge/steal_shift+1@0.5/off/moved"].sum()) == 0
    loads = np.where(d["valid"], d["cost"], 0).sum(1).astype(np.int64)
    assert 2 * loads[1] < loads[0]  # exact: shard 1 would ask shard 0


@pytest.mark.parametrize("trigger", [0.25, 0.5])
@pytest.mark.parametrize("ds", ["small", "large"])
@pytest.mark.parametrize("link", ["on", "off"])
def test_rebalance_reference_with_link_ok(data, ds, trigger, link):
    """`rebalance_reference` takes the reference's `link_ok` and `trigger`
    (accepted, not read: the threshold stays 0.5)."""
    d = data[ds]
    ok = d["link_ok"] if link == "on" else None
    want = rbal.rebalance_reference(
        jnp.asarray(d["items"]), jnp.asarray(d["valid"]), jnp.asarray(d["cost"]),
        rounds=2, max_items=sr.BALANCER_MAX_ITEMS, trigger=trigger,
        link_ok=None if ok is None else jnp.asarray(ok))
    got = pbal.rebalance_reference(
        *(torch.as_tensor(d[k]) for k in ("items", "valid", "cost")), rounds=2,
        max_items=sr.BALANCER_MAX_ITEMS, trigger=trigger,
        link_ok=None if ok is None else torch.as_tensor(ok))
    for what, a, b in zip(("items", "valid", "cost", "dropped"), want, got):
        assert_same(a, b, f"{ds} trigger {trigger} link {link}: {what}")
