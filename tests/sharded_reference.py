"""The reference's sharded outputs for the port's parity tests (JAX on the
CPU, run in a child process: `shard_map` needs as many devices as the mesh
has workers, forced with XLA_FLAGS before JAX is imported). Not a test.

    python tests/sharded_reference.py sharded OUT.npz
    python tests/sharded_reference.py balancer IN.npz OUT.npz

`sharded` writes `SHARDED_CASES`' runs of `repro.core.scheduler.
build_sharded_run` (every state leaf and the rounds, keys
``"<case>/<leaf>"``) and `COLLECTIVE_CASES`' `jax.lax` collectives on a 2x3
mesh; `balancer` runs `repro.core.balancer`'s collectives under
`shard_map` on a 1-D mesh of 8 on the queues in IN.npz. The parent sets
the device count (`DEVICES`).
"""

import os
import sys
from pathlib import Path

import numpy as np

# the executor's cases: name -> (mesh shape, strategy, torus), each on
# tests/test_scheduler.py's sharded FIB (n=20, cutoff 10, max leaf cost 8,
# capacity 128, 50,000 rounds at most)
SHARDED_CASES = {"4x4-neighbor": ((4, 4), "neighbor", False),
                 "4x4-global": ((4, 4), "global", False),
                 "4x4-neighbor-torus": ((4, 4), "neighbor", True),
                 "2x3-neighbor": ((2, 3), "neighbor", False),
                 "2x3-global": ((2, 3), "global", False)}
SHARDED_FIB = dict(n=20, cutoff=10, max_leaf_cost=8)
SHARDED_CFG = dict(capacity=128, max_rounds=50_000)
# the collectives on a 2x3 ("row", "col") mesh of a (6, 2) int32 value:
# name -> (op, axis, pairs)
COLLECTIVE_CASES = {"ppermute-row": ("ppermute", "row", ((0, 1),)),
                    "ppermute-col": ("ppermute", "col", ((0, 2), (2, 1))),
                    "ppermute-col-ring": ("ppermute", "col", ((0, 1), (1, 2), (2, 0))),
                    "all_gather-row": ("all_gather", "row", None),
                    "all_gather-col": ("all_gather", "col", None),
                    "psum-row": ("psum", "row", None),
                    "psum-col": ("psum", "col", None)}
BALANCER_SHARDS = 8
# the balancer's calls: name -> (function, shift or rounds, trigger)
BALANCER_CALLS = {f"{fn}{arg:+d}@{t}": (fn, arg, t)
                  for fn, args in (("steal_shift", (1, -1)), ("rebalance", (2,)))
                  for arg in args for t in (0.25, 0.5)}
BALANCER_CALLS["global_rebalance"] = ("global_rebalance", 0, None)
BALANCER_MAX_ITEMS = 4
DEVICES = 16


def state_leaves(state) -> dict:
    """A `WorkerState`'s leaves by name (the deque's as buf, bot, size)."""
    d = state.deque
    leaves = dict(state._asdict(), buf=d.buf, bot=d.bot, size=d.size)
    del leaves["deque"]
    return leaves


def _mesh(jax, shape, names=("row", "col")):
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _shard_map():
    try:
        from jax import shard_map
        return shard_map, {"check_vma": False}
    except ImportError:
        from jax.experimental.shard_map import shard_map
        return shard_map, {"check_rep": False}


def sharded_run(jax, shape, strategy: str, torus: bool, workload, **cfg):
    """One `build_sharded_run` on the first prod(shape) devices: the state's
    leaves (numpy) and the rounds."""
    from repro.core import scheduler, stealing

    run = scheduler.build_sharded_run(
        _mesh(jax, shape), scheduler.SchedulerConfig(
            strategy=stealing.Strategy(strategy), **cfg), workload, torus=torus)
    state, rounds = run()
    return {k: np.asarray(v) for k, v in state_leaves(state).items()}, int(rounds)


def sharded(out: str):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core import tasks

    wl = tasks.FibWorkload(**SHARDED_FIB)
    saved = {}
    for name, (shape, strategy, torus) in SHARDED_CASES.items():
        leaves, rounds = sharded_run(jax, shape, strategy, torus, wl, **SHARDED_CFG)
        saved.update({f"{name}/{k}": v for k, v in leaves.items()})
        saved[f"{name}/rounds"] = np.asarray(rounds)
    shard_map, kw = _shard_map()
    x = np.arange(12, dtype=np.int32).reshape(6, 2) * 10 + 1
    for name, (op, axis, pairs) in COLLECTIVE_CASES.items():
        def body(v, op=op, axis=axis, pairs=pairs):
            if op == "ppermute":
                return jax.lax.ppermute(v, axis, list(pairs))
            if op == "all_gather":
                return jax.lax.all_gather(v[0], axis)[None]
            return jax.lax.psum(v, axis)
        fn = shard_map(body, mesh=_mesh(jax, (2, 3)), in_specs=(P(("row", "col")),),
                       out_specs=P(("row", "col")), **kw)
        saved[f"collective/{name}"] = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    np.savez(out, **saved)


def balancer(inp: str, out: str):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core import balancer as bal

    shard_map, kw = _shard_map()
    mesh = _mesh(jax, (BALANCER_SHARDS,), ("x",))
    data = np.load(inp)
    datasets = sorted({k.split("/")[0] for k in data.files})
    saved = {}
    for name, (fn, arg, trigger) in BALANCER_CALLS.items():
        def body(items, valid, cost, link_ok, fn=fn, arg=arg, trigger=trigger):
            q = bal.ShardQueue(items[0], valid[0], cost[0])
            ok = link_ok[0]
            if fn == "steal_shift":
                q, st = bal.steal_shift(q, "x", arg, BALANCER_MAX_ITEMS, trigger, ok)
            elif fn == "rebalance":
                q, st = bal.rebalance(q, "x", arg, BALANCER_MAX_ITEMS, trigger, ok)
            else:
                q, st = bal.global_rebalance(q, "x", BALANCER_MAX_ITEMS)
            return (q.items[None], q.valid[None], q.cost[None], st["moved"][None],
                    st["dropped"][None], st["load"][None])
        spec = P("x")
        f = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,) * 4,
                              out_specs=(spec,) * 6, **kw))
        for ds in datasets:
            links = ("on", "off") if fn != "global_rebalance" else ("off",)
            for link in links:
                ok = data[f"{ds}/link_ok"] if link == "on" else np.ones(BALANCER_SHARDS, bool)
                res = f(*(jnp.asarray(data[f"{ds}/{k}"]) for k in ("items", "valid", "cost")),
                        jnp.asarray(ok))
                for key, v in zip(("items", "valid", "cost", "moved", "dropped", "load"), res):
                    saved[f"{ds}/{name}/{link}/{key}"] = np.asarray(v)
    np.savez(out, **saved)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
        sys.exit("set XLA_FLAGS=--xla_force_host_platform_device_count=N first")
    what, *paths = sys.argv[1:]
    {"sharded": sharded, "balancer": balancer}[what](*paths)
