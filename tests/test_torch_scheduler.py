"""Port parity of the round executor: `repro_torch.core.scheduler` on the
CPU against the reference's (`repro.core.scheduler`, JAX), exact equality
of every `RunResult` field, the three `per_worker_*` arrays included.

  * tests/test_scheduler.py's FIB at W = 16 under all four strategies (one
    port sweep against four reference runs);
  * one sub-round's victims (`_select_victims`) for every strategy;
  * the parameter checks' messages, the sharded executor's refusal of
    strategies it has no round for, and the CUDA default without a card;
  * the round on the staged push log (`benchmarks.sched_backends`) equal
    to the in-place round the executor runs.

UTS and `run_vectorized_batch` are in tests/test_torch_scheduler_batch.py,
the mixed grid, the `link_up` snapshot and the `max_rounds` cut in
tests/test_torch_scheduler_grid.py (each file's reference compiles take
most of its time).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_results_equal, assert_same, np_rng, to_jax, to_torch
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import scheduler as rsch
from repro.core import stealing as rst
from repro.core import tasks as rtasks
from repro.core import topology as rtopo
from repro_torch import convert
from repro_torch.benchmarks import sched_backends
from repro_torch.core import rng
from repro_torch.core import scheduler as psch
from repro_torch.core import stealing as pst

# tests/test_scheduler.py's fixtures
FIB = rtasks.FibWorkload(n=24, cutoff=10, max_leaf_cost=8)
MESH = rtopo.MeshTopology.square(16)
PFIB = convert.workload("FibWorkload", dataclasses.asdict(FIB))
PMESH = convert.mesh(16, 4, 4)
STRATEGIES = [s.value for s in rst.Strategy]
STATIC = dict(capacity=256, max_rounds=100_000)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's CPU path runs many small operations: one intra-op thread
    a test process keeps parallel workers from oversubscribing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(strategy: str, **kw):
    """The same configuration for both packages."""
    fields = dict(STATIC, **kw)
    return (rsch.SchedulerConfig(strategy=rst.Strategy(strategy), **fields),
            convert.sched_config(dict(fields, strategy=strategy)))


@pytest.fixture(scope="module")
def fib_all():
    """FIB at W = 16 under every strategy: the reference's four runs (one
    compile: the strategy is traced) and the port's four-point sweep (one
    core call)."""
    ref = {s: rsch.run_vectorized(FIB, MESH, _cfgs(s)[0]) for s in STRATEGIES}
    before = psch.run_trace_count()
    pts = [_cfgs(s)[1] for s in STRATEGIES]
    port = psch.run_sweep(PFIB, PMESH, pts[0], pts, device="cpu")
    assert psch.run_trace_count() - before == 1
    return ref, dict(zip(STRATEGIES, port))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_fib_every_strategy(fib_all, strategy):
    ref, port = fib_all
    assert_results_equal(ref[strategy], port[strategy])
    r = port[strategy]
    assert (r.result, r.nodes, r.overflow) == (FIB.expected_result(),
                                               FIB.expected_nodes(), 0)
    assert r.per_worker_busy.dtype == np.int32


@pytest.mark.parametrize("code", range(4))
def test_select_victims(code):
    """One sub-round's victims from a (round, sub) key, for random thieves
    and fail counts: the reference's `lax.switch` branch against the
    port's draw for that strategy."""
    W = MESH.num_workers
    rs = np_rng(code)
    is_thief = rs.random(W) < 0.6
    fails = rs.integers(0, 9, W).astype(np.int32)
    tables = {"neighbors": rst.neighbor_list(MESH), "radius2": rst.radius2_list(MESH),
              "lifelines": rst.lifeline_list(W)}
    ptables = psch._mesh_tables(PMESH, "cpu")
    for name, tab in tables.items():
        assert_same(tab, ptables[name], name)
    for rnd, sub in ((0, 0), (13, 5)):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(7), rnd), sub)
        want = rsch._select_victims(code, 3, {k: jnp.asarray(v) for k, v in tables.items()},
                                    key, jnp.asarray(is_thief), to_jax(fails), W)
        pkey = rng.fold_in(rng.fold_in(rng.PRNGKey(torch.tensor([[7]])), rnd), sub)
        got = psch._select_victims(torch.tensor([[code]]), torch.tensor([[3]]),
                                   ptables, pkey, torch.as_tensor(is_thief)[None],
                                   to_torch(fails)[None], W, present=[code])
        assert_same(want, got[0], f"code {code}, round {rnd}, sub {sub}")


def test_stack_and_split():
    cfg = psch.SchedulerConfig(strategy=pst.Strategy.ADAPTIVE, capacity=64,
                               escalate_after=2, max_grants_per_victim=3, seed=5)
    scfg, p = cfg.split()
    assert scfg == psch.SchedStatic(capacity=64, max_rounds=1_000_000)
    assert p == psch.SchedParams(strategy=pst.ADAPTIVE_CODE, escalate_after=2,
                                 max_grants_per_victim=3, seed=5)
    st = psch.stack_sched_params([p, p._replace(strategy="global", seed=9)])
    assert all(x.dtype == torch.int32 and x.shape == (2,) for x in st)
    assert st.strategy.tolist() == [pst.ADAPTIVE_CODE, pst.GLOBAL_CODE]
    assert st.seed.tolist() == [5, 9]
    ref = rsch.SchedulerConfig(strategy=rst.Strategy.ADAPTIVE, capacity=64,
                               escalate_after=2, max_grants_per_victim=3, seed=5)
    assert dataclasses.asdict(ref.static) == dataclasses.asdict(scfg)
    assert tuple(ref.params) == tuple(p)
    with pytest.raises(ValueError, match="at least one point"):
        psch.stack_sched_params([])


@pytest.mark.parametrize("bad", [dict(max_grants_per_victim=rst.GRANT_WIDTH + 1),
                                 dict(strategy=7), dict(strategy=-1)])
def test_check_sched_params_messages(bad):
    with pytest.raises(ValueError) as ref_err:
        rsch._check_sched_params(rsch.SchedParams()._replace(**bad))
    with pytest.raises(ValueError) as port_err:
        psch._check_sched_params(psch.SchedParams()._replace(**bad))
    assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match=str(ref_err.value)[:20]):
        psch.run_sweep(PFIB, PMESH, psch.SchedStatic(),
                       [psch.SchedParams()._replace(**bad)], device="cpu")


def test_refusals():
    from repro_torch.core import mesh_comm

    mesh = mesh_comm.LocalMesh((4, 4), device="cpu")
    adaptive = psch.SchedulerConfig(strategy=pst.Strategy.ADAPTIVE)
    with pytest.raises(ValueError, match="sharded executor supports NEIGHBOR and GLOBAL"):
        psch.make_sharded_round((4, 4), adaptive, PFIB.tables(), mesh=mesh)
    with pytest.raises(ValueError, match="sharded executor supports NEIGHBOR and GLOBAL"):
        psch.build_sharded_run(mesh, adaptive, PFIB)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            psch.run_vectorized(PFIB, PMESH, psch.SchedulerConfig(capacity=64))


def test_staged_round_equals_in_place():
    """One `stage` and one `apply` a round leave every `RunResult` field the
    executor's in-place pushes leave (the script raises where they differ),
    over 40 rounds of the W = 16 FIB, GLOBAL and NEIGHBOR x two seeds."""
    out = sched_backends.run(sched_backends.FIB_SMALL, workers=16, capacity=256,
                             rounds=40, seeds=(0, 1), device="cpu")
    assert sorted(out) == ["in_place", "staged"]
    assert all(len(r["ms_round"]) == 2 and r["activities"] is None
               for r in out.values())
