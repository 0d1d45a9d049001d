"""Port parity of checkpointing: `repro_torch.checkpoint` against
`repro.checkpoint`.

  * `pack_state` / `unpack_state` on tests/test_checkpoint.py's fixture
    (8 deques of 16 slots, some wrapped around the ring) for new_W ∈ {4,
    16, 7}: every packed array and every restored deque and accumulator
    equal to the reference's, each task kept exactly once, the
    accumulator's checksum kept;
  * a directory written by either package restores through the other,
    task checkpoints and generic trees (dicts, tuples, lists, NamedTuples,
    None) alike, paths and leaf order spelled the same;
  * the `Checkpointer` itself: async save, pruning, shape checks.
"""

import json
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same

from repro.checkpoint import Checkpointer as RCheckpointer
from repro.checkpoint import TaskCheckpointer as RTaskCheckpointer
from repro.checkpoint import task_checkpoint as rtc
from repro.core import deque as rdq
from repro_torch import convert
from repro_torch.checkpoint import Checkpointer, TaskCheckpointer
from repro_torch.checkpoint import task_checkpoint as ptc
from repro_torch.checkpoint.checkpointer import _flatten
from repro_torch.core import deque as pdq

MOD = 2**31 - 1
COUNTS = [5, 0, 3, 1, 0, 0, 2, 7]


def _deques_with_tasks(W, cap, counts, steal=()):
    """tests/test_checkpoint.py's state: worker w holds counts[w] tasks
    [2, w, i, 0]; `steal[w]` of them then taken from its bottom and as many
    pushed again, so its ring wraps."""
    state = rdq.make(W, cap)
    for w, n in enumerate(counts):
        for i in range(n):
            task = jnp.zeros((W, 4), jnp.int32).at[w].set(jnp.asarray([2, w, i, 0]))
            state, ok = rdq.push_top(state, task, jnp.arange(W) == w)
            assert bool(ok[w])
    for w, k in enumerate(steal):
        state = rdq.steal_bottom(state, jnp.zeros(W, jnp.int32).at[w].set(k))
        for i in range(k):
            task = jnp.zeros((W, 4), jnp.int32).at[w].set(jnp.asarray([2, w, 100 + i, 1]))
            state, _ = rdq.push_top(state, task, jnp.arange(W) == w)
    return state


def _port(state):
    return convert.deque_state(*(np.array(x) for x in state))


def _tasks(deques, W):
    return [t for w in range(W) for t in pdq.to_list(deques, w)]


@pytest.mark.parametrize("new_W", [4, 16, 7])
def test_pack_unpack_matches_reference(new_W):
    W, cap = 8, 16
    acc = np.arange(W, dtype=np.int64) * 11 + (MOD - 3)
    ref_state = _deques_with_tasks(W, cap, COUNTS, steal=(2, 0, 1, 0, 0, 0, 0, 4))
    ref_packed = rtc.pack_state(ref_state, acc)
    packed = ptc.pack_state(_port(ref_state), torch.as_tensor(acc))
    assert sorted(packed) == sorted(ref_packed)
    for k in packed:
        assert packed[k].dtype == ref_packed[k].dtype, k
        assert_same(ref_packed[k], packed[k], k)
    ref_deques, ref_acc = rtc.unpack_state(ref_packed, new_W, cap)
    deques, new_acc = ptc.unpack_state(packed, new_W, cap)
    for a, b, name in zip(ref_deques, deques, ("buf", "bot", "size")):
        assert b.dtype == torch.int32
        assert_same(a, b, name)
    assert new_acc.dtype == torch.int32
    assert_same(ref_acc, new_acc, "acc")
    # every task kept exactly once, the accumulator checksum kept
    kept = _tasks(deques, new_W)
    assert len(kept) == len(set(kept)) == sum(COUNTS)
    assert set(kept) == set(map(tuple, packed["tasks"].tolist()))
    assert int(new_acc.numpy().astype(np.int64).sum() % MOD) == int(acc.sum() % MOD)


def test_unpack_spills_when_full():
    """Eight tasks of worker 0 onto two deques of 3 slots: the owner's fills,
    then the rest spill to the emptiest deque, as the reference spills."""
    ref_state = _deques_with_tasks(2, 8, [6, 2])
    packed = rtc.pack_state(ref_state, np.zeros(2, np.int64))
    ref = rtc.unpack_state(packed, 3, 3)
    port = ptc.unpack_state(ptc.pack_state(_port(ref_state), np.zeros(2)), 3, 3)
    for a, b in zip(ref[0], port[0]):
        assert_same(a, b)
    assert port[0].size.tolist() == [3, 3, 2]


def test_empty_state():
    ref_state = rdq.make(3, 4)
    packed = ptc.pack_state(_port(ref_state), np.zeros(3, np.int64))
    assert packed["tasks"].shape == (0, 4) and packed["owner"].shape == (0,)
    deques, acc = ptc.unpack_state(packed, 5, 4)
    assert int(deques.size.sum()) == 0 and acc.shape == (5,)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_task_checkpoint_across_packages(tmp_path, writer):
    W, cap = 8, 16
    acc = np.arange(W, dtype=np.int64) * 7
    ref_state = _deques_with_tasks(W, cap, COUNTS)
    if writer == "reference":
        RTaskCheckpointer(str(tmp_path)).save(5, ref_state, acc)
    else:
        TaskCheckpointer(str(tmp_path)).save(5, _port(ref_state), torch.as_tensor(acc))
    (ref_deques, ref_acc), ref_step = RTaskCheckpointer(str(tmp_path)).restore(6, cap)
    (deques, new_acc), step = TaskCheckpointer(str(tmp_path)).restore(6, cap)
    assert step == ref_step == 5
    for a, b in zip(ref_deques, deques):
        assert_same(a, b)
    assert_same(ref_acc, new_acc)
    with open(tmp_path / "step_00000005" / "manifest.json") as f:
        manifest = json.load(f)
    assert [e["path"] for e in manifest["leaves"]] == ["acc", "owner", "tasks"]
    assert len(_tasks(deques, 6)) == sum(COUNTS)


class Moments(NamedTuple):
    count: object
    mu: object


def _tree(lib):
    """The same nested tree of arrays in either package's tensors."""
    rs = np.random.default_rng(3)
    a = rs.standard_normal((4, 8)).astype(np.float32)
    b = rs.integers(0, 9, 5).astype(np.int32)
    c = rs.standard_normal(3).astype(np.float32)
    t = jnp.asarray if lib == "reference" else torch.as_tensor
    return {"z": t(a), "nested": {"c": t(c), "b": (t(b), [t(b[:2]), None])},
            "opt": Moments(count=t(np.asarray(3, np.int32)), mu={"w": t(a[0])})}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_tree_across_packages(tmp_path, writer):
    if writer == "reference":
        RCheckpointer(str(tmp_path), async_save=False).save(2, _tree("reference"))
    else:
        Checkpointer(str(tmp_path), async_save=False).save(2, _tree("port"))
    target = _tree("port")
    got, step = Checkpointer(str(tmp_path)).restore(target)
    ref, ref_step = RCheckpointer(str(tmp_path)).restore(_tree("reference"))
    assert step == ref_step == 2
    assert isinstance(got["opt"], Moments) and got["nested"]["b"][1][1] is None
    want = [np.asarray(x) for x in _flatten(target)[0]]
    got_leaves = _flatten(got)[0]
    ref_leaves = [np.asarray(x) for x in jax.tree.leaves(ref)]
    for w, g, r in zip(want, got_leaves, ref_leaves):
        assert g.dtype == w.dtype
        assert_same(w, g)
        assert_same(r, g)


def test_checkpointer_async_prune_and_shape(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2, async_save=True)
    tree = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3)}
    for s in (1, 2, 3, 4):
        ckpt.save(s, {"a": tree["a"] + s})
    ckpt.wait()
    assert ckpt.all_steps() == [3, 4] and ckpt.latest_step() == 4
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    restored, step = ckpt.restore(tree)
    assert step == 4
    assert_same(tree["a"] + 4, restored["a"])
    restored, _ = ckpt.restore(tree, step=3)
    assert_same(tree["a"] + 3, restored["a"])
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore({"a": torch.zeros(5)})
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(tree)
