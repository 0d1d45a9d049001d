"""Task-level checkpointing (TC) for the work-stealing executor (paper §5).

Saves only *pending tasks* (deque contents) and result accumulators — the
"intermediate results needed to continue execution" — instead of the whole
state. The format is the `Checkpointer`'s, the reference's
(`repro.checkpoint.task_checkpoint`) leaf for leaf. Restore supports a
different worker count: deque contents are redistributed onto the new
constellation (owner w → w mod W, spilling to the emptiest deque when one
is full).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import deque as dq
from .checkpointer import Checkpointer, _host


def pack_state(deques: dq.DequeState, acc) -> dict:
    """Compact: only live deque entries are saved, bottom to top."""
    buf, bot, size = (_host(x) for x in deques)
    W, C, T = buf.shape
    ranks = [np.arange(int(size[w])) for w in range(W)]
    owner = np.concatenate([np.full(len(r), w, np.int32) for w, r in enumerate(ranks)]
                           + [np.zeros(0, np.int32)])
    slots = np.concatenate([(int(bot[w]) + r) % C for w, r in enumerate(ranks)]
                           + [np.zeros(0, np.int64)]).astype(np.int64)
    tasks = buf[owner, slots].astype(np.int32).reshape(-1, T)
    return {"tasks": tasks, "owner": owner, "acc": _host(acc).astype(np.int64)}


def unpack_state(packed: dict, num_workers: int, capacity: int):
    """Rebuild deques on a (possibly different-sized) constellation: the
    port's `DequeState` and an int32 accumulator, CPU tensors."""
    tasks = packed["tasks"]
    acc_old = packed["acc"]
    buf = np.zeros((num_workers, capacity, tasks.shape[1] if tasks.size else 4),
                   np.int32)
    size = np.zeros(num_workers, np.int32)
    # keep locality where possible: owner w → w mod num_workers
    for i, t in enumerate(tasks):
        w = int(packed["owner"][i]) % num_workers
        if size[w] >= capacity:  # spill to the emptiest deque
            w = int(np.argmin(size))
        buf[w, size[w]] = t
        size[w] += 1
    acc = np.zeros(num_workers, np.int64)
    for w in range(acc_old.shape[0]):
        acc[w % num_workers] += acc_old[w]

    def t(a):
        return torch.as_tensor(a, dtype=torch.int32)
    deques = dq.DequeState(t(buf), t(np.zeros(num_workers, np.int32)), t(size))
    return deques, t(acc % (2**31 - 1))


class TaskCheckpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.ckpt = Checkpointer(directory, keep=keep, async_save=False)

    def save(self, step: int, deques: dq.DequeState, acc):
        self.ckpt.save(step, pack_state(deques, acc))

    def restore(self, num_workers: int, capacity: int, step=None):
        """((deques, acc), step) from checkpoint `step` (default: the
        latest) onto `num_workers` deques of `capacity`."""
        step = step if step is not None else self.ckpt.all_steps()[-1]
        return unpack_state(self.ckpt.read(step), num_workers, capacity), step
