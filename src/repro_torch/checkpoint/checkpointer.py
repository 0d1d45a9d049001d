"""Numpy checkpointing with a manifest, async save and pruning.

  * every leaf is saved as its own .npy under a step directory, with a JSON
    manifest recording tree paths, shapes, dtypes and the step, so restore
    never needs the writer's layout;
  * `restore()` rebuilds the target's tree from the manifest, as numpy
    arrays, or with `shardings` as DTensors placed on a (possibly
    different) mesh — restoring onto another mesh (elastic shrink/grow) is
    just another `shardings` argument;
  * a DTensor leaf is saved whole (`full_tensor()`, a collective every
    rank takes part in, one leaf at a time), as the reference saves the
    `np.asarray` of a sharded array; only rank 0 keeps host copies and
    writes, and a sharded restore reads and places one leaf at a time;
  * saves are atomic (tmp dir + rename) and optionally run on a background
    thread (work continues while the previous step flushes);
  * `keep` bounds retained checkpoints (oldest pruned).

The layout is the reference's (`repro.checkpoint.checkpointer`): leaves in
its flattening order — dict keys sorted, tuple and list items in order,
None an empty subtree — and paths spelled as it spells them: keys and
indices joined by "/", a NamedTuple field as ".name", a bare leaf "". So a
directory written by either package restores through the other.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch


def _flatten(tree, prefix: str | None = None):
    """(leaves, paths) of `tree` in the reference's order and spelling."""
    def join(part):
        return part if prefix is None else f"{prefix}/{part}"

    if tree is None:
        return [], []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return [tree], ["" if prefix is None else prefix]
    leaves, paths = [], []
    for part, sub in items:
        lv, ps = _flatten(sub, join(part))
        leaves += lv
        paths += ps
    return leaves, paths


def _unflatten(tree, leaves):
    """`tree`'s structure with its leaves taken in order from the iterator
    `leaves`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves) for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(x, leaves) for x in tree)
    return next(leaves)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)


def _is_dtensor(leaf) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(leaf, DTensor)


def _host(leaf, keep: bool = True):
    """A leaf as a host array (a tensor copied off its device; a DTensor
    gathered whole first, on every rank, as the collective needs), or None
    when not `keep`."""
    if isinstance(leaf, torch.Tensor):
        if _is_dtensor(leaf):
            leaf = leaf.full_tensor()
        return leaf.detach().cpu().numpy() if keep else None
    return np.asarray(leaf) if keep else None


def _writes(leaves) -> bool:
    """Whether this process writes a tree with these leaves: always, but
    for a tree of DTensors in a process group, where rank 0 writes."""
    import torch.distributed as dist

    return not (any(_is_dtensor(x) for x in leaves) and dist.is_initialized()
                and dist.get_rank() != 0)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree) -> str:
        """Snapshot `tree` at `step`. Returns the checkpoint path."""
        leaves, paths = _flatten(tree)
        writes = _writes(leaves)
        host = [_host(x, writes) for x in leaves]
        if not writes:
            return self._step_dir(step)
        self.wait()
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, paths), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, paths)
        return self._step_dir(step)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _write(self, step: int, leaves: list, paths: list):
        final = self._step_dir(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for i, (arr, path) in enumerate(zip(leaves, paths)):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append({
                "path": path, "file": fname,
                "shape": list(arr.shape), "dtype": str(arr.dtype)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._prune()

    def _prune(self):
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def all_steps(self) -> list:
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.dir)
                      if name.startswith("step_") and not name.endswith(".tmp"))

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _files(self, step: int) -> dict:
        """Each leaf's file in checkpoint `step`, by its manifest path."""
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        return {e["path"]: os.path.join(d, e["file"]) for e in manifest["leaves"]}

    def read(self, step: int) -> dict:
        """Every leaf of checkpoint `step`, by its manifest path."""
        return {path: np.load(f) for path, f in self._files(step).items()}

    def restore(self, target_tree, step: int | None = None, shardings=None):
        """Rebuild `target_tree`'s structure from disk, its leaves as numpy
        arrays; returns (tree, step). `shardings`: optional tree (matching
        the target) of `launch.shardings.NamedSharding`, placing each leaf
        on its mesh under its spec as a DTensor (`distribute_tensor`) as
        soon as it is read, so a rank holds one whole leaf at a time —
        elastic restore onto any mesh."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        files = self._files(step)
        leaves, paths = _flatten(target_tree)
        if shardings is not None:
            from ..launch.shardings import place

            where = _flatten(shardings)[0]
        out = []
        for i, (leaf, path) in enumerate(zip(leaves, paths)):
            arr = np.load(files[path])
            if tuple(arr.shape) != _shape(leaf):
                raise ValueError(
                    f"shape mismatch for {path}: ckpt {arr.shape} vs target "
                    f"{_shape(leaf)}")
            out.append(arr if shardings is None else place(arr, where[i]))
        return _unflatten(target_tree, iter(out)), step
