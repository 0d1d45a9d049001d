"""Elastic scaling: checkpoint-reshard-restart across different meshes. The
port of `repro.runtime.elastic`.

The constellation analogy (paper §5 malleability): satellites join and
leave, so the runtime must restore any checkpoint onto any worker count.
For the LM framework: parameters and optimizer state saved from an (A×B)
mesh restore onto an (A'×B') mesh — the manifest stores only logical
shapes, and `Checkpointer.restore(shardings=...)` places each leaf under
the new mesh's specs as a DTensor. The work-stealing runtime equivalently
redistributes pending deques via `TaskCheckpointer`.

`reshard_plan` computes the per-leaf resharding (what moves where) so a
deployment can pre-size the transfer.
"""

from __future__ import annotations

import numpy as np

from ..launch import shardings as sh


def make_shardings(mesh, params, rules):
    """Map every leaf to a `NamedSharding` under `mesh` using `rules` (a
    tree of specs, `launch.shardings`)."""
    return sh.named_shardings(rules, mesh)


def reshard_plan(old_mesh_shape: tuple, new_mesh_shape: tuple,
                 leaf_shapes: dict) -> dict:
    """Bytes that must move per leaf when the mesh changes size.

    Conservative model: a leaf sharded over axes that changed size moves
    entirely; replicated leaves move only if the device set changed.
    """
    plan = {}
    changed = old_mesh_shape != new_mesh_shape
    for path, (shape, dtype_size, sharded) in leaf_shapes.items():
        nbytes = int(np.prod(shape)) * dtype_size
        plan[path] = nbytes if (changed and sharded) else 0
    return plan


def elastic_restore(ckpt, target_tree, mesh, rules):
    """Restore the latest checkpoint onto `mesh` (any shape)."""
    shardings = make_shardings(mesh, target_tree, rules)
    return ckpt.restore(target_tree, shardings=shardings)
