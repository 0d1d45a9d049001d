"""Checkpointing of the port: the numpy-leaf `Checkpointer` (manifest,
atomic rename, async save, pruning) and the round executor's task-level
checkpoints (`TaskCheckpointer`). The on-disk format is the reference's
(`repro.checkpoint`): a directory written by either package restores
through the other."""

from . import checkpointer, task_checkpoint
from .checkpointer import Checkpointer
from .task_checkpoint import TaskCheckpointer

__all__ = ["checkpointer", "task_checkpoint", "Checkpointer", "TaskCheckpointer"]
