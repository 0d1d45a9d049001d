"""Greedy sequence packing of variable-length documents into fixed (B, S)
batches with loss masks and per-row token costs.

Packing is deliberately *local per shard* (no global shuffle), which is what
creates the cross-shard token imbalance the neighbor-only balancer then
fixes — mirroring the paper's setting where work originates unevenly and is
diffused by stealing.

The port's own copy of `repro.data.packing` (pure numpy, line for line), so the
port imports nothing of the reference package.
"""

from __future__ import annotations

import numpy as np


def pack_documents(docs: list, batch: int, seq_len: int, pad_id: int = 0):
    """First-fit pack docs into (batch, seq_len).

    Returns dict(tokens, loss_mask, row_cost) + list of leftover docs.
    Documents longer than seq_len are split. row_cost = real tokens per row
    (the balancer's work estimate).
    """
    rows = np.full((batch, seq_len), pad_id, np.int32)
    mask = np.zeros((batch, seq_len), np.float32)
    fill = np.zeros(batch, np.int64)
    leftovers = []
    for doc in docs:
        doc = np.asarray(doc)
        while doc.size > seq_len:
            leftovers.append(doc[seq_len:])
            doc = doc[:seq_len]
        placed = False
        for r in range(batch):
            if fill[r] + doc.size <= seq_len:
                rows[r, fill[r]:fill[r] + doc.size] = doc
                mask[r, fill[r]:fill[r] + doc.size] = 1.0
                fill[r] += doc.size
                placed = True
                break
        if not placed:
            leftovers.append(doc)
    return ({"tokens": rows, "loss_mask": mask,
             "row_cost": fill.astype(np.int32)}, leftovers)


def packing_efficiency(batch_dict) -> float:
    return float(batch_dict["loss_mask"].mean())
