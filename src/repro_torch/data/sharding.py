"""Host-side data sharding helpers (per-process slices of the global batch).

The port's own copy of `repro.data.sharding` (pure numpy, line for line), so the
port imports nothing of the reference package.
"""

from __future__ import annotations

import numpy as np


def shard_slice(global_batch: int, n_shards: int, shard: int) -> slice:
    assert global_batch % n_shards == 0, "global batch must divide evenly"
    per = global_batch // n_shards
    return slice(shard * per, (shard + 1) * per)


def shard_batch(batch: dict, n_shards: int, shard: int) -> dict:
    out = {}
    for k, v in batch.items():
        sl = shard_slice(v.shape[0], n_shards, shard)
        out[k] = v[sl]
    return out


def interleave(batches: list) -> dict:
    return {k: np.concatenate([b[k] for b in batches], axis=0)
            for k in batches[0]}
