"""Deterministic synthetic corpus: zipf-ish token streams + variable-length
documents (the imbalance source the steal-rebalancer consumes).

Everything is a pure function of (seed, shard, step) so any worker can
regenerate any batch — restart/elastic-reshard safe by construction (no
data-loader state in checkpoints).

The port's own copy of `repro.data.synthetic` (pure numpy, line for line), so the
port imports nothing of the reference package.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int = 32000
    seq_len: int = 1024
    global_batch: int = 32
    seed: int = 17
    # document-length distribution (lognormal), used for packing/balancing
    doc_len_mu: float = 5.5
    doc_len_sigma: float = 1.0
    min_doc_len: int = 16


def _rng(cfg: DataConfig, shard: int, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, shard, step]))


def token_batch(cfg: DataConfig, shard: int, n_shards: int, step: int):
    """(local_batch, seq_len) int32 zipf tokens + all-ones loss mask."""
    local = cfg.global_batch // n_shards
    rng = _rng(cfg, shard, step)
    toks = rng.zipf(1.3, size=(local, cfg.seq_len)).astype(np.int64)
    toks = (toks - 1) % cfg.vocab
    return {"tokens": toks.astype(np.int32),
            "loss_mask": np.ones((local, cfg.seq_len), np.float32)}


def document_lengths(cfg: DataConfig, shard: int, step: int, n_docs: int):
    rng = _rng(cfg, shard, step * 1000 + 7)
    lens = rng.lognormal(cfg.doc_len_mu, cfg.doc_len_sigma, n_docs)
    return np.maximum(lens.astype(np.int64), cfg.min_doc_len)


def documents(cfg: DataConfig, shard: int, step: int, n_docs: int):
    """List of variable-length token arrays (the packer's input)."""
    lens = document_lengths(cfg, shard, step, n_docs)
    rng = _rng(cfg, shard, step * 1000 + 13)
    return [((rng.zipf(1.3, size=int(l)) - 1) % cfg.vocab).astype(np.int32)
            for l in lens]
