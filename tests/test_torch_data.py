"""Port parity of the data pipeline: `repro_torch.data` (the port's copies of
`repro.data`'s numpy modules) and `runtime.train_loop`'s batch builders
against the reference's, on the CPU. Everything here is integers or exact
float copies: bit-equal."""

import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import assert_same
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.data import imbalance as rimb
from repro.data import packing as rpack
from repro.data import sharding as rshard
from repro.data import synthetic as rsyn
from repro.models import registry as rreg
from repro.runtime import train_loop as rtl
from repro_torch.data import imbalance as pimb
from repro_torch.data import packing as ppack
from repro_torch.data import sharding as pshard
from repro_torch.data import synthetic as psyn
from repro_torch.models import registry as preg
from repro_torch.runtime import train_loop as ptl

torch.set_num_threads(1)

CONFIGS = [dict(), dict(vocab=151936, seq_len=512, global_batch=8, seed=3),
           dict(vocab=128, seq_len=64, global_batch=12, doc_len_mu=3.0,
                doc_len_sigma=0.5, min_doc_len=4)]


def _cfgs(fields):
    return rsyn.DataConfig(**fields), psyn.DataConfig(**fields)


def _same_dict(a: dict, b: dict, what: str):
    assert list(a) == list(b), what
    for k in a:
        assert a[k].dtype == b[k].dtype, (what, k)
        assert_same(a[k], b[k], f"{what}.{k}")


@pytest.mark.parametrize("fields", CONFIGS)
@pytest.mark.parametrize("shard,n_shards,step", [(0, 1, 0), (1, 4, 7), (3, 4, 123)])
def test_synthetic_bit_equal(fields, shard, n_shards, step):
    rc, pc = _cfgs(fields)
    assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
    _same_dict(rsyn.token_batch(rc, shard, n_shards, step),
               psyn.token_batch(pc, shard, n_shards, step), "token_batch")
    assert_same(rsyn.document_lengths(rc, shard, step, 9),
                psyn.document_lengths(pc, shard, step, 9), "document_lengths")
    rd, pd = rsyn.documents(rc, shard, step, 11), psyn.documents(pc, shard, step, 11)
    assert len(rd) == len(pd)
    for i, (a, b) in enumerate(zip(rd, pd)):
        assert a.dtype == b.dtype
        assert_same(a, b, f"documents[{i}]")


@pytest.mark.parametrize("batch,seq_len", [(2, 64), (4, 512), (3, 16)])
def test_packing_bit_equal(batch, seq_len):
    cfg = psyn.DataConfig(vocab=1000, seq_len=seq_len)
    docs = psyn.documents(cfg, 0, 5, batch * 3)
    rp, rleft = rpack.pack_documents(docs, batch, seq_len)
    pp, pleft = ppack.pack_documents(docs, batch, seq_len)
    _same_dict(rp, pp, "pack_documents")
    assert len(rleft) == len(pleft)
    for a, b in zip(rleft, pleft):
        assert_same(a, b, "leftover")
    assert rpack.packing_efficiency(rp) == ppack.packing_efficiency(pp)


def test_sharding_bit_equal():
    cfg = psyn.DataConfig(global_batch=8, seq_len=16)
    batch = psyn.token_batch(cfg, 0, 1, 2)
    for n in (1, 2, 4, 8):
        for s in range(n):
            assert rshard.shard_slice(8, n, s) == pshard.shard_slice(8, n, s)
            _same_dict(rshard.shard_batch(batch, n, s), pshard.shard_batch(batch, n, s),
                       f"shard_batch {n}/{s}")
    parts = [pshard.shard_batch(batch, 4, s) for s in range(4)]
    _same_dict(rshard.interleave(parts), pshard.interleave(parts), "interleave")
    with pytest.raises(AssertionError, match="divide evenly"):
        pshard.shard_slice(10, 4, 0)


@pytest.mark.parametrize("seed", [0, 5])
def test_imbalance_bit_equal(seed):
    for n, slots in ((8, 16), (16, 4), (3, 7)):
        for name in ("balanced_costs", "irregular_costs"):
            a = getattr(rimb, name)(n, slots, seed)
            b = getattr(pimb, name)(n, slots, seed)
            assert a.dtype == b.dtype
            assert_same(a, b, name)
        assert_same(rimb.root_loaded(n, slots), pimb.root_loaded(n, slots), "root_loaded")
        c = pimb.irregular_costs(n, slots, seed)
        valid = (np.arange(slots) % 2 == 0)[None, :].repeat(n, 0)
        assert rimb.imbalance_ratio(c) == pimb.imbalance_ratio(c)
        assert rimb.imbalance_ratio(c, valid) == pimb.imbalance_ratio(c, valid)


@pytest.mark.parametrize("arch,fields,rounds", [
    ("qwen2-0.5b", dict(seq_len=64, global_batch=8), 2),
    ("rwkv6-1.6b", dict(seq_len=32, global_batch=16, seed=4), 3),
    ("qwen2-0.5b", dict(seq_len=512, global_batch=8), 2)])
@pytest.mark.parametrize("step", [0, 3])
def test_balance_packed_batch_bit_equal(arch, fields, rounds, step):
    rcfg, pcfg = rreg.reduced(rreg.get_config(arch)), preg.reduced(preg.get_config(arch))
    rdc, pdc = _cfgs(fields)
    want = rtl.balance_packed_batch(rcfg, rdc, step,
                                    rtl.TrainConfig(balance_tokens=True,
                                                    rebalance_rounds=rounds))
    got = ptl.balance_packed_batch(pcfg, pdc, step,
                                   ptl.TrainConfig(balance_tokens=True,
                                                   rebalance_rounds=rounds))
    _same_dict({k: np.asarray(v) for k, v in want.items()}, got, "balance_packed_batch")


@pytest.mark.parametrize("balance", [False, True])
def test_make_batch_equal(balance):
    rcfg = rreg.reduced(rreg.get_config("qwen2-0.5b"))
    pcfg = preg.reduced(preg.get_config("qwen2-0.5b"))
    rdc, pdc = _cfgs(dict(seq_len=32, global_batch=8))
    want = rtl._make_batch(rcfg, rdc, 2, rtl.TrainConfig(balance_tokens=balance))
    got = ptl._make_batch(pcfg, pdc, 2, ptl.TrainConfig(balance_tokens=balance))
    assert list(got) == ["tokens", "loss_mask"] == list(want)
    assert got["tokens"].dtype == torch.int64 and got["loss_mask"].dtype == torch.float32
    assert_same(np.asarray(want["tokens"]).astype(np.int64), got["tokens"], "tokens")
    assert_same(want["loss_mask"], got["loss_mask"], "loss_mask")
