"""Port parity of the dense transformer's serving path: `repro_torch` on
the CPU against `repro.models` / `repro.runtime.serve_loop` at the reduced
qwen2-0.5b config (`registry.reduced`), with the reference's own weights
(`transformer.init`) carried across by `convert.lm_params`. On the CPU the
attention kernels run their plain versions (`kernels.ref`), which
test_torch_attention.py holds against the Pallas kernels.

Tolerances. fp32: atol 1e-5, rtol 1e-5 — the same arithmetic in another
order (the logits here are O(1)). bf16: atol 2e-2, rtol 0 — the two
frameworks round to bf16 at different points (scores, the softmax, the
matmul epilogues); one bf16 ulp at 1.0 is 2^-7. The balancer and the
serving simulation are integers: exact.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, assert_same, np_rng
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import balancer as rbal
from repro.models import layers as rL
from repro.models import registry as rreg
from repro.models import transformer as rtf
from repro.runtime import serve_loop as rserve
from repro_torch import convert
from repro_torch.core import balancer as pbal
from repro_torch.models import encdec as pencdec
from repro_torch.models import layers as pL
from repro_torch.models import registry as preg
from repro_torch.models import rglru as prglru
from repro_torch.models import transformer as ptf
from repro_torch.runtime import serve_loop as pserve

TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=0)}
DTYPES = ["float32", "bfloat16"]


def _close(want, got, dtype, what=""):
    np.testing.assert_allclose(np.asarray(want, np.float32), as_np(got.float()),
                               err_msg=what, **TOL[dtype])


@functools.lru_cache(maxsize=None)
def _model(dtype: str):
    """(reference cfg, reference params, port cfg, port params) at the
    reduced qwen2-0.5b config in one compute type."""
    rc = dataclasses.replace(rreg.reduced(rreg.get_config("qwen2-0.5b")), dtype=dtype)
    pc = dataclasses.replace(preg.reduced(preg.get_config("qwen2-0.5b")), dtype=dtype)
    assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
    rp = rtf.init(jax.random.PRNGKey(0), rc)
    pp = convert.lm_params(pc, jax.tree.map(np.asarray, rp))
    return rc, rp, pc, pp


@pytest.fixture(params=DTYPES)
def model(request):
    return _model(request.param)


def test_config_and_registry_mirror_reference():
    full_r, full_p = rreg.get_config("qwen2-0.5b"), preg.get_config("qwen2-0.5b")
    assert dataclasses.asdict(full_r) == dataclasses.asdict(full_p)
    assert full_p.n_params() == full_r.n_params()
    assert preg.list_archs() == ["qwen2-0.5b", "rwkv6-1.6b", "recurrentgemma-9b",
                                 "qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b",
                                 "mistral-large-123b", "granite-3-8b", "yi-34b",
                                 "llava-next-mistral-7b", "whisper-tiny"]
    # every architecture and family of the reference is served
    assert set(preg.list_archs()) == set(rreg.list_archs())
    assert preg._ARCH_ITEMS == {} and preg._FAMILY_ITEMS == {}
    for family in ("encdec", "vlm"):
        fns = preg.get_fns(dataclasses.replace(full_p, family=family))
        assert fns.prefill is (pencdec.prefill if family == "encdec" else ptf.prefill)
    # the hybrid family is served (recurrentgemma, `models.rglru`), and the
    # MoE family by the transformer (test_torch_moe_serve.py)
    assert preg.get_fns(dataclasses.replace(full_p, family="hybrid")).prefill is prglru.prefill
    assert preg.get_fns(dataclasses.replace(full_p, family="moe")).prefill is ptf.prefill


@pytest.mark.parametrize("change,error", [
    ({"cross_attention": True}, ValueError),
    ({"act": "gelu"}, None), ({"rope_theta": 0.0}, None),
    ({"pattern": ("rec", "attn")}, ValueError)])
def test_unported_configs_raise(change, error):
    """The dense transformer computes what the reference's does: the gelu
    MLP (wu, wd with biases, no wg) and sinusoidal positions (rope_theta <=
    0) at the reference's values (test_torch_encdec.py holds them), and
    cross-attention layers (lnx, xattn), whose forward needs the encoder's
    states; a block pattern with recurrent layers is not the dense
    family's (the hybrid family, test_torch_recurrentgemma.py, serves it).
    A sliding window is served: `test_windowed_dense_matches_reference`; so
    is layernorm (phi3.5-moe, test_torch_moe_serve.py)."""
    cfg = dataclasses.replace(preg.reduced(preg.get_config("qwen2-0.5b")), **change)
    if "pattern" in change:
        with pytest.raises(ValueError, match="hybrid"):
            ptf.init(cfg, device="cpu")
        return
    params = ptf.init(cfg, device="cpu")
    layer = params["layers"][0]
    assert ("lnx" in layer and "xattn" in layer) == cfg.cross_attention
    assert set(layer["mlp"]) == ({"wu", "wd"} if cfg.act == "gelu" else {"wg", "wu", "wd"})
    assert ("b" in layer["mlp"]["wu"]) == (cfg.act == "gelu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    if error is not None:
        with pytest.raises(error, match="enc_out"):
            ptf.forward(params, cfg, tokens)
        return
    assert tuple(ptf.forward(params, cfg, tokens).shape) == (1, 4, cfg.vocab)


def test_unported_inputs_raise(model):
    """A prefix and prompt past the cache without a window, which the
    reference writes as a ring, is refused as a prompt past the cache is
    (ROADMAP Queue 3); so is an unknown MLP activation."""
    _, _, pc, pp = model
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="exceeds cache_len"):
        ptf.prefill(pp, pc, tokens, 5, prefix_embeds=torch.zeros(1, 2, pc.d_model))
    with pytest.raises(ValueError, match="act"):
        ptf.forward(pp, dataclasses.replace(pc, act="relu"), tokens)


def test_norm_and_rope_match_reference():
    rs = np_rng(1)
    x = rs.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rs.standard_normal(16).astype(np.float32)
    _close(rL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)),
           pL.rmsnorm({"scale": torch.as_tensor(scale)}, torch.as_tensor(x)),
           "float32", "rmsnorm")
    pos = rs.integers(0, 600, (2, 5))
    _close(rL.rope_freqs(16, 1e6), pL.rope_freqs(16, 1e6), "float32", "freqs")
    # angles up to 600 rad: fp32 cos/sin of large arguments differ by a few ulps
    np.testing.assert_allclose(
        np.asarray(rL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        as_np(pL.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 1e6)),
        atol=1e-4, rtol=0)


def test_attention_layers_match_reference(model):
    rc, rp, pc, pp = model
    dtype = pc.dtype
    rs = np_rng(2)
    B, S, T = 3, 12, 20
    dims_r = rL.AttnDims(rc.d_model, rc.n_heads, rc.n_kv_heads, rc.hd, rc.qkv_bias)
    dims_p = pL.AttnDims(pc.d_model, pc.n_heads, pc.n_kv_heads, pc.hd, pc.qkv_bias)
    lr = jax.tree.map(lambda a: a[0], rp["layers"]["attn"])
    lp = pp["layers"][0]["attn"]
    x = rs.standard_normal((B, S, pc.d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.as_tensor(x).to(getattr(torch, dtype))
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    out_r, (k_r, v_r) = rL.attention_apply(lr, dims_r, xj, xj, pos, pos, rc.rope_theta,
                                           causal=True, window=None)
    out_p, (k_p, v_p) = pL.attention_apply(lp, dims_p, xt, pc.rope_theta)
    _close(out_r, out_p, dtype, "attention_apply")
    _close(np.asarray(k_r, np.float32).transpose(0, 2, 1, 3), k_p, dtype, "k")
    _close(np.asarray(v_r, np.float32).transpose(0, 2, 1, 3), v_p, dtype, "v")

    # decode against a random cache at ragged positions
    ck = rs.standard_normal((B, T, pc.n_kv_heads, pc.hd)).astype(np.float32)
    cv = rs.standard_normal((B, T, pc.n_kv_heads, pc.hd)).astype(np.float32)
    p = np.array([0, 7, T - 1], np.int32)
    x1 = x[:, :1]
    o_r, ck_r, cv_r = rL.attention_decode(
        lr, dims_r, jnp.asarray(x1).astype(dtype), jnp.asarray(ck).astype(dtype),
        jnp.asarray(cv).astype(dtype), jnp.asarray(p), rc.rope_theta, None)
    tt = getattr(torch, dtype)
    ck_t = torch.as_tensor(ck.transpose(0, 2, 1, 3).copy()).to(tt)
    cv_t = torch.as_tensor(cv.transpose(0, 2, 1, 3).copy()).to(tt)
    o_p, ck_p, cv_p = pL.attention_decode(lp, dims_p, torch.as_tensor(x1).to(tt),
                                          ck_t, cv_t, torch.as_tensor(p), pc.rope_theta)
    assert ck_p is ck_t                                 # written in place
    _close(o_r, o_p, dtype, "attention_decode")
    _close(np.asarray(ck_r, np.float32).transpose(0, 2, 1, 3), ck_p, dtype, "cache k")
    _close(np.asarray(cv_r, np.float32).transpose(0, 2, 1, 3), cv_p, dtype, "cache v")


def test_prefill_and_decode_match_reference(model):
    """Prefill logits and cache, then 8 teacher-forced decode steps."""
    rc, rp, pc, pp = model
    dtype = pc.dtype
    rs = np_rng(3)
    B, S, cache_len = 3, 24, 40
    toks = rs.integers(0, pc.vocab, (B, S))
    _close(rtf.forward(rp, rc, jnp.asarray(toks))[0],
           ptf.forward(pp, pc, torch.as_tensor(toks)), dtype, "forward")
    lr, cr, pos_r = rtf.prefill(rp, rc, jnp.asarray(toks), cache_len)
    lp, cp, pos_p = ptf.prefill(pp, pc, torch.as_tensor(toks), cache_len)
    _close(lr, lp, dtype, "prefill logits")
    assert_same(pos_r, pos_p, "next pos")
    for name in ("k", "v"):
        _close(np.asarray(cr[name], np.float32).transpose(0, 1, 3, 2, 4),
               cp[name], dtype, f"prefill cache {name}")
    forced = rs.integers(0, pc.vocab, (B, 8))
    for i in range(8):
        lr, cr, pos_r = rtf.decode_step(rp, rc, jnp.asarray(forced[:, i], jnp.int32),
                                        cr, pos_r)
        lp, cp, pos_p = ptf.decode_step(pp, pc, torch.as_tensor(forced[:, i]), cp, pos_p)
        _close(lr, lp, dtype, f"decode step {i} logits")
        assert_same(pos_r, pos_p, f"decode step {i} pos")
    for name in ("k", "v"):
        _close(np.asarray(cr[name], np.float32).transpose(0, 1, 3, 2, 4),
               cp[name], dtype, f"decoded cache {name}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_windowed_dense_matches_reference(dtype):
    """The dense transformer with a sliding window of 16 and cache_len 40,
    so a ring of T = 16 slots: prefill of 24 tokens (past the window: the
    ring keeps the last 16, position p at slot p % 16) and 12 teacher-forced
    decode steps (positions 24..35) against the reference, logits and ring
    caches after each."""
    rc = dataclasses.replace(rreg.reduced(rreg.get_config("qwen2-0.5b")), dtype=dtype,
                             window=16)
    pc = dataclasses.replace(preg.reduced(preg.get_config("qwen2-0.5b")), dtype=dtype,
                             window=16)
    rp = rtf.init(jax.random.PRNGKey(1), rc)
    pp = convert.lm_params(pc, jax.tree.map(np.asarray, rp))
    rs = np_rng(13)
    B, S, cache_len = 3, 24, 40
    toks = rs.integers(0, pc.vocab, (B, S))
    _close(rtf.forward(rp, rc, jnp.asarray(toks))[0],
           ptf.forward(pp, pc, torch.as_tensor(toks)), dtype, "forward")
    lr, cr, pos_r = rtf.prefill(rp, rc, jnp.asarray(toks), cache_len)
    lp, cp, pos_p = ptf.prefill(pp, pc, torch.as_tensor(toks), cache_len)
    assert tuple(cp["k"].shape) == (pc.n_layers, B, pc.n_kv_heads, 16, pc.hd)
    _close(lr, lp, dtype, "prefill logits")
    forced = rs.integers(0, pc.vocab, (B, 12))
    for i in range(12):
        for name in ("k", "v"):
            _close(np.asarray(cr[name], np.float32).transpose(0, 1, 3, 2, 4),
                   cp[name], dtype, f"ring {name} before step {i}")
        lr, cr, pos_r = rtf.decode_step(rp, rc, jnp.asarray(forced[:, i], jnp.int32),
                                        cr, pos_r)
        lp, cp, pos_p = ptf.decode_step(pp, pc, torch.as_tensor(forced[:, i]), cp, pos_p)
        _close(lr, lp, dtype, f"decode step {i} logits")
        assert_same(pos_r, pos_p, f"decode step {i} pos")


def test_serve_requests_token_equal_in_fp32():
    """Token equality is asserted in fp32: in bf16 a near-tie may flip."""
    rc, rp, pc, pp = _model("float32")
    sc_r = rserve.ServeConfig(max_new_tokens=10, prompt_len=12, cache_len=30, eos_id=1)
    sc_p = pserve.ServeConfig(**dataclasses.asdict(sc_r))
    prompts = np_rng(4).integers(0, pc.vocab, (4, 12))
    out_r, info_r = rserve.serve_requests(rc, rp, sc_r, prompts)
    out_p, info_p = pserve.serve_requests(pc, pp, sc_p, prompts, device="cpu")
    assert_same(out_r, out_p, "served tokens")
    assert info_r == info_p


def _queues(rs, S=6, slots=10, w=3):
    items = rs.integers(0, 1000, (S, slots, w)).astype(np.int32)
    valid = rs.random((S, slots)) < rs.random((S, 1))     # skewed fill per shard
    cost = rs.integers(1, 40, (S, slots)).astype(np.int32)
    return items, valid, cost


@pytest.mark.parametrize("rounds,max_items", [(1, 8), (3, 4), (2, 16)])
def test_rebalance_reference_exact(rounds, max_items):
    rs = np_rng(10 + rounds)
    for _ in range(5):
        items, valid, cost = _queues(rs)
        want = rbal.rebalance_reference(jnp.asarray(items), jnp.asarray(valid),
                                        jnp.asarray(cost), rounds=rounds,
                                        max_items=max_items)
        got = pbal.rebalance_reference(torch.as_tensor(items), torch.as_tensor(valid),
                                       torch.as_tensor(cost), rounds=rounds,
                                       max_items=max_items)
        for a, b, name in zip(want, got, ("items", "valid", "cost", "dropped")):
            assert_same(np.asarray(a).astype(np.int64), as_np(b).astype(np.int64), name)


def test_queue_steps_exact_on_one_shard():
    rs = np_rng(12)
    items, valid, cost = _queues(rs, S=1)
    rq = rbal.make_queue(items[0], valid[0], cost[0])
    pq = pbal.make_queue(items[0], valid[0], cost[0])
    assert int(rbal.load_of(rq)) == int(pbal.load_of(pq))
    assert_same(rbal._compact_indices(rq.valid), pbal._compact_indices(pq.valid))
    for want_cost, max_count in ((30, None), (100, 2), (0, 5)):
        want = rbal.select_donations(rq, want_cost, 4, max_count)
        got = pbal.select_donations(pq, want_cost, 4, max_count)
        for a, b in zip(want, got):
            assert_same(np.asarray(a).astype(np.int64), as_np(b).astype(np.int64))
    recs, rvalid, rcost, _ = rbal.select_donations(rq, 60, 4)
    q2r, d_r = rbal.insert_items(rq, recs, rvalid, rcost)
    q2p, d_p = pbal.insert_items(pq, *(torch.as_tensor(np.array(a))
                                       for a in (recs, rvalid, rcost)))
    assert int(d_r) == int(d_p)
    for a, b in zip(q2r, q2p):
        assert_same(np.asarray(a).astype(np.int64), as_np(b).astype(np.int64))


@pytest.mark.parametrize("rebalance,every,slots", [(True, 4, 8), (True, 2, 4),
                                                   (False, 4, 8)])
def test_simulate_serving_exact(rebalance, every, slots):
    rng = np.random.default_rng(0)
    lens = np.minimum((rng.pareto(1.2, (4, slots * 4)) * 16 + 4), 64).astype(np.int32)
    sc = rserve.ServeConfig(batch_slots=slots, rebalance=rebalance,
                            rebalance_every=every)
    want = rserve.simulate_serving(None, sc, lens)
    got = pserve.simulate_serving(None, pserve.ServeConfig(**dataclasses.asdict(sc)),
                                  lens, device="cpu")
    assert dataclasses.asdict(want) == dataclasses.asdict(got)
    assert got.completed == int((lens > 0).sum())


def test_launch_serve_runs_on_the_cpu():
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen2-0.5b",
         "--reduced", "--device", "cpu", "--max-new", "6"],
        capture_output=True, text=True, env=env, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("[serve] decoded 48 tokens")
    assert lines[-1].startswith("[serve] occupancy=0.727 moved=30 steps=151 completed=128")


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, model):
    _, _, pc, pp = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ptf.init(pc)
    with pytest.raises(RuntimeError, match="CUDA"):
        pserve.serve_requests(pc, pp, pserve.ServeConfig(), np.zeros((1, 4), np.int64))
    with pytest.raises(RuntimeError, match="CUDA"):
        pserve.simulate_serving(None, pserve.ServeConfig(), np.ones((2, 8), np.int32))


def test_make_cache_defaults_to_cuda_and_builds_on_the_cpu(monkeypatch):
    """`make_cache` resolves device=None as `init` does: to the card, so it
    raises where there is none; on device="cpu" it builds zeros of the
    ring's shape."""
    pc = preg.reduced(preg.get_config("qwen2-0.5b"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ptf.make_cache(pc, 2, 40)
    cache = ptf.make_cache(pc, 2, 40, device="cpu")
    shape = (pc.n_layers, 2, pc.n_kv_heads, pL.ring_len(40, pc.window), pc.hd)
    for leaf in cache.values():
        assert leaf.device.type == "cpu" and tuple(leaf.shape) == shape
        assert leaf.dtype == pL.dtype_of(pc.dtype) and not leaf.any()


def test_init_matches_reference_structure_and_scale():
    """`init` draws the reference's distributions with torch's generator:
    same tree, shapes and types, and normal(0, 0.02) weights."""
    pc = preg.reduced(preg.get_config("qwen2-0.5b"))
    rc = rreg.reduced(rreg.get_config("qwen2-0.5b"))
    pp = ptf.init(pc, seed=0, device="cpu")
    ref_shapes = convert.lm_params(pc, jax.tree.map(np.asarray, rtf.init(
        jax.random.PRNGKey(0), rc)))
    assert (jax.tree.map(lambda t: (tuple(t.shape), t.dtype), ref_shapes)
            == jax.tree.map(lambda t: (tuple(t.shape), t.dtype), pp))
    w = torch.cat([pp["embed"]["table"].float().flatten()]
                  + [lp["mlp"]["wd"]["w"].float().flatten() for lp in pp["layers"]])
    assert abs(float(w.std()) - 0.02) < 1e-3 and abs(float(w.mean())) < 1e-3
    assert torch.all(pp["layers"][0]["attn"]["wq"]["b"] == 0)
    assert torch.all(pp["final_norm"]["scale"] == 1)
    assert torch.equal(ptf.init(pc, seed=0, device="cpu")["embed"]["table"],
                       pp["embed"]["table"])
