"""Port parity of the encoder-decoder family (whisper-tiny): `repro_torch`
on the CPU against `repro.models.encdec` / `repro.models.transformer` at
the reduced config (`registry.reduced`: 2 encoder and 2 decoder layers,
d 64, 16 frames), with the reference's own weights carried across by
`convert.lm_params` and inputs made with numpy from a seed. On the CPU the
attention kernels run their plain versions.

Covered: `sinusoidal_positions` bit-equal; the gelu MLP, cross-attention
prefill (`attention_apply` with `kv_x`, not causal, no RoPE) and its
decode step (`cross_attention_decode`), `encode`, teacher-forced logits,
`prefill` (logits and the k/v/xk/xv caches, the port's (L, B, KV, T, hd)
permuted to the reference's (L, B, T, KV, hd)) and 8 decode steps; the
reference's decode-equals-teacher-forcing check on the port; `loss_fn`
and every gradient leaf; `_make_batch`'s frames and a 3-step `train`
history; a prefill without frames, which the reference's serving loop
makes (ROADMAP Queue 3).

Tolerances: test_torch_serve.py's `TOL` (fp32 atol = rtol = 1e-5; bf16
atol 2e-2), test_torch_train.py's LOSS_RTOL 1e-5 and GRAD_RTOL 2e-5 (of
each leaf's largest magnitude; a leaf whose gradient is zero in exact
arithmetic — a key bias without RoPE, which softmax cancels — against the
largest of the tree's), the frames within 4 ulps, the history at
test_torch_train_loop.py's tolerances.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, assert_same, np_rng
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.data import synthetic as rsyn
from repro.models import encdec as renc
from repro.models import layers as rL
from repro.models import registry as rreg
from repro.models import transformer as rtf
from repro.optim import adamw as radam
from repro.runtime import serve_loop as rserve
from repro.runtime import train_loop as rtl
from repro_torch import convert
from repro_torch.data import synthetic as psyn
from repro_torch.models import encdec as penc
from repro_torch.models import layers as pL
from repro_torch.models import registry as preg
from repro_torch.models import transformer as ptf
from repro_torch.optim import adamw as padam
from repro_torch.runtime import serve_loop as pserve
from repro_torch.runtime import train_loop as ptl

torch.set_num_threads(1)
ARCH = "whisper-tiny"
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=0)}
DTYPES = ["float32", "bfloat16"]
LOSS_RTOL, GRAD_RTOL = 1e-5, 2e-5
HIST_TOL = {"lr": 2e-6, "grad_norm": 1e-3}
OPT = dict(lr_peak=3e-3, warmup_steps=2, total_steps=3)
DATA = dict(seq_len=32, global_batch=4)


def _close(want, got, dtype, what=""):
    np.testing.assert_allclose(np.asarray(want, np.float32), as_np(got.float()),
                               err_msg=what, **TOL[dtype])


def _ref_cache(t):
    """A port cache leaf (L, B, KV, T, hd) in the reference's layout."""
    return as_np(t.float()).transpose(0, 1, 3, 2, 4)


@functools.lru_cache(maxsize=None)
def _model(dtype: str):
    """(reference cfg, reference params, port cfg, port params)."""
    rc = dataclasses.replace(rreg.reduced(rreg.get_config(ARCH)), dtype=dtype)
    pc = dataclasses.replace(preg.reduced(preg.get_config(ARCH)), dtype=dtype)
    assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
    rp = renc.init(jax.random.PRNGKey(0), rc)
    pp = convert.lm_params(pc, jax.tree.map(np.asarray, rp))
    return rc, rp, pc, pp


@pytest.fixture(params=DTYPES)
def model(request):
    return _model(request.param)


def _named(tree, prefix=""):
    """(path, leaf) of every tensor of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _inputs(pc, seed=0, B=2, S=10):
    """(tokens (B, S) int, frames (B, F, D) fp32) from a numpy seed."""
    rs = np_rng(seed)
    toks = rs.integers(0, pc.vocab, (B, S))
    frames = (rs.standard_normal((B, pc.n_frontend_tokens, pc.d_model)) * 0.5
              ).astype(np.float32)
    return toks, frames


def test_config_and_family_fns():
    rc, pc = rreg.get_config(ARCH), preg.get_config(ARCH)
    assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
    assert pc.n_params() == rc.n_params()
    fns = preg.get_fns(pc)
    assert (fns.init, fns.loss_fn, fns.prefill, fns.decode_step) == (
        penc.init, penc.loss_fn, penc.prefill, penc.decode_step)


@pytest.mark.parametrize("n,d", [(16, 64), (448, 384), (1500, 384), (8192, 384)])
def test_sinusoidal_positions_bit_equal(n, d):
    assert_same(rL.sinusoidal_positions(n, d), pL.sinusoidal_positions(n, d),
                f"sinusoidal_positions({n}, {d})")


def test_init_tree_matches_reference():
    """The port's own init has the reference's leaves (the encoder's list of
    layers against its stacked ones), shapes and storage types."""
    rc, rp, pc, _ = _model("bfloat16")
    mine = penc.init(pc, device="cpu")
    want = convert.lm_params(pc, jax.tree.map(np.asarray, rp))
    flat_w, flat_m = dict(_named(want)), dict(_named(mine))
    assert flat_w.keys() == flat_m.keys()
    for k, w in flat_w.items():
        assert (tuple(w.shape), w.dtype) == (tuple(flat_m[k].shape), flat_m[k].dtype), k
    assert "wg" not in mine["decoder"]["layers"][0]["mlp"]
    assert set(mine["decoder"]["layers"][0]) >= {"lnx", "xattn"}


def test_gelu_mlp_and_cross_attention_match_reference(model):
    rc, rp, pc, pp = model
    dtype = pc.dtype
    tt = getattr(torch, dtype)
    rs = np_rng(3)
    B, S, F = 2, 7, pc.n_frontend_tokens
    x = rs.standard_normal((B, S, pc.d_model)).astype(np.float32)
    enc = rs.standard_normal((B, F, pc.d_model)).astype(np.float32)
    xj, encj = jnp.asarray(x).astype(dtype), jnp.asarray(enc).astype(dtype)
    xt, enct = torch.as_tensor(x).to(tt), torch.as_tensor(enc).to(tt)
    for stack in ("encoder", "decoder"):
        lr = jax.tree.map(lambda a: a[0], rp[stack]["layers"]["mlp"])
        _close(rL.mlp_apply(lr, xj, "gelu"),
               pL.mlp_apply(pp[stack]["layers"][0]["mlp"], xt, "gelu"), dtype,
               f"{stack} gelu mlp")
    dims_r = rL.AttnDims(rc.d_model, rc.n_heads, rc.n_kv_heads, rc.hd, rc.qkv_bias)
    dims_p = pL.AttnDims(pc.d_model, pc.n_heads, pc.n_kv_heads, pc.hd, pc.qkv_bias)
    lr = jax.tree.map(lambda a: a[0], rp["decoder"]["layers"]["xattn"])
    lp = pp["decoder"]["layers"][0]["xattn"]
    qpos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    kpos = jnp.broadcast_to(jnp.arange(F)[None], (B, F))
    out_r, (k_r, v_r) = rL.attention_apply(lr, dims_r, xj, encj, qpos, kpos, None,
                                           causal=False, window=None)
    out_p, (k_p, v_p) = pL.attention_apply(lp, dims_p, xt, None, causal=False, kv_x=enct)
    _close(out_r, out_p, dtype, "cross attention_apply")
    _close(np.asarray(k_r, np.float32).transpose(0, 2, 1, 3), k_p, dtype, "xk")
    _close(np.asarray(v_r, np.float32).transpose(0, 2, 1, 3), v_p, dtype, "xv")
    # one decode step's cross-attention, as the reference's decode_step does it
    x1 = xj[:, :1]
    qg = rL.dense(lr["wq"], x1).reshape(B, 1, rc.n_heads, rc.hd)
    o = rL.mha(qg, k_r, v_r, jnp.zeros((B, 1), jnp.int32), kpos, causal=False)
    want = rL.dense(lr["wo"], o.reshape(B, 1, -1))
    _close(want, pL.cross_attention_decode(lp, dims_p, xt[:, :1], k_p, v_p), dtype,
           "cross_attention_decode")


def test_encode_and_logits_match_reference(model):
    rc, rp, pc, pp = model
    toks, frames = _inputs(pc, seed=4)
    enc_r = renc.encode(rp, rc, jnp.asarray(frames))
    enc_p = penc.encode(pp, pc, torch.as_tensor(frames))
    _close(enc_r, enc_p, pc.dtype, "encode")
    lr, _, _ = rtf.forward(rp["decoder"], rc, jnp.asarray(toks), enc_out=enc_r)
    _close(lr, ptf.forward(pp["decoder"], pc, torch.as_tensor(toks), enc_out=enc_p),
           pc.dtype, "teacher-forced logits")


def test_prefill_and_decode_match_reference(model):
    """Prefill logits and the four caches, then 8 teacher-forced decode
    steps (logits, and the caches after them)."""
    rc, rp, pc, pp = model
    toks, frames = _inputs(pc, seed=5)
    B, S, cache_len = toks.shape[0], toks.shape[1], 24
    lr, cr, pos_r = renc.prefill(rp, rc, jnp.asarray(toks), cache_len,
                                 frames=jnp.asarray(frames))
    lp, cp, pos_p = penc.prefill(pp, pc, torch.as_tensor(toks), cache_len,
                                 frames=torch.as_tensor(frames))
    assert set(cp) == set(cr) == {"k", "v", "xk", "xv"}
    _close(lr, lp, pc.dtype, "prefill logits")
    for k in cr:
        _close(cr[k], torch.as_tensor(_ref_cache(cp[k])), pc.dtype, f"prefill {k}")
    assert_same(pos_r, pos_p, "next_pos")
    feed = np_rng(6).integers(0, pc.vocab, (8, B))
    for i, tok in enumerate(feed):
        lr, cr, pos_r = renc.decode_step(rp, rc, jnp.asarray(tok), cr, pos_r)
        lp, cp, pos_p = penc.decode_step(pp, pc, torch.as_tensor(tok), cp, pos_p)
        _close(lr, lp, pc.dtype, f"decode step {i}")
    for k in cr:
        _close(cr[k], torch.as_tensor(_ref_cache(cp[k])), pc.dtype, f"cache {k}")
    assert_same(pos_r, pos_p, "pos")


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_matches_teacher_forcing(dtype):
    """The reference's check (tests/test_models.py), on the port: decode at
    position S gives the teacher-forced logits at S."""
    _, _, pc, pp = _model(dtype)
    toks, frames = _inputs(pc, seed=7, S=11)
    S = toks.shape[1] - 1
    toks_t, frames_t = torch.as_tensor(toks), torch.as_tensor(frames)
    _, cache, pos = penc.prefill(pp, pc, toks_t[:, :S], 32, frames=frames_t)
    lg_dec, _, _ = penc.decode_step(pp, pc, toks_t[:, S], cache, pos)
    full = ptf.forward(pp["decoder"], pc, toks_t, enc_out=penc.encode(pp, pc, frames_t))
    np.testing.assert_allclose(as_np(lg_dec.float()), as_np(full[:, S].float()),
                               **TOL[dtype])


def _grads_close(want, got):
    big = max(float(a.abs().max()) for a in padam.leaves(want))
    for (path, a), b in zip(_named(want), padam.leaves(got)):
        scale = big if "wk/b" in path else float(a.abs().max())
        err = float((a - b).abs().max())
        assert err <= GRAD_RTOL * scale + 1e-30, (path, err, scale)


def test_loss_and_grads_match_reference():
    rc, rp, pc, _ = _model("float32")
    toks, frames = _inputs(pc, seed=8, S=16)
    mask = (np_rng(9).random(toks.shape) > 0.3).astype(np.float32)
    batch = {"tokens": toks.astype(np.int32), "frames": frames, "loss_mask": mask}
    (loss_r, _), g_r = jax.value_and_grad(
        lambda p: renc.loss_fn(p, rc, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(rp)
    params = convert.master_params(pc, jax.tree.map(np.asarray, rp))
    loss, metrics, grads = ptl.loss_and_grads(
        preg.get_fns(pc), pc, params, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["xent"]), float(loss_r), rtol=LOSS_RTOL)
    _grads_close(convert.master_params(pc, jax.tree.map(np.asarray, g_r)), grads)


def test_make_batch_frames_and_history_match_reference():
    """`_make_batch`'s frames within 4 ulps of the reference's draw, and a
    3-step `train` from the reference's initial state against the
    reference's history."""
    rc = dataclasses.replace(rreg.reduced(rreg.get_config(ARCH), d_model=48),
                             dtype="float32")
    pc = dataclasses.replace(preg.reduced(preg.get_config(ARCH), d_model=48),
                             dtype="float32")
    for step in (0, 2):
        want = rtl._make_batch(rc, rsyn.DataConfig(vocab=rc.vocab, **DATA), step,
                               rtl.TrainConfig())
        got = ptl._make_batch(pc, psyn.DataConfig(vocab=pc.vocab, **DATA), step,
                              ptl.TrainConfig())
        assert_same(want["tokens"], got["tokens"].int(), "tokens")
        a = np.asarray(want["frames"]).view(np.int32).astype(np.int64)
        b = as_np(got["frames"]).view(np.int32).astype(np.int64)
        assert a.shape == b.shape and int(np.abs(a - b).max()) <= 4
    tc = dict(steps=3, log_every=1)
    params = renc.init(jax.random.PRNGKey(0), rc)
    opt = jax.tree.map(np.asarray, radam.init(params))
    state = (convert.master_params(pc, jax.tree.map(np.asarray, params)),
             convert.adamw_state(pc, opt.m, opt.v, opt.count))
    _, want = rtl.train(ARCH, rtl.TrainConfig(**tc), radam.AdamWConfig(**OPT),
                        rsyn.DataConfig(vocab=rc.vocab, **DATA), model_cfg=rc)
    _, got = ptl.train(ARCH, ptl.TrainConfig(**tc), padam.AdamWConfig(**OPT),
                       psyn.DataConfig(vocab=pc.vocab, **DATA), model_cfg=pc,
                       device="cpu", init_state=state)
    assert [h["step"] for h in got] == [h["step"] for h in want] == [0, 1, 2]
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=HIST_TOL.get(k, 1e-4),
                                       err_msg=f"step {w['step']} {k}")


def test_prefill_needs_frames():
    """The reference's serving loop calls `prefill` without frames, where
    its encoder fails on None (ROADMAP Queue 3); the port's prefill refuses
    a missing `frames` by name, and so its `serve_requests` does."""
    rc, rp, pc, pp = _model("float32")
    toks = np_rng(10).integers(0, pc.vocab, (2, 6))
    with pytest.raises(AttributeError):
        rserve.serve_requests(rc, rp, rserve.ServeConfig(max_new_tokens=2, prompt_len=6,
                                                         cache_len=16), toks)
    with pytest.raises(ValueError, match="frames"):
        penc.prefill(pp, pc, torch.as_tensor(toks), 16)
    with pytest.raises(ValueError, match="frames"):
        pserve.serve_requests(pc, pp, pserve.ServeConfig(max_new_tokens=2, prompt_len=6,
                                                         cache_len=16),
                              torch.as_tensor(toks), device="cpu")
    with pytest.raises(ValueError, match="enc_out"):
        ptf.prefill(pp["decoder"], pc, torch.as_tensor(toks), 16)
