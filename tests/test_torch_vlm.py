"""Port parity of the VLM family (llava-next-mistral-7b): `repro_torch` on
the CPU against `repro.models.transformer` with `prefix_embeds` at the
reduced config (`registry.reduced`: 2 layers, d 64, GQA 4 over 2 KV heads,
16 prefix embeddings), with the reference's own weights carried across by
`convert.lm_params` and inputs made with numpy from a seed. On the CPU the
attention kernels run their plain versions.

Covered: teacher-forced logits over the prefix and the text, `prefill`
(logits, the k/v caches permuted to the reference's layout, next_pos = P +
S) and 8 decode steps; the reference's decode-equals-teacher-forcing
check on the port; `loss_fn` (over the text's logits, `logits[:, P:]`)
and every gradient leaf; `_make_batch`'s `prefix_embeds` and a 3-step
`train` history; a prefill whose prefix and prompt overflow the cache,
which the port refuses (ROADMAP Queue 3).

Tolerances: test_torch_serve.py's `TOL` (fp32 atol = rtol = 1e-5; bf16
atol 2e-2), test_torch_train.py's LOSS_RTOL 1e-5 and GRAD_RTOL 2e-5 (of
each leaf's largest magnitude), the prefix within 4 ulps, the history at
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
from repro.models import registry as rreg
from repro.models import transformer as rtf
from repro.optim import adamw as radam
from repro.runtime import train_loop as rtl
from repro_torch import convert
from repro_torch.data import synthetic as psyn
from repro_torch.models import registry as preg
from repro_torch.models import transformer as ptf
from repro_torch.optim import adamw as padam
from repro_torch.runtime import train_loop as ptl

torch.set_num_threads(1)
ARCH = "llava-next-mistral-7b"
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=0)}
DTYPES = ["float32", "bfloat16"]
LOSS_RTOL, GRAD_RTOL = 1e-5, 2e-5
HIST_TOL = {"lr": 2e-6, "grad_norm": 1e-3}
OPT = dict(lr_peak=3e-3, warmup_steps=2, total_steps=3)
DATA = dict(seq_len=32, global_batch=4)


def _close(want, got, dtype, what=""):
    np.testing.assert_allclose(np.asarray(want, np.float32), as_np(got.float()),
                               err_msg=what, **TOL[dtype])


@functools.lru_cache(maxsize=None)
def _model(dtype: str):
    """(reference cfg, reference params, port cfg, port params)."""
    rc = dataclasses.replace(rreg.reduced(rreg.get_config(ARCH)), dtype=dtype)
    pc = dataclasses.replace(preg.reduced(preg.get_config(ARCH)), dtype=dtype)
    assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
    rp = rtf.init(jax.random.PRNGKey(0), rc)
    pp = convert.lm_params(pc, jax.tree.map(np.asarray, rp))
    return rc, rp, pc, pp


@pytest.fixture(params=DTYPES)
def model(request):
    return _model(request.param)


def _inputs(pc, seed=0, B=2, S=10):
    """(tokens (B, S) int, prefix embeddings (B, P, D) fp32) from a numpy
    seed."""
    rs = np_rng(seed)
    toks = rs.integers(0, pc.vocab, (B, S))
    prefix = (rs.standard_normal((B, pc.n_frontend_tokens, pc.d_model)) * 0.5
              ).astype(np.float32)
    return toks, prefix


def test_config_and_family_fns():
    rc, pc = rreg.get_config(ARCH), preg.get_config(ARCH)
    assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
    assert pc.n_params() == rc.n_params()
    fns = preg.get_fns(pc)
    assert (fns.init, fns.loss_fn, fns.prefill, fns.decode_step) == (
        ptf.init, ptf.loss_fn, ptf.prefill, ptf.decode_step)


def test_logits_with_prefix_match_reference(model):
    rc, rp, pc, pp = model
    toks, prefix = _inputs(pc, seed=1)
    want, _, _ = rtf.forward(rp, rc, jnp.asarray(toks), prefix_embeds=jnp.asarray(prefix))
    got = ptf.forward(pp, pc, torch.as_tensor(toks), prefix_embeds=torch.as_tensor(prefix))
    assert tuple(got.shape) == (2, pc.n_frontend_tokens + toks.shape[1], pc.vocab)
    _close(want, got, pc.dtype, "teacher-forced logits")


def test_prefill_and_decode_match_reference(model):
    """Prefill logits, caches and next_pos = P + S, then 8 teacher-forced
    decode steps (logits, and the caches after them)."""
    rc, rp, pc, pp = model
    toks, prefix = _inputs(pc, seed=2)
    B, S, cache_len = toks.shape[0], toks.shape[1], 40
    lr, cr, pos_r = rtf.prefill(rp, rc, jnp.asarray(toks), cache_len,
                                prefix_embeds=jnp.asarray(prefix))
    lp, cp, pos_p = ptf.prefill(pp, pc, torch.as_tensor(toks), cache_len,
                                prefix_embeds=torch.as_tensor(prefix))
    _close(lr, lp, pc.dtype, "prefill logits")
    for k in ("k", "v"):
        _close(cr[k], cp[k].float().transpose(2, 3), pc.dtype, f"prefill {k}")
    assert_same(pos_r, pos_p, "next_pos")
    assert int(pos_p[0]) == pc.n_frontend_tokens + S
    feed = np_rng(3).integers(0, pc.vocab, (8, B))
    for i, tok in enumerate(feed):
        lr, cr, pos_r = rtf.decode_step(rp, rc, jnp.asarray(tok), cr, pos_r)
        lp, cp, pos_p = ptf.decode_step(pp, pc, torch.as_tensor(tok), cp, pos_p)
        _close(lr, lp, pc.dtype, f"decode step {i}")
    for k in ("k", "v"):
        _close(cr[k], cp[k].float().transpose(2, 3), pc.dtype, f"cache {k}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_matches_teacher_forcing(dtype):
    """The reference's check (tests/test_models.py), on the port with a
    prefix: decode at text position S gives the teacher-forced logits
    there."""
    _, _, pc, pp = _model(dtype)
    toks, prefix = _inputs(pc, seed=4, S=11)
    S = toks.shape[1] - 1
    toks_t, prefix_t = torch.as_tensor(toks), torch.as_tensor(prefix)
    _, cache, pos = ptf.prefill(pp, pc, toks_t[:, :S], 32, prefix_embeds=prefix_t)
    lg_dec, _, _ = ptf.decode_step(pp, pc, toks_t[:, S], cache, pos)
    full = ptf.forward(pp, pc, toks_t, prefix_embeds=prefix_t)
    np.testing.assert_allclose(as_np(lg_dec.float()), as_np(full[:, -1].float()),
                               **TOL[dtype])


def test_loss_and_grads_match_reference():
    rc, rp, pc, _ = _model("float32")
    toks, prefix = _inputs(pc, seed=5, S=16)
    mask = (np_rng(6).random(toks.shape) > 0.3).astype(np.float32)
    batch = {"tokens": toks.astype(np.int32), "prefix_embeds": prefix, "loss_mask": mask}
    (loss_r, _), g_r = jax.value_and_grad(
        lambda p: rtf.loss_fn(p, rc, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(rp)
    params = convert.master_params(pc, jax.tree.map(np.asarray, rp))
    loss, metrics, grads = ptl.loss_and_grads(
        preg.get_fns(pc), pc, params, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["xent"]), float(loss_r), rtol=LOSS_RTOL)
    want = convert.master_params(pc, jax.tree.map(np.asarray, g_r))
    for i, (a, b) in enumerate(zip(padam.leaves(want), padam.leaves(grads))):
        err, scale = float((a - b).abs().max()), float(a.abs().max())
        assert err <= GRAD_RTOL * scale + 1e-30, (i, tuple(a.shape), err, scale)


def test_make_batch_prefix_and_history_match_reference():
    """`_make_batch`'s prefix embeddings within 4 ulps of the reference's
    draw, and a 3-step `train` from the reference's initial state against
    the reference's history."""
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
        a = np.asarray(want["prefix_embeds"]).view(np.int32).astype(np.int64)
        b = as_np(got["prefix_embeds"]).view(np.int32).astype(np.int64)
        assert a.shape == b.shape and int(np.abs(a - b).max()) <= 4
    tc = dict(steps=3, log_every=1)
    params = rtf.init(jax.random.PRNGKey(0), rc)
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


def test_prefix_and_prompt_past_the_cache_raise():
    """P + S past cache_len without a window: the reference writes the
    positions as a ring and decodes over it; the port refuses, as it
    refuses a prompt longer than the cache (ROADMAP Queue 3)."""
    _, _, pc, pp = _model("float32")
    toks, prefix = _inputs(pc, seed=7, S=10)
    P = pc.n_frontend_tokens
    ptf.prefill(pp, pc, torch.as_tensor(toks), P + 10, prefix_embeds=torch.as_tensor(prefix))
    with pytest.raises(ValueError, match="exceeds cache_len"):
        ptf.prefill(pp, pc, torch.as_tensor(toks), P + 9,
                    prefix_embeds=torch.as_tensor(prefix))
