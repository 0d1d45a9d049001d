"""Port parity of the training driver: `repro_torch.runtime.train_loop.train`
from the reference's own initial state (`convert.master_params`,
`convert.adamw_state`) against `repro.runtime.train_loop.train`, step by
step through `history` (every metric key), on the CPU at the reduced
qwen2-0.5b and qwen2-moe configs in fp32; restart from a checkpoint; the
neighbor-steal batch balance; the launcher; the families not ported yet.

Tolerances (fp32, 5 steps): the learning rate within rtol 2e-6 (`cos` and
`pow` of another library); the loss, cross entropy and MoE metrics within
rtol 1e-4 and the gradient norm within 1e-3 — the gradients agree to ~1e-6
of each leaf, and AdamW's normalised step turns a last-bit difference of a
gradient within a few eps of 0 into a share of lr for that weight, which
the next steps' losses carry. A run cut after its mid-run checkpoint and
restarted is held to the reference's run cut and restarted the same way
(the reference's labels: the restart runs the checkpoint's step again).
"""

import dataclasses
import io
import shutil
import threading
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.checkpoint import checkpointer as rckpt
from repro.data import synthetic as rsyn
from repro.models import registry as rreg
from repro.optim import adamw as radam
from repro.runtime import train_loop as rtl
from repro_torch import convert
from repro_torch.data import synthetic as psyn
from repro_torch.launch import train as launcher
from repro_torch.models import registry as preg
from repro_torch.optim import adamw as padam
from repro_torch.runtime import train_loop as ptl

torch.set_num_threads(1)
STEPS = 5
OPT = dict(lr_peak=3e-3, warmup_steps=2, total_steps=STEPS)
DATA = dict(seq_len=32, global_batch=8)
TOL = {"lr": 2e-6, "grad_norm": 1e-3}
# parameters after 5 AdamW updates: each update moves a weight by about lr
# or less, and a gradient within a few eps of 0 whose last bits differ can
# change a weight's step by a share of lr (see above): 1% of lr_peak
PARAM_ATOL = 1e-2 * OPT["lr_peak"]


def _cfgs(arch: str, d_model: int = 48):
    rc = dataclasses.replace(rreg.reduced(rreg.get_config(arch), d_model=d_model),
                             dtype="float32")
    pc = dataclasses.replace(preg.reduced(preg.get_config(arch), d_model=d_model),
                             dtype="float32")
    return rc, pc


def _port_state(arch: str, pc):
    """The reference `train`'s initial state (seed 0) as the port's."""
    rc = _cfgs(arch, pc.d_model)[0]
    params = rreg.get_fns(rc).init(jax.random.PRNGKey(0), rc)
    opt = jax.tree.map(np.asarray, radam.init(params))
    params = jax.tree.map(np.asarray, params)
    return (convert.master_params(pc, params),
            convert.adamw_state(pc, opt.m, opt.v, opt.count))


def _port_train(arch, pc, tc, **kw):
    return ptl.train(arch, tc, padam.AdamWConfig(**OPT),
                     psyn.DataConfig(vocab=pc.vocab, **DATA), model_cfg=pc,
                     device="cpu", init_state=_port_state(arch, pc), **kw)


@pytest.mark.parametrize("arch,fields", [
    ("qwen2-0.5b", dict()),
    ("qwen2-0.5b", dict(balance_tokens=True)),
    ("qwen2-0.5b", dict(num_microbatches=2, remat="full")),
    ("qwen2-moe-a2.7b", dict(balance_tokens=True))])
def test_history_matches_reference(arch, fields):
    rc, pc = _cfgs(arch)
    tc = dict(steps=STEPS, log_every=1, **fields)
    _, want = rtl.train(arch, rtl.TrainConfig(**tc), radam.AdamWConfig(**OPT),
                        rsyn.DataConfig(vocab=rc.vocab, **DATA), model_cfg=rc)
    _, got = _port_train(arch, pc, ptl.TrainConfig(**tc))
    assert [h["step"] for h in got] == [h["step"] for h in want] == list(range(STEPS))
    for w, g in zip(want, got):
        assert set(w) == set(g), (set(w), set(g))
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=TOL.get(k, 1e-4),
                                       err_msg=f"step {w['step']} {k}")
    assert got[-1]["loss"] < got[0]["loss"]


def _join_writers():
    """Wait for the checkpoint writers a cut run left behind (the
    reference's `train` does not wait for its async save when a hook
    raises): the threads running a reference `Checkpointer`'s `_write`."""
    for t in threading.enumerate():
        target = getattr(t, "_target", None)
        if isinstance(getattr(target, "__self__", None), rckpt.Checkpointer):
            t.join(timeout=60)


def test_restart_equals_uninterrupted_run(tmp_path):
    """A run cut after its step-2 checkpoint (a hook raises at step 3) and
    restarted from it equals the reference's run cut and restarted the same
    way: both save after step 2 under the label 2, so the restart runs step
    2 again (steps 0..2, then 2..3). Every history value to the file's
    tolerances, the final parameters within PARAM_ATOL, and the checkpoint
    steps on disk. (The uninterrupted run is held to the reference's in
    `test_history_matches_reference`.)"""
    rc, pc = _cfgs("qwen2-0.5b")
    tc = dict(steps=4, log_every=1, ckpt_every=2)
    opt, data = radam.AdamWConfig(**OPT), rsyn.DataConfig(vocab=rc.vocab, **DATA)

    def crash(step, params, metrics):
        if step == 3:
            raise KeyboardInterrupt

    def ref_train(c, hooks=None):
        return rtl.train("qwen2-0.5b", c, opt, data, model_cfg=rc, hooks=hooks)

    def port_train(c, hooks=None):
        return _port_train("qwen2-0.5b", pc, c, hooks=hooks)

    runs = {}
    for name, train, cfg in (("ref", ref_train, rtl.TrainConfig),
                             ("port", port_train, ptl.TrainConfig)):
        cut = cfg(ckpt_dir=str(tmp_path / name), **tc)
        with pytest.raises(KeyboardInterrupt):
            train(cut, hooks=[crash])
        _join_writers()
        assert ptl.Checkpointer(cut.ckpt_dir).all_steps() == [2], name
        out = io.StringIO()
        with redirect_stdout(out):
            params, resumed = train(cut)
        assert "[train] restored step 2" in out.getvalue(), name
        runs[name] = (params, resumed, ptl.Checkpointer(cut.ckpt_dir).all_steps())
    (rp, r_res, r_steps), (pp, p_res, p_steps) = runs["ref"], runs["port"]
    assert [h["step"] for h in p_res] == [h["step"] for h in r_res] == [2, 3]
    assert p_steps == r_steps == [2, 4]
    for w, g in zip(r_res, p_res):
        assert set(w) == set(g)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=TOL.get(k, 1e-4),
                                       err_msg=f"step {w['step']} {k}")
    want = convert.master_params(pc, jax.tree.map(np.asarray, rp))
    worst = max(float((b.detach() - a).abs().max())
                for a, b in zip(padam.leaves(want), padam.leaves(pp)))
    assert worst <= PARAM_ATOL, worst


def test_checkpoint_layout(tmp_path):
    """The checkpoint holds the parameters and the AdamW state (m, v, count)
    as the reference's manifest spells a (params, AdamWState) pair."""
    _, pc = _cfgs("qwen2-0.5b")
    tc = ptl.TrainConfig(steps=2, log_every=1, ckpt_dir=str(tmp_path))
    _port_train("qwen2-0.5b", pc, tc)
    leaves = ptl.Checkpointer(str(tmp_path)).read(2)
    assert int(leaves["1/.count"]) == 2
    assert leaves["0/embed/table"].dtype == np.float32
    assert leaves["1/.m/layers/0/attn/wq/w"].shape == (pc.d_model, pc.n_heads * pc.hd)


def test_launcher_runs_on_the_cpu(tmp_path):
    argv = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu", "--batch", "4",
            "--seq", "32", "--lr", "1e-3", "--ckpt", str(tmp_path), "--ckpt-every", "2"]
    for steps, first in ((3, "[launch/train] step     0 loss "),
                         (5, "[launch/train] restored step 3")):
        out = io.StringIO()
        with redirect_stdout(out):
            launcher.main(argv + ["--steps", str(steps)])
        lines = out.getvalue().splitlines()
        assert lines[0].startswith(first), lines
        assert lines[-2].startswith(f"[launch/train] step {steps - 1:5d} loss "), lines
        assert lines[-1].startswith("[launch/train] ") and "tokens/s) on cpu" in lines[-1]
    shutil.rmtree(tmp_path)


@pytest.mark.parametrize("family,key", [("vlm", "prefix_embeds"), ("encdec", "frames")])
def test_unported_families_raise(family, key):
    """The VLM and encoder-decoder families train: `_make_batch` adds the
    reference's draw of their frontend's output (normal · 0.02 from
    fold_in(PRNGKey(seed), step), within 4 ulps; test_torch_vlm.py and
    test_torch_encdec.py hold their histories), and `train` runs a step."""
    arch = {"vlm": "llava-next-mistral-7b", "encdec": "whisper-tiny"}[family]
    rc, pc = _cfgs(arch)
    want = rtl._make_batch(rc, rsyn.DataConfig(vocab=rc.vocab, **DATA), 1, rtl.TrainConfig())
    got = ptl._make_batch(pc, psyn.DataConfig(vocab=pc.vocab, **DATA), 1, ptl.TrainConfig())
    assert set(got) == set(want) == {"tokens", "loss_mask", key}
    a = np.asarray(want[key]).view(np.int32).astype(np.int64)
    b = got[key].numpy().view(np.int32).astype(np.int64)
    assert a.shape == b.shape == (DATA["global_batch"], pc.n_frontend_tokens, pc.d_model)
    assert int(np.abs(a - b).max()) <= 4
    _, hist = ptl.train(arch, ptl.TrainConfig(steps=1), padam.AdamWConfig(),
                        psyn.DataConfig(**DATA), model_cfg=pc, device="cpu")
    assert np.isfinite(hist[-1]["loss"])


def test_training_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, pc = _cfgs("qwen2-0.5b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptl.train("qwen2-0.5b", ptl.TrainConfig(steps=1), padam.AdamWConfig(),
                  psyn.DataConfig(**DATA), model_cfg=pc)
