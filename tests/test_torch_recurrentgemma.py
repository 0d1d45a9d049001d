"""Port parity of recurrentgemma serving: `repro_torch` on the CPU against
`repro.models.rglru` / `repro.runtime.serve_loop` at the reduced
recurrentgemma-9b config (`registry.reduced`: 3 layers (rec, rec, attn), d
64, 4 query heads over 1 KV head of 16, window 32, lru width 64), with the
reference's own weights (`rglru.init`) carried across by
`convert.rglru_params`. The reference initialises `lam` to 2, the biases to
0 and the norm scales to 1, values that would hide a wrong use of them, so
the tests draw those leaves anew with numpy from a seed, in the reference's
tree, before converting. On the CPU the kernels run their plain versions
(`kernels.ref`), which test_torch_rglru.py and test_torch_ring_attention.py
hold against the Pallas kernels.

Tolerances, over each compared array. fp32: |port - reference| <= 1e-4 *
max|reference| + 1e-6 — the same arithmetic in another order. bf16: 2e-2
+ 2^-7 * max|reference|, rtol 0 — the two frameworks round to bf16 at
different points (matmul epilogues, GeLU, the sigmoid gates, the conv
sum), and an rmsnorm spreads one rounding of the residual stream's
largest entries over the whole row. Served tokens are compared exactly, in
fp32.
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

from repro.models import registry as rreg
from repro.models import rglru as rrg
from repro.runtime import serve_loop as rserve
from repro_torch import convert
from repro_torch.models import registry as preg
from repro_torch.models import rglru as prg
from repro_torch.runtime import serve_loop as pserve

ARCH = "recurrentgemma-9b"
DTYPES = ["float32", "bfloat16"]


def _close(want, got, dtype, what=""):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    atol = 1e-4 * scale + 1e-6 if dtype == "float32" else 2e-2 + 2 ** -7 * scale
    np.testing.assert_allclose(want, as_np(got.float()), atol=atol, rtol=0,
                               err_msg=what)


def _redraw(node, rs):
    """Every constant leaf of a (grouped or per-layer) subtree drawn anew:
    lam ~ N(0, 1.5^2) (decays from fast to slow), the conv and gate biases
    ~ N(0, 0.1^2), norm scales ~ 1 + N(0, 0.1^2)."""
    for name, a in node.items():
        if isinstance(a, dict):
            _redraw(a, rs)
        elif name == "lam":
            node[name] = (1.5 * rs.standard_normal(a.shape)).astype(np.float32)
        elif name in ("conv_b", "ba", "bx"):
            node[name] = (0.1 * rs.standard_normal(a.shape)).astype(np.float32)
        elif name == "scale":
            node[name] = (1 + 0.1 * rs.standard_normal(a.shape)).astype(np.float32)


def _reference_tree(rc, seed: int):
    tree = jax.tree.map(np.asarray, rrg.init(jax.random.PRNGKey(0), rc))
    rs = np_rng(seed)
    for part in ("rec", "attn", "final_norm"):
        _redraw(tree[part], rs)
    for lp in tree["rem"]:
        _redraw(lp, rs)
    return tree


@functools.lru_cache(maxsize=None)
def _model(dtype: str, n_layers: int = 3):
    """(reference cfg, reference params, port cfg, port params) at the
    reduced recurrentgemma-9b config in one compute type."""
    rc = dataclasses.replace(rreg.reduced(rreg.get_config(ARCH)), dtype=dtype,
                             n_layers=n_layers)
    pc = dataclasses.replace(preg.reduced(preg.get_config(ARCH)), dtype=dtype,
                             n_layers=n_layers)
    assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
    tree = _reference_tree(rc, seed=31 + n_layers)
    rp = jax.tree.map(jnp.asarray, tree)
    pp = convert.rglru_params(pc, tree)
    return rc, rp, pc, pp


@pytest.fixture(params=DTYPES)
def model(request):
    return _model(request.param)


def _bf(a, dtype):
    """The same numpy array as a jax and a torch array of `dtype`."""
    return (jnp.asarray(a, jnp.float32).astype(dtype),
            torch.as_tensor(np.asarray(a, np.float32)).to(getattr(torch, dtype)))


def _close_state(want, got, dtype, what):
    """The reference's state against the port's: k/v permuted from (n_att,
    B, T, KV, hd) to the port's (n_att, B, KV, T, hd); h in fp32, the rest
    in the compute type."""
    assert set(want) == set(got)
    for name in want:
        w = np.asarray(want[name], np.float32)
        if name in ("k", "v"):
            w = w.transpose(0, 1, 3, 2, 4)
        assert got[name].dtype == (torch.float32 if name == "h"
                                   else getattr(torch, dtype)), name
        _close(w, got[name], dtype, f"{what} {name}")


def test_config_and_registry_mirror_reference():
    full_r, full_p = rreg.get_config(ARCH), preg.get_config(ARCH)
    assert dataclasses.asdict(full_r) == dataclasses.asdict(full_p)
    assert full_p.n_params() == full_r.n_params() == 9_572_462_592
    assert ARCH in preg.list_archs()
    fns = preg.get_fns(full_p)
    assert (fns.init, fns.prefill, fns.decode_step) == (
        prg.init, prg.prefill, prg.decode_step)
    red = preg.reduced(full_p)
    assert (red.n_layers, red.hd, red.window, red.lru_width, red.n_kv_heads,
            red.n_heads) == (3, 16, 32, 64, 1, 4)


@pytest.mark.parametrize("change,error", [
    ({"pattern": ("rec", "rwkv")}, ValueError), ({"dtype": "float16"}, ValueError),
    ({"n_layers": 2}, ValueError), ({"rope_theta": 0.0}, ValueError)])
def test_unserved_configs_raise(change, error):
    cfg = dataclasses.replace(preg.reduced(preg.get_config(ARCH)), **change)
    with pytest.raises(error):
        prg.init(cfg, device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(dtype, with_state):
    """The conv's K products summed one by one in the compute type, then +
    b; the new state is the last K-1 rows of [state, x]. S = 1 (decode)
    and S = 7."""
    rs = np_rng(40)
    K, W = 4, 24
    w = rs.standard_normal((K, W)).astype(np.float32)
    b = rs.standard_normal(W).astype(np.float32)
    for S in (1, 7):
        xj, xt = _bf(rs.standard_normal((2, S, W)), dtype)
        st = rs.standard_normal((2, K - 1, W)) if with_state else np.zeros((2, K - 1, W))
        sj, stt = _bf(st, dtype)
        y_r, s_r = rrg._causal_conv(xj, jnp.asarray(w), jnp.asarray(b), sj)
        wt, bt = (torch.as_tensor(a).to(getattr(torch, dtype)) for a in (w, b))
        y_p, s_p = prg._causal_conv(xt, wt, bt, stt)
        assert y_p.dtype == xt.dtype and s_p.dtype == xt.dtype
        _close(y_r, y_p, dtype, f"conv out S={S}")
        _close(s_r, s_p, dtype, f"conv state S={S}")


def test_blocks_match_reference(model):
    """One recurrent block (from a random h and conv state) and one
    attention block, layer by layer."""
    rc, rp, pc, pp = model
    dtype = pc.dtype
    rs = np_rng(41)
    B, S, D, W = 2, 12, pc.d_model, pc.lru_width
    xj, xt = _bf(rs.standard_normal((B, S, D)), dtype)
    h0 = rs.standard_normal((B, W)).astype(np.float32)
    cj, ct = _bf(rs.standard_normal((B, pc.conv1d_width - 1, W)), dtype)
    lr = rrg._layer_params(rp, rc, 1)
    x_r, h_r, c_r = rrg._rec_block(lr, xj, rc, jnp.asarray(h0), cj)
    x_p, h_p, c_p = prg._rec_block(pp["layers"][1], xt, pc, torch.as_tensor(h0), ct)
    _close(x_r, x_p, dtype, "rec block out")
    _close(h_r, h_p, dtype, "rec block h")
    _close(c_r, c_p, dtype, "rec block conv state")
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    a_r, (k_r, v_r) = rrg._attn_block(rrg._layer_params(rp, rc, 2), xj, rc, pos)
    a_p, (k_p, v_p) = prg._attn_block(pp["layers"][2], xt, pc)
    _close(a_r, a_p, dtype, "attn block out")
    _close(np.asarray(k_r, np.float32).transpose(0, 2, 1, 3), k_p, dtype, "attn k")
    _close(np.asarray(v_r, np.float32).transpose(0, 2, 1, 3), v_p, dtype, "attn v")


@pytest.mark.parametrize("S", [16, 64])
def test_forward_matches_reference(model, S):
    """S = 64 is past the window (32): the last queries see 32 keys."""
    rc, rp, pc, pp = model
    toks = np_rng(42 + S).integers(0, pc.vocab, (2, S))
    _close(rrg.forward(rp, rc, jnp.asarray(toks))[0],
           prg.forward(pp, pc, torch.as_tensor(toks)), pc.dtype,
           f"forward logits S={S}")


def _prefill_and_decode(rc, rp, pc, pp, seed: int, S: int = 40, steps: int = 12,
                        cache_len: int = 64):
    """Prefill of S tokens (past the window, so the ring keeps the last T),
    then `steps` teacher-forced decode steps that wrap the ring, logits and
    state compared after each."""
    dtype = pc.dtype
    rs = np_rng(seed)
    B = 3
    toks = rs.integers(0, pc.vocab, (B, S))
    lr, sr, pos_r = rrg.prefill(rp, rc, jnp.asarray(toks), cache_len)
    lp, sp, pos_p = prg.prefill(pp, pc, torch.as_tensor(toks), cache_len)
    _close(lr, lp, dtype, "prefill logits")
    assert_same(pos_r, pos_p, "next pos")
    _close_state(sr, sp, dtype, "prefill")
    forced = rs.integers(0, pc.vocab, (B, steps))
    for i in range(steps):
        lr, sr, pos_r = rrg.decode_step(rp, rc, jnp.asarray(forced[:, i], jnp.int32),
                                        sr, pos_r)
        lp, sp, pos_p = prg.decode_step(pp, pc, torch.as_tensor(forced[:, i]),
                                        sp, pos_p)
        _close(lr, lp, dtype, f"decode step {i} logits")
        assert_same(pos_r, pos_p, f"decode step {i} pos")
        _close_state(sr, sp, dtype, f"decode step {i}")


def test_prefill_and_decode_past_the_window_match_reference(model):
    """Window 32, cache_len 64: T = 32; a 40-token prompt and 12 steps
    (positions 40..51) wrap the ring."""
    rc, rp, pc, pp = model
    _prefill_and_decode(rc, rp, pc, pp, seed=43)


@pytest.mark.parametrize("dtype", DTYPES)
def test_five_layers_meet_the_remainder(dtype):
    """Five layers: one whole group (rec, rec, attn) and two remainder
    recurrent layers, which the reference keeps in its `rem` list."""
    rc, rp, pc, pp = _model(dtype, n_layers=5)
    assert len(rp["rem"]) == 2 and len(pp["layers"]) == 5
    assert [("lam" in lp) for lp in pp["layers"]] == [True, True, False, True, True]
    np.testing.assert_array_equal(np.asarray(rp["rem"][1]["lam"]),
                                  as_np(pp["layers"][4]["lam"]))
    _prefill_and_decode(rc, rp, pc, pp, seed=44, S=20, steps=4, cache_len=24)


def test_serve_requests_token_equal_in_fp32():
    """Token equality is asserted in fp32: in bf16 a near-tie may flip.
    Prompt 36 (past the window) and 10 new tokens."""
    rc, rp, pc, pp = _model("float32")
    sc_r = rserve.ServeConfig(max_new_tokens=10, prompt_len=36, cache_len=54, eos_id=1)
    sc_p = pserve.ServeConfig(**dataclasses.asdict(sc_r))
    prompts = np_rng(45).integers(0, pc.vocab, (4, 36))
    out_r, info_r = rserve.serve_requests(rc, rp, sc_r, prompts)
    out_p, info_p = pserve.serve_requests(pc, pp, sc_p, prompts, device="cpu")
    assert_same(out_r, out_p, "served tokens")
    assert info_r == info_p


def test_init_matches_reference_structure_and_scale():
    """`init` draws the reference's distributions with torch's generator:
    the same tree, shapes and types as the converted reference tree,
    normal(0, 0.02) matrices and the reference's constants."""
    pc = preg.reduced(preg.get_config(ARCH))
    rc = rreg.reduced(rreg.get_config(ARCH))
    want = convert.rglru_params(pc, jax.tree.map(np.asarray,
                                                 rrg.init(jax.random.PRNGKey(0), rc)))
    pp = prg.init(pc, seed=0, device="cpu")
    shapes = functools.partial(jax.tree.map, lambda t: (tuple(t.shape), t.dtype))
    assert shapes(want) == shapes(pp)
    for name in ("lam", "conv_b", "ba", "bx", "ln1", "ln2"):
        for a, b in zip(jax.tree.leaves(want["layers"][0][name]),
                        jax.tree.leaves(pp["layers"][0][name])):
            assert torch.equal(a, b), name
    assert pp["layers"][0]["lam"].dtype == torch.float32
    w = torch.cat([pp["head"]["table"].float().flatten()]
                  + [lp["mlp"]["wd"]["w"].float().flatten() for lp in pp["layers"]])
    assert abs(float(w.std()) - 0.02) < 1e-3 and abs(float(w.mean())) < 1e-3
    assert torch.equal(prg.init(pc, seed=0, device="cpu")["embed"]["table"],
                       pp["embed"]["table"])


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    _, _, pc, pp = _model("float32")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        prg.init(pc)
    with pytest.raises(RuntimeError, match="CUDA"):
        pserve.serve_requests(pc, pp, pserve.ServeConfig(), np.zeros((1, 4), np.int64))


def test_make_state_defaults_to_cuda_and_builds_on_the_cpu(monkeypatch):
    """`make_state` resolves device=None as `init` does: to the card, so it
    raises where there is none; on device="cpu" it builds the zero state of
    every recurrent and attention block."""
    pc = preg.reduced(preg.get_config(ARCH))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        prg.make_state(pc, 2, 40)
    state = prg.make_state(pc, 2, 40, device="cpu")
    kinds = pc.block_kinds()
    assert state["h"].shape[:2] == (kinds.count("rec"), 2)
    assert state["k"].shape[:2] == (kinds.count("attn"), 2)
    for leaf in state.values():
        assert leaf.device.type == "cpu" and not leaf.any()


def test_launch_serve_runs_on_the_cpu():
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--max-new", "6"],
        capture_output=True, text=True, env=env, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("[serve] decoded 48 tokens")
    assert lines[-1].startswith("[serve] occupancy=0.727 moved=30 steps=151 completed=128")
