"""Port parity of rwkv6 serving: `repro_torch` on the CPU against
`repro.models.rwkv6` / `repro.runtime.serve_loop` at the reduced rwkv6-1.6b
config (`registry.reduced`: 2 layers, d 64, head dim 16, so 4 heads), with
the reference's own weights (`rwkv6.init`) carried across by
`convert.rwkv6_params`. The reference initialises its constant leaves (lerp
coefficients 0.5, w0 -6, u 0, norms 1 and 0) to values that would hide a
wrong use of them, so the tests draw those leaves anew with numpy from a
seed, in the reference's tree, before converting. On the CPU the `wkv6`
kernel runs its plain version (`kernels.ref.wkv6`), which
test_torch_wkv6.py holds against the Pallas kernel.

Tolerances. fp32: atol = rtol = 1e-4 — the same arithmetic in another
order; at S = 512 the reference runs its chunk-parallel `wkv_chunked`,
which reorders the recurrence's sums (the logits here are O(1)). bf16:
|port - reference| <= 2e-2 + 2^-7 * max|reference| over the compared
array, rtol 0 — the two frameworks round to bf16 at different points
(lerps, matmul epilogues, the gating), and a layernorm subtracts the row's
mean, so one rounding difference of the residual stream's largest entries,
about one bf16 ulp of the largest value (2^-8 to 2^-7 of it), reaches
every entry of the normalised row; the shift state is such a row, and its
entries reach ~3, where one ulp is 2^-6. Served tokens are compared
exactly, in fp32.
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

from repro.models import layers as rL
from repro.models import registry as rreg
from repro.models import rwkv6 as rrw
from repro.runtime import serve_loop as rserve
from repro_torch import convert
from repro_torch.models import layers as pL
from repro_torch.models import registry as preg
from repro_torch.models import rwkv6 as prw
from repro_torch.runtime import serve_loop as pserve

ARCH = "rwkv6-1.6b"
DTYPES = ["float32", "bfloat16"]


def _close(want, got, dtype, what=""):
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        tol = dict(atol=1e-4, rtol=1e-4)
    else:
        tol = dict(atol=2e-2 + 2 ** -7 * float(np.abs(want).max()), rtol=0)
    np.testing.assert_allclose(want, as_np(got.float()), err_msg=what, **tol)


def _redraw_constants(params, seed: int):
    """The reference's tree with its constant leaves drawn anew (numpy):
    lerp coefficients in (0, 1), w0 in (-3, 0) (decays from 0.95 to 0.37
    at x = 0), u ~ N(0, 0.3^2), layernorm scales ~ 1 + N(0, 0.1^2) and
    biases ~ N(0, 0.1^2), gn scale ~ 1 + N(0, 0.1^2)."""
    rs = np_rng(seed)
    p = jax.tree.map(np.asarray, params)
    lay = p["layers"]

    def like(a, draw):
        return draw(a.shape).astype(np.float32)

    for group in ("mix", "cmix"):
        lay[group] = {k: like(a, rs.random) for k, a in lay[group].items()}
    lay["w0"] = like(lay["w0"], lambda s: rs.uniform(-3.0, 0.0, s))
    lay["u"] = like(lay["u"], lambda s: 0.3 * rs.standard_normal(s))
    for norms in (lay["ln1"], lay["ln2"], p["final_norm"]):
        norms["scale"] = like(norms["scale"], lambda s: 1 + 0.1 * rs.standard_normal(s))
        norms["bias"] = like(norms["bias"], lambda s: 0.1 * rs.standard_normal(s))
    lay["gn"]["scale"] = like(lay["gn"]["scale"],
                              lambda s: 1 + 0.1 * rs.standard_normal(s))
    return p


@functools.lru_cache(maxsize=None)
def _model(dtype: str):
    """(reference cfg, reference params, port cfg, port params) at the
    reduced rwkv6-1.6b config in one compute type."""
    rc = dataclasses.replace(rreg.reduced(rreg.get_config(ARCH)), dtype=dtype)
    pc = dataclasses.replace(preg.reduced(preg.get_config(ARCH)), dtype=dtype)
    assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
    tree = _redraw_constants(rrw.init(jax.random.PRNGKey(0), rc), seed=21)
    rp = jax.tree.map(jnp.asarray, tree)
    pp = convert.rwkv6_params(pc, tree)
    return rc, rp, pc, pp


@pytest.fixture(params=DTYPES)
def model(request):
    return _model(request.param)


def _bf(a, dtype):
    """The same numpy array as a jax and a torch array of `dtype`."""
    return (jnp.asarray(a, jnp.float32).astype(dtype),
            torch.as_tensor(np.asarray(a, np.float32)).to(getattr(torch, dtype)))


def test_config_and_registry_mirror_reference():
    full_r, full_p = rreg.get_config(ARCH), preg.get_config(ARCH)
    assert dataclasses.asdict(full_r) == dataclasses.asdict(full_p)
    assert full_p.n_params() == full_r.n_params()
    assert ARCH in preg.list_archs()
    fns = preg.get_fns(full_p)
    assert (fns.init, fns.prefill, fns.decode_step) == (
        prw.init, prw.prefill, prw.decode_step)


@pytest.mark.parametrize("change", [{"norm": "rmsnorm"}, {"pattern": ("rwkv", "attn")}])
def test_unported_configs_raise(change):
    cfg = dataclasses.replace(preg.reduced(preg.get_config(ARCH)), **change)
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 15\.3"):
        prw.init(cfg, device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm_matches_reference(dtype):
    rs = np_rng(1)
    x = 3 * rs.standard_normal((2, 5, 64)) + 0.5
    scale = rs.standard_normal(64).astype(np.float32)
    bias = rs.standard_normal(64).astype(np.float32)
    xj, xt = _bf(x, dtype)
    got = pL.layernorm({"scale": torch.as_tensor(scale), "bias": torch.as_tensor(bias)}, xt)
    assert got.dtype == xt.dtype
    _close(rL.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, xj),
           got, dtype, "layernorm")


def test_mixes_match_reference(model):
    """`_time_mix` and `_channel_mix` of layer 0 from a random shift row and
    WKV state: outputs and new state rows."""
    rc, rp, pc, pp = model
    dtype = pc.dtype
    rs = np_rng(2)
    B, S, D = 3, 12, pc.d_model
    H, hd = D // pc.rwkv_head_dim, pc.rwkv_head_dim
    lr = jax.tree.map(lambda a: a[0], rp["layers"])
    lp = pp["layers"][0]
    xj, xt = _bf(rs.standard_normal((B, S, D)), dtype)
    sj, st = _bf(rs.standard_normal((B, D)), dtype)
    wkv = (0.3 * rs.standard_normal((B, H, hd, hd))).astype(np.float32)
    out_r, sh_r, wkv_r = rrw._time_mix(lr, xj, rc, sj, jnp.asarray(wkv))
    out_p, sh_p, wkv_p = prw._time_mix(lp, xt, pc, st, torch.as_tensor(wkv))
    _close(out_r, out_p, dtype, "time mix out")
    _close(sh_r, sh_p, dtype, "time mix shift")
    _close(wkv_r, wkv_p, dtype, "time mix wkv state")
    assert wkv_p.dtype == torch.float32
    c_r, shf_r = rrw._channel_mix(lr, xj, sj)
    c_p, shf_p = prw._channel_mix(lp, xt, st)
    _close(c_r, c_p, dtype, "channel mix out")
    _close(shf_r, shf_p, dtype, "channel mix shift")


def _close_state(want, got, dtype, what):
    assert set(want) == set(got)
    for name in want:
        assert got[name].dtype == (torch.float32 if name == "wkv"
                                   else getattr(torch, dtype)), name
        _close(want[name], got[name], dtype, f"{what} {name}")


@pytest.mark.parametrize("S", [16, 512])
def test_forward_matches_reference(model, S):
    """S = 512 takes the reference's chunk-parallel branch (`wkv_chunked`,
    chunk 256), S = 16 its sequential scan."""
    rc, rp, pc, pp = model
    toks = np_rng(3 + S).integers(0, pc.vocab, (2, S))
    lr, _, sr = rrw.forward(rp, rc, jnp.asarray(toks))
    lp, sp = prw.forward(pp, pc, torch.as_tensor(toks))
    _close(lr, lp, pc.dtype, f"forward logits S={S}")
    _close_state(sr, sp, pc.dtype, f"forward S={S} state")


def test_prefill_and_decode_match_reference(model):
    """Prefill logits and state, then 8 teacher-forced decode steps, the
    state compared leaf by leaf after each."""
    rc, rp, pc, pp = model
    dtype = pc.dtype
    rs = np_rng(4)
    B, S = 3, 24
    toks = rs.integers(0, pc.vocab, (B, S))
    lr, sr, pos_r = rrw.prefill(rp, rc, jnp.asarray(toks))
    lp, sp, pos_p = prw.prefill(pp, pc, torch.as_tensor(toks), 40)
    _close(lr, lp, dtype, "prefill logits")
    assert_same(pos_r, pos_p, "next pos")
    _close_state(sr, sp, dtype, "prefill")
    forced = rs.integers(0, pc.vocab, (B, 8))
    for i in range(8):
        given = {k: v.clone() for k, v in sp.items()}
        lr, sr, pos_r = rrw.decode_step(rp, rc, jnp.asarray(forced[:, i], jnp.int32),
                                        sr, pos_r)
        lp, sp_new, pos_p = prw.decode_step(pp, pc, torch.as_tensor(forced[:, i]),
                                            sp, pos_p)
        assert all(torch.equal(given[k], sp[k]) for k in sp), "state mutated"
        sp = sp_new
        _close(lr, lp, dtype, f"decode step {i} logits")
        assert_same(pos_r, pos_p, f"decode step {i} pos")
        _close_state(sr, sp, dtype, f"decode step {i}")


def test_serve_requests_token_equal_in_fp32():
    """Token equality is asserted in fp32: in bf16 a near-tie may flip."""
    rc, rp, pc, pp = _model("float32")
    sc_r = rserve.ServeConfig(max_new_tokens=10, prompt_len=12, cache_len=30, eos_id=1)
    sc_p = pserve.ServeConfig(**dataclasses.asdict(sc_r))
    prompts = np_rng(5).integers(0, pc.vocab, (4, 12))
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
    ref_tree = rrw.init(jax.random.PRNGKey(0), rc)
    want = convert.rwkv6_params(pc, jax.tree.map(np.asarray, ref_tree))
    pp = prw.init(pc, seed=0, device="cpu")
    shapes = functools.partial(jax.tree.map, lambda t: (tuple(t.shape), t.dtype))
    assert shapes(want) == shapes(pp)
    # every constant leaf equals the reference's
    for name in ("mix", "w0", "u", "gn", "ln1", "ln2", "cmix"):
        for a, b in zip(jax.tree.leaves(want["layers"][1][name]),
                        jax.tree.leaves(pp["layers"][1][name])):
            assert torch.equal(a, b), name
    w = torch.cat([pp["head"]["table"].float().flatten()]
                  + [lp["ck"].float().flatten() for lp in pp["layers"]])
    assert abs(float(w.std()) - 0.02) < 1e-3 and abs(float(w.mean())) < 1e-3
    assert torch.equal(prw.init(pc, seed=0, device="cpu")["embed"]["table"],
                       pp["embed"]["table"])


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    _, _, pc, pp = _model("float32")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        prw.init(pc)
    with pytest.raises(RuntimeError, match="CUDA"):
        pserve.serve_requests(pc, pp, pserve.ServeConfig(), np.zeros((1, 4), np.int64))


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
