"""Port parity of the MoE transformers' serving path: `repro_torch` on the
CPU against `repro.models.transformer` / `repro.runtime.serve_loop` at
`registry.reduced` of qwen2-moe-a2.7b (rmsnorm, qkv bias, 8 experts top-2
and a shared expert) and phi3.5-moe-42b-a6.6b (layernorm, 4 query heads a
KV head, no shared expert), with the reference's own weights
(`transformer.init`) carried across by `convert.lm_params`. On the CPU the
attention kernels run their plain versions (`kernels.ref`), which
test_torch_attention.py holds against the Pallas kernels.

Tolerance, fp32: atol 1e-5, rtol 1e-5 — the same arithmetic in another
order (logits O(1)); each layer's expert choice is an exact top-k over
fp32 probabilities on both sides, so the routing agrees as long as no
near-tie falls within that rounding (none does on these inputs; the
choices themselves are held exactly in test_torch_moe.py). Served tokens
are compared exactly, in fp32.
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
from repro.models import transformer as rtf
from repro.runtime import serve_loop as rserve
from repro_torch import convert
from repro_torch.models import moe as pmoe
from repro_torch.models import registry as preg
from repro_torch.models import transformer as ptf
from repro_torch.runtime import serve_loop as pserve

TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ["qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b"]

torch.set_num_threads(1)


def _close(want, got, what=""):
    np.testing.assert_allclose(np.asarray(want, np.float32), as_np(got.float()),
                               err_msg=what, **TOL)


@functools.lru_cache(maxsize=None)
def _model(arch: str):
    """(reference cfg, reference params, port cfg, port params) at the
    reduced config of `arch`, in fp32."""
    rc = dataclasses.replace(rreg.reduced(rreg.get_config(arch)), dtype="float32")
    pc = dataclasses.replace(preg.reduced(preg.get_config(arch)), dtype="float32")
    assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
    rp = rtf.init(jax.random.PRNGKey(0), rc)
    pp = convert.lm_params(pc, jax.tree.map(np.asarray, rp))
    return rc, rp, pc, pp


@pytest.fixture(params=ARCHS)
def model(request):
    return _model(request.param)


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_serves_the_moe_archs(arch):
    """Both MoE architectures resolve to the reference's config field for
    field and to the transformer's functions; the tree the port's `init`
    builds has the reference's leaves, shapes and types (cfg.dtype; norm
    scales and layernorm's shifts fp32)."""
    full_r, full_p = rreg.get_config(arch), preg.get_config(arch)
    assert dataclasses.asdict(full_r) == dataclasses.asdict(full_p)
    assert full_p.n_params() == full_r.n_params()
    fns = preg.get_fns(full_p)
    assert (fns.init, fns.prefill, fns.decode_step) == (ptf.init, ptf.prefill,
                                                        ptf.decode_step)
    rc, rp, pc, pp = _model(arch)
    mine = ptf.init(dataclasses.replace(pc, dtype="bfloat16"), seed=0, device="cpu")
    ref_layer = jax.tree.map(lambda a: a[0], rp["layers"])
    want = jax.tree_util.tree_flatten_with_path(ref_layer)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(mine["layers"][0])[0])
    assert sorted(map(str, got)) == sorted(str(k) for k, _ in want)
    for path, leaf in want:
        t = got[path]
        assert tuple(t.shape) == leaf.shape, path
        fp32 = path[-1].key in ("scale", "bias")
        assert t.dtype == (torch.float32 if fp32 else torch.bfloat16), path
    assert "moe" in mine["layers"][0] and "mlp" not in mine["layers"][0]
    assert ("bias" in mine["layers"][0]["ln1"]) == (pc.norm == "layernorm")


def test_other_archs_still_name_their_items():
    """No architecture or family names an item any more: the last two
    (llava-next-mistral-7b, item 15.5; whisper-tiny, item 15.6) are
    served, with the reference's configurations."""
    for arch in ("llava-next-mistral-7b", "whisper-tiny"):
        assert dataclasses.asdict(preg.get_config(arch)) == dataclasses.asdict(
            rreg.get_config(arch))
    assert not set(preg._ARCH_ITEMS.values()) | set(preg._FAMILY_ITEMS.values())


def test_prefill_and_decode_match_reference(model):
    """Forward logits, prefill logits and cache, then 6 teacher-forced decode
    steps (each a T = B = 3 MoE call, capacity ceil(3·2/8·1.25) = 1), logits
    and cache after them."""
    rc, rp, pc, pp = model
    rs = np_rng(21)
    B, S, cache_len = 3, 20, 32
    toks = rs.integers(0, pc.vocab, (B, S))
    _close(rtf.forward(rp, rc, jnp.asarray(toks))[0],
           ptf.forward(pp, pc, torch.as_tensor(toks)), "forward")
    lr, cr, pos_r = rtf.prefill(rp, rc, jnp.asarray(toks), cache_len)
    lp, cp, pos_p = ptf.prefill(pp, pc, torch.as_tensor(toks), cache_len)
    _close(lr, lp, "prefill logits")
    assert_same(pos_r, pos_p, "next pos")
    for name in ("k", "v"):
        _close(np.asarray(cr[name], np.float32).transpose(0, 1, 3, 2, 4),
               cp[name], f"prefill cache {name}")
    assert pmoe.capacity_of(B, pc.moe) == 1
    forced = rs.integers(0, pc.vocab, (B, 6))
    for i in range(6):
        lr, cr, pos_r = rtf.decode_step(rp, rc, jnp.asarray(forced[:, i], jnp.int32),
                                        cr, pos_r)
        lp, cp, pos_p = ptf.decode_step(pp, pc, torch.as_tensor(forced[:, i]), cp, pos_p)
        _close(lr, lp, f"decode step {i} logits")
        assert_same(pos_r, pos_p, f"decode step {i} pos")
    for name in ("k", "v"):
        _close(np.asarray(cr[name], np.float32).transpose(0, 1, 3, 2, 4),
               cp[name], f"decoded cache {name}")


def test_moe_block_metrics_match_reference(model):
    """One MoE block inside the model: the first layer's FFN on a prompt's
    normed residual, y and the dropped shares against the reference's
    `moe_apply` on the same weights."""
    rc, rp, pc, pp = model
    from repro.models import moe as rmoe

    x = np_rng(22).standard_normal((2, 16, pc.d_model)).astype(np.float32)
    lr = jax.tree.map(lambda a: a[0], rp["layers"]["moe"])
    ry, rm = rmoe.moe_apply(lr, jnp.asarray(x), rc.moe)
    py, pm = pmoe.moe_apply(pp["layers"][0]["moe"], torch.as_tensor(x), pc.moe)
    _close(ry, py, "moe y")
    for key in ("moe_dropped", "moe_dropped_pre_steal"):
        assert float(rm[key]) == float(pm[key]), key


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_requests_token_equal_in_fp32(arch):
    rc, rp, pc, pp = _model(arch)
    sc_r = rserve.ServeConfig(max_new_tokens=8, prompt_len=10, cache_len=24, eos_id=1)
    sc_p = pserve.ServeConfig(**dataclasses.asdict(sc_r))
    prompts = np_rng(23).integers(0, pc.vocab, (4, 10))
    out_r, info_r = rserve.serve_requests(rc, rp, sc_r, prompts)
    out_p, info_p = pserve.serve_requests(pc, pp, sc_p, prompts, device="cpu")
    assert_same(out_r, out_p, "served tokens")
    assert info_r == info_p


def test_launch_serve_moe_runs_on_the_cpu():
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen2-moe-a2.7b",
         "--reduced", "--device", "cpu", "--max-new", "6"],
        capture_output=True, text=True, env=env, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("[serve] decoded 48 tokens")
    assert lines[-1].startswith("[serve] occupancy=0.727 moved=30 steps=151 completed=128")
