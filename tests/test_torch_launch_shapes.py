"""Port parity of the three dense configurations and `launch/shapes.py`:
`repro_torch.configs.{granite_3_8b, yi_34b, mistral_large_123b}` field for
field against the reference's; `SHAPES`, `TRAIN_MICROBATCHES`,
`runnable`, `cases`, `shape_overrides`, `input_specs` and
`cache_specs_abstract` against `repro.launch.shapes` for every
architecture and shape (the VLM and encoder-decoder branches included);
and the
fields new to the port's dense path — granite's tied 49,155-token vocabulary,
yi's rope_theta 5e6 and mistral's 1e6, GQA groups 4, 7 and 12 at head dim
128 — through prefill and decode against `repro.models.transformer`, with
the reference's weights carried across by `convert.lm_params`.

The port's abstract inputs are meta tensors. Its attention caches are
(L, B, KV, T, hd), the reference's (L, B, T, KV, hd): the k, v, xk and xv
shapes are compared with those two axes swapped. Logits in fp32 within
atol = rtol = 1e-5 (test_torch_serve.py's: the same arithmetic in another
order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, assert_same, np_rng
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.launch import shapes as rshapes
from repro.models import registry as rreg
from repro.models import transformer as rtf
from repro_torch import convert
from repro_torch.launch import shapes as pshapes
from repro_torch.models import registry as preg
from repro_torch.models import transformer as ptf

torch.set_num_threads(1)
NEW = ("granite-3-8b", "yi-34b", "mistral-large-123b")
KV_LEAVES = ("k", "v", "xk", "xv")


def _pairs():
    """(reference cfg, port cfg) of every architecture, the VLM and the
    encoder-decoder included."""
    return [(rreg.get_config(a), preg.get_config(a)) for a in preg.list_archs()]


@pytest.mark.parametrize("arch", NEW)
def test_configs_equal_reference(arch):
    rc, pc = rreg.get_config(arch), preg.get_config(arch)
    assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
    assert pc.n_params() == rc.n_params()
    assert arch in preg.list_archs() and arch not in preg._ARCH_ITEMS


def test_shape_tables_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in pshapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in rshapes.SHAPES.items()}
    assert pshapes.TRAIN_MICROBATCHES == rshapes.TRAIN_MICROBATCHES
    for arch in preg.list_archs():
        assert pshapes.cases(arch) == rshapes.cases(arch), arch
        for shape in rshapes.SHAPES:
            assert pshapes.runnable(arch, shape) == rshapes.runnable(arch, shape)


def _compare(want, got, path=""):
    """A reference ShapeDtypeStruct tree against the port's meta tensors."""
    if isinstance(want, dict):
        assert set(want) == set(got), path
        for k in want:
            _compare(want[k], got[k], f"{path}/{k}")
        return
    assert got.device.type == "meta", path
    shape = list(want.shape)
    if path.split("/")[-1] in KV_LEAVES:
        shape[2], shape[3] = shape[3], shape[2]
    assert tuple(got.shape) == tuple(shape), (path, got.shape, want.shape)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype), (path, got.dtype)


@pytest.mark.parametrize("shape", list(rshapes.SHAPES))
def test_input_specs_equal_reference(shape):
    for rc, pc in _pairs():
        case_r, case_p = rshapes.SHAPES[shape], pshapes.SHAPES[shape]
        assert dataclasses.asdict(pshapes.shape_overrides(pc, case_p)) == \
            dataclasses.asdict(rshapes.shape_overrides(rc, case_r)), (rc.name, shape)
        _compare(rshapes.input_specs(rc, case_r), pshapes.input_specs(pc, case_p),
                 f"{rc.name}/{shape}")
        _compare(rshapes.cache_specs_abstract(rc, 3, 5000),
                 pshapes.cache_specs_abstract(pc, 3, 5000), f"{rc.name}/cache")


def _small(arch: str, group: int):
    """The reduced config of `arch` (fp32) at head dim 128 with `group`
    query heads over one KV head, its rope_theta and its vocabulary and
    tied embedding as published."""
    full = rreg.get_config(arch)
    upd = dict(n_kv_heads=1, n_heads=group, head_dim=128, vocab=full.vocab,
               dtype="float32")
    rc = dataclasses.replace(rreg.reduced(full, d_model=32), **upd)
    pc = dataclasses.replace(preg.reduced(preg.get_config(arch), d_model=32), **upd)
    assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
    return rc, pc


@pytest.mark.parametrize("arch,group", [("granite-3-8b", 4), ("yi-34b", 7),
                                        ("mistral-large-123b", 12)])
def test_prefill_and_decode_match_reference(arch, group):
    """Prefill logits and cache, then 4 teacher-forced decode steps, at each
    model's GQA group and head dim 128 with its own vocabulary and
    rope_theta (granite's tied 49,155-token table, yi's 5e6, mistral's 1e6)."""
    rc, pc = _small(arch, group)
    assert (pc.tie_embeddings, pc.rope_theta) == {
        "granite-3-8b": (True, 10_000.0), "yi-34b": (False, 5e6),
        "mistral-large-123b": (False, 1e6)}[arch]
    rp = rtf.init(jax.random.PRNGKey(0), rc)
    pp = convert.lm_params(pc, jax.tree.map(np.asarray, rp))
    assert ("head" in pp) == (not pc.tie_embeddings)
    rs = np_rng(5)
    B, S, cache_len = 2, 12, 20
    toks = rs.integers(0, pc.vocab, (B, S))
    lr, cr, pos_r = rtf.prefill(rp, rc, jnp.asarray(toks), cache_len)
    lp, cp, pos_p = ptf.prefill(pp, pc, torch.as_tensor(toks), cache_len)
    np.testing.assert_allclose(as_np(lp), np.asarray(lr), atol=1e-5, rtol=1e-5)
    assert_same(pos_r, pos_p, "next pos")
    for name in ("k", "v"):
        np.testing.assert_allclose(as_np(cp[name]),
                                   np.asarray(cr[name]).transpose(0, 1, 3, 2, 4),
                                   atol=1e-5, rtol=1e-5)
    forced = rs.integers(0, pc.vocab, (B, 4))
    for i in range(4):
        lr, cr, pos_r = rtf.decode_step(rp, rc, jnp.asarray(forced[:, i], jnp.int32),
                                        cr, pos_r)
        lp, cp, pos_p = ptf.decode_step(pp, pc, torch.as_tensor(forced[:, i]), cp, pos_p)
        np.testing.assert_allclose(as_np(lp), np.asarray(lr), atol=1e-5, rtol=1e-5,
                                   err_msg=f"decode step {i}")
