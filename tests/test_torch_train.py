"""Port parity of the training forward and backward: each family's
`loss_fn` and every gradient leaf against `jax.value_and_grad` of the
reference's `loss_fn`, at the reduced configs (`registry.reduced`) in fp32,
from the reference's own initial parameters carried across as fp32 masters
(`convert.master_params`). On the CPU the kernels run their plain versions
inside the wrappers' autograd Functions (`kernels.ops`), which recompute
them under autograd in the backward pass.

Tolerances (fp32; the same arithmetic in another order, the losses ~4.9):
the loss and the metrics within rtol 1e-5; each gradient leaf elementwise
within 2e-5 · max|reference leaf| (measured ≤ 1.3e-6). The reference's
rwkv6 runs its sequential `wkv_scan` at these lengths (its `wkv_chunked`
needs S a multiple of 256 above 256), the port the `wkv6` kernel's plain
version: the same recurrence. Remat changes no value: the port's three
modes are held to the one reference, and to each other bit for bit. The
autograd Functions give the plain versions' own gradients bit for bit.
"""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.models import registry as rreg
from repro.optim import adamw as radam
from repro.runtime import train_loop as rtl
from repro_torch import convert
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as pL
from repro_torch.models import registry as preg
from repro_torch.models import remat as premat
from repro_torch.optim import adamw as padam
from repro_torch.runtime import train_loop as ptl

torch.set_num_threads(1)
LOSS_RTOL, GRAD_RTOL = 1e-5, 2e-5
ARCHS = ["qwen2-0.5b", "qwen2-moe-a2.7b", "rwkv6-1.6b", "recurrentgemma-9b"]


@functools.lru_cache(maxsize=None)
def _model(arch: str):
    """(reference cfg, reference params (numpy), port cfg) at the reduced
    config in fp32."""
    rc = dataclasses.replace(rreg.reduced(rreg.get_config(arch)), dtype="float32")
    pc = dataclasses.replace(preg.reduced(preg.get_config(arch)), dtype="float32")
    assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
    rp = jax.tree.map(np.asarray, rreg.get_fns(rc).init(jax.random.PRNGKey(0), rc))
    return rc, rp, pc


def _batch(vocab: int, B=2, S=16, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32)}
    if masked:
        b["loss_mask"] = (rng.random((B, S)) > 0.3).astype(np.float32)
    return b


@functools.lru_cache(maxsize=None)
def _reference(arch: str, masked: bool):
    """The reference's (loss, metrics, grads) as numpy, grads in the port's
    tree (`convert.master_params`)."""
    rc, rp, pc = _model(arch)
    batch = {k: jnp.asarray(v) for k, v in _batch(rc.vocab, masked=masked).items()}
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: rreg.get_fns(rc).loss_fn(p, rc, batch), has_aux=True)(
        jax.tree.map(jnp.asarray, rp))
    g = convert.master_params(pc, jax.tree.map(np.asarray, grads))
    return float(loss), {k: float(v) for k, v in metrics.items()}, g


def _port(arch: str, masked: bool, remat: str):
    rc, rp, pc = _model(arch)
    params = convert.master_params(pc, rp)
    batch = {k: torch.as_tensor(v) for k, v in _batch(rc.vocab, masked=masked).items()}
    return ptl.loss_and_grads(preg.get_fns(pc), pc, params, batch, remat)


def _assert_grads_close(want, got):
    for i, (a, b) in enumerate(zip(padam.leaves(want), padam.leaves(got))):
        assert a.shape == b.shape and b.dtype == torch.float32
        scale = float(a.abs().max())
        err = float((a - b).abs().max())
        assert err <= GRAD_RTOL * scale + 1e-30, (i, tuple(a.shape), err, scale)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_grads_match_reference(arch, masked):
    loss_r, metrics_r, grads_r = _reference(arch, masked)
    outs = {}
    for remat in premat.MODES:
        loss, metrics, grads = _port(arch, masked, remat)
        np.testing.assert_allclose(float(loss), loss_r, rtol=LOSS_RTOL)
        assert set(metrics) == set(metrics_r)
        for k, v in metrics.items():
            np.testing.assert_allclose(float(v), metrics_r[k], rtol=LOSS_RTOL, err_msg=k)
        _assert_grads_close(grads_r, grads)
        outs[remat] = (loss, grads)
    for remat in ("full", "dots"):       # remat changes memory, never a value
        assert torch.equal(outs[remat][0], outs["none"][0])
        for a, b in zip(padam.leaves(outs["none"][1]), padam.leaves(outs[remat][1])):
            assert torch.equal(a, b), remat


def test_moe_metrics_aggregate_over_layers():
    """The MoE forward's metrics: `moe_aux` summed over the layers, the
    dropped shares averaged, the loss the cross entropy plus `moe_aux`."""
    loss_r, metrics_r, _ = _reference("qwen2-moe-a2.7b", False)
    assert set(metrics_r) == {"moe_aux", "moe_dropped", "moe_dropped_pre_steal", "xent"}
    loss, metrics, _ = _port("qwen2-moe-a2.7b", False, "none")
    assert metrics["xent"] is not None and float(metrics["moe_aux"]) > 0
    np.testing.assert_allclose(float(metrics["moe_dropped_pre_steal"]),
                               metrics_r["moe_dropped_pre_steal"], rtol=0)


def test_softmax_xent_matches_reference():
    from repro.models import layers as rL
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 7))
    mask = (rng.random((3, 7)) > 0.5).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        for z in (0.0, 1e-4):
            want = rL.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                   None if m is None else jnp.asarray(m), z_weight=z)
            got = pL.softmax_xent(torch.as_tensor(logits), torch.as_tensor(labels),
                                  None if m is None else torch.as_tensor(m), z_weight=z)
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_masters_cast_at_use_leave_serving_unchanged(arch):
    """The serving parameters are the masters' draws cast once to cfg.dtype;
    the cast at use returns a stored-in-type weight itself, so a bf16
    forward from the masters equals the serving one bit for bit."""
    pc = preg.reduced(preg.get_config(arch))
    fns = preg.get_fns(pc)
    serving = fns.init(pc, seed=0, device="cpu")
    masters = fns.init(pc, seed=0, device="cpu", masters=True)
    for s, m in zip(padam.leaves(serving), padam.leaves(masters)):
        assert m.dtype == torch.float32
        assert torch.equal(s, m.to(s.dtype))
        assert pL.cast(s, s.dtype) is s
    tokens = torch.as_tensor(_batch(pc.vocab, S=8)["tokens"])
    want = fns.prefill(serving, pc, tokens, 16)[0]
    got = fns.prefill(masters, pc, tokens, 16)[0]
    assert want.dtype == got.dtype == torch.bfloat16
    assert torch.equal(want, got)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-moe-a2.7b"])
def test_microbatch_accumulation_matches_reference(arch):
    """One train step at 1 and 2 micro-batches (tests/test_system.py's
    micro-batch case): the port against the reference at each count, and
    the port's two counts against each other as the reference's test
    holds them (the loss to 1e-4, parameters to 3e-3)."""
    rc, rp, pc = _model(arch)
    oc = dict(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    batch = _batch(rc.vocab, B=4, S=16, seed=5)
    got = {}
    for n in (1, 2):
        rstep = rtl.make_train_step(rc, rreg.get_fns(rc), radam.AdamWConfig(**oc),
                                    num_microbatches=n)
        rparams = jax.tree.map(jnp.asarray, rp)
        r_new, r_opt, r_m = rstep(rparams, radam.init(rparams),
                                  {"tokens": jnp.asarray(batch["tokens"])})
        pstep = ptl.make_train_step(pc, preg.get_fns(pc), padam.AdamWConfig(**oc),
                                    num_microbatches=n)
        pparams = convert.master_params(pc, rp)
        p_new, p_opt, p_m = pstep(pparams, padam.init(pparams),
                                  {"tokens": torch.as_tensor(batch["tokens"])})
        assert set(p_m) == set(r_m)
        for k in r_m:
            np.testing.assert_allclose(float(p_m[k]), float(r_m[k]), rtol=LOSS_RTOL,
                                       err_msg=k)
        assert int(p_opt.count) == int(r_opt.count) == 1
        # the first moment is (1 - b1)·g: the gradients' tolerance
        _assert_grads_close(convert.master_params(pc, jax.tree.map(np.asarray, r_opt.m)),
                            p_opt.m)
        # Adam's first step is ~lr·g/(|g| + eps): where |g| is within a few
        # eps of 0 the gradients' last-bit differences move it by a share of
        # lr (measured: 2.7e-3·lr in the dense model, 2.5e-2·lr at 1 of 4096
        # expert weights), so the parameters are held to 5e-2·lr
        want = convert.master_params(pc, jax.tree.map(np.asarray, r_new))
        for a, b in zip(padam.leaves(want), padam.leaves(p_new)):
            np.testing.assert_allclose(b.detach().numpy(), a.numpy(),
                                       atol=5e-2 * oc["lr_peak"], rtol=0)
        got[n] = (float(p_m["loss"]), [t.detach() for t in padam.leaves(p_new)])
    np.testing.assert_allclose(got[1][0], got[2][0], rtol=1e-4)
    assert max(float((a - b).abs().max()) for a, b in zip(got[1][1], got[2][1])) < 3e-3


@pytest.mark.parametrize("name", ["flash_attention", "wkv6", "rglru"])
def test_autograd_functions_equal_plain_autograd(name):
    """On the CPU a wrapper given an input that needs a gradient runs its
    autograd Function (forward: the plain version; backward: the plain
    version recomputed under autograd), whose gradients are the plain
    version's own, bit for bit; without one it never enters it."""
    rng = np.random.default_rng(7)

    def t(*shape, lo=None):
        a = rng.standard_normal(shape).astype(np.float32)
        if lo is not None:
            a = 1 / (1 + np.exp(-a)) * (1 - lo) + lo
        return torch.as_tensor(a)

    if name == "flash_attention":
        args = (t(2, 2, 3, 9, 8), t(2, 2, 9, 8), t(2, 2, 9, 8))
        kw = dict(causal=True, window=4)
    elif name == "wkv6":
        args = (t(2, 6, 3, 4), t(2, 6, 3, 4), t(2, 6, 3, 4), t(2, 6, 3, 4, lo=0.5),
                t(3, 4), t(2, 3, 4, 4))
        kw = {}
    else:
        args = (t(2, 7, 5), t(2, 7, 5, lo=0.0), t(2, 7, 5, lo=0.0), t(5), t(2, 5))
        kw = {}
    fn, plain = getattr(ops, name), getattr(ref, name)

    def grads(f):
        xs = [a.clone().requires_grad_(True) for a in args]
        out = f(*xs, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        w = [torch.as_tensor(rng.standard_normal(o.shape).astype(np.float32))
             for o in outs]
        total = sum((o * g).sum() for o, g in zip(outs, w))
        return outs, torch.autograd.grad(total, xs)

    state = rng.bit_generator.state
    outs_k, g_k = grads(fn)
    rng.bit_generator.state = state
    outs_p, g_p = grads(plain)
    for a, b in zip(outs_k + g_k, outs_p + g_p):
        assert torch.equal(a, b)
    fun = {"flash_attention": ops._FlashAttention, "wkv6": ops._Wkv6,
           "rglru": ops._Rglru}[name]
    with mock.patch.object(fun, "apply", side_effect=AssertionError("autograd path")):
        with torch.no_grad():
            fn(*[a.requires_grad_(True) for a in args], **kw)
        fn(*[a.detach() for a in args], **kw)
