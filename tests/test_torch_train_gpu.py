"""The training path's autograd Functions on a CUDA card (`gpu` tests; each
skips where torch sees no card, deciding inside the test). No JAX here.

  * `flash_attention`, `wkv6` and `rglru` under autograd: the forward is
    the hand-written kernel (one launch, counted), within the kernel's
    tolerance of the plain version; the backward recomputes the plain
    version from the saved inputs, so the gradients equal the plain path's
    own for the same output gradient bit for bit, and it launches nothing;
  * a dense model's `loss_fn` at head dim 64 (the kernel's) and its
    gradients against the plain path: the loss within 0.02, each gradient
    leaf within a relative L2 error of 0.05 (bf16 compute).
"""

import dataclasses
from unittest import mock

import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop

pytestmark = pytest.mark.gpu


def _inputs(name, dtype):
    gen = torch.Generator(device="cuda").manual_seed(0)

    def t(*shape, lo=None, dt=dtype):
        a = torch.randn(shape, generator=gen, device="cuda")
        if lo is not None:
            a = torch.sigmoid(a) * (1 - lo) + lo
        return a.to(dt)

    if name == "flash_attention":
        return (t(2, 2, 7, 160, 64), t(2, 2, 160, 64), t(2, 2, 160, 64)), dict(causal=True)
    if name == "wkv6":
        f32 = torch.float32
        return (t(2, 40, 4, 64), t(2, 40, 4, 64), t(2, 40, 4, 64),
                t(2, 40, 4, 64, lo=0.5, dt=f32), t(4, 64, dt=f32), None), {}
    return (t(2, 50, 256), t(2, 50, 256, lo=0.0), t(2, 50, 256, lo=0.0),
            t(256, dt=torch.float32), None), {}


@pytest.mark.parametrize("name,dtype", [("flash_attention", torch.bfloat16),
                                        ("flash_attention", torch.float32),
                                        ("wkv6", torch.bfloat16), ("wkv6", torch.float32),
                                        ("rglru", torch.bfloat16), ("rglru", torch.float32)])
def test_autograd_function_against_plain(name, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args, kw = _inputs(name, dtype)
    kernel, plain = getattr(ops, name), getattr(ref, name)

    def run(fn):
        xs = [None if a is None else a.clone().requires_grad_(a.is_floating_point())
              for a in args]
        out = fn(*xs, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        g = torch.randn(outs[0].shape, generator=torch.Generator(device="cuda").manual_seed(1),
                        device="cuda").to(outs[0].dtype)
        before = dict(ops.LAUNCHES)
        grads = torch.autograd.grad(outs[0], [x for x in xs if x is not None], g)
        assert ops.LAUNCHES == before          # the backward launches nothing
        return outs[0], grads

    ops.reset_launch_counts()
    out_k, g_k = run(kernel)
    assert ops.LAUNCHES[name] == 1
    out_p, g_p = run(plain)
    tol = 2e-2 + 2 ** -7 * out_p.float().abs() if dtype == torch.bfloat16 else \
        1e-4 * out_p.float().abs().max() + 1e-5
    assert bool(((out_k.float() - out_p.float()).abs() <= tol).all())
    for a, b in zip(g_k, g_p):
        assert torch.equal(a, b)


def test_dense_loss_and_grads_against_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = dataclasses.replace(registry.get_config("qwen2-0.5b"), n_layers=2, d_model=256,
                              n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512, vocab=1000)
    fns = registry.get_fns(cfg)
    params = fns.init(cfg, seed=0, device="cuda", masters=True)
    tokens = torch.randint(0, cfg.vocab, (4, 128), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(2))
    ops.reset_launch_counts()
    loss_k, _, g_k = train_loop.loss_and_grads(fns, cfg, params, {"tokens": tokens})
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    with mock.patch.object(ops, "flash_attention", ref.flash_attention):
        loss_p, _, g_p = train_loop.loss_and_grads(fns, cfg, params, {"tokens": tokens})
    assert abs(float(loss_k) - float(loss_p)) < 0.02
    for a, b in zip(adamw.leaves(g_k), adamw.leaves(g_p)):
        assert float((a - b).norm()) <= 0.05 * float(b.norm()) + 1e-12
