"""The sharded train step on a CUDA card (`gpu` tests; each skips where
torch sees no card, deciding inside the test). No JAX here.

  * `launch.train.build_sharded_train` on a 1 x 1 ("data", "model")
    `DeviceMesh` over an NCCL process group of one against the unsharded
    `make_train_step` from the same state: qwen2-0.5b at full width and 2
    layers, batch 2 x 128, 2 steps; `flash_attention` launched once a layer
    a step inside `local_map`; the losses and every parameter leaf within
    a relative L2 gap of 1e-5 (the same kernels on both sides);
  * the launcher with `--reduced` on the card is refused cleanly: the
    reduced granite-3-8b has head dim 8, which the attention kernels were
    not built for (64, 128, 256), and the wrapper raises before any launch.
"""

import dataclasses

import pytest
import torch

from repro_torch.data import synthetic
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop

pytestmark = pytest.mark.gpu


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_one_by_one_nccl_mesh_equals_unsharded_step():
    _needs_card()
    import torch.distributed as dist

    cfg = dataclasses.replace(registry.get_config("qwen2-0.5b"), n_layers=2)
    fns = registry.get_fns(cfg)
    mesh, formed = launch_train.launch_mesh(None)
    try:
        opt_cfg = adamw.AdamWConfig(lr_peak=3e-4, warmup_steps=2, total_steps=4)
        init_fn, step_fn, _ = launch_train.build_sharded_train(
            cfg.name, mesh, model_cfg=cfg, opt_cfg=opt_cfg)
        params = fns.init(cfg, seed=0, device="cuda", masters=True)
        opt = adamw.init(params)
        sp, so = init_fn(state=adamw.tree_map(lambda t: t.clone(), (params, opt)))
        step = train_loop.make_train_step(cfg, fns, opt_cfg)
        dc = synthetic.DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=2)
        for i in range(2):
            batch = train_loop._make_batch(cfg, dc, i, train_loop.TrainConfig(), "cuda")
            params, opt, m = step(params, opt, batch)
            ops.reset_launch_counts()
            sp, so, ms = step_fn(sp, so, batch)
            torch.cuda.synchronize()
            assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
            loss = float(ms["loss"].full_tensor())
            assert abs(loss - float(m["loss"])) <= 1e-5 * abs(float(m["loss"]))
        for a, b in zip(adamw.leaves(params), adamw.leaves(sp)):
            gap = float((b.full_tensor() - a).norm()) / max(float(a.norm()), 1e-30)
            assert gap <= 1e-5
    finally:
        if formed:
            dist.destroy_process_group()


def test_reduced_launcher_is_refused_on_the_card():
    _needs_card()
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="not built for head dim 8"):
        launch_train.main(["--arch", "granite-3-8b", "--reduced", "--steps", "2",
                           "--batch", "2", "--seq", "16"])
    assert ops.LAUNCHES["flash_attention"] == 0
