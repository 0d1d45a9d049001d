"""The dry run's cases of tests/test_torch_dryrun.py, in a process of their
own (each forms and destroys a fake process group, which must not live in
a pytest worker beside the gloo groups of other tests). Not a test.

    python tests/dryrun_cases.py OUT.json

writes {"params": {arch: {mesh_kind: the local bytes of the fp32 master
tree on rank 0}}, "cells": {name: {"rec", "meta", "gathers"}}}: every
architecture's tree placed by `launch.shardings` on the fake production
meshes (32 x 8 and 2 x 32 x 8), and the tiny cells of `CELLS` counted by
`launch.dryrun.count_cell` ("gathers": each all-gather's result shape and
mesh axis).
"""

import dataclasses
import json
import sys
from pathlib import Path

# the tiny cells: (config, kind, mesh dims, variant); configs of 2 layers
# at d_model 64 whose 8 heads (and 8 KV heads, 8 experts, a shared expert
# of 64 hidden units, a vocabulary of 128) divide over "model" 8
CELLS = [(cfg, kind, dims, "baseline") for cfg in ("dense", "moe")
         for kind in ("train", "prefill", "decode") for dims in ((2, 2), (32, 8))]
CELLS.append(("dense", "train", (2, 2), "opt"))
# (kind, seq, global batch): the train batch's 8 micro-batches of 32 rows
# split over 32 data ranks as the production cells' do
SHAPES = {"train": ("train", 32, 256), "prefill": ("prefill", 32, 32),
          "decode": ("decode", 64, 32)}
ARCHS = {"dense": "qwen2-0.5b", "moe": "qwen2-moe-a2.7b"}


def tiny_config(name: str):
    from repro_torch.models import registry

    cfg = registry.reduced(registry.get_config(ARCHS[name]), d_model=64)
    return dataclasses.replace(cfg, n_heads=8, n_kv_heads=8, head_dim=8)


def cell_name(cfg: str, kind: str, dims, variant: str) -> str:
    return f"{cfg}/{kind}/{dims[0]}x{dims[1]}/{variant}"


def main(out: str):
    import torch

    torch.set_num_threads(1)
    from repro_torch.launch import dryrun, mesh as mesh_lib, shapes, shardings as sh
    from repro_torch.models import registry
    from repro_torch.optim import adamw

    result = {"params": {}, "cells": {}}
    for kind in ("single", "multi"):
        dims = tuple(mesh_lib.production_shape(kind == "multi").shape.values())
        dryrun._fake_group(int(torch.tensor(dims).prod()))
        try:
            mesh = mesh_lib.make_production_mesh(multi_pod=kind == "multi",
                                                 device_type="cuda")
            for arch in registry.list_archs():
                cfg = registry.get_config(arch)
                tree = registry.get_fns(cfg).init(cfg, device="meta", masters=True)
                placed = dryrun.placed(tree, sh.param_specs(tree, mesh, cfg), mesh)
                result["params"].setdefault(arch, {})[kind] = sum(
                    t.to_local().numel() * t.element_size() for t in adamw.leaves(placed))
        finally:
            torch.distributed.destroy_process_group()
    for cfg_name, kind, dims, variant in CELLS:
        shape = shapes.ShapeCase(f"tiny_{kind}", *SHAPES[kind])
        rec, meta, counter = dryrun.count_cell(
            ARCHS[cfg_name], "train_4k", "single", variant, model_cfg=tiny_config(cfg_name),
            shape=shape, mesh_dims=dims)
        result["cells"][cell_name(cfg_name, kind, dims, variant)] = {
            "rec": rec, "meta": meta,
            "gathers": [(axis, list(shp)) for k, axis, _, shp in counter.collectives
                        if k == "all-gather"]}
    Path(out).write_text(json.dumps(result))


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    main(sys.argv[1])
