"""Both sides of the sharded train step's parity tests. Not a test.

    python tests/sharded_train_reference.py OUT.npz

runs the reference's `repro.launch.train.build_sharded_train` (JAX on the
CPU with `DEVICES` forced host devices, set by the parent in XLA_FLAGS
before JAX is imported) on a (2, 2) ("data", "model") mesh for each of
`CASES` (router columns scaled by `ROUTER_SCALE`), and writes, keys
``"<case>/..."``: the initial parameters (``init/<path>``), the loss of
each step (``loss``), AdamW's first moment after each step s
(``m<s>/<path>``) and the parameters after the last (``p/<path>``), paths
in the reference's stacked tree.

`port_worker` is one rank of the port's side (`torch.multiprocessing`
spawn, gloo): the same cases on a 2 x 2 `DeviceMesh` from the reference's
initial parameters, keys ``"<case>/..."`` in the port's paths, each
leaf's placements checked against its spec, and (``crossings``) each MoE
layer call's slots that the neighbor steal moves from one "model" rank's
experts to the next's.
"""

import dataclasses
import os
import sys
from pathlib import Path

import numpy as np

ARCH = "qwen2-0.5b"        # the dense family
D_MODEL = 48
STEPS = 3
# AdamW: the train-loop tests' settings (lr 3e-3 after 2 warm-up steps)
OPT = dict(lr_peak=3e-3, warmup_steps=2, total_steps=5)
DATA = dict(seq_len=32, global_batch=8)
# name -> (architecture, micro-batches, remat)
CASES = {"plain": (ARCH, 1, "none"), "mb2-full": (ARCH, 2, "full"),
         "rwkv6": ("rwkv6-1.6b", 1, "none"), "hybrid": ("recurrentgemma-9b", 1, "none"),
         "moe": ("qwen2-moe-a2.7b", 1, "none"), "vlm": ("llava-next-mistral-7b", 1, "none"),
         "encdec": ("whisper-tiny", 1, "none"), "seqpar": (ARCH, 1, "none")}
# cases run with the sequence-parallel residual (`seq_shard_axis` "model",
# the dry run's variant "opt") on both sides
SEQ_SHARDED = {"seqpar"}
# case -> (experts, factor): the initial router's columns of the last
# expert of each "model" rank's 4 (both sides start from them) scaled, so
# those experts are chosen more often than the rest, overflow, and the
# neighbor steal moves slots across the ranks' boundary
ROUTER_SCALE = {"moe": ((3, 7), 3.0)}
DEVICES = 4


def _nested(flat: dict, prefix: str) -> dict:
    """The reference's nested tree from `flat`'s keys under `prefix`."""
    out = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node = out
        *parts, last = key[len(prefix):].split("/")
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = v
    return out


def reference(out: str):
    import jax

    from repro.data import synthetic
    from repro.launch import shardings as rsh
    from repro.launch import train as rlt
    from repro.models import registry
    from repro.optim import adamw
    from repro.runtime import train_loop as rtl

    # Auto axes: GSPMD propagates the shardings, as the reference's pjit
    # launcher assumes (with JAX's default Explicit axes its step raises a
    # sharding-type error at the first dense product)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    built, first, inits = {}, {}, {}
    for name, (arch, nmb, remat) in CASES.items():
        cfg = dataclasses.replace(registry.reduced(registry.get_config(arch),
                                                   d_model=D_MODEL), dtype="float32",
                                  seq_shard_axis="model" if name in SEQ_SHARDED else "")
        init_jit, step_jit, specs = rlt.build_sharded_train(
            arch, mesh, model_cfg=cfg, num_microbatches=nmb, remat=remat,
            opt_cfg=adamw.AdamWConfig(**OPT))
        with jax.set_mesh(mesh):
            if arch not in first:   # one init compile an architecture
                first[arch] = jax.device_get(init_jit(jax.random.PRNGKey(0)))
        if name in ROUTER_SCALE:
            experts, factor = ROUTER_SCALE[name]

            def scaled(path, w):
                if all(getattr(k, "key", None) != "router" for k in path):
                    return w
                f = np.ones(w.shape[-1], w.dtype)
                f[list(experts)] = factor
                return w * f
            first[arch] = (jax.tree_util.tree_map_with_path(scaled, first[arch][0]),
                           first[arch][1])
        built[name] = cfg, step_jit, specs
        for p, leaf in zip(rsh.tree_paths(first[arch][0]), jax.tree.leaves(first[arch][0])):
            inits[f"{name}/init/{p}"] = np.asarray(leaf)
    # the initial parameters first: the port's side starts from them while
    # the reference's steps run
    np.savez(init_path(out) + ".partial.npz", **inits)
    os.replace(init_path(out) + ".partial.npz", init_path(out))
    saved = dict(inits)
    for name, (cfg, step_jit, specs) in built.items():
        dc = synthetic.DataConfig(vocab=cfg.vocab, **DATA)
        with jax.set_mesh(mesh):
            params, opt = jax.device_put(first[CASES[name][0]], (specs["params"], specs["opt"]))
            paths = rsh.tree_paths(params)
            losses = []
            for step in range(STEPS):
                batch = rtl._make_batch(cfg, dc, step, rtl.TrainConfig())
                params, opt, metrics = step_jit(params, opt, batch)
                losses.append(float(metrics["loss"]))
                for p, leaf in zip(paths, jax.tree.leaves(opt.m)):
                    saved[f"{name}/m{step}/{p}"] = np.asarray(leaf)
            for p, leaf in zip(paths, jax.tree.leaves(params)):
                saved[f"{name}/p/{p}"] = np.asarray(leaf)
        saved[f"{name}/loss"] = np.asarray(losses)
    np.savez(out, **saved)


def init_path(out: str) -> str:
    """Where `reference(out)` writes the initial parameters before its
    steps."""
    return str(out).removesuffix(".npz") + "-init.npz"


def port_cfg(arch: str = ARCH):
    from repro_torch.models import registry

    return dataclasses.replace(registry.reduced(registry.get_config(arch),
                                                d_model=D_MODEL), dtype="float32")


def port_worker(rank: int, world: int, init_method: str, init_npz: str, out: str):
    """One rank of the port's 2 x 2 runs of every case from the reference's
    initial parameters (`init_path`); rank 0 writes."""
    import torch
    import torch.distributed as dist

    from repro_torch import convert
    from repro_torch.data import synthetic
    from repro_torch.models import layers as plyr
    from repro_torch.models import moe as pmoe
    from repro_torch.launch import mesh as pmesh
    from repro_torch.launch import shardings as sh
    from repro_torch.launch import train as plt
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop as ptl

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, world_size=world, rank=rank)
    # each MoE layer's slots that the neighbor steal moves across a boundary
    # of the "model" ranks' experts (the EP ring's hop), on its whole input
    crossings = []
    expert_shards = plyr.expert_shards

    def counted(fn, params, x, cfg):
        with torch.no_grad():
            router = {k: v.full_tensor() for k, v in params["router"].items()}
            crossings.append(pmoe.cross_shard_steals({"router": router}, x.full_tensor(),
                                                     cfg, x.device_mesh.size(1)))
        return expert_shards(fn, params, x, cfg)

    plyr.expert_shards = counted
    try:
        mesh = pmesh.make_mesh((2, 2), device_type="cpu")
        ref = dict(np.load(init_npz))
        saved = {}
        for name, (arch, nmb, remat) in CASES.items():
            cfg = dataclasses.replace(port_cfg(arch), seq_shard_axis="model"
                                      if name in SEQ_SHARDED else "")
            dc = synthetic.DataConfig(vocab=cfg.vocab, **DATA)
            init_fn, step_fn, specs = plt.build_sharded_train(
                arch, mesh, model_cfg=cfg, num_microbatches=nmb, remat=remat,
                opt_cfg=adamw.AdamWConfig(**OPT))
            params = convert.master_params(cfg, _nested(ref, f"{name}/init/"))
            params, opt = init_fn(state=(params, adamw.init(params)))
            wrong = []
            sh.zip_specs(lambda x, s: wrong.append(x.placements != s.placements),
                         (params, opt), (specs["params"], specs["opt"]))
            losses = []
            for step in range(STEPS):
                batch = ptl._make_batch(cfg, dc, step, ptl.TrainConfig())
                params, opt, metrics = step_fn(params, opt, batch)
                losses.append(float(metrics["loss"].full_tensor()))
                for p, leaf in sh.named_leaves(opt.m):
                    # a copy: a replicated leaf's full tensor is its local
                    # one, which later steps update in place
                    saved[f"{name}/m{step}/{p}"] = leaf.full_tensor().numpy().copy()
            sh.zip_specs(lambda x, s: wrong.append(x.placements != s.placements),
                         (params, opt), (specs["params"], specs["opt"]))
            for p, leaf in sh.named_leaves(params):
                saved[f"{name}/p/{p}"] = leaf.full_tensor().detach().numpy()
            saved[f"{name}/loss"] = np.asarray(losses)
            saved[f"{name}/crossings"] = np.asarray(crossings, dtype=np.int64)
            crossings.clear()
            saved[f"{name}/misplaced"] = np.asarray(sum(wrong))
        if rank == 0:
            np.savez(out, **saved)
    finally:
        plyr.expert_shards = expert_shards
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
        sys.exit("set XLA_FLAGS=--xla_force_host_platform_device_count=N first")
    reference(sys.argv[1])
