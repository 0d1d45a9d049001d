"""Multi-node dry run: every (arch x shape x mesh) cell of the launch stack
run once on a fake 256- or 512-rank mesh, with no card, counting one
device's work. The port of `repro.launch.dryrun`.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --out results/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k

Per cell this shows that the sharding rules are coherent at the production
mesh (every op of the step has a placement, every collective a group) and
gives the roofline terms of one device: FLOPs, bytes, collective bytes by
kind and by mesh axis, argument, output and peak bytes.

How a cell runs. A "fake" process group (`torch.testing._internal.
distributed.fake_pg`: every collective returns at once, nothing is sent)
of 256 or 512 ranks, this process rank 0, carries
`launch.mesh.make_production_mesh(device_type="cuda")`: typed "cuda" so
that DTensor picks the collectives NCCL would run (a "cpu" mesh swaps
all-to-all for all-gathers), yet no card is touched. The parameters, AdamW's
moments, the batch and the recurrent states are DTensors placed by
`launch.shardings` (KV caches as the attention kernels read them,
`serve_cache`) whose local shards lie on the meta device (shapes and types,
no memory), and the cell's step runs on them as a user would call it: for
train cells `launch.train.build_sharded_train`'s step (forward, backward
and AdamW, the reference's micro-batch count and remat choice), for
prefill and decode cells the family's `prefill` (the VLM's cache holding
its prefix too) and `decode_step`. The hand-written kernels run inside
`local_map` on local meta tensors, through their meta path (`kernels.ops`:
the kernels' outputs and a FLOP formula each).

What is counted (`DeviceCounter`, a `TorchDispatchMode`): an op on DTensors
is handed on to DTensor (the mode returns NotImplemented), whose
redistributions and local ops then reach the mode on local tensors, so the
counts are rank 0's own (the local op, not the logical one: a matmul with
its rows sharded 32 ways counts 1/32 of the global FLOPs); ops DTensor runs
under its own fake mode to propagate shapes are skipped. FLOPs from
`torch.utils.flop_counter`'s formulas of the local ops (and the kernels'
own); bytes: each op's input and output bytes, views and allocations
apart; collectives from the c10d functional ops (and DTensor's
`shard_dim_alltoall`), their result bytes a device, an all-reduce twice
(the reference's convention), by kind and by the mesh axis of their group;
memory: the live bytes of the local meta storages, each counted when an
op first makes it (or for the arguments, when the cell starts) and
released when its storage is freed (a weak reference's callback), the peak
of that sum; argument bytes the local parameters, optimizer state, inputs
and caches; output bytes the step's outputs' distinct storages.

Roofline terms, from H100 datasheet peaks (NVIDIA H100 SXM5 80 GB), not
measurements: compute at the dense bf16 tensor-core rate, memory at the
HBM3 rate, collectives at NVLink's rate a direction for "model" (inside a
node, `launch.mesh`'s layout) and at 400 Gb/s a card for "data" and "pod"
(across nodes), each axis's bytes over its own rate, summed.

Results are cached as JSON per cell (re-runs skip green cells unless
`--force`).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import ops
from ..models import layers, registry
from ..optim import adamw
from . import mesh as mesh_lib
from . import shapes as shapes_lib
from . import shardings as sh

# H100 SXM5 datasheet peaks (§Roofline), not measurements
PEAK_FLOPS = 989e12           # dense bf16 FLOP/s a card
HBM_BW = 3.35e12              # bytes/s a card
NVLINK_BW = 450e9             # bytes/s a direction a card, inside a node ("model")
NET_BW = 50e9                 # bytes/s a card (400 Gb/s), across nodes ("data", "pod")
AXIS_BW = {"model": NVLINK_BW, "data": NET_BW, "pod": NET_BW}

# the reference's remat threshold: parameters of the initialised tree
REMAT_FULL_ABOVE = 20e9

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
}
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
             "wait_tensor", "_wrap_tensor_autograd", "lift_fresh"}


def _pow2_divisor(n: int, cap: int = 1024) -> int:
    d = 1
    while d * 2 <= cap and n % (d * 2) == 0:
        d *= 2
    return d


def apply_variant(cfg, variant: str):
    """'baseline' is paper-faithful; 'opt' is the reference's hillclimbed
    configuration: the sequence-parallel residual (`seq_shard_axis`,
    `layers.seq_sharded`; "" for MoE archs, where the reference measured a
    regression) and causal block skipping (`attn_skip_masked`, which moves
    no count here: the port's `flash_attention` kernel skips the key tiles
    wholly outside the causal and window band whatever the flag,
    `kernels/csrc/flash_attention.cu:78`, and its FLOP formula counts the
    visible pairs); remat is chosen in `build_cell`."""
    if variant == "opt":
        seq_axis = "" if cfg.moe is not None else "model"
        cfg = dataclasses.replace(cfg, seq_shard_axis=seq_axis,
                                  attn_skip_masked=bool(cfg.attn_chunk_q))
    return cfg


def cell_config(arch: str, shape_name: str, variant: str = "baseline", cfg=None,
                shape=None):
    """The cell's model config (`cfg`, default the arch's): the shape's
    overrides, the variant, and the VLM's chunk re-fit to the prefix + text
    length (the reference's). `shape` a `shapes.ShapeCase` in place of
    SHAPES[shape_name]."""
    cfg = cfg or registry.get_config(arch)
    shape = shape or shapes_lib.SHAPES[shape_name]
    cfg = apply_variant(shapes_lib.shape_overrides(cfg, shape), variant)
    if cfg.family == "vlm" and cfg.attn_chunk_q:
        c = _pow2_divisor(shape.seq_len + cfg.n_frontend_tokens)
        cfg = dataclasses.replace(cfg, attn_chunk_q=c, attn_chunk_k=c)
    return cfg


def tree_params(tree) -> int:
    """Elements of every leaf of a (meta) tree."""
    return sum(t.numel() for t in adamw.leaves(tree))


def remat_choice(n_tree: int, variant: str) -> str:
    """The reference's: full remat above 20e9 parameters (of the
    initialised tree, here), else none; 'dots' for full under 'opt'."""
    remat = "full" if n_tree > REMAT_FULL_ABOVE else "none"
    return "dots" if variant == "opt" and remat == "full" else remat


def placed(tree, specs, mesh):
    """Every leaf of a meta tree as a DTensor on `mesh` under its spec, its
    local shard a meta tensor (no data, no communication)."""
    return sh.zip_specs(lambda x, spec: layers.placed_zeros(
        x.shape, x.dtype, "meta", mesh, sh.placements(spec, mesh)), tree, specs)


def serve_cache(cache, like, mesh):
    """A decode cell's cache (a meta tree of `shapes.input_specs`) placed as
    the port's decode path writes and reads it in place: a KV cache (L, B,
    KV, T, hd) as the attention kernels take their keys (rows over the data
    dims, KV heads over "model" when they divide, `layers.sharded_zeros`),
    where the reference's rule (`shardings.cache_specs`) puts T over
    "model", which the decode kernel, taking a row's whole cache, does not
    take; a recurrent state by `shardings.cache_specs`."""
    kv = {n: layers.sharded_zeros(t.shape, t.dtype, like, 1, 2)
          for n, t in cache.items() if n in ("k", "v", "xk", "xv")}
    rest = {n: t for n, t in cache.items() if n not in kv}
    return {**kv, **placed(rest, sh.cache_specs(rest, mesh), mesh)}


def build_cell(arch: str, shape_name: str, mesh, variant: str = "baseline",
               model_cfg=None, shape=None):
    """(run, meta) for one cell: `run()` places the cell's arguments on
    `mesh` and returns (step, args), `step(*args)` the cell's work.
    `model_cfg` and `shape` (a `shapes.ShapeCase`) replace the arch's
    config and SHAPES[shape_name] (the tests' small cells)."""
    cfg = cell_config(arch, shape_name, variant, model_cfg, shape)
    shape = shape or shapes_lib.SHAPES[shape_name]
    fns = registry.get_fns(cfg)
    ins = shapes_lib.input_specs(cfg, shape)
    meta = {"arch": arch, "shape": shape_name, "kind": shape.kind,
            "n_params": cfg.n_params(), "n_active": cfg.n_active_params(),
            "seq": shape.seq_len, "batch": shape.global_batch}

    if shape.kind == "train":
        from .train import build_sharded_train

        tree = fns.init(cfg, device="meta", masters=True)
        n_tree = tree_params(tree)
        nm = shapes_lib.TRAIN_MICROBATCHES.get(arch, 8)
        remat = remat_choice(n_tree, variant)
        meta.update(num_microbatches=nm, remat=remat, n_tree=n_tree)

        def run():
            _, step_fn, specs = build_sharded_train(arch, mesh, model_cfg=cfg,
                                                    num_microbatches=nm, remat=remat)
            pspecs = sh.param_specs(tree, mesh, cfg)
            params = placed(tree, pspecs, mesh)
            opt = placed(adamw.init(tree), sh.opt_specs(pspecs), mesh)
            batch = placed(ins["batch"], sh.batch_specs(ins["batch"], mesh), mesh)
            return step_fn, (params, opt, batch)
        return run, meta

    tree = fns.init(cfg, device="meta")
    meta["n_tree"] = tree_params(tree)

    def serve_args():
        return placed(tree, sh.param_specs(tree, mesh, cfg), mesh)

    if shape.kind == "prefill":
        def step(params, tokens, extras):
            if cfg.family == "encdec":
                return fns.prefill(params, cfg, tokens, shape.seq_len, frames=extras["frames"])
            if cfg.family == "vlm":     # the cache holds the prefix too
                return fns.prefill(params, cfg, tokens,
                                   shape.seq_len + cfg.n_frontend_tokens,
                                   prefix_embeds=extras["prefix_embeds"])
            return fns.prefill(params, cfg, tokens, shape.seq_len)

        def run():
            args = placed(ins, sh.batch_specs(ins, mesh), mesh)
            extras = {k: v for k, v in args.items() if k != "tokens"}
            return step, (serve_args(), args["tokens"], extras)
        return run, meta

    def run():
        token = placed(ins["token"], sh.batch_specs(ins["token"], mesh), mesh)
        pos = placed(ins["pos"], sh.batch_specs(ins["pos"], mesh), mesh)
        cache = serve_cache(ins["cache"], token, mesh)
        return (lambda p, t, c, q: fns.decode_step(p, cfg, t, c, q)), (
            serve_args(), token, cache, pos)
    return run, meta


# --------------------------------------------------------------------------- #
# Counting one device's work
# --------------------------------------------------------------------------- #
def _tensors(tree):
    import torch.utils._pytree as pytree

    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


class DeviceCounter(TorchDispatchMode):
    """Rank 0's FLOPs, bytes, collectives and live memory under the mode
    (see the module docstring). `axis_of` maps a process group's name to
    its mesh axis."""

    def __init__(self, axis_of: dict):
        super().__init__()
        from torch.utils import flop_counter

        ops._meta_ops()        # the kernels' FLOP formulas, registered
        self.formulas = flop_counter.flop_registry
        self.axis_of = axis_of
        self.flops = 0
        self.flops_by_op: dict[str, int] = {}
        self.bytes = 0
        # (kind, axis, bytes, the result's shape)
        self.collectives: list[tuple[str, str, int, tuple]] = []
        self.live = self.peak = 0
        self._storages: dict[int, weakref.ref] = {}

    def hold(self, tensors) -> int:
        """Count the storages of `tensors` as live (the arguments); returns
        the bytes newly counted."""
        before = self.live
        for t in tensors:
            self._track(_local(t))
        return self.live - before

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = weakref.ref(st, functools.partial(self._freed, key, n))
        self.live += n
        self.peak = max(self.peak, self.live)

    def _freed(self, key: int, n: int, _ref) -> None:
        if self._storages.pop(key, None) is not None:
            self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out         # DTensor's shape propagation: no device work
        name = func.__name__.split(".")[0]
        outs = _tensors(out)
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            group = next((a for a in list(args) + list(kwargs.values())
                          if isinstance(a, str) and a in self.axis_of), None)
            nbytes = sum(_nbytes(t) for t in outs)
            self.collectives.append((kind, self.axis_of.get(group, "other"),
                                     2 * nbytes if kind == "all-reduce" else nbytes,
                                     tuple(outs[0].shape) if outs else ()))
        else:
            formula = self.formulas.get(func._overloadpacket)
            if formula is not None:
                n = int(formula(*args, **kwargs, out_val=out))
                op = str(func._overloadpacket).removeprefix("aten.")
                self.flops += n
                self.flops_by_op[op] = self.flops_by_op.get(op, 0) + n
            views = any(r.alias_info is not None and not r.alias_info.is_write
                        for r in func._schema.returns)
            if not views and name not in _NO_BYTES:
                self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)) + outs)
        for t in outs:
            self._track(t)
        return out


def collective_bytes(ops_list) -> dict:
    """(kind, axis, bytes, ...) records summed by kind in the reference's
    layout (`total`, `op_counts`), plus `by_axis`: bytes by mesh axis."""
    out, counts, by_axis = {}, {}, {}
    for kind, axis, nbytes, *_ in ops_list:
        out[kind] = out.get(kind, 0.0) + float(nbytes)
        counts[kind] = counts.get(kind, 0) + 1
        by_axis[axis] = by_axis.get(axis, 0.0) + float(nbytes)
    out["total"] = sum(out.values())
    out["op_counts"] = counts
    out["by_axis"] = by_axis
    return out


def roofline(rec: dict) -> dict:
    """The three terms (seconds) and the bottleneck, the reference's
    choice of the largest."""
    by_axis = rec["collectives"]["by_axis"]
    terms = {"compute": rec["hlo_flops"] / PEAK_FLOPS,
             "memory": rec["hlo_bytes"] / HBM_BW,
             "collective": sum(b / AXIS_BW.get(a, NET_BW) for a, b in by_axis.items())}
    return {"t_compute": terms["compute"], "t_memory": terms["memory"],
            "t_collective": terms["collective"],
            "bottleneck": max(terms, key=terms.get)}


def _fake_group(world: int) -> None:
    import logging

    import torch.distributed as dist

    # DTensor warns of each multi-dim redistribution it splits; a cell has
    # thousands, which the counts already show
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), world_size=world, rank=0)


def count_cell(arch: str, shape_name: str, mesh_kind: str, variant: str = "baseline",
               model_cfg=None, shape=None, mesh_dims=None):
    """(record fields, meta, the `DeviceCounter`) of one cell, counted on a
    fake group that this call forms and destroys: the production mesh of
    `mesh_kind`, or a ("data", "model") mesh of `mesh_dims` (the tests')."""
    import torch.distributed as dist

    multi = mesh_kind == "multi"
    dims = mesh_dims or tuple(mesh_lib.production_shape(multi).shape.values())
    _fake_group(int(torch.tensor(dims).prod()))
    try:
        mesh = (mesh_lib.make_mesh(mesh_dims, device_type="cuda") if mesh_dims else
                mesh_lib.make_production_mesh(multi_pod=multi, device_type="cuda"))
        axis_of = {mesh.get_group(i).group_name: n
                   for i, n in enumerate(mesh.mesh_dim_names)}
        t0 = time.time()
        run, meta = build_cell(arch, shape_name, mesh, variant, model_cfg, shape)
        step, args = run()
        t_build = time.time() - t0
        counter = DeviceCounter(axis_of)
        arg_bytes = counter.hold(_tensors(args))
        with counter:
            out = step(*args)
        out_bytes = sum(st.nbytes() for st in {
            _local(t).untyped_storage()._cdata: _local(t).untyped_storage()
            for t in _tensors(out)}.values())
        rec = {"chips": mesh_lib.n_chips(mesh), "lower_s": round(t_build, 1),
               "compile_s": round(time.time() - t0 - t_build, 1),
               "hlo_flops": float(counter.flops), "hlo_bytes": float(counter.bytes),
               "flops_by_op": counter.flops_by_op,
               "collectives": collective_bytes(counter.collectives),
               "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                          "temp_bytes": counter.peak - arg_bytes,
                          "peak_bytes": counter.peak}}
        rec.update(roofline(rec))
        return rec, meta, counter
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             force: bool = False, variant: str = "baseline") -> dict:
    suffix = "" if variant == "baseline" else f"__{variant}"
    out_path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}{suffix}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            rec = json.load(f)
        if rec.get("ok"):
            return rec
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "ok": False,
           "variant": variant}
    try:
        counted, meta, _ = count_cell(arch, shape_name, mesh_kind, variant)
        rec.update(meta)
        rec.update(counted, ok=True)
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 1)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    status = "OK" if rec.get("ok") else f"FAIL ({rec.get('error', '?')[:80]})"
    print(f"[dryrun] {arch:24s} {shape_name:12s} {mesh_kind:6s} "
          f"{variant:8s} {status} {rec['total_s']}s", flush=True)
    return rec


def cells(arch: str = "all", shape: str = "all"):
    """(arch, shape, runnable) of every cell, in the reference's order (a
    cell not runnable is full attention at 500k, skipped)."""
    return [(a, s, shapes_lib.runnable(a, s))
            for a in (registry.list_archs() if arch == "all" else [arch])
            for s in (shapes_lib.cases(a) if shape == "all" else [shape])]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=["baseline", "opt"])
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    failures = 0
    for arch, shape_name, ok in cells(args.arch, args.shape):
        if not ok:
            print(f"[dryrun] {arch} {shape_name}: skipped (full attention at 500k)")
            continue
        for mesh_kind in meshes:
            rec = run_cell(arch, shape_name, mesh_kind, args.out, force=args.force,
                           variant=args.variant)
            failures += 0 if rec.get("ok") else 1
    print(f"[dryrun] done, failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
