"""Port parity of `launch/shardings.py` and `launch/mesh.py`: the spec
rules against `repro.launch.shardings` leaf by leaf, for every
architecture the port serves, on the meta device (the port's abstract
tree: `init(..., device="meta")`) against `jax.eval_shape` of the
reference's `init`, at the reference tests' meshes {data 16, model 16}
and {pod 2, data 16, model 16} (shape-only: no devices). The reference
stacks its layers, so each port leaf is compared with its leaf in the
reference's tree (`shardings.reference_path`) with the stack dims
dropped. Batch and cache specs on every architecture's `input_specs`; the
reference's four tests of tests/test_shardings.py, ported; the coverage
check again at the port's H100 production meshes (32 x 8, 2 x 32 x 8);
and the DTensor placements a spec becomes.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.launch import shapes as rshapes
from repro.launch import shardings as rsh
from repro.models import registry as rreg
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import shapes as pshapes
from repro_torch.launch import shardings as psh
from repro_torch.models import registry as preg
from repro_torch.optim import adamw as padam

torch.set_num_threads(1)


class FakeMesh:
    """Shape-only stand-in (never touches devices)."""
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})
MESH = pmesh.MeshShape(MESHES[0])
MESH_MP = pmesh.MeshShape(MESHES[1])


def _ref_flat(tree, specs):
    """{path: (spec as a tuple, leaf)} of a reference tree."""
    leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    return {p: (tuple(s), leaf) for p, s, leaf in
            zip(rsh.tree_paths(tree), leaves, jax.tree.leaves(tree))}


def _port_flat(tree, specs) -> list:
    """[(path, spec, leaf)] of a port tree and its spec tree."""
    out = []
    psh.zip_specs(lambda x, s: out.append(s), tree, specs)
    return [(p, s, leaf) for (p, leaf), s in zip(psh.named_leaves(tree), out)]


@pytest.mark.parametrize("arch", preg.list_archs())
def test_param_specs_equal_reference(arch):
    rc, pc = rreg.get_config(arch), preg.get_config(arch)
    ra = jax.eval_shape(lambda k: rreg.get_fns(rc).init(k, rc), jax.random.PRNGKey(0))
    pa = preg.get_fns(pc).init(pc, device="meta", masters=True)
    assert all(t.device.type == "meta" for t in padam.leaves(pa))
    for mesh in (None,) + MESHES:
        want = _ref_flat(ra, rsh.param_specs(ra, None if mesh is None else FakeMesh(mesh)))
        got = _port_flat(pa, psh.param_specs(
            pa, None if mesh is None else pmesh.MeshShape(mesh), cfg=pc))
        seen = set()
        for path, spec, leaf in got:
            ref_path, n_stack = psh.reference_path(path, pc)
            ref_spec, ref_leaf = want[ref_path]
            assert tuple(leaf.shape) == tuple(ref_leaf.shape[n_stack:]), path
            assert spec == ref_spec[n_stack:], (mesh, path, spec, ref_spec)
            seen.add(ref_path)
        assert seen == set(want), set(want) - seen


def test_hybrid_tree_needs_its_config():
    pc = preg.get_config("recurrentgemma-9b")
    pa = preg.get_fns(pc).init(pc, device="meta")
    with pytest.raises(ValueError, match="needs cfg"):
        psh.param_specs(pa, MESH)
    # its two remainder layers are the reference's `rem/...`: their `out`
    # is replicated, a grouped rec layer's is ("model", "data")
    assert psh.reference_path("layers/36/out", pc) == ("rem/0/out", 0)
    assert psh.reference_path("layers/0/out", pc) == ("rec/out", 2)
    specs = psh.param_specs(pa, MESH, cfg=pc)
    assert specs["layers"][0]["out"] == ("model", "data")
    assert specs["layers"][36]["out"] == ()


@pytest.mark.parametrize("mesh", [MESH, MESH_MP, pmesh.production_shape(),
                                  pmesh.production_shape(multi_pod=True)],
                         ids=["16x16", "2x16x16", "h100_32x8", "h100_2x32x8"])
@pytest.mark.parametrize("arch", preg.list_archs())
def test_param_specs_cover_and_divide(arch, mesh):
    """The reference's coverage test, at its meshes and at the port's H100
    production meshes: every spec divides its dim, and the bulk of the
    bytes shards."""
    cfg = preg.get_config(arch)
    pa = preg.get_fns(cfg).init(cfg, device="meta")
    sizes = pmesh.mesh_shape(mesh)
    n_sharded = total = sharded_bytes = 0
    for path, spec, leaf in _port_flat(pa, psh.param_specs(pa, mesh, cfg=cfg)):
        nbytes = leaf.numel() * leaf.element_size()
        total += nbytes
        factor = 1
        for i, ax in enumerate(spec):
            if ax is None:
                continue
            size = sizes[ax] if isinstance(ax, str) else int(np.prod([sizes[a] for a in ax]))
            assert leaf.shape[i] % size == 0, (arch, leaf.shape, spec)
            factor *= size
        n_sharded += factor > 1
        sharded_bytes += nbytes // factor
    assert sharded_bytes / total < 0.05 or cfg.n_params() < 1e8, \
        f"{arch}: only {total / sharded_bytes:.1f}x reduction"
    assert n_sharded > 0


def test_sanitize_drops_nondividing_axes():
    assert psh.sanitize(("model", "data"), (51865, 384), MESH) == (None, "data")
    assert tuple(rsh.sanitize(P("model", "data"), (51865, 384), FakeMesh(MESHES[0]))) \
        == (None, "data")


def test_batch_specs_pod_folds_into_dp():
    batch = {"tokens": pshapes.i32((256, 128))}
    assert psh.batch_specs(batch, MESH_MP)["tokens"] == (("pod", "data"), None)
    # unshardable batch stays replicated
    assert psh.batch_specs({"tokens": pshapes.i32((1, 128))}, MESH_MP)["tokens"] == ()


def test_cache_specs_long_dense_cache_time_sharded():
    # the port's layout (L, B, KV, T, hd): T is dim 3
    cache = {"k": pshapes.abstract((8, 128, 8, 32768, 128), torch.bfloat16),
             "v": pshapes.abstract((8, 128, 8, 32768, 128), torch.bfloat16)}
    assert psh.cache_specs(cache, MESH)["k"] == (None, "data", None, "model", None)
    small = {"k": pshapes.abstract((8, 128, 8, 2048, 128), torch.bfloat16)}
    assert psh.cache_specs(small, MESH)["k"] == (None, "data", None, None, None)


@pytest.mark.parametrize("shape", list(rshapes.SHAPES))
def test_batch_and_cache_specs_equal_reference(shape):
    """batch_specs of every served architecture's train and prefill inputs,
    cache_specs of its decode cache (T and KV swapped: the port's cache
    layout), against the reference's at both meshes."""
    for arch in preg.list_archs():
        rc, pc = rreg.get_config(arch), preg.get_config(arch)
        ri = rshapes.input_specs(rc, rshapes.SHAPES[shape])
        pi = pshapes.input_specs(pc, pshapes.SHAPES[shape])
        for mesh in MESHES:
            fm, pm = FakeMesh(mesh), pmesh.MeshShape(mesh)
            if "cache" in ri:
                want = _ref_flat(ri["cache"], rsh.cache_specs(ri["cache"], fm))
                for path, spec, _ in _port_flat(pi["cache"],
                                                psh.cache_specs(pi["cache"], pm)):
                    ref = list(want[path][0])
                    if path in ("k", "v"):
                        ref[2], ref[3] = ref[3], ref[2]
                    assert spec == tuple(ref), (arch, shape, path)
                continue
            batch_r = ri.get("batch", ri)
            want = _ref_flat(batch_r, rsh.batch_specs(batch_r, fm))
            for path, spec, _ in _port_flat(pi.get("batch", pi),
                                            psh.batch_specs(pi.get("batch", pi), pm)):
                assert spec == tuple(want[path][0]), (arch, shape, path)


def test_opt_specs_mirror_params():
    cfg = dataclasses.replace(preg.reduced(preg.get_config("qwen2-0.5b")), dtype="float32")
    pa = preg.get_fns(cfg).init(cfg, device="meta", masters=True)
    ps = psh.param_specs(pa, MESH, cfg=cfg)
    os_ = psh.opt_specs(ps)
    assert os_.m is ps and os_.v is ps and os_.count == ()


def test_placements_of_specs():
    assert psh.placements((None, ("data", "model")), MESH) == (Shard(1), Shard(1))
    assert psh.placements(("model", "data"), MESH) == (Shard(1), Shard(0))
    assert psh.placements((("pod", "data"), None), MESH_MP) == (Shard(0), Shard(0),
                                                                Replicate())
    assert psh.placements((), MESH) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="out of the mesh's order"):
        psh.placements((("model", "data"),), MESH)


def test_production_meshes():
    assert pmesh.production_shape().shape == {"data": 32, "model": 8}
    assert pmesh.production_shape(True).shape == {"pod": 2, "data": 32, "model": 8}
    assert pmesh.dp_axes(MESH_MP) == ("pod", "data")
    assert pmesh.n_chips(pmesh.production_shape(True)) == 512
    # without a process group the worker mesh is a local one
    local = pmesh.make_worker_mesh(2, 3, device="cpu")
    assert local.shape == (2, 3) and local.axis_names == ("row", "col")
