"""Port parity of the dry run (`repro_torch.launch.dryrun`) against the
reference's (`repro.launch.dryrun`), and what the port's counts must show.

  * In this process: the cell list and its skips, each cell's meta (kind,
    seq, batch, micro-batches, the remat choice — the port's from the
    initialised tree, the reference's from `n_params()` —, `n_params`,
    `n_active`, the VLM's re-fit chunk), `apply_variant` for every
    architecture and variant, the kernels' meta path (`kernels.ops`: the
    fakes' shapes and types against the plain versions', the FLOP
    formulas), and the meshes' default device type.
  * In one child process a session (`tests/dryrun_cases.py`; a fake
    process group must not live in a pytest worker): every architecture's
    fp32 master tree placed on the fake 32 x 8 and 2 x 32 x 8 meshes, and
    tiny dense and MoE cells (2 layers, d_model 64, 8 heads) at a fake
    2 x 2 and 32 x 8, train, prefill and decode, plus a dense train cell
    under "opt". Held: the placed trees' bytes against the reference's
    specs (each leaf's rank-0 shard, summed), every field of the
    reference's record, the kernels' FLOPs against counts worked out here
    (a device's own: a count of the logical ops would be 256 times larger
    at 32 x 8), and the MoE cells' expert FLOPs at about 1/(dp·tp) of the
    whole and their gathered expert bytes at 1/tp (expert parallelism over
    "model", its work split again over "data").
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch_parity import release_reference_compiles, run_once  # noqa: F401  (autouse)

import dryrun_cases as dc
from repro.launch import shapes as rshapes
from repro.launch import shardings as rsh
from repro.models import registry as rreg
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun as pdry
from repro_torch.launch import mesh as pmesh
from repro_torch.models import moe as pmoe
from repro_torch.models import registry as preg

ROOT = Path(__file__).resolve().parents[1]
CASES_TIMEOUT = 300   # seconds for the child's cases (~40 s here)
# the reference's dry run forces 512 host devices through XLA_FLAGS when it
# is imported; this process's JAX has started, so only the variable moves
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as rdry  # noqa: E402
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

# the reference's record (`repro.launch.dryrun.run_cell`), train cells'
RECORD = {"arch", "shape", "mesh", "ok", "variant", "kind", "n_params", "n_active", "seq",
          "batch", "num_microbatches", "remat", "chips", "lower_s", "compile_s", "hlo_flops",
          "hlo_bytes", "collectives", "memory", "t_compute", "t_memory", "t_collective",
          "bottleneck", "total_s"}
MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run_cases(out):
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}")
    subprocess.run([sys.executable, str(ROOT / "tests" / "dryrun_cases.py"),
                    str(out / "cases.json")], env=env, check=True, timeout=CASES_TIMEOUT)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    return json.loads((run_once(tmp_path_factory, "dryrun_cases", _run_cases)
                       / "cases.json").read_text())


# --------------------------------------------------------------------------- #
# The cells, their meta and the variants (this process)
# --------------------------------------------------------------------------- #
def test_cells_and_skips_equal_reference():
    """The reference's cells (every architecture's shapes, each marked
    runnable or skipped), each architecture's in the reference's order."""
    want = [(a, s, rshapes.runnable(a, s)) for a in rreg.list_archs()
            for s in rshapes.cases(a)]
    assert sorted(pdry.cells()) == sorted(want)
    for arch in rreg.list_archs():
        assert [c for c in pdry.cells() if c[0] == arch] == [c for c in want if c[0] == arch]


@pytest.mark.parametrize("arch", rreg.list_archs())
def test_cell_meta_equals_reference(arch):
    """Every runnable cell's meta is the reference's `build_cell`'s, the
    remat choice the reference's rule (full above 20e9 parameters) read off
    the initialised tree, and the VLM's attention chunk re-fit alike."""
    rcfg = rreg.get_config(arch)
    choices = {}
    for shape in rshapes.cases(arch):
        run, meta = pdry.build_cell(arch, shape, mesh=None)
        sc = rshapes.SHAPES[shape]
        want = {"arch": arch, "shape": shape, "kind": sc.kind, "n_params": rcfg.n_params(),
                "n_active": rcfg.n_active_params(), "seq": sc.seq_len,
                "batch": sc.global_batch}
        assert {k: meta[k] for k in want} == want
        rc = rdry.apply_variant(rshapes.shape_overrides(rcfg, sc), "baseline")
        if rc.family == "vlm" and rc.attn_chunk_q:
            c = rdry._pow2_divisor(sc.seq_len + rc.n_frontend_tokens)
            rc = dataclasses.replace(rc, attn_chunk_q=c, attn_chunk_k=c)
        pc = pdry.cell_config(arch, shape)
        assert (pc.attn_chunk_q, pc.attn_chunk_k) == (rc.attn_chunk_q, rc.attn_chunk_k)
        if sc.kind == "train":
            assert meta["num_microbatches"] == rshapes.TRAIN_MICROBATCHES.get(arch, 8)
            for variant in ("baseline", "opt"):
                ref_remat = "full" if rcfg.n_params() > 20e9 else "none"
                if variant == "opt" and ref_remat == "full":
                    ref_remat = "dots"
                choices[variant] = pdry.remat_choice(meta["n_tree"], variant)
                assert choices[variant] == ref_remat, (arch, variant, meta["n_tree"])
    assert choices, arch


@pytest.mark.parametrize("variant", ["baseline", "opt"])
def test_apply_variant_equals_reference(variant):
    for arch in rreg.list_archs():
        want = rdry.apply_variant(rreg.get_config(arch), variant)
        got = pdry.apply_variant(preg.get_config(arch), variant)
        assert (got.seq_shard_axis, got.attn_skip_masked) == (
            want.seq_shard_axis, want.attn_skip_masked), arch


def test_meshes_need_a_card_by_default():
    """With no device type and no card the meshes raise, as
    `core.resolve_device` does; a type given is taken as given."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        pmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        pmesh.make_mesh((1, 1))


# --------------------------------------------------------------------------- #
# The kernels' meta path
# --------------------------------------------------------------------------- #
def _kernel_calls(device):
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype).to(device)

    bf = torch.bfloat16
    lengths = torch.tensor([5, 12], dtype=torch.int32).to(device)
    return {
        "flash_attention": lambda: ops.flash_attention(rnd(2, 2, 3, 12, 8, dtype=bf),
                                                       rnd(2, 2, 12, 8, dtype=bf),
                                                       rnd(2, 2, 12, 8, dtype=bf), True, 5),
        "decode_attention": lambda: ops.decode_attention(rnd(2, 2, 3, 8, dtype=bf),
                                                         rnd(2, 2, 12, 8, dtype=bf),
                                                         rnd(2, 2, 12, 8, dtype=bf), lengths),
        "wkv6": lambda: ops.wkv6(rnd(2, 5, 2, 8, dtype=bf), rnd(2, 5, 2, 8, dtype=bf),
                                 rnd(2, 5, 2, 8, dtype=bf), rnd(2, 5, 2, 8), rnd(2, 8),
                                 rnd(2, 2, 8, 8)),
        "rglru": lambda: ops.rglru(rnd(2, 7, 16, dtype=bf), rnd(2, 7, 16, dtype=bf),
                                   rnd(2, 7, 16, dtype=bf), rnd(16), None)}


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention", "wkv6", "rglru"])
def test_meta_path_matches_plain_shapes_and_counts_no_launch(name):
    """On the meta device each kernel gives its plain version's shapes and
    types, through its custom operator, and counts no launch."""
    want = _kernel_calls("cpu")[name]()
    before = dict(ops.LAUNCHES)
    got = _kernel_calls("meta")[name]()
    assert ops.LAUNCHES == before
    want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype) for t in want]
    assert all(t.device.type == "meta" for t in got)


def test_meta_flop_formulas():
    """The FLOP formulas: attention 4·hd a visible (query, key) pair and
    query head (counted here pair by pair), wkv6 and rglru as chip_smoke.py
    bounds them."""
    from torch.utils.flop_counter import FlopCounterMode

    calls = _kernel_calls("meta")
    ops._meta_ops()     # the kernels' formulas, before the counter reads them
    with FlopCounterMode(display=False) as fc:
        for fn in calls.values():
            fn()
    got = {str(k).removeprefix("repro_torch."): v
           for k, v in fc.get_flop_counts()["Global"].items()}
    pairs = sum(1 for i in range(12) for s in range(12) if s <= i and i - s < 5)
    assert got["flash_attention"] == 4 * 8 * 2 * 2 * 3 * pairs
    assert got["decode_attention"] == 4 * 8 * 2 * 2 * 3 * 12
    assert got["wkv6"] == 2 * 2 * (17 * 64 + 71 * 8 + 5 * 64 + 8 * 8)
    assert got["rglru"] == 12 * 2 * 7 * 16
    # the plain attention on meta would hold the score matrix: the kernel's
    # fake holds nothing beyond its output
    q = torch.empty(1, 1, 1, 4096, 64, device="meta", dtype=torch.bfloat16)
    k = torch.empty(1, 1, 4096, 64, device="meta", dtype=torch.bfloat16)
    assert ops.flash_attention(q, k, k).shape == q.shape
    assert ops.flash_work(1, 1, 1, 4, 4, 8, True, 0) == 4 * 8 * 10


# --------------------------------------------------------------------------- #
# The child's cases
# --------------------------------------------------------------------------- #
class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("arch", rreg.list_archs())
def test_parameter_bytes_equal_reference_shards(cases, arch):
    """A device's bytes of the placed fp32 master tree, single and multi,
    equal the sum over the reference's tree of each leaf's rank-0 shard
    under the reference's specs on the same (shape-only) meshes."""
    rc = rreg.get_config(arch)
    tree = jax.eval_shape(lambda k: rreg.get_fns(rc).init(k, rc), jax.random.PRNGKey(0))
    for kind in ("single", "multi"):
        sizes = pmesh.production_shape(kind == "multi").shape
        specs = rsh.param_specs(tree, FakeMesh(sizes))
        total = 0
        for leaf, spec in zip(jax.tree.leaves(tree),
                              jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))):
            shard = list(leaf.shape)
            for d, entry in enumerate(tuple(spec)):
                axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
                shard[d] = -(-shard[d] // math.prod(sizes[a] for a in axes))
            total += math.prod(shard) * leaf.dtype.itemsize
        assert cases["params"][arch][kind] == total, (arch, kind)


def _tiny(name, kind):
    cfg = dc.tiny_config(name)
    _, S, B = dc.SHAPES[kind]
    return cfg, S, B


@pytest.mark.parametrize("name", [dc.cell_name(*c) for c in dc.CELLS])
def test_tiny_cell_record_and_kernel_flops(cases, name):
    """Each tiny cell's record has the reference's fields; the kernels'
    FLOPs are a device's own, worked out here from its rows and heads."""
    cell = cases["cells"][name]
    rec, meta = cell["rec"], cell["meta"]
    cfg_name, kind, dims, variant = name.split("/")
    dp, tp = (int(x) for x in dims.split("x"))
    want = RECORD - {"arch", "shape", "mesh", "ok", "variant", "total_s"}
    if kind != "train":
        want -= {"num_microbatches", "remat"}
    assert want <= set(rec) | set(meta)
    assert set(rec["memory"]) == MEMORY
    assert {"total", "op_counts"} <= set(rec["collectives"])
    assert rec["chips"] == dp * tp
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["hlo_flops"] == sum(rec["flops_by_op"].values())
    assert 0 < rec["memory"]["argument_bytes"] <= rec["memory"]["peak_bytes"]
    cfg, S, B = _tiny(cfg_name, kind)
    G, KV, hd, L_ = cfg.n_heads // cfg.n_kv_heads, cfg.n_kv_heads // tp, cfg.hd, cfg.n_layers
    rows = B // dp
    if kind == "decode":
        assert rec["flops_by_op"]["repro_torch.decode_attention"] == (
            L_ * ops.decode_work(rows, KV, G, S, hd))
    else:   # the forward kernel once a layer (a micro-batch's rows in turn)
        assert rec["flops_by_op"]["repro_torch.flash_attention"] == (
            L_ * ops.flash_work(rows, KV, G, S, S, hd, True, 0))
    if kind == "train":
        assert meta["num_microbatches"] == rshapes.TRAIN_MICROBATCHES.get(dc.ARCHS[cfg_name], 8)
        assert meta["remat"] == "none"


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("dims", ["2x2", "32x8"])
def test_moe_cell_runs_its_experts_on_their_shard(cases, kind, dims):
    """Expert parallelism over "model", split again over "data": a device's
    expert products are about 1/(dp·tp) of the whole layer's (E / tp
    experts' ceil(C / dp) places each and the shared experts' slice on
    ceil(T / dp) tokens, routing over every token of the batch), and it
    gathers (over "data" only) its E / tp experts' weights, never all E.
    Replicating the layer on every rank gives dp·tp times the products
    and tp times the gathers."""
    cell = cases["cells"][f"moe/{kind}/{dims}/baseline"]
    dp, tp = (int(x) for x in dims.split("x"))
    cfg, S, B = _tiny("moe", kind)
    mc, D, L_ = cfg.moe, cfg.d_model, cfg.n_layers
    E = mc.n_experts + mc.ep_pad_to
    # an all-gather's result is its inputs stacked on dim 0, so an expert
    # weight's (E / tp, D, F) shard gathered over "data" reads as
    # (dp·E / tp, D / dp, F): found by its size
    mine = E // tp * D * mc.d_ff_expert
    expert = [s for axis, s in cell["gathers"] if axis == "data" and math.prod(s) == mine]
    assert len(expert) >= 3 * L_, cell["gathers"]
    # the batched products beyond the dense cell's of the same shapes (its
    # decode head, its attention's backward): each rank's experts' places
    # and its shared slice, over its tokens of a (micro-)batch
    nm = cell["meta"].get("num_microbatches", 1)
    T = B * (S if kind != "decode" else 1) // nm
    C = pmoe.capacity_of(T, mc)
    mine_flops = L_ * 3 * 2 * (E // tp) * -(-C // dp) * D * mc.d_ff_expert
    shared = L_ * 2 * 2 * mc.n_shared * -(-T // dp) * D * (mc.d_ff_shared // tp)
    dense = cases["cells"][f"dense/{kind}/{dims}/baseline"]["rec"]["flops_by_op"]
    got = cell["rec"]["flops_by_op"]["bmm"] - dense.get("bmm", 0)
    if kind == "train":
        # at most 4 passes a micro-batch (the forward, the checkpoint's
        # recompute, the backward's two products)
        assert got <= nm * 4 * (mine_flops + shared)
        return
    assert len(expert) == 3 * L_    # each expert weight gathered once a layer
    assert got == mine_flops + shared


@pytest.mark.parametrize("dims", ["2x2", "32x8"])
def test_flops_are_a_devices_own(cases, dims):
    """A device's FLOPs, not the logical (global) op's: the dense prefill
    splits every product and the kernel over its dp x tp devices with
    nothing replicated (rows over "data", heads, hidden units and the
    vocabulary over "model"), so a device does exactly 1/(dp·tp) of the
    FLOPs `FlopCounterMode` counts for the whole batch on one device."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg, S, B = _tiny("dense", "prefill")
    fns = preg.get_fns(cfg)
    tokens = torch.zeros((B, S), dtype=torch.int32, device="meta")
    ops._meta_ops()     # the kernels' formulas, before the counter reads them
    with FlopCounterMode(display=False) as fc:
        fns.prefill(fns.init(cfg, device="meta"), cfg, tokens, S)
    dp, tp = (int(x) for x in dims.split("x"))
    per_device = cases["cells"][f"dense/prefill/{dims}/baseline"]["rec"]["hlo_flops"]
    assert per_device * dp * tp == fc.get_total_flops()


def test_opt_variant_shards_the_residual(cases):
    """Under "opt" the dense residual's sequence is sharded over "model"
    between blocks (`layers.seq_sharded`): its collectives differ from the
    baseline's, the kernels' FLOPs do not, and moving a dim's shard to
    another dim is counted as the all-to-all NCCL runs (the mesh is typed
    "cuda"; on a "cpu" mesh DTensor would gather instead)."""
    base = cases["cells"]["dense/train/2x2/baseline"]["rec"]
    opt = cases["cells"]["dense/train/2x2/opt"]["rec"]
    assert opt["flops_by_op"]["repro_torch.flash_attention"] == \
        base["flops_by_op"]["repro_torch.flash_attention"]
    assert opt["collectives"]["by_axis"] != base["collectives"]["by_axis"]
    assert opt["collectives"]["op_counts"].get("all-to-all", 0) > 0


def test_collective_bytes_layout_equals_reference():
    """`collective_bytes` in the reference's layout and convention: result
    bytes a device, an all-reduce twice, `total`, `op_counts`; `by_axis`
    besides."""
    ops_list = [("all-gather", "data", 100, (5,)), ("all-reduce", "model", 2 * 8, (2,)),
                ("all-gather", "model", 40, (10,))]
    got = pdry.collective_bytes(ops_list)
    assert got == {"all-gather": 140.0, "all-reduce": 16.0, "total": 156.0,
                   "op_counts": {"all-gather": 2, "all-reduce": 1},
                   "by_axis": {"data": 100.0, "model": 56.0}}
    hlo = ("%a = f32[25]{0} all-gather(f32[5] %x)\n%b = f32[2]{0} all-reduce(f32[2] %y)\n"
           "%c = f32[10]{0} all-gather(f32[5] %z)")
    assert {k: v for k, v in got.items() if k != "by_axis"} == rdry.collective_bytes(hlo)
