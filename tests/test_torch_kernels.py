"""Port parity of the kernels: the plain PyTorch versions of `steal_compact`
and `deque_apply` against `repro.kernels.ref` and against the Pallas kernels
themselves (`repro.kernels.ops`, interpret mode on the CPU); the wrappers'
CPU dispatch and launch counters; and, on a CUDA card only, the CUDA
kernels against their plain versions."""

import re
from pathlib import Path

import pytest
import torch
from torch_parity import assert_same, np_rng, to_jax, to_torch
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import stealing as rst
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.core import deque as pdq
from repro_torch.core import stealing as pst
from repro_torch.kernels import build, ops, ref

RNG = np_rng(7)


def steal_inputs(W, C):
    return (RNG.integers(1, 1000, (W, C, 4)), RNG.integers(0, C, W),
            RNG.integers(0, C + 1, W), RNG.integers(0, 9, W))


def apply_inputs(W, C, L):
    return (RNG.integers(1, 1000, (W, C, 4)),
            RNG.integers(0, min(C, 6), (W, L)),   # narrow: duplicate slots
            RNG.integers(1, 1000, (W, L, 4)), RNG.integers(0, L + 1, W))


def test_grant_width_is_one_constant():
    src = (build.CSRC / "steal_compact.cu").read_text()
    (width,) = re.findall(r"#define GRANT_WIDTH (\d+)", src)
    assert int(width) == ref.GRANT_WIDTH == pst.GRANT_WIDTH == rst.GRANT_WIDTH


@pytest.mark.parametrize("W,C", [(64, 16), (128, 64), (256, 8), (100, 32), (9, 16)])
def test_steal_compact_plain_matches_reference_and_pallas(W, C):
    arrays = steal_inputs(W, C)
    got = ref.steal_compact(*map(to_torch, arrays))
    want = rref.steal_compact_ref(*map(to_jax, arrays))
    pallas = rops.steal_compact(*map(to_jax, arrays))
    for a, b, c in zip(want, got, pallas):
        assert_same(a, b, "vs ref")
        assert_same(c, b, "vs pallas")


@pytest.mark.parametrize("W,C,L", [(64, 16, 9), (100, 32, 9), (9, 16, 24), (128, 8, 5)])
def test_deque_apply_plain_matches_reference_and_pallas(W, C, L):
    arrays = apply_inputs(W, C, L)
    got = ref.deque_apply(*map(to_torch, arrays))
    assert_same(rref.deque_apply_ref(*map(to_jax, arrays)), got, "vs ref")
    assert_same(rops.deque_apply(*map(to_jax, arrays)), got, "vs pallas")


def test_cpu_wrappers_run_plain_versions_without_counting():
    ops.reset_launch_counts()
    arrays = steal_inputs(32, 16)
    for a, b in zip(ops.steal_compact(*map(to_torch, arrays)),
                    ref.steal_compact(*map(to_torch, arrays))):
        assert_same(a, b)
    arrays = apply_inputs(32, 16, 12)
    assert_same(ops.deque_apply(*map(to_torch, arrays)),
                ref.deque_apply(*map(to_torch, arrays)))
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)


def test_plain_commit_paths_agree():
    """`deque.apply` (the lane-replay plain version through `ops`) and a
    commit through the staged reads' last-lane map give the same buffer on
    the same delta."""
    buf, slot, rec, n = map(to_torch, apply_inputs(32, 16, 12))
    d = pdq.DequeOps(buf0=buf, bot=to_torch(RNG.integers(0, 16, 32)),
                     size=to_torch(RNG.integers(0, 17, 32)), slot=slot, rec=rec, n=n)
    last = pdq._last_lane_map(d)
    staged = pdq._gather_rows(rec, last.clamp(min=0))
    assert_same(pdq.apply(d).buf, torch.where((last >= 0)[:, :, None], staged, buf))


def test_wrappers_refuse_non_cuda_devices():
    """Off the CPU a wrapper launches its kernel or raises: a tensor on
    another device is refused before any build."""
    m = torch.zeros((4, 8, 4), dtype=torch.int32, device="meta")
    v = torch.zeros((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.steal_compact(m, v, v, v)
    with pytest.raises(ValueError, match="CUDA"):
        ops.deque_apply(m, torch.zeros((4, 3), dtype=torch.int32, device="meta"),
                        torch.zeros((4, 3, 4), dtype=torch.int32, device="meta"), v)


def test_build_layout():
    """Libraries are named by a hash of their source, go to a git-ignored
    directory, and nothing is built at import."""
    assert {p.stem for p in build.CSRC.glob("*.cu")} == set(build.SOURCES)
    for name in build.SOURCES:
        path = build.lib_path(name)
        assert path.parent == build.build_dir()
        assert re.fullmatch(rf"lib{name}-[0-9a-f]{{16}}\.so", path.name)
    root = Path(__file__).resolve().parents[1]
    assert "build/" in (root / ".gitignore").read_text().split()
    assert not build._LIBS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("W,C,L", [(4096, 64, 9), (100, 32, 9), (9, 16, 24)])
def test_cuda_kernels_match_plain_versions(cuda_device, W, C, L):
    def dev(a):
        return to_torch(a).to(cuda_device)

    ops.reset_launch_counts()
    arrays = [dev(a) for a in steal_inputs(W, C)]
    for a, b in zip(ops.steal_compact(*arrays), ref.steal_compact(*arrays)):
        assert torch.equal(a, b)
    arrays = [dev(a) for a in apply_inputs(W, C, L)]
    assert torch.equal(ops.deque_apply(*arrays), ref.deque_apply(*arrays))
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {**dict.fromkeys(ops.LAUNCHES, 0),
                            "steal_compact": 1, "deque_apply": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("C", [64, 2048])
@pytest.mark.parametrize("L", [9, 83])
def test_cuda_inplace_commit_matches_plain_version(cuda_device, L, C):
    """The in-place `deque_apply` kernel through `deque.apply` with a
    per-row gate, against the in-place plain version on a copy: equal
    rings, written through the given buffer, with out-of-range slots
    writing nothing and gated and n = 0 rows bit for bit."""
    W = 4096 if C == 64 else 512
    buf, slot, rec, n = apply_inputs(W, C, L)
    out_of_range = RNG.random((W, L)) < 1 / 8
    slot[out_of_range] = RNG.choice([-1, C, C + 3], int(out_of_range.sum()))
    n[::5] = 0
    keep = torch.as_tensor(RNG.random(W) < 0.75, device=cuda_device)
    buf, slot, rec, n = (to_torch(a).to(cuda_device) for a in (buf, slot, rec, n))
    d = pdq.DequeOps(buf0=buf.clone(), bot=n, size=n, slot=slot, rec=rec, n=n)
    ops.reset_launch_counts()
    got = pdq.apply(d, keep).buf
    want = ref.deque_apply_(buf.clone(), slot, rec, torch.where(keep, n, 0))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["deque_apply"] == 1
    assert got.data_ptr() == d.buf0.data_ptr()
    assert torch.equal(got, want)
    untouched = ~keep | (n == 0)
    assert torch.equal(got[untouched], buf[untouched])


@pytest.mark.gpu
def test_cuda_steal_compact_at_a_narrow_width(cuda_device):
    """The export kernel at width 4 with grants above it: equal to the
    plain version, which clamps as the reference's `export_bottom` does."""
    buf, bot, size, grants = steal_inputs(4096, 64)
    grants = grants + RNG.integers(0, 5, grants.shape)
    arrays = [to_torch(a).to(cuda_device) for a in (buf, bot, size, grants)]
    got = ops.steal_compact(*arrays, 4)
    want = ref.steal_compact(*arrays, 4)
    torch.cuda.synchronize()
    assert tuple(got[0].shape) == (4096, 4, 4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
