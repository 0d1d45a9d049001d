"""Port parity: `repro_torch.core.topology` against `repro.core.topology`
on square, ragged and torus meshes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same, np_rng
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.core import topology as rtopo
from repro_torch import convert
from repro_torch.core import mesh_comm
from repro_torch.core import topology as ptopo

MESHES = [
    ("square", lambda m: m.square(36)),
    ("ragged", lambda m: m.square(10)),      # 4x4 grid, last row partial
    ("ragged_torus", lambda m: m.square(23, torus=True)),
    ("torus", lambda m: m.grid(5, 7, torus=True)),
    ("grid", lambda m: m.grid(3, 8)),
    ("line", lambda m: m.grid(1, 6, torus=True)),
    ("single", lambda m: m.square(1)),
    ("starlink", lambda m: m.square(4096)),
]


@pytest.mark.parametrize("name,make", MESHES, ids=[m[0] for m in MESHES])
def test_mesh_tables(name, make):
    ref, port = make(rtopo.MeshTopology), make(ptopo.MeshTopology)
    assert (ref.num_workers, ref.rows, ref.cols, ref.torus) == \
        (port.num_workers, port.rows, port.cols, port.torus)
    assert ref.torus_full() == port.torus_full()
    assert_same(ref.coords, port.coords, "coords")
    assert_same(ref.neighbor_table, port.neighbor_table, "neighbor_table")
    for w in (0, port.num_workers // 2, port.num_workers - 1):
        assert ref.coords_of(w) == port.coords_of(w)
    # the converter builds the same mesh from the reference's fields
    conv = convert.mesh(ref.num_workers, ref.rows, ref.cols, ref.torus)
    assert conv == port


@pytest.mark.parametrize("name,make", MESHES, ids=[m[0] for m in MESHES])
def test_ppermute_pairs(name, make):
    """The pairs equal the reference's, and a ppermute along a flat worker
    axis with them moves each worker's id to its neighbor (zeros where none
    arrives)."""
    ref, port = make(rtopo.MeshTopology), make(ptopo.MeshTopology)
    mesh = mesh_comm.LocalMesh((port.num_workers,), ("w",), device="cpu")
    ids = torch.arange(1, port.num_workers + 1, dtype=torch.int32)
    for d in range(ptopo.NUM_DIRECTIONS):
        pairs = port.ppermute_pairs(d)
        assert pairs == ref.ppermute_pairs(d), d
        want = np.zeros(port.num_workers, np.int32)
        for w, nb in enumerate(port.neighbor_table[:, d]):
            if nb != ptopo.NO_NEIGHBOR:
                want[nb] = w + 1
        assert_same(want, mesh.ppermute(ids, "w", pairs), f"direction {d}")


@pytest.mark.parametrize("name,make", MESHES, ids=[m[0] for m in MESHES])
def test_hop_dist(name, make):
    ref, port = make(rtopo.MeshTopology), make(ptopo.MeshTopology)
    W = ref.num_workers
    rs = np_rng(5)
    victim = rs.integers(-1, W, W).astype(np.int32)  # NO_NEIGHBOR lanes too
    want = rtopo.hop_dist(ref, jnp.asarray(ref.coords), jnp.asarray(victim))
    got = ptopo.hop_dist(port, torch.as_tensor(port.coords),
                         torch.as_tensor(victim))
    assert got.dtype == torch.int32
    assert_same(want, got, "hop_dist")
    if W <= 64:  # the dense oracle, where it is cheap
        live = victim >= 0
        assert_same(ref.hop_matrix[np.arange(W), np.clip(victim, 0, W - 1)][live],
                    got.numpy()[live], "hop_matrix")


HOP_MESHES = MESHES[:-1] + [
    ("paper_640", lambda m: m.square(640)),               # 25x26, last row partial
    ("paper_640_torus", lambda m: m.square(640, torus=True)),  # not full: no wrap
    ("exact_torus", lambda m: m.grid(6, 6, torus=True)),
]


@pytest.mark.parametrize("name,make", HOP_MESHES, ids=[m[0] for m in HOP_MESHES])
def test_hop_helpers(name, make):
    ref, port = make(rtopo.MeshTopology), make(ptopo.MeshTopology)
    W = ref.num_workers
    assert_same(ref.neighbor_counts, port.neighbor_counts, "neighbor_counts")
    assert_same(ref.hop_matrix, port.hop_matrix, "hop_matrix")
    assert port.hop_matrix.dtype == np.int32
    assert ref.mean_hops() == port.mean_hops()
    rs = np_rng(11)
    for a, b in rs.integers(0, W, (16, 2)).tolist() + [(0, W - 1)]:
        assert ref.hops(a, b) == port.hops(a, b) == int(port.hop_matrix[a, b])
    for w in (0, W // 2, W - 1):
        assert ref.neighbors_of(w) == port.neighbors_of(w)
    assert rtopo.theoretical_mean_hops(W) == ptopo.theoretical_mean_hops(W)
