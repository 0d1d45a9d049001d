"""The sharded executor's collective schedule (`repro_torch.launch.
dryrun_runtime`) on the CPU's local mesh: what tests/test_runtime_collectives.py
asserts of the reference's compiled HLO — NEIGHBOR has collective-permutes
and the termination all-reduce only, GLOBAL all-gathers with more bytes —
at 4x4 and at the reference's 16x16, the byte counts worked out from the
round's payloads, and the reference's layout and convention
(`repro.launch.dryrun.collective_bytes`).
"""

import json

import pytest
import torch
from torch_parity import release_reference_compiles  # noqa: F401  (autouse)

from repro.launch.dryrun import collective_bytes as ref_collective_bytes
from repro_torch.core import mesh_comm
from repro_torch.launch import dryrun_runtime as dr

G, T = 4, 4  # the grant budget's window and the task record's width


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("rows,cols", [(4, 4), (16, 16)])
def test_neighbor_is_single_hop_only(rows, cols):
    out = dr.schedules(rows, cols, device="cpu")
    n, g = out["neighbor"], out["global"]
    assert n.get("all-gather", 0) == 0 and n.get("all-to-all", 0) == 0, n
    assert n.get("collective-permute", 0) > 0, n
    assert g.get("all-gather", 0) > 0, g
    assert g["total"] > n["total"], (g["total"], n["total"])
    # NEIGHBOR: a request flag and a 5-int reply a direction; both: the
    # termination psum over two axes, an int32 each, counted twice
    assert n == {"collective-permute": 4 * 4.0 + 4 * 20.0, "all-reduce": 16.0,
                 "total": 112.0, "op_counts": {"collective-permute": 8, "all-reduce": 2}}
    # GLOBAL: sizes (int32), thief flags (pred) and bottom windows (G x T
    # int32), each gathered along "row" then "col"
    R, C = rows, cols
    gather = (R + C * R) * (4 + 1 + G * T * 4)
    assert g == {"all-gather": float(gather), "all-reduce": 16.0, "total": gather + 16.0,
                 "op_counts": {"all-gather": 6, "all-reduce": 2}}
    lines = dr.report(out)
    assert "single-hop-only (no gathers): True" in lines[2]
    assert lines[3].endswith(f"= {gather / 96.0:.1f}x")


def test_layout_and_convention_are_the_reference():
    """What `CountingMesh` records is what the reference's `collective_bytes`
    reads from HLO text of the same collectives' result shapes: one shard's
    bytes, a pred as one byte, all-reduce twice, the same layout."""
    mesh = dr.CountingMesh(mesh_comm.LocalMesh((2, 3), device="cpu"))
    x = torch.ones((6, 5), dtype=torch.int32)
    mesh.ppermute(x, "col", [(0, 1)])
    mesh.all_gather(x[:, 0] > 0, "row")
    mesh.all_gather(x, "col")
    mesh.psum(x[:, 0], "row")
    hlo = ["%a = s32[5]{0} collective-permute(s32[5]{0} %p)",
           "%b = pred[2]{0} all-gather(pred[] %p)",
           "%c = s32[3,5]{1,0} all-gather(s32[5]{0} %p)",
           "%d = s32[] all-reduce(s32[] %p)"]
    assert dr.collective_bytes(mesh.ops) == ref_collective_bytes("\n".join(hlo))


def test_main_prints_and_writes(tmp_path, capsys):
    out = tmp_path / "sub" / "paper_runtime.json"
    got = dr.main(["--rows", "4", "--cols", "4", "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == got
    printed = capsys.readouterr().out.splitlines()
    assert printed[:4] == dr.report(got) and json.loads(printed[4]) == got
