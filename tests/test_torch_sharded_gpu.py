"""The sharded executor on a CUDA card against the port's own CPU path
(`gpu` tests; each skips where torch sees no card, deciding inside the
test). No JAX here.

  * a local mesh on the card equals the CPU's at 4x4, NEIGHBOR (flat and
    torus) and GLOBAL, in `rounds` and every state leaf;
  * the card's loop is the captured one (`_replay_loop`), not the eager
    loop.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import mesh_comm
from repro_torch.core import scheduler as psch
from repro_torch.launch import sharded as launcher

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("strategy,torus", [("neighbor", False), ("global", False),
                                            ("neighbor", True)])
def test_local_mesh_card_equals_cpu(monkeypatch, strategy, torus):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    loops, captured = [], psch._replay_loop

    def replay(body, carry, max_ticks):
        loops.append(max_ticks)
        return captured(body, carry, max_ticks)

    monkeypatch.setattr(psch, "_replay_loop", replay)
    monkeypatch.setattr(psch, "_eager_loop", None)  # the card never runs it
    spec = launcher.job(strategy, torus)
    card = launcher.run(mesh_comm.LocalMesh((4, 4)), spec)
    assert loops == [spec["max_rounds"]]
    monkeypatch.undo()
    cpu = launcher.run(mesh_comm.LocalMesh((4, 4), device="cpu"), spec)
    assert card[1] == cpu[1]
    a, b = launcher.arrays(card[0]), launcher.arrays(cpu[0])
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    s = launcher.summary(*card)
    assert s["overflow"] == 0 and s["nodes"] == 287
