"""PyTorch/CUDA port of the work-stealing constellation simulator.

`repro_torch.core` mirrors `repro.core` module by module (rng, topology,
tasks, deque, stealing, linkstate, constellation, simulator, scheduler),
`repro_torch.checkpoint` mirrors `repro.checkpoint`, and `repro_torch.kernels` holds the
hand-written CUDA kernels with their plain PyTorch versions. The package
imports torch and numpy only. `simulate` runs on the CUDA device by default;
pass ``device="cpu"`` for the plain PyTorch path.
"""

from .core.simulator import SimConfig, SimResult, simulate

__all__ = ["SimConfig", "SimResult", "simulate"]
