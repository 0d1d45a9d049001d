"""Simulator core of the port: rng → f32math → topology → tasks → deque →
stealing → linkstate → constellation → arrivals → tracing → simulator →
scheduler (the round executor), each
(but f32math, the reference's float32 `log` op by op) the counterpart of
the `repro.core` module of the same name."""

import torch


def resolve_device(device, what: str) -> torch.device:
    """`device` as a torch device, the CUDA device when None; raises when
    that is CUDA and there is none. `what` names the caller in the message
    ("repro_torch's simulator runs")."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} on a CUDA device by default and none is available; pass "
            "device='cpu' to run the plain PyTorch path")
    return dev
