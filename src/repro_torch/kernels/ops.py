"""Wrappers of the hand-written CUDA kernels.

A wrapper runs its kernel's plain PyTorch version (`ref`) when its tensors
lie on the CPU, and launches the CUDA kernel when they lie on the card —
raising on a bad input, a failed build or a failed launch, never falling
back. `LAUNCHES` counts kernel launches by name: a wrapper adds one right
after its kernel launched, and nowhere else, so a run can show that its
path really went through the kernels.
"""

from __future__ import annotations

import torch

from ..core import stealing
from . import build, ref

LAUNCHES = {"steal_compact": 0, "deque_apply": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name}: expected int32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a contiguous, 16-byte aligned tensor")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def steal_compact(buf, bot, size, grants):
    """buf (W, C, 4), bot/size/grants (W,) int32 →
    (stolen (W, GRANT_WIDTH, 4), new_bot, new_size)."""
    if buf.device.type == "cpu":
        return ref.steal_compact(buf, bot, size, grants)
    W, C, T = buf.shape
    if T != 4:
        raise ValueError(f"steal_compact: record width must be 4, got {T}")
    for nm, t, shp in (("buf", buf, (W, C, T)), ("bot", bot, (W,)),
                       ("size", size, (W,)), ("grants", grants, (W,))):
        _check(f"steal_compact.{nm}", t, shp)
    lib = build.load("steal_compact")
    width = lib.steal_compact_grant_width()
    if width != stealing.GRANT_WIDTH:
        raise RuntimeError(f"steal_compact compiled with GRANT_WIDTH={width}, "
                           f"expected stealing.GRANT_WIDTH={stealing.GRANT_WIDTH}")
    stolen = torch.empty((W, width, T), dtype=torch.int32, device=buf.device)
    new_bot = torch.empty_like(bot)
    new_size = torch.empty_like(size)
    err = lib.steal_compact_launch(
        buf.data_ptr(), bot.data_ptr(), size.data_ptr(), grants.data_ptr(),
        stolen.data_ptr(), new_bot.data_ptr(), new_size.data_ptr(), W, C,
        _stream())
    _raise_on(err, "steal_compact")
    LAUNCHES["steal_compact"] += 1
    return stolen, new_bot, new_size


def deque_apply(buf, slot, rec, n):
    """buf (W, C, 4), slot (W, L), rec (W, L, 4), n (W,) int32 → new buffer
    (W, C, 4) with lanes l < n[w] committed in lane order."""
    if buf.device.type == "cpu":
        return ref.deque_apply(buf, slot, rec, n)
    W, C, T = buf.shape
    L = slot.shape[1]
    if T != 4:
        raise ValueError(f"deque_apply: record width must be 4, got {T}")
    for nm, t, shp in (("buf", buf, (W, C, T)), ("slot", slot, (W, L)),
                       ("rec", rec, (W, L, T)), ("n", n, (W,))):
        _check(f"deque_apply.{nm}", t, shp)
    lib = build.load("deque_apply")
    out = torch.empty_like(buf)
    err = lib.deque_apply_launch(buf.data_ptr(), slot.data_ptr(),
                                 rec.data_ptr(), n.data_ptr(), out.data_ptr(),
                                 W, C, L, _stream())
    _raise_on(err, "deque_apply")
    LAUNCHES["deque_apply"] += 1
    return out
