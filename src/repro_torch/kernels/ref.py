"""Plain PyTorch versions of the hand-written kernels.

Each function computes exactly what its CUDA kernel computes, at the same
interface. The wrappers in `ops` run these for CPU tensors; on the card they
serve only as the yardstick `chip_smoke.py` holds each kernel against.
"""

from __future__ import annotations

import torch

# the one staging width of the grant export, shared with the kernel's
# compile-time constant (checked by the wrapper)
from ..core.stealing import GRANT_WIDTH


def steal_compact(buf, bot, size, grants):
    """Extract `grants[w]` records from each deque's bottom and advance it.

    buf: (W, C, T) int32 ring buffers; bot, size, grants: (W,) int32.
    Returns (stolen (W, GRANT_WIDTH, T) zero-padded, new_bot, new_size).
    """
    C, T = buf.shape[1:]
    g = torch.minimum(grants, size)
    ranks = torch.arange(GRANT_WIDTH, device=buf.device)[None, :]
    idx = torch.remainder(bot[:, None] + ranks, C).long()
    rows = torch.gather(buf, 1, idx[:, :, None].expand(-1, -1, T))
    stolen = torch.where((ranks < g[:, None])[:, :, None], rows, 0)
    return stolen, torch.remainder(bot + g, C), size - g


def deque_apply(buf, slot, rec, n):
    """Commit a staged push log into the ring buffers, lanes in order.

    buf: (W, C, T) int32; slot: (W, L) ring slots; rec: (W, L, T) records;
    n: (W,) live-lane count. Lane l is committed iff l < n[w]; ascending lane
    order means a later push to a re-used slot wins. Returns a new buffer.
    """
    C = buf.shape[1]
    cols = torch.arange(C, device=buf.device)[None, :]
    out = buf
    for lane in range(slot.shape[1]):
        hit = (cols == slot[:, lane][:, None]) & (lane < n)[:, None]
        out = torch.where(hit[:, :, None], rec[:, lane][:, None, :], out)
    return out
