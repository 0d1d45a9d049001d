"""Error-feedback int8 gradient compression for data-parallel reduction, in
torch.

Mirrors `repro.optim.grad_compress`: gradients are quantized to int8 with a
per-tensor scale before they cross the data-parallel axis, and the
quantization residual is carried to the next step (error feedback). Two
transports:

  * ``psum_bf16`` — dequantize → bf16 `psum` (half the bytes of fp32);
  * ``allgather_int8`` — raw int8 `all_gather` + a local sum of the scaled
    shards (a quarter of fp32's bytes a hop; the payload grows with the
    axis size).

The collectives are `core.mesh_comm`'s, whose values carry a leading shard
axis (every worker's on a `LocalMesh`, one on a `torch.distributed` mesh):
`compressed_psum` quantizes each shard's gradient with its own scale, as
the reference does on each device. `torch.round` rounds half to even, as
`jnp.round` does.
"""

from __future__ import annotations

import torch

from ..core import mesh_comm
from .adamw import tree_map


def init_error(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def quantize(x, error):
    """fp32 → (int8, scale, new error); adds the carried error first."""
    x = x.to(torch.float32) + error
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    new_error = x - q.to(torch.float32) * scale
    return q, scale, new_error


def dequantize(q, scale):
    return q.to(torch.float32) * scale


def compressed_psum(grads, errors, axis_name: str, transport: str = "psum_bf16", *,
                    mesh):
    """Mean-reduce `grads` over `axis_name` of `mesh` with int8
    error-feedback compression: `quantize` on each shard (leading axis),
    then the transport. Returns (reduced fp32 grads, new errors)."""
    mesh = mesh_comm.as_mesh(mesh)
    n = mesh.axis_size(axis_name)

    def one(g, e):
        q, scale, e_new = (torch.stack(t) for t in zip(*map(quantize, g, e)))
        if transport == "allgather_int8":
            qs = mesh.all_gather(q, axis_name).to(torch.float32)   # (shards, n, ...)
            ss = mesh.all_gather(scale, axis_name)                   # (shards, n)
            red = (ss.reshape(*ss.shape, *[1] * (qs.dim() - 2)) * qs).sum(1)
        else:  # psum_bf16
            s = scale.reshape(-1, *[1] * (q.dim() - 1))
            red = mesh.psum(dequantize(q, s).to(torch.bfloat16),
                            axis_name).to(torch.float32)
        return red / n, e_new

    pairs = tree_map(one, grads, errors)
    return tree_map(lambda p: p[0], pairs, leaf=tuple), tree_map(lambda p: p[1], pairs,
                                                                  leaf=tuple)


def compression_ratio(transport: str, axis_size: int) -> float:
    """Bytes on the wire vs fp32 psum (ring all-reduce ≈ 2·payload/device)."""
    if transport == "allgather_int8":
        return (axis_size * 1.0) / (2 * 4.0)
    return 2.0 / 4.0
