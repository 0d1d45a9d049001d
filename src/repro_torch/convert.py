"""Build the port's objects from the reference's inputs, given as plain
fields and numpy arrays, so both packages run the same thing.

The simulator has no weights: its inputs are a workload's fields, a mesh's
``(num_workers, rows, cols, torus)``, a `SimConfig`'s (or the round
executor's `SchedulerConfig`'s) fields (its
`trace` a dict of `TraceConfig` fields, or a config), a link-state
schedule's arrays, an arrival config's fields or a constellation's config
fields and, for the deque layer, a `DequeState`'s ``(buf, bot, size)``.
Enum-valued fields may be any enum (or plain string) with the same values. A model's input is its
parameter tree (`lm_params` for the dense transformer, `rwkv6_params` for
rwkv6, `rglru_params` for the RG-LRU hybrid). This module imports nothing
of the reference package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import arrivals, constellation
from .core import deque as dq
from .core import linkstate as lstate
from .core import scheduler as sched
from .core import simulator as sim
from .core import stealing, tasks
from .core import topology as topo
from .core import tracing
from .models import layers
from .models.config import ModelConfig

_WORKLOADS = {"FibWorkload": tasks.FibWorkload, "UtsWorkload": tasks.UtsWorkload}


def _value(x):
    return getattr(x, "value", x)


def workload(kind: str, fields: dict):
    """`kind` is the workload's class name ("FibWorkload", "UtsWorkload")."""
    return _WORKLOADS[kind](**fields)


def mesh(num_workers: int, rows: int, cols: int, torus: bool = False):
    return topo.MeshTopology(num_workers=int(num_workers), rows=int(rows),
                             cols=int(cols), torus=bool(torus))


def sim_config(fields: dict) -> sim.SimConfig:
    """A `SimConfig` from a field dict (e.g. `dataclasses.asdict` of the
    reference's config)."""
    f = dict(fields)
    if "strategy" in f:
        f["strategy"] = stealing.Strategy(_value(f["strategy"]))
    if "recovery" in f:
        f["recovery"] = sim.Recovery(_value(f["recovery"]))
    if f.get("trace") is not None:
        t = f["trace"]
        f["trace"] = tracing.TraceConfig(**(t if isinstance(t, dict)
                                            else dataclasses.asdict(t)))
    return sim.SimConfig(**f)


def sched_config(fields: dict) -> sched.SchedulerConfig:
    """A round executor's `SchedulerConfig` from a field dict (e.g.
    `dataclasses.asdict` of the reference's config)."""
    f = dict(fields)
    if "strategy" in f:
        f["strategy"] = stealing.Strategy(_value(f["strategy"]))
    return sched.SchedulerConfig(**f)


def linkstate_schedule(epoch_starts, link_tau, link_up, speed
                       ) -> lstate.LinkStateSchedule:
    """A `LinkStateSchedule` from the reference's four arrays (epoch starts,
    per-link τ and availability, per-epoch speeds), copied as numpy."""
    return lstate.LinkStateSchedule(
        epoch_starts=np.array(epoch_starts, np.int32),
        link_tau=np.array(link_tau, np.int32),
        link_up=np.array(link_up, bool),
        speed=np.array(speed, np.int32))


def arrival_config(fields: dict) -> arrivals.ArrivalConfig:
    """An `ArrivalConfig` from a field dict (e.g. `dataclasses.asdict` of
    the reference's config); the schedule's sequences become tuples."""
    f = dict(fields)
    for k in ("rate_starts", "rate_scale"):
        if k in f:
            f[k] = tuple(f[k])
    return arrivals.ArrivalConfig(**f)


def constellation_config(fields: dict) -> constellation.ConstellationConfig:
    """A `ConstellationConfig` from a field dict (e.g. `dataclasses.asdict`
    of the reference's config)."""
    return constellation.ConstellationConfig(**fields)


def deque_state(buf, bot, size, device="cpu") -> dq.DequeState:
    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)
    return dq.DequeState(t(buf), t(bot), t(size))


def _tensors(cfg: ModelConfig, node, device, fp32_leaves, name=""):
    """A tree of numpy arrays as tensors on `device`: leaves named in
    `fp32_leaves` in fp32, every other leaf in cfg.dtype."""
    if isinstance(node, dict):
        return {k: _tensors(cfg, v, device, fp32_leaves, k) for k, v in node.items()}
    dt = torch.float32 if name in fp32_leaves else layers.dtype_of(cfg.dtype)
    return torch.from_numpy(np.array(node, np.float32)).to(device=device, dtype=dt)


def _index(node, *idx):
    """Every leaf of a tree of stacked arrays at index `idx`."""
    if isinstance(node, dict):
        return {k: _index(v, *idx) for k, v in node.items()}
    return np.asarray(node)[idx]


def _lm_tree(cfg: ModelConfig, params: dict, device, fp32_leaves) -> dict:
    """The reference's parameter tree (numpy arrays, `layers` leaves stacked
    along a leading n_layers axis) as the port's: one dict per layer, leaves
    named in `fp32_leaves` in fp32 and every other leaf in cfg.dtype."""
    out = {k: _tensors(cfg, v, device, fp32_leaves)
           for k, v in params.items() if k != "layers"}
    out["layers"] = [_tensors(cfg, _index(params["layers"], i), device, fp32_leaves)
                     for i in range(cfg.n_layers)]
    return out


def lm_params(cfg: ModelConfig, params: dict, device="cpu") -> dict:
    """The port's transformer parameters from the reference's parameter
    tree, given as numpy arrays (e.g. `jax.tree.map(np.asarray, params)`).

    The reference stacks every `layers` leaf along a leading n_layers axis;
    the port keeps one dict per layer. Weights are cast once to cfg.dtype
    on `device` — the reference casts its fp32 masters to cfg.dtype at
    every use, so the values are the same — and norm scales stay fp32, as
    the reference multiplies them in fp32. A tied embedding stays one
    table."""
    return _lm_tree(cfg, params, device, ("scale",))


def rwkv6_params(cfg: ModelConfig, params: dict, device="cpu") -> dict:
    """The port's rwkv6 parameters from the reference's tree (numpy arrays),
    as `lm_params` does for the dense tree. Kept in fp32, because the
    reference computes with them in fp32: norm scales, the layernorms'
    `bias`, `w0` (cast to fp32 before the decay LoRA is added) and `u`
    (cast to fp32 for the scan). The `mu_*` lerp coefficients are cast to
    the activations' type at use, so cfg.dtype is their value there."""
    return _lm_tree(cfg, params, device, ("scale", "bias", "w0", "u"))


def rglru_params(cfg: ModelConfig, params: dict, device="cpu") -> dict:
    """The port's RG-LRU hybrid parameters from the reference's tree (numpy
    arrays). The reference groups the layers: `rec` and `attn` leaves are
    stacked (n_groups, per_group, ...) over the whole groups of the
    pattern, and `rem` lists the remainder layers; the port keeps one dict
    per layer in `cfg.block_kinds()` order (layer li of the reference's
    `_layer_params`). Norm scales and `lam` stay fp32, as the reference
    computes with them in fp32; every other leaf is cast to cfg.dtype, the
    type the reference casts it to at use (`conv_w`, `conv_b`, `ba` and
    `bx` to the activations' type)."""
    fp32 = ("scale", "lam")
    p = len(cfg.pattern)
    n_groups = cfg.n_layers // p
    per_layer = []
    for li in range(cfg.n_layers):
        g, off = divmod(li, p)
        if g >= n_groups:
            per_layer.append(params["rem"][li - n_groups * p])
            continue
        kind = cfg.pattern[off]
        idx = cfg.pattern[:off].count(kind)
        per_layer.append(_index(params[kind], g, idx))
    out = {k: _tensors(cfg, params[k], device, fp32)
           for k in ("embed", "final_norm", "head")}
    out["layers"] = [_tensors(cfg, lp, device, fp32) for lp in per_layer]
    return out
