"""Strict JSON for bench/trace artifacts: no NaN, no Infinity, ever.

Python's `json.dump` defaults to `allow_nan=True` and emits the non-spec
literals ``NaN`` / ``Infinity`` / ``-Infinity`` for non-finite floats —
artifacts that then fail in any spec-compliant consumer (browsers,
`jq`, dashboards). Several of this repo's derived quantities are
*legitimately* undefined on degenerate runs (expected time-to-task at
``p_success == 0`` is exactly ``inf``; a ratio of two such is ``nan``),
so the writers here:

  * `sanitize` — recursively map non-finite floats to ``None`` (→ JSON
    ``null``, the spec's way of saying "undefined") and unwrap numpy
    scalars/arrays to plain Python;
  * `dump` / `dumps` / `write` — sanitize, then serialize with
    ``allow_nan=False`` so a non-finite value that slips past the
    sanitizer fails loudly at write time instead of corrupting the
    artifact;
  * `loads_strict` / `load_strict` — parse with a `parse_constant` hook
    that rejects the non-spec literals, for CI gates over uploaded
    artifacts.

Every JSON artifact writer in the repo (tracing exports, the crossover
and load-latency sweeps, the throughput/orbit benches) goes through this
module. This is the port's own copy of the reference's `jsonio` (numpy
only), held equal to it by the port's tests; the port's crossover benchmark
writes through it.
"""

from __future__ import annotations

import json
import math

import numpy as np


def sanitize(obj):
    """Recursively convert `obj` to strictly-JSON-serializable form:
    non-finite floats become None, numpy scalars/arrays become Python
    scalars/lists, tuples become lists. Dict keys pass through `str` when
    they are numpy scalars."""
    if isinstance(obj, dict):
        return {(_key(k)): sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return [sanitize(v) for v in obj.tolist()]
    if isinstance(obj, (np.floating, np.integer, np.bool_)):
        obj = obj.item()
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def _key(k):
    if isinstance(k, (np.floating, np.integer, np.bool_)):
        k = k.item()
    return k


def dumps(obj, **kw) -> str:
    """`json.dumps` of the sanitized document, with `allow_nan=False`."""
    kw.setdefault("allow_nan", False)
    return json.dumps(sanitize(obj), **kw)


def dump(obj, fp, **kw) -> None:
    kw.setdefault("allow_nan", False)
    json.dump(sanitize(obj), fp, **kw)


def write(path, obj, **kw) -> None:
    """Write `obj` to `path` as strict JSON (sanitized, allow_nan=False)."""
    with open(path, "w") as f:
        dump(obj, f, **kw)


def _reject(literal: str):
    """`parse_constant` hook: any non-spec literal is a hard error."""
    raise ValueError(f"non-finite JSON literal in artifact: {literal!r}")


def loads_strict(s: str):
    """Parse, rejecting `NaN`/`Infinity`/`-Infinity` (spec-strict gate)."""
    return json.loads(s, parse_constant=_reject)


def load_strict(path):
    with open(path) as f:
        return loads_strict(f.read())
