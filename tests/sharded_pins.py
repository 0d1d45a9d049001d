"""Print the reference's pins of `chip_smoke.py`'s `[sharded]` phase.

Runs `repro.core.scheduler.build_sharded_run` (JAX on the CPU, 256 forced
host devices: one worker a device) for every run of `SHARDED_RUNS` and
prints each one's `sharded_row` (rounds, result, nodes, attempts,
successes, overflow, then the first 16 hex digits of the sha256 of every
state leaf). Not a test; run from the repository root (the two 16x16 runs
take minutes):

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/sharded_pins.py
"""

import os

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=256 "
                           + os.environ.get("XLA_FLAGS", ""))

import json  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke as c  # noqa: E402  (the recipe's constants; no JAX there)
from sharded_reference import sharded_run  # noqa: E402

from repro.core import tasks  # noqa: E402


def main():
    for label, (shape, strategy, torus, fields, capacity, max_rounds) in c.SHARDED_RUNS.items():
        t0 = time.perf_counter()
        leaves, rounds = sharded_run(jax, shape, strategy, torus, tasks.FibWorkload(**fields),
                                     capacity=capacity, max_rounds=max_rounds)
        row = c.sharded_row(np, leaves, rounds)
        print(f'"{label}": {json.dumps(row)},  # {time.perf_counter() - t0:.1f} s', flush=True)


if __name__ == "__main__":
    main()
