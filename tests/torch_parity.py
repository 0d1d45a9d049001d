"""Shared helpers of the port's parity tests: numpy in, both packages out.

Inputs are made with numpy from a seed and handed to the JAX reference
(`repro`) and to the port (`repro_torch`, on the CPU); results are compared
as numpy arrays.
"""

import gc
import os

import filelock
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


# a third of the kernel's default limit on a process's memory mappings
# (vm.max_map_count, 65,530)
MAPPINGS_BEFORE_CLEAR = 20_000


def _mappings() -> int:
    """This process's memory mappings (0 where /proc is not there)."""
    try:
        with open("/proc/self/maps", "rb") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


def _release_if_crowded():
    if _mappings() > MAPPINGS_BEFORE_CLEAR:
        jax.clear_caches()
        gc.collect()


@pytest.fixture(autouse=True)
def release_reference_compiles():
    """Drop JAX's compiled executables around a parity test once this
    process holds more than MAPPINGS_BEFORE_CLEAR memory mappings (autouse
    where a module imports it). XLA's CPU backend maps each executable's
    code in many small regions (~700 for a simulator compile) and keeps
    them while JAX caches it; an xdist worker that compiles the reference
    test after test reaches the kernel's limit, where LLVM cannot allocate
    and XLA segfaults in the next compile, taking the worker down."""
    _release_if_crowded()
    yield
    _release_if_crowded()


def np_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def to_jax(a, dtype=jnp.int32):
    return jnp.asarray(np.asarray(a), dtype)


def to_torch(a, dtype=torch.int32):
    return torch.as_tensor(np.ascontiguousarray(a)).to(dtype)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def assert_same(a, b, what=""):
    """Exact equality of two arrays (jax, torch or numpy), shape included."""
    a, b = as_np(a), as_np(b)
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    np.testing.assert_array_equal(a, b, err_msg=what)


def assert_results_equal(ref, port, skip=()):
    """Every field of two `SimResult`s equal (arrays elementwise; the
    flight recorder's `Trace` and `TimeSeries` field by field, their arrays
    elementwise)."""
    assert ref._fields == port._fields
    for f in ref._fields:
        if f in skip:
            continue
        a, b = getattr(ref, f), getattr(port, f)
        if f in ("trace", "timeseries") and (a is not None or b is not None):
            assert a is not None and b is not None, f"{f}: {a!r} vs {b!r}"
            for name in a.__dataclass_fields__:
                x, y = getattr(a, name), getattr(b, name)
                if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                    assert_same(x, y, f"{f}.{name}")
                else:
                    assert x == y, f"{f}.{name}: reference {x!r} != port {y!r}"
        elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert_same(a, b, f)
        else:
            assert a == b, f"{f}: reference {a!r} != port {b!r}"


def port_linkstate(ls):
    """The port's `LinkStateSchedule` of the reference's (None passes)."""
    from repro_torch import convert

    if ls is None:
        return None
    return convert.linkstate_schedule(ls.epoch_starts, ls.link_tau, ls.link_up,
                                      ls.speed)


def port_simulate(workload, mesh, cfg, schedule=None, **overrides):
    """Run the port on the CPU with the reference's workload, mesh and
    `SimConfig` (carried across by `repro_torch.convert`), with `overrides`
    applied to the config's fields and `schedule` (a dict of `fail_time`,
    `wake_time`, `fail_period`, `speed` numpy arrays, `linkstate`, a
    reference `LinkStateSchedule`, with `routing_backend`, and `arrivals`, a
    reference `ArrivalConfig`) passed on."""
    import dataclasses

    from repro_torch import convert
    from repro_torch.core import simulator as psim

    fields = {**dataclasses.asdict(cfg), **overrides}
    schedule = dict(schedule or {})
    if "linkstate" in schedule:
        schedule["linkstate"] = port_linkstate(schedule["linkstate"])
    if schedule.get("arrivals") is not None:
        schedule["arrivals"] = convert.arrival_config(
            dataclasses.asdict(schedule["arrivals"]))
    return psim.simulate(
        convert.workload(type(workload).__name__, dataclasses.asdict(workload)),
        convert.mesh(mesh.num_workers, mesh.rows, mesh.cols, mesh.torus),
        convert.sim_config(fields), device="cpu", **schedule)


# (step_mode, deque_backend, use_steal_kernel): the port's stepper x backend
# matrix; on the CPU both values of the kernel flag run the kernels' plain
# versions, and both are accepted
PORT_MODES = [("tick", "loop", False), ("tick", "staged", True),
              ("leap", "loop", True), ("leap", "staged", False)]


def check_against_reference(ref_result, workload, mesh, cfg,
                            own_famine_ref=None):
    """Every port mode equals the reference run (leap, famine_batch=0) in
    every field; `events` equals it in leap mode and equals `ticks` in tick
    mode. Where the caller passes `own_famine_ref`, the reference run of
    `cfg` at its own `famine_batch`, the port in leap mode at that
    `famine_batch` equals it too, `events` included, on both backends."""
    for mode, backend, kernel in PORT_MODES:
        got = port_simulate(workload, mesh, cfg, step_mode=mode,
                            deque_backend=backend, use_steal_kernel=kernel,
                            famine_batch=0)
        assert_results_equal(ref_result, got, skip=("events",))
        if mode == "leap":
            assert got.events == ref_result.events, (mode, backend)
        else:
            assert got.events == got.ticks
    if own_famine_ref is not None:
        for backend in ("loop", "staged"):
            got = port_simulate(workload, mesh, cfg, step_mode="leap",
                                deque_backend=backend)
            assert_results_equal(own_famine_ref, got)


def run_once(tmp_path_factory, name: str, make):
    """A directory that `make(directory)` fills once a test session: under
    pytest-xdist every worker that needs it waits on a file lock in the
    session's shared temporary directory, the first runs `make`, and the
    rest read what it wrote (a module-scoped fixture alone runs once in
    each worker that gets one of the module's tests)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    out = base / name
    with filelock.FileLock(f"{out}.lock"):
        if not (out / "done").exists():
            out.mkdir(exist_ok=True)
            make(out)
            (out / "done").touch()
    return out
