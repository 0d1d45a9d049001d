"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each source in `csrc/` is compiled on its own into a shared library with a
plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -shared``),
one nvcc process per source, all started together. Libraries are named by a
hash of their source and flags, so a stale build is never loaded. They go to
``build/repro_torch_kernels/`` at the repository root (git-ignored), or to
``$REPRO_TORCH_BUILD_DIR``. Nothing is built at import: the first wrapper
call on a CUDA tensor builds what it needs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("steal_compact", "deque_apply", "flash_attention", "decode_attention",
           "wkv6", "rglru")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the launch functions (pointers and stream as void*)
_SIGNATURES = {
    "steal_compact": {
        "steal_compact_launch": [_P] * 7 + [_I] * 3 + [_P],
        "steal_compact_grant_width": [],
    },
    "deque_apply": {
        "deque_apply_launch": [_P] * 4 + [_I] * 3 + [_P],
    },
    "flash_attention": {
        "flash_attention_launch": [_P] * 4 + [_I] * 8 + [_P],
        "flash_attention_max_group": [_I],
    },
    "decode_attention": {
        "decode_attention_launch": [_P] * 7 + [_I] * 6 + [_P],
        "decode_attention_max_group": [_I],
        "decode_attention_chunk": [_I],
        "decode_attention_warps": [_I],
        "decode_attention_tile": [],
        "decode_attention_cluster": [_I, _I],
        "decode_attention_scratch_floats": [_I] * 6,
        "decode_attention_tickets_per_pair": [],
    },
    "wkv6": {
        "wkv6_launch": [_P] * 8 + [_I] * 4 + [_P],
        "wkv6_head_dim": [],
        "wkv6_tile": [],
    },
    "rglru": {
        "rglru_launch": [_P] * 7 + [_I] * 4 + [_P],
        "rglru_uses_tma": [_I] * 3,
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
# ptxas register/shared-memory report of each build, by kernel name
BUILD_LOGS: dict[str, str] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    """Where the library of kernel `name` is (or would be) built."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES) -> float:
    """Compile every missing library of `names` in parallel; returns the
    wall seconds spent. Raises with nvcc's output if any build fails."""
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return 0.0
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = out_dir / f"{lib_path(n).name}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, lib_path(n))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
