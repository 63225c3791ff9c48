"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at first use, never at import (the CPU tests import every module),
from the sources in this package only: all sources are compiled together,
one ``nvcc`` process each, into ``build/repro_torch/<digest>/`` under the
repository root, where the digest covers the sources and the flags. A
later process with the same sources loads the libraries without building.
A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from repro_torch.obs.metrics import CounterGroup

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("mex_window", "conflict", "compact", "fused_compact", "jpl_prio",
           "frontier", "fused_step", "q8_dot", "hub")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

#: CUDA kernel launches per wrapper, bumped where each wrapper launches
#: (a wrapper call that launches several kernels adds each of them)
KERNEL_LAUNCHES = CounterGroup("kernels.launches", SOURCES)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def build_root() -> Path:
    """``build/repro_torch`` beside ``src/`` in the repository checkout."""
    return CSRC.parents[3] / "build" / "repro_torch"


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first "
                       "use and need the CUDA toolkit")


def build_all() -> tuple[Path, float]:
    """Compile every missing library (one ``nvcc`` per source, all started
    together). Returns the build directory and the seconds spent; the
    compiler output of a fresh build is kept in ``build.log`` there."""
    import time

    out = build_root() / _digest()
    missing = [n for n in SOURCES if not (out / f"lib{n}.so").exists()]
    if not missing:
        return out, 0.0
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name in missing:
        tmp = out / f".lib{name}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for name, tmp, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {name} (rc {proc.returncode})\n{text}")
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, out / f"lib{name}.so")
    (out / "build.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    return out, time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all on first use."""
    with _lock:
        if not _libs:
            out, _ = build_all()
            for n in SOURCES:
                _libs[n] = ctypes.CDLL(str(out / f"lib{n}.so"))
        return _libs[name]


@functools.cache
def function(lib: str, symbol: str, argtypes: tuple):
    """The C function ``symbol`` of ``lib`` with its argument types set."""
    fn = getattr(library(lib), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def require(t, what: str, dtype, shape: tuple, device) -> None:
    """Validate one operand before its pointer goes to a kernel."""
    if t.device != device:
        raise ValueError(f"{what}: expected a tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def tile_arg(tile_rows: "int | None", what: str) -> int:
    """The ``tile_rows`` argument of a row kernel's launch: rows per
    thread block (``csrc/rows.cuh``), 0 for the default block."""
    if tile_rows is None:
        return 0
    if isinstance(tile_rows, bool) or not isinstance(tile_rows, int) \
            or tile_rows < 1:
        raise ValueError(f"{what}: tile_rows must be a positive int or "
                         f"None, got {tile_rows!r}")
    return tile_rows


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch function."""
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
