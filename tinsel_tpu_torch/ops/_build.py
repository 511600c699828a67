"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so``, a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds). The hash covers the source and the flags, so an edited
source is rebuilt; a finished library is reused.
The TMA tensor maps are encoded by libcuda's cuTensorMapEncodeTiled,
reached through the CUDA runtime's entry-point query, so nothing links
against libcuda. Nothing is compiled when the package is imported: the
first launch builds, or ``build_all`` does.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so csrc/<name>.cu
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("nlm",)
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict = {}
build_log: dict = {}  # name -> (seconds, compiler output) of builds run here


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "tinsel_tpu_torch are built from csrc/ at first use"
        )
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path,
    start time), or None if the library is already built."""
    so = library_path(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, so, time.perf_counter()


def _finish(name: str, job):
    proc, tmp, so, t0 = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, so)  # atomic: concurrent builders never see half a file
    build_log[name] = (time.perf_counter() - t0, out)


def build_all(names=SOURCES) -> dict:
    """Build every source not yet built, one nvcc per source, all started
    together. Returns {name: library path}."""
    jobs = {name: _start(name) for name in names}
    for name, job in jobs.items():
        if job is not None:
            _finish(name, job)
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all((name,))[name]
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib
