"""Build the port's native sources and load them with ctypes.

Each CUDA source ``csrc/<name>.cu`` (nvcc) and each host C++ source in
``HOST_SOURCES`` (g++: the BVH builder ``native/bvh_builder.cpp``) becomes
``_build/lib<name>-<hash>.so``, a shared library with a plain C interface
(no PyTorch headers, so a build takes seconds). The hash covers the source,
every header under ``csrc/`` that it includes (``#include "..."``, followed
through the headers) and the flags, so an edited source or header is
rebuilt; a finished library is reused. A failed build raises with the compiler's output.
The TMA tensor maps are encoded by libcuda's cuTensorMapEncodeTiled,
reached through the CUDA runtime's entry-point query, so nothing links
against libcuda. Nothing is compiled when the package is imported: the
first launch builds, or ``build_all`` does.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v [-fmad=false] -o lib<name>.so csrc/<name>.cu

(``-fmad=false`` for ``bvh.cu`` and ``sweep.cu``, see ``EXTRA_FLAGS``.)

    g++ -O3 -shared -fPIC -std=c++17 -o libbvh_builder.so native/bvh_builder.cpp
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("nlm", "bvh", "sweep")  # CUDA: csrc/<name>.cu
# host C++, built with the JAX package's flags (tinsel_tpu/native/
# bvh_native.py) so that both make the same trees
HOST_SOURCES = {"bvh_builder": _PKG / "native" / "bvh_builder.cpp"}
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# per source: the BVH walks and the sweep round every product and sum on
# its own, so that t equals the plain version's bit for bit (csrc/bvh.cu,
# csrc/sweep.cu)
EXTRA_FLAGS = {"bvh": ("-fmad=false",), "sweep": ("-fmad=false",)}


def flags(name: str) -> tuple:
    if name in HOST_SOURCES:
        return HOST_FLAGS
    return FLAGS + EXTRA_FLAGS.get(name, ())


def source(name: str) -> Path:
    return HOST_SOURCES.get(name, CSRC / f"{name}.cu")

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


def gxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found is None:
        raise RuntimeError(
            "g++ not found (set CXX): the BVH builder of tinsel_tpu_torch is "
            "built from native/bvh_builder.cpp at first use"
        )
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def headers(path: Path) -> list:
    """The local headers ``path`` includes, directly or through another
    one, each once, in the order they are first met."""
    out, todo = [], [path]
    while todo:
        for inc in _INCLUDE.findall(todo.pop(0).read_bytes()):
            h = path.parent / inc.decode()
            if h not in out:
                out.append(h)
                todo.append(h)
    return out


def library_path(name: str) -> Path:
    path = source(name)
    src = path.read_bytes() + b"".join(h.read_bytes() for h in headers(path))
    digest = hashlib.sha256(src + " ".join(flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start the compiler for one source; returns (process, tmp path,
    final path, start time), or None if the library is already built."""
    so = library_path(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    compiler = gxx() if name in HOST_SOURCES else nvcc()
    cmd = [compiler, *flags(name), "-o", str(tmp), str(source(name))]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, so, time.perf_counter()


def _finish(name: str, job):
    proc, tmp, so, t0 = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(proc.args[0]).name} failed for {source(name)}:\n{out}")
    os.replace(tmp, so)  # atomic: concurrent builders never see half a file
    build_log[name] = (time.perf_counter() - t0, out)


def build_all(names=SOURCES) -> dict:
    """Build every source not yet built, one compiler per source, all
    started together. Returns {name: library path}."""
    jobs = {name: _start(name) for name in names}
    for name, job in jobs.items():
        if job is not None:
            _finish(name, job)
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all((name,))[name]
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib
