"""Timing and tracing; the port of ``tinsel_tpu/utils/profiling.py``.

``sync`` waits for the device work behind a tensor (PyTorch returns before
the card finishes), ``timer`` times a block up to that sync, and
``profiler_trace`` (the JAX package's ``xla_trace``) records a
``torch.profiler`` trace of a block as a Chrome/Perfetto JSON file.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def sync(x):
    """Wait until the device work feeding ``x`` (a tensor, or a list,
    tuple or dict holding tensors) has finished: ``torch.cuda.synchronize``
    on the device of its first tensor when that is a CUDA device; CPU work
    is done when the call returns. Returns ``x``."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return x


@contextlib.contextmanager
def timer(name: str = "", rays: int | None = None, result=None):
    """Time a block up to a device sync on what it produced; optionally
    report a rays/s rate. Usage:

        with timer("render", rays=w*h*spp*depth) as t:
            out = fn(...)
            t.watch(out)
    """

    class _T:
        out = result
        elapsed = 0.0

        def watch(self, x):
            self.out = x
            return x

    t = _T()
    t0 = time.perf_counter()
    try:
        yield t
    finally:
        if t.out is not None:
            sync(t.out)
        t.elapsed = time.perf_counter() - t0
        msg = f"[{name}] {t.elapsed * 1e3:.2f} ms"
        if rays:
            msg += f"  ({rays / max(t.elapsed, 1e-12) / 1e6:.2f} Mrays/s)"
        print(msg, flush=True)


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """Record a ``torch.profiler`` trace of the block (host ops, and the
    card's kernels when CUDA is available) and write it to
    ``logdir/trace.json`` (Chrome/Perfetto format). The port's form of
    ``xla_trace``. Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}", flush=True)
