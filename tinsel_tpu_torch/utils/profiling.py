"""Timing and tracing; the port of ``tinsel_tpu/utils/profiling.py``.

``sync`` waits for the device work behind a tensor (PyTorch returns before
the card finishes), ``timer`` times a block up to that sync, and
``profiler_trace`` (the JAX package's ``xla_trace``) records a
``torch.profiler`` trace of a block as a Chrome/Perfetto JSON file, with
the port's spans beside the kernels.

The spans: ``span(name, **attrs)`` (a context manager) and ``traced(name)``
(a decorator) mark the port's layers where their work happens (the pass,
each bounce, NEE, the trace calls, the viewer's resolve, AOVs, denoiser and
PNG). Off, the default, a span is one test of a module flag and records
nothing. Inside ``recording()`` each span appends a ``SpanRecord`` with its
parent and root (the outermost open span on its thread, so all spans of one
pass share a root), stamped with ``time.time_ns()``, the Unix clock onto
which ``torch.profiler`` maps its host and device records. Under an active
profiler a recorded span also opens a ``record_function`` record of its
name (``_RecordFunctionFast``: under a microsecond each way) with its
stamps inside: a reading against the device records takes that record,
which is on their clock by construction, and so can put each device-idle
gap under the span that was open on the host. No span synchronises or
reads a device value.

``host_syncs`` counts, always, each place on the render path where the host
waits for the card (``count_sync`` beside it), like the kernel wrappers'
``launch_counts``.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading
import time
from typing import NamedTuple

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
    with torch.profiler.profile(activities=acts) as prof, recording():
        yield prof
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}", flush=True)


class SpanRecord(NamedTuple):
    """One closed span; times in ``time.time_ns()`` nanoseconds."""

    name: str
    id: int
    parent: int | None  # the enclosing span's id, None for a root
    root: int  # the outermost enclosing span's id (its own for a root)
    start_ns: int
    end_ns: int
    attrs: dict


_records: list | None = None  # the active recording()'s list; None: spans off
_ids = itertools.count(1)
_open = threading.local()  # .stack: the spans open on this thread
host_syncs = 0


def count_sync():
    """Count one host sync in ``host_syncs`` (called beside each place on
    the render path where the host waits for the card)."""
    global host_syncs
    host_syncs += 1


class _Span:
    __slots__ = ("name", "attrs", "out", "id", "parent", "root", "start", "fn")

    def __init__(self, name: str, attrs: dict, out: list):
        self.name, self.attrs, self.out = name, attrs, out

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.id = next(_ids)
        outer = stack[-1] if stack else None
        self.parent = outer.id if outer else None
        self.root = outer.root if outer else self.id
        stack.append(self)
        self.fn = None
        if torch.autograd._profiler_enabled():  # the stamps fall inside its record
            self.fn = torch._C._profiler._RecordFunctionFast(self.name)
            self.fn.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.fn is not None:
            self.fn.__exit__(*exc)
        _open.stack.pop()
        self.out.append(SpanRecord(self.name, self.id, self.parent, self.root, self.start, end,
                                   self.attrs))
        return False


_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """A context manager marking a block as the span ``name`` (``attrs``
    kept with its record); the shared no-op context unless recording."""
    if _records is None:
        return _OFF
    return _Span(name, attrs, _records)


def traced(name: str):
    """Decorator: each call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _records is None:
                return fn(*args, **kwargs)
            with _Span(name, {}, _records):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def recording():
    """Record the spans closed inside the block (on every thread); yields
    the list of ``SpanRecord`` they are appended to. A nested recording's
    records reach the enclosing one's list too."""
    global _records
    outer, mine = _records, []
    _records = mine
    try:
        yield mine
    finally:
        _records = outer
        if outer is not None:
            outer.extend(mine)
