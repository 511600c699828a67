"""The traced run's readings, taken from the benchmark's own files around
calls into the port (no span inside the program yet):

* a profiled segment (``torch.profiler``, CPU and CUDA activities) of
  ``trace_iterations`` iterations: the device's records read raw (kernel,
  copy and set records), the busy time as the union of their intervals,
  the idle gaps labelled by the innermost host op running at their middle,
  and the launches (the port's own kernels counted by their wrappers, since
  the profiler can miss a lone ctypes launch);
* for the renderer: CUDA-event spans around the integrator's calls into
  the trace layer (``integrator.trace_closest``, ``lights.trace_any``) and
  around each pass, in passes of their own; and the port's K5, K3/K4 and
  K6c/K6a launches timed one by one by events behind a spin kernel, their
  inputs kept for sampled calls so that the work they did can be counted.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time

import torch

OWN_KERNEL = re.compile(
    r"(sweep_(closest|any)|bvh_\w+|nlm_(filter|guided)|nee_(light|shade))_kernel")
SPIN_CYCLES = 200_000  # torch.cuda._sleep: about 0.1 ms of the card
RUNTIME = re.compile(r"^(cuda|cu[A-Z])")  # runtime and driver API records


class Trace:
    """What the metric readers read (``metrics/<name>.py::read``)."""

    def __init__(self, kind: str):
        self.kind = kind
        self.iterations = 0  # of the profiled segment
        self.window_s = 0.0
        self.device = []  # (start_ns, end_ns, name) of each device record
        self.busy_s = 0.0
        self.other_launches = 0  # kernel records that are not the port's own
        self.own_launches = 0  # the wrappers' counts over the same iterations
        self.gaps = {}  # host label -> idle seconds
        self.trace_ms = []  # event spans of the trace calls
        self.pass_ms = []  # event spans of the passes that hold them
        self.kernel_calls = {}  # "sweep" / "walk" / "rounds" -> [(bound ms, device ms)]
        self.captured = None  # the timed launches, until their bounds are counted
        self.post_ms = []  # the viewer's host spans after the step, per frame

    def op_seconds(self) -> dict:
        """Device seconds by operation name (cut to 96 characters)."""
        ops = {}
        for a, b, name in self.device:
            ops[name[:96]] = ops.get(name[:96], 0.0) + (b - a) / 1e9
        return ops

    def breakdown(self) -> dict:
        top = sorted(self.op_seconds().items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return dict(device_ops=[[k, v] for k, v in top], idle_gaps=[[k, v] for k, v in gaps])


def _union_ns(intervals) -> tuple:
    """(busy ns, gaps [(start, end)]) of sorted intervals."""
    busy, gaps, cur = 0, [], None
    for a, b in intervals:
        if cur is None:
            cur = [a, b]
        elif a <= cur[1]:
            cur[1] = max(cur[1], b)
        else:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], a))
            cur = [a, b]
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy, gaps


def _label(ops, starts, t) -> str:
    """The innermost host op running at ``t`` (``ops`` sorted by start)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 400, -1), -1):
        a, b, name = ops[j]
        if b >= t:
            return name
    return "host (no op)"


def profiled(loop, iterations: int, trace: Trace, counts):
    """Run ``iterations`` of ``loop`` under the profiler and reduce the
    records into ``trace``. ``counts``: a callable giving the port's
    wrapper launch counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loop.sync()
        t0 = time.perf_counter()
        for _ in range(iterations):
            loop.iterate()
        loop.sync()
        trace.window_s = time.perf_counter() - t0
    after = counts()
    trace.iterations = iterations
    trace.own_launches = sum(after[k] - before[k] for k in after)
    host = []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            trace.device.append((a, b, e.name()))
        elif not RUNTIME.match(e.name()):
            host.append((a, b, e.name()))
    trace.device.sort()
    kernels = [d for d in trace.device if "Memcpy" not in d[2] and "Memset" not in d[2]]
    trace.other_launches = sum(1 for d in kernels if not OWN_KERNEL.search(d[2]))
    busy, gaps = _union_ns([(a, b) for a, b, _ in trace.device])
    trace.busy_s = busy / 1e9
    host.sort()
    starts = [h[0] for h in host]
    for a, b in gaps:
        name = _label(host, starts, (a + b) // 2)
        trace.gaps[name] = trace.gaps.get(name, 0.0) + (b - a) / 1e9
    return prof


@contextlib.contextmanager
def trace_spans(port, trace: Trace):
    """CUDA events around ``integrator.trace_closest``, ``lights.trace_any``
    and ``lights.trace_closest`` (the shadow rays under
    ``NEE_CLOSEST_SHADOW``) while active; ``trace.trace_ms`` gets their
    spans on exit."""
    pairs = []

    def timed(fn):
        def wrapper(*a, **k):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out = fn(*a, **k)
            e1.record()
            pairs.append((e0, e1))
            return out
        return wrapper

    orig = (port.integrator.trace_closest, port.lights.trace_any, port.lights.trace_closest)
    port.integrator.trace_closest = timed(orig[0])
    port.lights.trace_any = timed(orig[1])
    port.lights.trace_closest = timed(orig[2])
    try:
        yield
    finally:
        port.integrator.trace_closest, port.lights.trace_any, port.lights.trace_closest = orig
    torch.cuda.synchronize()
    trace.trace_ms.append(sum(a.elapsed_time(b) for a, b in pairs))


def pass_span(loop, trace: Trace):
    """One iteration of ``loop`` between two CUDA events."""
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    loop.sync()
    e0.record()
    loop.iterate()
    e1.record()
    e1.synchronize()
    trace.pass_ms.append(e0.elapsed_time(e1))


def _timed_entry(orig_entry, calls: list, pending: list):
    """A module's ``_entry`` whose kernels run between CUDA events, a spin
    kernel before each so that the card is busy when the host reaches the
    launch; each launch that returns 0 adds (kernel, kept, (start, end)) to
    ``calls``, ``kept`` popped from ``pending`` where the launch's caller
    left it."""
    def entry(kernel):
        fn = orig_entry(kernel)

        def timed(*a):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            for e in (start, end):
                e.record()
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            err = fn(*a)
            end.record()
            name, kept = pending.pop() if pending else (kernel, None)
            if err == 0:
                calls.append((name, kept, (start, end)))
            return err
        return timed
    return entry


def _marked(pending: list, mark, fn, *args):
    """``fn(*args)`` with ``mark`` pending for its launch; the mark goes
    where no launch took it (no rays)."""
    pending.append(mark)
    try:
        return fn(*args)
    finally:
        if pending and pending[-1] is mark:
            pending.pop()


@contextlib.contextmanager
def kernel_spans(module, keep):
    """Each launch of ``module``'s kernels (``ops/sweep.py``, ``ops/bvh.py``)
    between CUDA events, a spin kernel before it so that the card is busy
    when the host reaches the launch; ``keep(kernel, index)`` says whether to
    keep a launch's arguments. Yields the list of (kernel, args or None,
    (start, end)) filled as the launches come."""
    calls, seen, pending = [], {}, []
    orig_entry, orig_launch = module._entry, module._launch

    def launch(kernel, *args):
        i = seen.get(kernel, 0)
        seen[kernel] = i + 1
        kept = tuple(x.clone() if torch.is_tensor(x) else x for x in args) if keep(kernel, i) \
            else None
        return _marked(pending, (kernel, kept), orig_launch, kernel, *args)

    module._entry, module._launch = _timed_entry(orig_entry, calls, pending), launch
    try:
        yield calls
    finally:
        module._entry, module._launch = orig_entry, orig_launch
        torch.cuda.synchronize()


ROUNDS = {"rounds_closest": "rounds_closest_cuda", "rounds_any": "rounds_any_cuda"}


@contextlib.contextmanager
def round_spans(module, keep):
    """Each launch of the shortlist rounds (``ops/instances.py``: K6c
    ``rounds_closest``, K6a ``rounds_any``) between CUDA events, as
    ``kernel_spans`` times them; ``keep(kernel, index)`` says whether to
    keep a launch's inputs, as the bound reads them: its rays, its
    instances and whether the batch moves. Yields the list of (kernel,
    inputs or None, (start, end)) filled as the launches come."""
    calls, seen, pending = [], {}, []
    orig = {k: getattr(module, f) for k, f in ROUNDS.items()}
    orig_entry = module._entry

    def hooked(kernel):
        def launch(scene, tab, origins, *rest):
            i = seen.get(kernel, 0)
            seen[kernel] = i + 1
            kept = dict(rays=origins.shape[0], instances=len(tab.prims),
                        motion=bool(tab.motion)) if keep(kernel, i) else None
            return _marked(pending, (kernel, kept), orig[kernel], scene, tab, origins, *rest)
        return launch

    for k, f in ROUNDS.items():
        setattr(module, f, hooked(k))
    module._entry = _timed_entry(orig_entry, calls, pending)
    try:
        yield calls
    finally:
        for k, f in ROUNDS.items():
            setattr(module, f, orig[k])
        module._entry = orig_entry
        torch.cuda.synchronize()


ALLREDUCE = re.compile(r"nccl\w*AllReduce", re.IGNORECASE)  # NCCL's all-reduce kernels


def rank_summary(t: Trace) -> dict:
    """One rank's traced steps, reduced to what rank 0 gathers: the steps,
    the window and busy seconds, the device ms of each NCCL all-reduce
    kernel in the order they ran (one a step), and seconds by device op and
    by the host label of the idle gaps."""
    return dict(iterations=t.iterations, window_s=t.window_s, busy_s=t.busy_s,
                allreduce_ms=[(b - a) / 1e6 for a, b, name in t.device
                              if ALLREDUCE.search(name)],
                ops=t.op_seconds(), gaps=dict(t.gaps))


class RankTraces:
    """What the metric readers of a cell of several cards read: each rank's
    ``rank_summary``, in rank order."""

    kind = "step"

    def __init__(self, ranks: list):
        self.ranks = ranks
        self.iterations = ranks[0]["iterations"]
        self.busy_s = sum(r["busy_s"] for r in ranks) / len(ranks)
        self.window_s = sum(r["window_s"] for r in ranks) / len(ranks)

    def allreduce_steps(self):
        """[rank][step] device ms of the all-reduce kernels, where every
        rank ran one a step; else None."""
        ar = [r["allreduce_ms"] for r in self.ranks]
        return ar if all(len(a) == self.iterations > 0 for a in ar) else None

    def breakdown(self) -> dict:
        """The device ops and idle gaps that took most time, averaged over
        the ranks."""
        def top(key):
            acc = {}
            for r in self.ranks:
                for k, v in r[key].items():
                    acc[k] = acc.get(k, 0.0) + v / len(self.ranks)
            return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:10]]
        return dict(device_ops=top("ops"), idle_gaps=top("gaps"))
