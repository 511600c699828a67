"""The spans segment of a traced run: ``iterations`` more units of the loop
under ``torch.profiler`` (CPU and CUDA) with the port's span recorder on
(``tinsel_tpu_torch/utils/profiling.py::recording``), each device-idle gap
put down to the layer whose span was open on the host at its middle.

The units run through ``trace.profiled``, so the device records and their
union gaps (``trace._union_ns``) are read as the traced run reads them.
The spans are read from their own profiler records (a recorded span opens
a ``record_function`` record of its name under an active profiler): the
profiler stamps those on the clock of its device records by construction,
where the spans' ``time.time_ns()`` stamps agree with them to a few
microseconds (``tests/test_torch_tracing_cuda.py``).

Each gap (and each kernel, by the runtime record that launched it) goes to
one layer: ``app`` where an ``app.*`` span is open at any depth (its
children included), else by the innermost open span: ``trace``
(``trace.*``), ``nee`` (``lights.nee``), ``shade`` (``integrator.bounce``),
``pass`` (``render.pass`` itself), or ``none`` outside every span. The
innermost span comes from a timeline of the spans' nesting, not from
``trace._label``, whose bounded look-back is shorter than a deep pass's
list of spans.

The traced run (``run_cell.py::traced``) does not call ``segment`` yet;
by hand, on the card, beside a cell's loop::

    t = trace.Trace(loop.unit)
    segment(loop, SimpleNamespace(profiling=tinsel_tpu_torch.utils.profiling), 2, t)
    print(t.span_idle, t.span_launches, t.span_host_syncs)
"""

from __future__ import annotations

import bisect

from . import trace as tracing

LAYERS = ("trace", "nee", "shade", "pass", "app", "none")
INNERMOST = {"lights.nee": "nee", "integrator.bounce": "shade", "render.pass": "pass"}


def layer(stack) -> str:
    """The layer of the innermost open span, ``stack`` outermost first."""
    if any(name.startswith("app.") for name in stack):
        return "app"
    if not stack:
        return "none"
    return "trace" if stack[-1].startswith("trace.") else INNERMOST.get(stack[-1], "none")


def timeline(spans) -> tuple:
    """(times, layers): from each time in ``times`` on, the layer in force,
    for host intervals ``spans`` [(start_ns, end_ns, name)] that nest (the
    spans of one thread)."""
    marks = sorted([(a, 1, i) for i, (a, _, _) in enumerate(spans)]
                   + [(b, 0, i) for i, (_, b, _) in enumerate(spans)])  # ends first on a tie
    times, layers, stack = [], [], []
    for t, start, i in marks:
        if start:
            stack.append(i)
        else:
            stack.remove(i)
        times.append(t)
        layers.append(layer([spans[j][2] for j in stack]))
    return times, layers


def at(times, layers, t) -> str:
    k = bisect.bisect_right(times, t) - 1
    return layers[k] if k >= 0 else "none"


def idle_by_layer(gaps, times, layers) -> dict:
    """Seconds of the gaps [(start_ns, end_ns)] by the layer in force
    (``timeline``) at each gap's middle."""
    out = dict.fromkeys(LAYERS, 0.0)
    for a, b in gaps:
        out[at(times, layers, (a + b) // 2)] += (b - a) / 1e9
    return out


def segment(loop, port, iterations: int, trace: tracing.Trace):
    """Run ``iterations`` units of ``loop`` under the profiler with the
    port's spans recorded (``port.profiling``), and store on ``trace``:
    ``span_iterations``; ``span_window_s``; ``span_idle`` (idle seconds by
    layer); ``span_launches`` and ``span_busy`` (the kernels, and their
    device seconds, by the layer open where the host launched them; a
    launch the profiler did not see is left out); ``span_host_syncs`` (the
    port's ``host_syncs`` over the segment)."""
    from torch.autograd import DeviceType

    prof = port.profiling
    seen = tracing.Trace(loop.unit)
    syncs = prof.host_syncs
    with prof.recording() as recorded:
        p = tracing.profiled(loop, iterations, seen, dict)  # launches: by layer, below
    trace.span_host_syncs = prof.host_syncs - syncs
    trace.span_iterations, trace.span_window_s = iterations, seen.window_s
    _, gaps = tracing._union_ns([(a, b) for a, b, _ in seen.device])
    names = {s.name for s in recorded}
    spans, launches, kernels = [], [], []
    for e in p.profiler.kineto_results.events():
        a = e.start_ns()
        if e.device_type() == DeviceType.CUDA:
            if "Memcpy" not in e.name() and "Memset" not in e.name():
                kernels.append((e.correlation_id(), e.duration_ns()))
        elif e.name() in names:
            spans.append((a, a + e.duration_ns(), e.name()))
        elif "Launch" in e.name() and tracing.RUNTIME.match(e.name()):
            launches.append((a, e.correlation_id()))
    times, layers = timeline(spans)
    trace.span_idle = idle_by_layer(gaps, times, layers)
    launched = {c: at(times, layers, a) for a, c in launches}
    trace.span_launches = dict.fromkeys(LAYERS, 0)
    trace.span_busy = dict.fromkeys(LAYERS, 0.0)
    for c, ns in kernels:
        if c in launched:
            trace.span_launches[launched[c]] += 1
            trace.span_busy[launched[c]] += ns / 1e9
    return p
