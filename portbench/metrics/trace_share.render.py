"""The share of a pass spent in the trace layer: the summed CUDA-event
spans around ``integrator.trace_closest``, ``lights.trace_any`` and
``lights.trace_closest`` (``harness/trace.py::trace_spans``) over the event
spans of the passes that hold them, in %."""


def read(t):
    if t.kind != "pass" or not t.pass_ms or sum(t.pass_ms) <= 0:
        return None
    return 100.0 * sum(t.trace_ms) / sum(t.pass_ms)
