"""The spans segment (``harness/spans.py``): device-idle gaps put down to the
layer of the innermost span open at their middle, on synthetic records; and
the segment's plumbing on the CPU, where the profiler holds no device
records."""

import contextlib
import types

import pytest

from harness import spans
from harness.trace import Trace


def test_innermost_span_wins():
    recs = [(0, 100, "render.pass"), (10, 90, "integrator.bounce"), (20, 40, "trace.closest"),
            (50, 80, "lights.nee"), (60, 70, "trace.any")]
    gaps = [(25, 35), (52, 56), (62, 68), (41, 49), (91, 99), (120, 130), (5, 8)]
    idle = spans.idle_by_layer(gaps, *spans.timeline(recs))
    assert idle["trace"] == pytest.approx((10 + 6) / 1e9)
    assert idle["nee"] == pytest.approx(4 / 1e9)
    assert idle["shade"] == pytest.approx(8 / 1e9)
    assert idle["pass"] == pytest.approx((8 + 3) / 1e9)
    assert idle["none"] == pytest.approx(10 / 1e9)  # a gap under no span
    assert idle["app"] == 0.0
    assert sum(idle.values()) == pytest.approx(sum(b - a for a, b in gaps) / 1e9)


def test_app_spans_take_their_children():
    recs = [(0, 50, "app.aovs"), (10, 40, "trace.closest"), (60, 70, "app.png"),
            (100, 200, "render.pass")]
    idle = spans.idle_by_layer([(20, 30), (62, 64), (52, 58), (150, 160)], *spans.timeline(recs))
    assert idle["app"] == pytest.approx(12 / 1e9)
    assert idle["trace"] == 0.0
    assert idle["none"] == pytest.approx(6 / 1e9)
    assert idle["pass"] == pytest.approx(10 / 1e9)


def test_a_span_ending_where_the_next_starts():
    recs = [(0, 10, "trace.any"), (10, 20, "trace.closest"), (20, 30, "lights.nee")]
    times, layers = spans.timeline(recs)
    assert spans.at(times, layers, 10) == "trace"
    assert spans.at(times, layers, 20) == "nee"
    assert spans.at(times, layers, 30) == "none"
    assert spans.at(times, layers, -5) == "none"


def test_segment_on_the_cpu():
    """No device records on the CPU: the segment runs its units with the
    spans recorded, finds no idle gap, and takes the counter's delta."""
    state = types.SimpleNamespace(on=False, host_syncs=5)

    @contextlib.contextmanager
    def recording():
        state.on = True
        yield []
        state.on = False

    class Loop:
        unit, done = "pass", 0

        def sync(self):
            pass

        def iterate(self):
            assert state.on
            state.host_syncs += 3
            self.done += 1

    port = types.SimpleNamespace(profiling=state)
    state.recording = recording
    t, loop = Trace("pass"), Loop()
    spans.segment(loop, port, 2, t)
    assert loop.done == 2 and not state.on
    assert t.span_iterations == 2 and t.span_host_syncs == 6
    assert t.span_idle == dict.fromkeys(spans.LAYERS, 0.0)
    assert sum(t.span_launches.values()) == 0 and t.span_window_s > 0
