"""The port's spans and host-sync counter (``utils/profiling.py``) on passes
of a 16x16 Cornell box (``scenes/cornell.tin``) at 1 spp, depth 4, on the
CPU: off, nothing is recorded; on, the image keeps its bits, the spans nest
as the pass runs (one ``render.pass`` root, a bounce span per bounce run,
NEE and the trace calls inside them), ``host_syncs`` counts the checks and
copies the pass made, and each span's ``record_function`` record under
``torch.profiler`` sits on the span's own stamps.

This file imports neither JAX nor tinsel_tpu.
"""

import dataclasses
import json
import os
import statistics
import threading

import pytest
import torch

from tinsel_tpu_torch.core.sampling import PathUniforms
from tinsel_tpu_torch.render.camera import CameraParams
from tinsel_tpu_torch.render.renderer import make_render_pass
from tinsel_tpu_torch.scene.loaders.tin import load_tin
from tinsel_tpu_torch.utils import profiling

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")
CAMERA_COPIES = 2  # camera.py::raster_to_world_matrix's host-to-device copies, a pass


def cornell(size: int, depth: int):
    scene = load_tin(os.path.join(SCENES, "cornell.tin"))
    o = dataclasses.replace(scene.options, width=size, height=size, max_depth=depth)
    return scene.flatten("cpu"), CameraParams.from_host(scene.camera, "cpu"), make_render_pass(o, 1)


@pytest.fixture(scope="module")
def box():
    return cornell(16, 4)


def one_pass(box, seed=7):
    flat, cam, fn = box
    return fn(flat, cam, PathUniforms(seed, "cpu"))


def test_off_records_nothing(box, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span was made with recording off")

    monkeypatch.setattr(profiling, "_Span", refuse)
    assert profiling._records is None
    one_pass(box)


def test_recording_keeps_the_image_bits(box):
    off = one_pass(box)
    with profiling.recording() as spans:
        on = one_pass(box)
    assert spans
    assert torch.equal(on, off)


def _by_id(spans):
    return {s.id: s for s in spans}


def test_spans_nest_as_the_pass_runs(box):
    before = profiling.host_syncs
    with profiling.recording() as spans:
        one_pass(box)
    synced = profiling.host_syncs - before
    ids = _by_id(spans)
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["render.pass"]
    root = roots[0]
    assert all(s.root == root.id for s in spans)
    bounces = sorted((s for s in spans if s.name == "integrator.bounce"), key=lambda s: s.start_ns)
    assert [b.attrs["i"] for b in bounces] == list(range(len(bounces)))
    assert all(b.parent == root.id for b in bounces)
    assert len(bounces) == 4  # 256 paths in a closed box: some live through every bounce
    for s in spans:
        if s.name in ("trace.closest", "lights.nee"):
            assert ids[s.parent].name == "integrator.bounce"
        if s.name == "trace.any":
            assert ids[s.parent].name == "lights.nee"
        if s.parent is not None:
            p = ids[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert sum(s.name == "trace.closest" for s in spans) == len(bounces)
    assert sum(s.name == "lights.nee" for s in spans) == len(bounces)
    # a dead-bounce check after every bounce but the last the depth allows
    assert synced == min(len(bounces), 4 - 1) + CAMERA_COPIES


def test_host_syncs_count_the_checks_of_a_pass_that_ends_early():
    deep = cornell(4, 64)  # 16 paths: all leave the open box or die long before 64 bounces
    before = profiling.host_syncs
    with profiling.recording() as spans:
        one_pass(deep, seed=11)
    bounces = sum(s.name == "integrator.bounce" for s in spans)
    assert 1 <= bounces < 64
    assert profiling.host_syncs - before == bounces + CAMERA_COPIES
    # counted with recording off too
    before = profiling.host_syncs
    one_pass(deep, seed=11)
    assert profiling.host_syncs - before == bounces + CAMERA_COPIES


def test_span_records_match_the_profilers_clock(box):
    """Each span is a record_function record of its name under the profiler
    whose interval holds the span's time.time_ns() stamps (2 us allowed for
    the profiler's conversion of its cycle counter), its start and end
    within 50 us of them at the median: the stamps are on the clock that
    torch.profiler maps its records onto. A stray preemption between the
    record and the stamp can widen one gap, never turn it round."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof, profiling.recording() as spans:
        one_pass(box)
    names = {s.name for s in spans}
    events = prof.profiler.kineto_results.events()
    recs = sorted((e.start_ns(), e.end_ns(), e.name()) for e in events if e.name() in names)
    assert len(recs) == len(spans)
    lead, lag = [], []
    for name in names:
        a = [r for r in recs if r[2] == name]
        b = sorted((s.start_ns, s.end_ns, s.name) for s in spans if s.name == name)
        assert len(a) == len(b)
        for (ps, pe, _), (ss, se, _) in zip(a, b):
            assert ps - 2_000 <= ss <= se <= pe + 2_000, (name, ss - ps, pe - se)
            lead.append(ss - ps)
            lag.append(pe - se)
    assert statistics.median(lead) < 50_000 and statistics.median(lag) < 50_000, (lead, lag)


def test_profiler_trace_shows_the_spans(box, tmp_path, capsys):
    with profiling.profiler_trace(str(tmp_path / "tr")):
        one_pass(box)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    seen = {e.get("name") for e in events}
    assert {"render.pass", "integrator.bounce", "trace.closest", "lights.nee",
            "trace.any"} <= seen
    assert profiling._records is None


def test_spans_of_another_thread_are_their_own_roots():
    with profiling.recording() as spans:
        with profiling.span("outer"):
            t = threading.Thread(target=lambda: profiling.span("inner").__enter__().__exit__())
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    inner, outer = sorted(spans, key=lambda s: s.name)
    assert outer.parent is None and inner.parent is None and inner.root == inner.id


def test_nested_recordings_reach_the_outer_list():
    with profiling.recording() as outer:
        with profiling.span("a"):
            with profiling.recording() as inner:
                with profiling.span("b"):
                    pass
    assert [s.name for s in inner] == ["b"]
    assert sorted(s.name for s in outer) == ["a", "b"]
    assert _by_id(outer)[inner[0].parent].name == "a"


def test_app_spans_are_roots_with_their_work_inside(box):
    from tinsel_tpu_torch.core.color import resolve
    from tinsel_tpu_torch.io.png import encode_png
    from tinsel_tpu_torch.ops.nlm import nlm_denoise, nlm_guided_denoise
    from tinsel_tpu_torch.render.aov import render_aovs

    flat, cam, _ = box
    accum = one_pass(box)
    with profiling.recording() as spans:
        img = resolve(accum)
        aovs = render_aovs(flat, cam, 16, 16)
        img = nlm_guided_denoise(img, aovs["normal"], aovs["albedo"], aovs["depth"])
        nlm_denoise(img)
        encode_png(img.numpy())
    ids = _by_id(spans)
    roots = [s.name for s in sorted(spans, key=lambda s: s.start_ns) if s.parent is None]
    assert roots == ["app.resolve", "app.aovs", "app.denoise", "app.denoise", "app.png"]
    (closest,) = [s for s in spans if s.name == "trace.closest"]
    assert ids[closest.parent].name == "app.aovs"
