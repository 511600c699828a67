"""The port's host-sync counter and spans (``utils/profiling.py``) on the
card. Every test needs an NVIDIA GPU and skips without one.

This file imports neither JAX nor tinsel_tpu, so it runs where JAX is not
installed, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_tracing_cuda.py

The two render configurations of the benchmark's render cells, by their
paths through the port: ``scenes/cornell.tin`` at 256x256, 16 spp, depth 4
(every trace call is the sweep K5c / K5a and its refit), and
``presets.envmesh_scene(probe=True)`` at 256x256, 4 spp, depth 64 (a big
displaced mesh walked by K3 / K4 in the batch of at most 12 instances, and
an HDR probe: the paths of ``ajaxenv.tin``, whose assets are not shipped).
On one pass of each, ``host_syncs`` equals the synchronising operations
that ``torch.cuda.set_sync_debug_mode("warn")`` reports; and under
``torch.profiler`` the kernels that launches inside a ``trace.closest``
span enqueued start after that span's record starts, on the profiler's
clock.
"""

import dataclasses
import os
import warnings

import pytest
import torch

from tinsel_tpu_torch.core.sampling import PathUniforms
from tinsel_tpu_torch.render.camera import CameraParams
from tinsel_tpu_torch.render.renderer import make_accumulate_fn
from tinsel_tpu_torch.scene import presets
from tinsel_tpu_torch.scene.loaders.tin import load_tin
from tinsel_tpu_torch.utils import profiling

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")
SYNC_WARNING = "called a synchronizing CUDA operation"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def configuration(name: str):
    if name == "cornell":
        scene, spp = load_tin(os.path.join(SCENES, "cornell.tin")), 16
        scene.options = dataclasses.replace(scene.options, width=256, height=256)
    else:
        scene, spp = presets.envmesh_scene(256, 256, max_depth=64, probe=True), 4
    return scene, spp


def render_setup(name, dev):
    scene, spp = configuration(name)
    flat = scene.flatten(dev)
    cam = CameraParams.from_host(scene.camera, dev)
    step = make_accumulate_fn(scene.options, spp)
    accum = torch.zeros((scene.options.height, scene.options.width, 4), device=dev)
    source = PathUniforms(2147483909, dev)
    step(accum, flat, cam, source, 1 << 40)  # warm-up: builds, tables, caches
    torch.cuda.synchronize(dev)
    return lambda k: step(accum, flat, cam, source, k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "envmesh_probe"])
def test_host_syncs_equal_the_sync_debug_count(cuda, name):
    run = render_setup(name, cuda)
    before = profiling.host_syncs
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run(0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize(cuda)
    counted = profiling.host_syncs - before
    reported = sum(SYNC_WARNING in str(w.message) for w in caught)
    print(f"{name}: host_syncs {counted}, sync debug {reported}")
    assert reported > 0
    assert counted == reported


@pytest.mark.cuda
def test_kernels_launched_in_trace_closest_start_after_its_record(cuda):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run = render_setup("cornell", cuda)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            profiling.recording() as spans:
        run(0)
        torch.cuda.synchronize(cuda)
    events = list(prof.profiler.kineto_results.events())
    closest = [(e.start_ns(), e.end_ns()) for e in events if e.name() == "trace.closest"]
    assert len(closest) == sum(s.name == "trace.closest" for s in spans) == 4
    kernels = {e.correlation_id(): e for e in events if e.device_type() == DeviceType.CUDA}
    launches = [e for e in events if e.device_type() == DeviceType.CPU
                and "Launch" in e.name() and e.correlation_id() in kernels]
    checked = 0
    for a, b in closest:
        for e in launches:
            if a <= e.start_ns() <= b:
                k = kernels[e.correlation_id()]
                assert k.start_ns() >= a, (e.name(), k.name(), k.start_ns() - a)
                assert k.start_ns() >= e.start_ns(), (k.name(), k.start_ns() - e.start_ns())
                checked += 1
    assert checked >= len(closest)
    # the spans' time.time_ns() stamps against the same records: report how
    # far this host's profiler clock (a cycle counter mapped onto the Unix
    # clock) sits from time.time_ns()
    mine = sorted((s.start_ns, s.end_ns) for s in spans if s.name == "trace.closest")
    off = [(ss - a, b - se) for (a, b), (ss, se) in zip(sorted(closest), mine)]
    print("trace.closest stamps inside their records by (start, end) ns:", off)
    assert all(abs(x) < 1_000_000 for pair in off for x in pair)
