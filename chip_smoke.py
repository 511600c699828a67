#!/usr/bin/env python3
"""Smoke run of tinsel_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, each fatal on failure (exit code 1):

1. the card: device name and ``nvidia-smi`` name and power limit;
2. build the CUDA kernels from ``tinsel_tpu_torch/csrc`` (nvcc, sm_90a);
3. each kernel against its plain PyTorch version on the card, at the
   shapes of the main path and a few more, timed with CUDA events;
4. the renderer on the card against the renderer on the CPU at equal
   draws (cornell 64x64, depth 4, 1 spp);
5. the main path at full size: ``render`` of cornell 512x512 depth 4 at
   16 spp, ``resolve`` -> ``nlm_denoise`` (kernel K1) and ``render_aovs``
   -> ``nlm_guided_denoise`` (kernel K2), with the kernels' launch counts
   reset just before and read just after; then the trace/shading split of
   one render pass.

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``. Without a GPU, or without the package
beside this file, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM rate and f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
L2_BYTES = 50 * 2**20
KERNEL_TOL = 1e-5  # kernel vs plain: f32 rounding of fused multiply-adds
# GPU vs CPU at equal draws, as the JAX parity test (a): per-pixel atol /
# rtol, share of pixels that must agree, relative difference of the means
RENDER_ATOL, RENDER_RTOL, RENDER_SHARE, RENDER_MEAN_REL = 1e-4, 1e-3, 0.995, 1e-3

MAIN_W = MAIN_H = 512
MAIN_DEPTH = 4
MAIN_SPP = 16
K1_SHAPES = ((37, 53), (512, 512), (2160, 3840))  # each at r = 1 and 2
K2_SHAPES = ((33, 49), (512, 512))  # at r = 2


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj):
    print(json.dumps(obj), flush=True)


def import_port():
    """The package of this checkout, never one installed elsewhere."""
    sys.path.insert(0, str(ROOT))
    try:
        import tinsel_tpu_torch
    except ImportError as e:
        fail(f"tinsel_tpu_torch is not beside chip_smoke.py: {e}")
    if Path(tinsel_tpu_torch.__file__).resolve().parent.parent != ROOT:
        fail(f"tinsel_tpu_torch imported from {tinsel_tpu_torch.__file__}")
    return tinsel_tpu_torch


def smi_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ kernel bounds


def valid_taps(h: int, w: int, r: int) -> int:
    """Number of (pixel, tap) pairs of a (2r+1)^2 window clipped to h x w."""
    sy = sum(max(h - abs(d), 0) for d in range(-r, r + 1))
    sx = sum(max(w - abs(d), 0) for d in range(-r, r + 1))
    return sy * sx


def nlm_filter_work(h: int, w: int, r: int):
    """(bytes, f32 operations) of K1: read the RGB image once, write it
    once; per in-bounds tap 3 adds of the box mean, then 3 sub + 5 for
    the squared distance, 1 mul, 1 exp, 6 for the weighted sum, 1 add;
    per pixel 3 divides for the mean, 1 max and 3 divides at the end."""
    return 24 * h * w, 20 * valid_taps(h, w, r) + 7 * h * w


def nlm_guided_work(h: int, w: int, r: int):
    """(bytes, f32 operations) of K2: read img, normal, albedo (3 planes
    each) and depth, write 3 planes; per search tap 8 for the color
    distance, 9 each for normal and albedo, 3 for depth, 2 to sum the
    guides, 2 for the exponent, 1 exp, 6 + 1 for the sums; the radius-1
    box mean 3 adds per tap; per pixel 3 mean divides, depth max and
    divide, 1 max and 3 divides at the end."""
    ops = 41 * valid_taps(h, w, r) + 3 * valid_taps(h, w, 1) + 9 * h * w
    return 52 * h * w, ops


def bound(work):
    nbytes, ops = work
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ timing


def copies(tensors, nbytes: int):
    """Enough copies of the inputs that one pass over them exceeds twice
    the L2 cache, so each timed launch reads its inputs from HBM."""
    n = max(2, min(64, math.ceil(2 * L2_BYTES / max(nbytes, 1))))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def _reps(run, budget_s: float) -> int:
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return int(min(200, max(3, budget_s / max(time.perf_counter() - t0, 1e-6))))


def _event_ms(run, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def call_ms(fn, arg_sets, budget_s: float = 0.2) -> float:
    """Time of one eager call as a caller pays it: CUDA events around a
    run of calls cycling through ``arg_sets``. Where the host takes longer
    to issue a call than the card to run it, this is the host's time."""
    state = {"i": 0}

    def run():
        fn(*arg_sets[state["i"] % len(arg_sets)])
        state["i"] += 1

    run()
    return _event_ms(run, _reps(run, budget_s))


def device_ms(fn, arg_sets, budget_s: float = 0.2) -> float:
    """Device time of one call: one call per input set captured into a
    CUDA graph, the graph replayed under CUDA events, so the host's
    dispatch is out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as graphs want
        fn(*arg_sets[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in arg_sets:
            fn(*args)
    graph.replay()
    ms = _event_ms(graph.replay, _reps(graph.replay, budget_s))
    del graph
    return ms / len(arg_sets)


# ------------------------------------------------------- kernels vs plain


def check_kernel(name, kernel_fn, plain_fn, inputs, work, tag, counts):
    """Run the kernel and its plain version on the same card inputs, hold
    them within KERNEL_TOL, time both; returns the result record."""
    before = counts[name]
    out = kernel_fn(*inputs)
    torch.cuda.synchronize()
    if counts[name] != before + 1:
        fail(f"{name} {tag}: the wrapper did not count its launch")
    ref = plain_fn(*inputs)
    if out.shape != ref.shape or not torch.isfinite(out).all():
        fail(f"{name} {tag}: bad output {tuple(out.shape)}")
    err = float((out - ref).abs().max())
    nbytes = sum(t.numel() * t.element_size() for t in inputs)
    sets = copies(inputs, nbytes)
    kernel_ms = device_ms(kernel_fn, sets)
    kernel_call_ms = call_ms(kernel_fn, sets)
    plain_ms = device_ms(plain_fn, sets)
    bound_ms, bound_by = bound(work)
    rec = dict(
        kernel=name, shape=tag, max_abs_err=err, kernel_ms=kernel_ms,
        kernel_call_ms=kernel_call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, launches=counts[name] - before, library_ms=None,
    )
    emit(rec)
    if not err <= KERNEL_TOL:
        fail(f"{name} {tag}: kernel differs from the plain version by {err}")
    return rec


def kernel_phase(ops_nlm, plain, dev):
    rng = np.random.default_rng(0)
    counts = ops_nlm.launch_counts
    worst = {"nlm_filter": 0.0, "nlm_guided": 0.0}
    for (h, w) in K1_SHAPES:
        img = torch.from_numpy(rng.random((h, w, 3), dtype=np.float32)).to(dev)
        for r in (1, 2):
            rec = check_kernel(
                "nlm_filter",
                lambda x, r=r: ops_nlm.nlm_filter_cuda(x, 200.0, r),
                lambda x, r=r: plain.nlm_filter(x, 200.0, r),
                (img,), nlm_filter_work(h, w, r), f"{h}x{w} r={r}", counts,
            )
            worst["nlm_filter"] = max(worst["nlm_filter"], rec["max_abs_err"])
        del img
    for (h, w) in K2_SHAPES:
        normal = rng.normal(size=(h, w, 3)).astype(np.float32)
        normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
        x = [
            rng.random((h, w, 3), dtype=np.float32), normal,
            rng.random((h, w, 3), dtype=np.float32),
            (rng.random((h, w, 1)) * 7).astype(np.float32),
        ]
        x = tuple(torch.from_numpy(a).to(dev) for a in x)
        rec = check_kernel(
            "nlm_guided",
            lambda *a: ops_nlm.nlm_guided_cuda(*a, falloff=40.0),
            lambda *a: plain.nlm_guided(*a, falloff=40.0),
            x, nlm_guided_work(h, w, 2), f"{h}x{w} r=2", counts,
        )
        worst["nlm_guided"] = max(worst["nlm_guided"], rec["max_abs_err"])
    return worst


# --------------------------------------------------------- render phases


def equal_draw_phase(dev):
    """The port on the card and on the CPU, fed the same uniforms."""
    from tinsel_tpu_torch.core.sampling import NumpyUniforms
    from tinsel_tpu_torch.render.renderer import render
    from tinsel_tpu_torch.scene.presets import cornell_scene

    a, b = (
        render(cornell_scene(64, 64, MAIN_DEPTH), spp=1, device=d,
               source=NumpyUniforms(7, d)).cpu().numpy()
        for d in (dev, torch.device("cpu"))
    )
    if a.shape != (64, 64, 4) or not np.isfinite(a).all():
        fail("equal-draw render on the card: bad output")
    close = np.isclose(a, b, atol=RENDER_ATOL, rtol=RENDER_RTOL).all(axis=-1)
    rel = abs(a[..., :3].mean() - b[..., :3].mean()) / b[..., :3].mean()
    rec = dict(phase="gpu_vs_cpu_equal_draws", scene="cornell 64x64 d4 1spp",
               pixels_within_tol=float(close.mean()), mean_rel_diff=float(rel),
               max_abs_diff=float(np.abs(a - b).max()))
    emit(rec)
    if close.mean() < RENDER_SHARE or not rel < RENDER_MEAN_REL:
        fail(f"card and CPU renders disagree at equal draws: {rec}")


def main_path(ops_nlm, dev):
    """The slice as a user drives it, launch counts reset just before."""
    from tinsel_tpu_torch.core.color import resolve
    from tinsel_tpu_torch.render.aov import render_aovs
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.render.renderer import render
    from tinsel_tpu_torch.scene.presets import cornell_scene

    sc = cornell_scene(MAIN_W, MAIN_H, MAIN_DEPTH)
    # warm-up at 1 spp: CUDA context, allocator and library handles
    render(sc, spp=1, seed=1, device=dev)
    torch.cuda.synchronize()

    ops_nlm.reset_launch_counts()
    t0 = time.perf_counter()
    accum = render(sc, spp=MAIN_SPP, seed=0, device=dev)
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    img = resolve(accum)
    den = ops_nlm.nlm_denoise(img)
    flat = sc.flatten(dev)
    cam = CameraParams.from_host(sc.camera, dev)
    aov = render_aovs(flat, cam, MAIN_W, MAIN_H)
    gden = ops_nlm.nlm_guided_denoise(img, aov["normal"], aov["albedo"], aov["depth"])
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    launches = dict(ops_nlm.launch_counts)

    shape3 = (MAIN_H, MAIN_W, 3)
    if tuple(accum.shape) != (MAIN_H, MAIN_W, 4) or not torch.isfinite(accum).all():
        fail("main path: the accumulation buffer is not finite")
    for name, t in (("resolve", img), ("nlm_denoise", den), ("nlm_guided_denoise", gden)):
        if tuple(t.shape) != shape3 or not torch.isfinite(t).all():
            fail(f"main path: {name} output is not a finite {shape3} image")
    mean = float(img.mean())
    if not 0.02 < mean < 0.98:
        fail(f"main path: the resolved image is black or blown out (mean {mean})")
    if min(launches.values()) < 1:
        fail(f"main path: a kernel was never launched: {launches}")

    n_lights = sum(flat.prim_static[j].light_samples for j in flat.light_indices)
    rays = MAIN_W * MAIN_H * MAIN_DEPTH * (1 + n_lights) * MAIN_SPP
    emit(dict(
        phase="main_path", scene=f"cornell {MAIN_W}x{MAIN_H} d{MAIN_DEPTH}",
        spp=MAIN_SPP, render_s=t_render, ms_per_spp=t_render * 1e3 / MAIN_SPP,
        rays_per_s=rays / t_render, ray_count="W*H*depth*(1+shadow rays) per spp",
        total_s_with_denoise=t_all, image_mean=mean,
        denoised_mean=float(den.mean()), guided_mean=float(gden.mean()),
        launches=launches,
    ))
    return img, aov, launches


def trace_split_phase(dev):
    """Device time inside trace_closest / trace_any against the whole of
    one render pass (1M rays), from CUDA events around each call. Events
    also count the device's idle gaps between those bounds."""
    from tinsel_tpu_torch.render import integrator, lights
    from tinsel_tpu_torch.render.renderer import render
    from tinsel_tpu_torch.scene.presets import cornell_scene

    spans = {"trace_closest": [], "trace_any": []}

    def timed(name, fn):
        def wrapper(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            spans[name].append((e0, e1))
            return out
        return wrapper

    orig = (integrator.trace_closest, lights.trace_any)
    integrator.trace_closest = timed("trace_closest", orig[0])
    lights.trace_any = timed("trace_any", orig[1])
    try:
        sc = cornell_scene(MAIN_W, MAIN_H, MAIN_DEPTH)
        spp = (1 << 20) // (MAIN_W * MAIN_H)  # one pass
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        render(sc, spp=spp, seed=2, device=dev)
        b.record()
        b.synchronize()
    finally:
        integrator.trace_closest, lights.trace_any = orig
    total = a.elapsed_time(b)
    rec = dict(phase="trace_split", pass_rays=spp * MAIN_W * MAIN_H, total_ms=total)
    traced = 0.0
    for name, pairs in spans.items():
        ms = sum(e0.elapsed_time(e1) for e0, e1 in pairs)
        rec[f"{name}_ms"] = ms
        rec[f"{name}_calls"] = len(pairs)
        traced += ms
    rec["shading_and_rest_ms"] = total - traced
    emit(rec)


def profile_phase(dev):
    """Kernel launches, device busy time and idle share of one render pass
    (1M rays) from torch.profiler's records of the card's kernels. The
    profiler adds host time per op, so the idle share is an upper bound;
    trace_split's total_ms is the same pass without it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tinsel_tpu_torch.render.renderer import render
    from tinsel_tpu_torch.scene.presets import cornell_scene

    sc = cornell_scene(MAIN_W, MAIN_H, MAIN_DEPTH)
    spp = (1 << 20) // (MAIN_W * MAIN_H)  # one pass
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render(sc, spp=spp, seed=3, device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    emit(dict(
        phase="profile", pass_rays=spp * MAIN_W * MAIN_H, wall_ms=wall_ms,
        device_busy_ms=busy_ms if busy_ms > 0 else "not measured",
        idle_share=1.0 - busy_ms / wall_ms if busy_ms > 0 else "not measured",
        kernel_launches=sum(e.count for e in kernels),
        top_kernels=[[e.key[:70], e.count, e.self_device_time_total / 1e3] for e in top],
    ))


def main_inputs_phase(ops_nlm, plain, img, aov):
    """Each kernel against its plain version on the main path's own
    inputs (these launches are not counted as the main path's)."""
    h, w = img.shape[:2]
    counts = ops_nlm.launch_counts
    k1 = check_kernel(
        "nlm_filter", ops_nlm.nlm_filter_cuda, plain.nlm_filter, (img,),
        nlm_filter_work(h, w, 1), f"main {h}x{w} r=1", counts,
    )
    guides = (img, aov["normal"], aov["albedo"], aov["depth"])
    k2 = check_kernel(
        "nlm_guided", ops_nlm.nlm_guided_cuda, plain.nlm_guided, guides,
        nlm_guided_work(h, w, 2), f"main {h}x{w} r=2", counts,
    )
    return k1, k2


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs on an NVIDIA GPU")
    port = import_port()
    from tinsel_tpu_torch.device import resolve_device
    from tinsel_tpu_torch.ops import _build
    from tinsel_tpu_torch.ops import nlm as ops_nlm
    from tinsel_tpu_torch.render import nlm as plain

    dev = resolve_device(None)  # cuda; turns TF32 off
    kind = torch.cuda.get_device_name(0)
    smi = smi_name_and_limit()
    emit(dict(phase="device", kind=kind, count=torch.cuda.device_count(),
              torch=torch.__version__, cuda=torch.version.cuda,
              package=str(Path(port.__file__).parent)))
    print(smi, flush=True)

    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    for name, (secs, log) in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"ptxas[{name}]: {line.strip()}", flush=True)
    emit(dict(phase="build", seconds=build_s, sources=list(_build.SOURCES)))

    worst = kernel_phase(ops_nlm, plain, dev)
    equal_draw_phase(dev)
    img, aov, launches = main_path(ops_nlm, dev)
    k1, k2 = main_inputs_phase(ops_nlm, plain, img, aov)
    trace_split_phase(dev)
    profile_phase(dev)

    table = []
    for rec, key, replaces in (
        (k1, "nlm_filter",
         "tinsel_tpu/ops/pallas/nlm.py:44 _nlm_band_kernel"),
        (k2, "nlm_guided",
         "tinsel_tpu/ops/pallas/nlm.py:199 _guided_band_kernel"),
    ):
        table.append(dict(
            name=key, route="cuda", source="tinsel_tpu_torch/csrc/nlm.cu",
            replaces=replaces, launches=launches[key],
            max_abs_err=max(worst[key], rec["max_abs_err"]),
            ms=rec["kernel_ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"], library_ms=None,
        ))
    print(smi, flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
