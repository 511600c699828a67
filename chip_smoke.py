#!/usr/bin/env python3
"""Smoke run of tinsel_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, each fatal on failure (exit code 1):

1. the card: device name and ``nvidia-smi`` name and power limit;
2. build the CUDA kernels from ``tinsel_tpu_torch/csrc`` (nvcc, sm_90a);
3. each kernel against its plain PyTorch version on the card, at the
   shapes of the main path and a few more (K1 at 37x53, 512^2 and
   2160x3840, r = 1 and 2; K2 at 33x49, 512^2 and 2160x3840 at r = 2, and
   512^2 at r = 1 and 3), timed with CUDA events; each record names the
   staging path the kernel took ("tma" or "cp.async") and its share of
   the bound;
4. the renderer on the card against the renderer on the CPU at equal
   draws (cornell 64x64, depth 4, 1 spp);
5. the main path at full size: ``render`` of cornell 512x512 depth 4 at
   16 spp, ``resolve`` -> ``nlm_denoise`` (kernel K1) and ``render_aovs``
   -> ``nlm_guided_denoise`` (kernel K2), with the kernels' launch counts
   reset just before and read just after; then the trace/shading split of
   one render pass;
6. the BVH walks K3 (closest hit) and K4 (any hit) against their plain
   versions on the card: the 524k-triangle sphere with 65,536 parallel
   rays, envmesh's first diffuse bounce and many_mesh's instance batch
   (per-lane offsets), each captured from a render pass on the card;
7. big meshes: envmesh on the card against the CPU at equal draws, then
   the big-mesh forward path (envmesh 512x512 depth 4 at 16 spp,
   many_mesh 512x512 depth 2, instances16 512x512 depth 3) with K3/K4's
   counts reset just before and read just after;
8. the gradient step (``render_loss_and_grads``) on cornell and envmesh
   512x512 depth 4: card against CPU at equal draws at 64x64, peak
   memory, the fwd+bwd / fwd ratio at matched spp and the backward's top
   kernels; then 10 steps of the inverse-rendering trainer at 512x512.

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``. Without a GPU, or without the package
beside this file, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
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
# (h, w, r): the viewer's 4K frame at the default r = 2, and r = 1 and 3
K2_CASES = ((33, 49, 2), (512, 512, 2), (2160, 3840, 2), (512, 512, 1), (512, 512, 3))
BIG_W = BIG_H = 512
# (name, depth, spp) of the big-mesh forward path
BIG_SCENES = (("envmesh", 4, 16), ("many_mesh", 2, 4), ("instances16", 3, 4))
GRAD_TOL = 1e-3  # card vs CPU gradients at equal draws, normalized per leaf
# the walks' bound: bytes of a node row (72 f32) and a leaf block (192
# f32), rays in (o, d, tmax: 28 B), per-lane offsets (8 B); f32 operations
# of one child slab test (6 sub, 6 mul, 6 min/max, 3 max for the entry, 2
# min for the exit, 2 compares) and one triangle test (two-sided
# Moller-Trumbore: 9 sub for the edges and the origin offset, 2 cross
# products of 9, 4 dots of 5, abs, reciprocal, 3 scales, 6 compares and
# the u + v add)
NODE_BYTES, BLOCK_BYTES, RAY_BYTES, OFFSET_BYTES = 288, 768, 28, 8
SLAB_OPS, TRI_OPS = 25, 59


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


def ptxas_summary(log: str):
    """(kernel<template args>, registers, stack frame bytes, spill store
    bytes, spill load bytes) of each kernel instance in nvcc's -Xptxas -v
    output. A BVH walk's per-thread stack lives in its stack frame."""
    rows, inst, frame = [], None, (0, 0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d(nlm_[a-z]+_kernel)I((?:Li\d+E)+)E", line)
        if m:
            args = re.findall(r"Li(\d+)E", m.group(2))
            inst = f"{m.group(1)}<{','.join(args)}>"
        m = re.search(r"Compiling entry function '\w*?\d(bvh_[a-z]+_kernel)E", line)
        if m:
            inst = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = tuple(int(g) for g in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and inst is not None:
            rows.append((inst, int(m.group(1)), *frame))
            inst, frame = None, (0, 0, 0)
    return rows


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


def check_kernel(ops_nlm, name, kernel_fn, plain_fn, inputs, work, tag):
    """Run the kernel and its plain version on the same card inputs, hold
    them within KERNEL_TOL, time both; returns the result record."""
    counts = ops_nlm.launch_counts
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
        bound_by=bound_by, bound_share=bound_ms / kernel_ms,
        staging=ops_nlm.last_geometry[name].path,
        launches=counts[name] - before, library_ms=None,
    )
    emit(rec)
    if not err <= KERNEL_TOL:
        fail(f"{name} {tag}: kernel differs from the plain version by {err}")
    return rec


def kernel_phase(ops_nlm, plain, dev):
    rng = np.random.default_rng(0)
    worst = {"nlm_filter": 0.0, "nlm_guided": 0.0}
    for (h, w) in K1_SHAPES:
        img = torch.from_numpy(rng.random((h, w, 3), dtype=np.float32)).to(dev)
        for r in (1, 2):
            rec = check_kernel(
                ops_nlm, "nlm_filter",
                lambda x, r=r: ops_nlm.nlm_filter_cuda(x, 200.0, r),
                lambda x, r=r: plain.nlm_filter(x, 200.0, r),
                (img,), nlm_filter_work(h, w, r), f"{h}x{w} r={r}",
            )
            worst["nlm_filter"] = max(worst["nlm_filter"], rec["max_abs_err"])
        del img
    for (h, w, r) in K2_CASES:
        normal = rng.normal(size=(h, w, 3)).astype(np.float32)
        normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
        x = [
            rng.random((h, w, 3), dtype=np.float32), normal,
            rng.random((h, w, 3), dtype=np.float32),
            (rng.random((h, w, 1)) * 7).astype(np.float32),
        ]
        x = tuple(torch.from_numpy(a).to(dev) for a in x)
        rec = check_kernel(
            ops_nlm, "nlm_guided",
            lambda *a, r=r: ops_nlm.nlm_guided_cuda(*a, falloff=40.0, radius=r),
            lambda *a, r=r: plain.nlm_guided(*a, falloff=40.0, radius=r),
            x, nlm_guided_work(h, w, r), f"{h}x{w} r={r}",
        )
        worst["nlm_guided"] = max(worst["nlm_guided"], rec["max_abs_err"])
        del x
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
    k1 = check_kernel(
        ops_nlm, "nlm_filter", ops_nlm.nlm_filter_cuda, plain.nlm_filter, (img,),
        nlm_filter_work(h, w, 1), f"main {h}x{w} r=1",
    )
    guides = (img, aov["normal"], aov["albedo"], aov["depth"])
    k2 = check_kernel(
        ops_nlm, "nlm_guided", ops_nlm.nlm_guided_cuda, plain.nlm_guided, guides,
        nlm_guided_work(h, w, 2), f"main {h}x{w} r=2",
    )
    return k1, k2


# --------------------------------------------------------- BVH walks (K3/K4)


def bvh_work(stats, lanes: int, per_lane: bool, out_bytes: int):
    """(bytes, f32 operations) of one walk, counted from the plain walk on
    the same inputs: each node row and leaf block the walk reads, read
    once, and each lane's ray (and offsets) in and result out; 16 slab
    tests a node arrival, 16 triangle tests a block test. Also the bytes
    if every arrival and block test read its row from device memory
    (``visit_bytes``: what a walk without any cache would move)."""
    lane = lanes * (RAY_BYTES + (OFFSET_BYTES if per_lane else 0) + out_bytes)
    nbytes = (int(stats["node_rows"].sum()) * NODE_BYTES
              + int(stats["block_rows"].sum()) * BLOCK_BYTES + lane)
    visit_bytes = stats["visits"] * NODE_BYTES + stats["blocks"] * BLOCK_BYTES + lane
    ops = 16 * (stats["visits"] * SLAB_OPS + stats["blocks"] * TRI_OPS)
    return (nbytes, ops), visit_bytes


class CaptureWalks:
    """Records the arguments of every K3/K4 wrapper call made by the
    renderer while active (tensors cloned), to replay the main path's own
    inputs."""

    def __init__(self, ops_bvh):
        self.ops, self.calls = ops_bvh, {"closest_hit": [], "any_hit": []}

    def __enter__(self):
        self.orig = {k: getattr(self.ops, k) for k in self.calls}
        for k, fn in self.orig.items():
            def wrapped(*a, _k=k, _fn=fn):
                self.calls[_k].append(tuple(x.clone() if torch.is_tensor(x) else x for x in a))
                return _fn(*a)
            setattr(self.ops, k, wrapped)
        return self

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(self.ops, k, fn)


def check_walk(ops_bvh, plain_walk, name, args, tag):
    """One walk kernel against its plain version on the same card inputs
    (K3: equal t to KERNEL_TOL and no differing triangle; K4: no differing
    lane), timed; returns the record."""
    pool, noff, toff, o, d, tmax, slots = args
    kernel = ops_bvh.closest_hit_cuda if name == "bvh_closest" else ops_bvh.any_hit_cuda
    before = ops_bvh.launch_counts[name]
    out = kernel(*args)
    torch.cuda.synchronize()
    launches = ops_bvh.launch_counts[name] - before
    if launches != 1:
        fail(f"{name} {tag}: the wrapper did not count its launch")
    stats = {}
    ref = plain_walk(pool, noff, toff, o, d, tmax, stack_slots=slots, stats=stats)
    lanes = o.shape[0]
    if name == "bvh_closest":
        (t, tri), (t_ref, tri_ref) = out, ref
        mismatched = int((tri != tri_ref).sum())
        same_inf = torch.equal(torch.isfinite(t), torch.isfinite(t_ref))
        fin = torch.isfinite(t_ref)
        err = float((t - t_ref)[fin].abs().max()) if bool(fin.any()) else 0.0
        err = err if same_inf else float("inf")
        hit_share = float(fin.float().mean())
    else:
        mismatched = int((out != ref).sum())
        err = float(mismatched > 0)
        hit_share = float(ref.float().mean())
    per_lane = torch.is_tensor(noff)

    def run_plain():
        plain_walk(pool, noff, toff, o, d, tmax, stack_slots=slots)

    kernel_ms = device_ms(kernel, [args])
    kernel_call_ms = call_ms(kernel, [args])
    plain_ms = _event_ms(run_plain, 2)
    work, visit_bytes = bvh_work(stats, lanes, per_lane, 8 if name == "bvh_closest" else 1)
    bound_ms, bound_by = bound(work)
    rec = dict(
        kernel=name, shape=tag, lanes=lanes, per_lane_offsets=per_lane,
        hit_share=hit_share, mismatched=mismatched, max_abs_err=err,
        kernel_ms=kernel_ms, kernel_call_ms=kernel_call_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / kernel_ms,
        mrays_per_s=lanes / kernel_ms / 1e3, visits_per_lane=stats["visits"] / lanes,
        blocks_per_lane=stats["blocks"] / lanes,
        rows_read=[int(stats["node_rows"].sum()), int(stats["block_rows"].sum())],
        visit_traffic_ms=visit_bytes / HBM_BYTES_PER_S * 1e3, launches=launches,
        library_ms=None,
    )
    emit(rec)
    if mismatched or not err <= KERNEL_TOL:
        fail(f"{name} {tag}: kernel differs from the plain version ({mismatched} lanes, {err})")
    return rec


def sphere_workload(dev):
    """The JAX package's bench workload (bench.py:378-401): a UV sphere of
    512 x 512 x 2 = 524,288 triangles and 65,536 parallel rays from
    z = -3 on a 256 x 256 grid over [-1.2, 1.2]^2."""
    from tinsel_tpu_torch.scene.model import MESH, Primitive, Scene
    from tinsel_tpu_torch.scene.procedural import sphere

    t0 = time.perf_counter()
    m = sphere(radius=1.0, n_theta=512, n_phi=512)
    m.build()
    sc = Scene()
    sc.add_primitive(Primitive(type=MESH, mesh=m))
    flat = sc.flatten(dev)
    build_s = time.perf_counter() - t0
    h = flat.prim_static[0].mesh
    g = np.linspace(-1.2, 1.2, 256, dtype=np.float32)
    x, y = np.meshgrid(g, g)
    r = 256 * 256
    o = torch.from_numpy(np.stack([x.ravel(), y.ravel(), np.full(r, -3.0, np.float32)], -1)).to(dev)
    d = torch.tensor([[1e-5, 1e-5, 1.0]], device=dev).repeat(r, 1)
    tmax = torch.full((r,), float("inf"), device=dev)
    emit(dict(phase="sphere524k", triangles=h.real_tris, nodes=h.num_nodes,
              stack_slots=h.stack_slots, host_build_s=build_s))
    return (flat.pool, h.node_offset, h.tri_offset, o, d, tmax, h.stack_slots)


def bvh_kernel_phase(dev):
    """K3 and K4 against their plain versions on three inputs: the 524k
    sphere, envmesh's first diffuse bounce (captured from a 512x512 pass)
    and many_mesh's instance batches (captured from a 512x512 pass: the
    shortlist rounds' lanes with per-lane offsets; the NEE shadow rays)."""
    from tinsel_tpu_torch.accel import traverse as plain
    from tinsel_tpu_torch.core.sampling import GeneratorUniforms
    from tinsel_tpu_torch.ops import bvh as ops_bvh
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.render.renderer import make_render_pass
    from tinsel_tpu_torch.scene.presets import envmesh_scene, many_mesh_scene

    inputs = {"sphere524k": {"closest": sphere_workload(dev)}}
    for name, sc in (("envmesh", envmesh_scene(BIG_W, BIG_H, 4)),
                     ("many_mesh", many_mesh_scene(48, BIG_W, BIG_H, 2))):
        flat = sc.flatten(dev)
        cam = CameraParams.from_host(sc.camera, dev)
        with torch.no_grad(), CaptureWalks(ops_bvh) as cap:
            make_render_pass(sc.options)(flat, cam, GeneratorUniforms(9, dev))
        closest, anyh = cap.calls["closest_hit"], cap.calls["any_hit"]
        if name == "envmesh":  # bounce 1: the first diffuse bounce
            inputs[name] = {"closest": closest[1]}
        else:
            inputs[name] = {"closest": closest[0], "any": anyh[0]}
    recs = {"bvh_closest": [], "bvh_any": []}
    for tag, ins in inputs.items():
        for kernel in ("bvh_closest", "bvh_any"):
            # each kernel runs on the closest-hit inputs, K4 also on the
            # shadow rays where the scene has them
            args = ins["closest"] if kernel == "bvh_closest" else ins.get("any", ins["closest"])
            what = "shadow rays" if kernel == "bvh_any" and "any" in ins else "rays"
            walk = plain.intersect_mesh if kernel == "bvh_closest" else plain.intersect_mesh_any
            recs[kernel].append(check_walk(ops_bvh, walk, kernel, args, f"{tag} {what}"))
    return recs


# ---------------------------------------------------------- big meshes


def big_scenes():
    from tinsel_tpu_torch.scene.presets import envmesh_scene, instances_scene, many_mesh_scene

    makers = {
        "envmesh": lambda d: envmesh_scene(BIG_W, BIG_H, d),
        "many_mesh": lambda d: many_mesh_scene(48, BIG_W, BIG_H, d),
        "instances16": lambda d: instances_scene(BIG_W, BIG_H, d, grid=4),
    }
    return {name: makers[name](depth) for name, depth, _ in BIG_SCENES}


def bigmesh_equal_draw_phase(dev):
    """envmesh (detail 32: 2,048 triangles) on the card and on the CPU at
    equal draws, 64x64 depth 4, 1 spp."""
    from tinsel_tpu_torch.core.sampling import NumpyUniforms
    from tinsel_tpu_torch.render.renderer import render
    from tinsel_tpu_torch.scene.presets import envmesh_scene

    a, b = (
        render(envmesh_scene(64, 64, 4, detail=32), spp=1, device=d,
               source=NumpyUniforms(7, d)).cpu().numpy()
        for d in (dev, torch.device("cpu"))
    )
    if a.shape != (64, 64, 4) or not np.isfinite(a).all():
        fail("equal-draw envmesh render on the card: bad output")
    close = np.isclose(a, b, atol=RENDER_ATOL, rtol=RENDER_RTOL).all(axis=-1)
    rel = abs(a[..., :3].mean() - b[..., :3].mean()) / b[..., :3].mean()
    rec = dict(phase="gpu_vs_cpu_equal_draws", scene="envmesh detail 32 64x64 d4 1spp",
               pixels_within_tol=float(close.mean()), mean_rel_diff=float(rel),
               max_abs_diff=float(np.abs(a - b).max()))
    emit(rec)
    if close.mean() < RENDER_SHARE or not rel < RENDER_MEAN_REL:
        fail(f"card and CPU envmesh renders disagree at equal draws: {rec}")


def bigmesh_path(ops_bvh, dev):
    """The big-mesh forward path: each scene flattened (set-up), then
    accumulated pass by pass as ``render`` does, K3/K4 counts reset just
    before the path and read just after."""
    from tinsel_tpu_torch.core.color import resolve
    from tinsel_tpu_torch.core.sampling import GeneratorUniforms
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.render.renderer import make_accumulate_fn

    t0 = time.perf_counter()
    scenes = big_scenes()
    flats = {n: (sc.flatten(dev), CameraParams.from_host(sc.camera, dev))
             for n, sc in scenes.items()}
    emit(dict(phase="bigmesh_setup", host_build_and_flatten_s=time.perf_counter() - t0,
              triangles={n: sum(p.mesh.real_tris for p in f.prim_static if p.mesh)
                         for n, (f, _) in flats.items()}))
    torch.cuda.synchronize()
    ops_bvh.reset_launch_counts()
    per_scene = {}
    for name, depth, spp in BIG_SCENES:
        flat, cam = flats[name]
        before = dict(ops_bvh.launch_counts)
        spp_pass = max(1, min(spp, (1 << 20) // (BIG_W * BIG_H)))
        step = make_accumulate_fn(scenes[name].options, spp_pass)
        source = GeneratorUniforms(0, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        accum = torch.zeros((BIG_H, BIG_W, 4), device=dev)
        for c in range(spp // spp_pass):
            accum = step(accum, flat, cam, source, c)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        img = resolve(accum)
        mean = float(img.mean())
        if not torch.isfinite(accum).all() or not 0.01 < mean < 0.99:
            fail(f"big-mesh path: {name} image is not finite or is black (mean {mean})")
        n_lights = sum(flat.prim_static[j].light_samples for j in flat.light_indices)
        rays = BIG_W * BIG_H * depth * (1 + n_lights) * spp
        per_scene[name] = dict(
            depth=depth, spp=spp, render_s=secs, ms_per_spp=secs * 1e3 / spp,
            rays_per_s=rays / secs, image_mean=mean,
            launches={k: v - before[k] for k, v in ops_bvh.launch_counts.items()},
        )
    launches = dict(ops_bvh.launch_counts)
    emit(dict(phase="bigmesh_path", size=f"{BIG_W}x{BIG_H}",
              ray_count="W*H*depth*(1+shadow rays) per spp", scenes=per_scene,
              launches=launches))
    if min(launches.values()) < 1:
        fail(f"big-mesh path: a BVH kernel was never launched: {launches}")
    return launches


# ------------------------------------------------------------- gradients


def _grad_leaves(grads):
    gm, gc = grads
    return {f"{o}.{f.name}": getattr(g, f.name)
            for o, g in (("materials", gm), ("camera", gc)) for f in dataclasses.fields(g)}


def gradient_equal_draw_phase(dev):
    """render_loss_and_grads on the card and on the CPU at equal draws,
    64x64, 1 spp. At depth 1 (camera rays and NEE) every gradient leaf
    must lie within GRAD_TOL of its largest entry and the loss within
    1e-5 relative. At depth 4 the numbers are reported: there about 0.1%
    of the paths take another branch after a last-bit difference of a
    transcendental function (the forward's equal-draw check), and a leaf
    fed by a few such paths (a glossy sphere's roughness) moves by more."""
    from tinsel_tpu_torch.core.sampling import NumpyUniforms
    from tinsel_tpu_torch.diff.gradients import render_loss_and_grads
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.scene.presets import cornell_scene, envmesh_scene

    for depth in (1, 4):
        for name, sc in (("cornell", cornell_scene(64, 64, depth)),
                         ("envmesh detail 32", envmesh_scene(64, 64, depth, detail=32))):
            res = []
            for d in (dev, torch.device("cpu")):
                loss, grads = render_loss_and_grads(
                    sc.flatten(d), CameraParams.from_host(sc.camera, d), NumpyUniforms(13, d),
                    torch.full((64, 64, 3), 0.25, device=d), width=64, height=64,
                    max_depth=depth,
                )
                res.append((float(loss), {k: v.cpu() for k, v in _grad_leaves(grads).items()}))
            (la, ga), (lb, gb) = res
            # a leaf whose gradient is zero in exact arithmetic holds the
            # rounding noise of sums that cancel (envmesh at depth 1 sees
            # only the sky, a function of the ray direction: its camera-
            # position gradient is +g - g over every pixel, measured 3e-8
            # of the largest leaf); leaves under 1e-3 of the largest
            # gradient of any leaf are held against that instead
            floor = 1e-3 * max(float(g.abs().max()) for g in gb.values())
            dev_norm = {k: float((ga[k] - gb[k]).abs().max())
                        / max(float(gb[k].abs().max()), floor, 1e-30) for k in gb}
            worst = max(dev_norm, key=dev_norm.get)
            rec = dict(phase="grad_gpu_vs_cpu_equal_draws", scene=f"{name} 64x64 d{depth} 1spp",
                       fatal=depth == 1, loss_rel_diff=abs(la - lb) / abs(lb), worst_leaf=worst,
                       worst_normalized_dev=dev_norm[worst])
            emit(rec)
            if depth == 1 and (rec["loss_rel_diff"] > 1e-5 or dev_norm[worst] > GRAD_TOL):
                fail(f"card and CPU gradients disagree at equal draws: {rec}")


def gradient_phase(ops_bvh, dev):
    """The gradient step at full size on cornell and envmesh 512x512
    depth 4, 1 spp: finite loss and gradients, some nonzero; peak device
    memory; fwd+bwd / fwd at matched spp (bench.py:159-204: the same pass
    with and without its backward, CUDA events, alternating, medians);
    the backward's top kernels from the profiler. K3 counts are reset
    just before and read just after."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tinsel_tpu_torch.core.sampling import GeneratorUniforms
    from tinsel_tpu_torch.diff.gradients import render_loss, render_loss_and_grads
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.scene.presets import cornell_scene, envmesh_scene

    opts = dict(width=BIG_W, height=BIG_H, max_depth=4)
    target = torch.full((BIG_H, BIG_W, 3), 0.25, device=dev)
    for name, sc in (("cornell", cornell_scene(BIG_W, BIG_H, 4)),
                     ("envmesh", envmesh_scene(BIG_W, BIG_H, 4))):
        flat, cam = sc.flatten(dev), CameraParams.from_host(sc.camera, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops_bvh.reset_launch_counts()
        loss, grads = render_loss_and_grads(flat, cam, GeneratorUniforms(1, dev), target, **opts)
        torch.cuda.synchronize()
        launches = dict(ops_bvh.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        leaves = _grad_leaves(grads)
        if not math.isfinite(float(loss)) or not all(bool(torch.isfinite(g).all())
                                                     for g in leaves.values()):
            fail(f"gradient step on {name}: loss or gradients not finite")
        nonzero = sorted(k for k, g in leaves.items() if float(g.abs().max()) > 0)
        if not nonzero:
            fail(f"gradient step on {name}: every gradient is zero")
        if name == "envmesh" and launches["bvh_closest"] < 1:
            fail(f"gradient step on envmesh did not launch K3: {launches}")

        def fwd_bwd(i):
            render_loss_and_grads(flat, cam, GeneratorUniforms(i, dev), target, **opts)

        def fwd(i):
            with torch.no_grad():
                render_loss(flat, cam, GeneratorUniforms(i, dev), target, **opts)

        times = {"fwd_bwd": [], "fwd": []}
        for i in range(3):
            for key, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd), ("fwd_bwd", fwd_bwd), ("fwd", fwd)):
                times[key].append(_event_ms(lambda: fn(i), 1))
        med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}

        # the backward alone under the profiler
        mats = dataclasses.replace(flat.materials, **{
            f.name: getattr(flat.materials, f.name).clone().requires_grad_(True)
            for f in dataclasses.fields(flat.materials)})
        cam_l = dataclasses.replace(cam, **{
            f.name: getattr(cam, f.name).clone().requires_grad_(True)
            for f in dataclasses.fields(cam)})
        ls = render_loss(dataclasses.replace(flat, materials=mats), cam_l,
                         GeneratorUniforms(5, dev), target, **opts)
        ins = [getattr(o, f.name) for o in (mats, cam_l) for f in dataclasses.fields(o)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            torch.autograd.grad(ls, ins, allow_unused=True)
            torch.cuda.synchronize()
            bwd_wall = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        scatter_ms = sum(e.self_device_time_total for e in kernels
                         if "index" in e.key.lower() or "scatter" in e.key.lower()) / 1e3
        emit(dict(
            phase="gradient_step", scene=f"{name} {BIG_W}x{BIG_H} d4 1spp", loss=float(loss),
            nonzero_leaves=len(nonzero), max_memory_allocated_gib=peak / 2**30,
            fwd_bwd_ms=med["fwd_bwd"], fwd_ms=med["fwd"],
            fwd_bwd_over_fwd=med["fwd_bwd"] / med["fwd"],
            fwd_bwd_rays_per_s=BIG_W * BIG_H * 4 / (med["fwd_bwd"] / 1e3),
            launches=launches, backward_wall_ms=bwd_wall,
            backward_device_busy_ms=busy if busy > 0 else "not measured",
            backward_index_scatter_ms=scatter_ms,
            backward_top_kernels=[[e.key[:70], e.count, e.self_device_time_total / 1e3]
                                  for e in top],
        ))
        del flat, cam, loss, grads, leaves, ls, ins, mats, cam_l, prof


def trainer_phase(dev):
    """10 Adam steps of the inverse-rendering example at 512x512 depth 4:
    the visible-albedo error must fall."""
    from tinsel_tpu_torch.examples.inverse_rendering import main as train

    t0 = time.perf_counter()
    err0, err1 = train(steps=10, size=BIG_W, spp_target=8, seed=0, device=dev, max_depth=4)
    torch.cuda.synchronize()
    rec = dict(phase="trainer", scene=f"cornell {BIG_W}x{BIG_H} d4", steps=10,
               err0=err0, err1=err1, seconds=time.perf_counter() - t0)
    emit(rec)
    if not err1 < err0:
        fail(f"trainer: the albedo error did not fall: {rec}")



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
            if "error" in line:
                print(f"ptxas[{name}]: {line.strip()}", flush=True)
        for inst, regs, stack, spill_st, spill_ld in ptxas_summary(log):
            print(f"ptxas[{name}]: {inst}: {regs} registers, {stack} B stack frame, "
                  f"{spill_st} B spill stores, {spill_ld} B spill loads", flush=True)
    emit(dict(phase="build", seconds=build_s, sources=list(_build.SOURCES)))

    worst = kernel_phase(ops_nlm, plain, dev)
    equal_draw_phase(dev)
    img, aov, launches = main_path(ops_nlm, dev)
    k1, k2 = main_inputs_phase(ops_nlm, plain, img, aov)
    trace_split_phase(dev)
    profile_phase(dev)

    from tinsel_tpu_torch.ops import bvh as ops_bvh

    walks = bvh_kernel_phase(dev)
    bigmesh_equal_draw_phase(dev)
    launches.update(bigmesh_path(ops_bvh, dev))
    gradient_equal_draw_phase(dev)
    gradient_phase(ops_bvh, dev)
    trainer_phase(dev)

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
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            bound_share=rec["bound_share"], library_ms=None,
        ))
    # K3 at the main path's incoherent bounce rays (envmesh's first diffuse
    # bounce), K4 at its shadow rays (many_mesh's NEE); the error is the
    # worst over every input
    for key, tag, replaces in (
        ("bvh_closest", "envmesh rays",
         "tinsel_tpu/accel/traverse.py:761 intersect_mesh (_step :390)"),
        ("bvh_any", "many_mesh shadow rays",
         "tinsel_tpu/accel/traverse.py:903 intersect_mesh_any (_traverse_tile_any :811)"),
    ):
        rec = next(r for r in walks[key] if r["shape"] == tag)
        table.append(dict(
            name=key, route="cuda", source="tinsel_tpu_torch/csrc/bvh.cu",
            replaces=replaces, launches=launches[key],
            max_abs_err=max(r["max_abs_err"] for r in walks[key]),
            ms=rec["kernel_ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            bound_share=rec["bound_share"], library_ms=None,
        ))
    print(smi, flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
