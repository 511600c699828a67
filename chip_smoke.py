#!/usr/bin/env python3
"""Smoke run of tinsel_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, each fatal on failure (exit code 1):

1. the card: device name and ``nvidia-smi`` name and power limit;
2. build the CUDA kernels from ``tinsel_tpu_torch/csrc`` (``nlm.cu``,
   ``bvh.cu`` with K3, K4, K7, K6c, K6a and K10, ``sweep.cu``; nvcc,
   sm_90a)
   and the BVH builder
   ``native/bvh_builder.cpp`` (g++), one compiler each, all at once;
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
   reset just before and read just after; the sweep kernels K5c / K5a
   counted around the render alone, one launch for each trace_closest /
   trace_any call (16 + 16), and NEE's K8 / K9 one launch each a light
   sample; then NEE's kernels (``nee_phase``): K8 and K9 against their
   plain versions on the inputs of their first calls in a pass of 1M
   paths of Cornell (the quad light through its area CDF) and of the
   probe-lit envmesh with ajaxenv's marble and a sphere light of 10
   samples (K8 on the sphere, K9's light and probe forms), K8 bit for bit
   and K9 within 1e-6 relative, each timed beside its plain version with
   its bound from the call's own bytes; a whole pass of each scene with
   the kernels against the same pass with the plain path forced, at
   equal draws, by portbench's ``px_off`` / ``rel_l1``; and the rounding
   of a pass's increment read back from an f32 accumulator after k
   passes; then the trace/shading split of one render
   pass and its profile; K5's A/B in one run, a trace_closest and a
   trace_any call of a Cornell pass (1M rays each) and one whole pass,
   through a kept copy of the torch-op sweep (``old_trace_closest``,
   ``old_trace_any``) and through K5c / K5a, in turns: device ms,
   launches, wall ms, the pass's idle share, K5's device ms from CUDA
   events around each launch (in a run of the same work after the
   profiled one) beside the profiler's record of its launches (a
   mismatch between events and the wrappers' counts fails);
   the profiler's record of a lone K5a launch, with and without a kernel
   before it in the session; then the sweep kernels K5c (closest hit)
   and K5a (occlusion) against their plain versions on captured inputs,
   every lane equal and t bit for bit: Cornell's 4 + 4 calls of one
   512x512 depth-4 pass, the first call of each of a pass of
   ``scenes/motionblur.tin`` and ``scenes/veach_mis.json``, and 1M rays
   in a scene of 2,000 spheres and 300 tiny instances whose record table
   spans several shared-memory chunks; each timed by CUDA-graph replays,
   with its share of the bound (``sweep_work``), the share that a kernel
   without fused multiply-adds can reach at most, and its launch
   geometry;
6. the BVH walks K3 (closest hit) and K4 (any hit) against their plain
   versions on the card: the 524k-triangle sphere with 65,536 parallel
   rays, envmesh's first diffuse bounce (captured from a render pass on
   the card) and many_mesh's instance batch (per-lane offsets: the first
   round of the plain shortlist rounds from the world rays, run on the
   card on the first rounds call of each form of a render pass, whose own
   rounds are K6);
   each record names its launch geometry and its share of the bound; the
   seam count (``seam_count``) on the 524k sphere's rays and envmesh's
   camera and first-bounce rays: the lanes where K3 hits under the
   sweep's best t and the refit drops the hit (none may), beside those
   that ``intersect_ray_tri``'s formula would drop;
7. big meshes: envmesh on the card against the CPU at equal draws, then
   the big-mesh forward path (envmesh 512x512 depth 4 at 16 spp,
   many_mesh 512x512 depth 2, instances16 512x512 depth 3) with K3/K4's
   and K6c/K6a's counts reset just before and read just after: envmesh
   K3 (it has no light) and no K6; many_mesh and instances16 (above
   INSTANCE_TOPK_MIN big instances) one K6 launch a rounds call and no
   K3/K4, and every K6 launch of one more pass of each held against the
   plain rounds from the same world rays (``accel/instances.py::
   rounds_closest_world`` / ``rounds_any_world``), t bit for bit; then one
   pass of each
   under the profiler:
   the walks' (bvh_*: K3, K4, K6) device time inside the pass;
8. the gradient step (``render_loss_and_grads``) on cornell and envmesh
   512x512 depth 4: card against CPU at equal draws at 64x64, peak
   memory, the fwd+bwd / fwd ratio at matched spp and the backward's top
   kernels, each for the package's material gather (one-hot backward) and
   for the advanced-indexing gather it replaced (a copy kept here), in
   turns; then 10 steps of the inverse-rendering trainer at 512x512;
9. the rest of the integrator: K7 (the walk's step count) against its
   plain version on envmesh's 512x512 camera rays (captured from a
   complexity pass), envmesh's first bounce and the 524k sphere, exactly,
   beside K3 on the same rays; K4 on envmesh's probe shadow rays
   (tmax = +inf); card against CPU at equal draws at 64x64 (the probe-lit
   envmesh, Cornell with power light sampling and Russian roulette, the
   stratified and blue-noise samplers, the normals and complexity views,
   adaptive rounds); the full-width path: ``envmesh_scene(512, 512, 4,
   probe=True)`` at 16 spp -> ``resolve`` -> ``nlm_denoise`` with K3/K4/K1
   counts reset just before and read just after, the same scene's
   complexity view (K7's count) and ``adaptive_render`` at a 16-spp
   budget; then one profiled pass of the probe scene;
10. K6, the shortlist rounds (``trace_ops_phase``): one 512x512 4-spp
    pass of many_mesh, instances16 and the 81-instance grid
    (``instances_scene(..., grid=9)``) through ``make_render_pass``, its
    ms and its launches (one K6c / K6a launch a rounds call, no K3/K4);
    every K6 launch of one more pass held against the plain rounds from
    the same world rays (``accel/instances.py``: the local rays and box
    entries, then torch ops around K3/K4),
    every lane equal, t bit for bit; on the first call of each form, K6's
    device ms (CUDA-graph replays) and the plain version's ms in turns,
    each one's launches and device ms under the profiler, K6's eager call
    ms and its bound (``rounds_work``: the world rays in and the results
    out, the instance table, the box tests and the plain rounds' own
    walks); many_mesh's whole bounce-0 trace_closest and trace_any calls
    under the profiler, with the memory each allocates at its peak; then
    K10, the frames of the batch of at most INSTANCE_TOPK_MIN big
    instances (``frames_phase``): the first call of each form (closest
    hit; any hit) of a 512x512 4-spp pass of the probe-lit envmesh (one
    instance) and of ``many_mesh_scene(18)`` (12 big instances), each
    against the plain version on the same inputs, every output bit for
    bit, timed by CUDA events behind a spin kernel against its byte bound
    (``frames_bytes``) beside the plain version's ms. On every path of
    1 to 12 big instances (phases 7, 9, 11 and 12) one K10 launch comes
    ahead of each K3 / K4 launch (``frames_per_walk``), and none where
    K6 walks;
11. scene files: every scene file of the repository that needs no asset
    from outside it, loaded through the port (``load_tin`` /
    ``load_tungsten``, mesh cache cold), flattened on the card and
    rendered at its own width, height and maxDepth at 4 spp, K3/K4 and
    K6 counts reset just before the renders and read just after (no file
    has more than INSTANCE_TOPK_MIN big meshes: no K6 launch); then
    ``veach_mis.json`` on the card against the CPU at equal draws;
12. ``scenes/ajaxenv.tin`` at real size with stand-ins for its two
    assets, written here: a binary PLY of the Perlin sphere at 267,912
    triangles (the scan it replaces has 268k) and a 1024x512 Radiance
    ``.hdr`` with RLE scanlines; cold import split into its steps (PLY
    parse, normalize, normals and CDF, native SAH build, wide collapse,
    cache write), warm import from the cache (flattened scenes equal),
    ``load_probe``, flatten; the 500x500 render at maxDepth 64, 4 spp,
    with K3/K4 counts reset just before and read just after; one profiled
    pass; the seam count on its camera and first-bounce rays; the card
    against the CPU at equal draws at 32x32;
13. the entry points, each run with the kernels' launch counts reset just
    before and read just after, timed up to a device sync: the CLI in
    process (``app.cli``) on ``scenes/cornell.tin`` at its own 256x256,
    depth 4, 64 spp with ``-denoise -aov`` (K1 and no K2; the PNG read
    back; each AOV PFM equal to ``render_aovs``; the CLI's own ms/spp
    beside a library ``render`` of the same scene, loaded beforehand, and
    spp), then ``-denoise-guided`` (K2); resume: 32 spp with a checkpoint
    every 16 against 16 spp then ``-resume`` to 32 (the buffers bit for
    bit, no guard event); ``scenes/veach_mis.json`` at 1280x720, depth 6,
    4 spp (K3, K4; a checkpoint write of its buffer timed apart) and its
    ``-mode complexity`` (K7); phase 12's ajaxenv stand-in at 500x500,
    maxDepth 64, 4 spp with ``-denoise-guided`` (K3, K4, K2). Each run's
    K1 and K2 outputs are held against the plain filters on the run's own
    inputs within KERNEL_TOL, and the AOVs it gave K2 against
    ``render_aovs``; K7's steps against the plain count on the run's own
    rays, lane by lane; no run launches K6. Then the chunk guard on the card (a NaN on the
    first attempt of pass 1: one rollback, a finite, reseeded buffer);
    ``python -m tinsel_tpu_torch`` in a subprocess; the HTTP viewer on a
    512x512 Cornell box in a thread (page, frame, status; denoise off,
    "nlm" (K1) and "guided" (K2), each with its ms per spp and frames per
    second; a fly-camera move restarts the accumulation);
14. multi-GPU (``parallel/sharding.py``, ``parallel/pipeline.py``) on the
    one card, each rank a process of this script (``--multi-gpu-rank``)
    on ``cuda:0``, every job under a deadline: the unsharded references
    first (the sum of 2 passes of Cornell and of ``envmesh_scene(512,
    512, 4, probe=True)``, the loss and gradients of Cornell over those
    passes, ``path_trace`` of the 512x512 pixel centres and of its four
    quarters under ``Prefixed(source, m)``); then a world-1 NCCL rank
    (one all-reduce of the 512x512 RGBA f32 buffer timed; the sharded
    Cornell render); two gloo ranks (the all-reduce; the sharded render of
    Cornell and of the probe-lit envmesh on meshes (rays 2, spp 1) and
    (1, 2), K3/K4 and K6 counts reset just before and read just after (no
    K6: neither scene is above INSTANCE_TOPK_MIN), and each K3/K4 call of
    a rank held against the plain walk on its own inputs;
    the sharded train step on (2, 1) with its ms and peak memory); four
    gloo stage ranks running the pipeline at ``n_micro`` 1 and 4. Images
    within rtol 2e-5 / atol 2e-6 of the unsharded sum, equal on every
    rank; the loss within rtol 1e-4 and the gradients within rtol 2e-3 /
    atol 2e-5; the pipeline within atol 1e-5 of ``path_trace``;
15. the JAX package's module switches, each flipped on the port's module
    and back in a ``finally`` (``switched``): ``STATIC_TRANSFORM_HOIST``
    off (``hoist_off_part``: K5c / K5a against plain on a Cornell 512x512
    depth-4 pass and on motionblur.tin with every record moving, t bit for
    bit, the table's size beside the hoisted one, the refit's t equal to
    the sweep's, the card against the CPU, end_p gradients);
    ``NEE_CLOSEST_SHADOW`` on (``closest_shadow_part``: the Cornell main
    path with its launch counts checked against those the code implies,
    its ms per spp beside the switch off, many_mesh's shadow rays through
    K6c (4 launches a pass, each against the plain rounds), the card
    against the CPU on "all" and "power"); ``MESH_VERTEX_GRADS`` on (``vertex_grads_part``:
    card against CPU gradients of the vertex planes, the 512x512 gradient
    step on Cornell and envmesh against the switch off, the vertex
    backward's share and its candidate backwards on the step's own
    gathers); and the gradient of the probe's texels (``probe_texels_part``:
    the probe-lit envmesh's step with and without ``ProbeFlat.data`` as a
    leaf, profiled).

The 524k sphere's tree (phase 6) comes from the native builder.

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``. Without a GPU, or without the package
beside this file, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
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
# the sweep's f32 operations a test (csrc/sweep.cu, counted from its
# expressions): a sphere test and its merge (q, two dots, the
# discriminant, the root, both roots ordered and picked, the compares:
# 37), its centre and scale lerped at the ray's time (12); a plane test
# and its merge (two dots, the division, the compares: 21); an instance's
# local ray (two inverse rotations: 75) and root-box test (40), its
# transform interpolated (37); the winning triangle again by
# intersect_ray_tri's formula (66)
SPHERE_OPS, MOTION_SPHERE_OPS, PLANE_OPS = 37, 12, 21
INSTANCE_OPS, MOTION_INSTANCE_OPS, REFIT_OPS = 115, 37, 66
SCENE_FILE_SPP = 4
# scene files whose meshes or probe lie outside the repository
EXTERNAL_ASSET_SCENES = ("ajax", "ajaxenv", "sportscar", "table")
AJAXENV_DETAIL = 366  # 2 * 366^2 = 267,912 triangles: the scan has 268k
PROBE_W, PROBE_H = 1024, 512
ENTRY_SPP = 64  # phase 13: the CLI on scenes/cornell.tin
VIEWER_W = VIEWER_H = 512
VIEWER_WINDOW_S = 2.0  # each denoise setting of the viewer is measured this long
VIEWER_DEADLINE_S = 60.0


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase or kernel record also gets ``t_s``, the
    seconds since the script started."""
    if "phase" in obj or "kernel" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
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
    output. A local-memory array (such as a per-thread stack) shows as a
    stack frame."""
    rows, inst, frame = [], None, (0, 0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d(nlm_[a-z]+_kernel)I((?:Li\d+E)+)E", line)
        if m:
            args = re.findall(r"Li(\d+)E", m.group(2))
            inst = f"{m.group(1)}<{','.join(args)}>"
        m = re.search(r"Compiling entry function '\w*?\d((?:bvh|sweep)_[a-z_]+?_kernel)"
                      r"(?:ILb([01])EE|ILi(\d+)EE)?E", line)
        if m:  # a sweep kernel's template argument (its records move) or K6's
            # (the entries a lane keeps in registers)
            inst = m.group(1) + ({"0": "<static>", "1": "<motion>"}.get(m.group(2), "")
                                 + (f"<kept {m.group(3)}>" if m.group(3) else ""))
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


def unfused_ceiling(work) -> float:
    """The largest share of ``bound`` that a kernel built with -fmad=false
    can reach: FP32_OPS_PER_S counts a fused multiply-add as two
    operations, and without contraction each operation is an instruction
    of its own, so operations take at least twice their bound."""
    nbytes, ops = work
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) / max(t_bytes, 2 * t_ops)


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

    from tinsel_tpu_torch.ops import nee as ops_nee
    from tinsel_tpu_torch.ops import sweep as ops_sweep
    from tinsel_tpu_torch.render import integrator, lights

    sc = cornell_scene(MAIN_W, MAIN_H, MAIN_DEPTH)
    # warm-up at 1 spp: CUDA context, allocator and library handles
    render(sc, spp=1, seed=1, device=dev)
    torch.cuda.synchronize()

    # the render's trace calls, counted beside the sweep kernels' launches
    traced = {"trace_closest": 0, "trace_any": 0}
    orig = (integrator.trace_closest, lights.trace_any)

    def counted(name, fn):
        def wrapper(*a, **k):
            traced[name] += 1
            return fn(*a, **k)
        return wrapper

    integrator.trace_closest = counted("trace_closest", orig[0])
    lights.trace_any = counted("trace_any", orig[1])
    try:
        ops_nlm.reset_launch_counts()
        ops_sweep.reset_launch_counts()
        ops_nee.reset_launch_counts()
        t0 = time.perf_counter()
        accum = render(sc, spp=MAIN_SPP, seed=0, device=dev)
        torch.cuda.synchronize()
        t_render = time.perf_counter() - t0
        sweeps = dict(ops_sweep.launch_counts)
        nees = dict(ops_nee.launch_counts)
    finally:
        integrator.trace_closest, lights.trace_any = orig
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
    if (sweeps["sweep_closest"] != traced["trace_closest"] or sweeps["sweep_any"]
            != traced["trace_any"] or min(sweeps.values()) < 1):
        fail(f"main path: sweep launches {sweeps} for trace calls {traced}")
    # no probe: each of NEE's trace_any calls is one light sample's
    if not nees["nee_light"] == nees["nee_shade"] == traced["trace_any"]:
        fail(f"main path: NEE launches {nees} for {traced['trace_any']} light samples")
    launches.update(sweeps)
    launches.update(nees)

    n_lights = sum(flat.prim_static[j].light_samples for j in flat.light_indices)
    rays = MAIN_W * MAIN_H * MAIN_DEPTH * (1 + n_lights) * MAIN_SPP
    emit(dict(
        phase="main_path", scene=f"cornell {MAIN_W}x{MAIN_H} d{MAIN_DEPTH}",
        spp=MAIN_SPP, render_s=t_render, ms_per_spp=t_render * 1e3 / MAIN_SPP,
        rays_per_s=rays / t_render, ray_count="W*H*depth*(1+shadow rays) per spp",
        total_s_with_denoise=t_all, image_mean=mean,
        denoised_mean=float(den.mean()), guided_mean=float(gden.mean()),
        launches=launches, trace_calls=traced,
    ))
    return img, aov, launches


# ------------------------------------------------------------- NEE: K8, K9

NEE_TOL = dict(rtol=1e-6, atol=1e-12)  # K9 against shade_plain, per value
READBACK_PASSES = (1, 100, 300, 600, 1000)


def nee_envmesh_scene():
    """``probe_scene()`` with ajaxenv's NEE: its mesh a marble (subsurface,
    transmission 0.3 at eta 1.5, clearcoat) under a sphere light of 10
    samples, beside the probe's sample."""
    from tinsel_tpu_torch.scene import model

    sc = probe_scene()
    sc.primitives[0].material = model.Material(
        color=np.array([0.8, 0.75, 0.7], np.float32), roughness=0.2, specular=0.5,
        subsurface=0.8, transmission=0.3, eta=1.5, clearcoat=0.5, clearcoat_gloss=0.7)
    sc.add_primitive(model.Primitive(
        type=model.SPHERE, radius=0.3,
        start_transform=model.HostTransform(p=np.array([1.2, 2.4, 1.0], np.float32)),
        material=model.Material(color=np.zeros(3, np.float32),
                                emission=np.array([30.0, 28.0, 24.0], np.float32)),
        light_samples=10))
    return sc


def capture_nee(run):
    """Run ``run()`` keeping the first call of each NEE kernel form ("K8",
    "K9 light", "K9 probe"), tensor arguments cloned: {form: (args,
    kwargs)}."""
    from tinsel_tpu_torch.ops import nee

    kept = {}
    orig = nee.light_sample, nee.shade

    def keep(form, fn):
        def wrapped(*a, **k):
            if form(k) not in kept:
                kept[form(k)] = (tuple(x.clone() if torch.is_tensor(x) else x for x in a), k)
            return fn(*a, **k)
        return wrapped

    nee.light_sample = keep(lambda k: "K8", orig[0])
    nee.shade = keep(lambda k: "K9 probe" if k.get("probe") else "K9 light", orig[1])
    try:
        run()
    finally:
        nee.light_sample, nee.shade = orig
    return kept


def nee_bytes(form, args, kwargs) -> int:
    """Device-memory bytes of one K8 / K9 launch on these inputs: what the
    kernel reads a lane (a one-row transform or emission stays in cache)
    and writes; K9 reads and writes its accumulator."""
    def lanes(*ts):
        r = args[3].shape[0]
        return sum(t.numel() * t.element_size() for t in ts
                   if torch.is_tensor(t) and t.dim() >= 1 and t.shape[0] == r)

    if form == "K8":
        scene, j, tr, p, n, times, uni = args[:7]
        return lanes(p, n, *uni, tr.p, tr.q, tr.s) + 9 * 4 * p.shape[0]  # 36 B out
    mat, eta_i, eta_o, n, wo, wi, vis, _, light_t, area_nl, emission = args[:11]
    fields = [getattr(mat, k) for k in ("color", "specular", "specular_tint", "metallic",
                                        "roughness", "subsurface", "transmission",
                                        "clearcoat", "clearcoat_gloss")]
    return lanes(*fields, eta_i, eta_o, n, wo, wi, vis, light_t, area_nl, emission,
                 kwargs.get("pmf")) + 2 * lanes(args[-1])


def check_nee(form, scene_tag, args, kwargs) -> dict:
    """One captured K8 / K9 call against its plain version on the card:
    K8 every output bit for bit, K9 within NEE_TOL; device ms of each
    (``device_ms``), the bound from ``nee_bytes``."""
    from tinsel_tpu_torch.ops import nee

    if form == "K8":
        name = "nee_light"
        kern = lambda: nee.light_sample(*args, **kwargs)  # noqa: E731
        plain = lambda: nee.light_sample_plain(*args, **kwargs)  # noqa: E731
    else:
        name = "nee_shade"
        *head, out = args
        acc = out.clone()
        kern = lambda: nee.shade(*head, acc, **kwargs)  # noqa: E731
        plain = lambda: out + nee.shade_plain(*head, **kwargs)  # noqa: E731
    with torch.no_grad():
        before = nee.launch_counts[name]
        if form == "K8":
            got, want = kern(), plain()
            pairs = list(zip(got, want))
        else:
            got, want = nee.shade(*head, out.clone(), **kwargs), plain()
            pairs = [(got, want)]
        torch.cuda.synchronize()
        if nee.launch_counts[name] != before + 1:
            fail(f"{name} {scene_tag}: the wrapper did not count its launch")
        mismatched, off, err, bit_equal = 0, 0, 0.0, 0
        for g, w in pairs:
            same = (g == w) | (torch.isnan(g) & torch.isnan(w))
            mismatched += int((~same).sum())
            bad = ~((g - w).abs() <= NEE_TOL["atol"] + NEE_TOL["rtol"] * w.abs()) & ~same
            off += int(bad.sum())
            err = max(err, float(torch.where(same, 0.0, (g - w).abs()).max()))
        if form != "K8":
            bit_equal = float((got == want).all(dim=-1).float().mean())
        kernel_ms = device_ms(lambda: kern(), [()])
        plain_ms = device_ms(lambda: plain(), [()])
    nbytes = nee_bytes(form, args, kwargs)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    rec = dict(kernel=name, form=form, shape=f"{scene_tag}, {args[3].shape[0]} lanes",
               mismatched=mismatched, off_tolerance=off, max_abs_err=err,
               lanes_bit_equal=bit_equal if form != "K8" else None, kernel_ms=kernel_ms,
               plain_ms=plain_ms, bytes_per_lane=nbytes / args[3].shape[0], bound_ms=bound_ms,
               bound_by="bytes", bound_share=bound_ms / kernel_ms, launches=1, library_ms=None)
    emit(rec)
    if form == "K8" and mismatched:
        fail(f"K8 {scene_tag}: {mismatched} values differ from the plain version")
    if off:
        fail(f"K9 {scene_tag}: {off} values off the plain version by more than {NEE_TOL}")
    return rec


def pass_numbers(p, r) -> dict:
    """portbench's ``px_off`` and ``rel_l1`` of ``p`` against ``r``, and
    the share of values equal bit for bit."""
    p, r = p.double(), r.double()
    d = (p - r).abs()
    return dict(px_off=float((~(d <= 1e-4 + 1e-3 * r.abs())).double().mean()),
                rel_l1=float(d.sum() / r.abs().sum().clamp_min(1e-300)),
                bit_equal=float((p == r).double().mean()))


def nee_phase(dev) -> dict:
    """K8 / K9 on the main path's inputs (one pass of 1M paths of each
    scene), a whole pass with the kernels against the plain path forced,
    and the f32 read-back of a pass's increment. Returns {form: [record]}."""
    from tinsel_tpu_torch.ops import nee
    from tinsel_tpu_torch.render.renderer import render
    from tinsel_tpu_torch.scene.presets import cornell_scene

    scenes = (("cornell", cornell_scene(MAIN_W, MAIN_H, MAIN_DEPTH)),
              ("envmesh marble + sphere light", nee_envmesh_scene()))
    spp = spp_per_pass(4, MAIN_W, MAIN_H)
    recs = {"K8": [], "K9 light": [], "K9 probe": []}
    for tag, sc in scenes:
        seed = 2147483911
        kept = capture_nee(lambda: render(sc, spp=spp, seed=seed, device=dev))
        for form, (args, kwargs) in kept.items():
            recs[form].append(check_nee(form, tag, args, kwargs))
        del kept
        fused = render(sc, spp=spp, seed=seed, device=dev)
        orig = nee.fuses
        nee.fuses = lambda p: False
        try:
            nee.reset_launch_counts()
            plain = render(sc, spp=spp, seed=seed, device=dev)
            if sum(nee.launch_counts.values()):
                fail(f"NEE pass {tag}: the plain path launched {nee.launch_counts}")
        finally:
            nee.fuses = orig
        torch.cuda.synchronize()
        rec = dict(phase="nee_pass", scene=f"{tag} {MAIN_W}x{MAIN_H} d{sc.options.max_depth}",
                   spp=spp, seed=seed, **pass_numbers(fused, plain))
        if tag == "cornell":
            # a pass's increment as the benchmark reads it back: the f32
            # accumulator after k passes (k times this one) plus the pass,
            # less the accumulator
            readback = {}
            for k in READBACK_PASSES:
                base = fused * float(k)
                readback[k] = pass_numbers((base + fused).double() - base.double(),
                                           fused)["rel_l1"]
            rec["readback_rel_l1_after_k_passes"] = readback
        emit(rec)
        if rec["px_off"] > 0.0 or not rec["rel_l1"] < 1e-5:
            fail(f"NEE pass {tag}: the kernels' pass is off the plain path's: {rec}")
    return recs


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


# ------------------------------------------------------ the sweep (K5c/K5a)

SWEEP_STRESS_RAYS = 1 << 20


def sweep_stress_scene(seed: int = 5):
    """2,000 spheres (a quarter moving) and 300 instances of three tiny
    meshes (a quad, a tetrahedron, a cube; a third moving) in a 20-unit
    box between two planes: a record table of three shared-memory chunks
    (tests/test_torch_sweep_cuda.py::synthetic_scene builds the same)."""
    from tinsel_tpu_torch.scene import model as m

    rng = np.random.default_rng(seed)
    sc = m.Scene()
    mat = m.Material(color=np.full(3, 0.5, np.float32))
    ident = np.array([0, 0, 0, 1.0])

    def tr(p, q, s):
        return m.HostTransform(p=p.astype(np.float32), q=q.astype(np.float32), s=float(s))

    for k in range(2000):
        p = rng.uniform(-10, 10, 3)
        end = tr(p + rng.normal(size=3) * 0.3, ident, 1.0) if k % 4 == 0 else None
        sc.add_primitive(m.Primitive(type=m.SPHERE, radius=float(rng.uniform(0.05, 0.3)),
                                     start_transform=tr(p, ident, 1.0), end_transform=end,
                                     material=mat))
    for y in (-12.0, 12.0):
        sc.add_primitive(m.Primitive(type=m.PLANE, material=mat,
                                     plane=np.array([0, 1, 0, -y], np.float32)))
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float32)
    meshes = [
        m.Mesh(np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], np.float32),
               np.array([[0, 1, 2], [0, 2, 3]], np.int32)),
        m.Mesh(np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]], np.float32),
               np.array([[0, 1, 2], [0, 3, 1], [0, 2, 3], [1, 3, 2]], np.int32)),
        m.Mesh(corners, np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                                  [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                                  [1, 5, 7], [1, 7, 3]], np.int32)),
    ]
    for k in range(300):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        start = tr(rng.uniform(-10, 10, 3), q, rng.uniform(0.3, 1.2))
        end = None
        if k % 3 == 0:
            q2 = q + rng.normal(size=4) * 0.3
            end = tr(start.p + rng.normal(size=3) * 0.5, q2 / np.linalg.norm(q2),
                     start.s * rng.uniform(0.8, 1.25))
        sc.add_primitive(m.Primitive(type=m.MESH, mesh=meshes[k % 3], material=mat,
                                     start_transform=start, end_transform=end))
    return sc


def check_sweep(ops_sweep, name, flat, args, tag, hoist: bool = True):
    """K5c or K5a against its plain version on the same card inputs: the
    winners (prim, tri) or the occlusion bit equal on every lane and t
    equal bit for bit; timed by CUDA-graph replays; returns the record.
    ``hoist``: the setting of ``render/trace.py::STATIC_TRANSFORM_HOIST``
    the table is packed for."""
    from tinsel_tpu_torch.accel import sweep as plain

    closest = name == "sweep_closest"
    kernel = ops_sweep.sweep_closest_cuda if closest else ops_sweep.sweep_any_cuda
    plain_fn = plain.sweep_closest if closest else plain.sweep_any
    before = ops_sweep.launch_counts[name]
    out = kernel(flat, *args, hoist=hoist)
    torch.cuda.synchronize()
    if ops_sweep.launch_counts[name] != before + 1:
        fail(f"{name} {tag}: the wrapper did not count its launch")
    stats = {}
    ref = plain_fn(flat, *args, stats=stats, hoist=hoist)
    rays = args[0].shape[0]
    if closest:
        (t, prim, tri), (t_ref, prim_ref, tri_ref) = out, ref
        mismatched = int(((prim != prim_ref) | (tri != tri_ref)).sum())
        t_bits = int((t.view(torch.int32) != t_ref.view(torch.int32)).sum())
        fin = torch.isfinite(t_ref) & torch.isfinite(t)
        err = float((t - t_ref)[fin].abs().max()) if bool(fin.any()) else 0.0
        hit_share = float((prim_ref >= 0).float().mean())
    else:
        mismatched = int((out != ref).sum())
        t_bits, err = 0, float(mismatched > 0)
        hit_share = float(ref.float().mean())
    sets = copies(args, sum(a.numel() * a.element_size() for a in args))

    def run(*a):
        return kernel(flat, *a, hoist=hoist)

    kernel_ms = device_ms(run, sets)
    kernel_call_ms = call_ms(run, sets)
    plain_ms = _event_ms(lambda: plain_fn(flat, *args, hoist=hoist), 1)
    work = sweep_work(flat, stats, closest, hoist)
    bound_ms, bound_by = bound(work)
    tab = ops_sweep.table(flat, args[0].device, hoist)
    tile, grid = ops_sweep.launch_geometry(name, tab, rays)
    rec = dict(
        kernel=name, shape=tag, rays=rays, hit_share=hit_share, mismatched=mismatched,
        t_bits_differing=t_bits, max_abs_err=err, kernel_ms=kernel_ms,
        kernel_call_ms=kernel_call_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        bound_share=bound_ms / kernel_ms, unfused_ceiling=unfused_ceiling(work),
        mrays_per_s=rays / kernel_ms / 1e3,
        tests_per_ray={k: v / rays for k, v in stats.items() if k != "rays"},
        table_floats=int(tab.table.numel()), chunks=tab.n_chunks,
        smem_bytes=4 * tab.smem_floats * (2 if tab.n_chunks > 1 else 1), tile_rays=tile,
        grid=grid, launches=1, library_ms=None,
    )
    emit(rec)
    if mismatched or t_bits:
        fail(f"{name} {tag}: kernel differs from the plain version "
             f"({mismatched} lanes, {t_bits} t bit patterns)")
    return rec


def sweep_args(args, closest: bool):
    """A dispatcher call's (scene, o, d, times[, tmax]) as the kernels take
    them: (scene, (o, d, times[, tmax]) contiguous f32 on the card)."""
    from tinsel_tpu_torch.ops import sweep as ops_sweep

    flat, o, d, times, *rest = args
    o, d, times = ops_sweep._rays(o, d, times)
    if closest:
        return flat, (o, d, times)
    tmax = torch.broadcast_to(rest[0].to(torch.float32), (o.shape[0],)).contiguous()
    return flat, (o, d, times, tmax)


def seam_count(flat, calls, tag):
    """The big-mesh batch at a seam: on each trace_closest call's rays
    ((scene, o, d, times) as captured), the lanes where K3's walk finds a
    triangle under the sweep's best t and the refit then drops it (the
    port's refit, the walk's own formula: none, or the run fails), beside
    the lanes that the JAX package's refit formula, intersect_ray_tri,
    would drop on the same winners."""
    from tinsel_tpu_torch.accel.sweep import layout
    from tinsel_tpu_torch.geometry.intersect import intersect_ray_tri
    from tinsel_tpu_torch.ops import sweep as ops_sweep
    from tinsel_tpu_torch.render import trace

    lay = layout(flat.prim_static)
    orig, seen = trace.tri_refit, {}

    def both(va, vb, vc, o, d):
        out = orig(va, vb, vc, o, d)
        seen["t_jax_formula"] = intersect_ray_tri(
            *(torch.stack(x, -1) for x in (va, vb, vc, o, d)))[1]
        return out

    recs = []
    trace.tri_refit = both
    try:
        for (_, o, d, times), _ in calls:
            with torch.no_grad():
                _, prim, tri = ops_sweep.sweep_closest(flat, o, d, times)
                best_t, _ = trace._refit(flat, lay, o, d, times, prim, tri)
                big = trace._big_closest(flat, lay, o, d, times, best_t)
            t_j = seen["t_jax_formula"]
            kept_j = big.hit & (t_j > 0.0) & (t_j < best_t)
            recs.append(dict(rays=int(o.shape[0]), walk_hits=int(big.hit.sum()),
                             dropped=int((big.hit & ~big.closer).sum()),
                             dropped_by_intersect_ray_tri=int((big.hit & ~kept_j).sum())))
    finally:
        trace.tri_refit = orig
    emit(dict(phase="seam_count", scene=tag, calls=recs))
    if any(r["dropped"] for r in recs):
        fail(f"seam count {tag}: the refit dropped lanes the walk hit: {recs}")
    return recs


def sweep_kernel_phase(dev):
    """Phase 3b: K5c and K5a against their plain versions on captured
    inputs: Cornell's 4 + 4 calls of one 512x512 depth-4 pass (4 spp, 1M
    rays a call), the first call of each kind of one 1-spp pass of
    scenes/motionblur.tin and scenes/veach_mis.json at their own sizes,
    and 1M random rays in the 2,000-sphere, 300-instance scene of three
    chunks. Returns {kernel: [records]}."""
    from tinsel_tpu_torch.core.sampling import PathUniforms
    from tinsel_tpu_torch.ops import sweep as ops_sweep
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.render.renderer import make_render_pass
    from tinsel_tpu_torch.scene.loaders.tin import load_tin
    from tinsel_tpu_torch.scene.loaders.tungsten import load_tungsten
    from tinsel_tpu_torch.scene.presets import cornell_scene

    recs = {"sweep_closest": [], "sweep_any": []}

    def captured(sc, spp):
        flat, cam = sc.flatten(dev), CameraParams.from_host(sc.camera, dev)
        run = make_render_pass(sc.options, spp)
        with torch.no_grad():
            return capture_calls(((ops_sweep, "sweep_closest"), (ops_sweep, "sweep_any")),
                                 lambda: run(flat, cam, PathUniforms(11, dev)))

    sc = cornell_scene(MAIN_W, MAIN_H, MAIN_DEPTH)
    calls = captured(sc, spp_per_pass(4, MAIN_W, MAIN_H))
    for name in recs:
        if len(calls[name]) != MAIN_DEPTH:
            fail(f"cornell pass: {len(calls[name])} {name} calls, expected {MAIN_DEPTH}")
        for i, (a, _) in enumerate(calls[name]):
            flat, args = sweep_args(a, name == "sweep_closest")
            recs[name].append(check_sweep(ops_sweep, name, flat, args,
                                          f"cornell {MAIN_W}x{MAIN_H} bounce {i}"))
        del calls[name][:]
    for fname, load in (("motionblur.tin", load_tin), ("veach_mis.json", load_tungsten)):
        sc = load(str(ROOT / "scenes" / fname))
        o = sc.options
        calls = captured(sc, 1)
        flat, args = sweep_args(calls["sweep_closest"][0][0], True)
        recs["sweep_closest"].append(check_sweep(ops_sweep, "sweep_closest", flat, args,
                                                 f"{fname} {o.width}x{o.height} bounce 0"))
        if calls["sweep_any"]:  # the pass's own shadow rays
            flat, args = sweep_args(calls["sweep_any"][0][0], False)
            tag = f"{fname} {o.width}x{o.height} bounce 0"
        else:  # no light to sample: the camera rays, with segments of 0 to 6 or +inf
            u = torch.from_numpy(np.random.default_rng(13).random(args[0].shape[0] * 2)
                                 .astype(np.float32)).to(dev)
            tmax = torch.where(u[0::2] < 0.2, float("inf"), 6.0 * u[1::2])
            args = (*args, tmax.contiguous())
            tag = f"{fname} {o.width}x{o.height} camera rays, tmax in [0, 6) or +inf"
        recs["sweep_any"].append(check_sweep(ops_sweep, "sweep_any", flat, args, tag))
        del calls
    flat = sweep_stress_scene().flatten(dev)
    rng = np.random.default_rng(12)
    n = SWEEP_STRESS_RAYS
    d = rng.normal(size=(n, 3))
    ray = [rng.uniform(-11, 11, (n, 3)), d / np.linalg.norm(d, axis=-1, keepdims=True),
           rng.random(n), np.where(rng.random(n) < 0.2, np.inf, rng.uniform(0, 6, n))]
    ray = [torch.from_numpy(x.astype(np.float32)).to(dev) for x in ray]
    n_chunks = ops_sweep.table(flat, dev).n_chunks
    if n_chunks < 2:
        fail(f"the stress scene's table is {n_chunks} chunk, not several")
    tag = f"stress 2000 spheres 300 instances ({n_chunks} chunks)"
    recs["sweep_closest"].append(check_sweep(ops_sweep, "sweep_closest", flat, ray[:3], tag))
    recs["sweep_any"].append(check_sweep(ops_sweep, "sweep_any", flat, ray, tag))
    return recs


# --------------------------------------------------------- BVH walks (K3/K4)


def bvh_work(stats, lanes: int, per_lane: bool, out_bytes: int, culled: int = 0,
             ray_bytes: int = RAY_BYTES):
    """(bytes, f32 operations) of one walk, counted from the plain walk on
    the same inputs: each node row and leaf block the walk reads, read
    once, and each lane's ray (and offsets) in and result out; 16 slab
    tests a node arrival, 16 triangle tests a block test. ``culled`` of
    the lanes have tmax <= 0 or NaN: their answer is fixed by tmax alone,
    so each counts its tmax read and its result written, and ``stats``
    holds the walk of the other lanes. Also the bytes if every arrival
    and block test read its row from device memory (``visit_bytes``:
    what a walk without any cache would move)."""
    lane = ((lanes - culled) * (ray_bytes + (OFFSET_BYTES if per_lane else 0) + out_bytes)
            + culled * (4 + out_bytes))
    nbytes = (int(stats["node_rows"].sum()) * NODE_BYTES
              + int(stats["block_rows"].sum()) * BLOCK_BYTES + lane)
    visit_bytes = stats["visits"] * NODE_BYTES + stats["blocks"] * BLOCK_BYTES + lane
    ops = 16 * (stats["visits"] * SLAB_OPS + stats["blocks"] * TRI_OPS)
    return (nbytes, ops), visit_bytes


class CaptureWalks:
    """Records the arguments of every call of the ``names`` wrappers
    (default K3/K4's) made by the renderer while active (tensors cloned),
    to replay the main path's own inputs."""

    def __init__(self, ops_bvh, names=("closest_hit", "any_hit")):
        self.ops, self.calls = ops_bvh, {k: [] for k in names}

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


def walk_bounds(plain_walk, args, stats_all, out_bytes: int):
    """(bound ms, bound by, culled lanes, bound ms counting every lane as
    walked) of one walk: the bound counts a lane with tmax <= 0 or NaN as
    its tmax read and its result written (no ray, offsets or root row);
    the last number is the count without that correction."""
    pool, noff, toff, o, d, tmax, slots = args
    per_lane = torch.is_tensor(noff)
    lanes = o.shape[0]
    live = tmax > 0
    culled = lanes - int(live.sum())
    stats = stats_all
    if culled:
        stats = {}
        noff, toff = (x[live] if torch.is_tensor(x) else x for x in (noff, toff))
        plain_walk(pool, noff, toff, o[live], d[live], tmax[live], stack_slots=slots,
                   stats=stats)
        if "node_rows" not in stats:  # no live lane: nothing walked
            stats = dict(visits=0, blocks=0, node_rows=torch.zeros(1, dtype=torch.bool),
                         block_rows=torch.zeros(1, dtype=torch.bool))
    work, _ = bvh_work(stats, lanes, per_lane, out_bytes, culled)
    bound_ms, bound_by = bound(work)
    work_all, _ = bvh_work(stats_all, lanes, per_lane, out_bytes)
    return bound_ms, bound_by, culled, bound(work_all)[0]


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

    geo = ops_bvh.last_geometry[name]
    kernel_ms = device_ms(kernel, [args])
    kernel_call_ms = call_ms(kernel, [args])
    plain_ms = _event_ms(run_plain, 1)
    out_bytes = 8 if name == "bvh_closest" else 1
    _, visit_bytes = bvh_work(stats, lanes, per_lane, out_bytes)
    bound_ms, bound_by, culled, bound_all_ms = walk_bounds(plain_walk, args, stats, out_bytes)
    rec = dict(
        kernel=name, shape=tag, lanes=lanes, per_lane_offsets=per_lane,
        hit_share=hit_share, mismatched=mismatched, max_abs_err=err,
        kernel_ms=kernel_ms, kernel_call_ms=kernel_call_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / kernel_ms,
        culled_lanes=culled, bound_ms_every_lane_walked=bound_all_ms,
        rays_per_block=geo["rays_per_block"], smem_bytes=geo["smem_bytes"],
        grid=geo["grid"],
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
    t1 = time.perf_counter()
    m.build()  # normals, CDF, SAH tree (native: 4,096 triangles or more)
    t2 = time.perf_counter()
    sc = Scene()
    sc.add_primitive(Primitive(type=MESH, mesh=m))
    flat = sc.flatten(dev)  # the native wide collapse, then to the card
    t3 = time.perf_counter()
    build_s = t3 - t0
    h = flat.prim_static[0].mesh
    g = np.linspace(-1.2, 1.2, 256, dtype=np.float32)
    x, y = np.meshgrid(g, g)
    r = 256 * 256
    o = torch.from_numpy(np.stack([x.ravel(), y.ravel(), np.full(r, -3.0, np.float32)], -1)).to(dev)
    d = torch.tensor([[1e-5, 1e-5, 1.0]], device=dev).repeat(r, 1)
    tmax = torch.full((r,), float("inf"), device=dev)
    emit(dict(phase="sphere524k", triangles=h.real_tris, nodes=h.num_nodes,
              stack_slots=h.stack_slots, builder="native", host_build_s=build_s,
              mesh_s=t1 - t0, build_s=t2 - t1, flatten_s=t3 - t2))
    seam_count(flat, [((flat, o, d, torch.zeros(r, device=dev)), {})], "sphere524k")
    return (flat.pool, h.node_offset, h.tri_offset, o, d, tmax, h.stack_slots)


def bvh_inputs(dev):
    """The walks' inputs on the card: the 524k sphere, envmesh's first
    diffuse bounce (captured from a 512x512 pass) and many_mesh's instance
    batches (the first round of the plain shortlist rounds, run on the
    card on the first ``_instance_rounds`` / ``_instance_rounds_any`` call
    of a 512x512 pass, whose own rounds are K6: lanes with per-lane
    offsets; the NEE shadow rays). {tag: {"closest": args, "any": args}},
    args as the wrappers take them."""
    from tinsel_tpu_torch.accel import instances as plain_rounds
    from tinsel_tpu_torch.core.sampling import PathUniforms
    from tinsel_tpu_torch.ops import bvh as ops_bvh
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.render.renderer import make_render_pass
    from tinsel_tpu_torch.scene.presets import envmesh_scene, many_mesh_scene

    from tinsel_tpu_torch.render import integrator, trace

    inputs = {"sphere524k": {"closest": sphere_workload(dev)}}
    sc = envmesh_scene(BIG_W, BIG_H, 4)
    flat = sc.flatten(dev)
    cam = CameraParams.from_host(sc.camera, dev)
    with torch.no_grad(), CaptureWalks(ops_bvh) as cap:
        traced = capture_calls(((integrator, "trace_closest"),), lambda: make_render_pass(
            sc.options)(flat, cam, PathUniforms(9, dev)))["trace_closest"]
    seam_count(flat, traced[:2], f"envmesh {BIG_W}x{BIG_H} bounces 0-1")  # camera, bounce 1
    del traced
    inputs["envmesh"] = {"closest": cap.calls["closest_hit"][1]}  # the first diffuse bounce

    sc = many_mesh_scene(48, BIG_W, BIG_H, 2)
    flat = sc.flatten(dev)
    cam = CameraParams.from_host(sc.camera, dev)
    with torch.no_grad():
        rounds = capture_calls(((trace, "_instance_rounds"), (trace, "_instance_rounds_any")),
                               lambda: make_render_pass(sc.options)(flat, cam, PathUniforms(9, dev)))
        with CaptureWalks(ops_bvh) as cap:
            for name, fn in (("_instance_rounds", plain_rounds.rounds_closest_world),
                             ("_instance_rounds_any", plain_rounds.rounds_any_world)):
                a, k = rounds[name][0]
                fn(*a, **k)
    del rounds
    inputs["many_mesh"] = {"closest": cap.calls["closest_hit"][0], "any": cap.calls["any_hit"][0]}
    return inputs


def bvh_kernel_phase(dev):
    """K3 and K4 against their plain versions on ``bvh_inputs``."""
    from tinsel_tpu_torch.accel import traverse as plain
    from tinsel_tpu_torch.ops import bvh as ops_bvh

    inputs = bvh_inputs(dev)
    recs = {"bvh_closest": [], "bvh_any": []}
    for tag, ins in inputs.items():
        for kernel in ("bvh_closest", "bvh_any"):
            # each kernel runs on the closest-hit inputs, K4 also on the
            # shadow rays where the scene has them
            args = ins["closest"] if kernel == "bvh_closest" else ins.get("any", ins["closest"])
            what = "shadow rays" if kernel == "bvh_any" and "any" in ins else "rays"
            walk = plain.intersect_mesh if kernel == "bvh_closest" else plain.intersect_mesh_any
            recs[kernel].append(check_walk(ops_bvh, walk, kernel, args, f"{tag} {what}"))
    return recs, inputs


# ---------------------------------------------------------- big meshes


def spp_per_pass(spp: int, w: int = BIG_W, h: int = BIG_H) -> int:
    """Samples a pass of about 1M rays takes at w x h."""
    return max(1, min(spp, (1 << 20) // (w * h)))


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
    before the path and read just after. Then one pass of each scene under
    the profiler: the walk kernels' device time inside it, beside the
    pass's device busy time and its ms in the timed run."""
    from tinsel_tpu_torch.core.color import resolve
    from tinsel_tpu_torch.core.sampling import PathUniforms
    from tinsel_tpu_torch.ops import instances as ops_instances
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.render.renderer import make_accumulate_fn, make_render_pass

    t0 = time.perf_counter()
    scenes = big_scenes()
    flats = {n: (sc.flatten(dev), CameraParams.from_host(sc.camera, dev))
             for n, sc in scenes.items()}
    emit(dict(phase="bigmesh_setup", host_build_and_flatten_s=time.perf_counter() - t0,
              triangles={n: sum(p.mesh.real_tris for p in f.prim_static if p.mesh)
                         for n, (f, _) in flats.items()}))
    torch.cuda.synchronize()
    ops_bvh.reset_launch_counts()
    ops_instances.reset_launch_counts()
    per_scene = {}
    for name, depth, spp in BIG_SCENES:
        flat, cam = flats[name]
        before = {**ops_bvh.launch_counts, **ops_instances.launch_counts}
        spp_pass = spp_per_pass(spp)
        step = make_accumulate_fn(scenes[name].options, spp_pass)
        source = PathUniforms(0, dev)
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
            pass_ms=secs * 1e3 / (spp // spp_pass), rays_per_s=rays / secs, image_mean=mean,
            passes=spp // spp_pass,
            launches={k: v - before[k] for k, v in {**ops_bvh.launch_counts,
                                                    **ops_instances.launch_counts}.items()},
        )
    launches = {k: v for k, v in {**ops_bvh.launch_counts, **ops_instances.launch_counts}.items()
                if k != "bvh_steps"}
    emit(dict(phase="bigmesh_path", size=f"{BIG_W}x{BIG_H}",
              ray_count="W*H*depth*(1+shadow rays) per spp", scenes=per_scene,
              launches=launches))
    # envmesh walks by K3 (it has no light: no K4); many_mesh's shadow rays
    # and every walk of many_mesh and instances16 go through K6
    if min(launches[k] for k in ("bvh_closest", "rounds_closest", "rounds_any")) < 1:
        fail(f"big-mesh path: a walk kernel was never launched: {launches}")
    # the scenes above INSTANCE_TOPK_MIN big instances walk through K6 alone:
    # one K6c / K6a launch a rounds call (counted in one more pass of each),
    # each held against the plain rounds on its own inputs; envmesh none
    held = {}
    for name, _, spp in BIG_SCENES:
        got = per_scene[name]["launches"]
        if name == "envmesh":
            if got["rounds_closest"] or got["rounds_any"]:
                fail(f"big-mesh path: envmesh (one mesh) launched K6: {got}")
            frames_per_walk(got, "big-mesh path: envmesh")
            continue
        flat, cam = flats[name]
        outs = {}
        with torch.no_grad():
            calls = capture_calls(((ops_instances, "rounds_closest"),
                                   (ops_instances, "rounds_any")),
                                  lambda: make_render_pass(scenes[name].options, spp_per_pass(spp))(
                                      flat, cam, PathUniforms(0, dev)), outs)
        held[name] = hold_rounds(calls, outs)
        del calls, outs
        want = {"bvh_closest": 0, "bvh_any": 0, "bvh_frames": 0,
                **{k: per_scene[name]["passes"] * held[name][k]["calls"]
                   for k in ("rounds_closest", "rounds_any")}}
        per_scene[name]["k6_held"] = held[name]
        if {k: got[k] for k in want} != want or not held[name]["rounds_closest"]["calls"]:
            fail(f"big-mesh path: {name} launched {got}, expected {want}")
    emit(dict(phase="bigmesh_k6_held", scenes=held))
    walks_in_pass(dev, scenes, flats, per_scene)
    return launches, per_scene, held


def device_events(prof):
    """(name, ms) of each device record (kernel, copy) of a profiler
    session, read from its raw records: ``key_averages`` first builds the
    profiler's event tree, which takes minutes for a pass of ~100k ops."""
    from torch.autograd import DeviceType

    return [(e.name(), e.duration_ns() / 1e6) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def walks_in_pass(dev, scenes, flats, per_scene, entries=BIG_SCENES, phase="bigmesh_walks_in_pass"):
    """Device time of the bvh_* kernels inside one pass of each big-mesh
    scene (``entries``: (name, depth, spp)), from torch.profiler's records
    of the card's kernels, and the pass's device idle share."""
    from torch.profiler import ProfilerActivity, profile

    from tinsel_tpu_torch.core.sampling import PathUniforms
    from tinsel_tpu_torch.render.renderer import make_accumulate_fn

    rec = {}
    for name, _, spp in entries:
        flat, cam = flats[name]
        o = scenes[name].options
        step = make_accumulate_fn(o, spp_per_pass(spp, o.width, o.height))
        accum = torch.zeros((o.height, o.width, 4), device=dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(accum, flat, cam, PathUniforms(4, dev), 0)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = device_events(prof)
        busy = sum(ms for _, ms in events)
        walks = {}
        for key, ms in events:
            if "bvh_" in key:
                count, total = walks.get(key[:40], (0, 0.0))
                walks[key[:40]] = (count + 1, total + ms)
        walk_ms = sum(ms for _, ms in walks.values())
        rec[name] = dict(
            size=f"{o.width}x{o.height}", depth=o.max_depth,
            pass_ms_timed_run=per_scene[name]["pass_ms"], profiled_wall_ms=wall_ms,
            device_busy_ms=busy if busy > 0 else "not measured",
            walk_device_ms=walk_ms if busy > 0 else "not measured",
            walk_launches=sum(c for c, _ in walks.values()),
            walk_share_of_pass=walk_ms / per_scene[name]["pass_ms"] if busy > 0 else None,
            walk_share_of_busy=walk_ms / busy if busy > 0 else None,
            idle_share_profiled=1.0 - busy / wall_ms if busy > 0 else "not measured",
            walk_kernels={k: list(v) for k, v in walks.items()},
        )
    emit(dict(phase=phase, scenes=rec))
    return rec


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
            dev_norm = grad_devs(ga, gb)
            worst = max(dev_norm, key=dev_norm.get)
            rec = dict(phase="grad_gpu_vs_cpu_equal_draws", scene=f"{name} 64x64 d{depth} 1spp",
                       fatal=depth == 1, loss_rel_diff=abs(la - lb) / abs(lb), worst_leaf=worst,
                       worst_normalized_dev=dev_norm[worst])
            emit(rec)
            if depth == 1 and (rec["loss_rel_diff"] > 1e-5 or dev_norm[worst] > GRAD_TOL):
                fail(f"card and CPU gradients disagree at equal draws: {rec}")


def grad_devs(ga, gb) -> dict:
    """{leaf: max |ga - gb| over the largest |gb|} of two gradient dicts.
    A leaf whose gradient is zero in exact arithmetic holds the rounding
    noise of sums that cancel (envmesh at depth 1 sees only the sky, a
    function of the ray direction: its camera-position gradient is +g - g
    over every pixel, measured 3e-8 of the largest leaf); leaves under
    1e-3 of the largest gradient of any leaf are held against that
    instead."""
    floor = 1e-3 * max(float(g.abs().max()) for g in gb.values())
    return {k: float((ga[k] - gb[k]).abs().max()) / max(float(gb[k].abs().max()), floor, 1e-30)
            for k in gb}


def _old_select(self, i):
    """``MaterialsFlat.select`` before its one-hot backward, kept here for
    the A/B of gradient_phase: advanced indexing, whose backward is the
    accumulating index_put."""
    i = i.long()
    return type(self)(**{f.name: getattr(self, f.name)[i] for f in dataclasses.fields(self)})


def gradient_phase(ops_bvh, dev):
    """The gradient step at full size on cornell and envmesh 512x512
    depth 4, 1 spp: finite loss and gradients, some nonzero; peak device
    memory; fwd+bwd / fwd at matched spp (bench.py:159-204: the same pass
    with and without its backward, CUDA events, medians) and the
    backward's device time and top kernels from the profiler, each for the
    package's material gather and for ``_old_select``, in the turns new,
    old, old, new. K3 counts are reset just before and read just after."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tinsel_tpu_torch.core.sampling import PathUniforms
    from tinsel_tpu_torch.diff.gradients import render_loss, render_loss_and_grads
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.scene import model
    from tinsel_tpu_torch.scene.presets import cornell_scene, envmesh_scene

    opts = dict(width=BIG_W, height=BIG_H, max_depth=4)
    target = torch.full((BIG_H, BIG_W, 3), 0.25, device=dev)
    for name, sc in (("cornell", cornell_scene(BIG_W, BIG_H, 4)),
                     ("envmesh", envmesh_scene(BIG_W, BIG_H, 4))):
        flat, cam = sc.flatten(dev), CameraParams.from_host(sc.camera, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops_bvh.reset_launch_counts()
        loss, grads = render_loss_and_grads(flat, cam, PathUniforms(1, dev), target, **opts)
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
            render_loss_and_grads(flat, cam, PathUniforms(i, dev), target, **opts)

        def fwd(i):
            with torch.no_grad():
                render_loss(flat, cam, PathUniforms(i, dev), target, **opts)

        def backward_profile():
            """The backward alone under the profiler."""
            mats = dataclasses.replace(flat.materials, **{
                f.name: getattr(flat.materials, f.name).clone().requires_grad_(True)
                for f in dataclasses.fields(flat.materials)})
            cam_l = dataclasses.replace(cam, **{
                f.name: getattr(cam, f.name).clone().requires_grad_(True)
                for f in dataclasses.fields(cam)})
            ls = render_loss(dataclasses.replace(flat, materials=mats), cam_l,
                             PathUniforms(5, dev), target, **opts)
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
            return dict(
                backward_wall_ms=bwd_wall,
                backward_device_busy_ms=busy if busy > 0 else "not measured",
                backward_index_scatter_ms=scatter_ms,
                scatter_share_of_backward=scatter_ms / busy if busy > 0 else "not measured",
                backward_top_kernels=[[e.key[:70], e.count, e.self_device_time_total / 1e3]
                                      for e in top],
            )

        # the package's gather ("new") and the one it replaced ("old"), in
        # turns; each turn times one forward and one forward + backward
        gathers = {"new": model.MaterialsFlat.select, "old": _old_select}
        times = {v: {"fwd": [], "fwd_bwd": []} for v in gathers}
        ab = {}
        try:
            for i, v in enumerate(("new", "old", "old", "new")):
                model.MaterialsFlat.select = gathers[v]
                for key, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
                    times[v][key].append(_event_ms(lambda: fn(i), 1))
            for v in gathers:
                model.MaterialsFlat.select = gathers[v]
                med = {k: statistics.median(t) for k, t in times[v].items()}
                ab[v] = dict(fwd_ms=med["fwd"], fwd_bwd_ms=med["fwd_bwd"],
                             fwd_bwd_over_fwd=med["fwd_bwd"] / med["fwd"],
                             fwd_bwd_rays_per_s=BIG_W * BIG_H * 4 / (med["fwd_bwd"] / 1e3),
                             **backward_profile())
        finally:
            model.MaterialsFlat.select = gathers["new"]
        new = ab["new"]
        emit(dict(
            phase="gradient_step", scene=f"{name} {BIG_W}x{BIG_H} d4 1spp", loss=float(loss),
            nonzero_leaves=len(nonzero), max_memory_allocated_gib=peak / 2**30,
            launches=launches, **new,
            old_gather=ab["old"],
            backward_busy_new_over_old=(
                new["backward_device_busy_ms"] / ab["old"]["backward_device_busy_ms"]
                if isinstance(new["backward_device_busy_ms"], float) else "not measured"),
        ))
        del flat, cam, loss, grads, leaves


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



# ------------------------------------- the rest of the integrator (K7)


def check_steps(ops_bvh, plain, args, tag):
    """K7 against its plain version (the plain walk's count with
    tmax = +inf) on the same card inputs: equal on every lane. Timed
    beside K3 on the same rays; the bound counts the rows the plain walk
    reads, each once, the ray in (no tmax) and one f32 out."""
    pool, noff, toff, o, d, slots = args
    lanes = o.shape[0]
    inf = torch.full((lanes,), float("inf"), device=o.device)
    before = ops_bvh.launch_counts["bvh_steps"]
    out = ops_bvh.traversal_steps_cuda(*args)
    torch.cuda.synchronize()
    if ops_bvh.launch_counts["bvh_steps"] != before + 1:
        fail(f"bvh_steps {tag}: the wrapper did not count its launch")
    stats = {}
    ref = plain.traversal_cost(pool, noff, toff, o, d, inf, stack_slots=slots, stats=stats)
    mismatched = int((out != ref).sum())
    geo = ops_bvh.last_geometry["bvh_steps"]
    k3_args = (pool, noff, toff, o, d, inf, slots)
    kernel_ms = device_ms(ops_bvh.traversal_steps_cuda, [args])
    k3_ms = device_ms(ops_bvh.closest_hit_cuda, [k3_args])
    kernel_call_ms = call_ms(ops_bvh.traversal_steps_cuda, [args])
    plain_ms = _event_ms(lambda: plain.traversal_cost(pool, noff, toff, o, d, inf,
                                                      stack_slots=slots), 1)
    per_lane = torch.is_tensor(noff)
    work, visit_bytes = bvh_work(stats, lanes, per_lane, 4, ray_bytes=24)
    bound_ms, bound_by = bound(work)
    rec = dict(
        kernel="bvh_steps", shape=tag, lanes=lanes, per_lane_offsets=per_lane,
        mismatched=mismatched, max_abs_err=float((out - ref).abs().max()),
        kernel_ms=kernel_ms, k3_ms_same_rays=k3_ms, k7_over_k3=kernel_ms / k3_ms,
        kernel_call_ms=kernel_call_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        bound_share=bound_ms / kernel_ms, rays_per_block=geo["rays_per_block"],
        smem_bytes=geo["smem_bytes"], grid=geo["grid"],
        steps_per_lane=float(ref.mean()), max_steps=float(ref.max()),
        lanes_over_16_steps=int((ref > 16).sum()),
        visits_per_lane=stats["visits"] / lanes, blocks_per_lane=stats["blocks"] / lanes,
        rows_read=[int(stats["node_rows"].sum()), int(stats["block_rows"].sum())],
        visit_traffic_ms=visit_bytes / HBM_BYTES_PER_S * 1e3, launches=1, library_ms=None,
    )
    emit(rec)
    if mismatched or stats["visits"] + stats["blocks"] != int(ref.sum()):
        fail(f"bvh_steps {tag}: kernel differs from the plain count ({mismatched} lanes)")
    return rec


def probe_scene(detail: int = 256, w: int = BIG_W, h: int = BIG_H, depth: int = 4):
    from tinsel_tpu_torch.scene.presets import envmesh_scene

    return envmesh_scene(w, h, depth, detail=detail, probe=True)


def steps_kernel_phase(dev, walk_inputs):
    """K7 on envmesh's 512x512 camera rays (captured from a complexity
    pass: local rays, per-lane offsets), envmesh's first diffuse bounce and
    the 524k sphere's rays; K4 on envmesh's probe shadow rays (captured
    from a pass of the probe scene). Returns (K7 records, K4 record)."""
    from tinsel_tpu_torch.accel import traverse as plain
    from tinsel_tpu_torch.core.sampling import PathUniforms
    from tinsel_tpu_torch.ops import bvh as ops_bvh
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.render.renderer import make_render_pass

    sc = probe_scene()
    flat = sc.flatten(dev)
    cam = CameraParams.from_host(sc.camera, dev)
    with torch.no_grad(), CaptureWalks(ops_bvh) as cap:
        make_render_pass(sc.options)(flat, cam, PathUniforms(9, dev))
    probe_shadow = cap.calls["any_hit"][0]  # bounce 0's probe shadow rays
    cx = dataclasses.replace(sc.options, mode="complexity")
    with torch.no_grad(), CaptureWalks(ops_bvh, ("traversal_steps",)) as cap:
        make_render_pass(cx)(flat, cam, PathUniforms(9, dev))
    camera = cap.calls["traversal_steps"][0]

    def drop_tmax(args):
        pool, noff, toff, o, d, _, slots = args
        return (pool, noff, toff, o, d, slots)

    recs = [
        check_steps(ops_bvh, plain, camera, "envmesh camera rays"),
        check_steps(ops_bvh, plain, drop_tmax(walk_inputs["envmesh"]["closest"]),
                    "envmesh bounce 1"),
        check_steps(ops_bvh, plain, drop_tmax(walk_inputs["sphere524k"]["closest"]),
                    "sphere524k rays"),
    ]
    k4 = check_walk(ops_bvh, plain.intersect_mesh_any, "bvh_any", probe_shadow,
                    "envmesh probe shadow rays")
    tmax = probe_shadow[5]
    if not bool(((tmax == float("inf")) | (tmax == 0)).all()) or not bool(torch.isinf(tmax).any()):
        fail("envmesh probe shadow rays: expected tmax = +inf (0 on culled lanes)")
    return recs, k4


def compare_renders(a, b, what):
    """Card against CPU at equal draws, the RENDER_* limits."""
    a, b = a.cpu().numpy(), b.cpu().numpy()
    if a.shape != b.shape or not np.isfinite(a).all():
        fail(f"equal-draw {what} on the card: bad output")
    close = np.isclose(a, b, atol=RENDER_ATOL, rtol=RENDER_RTOL).all(axis=-1)
    rel = abs(a[..., :3].mean() - b[..., :3].mean()) / max(abs(b[..., :3].mean()), 1e-12)
    rec = dict(phase="gpu_vs_cpu_equal_draws", scene=what, pixels_within_tol=float(close.mean()),
               mean_rel_diff=float(rel), max_abs_diff=float(np.abs(a - b).max()))
    emit(rec)
    if close.mean() < RENDER_SHARE or not rel < RENDER_MEAN_REL:
        fail(f"card and CPU disagree at equal draws: {rec}")


def integrator_equal_draw_phase(dev):
    """The slice's paths on the card and on the CPU at equal draws
    (NumpyUniforms), 64x64: the probe-lit envmesh (detail 32, 2,048
    triangles, depth 4), Cornell with power light sampling and Russian
    roulette from bounce 2, the stratified and blue-noise samplers at 4
    spp, the normals and complexity views (complexity: equal costs on the
    same rays), and a warm-up and two adaptive rounds."""
    from tinsel_tpu_torch.core.sampling import NumpyUniforms
    from tinsel_tpu_torch.render.adaptive import adaptive_round
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.render.integrator import traversal_costs
    from tinsel_tpu_torch.render.renderer import render
    from tinsel_tpu_torch.scene.presets import cornell_scene

    cpu = torch.device("cpu")

    def both(sc, what, spp=1):
        a, b = (render(sc, spp=spp, device=d, source=NumpyUniforms(7, d)) for d in (dev, cpu))
        compare_renders(a, b, what)

    both(probe_scene(32, 64, 64, 4), "envmesh probe detail 32 64x64 d4 1spp")
    c = cornell_scene(64, 64, MAIN_DEPTH)
    c.options = dataclasses.replace(c.options, light_sampling="power", rr_depth=2)
    both(c, "cornell 64x64 d4 power rr_depth=2 1spp")
    for sampler in ("stratified", "bluenoise"):
        c = cornell_scene(64, 64, MAIN_DEPTH)
        c.options = dataclasses.replace(c.options, sampler=sampler)
        both(c, f"cornell 64x64 d4 {sampler} 4spp", spp=4)
    e = probe_scene(32, 64, 64, 1)
    e.options = dataclasses.replace(e.options, mode="normals")
    both(e, "envmesh detail 32 64x64 normals 1spp")
    e.options = dataclasses.replace(e.options, mode="complexity")
    both(e, "envmesh detail 32 64x64 complexity 1spp")
    # the costs themselves on the same rays: equal
    flats = {d: e.flatten(d) for d in (dev, cpu)}
    rng = np.random.default_rng(3)
    dirs = rng.normal(size=(4096, 3)).astype(np.float32) * [0.3, 0.3, 1.0] + [0, -0.1, -1.0]
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    costs = [traversal_costs(flats[d], torch.tensor([[0.0, 1.0, 3.2]], device=d).repeat(4096, 1),
                             torch.from_numpy(dirs.astype(np.float32)).to(d),
                             torch.zeros(4096, device=d)).cpu() for d in (dev, cpu)]
    n_diff = int((costs[0] != costs[1]).sum())
    emit(dict(phase="complexity_costs_gpu_vs_cpu", rays=4096, differing=n_diff,
              mean_cost=float(costs[1].mean()), max_cost=float(costs[1].max())))
    if n_diff:
        fail(f"complexity costs differ between the card and the CPU on {n_diff} rays")
    # adaptive rounds: a uniform warm-up over the 16 tiles, two rounds of 4
    c = cornell_scene(64, 64, MAIN_DEPTH)
    out = []
    for d in (dev, cpu):
        flat, cam = c.flatten(d), CameraParams.from_host(c.camera, d)
        acc, m2 = torch.zeros((64, 64, 4), device=d), torch.zeros((64, 64, 3), device=d)
        for r, (k, uni) in enumerate(((16, True), (4, False), (4, False))):
            acc, m2 = adaptive_round(acc, m2, flat, cam, NumpyUniforms(7 + r, d), k_tiles=k,
                                     spp=2, width=64, height=64, max_depth=MAIN_DEPTH,
                                     uniform=uni)
        out.append(acc)
    if not torch.equal(out[0][..., 3].cpu(), out[1][..., 3]):
        fail("adaptive rounds chose other tiles on the card than on the CPU")
    compare_renders(out[0], out[1], "cornell 64x64 d4 adaptive warm-up + 2 rounds")


def probe_path(ops_nlm, ops_bvh, dev, per_scene_envmesh):
    """The full-width path: envmesh_scene(512, 512, 4, probe=True) at 16
    spp (flattened once as set-up, then accumulated pass by pass as
    ``render`` does) -> resolve -> nlm_denoise, K3/K4/K1 counts reset just
    before and read just after; the same scene's complexity view through
    ``render`` (K7 reset just before); ``adaptive_render`` at a 16-spp
    budget; one profiled pass. Returns the launches."""
    from tinsel_tpu_torch.core.color import resolve
    from tinsel_tpu_torch.core.sampling import PathUniforms
    from tinsel_tpu_torch.render.adaptive import adaptive_render
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.render.renderer import make_accumulate_fn, render

    from tinsel_tpu_torch.ops import instances as ops_instances
    from tinsel_tpu_torch.ops import nee as ops_nee

    sc = probe_scene()
    t0 = time.perf_counter()
    flat, cam = sc.flatten(dev), CameraParams.from_host(sc.camera, dev)
    setup_s = time.perf_counter() - t0
    spp, spp_pass = 16, spp_per_pass(16)
    step = make_accumulate_fn(sc.options, spp_pass)
    torch.cuda.synchronize()
    ops_bvh.reset_launch_counts()
    ops_nlm.reset_launch_counts()
    ops_nee.reset_launch_counts()
    ops_instances.reset_launch_counts()
    t1 = time.perf_counter()
    accum = torch.zeros((BIG_H, BIG_W, 4), device=dev)
    source = PathUniforms(0, dev)
    for c in range(spp // spp_pass):
        accum = step(accum, flat, cam, source, c)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    img = resolve(accum)
    den = ops_nlm.nlm_denoise(img)
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t1
    launches = {"bvh_closest": ops_bvh.launch_counts["bvh_closest"],
                "bvh_any": ops_bvh.launch_counts["bvh_any"],
                "bvh_frames": ops_instances.launch_counts["bvh_frames"],
                "nlm_filter": ops_nlm.launch_counts["nlm_filter"],
                "nee_shade": ops_nee.launch_counts["nee_shade"]}
    if ops_nee.launch_counts["nee_light"] != 0:  # the probe is the scene's one light
        fail(f"probe path: K8 launched without an area light: {ops_nee.launch_counts}")
    mean = float(img.mean())
    if not torch.isfinite(accum).all() or not torch.isfinite(den).all() or not 0.01 < mean < 0.99:
        fail(f"probe path: the image is not finite or is black (mean {mean})")
    if min(launches.values()) < 1:
        fail(f"probe path: a kernel was never launched: {launches}")
    frames_per_walk(launches, "probe path")
    rays = BIG_W * BIG_H * 4 * 2 * spp  # camera/bounce ray + probe shadow ray per bounce
    pass_ms = secs * 1e3 / (spp // spp_pass)
    emit(dict(phase="probe_path", scene=f"envmesh probe {BIG_W}x{BIG_H} d4", spp=spp,
              host_flatten_s=setup_s, render_s=secs, ms_per_spp=secs * 1e3 / spp,
              pass_ms=pass_ms, rays_per_s=rays / secs,
              ray_count="W*H*depth*(1+probe shadow ray) per spp",
              ms_per_spp_over_envmesh_no_probe=secs * 1e3 / spp / per_scene_envmesh["ms_per_spp"],
              total_s_with_denoise=t_all, image_mean=mean, denoised_mean=float(den.mean()),
              launches=launches))

    cx = probe_scene()
    cx.options = dataclasses.replace(cx.options, mode="complexity")
    ops_bvh.reset_launch_counts()
    t2 = time.perf_counter()
    heat = render(cx, spp=1, device=dev)
    torch.cuda.synchronize()
    cx_s = time.perf_counter() - t2
    launches["bvh_steps"] = ops_bvh.launch_counts["bvh_steps"]
    if launches["bvh_steps"] < 1 or not torch.isfinite(heat).all():
        fail(f"complexity view: K7 was not launched or the image is not finite: {launches}")
    emit(dict(phase="complexity_path", scene=f"envmesh probe {BIG_W}x{BIG_H}", spp=1,
              seconds_with_flatten=cx_s, launches=dict(ops_bvh.launch_counts),
              heat_mean=float(heat[..., :3].mean())))

    t3 = time.perf_counter()
    acc = adaptive_render(probe_scene(), 16, seed=0, device=dev)
    torch.cuda.synchronize()
    ad_s = time.perf_counter() - t3
    counts = acc[..., 3]
    if not torch.isfinite(acc).all() or float(counts.min()) < 4 or float(counts.mean()) > 16:
        fail("adaptive_render: non-finite buffer or a budget overrun")
    emit(dict(phase="adaptive_render", scene=f"envmesh probe {BIG_W}x{BIG_H} d4",
              budget_spp=16, seconds_with_flatten=ad_s, mean_spp=float(counts.mean()),
              max_spp=float(counts.max()), image_mean=float(resolve(acc).mean())))

    walks_in_pass(dev, {"envmesh_probe": sc}, {"envmesh_probe": (flat, cam)},
                  {"envmesh_probe": {"pass_ms": pass_ms}}, entries=(("envmesh_probe", 4, 16),),
                  phase="probe_walks_in_pass")
    return launches


# ---------------------------------- the trace: K5 against torch ops, K6


def rounds_differ(out, ref) -> tuple:
    """(lanes where a K6 output differs from the plain rounds' -- t by its
    bits, tri, inst, or the occlusion bit --, the largest |t - t_ref| over
    lanes where both are finite, +inf if finiteness differs)."""
    if torch.is_tensor(out):  # K6a
        return int((out != ref).sum()), float(bool((out != ref).any()))
    (t, tri, inst), (t_ref, tri_ref, inst_ref) = out, ref
    bad = ((t.view(torch.int32) != t_ref.view(torch.int32)) | (tri != tri_ref)
           | (inst != inst_ref))
    fin = torch.isfinite(t_ref)
    if not torch.equal(torch.isfinite(t), fin):
        return int(bad.sum()), float("inf")
    return int(bad.sum()), float((t - t_ref)[fin].abs().max()) if bool(fin.any()) else 0.0


def hold_rounds(calls, outs) -> dict:
    """Each K6c / K6a launch (a call of ops/instances.py's dispatchers
    captured with its output by ``capture_calls``) against the plain
    rounds from the same world rays (accel/instances.py::
    rounds_closest_world / rounds_any_world): every lane equal, t bit for
    bit. Fails on a mismatch."""
    from tinsel_tpu_torch.accel import instances as plain_rounds

    rec = {}
    for name in ("rounds_closest", "rounds_any"):
        rays = mismatched = 0
        err = 0.0
        for (a, k), out in zip(calls.get(name, []), outs.get(name, [])):
            n, e = rounds_differ(out, getattr(plain_rounds, f"{name}_world")(*a, **k))
            rays += a[2].shape[0]
            mismatched += n
            err = max(err, e)
        rec[name] = dict(calls=len(calls.get(name, [])), rays=rays, mismatched=mismatched,
                         max_abs_err=err)
        if mismatched:
            fail(f"{name}: K6 differs from the plain rounds on {mismatched} of {rays} rays")
    return rec


def capture_calls(targets, run, outs=None):
    """Run ``run()`` with every (module, name) of ``targets`` wrapped to
    record its arguments (tensors cloned): {name: [(args, kwargs), ...]}.
    ``outs``: a dict that also gets each call's result, {name: [out, ...]}."""
    calls = {name: [] for _, name in targets}
    orig = {(m, name): getattr(m, name) for m, name in targets}
    for (m, name), fn in orig.items():
        def wrapped(*a, _name=name, _fn=fn, **k):
            calls[_name].append((tuple(x.clone() if torch.is_tensor(x) else x for x in a), k))
            out = _fn(*a, **k)
            if outs is not None:
                outs.setdefault(_name, []).append(out)
            return out
        setattr(m, name, wrapped)
    try:
        run()
    finally:
        for (m, name), fn in orig.items():
            setattr(m, name, fn)
    return calls


SPIN_CYCLES = 200_000  # torch.cuda._sleep: ~0.1 ms of the card at 1.98 GHz


def profiled(run, warm: bool = True):
    """One run under the profiler: device busy ms and kernel launches in
    all, of the walk kernels (bvh_*) and of the sweep kernels (sweep_*,
    beside the launches their wrappers counted in that run,
    ``profiled_run_counted``), and its wall ms there. Then the run again
    outside the profiler, its sweep launches timed by CUDA events
    (``sweep_spans``): their spin kernels stay out of the profiled run's
    wall and idle share. ``warm``: a spin kernel runs first inside the
    session and is left out of the records (see ``profiler_probe``)."""
    from torch.profiler import ProfilerActivity, profile

    from tinsel_tpu_torch.ops import sweep as ops_sweep

    torch.cuda.synchronize()
    before = dict(ops_sweep.launch_counts)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if warm:
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    counted = {k: ops_sweep.launch_counts[k] - before[k] for k in before}
    events = [(k, ms) for k, ms in device_events(prof) if "spin_kernel" not in k]
    walks = [ms for key, ms in events if "bvh_" in key]
    sweeps = [ms for key, ms in events if "sweep_" in key]
    busy = sum(ms for _, ms in events)
    if busy <= 0 and warm:
        fail("the profiler recorded no device time")
    with torch.no_grad(), sweep_spans() as spans:
        run()
    if sum(counted.values()) != spans["counted"]:
        fail(f"profiled: {counted} sweep launches under the profiler, {spans['counted']} "
             "in the same work timed by events")
    return dict(device_ms=busy, launches=len(events),
                walk_device_ms=sum(walks), walk_launches=len(walks),
                profiler_sweep_launches=len(sweeps), profiler_sweep_device_ms=sum(sweeps),
                profiled_run_counted=counted, profiled_wall_ms=wall,
                sweep_device_ms=spans["device_ms"], sweep_launches=spans["launches"],
                sweep_launches_counted=spans["counted"])


@contextlib.contextmanager
def sweep_spans():
    """CUDA events around each K5c / K5a launch inside the block, a spin
    kernel before each launch, so the card is still busy when the host
    reaches the launch and the pair times the kernel, not the host's
    dispatch. Yields a dict filled on exit: the spans' launches and device
    ms and the launches the wrappers counted; fails when the events and
    the wrappers' counts differ."""
    from tinsel_tpu_torch.ops import sweep as ops_sweep

    spans, out = [], {}
    before = dict(ops_sweep.launch_counts)
    orig = ops_sweep._entry

    def entry(kernel):
        fn = orig(kernel)

        def timed(*args):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            for e in (start, end):  # created (at their first record) before the spin
                e.record()
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            err = fn(*args)
            end.record()
            if err == 0:
                spans.append((start, end))
            return err
        return timed

    ops_sweep._entry = entry
    try:
        yield out
    finally:
        ops_sweep._entry = orig
    torch.cuda.synchronize()
    counted = sum(ops_sweep.launch_counts[k] - before[k] for k in before)
    out.update(launches=len(spans), counted=counted,
               device_ms=sum(a.elapsed_time(b) for a, b in spans))
    if len(spans) != counted:
        fail(f"sweep spans: {len(spans)} launches timed by events, {counted} counted")


def sweep_work(flat, stats, closest: bool, hoist: bool = True):
    """(bytes, f32 operations) of K5c / K5a on one call's rays, counted
    from the plain sweep on the same inputs (``stats``): each ray's origin
    and direction in (its time where some row moves, its tmax for K5a),
    (t, prim, tri) or the occlusion byte out, the record table once; each
    test the plain version makes (K5a's up to a ray's first occluder, an
    instance's triangles only where its root box passes, one
    re-intersection for each ray a group's candidate comes from)."""
    from tinsel_tpu_torch.accel.sweep import layout
    from tinsel_tpu_torch.ops.sweep import pack_records

    lay = layout(flat.prim_static, hoist)
    motion = lay.sphere_motion or any(g.motion for g in lay.groups)
    per_ray = 24 + (4 if motion else 0) + (12 if closest else 5)
    nbytes = stats["rays"] * per_ray + 4 * pack_records(flat, hoist=hoist)[0].size
    sphere = SPHERE_OPS + (MOTION_SPHERE_OPS if lay.sphere_motion else 0)
    ops = (stats.get("sphere_tests", 0) * sphere + stats.get("plane_tests", 0) * PLANE_OPS
           + stats.get("instance_tests", 0) * INSTANCE_OPS
           + stats.get("moving_instance_tests", 0) * (INSTANCE_OPS + MOTION_INSTANCE_OPS)
           + stats.get("tri_tests", 0) * TRI_OPS + stats.get("refits", 0) * REFIT_OPS)
    return nbytes, ops


def rounds_work(args, walked: int, stats, closest: bool):
    """(bytes, f32 operations) of one K6 call on its arguments ``args``
    (the dispatcher's: scene, instance table, world rays, times, best t or
    tmax and occlusion), counted on the plain rounds of the same inputs:
    each ray's world ray in (its time where the batch moves), its best t
    (or tmax and occlusion) in and (t, tri, inst) or the occlusion bit
    out, the instance table once, and each node row and leaf block the
    plain rounds' walks read, once (``stats``: their counts,
    ``bvh_work``); each live ray's local ray and root-box test of every
    instance (INSTANCE_OPS, MOTION_INSTANCE_OPS where the batch moves;
    a live ray: best t > 0, or not occluded and tmax > 0), one compare of
    every instance's entry for each pick the rays make (a walked pick and
    the last one, which ends the ray), and the walks' slab and triangle
    tests."""
    tab, origins = args[1], args[2]
    rays, inst = origins.shape[0], len(tab.prims)
    if closest:
        live = int((args[5] > 0).sum())
    else:
        live = int((~args[6] & (args[5] > 0)).sum())
    lane = 24 + (4 if tab.motion else 0) + (4 + 16 if closest else 4 + 1 + 1)
    (walk_bytes, walk_ops), _ = bvh_work(stats, 0, False, 0)
    nbytes = lane * rays + tab.table.numel() * 4 + walk_bytes
    box_ops = INSTANCE_OPS + (MOTION_INSTANCE_OPS if tab.motion else 0)
    return nbytes, live * inst * box_ops + (walked + live) * inst + walk_ops


def plain_round_walks(ops_bvh, fn, args, closest: bool):
    """The plain rounds on ``args`` with their K3 / K4 calls captured, and
    the work of those walks: (rounds, lanes walked (tmax > 0), the plain
    walk's merged stats on those lanes)."""
    from tinsel_tpu_torch.accel import traverse as plain_walks

    with torch.no_grad(), CaptureWalks(ops_bvh) as cap:
        fn(*args)
    walk = plain_walks.intersect_mesh if closest else plain_walks.intersect_mesh_any
    calls = cap.calls["closest_hit" if closest else "any_hit"]
    merged = dict(visits=0, blocks=0, node_rows=None, block_rows=None)
    walked = 0
    for pool, noff, toff, o, d, tmax, slots in calls:
        live = tmax > 0
        walked += int(live.sum())
        if not bool(live.any()):
            continue
        st = {}
        walk(pool, noff[live], toff[live], o[live], d[live], tmax[live], stack_slots=slots,
             stats=st)
        if "node_rows" not in st:
            continue
        merged["visits"] += st["visits"]
        merged["blocks"] += st["blocks"]
        for key in ("node_rows", "block_rows"):
            merged[key] = st[key] if merged[key] is None else merged[key] | st[key]
    if merged["node_rows"] is None:
        merged.update(node_rows=torch.zeros(1, dtype=torch.bool),
                      block_rows=torch.zeros(1, dtype=torch.bool))
    return len(calls), walked, merged


def old_trace_closest(scene, origins, dirs, times):
    """trace_closest as the port ran it before kernel K5c (a copy kept for
    phase 10's A/B, scenes without big meshes): spheres and planes as
    (rows, rays) torch ops merged row by row, each tiny group swept by the
    brute test and its winner re-intersected."""
    from tinsel_tpu_torch.accel.sweep import mesh_partition
    from tinsel_tpu_torch.accel.traverse import intersect_mesh
    from tinsel_tpu_torch.core.math import dot, face_forward, quat_rotate, safe_normalize
    from tinsel_tpu_torch.geometry.intersect import (
        INF, intersect_ray_plane, intersect_ray_sphere, intersect_ray_tri)
    from tinsel_tpu_torch.render.trace import (
        Hit, _instance_box_entry, _local_rays, _offsets, _prim_transforms_batched)

    r, dev = origins.shape[0], origins.device
    best_t = torch.full((r,), INF, device=dev)
    best_prim = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_n = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    tiny_groups, big, spheres, planes = mesh_partition(scene.prim_static)
    if big:
        fail("old_trace_closest: the kept copy has no big-mesh batch")

    def merge_rows(t_rows, n_rows, ids):
        nonlocal best_t, best_prim, best_n
        for row, pid in enumerate(ids):
            t_r = t_rows[row]
            closer = torch.isfinite(t_r) & (t_r > 0.0) & (t_r < best_t)
            best_t = torch.where(closer, t_r, best_t)
            best_prim = torch.where(closer, pid, best_prim)
            best_n = torch.where(closer[..., None], n_rows[row], best_n)

    if spheres:
        sel = torch.as_tensor(spheres, dtype=torch.long, device=dev)
        tr_b = _prim_transforms_batched(scene, spheres, times)
        hit, t, n = intersect_ray_sphere(tr_b.p, scene.prims.radius[sel][:, None] * tr_b.s,
                                         origins[None, :, :], dirs[None, :, :])
        merge_rows(torch.where(hit & (t > 0.0), t, INF), n, spheres)
    if planes:
        sel = torch.as_tensor(planes, dtype=torch.long, device=dev)
        hit, t, n = intersect_ray_plane(scene.prims.plane[sel][:, None, :],
                                        origins[None, :, :], dirs[None, :, :])
        merge_rows(torch.where(hit & (t > 0.0), t, INF), n, planes)
    for idxs in tiny_groups.values():
        handles = [scene.prim_static[i].mesh for i in idxs]
        n_inst = len(idxs)
        tr_b, o_l, d_l = _local_rays(scene, idxs, origins, dirs, times)
        inst_ids = torch.arange(n_inst, dtype=torch.long, device=dev)[:, None]
        _, toff, _ = _offsets(handles, dev)
        with torch.no_grad():
            tmax_b = torch.broadcast_to(best_t[None, :], (n_inst, r))
            may_hit, _ = _instance_box_entry(handles, o_l, d_l, tmax_b)
            tmax_i = torch.where(may_hit, tmax_b, 0.0).reshape(n_inst * r)
            t_f, tri_f = intersect_mesh(
                scene.pool, handles[0].node_offset, handles[0].tri_offset,
                o_l.reshape(n_inst * r, 3), d_l.reshape(n_inst * r, 3), tmax_i,
                num_tris=handles[0].real_tris)
            t_i, tri_i = t_f.reshape(n_inst, r), tri_f.reshape(n_inst, r)
            t_min = t_i.min(dim=0).values
            inst = torch.where(t_i == t_min[None, :], inst_ids, n_inst)
            inst = torch.clamp(inst.min(dim=0).values, max=n_inst - 1)
            tri = torch.where(inst_ids == inst[None, :], tri_i, -1).max(dim=0).values
            hit = torch.isfinite(t_min) & (t_min < best_t)
        onehot = (inst_ids == inst[None, :]).to(torch.float32)
        ow = (onehot[..., None] * o_l).sum(dim=0)
        dw = (onehot[..., None] * d_l).sum(dim=0)
        qw = (onehot[..., None] * tr_b.q).sum(dim=0)
        gt = toff.long()[inst] + torch.clamp(tri, min=0).long()
        v0, v1, v2 = (x.detach() for x in scene.pool.gather_tri(gt))
        n0, n1, n2 = (x.detach() for x in scene.pool.gather_normals(gt))
        _, t, u, v, w, n_geo = intersect_ray_tri(v0, v1, v2, ow, dw)
        t = torch.where(hit & (tri >= 0), t, INF)
        ns = u[..., None] * n0 + v[..., None] * n1 + w[..., None] * n2
        ns = ns * torch.where(dot(ns, n_geo) < 0.0, -1.0, 1.0)[..., None]
        n = safe_normalize(quat_rotate(qw, ns), fallback=safe_normalize(quat_rotate(qw, n_geo)))
        prim_ids = torch.tensor(idxs, dtype=torch.int32, device=dev)[inst]
        closer = hit & (t > 0.0) & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best_prim = torch.where(closer, prim_ids, best_prim)
        best_n = torch.where(closer[..., None], n, best_n)
    return Hit(t=best_t, prim=best_prim, normal=face_forward(best_n, -dirs))


@torch.no_grad()
def old_trace_any(scene, origins, dirs, times, tmax):
    """trace_any as the port ran it before kernel K5a (the kept copy, as
    ``old_trace_closest``)."""
    from tinsel_tpu_torch.accel.sweep import mesh_partition
    from tinsel_tpu_torch.accel.traverse import intersect_mesh_any
    from tinsel_tpu_torch.geometry.intersect import intersect_ray_plane, intersect_ray_sphere
    from tinsel_tpu_torch.render.trace import (
        _instance_box_entry, _local_rays, _prim_transforms_batched)

    r, dev = origins.shape[0], origins.device
    occ = torch.zeros((r,), dtype=torch.bool, device=dev)
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=dev)
    tiny_groups, big, spheres, planes = mesh_partition(scene.prim_static)
    if big:
        fail("old_trace_any: the kept copy has no big-mesh batch")
    if spheres:
        sel = torch.as_tensor(spheres, dtype=torch.long, device=dev)
        tr_b = _prim_transforms_batched(scene, spheres, times)
        hit, t, _ = intersect_ray_sphere(tr_b.p, scene.prims.radius[sel][:, None] * tr_b.s,
                                         origins[None, :, :], dirs[None, :, :])
        occ = occ | (hit & (t > 0.0) & (t < tmax[None, :])).any(dim=0)
    if planes:
        sel = torch.as_tensor(planes, dtype=torch.long, device=dev)
        hit, t, _ = intersect_ray_plane(scene.prims.plane[sel][:, None, :],
                                        origins[None, :, :], dirs[None, :, :])
        occ = occ | (hit & (t > 0.0) & (t < tmax[None, :])).any(dim=0)
    for idxs in tiny_groups.values():
        handles = [scene.prim_static[i].mesh for i in idxs]
        n_inst = len(idxs)
        _, o_l, d_l = _local_rays(scene, idxs, origins, dirs, times)
        tmax_r = torch.where(occ, 0.0, tmax)
        tmax_b = torch.broadcast_to(tmax_r[None, :], (n_inst, r))
        may_hit, _ = _instance_box_entry(handles, o_l, d_l, tmax_b)
        tm = torch.where(may_hit, tmax_b, 0.0).reshape(n_inst * r)
        oc = intersect_mesh_any(scene.pool, handles[0].node_offset, handles[0].tri_offset,
                                o_l.reshape(n_inst * r, 3), d_l.reshape(n_inst * r, 3), tm,
                                num_tris=handles[0].real_tris)
        occ = occ | oc.reshape(n_inst, r).any(dim=0)
    return occ


def trace_ab_phase(dev):
    """K5's A/B in one run (item 5 of the module docstring): a
    trace_closest and a trace_any call of a Cornell pass (512x512, 4 spp:
    1M rays a call; 5 planes, 2 spheres and the 2-triangle light) through
    the kept torch-op copy (``old_trace_closest`` / ``old_trace_any``) and
    through kernels K5c / K5a, in turns (old, new, new, old): device ms and
    launches from the profiler, the sweep kernels' device ms from CUDA
    events around each launch (``sweep_spans``, a run of its own) beside
    the profiler's record of them, the call's wall ms under CUDA events,
    the sweep kernels' launches as their wrappers count them; then one
    whole Cornell pass each way, its launches and idle share (profiled,
    no spin kernel inside the profiled run); then ``profiler_probe`` on
    the trace_any call."""
    from tinsel_tpu_torch.core.sampling import PathUniforms
    from tinsel_tpu_torch.render import integrator, lights, trace
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.render.renderer import make_render_pass
    from tinsel_tpu_torch.scene.presets import cornell_scene

    def one_pass(sc):
        flat, cam = sc.flatten(dev), CameraParams.from_host(sc.camera, dev)
        spp = spp_per_pass(4)
        with torch.no_grad():
            make_render_pass(sc.options, spp)(flat, cam, PathUniforms(9, dev))
        return flat

    def timed(fn, args, kw):
        prof = profiled(lambda: fn(*args, **kw))
        with torch.no_grad():
            fn(*args, **kw)
            wall = _event_ms(lambda: fn(*args, **kw), 1)
        return dict(device_ms=prof["device_ms"], launches=prof["launches"],
                    sweep_launches_counted=prof["profiled_run_counted"],
                    sweep_launches=prof["sweep_launches"],
                    sweep_device_ms=prof["sweep_device_ms"],
                    profiler_sweep_launches=prof["profiler_sweep_launches"],
                    profiler_sweep_device_ms=prof["profiler_sweep_device_ms"],
                    wall_ms=wall, profiled_wall_ms=prof["profiled_wall_ms"])

    recs = {}
    sc = cornell_scene(BIG_W, BIG_H, 4)
    box = {}
    calls = capture_calls(((integrator, "trace_closest"), (lights, "trace_any")),
                          lambda: box.setdefault("flat", one_pass(sc)))
    for name, old, new in (("trace_closest", old_trace_closest, trace.trace_closest),
                           ("trace_any", old_trace_any, trace.trace_any)):
        args, kw = calls[name][1 if name == "trace_closest" else 0]
        with torch.no_grad():
            a, b = old(*args, **kw), new(*args, **kw)
        if name == "trace_closest":
            same = float((a.prim == b.prim).float().mean())
            close = torch.isclose(a.t, b.t, rtol=KERNEL_TOL, atol=KERNEL_TOL)
            t_share = float((close | (a.prim != b.prim)).float().mean())
            fin = torch.isfinite(a.t) & torch.isfinite(b.t)
            dt = float((a.t - b.t)[fin].abs().max())
        else:
            same, t_share, dt = float((a == b).float().mean()), 1.0, 0.0
        runs = [("torch ops", timed(old, args, kw)), ("K5", timed(new, args, kw)),
                ("K5", timed(new, args, kw)), ("torch ops", timed(old, args, kw))]
        rec = dict(phase="trace_ops", what=f"K5 A/B cornell {name}",
                   call="bounce 1" if name == "trace_closest" else "bounce 0",
                   rays=args[1].shape[0], runs=runs, winners_equal_share=same,
                   t_within_tol_share=t_share, max_abs_dt=dt, calls_per_pass=len(calls[name]))
        emit(rec)
        recs[f"K5 {name}"] = rec
        # the two paths round differently (the copy sums its dot products
        # with torch.sum, the sweep component by component): a winner may
        # flip at an exact tie and a grazing sphere hit's t moves by its
        # conditioning, on a few lanes in 10,000 at most
        if same < 0.9999 or t_share < 0.9999:
            fail(f"K5 A/B {name}: the two paths disagree ({same}, {t_share}, {dt})")
        if any(r["sweep_launches_counted"] != dict(sweep_closest=int(name == "trace_closest"),
                                                    sweep_any=int(name == "trace_any"))
               for how, r in runs if how == "K5"):
            fail(f"K5 A/B {name}: a call through K5 did not launch its sweep kernel once")
        if name == "trace_any":
            recs["profiler probe"] = profiler_probe(lambda: new(*args, **kw))
    del calls

    def pass_record(how):
        if how == "torch ops":
            integrator.trace_closest, lights.trace_any = old_trace_closest, old_trace_any
        try:
            prof = profiled(lambda: one_pass(sc))
        finally:
            integrator.trace_closest, lights.trace_any = trace.trace_closest, trace.trace_any
        return how, dict(prof, idle_share=1.0 - prof["device_ms"] / prof["profiled_wall_ms"])

    one_pass(sc)
    runs = [pass_record(h) for h in ("K5", "torch ops", "torch ops", "K5")]
    rec = dict(phase="trace_ops", what="K5 A/B one cornell pass (512x512, 4 spp, depth 4)",
               runs=runs)
    emit(rec)
    recs["K5 pass"] = rec
    return recs


def profiler_probe(call, reps: int = 8) -> dict:
    """How often torch.profiler records the one sweep kernel of ``call``
    (a trace_any call: K5a is its only kernel) in a session of its own,
    ``reps`` sessions each way: cold (the call is the session's first
    device work) and warm (a spin kernel runs first in the session, as
    ``profiled`` does by default). The kernel's launches and device ms
    from CUDA events, in a run of the call's own after each session
    (``sweep_spans``), stand beside."""
    out = {}
    for how in ("cold", "warm"):
        runs = [profiled(call, warm=how == "warm") for _ in range(reps)]
        out[how] = dict(
            launches_by_events=sum(r["sweep_launches"] for r in runs),
            launches_recorded_by_profiler=sum(r["profiler_sweep_launches"] for r in runs),
            event_ms=[r["sweep_device_ms"] for r in runs],
            profiler_ms=[r["profiler_sweep_device_ms"] for r in runs])
    emit(dict(phase="trace_ops", what="profiler record of K5a, one trace_any call a session",
              sessions=reps, **out))
    return out


K6_SCENES = (("many_mesh", 2), ("instances16", 3), ("grid81", 3))  # (scene, depth)


def k6_call_record(args, kind: str, closest: bool, held: dict) -> dict:
    """K6c / K6a and the plain rounds on one call's arguments (K6's output
    already held, ``held``): K6's device ms by CUDA-graph replays and the
    plain version's by CUDA events, in turns plain, K6, K6, plain; K6's
    eager call ms; launches a call: K6's and the plain version's K3/K4 as
    the wrappers count them, the plain version's torch ops and their
    device ms under the profiler (which can miss a kernel launched
    through ctypes, so it counts none of those); the bound from the plain
    rounds' own walks."""
    from tinsel_tpu_torch.accel import instances as plain_rounds
    from tinsel_tpu_torch.ops import bvh as ops_bvh
    from tinsel_tpu_torch.ops import instances as ops_instances

    kernel = getattr(ops_instances, f"{kind}_cuda")
    plain_fn = getattr(plain_rounds, f"{kind}_world")
    rounds, walked, stats = plain_round_walks(ops_bvh, plain_fn, args, closest)
    inst, rays = len(args[1].prims), args[2].shape[0]
    bound_ms, bound_by = bound(rounds_work(args, walked, stats, closest))
    k6_ms, plain_ms = [], []
    with torch.no_grad():
        for turn in ("plain", "k6", "k6", "plain"):
            if turn == "plain":
                plain_ms.append(_event_ms(lambda: plain_fn(*args), 1))
            else:
                k6_ms.append(device_ms(kernel, [args]))
        k6_call_ms = call_ms(kernel, [args])
        walk = "bvh_closest" if closest else "bvh_any"
        before = {**ops_instances.launch_counts, walk: ops_bvh.launch_counts[walk]}
        kernel(*args)
        k6_launches = ops_instances.launch_counts[kind] - before[kind]
        prof_plain = profiled(lambda: plain_fn(*args))  # the plain version runs twice in it
        plain_walks = (ops_bvh.launch_counts[walk] - before[walk]) // 2
    if k6_launches != 1 or plain_walks != rounds:
        fail(f"K6 {kind}: {k6_launches} launches a call, the plain version {plain_walks} walks "
             f"in {rounds} rounds")
    kernel_ms = statistics.mean(k6_ms)
    return dict(
        phase="k6", kernel=kind, instances=inst, rays=rays, plain_rounds=rounds,
        walked_lanes=walked, kernel_ms=kernel_ms, kernel_ms_turns=k6_ms,
        kernel_call_ms=k6_call_ms, kernel_launches=k6_launches,
        plain_ms=statistics.mean(plain_ms), plain_ms_turns=plain_ms,
        plain_launches=prof_plain["launches"] - prof_plain["walk_launches"] + plain_walks,
        plain_torch_op_launches=prof_plain["launches"] - prof_plain["walk_launches"],
        plain_walk_launches=plain_walks, plain_device_ms=prof_plain["device_ms"],
        plain_walk_device_ms_profiled=prof_plain["walk_device_ms"],
        plain_walk_launches_profiled=prof_plain["walk_launches"],
        bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / kernel_ms,
        max_abs_err=held["max_abs_err"], mismatched=held["mismatched"], library_ms=None,
    )


def k6_scene(name: str, depth: int):
    from tinsel_tpu_torch.scene.presets import instances_scene, many_mesh_scene

    return {"many_mesh": lambda: many_mesh_scene(48, BIG_W, BIG_H, depth),
            "instances16": lambda: instances_scene(BIG_W, BIG_H, depth, grid=4),
            "grid81": lambda: instances_scene(BIG_W, BIG_H, depth, grid=9)}[name]()


def trace_ops_phase(dev, per_scene):
    """Phase 10, K6: the shortlist rounds of one 512x512 4-spp pass of
    many_mesh (48 meshes, 32 big), instances16 and the 81-instance grid,
    through ``make_render_pass``. The pass timed after a warm-up one, its
    K6 and K3/K4 launches counted (one K6c / K6a launch a rounds call, no
    K3 / K4); one more pass with every K6 launch captured and held against
    the plain rounds on its own inputs (``hold_rounds``). On every rounds
    call of that pass (one a bounce and form): K6's device ms (CUDA-graph
    replays) and the plain version's ms (CUDA events; it syncs the host
    each round), in turns plain, K6, K6, plain; each one's launches and
    device ms under the profiler and K6's eager call ms; the bound
    (``rounds_work``, from the plain rounds' own walks,
    ``plain_round_walks``). many_mesh also: its whole bounce-0
    trace_closest and trace_any calls under the profiler, with the memory
    each allocates at its peak (``whole_trace_calls``). Returns (records
    by kernel, holds by scene, launches of the timed passes)."""
    from tinsel_tpu_torch.core.sampling import PathUniforms
    from tinsel_tpu_torch.ops import bvh as ops_bvh
    from tinsel_tpu_torch.ops import instances as ops_instances
    from tinsel_tpu_torch.render import integrator, lights
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.render.renderer import make_render_pass

    recs = {"rounds_closest": [], "rounds_any": []}
    held_all = {}
    launches = {"rounds_closest": 0, "rounds_any": 0}
    for name, depth in K6_SCENES:
        sc = k6_scene(name, depth)
        flat, cam = sc.flatten(dev), CameraParams.from_host(sc.camera, dev)
        spp = spp_per_pass(4)
        run = make_render_pass(sc.options, spp)
        src = PathUniforms(9, dev)
        with torch.no_grad():
            run(flat, cam, src)  # warm-up
            torch.cuda.synchronize()
            ops_instances.reset_launch_counts()
            ops_bvh.reset_launch_counts()
            t0 = time.perf_counter()
            run(flat, cam, src)
            torch.cuda.synchronize()
            pass_ms = (time.perf_counter() - t0) * 1e3
            counted = {**ops_instances.launch_counts,
                       **{k: ops_bvh.launch_counts[k] for k in ("bvh_closest", "bvh_any")}}
            outs = {}
            targets = [(ops_instances, "rounds_closest"), (ops_instances, "rounds_any")]
            if name == "many_mesh":
                targets += [(integrator, "trace_closest"), (lights, "trace_any")]
            calls = capture_calls(targets, lambda: run(flat, cam, src), outs)
        held = held_all[name] = hold_rounds(calls, outs)
        del outs
        want = {"bvh_closest": 0, "bvh_any": 0, "bvh_frames": 0,
                **{k: held[k]["calls"] for k in ("rounds_closest", "rounds_any")}}
        emit(dict(phase="k6_pass", scene=f"{name} {BIG_W}x{BIG_H} d{depth} {spp}spp",
                  pass_ms=pass_ms, ms_per_spp=pass_ms / spp,
                  ms_per_spp_bigmesh_path=per_scene.get(name, {}).get("ms_per_spp"),
                  launches=counted, expected=want, held=held))
        if counted != want or not held["rounds_closest"]["calls"]:
            fail(f"K6 {name}: launches {counted} in a pass, expected {want}")
        for k in launches:
            launches[k] += counted[k]
        if name == "many_mesh":
            # the whole trace calls of bounce 0 around the rounds (the
            # sweep, the refit of the winner)
            for rec in whole_trace_calls(calls):
                emit(rec)
        for kind, closest in (("rounds_closest", True), ("rounds_any", False)):
            for i, (args, _) in enumerate(calls[kind]):
                rec = k6_call_record(args, kind, closest, held[kind])
                rec.update(scene=f"{name} {BIG_W}x{BIG_H} d{depth}",
                           shape=f"{name} call {i + 1} of {len(calls[kind])} a pass")
                emit(rec)
                recs[kind].append(rec)
        del calls
    return recs, held_all, launches

# ----------------------------------------------------------- K10: frames

FRAMES_REPS = 50  # K10 launches timed a call (a median of them)


def frames_per_walk(launches: dict, what: str, some: bool = True):
    """Scenes of at most INSTANCE_TOPK_MIN big instances: one K10 launch
    ahead of each K3 / K4 launch; with ``some``, at least one."""
    walks = launches["bvh_closest"] + launches["bvh_any"]
    if launches["bvh_frames"] != walks or (some and not walks):
        fail(f"{what}: {launches['bvh_frames']} K10 launches for {walks} K3 / K4 launches")


def frames_args(args):
    """A captured ``ops/instances.py::frames`` call's arguments as the
    kernel takes them (``frames``' own broadcast of times and tmax): (scene,
    table, origins, dirs, times, tmax, occ or None)."""
    scene, tab, o, d, times, tmax, *occ = args
    r = o.shape[0]
    times, tmax = (torch.broadcast_to(torch.as_tensor(x, dtype=torch.float32, device=o.device),
                                      (r,)).contiguous() for x in (times, tmax))
    return scene, tab, o.contiguous(), d.contiguous(), times, tmax, occ[0] if occ else None


def frames_bytes(tab, rays: int, occ) -> int:
    """Device-memory bytes of one K10 launch: a ray's origin, direction and
    bound in (28 B), its time where the table moves (4 B), its occlusion
    flag in the any-hit form (1 B); a lane's local origin and direction,
    bound and two offsets out (36 B) for each of the I instances; the
    instance table once."""
    per_ray = 28 + (4 if tab.motion else 0) + (1 if occ is not None else 0)
    return rays * (per_ray + 36 * len(tab.prims)) + tab.table.numel() * 4


def spun_ms(fn, arg_sets, reps: int = FRAMES_REPS) -> float:
    """Median device ms of one ``fn`` call: CUDA events around it behind a
    spin kernel, so the card is still busy when the host reaches the
    launch and the pair times the kernel, not the host's dispatch; the
    calls cycle through ``arg_sets``, the first one a warm-up."""
    spans = []
    for i in range(reps + 1):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        for e in (start, end):  # created (at their first record) before the spin
            e.record()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn(*arg_sets[i % len(arg_sets)])
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in spans[1:])


def same_bits(a, b) -> bool:
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def frames_phase(dev) -> list:
    """K10 on the main path's inputs: the first ``ops/instances.py::
    frames`` call of each form (closest hit; any hit, with the occluded
    rays) in one 512x512 4-spp pass (1M rays) of the probe-lit envmesh
    (one big instance) and of ``many_mesh_scene(18)`` (12 spheres and
    capsules: the batch's most, INSTANCE_TOPK_MIN). Each held against the
    plain version (``accel/instances.py::frames``) on the same inputs,
    every output bit for bit, with one counted launch; K10's device ms
    (``spun_ms``) against its byte bound (``frames_bytes``), beside the
    plain version's ms (CUDA events, ``call_ms``). Returns the records."""
    from tinsel_tpu_torch.accel import instances as plain_instances
    from tinsel_tpu_torch.core.sampling import PathUniforms
    from tinsel_tpu_torch.ops import instances as ops_instances
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.render.renderer import make_render_pass
    from tinsel_tpu_torch.scene.presets import many_mesh_scene

    recs = []
    for tag, sc in (("envmesh probe", probe_scene()),
                    ("many_mesh 18", many_mesh_scene(18, BIG_W, BIG_H, 2))):
        flat, cam = sc.flatten(dev), CameraParams.from_host(sc.camera, dev)
        run = make_render_pass(sc.options, spp_per_pass(4))
        with torch.no_grad():
            calls = capture_calls(((ops_instances, "frames"),),
                                  lambda: run(flat, cam, PathUniforms(11, dev)))["frames"]
            for form in ("closest", "any"):
                found = [frames_args(a) for a, _ in calls if (len(a) > 6) == (form == "any")]
                if not found:
                    fail(f"K10 {tag}: no {form}-hit frames call in a pass")
                scene, tab, o, d, times, tmax, occ = args = found[0]
                r, n_inst = o.shape[0], len(tab.prims)
                before = ops_instances.launch_counts["bvh_frames"]
                got = ops_instances.frames_cuda(*args)
                want = plain_instances.frames(*args)
                torch.cuda.synchronize()
                if ops_instances.launch_counts["bvh_frames"] != before + 1:
                    fail(f"K10 {tag} {form}: the wrapper did not count its one launch")
                differ = [k for k, g, w in zip(want._fields, got, want) if not same_bits(g, w)]
                nbytes = frames_bytes(tab, r, occ)
                tensors = [t for t in (o, d, times, tmax, occ) if t is not None]
                sets = [(scene, tab, *c) for c in copies(tensors, nbytes)]
                kernel_ms = spun_ms(ops_instances.frames_cuda, sets)
                plain_ms = call_ms(plain_instances.frames, sets)
                bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
                rec = dict(phase="frames", kernel="bvh_frames", form=form,
                           shape=f"{tag}, {r} rays x {n_inst} instances", instances=n_inst,
                           rays=r, moving=bool(tab.motion), outputs_differing=differ,
                           max_abs_err=0.0, kernel_ms=kernel_ms, plain_ms=plain_ms,
                           bytes_per_ray=nbytes / r, bound_ms=bound_ms, bound_by="bytes",
                           bound_share=bound_ms / kernel_ms, launches=1, library_ms=None)
                emit(rec)
                if differ:
                    fail(f"K10 {tag} {form}: {differ} differ from the plain version")
                recs.append(rec)
                del got, want, sets, found, args
        del calls
    return recs


def peak_alloc_mib(call) -> float:
    """MiB of device memory that ``call`` allocates beyond what was
    allocated before it, at its peak (``max_memory_allocated``)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def whole_trace_calls(calls) -> list:
    """The first trace_closest and trace_any call of a pass (bounce 0:
    the camera rays and the first shadow rays), captured by
    ``capture_calls`` as ``integrator.trace_closest`` / ``lights.trace_any``,
    each run again whole: its device ms and launches under the profiler
    (``profiled``; the walks' share, K6 among them, in walk_device_ms) and
    the memory it allocates at its peak (``peak_alloc_mib``), all under
    no_grad as a render pass runs them."""
    from tinsel_tpu_torch.render import trace

    out = []
    for name in ("trace_closest", "trace_any"):
        args, kw = calls[name][0]
        fn = getattr(trace, name)
        with torch.no_grad():
            fn(*args, **kw)  # warm: the tables of the scene packed
            peak = peak_alloc_mib(lambda: fn(*args, **kw))
        rec = profiled(lambda: fn(*args, **kw))
        out.append(dict(phase="k6", what=f"many_mesh {name} bounce 0 (whole call)",
                        rays=args[1].shape[0], peak_alloc_mib=peak, **rec))
    return out


# ------------------------------------------------------------- scene files


def scene_file_paths():
    """Every scene file of the repository that needs no asset from
    outside it."""
    scenes = ROOT / "scenes"
    tins = [p for p in sorted(scenes.glob("*.tin")) if p.stem not in EXTERNAL_ASSET_SCENES]
    return (tins + sorted(scenes.glob("*.json"))
            + [ROOT / "tests" / "data" / f"{n}_parity.tin" for n in ("cornell", "glass")])


def load_scene_file(path):
    from tinsel_tpu_torch.scene.loaders.tin import load_tin
    from tinsel_tpu_torch.scene.loaders.tungsten import load_tungsten

    return (load_tungsten if path.suffix == ".json" else load_tin)(str(path))


def mesh_triangles(sc):
    return [len(p.mesh.indices) for p in sc.primitives if p.mesh is not None]


def accumulate(sc, flat, cam, spp: int, dev, seed: int = 0):
    """``spp`` samples of the scene's own options in passes of about 1M
    rays, as ``render`` takes them: (accumulation buffer, seconds, passes)."""
    from tinsel_tpu_torch.core.sampling import PathUniforms
    from tinsel_tpu_torch.render.renderer import make_accumulate_fn

    o = sc.options
    spp_pass = spp_per_pass(spp, o.width, o.height)
    if spp % spp_pass:
        fail(f"{spp} spp do not split into passes of {spp_pass}")
    step = make_accumulate_fn(o, spp_pass)
    source = PathUniforms(seed, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    accum = torch.zeros((o.height, o.width, 4), device=dev)
    for c in range(spp // spp_pass):
        accum = step(accum, flat, cam, source, c)
    torch.cuda.synchronize()
    return accum, time.perf_counter() - t0, spp // spp_pass


def equal_draws_small(sc, w: int, h: int, depth: int, what: str, dev):
    """The scene at w x h and depth min(its own, depth), 1 spp, on the card
    and on the CPU at equal draws (``compare_renders``)."""
    from tinsel_tpu_torch.core.sampling import NumpyUniforms
    from tinsel_tpu_torch.render.renderer import render

    small = dataclasses.replace(sc, options=dataclasses.replace(
        sc.options, width=w, height=h, max_depth=min(sc.options.max_depth, depth)))
    a, b = (render(small, spp=1, device=d, source=NumpyUniforms(7, d))
            for d in (dev, torch.device("cpu")))
    compare_renders(a, b, what)


def scene_files_phase(ops_bvh, dev):
    """Each scene file: load (the mesh cache cold), flatten on the card,
    then SCENE_FILE_SPP spp at the file's own width, height and maxDepth
    with K3/K4 counts reset just before the renders and read just after;
    the image finite with a nonzero mean; no file has more than
    INSTANCE_TOPK_MIN big meshes, so K6 is counted and never launched.
    Then veach_mis.json (the knob's 2,208 triangles through K3/K4) on the
    card against the CPU at equal draws, 64x64 depth 4. Returns the
    renders' K3/K4 (and K6) launches."""
    from tinsel_tpu_torch.core.color import resolve
    from tinsel_tpu_torch.ops import instances as ops_instances
    from tinsel_tpu_torch.render.camera import CameraParams

    loaded = {}
    for path in scene_file_paths():
        t0 = time.perf_counter()
        sc = load_scene_file(path)
        t1 = time.perf_counter()
        flat, cam = sc.flatten(dev), CameraParams.from_host(sc.camera, dev)
        torch.cuda.synchronize()
        loaded[path.name] = (sc, flat, cam, t1 - t0, time.perf_counter() - t1)
    if 2208 not in mesh_triangles(loaded["veach_mis.json"][0]):
        fail("veach_mis.json: the knob (2,208 triangles) did not load")

    ops_bvh.reset_launch_counts()
    ops_instances.reset_launch_counts()
    kinds = ("bvh_closest", "bvh_any", "rounds_closest", "rounds_any", "bvh_frames")
    per = {}
    for name, (sc, flat, cam, load_s, flatten_s) in loaded.items():
        before = {**ops_bvh.launch_counts, **ops_instances.launch_counts}
        accum, secs, passes = accumulate(sc, flat, cam, SCENE_FILE_SPP, dev)
        mean = float(resolve(accum).mean())
        if not bool(torch.isfinite(accum).all()) or not mean > 0:
            fail(f"scene file {name}: the image is not finite or is black (mean {mean})")
        o = sc.options
        per[name] = dict(
            size=f"{o.width}x{o.height}", depth=o.max_depth, triangles=sum(mesh_triangles(sc)),
            load_s=load_s, flatten_s=flatten_s, passes=passes,
            ms_per_spp=secs * 1e3 / SCENE_FILE_SPP, image_mean=mean,
            launches={k: {**ops_bvh.launch_counts, **ops_instances.launch_counts}[k] - before[k]
                      for k in kinds})
    launches = {k: {**ops_bvh.launch_counts, **ops_instances.launch_counts}[k] for k in kinds}
    emit(dict(phase="scene_files", spp=SCENE_FILE_SPP, files=len(per), scenes=per,
              launches=launches))
    if min(launches["bvh_closest"], launches["bvh_any"]) < 1:
        fail(f"scene files: a BVH kernel was never launched: {launches}")
    if launches["rounds_closest"] or launches["rounds_any"]:
        fail(f"scene files: K6 launched, but no file has more than INSTANCE_TOPK_MIN big "
             f"meshes: {launches}")
    for name, rec in per.items():
        frames_per_walk(rec["launches"], f"scene file {name}", some=False)
    frames_per_walk(launches, "scene files")
    equal_draws_small(loaded["veach_mis.json"][0], 64, 64, 4, "veach_mis.json 64x64 d4 1spp", dev)
    return launches


def perlin_sphere(detail: int):
    """envmesh's Perlin-displaced sphere (``presets.envmesh_scene``,
    2 * detail^2 triangles) as (positions, indices), not built."""
    from tinsel_tpu_torch.scene.procedural import sphere
    from tinsel_tpu_torch.utils.perlin import fractal3d

    m = sphere(radius=0.8, n_theta=detail, n_phi=detail)
    p = m.positions
    disp = np.asarray(fractal3d(p[:, 0] * 3.0, p[:, 1] * 3.0, p[:, 2] * 3.0, octaves=4),
                      np.float32)
    r = np.linalg.norm(p, axis=-1, keepdims=True)
    pos = (p / np.maximum(r, 1e-9)) * (0.8 + 0.18 * disp[:, None]).astype(np.float32)
    return pos.astype(np.float32), m.indices


def probe_image(w: int, h: int):
    """A lat-long sky of w x h: a gradient from horizon to zenith, a sun
    disc of radiance 2,000, a darker, grainy ground and seeded cloud
    noise in 8x8 blocks."""
    rng = np.random.default_rng(5)
    v = (np.arange(h, dtype=np.float32)[:, None] + 0.5) / h  # 0 = up
    u = (np.arange(w, dtype=np.float32)[None, :] + 0.5) / w
    up = np.clip(1.0 - 2.0 * v, 0.0, 1.0)
    sky = (np.array([0.9, 0.85, 0.75], np.float32) * (1 - up)[..., None]
           + np.array([0.25, 0.4, 0.75], np.float32) * up[..., None])
    img = np.broadcast_to(sky, (h, w, 3)).copy()
    img[v[:, 0] > 0.5] *= 0.3
    cloud = np.repeat(np.repeat(rng.random((h // 8, w // 8)), 8, 0), 8, 1)[:h, :w]
    img *= (0.8 + 0.4 * cloud)[..., None].astype(np.float32)
    # per-pixel grain on the ground: literal spans in the RLE scanlines
    img[h // 2:] *= (0.9 + 0.2 * rng.random((h - h // 2, w, 1))).astype(np.float32)
    sun = ((u - 0.3) ** 2 * 4 + (v - 0.2) ** 2) < 0.02 ** 2
    img[sun] = 2000.0
    return img.astype(np.float32)


def write_rle_hdr(path, img):
    """A Radiance .hdr of ``img`` with new-style RLE scanlines (a run of 3
    to 127 equal bytes as 128 + n and the byte, else literals of up to 128
    bytes), RGBE quantized as ``io/hdr.py::save_hdr`` does. Returns the
    (H, W, 4) RGBE bytes."""
    img = np.maximum(np.asarray(img, np.float32), 0.0)
    h, w = img.shape[:2]
    maxc = img.max(axis=-1)
    nz = maxc > 1e-32
    m, ex = np.frexp(maxc)
    scale = np.where(nz, m * 256.0 / np.maximum(maxc, 1e-32), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, ex + 128, 0).astype(np.uint8)
    out = bytearray(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode())
    for y in range(h):
        out += bytes((2, 2, w >> 8, w & 255))
        for c in range(4):
            row = rgbe[y, :, c]
            # starts of the runs of equal bytes
            starts = np.flatnonzero(np.r_[True, row[1:] != row[:-1]]).tolist() + [w]
            lit = []
            for a, b in zip(starts[:-1], starts[1:]):
                n = b - a
                if n < 3:
                    lit.extend(row[a:b].tolist())
                    continue
                for i in range(0, len(lit), 128):
                    out += bytes((len(lit[i:i + 128]),)) + bytes(lit[i:i + 128])
                lit = []
                while n > 0:
                    k = min(n, 127)
                    if k < 3:  # a tail too short for a run
                        out += bytes((k,)) + bytes([int(row[a])] * k)
                    else:
                        out += bytes((128 + k, int(row[a])))
                    n -= k
            for i in range(0, len(lit), 128):
                out += bytes((len(lit[i:i + 128]),)) + bytes(lit[i:i + 128])
    Path(path).write_bytes(bytes(out))
    return rgbe


def flats_equal(a, b) -> bool:
    """Two flattened scenes (or parts of one) equal: tensors bit for bit
    (node rows hold NaN-packed empty boxes)."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return type(a) is type(b) and all(
            flats_equal(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a))
    if torch.is_tensor(a):
        return (torch.is_tensor(b) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.reshape(-1).contiguous().view(torch.uint8),
                                b.reshape(-1).contiguous().view(torch.uint8)))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(flats_equal(x, y) for x, y in zip(a, b))
    return a == b


def ajaxenv_files_phase(ops_bvh, dev, tmp: Path):
    """scenes/ajaxenv.tin with stand-ins for its two assets (written into
    ``tmp``), through the port's loaders at real size; see the module
    docstring, item 12. Returns the render's K3/K4 and K10 launches."""
    from tinsel_tpu_torch.accel.build import build_wide_bvh
    from tinsel_tpu_torch.core.color import resolve
    from tinsel_tpu_torch.io.hdr import load_hdr
    from tinsel_tpu_torch.ops import instances as ops_instances
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.scene.loaders import mesh_io
    from tinsel_tpu_torch.scene.loaders.tin import load_tin
    from tinsel_tpu_torch.scene.probe_io import load_probe

    # the stand-ins
    t0 = time.perf_counter()
    pos, idx = perlin_sphere(AJAXENV_DETAIL)
    ply = tmp / "igea_standin.ply"
    mesh_io.save_ply(str(ply), pos, idx)
    t1 = time.perf_counter()
    hdr = tmp / "loft_standin.hdr"
    rgbe = write_rle_hdr(hdr, probe_image(PROBE_W, PROBE_H))
    t2 = time.perf_counter()
    text = (ROOT / "scenes" / "ajaxenv.tin").read_text()
    for old, new in (("../../reference/data/meshes/igea.ply", ply),
                     ("../../reference/data/probes/loft.hdr", hdr)):
        if text.count(old) != 1:
            fail(f"ajaxenv.tin no longer names {old} once")
        text = text.replace(old, str(new))
    tin = tmp / "ajaxenv.tin"
    tin.write_text(text)

    # the cold import step by step, as import_mesh takes it
    s0 = time.perf_counter()
    m = mesh_io.import_ply(str(ply))
    s1 = time.perf_counter()
    m.normalize()
    s2 = time.perf_counter()
    m.calculate_normals()
    m.rebuild_cdf()
    s3 = time.perf_counter()
    m.rebuild_bvh()
    s4 = time.perf_counter()
    wide = build_wide_bvh(m.bvh)
    s5 = time.perf_counter()
    mesh_io.save_mesh_cache(str(tmp / "steps.npz"), m)
    s6 = time.perf_counter()
    cold_steps = dict(ply_parse_s=s1 - s0, normalize_s=s2 - s1, normals_and_cdf_s=s3 - s2,
                      native_sah_build_s=s4 - s3, wide_collapse_s=s5 - s4,
                      cache_write_s=s6 - s5)

    # the scene file: cold (imports the PLY, writes the cache), then warm
    t3 = time.perf_counter()
    cold = load_tin(str(tin))
    t4 = time.perf_counter()
    warm = load_tin(str(tin))
    t5 = time.perf_counter()
    probe = load_probe(str(hdr))
    t6 = time.perf_counter()
    tris = mesh_triangles(cold)
    if len(idx) not in tris or mesh_triangles(warm) != tris:
        fail(f"ajaxenv stand-in: the {len(idx)}-triangle mesh did not load: {tris}")
    big = next(p.mesh for p in cold.primitives if p.mesh is not None and len(p.mesh.indices) == len(idx))
    for f in ("lower", "upper", "left", "right", "leaf", "count", "perm"):
        if not np.array_equal(getattr(big.bvh, f), getattr(m.bvh, f)):
            fail(f"ajaxenv stand-in: the loaded tree's {f} differs from the step-by-step import")
    if not np.array_equal(load_hdr(str(hdr)), _rgbe_to_float_ref(rgbe)):
        fail("ajaxenv stand-in: the RLE probe does not decode to the bytes written")
    if cold.sky.probe is None or not np.array_equal(cold.sky.probe.data, probe.data):
        fail("ajaxenv stand-in: the scene's probe is not load_probe's")

    t7 = time.perf_counter()
    flat, cam = cold.flatten(dev), CameraParams.from_host(cold.camera, dev)
    torch.cuda.synchronize()
    t8 = time.perf_counter()
    flat_warm = warm.flatten(dev)
    if not flats_equal(flat, flat_warm):
        fail("ajaxenv stand-in: the warm (cached) import flattens to another scene")
    del flat_warm
    h = next(p.mesh for p in flat.prim_static if p.mesh is not None and p.mesh.real_tris == len(idx))
    emit(dict(phase="ajaxenv_files_setup", triangles=len(idx), nodes=h.num_nodes,
              wide_rows=int(wide.node_rows.shape[0]), stack_slots=h.stack_slots,
              probe=f"{PROBE_W}x{PROBE_H} rle", write_ply_s=t1 - t0, write_hdr_s=t2 - t1,
              cold_import_steps=cold_steps, cold_load_tin_s=t4 - t3, warm_load_tin_s=t5 - t4,
              load_probe_s=t6 - t5, flatten_s=t8 - t7, warm_flatten_equal=True))

    o = cold.options
    ops_bvh.reset_launch_counts()
    ops_instances.reset_launch_counts()
    accum, secs, passes = accumulate(cold, flat, cam, SCENE_FILE_SPP, dev)
    launches = {**{k: ops_bvh.launch_counts[k] for k in ("bvh_closest", "bvh_any")},
                "bvh_frames": ops_instances.launch_counts["bvh_frames"]}
    mean = float(resolve(accum).mean())
    if not bool(torch.isfinite(accum).all()) or not mean > 0:
        fail(f"ajaxenv stand-in: the image is not finite or is black (mean {mean})")
    if min(launches.values()) < 1:
        fail(f"ajaxenv stand-in: a BVH kernel was never launched: {launches}")
    frames_per_walk(launches, "ajaxenv stand-in")
    pass_ms = secs * 1e3 / passes
    emit(dict(phase="ajaxenv_files", scene=f"ajaxenv {o.width}x{o.height} d{o.max_depth}",
              spp=SCENE_FILE_SPP, passes=passes, render_s=secs,
              ms_per_spp=secs * 1e3 / SCENE_FILE_SPP, pass_ms=pass_ms, image_mean=mean,
              launches=launches))
    walks_in_pass(dev, {"ajaxenv": cold}, {"ajaxenv": (flat, cam)},
                  {"ajaxenv": {"pass_ms": pass_ms}},
                  entries=(("ajaxenv", o.max_depth, SCENE_FILE_SPP),),
                  phase="ajaxenv_walks_in_pass")
    del accum
    from tinsel_tpu_torch.core.sampling import PathUniforms
    from tinsel_tpu_torch.render import integrator
    from tinsel_tpu_torch.render.renderer import make_render_pass

    with torch.no_grad():
        traced = capture_calls(((integrator, "trace_closest"),), lambda: make_render_pass(
            o, 1)(flat, cam, PathUniforms(5, dev)))["trace_closest"]
    seam_count(flat, traced[:2], f"ajaxenv {o.width}x{o.height} bounces 0-1")
    del flat, traced
    equal_draws_small(cold, 32, 32, 4, "ajaxenv stand-in 32x32 d4 1spp", dev)
    return launches


# ----------------------------------------------------------- entry points

KERNEL_NAMES = ("nlm_filter", "nlm_guided", "bvh_closest", "bvh_any", "bvh_steps",
                "sweep_closest", "sweep_any", "rounds_closest", "rounds_any")
K6_NAMES = ("rounds_closest", "rounds_any")  # no entry point's scene is above INSTANCE_TOPK_MIN
CLI_LINE = re.compile(r"(\d+) spp in ([\d.]+)s \(([\d.]+) ms/spp, ([\d.]+) Mpaths/s\)")


def reset_counts(ops_nlm, ops_bvh):
    from tinsel_tpu_torch.ops import instances as ops_instances
    from tinsel_tpu_torch.ops import sweep as ops_sweep

    ops_nlm.reset_launch_counts()
    ops_bvh.reset_launch_counts()
    ops_sweep.reset_launch_counts()
    ops_instances.reset_launch_counts()


def read_counts(ops_nlm, ops_bvh) -> dict:
    from tinsel_tpu_torch.ops import instances as ops_instances
    from tinsel_tpu_torch.ops import sweep as ops_sweep

    counts = {**ops_nlm.launch_counts, **ops_bvh.launch_counts, **ops_sweep.launch_counts,
              **ops_instances.launch_counts}
    return {k: counts[k] for k in KERNEL_NAMES}


def cli_run(ops_nlm, ops_bvh, argv, guard: bool = False, capture=()):
    """One in-process CLI run, counts reset just before and read just
    after, stdout captured: (ChunkGuard or main's code, seconds up to a
    device sync, launches, the CLI's timing line as numbers, the run's
    calls of the functions in ``capture`` ((module, name) pairs, as
    ``capture_calls``) as ({name: [(args, kwargs)]}, {name: [out]})). The
    wrappers call through, so the launch counts are the run's own."""
    from tinsel_tpu_torch.app import cli

    def run():
        nonlocal out
        if guard:
            args = cli.build_parser().parse_args(argv)
            out = cli.render_one(cli.load_scene(args.scene), args, args.output)
        else:
            out = cli.main(argv)

    out, outs = None, {}
    torch.cuda.synchronize()
    reset_counts(ops_nlm, ops_bvh)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        calls = capture_calls(capture, run, outs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts(ops_nlm, ops_bvh)
    text = buf.getvalue()
    m = CLI_LINE.search(text)
    if m is None:
        fail(f"CLI {argv}: no timing line in its output:\n{text}")
    line = dict(spp=int(m[1]), s=float(m[2]), ms_per_spp=float(m[3]), mpaths_per_s=float(m[4]))
    if not guard and out != 0:
        fail(f"CLI {argv} returned {out}")
    return out, secs, launches, line, (calls, outs)


def need(launches: dict, what: str, launched=(), absent=()):
    if any(launches[k] < 1 for k in launched) or any(launches[k] for k in absent):
        fail(f"{what}: kernel launches {launches}; expected {list(launched)} launched, "
             f"{list(absent)} not")


def png_image(path) -> np.ndarray:
    from tinsel_tpu_torch.io.png import read_png

    if not Path(path).exists():
        fail(f"{path} was not written")
    return read_png(str(path))


def checkpoint_accum(path, what: str):
    from tinsel_tpu_torch.parallel.checkpoint import load_checkpoint

    a = load_checkpoint(str(path))[0]
    if not np.isfinite(a).all():
        fail(f"{what}: the accumulation buffer is not finite")
    return a


def hold_nlm(calls, outs, name, plain_fn, what) -> float:
    """Each call of the ops/nlm.py dispatcher ``name`` in a CLI run (the
    kernel's output) against ``plain_fn`` on the same inputs, within
    KERNEL_TOL; returns the largest error."""
    if not calls[name]:
        fail(f"{what}: {name} was not called")
    err = 0.0
    for (a, k), out in zip(calls[name], outs[name]):
        ref = plain_fn(*a, **k)
        if out.shape != ref.shape or not torch.isfinite(out).all():
            fail(f"{what}: {name} gave {tuple(out.shape)}, plain {tuple(ref.shape)}")
        err = max(err, float((out - ref).abs().max()))
    if not err <= KERNEL_TOL:
        fail(f"{what}: {name} differs from the plain version by {err}")
    return err


def hold_aovs(calls, want: dict, what):
    """The AOVs a CLI run gave K2 equal ``render_aovs`` on the same camera."""
    img, normal, albedo, depth = calls["nlm_guided_denoise"][0][0][:4]
    for name, t in (("normal", normal), ("albedo", albedo), ("depth", depth)):
        if not torch.equal(t, want[name]):
            fail(f"{what}: the {name} AOV given to K2 differs from render_aovs by "
                 f"{float((t - want[name]).abs().max())}")


def hold_steps(calls, outs, what) -> dict:
    """K7's per-lane steps in a CLI run against the plain count
    (``accel/traverse.py::traversal_cost``, tmax = +inf) on the same
    rays: equal on every lane."""
    from tinsel_tpu_torch.accel import traverse as plain_walk

    if not calls["traversal_steps"]:
        fail(f"{what}: traversal_steps was not called")
    lanes = mismatched = 0
    for (a, k), out in zip(calls["traversal_steps"], outs["traversal_steps"]):
        pool, noff, toff, o, d, slots = a
        inf = torch.full((o.shape[0],), float("inf"), device=o.device)
        ref = plain_walk.traversal_cost(pool, noff, toff, o, d, inf, stack_slots=slots)
        lanes += o.shape[0]
        mismatched += int((out != ref).sum())
    if mismatched:
        fail(f"{what}: K7 differs from the plain count on {mismatched} of {lanes} lanes")
    return dict(lanes=lanes, mismatched=mismatched)


def entry_points_phase(ops_nlm, ops_bvh, dev, tmp: Path):
    """Item 13 of the module docstring. Returns every kernel's launches
    summed over the phase's runs and the viewer."""
    from tinsel_tpu_torch.app import cli
    from tinsel_tpu_torch.core import color
    from tinsel_tpu_torch.io.hdr import load_pfm
    from tinsel_tpu_torch.parallel.checkpoint import save_checkpoint
    from tinsel_tpu_torch.render import nlm as plain
    from tinsel_tpu_torch.render.aov import render_aovs
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.render.renderer import render

    total = dict.fromkeys(KERNEL_NAMES, 0)
    k1 = ((ops_nlm, "nlm_denoise"),)
    k2 = ((ops_nlm, "nlm_guided_denoise"),)

    def record(run, secs, launches, **kw):
        for k in KERNEL_NAMES:
            total[k] += launches[k]
        emit(dict(phase="entry_points", run=run, seconds=secs, launches=launches, **kw))

    cornell = str(ROOT / "scenes" / "cornell.tin")
    # 1: -denoise -aov at the file's own size and depth; K1's output held
    # against the plain filter on the run's own image
    out = tmp / "cornell_cli.png"
    _, secs, launches, line, (calls, outs) = cli_run(
        ops_nlm, ops_bvh, [cornell, "-spp", str(ENTRY_SPP), "-denoise", "-aov", "-o", str(out)],
        capture=k1)
    need(launches, "cli -denoise", launched=("nlm_filter",), absent=("nlm_guided", *K6_NAMES))
    k1_err = hold_nlm(calls, outs, "nlm_denoise", plain.nlm_filter, "cli -denoise")
    img = png_image(out)
    if img.shape != (256, 256, 3) or not img.mean() > 5:
        fail(f"cli -denoise: the PNG is {img.shape}, mean {img.mean()}")
    sc = cli.load_scene(cornell)
    aov = render_aovs(sc.flatten(dev), CameraParams.from_host(sc.camera, dev), 256, 256)
    for name, t in aov.items():
        want = t.cpu().numpy()
        want = np.repeat(want, 3, axis=-1) if want.shape[-1] == 1 else want
        if not np.array_equal(load_pfm(str(tmp / f"cornell_cli_{name}.pfm")), want):
            fail(f"cli -aov: {name}.pfm differs from render_aovs")
    # the library on a scene already loaded: flatten and the accumulate
    # loop (the CLI's line times its loop alone; flatten timed apart)
    lib_sc = cli.load_scene(cornell)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lib_sc.flatten(dev)
    torch.cuda.synchronize()
    flatten_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lib = render(lib_sc, spp=ENTRY_SPP, device=dev)
    torch.cuda.synchronize()
    lib_s = time.perf_counter() - t0
    if not torch.isfinite(lib).all():
        fail("library render of cornell.tin is not finite")
    record("cli cornell.tin 256x256 d4 -denoise -aov", secs, launches, spp=ENTRY_SPP,
           cli_line=line, png_mean=float(img.mean()), aov_pfms_equal_render_aovs=True,
           k1_max_abs_err_vs_plain=k1_err, library_render_s=lib_s,
           library_ms_per_spp=lib_s * 1e3 / ENTRY_SPP, library_flatten_s=flatten_s)

    # 2: -denoise-guided; K2's output against the plain guided filter, its
    # AOVs against render_aovs
    out = tmp / "cornell_guided.png"
    _, secs, launches, line, (calls, outs) = cli_run(
        ops_nlm, ops_bvh, [cornell, "-spp", str(ENTRY_SPP), "-denoise-guided", "-o", str(out)],
        capture=k2)
    need(launches, "cli -denoise-guided", launched=("nlm_guided",),
         absent=("nlm_filter", *K6_NAMES))
    k2_err = hold_nlm(calls, outs, "nlm_guided_denoise", plain.nlm_guided, "cli -denoise-guided")
    hold_aovs(calls, aov, "cli -denoise-guided")
    img = png_image(out)
    record("cli cornell.tin -denoise-guided", secs, launches, spp=ENTRY_SPP, cli_line=line,
           png_mean=float(img.mean()), k2_max_abs_err_vs_plain=k2_err, aovs_equal_render_aovs=True)

    # 3: resume: A straight to 32 spp; B to 16, then resumed to 32
    a_ck, b_ck = tmp / "resume_a.npz", tmp / "resume_b.npz"
    runs = []
    for spp, ck, extra in ((32, a_ck, []), (16, b_ck, []), (32, b_ck, ["-resume"])):
        g, secs, launches, line, _ = cli_run(
            ops_nlm, ops_bvh, [cornell, "-spp", str(spp), "-checkpoint", str(ck),
                               "-checkpoint-every", "16", *extra, "-o", str(tmp / "resume.png")],
            guard=True)
        if g.events:
            fail(f"cli resume run {spp} spp {extra}: guard events {g.events}")
        runs.append(dict(spp=spp, resume=bool(extra), seconds=secs, cli_line=line))
        for k in KERNEL_NAMES:
            total[k] += launches[k]
    a, b = checkpoint_accum(a_ck, "resume A"), checkpoint_accum(b_ck, "resume B")
    bit_equal = bool(np.array_equal(a, b))
    rel = float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))
    if not bit_equal and rel > 1e-6:
        fail(f"cli resume: the resumed buffer differs from the uninterrupted one ({rel})")
    emit(dict(phase="entry_points", run="cli cornell.tin resume 16 -> 32 against 32",
              runs=runs, bit_equal=bit_equal, max_rel_diff=rel))

    # 4: veach_mis.json at its own size (K3/K4), no checkpoint in the timed
    # run: the buffer is the one the CLI resolves; a checkpoint write of it
    # timed apart. Then its complexity view (K7), K7's steps held against
    # the plain count on the run's own rays
    veach = str(ROOT / "scenes" / "veach_mis.json")
    _, secs, launches, line, (calls, _) = cli_run(
        ops_nlm, ops_bvh, [veach, "-spp", "4", "-o", str(tmp / "veach.png")],
        capture=((color, "resolve"),))
    need(launches, "cli veach_mis.json", launched=("bvh_closest", "bvh_any"), absent=K6_NAMES)
    acc = calls["resolve"][0][0][0]
    if tuple(acc.shape) != (720, 1280, 4) or not torch.isfinite(acc).all():
        fail(f"cli veach_mis.json: the buffer is {tuple(acc.shape)} or not finite")
    ck_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        save_checkpoint(str(tmp / "veach.npz"), acc, 4, 0)
        ck_s.append(time.perf_counter() - t0)
    record("cli veach_mis.json 1280x720 d6", secs, launches, spp=4, cli_line=line,
           image_mean=float(acc[..., :3].mean() / max(float(acc[..., 3].mean()), 1e-12)),
           checkpoint_write_s=ck_s)
    _, secs, launches, line, (calls, outs) = cli_run(
        ops_nlm, ops_bvh, [veach, "-mode", "complexity", "-checkpoint",
                           str(tmp / "veach_cx.npz"), "-checkpoint-every", "1",
                           "-o", str(tmp / "veach_cx.png")],
        capture=((ops_bvh, "traversal_steps"),))
    need(launches, "cli veach_mis.json -mode complexity", launched=("bvh_steps",),
         absent=K6_NAMES)
    steps = hold_steps(calls, outs, "cli veach_mis.json -mode complexity")
    acc = checkpoint_accum(tmp / "veach_cx.npz", "cli -mode complexity")
    record("cli veach_mis.json -mode complexity", secs, launches, spp=1, cli_line=line,
           image_mean=float(acc[..., :3].mean()), k7_vs_plain=steps)

    # 5: the ajaxenv stand-in of phase 12 at real size, guided denoise;
    # K2 at 500x500 against the plain guided filter, its AOVs against
    # render_aovs
    _, secs, launches, line, (calls, outs) = cli_run(
        ops_nlm, ops_bvh, [str(tmp / "ajaxenv.tin"), "-spp", "4", "-denoise-guided",
                           "-checkpoint", str(tmp / "ajaxenv.npz"), "-checkpoint-every", "4",
                           "-o", str(tmp / "ajaxenv.png")],
        capture=k2)
    need(launches, "cli ajaxenv stand-in", launched=("bvh_closest", "bvh_any", "nlm_guided"),
         absent=K6_NAMES)
    k2_err = hold_nlm(calls, outs, "nlm_guided_denoise", plain.nlm_guided, "cli ajaxenv stand-in")
    sc = cli.load_scene(str(tmp / "ajaxenv.tin"))
    hold_aovs(calls, render_aovs(sc.flatten(dev), CameraParams.from_host(sc.camera, dev),
                                 500, 500), "cli ajaxenv stand-in")
    checkpoint_accum(tmp / "ajaxenv.npz", "cli ajaxenv stand-in")
    img = png_image(tmp / "ajaxenv.png")
    if img.shape != (500, 500, 3) or not img.mean() > 1:
        fail(f"cli ajaxenv stand-in: the PNG is {img.shape}, mean {img.mean()}")
    record("cli ajaxenv stand-in 500x500 d64 -denoise-guided", secs, launches, spp=4,
           cli_line=line, png_mean=float(img.mean()), k2_max_abs_err_vs_plain=k2_err,
           aovs_equal_render_aovs=True)

    guard_on_card(dev, cornell)
    subprocess_run(tmp, cornell)
    viewer_launches = viewer_phase(ops_nlm, ops_bvh, dev)
    for k in KERNEL_NAMES:
        total[k] += viewer_launches[k]
    emit(dict(phase="entry_points_launches", launches=total))
    return total


def guard_on_card(dev, cornell: str):
    """The accumulate step of cornell.tin returns NaN on the first attempt
    of pass 1: the guard rolls back, reseeds and logs one event."""
    from tinsel_tpu_torch.app import cli
    from tinsel_tpu_torch.core.sampling import PathUniforms
    from tinsel_tpu_torch.parallel.failure import ChunkGuard
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.render.renderer import make_accumulate_fn

    sc = cli.load_scene(cornell)
    flat, cam = sc.flatten(dev), CameraParams.from_host(sc.camera, dev)
    step = make_accumulate_fn(sc.options, 16)
    seen = []

    def poisoned(accum, scene, cam, source, pass_idx):
        out = step(accum, scene, cam, source, pass_idx)
        seen.append(pass_idx)
        return out * float("nan") if seen == [0, 1] else out

    src = PathUniforms(0, dev)
    guard = ChunkGuard(retries=2, backoff_s=0.0)
    buf = io.StringIO()
    t0 = time.perf_counter()
    accum = torch.zeros((256, 256, 4), device=dev)
    plain = torch.zeros_like(accum)
    with contextlib.redirect_stdout(buf):
        for c in range(3):
            accum = guard.run(poisoned, accum, flat, cam, src, c, spp_done=16 * c)
            plain = step(plain, flat, cam, src, c)
    torch.cuda.synchronize()
    kinds = [e["kind"] for e in guard.events]
    if kinds != ["corrupt-chunk"] or seen != [0, 1, 1, 2]:
        fail(f"guard on the card: events {guard.events}, attempts {seen}")
    if not torch.isfinite(accum).all() or torch.equal(accum, plain):
        fail("guard on the card: the returned buffer is not finite or not reseeded")
    emit(dict(phase="entry_points", run="guard: NaN on pass 1, attempt 0", events=guard.events,
              attempts=seen, seconds=time.perf_counter() - t0,
              max_abs_diff_to_unretried=float((accum - plain).abs().max())))


def subprocess_run(tmp: Path, cornell: str):
    """``python -m tinsel_tpu_torch`` from the repository root."""
    out = tmp / "subprocess.png"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tinsel_tpu_torch", cornell, "-spp", "4",
                           "-o", str(out)], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    secs = time.perf_counter() - t0
    m = CLI_LINE.search(proc.stdout)
    if proc.returncode != 0 or m is None or not out.exists():
        fail(f"python -m tinsel_tpu_torch: exit {proc.returncode}\n{proc.stdout}\n{proc.stderr}")
    emit(dict(phase="entry_points", run="python -m tinsel_tpu_torch cornell.tin -spp 4",
              exit_code=proc.returncode, seconds=secs, cli_line=m[0]))


def http_get(url) -> bytes:
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def http_json(url):
    return json.loads(http_get(url))


def viewer_phase(ops_nlm, ops_bvh, dev):
    """The viewer on a 512x512 Cornell box in a thread: each denoise
    setting measured for VIEWER_WINDOW_S. Returns its launches."""
    from tinsel_tpu_torch.app.viewer import run_viewer
    from tinsel_tpu_torch.scene.presets import cornell_scene

    sc = cornell_scene(VIEWER_W, VIEWER_H, MAIN_DEPTH)
    chunk = max(1, min(16, (1 << 20) // (VIEWER_W * VIEWER_H)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    stop = threading.Event()
    reset_counts(ops_nlm, ops_bvh)
    buf = io.StringIO()
    thread = threading.Thread(target=run_viewer, args=(sc, sc.options), daemon=True,
                              kwargs=dict(port=port, stop_event=stop, device=dev))

    def until(ok, what):
        deadline = time.perf_counter() + VIEWER_DEADLINE_S
        while time.perf_counter() < deadline:
            try:
                st = http_json(f"{base}/status")
                if ok(st):
                    return st
            except OSError:
                pass
            time.sleep(0.02)
        stop.set()
        fail(f"viewer: no {what} within {VIEWER_DEADLINE_S} s")

    def window(setting):
        k0 = dict(ops_nlm.launch_counts)
        a = until(lambda st: st["denoise"] == setting and st["spp"] > 0, f"frame under {setting}")
        t0 = time.perf_counter()
        time.sleep(VIEWER_WINDOW_S)
        b = http_json(f"{base}/status")
        dt = time.perf_counter() - t0
        frames = (b["spp"] - a["spp"]) / chunk
        if frames < 1:
            fail(f"viewer: no frame in {VIEWER_WINDOW_S} s under {setting}")
        return dict(ms_per_spp=dt * 1e3 / (frames * chunk), frames_per_s=frames / dt,
                    status_ms_per_spp=b["ms_per_spp"],
                    launches={k: ops_nlm.launch_counts[k] - k0[k] for k in k0})

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        thread.start()
        try:
            until(lambda st: st["spp"] >= chunk, "first frame")
            first_s = time.perf_counter() - t0
            if b"tinsel-tpu" not in http_get(f"{base}/"):
                fail("viewer: the page is not the viewer's")
            if not http_get(f"{base}/frame.png").startswith(b"\x89PNG"):
                fail("viewer: /frame.png is not a PNG")
            per = {"off": window("off")}
            http_get(f"{base}/ctl?denoise=toggle")
            per["nlm"] = window("nlm")
            http_get(f"{base}/ctl?denoise=toggle")
            per["guided"] = window("guided")
            if per["nlm"]["launches"]["nlm_filter"] < 1 or per["guided"]["launches"]["nlm_guided"] < 1:
                fail(f"viewer: the denoise toggle did not launch K1 / K2: {per}")
            st = until(lambda st: st["spp"] >= 3 * chunk, "three frames")
            pos0 = st["cam_pos"]
            http_get(f"{base}/ctl?move=f")
            st2 = until(lambda s2: s2["spp"] < st["spp"], "restart after a camera move")
            if st2["cam_pos"] == pos0:
                fail("viewer: the fly camera did not move")
        finally:
            stop.set()
            thread.join(timeout=VIEWER_DEADLINE_S)
    if thread.is_alive():
        fail("viewer: the render thread did not stop")
    launches = read_counts(ops_nlm, ops_bvh)
    emit(dict(phase="entry_points", run=f"viewer cornell {VIEWER_W}x{VIEWER_H} d{MAIN_DEPTH}",
              spp_per_frame=chunk, first_frame_s=first_s, per_denoise=per,
              restart_seen=True, seconds=time.perf_counter() - t0, launches=launches))
    return launches


# ------------------------------------------------------------- multi-GPU

MG_W = MG_H = 512
MG_DEPTH = 4  # also the pipeline's stages: one a bounce
MG_PASSES = 2
MG_SEED = 21
MG_DEADLINE_S = 300.0  # each job's ranks, start-up included
# sharded against unsharded (tests/test_sharding.py:78, :98-104); the
# pipeline against path_trace on the same draws
SHARD_RTOL, SHARD_ATOL = 2e-5, 2e-6
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-4, 2e-3, 2e-5
PIPE_ATOL = 1e-5
ALLREDUCE_REPS = 20


def mg_scene(name: str, dev):
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.scene.presets import cornell_scene, envmesh_scene

    sc = (envmesh_scene(MG_W, MG_H, MG_DEPTH, probe=True) if name == "envmesh"
          else cornell_scene(MG_W, MG_H, MG_DEPTH))
    return sc.flatten(dev), CameraParams.from_host(sc.camera, dev)


def mg_sources(dev):
    from tinsel_tpu_torch.core.sampling import PathUniforms, Prefixed

    return [Prefixed(PathUniforms(MG_SEED, dev), j) for j in range(MG_PASSES)]


def mg_rays(cam):
    """The pixel centres' camera rays of the 512x512 image, times 0."""
    from tinsel_tpu_torch.render.camera import generate_rays

    dev = cam.position.device
    xs = torch.arange(MG_W, dtype=torch.float32, device=dev) + 0.5
    ys = torch.arange(MG_H, dtype=torch.float32, device=dev) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    o, d = generate_rays(cam, MG_W, MG_H, torch.stack([gx, gy], -1).reshape(-1, 2))
    return o, d, torch.zeros(MG_W * MG_H, device=dev)


def _flat_grads(gm, gc) -> dict:
    out = {}
    for prefix, obj in (("materials", gm), ("camera", gc)):
        for f in dataclasses.fields(obj):
            out[f"{prefix}.{f.name}"] = getattr(obj, f.name)
    return out


def _synced_s(run) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def hold_walk_calls(calls, outs) -> dict:
    """Each K3/K4 call a rank's render made, its output against the plain
    walk on the same inputs: no differing triangle or lane, |dt| within
    KERNEL_TOL."""
    from tinsel_tpu_torch.accel import traverse as plain

    rec = {}
    for name, walk in (("closest_hit", plain.intersect_mesh), ("any_hit", plain.intersect_mesh_any)):
        lanes = mismatched = 0
        err = 0.0
        for (a, k), out in zip(calls[name], outs.get(name, [])):
            pool, noff, toff, o, d, tmax, *slots = a  # the dispatchers' arguments
            slots = slots[0] if slots else k.get("stack_slots", plain.DEFAULT_STACK_SLOTS)
            ref = walk(pool, noff, toff, o, d, tmax, stack_slots=slots)
            lanes += o.shape[0]
            if name == "closest_hit":
                (t, tri), (t_ref, tri_ref) = out, ref
                mismatched += int((tri != tri_ref).sum())
                fin = torch.isfinite(t_ref)
                if not torch.equal(torch.isfinite(t), fin):
                    err = float("inf")
                elif bool(fin.any()):
                    err = max(err, float((t - t_ref)[fin].abs().max()))
            else:
                mismatched += int((out != ref).sum())
        rec[name] = dict(calls=len(calls[name]), lanes=lanes, mismatched=mismatched,
                         max_abs_err=err)
    return rec


def mg_task(task, dev, ops_bvh) -> tuple:
    """One task of a rank: (scalars, arrays)."""
    import torch.distributed as dist

    from tinsel_tpu_torch.ops import instances as ops_instances
    from tinsel_tpu_torch.parallel import pipeline, sharding

    kind = task["kind"]
    opts = dict(width=MG_W, height=MG_H, max_depth=MG_DEPTH)
    if kind == "allreduce":  # the 512^2 RGBA f32 buffer, 4 MiB
        buf = torch.ones((MG_H, MG_W, 4), device=dev)
        for _ in range(3):
            dist.all_reduce(buf)
        dist.barrier()
        s = _synced_s(lambda: [dist.all_reduce(buf) for _ in range(ALLREDUCE_REPS)])
        return dict(ms=s * 1e3 / ALLREDUCE_REPS, bytes=buf.numel() * 4), {}
    flat, cam = mg_scene(task["scene"], dev)
    if kind == "pipeline":
        mesh = pipeline.make_stage_mesh(MG_DEPTH)
        src = mg_sources(dev)[0]
        o, d, t = (torch.from_numpy(np.load(task["rays"])[k]).to(dev) for k in ("o", "d", "t"))
        scalars, arrays = {}, {}
        pipeline.path_trace_pipelined(flat, o, d, t, MG_DEPTH, src, mesh)  # warm-up
        for n in task["n_micro"]:
            dist.barrier()
            out = {}
            s = _synced_s(lambda: out.setdefault("rad", pipeline.path_trace_pipelined(
                flat, o, d, t, MG_DEPTH, src, mesh, n_micro=n)))
            scalars[f"n_micro{n}_ms"] = s * 1e3
            arrays[f"n_micro{n}"] = out["rad"].cpu().numpy()
        return scalars, arrays
    mesh = sharding.make_mesh(spp_parallel=task["spp_parallel"])
    sources = mg_sources(dev)
    scalars = dict(mesh=list(mesh.shape), coordinate=list(mesh.get_coordinate()))
    if kind == "render":
        fn = sharding.sharded_render_fn(mesh, MG_PASSES, **opts)
        out, outs = {}, {}
        dist.barrier()
        torch.cuda.synchronize()
        ops_bvh.reset_launch_counts()
        ops_instances.reset_launch_counts()
        calls = capture_calls(((ops_bvh, "closest_hit"), (ops_bvh, "any_hit")),
                              lambda: out.setdefault("img", fn(flat, cam, sources)), outs)
        torch.cuda.synchronize()
        scalars["launches"] = {**ops_bvh.launch_counts, **ops_instances.launch_counts}
        dist.barrier()
        s = _synced_s(lambda: fn(flat, cam, sources))
        scalars["ms_per_spp"] = s * 1e3 / MG_PASSES
        scalars["walks"] = hold_walk_calls(calls, outs)
        return scalars, {"image": out["img"].cpu().numpy()}
    step = sharding.sharded_train_step(mesh, MG_PASSES, **opts)
    target = torch.full((MG_H, MG_W, 3), 0.25, device=dev)
    dist.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    out = {}
    scalars["first_step_s"] = _synced_s(
        lambda: out.setdefault("step", step(flat, cam, sources, target)))
    scalars["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    dist.barrier()
    scalars["step_ms"] = _synced_s(lambda: step(flat, cam, sources, target)) * 1e3
    loss, gm, gc = out["step"]
    scalars["loss"] = float(loss)
    return scalars, {k: v.cpu().numpy() for k, v in _flat_grads(gm, gc).items()}


def mg_rank(job_path: str, rank: int):
    """``chip_smoke.py --multi-gpu-rank JOB RANK``: one rank of a job of the
    multi_gpu phase, on the one card. Writes rank<r>.json and rank<r>.npz
    beside the job."""
    if not torch.cuda.is_available():
        fail("no CUDA device: the multi-GPU ranks run on an NVIDIA GPU")
    import_port()
    import torch.distributed as dist

    from tinsel_tpu_torch.device import resolve_device
    from tinsel_tpu_torch.ops import bvh as ops_bvh
    from tinsel_tpu_torch.parallel.sharding import init_distributed

    job_path = Path(job_path)
    job = json.loads(job_path.read_text())
    dev = resolve_device("cuda:0")  # every rank on the one card
    torch.cuda.set_device(dev)
    init_distributed(job["init"], job["world"], rank, backend=job["backend"])
    scalars, arrays = {}, {}
    try:
        for task in job["tasks"]:
            s, a = mg_task(task, dev, ops_bvh)
            scalars[task["name"]] = s
            arrays.update({f"{task['name']}.{k}": v for k, v in a.items()})
    finally:
        dist.destroy_process_group()
    np.savez(job_path.parent / f"rank{rank}.npz", **arrays)
    (job_path.parent / f"rank{rank}.json").write_text(json.dumps(scalars))


def run_mg_job(tmp: Path, name: str, world: int, backend: str, tasks) -> list:
    """Start ``world`` ranks of ``chip_smoke.py --multi-gpu-rank`` and wait
    for them under MG_DEADLINE_S; a rank that exits non-zero or a run past
    the deadline is fatal (every rank left is killed). Returns each rank's
    (scalars, arrays)."""
    d = tmp / name
    d.mkdir(parents=True)
    (d / "job.json").write_text(json.dumps(dict(
        init=f"file://{d / 'rendezvous'}", world=world, backend=backend, tasks=tasks)))
    logs = [open(d / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--multi-gpu-rank",
                               str(d / "job.json"), str(r)], cwd=ROOT, stdout=log,
                              stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    deadline = time.perf_counter() + MG_DEADLINE_S
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                tail = (d / f"rank{bad[0]}.log").read_text()[-4000:]
                fail(f"multi_gpu {name}: rank {bad[0]} exited {codes[bad[0]]}:\n{tail}")
            if all(c == 0 for c in codes):
                break
            if time.perf_counter() > deadline:
                fail(f"multi_gpu {name}: the ranks ran past {MG_DEADLINE_S} s")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    return [(json.loads((d / f"rank{r}.json").read_text()), dict(np.load(d / f"rank{r}.npz")))
            for r in range(world)]


def _rel_err(a, b, atol, rtol) -> float:
    """The largest |a - b| / (atol + rtol |b|): within the limits at <= 1."""
    return float((np.abs(a - b) / (atol + rtol * np.abs(b))).max())


def multi_gpu_phase(dev, tmp: Path) -> dict:
    """Item 14 of the module docstring. Returns the K3/K4 launches of the
    ranks' sharded renders, and the ranks' walk checks."""
    from tinsel_tpu_torch.core.sampling import Prefixed
    from tinsel_tpu_torch.diff.gradients import linear_image, loss_and_grads
    from tinsel_tpu_torch.render.integrator import path_trace
    from tinsel_tpu_torch.render.renderer import render_pass

    t_phase = time.perf_counter()
    opts = dict(width=MG_W, height=MG_H, max_depth=MG_DEPTH)
    # the unsharded references on the card, on the ranks' draws
    ref = {}
    with torch.no_grad():
        for name in ("cornell", "envmesh"):
            flat, cam = mg_scene(name, dev)
            sources = mg_sources(dev)
            sum(render_pass(flat, cam, s, **opts) for s in sources)  # warm-up
            out = {}
            s = _synced_s(lambda: out.setdefault(
                "acc", sum(render_pass(flat, cam, s, **opts) for s in sources)))
            ref[name] = dict(image=out["acc"].cpu().numpy(), ms_per_spp=s * 1e3 / MG_PASSES)
            if not np.isfinite(ref[name]["image"]).all():
                fail(f"multi_gpu: the unsharded {name} render is not finite")
    flat, cam = mg_scene("cornell", dev)
    sources = mg_sources(dev)
    target = torch.full((MG_H, MG_W, 3), 0.25, device=dev)

    def loss_fn(sc, c):
        accum = sum(render_pass(sc, c, s, **opts) for s in sources)
        return torch.mean((linear_image(accum) - target) ** 2)

    loss_u, (gm_u, gc_u) = loss_and_grads(loss_fn, flat, cam)
    grads_u = {k: v.cpu().numpy() for k, v in _flat_grads(gm_u, gc_u).items()}
    o, d, t = mg_rays(cam)
    np.savez(tmp / "mg_rays.npz", o=o.cpu().numpy(), d=d.cpu().numpy(), t=t.cpu().numpy())
    micro = MG_W * MG_H // 4
    with torch.no_grad():
        pipe_ref = {1: path_trace(flat, o, d, t, MG_DEPTH, sources[0]).cpu().numpy(),
                    4: torch.cat([path_trace(flat, o[m * micro:(m + 1) * micro],
                                             d[m * micro:(m + 1) * micro],
                                             t[m * micro:(m + 1) * micro], MG_DEPTH,
                                             Prefixed(sources[0], m))
                                  for m in range(4)]).cpu().numpy()}
    del flat, cam, gm_u, gc_u, o, d, t
    torch.cuda.empty_cache()
    emit(dict(phase="multi_gpu_setup", seconds=time.perf_counter() - t_phase,
              unsharded_ms_per_spp={k: v["ms_per_spp"] for k, v in ref.items()},
              unsharded_loss=float(loss_u)))

    jobs = {
        "nccl_world1": (1, "nccl", [
            dict(name="allreduce", kind="allreduce"),
            dict(name="render cornell (1,1)", kind="render", scene="cornell", spp_parallel=1),
        ]),
        "gloo_world2": (2, "gloo", [dict(name="allreduce", kind="allreduce")] + [
            dict(name=f"render {sc} ({2 // spp},{spp})", kind="render", scene=sc, spp_parallel=spp)
            for sc in ("cornell", "envmesh") for spp in (1, 2)
        ] + [dict(name="train cornell (2,1)", kind="train", scene="cornell", spp_parallel=1)]),
        "gloo_world4_pipeline": (4, "gloo", [
            dict(name="pipeline cornell", kind="pipeline", scene="cornell",
                 rays=str(tmp / "mg_rays.npz"), n_micro=[1, 4])]),
    }
    launches = {"bvh_closest": 0, "bvh_any": 0, "rounds_closest": 0, "rounds_any": 0}
    walk_err = {"bvh_closest": 0.0, "bvh_any": 0.0}
    for job, (world, backend, tasks) in jobs.items():
        t_job = time.perf_counter()
        ranks = run_mg_job(tmp, job, world, backend, tasks)
        for task in tasks:
            name = task["name"]
            recs = [sc[name] for sc, _ in ranks]
            base = dict(phase="multi_gpu", job=job, backend=backend, world=world, run=name)
            if task["kind"] == "allreduce":
                emit(dict(base, what=f"one all_reduce of a {MG_W}x{MG_H} RGBA f32 buffer",
                          ms_per_rank=[r["ms"] for r in recs], bytes=recs[0]["bytes"]))
                continue
            if task["kind"] == "pipeline":
                stages = world
                per = {}
                for n in task["n_micro"]:
                    outs = [a[f"{name}.n_micro{n}"] for _, a in ranks]
                    err = max(float(np.abs(x - pipe_ref[n]).max()) for x in outs)
                    per[n] = dict(max_abs_diff=err, ms_per_pass=max(r[f"n_micro{n}_ms"] for r in recs),
                                  ms_per_rank=[r[f"n_micro{n}_ms"] for r in recs],
                                  bubble_share=(stages - 1) / (n + stages - 1))
                    if not err <= PIPE_ATOL:
                        fail(f"multi_gpu {name} n_micro {n}: {err} from path_trace")
                emit(dict(base, stages=stages, rays=MG_W * MG_H, n_micro=per,
                          atol=PIPE_ATOL))
                continue
            if task["kind"] == "render":
                want = ref[task["scene"]]["image"]
                imgs = [a[f"{name}.image"] for _, a in ranks]
                worst = max(_rel_err(x, want, SHARD_ATOL, SHARD_RTOL) for x in imgs)
                walks = [r["walks"] for r in recs]
                for r in recs:
                    for k in launches:
                        launches[k] += r["launches"][k]
                for key, call in (("bvh_closest", "closest_hit"), ("bvh_any", "any_hit")):
                    for w in walks:
                        walk_err[key] = max(walk_err[key], w[call]["max_abs_err"])
                        if w[call]["mismatched"] or not w[call]["max_abs_err"] <= KERNEL_TOL:
                            fail(f"multi_gpu {name}: a rank's {call} differs from the plain "
                                 f"walk: {w[call]}")
                emit(dict(base, scene=f"{task['scene']} {MG_W}x{MG_H} d{MG_DEPTH}",
                          passes=MG_PASSES, mesh=recs[0]["mesh"],
                          max_abs_diff=max(float(np.abs(x - want).max()) for x in imgs),
                          worst_over_limit=worst, ms_per_spp_per_rank=[r["ms_per_spp"] for r in recs],
                          unsharded_ms_per_spp=ref[task["scene"]]["ms_per_spp"],
                          launches_per_rank=[r["launches"] for r in recs], walks_per_rank=walks))
                if not worst <= 1.0 or not all(np.array_equal(imgs[0], x) for x in imgs):
                    fail(f"multi_gpu {name}: the sharded image is not the unsharded sum "
                         f"within rtol {SHARD_RTOL}, atol {SHARD_ATOL} ({worst}), or the ranks differ")
                if task["scene"] == "envmesh" and any(
                        min(r["launches"]["bvh_closest"], r["launches"]["bvh_any"]) < 1
                        for r in recs):
                    fail(f"multi_gpu {name}: K3 and K4 did not both launch in every rank")
                if any(r["launches"][k] for r in recs for k in K6_NAMES):
                    fail(f"multi_gpu {name}: K6 launched in a scene of at most "
                         "INSTANCE_TOPK_MIN big meshes")
                continue
            loss_rel = max(abs(r["loss"] - float(loss_u)) / abs(float(loss_u)) for r in recs)
            worst = max(_rel_err(a[f"{name}.{k}"], g, GRAD_ATOL, GRAD_RTOL)
                        for _, a in ranks for k, g in grads_u.items())
            emit(dict(base, scene=f"cornell {MG_W}x{MG_H} d{MG_DEPTH}", passes=MG_PASSES,
                      mesh=recs[0]["mesh"], loss=recs[0]["loss"], loss_rel_diff=loss_rel,
                      grads_worst_over_limit=worst, step_ms_per_rank=[r["step_ms"] for r in recs],
                      first_step_s_per_rank=[r["first_step_s"] for r in recs],
                      peak_gib_per_rank=[r["peak_gib"] for r in recs]))
            if not loss_rel <= LOSS_RTOL or not worst <= 1.0:
                fail(f"multi_gpu {name}: loss {loss_rel} or gradients {worst} off the unsharded step")
        emit(dict(phase="multi_gpu_job", job=job, seconds=time.perf_counter() - t_job))
    emit(dict(phase="multi_gpu_done", seconds=time.perf_counter() - t_phase, launches=launches))
    return launches, walk_err


# ------------------------------------------- phase 15: the module switches


@contextlib.contextmanager
def switched(module, name: str, value):
    """``module.name = value`` for the body, restored in a ``finally``."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


# The candidate backwards of a vertex-plane gather (``accel/traverse.py::
# _GatherPlanes``): each sums the (N, 9) lane gradients g into the (rows,
# 9) planes at the lanes' rows ``flat``.
def _scatter_onehot(flat, g, rows):
    """One (rows, N) x (N, 9) matmul (``_GatherRows``'s backward)."""
    return (flat[None, :] == torch.arange(rows, device=flat.device)[:, None]).to(g.dtype) @ g


def _scatter_index_add(flat, g, rows):
    """``index_add_``: an atomic add a lane on the card."""
    return torch.zeros((rows, g.shape[1]), dtype=g.dtype, device=g.device).index_add_(0, flat, g)


def _scatter_sorted(flat, g, rows):
    """A sorted segment sum: the lanes sorted by row, an f64 prefix sum,
    each row's sum the difference at its bounds (no atomics, no sync)."""
    s, order = torch.sort(flat)
    # the scan along the innermost dimension (a scan along dim 0 of an
    # (N, 9) tensor runs one thread a column)
    c = torch.cumsum(g.index_select(0, order).t().double(), 1)
    c = torch.cat([c.new_zeros((g.shape[1], 1)), c], 1)
    bounds = torch.searchsorted(s, torch.arange(rows + 1, device=flat.device))
    return (c[:, bounds[1:]] - c[:, bounds[:-1]]).t().to(g.dtype)


def _scatter_index_put(flat, g, rows):
    """Advanced indexing's backward, the accumulating ``index_put``."""
    out = torch.zeros((rows, g.shape[1]), dtype=g.dtype, device=g.device)
    return out.index_put_((flat,), g, accumulate=True)


SCATTERS = {"onehot": _scatter_onehot, "index_add": _scatter_index_add,
            "sorted": _scatter_sorted, "index_put": _scatter_index_put}
ONEHOT_MAX_ELEMS = 1 << 30  # (rows x N) one-hot tables larger than 4 GiB are not tried


def vertex_backward_candidates(regimes, what: str):
    """Each candidate backward of a vertex-plane gather on each regime
    (name, (N,) int64 rows on the card, pool rows), timed by CUDA-graph
    replays in the turns A B C D D C B A, each held against an f64 sum:
    within 1e-6 of each row's sum of |g| (f32 sums in another order).
    Returns {regime: {candidate: ms}}."""
    out = {}
    for name, flat, rows in regimes:
        gen = torch.Generator(device=flat.device).manual_seed(3)
        g = torch.randn((flat.shape[0], 9), device=flat.device, generator=gen)
        cands = [c for c in SCATTERS if c != "onehot" or rows * flat.shape[0] <= ONEHOT_MAX_ELEMS]
        ref = _scatter_index_add(flat, g.double(), rows)
        tol = 1e-6 * (_scatter_index_add(flat, g.abs().double(), rows) + 1.0)
        for c in cands:
            err = (SCATTERS[c](flat, g, rows).double() - ref).abs()
            if not bool((err <= tol).all()):
                fail(f"vertex backward {c} on {name} differs from the f64 sum by "
                     f"{float(err.max())}")
        ms = {c: [] for c in cands}
        for c in cands + cands[::-1]:
            ms[c].append(device_ms(SCATTERS[c], [(flat, g, rows)], budget_s=0.1))
        out[name] = {c: min(v) for c, v in ms.items()}
        emit(dict(phase="vertex_backward_candidates", what=what, regime=name,
                  lanes=flat.shape[0], rows=rows,
                  distinct_rows=int(torch.unique(flat).numel()),
                  ms={c: v for c, v in ms.items()}, best=min(out[name], key=out[name].get)))
    return out


def synthetic_vertex_regimes(dev):
    """The three regimes of a vertex gather at their sizes, with made-up
    rows: Cornell's light samples (1M lanes on 2 rows of 16), envmesh's
    bounce (262,144 lanes over 131,072 rows, half of them missing onto row
    0), the 524k sphere (1M lanes over 524,288 rows)."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def rows_of(n, rows):
        return torch.randint(0, rows, (n,), device=dev, generator=gen)

    spread = rows_of(1 << 18, 1 << 17)
    return [("cornell light quad", rows_of(1 << 20, 2), 16),
            ("envmesh bounce", torch.where(rows_of(1 << 18, 2) == 0, 0, spread), 1 << 17),
            ("sphere 524k", rows_of(1 << 20, 1 << 19), 1 << 19)]


def two_lights_scene(w: int, h: int, depth: int):
    """Cornell with a second light, a small warm emissive sphere (the
    scene of tests/test_torch_lightsampling.py::_two_lights)."""
    from tinsel_tpu_torch.scene import model
    from tinsel_tpu_torch.scene.presets import cornell_scene

    sc = cornell_scene(w, h, depth)
    sc.add_primitive(model.Primitive(
        type=model.SPHERE, radius=0.15,
        start_transform=model.HostTransform(p=np.array([-0.55, 1.4, 0.3], np.float32)),
        material=model.Material(color=np.zeros(3, np.float32),
                                emission=np.array([6.0, 3.0, 1.0], np.float32)),
        light_samples=1,
    ))
    return sc


def leaf_grads(flat, cam, leaves_of, put, source, w: int, h: int, depth: int):
    """(loss, {leaf: gradient}) of render_loss against 0.25 with respect to
    ``leaves_of(flat, cam)`` (a dict of tensors, cloned as leaves) put back
    by ``put(flat, cam, leaves) -> (flat, cam)``; a leaf the loss does not
    reach gets zeros."""
    from tinsel_tpu_torch.diff.gradients import render_loss

    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in leaves_of(flat, cam).items()}
    f, c = put(flat, cam, leaves)
    target = torch.full((h, w, 3), 0.25, device=flat.prims.start_p.device)
    loss = render_loss(f, c, source, target, width=w, height=h, max_depth=depth)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss, {k: torch.zeros_like(v) if g is None else g
                  for (k, v), g in zip(leaves.items(), grads)}


def hold_grads(dev, sc, leaves_of, put, what, w=64, h=64, depth=1, held=None):
    """Card against CPU gradients at equal draws (NumpyUniforms(13)): the
    loss within 1e-5 relative, each leaf within GRAD_TOL of its largest
    entry (``grad_devs``). ``held``: the leaves so held
    (default all); the others are reported, as gradient_equal_draw_phase
    reports depth 4, where a leaf fed by the few paths that take another
    branch after a last-bit difference moves by more. Returns the card's
    gradients."""
    from tinsel_tpu_torch.core.sampling import NumpyUniforms
    from tinsel_tpu_torch.render.camera import CameraParams

    res = []
    for d in (dev, torch.device("cpu")):
        flat, cam = sc.flatten(d), CameraParams.from_host(sc.camera, d)
        loss, g = leaf_grads(flat, cam, leaves_of, put, NumpyUniforms(13, d), w, h, depth)
        res.append((float(loss.detach()), {k: v.detach().cpu() for k, v in g.items()}))
    (la, ga), (lb, gb) = res
    dev_norm = grad_devs(ga, gb)
    held = [k for k in gb if held is None or k in held]
    worst = max(held, key=dev_norm.get)
    rest = [k for k in gb if k not in held]
    rec = dict(phase="switch_grad_gpu_vs_cpu_equal_draws", scene=what,
               loss_rel_diff=abs(la - lb) / abs(lb), worst_leaf=worst,
               worst_normalized_dev=dev_norm[worst],
               worst_reported_leaf=max(rest, key=dev_norm.get) if rest else None,
               worst_reported_dev=max((dev_norm[k] for k in rest), default=None),
               nonzero_leaves=sorted(k for k, g in ga.items() if bool(g.any())))
    emit(rec)
    if rec["loss_rel_diff"] > 1e-5 or dev_norm[worst] > GRAD_TOL:
        fail(f"card and CPU gradients disagree at equal draws: {rec}")
    return ga


def _planes_of(flat, cam):
    pool = flat.pool
    return {**{f"tri_planes[{k}]": p for k, p in enumerate(pool.tri_planes)},
            **{f"nrm_planes[{k}]": p for k, p in enumerate(pool.nrm_planes)}}


def _materials_camera_planes(flat, cam):
    return {**{f"materials.{f.name}": getattr(flat.materials, f.name)
               for f in dataclasses.fields(flat.materials)},
            **{f"camera.{f.name}": getattr(cam, f.name) for f in dataclasses.fields(cam)},
            **_planes_of(flat, cam)}


def _put(flat, cam, leaves):
    """Leaves named as ``_materials_camera_planes`` (or a subset, or
    ``prims.<field>``) back into (flat, cam)."""
    def part(prefix):
        return {k.split(".", 1)[1]: v for k, v in leaves.items() if k.startswith(prefix + ".")}

    pool = flat.pool
    tri = [leaves.get(f"tri_planes[{k}]", p) for k, p in enumerate(pool.tri_planes)]
    nrm = [leaves.get(f"nrm_planes[{k}]", p) for k, p in enumerate(pool.nrm_planes)]
    flat = dataclasses.replace(
        flat, materials=dataclasses.replace(flat.materials, **part("materials")),
        prims=dataclasses.replace(flat.prims, **part("prims")),
        pool=dataclasses.replace(pool, tri_planes=tuple(tri), nrm_planes=tuple(nrm)))
    return flat, dataclasses.replace(cam, **part("camera"))


def hoist_off_part(dev) -> dict:
    """``STATIC_TRANSFORM_HOIST = False`` (every sphere and tiny instance
    interpolated at the ray's time): K5c and K5a against their plain
    versions on the calls of one Cornell 512x512 depth-4 pass (4 spp, 1M
    rays a call) and of one pass of scenes/motionblur.tin, every lane
    equal and t bit for bit, the table packed in the moving form (its
    size beside the hoisted table's); the refit's t equal to the sweep's
    on every closest-hit call; motionblur.tin on the card against the CPU
    at equal draws at 64x64; the gradient of end_p (and start_p) at 64x64
    depth 2 (the scene has no light: its radiance is the sky's, reached by
    the first bounce): a static primitive's end_p gradient nonzero on the
    card, both within GRAD_TOL of the CPU's. Returns {kernel: [records]}."""
    from tinsel_tpu_torch.accel.sweep import layout
    from tinsel_tpu_torch.core.sampling import PathUniforms
    from tinsel_tpu_torch.ops import sweep as ops_sweep
    from tinsel_tpu_torch.render import trace
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.render.renderer import make_render_pass
    from tinsel_tpu_torch.scene.loaders.tin import load_tin
    from tinsel_tpu_torch.scene.model import PLANE
    from tinsel_tpu_torch.scene.presets import cornell_scene

    recs = {"sweep_closest": [], "sweep_any": []}
    motionblur = load_tin(str(ROOT / "scenes" / "motionblur.tin"))
    with switched(trace, "STATIC_TRANSFORM_HOIST", False):
        for tag, sc, spp, n_calls in (
                (f"cornell {MAIN_W}x{MAIN_H}", cornell_scene(MAIN_W, MAIN_H, MAIN_DEPTH),
                 spp_per_pass(4, MAIN_W, MAIN_H), MAIN_DEPTH),
                ("motionblur.tin", motionblur, 1, 1)):
            flat, cam = sc.flatten(dev), CameraParams.from_host(sc.camera, dev)
            run = make_render_pass(sc.options, spp)
            with torch.no_grad():
                calls = capture_calls(((ops_sweep, "sweep_closest"), (ops_sweep, "sweep_any")),
                                      lambda: run(flat, cam, PathUniforms(11, dev)))
            refit_bits = 0
            for name in recs:
                if any(k.get("hoist", True) for _, k in calls[name]):
                    fail(f"hoist off, {tag}: a {name} call was made with the hoist on")
                for i, (a, _) in enumerate(calls[name][:n_calls]):
                    f, args = sweep_args(a, name == "sweep_closest")
                    recs[name].append(check_sweep(ops_sweep, name, f, args,
                                                  f"{tag} hoist off bounce {i}", hoist=False))
                    if name == "sweep_closest":
                        t, prim, tri = ops_sweep.sweep_closest_cuda(f, *args, hoist=False)
                        with torch.no_grad():
                            t_re, _ = trace._refit(f, layout(f.prim_static, False), *args,
                                                   prim, tri)
                        refit_bits += int((t_re.view(torch.int32) != t.view(torch.int32)).sum())
            tabs = {h: ops_sweep.table(flat, dev, h) for h in (True, False)}
            emit(dict(phase="hoist_off_table", scene=tag,
                      **{("hoisted" if h else "hoist_off"): dict(
                          floats=int(t.table.numel()), bytes=4 * int(t.table.numel()),
                          chunks=t.n_chunks, moving=t.motion) for h, t in tabs.items()},
                      refit_t_bits_differing=refit_bits))
            if refit_bits:
                fail(f"hoist off, {tag}: the refit's t differs from the sweep's on "
                     f"{refit_bits} rays")
            del calls, flat, cam
        equal_draws_small(motionblur, 64, 64, MAIN_DEPTH, "motionblur.tin 64x64 hoist off",
                          dev)
        g = hold_grads(dev, motionblur,
                       lambda f, c: {"prims.start_p": f.prims.start_p,
                                     "prims.end_p": f.prims.end_p},
                       _put, "motionblur.tin 64x64 d2 hoist off: start_p, end_p", depth=2)
        static = [i for i, ps in enumerate(motionblur.flatten("cpu").prim_static)
                  if not ps.motion and ps.type != PLANE]
        end_static = float(g["prims.end_p"][static].abs().max()) if static else 0.0
        emit(dict(phase="hoist_off_end_p", static_prims=static,
                  max_abs_end_p_grad_static=end_static))
        if not end_static > 0:
            fail("hoist off: no static primitive's end_p gradient on the card")
    return recs


def closest_shadow_part(ops_nlm, ops_bvh, dev) -> tuple:
    """``NEE_CLOSEST_SHADOW = True`` (every area-light shadow ray a closest
    hit, accepted within PORTAL_TOL of the sampled distance):

    * Cornell 512x512 depth 4 at 16 spp -> ``resolve`` -> ``nlm_denoise``,
      K5c, K5a, K1, K3 and K4 counts reset just before and read just after.
      The code implies, per pass of 4 spp (1M rays): at each of the 4
      bounces one K5c for the path's ray and one for each light sample's
      shadow ray (Cornell: one light, one sample), no K5a (no probe, no
      occlusion query), no walk (no big mesh): K5c = 4 passes x 4 bounces
      x 2 = 32, K5a = 0, K1 = 1, K3 = K4 = 0;
    * its ms per spp beside the switch off, in the turns on, off, off, on;
    * many_mesh_scene(48, 512, 512, 2) at 4 spp (one pass): the light's
      shadow rays' closest hits run the shortlist rounds, K6c, beside the
      path's: 2 bounces x 2 = 4 K6c launches, no K6a, K3 or K4; every
      K6c launch of the pass held against the plain rounds on its own
      inputs;
    * card against CPU at equal draws at 64x64: Cornell ("all") and
      Cornell with a second light in "power" mode.

    Returns (launches of the Cornell and many_mesh runs, K6c's worst
    error)."""
    from tinsel_tpu_torch.core.color import resolve
    from tinsel_tpu_torch.core.sampling import PathUniforms
    from tinsel_tpu_torch.ops import instances as ops_instances
    from tinsel_tpu_torch.ops import sweep as ops_sweep
    from tinsel_tpu_torch.render import lights, trace
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.render.renderer import make_render_pass, render
    from tinsel_tpu_torch.scene.presets import cornell_scene, many_mesh_scene

    sc = cornell_scene(MAIN_W, MAIN_H, MAIN_DEPTH)
    flat = sc.flatten(dev)
    passes = MAIN_SPP // spp_per_pass(MAIN_SPP, MAIN_W, MAIN_H)
    shadow = sum(flat.prim_static[j].light_samples for j in flat.light_indices)
    want = {"sweep_closest": passes * MAIN_DEPTH * (1 + shadow), "sweep_any": 0,
            "nlm_filter": 1, "bvh_closest": 0, "bvh_any": 0, "rounds_closest": 0,
            "rounds_any": 0}
    with switched(lights, "NEE_CLOSEST_SHADOW", True):
        render(sc, spp=1, seed=1, device=dev)  # warm-up
        torch.cuda.synchronize()
        for m in (ops_nlm, ops_sweep, ops_bvh, ops_instances):
            m.reset_launch_counts()
        accum = render(sc, spp=MAIN_SPP, seed=0, device=dev)
        den = ops_nlm.nlm_denoise(resolve(accum))
        torch.cuda.synchronize()
        got = {**ops_sweep.launch_counts, **ops_bvh.launch_counts, **ops_nlm.launch_counts,
               **ops_instances.launch_counts}
    got = {k: got[k] for k in want}
    emit(dict(phase="closest_shadow_main_path", scene=f"cornell {MAIN_W}x{MAIN_H} "
              f"d{MAIN_DEPTH} {MAIN_SPP}spp", launches=got, expected=want,
              image_mean=float(resolve(accum).mean()), denoised_mean=float(den.mean())))
    if got != want or not torch.isfinite(den).all():
        fail(f"closest-shadow main path: launches {got}, expected {want}")
    launches = dict(got)

    ms = {True: [], False: []}
    for closest in (True, False, False, True):
        with switched(lights, "NEE_CLOSEST_SHADOW", closest):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render(sc, spp=MAIN_SPP, seed=0, device=dev)
            torch.cuda.synchronize()
            ms[closest].append((time.perf_counter() - t0) * 1e3 / MAIN_SPP)
    emit(dict(phase="closest_shadow_ms_per_spp", scene=f"cornell {MAIN_W}x{MAIN_H} "
              f"d{MAIN_DEPTH} {MAIN_SPP}spp", turns="on, off, off, on",
              closest_shadow_ms_per_spp=ms[True], segment_occlusion_ms_per_spp=ms[False]))

    mm = many_mesh_scene(48, BIG_W, BIG_H, 2)
    flat, cam = mm.flatten(dev), CameraParams.from_host(mm.camera, dev)
    run = make_render_pass(mm.options, spp_per_pass(4))
    rounds = {"n": 0}
    orig_rounds = trace._instance_rounds

    def counted(*a, **k):
        rounds["n"] += 1
        return orig_rounds(*a, **k)

    outs = {}
    trace._instance_rounds = counted
    try:
        with switched(lights, "NEE_CLOSEST_SHADOW", True), torch.no_grad():
            ops_bvh.reset_launch_counts()
            ops_instances.reset_launch_counts()
            calls = capture_calls(((ops_instances, "rounds_closest"),
                                   (ops_instances, "rounds_any")),
                                  lambda: run(flat, cam, PathUniforms(3, dev)), outs=outs)
            torch.cuda.synchronize()
            mm_launches = {**ops_bvh.launch_counts, **ops_instances.launch_counts}
    finally:
        trace._instance_rounds = orig_rounds
    held = hold_rounds(calls, outs)
    mm_want = {"bvh_closest": 0, "bvh_any": 0, "bvh_steps": 0, "rounds_closest": 2 * 2,
               "rounds_any": 0, "bvh_frames": 0}
    emit(dict(phase="closest_shadow_many_mesh", scene=f"many_mesh 48 {BIG_W}x{BIG_H} d2 "
              f"{spp_per_pass(4)}spp pass", launches=mm_launches, expected=mm_want,
              instance_rounds_calls=rounds["n"], k6c_held=held["rounds_closest"]))
    if rounds["n"] != 2 * 2 or mm_launches != mm_want:
        fail(f"closest-shadow many_mesh: {held}, rounds {rounds}, launches {mm_launches}")
    for k in ("bvh_closest", "bvh_any", "rounds_closest", "rounds_any"):
        launches[k] += mm_launches[k]
    del calls, outs

    with switched(lights, "NEE_CLOSEST_SHADOW", True):
        equal_draws_small(cornell_scene(64, 64, MAIN_DEPTH), 64, 64, MAIN_DEPTH,
                          "cornell 64x64 d4 closest shadow", dev)
        two = two_lights_scene(64, 64, 3)
        two.options = dataclasses.replace(two.options, light_sampling="power")
        equal_draws_small(two, 64, 64, 3, "two lights 64x64 d3 power closest shadow", dev)
    return launches, held["rounds_closest"]["max_abs_err"]


def vertex_grads_part(dev):
    """``MESH_VERTEX_GRADS = True``: card against CPU gradients at equal
    draws at 64x64 depth 2 (Cornell: the light quad; envmesh detail 32:
    the big batch, whose sky-lit radiance reaches its vertices through the
    first bounce) with the vertex and normal planes as leaves beside
    materials and camera, the planes held (materials and camera are held
    at depth 1 by gradient_equal_draw_phase, and reported here); then the gradient step at 512x512 depth 4 on
    Cornell and envmesh (131k triangles) with those leaves, the switch on
    against off in the turns on, off, off, on: fwd and fwd+bwd ms
    (fwd+bwd / fwd), peak memory, and one profiled backward each: device
    busy ms, top kernels and the vertex backward's own device ms
    (``_GatherPlanes.backward`` under a profiler range); then every
    candidate backward (``vertex_backward_candidates``) on the largest
    gather each scene's backward ran, and on the three regimes at their
    sizes (``synthetic_vertex_regimes``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from tinsel_tpu_torch.accel import traverse
    from tinsel_tpu_torch.core.sampling import PathUniforms
    from tinsel_tpu_torch.diff.gradients import render_loss
    from tinsel_tpu_torch.render import trace
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.scene.presets import cornell_scene, envmesh_scene

    with switched(trace, "MESH_VERTEX_GRADS", True):
        for what, sc in (("cornell", cornell_scene(64, 64, 2)),
                         ("envmesh detail 32", envmesh_scene(64, 64, 2, detail=32))):
            planes = _planes_of(sc.flatten("cpu"), None)
            g = hold_grads(dev, sc, _materials_camera_planes, _put,
                           f"{what} 64x64 d2 vertex grads", depth=2, held=planes)
            if not any(bool(g[k].any()) for k in planes):
                fail(f"vertex grads on {what}: every plane's gradient is zero on the card")

    orig_bwd = traverse._GatherPlanes.backward
    seen = []

    def traced_bwd(ctx, *grads):
        flat = ctx.saved_tensors[0]
        seen.append((flat.shape[0], flat, ctx.rows))
        with record_function("vertex_backward"):
            return orig_bwd(ctx, *grads)

    target = torch.full((BIG_H, BIG_W, 3), 0.25, device=dev)
    regimes = []
    for name, sc in (("cornell", cornell_scene(BIG_W, BIG_H, 4)),
                     ("envmesh", envmesh_scene(BIG_W, BIG_H, 4))):
        flat, cam = sc.flatten(dev), CameraParams.from_host(sc.camera, dev)

        def fwd_bwd(i):
            leaf_grads(flat, cam, _materials_camera_planes, _put, PathUniforms(i, dev),
                       BIG_W, BIG_H, 4)

        def fwd(i):
            with torch.no_grad():
                render_loss(flat, cam, PathUniforms(i, dev), target, width=BIG_W, height=BIG_H,
                            max_depth=4)

        times = {v: {"fwd": [], "fwd_bwd": []} for v in (True, False)}
        peak, prof_rec = {}, {}
        for on in (True, False):  # warm-up: the first backward of each setting
            with switched(trace, "MESH_VERTEX_GRADS", on):
                fwd_bwd(9)
        for i, on in enumerate((True, False, False, True)):
            with switched(trace, "MESH_VERTEX_GRADS", on):
                times[on]["fwd"].append(_event_ms(lambda: fwd(i), 1))
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                times[on]["fwd_bwd"].append(_event_ms(lambda: fwd_bwd(i), 1))
                peak[on] = torch.cuda.max_memory_allocated() / 2**30
        for on in (True, False):
            traverse._GatherPlanes.backward = staticmethod(traced_bwd)
            del seen[:]
            try:
                with switched(trace, "MESH_VERTEX_GRADS", on):
                    leaves = {k: v.detach().clone().requires_grad_(True)
                              for k, v in _materials_camera_planes(flat, cam).items()}
                    f, c = _put(flat, cam, leaves)
                    ls = render_loss(f, c, PathUniforms(5, dev), target, width=BIG_W,
                                     height=BIG_H, max_depth=4)
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        torch.autograd.grad(ls, list(leaves.values()), allow_unused=True)
                        torch.cuda.synchronize()
            finally:
                traverse._GatherPlanes.backward = orig_bwd
            kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                       and e.key != "vertex_backward"]
            busy, vb = range_device_ms(prof, "vertex_backward")
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
            prof_rec[on] = dict(
                backward_device_busy_ms=busy if busy > 0 else "not measured",
                vertex_backward_ms=vb, vertex_backward_calls=len(seen),
                vertex_backward_share=vb / busy if busy > 0 else "not measured",
                backward_top_kernels=[[e.key[:70], e.count, e.self_device_time_total / 1e3]
                                      for e in top])
            if on:
                if not seen:
                    fail(f"vertex grads on {name}: the gathers' backward never ran")
                n, idx, rows = max(seen, key=lambda x: x[0])
                regimes.append((f"{name} largest gather", idx, rows))
            del seen[:], ls, leaves, f, c
        med = {on: {k: statistics.median(v) for k, v in t.items()} for on, t in times.items()}
        emit(dict(phase="vertex_grads_step", scene=f"{name} {BIG_W}x{BIG_H} d4 1spp",
                  turns="on, off, off, on", **{("on" if on else "off"): dict(
                      fwd_ms=times[on]["fwd"], fwd_bwd_ms=times[on]["fwd_bwd"],
                      fwd_bwd_over_fwd=med[on]["fwd_bwd"] / med[on]["fwd"],
                      peak_memory_gib=peak[on], **prof_rec[on]) for on in (True, False)}))
        del flat, cam
    vertex_backward_candidates(regimes, "captured")
    vertex_backward_candidates(synthetic_vertex_regimes(dev), "synthetic")


def probe_texels_part(dev):
    """The gradient of the probe's texels (``ProbeFlat.data``, read by
    advanced indexing in render/probe.py, whose backward is the
    accumulating ``index_put``): the gradient step on
    ``envmesh_scene(512, 512, 4, probe=True)`` at 1 spp with materials and
    camera as leaves, with and without ``probe.data`` beside them, in the
    turns with, without, without, with: each backward profiled, its
    device busy ms, the ms of its kernels named ``index`` and its top
    kernels; the texel gradient finite and nonzero."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tinsel_tpu_torch.core.sampling import PathUniforms
    from tinsel_tpu_torch.diff.gradients import render_loss
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.scene.presets import envmesh_scene

    sc = envmesh_scene(BIG_W, BIG_H, 4, probe=True)
    flat, cam = sc.flatten(dev), CameraParams.from_host(sc.camera, dev)

    def leaves_of(texels):
        def get(f, c):
            out = {k: v for k, v in _materials_camera_planes(f, c).items()
                   if not k.endswith("]")}  # materials and camera
            if texels:
                out["probe.data"] = f.probe.data
            return out
        return get

    def put(f, c, leaves):
        if "probe.data" in leaves:
            f = dataclasses.replace(f, probe=dataclasses.replace(f.probe,
                                                                 data=leaves["probe.data"]))
        return _put(f, c, {k: v for k, v in leaves.items() if k != "probe.data"})

    target = torch.full((BIG_H, BIG_W, 3), 0.25, device=dev)
    recs = {True: [], False: []}
    leaf_grads(flat, cam, leaves_of(True), put, PathUniforms(9, dev), BIG_W, BIG_H, 4)  # warm
    for i, texels in enumerate((True, False, False, True)):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in leaves_of(texels)(flat, cam).items()}
        loss = render_loss(*put(flat, cam, leaves), PathUniforms(i, dev), target, width=BIG_W,
                           height=BIG_H, max_depth=4)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            g = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                     allow_unused=True)))
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
        recs[texels].append(dict(
            backward_device_busy_ms=sum(e.self_device_time_total for e in kernels) / 1e3,
            index_kernels_ms=sum(e.self_device_time_total for e in kernels
                                 if "index" in e.key.lower()) / 1e3,
            top_kernels=[[e.key[:70], e.count, e.self_device_time_total / 1e3] for e in top]))
        if texels:
            t = g["probe.data"]
            if t is None or not bool(torch.isfinite(t).all()) or not bool(t.any()):
                fail("probe texel gradient: not finite, or zero")
            texel_nonzero = int(t.abs().sum(-1).gt(0).sum())
    emit(dict(phase="probe_texel_grads", scene=f"envmesh probe {BIG_W}x{BIG_H} d4 1spp",
              turns="with, without, without, with", texels=int(flat.probe.data[..., 0].numel()),
              texels_with_gradient=texel_nonzero, with_texels=recs[True],
              without_texels=recs[False]))


def range_device_ms(prof, name: str) -> tuple:
    """(device ms of a profiler run's device records, device ms of
    those inside the spans of the range ``name``), from the raw records:
    the profiler marks each span of a ``record_function`` range on the
    device timeline with a record of the range's name, which is not
    counted itself."""
    from torch.autograd import DeviceType

    recs = [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
    spans = [(s, s + d) for n, s, d in recs if n == name]
    work = [(s, d) for n, s, d in recs if n != name]
    inside = sum(d for s, d in work if any(a <= s and s + d <= b for a, b in spans))
    return sum(d for _, d in work) / 1e6, inside / 1e6


def switches_phase(ops_nlm, ops_bvh, dev) -> tuple:
    """Item 15 of the module docstring. Returns (the sweep records of the
    hoist-off part, the closest-shadow runs' launches, K6c's worst error
    there)."""
    t0 = time.perf_counter()
    sweeps = hoist_off_part(dev)
    launches, k6_err = closest_shadow_part(ops_nlm, ops_bvh, dev)
    vertex_grads_part(dev)
    probe_texels_part(dev)
    emit(dict(phase="switches", seconds=time.perf_counter() - t0))
    return sweeps, launches, k6_err


def _rgbe_to_float_ref(rgbe):
    """RGBE bytes to f32: mantissa / 256 * 2^(e - 128), 0 where e = 0."""
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(np.float32(1.0), e - 136), np.float32(0.0))
    return (rgbe[..., :3].astype(np.float32) * scale[..., None].astype(np.float32))


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
    sources = _build.SOURCES + tuple(_build.HOST_SOURCES)  # the kernels and the BVH builder
    _build.build_all(sources)
    build_s = time.perf_counter() - t0
    for name, (secs, log) in _build.build_log.items():
        for line in log.splitlines():
            if "error" in line:
                print(f"ptxas[{name}]: {line.strip()}", flush=True)
        for inst, regs, stack, spill_st, spill_ld in ptxas_summary(log):
            print(f"ptxas[{name}]: {inst}: {regs} registers, {stack} B stack frame, "
                  f"{spill_st} B spill stores, {spill_ld} B spill loads", flush=True)
    emit(dict(phase="build", seconds=build_s, sources=list(sources),
              per_source_s={k: v[0] for k, v in _build.build_log.items()}))

    worst = kernel_phase(ops_nlm, plain, dev)
    equal_draw_phase(dev)
    img, aov, launches = main_path(ops_nlm, dev)
    nee_recs = nee_phase(dev)
    k1, k2 = main_inputs_phase(ops_nlm, plain, img, aov)
    trace_split_phase(dev)
    profile_phase(dev)
    trace_ab_phase(dev)
    sweeps = sweep_kernel_phase(dev)

    from tinsel_tpu_torch.ops import bvh as ops_bvh

    walks, walk_inputs = bvh_kernel_phase(dev)
    bigmesh_equal_draw_phase(dev)
    big_launches, per_scene, big_held = bigmesh_path(ops_bvh, dev)
    gradient_equal_draw_phase(dev)
    gradient_phase(ops_bvh, dev)
    trainer_phase(dev)

    steps, k4_probe = steps_kernel_phase(dev, walk_inputs)
    walks["bvh_any"].append(k4_probe)
    integrator_equal_draw_phase(dev)
    probe_launches = probe_path(ops_nlm, ops_bvh, dev, per_scene["envmesh"])
    k6, k6_held, k6_launches = trace_ops_phase(dev, per_scene)
    frames = frames_phase(dev)

    from tinsel_tpu_torch.scene.loaders import mesh_io

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        mesh_io._CACHE_DIR = str(Path(tmp) / "mesh_cache")  # cold at the first load
        file_launches = scene_files_phase(ops_bvh, dev)
        ajax_launches = ajaxenv_files_phase(ops_bvh, dev, Path(tmp))
        entry_launches = entry_points_phase(ops_nlm, ops_bvh, dev, Path(tmp))
        mg_launches, mg_walk_err = multi_gpu_phase(dev, Path(tmp))
    sw_sweeps, sw_launches, sw_k6_err = switches_phase(ops_nlm, ops_bvh, dev)
    # K3/K4 on the big-mesh, probe and scene-file paths, K7 on the
    # complexity view, K6 on the big-mesh path and K6's passes; every
    # kernel on the entry points' runs
    for k in ("bvh_closest", "bvh_any"):
        launches[k] = (big_launches[k] + probe_launches[k] + file_launches[k]
                       + ajax_launches[k])
    launches["bvh_steps"] = probe_launches["bvh_steps"]
    launches["bvh_frames"] = (big_launches["bvh_frames"] + probe_launches["bvh_frames"]
                              + file_launches["bvh_frames"] + ajax_launches["bvh_frames"])
    for k in K6_NAMES:
        launches[k] = big_launches[k] + k6_launches[k] + file_launches[k]
    launches["nee_shade"] += probe_launches["nee_shade"]  # the probe's form
    # K5c/K5a: the main path's frame (phase 5), then the entry points
    for k in KERNEL_NAMES:
        launches[k] += entry_launches[k]
    for k in mg_launches:  # the ranks' sharded renders
        launches[k] += mg_launches[k]
    for k, n in sw_launches.items():  # the closest-shadow runs (phase 15)
        launches[k] += n
    for k, recs in sw_sweeps.items():  # the hoist-off sweeps, in the worst error
        sweeps[k] += recs

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
    # bounce), K4 at its shadow rays (envmesh's probe NEE); the error is the
    # worst over every input
    for key, tag, replaces in (
        ("bvh_closest", "envmesh rays",
         "tinsel_tpu/accel/traverse.py:761 intersect_mesh (_step :390)"),
        ("bvh_any", "envmesh probe shadow rays",
         "tinsel_tpu/accel/traverse.py:903 intersect_mesh_any (_traverse_tile_any :811)"),
    ):
        rec = next(r for r in walks[key] if r["shape"] == tag)
        table.append(dict(
            name=key, route="cuda", source="tinsel_tpu_torch/csrc/bvh.cu",
            replaces=replaces, launches=launches[key],
            max_abs_err=max([r["max_abs_err"] for r in walks[key]] + [mg_walk_err[key]]),
            ms=rec["kernel_ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            bound_share=rec["bound_share"], library_ms=None,
        ))
    # K7 at the complexity view's own input: envmesh's camera rays
    rec = steps[0]
    table.append(dict(
        name="bvh_steps", route="cuda", source="tinsel_tpu_torch/csrc/bvh.cu",
        replaces="tinsel_tpu/accel/traverse.py:963 traversal_cost (_run_tiled with_steps :635)",
        launches=launches["bvh_steps"], max_abs_err=max(r["max_abs_err"] for r in steps),
        ms=rec["kernel_ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
        bound_by=rec["bound_by"], bound_share=rec["bound_share"], library_ms=None,
    ))
    # K5c/K5a at the main path's own inputs: Cornell's first-bounce calls
    # (1M rays each); the error is the worst over every input
    for key, replaces in (
        ("sweep_closest", "tinsel_tpu/render/trace.py:388-424 sphere/plane rows and merge + "
                          "tinsel_tpu/accel/traverse.py:981 _intersect_mesh_brute"),
        ("sweep_any", "tinsel_tpu/render/trace.py:576 trace_any sphere/plane rows + "
                      "tinsel_tpu/accel/traverse.py:981 _intersect_mesh_brute"),
    ):
        rec = next(r for r in sweeps[key] if r["shape"].endswith("bounce 1"))
        table.append(dict(
            name=key, route="cuda", source="tinsel_tpu_torch/csrc/sweep.cu",
            replaces=replaces, launches=launches[key],
            max_abs_err=max(r["max_abs_err"] for r in sweeps[key]),
            ms=rec["kernel_ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], bound_share=rec["bound_share"], library_ms=None,
        ))
    # K6c/K6a at many_mesh's first rounds call of each form (bounce 0, 1M
    # rays, 48 meshes); the error is the worst over every launch held
    for key, replaces in (
        ("rounds_closest", "tinsel_tpu/render/trace.py:267 _instance_rounds "
                           "(_shortlist_candidates :251, _instance_box_entry :216)"),
        ("rounds_any", "tinsel_tpu/render/trace.py:330 _instance_rounds_any "
                       "(_instance_box_entry :216)"),
    ):
        rec = next(r for r in k6[key] if r["shape"].startswith("many_mesh"))
        errs = ([r["max_abs_err"] for r in k6[key]]
                + [h[key]["max_abs_err"] for h in (*big_held.values(), *k6_held.values())]
                + ([sw_k6_err] if key == "rounds_closest" else []))
        table.append(dict(
            name=key, route="cuda", source="tinsel_tpu_torch/csrc/bvh.cu",
            replaces=replaces, launches=launches[key], max_abs_err=max(errs),
            ms=rec["kernel_ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], bound_share=rec["bound_share"], library_ms=None,
        ))
    # K8 / K9 at the main path's own inputs: Cornell's first light sample
    # of a pass (1M lanes); the error is the worst over every input held
    for key, forms in (("nee_light", ("K8",)), ("nee_shade", ("K9 light", "K9 probe"))):
        held = [r for f in forms for r in nee_recs[f]]
        rec = next(r for r in held if r["shape"].startswith("cornell"))
        table.append(dict(
            name=key, route="cuda", source="tinsel_tpu_torch/csrc/nee.cu",
            replaces="none (no TPU kernel: tinsel_tpu/render/lights.py:sample_lights is "
                     "plain JAX)", launches=launches[key],
            max_abs_err=max(r["max_abs_err"] for r in held),
            ms=rec["kernel_ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], bound_share=rec["bound_share"], library_ms=None,
        ))
    # K10 at the main path's own input: envmesh's first closest-hit call
    # (1M rays, one instance); every call held was equal bit for bit
    rec = next(r for r in frames if r["shape"].startswith("envmesh") and r["form"] == "closest")
    table.append(dict(
        name="bvh_frames", route="cuda", source="tinsel_tpu_torch/csrc/bvh.cu",
        replaces="none (no TPU kernel: accel/instances.py::world_inputs' eager chain; "
                 "tinsel_tpu/render/trace.py:216 _instance_box_entry and the local rays "
                 ":434-436 are plain JAX)", launches=launches["bvh_frames"], max_abs_err=0.0,
        ms=rec["kernel_ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
        bound_by=rec["bound_by"], bound_share=rec["bound_share"], library_ms=None,
    ))
    print(smi, flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multi-gpu-rank"]:
        mg_rank(sys.argv[2], int(sys.argv[3]))
    else:
        main()
