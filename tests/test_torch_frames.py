"""Kernel K10's wrapper (``ops/instances.py::frames``: the lanes of the batch
of at most 12 big instances, which kernels K3 / K4 walk) checked on the
CPU: its launch geometry, every argument check (reached with CPU
tensors, before any device), its dispatch of CPU tensors to the plain
version (``accel/instances.py::frames``: ``world_inputs``, the rule tmax
-> 0 where the root box is missed or the ray occluded, and the per-lane
offsets) and what trace_closest / trace_any hand it. The kernel itself
runs in tests/test_torch_frames_cuda.py on the card."""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_bvh_launch import LANES
from test_torch_instances_cuda import rays, turned_capsules
from tinsel_tpu_torch.accel import instances as plain
from tinsel_tpu_torch.accel.sweep import layout
from tinsel_tpu_torch.ops import bvh as ops_bvh
from tinsel_tpu_torch.ops import instances as ops
from tinsel_tpu_torch.render import trace
from tinsel_tpu_torch.scene import model, presets, procedural

torch.set_num_threads(2)
CPU = torch.device("cpu")
R = 700
# one instance (envmesh's Perlin sphere), 7 turned and scaled capsules, 5
# of which two move (the whole batch then interpolates at the ray's time)
SCENES = {
    "envmesh": lambda: presets.envmesh_scene(32, 32, 4, detail=24),
    "turned7": lambda: turned_capsules(model, procedural, 7, seed=3),
    "moving5": lambda: turned_capsules(model, procedural, 5, moving=True, seed=4),
}
_FLATS = {}


def _flat(name):
    if name not in _FLATS:
        _FLATS[name] = SCENES[name]().flatten(device="cpu")
    return _FLATS[name]


def _args(name, n=R, hoist=True, seed=1):
    """(scene, table, origins, dirs, times, tmax, occ) on the CPU."""
    flat = _flat(name)
    big = list(layout(flat.prim_static, hoist).big)
    o, d, times, best, occ = rays(flat, big, n, seed, moving=name == "moving5" or not hoist)
    tab = ops.table(flat, CPU, hoist)
    return (flat, tab, *map(torch.from_numpy, (o, d, times, best)), torch.from_numpy(occ))


def _old_lanes(scene, tab, o, d, times, tmax, occ):
    """The lanes as trace_closest / trace_any built them before K10."""
    n, r = len(tab.prims), o.shape[0]
    if occ is not None:
        tmax = torch.where(occ, 0.0, tmax)
    o_l, d_l, tn = plain.world_inputs(scene, tab, o, d, times, tmax)
    tm = torch.where(torch.isfinite(tn), tmax[None, :], 0.0).reshape(n * r)
    return (o_l.reshape(n * r, 3), d_l.reshape(n * r, 3), tm, tab.noff.repeat_interleave(r),
            tab.toff.repeat_interleave(r))


@pytest.mark.parametrize("lanes", LANES)
def test_grid_covers_every_lane(lanes):
    threads, grid = ops.frames_geometry(lanes)
    assert threads == ops.FRAME_THREADS and threads % 32 == 0
    assert grid * threads >= lanes
    assert (grid - 1) * threads < lanes or grid == 0
    assert (grid == 0) == (lanes == 0)  # no launch without rays
    assert grid < 2**31


def test_negative_rays_raise():
    with pytest.raises(ValueError, match="rays"):
        ops.frames_geometry(-1)


@pytest.mark.parametrize("hoist", [True, False])
@pytest.mark.parametrize("form", ["closest", "any"])
@pytest.mark.parametrize("name", list(SCENES))
def test_cpu_tensors_run_the_plain_version(name, form, hoist):
    """On CPU tensors ``frames`` is the plain version, which equals what the
    trace built before K10, and nothing is launched or counted."""
    flat, tab, o, d, times, tmax, occ = _args(name, hoist=hoist)
    occ = occ if form == "any" else None
    ops.reset_launch_counts()
    ops_bvh.reset_launch_counts()
    got = ops.frames(flat, tab, o, d, times, tmax, occ)
    want = plain.frames(flat, tab, o, d, times, tmax, occ)
    n = len(tab.prims) * R
    shapes = ((n, 3), (n, 3), (n,), (n,), (n,))
    dtypes = (torch.float32,) * 3 + (torch.int32,) * 2
    for a, b, c, shape, dtype in zip(got, want, _old_lanes(flat, tab, o, d, times, tmax, occ),
                                     shapes, dtypes):
        assert torch.equal(a, b) and torch.equal(a, c)
        assert tuple(a.shape) == shape and a.dtype == dtype and a.is_contiguous()
    assert ops.launch_counts == {"rounds_closest": 0, "rounds_any": 0, "bvh_frames": 0}
    assert ops_bvh.launch_counts == {"bvh_closest": 0, "bvh_any": 0, "bvh_steps": 0}
    culled = got.tmax == 0
    assert 0 < float(culled.float().mean()) < 1
    if occ is not None:  # an occluded ray is culled in every frame
        assert bool(culled.reshape(-1, R)[:, occ].all())
    assert tab.motion == (name == "moving5" or not hoist)


def test_scalar_bounds_and_no_rays():
    """times and tmax may be scalars (broadcast to the rays); no rays give
    empty lanes."""
    flat, tab, o, d, times, tmax, _ = _args("turned7")
    got = ops.frames(flat, tab, o, d, 0.0, 5.0)
    want = plain.frames(flat, tab, o, d, torch.zeros(R), torch.full((R,), 5.0))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    empty = ops.frames(flat, tab, o[:0], d[:0], times[:0], tmax[:0])
    assert [tuple(x.shape) for x in empty] == [(0, 3), (0, 3), (0,), (0,), (0,)]


def _bad(args, what):
    """K10's arguments (scene, table, origins, dirs, times, tmax, occ)
    with one of them made wrong."""
    a = list(args)
    tab = a[1]
    if what == "origins dtype":
        a[2] = a[2].double()
    elif what == "origins shape":
        a[2] = a[2][:, :2].contiguous()
    elif what == "dirs shape":
        a[3] = a[3][:-1]
    elif what == "dirs transposed":
        a[3] = a[3].t().contiguous().t()
    elif what == "times shape":
        a[4] = a[4][:, None]
    elif what == "tmax dtype":
        a[5] = a[5].half()
    elif what == "tmax broadcast":
        a[5] = a[5][:1].expand(a[5].shape[0])
    elif what == "occ dtype":
        a[6] = a[6].to(torch.uint8)
    elif what == "occ shape":
        a[6] = a[6][:-1]
    elif what == "table dtype":
        a[1] = dataclasses.replace(tab, table=tab.table.double())
    elif what == "table shape":
        a[1] = dataclasses.replace(tab, table=tab.table[:, :20].contiguous())
    elif what == "no instance":
        a[1] = dataclasses.replace(tab, table=tab.table[:0], prims=())
    return a


BAD = {"origins dtype": (TypeError, "origins"), "origins shape": (ValueError, "origins"),
       "dirs shape": (ValueError, "dirs: expected shape"),
       "dirs transposed": (ValueError, "dirs: expected a contiguous"),
       "times shape": (ValueError, "times: expected shape"),
       "tmax dtype": (TypeError, "tmax"),
       "tmax broadcast": (ValueError, "tmax: expected a contiguous"),
       "occ dtype": (TypeError, "occ"), "occ shape": (ValueError, "occ: expected shape"),
       "table dtype": (TypeError, "table"), "table shape": (ValueError, "table: expected shape"),
       "no instance": (ValueError, "instances"), "cpu tensors": (ValueError, "CUDA")}


@pytest.mark.parametrize("what", list(BAD))
def test_wrapper_refuses_bad_arguments(what):
    """Every argument check of K10's wrapper, reached with CPU tensors
    (dtype, shape, contiguity and sizes are checked before the device), in
    both forms; nothing is launched or counted."""
    args = _args("turned7", n=64)
    ops.reset_launch_counts()
    error, match = BAD[what]
    forms = [args] if what.startswith("occ") else [args, args[:6]]
    for a in forms:
        with pytest.raises(error, match=match):
            ops.frames_cuda(*_bad(a, what))
    assert ops.launch_counts == {"rounds_closest": 0, "rounds_any": 0, "bvh_frames": 0}


@pytest.mark.parametrize("name", ["envmesh", "moving5"])
def test_trace_hands_frames_what_the_kernel_takes(name, monkeypatch):
    """trace_closest / trace_any on at most 12 big instances make one
    ``frames`` call each, with what K10's wrapper checks on the card: f32
    contiguous world rays, (R,) times and bound, bool occlusion for the
    any-hit form, the scene's instance table; the walks then take its
    lanes unchanged."""
    flat, tab, o, d, times, tmax, _ = _args(name)
    calls, walks = [], []
    orig = ops.frames

    def rec(*a):
        calls.append(a)
        out = orig(*a)
        walks.append(out)
        return out

    monkeypatch.setattr(ops, "frames", rec)
    for fn in ("closest_hit", "any_hit"):
        orig_walk = getattr(ops_bvh, fn)

        def walk(pool, noff, toff, oo, dd, tm, slots, _orig=orig_walk):
            f = walks[-1]
            assert all(x is y for x, y in zip((oo, dd, tm, noff, toff), f))
            assert slots == tab.slots
            return _orig(pool, noff, toff, oo, dd, tm, slots)

        monkeypatch.setattr(ops_bvh, fn, walk)
    bound = torch.where(torch.isfinite(tmax), tmax, 20.0)
    trace.trace_closest(flat, o, d, times)
    trace.trace_any(flat, o, d, times, bound)
    assert len(calls) == 2
    for k, (scene, tab_, o_, d_, times_, tm, *occ) in enumerate(calls):
        assert scene is flat and tab_ is tab
        for t, dtype, shape in ((o_, torch.float32, (R, 3)), (d_, torch.float32, (R, 3)),
                                (times_, torch.float32, (R,)), (tm, torch.float32, (R,))):
            assert t.dtype == dtype and tuple(t.shape) == shape and t.is_contiguous()
        assert len(occ) == k  # the any-hit call passes the sweep's occlusion
        if occ:
            assert occ[0].dtype == torch.bool and tuple(occ[0].shape) == (R,)
