"""Kernel K10 (csrc/bvh.cu's bvh_frames_kernel, ops/instances.py::frames:
each (instance, ray) lane's local ray, bound and sub-BVH offsets for the
batch of at most 12 big instances) against its plain PyTorch version
(accel/instances.py::frames: world_inputs' torch ops, the rule tmax -> 0
where the root box is missed or the ray occluded, and the per-lane
offsets) on the card, and the trace through it against the trace through
the plain version. Every test needs an NVIDIA GPU and skips without one.

This file imports neither JAX nor tinsel_tpu, so it runs where JAX is not
installed, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_frames_cuda.py

Tolerance: none. K10 takes each ray into each instance's frame and tests
its root box with frame.cuh's functions, which follow the plain version's
order of operations under -fmad=false, so every output is equal bit for
bit (torch.equal). The cases: envmesh (one instance), 2, 7 and 12 turned
and scaled capsules, 5 of which two move, the hoist on and off; the rays
of test_torch_instances_cuda.py (best t / tmax +inf, finite and 0, a fifth
occluded), rays with direction components of exactly 0 and -0, from box
faces and edges and from inside boxes; 0, 1, 17, 4,099 and 2^18 rays.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_instances_cuda import cuda, rays, turned_capsules  # noqa: F401 (fixture)
from tinsel_tpu_torch.accel import instances as plain
from tinsel_tpu_torch.accel.sweep import layout
from tinsel_tpu_torch.ops import bvh as ops_bvh
from tinsel_tpu_torch.ops import instances as ops
from tinsel_tpu_torch.render import trace
from tinsel_tpu_torch.scene import model, presets, procedural

SCENES = {
    "envmesh": lambda: presets.envmesh_scene(64, 64, 4, detail=48),
    "turned2": lambda: turned_capsules(model, procedural, 2, seed=5),
    "turned7": lambda: turned_capsules(model, procedural, 7, seed=6),
    "turned12": lambda: turned_capsules(model, procedural, 12, seed=7),
    "moving5": lambda: turned_capsules(model, procedural, 5, moving=True, seed=8),
}
_FLATS = {}


def _flat(name, dev):
    if name not in _FLATS:
        _FLATS[name] = SCENES[name]().flatten(device=dev)
    return _FLATS[name]


def _big(flat, hoist=True):
    return list(layout(flat.prim_static, hoist).big)


def _inputs(flat, o, d, times, best, occ, hoist=True):
    """(scene, table, origins, dirs, times, tmax, occ) on the card."""
    dev = torch.device("cuda")
    tab = ops.table(flat, dev, hoist)
    return (flat, tab, *(torch.from_numpy(np.asarray(x, np.float32)).to(dev)
                         for x in (o, d, times, best)), torch.from_numpy(occ).to(dev))


def _assert_equal_plain(args):
    """One K10 launch a form (closest: no occlusion; any: with it), every
    output equal to the plain version's, bit for bit."""
    ops.reset_launch_counts()
    ops_bvh.reset_launch_counts()
    closest = ops.frames(*args[:6])
    occluded = ops.frames(*args)
    torch.cuda.synchronize()
    r = args[2].shape[0]
    assert ops.launch_counts == {"rounds_closest": 0, "rounds_any": 0,
                                 "bvh_frames": 2 if r else 0}
    assert ops_bvh.launch_counts == {"bvh_closest": 0, "bvh_any": 0, "bvh_steps": 0}
    for got, want in ((closest, plain.frames(*args[:6])), (occluded, plain.frames(*args))):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape and a.is_contiguous()
            assert torch.equal(a, b)
            # equal bits: the zeros' signs and the infinities too
            if a.dtype == torch.float32:
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    return closest, occluded


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 17, 4099])
@pytest.mark.parametrize("name", list(SCENES))
def test_kernel_equals_plain(cuda, name, lanes):  # noqa: F811 (fixture)
    flat = _flat(name, cuda)
    args = _inputs(flat, *rays(flat, _big(flat), lanes, lanes, moving=name == "moving5"))
    closest, occluded = _assert_equal_plain(args)
    assert args[1].motion == (name == "moving5")
    if lanes == 4099:  # some rays may hit a root box before their bound, some none
        live = (closest.tmax > 0).reshape(-1, lanes).any(dim=0)
        assert 0.05 < float(live.float().mean()) < 0.95
        # an occluded ray is culled in every frame
        occ = args[6]
        assert not bool(occluded.tmax.reshape(-1, lanes)[:, occ].any())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["envmesh", "turned7", "moving5"])
def test_kernel_equals_plain_with_the_hoist_off(cuda, name):  # noqa: F811 (fixture)
    """STATIC_TRANSFORM_HOIST off: every instance takes its transform at
    the ray's time, from the table packed for that setting."""
    flat = _flat(name, cuda)
    o, d, _, best, occ = rays(flat, _big(flat, False), 4099, 5)
    times = np.random.default_rng(6).random(len(o))
    args = _inputs(flat, o, d, times, best, occ, hoist=False)
    assert args[1].motion
    _assert_equal_plain(args)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["envmesh", "turned7", "moving5"])
def test_zero_directions_box_faces_and_inside(cuda, name):  # noqa: F811 (fixture)
    """Rays from points on the instances' box faces and edges (in world
    space), along an axis with the other two direction components exactly
    0 or -0, and rays from inside the boxes; bounds 0, +inf and finite; a
    tenth occluded."""
    flat = _flat(name, cuda)
    big = _big(flat)
    lo = np.array([flat.prim_static[i].mesh.root_lower for i in big], np.float32)
    hi = np.array([flat.prim_static[i].mesh.root_upper for i in big], np.float32)
    p = flat.prims.start_p.cpu().numpy()[big]
    s = flat.prims.start_s.cpu().numpy()[big][:, None]
    n = 3000
    rng = np.random.default_rng(4)
    k = rng.integers(len(big), size=n)
    u = rng.random((n, 3))
    face = rng.integers(3, size=n)
    u[np.arange(n), face] = rng.integers(2, size=n)
    edge = np.arange(0, n, 3)
    u[edge, (face[edge] + 1) % 3] = 1.0  # a third on an edge
    on = p[k] + s[k] * (lo[k] + u * (hi[k] - lo[k]))
    axis = rng.integers(3, size=n)
    d = np.zeros((n, 3), np.float32)
    d[np.arange(n), axis] = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    neg = rng.random((n, 3)) < 0.5
    d = np.where((d == 0) & neg, np.float32(-0.0), d)  # zeros of both signs
    inside = rng.random(n) < 0.3
    centre = p[k] + s[k] * 0.5 * (lo[k] + hi[k])
    o = np.where(inside[:, None], centre + rng.normal(size=(n, 3)) * 0.05, on)
    back = rng.random(n) < 0.5
    o = np.where((~inside & back)[:, None], on - 6.0 * d, o)  # else the face itself
    best = np.where(rng.random(n) < 0.6, np.inf, rng.uniform(0.0, 8, n))
    best[::7] = 0.0
    occ = rng.random(n) < 0.1
    times = rng.random(n) if name == "moving5" else np.zeros(n)
    args = _inputs(flat, o, d, times, best, occ)
    assert bool((torch.signbit(args[3]) & (args[3] == 0)).any())
    closest, _ = _assert_equal_plain(args)
    assert bool((closest.tmax == float("inf")).any())


@pytest.mark.cuda
def test_a_quarter_million_rays(cuda):  # noqa: F811 (fixture)
    flat = _flat("turned12", cuda)
    _assert_equal_plain(_inputs(flat, *rays(flat, _big(flat), 1 << 18, 3)))


@pytest.mark.cuda
def test_no_rays_no_launch(cuda):  # noqa: F811 (fixture)
    flat = _flat("turned7", cuda)
    e = np.zeros((0, 3), np.float32)
    args = _inputs(flat, e, e, np.zeros(0), np.zeros(0), np.zeros(0, bool))
    closest, occluded = _assert_equal_plain(args)
    n = 0
    for f in (closest, occluded):
        assert [tuple(x.shape) for x in f] == [(n, 3), (n, 3), (n,), (n,), (n,)]


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["table on the CPU", "occ on the CPU", "tmax on the CPU"])
def test_wrapper_refuses_tensors_off_the_rays_device(cuda, what):  # noqa: F811 (fixture)
    flat = _flat("turned2", cuda)
    args = list(_inputs(flat, *rays(flat, _big(flat), 64, 3)))
    if what == "table on the CPU":
        args[1] = dataclasses.replace(args[1], table=args[1].table.cpu())
    else:
        i = 6 if what.startswith("occ") else 5
        args[i] = args[i].cpu()
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        ops.frames_cuda(*args)
    assert ops.launch_counts["bvh_frames"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENES))
def test_trace_equals_the_trace_through_world_inputs(cuda, name, monkeypatch):  # noqa: F811
    """trace_closest / trace_any through K10 give the same t, prim, normal
    and occlusion as with the plain version (world_inputs' torch ops) in
    its place: one K10 and one K3 launch a closest call, one K10 and one
    K4 launch an occlusion call."""
    flat = _flat(name, cuda)
    big = _big(flat)
    o, d, times, best, _ = (torch.from_numpy(a).to(cuda)
                            for a in rays(flat, big, 5000, 9, moving=name == "moving5"))
    tmax = torch.where(torch.isfinite(best), best, 20.0)
    ops.reset_launch_counts()
    ops_bvh.reset_launch_counts()
    hit = trace.trace_closest(flat, o, d, times)
    torch.cuda.synchronize()
    assert ops.launch_counts == {"rounds_closest": 0, "rounds_any": 0, "bvh_frames": 1}
    assert ops_bvh.launch_counts == {"bvh_closest": 1, "bvh_any": 0, "bvh_steps": 0}
    occ = trace.trace_any(flat, o, d, times, tmax)
    torch.cuda.synchronize()
    assert ops.launch_counts == {"rounds_closest": 0, "rounds_any": 0, "bvh_frames": 2}
    assert ops_bvh.launch_counts == {"bvh_closest": 1, "bvh_any": 1, "bvh_steps": 0}
    monkeypatch.setattr(ops, "frames", plain.frames)
    ref = trace.trace_closest(flat, o, d, times)
    assert torch.equal(hit.t, ref.t) and torch.equal(hit.prim, ref.prim)
    assert torch.equal(hit.normal, ref.normal)
    assert torch.equal(occ, trace.trace_any(flat, o, d, times, tmax))
    assert ops.launch_counts["bvh_frames"] == 2  # the plain version launched nothing
    on_big = torch.isin(hit.prim, torch.tensor(big, dtype=hit.prim.dtype, device=cuda))
    assert 0.05 < float(on_big.float().mean())


@pytest.mark.cuda
def test_one_trace_any_on_envmesh_adds_one_frames_and_one_walk(cuda):  # noqa: F811
    flat = _flat("envmesh", cuda)
    o, d, times, best, _ = (torch.from_numpy(a).to(cuda) for a in rays(flat, _big(flat), 999, 2))
    trace.trace_any(flat, o, d, times, 1.0)  # the table packed and the kernels built
    torch.cuda.synchronize()
    before = {**ops.launch_counts, **ops_bvh.launch_counts}
    trace.trace_any(flat, o, d, times, torch.where(torch.isfinite(best), best, 20.0))
    torch.cuda.synchronize()
    after = {**ops.launch_counts, **ops_bvh.launch_counts}
    assert {k: after[k] - before[k] for k in after} == {
        "rounds_closest": 0, "rounds_any": 0, "bvh_frames": 1, "bvh_closest": 0, "bvh_any": 1,
        "bvh_steps": 0}
