"""The instance shortlist rounds as kernels K6c (closest hit) and K6a
(occlusion), csrc/bvh.cu, against their plain PyTorch version
(accel/instances.py::rounds_closest_world / rounds_any_world: the world
rays taken into every instance's frame by torch ops, then torch ops
around kernels K3 / K4) on the card. Every test needs an NVIDIA GPU and
skips without one.

This file imports neither JAX nor tinsel_tpu, so it runs where JAX is not
installed, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_instances_cuda.py

Tolerance: none. K6 takes each ray into each instance's frame and tests
its root box with the plain version's component formulas and walks with
K3 / K4's code, all under -fmad=false, and mirrors the plain round (the
picks in (entry, id) order, every pick under the round-start best t, the
first of the least t), so t, the triangle, the instance and the occlusion
bit are equal on every lane, t bit for bit. The cases: instances16,
many_mesh (48 meshes, 32 big), the 81-instance grid, a line of 21 sphere
instances whose boxes a ray can cross without a hit (ceil(21 / 4) rounds,
two instances with equal box entries and equal hits), 144 turned and
scaled capsules (above the 128 instances whose entries a lane keeps in
registers) and 40 of which a third move, the hoist on and off; rays from
inside the boxes and along their faces; best t finite, +inf and 0; rays
already occluded; 0, 1, 17 and 4,099 rays. Through trace_closest /
trace_any each call is one launch and no K3 / K4 launch. The wrappers
refuse bad arguments. A many_mesh call allocates less than one (I, R)
f32 table.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tinsel_tpu_torch.accel import instances as plain
from tinsel_tpu_torch.accel.sweep import layout
from tinsel_tpu_torch.ops import bvh as ops_bvh
from tinsel_tpu_torch.ops import instances as ops
from tinsel_tpu_torch.render import trace
from tinsel_tpu_torch.scene import model, presets, procedural

LINE = 21  # spheres in a line


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def sphere_line(model, procedural):
    """LINE - 1 instances of one 256-triangle sphere of radius 0.5 along x
    at y = 0.5, 1.05 apart, and one more on the fourth (equal box entries
    and equal hits: the lower id wins). A ray along x through the corners
    of the boxes' cross-section passes every box and misses every sphere:
    with best t +inf it takes ceil(LINE / 4) rounds."""
    sc = model.Scene()
    m = procedural.sphere(0.5, 8, 16)
    m.build()
    for i in [*range(LINE - 1), 3]:
        sc.add_primitive(model.Primitive(type=model.MESH, mesh=m, start_transform=(
            model.HostTransform(p=np.array([1.05 * (i - (LINE - 2) / 2), 0.5, 0.0], np.float32)))))
    return sc


def turned_capsules(model, procedural, n, moving=False, seed=0):
    """n instances of one 576-triangle capsule on a grid over [-5, 5] in x
    and z, each turned by a random rotation (a unit quaternion) and scaled
    by 0.6 to 1.4; with ``moving``, every third one ends elsewhere, turned
    and scaled again (the whole batch then interpolates at the ray's
    time)."""
    rng = np.random.default_rng(seed)
    sc = model.Scene()
    m = procedural.capsule(radius=0.3, half_height=0.25, slices=12, segments=24)
    m.build()
    side = int(np.ceil(np.sqrt(n)))

    def turned(p):
        q = rng.normal(size=4)
        return model.HostTransform(p=p.astype(np.float32),
                                   q=(q / np.linalg.norm(q)).astype(np.float32),
                                   s=float(rng.uniform(0.6, 1.4)))

    for i in range(n):
        p = np.array([-5 + 10 * (i % side + 0.5) / side, rng.uniform(0.5, 2.5),
                      -5 + 10 * (i // side + 0.5) / side])
        end = turned(p + rng.normal(size=3) * 0.3) if moving and i % 3 == 0 else None
        sc.add_primitive(model.Primitive(type=model.MESH, mesh=m, start_transform=turned(p),
                                         end_transform=end))
    return sc


def rays(flat, big, n, seed, line=False, moving=False):
    """n rays from above the floor: a third aimed at a random big
    primitive's centre, a third nearly level across the field at the
    height of the primitives' tops (through many instance boxes, missing
    most primitives in them: several rounds; with ``line``, along the line
    of spheres through the corners of their boxes), a third in random
    directions; best t (and tmax) +inf, finite or 0, and a fifth of the
    rays already occluded; times 0, or in [0, 1) with ``moving``. Numpy
    (o, d, times, best t, occluded)."""
    rng = np.random.default_rng(seed)
    p = flat.prims.start_p.cpu().numpy()[np.asarray(big)]
    o = np.stack([rng.uniform(-6, 6, n), rng.uniform(0.05, 4, n), rng.uniform(-6, 9, n)], -1)
    aim = p[rng.integers(len(big), size=n)] + rng.normal(size=(n, 3)) * 0.3 - o
    ang = rng.uniform(0, 2 * np.pi, n)
    y = rng.uniform(0.9, 1.1, n)
    level = np.stack([8 * np.cos(ang), y, 8 * np.sin(ang)], -1)
    half = np.abs(p).max(0)
    through = np.stack([rng.uniform(-half[0], half[0], n), y + rng.normal(size=n) * 0.02,
                        rng.uniform(-half[2], half[2], n)], -1)
    level_d = through - level
    third = np.arange(n) % 3
    o = np.where(third[:, None] == 1, level, o)
    d = np.where(third[:, None] == 0, aim, np.where(third[:, None] == 1, level_d,
                                                    rng.normal(size=(n, 3))))
    if line:  # the second third through the boxes' corners along the line
        corner = np.sign(rng.random((n, 2)) - 0.5) * rng.uniform(0.38, 0.48, (n, 2))
        end = np.where(rng.random(n) < 0.5, -13.0, 13.0)
        o = np.where(third[:, None] == 1, np.stack([end, 0.5 + corner[:, 0], corner[:, 1]], -1), o)
        along = np.stack([-np.sign(end), np.zeros(n), np.zeros(n)], -1)
        along[::6, 1:] = rng.normal(size=(len(along[::6]), 2)) * 1e-3  # some not axis-aligned
        d = np.where(third[:, None] == 1, along, d)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    u = rng.random(n)
    best = np.where(u < 0.45, np.inf, np.where(u < 0.95, rng.uniform(0.5, 12, n), 0.0))
    occ0 = rng.random(n) < 0.2
    times = rng.random(n) if moving else np.zeros(n)
    return (o.astype(np.float32), d.astype(np.float32), times.astype(np.float32),
            best.astype(np.float32), occ0)


SCENES = {
    "instances16": lambda: presets.instances_scene(32, 32, 3, grid=4),
    "many_mesh": lambda: presets.many_mesh_scene(48, 32, 32, 2),
    "grid81": lambda: presets.instances_scene(32, 32, 3, grid=9),
    "line21": lambda: sphere_line(model, procedural),
    "turned144": lambda: turned_capsules(model, procedural, 144, seed=1),
    "moving40": lambda: turned_capsules(model, procedural, 40, moving=True, seed=2),
}
_FLATS = {}


def _flat(name, dev):
    if name not in _FLATS:
        _FLATS[name] = SCENES[name]().flatten(device=dev)
    return _FLATS[name]


def inputs(flat, o, d, times, best, occ0, hoist=True):
    """The rounds' arguments as trace_closest / trace_any build them:
    (closest args, any args)."""
    tab = ops.table(flat, o.device, hoist)
    tmax = torch.where(occ0, 0.0, best)
    return (flat, tab, o, d, times, best), (flat, tab, o, d, times, tmax, occ0)


def _case_rays(name, flat, lanes, seed):
    big = list(layout(flat.prim_static).big)
    return rays(flat, big, lanes, seed, line=name == "line21", moving=name == "moving40")


def _assert_equal_plain(closest_args, any_args):
    """One launch of each kernel, each equal to the plain rounds on every
    lane, t bit for bit."""
    ops.reset_launch_counts()
    ops_bvh.reset_launch_counts()
    got = ops.rounds_closest(*closest_args)
    occ = ops.rounds_any(*any_args)
    torch.cuda.synchronize()
    assert ops.launch_counts == {"rounds_closest": 1, "rounds_any": 1, "bvh_frames": 0}
    assert ops_bvh.launch_counts == {"bvh_closest": 0, "bvh_any": 0, "bvh_steps": 0}
    want = plain.rounds_closest_world(*closest_args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(occ, plain.rounds_any_world(*any_args))
    return got, occ


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 17, 4099])
@pytest.mark.parametrize("name", list(SCENES))
def test_kernels_equal_plain(cuda, name, lanes):
    flat = _flat(name, cuda)
    args = inputs(flat, *(torch.from_numpy(a).to(cuda) for a in _case_rays(name, flat, lanes,
                                                                            lanes)))
    (t, tri, inst), occ = _assert_equal_plain(*args)
    if lanes == 4099:
        assert 0.1 < float((tri >= 0).float().mean()) < 0.9
        assert bool(occ[args[1][6]].all())  # already occluded stays so
    if name == "line21" and lanes == 4099:
        # rays through every box without a hit: ceil(21 / 4) rounds
        tn = plain.world_inputs(*args[0])[2]
        assert int(torch.isfinite(tn).sum(0).max()) == LINE


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["instances16", "many_mesh", "moving40", "turned144"])
def test_kernels_equal_plain_with_the_hoist_off(cuda, name):
    """STATIC_TRANSFORM_HOIST off: every instance takes its transform at
    the ray's time (the nlerp of a static rotation may move it by an ulp),
    from the table packed for that setting."""
    flat = _flat(name, cuda)
    o, d, _, best, occ0 = _case_rays(name, flat, 4099, 5)
    times = np.random.default_rng(6).random(len(o)).astype(np.float32)
    args = inputs(flat, *(torch.from_numpy(a).to(cuda) for a in (o, d, times, best, occ0)),
                  hoist=False)
    assert args[0][1].motion
    assert ops.table(flat, cuda, True).motion == (name == "moving40")
    _assert_equal_plain(*args)


@pytest.mark.cuda
def test_equal_entries_and_equal_hits_take_the_lower_instance(cuda):
    """Rays from above onto the fourth sphere of the line, which two
    instances (3 and LINE - 1) share: equal entries, equal t."""
    flat = _flat("line21", cuda)
    n = 257
    x = 1.05 * (3 - (LINE - 2) / 2)
    rng = np.random.default_rng(2)
    o = np.stack([x + rng.uniform(-0.3, 0.3, n), np.full(n, 3.0), rng.uniform(-0.3, 0.3, n)], -1)
    d = np.tile(np.array([[0.0, -1.0, 0.0]]), (n, 1))
    best = np.full(n, np.inf)
    args = inputs(flat, *(torch.from_numpy(a.astype(np.float32)).to(cuda)
                          for a in (o, d, np.zeros(n), best)),
                  torch.zeros(n, dtype=torch.bool, device=cuda))
    tn = plain.world_inputs(*args[0])[2]
    assert torch.equal(tn[3], tn[LINE - 1]) and bool(torch.isfinite(tn[3]).all())
    (t, tri, inst), occ = _assert_equal_plain(*args)
    assert bool((tri >= 0).all()) and bool((inst == 3).all()) and bool(occ.all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["grid81", "line21"])
def test_rays_on_box_faces_and_from_inside_boxes(cuda, name):
    """Rays that start inside instance boxes (entry 0, many ties), run
    along box faces and edges, or graze them with zero direction
    components."""
    flat = _flat(name, cuda)
    big = list(layout(flat.prim_static).big)
    lo = np.array([flat.prim_static[i].mesh.root_lower for i in big], np.float32)
    hi = np.array([flat.prim_static[i].mesh.root_upper for i in big], np.float32)
    p = flat.prims.start_p.cpu().numpy()[big]
    s = flat.prims.start_s.cpu().numpy()[big][:, None]
    n = 3000
    rng = np.random.default_rng(4)
    k = rng.integers(len(big), size=n)
    # a point on a face or an edge of instance k's box, in world space
    u = rng.random((n, 3))
    face = rng.integers(3, size=n)
    u[np.arange(n), face] = rng.integers(2, size=n)
    edge = np.arange(0, n, 3)
    u[edge, (face[edge] + 1) % 3] = 1.0  # a third on an edge
    on = p[k] + s[k] * (lo[k] + u * (hi[k] - lo[k]))
    axis = rng.integers(3, size=n)
    d = np.zeros((n, 3), np.float32)
    d[np.arange(n), axis] = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    inside = rng.random(n) < 0.3
    centre = p[k] + s[k] * 0.5 * (lo[k] + hi[k])
    o = np.where(inside[:, None], centre + rng.normal(size=(n, 3)) * 0.05, on - 6.0 * d)
    d[inside] = rng.normal(size=(int(inside.sum()), 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    best = np.where(rng.random(n) < 0.7, np.inf, rng.uniform(0.01, 8, n))
    occ0 = rng.random(n) < 0.1
    args = inputs(flat, *(torch.from_numpy(a.astype(np.float32)).to(cuda)
                          for a in (o, d, np.zeros(n), best)), torch.from_numpy(occ0).to(cuda))
    _assert_equal_plain(*args)


@pytest.mark.cuda
def test_no_rays_no_launch(cuda):
    flat = _flat("instances16", cuda)
    e = torch.zeros((0, 3), device=cuda)
    args = inputs(flat, e, e, torch.zeros(0, device=cuda), torch.zeros(0, device=cuda),
                  torch.zeros(0, dtype=torch.bool, device=cuda))
    ops.reset_launch_counts()
    t, tri, inst = ops.rounds_closest(*args[0])
    occ = ops.rounds_any(*args[1])
    torch.cuda.synchronize()
    assert t.shape == tri.shape == inst.shape == occ.shape == (0,)
    assert ops.launch_counts == {"rounds_closest": 0, "rounds_any": 0, "bvh_frames": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["instances16", "many_mesh", "grid81"])
def test_one_launch_a_trace_call(cuda, name, monkeypatch):
    """trace_closest / trace_any above INSTANCE_TOPK_MIN big instances: one
    K6c / K6a launch a call and no K3 / K4 launch (every big mesh is an
    instance of the rounds); the hits equal those through the plain
    rounds."""
    flat = _flat(name, cuda)
    assert len(layout(flat.prim_static).big) > trace.INSTANCE_TOPK_MIN
    big = list(layout(flat.prim_static).big)
    o, d, times, best, _ = (torch.from_numpy(a).to(cuda) for a in rays(flat, big, 5000, 9))
    tmax = torch.where(torch.isfinite(best), best, 20.0)
    ops.reset_launch_counts()
    ops_bvh.reset_launch_counts()
    hit = trace.trace_closest(flat, o, d, times)
    occ = trace.trace_any(flat, o, d, times, tmax)
    torch.cuda.synchronize()
    assert ops.launch_counts == {"rounds_closest": 1, "rounds_any": 1, "bvh_frames": 0}
    assert ops_bvh.launch_counts == {"bvh_closest": 0, "bvh_any": 0, "bvh_steps": 0}
    monkeypatch.setattr(ops, "rounds_closest", plain.rounds_closest_world)
    monkeypatch.setattr(ops, "rounds_any", plain.rounds_any_world)
    ref = trace.trace_closest(flat, o, d, times)
    assert torch.equal(hit.t, ref.t) and torch.equal(hit.prim, ref.prim)
    assert torch.equal(hit.normal, ref.normal)
    assert torch.equal(occ, trace.trace_any(flat, o, d, times, tmax))
    assert 0.05 < float((hit.prim >= 0).float().mean()) < 0.95


@pytest.mark.cuda
def test_a_many_mesh_call_allocates_less_than_one_instance_ray_table(cuda):
    """K6c / K6a on many_mesh's 32 big instances and 2^18 rays: the peak
    allocation of each call above what was allocated before it stays below
    one (I, R) f32 table (the kernels allocate their outputs only)."""
    flat = _flat("many_mesh", cuda)
    n = 1 << 18
    args = inputs(flat, *(torch.from_numpy(a).to(cuda) for a in _case_rays("many_mesh", flat,
                                                                            n, 8)))
    n_inst = len(args[0][1].prims)
    assert n_inst == 32
    for fn, a in ((ops.rounds_closest, args[0]), (ops.rounds_any, args[1])):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*a)
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - base < 4 * n_inst * n
        del out


def _bad(args, what, dev):
    a = list(args)
    tab = a[1]
    if what == "origins dtype":
        a[2] = a[2].double()
    elif what == "times shape":
        a[4] = a[4][:-1]
    elif what == "dirs transposed":
        a[3] = a[3].t().contiguous().t()
    elif what == "table dtype":
        a[1] = dataclasses.replace(tab, table=tab.table.double())
    elif what == "best on the CPU":
        a[5] = a[5].cpu()
    elif what == "stack slots":
        a[1] = dataclasses.replace(tab, slots=200)
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["origins dtype", "times shape", "dirs transposed",
                                  "table dtype", "best on the CPU", "stack slots"])
def test_wrappers_refuse_bad_arguments(cuda, what):
    flat = _flat("instances16", cuda)
    big = list(layout(flat.prim_static).big)
    args = inputs(flat, *(torch.from_numpy(a).to(cuda) for a in rays(flat, big, 64, 3)))
    ops.reset_launch_counts()
    for fn, a in ((ops.rounds_closest, args[0]), (ops.rounds_any, args[1])):
        with pytest.raises((TypeError, ValueError)):
            fn(*_bad(a, what, cuda))
    assert ops.launch_counts == {"rounds_closest": 0, "rounds_any": 0, "bvh_frames": 0}
