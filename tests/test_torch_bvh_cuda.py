"""The CUDA BVH walks (kernels K3 and K4, csrc/bvh.cu) against their plain
PyTorch versions (accel/traverse.py) on the card, and the big-mesh render
on the card against the CPU at equal draws. Every test needs an NVIDIA GPU
and skips without one.

This file imports neither JAX nor tinsel_tpu, so it runs where JAX is not
installed, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_bvh_cuda.py

Tolerance: none. csrc/bvh.cu is compiled with -fmad=false, so the kernels
round every product and sum as the plain version's separate torch ops do,
and t and the winning triangle are equal bit for bit. The cases aim at
what a half-warp per ray can get wrong: ties in t within a block and
across leaf children, shared edges and vertices, part-filled blocks,
offsets that change within a warp, stack overflow, and culled lanes
(tmax 0, -0.0, NaN) beside +inf ones. K7 takes no tmax (the complexity
view walks unbounded rays): it is held against the plain count with
tmax = +inf, where a ray that misses every child of the root counts 1.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tinsel_tpu_torch.accel import traverse as plain
from tinsel_tpu_torch.core.sampling import NumpyUniforms
from tinsel_tpu_torch.ops import bvh as ops
from tinsel_tpu_torch.render.renderer import render
from tinsel_tpu_torch.scene import model, presets, procedural


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _soup(n, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-2, 2, (n, 1, 3))
    size = rng.choice([0.02, 0.2, 1.0], (n, 1, 1))
    pos = (c + rng.normal(size=(n, 3, 3)) * size).reshape(-1, 3).astype(np.float32)
    return model.Mesh(pos, np.arange(3 * n, dtype=np.int32).reshape(n, 3))


def _pool(dev):
    """Three meshes in one pool: a random soup (deep tree), a UV sphere and
    a disc (flat boxes)."""
    sc = model.Scene()
    for m in (_soup(3000, 1), procedural.sphere(1.5, 24, 48), procedural.disc(1.0, 40)):
        sc.add_primitive(model.Primitive(type=model.MESH, mesh=m))
    flat = sc.flatten(device=dev)
    return flat.pool, [p.mesh for p in flat.prim_static]


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = (rng.uniform(-1, 1, (n, 3)) - 0.3 * o).astype(np.float32)
    # a sixth of the lanes axis-aligned: zero direction components
    axis = rng.integers(0, 3, n)
    aligned = np.arange(n) % 6 == 0
    d[aligned] = 0.0
    d[aligned, axis[aligned]] = -np.sign(o[aligned, axis[aligned]])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    u = rng.random(n)
    tmax = np.where(u < 0.6, np.inf, np.where(u < 0.9, rng.uniform(0, 5, n), 0.0))
    return o, d, tmax.astype(np.float32)


def _per_lane(handles, n, dev):
    which = np.arange(n) % len(handles)
    noff = np.array([h.node_offset for h in handles], np.int32)[which]
    toff = np.array([h.tri_offset for h in handles], np.int32)[which]
    return (torch.from_numpy(noff).to(dev), torch.from_numpy(toff).to(dev),
            max(h.stack_slots for h in handles))


def _with_culled(tmax, seed):
    """A fifth of the lanes culled with tmax 0, -0.0 or NaN (the kernels'
    early exit), and some +inf, mixed within every warp."""
    rng = np.random.default_rng(seed)
    tmax = tmax.copy()
    pick = rng.random(tmax.shape[0])
    tmax[pick < 0.2] = rng.choice(np.array([0.0, -0.0, np.nan, np.inf], np.float32),
                                  int((pick < 0.2).sum()))
    return tmax


def _assert_equal_plain(pool, noff, toff, o, d, tmax, slots):
    """Both kernels, one launch each, against both plain walks: equal bit
    for bit; culled lanes (tmax <= 0 or NaN) miss."""
    ops.reset_launch_counts()
    t, tri = ops.closest_hit(pool, noff, toff, o, d, tmax, slots)
    occ = ops.any_hit(pool, noff, toff, o, d, tmax, slots)
    torch.cuda.synchronize()
    assert ops.launch_counts == {"bvh_closest": 1, "bvh_any": 1, "bvh_steps": 0}
    t_ref, tri_ref = plain.intersect_mesh(pool, noff, toff, o, d, tmax, stack_slots=slots)
    occ_ref = plain.intersect_mesh_any(pool, noff, toff, o, d, tmax, stack_slots=slots)
    assert torch.equal(t, t_ref)
    assert torch.equal(tri, tri_ref)
    assert torch.equal(occ, occ_ref)
    culled = ~(tmax > 0)
    assert not occ[culled].any() and not torch.isfinite(t[culled]).any()
    assert (tri[culled] == -1).all()
    return t, tri, occ


@pytest.mark.cuda
@pytest.mark.parametrize("culled", [False, True])
@pytest.mark.parametrize("lanes", [1, 7, 9, 127, 4099])
def test_kernels_equal_plain_per_lane_offsets(cuda, lanes, culled):
    """Lane counts that leave a block part-filled (8 rays a block), and
    offsets that change from ray to ray within a warp."""
    pool, handles = _pool(cuda)
    o, d, tmax = _rays(lanes, lanes)
    if culled:
        tmax = _with_culled(tmax, lanes)
    o, d, tmax = (torch.from_numpy(a).to(cuda) for a in (o, d, tmax))
    noff, toff, slots = _per_lane(handles, lanes, cuda)
    t, _, _ = _assert_equal_plain(pool, noff, toff, o, d, tmax, slots)
    if lanes > 1000:
        assert 0.2 < float(torch.isfinite(t).float().mean()) < 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("mesh,lanes", [(0, 2048), (1, 2048), (2, 2048),
                                        (0, 65536)])  # the soup at a full launch
def test_kernels_equal_plain_scalar_offsets(cuda, mesh, lanes):
    pool, handles = _pool(cuda)
    h = handles[mesh]
    o, d, tmax = _rays(lanes, 7 + mesh)
    o, d, tmax = (torch.from_numpy(a).to(cuda) for a in (o, d, _with_culled(tmax, mesh)))
    _assert_equal_plain(pool, h.node_offset, h.tri_offset, o, d, tmax, h.stack_slots)


def _sequential(pool, node_offset, tri_offset, o, d, tmax, slots, any_hit, steps=False):
    """The walk one ray at a time, in csrc/bvh.cu's order, with torch ops
    on the CPU: a push past ``slots`` entries is dropped and a pop past
    them ends the walk (the plain lockstep walk does not take a stack
    smaller than its walks need). ``steps``: return the closest-hit walk's
    step counts instead (one per node visited, one per block tested)."""
    pool = dataclasses.replace(pool, node_rows=pool.node_rows.cpu(),
                               block_rows=pool.block_rows.cpu())
    lo, hi, words = plain._decode_nodes(pool.node_rows)
    o, d, tmax = o.cpu(), d.cpu(), tmax.cpu()
    rd = plain._safe_rcp3(d)
    n = o.shape[0]
    noff = plain._lanes(node_offset, n, "cpu").tolist()
    bbase = (plain._lanes(tri_offset, n, "cpu") // 16).tolist()
    t_out = torch.full((n,), float("inf"))
    tri_out = torch.full((n,), -1, dtype=torch.int32)
    steps_out = torch.zeros((n,))
    for i in range(n):
        best_t, best_tri = float(tmax[i]), -1
        stack, sp, cur, lc, ic = [0] * slots, 0, 0, 0, 0
        while cur >= 0:
            steps_out[i] += 1
            node = noff[i] + cur
            t0 = (lo[node] - o[i][:, None]) * rd[i][:, None]  # (3, 16)
            t1 = (hi[node] - o[i][:, None]) * rd[i][:, None]
            near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
            tn = torch.maximum(torch.maximum(near[0], near[1]),
                               torch.maximum(near[2], torch.zeros(16)))
            tf = torch.minimum(torch.minimum(far[0], far[1]), far[2])
            tn = torch.where(tn <= tf, tn, float("nan")).tolist()  # NaN: a miss
            w = words[node].tolist()
            for c in range(lc, 16):  # leaf children, each under the current best t
                if w[c] >= 0 or not tn[c] < best_t:
                    continue
                steps_out[i] += 1
                b = pool.block_rows[bbase[i] + ~w[c]].reshape(12, 16)
                hit, t = plain._tri_hit(b[0:3], b[3:6], b[6:9], o[i], d[i])
                t = torch.where(hit & (t < best_t), t, plain.INF)
                if float(t.min()) < best_t:
                    best_t, best_tri = float(t.min()), ~w[c] * 16 + int(t.argmin())
                    if any_hit:
                        break
            if any_hit and best_tri >= 0:
                break
            hits = [c for c in range(ic, 16) if w[c] >= 0 and tn[c] < best_t]
            if hits:
                if len(hits) > 1:
                    if sp < slots:
                        stack[sp] = (cur << 4) | hits[1]
                    sp += 1
                cur, ic, lc = w[hits[0]], 0, 0
            elif sp > 0:
                sp -= 1
                e = stack[sp] if sp < slots else -1
                cur, ic, lc = (-1 if e < 0 else e >> 4), e & 15, 16
            else:
                cur = -1
        if best_tri >= 0:
            t_out[i], tri_out[i] = best_t, best_tri
    if steps:
        return steps_out
    return (tri_out >= 0) if any_hit else (t_out, tri_out)


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [1, 2])
def test_stack_overflow_as_the_sequential_walk(cuda, slots):
    """The soup's walks need 2 stack entries: with 1 the pushes past it
    are dropped; with 2 the stack fits exactly."""
    pool, handles = _pool(cuda)
    h = handles[0]
    assert h.stack_slots == 2
    o, d, tmax = _rays(512, 11)
    o, d, tmax = (torch.from_numpy(a).to(cuda) for a in (o, d, _with_culled(tmax, 11)))
    args = (pool, h.node_offset, h.tri_offset, o, d, tmax, slots)
    t, tri = ops.closest_hit(*args)
    occ = ops.any_hit(*args)
    t_ref, tri_ref = _sequential(*args, any_hit=False)
    assert torch.equal(t.cpu(), t_ref) and torch.equal(tri.cpu(), tri_ref)
    assert torch.equal(occ.cpu(), _sequential(*args, any_hit=True))
    if slots == h.stack_slots:
        want = plain.intersect_mesh(pool, h.node_offset, h.tri_offset, o, d, tmax,
                                    stack_slots=slots)
        assert torch.equal(t, want[0]) and torch.equal(tri, want[1])
    # K7 on the same rays (unbounded)
    inf = torch.full_like(tmax, float("inf"))
    steps = ops.traversal_steps(pool, h.node_offset, h.tri_offset, o, d, slots)
    want = _sequential(pool, h.node_offset, h.tri_offset, o, d, inf, slots, False, steps=True)
    assert torch.equal(steps.cpu(), want)
    if slots == h.stack_slots:
        assert torch.equal(steps, plain.traversal_cost(pool, h.node_offset, h.tri_offset, o, d,
                                                       inf, stack_slots=slots))


def _assert_steps_equal_plain(pool, noff, toff, o, d, slots):
    """K7, one launch, against the plain count with tmax = +inf: equal on
    every lane."""
    before = ops.launch_counts["bvh_steps"]
    steps = ops.traversal_steps(pool, noff, toff, o, d, slots)
    torch.cuda.synchronize()
    assert ops.launch_counts["bvh_steps"] == before + 1
    inf = torch.full((o.shape[0],), float("inf"), device=o.device)
    want = plain.traversal_cost(pool, noff, toff, o, d, inf, stack_slots=slots)
    assert steps.dtype == torch.float32 and torch.equal(steps, want)
    assert (steps >= 1).all()
    return steps


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 7, 9, 127, 4099])
def test_steps_kernel_equals_plain_per_lane_offsets(cuda, lanes):
    """K7 with offsets that change from ray to ray within a warp, at lane
    counts that leave a block part-filled."""
    pool, handles = _pool(cuda)
    o, d, _ = _rays(lanes, lanes)
    o, d = (torch.from_numpy(a).to(cuda) for a in (o, d))
    noff, toff, slots = _per_lane(handles, lanes, cuda)
    steps = _assert_steps_equal_plain(pool, noff, toff, o, d, slots)
    if lanes > 1000:
        assert float(steps.max()) > 16 and float((steps == 1).float().mean()) > 0.05


@pytest.mark.cuda
def test_steps_kernel_on_the_soup_and_the_524k_sphere(cuda):
    """The soup (a deep tree) at a full launch, then the 524,288-triangle
    UV sphere: 65,536 rays aimed at its middle and rays that miss the
    root's children, which count 1 (the root's step)."""
    pool, handles = _pool(cuda)
    h = handles[0]
    o, d, _ = _rays(65536, 21)
    o, d = (torch.from_numpy(a).to(cuda) for a in (o, d))
    _assert_steps_equal_plain(pool, h.node_offset, h.tri_offset, o, d, h.stack_slots)

    m = procedural.sphere(radius=1.0, n_theta=512, n_phi=512)
    sc = model.Scene()
    sc.add_primitive(model.Primitive(type=model.MESH, mesh=m))
    flat = sc.flatten(device=cuda)
    h = flat.prim_static[0].mesh
    assert h.real_tris == 524288
    rng = np.random.default_rng(5)
    n = 65536
    o = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.6, 0.6, n), np.full(n, -3.0)], -1)
    d = np.tile([0.0, 0.0, 1.0], (n, 1)) + rng.normal(size=(n, 3)) * 0.02
    o[: n // 8, 2] = 5.0  # behind the sphere, looking away: miss the root's children
    o, d = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (o, d))
    steps = _assert_steps_equal_plain(flat.pool, h.node_offset, h.tri_offset, o, d,
                                      h.stack_slots)
    assert (steps[: n // 8] == 1).all() and float(steps[n // 8:].min()) > 1


@pytest.mark.cuda
def test_complexity_view_on_the_card_matches_the_cpu(cuda):
    """mode="complexity" on many_mesh (big meshes in one K7 launch with
    per-lane offsets, tiny meshes at their constant, the floor at 1) and on
    envmesh: equal costs on the same rays on the card and on the CPU, and
    the rendered views equal on 99% of the pixels (the camera rays are
    computed on each device and may differ in the last bit, which can move
    a ray across a box's edge)."""
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.render.integrator import traversal_costs

    for sc in (presets.many_mesh_scene(20, 48, 48, 1), presets.envmesh_scene(48, 48, 1, detail=48)):
        sc.options.mode = "complexity"
        ops.reset_launch_counts()
        a = render(sc, spp=2, device=cuda, source=NumpyUniforms(5, cuda)).cpu()
        assert ops.launch_counts == {"bvh_closest": 0, "bvh_any": 0, "bvh_steps": 1}
        b = render(sc, spp=2, device="cpu", source=NumpyUniforms(5, "cpu"))
        close = torch.isclose(a, b, atol=1e-4, rtol=1e-3).all(dim=-1)
        assert float(close.float().mean()) >= 0.99
        flat, cam = sc.flatten(cuda), CameraParams.from_host(sc.camera, cuda)
        rng = np.random.default_rng(1)
        o = cam.position.expand(4096, 3).contiguous()
        d = torch.from_numpy(rng.normal(size=(4096, 3)).astype(np.float32)).to(cuda)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        t = torch.zeros(4096, device=cuda)
        cpu = sc.flatten("cpu")
        assert torch.equal(traversal_costs(flat, o, d, t).cpu(),
                           traversal_costs(cpu, o.cpu(), d.cpu(), t.cpu()))


def _duplicates():
    """40 copies of one triangle and 24 triangles twice each: equal t in
    one block and across leaf children of one node."""
    rng = np.random.default_rng(0)
    base = np.array([[-1, 0, -1], [1, 0, -1], [0, 0, 1]], np.float32)
    tris = [base] * 40
    for _ in range(24):
        c = rng.uniform(-2, 2, 3).astype(np.float32)
        tri = c + rng.normal(size=(3, 3)).astype(np.float32) * 0.3
        tri[:, 1] = rng.uniform(0.5, 1.5)
        tris += [tri, tri]
    pos = np.concatenate(tris).astype(np.float32)
    return model.Mesh(pos, np.arange(len(pos), dtype=np.int32).reshape(-1, 3))


@pytest.mark.cuda
def test_ties_go_to_the_first_slot(cuda):
    sc = model.Scene()
    sc.add_primitive(model.Primitive(type=model.MESH, mesh=_duplicates()))
    flat = sc.flatten(device=cuda)
    h = flat.prim_static[0].mesh
    rng = np.random.default_rng(1)
    n = 4096
    o = np.stack([rng.uniform(-2.5, 2.5, n), np.full(n, 3.0), rng.uniform(-2.5, 2.5, n)], -1)
    d = np.concatenate([np.tile([[0.0, -1.0, 0.0]], (n // 2, 1)),
                        rng.normal(size=(n // 2, 3)) * 0.2 + [0.0, -1.0, 0.0]])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (o, d))
    tmax = torch.full((n,), float("inf"), device=cuda)
    t, tri, _ = _assert_equal_plain(flat.pool, h.node_offset, h.tri_offset, o, d, tmax,
                                    h.stack_slots)
    # the case is real: every lane that hits finds two or more triangles
    # at its t (15% of the lanes)
    va, vb, vc = flat.pool.gather_tri(torch.arange(h.tri_offset, h.tri_offset + h.num_tris,
                                                   device=cuda))
    hit, tt = plain._tri_hit(
        tuple(v[:, None, i] for v, i in ((va, 0), (va, 1), (va, 2))),
        tuple(v[:, None, i] for v, i in ((vb, 0), (vb, 1), (vb, 2))),
        tuple(v[:, None, i] for v, i in ((vc, 0), (vc, 1), (vc, 2))),
        tuple(o[None, :, i] for i in range(3)), tuple(d[None, :, i] for i in range(3)))
    ties = (hit & (tt == t[None, :])).sum(0) >= 2
    assert torch.equal(ties, torch.isfinite(t)) and float(ties.float().mean()) > 0.1


@pytest.mark.cuda
def test_rays_through_shared_edges_and_vertices(cuda):
    """Rays straight down and tilted onto the disc fan's centre, its rim
    vertices and points of its spokes, each shared by two triangles."""
    pool, handles = _pool(cuda)
    h = handles[2]
    a = np.linspace(0.0, 2.0 * np.pi, 40, endpoint=False)
    rim = np.stack([np.cos(a), np.zeros_like(a), np.sin(a)], -1).astype(np.float32)
    targets = np.concatenate([np.zeros((1, 3), np.float32), rim,
                              *(s * rim for s in (np.float32(0.25), np.float32(0.5)))])
    rng = np.random.default_rng(2)
    tilt = np.concatenate([np.zeros((1, 3)), rng.normal(size=(7, 3)) * 0.3])
    d = np.repeat(tilt + [0.0, -1.0, 0.0], len(targets), 0)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(targets, (len(tilt), 1)) - 2.0 * d
    o, d = (torch.from_numpy(x.astype(np.float32)).to(cuda) for x in (o, d))
    tmax = torch.full((o.shape[0],), float("inf"), device=cuda)
    t, _, _ = _assert_equal_plain(pool, h.node_offset, h.tri_offset, o, d, tmax,
                                  h.stack_slots)
    # rim vertices lie on the disc's boundary: some tilted rays miss there
    assert float(torch.isfinite(t).float().mean()) > 0.7


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    pool, handles = _pool(cuda)
    o, d, tmax = (torch.from_numpy(a).to(cuda) for a in _rays(64, 3))
    h = handles[0]
    with pytest.raises(TypeError):
        ops.closest_hit(pool, h.node_offset, h.tri_offset, o.double(), d, tmax, h.stack_slots)
    with pytest.raises(ValueError):
        ops.closest_hit(pool, h.node_offset, h.tri_offset, o, d, tmax, 129)
    with pytest.raises(TypeError):
        ops.any_hit(pool, torch.zeros(64, dtype=torch.int64, device=cuda), h.tri_offset,
                    o, d, tmax, h.stack_slots)
    before = dict(ops.launch_counts)
    with pytest.raises(ValueError):
        ops.closest_hit(pool, h.node_offset, h.tri_offset, o[:, :2].contiguous(), d, tmax,
                        h.stack_slots)
    assert ops.launch_counts == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["instances", "envmesh", "many_mesh", "envmesh_probe"])
def test_big_mesh_render_on_the_card_matches_the_cpu(cuda, name):
    """Equal draws on both devices: 99.5% of pixels within atol 1e-4 /
    rtol 1e-3 (the card's transcendental functions round differently in
    the last bit, and a grazing ray may then take another path). Only
    many_mesh has a light and envmesh_probe a probe, so only their shadow
    rays launch K4."""
    sc = {
        "instances": lambda: presets.instances_scene(48, 48, 3),
        "envmesh": lambda: presets.envmesh_scene(48, 48, 3, detail=32),
        "many_mesh": lambda: presets.many_mesh_scene(20, 48, 48, 2),
        "envmesh_probe": lambda: presets.envmesh_scene(48, 48, 3, detail=32, probe=True),
    }[name]()
    ops.reset_launch_counts()
    a = render(sc, spp=1, device=cuda, source=NumpyUniforms(5, cuda)).cpu().numpy()
    assert ops.launch_counts["bvh_closest"] > 0
    assert (ops.launch_counts["bvh_any"] > 0) == (name in ("many_mesh", "envmesh_probe"))
    b = render(sc, spp=1, device="cpu", source=NumpyUniforms(5, "cpu")).numpy()
    assert np.isfinite(a).all()
    close = np.isclose(a, b, atol=1e-4, rtol=1e-3).all(axis=-1)
    assert close.mean() >= 0.995, close.mean()
