"""The sweep kernels K5c (closest hit) and K5a (occlusion), csrc/sweep.cu,
against their plain PyTorch versions (accel/sweep.py) on the card. Every
test needs an NVIDIA GPU and skips without one.

This file imports neither JAX nor tinsel_tpu, so it runs where JAX is not
installed, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_sweep_cuda.py

Tolerance: none. csrc/sweep.cu is compiled with -fmad=false and follows the
plain version's order of operations, so t, the primitive, the triangle and
the occlusion bit are equal on every lane, t bit for bit. The cases: the
Cornell box, scenes/motionblur.tin (a moving sphere), scenes/veach_mis.json
(spheres, quads, plates; its big knob goes to the walks, not the sweep) and
a synthetic scene of 2,000 spheres and 300 tiny instances, some moving,
whose record table spans three shared-memory chunks; ray counts that leave
the last block part-filled; axis-aligned directions; tmax 0, -0.0, NaN and
+inf; a scene with nothing to sweep. Around the persistent grid: ray counts
of 1, a tile - 1 and + 1, fewer tiles than resident blocks and several
strides of the grid; the synthetic table cut into 600-float chunks (groups
split across chunks, two buffers taking turns over tiles); K5a on warps
whose rays are all, none or some occluded. A launch whose shared memory
is above the card's opt-in limit raises.
"""

import os

import numpy as np
import pytest
import torch

from tinsel_tpu_torch.accel import sweep as plain
from tinsel_tpu_torch.ops import sweep as ops
from tinsel_tpu_torch.render import trace
from tinsel_tpu_torch.scene import model, presets, procedural

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def tiny_meshes(m):
    """A quad (2 triangles), a tetrahedron (4) and a cube (12) of the model
    module ``m`` (this package's or the JAX package's)."""
    quad = m.Mesh(np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], np.float32),
                  np.array([[0, 1, 2], [0, 2, 3]], np.int32))
    tet = m.Mesh(np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]], np.float32),
                 np.array([[0, 1, 2], [0, 3, 1], [0, 2, 3], [1, 3, 2]], np.int32))
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float32)
    faces = [[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1], [2, 3, 7],
             [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]]
    return [quad, tet, m.Mesh(corners, np.array(faces, np.int32))]


def synthetic_scene(m, seed=5):
    """2,000 spheres (a quarter moving) and 300 instances of three tiny
    meshes (a third moving: position, rotation and scale) in a 20-unit box
    between two planes, built with the model module ``m``."""
    rng = np.random.default_rng(seed)
    sc = m.Scene()
    mat = m.Material(color=np.full(3, 0.5, np.float32))

    def tr(p, q, s):
        return m.HostTransform(p=p.astype(np.float32), q=q.astype(np.float32), s=float(s))

    ident = np.array([0, 0, 0, 1.0])
    for k in range(2000):
        p = rng.uniform(-10, 10, 3)
        end = tr(p + rng.normal(size=3) * 0.3, ident, 1.0) if k % 4 == 0 else None
        sc.add_primitive(m.Primitive(type=m.SPHERE, radius=float(rng.uniform(0.05, 0.3)),
                                     start_transform=tr(p, ident, 1.0), end_transform=end,
                                     material=mat))
    for y in (-12.0, 12.0):
        sc.add_primitive(m.Primitive(type=m.PLANE, material=mat,
                                     plane=np.array([0, 1, 0, -y], np.float32)))
    meshes = tiny_meshes(m)
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


def camera_rays(cam, rng, n):
    """Rays from near the camera in a cone around its view direction."""
    q = np.asarray(cam.rotation, np.float64)
    u, w = q[:3], q[3]
    fwd = np.array([0.0, 0.0, -1.0])
    t = 2.0 * np.cross(u, fwd)
    fwd = fwd + w * t + np.cross(u, t)
    o = np.asarray(cam.position, np.float32) + rng.normal(size=(n, 3)).astype(np.float32) * 0.01
    d = fwd[None] + rng.normal(size=(n, 3)) * 0.35
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _scene(name, tmp_path, monkeypatch):
    """(scene, origins, dirs) of a case, rays as numpy."""
    from tinsel_tpu_torch.scene.loaders import mesh_io
    from tinsel_tpu_torch.scene.loaders.tin import load_tin
    from tinsel_tpu_torch.scene.loaders.tungsten import load_tungsten

    rng = np.random.default_rng(len(name))
    n = 65536
    if name == "cornell":
        sc = presets.cornell_scene(64, 64, 4)
        o = np.stack([rng.uniform(-0.95, 0.95, n), rng.uniform(0.05, 1.95, n),
                      rng.uniform(-0.95, 3.0, n)], -1).astype(np.float32)
        return sc, o, _unit(rng, n)
    if name == "multichunk":
        return synthetic_scene(model), rng.uniform(-11, 11, (n, 3)).astype(np.float32), \
            _unit(rng, n)
    monkeypatch.setattr(mesh_io, "_CACHE_DIR", str(tmp_path / "cache"))
    if name == "motionblur":
        sc = load_tin(os.path.join(SCENES, "motionblur.tin"))
    else:
        sc = load_tungsten(os.path.join(SCENES, "veach_mis.json"))
    return (sc, *camera_rays(sc.camera, rng, n))


def _tmax(rng, n):
    """Segment lengths with 0, -0.0, NaN and +inf mixed into every warp."""
    tmax = rng.uniform(0.0, 8.0, n).astype(np.float32)
    pick = rng.random(n)
    tmax[pick < 0.25] = rng.choice(np.array([0.0, -0.0, np.nan, np.inf], np.float32),
                                   int((pick < 0.25).sum()))
    return tmax


def _assert_kernels_equal_plain(flat, o, d, times, tmax):
    ops.reset_launch_counts()
    t, prim, tri = ops.sweep_closest(flat, o, d, times)
    occ = ops.sweep_any(flat, o, d, times, tmax)
    torch.cuda.synchronize()
    assert ops.launch_counts == {"sweep_closest": 1, "sweep_any": 1}
    t_ref, prim_ref, tri_ref = plain.sweep_closest(flat, o, d, times)
    occ_ref = plain.sweep_any(flat, o, d, times, tmax)
    assert torch.equal(prim, prim_ref)
    assert torch.equal(tri, tri_ref)
    assert torch.equal(t, t_ref)  # +inf on both sides where nothing is hit
    assert torch.equal(occ, occ_ref)
    return t, prim, tri, occ


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "motionblur", "veach", "multichunk"])
def test_kernels_equal_plain(cuda, name, tmp_path, monkeypatch):
    sc, o, d = _scene(name, tmp_path, monkeypatch)
    flat = sc.flatten(device=cuda)
    rng = np.random.default_rng(1)
    n = o.shape[0]
    times = rng.random(n).astype(np.float32)
    o, d, times, tmax = (torch.from_numpy(x).to(cuda)
                         for x in (o, d, times, _tmax(rng, n)))
    t, prim, tri, occ = _assert_kernels_equal_plain(flat, o, d, times, tmax)
    assert 0.3 < float(torch.isfinite(t).float().mean())
    assert 0.05 < float(occ.float().mean()) < 0.95
    assert not occ[~(tmax > 0)].any()
    if name == "multichunk":
        assert ops.table(flat, cuda).n_chunks == 3
        kinds = flat.prim_type[prim[prim >= 0].long()]
        assert {int(k) for k in kinds.unique()} == {model.SPHERE, model.PLANE, model.MESH}


@pytest.mark.cuda
@pytest.mark.parametrize("rays", [1, 255, 256, 257, 4099])
def test_part_filled_blocks_and_axis_aligned_rays(cuda, rays):
    """Ray counts around the 256-thread block; a third of the directions
    along an axis (zero components: the box test's nudge)."""
    flat = synthetic_scene(model).flatten(device=cuda)
    rng = np.random.default_rng(rays)
    o = rng.uniform(-11, 11, (rays, 3)).astype(np.float32)
    d = _unit(rng, rays)
    axis = rng.integers(0, 3, rays)
    aligned = np.arange(rays) % 3 == 0
    d[aligned] = 0.0
    d[aligned, axis[aligned]] = rng.choice([-1.0, 1.0], int(aligned.sum()))
    times = rng.random(rays).astype(np.float32)
    o, d, times, tmax = (torch.from_numpy(x).to(cuda)
                         for x in (o, d, times, _tmax(rng, rays)))
    _assert_kernels_equal_plain(flat, o, d, times, tmax)


@pytest.mark.cuda
def test_nothing_to_sweep(cuda):
    """A scene of one big mesh: an empty table, every ray a miss."""
    sc = model.Scene()
    sc.add_primitive(model.Primitive(type=model.MESH, mesh=procedural.sphere(1.0, 8, 16)))
    flat = sc.flatten(device=cuda)
    assert ops.table(flat, cuda).n_chunks == 0
    rng = np.random.default_rng(0)
    o = torch.from_numpy(rng.uniform(-2, 2, (1000, 3)).astype(np.float32)).to(cuda)
    d = torch.from_numpy(_unit(rng, 1000)).to(cuda)
    z = torch.zeros(1000, device=cuda)
    t, prim, tri, occ = _assert_kernels_equal_plain(flat, o, d, z, z + np.inf)
    assert torch.isinf(t).all() and (prim == -1).all() and not occ.any()


@pytest.mark.cuda
def test_trace_routes_the_sweep_through_the_kernels(cuda):
    """trace_closest / trace_any on CUDA tensors: one K5c / K5a launch a
    call, and the hit equals the one the CPU traces."""
    sc = presets.cornell_scene(64, 64, 4)
    rng = np.random.default_rng(4)
    n = 4096
    o = np.stack([rng.uniform(-0.9, 0.9, n), rng.uniform(0.1, 1.9, n),
                  rng.uniform(-0.9, 2.5, n)], -1).astype(np.float32)
    d, times, tmax = _unit(rng, n), rng.random(n).astype(np.float32), _tmax(rng, n)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        flat = sc.flatten(device=dev)
        args = [torch.from_numpy(x).to(dev) for x in (o, d, times, tmax)]
        ops.reset_launch_counts()
        h = trace.trace_closest(flat, *args[:3])
        occ = trace.trace_any(flat, *args)
        out[dev.type] = (h.prim.cpu(), h.t.cpu(), h.normal.cpu(), occ.cpu(),
                         dict(ops.launch_counts))
    assert out["cuda"][4] == {"sweep_closest": 1, "sweep_any": 1}
    assert out["cpu"][4] == {"sweep_closest": 0, "sweep_any": 0}
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][3], out["cpu"][3])
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(out["cuda"][2], out["cpu"][2], rtol=1e-5, atol=1e-5)


def _random_rays(rng, n):
    o = rng.uniform(-11, 11, (n, 3)).astype(np.float32)
    return o, _unit(rng, n), rng.random(n).astype(np.float32), _tmax(rng, n)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["one", "tile-1", "tile+1", "few tiles", "strides"])
def test_ray_counts_around_the_tile_and_the_persistent_grid(cuda, which):
    """1 ray, a tile (THREADS * RAYS rays, csrc/sweep.cu) less and more one,
    fewer tiles than the grid's resident blocks, and enough tiles for each
    block to take several strides."""
    sc = synthetic_scene(model) if which != "strides" else presets.cornell_scene(64, 64, 4)
    flat = sc.flatten(device=cuda)
    tab = ops.table(flat, cuda)
    tile, grid = ops.launch_geometry("sweep_closest", tab, 1 << 20)
    n = {"one": 1, "tile-1": tile - 1, "tile+1": tile + 1, "few tiles": 3 * tile + 7,
         "strides": 3 * grid * tile + tile // 2 + 3}[which]
    _, grid_n = ops.launch_geometry("sweep_closest", tab, n)
    if which == "few tiles":
        assert grid_n == -(-n // tile) < grid  # one block a tile
    if which == "strides":
        assert -(-n // tile) > 3 * grid_n  # every block takes 3 or 4 tiles
    rng = np.random.default_rng(n)
    args = [torch.from_numpy(x).to(cuda) for x in _random_rays(rng, n)]
    _assert_kernels_equal_plain(flat, *args)


@pytest.mark.cuda
def test_table_of_many_small_chunks(cuda, monkeypatch):
    """The synthetic scene packed into chunks of at most 600 floats: groups
    cut across chunks (a chunk starting inside a group), the two buffers
    taking turns across the tiles of a block."""
    monkeypatch.setattr(ops, "SMEM_FLOATS", 1200)
    monkeypatch.setattr(ops, "CHUNK_FLOATS", 600)
    flat = synthetic_scene(model).flatten(device=cuda)
    tab = ops.table(flat, cuda)
    assert tab.n_chunks > 40 and tab.smem_floats <= 600
    rng = np.random.default_rng(8)
    for n in (1, 3000):
        args = [torch.from_numpy(x).to(cuda) for x in _random_rays(rng, n)]
        _assert_kernels_equal_plain(flat, *args)


@pytest.mark.cuda
def test_warps_with_all_none_or_some_rays_occluded(cuda):
    """K5a on warps of uniform and of mixed occlusion: runs of 64 rays (one
    warp's) whose segments all reach far (occluded by the box's walls),
    all end at once (tmax 1e-4: none occluded), or alternate; the kernel's
    bits equal the plain version's on every lane."""
    flat = presets.cornell_scene(64, 64, 4).flatten(device=cuda)
    rng = np.random.default_rng(6)
    n = 64 * 300
    o = np.stack([rng.uniform(-0.9, 0.9, n), rng.uniform(0.1, 1.9, n),
                  rng.uniform(-0.9, 2.5, n)], -1).astype(np.float32)
    run = np.arange(n) // 64 % 3
    far = np.where(run == 0, True, np.where(run == 1, False, rng.random(n) < 0.5))
    tmax = np.where(far, 50.0, 1e-4).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda) for x in (o, _unit(rng, n), np.zeros(n, np.float32),
                                                   tmax)]
    *_, occ = _assert_kernels_equal_plain(flat, *args)
    occ = occ.cpu().numpy()
    assert occ[run == 0].mean() > 0.99 and not occ[run == 1].any()
    assert 0.3 < occ[run == 2].mean() < 0.7


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [1, 2])
def test_shared_memory_above_the_opt_in_limit_raises(cuda, monkeypatch, chunks):
    """A table whose staging needs more shared memory than a block may opt
    in to (one chunk of 256 KB, or two buffers of 120 KB) is refused with
    an error, nothing launched, never zeros returned."""
    floats = 65536 if chunks == 1 else 30720
    big = ops.SweepTable(
        table=torch.zeros(floats * chunks, device=cuda),
        chunks=torch.arange(chunks + 1, dtype=torch.int32, device=cuda) * floats,
        n_chunks=chunks, smem_floats=floats, motion=False)
    monkeypatch.setattr(ops, "table", lambda scene, dev, hoist: big)
    flat = presets.cornell_scene(8, 8, 1).flatten(device=cuda)
    o = torch.zeros(64, 3, device=cuda)
    d = torch.ones(64, 3, device=cuda)
    z = torch.zeros(64, device=cuda)
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="opt in"):
        ops.sweep_closest_cuda(flat, o, d, z)
    with pytest.raises(RuntimeError, match="opt in"):
        ops.sweep_any_cuda(flat, o, d, z, z)
    assert ops.launch_counts == {"sweep_closest": 0, "sweep_any": 0}
