"""The CUDA BVH walks (kernels K3 and K4, csrc/bvh.cu) against their plain
PyTorch versions (accel/traverse.py) on the card, and the big-mesh render
on the card against the CPU at equal draws. Every test needs an NVIDIA GPU
and skips without one.

This file imports neither JAX nor tinsel_tpu, so it runs where JAX is not
installed, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_bvh_cuda.py

Tolerance: none. csrc/bvh.cu is compiled with -fmad=false, so the kernels
round every product and sum as the plain version's separate torch ops do,
and t and the winning triangle are equal bit for bit.
"""

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


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 127, 4099])
def test_kernels_equal_plain_per_lane_offsets(cuda, lanes):
    pool, handles = _pool(cuda)
    o, d, tmax = (torch.from_numpy(a).to(cuda) for a in _rays(lanes, lanes))
    noff, toff, slots = _per_lane(handles, lanes, cuda)
    ops.reset_launch_counts()
    t, tri = ops.closest_hit(pool, noff, toff, o, d, tmax, slots)
    occ = ops.any_hit(pool, noff, toff, o, d, tmax, slots)
    torch.cuda.synchronize()
    assert ops.launch_counts == {"bvh_closest": 1, "bvh_any": 1}
    t_ref, tri_ref = plain.intersect_mesh(pool, noff, toff, o, d, tmax, stack_slots=slots)
    occ_ref = plain.intersect_mesh_any(pool, noff, toff, o, d, tmax, stack_slots=slots)
    assert torch.equal(t, t_ref)
    assert torch.equal(tri, tri_ref)
    assert torch.equal(occ, occ_ref)
    assert not occ[tmax == 0].any() and not torch.isfinite(t[tmax == 0]).any()
    if lanes > 1000:
        assert 0.2 < float(torch.isfinite(t).float().mean()) < 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", [0, 1, 2])
def test_kernels_equal_plain_scalar_offsets(cuda, mesh):
    pool, handles = _pool(cuda)
    h = handles[mesh]
    o, d, tmax = (torch.from_numpy(a).to(cuda) for a in _rays(2048, 7 + mesh))
    got = ops.closest_hit(pool, h.node_offset, h.tri_offset, o, d, tmax, h.stack_slots)
    want = plain.intersect_mesh(pool, h.node_offset, h.tri_offset, o, d, tmax,
                                stack_slots=h.stack_slots)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    occ = ops.any_hit(pool, h.node_offset, h.tri_offset, o, d, tmax, h.stack_slots)
    assert torch.equal(occ, plain.intersect_mesh_any(pool, h.node_offset, h.tri_offset, o, d,
                                                      tmax, stack_slots=h.stack_slots))


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
@pytest.mark.parametrize("name", ["instances", "envmesh", "many_mesh"])
def test_big_mesh_render_on_the_card_matches_the_cpu(cuda, name):
    """Equal draws on both devices: 99.5% of pixels within atol 1e-4 /
    rtol 1e-3 (the card's transcendental functions round differently in
    the last bit, and a grazing ray may then take another path). Only
    many_mesh has a light, so only its shadow rays launch K4."""
    sc = {
        "instances": lambda: presets.instances_scene(48, 48, 3),
        "envmesh": lambda: presets.envmesh_scene(48, 48, 3, detail=32),
        "many_mesh": lambda: presets.many_mesh_scene(20, 48, 48, 2),
    }[name]()
    ops.reset_launch_counts()
    a = render(sc, spp=1, device=cuda, source=NumpyUniforms(5, cuda)).cpu().numpy()
    assert ops.launch_counts["bvh_closest"] > 0
    assert (ops.launch_counts["bvh_any"] > 0) == (name == "many_mesh")
    b = render(sc, spp=1, device="cpu", source=NumpyUniforms(5, "cpu")).numpy()
    assert np.isfinite(a).all()
    close = np.isclose(a, b, atol=1e-4, rtol=1e-3).all(axis=-1)
    assert close.mean() >= 0.995, close.mean()
