"""On the card: the material gather's one-hot backward and the vertex
gather's (one-hot or ``index_add_``) against the accumulating gathers
they replaced, the walks (K3, K4) on trees from the native SAH code, and a
loaded scene file against the CPU at equal draws.
Every test needs an NVIDIA GPU and skips without one.

This file imports neither JAX nor tinsel_tpu, so it runs where JAX is not
installed, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_scene_files_cuda.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tinsel_tpu_torch.accel import traverse as plain
from tinsel_tpu_torch.core.sampling import NumpyUniforms
from tinsel_tpu_torch.ops import bvh as ops
from tinsel_tpu_torch.render.renderer import render
from tinsel_tpu_torch.scene import model, presets
from tinsel_tpu_torch.scene.loaders import mesh_io
from tinsel_tpu_torch.scene.loaders.tungsten import load_tungsten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _old_select(mats, i):
    """MaterialsFlat.select before the one-hot backward: advanced indexing."""
    i = i.long()
    return {f.name: getattr(mats, f.name)[i] for f in dataclasses.fields(mats)}


def _select_grads(mats, idx, upstream, new: bool):
    """Gradients of sum(select(idx) * upstream) for every table of
    ``mats``, through the package's gather (``new``) or the old one."""
    leaves = {f.name: getattr(mats, f.name).clone().requires_grad_(True)
              for f in dataclasses.fields(mats)}
    m = model.MaterialsFlat(**leaves)
    rows = {k: getattr(m.select(idx), k) for k in leaves} if new else _old_select(m, idx)
    loss = sum((rows[k] * upstream[k]).sum() for k in rows)
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,spread", [(16, 2), (16, 16), (131072, 2), (131072, 131072)])
def test_vertex_gather_matches_advanced_indexing(cuda, rows, spread):
    """``MeshPool.gather_tri``: forward bit for bit against advanced
    indexing; backward (one-hot for 16 rows, ``index_add_`` for 131,072)
    against the accumulating ``index_put`` on 262,144 lanes over ``spread``
    rows, with small-integer upstream gradients, so every sum is exact in
    f32 and the two are equal bit for bit in any order."""
    rng = np.random.default_rng(rows + spread)
    planes = [torch.from_numpy(rng.normal(size=rows).astype(np.float32)).to(cuda)
              for _ in range(18)]
    pool = plain.MeshPool(node_rows=torch.zeros((1, 72), device=cuda),
                          block_rows=torch.zeros((1, 192), device=cuda),
                          tri_cdf=torch.zeros(rows, device=cuda), tri_planes=tuple(planes[:9]),
                          nrm_planes=tuple(planes[9:]))
    idx = torch.from_numpy(rng.integers(0, spread, 262144)).to(cuda)
    up = torch.from_numpy(rng.integers(-8, 9, (3, 262144, 3)).astype(np.float32)).to(cuda)
    grads = []
    for new in (True, False):
        leaves = [p.clone().requires_grad_(True) for p in planes[:9]]
        if new:
            corners = dataclasses.replace(pool, tri_planes=tuple(leaves)).gather_tri(idx)
        else:
            corners = tuple(torch.stack([leaves[3 * k + c][idx] for c in range(3)], -1)
                            for k in range(3))
        grads.append(torch.autograd.grad(sum((c * u).sum() for c, u in zip(corners, up)),
                                         leaves))
        if new:
            for a, k in zip(corners, range(3)):
                want = torch.stack([planes[3 * k + c][idx] for c in range(3)], -1)
                assert torch.equal(a, want)
    for got, want in zip(*grads):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("upstream,lanes", [("normal", 1), ("normal", 4099),
                                            ("integer", 4099), ("integer", 262144)])
def test_material_select_matches_the_old_gather(cuda, upstream, lanes):
    """Forward bit for bit. Backward: with normal upstream gradients
    within 1e-6 of each leaf's largest entry (the sums run in another
    order); with small-integer upstream gradients every sum is exact in
    f32 (below 2^24), so both backwards are equal bit for bit, at the
    lane count of a 512x512 pass too."""
    sc = presets.cornell_scene(8, 8, 1)
    mats = sc.flatten(device=cuda).materials
    rng = np.random.default_rng(lanes)
    idx = torch.from_numpy(rng.integers(0, mats.color.shape[0], lanes)).to(cuda)
    new_rows, old_rows = mats.select(idx), _old_select(mats, idx)
    for k, want in old_rows.items():
        assert torch.equal(getattr(new_rows, k), want), k
    draw = ((lambda shape: rng.normal(size=shape)) if upstream == "normal"
            else (lambda shape: rng.integers(-8, 9, shape)))
    up = {k: torch.from_numpy(draw(tuple(v.shape)).astype(np.float32)).to(cuda)
          for k, v in old_rows.items()}
    got, want = (_select_grads(mats, idx, up, new) for new in (True, False))
    for k in want:
        if upstream == "integer":
            assert torch.equal(got[k], want[k]), k
        else:
            scale = float(want[k].abs().max())
            assert scale > 0 and float((got[k] - want[k]).abs().max()) <= 1e-6 * scale, k


@pytest.mark.cuda
def test_walks_on_a_native_tree_equal_plain(cuda):
    """envmesh's Perlin sphere at detail 64 (8,192 triangles: the native
    SAH build and the native wide collapse) under K3 and K4: bit for bit."""
    sc = presets.envmesh_scene(8, 8, 1, detail=64)
    flat = sc.flatten(device=cuda)
    h = flat.prim_static[0].mesh
    assert h.real_tris == 8192
    rng = np.random.default_rng(3)
    n = 20000
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.where(rng.random(n) < 0.8, np.inf, rng.uniform(0, 2, n)).astype(np.float32)
    o, d, tmax = (torch.from_numpy(x).to(cuda) for x in (o, d, tmax))
    args = (flat.pool, h.node_offset, h.tri_offset, o, d, tmax, h.stack_slots)
    t, tri = ops.closest_hit(*args)
    occ = ops.any_hit(*args)
    t_ref, tri_ref = plain.intersect_mesh(*args[:6], stack_slots=h.stack_slots)
    occ_ref = plain.intersect_mesh_any(*args[:6], stack_slots=h.stack_slots)
    assert torch.equal(t, t_ref) and torch.equal(tri, tri_ref) and torch.equal(occ, occ_ref)
    assert bool(torch.isfinite(t).any())


@pytest.mark.cuda
def test_veach_mis_file_on_the_card_matches_the_cpu(cuda, tmp_path, monkeypatch):
    """scenes/veach_mis.json loaded through the port (the knob's 2,208
    triangles go through K3/K4), 64x64 depth 4 at 1 spp, card against CPU
    at equal draws: 99.5% of pixels within atol 1e-4 / rtol 1e-3, means
    within 1e-3."""
    monkeypatch.setattr(mesh_io, "_CACHE_DIR", str(tmp_path))
    sc = load_tungsten(os.path.join(ROOT, "scenes", "veach_mis.json"))
    sc.options = dataclasses.replace(sc.options, width=64, height=64, max_depth=4)
    ops.reset_launch_counts()
    a = render(sc, spp=1, device=cuda, source=NumpyUniforms(7, cuda)).cpu().numpy()
    assert ops.launch_counts["bvh_closest"] >= 1 and ops.launch_counts["bvh_any"] >= 1
    cpu = torch.device("cpu")
    b = render(sc, spp=1, device=cpu, source=NumpyUniforms(7, cpu)).numpy()
    assert np.isfinite(a).all()
    close = np.isclose(a, b, atol=1e-4, rtol=1e-3).all(axis=-1)
    assert close.mean() >= 0.995, close.mean()
    rel = abs(a[..., :3].mean() - b[..., :3].mean()) / b[..., :3].mean()
    assert rel < 1e-3, rel
