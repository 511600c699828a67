"""The debug views against tinsel_tpu: the plain version of kernel K7
(``accel/traverse.py::traversal_cost``, the closest-hit walk's step count)
exactly equal to the JAX count, and ``mode="complexity"`` /
``mode="normals"`` render passes.

The JAX walk runs in one phase when a call has at most its TILE = 4,096
rays; above that it caps the first phase at 16 steps and re-walks the
unfinished rays from the root, which the port does not. The rays here stay
within one tile, and many take more than 16 steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinsel_tpu.accel import traverse as jtraverse
from tinsel_tpu.render.camera import CameraParams as JCam
from tinsel_tpu.scene import presets as jpresets
from tinsel_tpu_torch.accel import traverse as ttraverse
from tinsel_tpu_torch.ops import bvh as ops_bvh
from tinsel_tpu_torch.render import renderer as trenderer
from tinsel_tpu_torch.render.camera import CameraParams as TCam
from tinsel_tpu_torch.scene import presets as tpresets

from torch_parity import JaxUniforms, jax_render_pass

torch.set_num_threads(2)
R = 3000


def _meshes():
    """envmesh at detail 24 (1,152 triangles) and many_mesh (big and tiny
    meshes in one pool), flattened by both packages."""
    out = {}
    for name, args in (("envmesh", (32, 32, 4, 24)), ("many_mesh", (12, 32, 32, 2))):
        js = getattr(jpresets, f"{name}_scene")(*args)
        ts = getattr(tpresets, f"{name}_scene")(*args)
        out[name] = (js.flatten(), ts.flatten(device="cpu"))
    return out


def _rays(seed):
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-3, 3, R), rng.uniform(-1, 3, R), rng.uniform(-3, 3, R)], -1)
    aim = rng.uniform(-0.6, 0.6, (R, 3)) - o
    d = np.where(np.arange(R)[:, None] % 3 == 0, rng.normal(size=(R, 3)), aim)
    d[::7] = 0.0  # axis-aligned lanes
    d[::7, 1] = -1.0
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.where(rng.random(R) < 0.7, np.inf, rng.uniform(0.0, 4.0, R))
    tmax[::11] = 0.0
    tmax[5::22] = np.nan
    return o.astype(np.float32), d.astype(np.float32), tmax.astype(np.float32)


@pytest.fixture(scope="module")
def meshes():
    return _meshes()


@pytest.mark.parametrize("name", ["envmesh", "many_mesh"])
def test_traversal_cost_equals_jax(meshes, name):
    """Every big mesh of the scene alone (scalar offsets), then all of them
    at once with per-lane offsets: equal counts on every lane, culled lanes
    (tmax 0 or NaN) count 1 on both sides."""
    jf, tf = meshes[name]
    np.testing.assert_array_equal(tf.pool.node_rows.numpy(), np.asarray(jf.pool.node_rows))
    handles = [p.mesh for p in tf.prim_static if p.mesh is not None and p.mesh.num_tris > 16]
    handles = list({(h.node_offset, h.tri_offset): h for h in handles}.values())
    assert handles
    o, d, tmax = _rays(len(handles))
    jcost = jax.jit(jtraverse.traversal_cost, static_argnames=("num_tris", "stack_slots"))
    for h in handles[:3]:
        a = np.asarray(jcost(jf.pool, h.node_offset, h.tri_offset, *map(jnp.asarray, (o, d, tmax)),
                             num_tris=h.num_tris, stack_slots=h.stack_slots))
        b = ttraverse.traversal_cost(tf.pool, h.node_offset, h.tri_offset,
                                     *map(torch.from_numpy, (o, d, tmax)),
                                     num_tris=h.num_tris, stack_slots=h.stack_slots).numpy()
        np.testing.assert_array_equal(b, a)
        assert (b[~(tmax > 0)] == 1).all()
        if name == "envmesh":  # walks past the JAX phase-1 cap of 16 steps
            assert (b > 16).sum() >= 20, (b > 16).sum()
    which = np.arange(R) % len(handles)
    noff = np.array([h.node_offset for h in handles], np.int32)[which]
    toff = np.array([h.tri_offset for h in handles], np.int32)[which]
    slots = max(h.stack_slots for h in handles)
    a = np.asarray(jcost(jf.pool, jnp.asarray(noff), jnp.asarray(toff),
                         *map(jnp.asarray, (o, d, tmax)), stack_slots=slots))
    b = ttraverse.traversal_cost(tf.pool, torch.from_numpy(noff), torch.from_numpy(toff),
                                 *map(torch.from_numpy, (o, d, tmax)), stack_slots=slots)
    np.testing.assert_array_equal(b.numpy(), a)
    # the dispatcher on CPU tensors: the plain walk with tmax = +inf, no launch
    ops_bvh.reset_launch_counts()
    c = ops_bvh.traversal_steps(tf.pool, torch.from_numpy(noff), torch.from_numpy(toff),
                                torch.from_numpy(o), torch.from_numpy(d), slots)
    inf = torch.full((R,), float("inf"))
    assert torch.equal(c, ttraverse.traversal_cost(
        tf.pool, torch.from_numpy(noff), torch.from_numpy(toff), torch.from_numpy(o),
        torch.from_numpy(d), inf, stack_slots=slots))
    assert not any(ops_bvh.launch_counts.values())


def test_tiny_mesh_costs_its_triangle_count(meshes):
    """A mesh of at most 16 triangles skips the walk: its padded count."""
    _, tf = meshes["many_mesh"]
    h = next(p.mesh for p in tf.prim_static if p.mesh is not None and p.mesh.num_tris <= 16)
    o, d, tmax = map(torch.from_numpy, _rays(0))
    c = ttraverse.traversal_cost(tf.pool, h.node_offset, h.tri_offset, o, d, tmax,
                                 num_tris=h.num_tris)
    a = jtraverse.traversal_cost(jnp.zeros(()), 0, 0, jnp.zeros((R, 3)), jnp.zeros((R, 3)),
                                 jnp.zeros(R), num_tris=h.num_tris)
    np.testing.assert_array_equal(c.numpy(), np.asarray(a))
    assert (c == 16).all()


def _jax_costs(flat, o, d, times):
    """The per-ray cost ``tinsel_tpu``'s trace_complexity maps to colour
    (``render/integrator.py:444-458``), before the colour map."""
    from tinsel_tpu.core.math import inverse_transform_point, inverse_transform_vector
    from tinsel_tpu.render.trace import prim_transform
    from tinsel_tpu.scene.model import MESH

    cost = jnp.zeros((o.shape[0],), jnp.float32)
    for i, ps in enumerate(flat.prim_static):
        if ps.type != MESH:
            cost = cost + 1.0
            continue
        tr = prim_transform(flat, i, times)
        h = ps.mesh
        cost = cost + jtraverse.traversal_cost(
            flat.pool, h.node_offset, h.tri_offset, inverse_transform_point(tr, o),
            inverse_transform_vector(tr, d), jnp.full((o.shape[0],), jnp.inf),
            num_tris=h.num_tris, stack_slots=h.stack_slots)
    return np.asarray(cost)


@pytest.mark.parametrize("name", ["envmesh", "many_mesh"])
def test_complexity_costs_equal_jax(meshes, name):
    """The summed per-ray cost of the complexity view on 2,048 rays through
    the scene: equal on every ray (big meshes walked in one batch with
    per-lane offsets, tiny meshes their padded count, other primitives 1)."""
    from tinsel_tpu_torch.render.integrator import traversal_costs

    jf, tf = meshes[name]
    rng = np.random.default_rng(4)
    o = np.tile(np.array([[0.0, 1.5, 4.0]], np.float32), (2048, 1)) if name == "envmesh" else \
        np.tile(np.array([[0.0, 3.0, 9.0]], np.float32), (2048, 1))
    d = rng.uniform(-0.5, 0.5, (2048, 3)).astype(np.float32) + [0.0, -0.2, -1.0]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    times = np.zeros(2048, np.float32)
    a = _jax_costs(jf, *map(jnp.asarray, (o, d, times)))
    b = traversal_costs(tf, *map(torch.from_numpy, (o, d, times))).numpy()
    np.testing.assert_array_equal(b, a)
    assert len(np.unique(b)) > 10


@pytest.mark.parametrize("name,args,mode", [
    ("envmesh", (32, 32, 4, 24), "complexity"),
    ("many_mesh", (12, 32, 32, 2), "complexity"),
    ("cornell", (32, 32, 2), "normals"),
    ("envmesh", (32, 32, 4, 24), "normals"),
])
def test_debug_modes_match_jax(name, args, mode):
    """2 spp at 32x32 (1,024 rays a sample: one JAX tile): the complexity
    heat map within 1e-6 (XLA rounds the colour map's hue arithmetic in
    the last bit), the normals within 1e-4 (a last-bit difference of the
    camera ray moves a sphere's normal near its silhouette); alpha 1, no
    splat."""
    js = getattr(jpresets, f"{name}_scene")(*args)
    ts = getattr(tpresets, f"{name}_scene")(*args)
    if name == "cornell":  # a bump-mapped floor: the view shows the bumped normal
        js.primitives[0].material.bump = ts.primitives[0].material.bump = 0.5
    kw = dict(width=32, height=32, max_depth=1, samples_per_pass=2, mode=mode)
    key = jax.random.key(2)
    a = jax_render_pass(js.flatten(), JCam.from_host(js.camera), key, **kw)
    tflat = ts.flatten(device="cpu")
    assert tflat.has_bump == (name == "cornell")
    b = trenderer.render_pass(tflat, TCam.from_host(ts.camera, device="cpu"),
                              JaxUniforms(key), **kw).numpy()
    assert b.shape == (32, 32, 4) and (b[..., 3] == 1).all()
    if mode == "complexity":
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)
        assert len(np.unique(b[..., :3].reshape(-1, 3), axis=0)) > 10  # a real heat map
    else:
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=0)
        assert (b[..., :3] > 0).any()
