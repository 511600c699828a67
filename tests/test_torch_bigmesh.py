"""Big-mesh scenes through the port against tinsel_tpu: scene tracing
(the big-mesh batch, per-lane sub-BVH offsets, the shortlist rounds) and
whole render passes at equal draws.

On the CPU the walks are the plain versions of kernels K3 and K4
(``accel/traverse.py``); tests/test_torch_bvh_cuda.py holds the kernels
against them on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinsel_tpu.render import trace as jtrace
from tinsel_tpu.render.camera import CameraParams as JCam
from tinsel_tpu.render.renderer import render_pass as jrender_pass
from tinsel_tpu.scene import presets as jpresets
from tinsel_tpu_torch.ops import bvh as ops_bvh
from tinsel_tpu_torch.render import renderer as trenderer
from tinsel_tpu_torch.render import trace as ttrace
from tinsel_tpu_torch.render.camera import CameraParams as TCam
from tinsel_tpu_torch.scene import presets as tpresets

from torch_parity import JaxUniforms

torch.set_num_threads(2)
R = 2048
# (preset, args): 16 instances of one capsule (> 12: shortlist rounds);
# 20 distinct meshes, 14 of them big (rounds), 6 tiny tetrahedra; the
# Perlin sphere at 1,152 triangles
SCENES = {
    "instances16": ("instances_scene", (32, 32, 3, 4)),
    "many_mesh": ("many_mesh_scene", (20, 32, 32, 2)),
    "envmesh": ("envmesh_scene", (32, 32, 4, 24)),
}
# 81 instances of one capsule (a 9 x 9 grid): the rounds' stress case
GRID81 = ("instances_scene", (32, 32, 3, 9))


def _scenes(name):
    preset, args = SCENES[name] if name in SCENES else GRID81
    return (getattr(jpresets, preset)(*args).flatten(),
            getattr(tpresets, preset)(*args).flatten(device="cpu"))


def _rays(seed):
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-4, 4, R), rng.uniform(0.05, 3, R), rng.uniform(-4, 7, R)],
                 -1).astype(np.float32)
    # half aimed at the meshes, half in random directions
    aim = np.stack([rng.uniform(-2.5, 2.5, R), rng.uniform(0.2, 1.6, R),
                    rng.uniform(-2.5, 2.5, R)], -1) - o
    d = np.where(np.arange(R)[:, None] % 2 == 0, aim, rng.normal(size=(R, 3)))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tmax = rng.uniform(0.0, 6.0, R).astype(np.float32)
    return o, d, np.zeros(R, np.float32), tmax


@pytest.mark.parametrize("name", sorted(SCENES))
def test_trace_matches_jax(name):
    """Hit primitive equal; t and normal to 1e-4 (the refit's normal is
    interpolated from the same vertices; XLA rounds the JAX walk's t in
    the last bits); occlusion equal."""
    jf, tf = _scenes(name)
    o, d, times, tmax = _rays(1)
    jh = jax.jit(jtrace.trace_closest)(jf, *map(jnp.asarray, (o, d, times)))
    ops_bvh.reset_launch_counts()
    th = ttrace.trace_closest(tf, *map(torch.from_numpy, (o, d, times)))
    prim = np.asarray(jh.prim)
    np.testing.assert_array_equal(th.prim.numpy(), prim)
    hit = prim >= 0
    assert 0.2 < hit.mean() < 0.95
    mesh_hit = hit & np.isin(prim, [i for i, p in enumerate(tf.prim_static) if p.mesh is not None])
    assert mesh_hit.mean() > 0.1
    np.testing.assert_allclose(th.t.numpy()[hit], np.asarray(jh.t)[hit], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(th.normal.numpy(), np.asarray(jh.normal), atol=1e-4)
    jo = np.asarray(jax.jit(jtrace.trace_any)(jf, *map(jnp.asarray, (o, d, times, tmax))))
    to = ttrace.trace_any(tf, *map(torch.from_numpy, (o, d, times, tmax))).numpy()
    np.testing.assert_array_equal(to, jo)
    assert 0.05 < jo.mean() < 0.95
    # CPU tensors never launch a kernel
    assert ops_bvh.launch_counts == {"bvh_closest": 0, "bvh_any": 0, "bvh_steps": 0}


@pytest.mark.parametrize("name", ["instances16", "many_mesh", "grid81"])
def test_shortlist_rounds_equal_the_full_batch(name, monkeypatch):
    """The top-k rounds give exactly what walking every (instance, ray)
    pair gives, closest and occlusion."""
    _, tf = _scenes(name)
    o, d, times, tmax = map(torch.from_numpy, _rays(2))
    monkeypatch.setattr(ttrace, "INSTANCE_TOPK_MIN", 10**9)
    full = ttrace.trace_closest(tf, o, d, times), ttrace.trace_any(tf, o, d, times, tmax)
    monkeypatch.setattr(ttrace, "INSTANCE_TOPK_MIN", 1)
    rounds = ttrace.trace_closest(tf, o, d, times), ttrace.trace_any(tf, o, d, times, tmax)
    assert torch.equal(full[0].prim, rounds[0].prim)
    assert torch.equal(full[0].t, rounds[0].t)
    assert torch.equal(full[0].normal, rounds[0].normal)
    assert torch.equal(full[1], rounds[1])


@pytest.mark.parametrize("name", ["instances16", "envmesh"])
def test_render_pass_matches_jax_per_pixel(name):
    """One 1-spp pass at 32x32 from both packages at the same key: 99.5%
    of pixels within atol 1e-4 / rtol 1e-3 and image means within 1e-3
    relative, as the Cornell parity test (a ray grazing an edge may take
    another path after a last-bit difference)."""
    preset, args = SCENES[name]
    js, ts = getattr(jpresets, preset)(*args), getattr(tpresets, preset)(*args)
    o = ts.options
    kw = dict(width=o.width, height=o.height, max_depth=o.max_depth,
              filter_type=o.filter_type, filter_width=o.filter_width,
              filter_falloff=o.filter_falloff)
    key = jax.random.key(3)
    a = np.array(jax.jit(lambda s, c, k: jrender_pass(s, c, k, **kw))(
        js.flatten(), JCam.from_host(js.camera), key))
    b = trenderer.render_pass(ts.flatten(device="cpu"), TCam.from_host(ts.camera, device="cpu"),
                              JaxUniforms(key), **kw).numpy()
    assert b.shape == a.shape and np.isfinite(b).all()
    close = np.isclose(b, a, atol=1e-4, rtol=1e-3).all(axis=-1)
    assert close.mean() >= 0.995, close.mean()
    rel = abs(b[..., :3].mean() - a[..., :3].mean()) / a[..., :3].mean()
    assert rel < 1e-3, rel


@pytest.mark.parametrize("name", sorted(SCENES))
def test_trace_hands_the_kernels_contiguous_inputs(name, monkeypatch):
    """What the kernels' wrappers check on the card, checked here on the
    calls trace_closest / trace_any make: contiguous f32 rays and tmax,
    per-lane offsets as contiguous int32 (also for a one-instance batch)."""
    _, tf = _scenes(name)
    o, d, times, tmax = map(torch.from_numpy, _rays(3))
    calls = []
    for fn in ("closest_hit", "any_hit"):
        orig = getattr(ops_bvh, fn)

        def rec(*a, _orig=orig):
            calls.append(a)
            return _orig(*a)

        monkeypatch.setattr(ops_bvh, fn, rec)
    ttrace.trace_closest(tf, o, d, times)
    ttrace.trace_any(tf, o, d, times, tmax)
    assert calls
    for pool, noff, toff, oo, dd, tm, slots in calls:
        r = oo.shape[0]
        for t, dtype, shape in ((noff, torch.int32, (r,)), (toff, torch.int32, (r,)),
                                (oo, torch.float32, (r, 3)), (dd, torch.float32, (r, 3)),
                                (tm, torch.float32, (r,))):
            assert t.dtype == dtype and tuple(t.shape) == shape and t.is_contiguous()
        assert 1 <= slots <= 128
