"""Scene tracing and ray-primitive tests of the port against tinsel_tpu.

trace_closest / trace_any on the Cornell flat scene for 4096 random rays
(from inside the box, a quarter of them aimed at the light quad): the hit
primitive must be equal, t and normal agree to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinsel_tpu.geometry import intersect as jgeo
from tinsel_tpu.render import trace as jtrace
from tinsel_tpu.scene.presets import cornell_scene as jcornell
from tinsel_tpu_torch.geometry import intersect as tgeo
from tinsel_tpu_torch.render import trace as ttrace
from tinsel_tpu_torch.scene.presets import cornell_scene as tcornell

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
R = 4096


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(0)
    o = np.stack([
        rng.uniform(-0.95, 0.95, R), rng.uniform(0.05, 1.95, R),
        rng.uniform(-0.95, 3.0, R),
    ], -1).astype(np.float32)
    d = _unit(rng, R)
    # a quarter aimed at random points of the light quad (y = 1.9999)
    q = R // 4
    target = np.stack([
        rng.uniform(-0.3, 0.3, q), np.full(q, 1.9999), rng.uniform(-0.3, 0.3, q)
    ], -1).astype(np.float32)
    to = target - o[:q]
    d[:q] = to / np.linalg.norm(to, axis=-1, keepdims=True)
    times = rng.random(R).astype(np.float32)
    tmax = rng.uniform(0.0, 3.0, R).astype(np.float32)
    return o, d, times, tmax


@pytest.fixture(scope="module")
def scenes():
    return jcornell(32, 32, 4).flatten(), tcornell(32, 32, 4).flatten(device="cpu")


def test_trace_closest_matches_jax(rays, scenes):
    o, d, times, _ = rays
    jf, tf = scenes
    jh = jax.jit(jtrace.trace_closest)(jf, jnp.asarray(o), jnp.asarray(d), jnp.asarray(times))
    th = ttrace.trace_closest(tf, torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(times))
    np.testing.assert_array_equal(th.prim.numpy(), np.asarray(jh.prim))
    hit = np.asarray(jh.prim) >= 0
    assert hit.all()  # the box is closed
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), **TOL)
    np.testing.assert_allclose(th.normal.numpy(), np.asarray(jh.normal), **TOL)
    # every primitive, the light quad included, was hit by some ray
    assert set(np.unique(np.asarray(jh.prim))) == set(range(8))


def test_trace_any_matches_jax(rays, scenes):
    o, d, times, tmax = rays
    jf, tf = scenes
    jo = jax.jit(jtrace.trace_any)(jf, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(times), jnp.asarray(tmax))
    to = ttrace.trace_any(tf, torch.from_numpy(o), torch.from_numpy(d),
                          torch.from_numpy(times), torch.from_numpy(tmax))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert 0.05 < np.asarray(jo).mean() < 0.95


def _prims(rng, n):
    return dict(
        c=rng.normal(size=(n, 3)).astype(np.float32),
        rad=rng.uniform(0.2, 1.5, n).astype(np.float32),
        plane=np.concatenate([_unit(rng, n), rng.normal(size=(n, 1))], -1).astype(np.float32),
        a=rng.normal(size=(n, 3)).astype(np.float32),
        b=rng.normal(size=(n, 3)).astype(np.float32),
        cc=rng.normal(size=(n, 3)).astype(np.float32),
        o=(rng.normal(size=(n, 3)) * 2).astype(np.float32),
        d=_unit(rng, n),
    )


@pytest.mark.parametrize("kind", ["sphere", "plane", "tri", "aabb"])
def test_intersect_primitives(kind):
    x = _prims(np.random.default_rng(1), 2048)
    J = {k: jnp.asarray(v) for k, v in x.items()}
    T = {k: torch.from_numpy(v) for k, v in x.items()}
    if kind == "sphere":
        a = tgeo.intersect_ray_sphere(T["c"], T["rad"], T["o"], T["d"])
        b = jgeo.intersect_ray_sphere(J["c"], J["rad"], J["o"], J["d"])
    elif kind == "plane":
        a = tgeo.intersect_ray_plane(T["plane"], T["o"], T["d"])
        b = jgeo.intersect_ray_plane(J["plane"], J["o"], J["d"])
    elif kind == "tri":
        a = tgeo.intersect_ray_tri(T["a"], T["b"], T["cc"], T["o"], T["d"])
        b = jgeo.intersect_ray_tri(J["a"], J["b"], J["cc"], J["o"], J["d"])
    else:
        lo = np.minimum(x["a"], x["b"])
        hi = np.maximum(x["a"], x["b"])
        rcp = (1.0 / x["d"]).astype(np.float32)
        a = tgeo.intersect_ray_aabb(*map(torch.from_numpy, (lo, hi, x["o"], rcp)))
        b = jgeo.intersect_ray_aabb(*map(jnp.asarray, (lo, hi, x["o"], rcp)))
    hit_t, hit_j = a[0].numpy(), np.asarray(b[0])
    np.testing.assert_array_equal(hit_t, hit_j)
    assert 0 < hit_j.mean() < 1
    for at, bj in zip(a[1:], b[1:]):
        at, bj = at.numpy(), np.asarray(bj)
        if kind != "aabb":  # miss rows of the other outputs are unused
            at, bj = at[hit_j], bj[hit_j]
        np.testing.assert_allclose(at, bj, **TOL)
