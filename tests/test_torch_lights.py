"""Light sampling of the port against tinsel_tpu.render.lights at the JAX
package's exact draws: ``primitive_sample`` on the Cornell quad and on a
moving, growing sphere light, and ``sample_lights`` (next-event estimation
with segment occlusion) at points of the Cornell box lit by both.

Tolerance: samples 1e-5 (the same f32 formulas). NEE radiance: a shadow
ray that grazes a sphere's silhouette can come out occluded on one side
and not on the other after a last-bit difference, so 99.5% of the points
must agree to 1e-5 absolute / 1e-4 relative and the means to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinsel_tpu.render import lights as jlights
from tinsel_tpu.scene import model as jmodel
from tinsel_tpu.scene import presets as jpresets
from tinsel_tpu_torch.render import lights as tlights
from tinsel_tpu_torch.scene import model as tmodel
from tinsel_tpu_torch.scene import presets as tpresets

from torch_parity import JaxUniforms

torch.set_num_threads(1)
R = 2048
TOL = dict(rtol=1e-5, atol=1e-5)


def _scene(model, presets):
    sc = presets.cornell_scene(8, 8, 2)
    sc.add_primitive(model.Primitive(
        type=model.SPHERE, radius=0.12,
        start_transform=model.HostTransform(p=np.array([0.5, 1.5, 0.4], np.float32)),
        end_transform=model.HostTransform(
            p=np.array([0.4, 1.55, 0.4], np.float32), s=1.3),
        material=model.Material(
            color=np.zeros(3, np.float32),
            emission=np.array([4.0, 6.0, 9.0], np.float32)),
        light_samples=2,
    ))
    return sc


@pytest.fixture(scope="module")
def scenes():
    return _scene(jmodel, jpresets).flatten(), _scene(tmodel, tpresets).flatten(device="cpu")


@pytest.fixture(scope="module")
def times():
    return np.random.default_rng(0).random(R).astype(np.float32)


@pytest.mark.parametrize("light", [5, 8], ids=["quad", "sphere"])
def test_primitive_sample_matches_jax(scenes, times, light):
    jf, tf = scenes
    key = jax.random.key(11)
    a = jlights.primitive_sample(jf, light, jnp.asarray(times), key)
    src = JaxUniforms(key)
    uni = [src.uniform((k,), (R,)) for k in range(3)]
    b = tlights.primitive_sample(tf, light, torch.from_numpy(times), uni)
    for x, y in zip(b, a):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL)


def test_sample_lights_matches_jax(scenes, times):
    jf, tf = scenes
    rng = np.random.default_rng(1)
    # points on the floor (prim 0), seen from above at random angles
    p = np.stack([rng.uniform(-0.95, 0.95, R), np.zeros(R),
                  rng.uniform(-0.95, 0.95, R)], -1).astype(np.float32)
    n = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (R, 1))
    wo = rng.normal(size=(R, 3)).astype(np.float32)
    wo[:, 1] = np.abs(wo[:, 1]) + 0.05
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    idx = np.zeros(R, np.int32)
    eta_i = np.ones(R, np.float32)
    key = jax.random.key(5)

    jm = jf.materials.select(jnp.asarray(idx))
    a = np.asarray(jlights.sample_lights(
        jf, jm, jnp.asarray(eta_i), jm.eta, *map(jnp.asarray, (p, n, wo, times)), key,
    ))
    tm = tf.materials.select(torch.from_numpy(idx))
    b = tlights.sample_lights(
        tf, tm, torch.from_numpy(eta_i), tm.eta,
        *map(torch.from_numpy, (p, n, wo, times)), JaxUniforms(key),
    ).numpy()

    assert np.isfinite(b).all() and (a > 0).any(axis=-1).mean() > 0.5
    close = np.isclose(b, a, atol=1e-5, rtol=1e-4).all(axis=-1)
    assert close.mean() >= 0.995, close.mean()
    np.testing.assert_allclose(b.mean(axis=0), a.mean(axis=0), rtol=1e-4)
