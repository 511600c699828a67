"""The stratified and blue-noise samplers against tinsel_tpu at equal
draws: the best-candidate point sets, the toroidal shift, and render
passes with each sampler."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinsel_tpu.core import sampling as jsampling
from tinsel_tpu.render.camera import CameraParams as JCam
from tinsel_tpu.scene import presets as jpresets
from tinsel_tpu_torch.core import sampling as tsampling
from tinsel_tpu_torch.render import renderer as trenderer
from tinsel_tpu_torch.render.camera import CameraParams as TCam
from tinsel_tpu_torch.scene import presets as tpresets

from torch_parity import JaxUniforms, assert_pass_matches, jax_render_pass

torch.set_num_threads(2)


@pytest.mark.parametrize("n", [2, 4, 16, 64])
def test_best_candidate_sets_equal_jax(n):
    """Both generators bit for bit at equal draws. Each step keeps the
    candidate with the largest distance to the set (argmax: the first of
    equal scores on both sides); the scores of the best and second-best
    candidate never come within 1e-6 of each other here, so no near-tie
    could flip the pick."""
    key = jax.random.key(n)
    a = np.asarray(jsampling.best_candidate_2d(n, key))
    b = tsampling.best_candidate_2d(n, JaxUniforms(key)).numpy()
    np.testing.assert_array_equal(b, a)
    a = np.asarray(jsampling.best_candidate_projective_2d(n, key))
    b = tsampling.best_candidate_projective_2d(n, JaxUniforms(key)).numpy()
    np.testing.assert_array_equal(b, a)
    assert ((b >= 0) & (b < 1)).all() and len(np.unique(b, axis=0)) == n
    _assert_no_near_tie(n, JaxUniforms(key))


def _assert_no_near_tie(n, src, k=32):
    pts = tsampling.best_candidate_2d(n, src)
    for i in range(1, n):
        cand = src.uniform((i,), (k, 2))
        score = tsampling._toroidal_dist2(cand[:, None, :], pts[None, :i, :]).min(dim=1).values
        top2 = torch.topk(score, 2).values
        assert float(top2[0] - top2[1]) > 1e-6


def test_toroidal_shift_and_randint_equal_jax():
    key = jax.random.key(7)
    pts = np.random.default_rng(0).random((10, 2)).astype(np.float32)
    a = np.asarray(jsampling.toroidal_shift(jnp.asarray(pts), key))
    b = tsampling.toroidal_shift(torch.from_numpy(pts), JaxUniforms(key)).numpy()
    np.testing.assert_array_equal(b, a)
    r = JaxUniforms(key).randint((9,), (), 0, 37)
    assert int(r) == int(jax.random.randint(jax.random.fold_in(key, 9), (), 0, 37))
    for src in (tsampling.NumpyUniforms(1, "cpu"), tsampling.PathUniforms(1, "cpu")):
        v = tsampling.Prefixed(src, 3).randint((9,), (50,), 2, 6)
        assert v.shape == (50,) and int(v.min()) >= 2 and int(v.max()) < 6


@pytest.mark.parametrize("sampler", ["stratified", "bluenoise"])
def test_sampler_render_pass_matches_jax(sampler):
    """Cornell 32x32 depth 1 at 4 spp in one pass (a 2 x 2 stratum grid;
    a 4-point blue-noise set shifted per pixel), the criteria of the
    Cornell parity test."""
    js, ts = jpresets.cornell_scene(32, 32, 1), tpresets.cornell_scene(32, 32, 1)
    kw = dict(width=32, height=32, max_depth=1, samples_per_pass=4, sampler=sampler,
              filter_type="gaussian", filter_width=1.0, filter_falloff=1.0)
    key = jax.random.key(9)
    a = jax_render_pass(js.flatten(), JCam.from_host(js.camera), key, **kw)
    b = trenderer.render_pass(ts.flatten(device="cpu"), TCam.from_host(ts.camera, device="cpu"),
                              JaxUniforms(key), **kw).numpy()
    assert_pass_matches(a, b)


@pytest.mark.parametrize("sampler", ["stratified", "bluenoise"])
def test_sample_grid_equals_jax(sampler):
    """The raster positions and shutter times themselves, 6 spp (a 2 x 3
    stratum grid), with a moving shutter."""
    from tinsel_tpu.render.renderer import _sample_grid as jgrid

    from tinsel_tpu_torch.render.renderer import _sample_grid as tgrid

    js, ts = jpresets.cornell_scene(8, 8, 1), tpresets.cornell_scene(8, 8, 1)
    js.camera.shutter_start = ts.camera.shutter_start = 0.25
    key = jax.random.key(1)
    a = [np.asarray(x) for x in jgrid(8, 8, JCam.from_host(js.camera), key, 6, sampler)]
    b = [x.numpy() for x in tgrid(8, 8, TCam.from_host(ts.camera, device="cpu"),
                                  JaxUniforms(key), 6, sampler)]
    for x, y in zip(b, a):
        np.testing.assert_allclose(x, y, atol=1e-6, rtol=0)
    assert b[2].min() >= 0.25
