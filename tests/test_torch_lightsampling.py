"""The rest of the integrator against tinsel_tpu at equal draws: power
light sampling (one light per lane from the power pmf, its MIS on emission
hits), Russian roulette, the forward-only loop, and the Perez skylight."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinsel_tpu.core import color as jcolor
from tinsel_tpu.render import skylight as jskylight
from tinsel_tpu.render.camera import CameraParams as JCam
from tinsel_tpu.scene import model as jmodel
from tinsel_tpu.scene import presets as jpresets
from tinsel_tpu_torch.core import color as tcolor
from tinsel_tpu_torch.core.sampling import NumpyUniforms, Prefixed
from tinsel_tpu_torch.render import renderer as trenderer
from tinsel_tpu_torch.render import skylight as tskylight
from tinsel_tpu_torch.render.camera import CameraParams as TCam
from tinsel_tpu_torch.render.camera import generate_rays
from tinsel_tpu_torch.render.integrator import path_trace, path_trace_while
from tinsel_tpu_torch.scene import model as tmodel
from tinsel_tpu_torch.scene import presets as tpresets

from torch_parity import JaxUniforms, assert_pass_matches, jax_render_pass

torch.set_num_threads(2)


def _two_lights(model, presets):
    """The Cornell box (depth 3) with a second light: a small warm emissive
    sphere."""
    sc = presets.cornell_scene(32, 32, 3)
    sc.add_primitive(model.Primitive(
        type=model.SPHERE, radius=0.15,
        start_transform=model.HostTransform(p=np.array([-0.55, 1.4, 0.3], np.float32)),
        material=model.Material(color=np.zeros(3, np.float32),
                                emission=np.array([6.0, 3.0, 1.0], np.float32)),
        light_samples=1,
    ))
    return sc


SCENES = {"cornell": lambda m, p: p.cornell_scene(32, 32, 2), "two_lights": _two_lights}


@pytest.mark.parametrize("name,light_sampling,rr_depth", [
    ("cornell", "power", 0), ("two_lights", "power", 2),
])
def test_render_pass_matches_jax(name, light_sampling, rr_depth):
    """32x32, one pass at the same key, the criteria of the Cornell parity
    test; the power pmf equal to the JAX package's bit for bit. Cornell
    (one light, depth 2); the two-light box at depth 3 with roulette from
    bounce 2, which decides the third bounce's rays (the roulette code does
    not depend on the light-sampling mode)."""
    js, ts = SCENES[name](jmodel, jpresets), SCENES[name](tmodel, tpresets)
    jflat, tflat = js.flatten(), ts.flatten(device="cpu")
    np.testing.assert_array_equal(tflat.light_pmf.numpy(), np.asarray(jflat.light_pmf))
    assert len(tflat.light_indices) == (2 if name == "two_lights" else 1)
    o = ts.options
    kw = dict(width=o.width, height=o.height, max_depth=o.max_depth, filter_type=o.filter_type,
              filter_width=o.filter_width, filter_falloff=o.filter_falloff,
              light_sampling=light_sampling, rr_depth=rr_depth)
    key = jax.random.key(6)
    a = jax_render_pass(jflat, JCam.from_host(js.camera), key, **kw)
    b = trenderer.render_pass(tflat, TCam.from_host(ts.camera, device="cpu"),
                              JaxUniforms(key), **kw).numpy()
    assert_pass_matches(a, b)


def test_roulette_kills_paths_and_keeps_the_mean():
    """rr_depth=1 on the two-light box at depth 6: another estimate with
    the same mean radiance within the noise."""
    flat = _two_lights(tmodel, tpresets).flatten(device="cpu")
    cam = TCam.from_host(_two_lights(tmodel, tpresets).camera, device="cpu")
    n = 64
    g = torch.arange(n, dtype=torch.float32) + 0.5
    raster = torch.stack(torch.meshgrid(g, g, indexing="xy"), -1).reshape(-1, 2)
    o, d = generate_rays(cam, n, n, raster, torch.zeros_like(raster))
    o, d = o.repeat(8, 1), d.repeat(8, 1)
    times = torch.zeros(o.shape[0])
    src = Prefixed(NumpyUniforms(3, "cpu"), 2)
    full = path_trace(flat, o, d, times, 6, src)
    rr = path_trace(flat, o, d, times, 6, src, rr_depth=1)
    assert not torch.equal(full, rr)
    m_full, m_rr = float(full.mean()), float(rr.mean())
    assert abs(m_rr - m_full) / m_full < 0.05, (m_full, m_rr)


@pytest.mark.parametrize("rr_depth,light_sampling", [(0, "all"), (2, "power")])
def test_path_trace_while_equals_path_trace(rr_depth, light_sampling):
    """The forward-only loop is the same bounce: bit-equal radiance."""
    sc = _two_lights(tmodel, tpresets)
    flat, cam = sc.flatten(device="cpu"), TCam.from_host(sc.camera, device="cpu")
    rng = np.random.default_rng(0)
    raster = torch.from_numpy(rng.uniform(0, 32, (2048, 2)).astype(np.float32))
    o, d = generate_rays(cam, 32, 32, raster, torch.zeros_like(raster))
    times = torch.zeros(2048)
    args = (flat, o, d, times, 5, Prefixed(NumpyUniforms(1, "cpu"), 2))
    kw = dict(rr_depth=rr_depth, light_sampling=light_sampling)
    a = path_trace(*args, **kw)
    b = path_trace_while(*args, **kw)
    assert torch.equal(a, b) and not b.requires_grad
    assert float(a.abs().sum()) > 0


def test_skylight_matches_jax():
    """sky_radiance_dir within 1e-5 relative (of the largest channel) on
    directions over the whole sphere, for three suns and turbidities."""
    rng = np.random.default_rng(1)
    d = rng.normal(size=(2000, 3)).astype(np.float32)
    for sun, turb in (([0.3, 0.8, 0.2], 2.5), ([-0.5, 0.3, 0.6], 4.0), ([0.0, 1.0, 0.1], 2.0)):
        sun = np.asarray(sun, np.float32)
        a = np.asarray(jax.jit(jskylight.sky_radiance_dir, static_argnums=2)(d, sun, turb))
        b = tskylight.sky_radiance_dir(torch.from_numpy(d), torch.from_numpy(sun), turb).numpy()
        assert np.isfinite(b).all() and b.max() > 0
        scale = np.abs(a).max(axis=-1, keepdims=True) + 1e-12
        np.testing.assert_allclose(b / scale, a / scale, atol=1e-5, rtol=0)


def test_color_conversions_match_jax():
    rng = np.random.default_rng(2)
    Y, x, y = (rng.uniform(0.0, 1.0, 256).astype(np.float32) for _ in range(3))
    y[:4] = 0.0  # the floor at 1e-6
    a = np.asarray(jcolor.xyz_to_linear_rgb(jcolor.yxy_to_xyz(*map(jnp.asarray, (Y, x, y)))))
    b = tcolor.xyz_to_linear_rgb(tcolor.yxy_to_xyz(*map(torch.from_numpy, (Y, x, y)))).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
