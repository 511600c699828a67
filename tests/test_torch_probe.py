"""HDR probes in the port against tinsel_tpu: the probe tables, the probe
functions (uv mapping, nearest-texel eval, pdf, importance sampling), and
probe-lit render passes (probe NEE with unbounded shadow rays, escape-ray
MIS) at equal draws."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tinsel_tpu.render import probe as jprobe
from tinsel_tpu.render.camera import CameraParams as JCam
from tinsel_tpu.scene import model as jmodel
from tinsel_tpu.scene import presets as jpresets
from tinsel_tpu.scene.loaders.tin import _look_at_quat
from tinsel_tpu.scene.probe_io import create_test_probe as jcreate_test_probe
from tinsel_tpu_torch.core.sampling import Prefixed
from tinsel_tpu_torch.render import probe as tprobe
from tinsel_tpu_torch.render import renderer as trenderer
from tinsel_tpu_torch.render.camera import CameraParams as TCam
from tinsel_tpu_torch.render.integrator import path_trace
from tinsel_tpu_torch.scene import model as tmodel
from tinsel_tpu_torch.scene import presets as tpresets
from tinsel_tpu_torch.scene.convert import camera_from_numpy, scene_flat_from_numpy
from tinsel_tpu_torch.scene.probe_io import create_test_probe, load_probe

from torch_parity import (
    JaxUniforms, assert_pass_matches, camera_to_numpy, jax_render_pass, scene_to_numpy,
)

torch.set_num_threads(2)
PROBE_FIELDS = ("data", "pdf_x", "cdf_x", "pdf_y", "cdf_y")


def _random_probe(h=24, w=48, seed=0):
    """A probe with every texel lit (random radiance, some rows dark), so
    both CDF searches and the pdf see every kind of row."""
    rng = np.random.default_rng(seed)
    data = rng.gamma(0.5, 2.0, (h, w, 3)).astype(np.float32)
    data[3] = 0.0  # a black row: zero pdf_y
    return data


def _flat_probes(data):
    jp, tp = jmodel.HostProbe(data=data.copy()), tmodel.HostProbe(data=data.copy())
    jp.build_cdf()
    tp.build_cdf()
    jf = jmodel.ProbeFlat(**{k: jnp.asarray(getattr(jp, k)) for k in PROBE_FIELDS})
    tf = tmodel.ProbeFlat(**{k: torch.from_numpy(getattr(tp, k)) for k in PROBE_FIELDS})
    return jp, tp, jf, tf


def _dirs(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    # the poles, the seam (z = 0, x < 0) and axis-aligned directions
    d[:6] = [[0, 1, 0], [0, -1, 0], [-1, 0, 0], [1, 0, 0], [0, 0, 1], [0, 0, -1]]
    d[6:20, 2] = 0.0
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_probe_tables_and_test_probe_equal_jax(tmp_path):
    """build_cdf (f64, stored f32), create_test_probe and load_probe on a
    written .hdr, bit for bit."""
    from tinsel_tpu.io.hdr import save_hdr
    from tinsel_tpu.scene.probe_io import load_probe as jload_probe

    jp, tp, _, _ = _flat_probes(_random_probe())
    for k in PROBE_FIELDS:
        np.testing.assert_array_equal(getattr(tp, k), getattr(jp, k))
    jt, tt = jcreate_test_probe(128, 64), create_test_probe(128, 64)
    for k in PROBE_FIELDS:
        np.testing.assert_array_equal(getattr(tt, k), getattr(jt, k))
    path = str(tmp_path / "sky.hdr")
    save_hdr(path, _random_probe())
    jl, tl = jload_probe(path), load_probe(path)
    for k in PROBE_FIELDS:
        np.testing.assert_array_equal(getattr(tl, k), getattr(jl, k))


def _texel_edge_distance(uv, h, w):
    """Distance of u*w and v*h to the nearest integer (a texel edge)."""
    x = uv[:, 0].astype(np.float64) * w
    y = uv[:, 1].astype(np.float64) * h
    return np.minimum(np.abs(x - np.round(x)), np.abs(y - np.round(y)))


def test_probe_functions_match_jax():
    """dir -> uv within 1e-6 and the same texel from both uv's on every
    lane. eval and pdf against the jitted JAX functions: equal (pdf within
    1e-5 relative: near a pole the Jacobian's 1/sin(theta) turns a last-bit
    difference of arccos into up to 6.5e-6 on one lane here) except on
    lanes whose u*w or v*h lies on a texel edge, where XLA's fused
    (pi + phi) / 2pi * w may round to the texel below: 12 of the 4,096
    lanes here (the axis directions and the seam put there on purpose), and
    no lane off an edge."""
    _, _, jf, tf = _flat_probes(_random_probe())
    h, w = tf.data.shape[:2]
    d = _dirs(4096, 1)
    uv_j = np.asarray(jax.jit(jprobe.probe_dir_to_uv)(d))
    uv_t = tprobe.probe_dir_to_uv(torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(uv_t, uv_j, atol=1e-6, rtol=0)

    def texel(uv):
        return (np.clip((uv[:, 1] * h).astype(np.int32), 0, h - 1),
                np.clip((uv[:, 0] * w).astype(np.int32), 0, w - 1))

    np.testing.assert_array_equal(np.stack(texel(uv_t)), np.stack(texel(uv_j)))
    edge = _texel_edge_distance(uv_j, h, w) < 1e-5

    ev_j = np.asarray(jax.jit(lambda p, x: jprobe.probe_eval_dir(p, x))(jf, d))
    ev_t = tprobe.probe_eval_dir(tf, torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(ev_t[~edge], ev_j[~edge])
    assert (ev_t != ev_j).any(-1).sum() == 12
    pdf_j = np.asarray(jax.jit(jprobe.probe_pdf)(jf, d))
    pdf_t = tprobe.probe_pdf(tf, torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(pdf_t[~edge], pdf_j[~edge], rtol=1e-5, atol=1e-6)
    assert (pdf_t[:2] == 0).all() and (pdf_t > 0).mean() > 0.8
    # un-jitted, JAX takes the port's texel on every lane
    np.testing.assert_array_equal(ev_t, np.asarray(jprobe.probe_eval_dir(jf, d)))

    uv = np.random.default_rng(2).random((512, 2)).astype(np.float32)
    dir_j = np.asarray(jax.jit(jprobe.probe_uv_to_dir)(uv))
    dir_t = tprobe.probe_uv_to_dir(torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(dir_t, dir_j, atol=1e-6, rtol=0)


def test_probe_sampling_matches_jax():
    """probe_sample_uniforms: the two CDF searches pick the same texel on
    every lane (exact integer searches of the same tables); direction
    within 1e-6, color equal, pdf within 1e-6 relative."""
    _, _, jf, tf = _flat_probes(_random_probe())
    rng = np.random.default_rng(3)
    r1, r2 = (rng.random(4096, dtype=np.float32) for _ in range(2))
    r1[:3] = [0.0, 1.0 - 2**-24, 0.5]
    dj, cj, pj = (np.asarray(x) for x in jax.jit(jprobe.probe_sample_uniforms)(jf, r1, r2))
    dt, ct, pt = (x.numpy() for x in tprobe.probe_sample_uniforms(
        tf, torch.from_numpy(r1), torch.from_numpy(r2)))
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_allclose(dt, dj, atol=1e-6, rtol=0)
    np.testing.assert_allclose(pt, pj, rtol=1e-6, atol=0)
    # row 0 (v = 0) has sin(theta) = 0 and pdf 0, as r1 = 0 picks it
    assert pj[0] == 0 and (pj > 0).mean() > 0.9


def _probe_scene(m, create):
    """tests/test_probe.py's probe-lit scene: a glossy metal sphere over a
    matte plane under the disc-light test probe."""
    sc = m.Scene()
    sc.sky = m.Sky(horizon=np.zeros(3, np.float32), zenith=np.zeros(3, np.float32))
    sc.sky.probe = create()
    sc.add_primitive(m.Primitive(
        type=m.PLANE, plane=np.array([0, 1, 0, 0], np.float32),
        material=m.Material(color=np.full(3, 0.6, np.float32), roughness=0.7, specular=0.1),
    ))
    sc.add_primitive(m.Primitive(
        type=m.SPHERE, radius=0.6,
        start_transform=m.HostTransform(p=np.array([0.0, 0.6, 0.0], np.float32)),
        material=m.Material(color=np.array([0.9, 0.9, 0.92], np.float32), roughness=0.2,
                            specular=1.0, metallic=1.0),
    ))
    pos = np.array([0.0, 1.0, 3.0], np.float32)
    sc.camera = m.Camera(position=pos,
                         rotation=_look_at_quat(pos, np.array([0.0, 0.5, 0.0], np.float32)))
    return sc


def test_probe_scene_render_pass_matches_jax():
    """The probe-lit sphere over a plane, 32x32 depth 3, the scene carried
    across from the JAX package's arrays (probe tables and light pmf
    included)."""
    js = _probe_scene(jmodel, jcreate_test_probe)
    jflat, jcam = js.flatten(), JCam.from_host(js.camera)
    arrays, static = scene_to_numpy(jflat)
    tflat = scene_flat_from_numpy(arrays, static, device="cpu")
    tcam = camera_from_numpy(camera_to_numpy(jcam), device="cpu")
    for k in PROBE_FIELDS:
        assert torch.equal(getattr(tflat.probe, k), torch.from_numpy(np.array(arrays[f"probe.{k}"])))
    # the port's own flatten gives the same tables
    own = _probe_scene(tmodel, create_test_probe).flatten(device="cpu")
    for k in PROBE_FIELDS:
        assert torch.equal(getattr(own.probe, k), getattr(tflat.probe, k))
    kw = dict(width=32, height=32, max_depth=3)
    key = jax.random.key(8)
    a = jax_render_pass(jflat, jcam, key, **kw)
    b = trenderer.render_pass(tflat, tcam, JaxUniforms(key), **kw).numpy()
    assert_pass_matches(a, b)
    assert a[..., :3].mean() > 1e-3  # the probe lights the scene


def test_envmesh_probe_render_pass_matches_jax():
    """envmesh_scene(probe=True) at detail 16 (512 triangles, a BVH), 32x32
    depth 4: every bounce sends a probe shadow ray through the mesh."""
    js = jpresets.envmesh_scene(32, 32, 4, detail=16, probe=True)
    ts = tpresets.envmesh_scene(32, 32, 4, detail=16, probe=True)
    tflat = ts.flatten(device="cpu")
    assert tflat.probe is not None and tflat.probe.data.shape == (64, 128, 3)
    o = ts.options
    kw = dict(width=o.width, height=o.height, max_depth=o.max_depth, filter_type=o.filter_type,
              filter_width=o.filter_width, filter_falloff=o.filter_falloff)
    key = jax.random.key(4)
    a = jax_render_pass(js.flatten(), JCam.from_host(js.camera), key, **kw)
    b = trenderer.render_pass(tflat, TCam.from_host(ts.camera, device="cpu"),
                              JaxUniforms(key), **kw).numpy()
    assert_pass_matches(a, b)


def test_constant_probe_equals_constant_sky():
    """A constant probe is a constant sky: the probe's NEE and the escape
    MIS weight on top of the BSDF-only sky path must neither double count
    nor drop a term (tests/test_probe.py's check, on the port)."""
    def run(sc):
        flat = sc.flatten(device="cpu")
        n = 8192
        th = torch.linspace(0.0, 0.8, n)
        origins = torch.stack([torch.sin(th) * 0.5, torch.cos(th) * 0.5,
                               torch.full((n,), -3.0)], -1)
        dirs = torch.tensor([[0.0, 0.0, 1.0]]).repeat(n, 1)
        from tinsel_tpu_torch.core.sampling import NumpyUniforms
        rad = path_trace(flat, origins, dirs, torch.zeros(n), 3,
                         Prefixed(NumpyUniforms(5, "cpu"), 2))
        return float(rad.mean())

    mat = tmodel.Material(color=np.full(3, 0.65, np.float32), roughness=0.8, specular=0.2)
    sky = tmodel.Scene(sky=tmodel.Sky(horizon=np.ones(3, np.float32),
                                      zenith=np.ones(3, np.float32)))
    sky.add_primitive(tmodel.Primitive(type=tmodel.SPHERE, radius=1.0, material=mat))
    probe = tmodel.HostProbe(data=np.ones((32, 64, 3), np.float32))
    probe.build_cdf()
    lit = tmodel.Scene(sky=tmodel.Sky(probe=probe))
    lit.add_primitive(tmodel.Primitive(type=tmodel.SPHERE, radius=1.0,
                                       material=dataclasses.replace(mat)))
    e_sky, e_probe = run(sky), run(lit)
    assert abs(e_probe - e_sky) / e_sky < 0.02, (e_probe, e_sky)
