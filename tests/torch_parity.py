"""Helpers shared by the tests that hold tinsel_tpu_torch against tinsel_tpu:
a JAX-backed UniformSource and numpy views of the JAX package's state.

Importing this module builds tinsel_tpu's native BVH library
(``build_jax_native_library``) before any test runs."""

from __future__ import annotations

import dataclasses
import fcntl
import os
import subprocess

import jax
import numpy as np
import torch


class JaxUniforms:
    """UniformSource that reproduces the JAX package's draws: fold ``key``
    along ``path``, then ``jax.random.uniform(k, shape)``."""

    def __init__(self, key):
        self.key = key

    def uniform(self, path, shape):
        k = self.key
        for p in path:
            k = jax.random.fold_in(k, p)
        return torch.from_numpy(np.array(jax.random.uniform(k, tuple(shape))))

    def randint(self, path, shape, low, high):
        k = self.key
        for p in path:
            k = jax.random.fold_in(k, p)
        return torch.from_numpy(np.array(jax.random.randint(k, tuple(shape), low, high)))


def scene_to_numpy(flat):
    """(arrays, static) of a tinsel_tpu SceneFlat, the input of
    tinsel_tpu_torch.scene.convert.scene_flat_from_numpy."""
    arrays = {}
    for group in ("prims", "materials"):
        obj = getattr(flat, group)
        for f in dataclasses.fields(obj):
            arrays[f"{group}.{f.name}"] = np.asarray(getattr(obj, f.name))
    arrays["pool.node_rows"] = np.asarray(flat.pool.node_rows)
    arrays["pool.block_rows"] = np.asarray(flat.pool.block_rows)
    arrays["pool.tri_cdf"] = np.asarray(flat.pool.tri_cdf)
    arrays["pool.tri_planes"] = np.stack([np.asarray(p) for p in flat.pool.tri_planes])
    arrays["pool.nrm_planes"] = np.stack([np.asarray(p) for p in flat.pool.nrm_planes])
    for name in ("sky_horizon", "sky_zenith", "prim_type", "prim_light_samples",
                 "prim_local_area", "prim_bump"):
        arrays[name] = np.asarray(getattr(flat, name))
    arrays["light_pmf"] = np.asarray(flat.light_pmf)
    if flat.probe is not None:
        for f in dataclasses.fields(flat.probe):
            arrays[f"probe.{f.name}"] = np.asarray(getattr(flat.probe, f.name))
    prim_static = []
    for ps in flat.prim_static:
        mesh = None if ps.mesh is None else dataclasses.asdict(ps.mesh)
        prim_static.append(dict(
            type=ps.type, mesh=mesh, material_index=ps.material_index,
            light_samples=ps.light_samples, motion=ps.motion,
        ))
    return arrays, dict(prim_static=prim_static, light_indices=flat.light_indices,
                        has_bump=flat.has_bump)


def camera_to_numpy(cam):
    return {f.name: np.asarray(getattr(cam, f.name)) for f in dataclasses.fields(cam)}


def materials_rows(flat, idx):
    """The JAX MaterialsFlat gathered at numpy indices, as a dict."""
    return {
        f.name: np.asarray(getattr(flat.materials, f.name))[idx]
        for f in dataclasses.fields(flat.materials)
    }


def jax_render_pass(flat, cam, key, **kw):
    """tinsel_tpu's render_pass, jitted, as numpy."""
    from tinsel_tpu.render.renderer import render_pass

    return np.array(jax.jit(lambda s, c, k: render_pass(s, c, k, **kw))(flat, cam, key))


def assert_pass_matches(a, b):
    """A port render pass ``b`` against the JAX pass ``a`` at equal draws:
    at least 99.5% of pixels within atol 1e-4 / rtol 1e-3, image means
    within 1e-3 relative (a ray grazing an edge may take another path after
    a last-bit difference of a transcendental function)."""
    assert b.shape == a.shape and np.isfinite(b).all()
    close = np.isclose(b, a, atol=1e-4, rtol=1e-3).all(axis=-1)
    assert close.mean() >= 0.995, close.mean()
    rel = abs(b[..., :3].mean() - a[..., :3].mean()) / a[..., :3].mean()
    assert rel < 1e-3, rel


def loaded_pass_pair(jscene, tscene, key, size=32, max_depth=4, moved_camera=False):
    """One 1-spp pass of a scene each package loaded itself, at size x size
    and depth min(the file's maxDepth, max_depth), with the file's own
    filter, clamp and roulette: (JAX pass, port pass at equal draws), and
    with ``moved_camera`` a third, the JAX pass from a camera one ulp
    away (its position's components stepped to the next float up)."""
    from tinsel_tpu.render.camera import CameraParams as JCam
    from tinsel_tpu.render.renderer import render_pass as jrender_pass
    from tinsel_tpu_torch.render import renderer as trenderer
    from tinsel_tpu_torch.render.camera import CameraParams as TCam

    o = jscene.options
    kw = dict(width=size, height=size, max_depth=min(o.max_depth, max_depth), clamp=o.clamp,
              filter_type=o.filter_type, filter_width=o.filter_width,
              filter_falloff=o.filter_falloff, rr_depth=o.rr_depth)
    jflat, jcam = jscene.flatten(), JCam.from_host(jscene.camera)
    jpass = jax.jit(lambda s, c, k: jrender_pass(s, c, k, **kw))
    a = np.array(jpass(jflat, jcam, key))
    b = trenderer.render_pass(tscene.flatten(device="cpu"),
                              TCam.from_host(tscene.camera, device="cpu"),
                              JaxUniforms(key), **kw).numpy()
    if not moved_camera:
        return a, b
    pos = np.nextafter(np.asarray(jcam.position), np.float32(np.inf))
    moved = dataclasses.replace(jcam, position=jax.numpy.asarray(pos))
    return a, b, np.array(jpass(jflat, moved, key))


SCENES_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")


def check_scene_file(name, tmp_path, monkeypatch, seed, max_depth=4, ill_conditioned=False):
    """(b) on a scene file: each package loads ``scenes/<name>.tin`` (or
    ``scenes/<name>`` for a Tungsten ``.json``) with its own loader, each
    mesh cache in its own directory under tmp_path; one pass at equal
    draws must match (``assert_pass_matches``).

    ``ill_conditioned``: a scene whose JAX render itself moves on more than
    0.5% of its pixels when the camera moves by one ulp (veach_mis.json:
    near-mirror plates lit by tiny, bright spheres). Its share of agreeing
    pixels must reach that of the two JAX passes less 0.005, not 0.995;
    the means are held to 1e-3 as everywhere."""
    from tinsel_tpu.scene.loaders import mesh_io as jmesh_io
    from tinsel_tpu.scene.loaders.tin import load_tin as jload_tin
    from tinsel_tpu.scene.loaders.tungsten import load_tungsten as jload_tungsten
    from tinsel_tpu_torch.scene.loaders import mesh_io as tmesh_io
    from tinsel_tpu_torch.scene.loaders.tin import load_tin as tload_tin
    from tinsel_tpu_torch.scene.loaders.tungsten import load_tungsten as tload_tungsten

    monkeypatch.setattr(jmesh_io, "_CACHE_DIR", str(tmp_path / "jax_cache"))
    monkeypatch.setattr(tmesh_io, "_CACHE_DIR", str(tmp_path / "torch_cache"))
    if name.endswith(".json"):
        path = os.path.join(SCENES_DIR, name)
        js, ts = jload_tungsten(path), tload_tungsten(path)
    else:
        path = os.path.join(SCENES_DIR, name + ".tin")
        js, ts = jload_tin(path), tload_tin(path)
    key = jax.random.key(seed)
    if not ill_conditioned:
        a, b = loaded_pass_pair(js, ts, key, max_depth=max_depth)
        assert_pass_matches(a, b)
        assert a[..., :3].mean() > 1e-3
        return
    a, b, a_moved = loaded_pass_pair(js, ts, key, max_depth=max_depth, moved_camera=True)
    self_share = pixels_close(a_moved, a).mean()
    share = pixels_close(b, a).mean()
    assert self_share < 0.995  # else the usual limit applies
    assert share >= self_share - 0.005, (share, self_share)
    rel = abs(b[..., :3].mean() - a[..., :3].mean()) / a[..., :3].mean()
    assert rel < 1e-3, rel


def pixels_close(b, a):
    return np.isclose(b, a, atol=1e-4, rtol=1e-3).all(axis=-1)


def build_jax_native_library():
    """Build ``tinsel_tpu/native/libtinselbvh.so`` if it is missing or older
    than its source, once across processes.

    ``tinsel_tpu/native/bvh_native.py::_ensure_lib`` compiles the library at
    first use into one fixed temporary name under a ``threading.Lock``, which
    holds within a process only: two test workers compiling at once write
    the same temporary file, and one of them then renames a file the other
    is still writing ("file too short") or finds it gone. Here the build runs
    under an exclusive ``flock`` on the source, with the JAX package's
    compiler flags, into a per-process temporary name renamed atomically;
    ``_ensure_lib`` then finds the library up to date and compiles nothing.
    pytest-xdist workers import every test module before any of them runs a
    test, so calling this at import covers the JAX package's own tests too."""
    from tinsel_tpu.native import bvh_native

    so, src = bvh_native._SO, bvh_native._SRC
    with open(src, "rb") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
                tmp = f"{so}.tmp{os.getpid()}"
                subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp],
                               check=True, capture_output=True)
                os.replace(tmp, so)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


build_jax_native_library()
