"""The slice end to end: the port's Cornell render, resolve and denoisers
against tinsel_tpu at equal draws, and the port's isolation from JAX."""

import ast
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinsel_tpu.core.color import resolve as jresolve
from tinsel_tpu.ops.pallas.nlm import nlm_denoise as jnlm_denoise
from tinsel_tpu.ops.pallas.nlm import nlm_guided_denoise as jnlm_guided_denoise
from tinsel_tpu.render.aov import render_aovs as jrender_aovs
from tinsel_tpu.render.camera import CameraParams as JCam
from tinsel_tpu.render.renderer import render_pass as jrender_pass
from tinsel_tpu.scene.presets import cornell_scene as jcornell
from tinsel_tpu_torch.core.color import resolve as tresolve
from tinsel_tpu_torch.core.sampling import NumpyUniforms
from tinsel_tpu_torch.ops.nlm import nlm_denoise, nlm_guided_denoise
from tinsel_tpu_torch.render import renderer as trenderer
from tinsel_tpu_torch.render.aov import render_aovs
from tinsel_tpu_torch.render.camera import CameraParams as TCam
from tinsel_tpu_torch.scene.presets import cornell_scene as tcornell

from torch_parity import JaxUniforms

torch.set_num_threads(2)
W = H = 32
DEPTH = 4
REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "tinsel_tpu_torch"


@pytest.fixture(scope="module")
def passes():
    """One 1-spp pass of cornell 32x32 depth 4 from both packages at the
    same key: the JAX package draws from it, the port reads the same draws
    through JaxUniforms."""
    key = jax.random.key(0)
    js = jcornell(W, H, DEPTH)
    jflat, jcam = js.flatten(), JCam.from_host(js.camera)
    kw = dict(width=W, height=H, max_depth=DEPTH, filter_type="gaussian",
              filter_width=1.0, filter_falloff=1.0)
    a = np.array(jax.jit(lambda s, c, k: jrender_pass(s, c, k, **kw))(jflat, jcam, key))
    ts = tcornell(W, H, DEPTH)
    tflat, tcam = ts.flatten(device="cpu"), TCam.from_host(ts.camera, device="cpu")
    b = trenderer.render_pass(tflat, tcam, JaxUniforms(key), **kw).numpy()
    return dict(jax=a, torch=b, jflat=jflat, jcam=jcam, tflat=tflat, tcam=tcam)


def test_render_pass_matches_jax_per_pixel(passes):
    """(a) Per-pixel parity at equal draws. Both sides run the same f32
    formulas, but XLA and PyTorch round a few transcendental functions and
    fused products differently in the last bit; a ray that grazes an edge
    (a sphere silhouette, the light quad's border) or a uniform that sits
    at a lobe threshold can then take the other branch and follow another
    path, so a few pixels may differ. At least 99.5% must agree."""
    a, b = passes["jax"], passes["torch"]
    assert b.shape == (H, W, 4) and np.isfinite(b).all()
    close = np.isclose(b, a, atol=1e-4, rtol=1e-3).all(axis=-1)
    assert close.mean() >= 0.995, close.mean()
    rel = abs(b[..., :3].mean() - a[..., :3].mean()) / a[..., :3].mean()
    assert rel < 1e-3, rel


def test_resolve_and_denoise_match_jax(passes):
    """(b) The slice's back end on the same accumulation buffer: resolve ->
    nlm_denoise, and render_aovs -> nlm_guided_denoise."""
    acc = passes["jax"]
    j_img = jresolve(jnp.asarray(acc))
    t_img = tresolve(torch.from_numpy(acc))
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=1e-6)
    np.testing.assert_allclose(
        nlm_denoise(t_img).numpy(), np.asarray(jax.jit(jnlm_denoise)(j_img)), atol=1e-5
    )

    j_aov = jax.jit(jrender_aovs, static_argnums=(2, 3))(
        passes["jflat"], passes["jcam"], W, H
    )
    t_aov = render_aovs(passes["tflat"], passes["tcam"], W, H)
    # depth and albedo to 1e-5; a sphere's normal near its silhouette moves
    # by up to ~1e-4 for a last-bit change of the camera ray (the root
    # sqrt(b^2 - 4c) has an unbounded derivative there), hence 1e-4
    for k, tol in (("normal", 1e-4), ("depth", 1e-5), ("albedo", 1e-5)):
        np.testing.assert_allclose(t_aov[k].numpy(), np.asarray(j_aov[k]), atol=tol)
    j_out = jax.jit(jnlm_guided_denoise)(j_img, j_aov["normal"], j_aov["albedo"], j_aov["depth"])
    t_out = nlm_guided_denoise(t_img, t_aov["normal"], t_aov["albedo"], t_aov["depth"])
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-5)


def test_render_accumulates_passes_like_the_jax_loop():
    """render() folds the pass index in first and renders the remainder
    pass at index n_full, as tinsel_tpu's render loop does."""
    sc = tcornell(8, 8, 2)
    src = NumpyUniforms(11, "cpu")
    acc = trenderer.render(sc, spp=3, samples_per_pass=2, device="cpu", source=src)
    flat, cam = sc.flatten(device="cpu"), TCam.from_host(sc.camera, device="cpu")
    ref = trenderer.make_accumulate_fn(sc.options, 2)(
        torch.zeros((8, 8, 4)), flat, cam, src, 0
    )
    ref = trenderer.make_accumulate_fn(sc.options, 1)(ref, flat, cam, src, 1)
    assert torch.equal(acc, ref)
    assert float(acc[..., 3].min()) > 0.0


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_package_imports_neither_jax_nor_tinsel_tpu():
    """(c) No module of the port imports jax or tinsel_tpu, and importing
    every module leaves jax out of sys.modules."""
    sources = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 20
    for path in sources:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "tinsel_tpu"), (path, mod)
    code = (
        "import importlib, pkgutil, sys, tinsel_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'tinsel_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'tinsel_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """(d) render() without device= means cuda; with no GPU it raises
    instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = tcornell(8, 8, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trenderer.render(sc, spp=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sc.flatten()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCam.from_host(sc.camera)
