"""The alternative BSDFs (``bsdf/lambert.py``, ``bsdf/blinn.py``) and the
BSDF visualizer (``diag/bsdf_vis.py::bsdf_test``) of the port against
tinsel_tpu's, at identical inputs and the JAX package's exact uniforms.

Tolerances: eval and pdf 1e-5 relative and absolute (the same f32
formulas on both sides). The sampled pdf and the Blinn eval with its
exponent 10/roughness (up to 100 here) are held to 1e-4 relative: one ulp
of cos(theta_h) moves cos^e by about e ulps. ``bsdf_test``: the ratio map
within 1e-4, and the scatter marks at the same pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinsel_tpu.bsdf import blinn as jblinn
from tinsel_tpu.bsdf import lambert as jlambert
from tinsel_tpu.core.math import basis_from_vector
from tinsel_tpu.diag.bsdf_vis import bsdf_test as jbsdf_test
from tinsel_tpu.scene import model as jmodel
from tinsel_tpu_torch.bsdf import blinn as tblinn
from tinsel_tpu_torch.bsdf import lambert as tlambert
from tinsel_tpu_torch.diag.bsdf_vis import bsdf_test as tbsdf_test
from tinsel_tpu_torch.scene.model import MaterialsFlat as TMaterials

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
N = 2048
MODULES = {"lambert": (jlambert, tlambert), "blinn": (jblinn, tblinn)}


def _materials():
    return [
        jmodel.Material(color=np.array([0.8, 0.8, 0.8], np.float32), roughness=1.0),
        jmodel.Material(color=np.array([0.2, 0.4, 0.8], np.float32), roughness=0.4),
        jmodel.Material(color=np.array([0.9, 0.6, 0.3], np.float32), roughness=0.1,
                        metallic=1.0),
    ]


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    jm = jmodel.MaterialsFlat.from_host(_materials())
    idx = rng.integers(0, jm.emission.shape[0], N)
    rows = {k: np.asarray(v)[idx] for k, v in vars(jm).items()}
    n = _unit(rng, N)
    v = _unit(rng, N)
    v = np.where((np.sum(v * n, -1) < 0)[:, None], -v, v)  # view above
    l = _unit(rng, N)  # both hemispheres
    eta_i = np.ones(N, np.float32)
    eta_o = np.full(N, 1.5, np.float32)
    jmat = jmodel.MaterialsFlat(**{k: jnp.asarray(a) for k, a in rows.items()})
    tmat = TMaterials(**{k: torch.from_numpy(np.array(a)) for k, a in rows.items()})
    arrays = dict(n=n, v=v, l=l, eta_i=eta_i, eta_o=eta_o)
    return (jmat, {k: jnp.asarray(a) for k, a in arrays.items()},
            tmat, {k: torch.from_numpy(a) for k, a in arrays.items()})


@pytest.mark.parametrize("name", list(MODULES))
@pytest.mark.parametrize("fn", ["bsdf_eval", "bsdf_pdf"])
def test_eval_and_pdf(inputs, name, fn):
    jmat, J, tmat, T = inputs
    jmod, tmod = MODULES[name]
    a = getattr(tmod, fn)(tmat, T["eta_i"], T["eta_o"], T["n"], T["v"], T["l"])
    b = getattr(jmod, fn)(jmat, J["eta_i"], J["eta_o"], J["n"], J["v"], J["l"])
    tol = dict(rtol=1e-4, atol=1e-5) if (name, fn) == ("blinn", "bsdf_eval") else TOL
    np.testing.assert_allclose(a.numpy(), np.broadcast_to(np.asarray(b), a.shape), **tol)


@pytest.mark.parametrize("name", list(MODULES))
def test_sample(inputs, name):
    jmat, J, tmat, T = inputs
    jmod, tmod = MODULES[name]
    key = jax.random.key(3)
    # the two draws the sampler makes from its key: fold_in(key, 0), (key, 1)
    uni = [np.array(jax.random.uniform(jax.random.fold_in(key, i), (N,))) for i in range(2)]
    u_ax, v_ax = basis_from_vector(J["n"])
    jl, jpdf, jev = jmod.bsdf_sample(jmat, J["eta_i"], J["eta_o"], u_ax, v_ax, J["n"], J["v"], key)
    tl, tpdf, tev = tmod.bsdf_sample(
        tmat, T["eta_i"], T["eta_o"], torch.from_numpy(np.array(u_ax)),
        torch.from_numpy(np.array(v_ax)), T["n"], T["v"], [torch.from_numpy(u) for u in uni],
    )
    np.testing.assert_array_equal(tev.numpy(), np.asarray(jev))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tpdf.numpy(), np.asarray(jpdf), rtol=1e-4, atol=1e-5)


def _jax_draws(seed: int, n: int):
    """The uniforms bsdf_test's vmapped sampler draws in the JAX package:
    sample j's key is split(key(seed), n)[j], and uniform i of it
    fold_in(k_j, i) (six, as the Disney sampler takes)."""
    keys = jax.random.split(jax.random.key(seed), n)
    return [np.array(jax.vmap(lambda k: jax.random.uniform(jax.random.fold_in(k, i), ()))(keys))
            for i in range(6)]


@pytest.mark.parametrize("name", ["disney", "lambert", "blinn"])
@pytest.mark.parametrize("m", [0, 2])
def test_bsdf_test_image_matches_jax(tmp_path, name, m):
    from tinsel_tpu_torch.io.hdr import load_pfm

    mat = _materials()[m]
    jmod, tmod = MODULES.get(name, (None, None))
    kw = dict(width=64, height=32, n_samples=200, view_theta=0.5, seed=4)
    a = jbsdf_test(mat, jmod, **kw)
    path = str(tmp_path / "b.pfm")
    b = tbsdf_test(mat, tmod, **kw, uniforms=_jax_draws(4, 200), device="cpu", pfm_path=path)
    marks_a = (a == [0.0, 10.0, 0.0]).all(axis=-1)
    marks_b = (b == [0.0, 10.0, 0.0]).all(axis=-1)
    assert marks_a.sum() > 10
    np.testing.assert_array_equal(marks_b, marks_a)
    np.testing.assert_allclose(b[~marks_a], a[~marks_a], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(load_pfm(path), b)
    # the port's own draws give a map of the same shape
    c = tbsdf_test(mat, tmod, **kw, device="cpu")
    assert c.shape == (32, 64, 3) and np.isfinite(c).all()
