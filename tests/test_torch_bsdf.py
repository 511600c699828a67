"""Disney BSDF of the port against tinsel_tpu.bsdf.disney at identical
inputs and the JAX package's exact uniforms.

Materials: the Cornell rows plus a transmissive, a clearcoat and a
subsurface row. Tolerance 1e-5 (relative and absolute): the same f32
formulas on both sides; GGX peaks reach ~1e5, hence the relative part.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinsel_tpu.bsdf import disney as jd
from tinsel_tpu.core.math import basis_from_vector
from tinsel_tpu.scene import model as jmodel
from tinsel_tpu.scene.presets import cornell_scene
from tinsel_tpu_torch.bsdf import disney as td
from tinsel_tpu_torch.scene.model import MaterialsFlat as TMaterials

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
N = 4096


def _materials():
    mats = [p.material for p in cornell_scene(8, 8, 1).primitives]
    mats += [
        jmodel.Material(color=np.array([0.9, 0.95, 1.0], np.float32),
                        transmission=1.0, eta=1.5, roughness=0.2),
        jmodel.Material(color=np.array([0.2, 0.4, 0.8], np.float32),
                        clearcoat=1.0, clearcoat_gloss=0.5, roughness=0.4),
        jmodel.Material(color=np.array([0.8, 0.5, 0.3], np.float32),
                        subsurface=0.7, roughness=0.6, specular_tint=0.5),
    ]
    return jmodel.MaterialsFlat.from_host(mats)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    jm = _materials()
    idx = rng.integers(0, jm.emission.shape[0], N)
    rows = {k: np.asarray(v)[idx] for k, v in vars(jm).items()}
    n = _unit(rng, N)
    v = _unit(rng, N)
    v = np.where((np.sum(v * n, -1) < 0)[:, None], -v, v)  # view above
    l = _unit(rng, N)  # both hemispheres
    choice = rng.integers(0, 2, N)
    eta_i = np.where(choice == 0, 1.0, 1.5).astype(np.float32)
    eta_o = np.where(choice == 0, 1.5, 1.0).astype(np.float32)
    return dict(rows=rows, n=n, v=v, l=l, eta_i=eta_i, eta_o=eta_o)


def _both(x):
    rows = x["rows"]
    jm = jmodel.MaterialsFlat(**{k: jnp.asarray(a) for k, a in rows.items()})
    tm = TMaterials(**{k: torch.from_numpy(np.array(a)) for k, a in rows.items()})
    J = {k: jnp.asarray(x[k]) for k in ("n", "v", "l", "eta_i", "eta_o")}
    T = {k: torch.from_numpy(x[k]) for k in ("n", "v", "l", "eta_i", "eta_o")}
    return jm, tm, J, T


@pytest.mark.parametrize("fn", ["bsdf_eval", "bsdf_pdf"])
def test_eval_and_pdf(inputs, fn):
    jm, tm, J, T = _both(inputs)
    a = getattr(td, fn)(tm, T["eta_i"], T["eta_o"], T["n"], T["v"], T["l"])
    b = getattr(jd, fn)(jm, J["eta_i"], J["eta_o"], J["n"], J["v"], J["l"])
    np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_sample(inputs):
    jm, tm, J, T = _both(inputs)
    key = jax.random.key(3)
    # the six draws bsdf_sample makes from its key (disney.py:180-183)
    uni = [np.array(jax.random.uniform(jax.random.fold_in(key, i), (N,)))
           for i in range(6)]
    u_ax, v_ax = basis_from_vector(J["n"])
    jl, jpdf, jev = jd.bsdf_sample(jm, J["eta_i"], J["eta_o"], u_ax, v_ax,
                                   J["n"], J["v"], key)
    tl, tpdf, tev = td.bsdf_sample(
        tm, T["eta_i"], T["eta_o"], torch.from_numpy(np.array(u_ax)),
        torch.from_numpy(np.array(v_ax)), T["n"], T["v"],
        [torch.from_numpy(u) for u in uni],
    )
    np.testing.assert_array_equal(tev.numpy(), np.asarray(jev))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    # Sampled directions sit near the GGX peak, where the pdf is badly
    # conditioned: t = 1 + (a^2 - 1) cos^2 cancels to ~a^2, so one ulp of
    # cos(theta_h) or of the half-vector normalization moves the pdf by
    # ~4/a^2 * 6e-8 = 2.4e-5 relative at roughness 0.1 (the spheres). The
    # sampled pdf is therefore held to 1e-4 (a few ulps of input); the
    # event, direction, and eval/pdf at generic directions keep 1e-5.
    np.testing.assert_allclose(tpdf.numpy(), np.asarray(jpdf), rtol=1e-4, atol=1e-5)
    # every lobe was drawn
    assert set(np.unique(np.asarray(jev))) == {0, 1, 2}
