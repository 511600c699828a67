"""tinsel_tpu_torch.core against tinsel_tpu.core on identical numpy inputs.

Tolerance: 1e-6 relative (with a 1e-6 floor for values near zero; the
inputs are O(1)): both sides run the same f32 formulas, so only the last
bits of transcendental functions and operation fusion may differ.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinsel_tpu.core import color as jcolor
from tinsel_tpu.core import math as jm
from tinsel_tpu.core import sampling as jsamp
from tinsel_tpu.core import search as jsearch
from tinsel_tpu_torch.core import color as tcolor
from tinsel_tpu_torch.core import math as tm
from tinsel_tpu_torch.core import sampling as tsamp
from tinsel_tpu_torch.core import search as tsearch

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-6)
N = 257


def _rng(seed):
    return np.random.default_rng(seed)


def _vec(rng, n=N, k=3):
    return rng.normal(size=(n, k)).astype(np.float32)


def _quat(rng, n=N):
    q = _vec(rng, n, 4)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _close(a_torch, b_jax):
    if isinstance(a_torch, tuple):
        for a, b in zip(a_torch, b_jax):
            _close(a, b)
        return
    np.testing.assert_allclose(
        a_torch.numpy(), np.asarray(b_jax), **TOL
    )


T = torch.from_numpy
J = jnp.asarray


@pytest.mark.parametrize(
    "name",
    ["normalize", "safe_normalize", "face_forward", "clamp_length", "cross",
     "quat_rotate", "quat_normalize", "basis_from_vector"],
)
def test_math_vector_ops(name):
    rng = _rng(0)
    a, b = _vec(rng), _vec(rng)
    a[:5] = 0.0  # degenerate rows exercise the guards
    q1 = _quat(rng)
    cases = {
        "normalize": lambda m, x: m.normalize(x(a)),
        "safe_normalize": lambda m, x: m.safe_normalize(x(a), fallback=x(b)),
        "face_forward": lambda m, x: m.face_forward(x(a), x(b)),
        "clamp_length": lambda m, x: m.clamp_length(x(a), 0.7),
        "cross": lambda m, x: m.cross(x(a), x(b)),
        "quat_rotate": lambda m, x: m.quat_rotate(x(q1), x(b)),
        "quat_normalize": lambda m, x: m.quat_normalize(x(q1 * 3.0)),
        "basis_from_vector": lambda m, x: m.basis_from_vector(
            x(b / np.linalg.norm(b, axis=-1, keepdims=True))
        ),
    }
    _close(cases[name](tm, T), cases[name](jm, J))


@pytest.mark.parametrize("name", ["point", "vector", "inv_point", "inv_vector"])
def test_math_transforms(name):
    rng = _rng(1)
    p, v, q = _vec(rng), _vec(rng), _quat(rng)
    s = rng.uniform(0.2, 2.0, N).astype(np.float32)
    fn = {
        "point": "transform_point", "vector": "transform_vector",
        "inv_point": "inverse_transform_point",
        "inv_vector": "inverse_transform_vector",
    }[name]
    a = getattr(tm, fn)(tm.Transform(T(p), T(q), T(s)), T(v))
    b = getattr(jm, fn)(jm.Transform(J(p), J(q), J(s)), J(v))
    _close(a, b)


def test_interpolate_transform():
    rng = _rng(2)
    p0, p1, q0, q1 = _vec(rng), _vec(rng), _quat(rng), _quat(rng)
    s0 = rng.uniform(0.2, 2.0, N).astype(np.float32)
    s1 = rng.uniform(0.2, 2.0, N).astype(np.float32)
    t = rng.random(N).astype(np.float32)
    a = tm.interpolate_transform(
        tm.Transform(T(p0), T(q0), T(s0)), tm.Transform(T(p1), T(q1), T(s1)), T(t)
    )
    b = jm.interpolate_transform(
        jm.Transform(J(p0), J(q0), J(s0)), jm.Transform(J(p1), J(q1), J(s1)), J(t)
    )
    _close((a.p, a.q, a.s), (b.p, b.q, b.s))


@pytest.mark.parametrize(
    "name",
    ["uniform_sample_sphere", "uniform_sample_hemisphere", "uniform_sample_disc",
     "cosine_sample_hemisphere", "uniform_sample_triangle"],
)
def test_samplers(name):
    rng = _rng(3)
    u1, u2 = rng.random(N).astype(np.float32), rng.random(N).astype(np.float32)
    _close(getattr(tsamp, name)(T(u1), T(u2)), getattr(jsamp, name)(J(u1), J(u2)))


def test_lower_bound():
    rng = _rng(4)
    # three windows of a flat CDF table, like the padded mesh tri_cdf
    flat = np.concatenate(
        [np.cumsum(rng.random(16)) / s for s in (1.0, 1.0, 1.0)]
    ).astype(np.float32)
    flat[:16] /= flat[15]
    flat[16:32] /= flat[31]
    flat[32:] /= flat[47]
    lo = (rng.integers(0, 3, N) * 16).astype(np.int32)
    value = rng.random(N).astype(np.float32)
    value[:3] = [0.0, 1.0, 1.5]  # edges: first slot, last slot, past the end
    a = tsearch.lower_bound(T(flat), T(lo), 16, T(value))
    b = jsearch.lower_bound(J(flat), J(lo), 16, J(value))
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("tonemap", ["filmic", "reinhard"])
def test_resolve(tonemap):
    rng = _rng(5)
    acc = rng.gamma(1.0, 2.0, size=(9, 11, 4)).astype(np.float32)
    acc[0, 0, 3] = 0.0  # zero weight hits the 1e-7 floor
    a = tcolor.resolve(T(acc), exposure=1.3, limit=1.5, tonemap=tonemap)
    b = jcolor.resolve(J(acc), exposure=1.3, limit=1.5, tonemap=tonemap)
    _close(a, b)


def test_generator_and_numpy_sources():
    g1 = tsamp.PathUniforms(7, "cpu").uniform((0,), (5, 3))
    g2 = tsamp.PathUniforms(7, "cpu").uniform((9,), (5, 3))
    assert g1.dtype == torch.float32 and not torch.equal(g1, g2)  # the path counts
    assert torch.equal(tsamp.PathUniforms(7, "cpu").uniform((0,), (5, 3)), g1)
    src = tsamp.NumpyUniforms(3, "cpu")
    a = tsamp.Prefixed(tsamp.Prefixed(src, 1), 2).uniform((0,), (4,))
    assert torch.equal(a, src.uniform((1, 2, 0), (4,)))
    assert not torch.equal(a, src.uniform((1, 2, 1), (4,)))
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
