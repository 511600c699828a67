"""NLM denoiser of the port against tinsel_tpu.render.nlm (the reference
that tests/test_pallas.py pins the Pallas kernels to), and the gradients of
the port's autograd.Function against jax.grad. The CUDA kernels against
their plain versions on the card: tests/test_torch_nlm_cuda.py.

Tolerances: the plain versions repeat the JAX stencils operation by
operation, so 2e-6 (f32 rounding of a few exp / divide); gradients 2e-5
(reverse-mode sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinsel_tpu.render import nlm as jnlm
from tinsel_tpu_torch.ops import nlm as ops
from tinsel_tpu_torch.render import nlm as tnlm

torch.set_num_threads(1)


def _guides(rng, h, w):
    img = rng.random((h, w, 3)).astype(np.float32)
    normal = rng.normal(size=(h, w, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    albedo = rng.random((h, w, 3)).astype(np.float32)
    depth = (rng.random((h, w, 1)) * 7).astype(np.float32)
    return img, normal, albedo, depth


@pytest.mark.parametrize("radius", [1, 2])
def test_average_filter_matches_jax(radius):
    img = np.random.default_rng(0).random((37, 53, 3)).astype(np.float32)
    a = tnlm.average_filter(torch.from_numpy(img), radius).numpy()
    b = np.asarray(jnlm.average_filter(jnp.asarray(img), radius))
    np.testing.assert_allclose(a, b, atol=2e-6)


@pytest.mark.parametrize("radius", [1, 2])
def test_nlm_filter_matches_jax(radius):
    img = np.random.default_rng(0).random((37, 53, 3)).astype(np.float32)
    a = tnlm.nlm_filter(torch.from_numpy(img), radius=radius).numpy()
    b = np.asarray(jnlm.nlm_filter(jnp.asarray(img), radius=radius))
    np.testing.assert_allclose(a, b, atol=2e-6)


@pytest.mark.parametrize("falloff", [40.0, 200.0])
def test_nlm_guided_matches_jax(falloff):
    x = _guides(np.random.default_rng(3), 33, 49)
    a = tnlm.nlm_guided(*map(torch.from_numpy, x), falloff=falloff).numpy()
    b = np.asarray(jax.jit(jnlm.nlm_guided, static_argnames="falloff")(
        *map(jnp.asarray, x), falloff=falloff
    ))
    np.testing.assert_allclose(a, b, atol=2e-6)


def test_dispatchers_on_cpu_use_the_plain_versions():
    ops.reset_launch_counts()
    x = [torch.from_numpy(a) for a in _guides(np.random.default_rng(5), 16, 20)]
    assert torch.equal(ops.nlm_denoise(x[0]), tnlm.nlm_filter(x[0]))
    assert torch.equal(ops.nlm_guided_denoise(*x), tnlm.nlm_guided(*x))
    assert ops.launch_counts == {"nlm_filter": 0, "nlm_guided": 0}


def test_nlm_filter_gradients_match_jax():
    img = np.random.default_rng(1).random((24, 40, 3)).astype(np.float32)
    g_j = jax.jit(jax.grad(lambda z: jnp.sum(jnlm.nlm_filter(z) ** 2)))(
        jnp.asarray(img)
    )
    x = torch.from_numpy(img).requires_grad_(True)
    (ops.nlm_filter_cuda(x) ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_j), atol=2e-5)


def test_nlm_guided_gradients_match_jax():
    x = _guides(np.random.default_rng(4), 17, 24)

    def loss_j(*a):
        return jnp.sum(jnlm.nlm_guided(*a, falloff=40.0) ** 2)

    g_j = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2, 3)))(*map(jnp.asarray, x))
    xt = [torch.from_numpy(a).requires_grad_(True) for a in x]
    (ops.nlm_guided_cuda(*xt, falloff=40.0) ** 2).sum().backward()
    for t, j in zip(xt, g_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=2e-5)


def test_mixed_devices_raise():
    x = torch.zeros((4, 4, 3))
    with pytest.raises(ValueError, match="on the CPU or all on CUDA"):
        ops._on_cpu(x, torch.zeros((4, 4, 3), device="meta"))
