"""The port's bump mapping against tinsel_tpu's: the lattice hash bit for
bit, the noise and the bumped normal to the tolerances below, and lanes of
strength 0 untouched."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tinsel_tpu.render import bump as jbump
from tinsel_tpu_torch.render import bump as tbump

torch.set_num_threads(1)


def test_hash_is_bit_exact():
    """The uint32 mix in int64 keeps the JAX bits over the whole int32
    range, negative coordinates included."""
    rng = np.random.default_rng(0)
    ix, iy = (rng.integers(-2**31, 2**31, 50000).astype(np.int32) for _ in range(2))
    iz = rng.integers(-1000, 1000, 50000).astype(np.int32)
    ix[:4] = [-2**31, 2**31 - 1, -1, 0]
    want = np.asarray(jbump._hash3(*map(jnp.asarray, (ix, iy, iz)))).astype(np.int64)
    got = tbump._hash3(*map(torch.from_numpy, (ix, iy, iz))).numpy()
    np.testing.assert_array_equal(got, want)


def test_noise_matches_jax():
    """Gradient noise and its fBm: the same f32 formulas; XLA rounds the
    fade polynomial in another order and coordinates up to ~80 keep ~5e-6
    of their fractional part, hence 5e-6."""
    rng = np.random.default_rng(1)
    x, y, z = (rng.normal(size=20000).astype(np.float32) * 20 for _ in range(3))
    for jf, tf in ((jbump.gradient_noise3, tbump.gradient_noise3),
                   (jbump.fractal_noise3, tbump.fractal_noise3)):
        want = np.asarray(jax.jit(jf)(*map(jnp.asarray, (x, y, z))))
        got = tf(*map(torch.from_numpy, (x, y, z))).numpy()
        np.testing.assert_allclose(got, want, atol=5e-6)
        assert 0.1 < np.abs(want).mean() < 1.0


def test_bump_normal_matches_jax_and_leaves_flat_lanes_alone():
    """bump_normal against JAX to 1e-3: the height field's forward
    differences over 1e-3 scale its last-bit noise by 1e3 (measured up to
    3.6e-4). Lanes of strength 0 return the input normal bit for bit."""
    rng = np.random.default_rng(2)
    n = rng.normal(size=(4096, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    p = (rng.normal(size=(4096, 3)) * 3).astype(np.float32)
    strength = np.where(rng.random(4096) < 0.3, 0.0, rng.uniform(0.05, 1.0, 4096)).astype(np.float32)
    tile = rng.uniform(0.5, 10.0, 4096).astype(np.float32)
    want = np.asarray(jax.jit(jbump.bump_normal)(*map(jnp.asarray, (n, p, strength, tile))))
    got = tbump.bump_normal(*map(torch.from_numpy, (n, p, strength, tile))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)
    flat = strength == 0
    np.testing.assert_array_equal(got[flat], n[flat])
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    assert np.abs(got[~flat] - n[~flat]).max() > 0.05  # the bump moves normals
