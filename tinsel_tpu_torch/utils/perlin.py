"""Perlin gradient noise in NumPy for host-side procedural content (the
port's own copy of ``perlin3d``, its 2D and 1D slices and ``fractal3d`` from
``tinsel_tpu/utils/perlin.py``, same permutation table)."""

from __future__ import annotations

import numpy as np

_P = np.random.default_rng(12345).permutation(256)
_PERM = np.concatenate([_P, _P]).astype(np.int32)


def _fade(t):
    return t * t * t * (t * (t * 6 - 15) + 10)


def _grad3(h, x, y, z):
    u = np.where(h < 8, x, y)
    v = np.where(h < 4, y, np.where((h == 12) | (h == 14), x, z))
    return np.where(h & 1, -u, u) + np.where(h & 2, -v, v)


def perlin3d(x, y, z, period: int | None = None):
    """3D Perlin noise in roughly [-1, 1]; broadcastable array inputs."""
    x, y, z = np.broadcast_arrays(
        np.asarray(x, np.float64), np.asarray(y, np.float64), np.asarray(z, np.float64)
    )
    xi = np.floor(x).astype(np.int64)
    yi = np.floor(y).astype(np.int64)
    zi = np.floor(z).astype(np.int64)
    xf, yf, zf = x - xi, y - yi, z - zi
    u, v, w = _fade(xf), _fade(yf), _fade(zf)

    def wrap(i):
        return (i % period if period else i) & 255

    def corner(dx, dy, dz):
        h = _PERM[_PERM[_PERM[wrap(xi + dx)] + wrap(yi + dy)] + wrap(zi + dz)] & 15
        return _grad3(h, xf - dx, yf - dy, zf - dz)

    def lerp(a, b, t):
        return a + t * (b - a)

    x00 = lerp(corner(0, 0, 0), corner(1, 0, 0), u)
    x10 = lerp(corner(0, 1, 0), corner(1, 1, 0), u)
    x01 = lerp(corner(0, 0, 1), corner(1, 0, 1), u)
    x11 = lerp(corner(0, 1, 1), corner(1, 1, 1), u)
    return lerp(lerp(x00, x10, v), lerp(x01, x11, v), w)


def perlin2d(x, y, period: int | None = None):
    return perlin3d(x, y, 0.5, period)


def perlin1d(x, period: int | None = None):
    return perlin3d(x, 0.5, 0.5, period)


def fractal3d(x, y, z, octaves: int = 3, persistence: float = 0.5,
              period: int | None = None):
    """fBm: octaves of doubling frequency and decaying amplitude."""
    out = 0.0
    amp = 1.0
    freq = 1.0
    total = 0.0
    for _ in range(octaves):
        out = out + amp * perlin3d(x * freq, y * freq, z * freq, period)
        total += amp
        amp *= persistence
        freq *= 2.0
    return out / total
