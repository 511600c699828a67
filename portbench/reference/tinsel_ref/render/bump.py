"""Procedural Perlin bump mapping (port of ``tinsel_tpu/render/bump.py``).

Fractal gradient noise is evaluated at the shading point: a multiplicative
integer lattice hash, Perlin's smoothstep and 12-gradient set. The hash is
uint32 arithmetic in the JAX package; torch has no full uint32 arithmetic,
so here it runs in int64 kept to the low 32 bits, each 32 x 32-bit product
split into two 32 x 16-bit halves so that nothing overflows; the bits are
the JAX package's. The height field is sampled at ``tile * p``, tangents
are displaced along the normal by forward differences, and the bumped
normal is their cross product.
"""

from __future__ import annotations

import torch

from ..core.math import basis_from_vector, cross, normalize

_EPS = 1e-3  # forward-difference step in world units
_M32 = 0xFFFFFFFF


def _mul32(a, b: int):
    """(a * b) mod 2^32 for int64 a in [0, 2^32) and a 32-bit constant b."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash3(ix, iy, iz):
    """3D lattice hash of int32 lattice coordinates -> [0, 2^32) as int64
    (the JAX package's uint32 mix, bit for bit)."""

    def u32(i):
        return i.to(torch.int64) & _M32

    h = (_mul32(u32(ix), 0x9E3779B1) + _mul32(u32(iy), 0x85EBCA77)
         + _mul32(u32(iz), 0xC2B2AE3D)) & _M32
    h = h ^ (h >> 15)
    h = _mul32(h, 0x2C1B3C6D)
    return h ^ (h >> 12)


def _grad3(h, x, y, z):
    """Perlin's 12-gradient dot product, branchless (h: low 4 hash bits)."""
    h = h & 15
    u = torch.where(h < 8, x, y)
    v = torch.where(h < 4, y, torch.where((h == 12) | (h == 14), x, z))
    return torch.where((h & 1) != 0, -u, u) + torch.where((h & 2) != 0, -v, v)


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def gradient_noise3(x, y, z):
    """Hash-lattice gradient noise in roughly [-1, 1]."""
    xi = torch.floor(x)
    yi = torch.floor(y)
    zi = torch.floor(z)
    xf, yf, zf = x - xi, y - yi, z - zi
    xi, yi, zi = (c.to(torch.int32) for c in (xi, yi, zi))
    u, v, w = _fade(xf), _fade(yf), _fade(zf)

    def corner(dx, dy, dz):
        h = _hash3(xi + dx, yi + dy, zi + dz)
        return _grad3(h, xf - dx, yf - dy, zf - dz)

    def lerp(a, b, t):
        return a + t * (b - a)

    x00 = lerp(corner(0, 0, 0), corner(1, 0, 0), u)
    x10 = lerp(corner(0, 1, 0), corner(1, 1, 0), u)
    x01 = lerp(corner(0, 0, 1), corner(1, 0, 1), u)
    x11 = lerp(corner(0, 1, 1), corner(1, 1, 1), u)
    return lerp(lerp(x00, x10, v), lerp(x01, x11, v), w)


def fractal_noise3(x, y, z, octaves: int = 3, persistence: float = 0.5):
    """fBm over gradient_noise3."""
    out = 0.0
    amp = 1.0
    freq = 1.0
    total = 0.0
    for _ in range(octaves):
        out = out + amp * gradient_noise3(x * freq, y * freq, z * freq)
        total += amp
        amp *= persistence
        freq *= 2.0
    return out / total


def bump_normal(n, p, strength, tile):
    """Perturb shading normals by the procedural height field.

    n: (R, 3) unit normals; p: (R, 3) hit points; strength/tile: (R,)
    per-lane material values. Lanes with strength 0 return n exactly."""
    u_ax, v_ax = basis_from_vector(n)

    def h(q):
        x = q * tile[..., None]
        return fractal_noise3(x[..., 0], x[..., 1], x[..., 2])

    h0 = h(p)
    du = (h(p + u_ax * _EPS) - h0) / _EPS
    dv = (h(p + v_ax * _EPS) - h0) / _EPS
    dpdu = u_ax + (strength * du)[..., None] * n
    dpdv = v_ax + (strength * dv)[..., None] * n
    nb = normalize(cross(dpdu, dpdv))
    return torch.where((strength > 0.0)[..., None], nb, n)
