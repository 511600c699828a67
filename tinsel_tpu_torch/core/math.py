"""Vector / quaternion / rigid-transform helpers on tensors with trailing
component axes: vectors ``(..., 3)``, quaternions ``(..., 4)`` as
(x, y, z, w), transforms ``p (..., 3) / q (..., 4) / s (...)``.

Port of ``tinsel_tpu/core/math.py`` (same formulas, same operation order)
for what the Cornell forward path uses.
"""

from __future__ import annotations

import dataclasses
import math

import torch

PI = float(math.pi)
TWO_PI = 2.0 * PI
INV_PI = 1.0 / PI
INV_2PI = 0.5 / PI


def dot(a, b):
    """Dot product over the trailing axis, keeps batch shape."""
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def length_sq(a):
    return torch.sum(a * a, dim=-1)


def length(a):
    return torch.sqrt(length_sq(a))


def normalize(a):
    return a / torch.sqrt(torch.clamp(length_sq(a), min=1e-30))[..., None]


def safe_normalize(a, fallback=None):
    """Normalize; degenerate inputs return ``fallback`` (or zero)."""
    lsq = length_sq(a)
    ok = lsq > 1e-20
    inv = torch.rsqrt(torch.where(ok, lsq, torch.ones_like(lsq)))
    out = a * inv[..., None]
    if fallback is None:
        fallback = torch.zeros_like(a)
    return torch.where(ok[..., None], out, fallback)


def clamp_length(v, max_length):
    """Scale v down so |v| <= max_length (firefly clamp)."""
    l = length(v)
    scale = torch.where(
        l > max_length, max_length / torch.clamp(l, min=1e-30),
        torch.ones_like(l),
    )
    return v * scale[..., None]


def face_forward(n, v):
    """Flip n so it lies in the same hemisphere as v."""
    s = torch.where(dot(v, n) < 0.0, -1.0, 1.0)
    return n * s[..., None]


def lerp(a, b, t):
    return a + (b - a) * t


def sqr(x):
    return x * x


# ---------------------------------------------------------------- quaternions


def quat_conjugate(q):
    return q * q.new_tensor([-1.0, -1.0, -1.0, 1.0])


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q (q * v * q^-1), cross-form."""
    u = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * cross(u, v)
    return v + w * t + cross(u, t)


def quat_normalize(q):
    return q / torch.sqrt(
        torch.clamp(torch.sum(q * q, dim=-1, keepdim=True), min=1e-30)
    )


def quat_nlerp(a, b, t):
    """Normalized lerp of quaternions (motion-blur interpolation)."""
    return quat_normalize(a + (b - a) * t[..., None])


# ------------------------------------------------------- rigid transform


@dataclasses.dataclass(frozen=True)
class Transform:
    """Rigid transform with uniform scale. p (...,3), q (...,4), s (...,)."""

    p: torch.Tensor
    q: torch.Tensor
    s: torch.Tensor


def transform_point(t: Transform, v):
    return t.p + quat_rotate(t.q, v * t.s[..., None])


def transform_vector(t: Transform, v):
    return quat_rotate(t.q, v * t.s[..., None])


def inverse_transform_point(t: Transform, v):
    return quat_rotate(quat_conjugate(t.q), v - t.p) / t.s[..., None]


def inverse_transform_vector(t: Transform, v):
    return quat_rotate(quat_conjugate(t.q), v) / t.s[..., None]


def interpolate_transform(a: Transform, b: Transform, t) -> Transform:
    """Motion-blur transform interpolation: lerp p, nlerp q, lerp s."""
    return Transform(
        p=lerp(a.p, b.p, t[..., None]),
        q=quat_nlerp(a.q, b.q, t),
        s=lerp(a.s, b.s, t),
    )


# ------------------------------------------------------- orthonormal basis


def basis_from_vector(w):
    """Build (u, v) orthonormal to w (w is the 'z' axis). Branchless."""
    wx, wy, wz = w.unbind(-1)
    use_x = torch.abs(wx) > torch.abs(wy)
    inv_a = torch.rsqrt(torch.clamp(wx**2 + wz**2, min=1e-20))
    ua = torch.stack([-wz * inv_a, torch.zeros_like(inv_a), wx * inv_a], -1)
    inv_b = torch.rsqrt(torch.clamp(wy**2 + wz**2, min=1e-20))
    ub = torch.stack([torch.zeros_like(inv_b), wz * inv_b, -wy * inv_b], -1)
    u = torch.where(use_x[..., None], ua, ub)
    v = cross(w, u)
    return u, v
