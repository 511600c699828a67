"""Vector / quaternion / rigid-transform helpers on tensors with trailing
component axes: vectors ``(..., 3)``, quaternions ``(..., 4)`` as
(x, y, z, w), transforms ``p (..., 3) / q (..., 4) / s (...)``.

Port of ``tinsel_tpu/core/math.py`` (same formulas, same operation order)
for what the render path and the scene loaders use. The loaders call the
quaternion and 4x4 helpers on CPU f32 tensors and keep the result as numpy.
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


def vdot(a, b):
    """Dot product with a trailing singleton axis (broadcast helper)."""
    return torch.sum(a * b, dim=-1, keepdim=True)


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


def quat_identity(shape=()):
    q = torch.zeros(tuple(shape) + (4,), dtype=torch.float32)
    q[..., 3] = 1.0
    return q


def quat_conjugate(q):
    return q * q.new_tensor([-1.0, -1.0, -1.0, 1.0])


def quat_mul(a, b):
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


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


def quat_from_axis_angle(axis, angle):
    axis = normalize(torch.as_tensor(axis, dtype=torch.float32))
    half = 0.5 * torch.as_tensor(angle, dtype=torch.float32)
    s = torch.sin(half)
    return torch.cat([axis * s[..., None], torch.cos(half)[..., None]], dim=-1)


def quat_from_matrix3(m):
    """Quaternion from a 3x3 rotation matrix (..., 3, 3), rows first
    (m[i, j] = row i, column j): the four candidate constructions, the one
    with the largest pivot kept (the first on a tie), normalized."""
    m = torch.as_tensor(m, dtype=torch.float32)
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22

    def half_rsqrt(t):
        return 0.5 * torch.rsqrt(torch.clamp(t, min=1e-12))

    sw, sx, sy, sz = (half_rsqrt(t) for t in (tw, tx, ty, tz))
    cands = torch.stack([
        torch.stack([(m21 - m12) * sw, (m02 - m20) * sw, (m10 - m01) * sw, tw * sw], -1),
        torch.stack([tx * sx, (m01 + m10) * sx, (m02 + m20) * sx, (m21 - m12) * sx], -1),
        torch.stack([(m01 + m10) * sy, ty * sy, (m12 + m21) * sy, (m02 - m20) * sy], -1),
        torch.stack([(m02 + m20) * sz, (m12 + m21) * sz, tz * sz, (m10 - m01) * sz], -1),
    ], -2)  # (..., 4 candidates, 4)
    best = torch.argmax(torch.stack([tw, tx, ty, tz], -1), dim=-1)
    q = torch.take_along_dim(cands, best[..., None, None].expand(*best.shape, 1, 4), dim=-2)
    return quat_normalize(q[..., 0, :])


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


def transform_compose(a: Transform, b: Transform) -> Transform:
    """a after b: transform_point(compose(a, b), v) equals
    transform_point(a, transform_point(b, v)), uniform scale included."""
    return Transform(
        p=quat_rotate(a.q, b.p * a.s[..., None]) + a.p,
        q=quat_mul(a.q, b.q),
        s=a.s * b.s,
    )


def transform_inverse(t: Transform) -> Transform:
    qc = quat_conjugate(t.q)
    s_inv = 1.0 / t.s
    return Transform(p=-quat_rotate(qc, t.p) * s_inv[..., None], q=qc, s=s_inv)


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


# ------------------------------------------------- 4x4 matrices (host side)


def mat44_affine_inverse(m):
    """Inverse of an orthonormal affine matrix (rotation + translation)."""
    m = torch.as_tensor(m, dtype=torch.float32)
    rt = m[:3, :3].T
    out = torch.eye(4, dtype=torch.float32)
    out[:3, :3] = rt
    out[:3, 3] = -rt @ m[:3, 3]
    return out


def look_at_matrix(eye, target, up=(0.0, 1.0, 0.0)):
    """World-to-camera matrix, OpenGL convention (camera looks down -z)."""
    eye, target, up = (torch.as_tensor(x, dtype=torch.float32) for x in (eye, target, up))
    forward = -normalize(target - eye)  # camera z axis
    left = -normalize(cross(forward, up))  # camera x axis
    upv = -cross(left, forward)  # camera y axis
    cam_to_world = torch.eye(4, dtype=torch.float32)
    cam_to_world[:3, 0] = left
    cam_to_world[:3, 1] = upv
    cam_to_world[:3, 2] = forward
    cam_to_world[:3, 3] = eye
    return mat44_affine_inverse(cam_to_world)


def transform_point_mat44(m, v):
    """Apply a 4x4 matrix to points of shape (..., 3)."""
    vh = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    return torch.einsum("ij,...j->...i", m, vh)[..., :3]
