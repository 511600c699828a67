"""Ray-primitive intersection, branchless and batched (port of
``tinsel_tpu/geometry/intersect.py``). Misses are hit=False with t=+inf."""

from __future__ import annotations

import torch

from ..core.math import cross, dot

INF = float("inf")


def _nonzero(x, eps=1e-30):
    return torch.where(torch.abs(x) > eps, x, torch.full_like(x, eps))


def intersect_ray_sphere(center, radius, origin, direction):
    """Numerically-stable quadratic sphere test. Returns (hit, t, normal).
    Rays starting inside hit the far root."""
    q = origin - center
    b = 2.0 * dot(q, direction)
    c = dot(q, q) - radius * radius
    disc = b * b - 4.0 * c  # a == 1 for normalized directions
    has_root = disc >= 0.0
    sqrt_disc = torch.sqrt(torch.clamp(disc, min=1e-12))
    sign_b = torch.where(b >= 0.0, 1.0, -1.0)
    tq = -0.5 * (b + sign_b * sqrt_disc)
    t0 = tq
    t1 = c / _nonzero(tq)
    tmin = torch.minimum(t0, t1)
    tmax = torch.maximum(t0, t1)
    t = torch.where(tmin < 0.0, tmax, tmin)
    hit = has_root & (t > 0.0)
    t_fin = torch.where(hit, t, torch.zeros_like(t))
    p = origin + direction * t_fin[..., None]
    normal = (p - center) / torch.clamp(radius, min=1e-30)[..., None]
    t = torch.where(hit, t, INF)
    return hit, t, normal


def intersect_ray_plane(plane, origin, direction):
    """Infinite plane a x + b y + c z + d = 0. Returns (hit, t, normal)."""
    n = plane[..., :3]
    d = dot(n, direction)
    num = -(dot(n, origin) + plane[..., 3])
    t = num / _nonzero(d)
    hit = (torch.abs(d) > 1e-30) & (t > 0.0)
    t = torch.where(hit, t, INF)
    return hit, t, torch.broadcast_to(n, t.shape + (3,))


def intersect_ray_tri(a, b, c, origin, direction):
    """Two-sided Moller-Trumbore. Returns (hit, t, u, v, w, n_geo), n_geo
    unnormalized and flipped to the side the ray arrives from."""
    ab = b - a
    ac = c - a
    n = cross(ab, ac)
    d = dot(-direction, n)
    ood = 1.0 / _nonzero(d)
    ap = origin - a
    t = dot(ap, n) * ood
    e = cross(-direction, ap)
    v = dot(ac, e) * ood
    w = -dot(ab, e) * ood
    u = 1.0 - v - w
    hit = (
        (torch.abs(d) > 1e-30)
        & (t > 0.0)
        & (v >= 0.0)
        & (v <= 1.0)
        & (w >= 0.0)
        & (v + w <= 1.0)
    )
    t = torch.where(hit, t, INF)
    n_signed = n * torch.where(d >= 0.0, 1.0, -1.0)[..., None]
    return hit, t, u, v, w, n_signed


def intersect_ray_aabb(lower, upper, origin, rcp_direction):
    """Slab test with precomputed reciprocal directions: (hit, t_near)."""
    l1 = (lower - origin) * rcp_direction
    l2 = (upper - origin) * rcp_direction
    lmin = torch.minimum(l1, l2).amax(dim=-1)
    lmax = torch.maximum(l1, l2).amin(dim=-1)
    hit = (lmax >= 0.0) & (lmax >= lmin)
    return hit, lmin


def triangle_area(a, b, c):
    return 0.5 * torch.sqrt(
        torch.clamp(torch.sum(cross(b - a, c - a) ** 2, dim=-1), min=0.0)
    )
