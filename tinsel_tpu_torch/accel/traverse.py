"""Mesh pool layout and the tiny-mesh brute sweep (port of the parts of
``tinsel_tpu/accel/traverse.py`` that the Cornell box uses).

Meshes of at most ``BLOCK_SIZE`` triangles never touch a BVH: every ray
tests every real triangle (``_intersect_mesh_brute``). The wide-BVH walks
(closest and any hit) are kernels of a later slice; asking for one raises.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry.intersect import INF

BLOCK_SIZE = 16  # triangles per leaf block (tinsel_tpu accel.build)


@dataclasses.dataclass(frozen=True)
class MeshPool:
    """All mesh triangles concatenated in block-padded order.

    tri_planes / nrm_planes: 9 x (Tp,) f32 component planes
    (v0x v0y v0z v1x ... v2z and n0x ... n2z); tri_cdf: (Tp,) per-mesh area
    CDF over the padded order (padding slots repeat the last value)."""

    tri_cdf: torch.Tensor
    tri_planes: tuple
    nrm_planes: tuple

    def gather_tri(self, idx):
        """Vertices of triangles idx (...,) -> three (..., 3) tensors."""
        p = self.tri_planes
        return tuple(
            torch.stack([p[3 * k][idx], p[3 * k + 1][idx], p[3 * k + 2][idx]], -1)
            for k in range(3)
        )

    def gather_normals(self, idx):
        """Vertex normals of triangles idx (...,) -> three (..., 3) tensors."""
        p = self.nrm_planes
        return tuple(
            torch.stack([p[3 * k][idx], p[3 * k + 1][idx], p[3 * k + 2][idx]], -1)
            for k in range(3)
        )


@dataclasses.dataclass(frozen=True)
class MeshHandle:
    """Static addressing of one mesh inside a MeshPool (the subset of the
    JAX handle that tiny meshes need: no node rows, no stack bound)."""

    node_offset: int
    tri_offset: int  # padded-order offset, multiple of BLOCK_SIZE
    num_tris: int  # padded count, multiple of BLOCK_SIZE
    real_tris: int  # unpadded triangle count
    area: float
    root_lower: tuple  # (3,) mesh-local root AABB
    root_upper: tuple


def _tri_hit(va, vb, vc, o, d, eps=1e-9):
    """Two-sided Moller-Trumbore, component-wise. va/vb/vc/o/d: 3-tuples of
    broadcast-compatible tensors. Returns (hit, t)."""
    abx = vb[0] - va[0]
    aby = vb[1] - va[1]
    abz = vb[2] - va[2]
    acx = vc[0] - va[0]
    acy = vc[1] - va[1]
    acz = vc[2] - va[2]
    # p = d x ac
    px = d[1] * acz - d[2] * acy
    py = d[2] * acx - d[0] * acz
    pz = d[0] * acy - d[1] * acx
    det = abx * px + aby * py + abz * pz
    ok = torch.abs(det) >= eps
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tx = o[0] - va[0]
    ty = o[1] - va[1]
    tz = o[2] - va[2]
    u = (tx * px + ty * py + tz * pz) * inv
    # q = t x ab
    qx = ty * abz - tz * aby
    qy = tz * abx - tx * abz
    qz = tx * aby - ty * abx
    v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv
    t = (acx * qx + acy * qy + acz * qz) * inv
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return hit, t


def _intersect_mesh_brute(pool: MeshPool, tri_offset: int, num_tris: int,
                          origins, dirs, tmax):
    """All-triangles masked sweep for tiny meshes, (T, R) broadcast.

    Returns (t, tri_local): t = +inf and tri_local = -1 on a miss; ties go
    to the lowest triangle id. The JAX version also refits (u, v, w, n) at
    the winner; no caller of this slice reads them, so the port stops at
    the search."""
    sl = slice(tri_offset, tri_offset + num_tris)
    p = pool.tri_planes
    va = tuple(p[i][sl][:, None] for i in range(3))  # (T, 1)
    vb = tuple(p[3 + i][sl][:, None] for i in range(3))
    vc = tuple(p[6 + i][sl][:, None] for i in range(3))
    o = tuple(c[None, :] for c in origins.unbind(-1))  # (1, R)
    d = tuple(c[None, :] for c in dirs.unbind(-1))
    hit, t = _tri_hit(va, vb, vc, o, d)  # (T, R)
    t = torch.where(hit & (t < tmax[None, :]), t, INF)
    t_min = t.min(dim=0).values
    found = torch.isfinite(t_min)
    tri_ids = torch.arange(num_tris, dtype=torch.int32, device=t.device)[:, None]
    big = torch.full_like(tri_ids, 2**30)
    win = torch.where(t == t_min[None, :], tri_ids, big).min(dim=0).values
    best_tri = torch.where(found, win, torch.full_like(win, -1))
    return t_min, best_tri


def intersect_mesh(pool: MeshPool, tri_offset: int, origins, dirs, tmax,
                   num_tris: int):
    """Closest hit against one tiny mesh: (t, tri_local)."""
    if num_tris > BLOCK_SIZE:
        raise NotImplementedError(
            "wide-BVH closest-hit walk (kernel K3) is ported in slice 3"
        )
    return _intersect_mesh_brute(pool, tri_offset, num_tris, origins, dirs, tmax)


def intersect_mesh_any(pool: MeshPool, tri_offset: int, origins, dirs, tmax,
                       num_tris: int):
    """Occlusion against one tiny mesh: (R,) bool, any hit with t < tmax."""
    if num_tris > BLOCK_SIZE:
        raise NotImplementedError(
            "wide-BVH any-hit walk (kernel K4) is ported in slice 3"
        )
    _, tri = _intersect_mesh_brute(pool, tri_offset, num_tris, origins, dirs, tmax)
    return tri >= 0
