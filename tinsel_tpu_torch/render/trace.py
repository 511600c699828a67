"""Scene-level closest-hit and shadow tracing (port of
``tinsel_tpu/render/trace.py`` for spheres, planes and tiny meshes).

Every ray tests every primitive with masks. Spheres and planes are batched
by type as (P, R) tests; mesh primitives whose triangles fit one 16-slot
block are grouped by pool segment and swept by ``_intersect_mesh_brute``
after a root-box cull. Rows merge in the JAX order (spheres, planes, tiny
groups) with a strict ``<``, so ties keep the earlier primitive, and the
final normal is face-forwarded against the ray. The search runs without
gradient; the winning triangle is re-intersected with grad enabled, as in
the JAX package. Meshes that need the BVH walk raise (slice 3).

These sweeps run as torch ops in this slice; whether they become the
fused scene-trace kernel K5 is decided by measurement (PERF.md).
"""

from __future__ import annotations

import dataclasses

import torch

from ..accel.traverse import BLOCK_SIZE, intersect_mesh, intersect_mesh_any
from ..core.math import (
    Transform,
    dot,
    face_forward,
    interpolate_transform,
    inverse_transform_point,
    inverse_transform_vector,
    quat_rotate,
    safe_normalize,
)
from ..geometry.intersect import (
    INF,
    intersect_ray_plane,
    intersect_ray_sphere,
    intersect_ray_tri,
)
from ..scene.model import MESH, PLANE, SPHERE, SceneFlat


@dataclasses.dataclass(frozen=True)
class Hit:
    t: torch.Tensor  # (R,) +inf on miss
    prim: torch.Tensor  # (R,) i32, -1 on miss
    normal: torch.Tensor  # (R, 3) shading normal, face-forwarded to -ray dir


def prim_transform(scene: SceneFlat, i: int, times):
    """Transform of primitive i at per-ray times (R,). A static primitive
    (start == end) returns its start transform unbatched, as the JAX
    package's STATIC_TRANSFORM_HOIST does."""
    pr = scene.prims
    start = Transform(p=pr.start_p[i], q=pr.start_q[i], s=pr.start_s[i])
    if not scene.prim_static[i].motion:
        return start
    end = Transform(p=pr.end_p[i], q=pr.end_q[i], s=pr.end_s[i])
    return interpolate_transform(start, end, times)


def _prim_transforms_batched(scene: SceneFlat, idxs, times):
    """(I, R)-batched transforms of primitives ``idxs`` ((I, 1) when all
    are static)."""
    pr = scene.prims
    sel = torch.as_tensor(idxs, dtype=torch.long, device=pr.start_p.device)
    start = Transform(
        p=pr.start_p[sel][:, None, :],
        q=pr.start_q[sel][:, None, :],
        s=pr.start_s[sel][:, None],
    )
    if not any(scene.prim_static[i].motion for i in idxs):
        return start
    end = Transform(
        p=pr.end_p[sel][:, None, :],
        q=pr.end_q[sel][:, None, :],
        s=pr.end_s[sel][:, None],
    )
    return interpolate_transform(start, end, times[None, :])


def _mesh_partition(scene: SceneFlat):
    """(tiny groups keyed by pool segment, spheres, planes)."""
    tiny_groups: dict = {}
    spheres, planes = [], []
    for i, ps in enumerate(scene.prim_static):
        if ps.type == MESH:
            if ps.mesh.num_tris > BLOCK_SIZE:
                raise NotImplementedError(
                    "big-mesh traversal (kernels K3/K4/K6) is ported in slice 3"
                )
            k = (ps.mesh.node_offset, ps.mesh.tri_offset)
            tiny_groups.setdefault(k, []).append(i)
        elif ps.type == SPHERE:
            spheres.append(i)
        elif ps.type == PLANE:
            planes.append(i)
    return tiny_groups, spheres, planes


def _instance_box_entry(handles, o_l, d_l, tmax_b):
    """Per-instance local-space root-AABB slab test. o_l/d_l: (I, R, 3).
    Returns ((I, R) 'may hit', (I, R) entry distance, +inf where missed).
    A flat mesh's zero-extent axis gives t0 == t1 there, so it is not
    culled."""
    dev = o_l.device
    lo = torch.tensor([h.root_lower for h in handles], dtype=torch.float32,
                      device=dev)[:, None, :]
    hi = torch.tensor([h.root_upper for h in handles], dtype=torch.float32,
                      device=dev)[:, None, :]
    # zero direction components nudged to +/-tiny: an on-bound origin gives
    # 0 * huge = 0, not 0 * inf = NaN
    eps = 1e-30
    tiny = torch.where(d_l < 0, -eps, eps)
    rd = 1.0 / torch.where(torch.abs(d_l) < eps, tiny, d_l)
    t0 = (lo - o_l) * rd
    t1 = (hi - o_l) * rd
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    tn = torch.clamp(tn, min=0.0)
    may = (tn <= tf) & (tn < tmax_b)
    return may, torch.where(may, tn, INF)


def _local_rays(scene, idxs, origins, dirs, times):
    tr_b = _prim_transforms_batched(scene, idxs, times)
    o_l = inverse_transform_point(tr_b, origins[None, :, :])
    d_l = inverse_transform_vector(tr_b, dirs[None, :, :])
    return tr_b, o_l, d_l


def trace_closest(scene: SceneFlat, origins, dirs, times) -> Hit:
    """Closest hit over all primitives. origins/dirs (R, 3), times (R,)."""
    r = origins.shape[0]
    dev = origins.device
    best_t = torch.full((r,), INF, device=dev)
    best_prim = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_n = torch.zeros((r, 3), dtype=torch.float32, device=dev)

    tiny_groups, spheres, planes = _mesh_partition(scene)

    def merge_rows(t_rows, n_rows, ids):
        nonlocal best_t, best_prim, best_n
        for row, pid in enumerate(ids):
            t_r = t_rows[row]
            closer = torch.isfinite(t_r) & (t_r > 0.0) & (t_r < best_t)
            best_t = torch.where(closer, t_r, best_t)
            best_prim = torch.where(closer, pid, best_prim)
            best_n = torch.where(closer[..., None], n_rows[row], best_n)

    if spheres:
        sel = torch.as_tensor(spheres, dtype=torch.long, device=dev)
        tr_b = _prim_transforms_batched(scene, spheres, times)  # (S, R)
        hit, t, n = intersect_ray_sphere(
            tr_b.p,
            scene.prims.radius[sel][:, None] * tr_b.s,
            origins[None, :, :],
            dirs[None, :, :],
        )
        merge_rows(torch.where(hit & (t > 0.0), t, INF), n, spheres)

    if planes:
        sel = torch.as_tensor(planes, dtype=torch.long, device=dev)
        hit, t, n = intersect_ray_plane(
            scene.prims.plane[sel][:, None, :], origins[None, :, :],
            dirs[None, :, :],
        )
        merge_rows(torch.where(hit & (t > 0.0), t, INF), n, planes)

    for idxs in tiny_groups.values():
        handles = [scene.prim_static[i].mesh for i in idxs]
        n_inst = len(idxs)
        tr_b, o_l, d_l = _local_rays(scene, idxs, origins, dirs, times)

        # the discrete search for the winning triangle runs without grad
        with torch.no_grad():
            tmax_b = torch.broadcast_to(best_t[None, :], (n_inst, r))
            may_hit, _ = _instance_box_entry(handles, o_l, d_l, tmax_b)
            tmax_i = torch.where(may_hit, tmax_b, 0.0)
            t_f, tri_f = intersect_mesh(
                scene.pool, handles[0].tri_offset,
                o_l.reshape(n_inst * r, 3), d_l.reshape(n_inst * r, 3),
                tmax_i.reshape(n_inst * r), num_tris=handles[0].real_tris,
            )
            # local t equals world t (uniform scale folds into |d_l|)
            t_i = t_f.reshape(n_inst, r)
            tri_i = tri_f.reshape(n_inst, r)
            inst_ids = torch.arange(n_inst, dtype=torch.int32, device=dev)[:, None]
            t_min = t_i.min(dim=0).values
            inst = torch.where(t_i == t_min[None, :], inst_ids, n_inst)
            inst = torch.clamp(inst.min(dim=0).values, max=n_inst - 1)
            tri = torch.where(inst_ids == inst[None, :], tri_i, -1).max(dim=0).values
            hit = torch.isfinite(t_min) & (t_min < best_t)

        # winning instance's local ray + rotation, then a differentiable
        # re-intersection at the found triangle
        onehot = (inst_ids == inst[None, :]).to(torch.float32)  # (I, R)
        ow = (onehot[..., None] * o_l).sum(dim=0)
        dw = (onehot[..., None] * d_l).sum(dim=0)
        qw = (onehot[..., None] * tr_b.q).sum(dim=0)

        toff = torch.tensor([h.tri_offset for h in handles], dtype=torch.long,
                            device=dev)
        gt = toff[inst.long()] + torch.clamp(tri, min=0).long()
        v0, v1, v2 = scene.pool.gather_tri(gt)
        n0, n1, n2 = scene.pool.gather_normals(gt)
        _, t, u, v, w, n_geo = intersect_ray_tri(v0, v1, v2, ow, dw)
        t = torch.where(hit & (tri >= 0), t, INF)
        ns = u[..., None] * n0 + v[..., None] * n1 + w[..., None] * n2
        # keep the smooth normal on the geometric side
        ns = ns * torch.where(dot(ns, n_geo) < 0.0, -1.0, 1.0)[..., None]
        n = safe_normalize(
            quat_rotate(qw, ns), fallback=safe_normalize(quat_rotate(qw, n_geo))
        )

        prim_ids = torch.tensor(idxs, dtype=torch.int32, device=dev)[inst.long()]
        closer = hit & (t > 0.0) & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best_prim = torch.where(closer, prim_ids, best_prim)
        best_n = torch.where(closer[..., None], n, best_n)

    best_n = face_forward(best_n, -dirs)
    return Hit(t=best_t, prim=best_prim, normal=best_n)


@torch.no_grad()
def trace_any(scene: SceneFlat, origins, dirs, times, tmax):
    """Occlusion query: any primitive hit with 0 < t < tmax. (R,) bool."""
    r = origins.shape[0]
    dev = origins.device
    occ = torch.zeros((r,), dtype=torch.bool, device=dev)
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=dev)

    tiny_groups, spheres, planes = _mesh_partition(scene)
    if spheres:
        sel = torch.as_tensor(spheres, dtype=torch.long, device=dev)
        tr_b = _prim_transforms_batched(scene, spheres, times)
        hit, t, _ = intersect_ray_sphere(
            tr_b.p,
            scene.prims.radius[sel][:, None] * tr_b.s,
            origins[None, :, :],
            dirs[None, :, :],
        )
        occ = occ | (hit & (t > 0.0) & (t < tmax[None, :])).any(dim=0)
    if planes:
        sel = torch.as_tensor(planes, dtype=torch.long, device=dev)
        hit, t, _ = intersect_ray_plane(
            scene.prims.plane[sel][:, None, :], origins[None, :, :],
            dirs[None, :, :],
        )
        occ = occ | (hit & (t > 0.0) & (t < tmax[None, :])).any(dim=0)

    for idxs in tiny_groups.values():
        handles = [scene.prim_static[i].mesh for i in idxs]
        n_inst = len(idxs)
        _, o_l, d_l = _local_rays(scene, idxs, origins, dirs, times)
        # already-occluded rays get tmax 0 -> no hit in any frame
        tmax_b = torch.broadcast_to(
            torch.where(occ, 0.0, tmax)[None, :], (n_inst, r)
        )
        may_hit, _ = _instance_box_entry(handles, o_l, d_l, tmax_b)
        tm = torch.where(may_hit, tmax_b, 0.0).reshape(n_inst * r)
        oc = intersect_mesh_any(
            scene.pool, handles[0].tri_offset,
            o_l.reshape(n_inst * r, 3), d_l.reshape(n_inst * r, 3), tm,
            num_tris=handles[0].real_tris,
        )
        occ = occ | oc.reshape(n_inst, r).any(dim=0)
    return occ
