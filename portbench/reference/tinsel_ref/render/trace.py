"""Scene-level closest-hit and shadow tracing, plain (the port's
``render/trace.py`` with its kernels' plain versions).

Two searches, each without gradient:

* spheres, planes and the tiny meshes (at most 16 triangles, grouped by
  pool segment) are swept by ``accel/sweep.py`` (the port's K5c / K5a),
  one call each;
* every other mesh primitive joins ONE batch of (instance, ray) lanes with
  per-lane sub-BVH offsets, walked by ``accel/traverse.py`` (the port's
  K3 / K4) after a root-box cull, with the sweep's t as its bound (the
  local rays and box entries by ``accel/instances.py::world_inputs``). The
  reference covers at most ``INSTANCE_TOPK_MIN`` big instances: above
  that the port walks shortlist rounds (K6c / K6a), which no cell runs.

Hits merge in the JAX order (spheres, planes, tiny groups, the big batch)
with a strict ``<``, so ties keep the earlier primitive. Each search's
winner is then intersected again with grad enabled (``_refit`` for the
sweep's, with its formulas, so t keeps its bits; the big batch's
triangle with the walk's formula, ``accel/traverse.py::tri_refit``, in the
winner's frame taken from its transform rows with the search's formulas,
so a ray through a seam keeps the hit that the walk found). The final
normal is face-forwarded against the ray.

``MESH_VERTEX_GRADS`` and ``STATIC_TRANSFORM_HOIST`` keep the port's
defaults.
"""

from __future__ import annotations

import dataclasses

import torch

from ..accel import instances as plain_instances
from ..accel import sweep as plain_sweep
from ..accel import traverse as plain_walk
from ..accel.sweep import (
    layout,
    lerp_transform,
    local_ray,
    plane_hit,
    ray_tri,
    sphere_hit,
    sphere_normal,
)
from ..accel.traverse import tri_refit
from ..core.math import (
    Transform,
    dot,
    face_forward,
    interpolate_transform,
    quat_rotate,
    safe_normalize,
)
from ..geometry.intersect import INF
from ..scene.model import MESH, PLANE, SPHERE, SceneFlat, _GatherRows

INSTANCE_TOPK_MIN = 12  # the port walks shortlist rounds above this instance count
MESH_VERTEX_GRADS = False  # gradients into the pool's vertex and normal
# planes (its gathers' backward is a scatter-add, MeshPool); off, every
# read of the planes on a differentiated path is detached
STATIC_TRANSFORM_HOIST = True  # a static primitive (start == end) takes
# its start transform; off, every primitive interpolates at the ray's
# time, so end_p/q/s get their (1 - t) / t share of the gradient


@dataclasses.dataclass(frozen=True)
class Hit:
    t: torch.Tensor  # (R,) +inf on miss
    prim: torch.Tensor  # (R,) i32, -1 on miss
    normal: torch.Tensor  # (R, 3) shading normal, face-forwarded to -ray dir


def prim_transform(scene: SceneFlat, i: int, times):
    """Transform of primitive i at per-ray times (R,). Under
    ``STATIC_TRANSFORM_HOIST`` a static primitive (start == end) returns
    its start transform unbatched."""
    pr = scene.prims
    start = Transform(p=pr.start_p[i], q=pr.start_q[i], s=pr.start_s[i])
    if STATIC_TRANSFORM_HOIST and not scene.prim_static[i].motion:
        return start
    end = Transform(p=pr.end_p[i], q=pr.end_q[i], s=pr.end_s[i])
    return interpolate_transform(start, end, times)


def _rays(origins, dirs, times):
    """The rays as the searches take them: detached, contiguous, one time
    a ray."""
    r = origins.shape[0]
    times = torch.broadcast_to(torch.as_tensor(times, dtype=torch.float32,
                                               device=origins.device), (r,))
    return origins.detach().contiguous(), dirs.detach().contiguous(), times.detach().contiguous()


def _batch(scene, dev):
    tab = plain_instances.batch(scene, dev, STATIC_TRANSFORM_HOIST)
    if len(tab.prims) > INSTANCE_TOPK_MIN:
        raise NotImplementedError(f"{len(tab.prims)} big instances: the reference covers "
                                  f"at most {INSTANCE_TOPK_MIN}")
    return tab


def _vertices(pool, gt):
    """Vertices and vertex normals of triangles ``gt``, detached unless
    ``MESH_VERTEX_GRADS``."""
    rows = pool.gather_tri(gt) + pool.gather_normals(gt)
    return rows if MESH_VERTEX_GRADS else tuple(x.detach() for x in rows)


def _refit(scene: SceneFlat, lay, origins, dirs, times, prim, tri):
    """(t, normal) of each ray's sweep winner, taken again under autograd
    with the sweep's own formulas (``accel/sweep.py``), so t equals the
    sweep's bit for bit: the winning sphere at the ray's time, the winning
    plane, or the winning tiny-mesh triangle in its instance's frame
    (vertices and normals detached unless ``MESH_VERTEX_GRADS``). A miss
    gives (+inf, 0). The rows come
    from ``_GatherRows``, whose backward is a one-hot matmul, so gradient
    reaches only the winning row, as the JAX package's where-merge passes
    it."""
    r = origins.shape[0]
    dev = origins.device
    found = prim >= 0
    idx = torch.clamp(prim, min=0).long()
    kind = scene.prim_type[idx]
    pr = scene.prims
    motion = any(lay.batch_motion)
    # one gather of the rows the refit reads, side by side: start p, q, s,
    # radius, plane (then end p, q, s where some batch moves)
    cols = [pr.start_p, pr.start_q, pr.start_s[:, None], pr.radius[:, None], pr.plane]
    if motion:
        cols += [pr.end_p, pr.end_q, pr.end_s[:, None]]
    (rows,) = _GatherRows.apply(idx, torch.cat(cols, dim=1))
    c = rows.unbind(-1)
    p, q, s, rad, pl = c[0:3], c[3:7], c[7], c[8], c[9:13]
    if motion:  # the batch's transforms are interpolated
        moving = torch.tensor(lay.batch_motion, device=dev)[idx]
        p2, q2, s2 = lerp_transform(p, q, s, c[13:16], c[16:20], c[20], times)
        p = tuple(torch.where(moving, a, b) for a, b in zip(p2, p))
        q = tuple(torch.where(moving, a, b) for a, b in zip(q2, q))
        s = torch.where(moving, s2, s)
    o, d = origins.unbind(-1), dirs.unbind(-1)
    t = torch.full((r,), INF, device=dev)
    n = torch.zeros((r, 3), device=dev)
    if lay.spheres:
        hit, t_s = sphere_hit(p, rad * s, o, d)
        is_s = kind == SPHERE
        t = torch.where(is_s, t_s, t)
        n = torch.where(is_s[:, None], sphere_normal(p, rad * s, o, d, hit, t_s), n)
    if lay.planes:
        _, t_p = plane_hit(pl, o, d)
        is_p = kind == PLANE
        t = torch.where(is_p, t_p, t)
        n = torch.where(is_p[:, None], torch.stack(pl[:3], -1), n)
    if lay.groups:
        ow, dw = local_ray(p, q, s, o, d)
        gt = torch.clamp(tri, min=0).long()
        v0, v1, v2, n0, n1, n2 = _vertices(scene.pool, gt)
        _, t_m, u, v, w, n_geo = ray_tri(v0.unbind(-1), v1.unbind(-1), v2.unbind(-1), ow, dw)
        n_geo = torch.stack(n_geo, -1)
        ns = u[..., None] * n0 + v[..., None] * n1 + w[..., None] * n2
        # keep the smooth normal on the geometric side
        ns = ns * torch.where(dot(ns, n_geo) < 0.0, -1.0, 1.0)[..., None]
        qw = torch.stack(q, -1)
        n_m = safe_normalize(quat_rotate(qw, ns), fallback=safe_normalize(quat_rotate(qw, n_geo)))
        is_m = (kind == MESH) & (tri >= 0)
        t = torch.where(is_m, t_m, t)
        n = torch.where(is_m[:, None], n_m, n)
    return torch.where(found, t, INF), torch.where(found[:, None], n, 0.0)


@dataclasses.dataclass(frozen=True)
class BigHits:
    """The big-mesh batch's result against the best hit so far (R,) each:
    ``hit``, the walk found a triangle under the best t; ``closer``, its
    re-intersection (``t``) is > 0 and under the best t too, so it
    replaces the best hit. Lanes with ``hit & ~closer`` are the walk's hits
    that the refit drops (a ray through a seam of two triangles)."""

    hit: torch.Tensor
    closer: torch.Tensor
    t: torch.Tensor
    prim: torch.Tensor
    normal: torch.Tensor


def _big_closest(scene: SceneFlat, lay, origins, dirs, times, best_t) -> BigHits:
    """Every big-mesh primitive as ONE batch of (instance, ray) lanes walked
    by the plain closest-hit walk with ``best_t`` as the bound, then the winning triangle intersected again under autograd
    with the walk's own formula (``tri_refit``) in the winner's frame, taken
    from its transform rows with the search's formulas, so its t is the
    walk's bit for bit. The JAX package takes ``intersect_ray_tri`` there,
    which at a seam can miss a triangle that the walk hit, and drops that
    ray."""
    r = origins.shape[0]
    dev = origins.device
    tab = _batch(scene, dev)
    n_inst = len(tab.prims)

    # the discrete search for the winning triangle runs without grad
    with torch.no_grad():
        o, d, tm = _rays(origins, dirs, times)
        o_l, d_l, tn = plain_instances.world_inputs(scene, tab, o, d, tm, best_t)
        tmax_i = torch.where(torch.isfinite(tn), best_t[None, :], 0.0).reshape(n_inst * r)
        t_f, tri_f = plain_walk.intersect_mesh(
            scene.pool, tab.noff.repeat_interleave(r), tab.toff.repeat_interleave(r),
            o_l.reshape(n_inst * r, 3), d_l.reshape(n_inst * r, 3), tmax_i,
            stack_slots=tab.slots,
        )
        del o_l, d_l, tn
        # local t equals world t (uniform scale folds into |d_l|)
        t_i = t_f.reshape(n_inst, r)
        tri_i = tri_f.reshape(n_inst, r)
        t_min = t_i.min(dim=0).values
        inst_ids = torch.arange(n_inst, dtype=torch.long, device=dev)[:, None]
        inst = torch.where(t_i == t_min[None, :], inst_ids, n_inst)
        inst = torch.clamp(inst.min(dim=0).values, max=n_inst - 1)
        tri = torch.where(inst_ids == inst[None, :], tri_i, -1).max(dim=0).values
        hit = torch.isfinite(t_min) & (t_min < best_t)

    # the winner's transform rows (gradient to the winning row only: the
    # gather's backward is a one-hot matmul) and the ray in its frame,
    # then a differentiable re-intersection at the found triangle
    pr = scene.prims
    prim_ids = tab.prim_ids[inst]
    cols = [pr.start_p, pr.start_q, pr.start_s[:, None]]
    if tab.motion:
        cols += [pr.end_p, pr.end_q, pr.end_s[:, None]]
    (rows,) = _GatherRows.apply(prim_ids, torch.cat(cols, dim=1))
    c = rows.unbind(-1)
    p, q, s = c[0:3], c[3:7], c[7]
    if tab.motion:  # every instance of the batch is interpolated
        p, q, s = lerp_transform(p, q, s, c[8:11], c[11:15], c[15], times)
    ow, dw = local_ray(p, q, s, origins.unbind(-1), dirs.unbind(-1))
    qw = torch.stack(q, -1)

    gt = tab.toff.long()[inst] + torch.clamp(tri, min=0).long()
    v0, v1, v2, n0, n1, n2 = _vertices(scene.pool, gt)
    # the walk's own formula, so t is the walk's bit for bit and a hit at
    # a seam of two triangles is kept
    _, t, u, v, w, n_geo = tri_refit(v0.unbind(-1), v1.unbind(-1), v2.unbind(-1), ow, dw)
    n_geo = torch.stack(n_geo, -1)
    t = torch.where(hit & (tri >= 0), t, INF)
    ns = u[..., None] * n0 + v[..., None] * n1 + w[..., None] * n2
    # keep the smooth normal on the geometric side
    ns = ns * torch.where(dot(ns, n_geo) < 0.0, -1.0, 1.0)[..., None]
    n = safe_normalize(
        quat_rotate(qw, ns), fallback=safe_normalize(quat_rotate(qw, n_geo))
    )
    closer = hit & (t > 0.0) & (t < best_t)
    return BigHits(hit=hit, closer=closer, t=t, prim=prim_ids.to(torch.int32), normal=n)


def trace_closest(scene: SceneFlat, origins, dirs, times) -> Hit:
    """Closest hit over all primitives. origins/dirs (R, 3), times (R,)."""
    hoist = STATIC_TRANSFORM_HOIST
    lay = layout(scene.prim_static, hoist)
    # the discrete search, then the winner again under autograd
    _, best_prim, tri = plain_sweep.sweep_closest(scene, *_rays(origins, dirs, times),
                                                  hoist=hoist)
    best_t, best_n = _refit(scene, lay, origins, dirs, times, best_prim, tri)

    if lay.big:
        big = _big_closest(scene, lay, origins, dirs, times, best_t)
        best_t = torch.where(big.closer, big.t, best_t)
        best_prim = torch.where(big.closer, big.prim, best_prim)
        best_n = torch.where(big.closer[..., None], big.normal, best_n)

    best_n = face_forward(best_n, -dirs)
    return Hit(t=best_t, prim=best_prim, normal=best_n)


@torch.no_grad()
def trace_any(scene: SceneFlat, origins, dirs, times, tmax):
    """Occlusion query: any primitive hit with 0 < t < tmax. (R,) bool."""
    r = origins.shape[0]
    dev = origins.device
    tmax = torch.broadcast_to(torch.as_tensor(tmax, dtype=torch.float32, device=dev), (r,))
    # spheres, planes and tiny meshes
    hoist = STATIC_TRANSFORM_HOIST
    o, d, tm = _rays(origins, dirs, times)
    tmax = tmax.contiguous()
    occ = plain_sweep.sweep_any(scene, o, d, tm, tmax, hoist=hoist)

    if layout(scene.prim_static, hoist).big:
        tab = _batch(scene, dev)
        n_inst = len(tab.prims)
        # already-occluded rays get tmax 0 -> no hit in any frame
        tmax_r = torch.where(occ, 0.0, tmax)
        o_l, d_l, tn = plain_instances.world_inputs(scene, tab, o, d, tm, tmax_r)
        tm_i = torch.where(torch.isfinite(tn), tmax_r[None, :], 0.0).reshape(n_inst * r)
        oc = plain_walk.intersect_mesh_any(
            scene.pool, tab.noff.repeat_interleave(r), tab.toff.repeat_interleave(r),
            o_l.reshape(n_inst * r, 3), d_l.reshape(n_inst * r, 3), tm_i, stack_slots=tab.slots,
        )
        occ = occ | oc.reshape(n_inst, r).any(dim=0)
    return occ
