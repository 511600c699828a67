"""The instance shortlist rounds as torch ops: the plain version of kernels
K6c (closest hit) and K6a (occlusion) in ``csrc/bvh.cu``, which
``ops/instances.py`` dispatches to (port of
``tinsel_tpu/render/trace.py:267 _instance_rounds`` and ``:330
_instance_rounds_any``).

Above ``render/trace.py::INSTANCE_TOPK_MIN`` big instances, a trace call
walks, per ray and round, only the ``INSTANCE_TOPK`` instances with the
nearest unvisited root-box entries, and repeats while some ray's next
unvisited entry still beats its best hit. ``rounds_closest`` /
``rounds_any`` define a round over given (I, R) local rays and entries;
``rounds_closest_world`` / ``rounds_any_world`` build those from the world
rays with the kernels' component formulas (``world_inputs``) and call
them. Each round's walks go through ``ops/bvh.py`` (K3 / K4 on the card,
the plain walks on the CPU), with one host sync a round for the loop's
test.
"""

from __future__ import annotations

import torch

from ..geometry.intersect import INF
from ..ops import bvh as ops_bvh
from .sweep import box_entry, lerp_transform, local_ray

INSTANCE_TOPK = 4  # candidate instances walked per shortlist round


def shortlist_candidates(work, k: int):
    """The k nearest-entry instances per ray from the (I, R) entry table
    ``work`` (visited or missed entries +inf): ((k, R) ids, (k, R) entry
    distances, ``work`` with the picks set to +inf)."""
    rows = torch.arange(work.shape[0], device=work.device)[:, None]
    ids, tns = [], []
    for _ in range(k):
        j = torch.argmin(work, dim=0)
        tns.append(work.gather(0, j[None, :])[0])
        ids.append(j)
        work = torch.where(rows == j[None, :], INF, work)
    return torch.stack(ids), torch.stack(tns), work


def candidate_rays(o_l, d_l, ids):
    sel = ids[:, :, None].expand(*ids.shape, 3)
    k, r = ids.shape
    return o_l.gather(0, sel).reshape(k * r, 3), d_l.gather(0, sel).reshape(k * r, 3)


def rounds_closest(scene, o_l, d_l, tn, best_t0, noff, toff, stack_slots):
    """tn-ordered top-k instance rounds, closest hit (port of
    ``tinsel_tpu/render/trace.py:267``). o_l/d_l (I, R, 3) local rays, tn
    (I, R) box entry distances (+inf = culled). Returns (t, tri, inst)."""
    k = INSTANCE_TOPK
    r = o_l.shape[1]
    cand = torch.arange(k, device=o_l.device)[:, None]
    work, t_b = tn, best_t0
    tri_b = torch.full((r,), -1, dtype=torch.int32, device=o_l.device)
    inst_b = torch.zeros((r,), dtype=torch.long, device=o_l.device)
    while bool((work.min(dim=0).values < t_b).any()):
        ids, tns, work = shortlist_candidates(work, k)
        o_c, d_c = candidate_rays(o_l, d_l, ids)
        tm_c = torch.where(tns < t_b[None, :], t_b[None, :], 0.0)
        t_f, tri_f = ops_bvh.closest_hit(
            scene.pool, noff[ids].reshape(-1), toff[ids].reshape(-1), o_c, d_c,
            tm_c.reshape(-1), stack_slots,
        )
        t_i, tri_i = t_f.reshape(k, r), tri_f.reshape(k, r)
        t_min = t_i.min(dim=0).values
        closer = torch.isfinite(t_min) & (t_min < t_b)
        ci = torch.where(t_i == t_min[None, :], cand, k).min(dim=0).values
        oh_k = cand == torch.clamp(ci, max=k - 1)[None, :]
        inst_w = torch.where(oh_k, ids, 0).sum(dim=0)
        tri_w = torch.where(oh_k, tri_i, 0).sum(dim=0, dtype=torch.int32)
        t_b = torch.where(closer, t_min, t_b)
        tri_b = torch.where(closer, tri_w, tri_b)
        inst_b = torch.where(closer, inst_w, inst_b)
    return t_b, tri_b, inst_b


def rounds_any(scene, o_l, d_l, tn, tmax, occ, noff, toff, stack_slots):
    """The rounds, occlusion form (``tinsel_tpu/render/trace.py:330``).
    tmax (R,) is 0 where a ray is already occluded. Returns (R,) bool."""
    k = INSTANCE_TOPK
    r = o_l.shape[1]
    work = tn
    while bool((~occ & (work.min(dim=0).values < tmax)).any()):
        ids, tns, work = shortlist_candidates(work, k)
        o_c, d_c = candidate_rays(o_l, d_l, ids)
        tm_c = torch.where(~occ[None, :] & (tns < tmax[None, :]), tmax[None, :], 0.0)
        oc = ops_bvh.any_hit(
            scene.pool, noff[ids].reshape(-1), toff[ids].reshape(-1), o_c, d_c,
            tm_c.reshape(-1), stack_slots,
        )
        occ = occ | oc.reshape(k, r).any(dim=0)
    return occ


def world_inputs(scene, tab, origins, dirs, times, tmax):
    """The rounds' per-(instance, ray) inputs from world rays, with the
    formulas kernels K5 and K6 hold bit for bit (``accel/sweep.py``): each
    instance's transform at the ray's time where ``tab.motion``, else its
    start transform; the ray in its frame; its root-box entry, +inf where
    the box is missed or entered at or beyond tmax (R,). ``tab``: the
    batch's ``ops/instances.py::InstanceTable`` (its primitives, motion
    rule and root boxes); the transforms come from the scene. Returns the
    (I, R, 3) local origins and directions and the (I, R) entries."""
    pr = scene.prims

    def rows(x):  # (I, 1) columns of primitive rows
        x = x.detach()[tab.prim_ids]
        return tuple(x[:, k:k + 1] for k in range(x.shape[1])) if x.dim() == 2 else x[:, None]

    p, q, s = rows(pr.start_p), rows(pr.start_q), rows(pr.start_s)
    if tab.motion:
        p, q, s = lerp_transform(p, q, s, rows(pr.end_p), rows(pr.end_q), rows(pr.end_s),
                                 times[None, :])
    o_l, d_l = local_ray(p, q, s, tuple(c[None, :] for c in origins.unbind(-1)),
                         tuple(c[None, :] for c in dirs.unbind(-1)))
    lo, hi = tab.lower.unbind(-1), tab.upper.unbind(-1)
    may, tn = box_entry(tuple(c[:, None] for c in lo), tuple(c[:, None] for c in hi), o_l, d_l,
                        tmax[None, :])
    return torch.stack(o_l, -1), torch.stack(d_l, -1), torch.where(may, tn, INF)


def rounds_closest_world(scene, tab, origins, dirs, times, best_t0):
    """``rounds_closest`` on world rays (R, 3), times and best_t0 (R,):
    the plain version of kernel K6c. Returns (t, tri, inst)."""
    o_l, d_l, tn = world_inputs(scene, tab, origins, dirs, times, best_t0)
    return rounds_closest(scene, o_l, d_l, tn, best_t0, tab.noff, tab.toff, tab.slots)


def rounds_any_world(scene, tab, origins, dirs, times, tmax, occ):
    """``rounds_any`` on world rays: the plain version of kernel K6a. tmax
    (R,) is 0 where a ray is already occluded. Returns (R,) bool."""
    o_l, d_l, tn = world_inputs(scene, tab, origins, dirs, times, tmax)
    return rounds_any(scene, o_l, d_l, tn, tmax, occ, tab.noff, tab.toff, tab.slots)
