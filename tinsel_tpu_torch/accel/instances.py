"""The instance shortlist rounds as torch ops: the plain version of kernels
K6c (closest hit) and K6a (occlusion) in ``csrc/bvh.cu``, which
``ops/instances.py`` dispatches to (port of
``tinsel_tpu/render/trace.py:267 _instance_rounds`` and ``:330
_instance_rounds_any``).

Above ``render/trace.py::INSTANCE_TOPK_MIN`` big instances, a trace call
walks, per ray and round, only the ``INSTANCE_TOPK`` instances with the
nearest unvisited root-box entries, and repeats while some ray's next
unvisited entry still beats its best hit. Each round's walks go through
``ops/bvh.py`` (K3 / K4 on the card, the plain walks on the CPU), with
one host sync a round for the loop's test.
"""

from __future__ import annotations

import torch

from ..geometry.intersect import INF
from ..ops import bvh as ops_bvh

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
