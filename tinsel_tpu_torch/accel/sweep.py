"""The sweep over spheres, planes and tiny meshes: the plain versions of
kernels K5c (closest hit) and K5a (occlusion), ``csrc/sweep.cu``.

Port of the discrete search in ``tinsel_tpu/render/trace.py``
(``trace_closest`` :388-424 and ``trace_any`` :576 on the sphere and plane
rows) and of ``tinsel_tpu/accel/traverse.py:981 _intersect_mesh_brute`` on
the tiny groups. Every ray tests, in the JAX order, each sphere, each
plane, then each tiny group (the mesh primitives of at most
``BLOCK_SIZE`` triangles, grouped by pool segment in ``mesh_partition``'s
order). A row or group replaces the ray's best hit only with a strictly
smaller t, so ties keep the earlier primitive; inside a group the lowest
instance and then the lowest triangle win a tie, an instance whose local
root box the ray misses (or enters at or beyond the best t) is culled,
and the winning triangle's t is taken again with ``intersect_ray_tri``'s
formula (``ray_tri``) and merged only if that t also beats the best.

Every test is written component by component (no ``torch.sum`` dot
product, no ``linalg.cross``), so each rounding happens at a fixed place
and the kernels, compiled with ``-fmad=false``, equal these functions bit
for bit. ``render/trace.py`` re-intersects the winner with the same
functions under autograd.

Motion: a sphere, or a tiny group's instance, takes the transform
interpolated at the ray's time (lerp p, nlerp q, lerp s) when some row of
its batch moves (all spheres are one batch; each tiny group is one),
else its start transform, as the JAX package's
``_prim_transforms_batched`` does.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..geometry.intersect import INF
from ..scene.model import MESH, PLANE, SPHERE
from .build import BLOCK_SIZE
from .traverse import MeshHandle, _tri_hit

ROW_BUDGET = 1 << 22  # elements of a (rows, rays) temporary of the plain versions


def mesh_partition(prim_static):
    """(tiny groups keyed by pool segment, big-mesh prims, spheres, planes)
    of a scene's ``prim_static``, in primitive order."""
    tiny_groups: dict = {}
    big, spheres, planes = [], [], []
    for i, ps in enumerate(prim_static):
        if ps.type == MESH:
            if ps.mesh.num_tris <= BLOCK_SIZE:
                k = (ps.mesh.node_offset, ps.mesh.tri_offset)
                tiny_groups.setdefault(k, []).append(i)
            else:
                big.append(i)
        elif ps.type == SPHERE:
            spheres.append(i)
        elif ps.type == PLANE:
            planes.append(i)
    return tiny_groups, big, spheres, planes


@dataclasses.dataclass(frozen=True)
class Group:
    """One tiny group: instances of one pool segment, swept together."""

    prims: tuple  # primitive ids, in merge order
    handle: MeshHandle
    tris: int  # triangles tested (the mesh's own, without padding)
    motion: bool  # some instance moves: every instance interpolates


@dataclasses.dataclass(frozen=True)
class Layout:
    spheres: tuple
    planes: tuple
    groups: tuple  # of Group, in merge order
    big: tuple  # big-mesh prims (the walks' batch, not swept)
    sphere_motion: bool
    batch_motion: tuple  # per prim: its batch interpolates its transform


@functools.lru_cache(maxsize=16)
def layout(prim_static: tuple) -> Layout:
    """The sweep's rows of a scene, from its (hashable) ``prim_static``."""
    tiny, big, spheres, planes = mesh_partition(prim_static)
    sphere_motion = any(prim_static[i].motion for i in spheres)
    groups = []
    flags = [False] * len(prim_static)
    for i in spheres:
        flags[i] = sphere_motion
    for idxs in tiny.values():
        h = prim_static[idxs[0]].mesh
        motion = any(prim_static[i].motion for i in idxs)
        groups.append(Group(tuple(idxs), h, h.real_tris or h.num_tris, motion))
        for i in idxs:
            flags[i] = motion
    return Layout(tuple(spheres), tuple(planes), tuple(groups), tuple(big), sphere_motion,
                  tuple(flags))


# ------------------------------------------ component-wise geometry (K5's)


def _dot3(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _nonzero(x, eps=1e-30):
    return torch.where(torch.abs(x) > eps, x, eps)


def lerp_transform(sp, sq, ss, ep, eq, es, t):
    """``core/math.py::interpolate_transform`` on components: p and s
    lerped, q nlerped (normalized with its squares summed x, y, z, w in
    order)."""
    p = tuple(a + (b - a) * t for a, b in zip(sp, ep))
    q = tuple(a + (b - a) * t for a, b in zip(sq, eq))
    n = torch.sqrt(torch.clamp(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3],
                               min=1e-30))
    return p, tuple(c / n for c in q), ss + (es - ss) * t


def inverse_rotate(q, v, s):
    """``quat_rotate(quat_conjugate(q), v) / s`` on components."""
    u = (-q[0], -q[1], -q[2])
    t = tuple(2.0 * c for c in _cross3(u, v))
    c = _cross3(u, t)
    return tuple(((v[k] + q[3] * t[k]) + c[k]) / s for k in range(3))


def local_ray(p, q, s, o, d):
    """The ray (o, d) in the frame of the transform (p, q, s)."""
    return inverse_rotate(q, tuple(o[k] - p[k] for k in range(3)), s), inverse_rotate(q, d, s)


def sphere_hit(c, rad, o, d):
    """``geometry/intersect.py::intersect_ray_sphere``'s (hit, t) on
    components: the numerically stable quadratic, the far root from
    inside, t = +inf on a miss."""
    q = tuple(o[k] - c[k] for k in range(3))
    b = 2.0 * _dot3(q, d)
    cc = _dot3(q, q) - rad * rad
    disc = b * b - 4.0 * cc
    sq = torch.sqrt(torch.clamp(disc, min=1e-12))
    tq = -0.5 * (b + torch.where(b >= 0.0, sq, -sq))
    t1 = cc / _nonzero(tq)
    t = torch.where(torch.minimum(tq, t1) < 0.0, torch.maximum(tq, t1), torch.minimum(tq, t1))
    hit = (disc >= 0.0) & (t > 0.0)
    return hit, torch.where(hit, t, INF)


def sphere_normal(c, rad, o, d, hit, t):
    """(..., 3) outward normal at the sphere hit (o + d t - c) / rad."""
    tf = torch.where(hit, t, 0.0)
    r = torch.clamp(rad, min=1e-30)
    return torch.stack([((o[k] + d[k] * tf) - c[k]) / r for k in range(3)], -1)


def plane_hit(pl, o, d):
    """``intersect_ray_plane``'s (hit, t) on components; pl = (a, b, c, dd)
    of a x + b y + c z + dd = 0."""
    n = pl[:3]
    dn = _dot3(n, d)
    t = -(_dot3(n, o) + pl[3]) / _nonzero(dn)
    hit = (torch.abs(dn) > 1e-30) & (t > 0.0)
    return hit, torch.where(hit, t, INF)


def ray_tri(a, b, c, o, d):
    """``intersect_ray_tri`` on components: (hit, t, u, v, w, n_geo), t =
    +inf on a miss, n_geo (3-tuple) unnormalized and flipped towards the
    side the ray arrives from."""
    ab = tuple(b[k] - a[k] for k in range(3))
    ac = tuple(c[k] - a[k] for k in range(3))
    n = _cross3(ab, ac)
    nd = tuple(-x for x in d)
    dn = _dot3(nd, n)
    ood = 1.0 / _nonzero(dn)
    ap = tuple(o[k] - a[k] for k in range(3))
    t = _dot3(ap, n) * ood
    e = _cross3(nd, ap)
    v = _dot3(ac, e) * ood
    w = -_dot3(ab, e) * ood
    u = (1.0 - v) - w
    hit = ((torch.abs(dn) > 1e-30) & (t > 0.0) & (v >= 0.0) & (v <= 1.0) & (w >= 0.0)
           & (v + w <= 1.0))
    sign = torch.where(dn >= 0.0, 1.0, -1.0)
    return hit, torch.where(hit, t, INF), u, v, w, tuple(x * sign for x in n)


def box_entry(lo, hi, o, d, tmax):
    """Local root-box slab test (``render/trace.py::_instance_box_entry``):
    (may hit, entry t). Zero direction components are nudged to +/-1e-30."""
    eps = 1e-30
    near, far = [], []
    for k in range(3):
        rd = 1.0 / torch.where(torch.abs(d[k]) < eps, torch.where(d[k] < 0, -eps, eps), d[k])
        t0 = (lo[k] - o[k]) * rd
        t1 = (hi[k] - o[k]) * rd
        near.append(torch.minimum(t0, t1))
        far.append(torch.maximum(t0, t1))
    tn = torch.clamp(torch.maximum(torch.maximum(near[0], near[1]), near[2]), min=0.0)
    tf = torch.minimum(torch.minimum(far[0], far[1]), far[2])
    return (tn <= tf) & (tn < tmax), tn


# ------------------------------------------------------------ row tables


def _rows(x, sel, cols):
    """Rows ``sel`` of the (P, ...) table x as ``cols`` (N, 1) columns."""
    x = x.detach()[sel]
    return tuple(x[:, k:k + 1] for k in range(cols)) if cols else x[:, None]


def _transforms(scene, sel, times, motion: bool):
    """Components of the (N, R) transforms (N, 1 when ``motion`` is False)
    of primitives ``sel`` at ray times (R,)."""
    pr = scene.prims
    sp, sq, ss = _rows(pr.start_p, sel, 3), _rows(pr.start_q, sel, 4), _rows(pr.start_s, sel, 0)
    if not motion:
        return sp, sq, ss
    ep, eq, es = _rows(pr.end_p, sel, 3), _rows(pr.end_q, sel, 4), _rows(pr.end_s, sel, 0)
    return lerp_transform(sp, sq, ss, ep, eq, es, times[None, :])


def _chunks(ids, per: int):
    per = max(1, per)
    return [ids[i:i + per] for i in range(0, len(ids), per)]


def _first_min(t):
    """(min over dim 0, lowest index attaining it) of an (N, R) tensor."""
    t_min = t.min(dim=0).values
    rows = torch.arange(t.shape[0], device=t.device)[:, None]
    idx = torch.where(t == t_min[None, :], rows, t.shape[0]).min(dim=0).values
    return t_min, torch.clamp(idx, max=t.shape[0] - 1)


def _sphere_rows(scene, sel, motion, o, d, times):
    p, _, s = _transforms(scene, sel, times, motion)
    return sphere_hit(p, _rows(scene.prims.radius, sel, 0) * s, o, d)


def _plane_rows(scene, sel, o, d):
    return plane_hit(_rows(scene.prims.plane, sel, 4), o, d)


def _instance_chunks(scene, g: Group, o, d, times, tmax):
    """Each chunk of a group's instances, in order: (first instance, local
    rays (I, R) components, root-box pass (I, R), triangle hits (T, I, R)
    with t < tmax where the box passes, their t)."""
    r = tmax.shape[0]
    lo = g.handle.tri_offset
    tris = tuple(c[lo:lo + g.tris][:, None, None] for c in scene.pool.tri_planes)
    per = max(1, ROW_BUDGET // max(r * g.tris, 1))
    for c0 in range(0, len(g.prims), per):
        rows = g.prims[c0:c0 + per]
        sel = torch.tensor(rows, dtype=torch.long, device=tmax.device)
        p, q, s = _transforms(scene, sel, times, g.motion)
        ol, dl = (tuple(torch.broadcast_to(x, (len(rows), r)) for x in v)
                  for v in local_ray(p, q, s, o, d))
        may, _ = box_entry(g.handle.root_lower, g.handle.root_upper, ol, dl, tmax[None, :])
        hit, t = _tri_hit(tris[0:3], tris[3:6], tris[6:9], tuple(x[None] for x in ol),
                          tuple(x[None] for x in dl))
        yield c0, ol, dl, may, hit & (t < torch.where(may, tmax[None, :], 0.0)[None]), t


def _add(stats, key, n):
    if stats is not None:
        stats[key] = stats.get(key, 0) + n


# ------------------------------------------------------------- closest hit


@torch.no_grad()
def sweep_closest(scene, origins, dirs, times, stats: dict | None = None):
    """Closest hit of each ray over the scene's spheres, planes and tiny
    meshes (plain version of kernel K5c). origins/dirs (R, 3), times (R,).
    Returns (t, prim, tri): t = +inf, prim = -1 and tri = -1 on a miss;
    prim the primitive's index; tri the winning triangle's index in the
    pool's padded order, or -1 for a sphere or plane. A tiny mesh's t is
    ``ray_tri``'s. ``stats``: a dict the sweep adds its tests to ("rays",
    "sphere_tests", "plane_tests", "instance_tests": a local ray and box
    test ("moving_instance_tests" where the transform is interpolated),
    "tri_tests": only where the box passes, "refits": one a group where a
    ray's candidate comes from)."""
    lay = layout(scene.prim_static)
    r = origins.shape[0]
    dev = origins.device
    o, d = origins.detach().unbind(-1), dirs.detach().unbind(-1)
    ob, db = tuple(x[None] for x in o), tuple(x[None] for x in d)
    times = times.detach()
    best_t = torch.full((r,), INF, device=dev)
    best_prim = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    _add(stats, "rays", r)

    def merge(t, ids):
        nonlocal best_t, best_prim, best_tri
        t = torch.where(torch.isfinite(t) & (t > 0.0), t, INF)
        t_min, row = _first_min(t)
        closer = t_min < best_t
        best_t = torch.where(closer, t_min, best_t)
        best_prim = torch.where(closer, ids[row], best_prim)
        best_tri = torch.where(closer, -1, best_tri)

    per = ROW_BUDGET // max(r, 1)
    for rows in _chunks(lay.spheres, per):
        sel = torch.tensor(rows, dtype=torch.long, device=dev)
        hit, t = _sphere_rows(scene, sel, lay.sphere_motion, ob, db, times)
        merge(torch.where(hit & (t > 0.0), t, INF), sel.to(torch.int32))
        _add(stats, "sphere_tests", len(rows) * r)
    for rows in _chunks(lay.planes, per):
        sel = torch.tensor(rows, dtype=torch.long, device=dev)
        hit, t = _plane_rows(scene, sel, ob, db)
        merge(torch.where(hit & (t > 0.0), t, INF), sel.to(torch.int32))
        _add(stats, "plane_tests", len(rows) * r)
    for g in lay.groups:
        best_t, best_prim, best_tri = _group_closest(scene, g, o, d, times, best_t, best_prim,
                                                     best_tri, stats)
    return best_t, best_prim, best_tri


def _group_closest(scene, g: Group, o, d, times, best_t, best_prim, best_tri, stats):
    """Merge one tiny group into the best hit (JAX: one brute-sweep batch,
    its winner re-intersected). Instances go in chunks; a chunk replaces
    the candidate only with a strictly smaller t, so the lowest instance
    wins a tie, as in one batch."""
    r = best_t.shape[0]
    dev = best_t.device
    bound = best_t
    cand_t = bound.clone()
    cand_inst = torch.zeros((r,), dtype=torch.long, device=dev)
    cand_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    ow = tuple(torch.zeros_like(bound) for _ in range(3))
    dw = tuple(torch.zeros_like(bound) for _ in range(3))
    tri_ids = torch.arange(g.tris, dtype=torch.int32, device=dev)[:, None, None]
    for c0, ol, dl, may, hit, t in _instance_chunks(scene, g, o, d, times, bound):
        t = torch.where(hit, t, INF)  # (T, I, R)
        t_i = t.min(dim=0).values  # (I, R)
        tri_i = torch.where(t == t_i[None], tri_ids, 2**30).min(dim=0).values
        tri_i = torch.where(torch.isfinite(t_i), tri_i, -1)
        t_c, inst_c = _first_min(t_i)
        closer = t_c < cand_t
        cand_t = torch.where(closer, t_c, cand_t)
        cand_inst = torch.where(closer, c0 + inst_c, cand_inst)
        pick = inst_c[None, :]
        cand_tri = torch.where(closer, tri_i.gather(0, pick)[0], cand_tri)
        ow = tuple(torch.where(closer, x.gather(0, pick)[0], w) for x, w in zip(ol, ow))
        dw = tuple(torch.where(closer, x.gather(0, pick)[0], w) for x, w in zip(dl, dw))
        if stats is not None:
            _add(stats, "moving_instance_tests" if g.motion else "instance_tests", may.numel())
            _add(stats, "tri_tests", int(may.sum()) * g.tris)
    found = torch.isfinite(cand_t) & (cand_t < bound)
    gt = g.handle.tri_offset + torch.clamp(cand_tri, min=0).long()
    v = [c[gt] for c in scene.pool.tri_planes]
    hit_re, t_re, *_ = ray_tri(v[0:3], v[3:6], v[6:9], ow, dw)
    t_new = torch.where(found & (cand_tri >= 0), t_re, INF)
    closer = found & (t_new > 0.0) & (t_new < best_t)
    if stats is not None:
        _add(stats, "refits", int(found.sum()))
    prim_ids = torch.tensor(g.prims, dtype=torch.int32, device=dev)
    return (torch.where(closer, t_new, best_t), torch.where(closer, prim_ids[cand_inst], best_prim),
            torch.where(closer, gt.to(torch.int32), best_tri))


# --------------------------------------------------------------- occlusion


@torch.no_grad()
def sweep_any(scene, origins, dirs, times, tmax, stats: dict | None = None):
    """Occlusion of each ray by a sphere, plane or tiny-mesh triangle with
    0 < t < tmax (plain version of kernel K5a): (R,) bool. ``stats``: as
    ``sweep_closest``'s, counting the tests of a sweep that stops at a
    ray's first occluding row (sphere, plane or triangle), as the kernel
    does."""
    lay = layout(scene.prim_static)
    r = origins.shape[0]
    dev = origins.device
    o, d = origins.detach().unbind(-1), dirs.detach().unbind(-1)
    ob, db = tuple(x[None] for x in o), tuple(x[None] for x in d)
    times = times.detach()
    tmax = torch.broadcast_to(torch.as_tensor(tmax, dtype=torch.float32, device=dev), (r,))
    occ = torch.zeros((r,), dtype=torch.bool, device=dev)
    _add(stats, "rays", r)

    def rows_hit(hit, key):
        """Fold (N, R) row hits into occ; count the rows a sweep that
        stops at its first hit tests."""
        nonlocal occ
        n = hit.shape[0]
        if stats is not None:
            first = torch.where(hit, torch.arange(n, device=dev)[:, None], n).min(dim=0).values
            _add(stats, key, int(torch.where(occ, 0, torch.clamp(first + 1, max=n)).sum()))
        occ = occ | hit.any(dim=0)

    per = ROW_BUDGET // max(r, 1)
    for rows in _chunks(lay.spheres, per):
        sel = torch.tensor(rows, dtype=torch.long, device=dev)
        hit, t = _sphere_rows(scene, sel, lay.sphere_motion, ob, db, times)
        rows_hit(hit & (t > 0.0) & (t < tmax[None, :]), "sphere_tests")
    for rows in _chunks(lay.planes, per):
        sel = torch.tensor(rows, dtype=torch.long, device=dev)
        hit, t = _plane_rows(scene, sel, ob, db)
        rows_hit(hit & (t > 0.0) & (t < tmax[None, :]), "plane_tests")
    for g in lay.groups:
        # an occluded ray's tmax 0 culls it in every later instance
        for _, _, _, may, hit, _ in _instance_chunks(scene, g, o, d, times,
                                                     torch.where(occ, 0.0, tmax)):
            if stats is not None:
                _count_group_any(stats, occ, may, hit, g.motion)
            occ = occ | hit.any(dim=0).any(dim=0)
    return occ


def _count_group_any(stats, occ, may, hit, motion: bool):
    """Tests of a sweep over a chunk of instances that stops at the first
    occluding triangle: every instance up to the first occluding one
    (local ray and box), and the triangles of those whose box passes, the
    occluding instance's only up to its first hit."""
    n_t, n_i = hit.shape[:2]
    dev = hit.device
    inst_hit = hit.any(dim=0)  # (I, R)
    rows = torch.arange(n_i, device=dev)[:, None]
    first_i = torch.where(inst_hit, rows, n_i).min(dim=0).values
    live = ~occ[None, :] & (rows <= first_i[None, :])  # (I, R) instances tested
    first_t = torch.where(hit, torch.arange(n_t, device=dev)[:, None, None], n_t).min(dim=0).values
    tris = torch.where(inst_hit, first_t + 1, n_t)
    _add(stats, "moving_instance_tests" if motion else "instance_tests", int(live.sum()))
    _add(stats, "tri_tests", int(torch.where(live & may, tris, 0).sum()))
