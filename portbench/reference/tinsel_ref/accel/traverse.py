"""Mesh pool layout, the tiny-mesh brute sweep, and the plain versions of
the two wide-BVH walks (port of ``tinsel_tpu/accel/traverse.py``).

``intersect_mesh`` (closest hit) and ``intersect_mesh_any`` (any hit with
t < tmax) walk the 16-ary node rows of ``accel/build.py`` as lockstep
torch ops over every lane, one step at a time, with one host ``any()`` a
step, following ``_step`` (``tinsel_tpu/accel/traverse.py:390-489``) and
``_traverse_tile_any`` (``:811``):

* a lane dwells at a node while it tests, in slot order, each hit leaf
  child's 16-triangle block (two-sided Moller-Trumbore, strict ``<``
  against the lane's best t, first slot on a tie);
* then it descends into the first hit internal child at slot >= ``ic``
  and, if another hit internal slot follows, pushes one compressed entry
  ``cur << 4 | slot``; with none it pops, re-tests the popped node's
  children under the tightened best t and resumes at the stored slot.

These are what the CUDA kernels K3 and K4 (``csrc/bvh.cu``) compute, a
half-warp per lane. The JAX package's
TPU machinery (tiles, two-phase compaction, packets) is not ported: it
changes which of two triangles at exactly equal t wins, never t. Meshes
of at most ``BLOCK_SIZE`` triangles take the brute sweep instead.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry.intersect import INF
from .build import BLOCK_SIZE, WIDE_K

DEFAULT_STACK_SLOTS = 48  # stack entries when the caller gives no bound
MAX_STACK_SLOTS = 128  # the most a mesh may need (flatten refuses more)
_SLOT_BITS = (WIDE_K - 1).bit_length()  # slot field of a stack entry


@dataclasses.dataclass(frozen=True)
class MeshPool:
    """All mesh BVHs and triangles concatenated into flat tables.

    node_rows: (Ni, 72) f32 wide-BVH rows (``accel/build.py::WideBVH``);
    block_rows: (B, 192) f32 leaf blocks, component-major (16 x v0x, 16 x
    v0y, ..., 16 x v2z, 48 pad); tri_planes / nrm_planes: 9 x (Tp,) f32
    component planes of the same triangles (v0x v0y v0z v1x ... v2z and
    n0x ... n2z); tri_cdf: (Tp,) per-mesh area CDF over the padded order
    (padding slots repeat the previous value)."""

    node_rows: torch.Tensor
    block_rows: torch.Tensor
    tri_cdf: torch.Tensor
    tri_planes: tuple
    nrm_planes: tuple

    def gather_tri(self, idx):
        """Vertices of triangles idx (...,) -> three (..., 3) tensors."""
        return _corners(_GatherPlanes.apply(idx, *self.tri_planes))

    def gather_normals(self, idx):
        """Vertex normals of triangles idx (...,) -> three (..., 3) tensors."""
        return _corners(_GatherPlanes.apply(idx, *self.nrm_planes))


def _corners(cols):
    """Nine gathered planes -> three (..., 3) corners."""
    return tuple(torch.stack(cols[3 * k:3 * k + 3], -1) for k in range(3))


ONEHOT_ROWS = 64  # a gather's backward over at most this many rows is a matmul


class _GatherPlanes(torch.autograd.Function):
    """``plane[idx]`` for each of the nine (T,) planes of a gather:
    ``index_select`` forward (exact, the bits of advanced indexing). The
    backward sums each lane's gradient into its row, for the planes that
    need one at once: a pool of at most ``ONEHOT_ROWS`` rows takes one
    (T, N) one-hot x (N, 9) matmul, a larger one ``index_add_`` (an atomic
    add a lane on the card).

    The rule, from the candidates timed on an NVIDIA H100 80GB HBM3 at
    700 W (``chip_smoke.py::vertex_backward_candidates``): on a 512x512
    gradient step's largest gather (262,144 lanes), Cornell's (2 of 16
    rows) one-hot 0.090 ms, ``index_add_`` 0.368 (colliding atomics), a
    sorted segment sum 0.650; envmesh's (14,411 of 186,688 rows: missed
    lanes all read one row) ``index_add_`` 0.495, sorted 0.681. At 1M
    lanes, 2 rows of 16: one-hot 0.289, ``index_add_`` 1.459; over the
    524k sphere's rows, where a one-hot table does not fit,
    ``index_add_`` 0.080, sorted 2.66. Advanced indexing's backward, the
    accumulating ``index_put`` that sorts and serializes colliding rows,
    took 23, 47, 122 and 0.38 ms on the same four."""

    @staticmethod
    def forward(ctx, idx, *planes):
        ctx.set_materialize_grads(False)
        flat = idx.reshape(-1)
        ctx.save_for_backward(flat)
        ctx.rows = planes[0].shape[0]
        return tuple(p.index_select(0, flat).reshape(idx.shape) for p in planes)

    @staticmethod
    def backward(ctx, *grads):
        (flat,) = ctx.saved_tensors
        live = [k for k, g in enumerate(grads) if g is not None and ctx.needs_input_grad[k + 1]]
        out = [None] * len(grads)
        if live:
            g = torch.stack([grads[k].reshape(-1) for k in live], 1)
            if ctx.rows <= ONEHOT_ROWS:
                rows = torch.arange(ctx.rows, device=flat.device)
                sums = (flat[None, :] == rows[:, None]).to(g.dtype) @ g
            else:
                sums = torch.zeros((ctx.rows, len(live)), dtype=g.dtype, device=g.device)
                sums.index_add_(0, flat, g)
            for c, k in enumerate(live):
                out[k] = sums[:, c]
        return (None, *out)


@dataclasses.dataclass(frozen=True)
class MeshHandle:
    """Static addressing of one mesh inside a MeshPool."""

    node_offset: int
    num_nodes: int
    tri_offset: int  # padded-order offset, multiple of BLOCK_SIZE
    num_tris: int  # padded count, multiple of BLOCK_SIZE
    real_tris: int  # unpadded triangle count
    area: float
    root_lower: tuple  # (3,) mesh-local root AABB
    root_upper: tuple
    stack_slots: int  # worst-case walk stack depth (build.wide_stack_bound)


def _mt_terms(va, vb, vc, o, d, eps):
    """Two-sided Moller-Trumbore, component-wise: (ab, ac, hit, t, u, v),
    u and v the weights of vb and vc."""
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
    return (abx, aby, abz), (acx, acy, acz), hit, t, u, v


def _tri_hit(va, vb, vc, o, d, eps=1e-9):
    """Two-sided Moller-Trumbore, component-wise. va/vb/vc/o/d: 3-tuples of
    broadcast-compatible tensors. Returns (hit, t)."""
    _, _, hit, t, _, _ = _mt_terms(va, vb, vc, o, d, eps)
    return hit, t


def tri_refit(va, vb, vc, o, d, eps=1e-9):
    """The walk's own triangle test (``_tri_hit``: the same operations in
    the same order, so t equals the walk's bit for bit) with what a refit
    needs, in ``intersect_ray_tri``'s form: (hit, t, u, v, w, n_geo), t =
    +inf on a miss, u, v, w the weights of va, vb, vc, n_geo = ab x ac
    (3-tuple) flipped towards the side the ray arrives from."""
    ab, ac, hit, t, bv, bw = _mt_terms(va, vb, vc, o, d, eps)
    n = (ab[1] * ac[2] - ab[2] * ac[1], ab[2] * ac[0] - ab[0] * ac[2],
         ab[0] * ac[1] - ab[1] * ac[0])
    dn = -d[0] * n[0] + -d[1] * n[1] + -d[2] * n[2]
    sign = torch.where(dn >= 0.0, 1.0, -1.0)
    return (hit, torch.where(hit, t, INF), (1.0 - bv) - bw, bv, bw,
            tuple(x * sign for x in n))


def _intersect_mesh_brute(pool: MeshPool, tri_offset: int, num_tris: int,
                          origins, dirs, tmax):
    """All-triangles masked sweep for tiny meshes, (T, R) broadcast.

    Returns (t, tri_local): t = +inf and tri_local = -1 on a miss; ties go
    to the lowest triangle id."""
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


# ------------------------------------------------------------ wide BVH walk


def _safe_rcp3(d):
    """Reciprocal direction with zero components nudged to +/-1e-30, so an
    origin on a box bound gives 0 * 1e30 = 0, not 0 * inf = NaN."""
    eps = 1e-30
    tiny = torch.where(d < 0, -eps, eps)
    return 1.0 / torch.where(torch.abs(d) < eps, tiny, d)


def _decode_nodes(node_rows):
    """Unpack every node row once: (lo, hi) (Ni, 3, K) f32 child boxes
    (bf16 upper bound in a word's high half, lower bound in its low half;
    empty slots decode to NaN) and (Ni, K) i32 child words."""
    k = WIDE_K
    bits = node_rows[:, :3 * k].contiguous().view(torch.int32).to(torch.int64)
    bits = bits & 0xFFFFFFFF

    def as_f32(b):  # low 32 bits of an int64 -> the f32 they encode
        b = torch.where(b >= 2**31, b - 2**32, b)
        return b.to(torch.int32).view(torch.float32)

    hi = as_f32(bits & 0xFFFF0000).reshape(-1, 3, k)
    lo = as_f32((bits << 16) & 0xFFFFFFFF).reshape(-1, 3, k)
    words = node_rows[:, 3 * k:4 * k].contiguous().view(torch.int32)
    return lo, hi, words


def _child_tests(lo, hi, o, rd, best_t, live):
    """Slab-test the K child boxes of each lane's node: (R, K) bool."""
    t0 = (lo - o[:, :, None]) * rd[:, :, None]  # (R, 3, K)
    t1 = (hi - o[:, :, None]) * rd[:, :, None]
    near = torch.minimum(t0, t1)
    far = torch.maximum(t0, t1)
    tn = torch.maximum(
        torch.maximum(near[:, 0], near[:, 1]), torch.maximum(near[:, 2], torch.zeros_like(near[:, 2]))
    )
    tf = torch.minimum(torch.minimum(far[:, 0], far[:, 1]), far[:, 2])
    return live[:, None] & (tn <= tf) & (tn < best_t[:, None])


def _block_test(block_rows, block_base, pend, o, d, best_t):
    """Test the 16 triangles of each lane's pending leaf block (lanes with
    pend < 0 find nothing). Returns (found, t_min, tri_local)."""
    has = pend >= 0
    brow = block_rows[block_base + torch.where(has, pend, 0)]
    b = BLOCK_SIZE
    comp = [brow[:, i * b:(i + 1) * b] for i in range(9)]
    ob = tuple(c[:, None] for c in o.unbind(-1))
    db = tuple(c[:, None] for c in d.unbind(-1))
    hit, t = _tri_hit(comp[0:3], comp[3:6], comp[6:9], ob, db)  # (R, 16)
    tt = torch.where(hit & has[:, None] & (t < best_t[:, None]), t, INF)
    t_min, slot = tt.min(dim=1)  # first slot among equal minima
    return t_min < best_t, t_min, pend * b + slot.to(torch.int32)


def _advance(ok, words, cur, lc, ic, sp, stack, act):
    """Leaf dwell and the compressed-stack advance of one step (in place on
    ``stack``). Returns (pend, dwell, s, cur', ic', lc', sp')."""
    k = WIDE_K
    slots = torch.arange(k, dtype=torch.int32, device=ok.device)[None, :]
    none = torch.full_like(slots, k)
    leafm = ok & (words < 0) & (slots >= lc[:, None])
    s = torch.where(leafm, slots, none).min(dim=1).values
    w_s = torch.where(slots == s[:, None], words, 0).sum(dim=1, dtype=torch.int32)
    dwell = act & (s < k)
    pend = torch.where(dwell, -w_s - 1, -1)

    intm = ok & (words >= 0) & (slots >= ic[:, None])
    first_c = torch.where(intm, slots, none).min(dim=1).values
    desc = torch.where(slots == first_c[:, None], words, 0).sum(dim=1, dtype=torch.int32)
    second_c = torch.where(intm & (slots > first_c[:, None]), slots, none).min(dim=1).values
    has_desc = first_c < k
    adv = act & ~dwell

    push = adv & (second_c < k)
    top = torch.clamp(sp, max=stack.shape[1] - 1)[:, None]
    entry = (cur << _SLOT_BITS) | second_c
    stack.scatter_(1, top, torch.where(push, entry, stack.gather(1, top)[:, 0])[:, None])
    sp = sp + push.to(torch.int32)

    pop = adv & ~has_desc & (sp > 0)
    popped = torch.where(pop, stack.gather(1, torch.clamp(sp - 1, min=0)[:, None])[:, 0], -1)
    sp = sp - pop.to(torch.int32)
    resumed = popped >= 0
    nxt = torch.where(has_desc, desc, torch.where(resumed, popped >> _SLOT_BITS, -1))
    ic = torch.where(
        adv,
        torch.where(has_desc, 0, torch.where(resumed, popped & (k - 1), 0)),
        ic,
    )
    lc = torch.where(dwell, s + 1, torch.where(adv, torch.where(has_desc, 0, k), lc))
    return pend, dwell, adv, nxt, ic, lc, sp


def _count(stats, pool, nodes, blocks):
    """Add one step's node arrivals and leaf-block tests to ``stats`` and
    mark the rows they read."""
    if "node_rows" not in stats:
        stats.update(visits=0, blocks=0)
        stats["node_rows"] = torch.zeros(pool.node_rows.shape[0], dtype=torch.bool,
                                         device=nodes.device)
        stats["block_rows"] = torch.zeros(pool.block_rows.shape[0], dtype=torch.bool,
                                          device=nodes.device)
    stats["visits"] += nodes.numel()
    stats["blocks"] += blocks.numel()
    stats["node_rows"][nodes] = True
    stats["block_rows"][blocks] = True


def _lanes(x, r, device):
    """A scalar or (R,) offset as an (R,) int64 tensor."""
    return torch.as_tensor(x, device=device).to(torch.int64).expand(r)


def _walk(pool: MeshPool, node_offset, tri_offset, origins, dirs, tmax,
          stack_slots: int, any_hit: bool, stats: dict | None):
    r = origins.shape[0]
    dev = origins.device
    lo, hi, words = _decode_nodes(pool.node_rows)
    noff = _lanes(node_offset, r, dev)
    bbase = _lanes(tri_offset, r, dev) // BLOCK_SIZE
    rd = _safe_rcp3(dirs)
    i32 = dict(dtype=torch.int32, device=dev)
    cur = torch.zeros(r, **i32)
    lc = torch.zeros(r, **i32)
    ic = torch.zeros(r, **i32)
    pend = torch.full((r,), -1, **i32)
    sp = torch.zeros(r, **i32)
    stack = torch.zeros((r, max(int(stack_slots), 1)), **i32)
    best_t = tmax.to(torch.float32).clone()
    best_tri = torch.full((r,), -1, **i32)
    occ = torch.zeros(r, dtype=torch.bool, device=dev)

    arrived = cur >= 0  # lanes that reached a node this step
    while bool(((cur >= 0) | (pend >= 0)).any()):
        live = cur >= 0
        node = noff + torch.clamp(cur, min=0)
        if stats is not None:
            _count(stats, pool, node[arrived], (bbase + pend)[pend >= 0])
        found, t_min, tri_local = _block_test(pool.block_rows, bbase, pend, origins, dirs, best_t)
        if any_hit:
            occ = occ | found
            act = live & ~occ
        else:
            best_t = torch.where(found, t_min, best_t)
            best_tri = torch.where(found, tri_local, best_tri)
            act = live
        ok = _child_tests(lo[node], hi[node], origins, rd, best_t, act)
        pend, dwell, adv, nxt, ic, lc, sp = _advance(
            ok, words[node], cur, lc, ic, sp, stack, act
        )
        if any_hit:
            cur = torch.where(live, torch.where(occ, -1, torch.where(dwell, cur, nxt)), cur)
        else:
            cur = torch.where(adv, nxt, cur)
        arrived = adv & (cur >= 0)
    if any_hit:
        return occ
    return torch.where(best_tri >= 0, best_t, INF), best_tri


def intersect_mesh(pool: MeshPool, node_offset, tri_offset, origins, dirs, tmax,
                   num_tris: int | None = None,
                   stack_slots: int = DEFAULT_STACK_SLOTS, stats: dict | None = None):
    """Closest hit against one mesh sub-BVH per lane (plain version of
    kernel K3). origins/dirs (R, 3), tmax (R,); node_offset / tri_offset
    an int or (R,) per lane. Returns (t, tri_local): t = +inf and
    tri_local = -1 on a miss, tri_local in the block-padded order. A mesh
    of at most BLOCK_SIZE triangles (``num_tris``) takes the brute sweep.
    ``stats``: a dict the walk fills with the work a kernel bound counts:
    "visits" (arrivals of a lane at a node), "blocks" (leaf-block tests)
    and "node_rows" / "block_rows", masks of the rows read."""
    if num_tris is not None and num_tris <= BLOCK_SIZE:
        return _intersect_mesh_brute(pool, int(tri_offset), num_tris, origins, dirs, tmax)
    return _walk(pool, node_offset, tri_offset, origins, dirs, tmax, stack_slots, False, stats)


def intersect_mesh_any(pool: MeshPool, node_offset, tri_offset, origins, dirs,
                       tmax, num_tris: int | None = None,
                       stack_slots: int = DEFAULT_STACK_SLOTS, stats: dict | None = None):
    """Occlusion (plain version of kernel K4): (R,) bool, any triangle hit
    with t < tmax. Arguments as ``intersect_mesh``."""
    if num_tris is not None and num_tris <= BLOCK_SIZE:
        _, tri = _intersect_mesh_brute(pool, int(tri_offset), num_tris, origins, dirs, tmax)
        return tri >= 0
    return _walk(pool, node_offset, tri_offset, origins, dirs, tmax, stack_slots, True, stats)
