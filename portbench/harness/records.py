"""The packed record table of the port's sweep kernels (``csrc/sweep.cu``,
K5c / K5a), rebuilt from the reference's flat scene: ``harness/work.py``
counts a sweep's bytes with the table read once, so only its size is used
(``pack_records(...)[0].size``)."""

from __future__ import annotations

import numpy as np

from reference.tinsel_ref.accel.sweep import layout

# The packed record table of csrc/sweep.cu, copied for its size: the
# sweep's bytes count the table read once.
SMEM_FLOATS = 28672
CHUNK_FLOATS = SMEM_FLOATS // 2
HEAD = 4
SPHERE_STATIC, SPHERE_MOVING, PLANE_LEN = 4, 12, 4
GROUP_HEAD, TRI_LEN, INSTANCE_STATIC, INSTANCE_MOVING = 12, 12, 8, 16
SPHERES_MOVE = 1  # chunk flag
OPENS, CLOSES, MOVES = 1, 2, 4  # group flags


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def _ids(ids) -> np.ndarray:
    """An id run: int32 bits as f32, padded with zeros to 4."""
    out = np.zeros(_pad4(len(ids)), np.int32)
    out[:len(ids)] = ids
    return out.view(np.float32)


def _records(lay, scene):
    """Per-item f32 records of a scene, in merge order: (sphere records,
    plane records, per group (the group, its root box, its triangle
    records, its instance records))."""
    f32 = np.float32
    pr = {k: getattr(scene.prims, k).detach().cpu().numpy().astype(f32)
          for k in ("start_p", "start_q", "start_s", "end_p", "end_q", "end_s", "radius",
                    "plane")}
    sp = pr["start_p"]
    if lay.sphere_motion:
        spheres = [np.concatenate([sp[i], [pr["start_s"][i]], pr["end_p"][i] - sp[i],
                                   [pr["end_s"][i] - pr["start_s"][i]],
                                   [pr["radius"][i], 0, 0, 0]]).astype(f32)
                   for i in lay.spheres]
    else:
        spheres = [np.concatenate([sp[i], [pr["radius"][i] * pr["start_s"][i]]]).astype(f32)
                   for i in lay.spheres]
    planes = [pr["plane"][i].astype(f32) for i in lay.planes]
    planes9 = [c.detach().cpu().numpy().astype(f32) for c in scene.pool.tri_planes]
    groups = []
    for g in lay.groups:
        lo = g.handle.tri_offset
        v = np.stack([c[lo:lo + g.tris] for c in planes9], -1).reshape(-1, 3, 3)
        tris = [tri_record(*t) for t in v]
        if g.motion:
            inst = [np.concatenate([sp[i], [pr["start_s"][i]], pr["start_q"][i],
                                    pr["end_p"][i] - sp[i], [pr["end_s"][i] - pr["start_s"][i]],
                                    pr["end_q"][i] - pr["start_q"][i]]).astype(f32)
                    for i in g.prims]
        else:
            inst = [np.concatenate([sp[i], [pr["start_s"][i]], -pr["start_q"][i][:3],
                                    pr["start_q"][i][3:]]).astype(f32) for i in g.prims]
        bounds = np.array([*g.handle.root_lower, 0, *g.handle.root_upper, 0], f32)
        groups.append((g, bounds, tris, inst))
    return spheres, planes, groups


def tri_record(v0, v1, v2) -> np.ndarray:
    """A triangle's 12 floats: v0, ab = v1 - v0, ac = v2 - v0 and the
    normal ab x ac, each an f32 operation in the kernels' order (the
    edges of ``accel/traverse.py::_tri_hit``, the normal of
    ``accel/sweep.py::ray_tri``)."""
    v0, v1, v2 = (np.asarray(x, np.float32) for x in (v0, v1, v2))
    ab, ac = v1 - v0, v2 - v0
    n = np.array([ab[1] * ac[2] - ab[2] * ac[1], ab[2] * ac[0] - ab[0] * ac[2],
                  ab[0] * ac[1] - ab[1] * ac[0]], np.float32)
    return np.concatenate([v0, ab, ac, n]).astype(np.float32)


class _Chunk:
    """One chunk being filled: its runs and its size in floats. A group
    part is [(group, bounds, triangles, instance records), instance
    indices]: it opens the group where it holds the first instance and
    closes it where it holds the last."""

    def __init__(self, sphere_moves: bool):
        self.moves = sphere_moves
        self.spheres, self.planes, self.groups = [], [], []

    def size(self) -> int:
        """Floats of the chunk (the records of a run have one length)."""
        ns, n_planes = len(self.spheres), len(self.planes)
        n = HEAD + _pad4(ns) + (ns and ns * len(self.spheres[0][1]))
        n += _pad4(n_planes) + PLANE_LEN * n_planes
        for (_, _, tris, inst), js in self.groups:
            n += GROUP_HEAD + TRI_LEN * len(tris) + _pad4(len(js)) + len(js) * len(inst[0])
        return n

    def floats(self) -> np.ndarray:
        def ints(*x):
            return np.asarray(x, np.int32).view(np.float32)

        out = [ints(len(self.spheres), len(self.planes), len(self.groups),
                    SPHERES_MOVE if self.moves else 0)]
        out += [_ids([i for i, _ in self.spheres])] + [r for _, r in self.spheres]
        out += [_ids([i for i, _ in self.planes])] + [r for _, r in self.planes]
        for (g, bounds, tris, inst), js in self.groups:
            flags = ((OPENS if js[0] == 0 else 0) | (CLOSES if js[-1] == len(g.prims) - 1 else 0)
                     | (MOVES if g.motion else 0))
            out += [ints(g.tris, len(js), flags, g.handle.tri_offset), bounds, *tris,
                    _ids([g.prims[j] for j in js]), *(inst[j] for j in js)]
        return np.concatenate(out).astype(np.float32)


def pack_records(scene, chunk_floats: int | None = None, hoist: bool = True):
    """(table, chunk bounds) of a scene: its chunks as one (F,) f32 numpy
    array and the (C + 1,) int32 float offsets where each starts (the
    last: F). Chunks hold at most ``chunk_floats`` floats (by default one
    chunk of up to ``SMEM_FLOATS``, else chunks of up to ``CHUNK_FLOATS``);
    an item that does not fit starts the next chunk. ``hoist=False``
    (``render/trace.py::STATIC_TRANSFORM_HOIST`` off): every sphere and
    instance record takes the moving form."""
    if chunk_floats is None:
        table, bounds = pack_records(scene, SMEM_FLOATS, hoist)
        return (table, bounds) if len(bounds) <= 2 else pack_records(scene, CHUNK_FLOATS, hoist)
    limit = chunk_floats
    lay = layout(scene.prim_static, hoist)
    spheres, planes, groups = _records(lay, scene)
    done, cur = [], _Chunk(lay.sphere_motion)

    def add(run, item):
        """Append an item to a run of the current chunk, or of a new one."""
        nonlocal cur
        for attempt in range(2):
            lists = {"spheres": cur.spheres, "planes": cur.planes}
            if run in lists:
                lists[run].append(item)
            else:  # (group, instance index): the group's part in this chunk
                grp, j = item
                if not cur.groups or cur.groups[-1][0] is not grp:
                    cur.groups.append([grp, []])
                cur.groups[-1][1].append(j)
            if cur.size() <= limit:
                return
            if attempt:
                raise ValueError(f"a sweep record does not fit a chunk of {limit} floats")
            if run in lists:
                lists[run].pop()
            else:
                cur.groups[-1][1].pop()
                if not cur.groups[-1][1]:
                    cur.groups.pop()
            done.append(cur.floats())
            cur = _Chunk(lay.sphere_motion)

    for item in zip(lay.spheres, spheres):
        add("spheres", item)
    for item in zip(lay.planes, planes):
        add("planes", item)
    for grp in groups:
        for j in range(len(grp[0].prims)):
            add("groups", (grp, j))
    if cur.spheres or cur.planes or cur.groups:
        done.append(cur.floats())
    table = np.concatenate(done) if done else np.zeros(0, np.float32)
    return table, np.concatenate([[0], np.cumsum([len(c) for c in done])]).astype(np.int32)


