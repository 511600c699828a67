"""The sweep over spheres, planes and tiny meshes as CUDA kernels, and its
dispatchers.

``sweep_closest`` (kernel K5c, ``csrc/sweep.cu``) and ``sweep_any`` (K5a)
replace the JAX package's pure-JAX sweep: the sphere and plane rows and
their merge in ``tinsel_tpu/render/trace.py:388-424`` (``trace_closest``)
and ``:576`` (``trace_any``), and the brute sweep over meshes of at most 16
triangles, ``tinsel_tpu/accel/traverse.py:981 _intersect_mesh_brute``.
Neither was Pallas there.

The kernels read the scene as a table in the merge order of the plain
versions (``accel/sweep.py``), cut into chunks at item bounds. A chunk is
runs of one kind, each field a float (ints as their bits) and every run
and record a multiple of 4 floats, so a record arrives as 16-byte shared
loads:

    header (4): spheres, planes, groups in this chunk, flags (1: the
        spheres move)
    sphere ids (the count rounded up to 4), then the spheres: static
        (4): centre (3), radius * s; moving (12): start p (3), start s,
        end p - start p (3), end s - start s, radius, 0, 0, 0
    plane ids (rounded up to 4), then the planes (4): a, b, c, d
    each group: a head (12): triangles, instances in this chunk, flags
        (1 opens the group, 2 closes it, 4 its instances move), the
        pool's index of its first triangle, root box lower (3), 0, upper
        (3), 0; its triangles (12 each): v0 (3), ab = v1 - v0 (3),
        ac = v2 - v0 (3), ab x ac (3); instance ids (rounded up to 4);
        its instances: static (8): p (3), s, -q.xyz (3), q.w; moving
        (16): start p (3), start s, start q (4), end p - start p (3),
        end s - start s, end q - start q (4)

Every precomputed field is one f32 subtraction, product or negation of
the scene's values, computed here as the kernels' plain version computes
it, so it has the same bits (``tests/test_torch_sweep.py``). A chunk that
starts inside a group repeats the group's head and triangles, not opening
it. The table is packed on the host once for a scene's primitive tables
(``table``, kept while those tensors stay the same objects at the same
version). Each block of a kernel stages the table in shared memory with
TMA bulk copies: once for the whole launch where it is one chunk (up to
``SMEM_FLOATS``), else chunk by chunk (each up to ``CHUNK_FLOATS``) with
the next chunk's copy in flight in a second buffer.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises. The sweeps return discrete winners and have no gradient:
``render/trace.py`` intersects the winner again under autograd.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..accel import sweep as _plain
from . import _build
from .bvh import _check, _on_cpu

# Launches per kernel since the last reset; a wrapper adds one where it
# launches its kernel and nowhere else.
launch_counts = {"sweep_closest": 0, "sweep_any": 0}
# A block of csrc/sweep.cu stages at most SMEM_FLOATS floats (112 KB,
# above the 48 KB without opt-in, so that two blocks fit an SM's 227 KB): a
# table of up to SMEM_FLOATS is one chunk, staged once; a larger one is cut
# into chunks of up to CHUNK_FLOATS, two buffers of which take turns.
SMEM_FLOATS = 28672
CHUNK_FLOATS = SMEM_FLOATS // 2
HEAD = 4
SPHERE_STATIC, SPHERE_MOVING, PLANE_LEN = 4, 12, 4
GROUP_HEAD, TRI_LEN, INSTANCE_STATIC, INSTANCE_MOVING = 12, 12, 8, 16
SPHERES_MOVE = 1  # chunk flag
OPENS, CLOSES, MOVES = 1, 2, 4  # group flags
TABLES_KEPT = 8  # packed tables kept, the oldest dropped first

_entries: dict = {}
_tables: dict = {}  # key of the tensors read -> (those objects, SweepTable)


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


@dataclasses.dataclass(frozen=True)
class SweepTable:
    table: torch.Tensor  # (F,) f32 chunks, on the rays' device
    chunks: torch.Tensor  # (C + 1,) i32 chunk bounds, in floats
    n_chunks: int
    smem_floats: int  # floats of the largest chunk
    motion: bool  # some record interpolates at the ray's time


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
    lay = _plain.layout(scene.prim_static, hoist)
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


def _key(scene, dev, hoist: bool):
    objs = (scene.prim_static, scene.prims.start_p, scene.prims.start_q, scene.prims.start_s,
            scene.prims.end_p, scene.prims.end_q, scene.prims.end_s, scene.prims.radius,
            scene.prims.plane, *scene.pool.tri_planes)
    key = (str(dev), SMEM_FLOATS, hoist) + tuple((id(x), getattr(x, "_version", 0))
                                                 for x in objs)
    return key, objs


def table(scene, dev, hoist: bool = True) -> SweepTable:
    """The scene's packed record table on ``dev`` for the hoist setting
    ``hoist`` (``pack_records``), packed at its first use and kept while
    the scene's tables are the same tensors, unchanged."""
    key, objs = _key(scene, dev, hoist)
    hit = _tables.get(key)
    if hit is not None:
        return hit[1]
    recs, bounds = pack_records(scene, hoist=hoist)
    sizes = np.diff(bounds)
    lay = _plain.layout(scene.prim_static, hoist)
    tab = SweepTable(
        table=torch.from_numpy(recs).to(dev), chunks=torch.from_numpy(bounds).to(dev),
        n_chunks=len(bounds) - 1, smem_floats=int(sizes.max()) if len(sizes) else 0,
        motion=lay.sphere_motion or any(g.motion for g in lay.groups),
    )
    if len(_tables) >= TABLES_KEPT:
        _tables.pop(next(iter(_tables)))
    _tables[key] = (objs, tab)  # holding objs keeps their ids unique
    return tab


def _entry(kernel: str):
    fn = _entries.get(kernel)
    if fn is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = getattr(_build.load("sweep"), f"tinsel_{kernel}")
        # table, chunk bounds, chunks, floats of the largest chunk, origins,
        # dirs, times (or NULL), [tmax,] rays, out pointer(s), stream
        rays = [p, p, p, p] if kernel == "sweep_any" else [p, p, p]
        outs = [p] if kernel == "sweep_any" else [p, p, p]
        fn.argtypes = [p, p, i, i, *rays, i, *outs, p]
        fn.restype = i
        _entries[kernel] = fn
    return fn


def launch_geometry(kernel: str, tab: SweepTable, rays: int) -> tuple:
    """(rays a block sweeps at a time, blocks) of a launch of ``kernel``
    on ``rays`` rays of the packed table ``tab``, on the current device."""
    lib = _build.load("sweep")
    tile, grid = ctypes.c_int(), ctypes.c_int()
    err = lib.tinsel_sweep_geometry(int(kernel == "sweep_closest"), int(tab.motion), tab.n_chunks,
                                    tab.smem_floats, rays, ctypes.byref(tile), ctypes.byref(grid))
    if err:
        raise RuntimeError(f"{kernel}: no launch geometry (error {err})")
    return tile.value, grid.value


def _launch(kernel: str, scene, origins, dirs, times, tmax, outs, hoist: bool):
    r = origins.shape[0]
    dev = origins.device
    checks = [(origins, "origins", (r, 3)), (dirs, "dirs", (r, 3)), (times, "times", (r,))]
    for t, name, shape in checks + ([(tmax, "tmax", (r,))] if tmax is not None else []):
        _check(t, name, torch.float32, shape)
        if t.device != dev:
            raise ValueError(f"{kernel}: {name} on {t.device}, the rays on {dev}")
    if r == 0:
        return
    # the kernels read and write a thread's rays as 8- or 16-byte vectors
    origins, dirs, times, tmax = (x if x is None or x.data_ptr() % 16 == 0 else x.clone()
                                  for x in (origins, dirs, times, tmax))
    tab = table(scene, dev, hoist)
    rays = [origins.data_ptr(), dirs.data_ptr(), times.data_ptr() if tab.motion else None]
    if tmax is not None:
        rays.append(tmax.data_ptr())
    args = (tab.table.data_ptr(), tab.chunks.data_ptr(), tab.n_chunks, tab.smem_floats, *rays,
            r, *(o.data_ptr() for o in outs))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index is None or dev.index == torch.cuda.current_device():
        err = _entry(kernel)(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = _entry(kernel)(*args, stream)
    if err != 0:
        what = {9001: "arguments rejected by the kernel",
                9002: f"{tab.smem_floats * 4 * (2 if tab.n_chunks > 1 else 1)} bytes of shared "
                      "memory, above what a block of this card may opt in to"}.get(
                          err, f"CUDA error {err}")
        raise RuntimeError(f"{kernel} kernel launch failed: {what} ({r} rays)")
    launch_counts[kernel] += 1


def sweep_closest_cuda(scene, origins, dirs, times, hoist: bool = True):
    """Kernel K5c: (t, prim, tri) of each ray's closest sphere, plane or
    tiny-mesh hit, as ``accel/sweep.py::sweep_closest``."""
    r, dev = origins.shape[0], origins.device
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    prim = torch.empty((r,), dtype=torch.int32, device=dev)
    tri = torch.empty((r,), dtype=torch.int32, device=dev)
    _launch("sweep_closest", scene, origins, dirs, times, None, (t, prim, tri), hoist)
    return t, prim, tri


def sweep_any_cuda(scene, origins, dirs, times, tmax, hoist: bool = True):
    """Kernel K5a: (R,) bool, some sphere, plane or tiny-mesh triangle hit
    with 0 < t < tmax, as ``accel/sweep.py::sweep_any``."""
    occ = torch.empty((origins.shape[0],), dtype=torch.bool, device=origins.device)
    _launch("sweep_any", scene, origins, dirs, times, tmax, (occ,), hoist)
    return occ


def _rays(origins, dirs, times):
    """Detached, contiguous rays; times broadcast to (R,)."""
    r = origins.shape[0]
    times = torch.broadcast_to(torch.as_tensor(times, dtype=torch.float32,
                                               device=origins.device), (r,))
    return origins.detach().contiguous(), dirs.detach().contiguous(), times.detach().contiguous()


def sweep_closest(scene, origins, dirs, times, hoist: bool = True):
    """Closest sphere, plane or tiny-mesh hit of each ray, (t, prim, tri):
    kernel K5c on CUDA tensors, ``accel/sweep.py::sweep_closest`` on CPU
    tensors. ``hoist``: ``render/trace.py::STATIC_TRANSFORM_HOIST``."""
    o, d, tm = _rays(origins, dirs, times)
    if _on_cpu(o):
        return _plain.sweep_closest(scene, o, d, tm, hoist=hoist)
    return sweep_closest_cuda(scene, o, d, tm, hoist)


def sweep_any(scene, origins, dirs, times, tmax, hoist: bool = True):
    """Occlusion by a sphere, plane or tiny-mesh triangle with
    0 < t < tmax: kernel K5a on CUDA tensors, ``accel/sweep.py::sweep_any``
    on CPU tensors. ``hoist``: as ``sweep_closest``'s."""
    o, d, tm = _rays(origins, dirs, times)
    tmax = torch.broadcast_to(torch.as_tensor(tmax, dtype=torch.float32, device=o.device),
                              (o.shape[0],)).contiguous()
    if _on_cpu(o):
        return _plain.sweep_any(scene, o, d, tm, tmax, hoist=hoist)
    return sweep_any_cuda(scene, o, d, tm, tmax, hoist)
