"""The sweep over spheres, planes and tiny meshes as CUDA kernels, and its
dispatchers.

``sweep_closest`` (kernel K5c, ``csrc/sweep.cu``) and ``sweep_any`` (K5a)
replace the JAX package's pure-JAX sweep: the sphere and plane rows and
their merge in ``tinsel_tpu/render/trace.py:388-424`` (``trace_closest``)
and ``:576`` (``trace_any``), and the brute sweep over meshes of at most 16
triangles, ``tinsel_tpu/accel/traverse.py:981 _intersect_mesh_brute``.
Neither was Pallas there.

The kernels take one ray a thread and read the scene as a table of
records, in the merge order of the plain versions (``accel/sweep.py``):

    sphere (12 floats): kind 0, prim, motion, radius, start p (3), start s,
        end p (3), end s
    plane (6): kind 1, prim, a, b, c, d
    group (11 + 9 n): kind 2, n triangles, opens the group (1) or
        continues it in a new chunk (0), motion, the pool's index of its
        first triangle, root box lower (3) and upper (3), then per
        triangle v0, v1, v2 (9)
    instance (18): kind 3, prim, start p (3), q (4), s, end p (3), q (4), s
    end of group (1): kind 4

(ints stored as their bits). The table is packed on the host once for a
scene's primitive tables (``table``, kept while those tensors stay the
same objects at the same version) and cut into chunks of at most
``CHUNK_FLOATS`` floats at record bounds; a chunk that starts inside a
group repeats the group's record first. Each block stages one chunk at a
time in shared memory.

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
THREADS = 256  # threads per block, one ray each
CHUNK_FLOATS = 12288  # 48 KB of shared memory: no opt-in needed
SPHERE, PLANE, GROUP, INSTANCE, END = range(5)
SPHERE_LEN, PLANE_LEN, GROUP_HEAD, INSTANCE_LEN, END_LEN = 12, 6, 11, 18, 1
TABLES_KEPT = 8  # packed tables kept, the oldest dropped first

_entries: dict = {}
_tables: dict = {}  # key of the tensors read -> (those objects, SweepTable)


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


@dataclasses.dataclass(frozen=True)
class SweepTable:
    table: torch.Tensor  # (F,) f32 records, on the rays' device
    chunks: torch.Tensor  # (C + 1,) i32 chunk bounds, in floats
    n_chunks: int
    smem_floats: int  # floats of the largest chunk
    motion: bool  # some record interpolates at the ray's time


def _bits(x: int) -> np.float32:
    """The f32 whose bits are the int32 x (a record's int field)."""
    return np.array([x], np.int32).view(np.float32)[0]


def pack_records(scene):
    """(records, chunk bounds) of a scene: the record table as a (F,) f32
    numpy array and the (C + 1,) int32 float offsets of its chunks."""
    lay = _plain.layout(scene.prim_static)
    pr = {k: getattr(scene.prims, k).detach().cpu().numpy().astype(np.float32)
          for k in ("start_p", "start_q", "start_s", "end_p", "end_q", "end_s", "radius",
                    "plane")}
    planes9 = [c.detach().cpu().numpy() for c in scene.pool.tri_planes]
    recs = []  # (record, group index or -1, kind)
    for i in lay.spheres:
        recs.append(([_bits(SPHERE), _bits(i), float(lay.sphere_motion), pr["radius"][i],
                      *pr["start_p"][i], pr["start_s"][i], *pr["end_p"][i], pr["end_s"][i]],
                     -1, SPHERE))
    for i in lay.planes:
        recs.append(([_bits(PLANE), _bits(i), *pr["plane"][i]], -1, PLANE))
    for gi, g in enumerate(lay.groups):
        h = g.handle
        lo = h.tri_offset
        tris = np.stack([c[lo:lo + g.tris] for c in planes9], -1).reshape(-1)
        head = [_bits(GROUP), _bits(g.tris), 1.0, float(g.motion), _bits(lo), *h.root_lower,
                *h.root_upper]
        recs.append(([*head, *tris], gi, GROUP))
        for i in g.prims:
            recs.append(([_bits(INSTANCE), _bits(i), *pr["start_p"][i], *pr["start_q"][i],
                          pr["start_s"][i], *pr["end_p"][i], *pr["end_q"][i], pr["end_s"][i]],
                         gi, INSTANCE))
        recs.append(([_bits(END)], gi, END))
    out, bounds, used, group = [], [0], 0, None
    for rec, gi, kind in recs:
        if used + len(rec) > CHUNK_FLOATS:
            bounds.append(sum(len(r) for r in out))
            used = 0
            if group is not None:  # the group goes on: its record again, not opening
                cont = list(group)
                cont[2] = 0.0
                out.append(cont)
                used += len(cont)
        out.append(rec)
        used += len(rec)
        if kind == GROUP:
            group = rec
        elif kind == END:
            group = None
    total = sum(len(r) for r in out)
    if total > bounds[-1]:
        bounds.append(total)
    table = np.asarray([x for r in out for x in r], np.float32) if out else np.zeros(0, np.float32)
    return table, np.asarray(bounds, np.int32)


def _key(scene, dev):
    objs = (scene.prim_static, scene.prims.start_p, scene.prims.start_q, scene.prims.start_s,
            scene.prims.end_p, scene.prims.end_q, scene.prims.end_s, scene.prims.radius,
            scene.prims.plane, *scene.pool.tri_planes)
    key = (str(dev),) + tuple((id(x), getattr(x, "_version", 0)) for x in objs)
    return key, objs


def table(scene, dev) -> SweepTable:
    """The scene's packed record table on ``dev``, packed at its first use
    and kept while the scene's tables are the same tensors, unchanged."""
    key, objs = _key(scene, dev)
    hit = _tables.get(key)
    if hit is not None:
        return hit[1]
    recs, bounds = pack_records(scene)
    sizes = np.diff(bounds)
    lay = _plain.layout(scene.prim_static)
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
        # table, chunk bounds, chunks, shared floats, origins, dirs, times
        # (or NULL), [tmax,] rays, threads, grid, out pointer(s), stream
        rays = [p, p, p, p] if kernel == "sweep_any" else [p, p, p]
        outs = [p] if kernel == "sweep_any" else [p, p, p]
        fn.argtypes = [p, p, i, i, *rays, i, i, i, *outs, p]
        fn.restype = i
        _entries[kernel] = fn
    return fn


def _launch(kernel: str, scene, origins, dirs, times, tmax, outs):
    r = origins.shape[0]
    dev = origins.device
    checks = [(origins, "origins", (r, 3)), (dirs, "dirs", (r, 3)), (times, "times", (r,))]
    for t, name, shape in checks + ([(tmax, "tmax", (r,))] if tmax is not None else []):
        _check(t, name, torch.float32, shape)
        if t.device != dev:
            raise ValueError(f"{kernel}: {name} on {t.device}, the rays on {dev}")
    if r == 0:
        return
    tab = table(scene, dev)
    grid = -(-r // THREADS)
    rays = [origins.data_ptr(), dirs.data_ptr(), times.data_ptr() if tab.motion else None]
    if tmax is not None:
        rays.append(tmax.data_ptr())
    args = (tab.table.data_ptr(), tab.chunks.data_ptr(), tab.n_chunks, tab.smem_floats, *rays,
            r, THREADS, grid, *(o.data_ptr() for o in outs))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index is None or dev.index == torch.cuda.current_device():
        err = _entry(kernel)(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = _entry(kernel)(*args, stream)
    if err != 0:
        what = "arguments rejected by the kernel" if err == 9001 else f"CUDA error {err}"
        raise RuntimeError(f"{kernel} kernel launch failed: {what} ({r} rays)")
    launch_counts[kernel] += 1


def sweep_closest_cuda(scene, origins, dirs, times):
    """Kernel K5c: (t, prim, tri) of each ray's closest sphere, plane or
    tiny-mesh hit, as ``accel/sweep.py::sweep_closest``."""
    r, dev = origins.shape[0], origins.device
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    prim = torch.empty((r,), dtype=torch.int32, device=dev)
    tri = torch.empty((r,), dtype=torch.int32, device=dev)
    _launch("sweep_closest", scene, origins, dirs, times, None, (t, prim, tri))
    return t, prim, tri


def sweep_any_cuda(scene, origins, dirs, times, tmax):
    """Kernel K5a: (R,) bool, some sphere, plane or tiny-mesh triangle hit
    with 0 < t < tmax, as ``accel/sweep.py::sweep_any``."""
    occ = torch.empty((origins.shape[0],), dtype=torch.bool, device=origins.device)
    _launch("sweep_any", scene, origins, dirs, times, tmax, (occ,))
    return occ


def _rays(origins, dirs, times):
    """Detached, contiguous rays; times broadcast to (R,)."""
    r = origins.shape[0]
    times = torch.broadcast_to(torch.as_tensor(times, dtype=torch.float32,
                                               device=origins.device), (r,))
    return origins.detach().contiguous(), dirs.detach().contiguous(), times.detach().contiguous()


def sweep_closest(scene, origins, dirs, times):
    """Closest sphere, plane or tiny-mesh hit of each ray, (t, prim, tri):
    kernel K5c on CUDA tensors, ``accel/sweep.py::sweep_closest`` on CPU
    tensors."""
    o, d, tm = _rays(origins, dirs, times)
    if _on_cpu(o):
        return _plain.sweep_closest(scene, o, d, tm)
    return sweep_closest_cuda(scene, o, d, tm)


def sweep_any(scene, origins, dirs, times, tmax):
    """Occlusion by a sphere, plane or tiny-mesh triangle with
    0 < t < tmax: kernel K5a on CUDA tensors, ``accel/sweep.py::sweep_any``
    on CPU tensors."""
    o, d, tm = _rays(origins, dirs, times)
    tmax = torch.broadcast_to(torch.as_tensor(tmax, dtype=torch.float32, device=o.device),
                              (o.shape[0],)).contiguous()
    if _on_cpu(o):
        return _plain.sweep_any(scene, o, d, tm, tmax)
    return sweep_any_cuda(scene, o, d, tm, tmax)
