"""The instance shortlist rounds as CUDA kernels, and their dispatchers.

``rounds_closest`` (kernel K6c, ``csrc/bvh.cu``) and ``rounds_any`` (K6a,
same source) replace the JAX package's ``jax.lax.while_loop`` of rounds
around its walks, ``tinsel_tpu/render/trace.py:267 _instance_rounds`` and
``:330 _instance_rounds_any`` (with ``:251 _shortlist_candidates``), and
the inputs it builds for them per (instance, ray) pair: the local rays
(``:434-436``) and the root-box entries (``:216 _instance_box_entry``).
Neither was Pallas there.

Each kernel runs every round of one call in one launch with no host
sync, from the world rays and the scene's instance table (``table``,
packed by ``pack_instances``): one 16-lane group per ray, with K3's launch
geometry (``ops/bvh.py::launch_geometry``), its shared-memory stacks and
its walk. Each lane takes the ray into the frames of its own instances
and tests their root boxes, keeps those entries in registers, and the
group picks the next instance in (entry, id) order. It gives exactly what
the plain rounds give (``accel/instances.py::rounds_closest_world`` /
``rounds_any_world``): every lane equal, t bit for bit (``bvh.cu`` is
built with ``-fmad=false``); ``csrc/bvh.cu``'s K6 note says why.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises. The rounds return discrete winners and have no gradient:
``render/trace.py`` intersects the winner again under autograd.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..accel import instances as _plain
from ..accel.build import BLOCK_SIZE, NODE_ROW_WIDTH
from ..accel.sweep import layout
from . import _build
from .bvh import _check_layout, _invoke, _on_cpu, launch_geometry

# Launches per kernel since the last reset; a wrapper adds one where it
# launches its kernel and nowhere else.
launch_counts = {"rounds_closest": 0, "rounds_any": 0}

RECORD_FLOATS = 24  # floats of an instance record (csrc/bvh.cu's record())
TABLES_KEPT = 8  # instance tables cached (scene, device, hoist)

_entries: dict = {}
_tables: dict = {}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


@dataclasses.dataclass(frozen=True)
class InstanceTable:
    """A scene's big-mesh primitives as the shortlist rounds take them, on
    one device, for one ``STATIC_TRANSFORM_HOIST`` setting."""

    table: torch.Tensor  # (I, RECORD_FLOATS) f32 records (pack_instances)
    prims: tuple  # the instances' primitive ids, in batch order
    prim_ids: torch.Tensor  # the same (I,) int64, on the table's device
    motion: bool  # every instance takes its transform at the ray's time
    slots: int  # the batch's stack bound

    # views of the records: the root boxes in each mesh's frame, (I, 3)
    # f32; the node and triangle offsets, (I,) int32
    @property
    def lower(self):
        return self.table[:, 16:19]

    @property
    def upper(self):
        return self.table[:, 20:23]

    @property
    def noff(self):
        return self.table.view(torch.int32)[:, 19]

    @property
    def toff(self):
        return self.table.view(torch.int32)[:, 23]


def pack_instances(scene, hoist: bool = True):
    """The records of the scene's big-mesh primitives (``accel/sweep.py::
    layout(...).big``, in that order): ((I, RECORD_FLOATS) f32 array,
    prims, motion). A record is six float4s:

        [0:3] start p, [3] start s, [4:8] start q,
        [8:11] end p - start p, [11] end s - start s, [12:16] end q - start q,
        [16:19] root lower, [19] node offset, [20:23] root upper,
        [23] triangle offset

    the offsets as int32 bits, the differences taken here in f32 (the
    bits of the plain version's ``b - a``). ``motion``: the batch rule of
    ``render/trace.py::_prim_transforms_batched``, every instance
    interpolated at the ray's time when the hoist is off or some instance
    of the batch moves, else each at its start transform."""
    prims = layout(scene.prim_static, hoist).big
    pr = scene.prims
    sel = np.asarray(prims, np.int64)

    def rows(x, cols):
        return x.detach().cpu().numpy().astype(np.float32).reshape(-1, cols)[sel]

    sp, sq, ss = rows(pr.start_p, 3), rows(pr.start_q, 4), rows(pr.start_s, 1)
    ep, eq, es = rows(pr.end_p, 3), rows(pr.end_q, 4), rows(pr.end_s, 1)
    handles = [scene.prim_static[i].mesh for i in prims]
    rec = np.zeros((len(prims), RECORD_FLOATS), np.float32)
    rec[:, 0:3], rec[:, 3:4], rec[:, 4:8] = sp, ss, sq
    rec[:, 8:11], rec[:, 11:12], rec[:, 12:16] = ep - sp, es - ss, eq - sq
    rec[:, 16:19] = [h.root_lower for h in handles]
    rec[:, 20:23] = [h.root_upper for h in handles]
    ints = rec.view(np.int32)
    ints[:, 19] = [h.node_offset for h in handles]
    ints[:, 23] = [h.tri_offset for h in handles]
    motion = bool(prims) and (not hoist or any(scene.prim_static[i].motion for i in prims))
    return rec, prims, motion


def _key(scene, dev, hoist: bool):
    pr = scene.prims
    objs = (scene.prim_static, pr.start_p, pr.start_q, pr.start_s, pr.end_p, pr.end_q, pr.end_s)
    return (str(dev), hoist) + tuple((id(x), getattr(x, "_version", 0)) for x in objs), objs


def table(scene, dev, hoist: bool = True) -> InstanceTable:
    """The scene's instance table on ``dev`` for the hoist setting
    ``hoist`` (``pack_instances``), packed on the host at its first use
    and kept while the scene's tables are the same tensors, unchanged."""
    key, objs = _key(scene, dev, hoist)
    hit = _tables.get(key)
    if hit is not None:
        return hit[1]
    rec, prims, motion = pack_instances(scene, hoist)
    slots = max((scene.prim_static[i].mesh.stack_slots for i in prims), default=1)
    tab = InstanceTable(table=torch.from_numpy(rec).to(dev), prims=tuple(prims),
                        prim_ids=torch.tensor(prims, dtype=torch.long, device=dev),
                        motion=motion, slots=slots)
    if len(_tables) >= TABLES_KEPT:
        _tables.pop(next(iter(_tables)))
    _tables[key] = (objs, tab)  # holding objs keeps their ids unique
    return tab


def kept_entries(n_inst: int) -> int:
    """Entries a lane of the kernels keeps in registers for ``n_inst``
    instances (16 lanes a ray): the least of 1, 2, 4, 8 that covers them;
    0 above 128 (a lane computes each again where it is scanned)."""
    return next((k for k in (1, 2, 4, 8) if n_inst <= 16 * k), 0)


def _entry(kernel: str):
    fn = _entries.get(kernel)
    if fn is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = getattr(_build.load("bvh"), f"tinsel_bvh_{kernel}")
        # node_rows, block_rows, table, origins, dirs, times (or NULL),
        # best t (K6c) or tmax and occ0 (K6a), instances, kept entries,
        # rays, [top k,] stack slots, threads, rays per block, shared
        # bytes, grid, out pointers, stream
        if kernel == "rounds_closest":
            fn.argtypes = [p] * 7 + [i] * 9 + [p, p, p, p]
        else:
            fn.argtypes = [p] * 8 + [i] * 8 + [p, p]
        fn.restype = i
        _entries[kernel] = fn
    return fn


def _check_args(scene, tab, origins, dirs, times, per_ray):
    """The arguments both kernels take; per_ray: [(name, tensor, dtype)]
    of (R,) tensors. Every dtype, shape and contiguity, the stack slots and
    the sizes are checked before any device, so that each check can be
    reached with CPU tensors. Returns the launch geometry."""
    if origins.dim() != 2:
        raise ValueError(f"origins: expected shape (R, 3), got {tuple(origins.shape)}")
    r = origins.shape[0]
    pool = scene.pool
    n_inst = len(tab.prims)
    n_nodes, n_blocks = pool.node_rows.shape[0], pool.block_rows.shape[0]
    tensors = [("origins", origins, torch.float32, (r, 3)),
               ("dirs", dirs, torch.float32, (r, 3)),
               ("times", times, torch.float32, (r,)),
               *((name, t, dtype, (r,)) for name, t, dtype in per_ray),
               ("table", tab.table, torch.float32, (n_inst, RECORD_FLOATS)),
               ("node_rows", pool.node_rows, torch.float32, (n_nodes, NODE_ROW_WIDTH)),
               ("block_rows", pool.block_rows, torch.float32, (n_blocks, 12 * BLOCK_SIZE))]
    for name, t, dtype, shape in tensors:
        _check_layout(t, name, dtype, shape)
    geo = launch_geometry(r, int(tab.slots))
    if n_inst < 1:
        raise ValueError("the rounds need at least one instance")
    if max(n_nodes * NODE_ROW_WIDTH, n_blocks * 12 * BLOCK_SIZE) >= 2**32:
        raise ValueError(f"the kernel addresses rows by 32-bit float offsets; {n_nodes} node "
                         f"rows and {n_blocks} blocks are too many")
    if r >= 2**31:
        raise ValueError(f"{r} rays: the kernel indexes rays by a 32-bit int")
    dev = origins.device
    for name, t, _, _ in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, the rays on {dev}")
    return geo


def _run(kernel: str, args, outs, dev, rays: int):
    _invoke(_entry(kernel), (*args, *(o.data_ptr() for o in outs)), dev,
            f"bvh_{kernel} ({rays} rays)")
    launch_counts[kernel] += 1


def _scene_args(scene, tab, origins, dirs, times):
    """The pointers both kernels take first: rows, records, rays and the
    rays' times (NULL where the batch does not move)."""
    return (scene.pool.node_rows.data_ptr(), scene.pool.block_rows.data_ptr(),
            tab.table.data_ptr(), origins.data_ptr(), dirs.data_ptr(),
            times.data_ptr() if tab.motion else None)


def rounds_closest_cuda(scene, tab, origins, dirs, times, best_t0):
    """Kernel K6c: (t f32, tri i32, inst i64) per ray, as
    ``accel/instances.py::rounds_closest_world``."""
    geo = _check_args(scene, tab, origins, dirs, times, [("best_t0", best_t0, torch.float32)])
    r, dev = origins.shape[0], origins.device
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    tri = torch.empty((r,), dtype=torch.int32, device=dev)
    inst = torch.empty((r,), dtype=torch.long, device=dev)
    if geo.grid:
        n_inst = len(tab.prims)
        args = (*_scene_args(scene, tab, origins, dirs, times), best_t0.data_ptr(), n_inst,
                kept_entries(n_inst), r, _plain.INSTANCE_TOPK, int(tab.slots), geo.threads,
                geo.rays_per_block, geo.smem_bytes, geo.grid)
        _run("rounds_closest", args, (t, tri, inst), dev, r)
    return t, tri, inst


def rounds_any_cuda(scene, tab, origins, dirs, times, tmax, occ):
    """Kernel K6a: (R,) bool, as ``accel/instances.py::rounds_any_world``."""
    geo = _check_args(scene, tab, origins, dirs, times,
                      [("tmax", tmax, torch.float32), ("occ", occ, torch.bool)])
    r, dev = origins.shape[0], origins.device
    out = torch.empty((r,), dtype=torch.bool, device=dev)
    if geo.grid:
        n_inst = len(tab.prims)
        args = (*_scene_args(scene, tab, origins, dirs, times), tmax.data_ptr(), occ.data_ptr(),
                n_inst, kept_entries(n_inst), r, int(tab.slots), geo.threads,
                geo.rays_per_block, geo.smem_bytes, geo.grid)
        _run("rounds_any", args, (out,), dev, r)
    return out


def rounds_closest(scene, tab, origins, dirs, times, best_t0):
    """The shortlist rounds, closest hit: kernel K6c on CUDA tensors,
    ``accel/instances.py::rounds_closest_world`` on CPU tensors. tab: the
    scene's ``InstanceTable``; origins / dirs (R, 3), times and best_t0
    (R,) f32, world space. Returns (t, tri, inst)."""
    if _on_cpu(origins):
        return _plain.rounds_closest_world(scene, tab, origins, dirs, times, best_t0)
    return rounds_closest_cuda(scene, tab, origins, dirs, times, best_t0)


def rounds_any(scene, tab, origins, dirs, times, tmax, occ):
    """The shortlist rounds, occlusion: kernel K6a on CUDA tensors,
    ``accel/instances.py::rounds_any_world`` on CPU tensors. tmax (R,) f32
    (0 where already occluded), occ (R,) bool. Returns (R,) bool."""
    if _on_cpu(origins):
        return _plain.rounds_any_world(scene, tab, origins, dirs, times, tmax, occ)
    return rounds_any_cuda(scene, tab, origins, dirs, times, tmax, occ)
