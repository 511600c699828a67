"""CUDA wide-BVH walk kernels and their dispatchers.

``closest_hit`` (kernel K3, ``csrc/bvh.cu``) replaces the JAX package's
pure-JAX walk ``tinsel_tpu/accel/traverse.py:761 intersect_mesh``
(``_run_tiled`` / ``_traverse_tile`` / ``_step``); ``any_hit`` (K4, same
source) replaces ``:903 intersect_mesh_any`` (``_traverse_tile_any``).
Neither was Pallas in the JAX package: Mosaic has no per-lane gather from
a large table, which a card does at every load.

Bound and design: the work is a data-dependent chain of dependent loads
(a node row, then the leaf blocks it points to), so a walk is bounded by
memory latency more than by bytes or operations. This first kernel is the
simple one: one thread per lane, a per-thread compressed stack in local
memory, node rows and blocks read through the read-only cache. Making it
fast (rows in shared memory, warp-coherent or persistent walks, ray
sorting) is later work.

A CPU tensor runs the plain version (``accel/traverse.py``); a CUDA tensor
launches the kernel or raises. The walks return discrete winners and have
no gradient: the caller re-intersects the winning triangle with torch ops.
"""

from __future__ import annotations

import ctypes

import torch

from ..accel import traverse as _plain
from ..accel.build import BLOCK_SIZE, NODE_ROW_WIDTH
from ..accel.traverse import MAX_STACK_SLOTS
from . import _build

# Launches per kernel since the last reset; a wrapper adds one where it
# launches its kernel and nowhere else.
launch_counts = {"bvh_closest": 0, "bvh_any": 0}
# lanes, threads per block and blocks of each kernel's latest launch
last_geometry: dict = {}
THREADS = 128

_entries: dict = {}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def _entry(kernel: str):
    fn = _entries.get(kernel)
    if fn is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = getattr(_build.load("bvh"), f"tinsel_{kernel}")
        # node_rows, block_rows, origins, dirs, tmax, node offsets (or
        # NULL), tri offsets (or NULL), the scalar offsets, lanes, stack
        # slots, threads, out pointer(s), stream
        outs = [p, p] if kernel == "bvh_closest" else [p]
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, *outs, p]
        fn.restype = i
        _entries[kernel] = fn
    return fn


def _check(t: torch.Tensor, name: str, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _offset(x, r: int, dev, name: str):
    """(pointer or 0, scalar) of a scalar or per-lane (R,) offset."""
    if isinstance(x, torch.Tensor) and x.dim() == 1:
        _check(x, name, torch.int32, (r,))
        if x.device != dev:
            raise ValueError(f"{name}: on {x.device}, the rays on {dev}")
        return x.data_ptr(), 0
    return 0, int(x)


def _launch(kernel: str, pool, node_offset, tri_offset, origins, dirs, tmax,
            stack_slots: int, outs):
    r = origins.shape[0]
    dev = origins.device
    n_nodes, n_blocks = pool.node_rows.shape[0], pool.block_rows.shape[0]
    _check(pool.node_rows, "node_rows", torch.float32, (n_nodes, NODE_ROW_WIDTH))
    _check(pool.block_rows, "block_rows", torch.float32, (n_blocks, 12 * BLOCK_SIZE))
    _check(origins, "origins", torch.float32, (r, 3))
    _check(dirs, "dirs", torch.float32, (r, 3))
    _check(tmax, "tmax", torch.float32, (r,))
    for t in (pool.node_rows, pool.block_rows, *outs):
        if t.device != dev:
            raise ValueError(f"{kernel}: tensors on {t.device} and {dev}")
    if not 1 <= stack_slots <= MAX_STACK_SLOTS:
        raise ValueError(f"stack_slots must be in [1, {MAX_STACK_SLOTS}], got {stack_slots}")
    noff_p, noff = _offset(node_offset, r, dev, "node_offset")
    toff_p, toff = _offset(tri_offset, r, dev, "tri_offset")
    if r == 0:
        return
    args = (
        pool.node_rows.data_ptr(), pool.block_rows.data_ptr(),
        origins.data_ptr(), dirs.data_ptr(), tmax.data_ptr(), noff_p, toff_p,
        noff, toff, r, int(stack_slots), THREADS, *(o.data_ptr() for o in outs),
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index is None or dev.index == torch.cuda.current_device():
        err = _entry(kernel)(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = _entry(kernel)(*args, stream)
    if err != 0:
        what = "arguments rejected by the kernel" if err == 9001 else f"CUDA error {err}"
        raise RuntimeError(f"{kernel} kernel launch failed: {what} ({r} lanes)")
    launch_counts[kernel] += 1
    last_geometry[kernel] = dict(lanes=r, threads=THREADS, blocks=-(-r // THREADS))


def closest_hit_cuda(pool, node_offset, tri_offset, origins, dirs, tmax,
                     stack_slots: int):
    """Kernel K3: (t, tri_local) of the closest hit per lane, t = +inf and
    tri_local = -1 on a miss."""
    r = origins.shape[0]
    t = torch.empty((r,), dtype=torch.float32, device=origins.device)
    tri = torch.empty((r,), dtype=torch.int32, device=origins.device)
    _launch("bvh_closest", pool, node_offset, tri_offset, origins, dirs, tmax,
            stack_slots, (t, tri))
    return t, tri


def any_hit_cuda(pool, node_offset, tri_offset, origins, dirs, tmax,
                 stack_slots: int):
    """Kernel K4: (R,) bool, some triangle hit with t < tmax."""
    occ = torch.empty((origins.shape[0],), dtype=torch.bool, device=origins.device)
    _launch("bvh_any", pool, node_offset, tri_offset, origins, dirs, tmax,
            stack_slots, (occ,))
    return occ


def _on_cpu(origins) -> bool:
    if origins.device.type == "cpu":
        return True
    if origins.device.type == "cuda":
        return False
    raise ValueError(f"rays must lie on the CPU or on CUDA, got {origins.device}")


def closest_hit(pool, node_offset, tri_offset, origins, dirs, tmax,
                stack_slots: int = _plain.DEFAULT_STACK_SLOTS):
    """Closest hit against one mesh sub-BVH per lane: kernel K3 on CUDA
    tensors, ``accel/traverse.py::intersect_mesh`` on CPU tensors. Offsets
    are ints or (R,) int32 tensors."""
    if _on_cpu(origins):
        return _plain.intersect_mesh(pool, node_offset, tri_offset, origins, dirs, tmax,
                                     stack_slots=stack_slots)
    return closest_hit_cuda(pool, node_offset, tri_offset, origins, dirs, tmax, stack_slots)


def any_hit(pool, node_offset, tri_offset, origins, dirs, tmax,
            stack_slots: int = _plain.DEFAULT_STACK_SLOTS):
    """Occlusion against one mesh sub-BVH per lane: kernel K4 on CUDA
    tensors, ``accel/traverse.py::intersect_mesh_any`` on CPU tensors."""
    if _on_cpu(origins):
        return _plain.intersect_mesh_any(pool, node_offset, tri_offset, origins, dirs,
                                         tmax, stack_slots=stack_slots)
    return any_hit_cuda(pool, node_offset, tri_offset, origins, dirs, tmax, stack_slots)
