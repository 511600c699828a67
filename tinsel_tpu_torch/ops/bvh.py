"""CUDA wide-BVH walk kernels and their dispatchers.

``closest_hit`` (kernel K3, ``csrc/bvh.cu``) replaces the JAX package's
pure-JAX walk ``tinsel_tpu/accel/traverse.py:761 intersect_mesh``
(``_run_tiled :635`` / ``_traverse_tile :491`` / ``_step :390``);
``any_hit`` (K4, same source) replaces ``:903 intersect_mesh_any``
(``_traverse_tile_any :811``); ``traversal_steps`` (K7, same source, the
same walk counting its steps) replaces ``:963 traversal_cost``. None was
Pallas in the JAX package: Mosaic has no per-lane gather from a large
table, which a card does at every load.

Bound and design: the work is a data-dependent chain of dependent loads
(a node row, then the leaf blocks it points to), so a walk is bounded by
the latency of each load and the number of walks in flight, not by bytes
or operations. The kernels give each ray a half-warp: lane c holds child
slot c of the node and triangle c of the leaf block, so a node row or a
block arrives in one round trip of coalesced 64-byte runs and the 16
triangle tests run at once; the per-ray stack lives in shared memory.
``csrc/bvh.cu``'s note gives the design and why it equals the plain walk
bit for bit.

A CPU tensor runs the plain version (``accel/traverse.py``); a CUDA tensor
launches the kernel or raises. The walks return discrete winners and have
no gradient: the caller re-intersects the winning triangle with torch ops.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..accel import traverse as _plain
from ..accel.build import BLOCK_SIZE, NODE_ROW_WIDTH
from ..accel.traverse import MAX_STACK_SLOTS
from . import _build

# Launches per kernel since the last reset; a wrapper adds one where it
# launches its kernel and nowhere else.
launch_counts = {"bvh_closest": 0, "bvh_any": 0, "bvh_steps": 0}
# lanes and launch geometry of each kernel's latest launch
last_geometry: dict = {}
GROUP = 16  # lanes per ray: one per child slot and per triangle slot
THREADS = 128  # threads per block

_entries: dict = {}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


@dataclasses.dataclass(frozen=True)
class Geometry:
    threads: int  # threads per block
    rays_per_block: int
    smem_bytes: int  # dynamic shared memory: the rays' stacks
    grid: int  # blocks; 0 for no lanes (no launch)


def launch_geometry(lanes: int, slots: int) -> Geometry:
    """Launch geometry of K3/K4/K7 for ``lanes`` rays with ``slots`` stack
    entries each: a 16-lane group per ray, 128-thread blocks, a 4-byte
    shared-memory stack entry per slot and ray, one block per 8 rays."""
    if lanes < 0:
        raise ValueError(f"lanes must be >= 0, got {lanes}")
    if not 1 <= slots <= MAX_STACK_SLOTS:
        raise ValueError(f"stack_slots must be in [1, {MAX_STACK_SLOTS}], got {slots}")
    rays = THREADS // GROUP
    return Geometry(THREADS, rays, rays * slots * 4, -(-lanes // rays))


def _entry(kernel: str):
    fn = _entries.get(kernel)
    if fn is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = getattr(_build.load("bvh"), f"tinsel_{kernel}")
        # node_rows, block_rows, origins, dirs, tmax (not K7's), node
        # offsets (or NULL), tri offsets (or NULL), the scalar offsets,
        # lanes, stack slots, threads, rays per block, shared bytes, grid,
        # out pointer(s), stream
        rays = [p, p, p, p] if kernel == "bvh_steps" else [p, p, p, p, p]
        outs = [p, p] if kernel == "bvh_closest" else [p]
        fn.argtypes = [*rays, p, p, i, i, i, i, i, i, i, i, *outs, p]
        fn.restype = i
        _entries[kernel] = fn
    return fn


def _check_layout(t: torch.Tensor, name: str, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _check(t: torch.Tensor, name: str, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    _check_layout(t, name, dtype, shape)


def _invoke(fn, args, dev, what: str):
    """Call a kernel's C entry ``fn(*args, stream)`` on ``dev``'s current
    stream; raise on the error code it returns."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index is None or dev.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, stream)
    if err != 0:
        reason = "arguments rejected by the kernel" if err == 9001 else f"CUDA error {err}"
        raise RuntimeError(f"{what} kernel launch failed: {reason}")


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
    if tmax is not None:
        _check(tmax, "tmax", torch.float32, (r,))
    for t in (pool.node_rows, pool.block_rows, *outs):
        if t.device != dev:
            raise ValueError(f"{kernel}: tensors on {t.device} and {dev}")
    if max(n_nodes * NODE_ROW_WIDTH, n_blocks * 12 * BLOCK_SIZE) >= 2**32:
        raise ValueError(f"{kernel}: the kernel addresses rows by 32-bit float offsets; "
                         f"{n_nodes} node rows and {n_blocks} blocks are too many")
    geo = launch_geometry(r, int(stack_slots))
    noff_p, noff = _offset(node_offset, r, dev, "node_offset")
    toff_p, toff = _offset(tri_offset, r, dev, "tri_offset")
    if geo.grid == 0:
        return
    rays = (origins.data_ptr(), dirs.data_ptr())
    if tmax is not None:
        rays += (tmax.data_ptr(),)
    args = (
        pool.node_rows.data_ptr(), pool.block_rows.data_ptr(), *rays, noff_p, toff_p,
        noff, toff, r, int(stack_slots), geo.threads, geo.rays_per_block,
        geo.smem_bytes, geo.grid, *(o.data_ptr() for o in outs),
    )
    _invoke(_entry(kernel), args, dev, f"{kernel} ({r} lanes)")
    launch_counts[kernel] += 1
    last_geometry[kernel] = dict(lanes=r, **dataclasses.asdict(geo))


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


def traversal_steps_cuda(pool, node_offset, tri_offset, origins, dirs, stack_slots: int):
    """Kernel K7: (R,) f32 step count of each lane's closest-hit walk with
    tmax = +inf (node arrivals plus leaf blocks tested)."""
    steps = torch.empty((origins.shape[0],), dtype=torch.float32, device=origins.device)
    _launch("bvh_steps", pool, node_offset, tri_offset, origins, dirs, None,
            stack_slots, (steps,))
    return steps


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


def traversal_steps(pool, node_offset, tri_offset, origins, dirs,
                    stack_slots: int = _plain.DEFAULT_STACK_SLOTS):
    """Step count of each lane's unbounded closest-hit walk: kernel K7 on
    CUDA tensors, ``accel/traverse.py::traversal_cost`` with tmax = +inf on
    CPU tensors. Offsets are ints or (R,) int32 tensors."""
    if _on_cpu(origins):
        tmax = torch.full((origins.shape[0],), float("inf"))
        return _plain.traversal_cost(pool, node_offset, tri_offset, origins, dirs, tmax,
                                     stack_slots=stack_slots)
    return traversal_steps_cuda(pool, node_offset, tri_offset, origins, dirs, stack_slots)
