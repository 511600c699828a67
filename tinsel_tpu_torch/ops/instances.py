"""The instance shortlist rounds as CUDA kernels, and their dispatchers.

``rounds_closest`` (kernel K6c, ``csrc/bvh.cu``) and ``rounds_any`` (K6a,
same source) replace the JAX package's ``jax.lax.while_loop`` of rounds
around its walks, ``tinsel_tpu/render/trace.py:267 _instance_rounds`` and
``:330 _instance_rounds_any`` (with ``:251 _shortlist_candidates``).
Neither was Pallas there.

Each kernel runs every round of one call in one launch with no host
sync: one 16-lane group per ray, with K3's launch geometry
(``ops/bvh.py::launch_geometry``), its shared-memory stacks and its walk,
picking each ray's next instance in (entry, id) order from the (I, R)
box-entry table. It gives exactly what the plain rounds give
(``accel/instances.py``): every lane equal, t bit for bit (``bvh.cu`` is
built with ``-fmad=false``); ``csrc/bvh.cu``'s K6 note says why.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises. The rounds return discrete winners and have no gradient:
``render/trace.py`` intersects the winner again under autograd.
"""

from __future__ import annotations

import ctypes

import torch

from ..accel import instances as _plain
from ..accel.build import BLOCK_SIZE, NODE_ROW_WIDTH
from . import _build
from .bvh import _check_layout, _invoke, _on_cpu, launch_geometry

# Launches per kernel since the last reset; a wrapper adds one where it
# launches its kernel and nowhere else.
launch_counts = {"rounds_closest": 0, "rounds_any": 0}

_entries: dict = {}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def _entry(kernel: str):
    fn = _entries.get(kernel)
    if fn is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = getattr(_build.load("bvh"), f"tinsel_bvh_{kernel}")
        # node_rows, block_rows, o_l, d_l, tn, best t (K6c) or tmax and
        # occ0 (K6a), node offsets, tri offsets, instances, rays, [top k,]
        # stack slots, threads, rays per block, shared bytes, grid, out
        # pointers, stream
        if kernel == "rounds_closest":
            fn.argtypes = [p] * 8 + [i] * 8 + [p, p, p, p]
        else:
            fn.argtypes = [p] * 9 + [i] * 7 + [p, p]
        fn.restype = i
        _entries[kernel] = fn
    return fn


def _check_args(pool, o_l, d_l, tn, per_ray, noff, toff, stack_slots: int):
    """The arguments both kernels take; per_ray: [(name, tensor, dtype)]
    of (R,) tensors. Every dtype, shape and contiguity, the stack slots and
    the pool's size are checked before any device, so that each check can
    be reached with CPU tensors. Returns the launch geometry."""
    if o_l.dim() != 3:
        raise ValueError(f"o_l: expected shape (I, R, 3), got {tuple(o_l.shape)}")
    n_inst, r = o_l.shape[:2]
    n_nodes, n_blocks = pool.node_rows.shape[0], pool.block_rows.shape[0]
    tensors = [("o_l", o_l, torch.float32, (n_inst, r, 3)),
               ("d_l", d_l, torch.float32, (n_inst, r, 3)),
               ("tn", tn, torch.float32, (n_inst, r)),
               *((name, t, dtype, (r,)) for name, t, dtype in per_ray),
               ("noff", noff, torch.int32, (n_inst,)), ("toff", toff, torch.int32, (n_inst,)),
               ("node_rows", pool.node_rows, torch.float32, (n_nodes, NODE_ROW_WIDTH)),
               ("block_rows", pool.block_rows, torch.float32, (n_blocks, 12 * BLOCK_SIZE))]
    for name, t, dtype, shape in tensors:
        _check_layout(t, name, dtype, shape)
    geo = launch_geometry(r, int(stack_slots))
    if n_inst < 1:
        raise ValueError("the rounds need at least one instance")
    if max(n_nodes * NODE_ROW_WIDTH, n_blocks * 12 * BLOCK_SIZE) >= 2**32:
        raise ValueError(f"the kernel addresses rows by 32-bit float offsets; {n_nodes} node "
                         f"rows and {n_blocks} blocks are too many")
    if r >= 2**31:
        raise ValueError(f"{r} rays: the kernel indexes rays by a 32-bit int")
    dev = o_l.device
    for name, t, _, _ in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, the local rays on {dev}")
    return geo


def _run(kernel: str, args, outs, dev, rays: int):
    _invoke(_entry(kernel), (*args, *(o.data_ptr() for o in outs)), dev,
            f"bvh_{kernel} ({rays} rays)")
    launch_counts[kernel] += 1


def rounds_closest_cuda(scene, o_l, d_l, tn, best_t0, noff, toff, stack_slots: int):
    """Kernel K6c: (t f32, tri i32, inst i64) per ray, as
    ``accel/instances.py::rounds_closest``."""
    pool = scene.pool
    geo = _check_args(pool, o_l, d_l, tn, [("best_t0", best_t0, torch.float32)], noff, toff,
                      stack_slots)
    n_inst, r = o_l.shape[:2]
    dev = o_l.device
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    tri = torch.empty((r,), dtype=torch.int32, device=dev)
    inst = torch.empty((r,), dtype=torch.long, device=dev)
    if geo.grid:
        args = (pool.node_rows.data_ptr(), pool.block_rows.data_ptr(), o_l.data_ptr(),
                d_l.data_ptr(), tn.data_ptr(), best_t0.data_ptr(), noff.data_ptr(),
                toff.data_ptr(), n_inst, r, _plain.INSTANCE_TOPK, int(stack_slots),
                geo.threads, geo.rays_per_block, geo.smem_bytes, geo.grid)
        _run("rounds_closest", args, (t, tri, inst), dev, r)
    return t, tri, inst


def rounds_any_cuda(scene, o_l, d_l, tn, tmax, occ, noff, toff, stack_slots: int):
    """Kernel K6a: (R,) bool, as ``accel/instances.py::rounds_any``."""
    pool = scene.pool
    geo = _check_args(pool, o_l, d_l, tn, [("tmax", tmax, torch.float32),
                                           ("occ", occ, torch.bool)], noff, toff, stack_slots)
    n_inst, r = o_l.shape[:2]
    dev = o_l.device
    out = torch.empty((r,), dtype=torch.bool, device=dev)
    if geo.grid:
        args = (pool.node_rows.data_ptr(), pool.block_rows.data_ptr(), o_l.data_ptr(),
                d_l.data_ptr(), tn.data_ptr(), tmax.data_ptr(), occ.data_ptr(),
                noff.data_ptr(), toff.data_ptr(), n_inst, r, int(stack_slots),
                geo.threads, geo.rays_per_block, geo.smem_bytes, geo.grid)
        _run("rounds_any", args, (out,), dev, r)
    return out


def rounds_closest(scene, o_l, d_l, tn, best_t0, noff, toff, stack_slots: int):
    """The shortlist rounds, closest hit: kernel K6c on CUDA tensors,
    ``accel/instances.py::rounds_closest`` on CPU tensors. o_l/d_l (I, R,
    3) local rays, tn (I, R) box entries (+inf = culled), best_t0 (R,),
    noff/toff (I,) int32. Returns (t, tri, inst)."""
    if _on_cpu(o_l):
        return _plain.rounds_closest(scene, o_l, d_l, tn, best_t0, noff, toff, stack_slots)
    return rounds_closest_cuda(scene, o_l, d_l, tn, best_t0, noff, toff, stack_slots)


def rounds_any(scene, o_l, d_l, tn, tmax, occ, noff, toff, stack_slots: int):
    """The shortlist rounds, occlusion: kernel K6a on CUDA tensors,
    ``accel/instances.py::rounds_any`` on CPU tensors. tmax (R,) f32 (0
    where already occluded), occ (R,) bool. Returns (R,) bool."""
    if _on_cpu(o_l):
        return _plain.rounds_any(scene, o_l, d_l, tn, tmax, occ, noff, toff, stack_slots)
    return rounds_any_cuda(scene, o_l, d_l, tn, tmax, occ, noff, toff, stack_slots)
