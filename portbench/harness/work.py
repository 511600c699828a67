"""The peaks of the card and the work of the port's kernels, counted from
the algorithm and its inputs (copied from the repository's
``chip_smoke.py``, where they were first written): a kernel's roofline
share is its bound (the larger of its bytes at the HBM rate and its f32
operations at the f32 rate) over the device time it took."""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet: HBM rate and f32 rate outside the tensor
# cores, both at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# the walks (csrc/bvh.cu): bytes of a node row (72 f32) and a leaf block
# (192 f32), rays in (o, d, tmax: 28 B), per-lane offsets (8 B); f32
# operations of one child slab test and one two-sided Moller-Trumbore test
NODE_BYTES, BLOCK_BYTES, RAY_BYTES, OFFSET_BYTES = 288, 768, 28, 8
SLAB_OPS, TRI_OPS = 25, 59
# the sweep (csrc/sweep.cu): a sphere test and its merge, its centre and
# scale at the ray's time; a plane test and merge; an instance's local ray
# and root-box test, its transform interpolated; the winning triangle again
SPHERE_OPS, MOTION_SPHERE_OPS, PLANE_OPS = 37, 12, 21
INSTANCE_OPS, MOTION_INSTANCE_OPS, REFIT_OPS = 115, 37, 66
# the shortlist rounds (csrc/bvh.cu K6c / K6a): an instance record (24
# f32); a ray's bytes besides its origin and direction (24 B) and its time:
# K6c its best t in, (t f32, tri i32, inst i64) out; K6a its tmax and
# occlusion byte in, the byte out
INSTANCE_RECORD_BYTES, ROUNDS_CLOSEST_RAY, ROUNDS_ANY_RAY = 96, 4 + 16, 4 + 1 + 1


def bound_ms(work) -> float:
    """The least time the card could take for (bytes, f32 operations)."""
    nbytes, ops = work
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3


def sweep_work(lay, table_floats: int, stats: dict, closest: bool):
    """(bytes, f32 operations) of one K5c / K5a call, counted from the
    plain sweep on the same rays (``stats``): each ray's origin and
    direction in (its time where some row moves, its tmax for K5a), (t,
    prim, tri) or the occlusion byte out, the record table once; each
    test the plain version makes. ``lay``: the scene's sweep layout."""
    motion = lay.sphere_motion or any(g.motion for g in lay.groups)
    per_ray = 24 + (4 if motion else 0) + (12 if closest else 5)
    nbytes = stats["rays"] * per_ray + 4 * table_floats
    sphere = SPHERE_OPS + (MOTION_SPHERE_OPS if lay.sphere_motion else 0)
    ops = (stats.get("sphere_tests", 0) * sphere + stats.get("plane_tests", 0) * PLANE_OPS
           + stats.get("instance_tests", 0) * INSTANCE_OPS
           + stats.get("moving_instance_tests", 0) * (INSTANCE_OPS + MOTION_INSTANCE_OPS)
           + stats.get("tri_tests", 0) * TRI_OPS + stats.get("refits", 0) * REFIT_OPS)
    return nbytes, ops


def rounds_bound_ms(rays: int, instances: int, motion: bool, closest: bool) -> float:
    """The bound of one K6c / K6a launch (the shortlist rounds): the bytes
    that any implementation of the launch moves at the HBM rate. In: each
    ray's world origin and direction, its time where the batch moves, and
    its best t (K6c) or its tmax and occlusion byte (K6a); out: (t, tri,
    inst) or the occlusion byte; the instance table read once. No node, box
    or triangle test is counted, so the bound is the same work whatever
    algorithm walks the instances."""
    per_ray = 24 + (4 if motion else 0) + (ROUNDS_CLOSEST_RAY if closest else ROUNDS_ANY_RAY)
    return bound_ms((rays * per_ray + instances * INSTANCE_RECORD_BYTES, 0))


def bvh_work(stats, lanes: int, per_lane: bool, out_bytes: int, culled: int = 0):
    """(bytes, f32 operations) of one K3 / K4 walk, counted from the plain
    walk on the same inputs: each node row and leaf block it reads, read
    once, each lane's ray (and offsets) in and result out; 16 slab tests a
    node arrival, 16 triangle tests a block test. ``culled`` lanes (tmax
    <= 0 or NaN) count their tmax read and their result written, and
    ``stats`` holds the walk of the other lanes."""
    lane = ((lanes - culled) * (RAY_BYTES + (OFFSET_BYTES if per_lane else 0) + out_bytes)
            + culled * (4 + out_bytes))
    nbytes = (int(stats["node_rows"].sum()) * NODE_BYTES
              + int(stats["block_rows"].sum()) * BLOCK_BYTES + lane)
    ops = 16 * (stats["visits"] * SLAB_OPS + stats["blocks"] * TRI_OPS)
    return nbytes, ops


def walk_bound_ms(plain_walk, args, out_bytes: int) -> float:
    """The bound of one walk on its own arguments (pool, node offsets, tri
    offsets, origins, dirs, tmax, stack slots), its live lanes walked by
    ``plain_walk`` to count the rows and tests."""
    pool, noff, toff, o, d, tmax, slots = args
    per_lane = torch.is_tensor(noff)
    lanes = o.shape[0]
    live = tmax > 0
    culled = lanes - int(live.sum())
    stats = {}
    if culled < lanes:
        sel = (lambda x: x[live]) if culled else (lambda x: x)
        noff_l, toff_l = (sel(x) if torch.is_tensor(x) else x for x in (noff, toff))
        plain_walk(pool, noff_l, toff_l, sel(o), sel(d), sel(tmax), stack_slots=slots,
                   stats=stats)
    if "node_rows" not in stats:  # no live lane: nothing walked
        stats = dict(visits=0, blocks=0, node_rows=torch.zeros(1, dtype=torch.bool),
                     block_rows=torch.zeros(1, dtype=torch.bool))
    return bound_ms(bvh_work(stats, lanes, per_lane, out_bytes, culled))
