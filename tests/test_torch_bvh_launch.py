"""Launch geometry of the CUDA BVH walks (``ops/bvh.py::launch_geometry``,
shared by K3, K4 and the step count K7) and the premises of their early
exit and of K7's count, checked on the CPU. The kernels themselves run in
tests/test_torch_bvh_cuda.py on the card."""

import numpy as np
import pytest
import torch

from test_torch_bvh_cuda import _per_lane, _pool, _rays
from tinsel_tpu_torch.accel import traverse as plain
from tinsel_tpu_torch.ops import bvh as ops

LANES = [0, 1, 7, 8, 9, 15, 16, 17, 127, 128, 129, 4099, 65536, 262144, 1048575,
         1048576, 4194303, 4194304]


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("slots", [1, 2, 6, 48, 128])
def test_grid_covers_every_lane(lanes, slots):
    g = ops.launch_geometry(lanes, slots)
    assert g.grid * g.rays_per_block >= lanes
    assert (g.grid - 1) * g.rays_per_block < lanes or g.grid == 0
    assert (g.grid == 0) == (lanes == 0)  # no launch without lanes


def test_shared_memory_holds_every_stack():
    for slots in range(1, ops.MAX_STACK_SLOTS + 1):
        g = ops.launch_geometry(4099, slots)
        assert g.smem_bytes == g.rays_per_block * slots * 4
        assert g.smem_bytes <= 48 * 1024  # no opt-in for more shared memory


def test_a_group_of_16_lanes_per_ray():
    g = ops.launch_geometry(1000, 6)
    assert g.threads % 32 == 0 and g.threads % ops.GROUP == 0
    assert ops.GROUP == 16  # one lane per child slot and per triangle slot
    assert g.rays_per_block == g.threads // ops.GROUP


def test_bad_arguments_raise():
    for lanes, slots in ((-1, 6), (10, 0), (10, 129)):
        with pytest.raises(ValueError):
            ops.launch_geometry(lanes, slots)


@pytest.mark.parametrize("tmax", [0.0, -0.0, float("nan")])
@pytest.mark.parametrize("mesh", [0, 1, 2, "per_lane"])
def test_plain_walk_misses_where_tmax_is_not_positive(mesh, tmax):
    """The kernels' early exit: a lane whose tmax is <= 0 or NaN writes a
    miss without loading anything. The plain walk gives the same, because
    a child's entry tn is >= 0 or NaN and never < tmax."""
    cpu = torch.device("cpu")
    pool, handles = _pool(cpu)
    n = 600
    o, d, tm = _rays(n, 3)
    culled = np.arange(n) % 2 == 0
    tm[culled] = tmax
    o, d, tm = (torch.from_numpy(a) for a in (o, d, tm))
    if mesh == "per_lane":
        noff, toff, slots = _per_lane(handles, n, cpu)
    else:
        h = handles[mesh]
        noff, toff, slots = h.node_offset, h.tri_offset, h.stack_slots
    t, tri = plain.intersect_mesh(pool, noff, toff, o, d, tm, stack_slots=slots)
    occ = plain.intersect_mesh_any(pool, noff, toff, o, d, tm, stack_slots=slots)
    culled = torch.from_numpy(culled)
    assert torch.isinf(t[culled]).all() and (t[culled] > 0).all()
    assert (tri[culled] == -1).all() and not occ[culled].any()
    # the same rays with an unbounded tmax hit something
    t_open, _ = plain.intersect_mesh(pool, noff, toff, o, d,
                                     torch.full_like(tm, float("inf")), stack_slots=slots)
    assert bool(torch.isfinite(t_open[culled]).any())


# K7's launches on the complexity path: one per frame pass over every
# big-mesh primitive, (big meshes) x (spp x H x W) lanes
K7_LANES = [1 * 512 * 512, 4 * 512 * 512, 14 * 2 * 48 * 48, 16 * 1024 * 1024]


@pytest.mark.parametrize("lanes", K7_LANES)
@pytest.mark.parametrize("slots", [2, 6, 12])
def test_steps_launch_covers_the_complexity_batch(lanes, slots):
    g = ops.launch_geometry(lanes, slots)
    assert g.grid * g.rays_per_block >= lanes > (g.grid - 1) * g.rays_per_block
    assert g.grid < 2**31 and g.smem_bytes == g.rays_per_block * slots * 4


def test_complexity_hands_k7_one_batch_with_per_lane_offsets(monkeypatch):
    """traversal_costs makes one K7 call over every big-mesh primitive with
    contiguous f32 local rays and contiguous int32 per-lane offsets,
    instance-major, and the batch's stack bound."""
    from tinsel_tpu_torch.render import integrator
    from tinsel_tpu_torch.scene import presets

    flat = presets.many_mesh_scene(12, 16, 16, 1).flatten(device="cpu")
    big = [p.mesh for p in flat.prim_static if p.mesh is not None and p.mesh.num_tris > 16]
    calls = []
    orig = ops.traversal_steps

    def rec(*a):
        calls.append(a)
        return orig(*a)

    monkeypatch.setattr(ops, "traversal_steps", rec)
    o, d, _ = _rays(300, 4)
    cost = integrator.traversal_costs(flat, torch.from_numpy(o), torch.from_numpy(d),
                                      torch.zeros(300))
    assert len(calls) == 1
    pool, noff, toff, oo, dd, slots = calls[0]
    n = len(big) * 300
    for t, dtype, shape in ((noff, torch.int32, (n,)), (toff, torch.int32, (n,)),
                            (oo, torch.float32, (n, 3)), (dd, torch.float32, (n, 3))):
        assert t.dtype == dtype and tuple(t.shape) == shape and t.is_contiguous()
    assert noff.tolist() == [h.node_offset for h in big for _ in range(300)]
    assert slots == max(h.stack_slots for h in big)
    assert cost.shape == (300,) and (cost >= len(flat.prim_static)).all()


def test_plain_count_is_one_where_no_root_child_is_hit():
    """K7 walks with tmax = +inf and takes no tmax: a lane whose ray misses
    every child box of the root counts exactly its root step, as does a
    lane of the plain count with tmax <= 0 or NaN."""
    pool, handles = _pool(torch.device("cpu"))
    h = handles[1]  # the UV sphere of radius 1.5
    n = 64
    o = torch.tensor([[0.0, 0.0, 10.0]]).repeat(n, 1)
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(n, 1)  # away from the mesh
    inf = torch.full((n,), float("inf"))
    c = plain.traversal_cost(pool, h.node_offset, h.tri_offset, o, d, inf,
                             stack_slots=h.stack_slots)
    assert (c == 1).all()
    toward = plain.traversal_cost(pool, h.node_offset, h.tri_offset, o, -d, inf,
                                  stack_slots=h.stack_slots)
    assert (toward > 2).all()
    culled = torch.tensor([0.0, -0.0, float("nan")]).repeat_interleave(n // 3 + 1)[:n]
    c = plain.traversal_cost(pool, h.node_offset, h.tri_offset, o, -d, culled,
                             stack_slots=h.stack_slots)
    assert (c == 1).all()
    stats = {}
    plain.traversal_cost(pool, h.node_offset, h.tri_offset, o, -d, inf,
                         stack_slots=h.stack_slots, stats=stats)
    assert stats["visits"] + stats["blocks"] == int(toward.sum())
