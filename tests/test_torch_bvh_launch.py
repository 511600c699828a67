"""Launch geometry of the CUDA BVH walks (``ops/bvh.py::launch_geometry``)
and the premise of their early exit, checked on the CPU. The kernels
themselves run in tests/test_torch_bvh_cuda.py on the card."""

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
