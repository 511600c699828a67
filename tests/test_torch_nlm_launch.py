"""Launch geometry of the CUDA NLM kernels (``ops/nlm.py::launch_geometry``),
checked on the CPU: what the wrapper hands the C interface for a given
image, radius and pointer alignment. The kernels themselves run in
tests/test_torch_nlm_cuda.py on the card."""

import pytest

from tinsel_tpu_torch.ops import nlm as ops

KERNELS = ("nlm_filter", "nlm_guided")
SHAPES = [(1, 1), (1, 5), (3, 2), (33, 49), (37, 53), (64, 64), (512, 512),
          (1080, 1920), (1100, 999), (2160, 3840)]


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("radius", range(9))
def test_shared_memory_fits_the_card(kernel, radius):
    for aligned in (True, False):
        g = ops.launch_geometry(kernel, 512, 512, radius, aligned)
        assert 0 < g.smem <= ops.SMEM_MAX == 232_448
        assert g.stages in (1, 2)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("radius", [0, 1, 2, 3, 5])
def test_grid_covers_every_pixel(kernel, h, w, radius):
    g = ops.launch_geometry(kernel, h, w, radius)
    tiles_x, tiles_y = -(-w // g.tile_w), -(-h // g.tile_h)
    assert g.tiles == tiles_x * tiles_y
    assert tiles_x * g.tile_w >= w and tiles_y * g.tile_h >= h
    # persistent CTAs walk tiles blockIdx, blockIdx + grid, ...: every tile
    # has an owner
    assert 1 <= g.grid <= g.tiles
    owners = {t % g.grid for t in range(g.tiles)}
    assert owners == set(range(g.grid))
    assert g.threads % 32 == 0 and (g.threads // 32) * (g.tile_h * 32 // g.threads) == g.tile_h


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("h,w", SHAPES)
def test_tma_only_where_its_strides_and_bases_allow(kernel, h, w):
    for aligned in (True, False):
        g = ops.launch_geometry(kernel, h, w, 2, aligned)
        rows_ok = (12 * w) % 16 == 0 and (4 * w) % 16 == 0
        assert (g.path == "tma") == (aligned and rows_ok)
        assert g.path in ("tma", "cp.async")


def test_large_radii_leave_tma_or_raise():
    # a TMA box has at most 256 elements a side: K1 at r = 14 stages by
    # cp.async; radii whose tile does not fit in shared memory raise
    assert ops.launch_geometry("nlm_filter", 512, 512, 13).path == "tma"
    assert ops.launch_geometry("nlm_filter", 512, 512, 14).path == "cp.async"
    with pytest.raises(ValueError, match="shared memory"):
        ops.launch_geometry("nlm_guided", 512, 512, 40)


def test_bad_arguments_raise():
    with pytest.raises(ValueError):
        ops.launch_geometry("nlm_filter", 0, 5, 1)
    with pytest.raises(ValueError):
        ops.launch_geometry("nlm_filter", 5, 5, -1)
    with pytest.raises(ValueError):
        ops.launch_geometry("nlm_box", 5, 5, 1)


def test_small_images_get_more_warps_per_tile():
    small = ops.launch_geometry("nlm_filter", 512, 512, 1)
    large = ops.launch_geometry("nlm_filter", 2160, 3840, 1)
    assert (small.threads, large.threads) == (256, 128)
    assert large.grid < large.tiles  # persistent: several tiles per CTA
