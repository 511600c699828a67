"""Adaptive sampling: variance-driven per-tile sample allocation (port of
``tinsel_tpu/render/adaptive.py``).

After a uniform warm-up, each round re-estimates the per-pixel standard
error of the pixel mean and spends the whole next batch of samples on the
K tiles (16 x 16 pixels) with the largest summed error. The buffer holds
(sum, count) per pixel and resolves by division, so every pixel's estimate
is the plain average of its own samples, however many rounds chose it.
Adaptive rounds reconstruct with a per-pixel box (jitter inside the
pixel): a wider splat would spread samples over tile borders and break the
per-tile bookkeeping.
"""

from __future__ import annotations

import torch

from ..core.math import lerp
from ..core.sampling import PathUniforms, Prefixed
from ..device import resolve_device
from ..scene.model import SceneFlat
from .camera import CameraParams, generate_rays
from .integrator import path_trace

TILE = 16  # pixels per tile side


def _check_dims(width: int, height: int):
    if width % TILE or height % TILE:
        raise ValueError(
            f"adaptive sampling needs width/height divisible by {TILE}; got {width}x{height}"
        )


def _to_tiles(img):
    """(H, W, C) -> (T, TILE, TILE, C) in row-major tile order."""
    h, w, c = img.shape
    return (
        img.reshape(h // TILE, TILE, w // TILE, TILE, c)
        .permute(0, 2, 1, 3, 4)
        .reshape(-1, TILE, TILE, c)
    )


def _from_tiles(tiles, height: int, width: int):
    c = tiles.shape[-1]
    return (
        tiles.reshape(height // TILE, width // TILE, TILE, TILE, c)
        .permute(0, 2, 1, 3, 4)
        .reshape(height, width, c)
    )


def _tile_priority(accum, m2):
    """Per-tile priority (T,): the summed absolute standard error of the
    pixel means, whose square is each pixel's expected contribution to the
    image's MSE. accum: (H, W, 4) (sum, count); m2: (H, W, 3) sum of
    squared radiance."""
    w = torch.clamp(accum[..., 3:4], min=1.0)
    mean = accum[..., :3] / w
    var = torch.clamp(m2 / w - mean * mean, min=0.0)  # per-sample variance
    sem = torch.sqrt(var / w)
    per_pixel = sem.sum(dim=-1, keepdim=True)
    return _to_tiles(per_pixel).sum(dim=(1, 2, 3))


def _trace_pixels(scene, cam, source, px, py, spp, width, height, max_depth,
                  rr_depth, light_sampling):
    """Trace spp box-filtered samples of the pixels at integer raster
    coordinates px, py (N,). Returns (sum, sum of squares), (N, 3) each."""
    n = px.shape[0]
    jitter = source.uniform((0,), (spp, n, 2))
    rx = px[None, :].to(torch.float32) + jitter[..., 0]
    ry = py[None, :].to(torch.float32) + jitter[..., 1]
    raster = torch.stack([rx, ry], dim=-1).reshape(-1, 2)
    lens_uv = source.uniform((4,), (spp * n, 2))  # thin-lens draws
    origins, dirs = generate_rays(cam, width, height, raster, lens_uv)
    times = lerp(cam.shutter_start, cam.shutter_end, source.uniform((1,), (spp * n,)))
    rad = path_trace(
        scene, origins, dirs, times, max_depth, Prefixed(source, 2),
        rr_depth=rr_depth, light_sampling=light_sampling,
    ).reshape(spp, n, 3)
    return rad.sum(dim=0), (rad * rad).sum(dim=0)


@torch.no_grad()
def adaptive_round(accum, m2, scene: SceneFlat, cam: CameraParams, source, *,
                   k_tiles: int, spp: int, width: int, height: int, max_depth: int,
                   rr_depth: int = 0, uniform: bool = False, light_sampling: str = "all"):
    """One round: pick the k_tiles highest-priority tiles (ties to the lower
    tile index, as ``lax.top_k``), spend spp samples on each of their
    pixels, add the sums back. ``uniform=True`` takes k_tiles tiles of a
    rotation from a random first tile instead (the warm-up). ``source``:
    the UniformSource of the round. Returns (accum, m2)."""
    n_tiles = (width // TILE) * (height // TILE)
    dev = accum.device
    if uniform:
        start = source.randint((9,), (), 0, n_tiles).to(dev)
        idx = (start + torch.arange(k_tiles, device=dev)) % n_tiles
    else:
        order = torch.sort(_tile_priority(accum, m2), descending=True, stable=True).indices
        idx = order[:k_tiles]
    idx = idx.long()

    tx = (idx % (width // TILE)) * TILE
    ty = (idx // (width // TILE)) * TILE
    dx = torch.arange(TILE, device=dev)
    px = (tx[:, None, None] + dx[None, None, :]).expand(k_tiles, TILE, TILE).reshape(-1)
    py = (ty[:, None, None] + dx[None, :, None]).expand(k_tiles, TILE, TILE).reshape(-1)

    s, s2 = _trace_pixels(scene, cam, source, px, py, spp, width, height, max_depth,
                          rr_depth, light_sampling)
    upd = torch.cat([s, torch.full_like(s[:, :1], float(spp))], dim=-1)
    acc_t = _to_tiles(accum).clone()
    m2_t = _to_tiles(m2).clone()
    # the tiles are distinct, so the adds never collide
    acc_t[idx] += upd.reshape(k_tiles, TILE, TILE, 4)
    m2_t[idx] += s2.reshape(k_tiles, TILE, TILE, 3)
    return _from_tiles(acc_t, height, width), _from_tiles(m2_t, height, width)


def adaptive_render(scene_host, budget_spp: int, seed: int = 0, options=None,
                    frac: float = 0.25, warmup_spp: int = 2, spp_round: int = 4,
                    report=None, device=None, source=None):
    """Render with a budget of ``budget_spp`` average samples per pixel:
    ``warmup_spp`` uniform samples over every tile (at least one round of
    ``spp_round``), then rounds of ``spp_round`` samples on the top
    ``frac`` of tiles while the budget lasts; round r draws under (r,) of
    ``source`` (default ``PathUniforms(seed)`` on the device). Returns
    the (H, W, 4) accumulation buffer (resolve as usual). ``device``:
    None means cuda."""
    device = resolve_device(device)
    options = options or scene_host.options
    w, h = options.width, options.height
    _check_dims(w, h)
    flat = scene_host.flatten(device)
    cam = CameraParams.from_host(scene_host.camera, device)
    if source is None:
        source = PathUniforms(seed, device)
    n_tiles = (w // TILE) * (h // TILE)
    k = max(1, min(n_tiles, int(round(frac * n_tiles))))

    accum = torch.zeros((h, w, 4), dtype=torch.float32, device=device)
    m2 = torch.zeros((h, w, 3), dtype=torch.float32, device=device)
    kwargs = dict(spp=spp_round, width=w, height=h, max_depth=options.max_depth,
                  rr_depth=options.rr_depth, light_sampling=options.light_sampling)

    warm_rounds = max(1, warmup_spp // spp_round)
    for r in range(warm_rounds):
        accum, m2 = adaptive_round(accum, m2, flat, cam, Prefixed(source, r),
                                   k_tiles=n_tiles, uniform=True, **kwargs)
    r = warm_rounds
    budget_rays = budget_spp * w * h
    spent = warm_rounds * spp_round * w * h
    rays_per_round = k * TILE * TILE * spp_round
    while spent + rays_per_round <= budget_rays:
        accum, m2 = adaptive_round(accum, m2, flat, cam, Prefixed(source, r),
                                   k_tiles=k, uniform=False, **kwargs)
        spent += rays_per_round
        r += 1
        if report:
            report(r, spent / (w * h))
    return accum
