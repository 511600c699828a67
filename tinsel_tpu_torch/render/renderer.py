"""Renderer front end: progressive accumulation over sample passes (port of
``tinsel_tpu/render/renderer.py``).

A pass renders ``samples_per_pass`` spp as one flat (S*H*W,) ray batch and
returns its (H, W, 4) RGBA increment through the gather-stencil splat;
``render`` bounds a pass at about 1M rays, as the JAX package does. The
debug modes "normals" and "complexity" return the mean of the pass's
samples with alpha 1, unsplatted.
"""

from __future__ import annotations

import math
from functools import partial

import torch

from ..core.math import clamp_length, lerp
from ..core.sampling import Lanes, PathUniforms, Prefixed, best_candidate_2d
from ..device import resolve_device
from ..scene.model import Options, SceneFlat
from ..utils.profiling import traced
from .camera import CameraParams, generate_rays
from .filters import splat
from .integrator import path_trace, trace_complexity, trace_normals

SAMPLERS = ("random", "stratified", "bluenoise")
MODES = ("pathtrace", "normals", "complexity")


def _sample_grid(width: int, height: int, cam: CameraParams, source,
                 spp: int = 1, sampler: str = "random"):
    """Raster positions + shutter times: (S, H, W) tensors.

    "random": plain uniform jitter (the reference's active sampler).
    "stratified": jitter within the most-square s1 x s2 sub-pixel grid
    across the pass's spp samples, shutter times stratified over the pass.
    "bluenoise": the pass's spp sub-pixel positions are one best-candidate
    point set shared by every pixel and shifted per pixel mod 1 (a
    Cranley-Patterson rotation); times are one stratified 1-D set shifted
    per pixel. Both fall back to "random" at 1 spp."""
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r}")
    dev = cam.position.device
    arange_s = torch.arange(spp, dtype=torch.float32, device=dev)[:, None, None]
    if sampler == "bluenoise" and spp > 1:
        pts = best_candidate_2d(spp, Prefixed(source, 3))  # (spp, 2)
        shift = source.uniform((0,), (1, height, width, 2))
        jitter = torch.remainder(pts[:, None, None, :] + shift, 1.0)
        tshift = source.uniform((1,), (1, height, width))
        tu = torch.remainder((arange_s + 0.5) / spp + tshift, 1.0)
    else:
        jitter = source.uniform((0,), (spp, height, width, 2))
        tu = source.uniform((1,), (spp, height, width))
    jx, jy = jitter[..., 0], jitter[..., 1]
    if sampler == "stratified" and spp > 1:
        s1 = int(math.sqrt(spp))
        while spp % s1:
            s1 -= 1
        s2 = spp // s1
        sx = torch.remainder(arange_s, s1)
        sy = torch.div(arange_s, s1, rounding_mode="floor")
        jx = (sx + jx) / s1
        jy = (sy + jy) / s2
        tu = (arange_s + tu) / spp
    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(height, dtype=torch.float32, device=dev)[None, :, None]
    rx = xs + jx
    ry = ys + jy
    times = lerp(cam.shutter_start, cam.shutter_end, tu)
    return rx, ry, times


@traced("render.pass")
def render_pass(
    scene: SceneFlat,
    cam: CameraParams,
    source,
    *,
    width: int,
    height: int,
    max_depth: int,
    samples_per_pass: int = 1,
    clamp: float = float("inf"),
    filter_type: str = "gaussian",
    filter_width: float = 0.75,
    filter_falloff: float = 1.0,
    mode: str = "pathtrace",
    sampler: str = "random",
    rr_depth: int = 0,
    light_sampling: str = "all",
    rows: tuple[int, int] | None = None,
):
    """One pass of ``samples_per_pass`` spp -> (H, W, 4) RGBA increment.
    ``source``: the UniformSource of the pass (the JAX pass key).

    ``rows=(y0, y1)``: only the samples generated in image rows [y0, y1),
    splatted at their own pixels into the full (H, W, 4) buffer (the
    filter reaches rows outside the band); the passes of the row bands of
    one image sum to the whole pass. Every draw is made at the whole pass's
    shape and the band keeps its lanes (``core/sampling.py::Lanes``), so a
    band's samples are the whole pass's (``parallel/sharding.py``)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    s = samples_per_pass
    rx, ry, times = _sample_grid(width, height, cam, source, s, sampler)
    raster = torch.stack([rx, ry], dim=-1).reshape(-1, 2)
    # thin-lens draws; zero aperture ignores them
    lens_uv = source.uniform((5,), (s, height, width, 2)).reshape(-1, 2)
    origins, dirs = generate_rays(cam, width, height, raster, lens_uv)
    times_flat = times.reshape(-1)
    path_source = Prefixed(source, 2)
    band_h = height
    if rows is not None:
        y0, y1 = rows
        if not 0 <= y0 < y1 <= height:
            raise ValueError(f"rows {rows} are not a band of {height} rows")
        band_h = y1 - y0
        lanes = torch.arange(s * height * width, device=origins.device)
        lanes = lanes.reshape(s, height, width)[:, y0:y1].reshape(-1)
        origins, dirs, times_flat = (x.index_select(0, lanes) for x in (origins, dirs, times_flat))
        path_source = Lanes(path_source, lanes, s * height * width)

    if mode != "pathtrace":
        dbg = trace_normals if mode == "normals" else trace_complexity
        rgb = dbg(scene, origins, dirs, times_flat).reshape(s, band_h, width, 3).mean(dim=0)
        out = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
        return out if rows is None else _place_rows(out, rows, height)

    radiance = path_trace(
        scene, origins, dirs, times_flat, max_depth, path_source,
        rr_depth=rr_depth, light_sampling=light_sampling,
    )
    if math.isfinite(clamp):
        radiance = clamp_length(radiance, clamp)
    sample_rgb = radiance.reshape(s, band_h, width, 3)
    if rows is None:
        return splat(sample_rgb, rx, ry, filter_type, filter_width, filter_falloff)
    present = torch.zeros((s, height, width), dtype=torch.bool, device=rx.device)
    present[:, y0:y1] = True
    sample_rgb = _place_rows(sample_rgb.transpose(0, 1), rows, height).transpose(0, 1)
    return splat(sample_rgb, rx, ry, filter_type, filter_width, filter_falloff, present)


def _place_rows(x, rows, height: int):
    """(y1 - y0, ...) rows -> (height, ...), zero outside [y0, y1)."""
    y0, y1 = rows
    pad = (0, 0) * (x.dim() - 1) + (y0, height - y1)
    return torch.nn.functional.pad(x, pad)


def make_render_pass(options: Options, samples_per_pass: int = 1):
    """Bind static options; returns render_pass(scene, cam, source)."""
    return partial(
        render_pass,
        width=options.width,
        height=options.height,
        max_depth=options.max_depth,
        samples_per_pass=samples_per_pass,
        clamp=options.clamp,
        filter_type=options.filter_type,
        filter_width=options.filter_width,
        filter_falloff=options.filter_falloff,
        mode=options.mode,
        sampler=options.sampler,
        rr_depth=options.rr_depth,
        light_sampling=options.light_sampling,
    )


def make_accumulate_fn(options: Options, samples_per_pass: int = 1):
    """(accum, scene, cam, source, pass_idx) -> accum + one pass, the pass
    drawing under ``pass_idx`` (the JAX ``fold_in(key, pass_idx)``)."""
    pass_fn = make_render_pass(options, samples_per_pass)

    @torch.no_grad()
    def step(accum, scene, cam, source, pass_idx: int):
        return accum + pass_fn(scene, cam, Prefixed(source, pass_idx))

    return step


def render(scene_host, spp: int, seed: int = 0, options: Options = None,
           samples_per_pass: int | None = None, report_every: int = 0, device=None,
           source=None):
    """Host loop: flatten, then accumulate ``spp`` samples in passes of at
    most ~1M rays. Returns the (H, W, 4) accumulation buffer (resolve with
    core.color.resolve). ``report_every``: after every ``report_every``
    passes, wait for the device (the JAX package's ``block_until_ready``;
    the image is the same). ``device``: None means cuda (raises without a
    GPU). ``source``: a UniformSource; default ``PathUniforms(seed)`` on
    the device, the CLI's source, so ``seed`` gives the CLI's ``-seed``
    image."""
    device = resolve_device(device)
    options = options or scene_host.options
    flat = scene_host.flatten(device)
    cam = CameraParams.from_host(scene_host.camera, device)
    if source is None:
        source = PathUniforms(seed, device)
    if samples_per_pass is None:
        samples_per_pass = max(
            1, min(spp, (1 << 20) // max(options.width * options.height, 1))
        )
    n_full, rem = divmod(spp, samples_per_pass)
    step = make_accumulate_fn(options, samples_per_pass)
    accum = torch.zeros(
        (options.height, options.width, 4), dtype=torch.float32, device=device
    )
    for c in range(n_full):
        accum = step(accum, flat, cam, source, c)
        if report_every and (c + 1) % report_every == 0 and accum.is_cuda:
            torch.cuda.synchronize(accum.device)
    if rem:
        accum = make_accumulate_fn(options, rem)(accum, flat, cam, source, n_full)
    return accum
