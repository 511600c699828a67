"""CUDA NLM denoiser kernels and their dispatchers.

``nlm_filter_cuda`` (kernel K1, ``csrc/nlm.cu``) replaces the Pallas
kernel ``tinsel_tpu/ops/pallas/nlm.py:44 _nlm_band_kernel``;
``nlm_guided_cuda`` (K2, same source) replaces
``_guided_band_kernel`` (``nlm.py:199``). Both keep the JAX
signatures and the (H, W, C) layout.

Bound and design: each kernel reads its inputs once and writes three
planes; K1 at its default r = 1 is bounded by device-memory bytes, K2 at
r = 2 by f32 operations. What the card spends is instructions per pixel,
so a CTA computes a 32x32 tile with each thread walking a column strip
and reusing every staged value across the taps that need it; staging is
by TMA where the widths allow it and by ``cp.async`` elsewhere (see the
note in ``csrc/nlm.cu``). ``launch_geometry`` below picks the
tile, the grid, the shared memory and the staging path; the C side checks
it against its own layout.

A CPU tensor runs the plain version (``render/nlm.py``); a CUDA tensor
launches the kernel or raises. There is no backward kernel (the Pallas
kernels have none either): the backward is autograd of the plain version,
as ``jax.custom_vjp`` does in the JAX package (``nlm.py:173-177``,
``:349-360``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..render import nlm as _plain
from . import _build

# Launches per kernel since the last reset; a wrapper adds one where it
# launches its kernel and nowhere else.
launch_counts = {"nlm_filter": 0, "nlm_guided": 0}
# The geometry of each kernel's latest launch (staging path and all).
last_geometry: dict = {}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


# ------------------------------------------------------------ geometry
# Mirrors csrc/nlm.cu: TX, TY, make_layout, and the (threads, minimum CTAs
# per SM of __launch_bounds__) of each kernel shape. K1's first shape (8
# rows a thread) reuses staged values more; its second (4 rows, twice the
# warps) serves images with fewer tiles than the card has CTA slots.

TILE_W = TILE_H = 32
SHAPES = {"nlm_filter": ((128, 4), (256, 2)), "nlm_guided": ((256, 2),)}
SMEM_MAX = 232_448  # dynamic shared memory a CTA may use (H100)
_SM_SMEM, _CTA_RESERVED = 233_472, 1024  # per SM, and reserved per CTA
_TMA_BOX_MAX = 256  # elements per box dimension


class Geometry(NamedTuple):
    tile_w: int
    tile_h: int
    threads: int
    stages: int  # 2: the next tile's loads overlap this tile's compute
    grid: int  # persistent CTAs, each walking tiles grid apart
    tiles: int
    smem: int  # dynamic shared-memory bytes
    path: str  # "tma" or "cp.async"


def _round4(x: int) -> int:
    return (x + 3) & ~3


def _align128(b: int) -> int:
    return (b + 127) & ~127


def _staged(kernel: str, r: int):
    """(channels, halo) of each staged input, in the kernel's order."""
    if kernel == "nlm_filter":
        return ((3, 2 * r),)
    return ((3, r + 1), (3, r), (3, r), (1, r))


def _boxes(kernel: str, r: int):
    """(rows, pitch in floats) of each staged input: its TMA box. A box
    starts on a 16-byte boundary, so a row begins (-C * halo) % 4 floats
    before the halo."""
    return [
        (TILE_H + 2 * halo, _round4((-ch * halo) % 4 + ch * (TILE_W + 2 * halo)))
        for ch, halo in _staged(kernel, r)
    ]


def _smem_bytes(kernel: str, r: int, stages: int) -> int:
    stage = sum(_align128(rows * pitch * 4) for rows, pitch in _boxes(kernel, r))
    means = _align128((TILE_H + 2 * r) * 3 * (TILE_W + 2 * r) * 4)
    return 256 + stages * stage + means


@functools.lru_cache(maxsize=256)
def launch_geometry(kernel: str, h: int, w: int, radius: int, aligned: bool = True,
                    num_sms: int = 132) -> Geometry:
    """Launch geometry of ``kernel`` ("nlm_filter" or "nlm_guided") for an
    (h, w) image at search radius ``radius``. ``aligned``: every input's
    base address is a multiple of 16 bytes. TMA needs that and row strides
    (4 * C * w bytes) that are multiples of 16, i.e. w % 4 == 0, and boxes
    of at most 256 elements a side; anything else stages by cp.async."""
    if kernel not in SHAPES:
        raise ValueError(f"unknown kernel {kernel!r}")
    if h < 1 or w < 1 or radius < 0:
        raise ValueError(f"bad shape or radius: {h}x{w}, r={radius}")
    two = _smem_bytes(kernel, radius, 2)
    stages = 2 if 2 * (two + _CTA_RESERVED) <= _SM_SMEM else 1
    smem = _smem_bytes(kernel, radius, stages)
    if smem > SMEM_MAX:
        raise ValueError(
            f"{kernel}: radius {radius} needs {smem} B of shared memory per "
            f"CTA; the card allows {SMEM_MAX}"
        )
    tma = (
        aligned and w % 4 == 0
        and all(rows <= _TMA_BOX_MAX and pitch <= _TMA_BOX_MAX
                for rows, pitch in _boxes(kernel, radius))
    )
    tiles = -(-w // TILE_W) * -(-h // TILE_H)

    def ctas_per_sm(threads, min_ctas):
        return min(2048 // threads, _SM_SMEM // (smem + _CTA_RESERVED), min_ctas)

    shapes = SHAPES[kernel]
    threads, min_ctas = shapes[0]
    if tiles <= num_sms * ctas_per_sm(threads, min_ctas):
        threads, min_ctas = shapes[-1]
    grid = max(1, min(tiles, num_sms * ctas_per_sm(threads, min_ctas)))
    return Geometry(TILE_W, TILE_H, threads, stages, grid, tiles, smem,
                    "tma" if tma else "cp.async")


# ------------------------------------------------------------- launch

_typed_libs: dict = {}  # kernel -> its loaded C entry point, argtypes set
_sms: dict = {}  # device index -> multiprocessor count


def _entry(kernel: str):
    fn = _typed_libs.get(kernel)
    if fn is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        geo = [i] * 7  # tile_w, tile_h, threads, stages, grid, smem, tma
        if kernel == "nlm_filter":
            fn = _build.load("nlm").tinsel_nlm_filter
            fn.argtypes = [p, p, i, i, f, i, *geo, p]
        else:
            fn = _build.load("nlm").tinsel_nlm_guided
            fn.argtypes = [p, p, p, p, p, p, i, i, f, i, f, f, f, *geo, p]
        fn.restype = i
        _typed_libs[kernel] = fn
    return fn


def _num_sms(dev: torch.device) -> int:
    n = _sms.get(dev.index)
    if n is None:
        n = _sms[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return n


def _check(t: torch.Tensor, name: str, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _check_image(img: torch.Tensor):
    if img.dim() != 3 or img.shape[-1] != 3 or img.shape[0] < 1 or img.shape[1] < 1:
        raise ValueError(f"expected an (H, W, 3) image, got {tuple(img.shape)}")


_C_ERRORS = {9001: "launch geometry rejected by the kernel",
             9002: "cuTensorMapEncodeTiled is not available"}


def _launched(err: int, kernel: str, geo: Geometry):
    if err != 0:
        what = _C_ERRORS.get(err) or (
            f"tensor map encode failed (CUresult {err - 9100})" if err >= 9100
            else f"CUDA error {err}"
        )
        raise RuntimeError(f"{kernel} kernel launch failed: {what} ({geo})")
    launch_counts[kernel] += 1
    last_geometry[kernel] = geo


def _launch(dev: torch.device, fn, *args) -> int:
    """Call the C entry point on ``dev``'s current stream; the device
    context is switched only when ``dev`` is not already current."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index is None or dev.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(dev):
        return fn(*args, stream)


def _nlm_filter_kernel(img, falloff: float, radius: int):
    _check_image(img)
    _check(img, "img", img.shape)
    if radius < 0:
        raise ValueError("radius must be >= 0")
    h, w = img.shape[:2]
    geo = launch_geometry("nlm_filter", h, w, int(radius), img.data_ptr() % 16 == 0,
                          _num_sms(img.device))
    out = torch.empty_like(img)
    err = _launch(
        img.device, _entry("nlm_filter"), img.data_ptr(), out.data_ptr(), h, w,
        float(falloff), int(radius), *geo[:5], geo.smem, geo.path == "tma",
    )
    _launched(err, "nlm_filter", geo)
    return out


def _nlm_guided_kernel(img, normal, albedo, depth, falloff, radius, f_normal,
                       f_albedo, f_depth):
    _check_image(img)
    h, w = img.shape[:2]
    _check(img, "img", (h, w, 3))
    _check(normal, "normal", (h, w, 3))
    _check(albedo, "albedo", (h, w, 3))
    _check(depth, "depth", (h, w, 1))
    if radius < 0:
        raise ValueError("radius must be >= 0")
    ptrs = [t.data_ptr() for t in (img, normal, albedo, depth)]
    geo = launch_geometry("nlm_guided", h, w, int(radius),
                          all(p % 16 == 0 for p in ptrs), _num_sms(img.device))
    # the global max is a reduction over the whole image, as the JAX package
    # takes it before its pallas_call (:294); the kernel divides by it
    dmax = torch.amax(depth)
    out = torch.empty_like(img)
    err = _launch(
        img.device, _entry("nlm_guided"), *ptrs, dmax.data_ptr(), out.data_ptr(),
        h, w, float(falloff), int(radius), float(f_normal), float(f_albedo),
        float(f_depth), *geo[:5], geo.smem, geo.path == "tma",
    )
    _launched(err, "nlm_guided", geo)
    return out


def _on_cpu(*ts):
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"inputs must all be on the CPU or all on CUDA, got {devs}")


class _NLMFilter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, falloff, radius):
        ctx.save_for_backward(img)
        ctx.args = (falloff, radius)
        if _on_cpu(img):
            return _plain.nlm_filter(img, falloff, radius)
        return _nlm_filter_kernel(img, falloff, radius)

    @staticmethod
    def backward(ctx, g):
        (img,) = ctx.saved_tensors
        with torch.enable_grad():
            x = img.detach().requires_grad_(True)
            y = _plain.nlm_filter(x, *ctx.args)
            (gx,) = torch.autograd.grad(y, x, g)
        return gx, None, None


class _NLMGuided(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, normal, albedo, depth, falloff, radius, f_normal,
                f_albedo, f_depth):
        ctx.save_for_backward(img, normal, albedo, depth)
        ctx.args = (falloff, radius, f_normal, f_albedo, f_depth)
        if _on_cpu(img, normal, albedo, depth):
            return _plain.nlm_guided(img, normal, albedo, depth, *ctx.args)
        return _nlm_guided_kernel(img, normal, albedo, depth, *ctx.args)

    @staticmethod
    def backward(ctx, g):
        ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = _plain.nlm_guided(*ins, *ctx.args)
            grads = torch.autograd.grad(y, ins, g)
        return (*grads, None, None, None, None, None)


def nlm_filter_cuda(img, falloff: float = 200.0, radius: int = 1):
    """NLM denoise of an (H, W, 3) f32 image (kernel K1 on CUDA tensors)."""
    return _NLMFilter.apply(img, falloff, radius)


def nlm_guided_cuda(img, normal, albedo, depth, falloff: float = 200.0,
                    radius: int = 2, f_normal: float = 8.0,
                    f_albedo: float = 50.0, f_depth: float = 1.0):
    """AOV-guided joint NLM (kernel K2 on CUDA tensors). img, normal,
    albedo (H, W, 3), depth (H, W, 1)."""
    return _NLMGuided.apply(
        img, normal, albedo, depth, falloff, radius, f_normal, f_albedo, f_depth
    )


def nlm_denoise(img, falloff: float = 200.0, radius: int = 1):
    """Dispatcher (the CLI's ``-denoise``): kernel K1 for a CUDA tensor,
    the plain version for a CPU tensor."""
    return nlm_filter_cuda(img, falloff, radius)


def nlm_guided_denoise(img, normal, albedo, depth, **kw):
    """Dispatcher (the CLI's ``-denoise-guided``): kernel K2 for CUDA
    tensors, the plain version for CPU tensors."""
    return nlm_guided_cuda(img, normal, albedo, depth, **kw)
