"""CUDA NLM denoiser kernels and their dispatchers.

``nlm_filter_cuda`` (kernel K1, ``csrc/nlm.cu`` ``tinsel_nlm_filter``)
replaces the Pallas kernel ``tinsel_tpu/ops/pallas/nlm.py:44
_nlm_band_kernel``; ``nlm_guided_cuda`` (K2, ``tinsel_nlm_guided``)
replaces ``_guided_band_kernel`` (``nlm.py:199``). Both keep the JAX
signatures and the (H, W, C) layout.

Bound and design: each kernel reads its inputs once and writes three
planes. K1 at its default r = 1 is bounded by device-memory bytes (~8 f32
operations per byte); K2 at its default r = 2 sits where bytes and f32
operations take about equal time. One CTA per 32x8 output tile stages the
tile and its halo in shared memory, computes the box means there and then
the weighted sums, so the (2r+1)^2 shifted copies of the plain version
never reach device memory (see the note in ``csrc/nlm.cu``).

A CPU tensor runs the plain version (``render/nlm.py``); a CUDA tensor
launches the kernel or raises. There is no backward kernel (the Pallas
kernels have none either): the backward is autograd of the plain version,
as ``jax.custom_vjp`` does in the JAX package (``nlm.py:173-177``,
``:349-360``).
"""

from __future__ import annotations

import ctypes

import torch

from ..render import nlm as _plain
from . import _build

# Launches per kernel since the last reset; a wrapper adds one where it
# launches its kernel and nowhere else.
launch_counts = {"nlm_filter": 0, "nlm_guided": 0}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


_typed_lib: list = []  # the loaded library, argtypes set


def _lib():
    if not _typed_lib:
        lib = _build.load("nlm")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tinsel_nlm_filter.argtypes = [p, p, i, i, f, i, p]
        lib.tinsel_nlm_filter.restype = i
        lib.tinsel_nlm_guided.argtypes = [p, p, p, p, p, i, i, f, i, f, f, f, p]
        lib.tinsel_nlm_guided.restype = i
        _typed_lib.append(lib)
    return _typed_lib[0]


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


def _launched(err: int, kernel: str):
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    launch_counts[kernel] += 1


def _nlm_filter_kernel(img, falloff: float, radius: int):
    _check_image(img)
    _check(img, "img", img.shape)
    if radius < 0:
        raise ValueError("radius must be >= 0")
    h, w = img.shape[:2]
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().tinsel_nlm_filter(
            img.data_ptr(), out.data_ptr(), h, w, float(falloff), int(radius),
            stream,
        )
    _launched(err, "nlm_filter")
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
    # the global max is a reduction over the whole image: a torch op before
    # the launch, as the JAX package does before its pallas_call (:294)
    dn = (depth / torch.clamp(torch.max(depth), min=1e-6)).contiguous()
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().tinsel_nlm_guided(
            img.data_ptr(), normal.data_ptr(), albedo.data_ptr(), dn.data_ptr(),
            out.data_ptr(), h, w, float(falloff), int(radius), float(f_normal),
            float(f_albedo), float(f_depth), stream,
        )
    _launched(err, "nlm_guided")
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
