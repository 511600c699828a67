"""The guided non-local-means denoiser, plain PyTorch (line-for-line port
of ``tinsel_tpu/render/nlm.py``).

The plain version of the port's guided NLM kernel (K2, ``csrc/nlm.cu``),
on every device.

Windows are clipped at the image border: the mean divides by the count of
in-bounds taps, and NLM normalizes by the sum of in-bounds weights.
"""

from __future__ import annotations

import torch

from .filters import _shift2d


def _valid_mask(h, w, dy, dx, device):
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    return (yy + dy >= 0) & (yy + dy < h) & (xx + dx >= 0) & (xx + dx < w)


def average_filter(img, radius: int = 1):
    """Box mean over a clipped (2r+1)^2 window. img: (H, W, C)."""
    h, w = img.shape[:2]
    acc = torch.zeros_like(img)
    cnt = torch.zeros((h, w), dtype=torch.float32, device=img.device)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            m = _valid_mask(h, w, dy, dx, img.device)
            acc = acc + torch.where(m[..., None], _shift2d(img, dy, dx), 0.0)
            cnt = cnt + m
    return acc / cnt[..., None]


def nlm_guided(img, normal, albedo, depth, falloff: float = 200.0,
               radius: int = 2, f_normal: float = 8.0, f_albedo: float = 50.0,
               f_depth: float = 1.0):
    """Joint (guided) non-local means: the color-patch distance plus
    normal / albedo / relative-depth guide distances from the AOV pass.

    img: (H, W, 3) tonemapped; normal (H, W, 3); albedo (H, W, 3);
    depth (H, W, 1)."""
    h, w = img.shape[:2]
    means = average_filter(img, 1)
    dmax = torch.clamp(torch.max(depth), min=1e-6)
    dn = depth / dmax
    acc = torch.zeros_like(img)
    wsum = torch.zeros((h, w), dtype=torch.float32, device=img.device)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            m = _valid_mask(h, w, dy, dx, img.device)
            d2 = torch.sum((means - _shift2d(means, dy, dx)) ** 2, dim=-1)
            g2 = (
                f_normal * torch.sum((normal - _shift2d(normal, dy, dx)) ** 2, dim=-1)
                + f_albedo * torch.sum((albedo - _shift2d(albedo, dy, dx)) ** 2, dim=-1)
                + f_depth * torch.sum((dn - _shift2d(dn, dy, dx)) ** 2, dim=-1)
            )
            wgt = torch.where(m, torch.exp(-falloff * d2 - g2), 0.0)
            acc = acc + _shift2d(img, dy, dx) * wgt[..., None]
            wsum = wsum + wgt
    return acc / torch.clamp(wsum, min=1e-12)[..., None]
