"""Reconstruction filtering as a gather stencil (port of
``tinsel_tpu/render/filters.py``): each output pixel gathers the weighted
contributions of the samples generated in its (2K+1)^2 neighbourhood, with
the reference's int-truncated footprint and truncated Gaussian."""

from __future__ import annotations

import numpy as np
import torch


def _shift2d(a, dy: int, dx: int):
    """Shift an (H, W, ...) tensor so out[y, x] = a[y+dy, x+dx]; zero-pad."""
    h, w = a.shape[:2]
    out = torch.zeros_like(a)
    ys, yd = max(0, dy), max(0, -dy)
    xs, xd = max(0, dx), max(0, -dx)
    ny, nx = h - abs(dy), w - abs(dx)
    if ny > 0 and nx > 0:
        out[yd:yd + ny, xd:xd + nx] = a[ys:ys + ny, xs:xs + nx]
    return out


def splat(sample_rgb, raster_x, raster_y, filter_type: str, filter_width: float,
          filter_falloff: float, present=None):
    """Accumulate one sample-per-pixel pass into an (H, W, 4) RGBA buffer
    (premultiplied color, weight in alpha).

    sample_rgb: (S, H, W, 3) radiance of the sample generated at pixel
    (y, x) of pass s; raster_x / raster_y: (S, H, W) raster positions. The
    S passes are splatted independently and summed (the JAX package vmaps
    ``splat`` over them). present: None, or an (S, H, W) bool mask of the
    samples that exist; the others add neither color nor weight (a row
    band's samples, ``render_pass(rows=...)``)."""
    s_, h, w = raster_x.shape
    fw = float(filter_width)
    k = int(np.floor(fw)) + 1
    offset = float(np.exp(-filter_falloff * fw * fw))
    dev = sample_rgb.device

    # (H, W, S, ...) layout: the shifts act on the two leading axes
    rgb = sample_rgb.permute(1, 2, 0, 3)
    rx_all = raster_x.permute(1, 2, 0)
    ry_all = raster_y.permute(1, 2, 0)
    present_all = None if present is None else present.permute(1, 2, 0)

    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :, None]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None, None]
    yy = torch.arange(h, device=dev)[:, None, None]
    xx = torch.arange(w, device=dev)[None, :, None]

    acc_c = torch.zeros((h, w, s_, 3), dtype=torch.float32, device=dev)
    acc_w = torch.zeros((h, w, s_), dtype=torch.float32, device=dev)
    for dy in range(-k, k + 1):
        for dx in range(-k, k + 1):
            c = _shift2d(rgb, dy, dx)
            rx = _shift2d(rx_all, dy, dx)
            ry = _shift2d(ry_all, dy, dx)
            valid = (yy + dy >= 0) & (yy + dy < h) & (xx + dx >= 0) & (xx + dx < w)
            if present_all is not None:
                valid = valid & _shift2d(present_all, dy, dx)
            in_fp = (
                (xs >= torch.floor(rx - fw))
                & (xs <= torch.floor(rx + fw))
                & (ys >= torch.floor(ry - fw))
                & (ys <= torch.floor(ry + fw))
            )
            if filter_type == "box":
                wgt = (valid & in_fp).to(torch.float32)
            else:
                gx = torch.clamp(
                    torch.exp(-filter_falloff * (xs - rx) ** 2) - offset, min=0.0
                )
                gy = torch.clamp(
                    torch.exp(-filter_falloff * (ys - ry) ** 2) - offset, min=0.0
                )
                wgt = torch.where(valid & in_fp, gx * gy, torch.zeros_like(gx))
            acc_c = acc_c + c * wgt[..., None]
            acc_w = acc_w + wgt
    return torch.cat([acc_c, acc_w[..., None]], dim=-1).sum(dim=2)
