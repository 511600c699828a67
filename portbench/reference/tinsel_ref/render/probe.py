"""HDR environment probe: lat-long mapping, nearest-texel evaluation, pdf
and CDF importance sampling (port of ``tinsel_tpu/render/probe.py``).

The dir <-> uv mapping is y-up lat-long; the pdf carries the
``w * h / (2 pi^2 sin theta)`` Jacobian from texel area to solid angle;
sampling inverts the row CDF, then the chosen row's column CDF, each with
the vectorized ``lower_bound`` of ``core/search.py``.
"""

from __future__ import annotations

import torch

from ..core.math import INV_PI, PI, TWO_PI
from ..core.search import lower_bound


def probe_dir_to_uv(d):
    """World direction -> lat-long UV (y-up)."""
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.where(
        (d[..., 0] == 0.0) & (d[..., 2] == 0.0),
        0.0,
        torch.atan2(d[..., 2], d[..., 0]),
    )
    u = (PI + phi) * INV_PI * 0.5
    v = theta * INV_PI
    return torch.stack([u, v], dim=-1)


def probe_uv_to_dir(uv):
    theta = uv[..., 1] * PI
    phi = uv[..., 0] * TWO_PI
    sin_t = torch.sin(theta)
    return torch.stack(
        [-sin_t * torch.cos(phi), torch.cos(theta), -sin_t * torch.sin(phi)], dim=-1
    )


def _texel(probe, uv):
    """(row, col) int64 of the nearest texel (truncation, clamped)."""
    h, w = probe.data.shape[:2]
    col = torch.clamp((uv[..., 0] * w).to(torch.int32), 0, w - 1).long()
    row = torch.clamp((uv[..., 1] * h).to(torch.int32), 0, h - 1).long()
    return row, col


def probe_eval_uv(probe, uv):
    """Nearest-texel radiance lookup. probe: ProbeFlat; uv (..., 2)."""
    row, col = _texel(probe, uv)
    return probe.data[row, col]


def probe_eval_dir(probe, d):
    return probe_eval_uv(probe, probe_dir_to_uv(d))


def probe_pdf(probe, d):
    """Solid-angle pdf that ``probe_sample_uniforms`` generates direction d."""
    h, w = probe.data.shape[:2]
    uv = probe_dir_to_uv(d)
    row, col = _texel(probe, uv)
    pdf = probe.pdf_x[row, col] * probe.pdf_y[row]
    sin_theta = torch.sin(uv[..., 1] * PI)
    jac = (w * h) / (2.0 * PI * PI * torch.clamp(torch.abs(sin_theta), min=1e-6))
    return torch.where(torch.abs(sin_theta) < 1e-4, 0.0, pdf * jac)


def probe_sample_uniforms(probe, r1, r2):
    """Importance-sample the probe from uniforms r1, r2 (any batch shape).
    Returns (dir (..., 3), color (..., 3), pdf (...,))."""
    h, w = probe.data.shape[:2]
    row = lower_bound(probe.cdf_y, torch.zeros_like(r1, dtype=torch.int32), h, r1)
    row = torch.clamp(row, 0, h - 1)
    col = lower_bound(probe.cdf_x.reshape(-1), row * w, w, r2) - row * w
    col = torch.clamp(col, 0, w - 1)
    rl, cl = row.long(), col.long()

    color = probe.data[rl, cl]
    pdf = probe.pdf_x[rl, cl] * probe.pdf_y[rl]

    u = col.to(torch.float32) / w
    v = row.to(torch.float32) / h
    sin_theta = torch.sin(v * PI)
    jac = (w * h) / (2.0 * PI * PI * torch.clamp(sin_theta, min=1e-6))
    pdf = torch.where(sin_theta == 0.0, 0.0, pdf * jac)

    d = probe_uv_to_dir(torch.stack([u, v], dim=-1))
    return d, color, pdf


def sky_eval(scene, d):
    """Sky radiance for escaped rays: the probe if the scene has one, else
    the horizon -> zenith gradient on sqrt(|dir.y|)."""
    if scene.probe is not None:
        return probe_eval_dir(scene.probe, d)
    t = torch.sqrt(torch.abs(d[..., 1]))[..., None]
    return scene.sky_horizon + (scene.sky_zenith - scene.sky_horizon) * t
