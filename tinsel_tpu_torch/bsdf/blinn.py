"""Blinn microfacet BRDF: Blinn NDF with exponent 10/roughness, Schlick
Fresnel on the base color, Torrance-Sparrow geometric term (port of
``tinsel_tpu/bsdf/blinn.py``). Same (eval, pdf, sample) signatures as the
Disney BSDF; ``bsdf_sample`` reads the first two of its uniforms.
"""

from __future__ import annotations

import torch

from ..core.math import INV_2PI, PI, TWO_PI, dot, normalize
from .disney import REFLECTED

_EPS = 1e-6


def _exponent(m):
    return 10.0 / torch.clamp(m.roughness, min=1e-3)


def _schlick_color(c, cos_theta):
    return c + (1.0 - c) * torch.pow(torch.clamp(1.0 - cos_theta, 0.0, 1.0), 5.0)[..., None]


def bsdf_pdf(m, eta_i, eta_o, n, v, l):
    e = _exponent(m)
    h = normalize(v + l)
    cos_theta = torch.abs(dot(h, n))
    pdf = ((e + 1.0) * torch.pow(cos_theta, e)) / (
        2.0 * PI * 4.0 * torch.clamp(torch.abs(dot(v, h)), min=_EPS)
    )
    return torch.where(dot(l, n) <= 0.0, 0.0, pdf)


def bsdf_sample(m, eta_i, eta_o, u, v, n, view, uniforms):
    u1, u2 = uniforms[0], uniforms[1]
    shape = torch.broadcast_shapes(m.roughness.shape, u1.shape)
    e = _exponent(m)
    cos_t = torch.pow(u1, 1.0 / (e + 1.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = u2 * TWO_PI
    h = (
        u * (sin_t * torch.cos(phi))[..., None]
        + v * (sin_t * torch.sin(phi))[..., None]
        + n * cos_t[..., None]
    )
    h = h * torch.where(dot(view, h) < 0.0, -1.0, 1.0)[..., None]
    light = -view + 2.0 * dot(view, h)[..., None] * h
    pdf = bsdf_pdf(m, eta_i, eta_o, n, view, light)
    return light, pdf, torch.full(shape, REFLECTED, dtype=torch.int32, device=u1.device)


def bsdf_eval(m, eta_i, eta_o, n, v, l):
    e = _exponent(m)
    wh = normalize(v + l)
    n_dot_wh = torch.abs(dot(wh, n))
    n_dot_wo = torch.abs(dot(v, n))
    n_dot_wi = torch.abs(dot(l, n))
    wo_dot_wh = torch.clamp(torch.abs(dot(v, wh)), min=_EPS)

    f = _schlick_color(m.color, wo_dot_wh)
    g = torch.clamp(
        torch.minimum(
            2.0 * n_dot_wh * n_dot_wo / wo_dot_wh,
            2.0 * n_dot_wh * n_dot_wi / wo_dot_wh,
        ),
        max=1.0,
    )
    d = (e + 2.0) * INV_2PI * torch.pow(n_dot_wh, e)
    return f * (d * g / (4.0 * n_dot_wi * n_dot_wo + 1e-4))[..., None]
