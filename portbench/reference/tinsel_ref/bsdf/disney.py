"""Disney BSDF, branchless and batched (port of
``tinsel_tpu/bsdf/disney.py``: same lobes, masks and guards).

``bsdf_sample`` takes its six uniforms as tensors, in the JAX package's
order ``u0, u1, r1, r2, u4, u5`` (``disney.py:180-183``).
"""

from __future__ import annotations

import torch

from ..core.math import (
    INV_2PI,
    INV_PI,
    TWO_PI,
    PI,
    dot,
    lerp,
    normalize,
    safe_normalize,
    sqr,
)
from ..core.sampling import cosine_sample_hemisphere, uniform_sample_hemisphere

# BSDF event types
REFLECTED = 0
TRANSMITTED = 1
SPECULAR = 2

_EPS = 1e-6


def _nonzero(x):
    return torch.where(torch.abs(x) > _EPS, x, torch.full_like(x, _EPS))


def schlick_fresnel(u):
    m = torch.clamp(1.0 - u, 0.0, 1.0)
    m2 = m * m
    return m2 * m2 * m


def gtr1(n_dot_h, a):
    """Clearcoat NDF; a >= 1 degenerates to 1/pi."""
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * n_dot_h * n_dot_h
    safe = (a2 - 1.0) / (
        PI * torch.log(torch.clamp(a2, min=_EPS)) * torch.clamp(t, min=_EPS)
    )
    return torch.where(a >= 1.0, INV_PI, safe)


def gtr2(n_dot_h, a):
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * n_dot_h * n_dot_h
    # denormal guard only: t^2 >= a^4 >= 1e-12 at the 0.001 roughness floor
    return a2 / (PI * torch.clamp(t * t, min=1e-20))


def smith_ggx(n_dot_v, alpha_g):
    a = alpha_g * alpha_g
    b = n_dot_v * n_dot_v
    return 1.0 / torch.clamp(
        n_dot_v + torch.sqrt(torch.clamp(a + b - a * b, min=0.0)), min=_EPS
    )


def fresnel_dielectric(v_dot_n, eta_i, eta_o):
    """Exact unpolarized dielectric Fresnel; 1 under total internal
    reflection."""
    sin2_t = sqr(eta_i / eta_o) * (1.0 - v_dot_n * v_dot_n)
    tir = sin2_t > 1.0
    l_dot_n = torch.sqrt(torch.clamp(1.0 - sin2_t, min=1e-12))
    eta = eta_o / torch.clamp(eta_i, min=_EPS)
    denom1 = v_dot_n + eta * l_dot_n
    denom2 = l_dot_n + eta * v_dot_n
    r1 = (v_dot_n - eta * l_dot_n) / _nonzero(denom1)
    r2 = (l_dot_n - eta * v_dot_n) / _nonzero(denom2)
    f = 0.5 * (sqr(r1) + sqr(r2))
    return torch.where(tir, 1.0, torch.clamp(f, 0.0, 1.0))


def refract(wi, n, eta):
    """Refract wi (pointing away from the surface) about n: (ok, wt)."""
    cos_i = dot(n, wi)
    sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    sin2_t = eta * eta * sin2_i
    ok = sin2_t < 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=1e-12))
    wt = -wi * eta[..., None] + (eta * cos_i - cos_t)[..., None] * n
    return ok, wt


def _spec_color(m):
    """Cspec0: tintable dielectric specular color lerped to base color by
    metallic."""
    cd = m.color
    lum = 0.3 * cd[..., 0] + 0.6 * cd[..., 1] + 0.1 * cd[..., 2]
    tint = torch.where(
        (lum > 0.0)[..., None],
        cd / torch.clamp(lum, min=_EPS)[..., None],
        torch.ones_like(cd),
    )
    white = torch.ones_like(cd)
    dielectric = (m.specular * 0.08)[..., None] * lerp(
        white, tint, m.specular_tint[..., None]
    )
    return lerp(dielectric, cd, m.metallic[..., None])


def bsdf_pdf(m, eta_i, eta_o, n, v, l):
    """Solid-angle pdf of ``bsdf_sample`` producing direction l (view v)."""
    n_dot_l = dot(l, n)
    below = n_dot_l <= 0.0

    brdf_pdf_below = INV_2PI * m.subsurface * 0.5

    f = fresnel_dielectric(dot(n, v), eta_i, eta_o)
    a = torch.clamp(m.roughness, min=0.001)
    half = safe_normalize(l + v)
    cos_theta_half = torch.abs(dot(half, n))
    pdf_half = gtr2(cos_theta_half, a) * cos_theta_half
    pdf_spec = 0.25 * pdf_half / torch.clamp(dot(l, half), min=_EPS)
    pdf_diff = torch.abs(n_dot_l) * INV_PI * (1.0 - m.subsurface)
    bsdf_pdf_above = pdf_spec * f
    brdf_pdf_above = lerp(pdf_diff, pdf_spec, 0.5)

    above = lerp(brdf_pdf_above, bsdf_pdf_above, m.transmission)
    below_v = lerp(brdf_pdf_below, torch.zeros_like(brdf_pdf_below), m.transmission)
    return torch.where(below, below_v, above)


def _sample_gtr2_half(u, v, n, view, r1, r2, roughness):
    """Sample a GTR2 half-vector in the (u, v, n) frame and reflect view."""
    a = torch.clamp(roughness, min=0.001)
    phi = r1 * TWO_PI
    cos_theta = torch.sqrt((1.0 - r2) / (1.0 + (sqr(a) - 1.0) * r2))
    sin_theta = torch.sqrt(torch.clamp(1.0 - sqr(cos_theta), min=1e-12))
    half = (
        u * (sin_theta * torch.cos(phi))[..., None]
        + v * (sin_theta * torch.sin(phi))[..., None]
        + n * cos_theta[..., None]
    )
    half = half * torch.where(dot(half, view) <= 0.0, -1.0, 1.0)[..., None]
    return 2.0 * dot(view, half)[..., None] * half - view


def bsdf_sample(m, eta_i, eta_o, u, v, n, view, uniforms):
    """Importance-sample an outgoing direction from six uniforms
    ``(u0, u1, r1, r2, u4, u5)``. Returns (light, pdf, event_type); the
    smooth-refraction event returns its discrete probability as ``pdf``
    and type SPECULAR."""
    u0, u1, r1, r2, u4, u5 = uniforms

    f = fresnel_dielectric(dot(n, view), eta_i, eta_o)

    is_trans = u0 < m.transmission
    is_spec_reflect = is_trans & (u1 < f)
    is_refract = is_trans & ~is_spec_reflect
    is_brdf = ~is_trans
    is_brdf_diff = is_brdf & (u4 < 0.5)
    is_ss = is_brdf_diff & (u5 < m.subsurface)
    is_cos = is_brdf_diff & ~is_ss

    l_spec = _sample_gtr2_half(u, v, n, view, r1, r2, m.roughness)

    refract_ok, l_refr = refract(view, n, eta_i / torch.clamp(eta_o, min=_EPS))
    l_refr = safe_normalize(l_refr, fallback=-view)

    d_cos = cosine_sample_hemisphere(r1, r2)
    l_cos = u * d_cos[..., 0:1] + v * d_cos[..., 1:2] + n * d_cos[..., 2:3]

    d_ss = uniform_sample_hemisphere(r1, r2)
    l_ss = u * d_ss[..., 0:1] + v * d_ss[..., 1:2] - n * d_ss[..., 2:3]

    light = torch.where(
        is_refract[..., None],
        l_refr,
        torch.where(
            is_ss[..., None], l_ss, torch.where(is_cos[..., None], l_cos, l_spec)
        ),
    )

    event = torch.where(
        is_refract,
        SPECULAR,
        torch.where(is_ss, TRANSMITTED, REFLECTED),
    ).to(torch.int32)

    pdf_smooth = torch.where(
        refract_ok, (1.0 - f) * m.transmission, torch.zeros_like(f)
    )
    pdf_solid = bsdf_pdf(m, eta_i, eta_o, n, view, light)
    pdf = torch.where(is_refract, pdf_smooth, pdf_solid)
    return light, pdf, event


def bsdf_eval(m, eta_i, eta_o, n, v, l):
    """Evaluate the BSDF value f(v, l) (RGB)."""
    n_dot_l = dot(n, l)
    n_dot_v = dot(n, v)
    h = normalize(l + v)
    n_dot_h = dot(n, h)
    l_dot_h = dot(l, h)

    cdlin = m.color
    cspec0 = _spec_color(m)
    below = n_dot_l <= 0.0
    a = torch.clamp(m.roughness, min=0.001)

    one_minus_metallic = 1.0 - m.metallic

    # ---- transmissive side (bsdf), weighted by m.transmission
    f_v = fresnel_dielectric(n_dot_v, eta_i, eta_o)
    bsdf_below = (
        m.transmission
        * (1.0 - f_v)
        / torch.clamp(torch.abs(n_dot_l), min=_EPS)
        * one_minus_metallic
    )[..., None] * torch.ones_like(cdlin)

    ds = gtr2(n_dot_h, a)
    fh_diel = fresnel_dielectric(l_dot_h, eta_i, eta_o)
    fs_t = lerp(cspec0, torch.ones_like(cspec0), fh_diel[..., None])
    gs = smith_ggx(n_dot_v, a) * smith_ggx(n_dot_l, a)
    bsdf_above = (gs * ds)[..., None] * fs_t

    bsdf = torch.where(below[..., None], bsdf_below, bsdf_above)

    # ---- reflective side (brdf), weighted by 1 - m.transmission
    s = torch.sqrt(torch.clamp(cdlin, min=1e-12))
    fl_b = schlick_fresnel(torch.abs(n_dot_l))
    fv_b = schlick_fresnel(n_dot_v)
    fd_b = (1.0 - 0.5 * fl_b) * (1.0 - 0.5 * fv_b)
    brdf_below = (INV_PI * m.subsurface * fd_b * one_minus_metallic)[..., None] * s
    brdf_below = torch.where(
        (m.subsurface > 0.0)[..., None], brdf_below, torch.zeros_like(brdf_below)
    )

    fh = schlick_fresnel(l_dot_h)
    fs = lerp(cspec0, torch.ones_like(cspec0), fh[..., None])
    fl = schlick_fresnel(n_dot_l)
    fv = schlick_fresnel(n_dot_v)
    fd90 = 0.5 + 2.0 * l_dot_h * l_dot_h * m.roughness
    fd = lerp(1.0, fd90, fl) * lerp(1.0, fd90, fv)

    dr = gtr1(n_dot_h, lerp(0.1, 0.001, m.clearcoat_gloss))
    fc = lerp(0.04, 1.0, fh)
    gr = smith_ggx(n_dot_l, 0.25) * smith_ggx(n_dot_v, 0.25)

    brdf_above = (
        (INV_PI * fd * one_minus_metallic * (1.0 - m.subsurface))[..., None] * cdlin
        + (gs * ds)[..., None] * fs
        + (m.clearcoat * gr * fc * dr)[..., None] * torch.ones_like(cdlin)
    )

    brdf = torch.where(below[..., None], brdf_below, brdf_above)
    return lerp(brdf, bsdf, m.transmission[..., None])
