"""Preetham/Perez analytic daylight (port of ``tinsel_tpu/render/skylight.py``).

A clear-sky radiance as a function of view direction, sun direction and
turbidity, evaluated in Yxy and converted to linear RGB, with the
coefficient tables of Preetham et al. 1999 ("A Practical Analytic Model
for Daylight"). A library function: no render path calls it.
"""

from __future__ import annotations

import math

import torch

from ..core.color import xyz_to_linear_rgb, yxy_to_xyz

# Perez coefficients (A..E) as linear functions of turbidity T: m * T + b;
# rows A, B, C, D, E; columns (m, b). Preetham et al. 1999, Table A.1.
_PEREZ_x = (
    (-0.0193, -0.2592), (-0.0665, 0.0008), (-0.0004, 0.2125), (-0.0641, -0.8989),
    (-0.0033, 0.0452),
)
_PEREZ_y = (
    (-0.0167, -0.2608), (-0.0950, 0.0092), (-0.0079, 0.2102), (-0.0441, -1.6537),
    (-0.0109, 0.0529),
)
_PEREZ_Y = (
    (0.1787, -1.4630), (-0.3554, 0.4275), (-0.0227, 5.3251), (0.1206, -2.5771),
    (-0.0670, 0.3703),
)
# zenith chromaticity: cubic in the sun's theta dotted with quadratic in T,
# Preetham et al. 1999, eq. (8)-(9)
_ZENITH_x = (
    (0.00166, -0.00375, 0.00209, 0.0),
    (-0.02903, 0.06377, -0.03202, 0.00394),
    (0.11693, -0.21196, 0.06052, 0.25886),
)
_ZENITH_y = (
    (0.00275, -0.00610, 0.00317, 0.0),
    (-0.04214, 0.08970, -0.04153, 0.00516),
    (0.15346, -0.26756, 0.06670, 0.26688),
)


def _perez(cos_theta, gamma, cos_gamma, coeffs):
    a, b, c, d, e = coeffs
    return (1.0 + a * torch.exp(b / torch.clamp(cos_theta, min=1e-4))) * (
        1.0 + c * torch.exp(d * gamma) + e * cos_gamma * cos_gamma
    )


def sky_radiance(theta, phi, sun_theta, sun_phi, turbidity=2.5):
    """Perez sky at view angles (theta from the zenith, phi azimuth) as
    linear RGB; the angles are f32 tensors that broadcast. theta is
    clamped just below the horizon; luminance is normalized by its zenith
    value."""
    dev = theta.device
    f32 = dict(dtype=torch.float32, device=dev)
    t = torch.as_tensor(turbidity, **f32)
    sun_theta = torch.as_tensor(sun_theta, **f32)
    theta = torch.clamp(theta, 0.0, math.pi * 0.5 - 1e-6)
    cos_theta = torch.cos(theta)
    cos_sun = torch.cos(sun_theta)
    sin_sun = torch.sin(sun_theta)

    # arc between the view direction and the sun
    cg = torch.clamp(
        cos_sun * cos_theta + sin_sun * torch.sin(theta) * torch.cos(torch.abs(phi - sun_phi)),
        -1.0, 1.0,
    )
    gamma = torch.arccos(cg)

    # zenith values
    chi = (4.0 / 9.0 - t / 120.0) * (math.pi - 2.0 * sun_theta)
    zen_Y = (4.0453 * t - 4.9710) * torch.tan(chi) - 0.2155 * t + 2.4192  # kcd/m^2
    tv = torch.stack([t * t, t, torch.ones_like(t)])
    sv = torch.stack([sun_theta ** 3, sun_theta ** 2, sun_theta, torch.ones_like(sun_theta)])
    zen_x = tv @ torch.tensor(_ZENITH_x, **f32) @ sv
    zen_y = tv @ torch.tensor(_ZENITH_y, **f32) @ sv

    def lum(zen, table):
        table = torch.tensor(table, **f32)
        coeffs = table[:, 0] * t + table[:, 1]
        num = _perez(cos_theta, gamma, cg, coeffs)
        den = _perez(torch.ones((), **f32), sun_theta, cos_sun, coeffs)
        return zen * num / torch.clamp(den, min=1e-9)

    xyz = yxy_to_xyz(lum(zen_Y, _PEREZ_Y), lum(zen_x, _PEREZ_x), lum(zen_y, _PEREZ_y))
    return torch.clamp(xyz_to_linear_rgb(xyz), min=0.0)


def sky_radiance_dir(dirs, sun_dir, turbidity=2.5):
    """The Perez sky for (..., 3) direction batches (y-up, the gradient
    sky's convention); sun_dir (3,)."""
    d = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    s = sun_dir / torch.linalg.norm(sun_dir, dim=-1)
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.atan2(d[..., 2], d[..., 0])
    sun_theta = torch.arccos(torch.clamp(s[1], -1.0, 1.0))
    sun_phi = torch.atan2(s[2], s[0])
    return sky_radiance(theta, phi, sun_theta, sun_phi, turbidity)
