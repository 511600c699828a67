"""Display transforms: luminance, gamma, filmic / Reinhard tonemap and the
accumulation-buffer resolve (port of ``tinsel_tpu/core/color.py``)."""

from __future__ import annotations

import torch

from ..utils.profiling import traced

GAMMA = 2.2


def luminance(c):
    """Reference's luminance approximation: 0.3 R + 0.6 G + 0.1 B."""
    return 0.3 * c[..., 0] + 0.6 * c[..., 1] + 0.1 * c[..., 2]


def linear_to_srgb(c):
    return torch.pow(torch.clamp(c, min=0.0), 1.0 / GAMMA)


def srgb_to_linear(c):
    return torch.pow(torch.clamp(c, min=0.0), GAMMA)


def tonemap_filmic(c, limit=1.0):
    """Hejl/Burgess-Dawson filmic curve, linearized so the final display
    gamma (linear_to_srgb) round-trips. ``limit`` is accepted and unused,
    as in the JAX package."""
    x = torch.clamp(c - 0.004, min=0.0)
    ret = (x * (6.2 * x + 0.5)) / (x * (6.2 * x + 1.7) + 0.06)
    return srgb_to_linear(ret)


def yxy_to_xyz(Y, x, y):
    """CIE Yxy -> XYZ, broadcasting; returns (..., 3)."""
    y = torch.clamp(y, min=1e-6)
    X = x * (Y / y)
    Z = (1.0 - x - y) * (Y / y)
    return torch.stack(torch.broadcast_tensors(X, Y, Z), dim=-1)


# sRGB D65 primaries (linear RGB), standard matrix
_XYZ_TO_RGB = (
    (3.2404542, -1.5371385, -0.4985314),
    (-0.9692660, 1.8760108, 0.0415560),
    (0.0556434, -0.2040259, 1.0572252),
)


def xyz_to_linear_rgb(xyz):
    """CIE XYZ -> linear sRGB. xyz: (..., 3)."""
    m = torch.tensor(_XYZ_TO_RGB, dtype=torch.float32, device=xyz.device)
    return xyz @ m.T


def hsv_to_rgb(h, s, v):
    """HSV -> RGB, broadcasting, h in [0, 1) (port of
    ``tinsel_tpu/core/color.py:62``, same operation order)."""
    h6 = torch.remainder(h, 1.0) * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack(
        [pick(v, q, p, p, t, v), pick(t, v, v, q, p, p), pick(p, p, t, v, v, q)], dim=-1
    )


def tonemap_reinhard(c, limit=1.0):
    lum = luminance(c)
    return c / (1.0 + lum / limit)[..., None]


@traced("app.resolve")
def resolve(accum, exposure=1.0, limit=1.0, tonemap="filmic"):
    """RGBA accumulation buffer (premultiplied color, weight in alpha) ->
    display sRGB in [0, 1]. ``tonemap``: "filmic" or "reinhard" (where
    ``limit`` sets the luminance shoulder)."""
    w = torch.clamp(accum[..., 3:4], min=1e-7)
    c = accum[..., :3] * (exposure / w)
    if tonemap == "reinhard":
        c = tonemap_reinhard(c, limit)
    else:
        c = tonemap_filmic(c)
    return torch.clamp(linear_to_srgb(c), 0.0, 1.0)
