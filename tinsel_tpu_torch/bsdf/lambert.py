"""Lambert BRDF, uniform-hemisphere sampling, f = color / pi (port of
``tinsel_tpu/bsdf/lambert.py``). A drop-in for the Disney BSDF with the
same (eval, pdf, sample) signatures; ``bsdf_sample`` reads the first two
of its uniforms (the JAX package's ``fold_in(key, 0)`` and ``(key, 1)``).
"""

from __future__ import annotations

import torch

from ..core.math import INV_2PI, INV_PI, dot
from ..core.sampling import uniform_sample_hemisphere
from .disney import REFLECTED


def bsdf_pdf(m, eta_i, eta_o, n, v, l):
    return torch.where(dot(l, n) <= 0.0, 0.0, INV_2PI)


def bsdf_sample(m, eta_i, eta_o, u, v, n, view, uniforms):
    r1, r2 = uniforms[0], uniforms[1]
    shape = torch.broadcast_shapes(m.roughness.shape, r1.shape)
    d = uniform_sample_hemisphere(r1, r2)
    light = u * d[..., 0:1] + v * d[..., 1:2] + n * d[..., 2:3]
    pdf = torch.full(shape, INV_2PI, dtype=torch.float32, device=r1.device)
    event = torch.full(shape, REFLECTED, dtype=torch.int32, device=r1.device)
    return light, pdf, event


def bsdf_eval(m, eta_i, eta_o, n, v, l):
    return INV_PI * m.color * torch.ones_like(m.color)
