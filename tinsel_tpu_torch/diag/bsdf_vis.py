"""BSDF sample/pdf consistency visualizer (port of
``tinsel_tpu/diag/bsdf_vis.py``): f(v, l) / pdf(v, l) over a lat-long map
of outgoing directions for a fixed view vector, with N importance-sampled
directions marked on top, a visual check that the sampler's density
matches the analytic pdf. The ratio map is one batched eval/pdf call, the
samples one batched ``bsdf_sample`` of N lanes.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.math import basis_from_vector
from ..core.sampling import PathUniforms
from ..device import resolve_device
from ..io.hdr import save_pfm
from ..scene.model import MaterialsFlat


def _latlong_dirs(width: int, height: int, device):
    """Direction grid over the full sphere (lat-long, y-up), (H, W, 3)."""
    u = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) / width
    v = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) / height
    phi = u * 2.0 * math.pi
    theta = v * math.pi
    T, P = torch.meshgrid(theta, phi, indexing="ij")
    return torch.stack(
        [torch.sin(T) * torch.cos(P), torch.cos(T), torch.sin(T) * torch.sin(P)], dim=-1
    )


def _dir_to_pixel(d, width: int, height: int):
    phi = torch.remainder(torch.atan2(d[..., 2], d[..., 0]), 2.0 * math.pi)
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    x = torch.clamp((phi / (2.0 * math.pi) * width).to(torch.int32), 0, width - 1)
    y = torch.clamp((theta / math.pi * height).to(torch.int32), 0, height - 1)
    return x, y


@torch.no_grad()
def bsdf_test(material, bsdf_module=None, *, width: int = 512, height: int = 256,
              n_samples: int = 1000, view_theta: float = 0.35, seed: int = 0,
              pfm_path: str | None = None, uniforms=None, device=None) -> np.ndarray:
    """The f/pdf map of ``material`` with ``n_samples`` importance samples
    marked in green; returns the (H, W, 3) image, also written as a PFM if
    ``pfm_path`` is given. ``bsdf_module`` defaults to the Disney BSDF.
    ``uniforms``: the sampler's six (n_samples,) uniforms; default drawn
    from ``PathUniforms(seed)`` at paths (0,) .. (5,). ``device``: None
    means cuda."""
    if bsdf_module is None:
        from ..bsdf import disney as bsdf_module
    dev = resolve_device(device)

    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    n = t([0.0, 1.0, 0.0])
    th = t(view_theta)
    view = torch.stack([torch.sin(th), torch.cos(th), t(0.0)])
    eta_i = t(1.0)
    eta_o = t(material.index_of_refraction())
    # the one material as the integrator's SoA record, each field a row
    table = MaterialsFlat.from_host([material], dev)
    mflat = MaterialsFlat(**{f.name: getattr(table, f.name)[0]
                             for f in dataclasses.fields(table)})

    dirs = _latlong_dirs(width, height, dev)
    f = bsdf_module.bsdf_eval(mflat, eta_i, eta_o, n, view, dirs)
    pdf = bsdf_module.bsdf_pdf(mflat, eta_i, eta_o, n, view, dirs)
    ratio = torch.where(pdf[..., None] > 1e-7, f / torch.clamp(pdf, min=1e-7)[..., None], 0.0)

    u_axis, v_axis = basis_from_vector(n)
    if uniforms is None:
        src = PathUniforms(seed, dev)
        uniforms = [src.uniform((i,), (n_samples,)) for i in range(6)]
    uniforms = [torch.as_tensor(u, dtype=torch.float32, device=dev) for u in uniforms]
    l, spdf, _ = bsdf_module.bsdf_sample(mflat, eta_i, eta_o, u_axis, v_axis, n, view, uniforms)
    x, y = _dir_to_pixel(l, width, height)
    ok = spdf > 0.0
    img = ratio.expand(height, width, 3).cpu().numpy().copy()  # writable for the marks
    x, y, ok = x.cpu().numpy(), y.cpu().numpy(), ok.cpu().numpy()
    img[y[ok], x[ok]] = [0.0, 10.0, 0.0]

    if pfm_path is not None:
        save_pfm(pfm_path, img)
    return img
