"""Next-event estimation with MIS (port of ``tinsel_tpu/render/lights.py``:
``primitive_sample`` and ``sample_lights`` in its default "all" mode).

Shadow visibility is the JAX default segment-occlusion query
(``NEE_CLOSEST_SHADOW=False``): ``trace_any`` up to ``dist - PORTAL_TOL``,
with the sampled light's own emission and distance. Probe NEE and the
"power" light-selection mode are ported in slice 4.
"""

from __future__ import annotations

import math

import torch

from ..bsdf.disney import bsdf_eval, bsdf_pdf
from ..core.math import (
    dot,
    face_forward,
    length_sq,
    safe_normalize,
    transform_point,
    transform_vector,
)
from ..core.sampling import Prefixed, uniform_sample_sphere, uniform_sample_triangle
from ..core.search import lower_bound
from ..scene.model import MESH, SPHERE, SceneFlat
from .trace import prim_transform, trace_any

RAY_EPS = 1e-4  # kRayEpsilon
K_BSDF_SAMPLES = 1.0
PORTAL_TOL = 1e-2  # kTolerance


def primitive_sample(scene: SceneFlat, j: int, times, uniforms):
    """Uniform-area sample on light primitive j at per-ray times, from three
    uniforms ``(u0, u1, u2)``. Returns world-space (pos (R,3), normal (R,3),
    area (R,)), the area at the interpolated scale."""
    ps = scene.prim_static[j]
    tr = prim_transform(scene, j, times)
    u0, u1, u2 = uniforms
    shape = times.shape

    if ps.type == SPHERE:
        radius = scene.prims.radius[j]
        d = uniform_sample_sphere(u0, u1)
        pos = transform_point(tr, d * radius)
        normal = safe_normalize(pos - tr.p)
        area = 4.0 * math.pi * (radius * tr.s) ** 2
    elif ps.type == MESH:
        h = ps.mesh
        pool = scene.pool
        lo = torch.full(shape, h.tri_offset, dtype=torch.int32, device=times.device)
        tri = lower_bound(pool.tri_cdf, lo, h.num_tris, u0)
        tri = torch.clamp(tri, h.tri_offset, h.tri_offset + h.num_tris - 1).long()
        bu, bv = uniform_sample_triangle(u1, u2)
        bw = 1.0 - bu - bv
        a, b, c = pool.gather_tri(tri)
        n0, n1, n2 = pool.gather_normals(tri)
        pos_l = bu[..., None] * a + bv[..., None] * b + bw[..., None] * c
        nrm_l = bu[..., None] * n0 + bv[..., None] * n1 + bw[..., None] * n2
        pos = transform_point(tr, pos_l)
        normal = safe_normalize(transform_vector(tr, nrm_l))
        area = h.area * tr.s * tr.s
    else:
        raise ValueError("plane primitives cannot be area lights")
    return pos, normal, area * torch.ones(shape, dtype=torch.float32, device=times.device)


def sample_lights(scene: SceneFlat, mat, eta_i, eta_o, p, n, wo, times, source,
                  light_sampling: str = "all"):
    """Direct lighting at surface points p with shading normals n: one
    shadow ray per light sample. ``source`` is the UniformSource of this
    bounce's NEE draws: light draw d, sample s reads paths (d, s, k).
    Returns (R, 3) radiance (not multiplied by throughput)."""
    if light_sampling != "all":
        raise NotImplementedError(
            f"light_sampling={light_sampling!r} is ported in slice 4"
        )
    total = torch.zeros_like(p)
    shape = tuple(times.shape)
    for draw, j in enumerate(scene.light_indices):
        n_samples = scene.prim_static[j].light_samples
        lj = torch.zeros_like(p)
        for s in range(n_samples):
            ks = Prefixed(source, draw, s)
            uni = [ks.uniform((k,), shape) for k in range(3)]
            light_pos, light_nrm, area = primitive_sample(scene, j, times, uni)

            wi_un = light_pos - p
            dist = torch.sqrt(torch.clamp(length_sq(wi_un), min=1e-20))
            wi = wi_un / dist[..., None]

            shadow_o = p + face_forward(n, wi) * RAY_EPS
            # segment occlusion: anything strictly before the sampled point
            # (minus the portal tolerance) blocks
            occ = trace_any(
                scene, shadow_o, wi, times, torch.clamp(dist - PORTAL_TOL, min=0.0)
            )
            accept = ~occ
            light_t = dist
            emission = torch.broadcast_to(scene.materials.emission[j], p.shape)

            nl = torch.abs(dot(light_nrm, wi))
            accept = accept & (nl >= 1e-6)
            light_pdf = (light_t * light_t) / torch.clamp(area * nl, min=1e-12)

            bpdf = bsdf_pdf(mat, eta_i, eta_o, n, wo, wi)
            f = bsdf_eval(mat, eta_i, eta_o, n, wo, wi)
            accept = accept & (bpdf > 0.0)

            ns_ = n_samples + K_BSDF_SAMPLES
            c_bsdf = K_BSDF_SAMPLES / ns_
            c_light = n_samples / ns_
            weight = c_light * light_pdf / torch.clamp(
                c_bsdf * bpdf + c_light * light_pdf, min=1e-12
            )
            contrib = (
                (weight * torch.abs(dot(wi, n)) / torch.clamp(light_pdf, min=1e-3))[..., None]
                * f
                * emission
            )
            lj = lj + torch.where(accept[..., None], contrib, torch.zeros_like(contrib))
        total = total + lj / max(n_samples, 1)
    return total
