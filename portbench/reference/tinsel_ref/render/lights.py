"""Next-event estimation with MIS (port of ``tinsel_tpu/render/lights.py``:
``primitive_sample`` and ``sample_lights``).

A scene with an HDR probe first samples the probe (draw 0): one shadow ray
with ``tmax = +inf`` and a balance-heuristic weight against the BSDF
pdf. The area lights follow under draws 1, 2, ... (0, 1, ... without a
probe): "all" traces one shadow ray per light sample; "power" picks one
light per lane from ``SceneFlat.light_pmf`` and traces one shadow ray,
with the pmf folded into the light pdf.

Area-light shadow visibility follows ``NEE_CLOSEST_SHADOW``, read at call
time as in the JAX package. False (the default) is the segment-occlusion
query: ``trace_any`` up to ``dist - PORTAL_TOL``, with the sampled light's
own emission and distance (kernel K5a, and K4 on big meshes, on the
card). True is the reference's estimator: a closest hit of the shadow ray
(``trace_closest``: K5c and its refit, K3 and the shortlist rounds on big
meshes), accepted when |t - dist| <= ``PORTAL_TOL``, with t as the light
distance and the emission of the primitive hit, gathered by
``_GatherRows`` (one-hot backward). The probe's shadow ray is an
occlusion query in both forms.
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
from ..scene.model import MESH, SPHERE, SceneFlat, _GatherRows
from . import trace
from .probe import probe_sample_uniforms
from .trace import prim_transform, trace_any, trace_closest

RAY_EPS = 1e-4  # kRayEpsilon
K_BSDF_SAMPLES = 1.0
K_PROBE_SAMPLES = 1.0
PORTAL_TOL = 1e-2  # kTolerance
NEE_CLOSEST_SHADOW = False  # True: the reference's closest-hit shadow
# estimator (module docstring); False: segment occlusion


def primitive_sample(scene: SceneFlat, j: int, times, uniforms):
    """Uniform-area sample on light primitive j at per-ray times, from three
    uniforms ``(u0, u1, u2)``. Returns world-space (pos (R,3), normal (R,3),
    area (R,)), the area at the interpolated scale. A mesh light's vertices
    and normals are detached unless ``trace.MESH_VERTEX_GRADS``: its
    position and size gradients flow through the transform."""
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
        a, b, c, n0, n1, n2 = trace._vertices(pool, tri)
        pos_l = bu[..., None] * a + bv[..., None] * b + bw[..., None] * c
        nrm_l = bu[..., None] * n0 + bv[..., None] * n1 + bw[..., None] * n2
        pos = transform_point(tr, pos_l)
        normal = safe_normalize(transform_vector(tr, nrm_l))
        area = h.area * tr.s * tr.s
    else:
        raise ValueError("plane primitives cannot be area lights")
    return pos, normal, area * torch.ones(shape, dtype=torch.float32, device=times.device)


def _probe_nee(scene: SceneFlat, mat, eta_i, eta_o, p, n, wo, times, source):
    """The probe's sample (draw 0): uniforms (0,) and (1,) of ``source``."""
    shape = tuple(times.shape)
    r1 = source.uniform((0,), shape)
    r2 = source.uniform((1,), shape)
    wi, sky_color, sky_pdf = probe_sample_uniforms(scene.probe, r1, r2)
    shadow_o = p + face_forward(n, wi) * RAY_EPS
    # probe rays only need visibility: any hit, unbounded
    visible = ~trace_any(scene, shadow_o, wi, times,
                         torch.full(shape, math.inf, device=p.device))
    bpdf = bsdf_pdf(mat, eta_i, eta_o, n, wo, wi)
    f = bsdf_eval(mat, eta_i, eta_o, n, wo, wi)
    ns = K_PROBE_SAMPLES + K_BSDF_SAMPLES
    c_bsdf = K_BSDF_SAMPLES / ns
    c_sky = K_PROBE_SAMPLES / ns
    weight = c_sky * sky_pdf / torch.clamp(c_bsdf * bpdf + c_sky * sky_pdf, min=1e-12)
    contrib = (
        (weight * torch.abs(dot(wi, n)) / torch.clamp(sky_pdf, min=1e-12))[..., None]
        * sky_color
        * f
    )
    ok = visible & (bpdf > 0.0) & (sky_pdf > 0.0) & (weight > 0.0)
    return torch.where(ok[..., None], contrib, torch.zeros_like(contrib)) / K_PROBE_SAMPLES


def _closest_shadow(scene: SceneFlat, shadow_o, wi, times, dist):
    """The reference's shadow estimator: (accept, light distance, (R, 3)
    emission) from the closest hit of each shadow ray."""
    sh = trace_closest(scene, shadow_o, wi, times)
    hit_any = sh.prim >= 0
    t = torch.where(hit_any, sh.t, 0.0)
    accept = hit_any & (torch.abs(t - dist) <= PORTAL_TOL)
    (emission,) = _GatherRows.apply(torch.clamp(sh.prim, min=0).long(),
                                    scene.materials.emission)
    return accept, t, emission


def _power_nee(scene: SceneFlat, mat, eta_i, eta_o, p, n, wo, times, source):
    """One light per lane, picked from the power pmf by the uniform (999,)
    of ``source``; light jj's candidate sample reads (jj, k). Every
    candidate is evaluated, the shadow ray is traced once."""
    closest = NEE_CLOSEST_SHADOW
    shape = tuple(times.shape)
    li = list(scene.light_indices)
    pmf_l = torch.stack([scene.light_pmf[j] for j in li])  # (L,)
    cdf = torch.cumsum(pmf_l, dim=0)
    u = source.uniform((999,), shape)
    sel = torch.clamp(torch.searchsorted(cdf, u, right=True), 0, len(li) - 1)
    pos = torch.zeros_like(p)
    nrm = torch.zeros_like(p)
    area = torch.zeros(shape, dtype=torch.float32, device=p.device)
    pmf_sel = torch.zeros(shape, dtype=torch.float32, device=p.device)
    emission = torch.zeros_like(p)
    for jj, j in enumerate(li):
        kj = Prefixed(source, jj)
        pj, nj, aj = primitive_sample(scene, j, times, [kj.uniform((k,), shape) for k in range(3)])
        m = sel == jj
        pos = torch.where(m[..., None], pj, pos)
        nrm = torch.where(m[..., None], nj, nrm)
        area = torch.where(m, aj, area)
        pmf_sel = torch.where(m, pmf_l[jj], pmf_sel)
        if not closest:  # the sampled light's emission
            emission = torch.where(m[..., None], scene.materials.emission[j], emission)

    wi_un = pos - p
    dist = torch.sqrt(torch.clamp(length_sq(wi_un), min=1e-20))
    wi = wi_un / dist[..., None]
    shadow_o = p + face_forward(n, wi) * RAY_EPS
    if closest:
        accept, light_t, emission = _closest_shadow(scene, shadow_o, wi, times, dist)
    else:
        accept = ~trace_any(scene, shadow_o, wi, times, torch.clamp(dist - PORTAL_TOL, min=0.0))
        light_t = dist
    nl = torch.abs(dot(nrm, wi))
    accept = accept & (nl >= 1e-6) & (pmf_sel > 0.0)
    # the selection pmf folds into the NEE pdf; one sample per strategy, so
    # the balance-heuristic coefficients (1/2 each) cancel
    light_pdf = pmf_sel * (light_t * light_t) / torch.clamp(area * nl, min=1e-12)
    bpdf = bsdf_pdf(mat, eta_i, eta_o, n, wo, wi)
    f = bsdf_eval(mat, eta_i, eta_o, n, wo, wi)
    accept = accept & (bpdf > 0.0)
    weight = light_pdf / torch.clamp(bpdf + light_pdf, min=1e-12)
    contrib = (
        (weight * torch.abs(dot(wi, n)) / torch.clamp(light_pdf, min=1e-3))[..., None]
        * f
        * emission
    )
    return torch.where(accept[..., None], contrib, torch.zeros_like(contrib))


def sample_lights(scene: SceneFlat, mat, eta_i, eta_o, p, n, wo, times, source,
                  light_sampling: str = "all"):
    """Direct lighting at surface points p with shading normals n.
    ``source`` is the UniformSource of this bounce's NEE draws: the probe
    reads draw 0, the lights the draws after it; in "all" mode light draw d,
    sample s reads (d, s, k). Returns (R, 3) radiance (not multiplied by
    throughput)."""
    if light_sampling not in ("all", "power"):
        raise ValueError(f"unknown light_sampling {light_sampling!r}")
    total = torch.zeros_like(p)
    shape = tuple(times.shape)
    draw = 0
    if scene.probe is not None:
        total = total + _probe_nee(scene, mat, eta_i, eta_o, p, n, wo, times,
                                   Prefixed(source, draw))
        draw += 1
    if light_sampling == "power" and scene.light_indices:
        return total + _power_nee(scene, mat, eta_i, eta_o, p, n, wo, times,
                                  Prefixed(source, draw))
    for j in scene.light_indices:
        n_samples = scene.prim_static[j].light_samples
        lj = torch.zeros_like(p)
        rays = []
        for s in range(n_samples):
            ks = Prefixed(source, draw, s)
            uni = [ks.uniform((k,), shape) for k in range(3)]
            light_pos, light_nrm, area = primitive_sample(scene, j, times, uni)

            wi_un = light_pos - p
            dist = torch.sqrt(torch.clamp(length_sq(wi_un), min=1e-20))
            wi = wi_un / dist[..., None]

            shadow_o = p + face_forward(n, wi) * RAY_EPS
            rays.append((light_nrm, area, wi, dist, shadow_o))
        if not NEE_CLOSEST_SHADOW and rays:
            # segment occlusion: anything strictly before the sampled
            # point (minus the portal tolerance) blocks. The reference
            # asks for every sample's shadow ray in one query: each ray's
            # answer is its own, so this is the per-sample query's answer
            # in fewer calls.
            occs = trace_any(
                scene, torch.cat([r[4] for r in rays]), torch.cat([r[2] for r in rays]),
                times.repeat(n_samples),
                torch.cat([torch.clamp(r[3] - PORTAL_TOL, min=0.0) for r in rays]),
            ).split(times.shape[0])
        for s, (light_nrm, area, wi, dist, shadow_o) in enumerate(rays):
            if NEE_CLOSEST_SHADOW:
                accept, light_t, emission = _closest_shadow(scene, shadow_o, wi, times, dist)
            else:
                accept = ~occs[s]
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
        draw += 1
        total = total + lj / max(n_samples, 1)
    return total
