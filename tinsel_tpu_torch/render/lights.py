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

Each sample's steps around its trace are ``ops/nee.py``'s: the light
sample and shadow ray (kernel K8 on the card), the shading (K9), or their
plain versions on the CPU. Under autograd on the card the kernels run
forward and the plain versions give the gradient.
"""

from __future__ import annotations

import math

import torch

from ..core.math import face_forward
from ..core.sampling import Prefixed
from ..ops import nee
from ..ops.nee import PORTAL_TOL, RAY_EPS, LightSample
from ..scene.model import SceneFlat, _GatherRows
from ..utils.profiling import traced
from . import trace
from .probe import probe_sample_uniforms
from .trace import prim_transform, trace_any, trace_closest

K_BSDF_SAMPLES = 1.0
K_PROBE_SAMPLES = 1.0  # kernel K9 adds the probe's sample undivided
NEE_CLOSEST_SHADOW = False  # True: the reference's closest-hit shadow
# estimator (module docstring); False: segment occlusion


def primitive_sample(scene: SceneFlat, j: int, times, uniforms):
    """Uniform-area sample on light primitive j at per-ray times, from three
    uniforms ``(u0, u1, u2)``: ``ops/nee.py::sample_point`` at the light's
    transform. Returns world-space (pos (R,3), normal (R,3), area (R,))."""
    return nee.sample_point(scene, j, prim_transform(scene, j, times), times, uniforms,
                            trace.MESH_VERTEX_GRADS)


def _probe_nee(scene: SceneFlat, mat, eta_i, eta_o, p, n, wo, times, source, total,
               fused: bool):
    """The probe's sample (draw 0): uniforms (0,) and (1,) of ``source``,
    added to ``total``."""
    shape = tuple(times.shape)
    r1 = source.uniform((0,), shape)
    r2 = source.uniform((1,), shape)
    wi, sky_color, sky_pdf = probe_sample_uniforms(scene.probe, r1, r2)
    shadow_o = p + face_forward(n, wi) * RAY_EPS
    # probe rays only need visibility: any hit, unbounded
    occ = trace_any(scene, shadow_o, wi, times, torch.full(shape, math.inf, device=p.device))
    ns = K_PROBE_SAMPLES + K_BSDF_SAMPLES
    c_bsdf = K_BSDF_SAMPLES / ns
    c_sky = K_PROBE_SAMPLES / ns
    args = (mat, eta_i, eta_o, n, wo, wi, occ, True, sky_pdf, None, sky_color, c_bsdf, c_sky,
            1e-12)
    if fused:
        return nee.shade(*args, total, probe=True)
    return total + nee.shade_plain(*args, probe=True) / K_PROBE_SAMPLES


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


def _power_nee(scene: SceneFlat, mat, eta_i, eta_o, p, n, wo, times, source, total,
               fused: bool):
    """One light per lane, picked from the power pmf by the uniform (999,)
    of ``source``; light jj's candidate sample reads (jj, k). Every
    candidate is sampled, the shadow ray of each lane's pick is traced
    once, and its contribution added to ``total``."""
    closest = NEE_CLOSEST_SHADOW
    shape = tuple(times.shape)
    li = list(scene.light_indices)
    pmf_l = torch.stack([scene.light_pmf[j] for j in li])  # (L,)
    cdf = torch.cumsum(pmf_l, dim=0)
    u = source.uniform((999,), shape)
    sel = torch.clamp(torch.searchsorted(cdf, u, right=True), 0, len(li) - 1)
    light_sample = nee.light_sample if fused else nee.light_sample_plain
    ls = None
    pmf_sel = torch.zeros(shape, dtype=torch.float32, device=p.device)
    emission = torch.zeros_like(p)
    for jj, j in enumerate(li):
        kj = Prefixed(source, jj)
        lj = light_sample(scene, j, prim_transform(scene, j, times), p, n, times,
                          [kj.uniform((k,), shape) for k in range(3)], trace.MESH_VERTEX_GRADS)
        m = sel == jj
        ls = lj if ls is None else LightSample(*(torch.where(m[..., None] if a.dim() == 2 else m,
                                                             a, b) for a, b in zip(lj, ls)))
        pmf_sel = torch.where(m, pmf_l[jj], pmf_sel)
        if not closest:  # the sampled light's emission
            emission = torch.where(m[..., None], scene.materials.emission[j], emission)

    if closest:
        vis, light_t, emission = _closest_shadow(scene, ls.shadow_o, ls.wi, times, ls.dist)
    else:
        vis, light_t = trace_any(scene, ls.shadow_o, ls.wi, times, ls.tmax), ls.dist
    # the selection pmf folds into the NEE pdf; one sample per strategy, so
    # the balance-heuristic coefficients (1/2 each) cancel
    args = (mat, eta_i, eta_o, n, wo, ls.wi, vis, not closest, light_t, ls.area_nl, emission,
            1.0, 1.0, 1e-3)
    if fused:
        return nee.shade(*args, total, pmf=pmf_sel)
    return total + nee.shade_plain(*args, pmf=pmf_sel)


@traced("lights.nee")
def sample_lights(scene: SceneFlat, mat, eta_i, eta_o, p, n, wo, times, source,
                  light_sampling: str = "all"):
    """Direct lighting at surface points p with shading normals n.
    ``source`` is the UniformSource of this bounce's NEE draws: the probe
    reads draw 0, the lights the draws after it; in "all" mode light draw d,
    sample s reads (d, s, k). Returns (R, 3) radiance (not multiplied by
    throughput).

    On CUDA tensors (``ops/nee.py::fuses``) each sample is kernel K8 (the
    light sample and its shadow ray), the trace, and kernel K9 (the
    shading, added to the light's sum); on the CPU the same steps run as
    their plain versions."""
    if light_sampling not in ("all", "power"):
        raise ValueError(f"unknown light_sampling {light_sampling!r}")
    fused = nee.fuses(p)
    total = torch.zeros_like(p)
    shape = tuple(times.shape)
    draw = 0
    if scene.probe is not None:
        total = _probe_nee(scene, mat, eta_i, eta_o, p, n, wo, times, Prefixed(source, draw),
                           total, fused)
        draw += 1
    if light_sampling == "power" and scene.light_indices:
        return _power_nee(scene, mat, eta_i, eta_o, p, n, wo, times, Prefixed(source, draw),
                          total, fused)
    light_sample = nee.light_sample if fused else nee.light_sample_plain
    for j in scene.light_indices:
        n_samples = scene.prim_static[j].light_samples
        tr = prim_transform(scene, j, times)  # the same for every sample
        ns_ = n_samples + K_BSDF_SAMPLES
        c_bsdf = K_BSDF_SAMPLES / ns_
        c_light = n_samples / ns_
        lj = torch.zeros_like(p)
        for s in range(n_samples):
            ks = Prefixed(source, draw, s)
            uni = [ks.uniform((k,), shape) for k in range(3)]
            ls = light_sample(scene, j, tr, p, n, times, uni, trace.MESH_VERTEX_GRADS)
            if NEE_CLOSEST_SHADOW:
                vis, light_t, emission = _closest_shadow(scene, ls.shadow_o, ls.wi, times,
                                                         ls.dist)
            else:
                vis = trace_any(scene, ls.shadow_o, ls.wi, times, ls.tmax)
                light_t, emission = ls.dist, scene.materials.emission[j]
            args = (mat, eta_i, eta_o, n, wo, ls.wi, vis, not NEE_CLOSEST_SHADOW, light_t,
                    ls.area_nl, emission, c_bsdf, c_light, 1e-3)
            lj = nee.shade(*args, lj) if fused else lj + nee.shade_plain(*args)
        draw += 1
        total = total + lj / max(n_samples, 1)
    return total
