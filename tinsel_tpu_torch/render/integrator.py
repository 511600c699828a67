"""Wavefront path-trace integrator: a Python loop over bounces on a flat
ray batch, every per-path branch carried as masks (port of
``_make_bounce`` / ``path_trace`` in ``tinsel_tpu/render/integrator.py``).

Per bounce: closest hit -> sky for escaped rays (MIS-weighted against
the probe's NEE when the scene has a probe) -> Beer-Lambert absorption ->
bump normal (scenes with a bump material) -> emission MIS -> next-event
estimation -> BSDF sample -> Russian roulette (``rr_depth > 0``) -> state
update. Per-primitive lookups are exact ``index_select`` gathers where the
JAX package uses exact one-hot matmuls. Once every lane is dead the
remaining bounces are skipped, which changes no value; ``path_trace_while``
is the same loop for forward-only callers.

Also the debug views: ``trace_normals`` and ``trace_complexity`` (the
per-ray traversal cost, kernel K7 on the card).
"""

from __future__ import annotations

import torch

from ..accel.build import BLOCK_SIZE
from ..accel.instances import lane_offsets
from ..bsdf.disney import SPECULAR, bsdf_eval, bsdf_sample
from ..core.color import hsv_to_rgb
from ..core.math import basis_from_vector, dot, face_forward, lerp
from ..core.sampling import Prefixed
from ..ops import bvh as ops_bvh
from ..scene.model import MESH, SceneFlat
from ..utils.profiling import count_sync, span
from .bump import bump_normal
from .lights import RAY_EPS, K_BSDF_SAMPLES, K_PROBE_SAMPLES, sample_lights
from .probe import probe_pdf, sky_eval
from .trace import _local_rays, _offsets, trace_closest

RR_MIN_Q = 0.05  # survival-probability floor (firefly guard)


def _initial_state(origins, dirs):
    r = origins.shape[0]
    kw = dict(dtype=torch.float32, device=origins.device)
    return dict(
        o=origins,
        d=dirs,
        eta=torch.ones((r,), **kw),
        absorb=torch.zeros((r, 3), **kw),
        rtype=torch.zeros((r,), dtype=torch.int32, device=origins.device),
        bpdf=torch.ones((r,), **kw),  # pdf of the ray's generating sample
        thr=torch.ones((r, 3), **kw),
        rad=torch.zeros((r, 3), **kw),
        alive=torch.ones((r,), dtype=torch.bool, device=origins.device),
    )


def _make_bounce(scene: SceneFlat, times, source, r, rr_depth: int = 0,
                 light_sampling: str = "all"):
    """The integrator step. ``source`` is the UniformSource of this path
    batch: bounce i reads its NEE draws under (i, 1, ...), its six BSDF
    uniforms under (i, 2, k) and its roulette uniform under (i, 3).

    ``rr_depth > 0``: Russian roulette on the ray leaving bounce i for
    i + 1 >= rr_depth, survival q = clip(max throughput, RR_MIN_Q, 1) with
    q detached, survivors' throughput divided by q."""
    zeros3 = torch.zeros((r, 3), dtype=torch.float32, device=times.device)

    def bounce(st, i: int):
        kb = Prefixed(source, i)
        o, d = st["o"], st["d"]
        hit = trace_closest(scene, o, d, times)
        found = hit.prim >= 0
        act_hit = st["alive"] & found
        act_miss = st["alive"] & ~found
        first = i == 0

        # escaped rays: sky, MIS-weighted against the probe's NEE
        sky = sky_eval(scene, d)
        if scene.probe is not None:
            sky_pdf = probe_pdf(scene.probe, d)
            ns = K_PROBE_SAMPLES + K_BSDF_SAMPLES
            c_bsdf = K_BSDF_SAMPLES / ns
            c_sky = K_PROBE_SAMPLES / ns
            w_sky = c_bsdf * st["bpdf"] / torch.clamp(
                c_bsdf * st["bpdf"] + c_sky * sky_pdf, min=1e-12
            )
            w_sky = torch.where((st["rtype"] == SPECULAR) | first, 1.0, w_sky)
            sky = w_sky[..., None] * sky
        rad = st["rad"] + torch.where(act_miss[..., None], sky * st["thr"], zeros3)

        # hit shading: per-lane primitive records
        idx = torch.clamp(hit.prim, min=0).long()
        m = scene.materials.select(idx)
        in_air = st["eta"] == 1.0
        out_eta = torch.where(in_air, m.eta, 1.0)
        out_absorb = torch.where(in_air[..., None], m.absorption, zeros3)

        # inf-free hit distance: misses never feed arithmetic
        t_safe = torch.where(found, hit.t, 0.0)

        thr = torch.where(
            act_hit[..., None],
            st["thr"] * torch.exp(-st["absorb"] * t_safe[..., None]),
            st["thr"],
        )

        p = o + d * t_safe[..., None]
        n = hit.normal
        if scene.has_bump:  # bump-free scenes evaluate no noise
            bmp = scene.prim_bump[idx]
            n = bump_normal(n, p, bmp[..., 0], bmp[..., 1])

        # emission: direct at depth 0; MIS-weighted on BSDF rays after
        lsamp = scene.prim_light_samples[idx]
        s_t = lerp(scene.prims.start_s[idx], scene.prims.end_s[idx], times)
        area = scene.prim_local_area[idx] * s_t * s_t
        has_area = area > 0.0
        cos_term = torch.clamp(dot(-d, n), 1e-3, 1.0)
        light_pdf = t_safe * t_safe / torch.clamp(area * cos_term, min=1e-12)
        if light_sampling == "power":
            # NEE picked one light with its pmf: its pdf for this direction
            # is pmf * area pdf, one sample per strategy
            pmf_hit = scene.light_pmf[idx]
            w_em = st["bpdf"] / torch.clamp(st["bpdf"] + pmf_hit * light_pdf, min=1e-12)
        else:
            ns_e = lsamp.to(torch.float32) + K_BSDF_SAMPLES
            c_b = K_BSDF_SAMPLES / ns_e
            c_l = lsamp.to(torch.float32) / ns_e
            w_em = c_b * st["bpdf"] / torch.clamp(
                c_b * st["bpdf"] + c_l * light_pdf, min=1e-12
            )
        w_em = torch.where(st["rtype"] == SPECULAR, 1.0, w_em)
        add_em = act_hit & (first | has_area)
        w_first = torch.ones_like(w_em) if first else w_em
        rad = rad + torch.where(
            add_em[..., None], w_first[..., None] * thr * m.emission, zeros3
        )

        # next-event estimation
        nee = sample_lights(
            scene, m, st["eta"], out_eta, p, n, -d, times,
            Prefixed(kb, 1), light_sampling=light_sampling,
        )
        rad = rad + torch.where(act_hit[..., None], thr * nee, zeros3)

        # terminate on explicit light sources
        alive = act_hit & (lsamp == 0)

        # BSDF sampling for the next bounce
        u_axis, v_axis = basis_from_vector(n)
        uni = [kb.uniform((2, k), (r,)) for k in range(6)]
        l, new_pdf, ev = bsdf_sample(m, st["eta"], out_eta, u_axis, v_axis, n, -d, uni)
        alive = alive & (new_pdf > 0.0)
        f_val = bsdf_eval(m, st["eta"], out_eta, n, -d, l)

        trans_side = dot(l, n) <= 0.0
        eta = torch.where(alive & trans_side, out_eta, st["eta"])
        absorb = torch.where((alive & trans_side)[..., None], out_absorb, st["absorb"])

        thr_next = thr * f_val * (
            torch.abs(dot(n, l)) / torch.clamp(new_pdf, min=1e-12)
        )[..., None]
        thr = torch.where(alive[..., None], thr_next, thr)

        if rr_depth > 0 and i + 1 >= rr_depth:
            q = torch.clamp(thr.detach().max(dim=-1).values, RR_MIN_Q, 1.0)
            u_rr = kb.uniform((3,), (r,))
            alive = alive & (u_rr < q)
            thr = torch.where(alive[..., None], thr / q[..., None], thr)

        o = torch.where(alive[..., None], p + face_forward(n, l) * RAY_EPS, o)
        d = torch.where(alive[..., None], l, d)

        return dict(
            o=o,
            d=d,
            eta=eta,
            absorb=absorb,
            rtype=torch.where(alive, ev, st["rtype"]),
            bpdf=torch.where(alive, new_pdf, st["bpdf"]),
            thr=thr,
            rad=rad,
            alive=alive,
        )

    return bounce


def path_trace(scene: SceneFlat, origins, dirs, times, max_depth: int, source,
               rr_depth: int = 0, light_sampling: str = "all"):
    """Trace a batch of paths; returns (R, 3) radiance.

    origins/dirs: (R, 3); times: (R,); source: the UniformSource of this
    batch (the JAX package's ``fold_in(key, 2)`` of the pass)."""
    r = origins.shape[0]
    bounce = _make_bounce(scene, times, source, r, rr_depth, light_sampling)
    state = _initial_state(origins, dirs)
    for i in range(max_depth):
        with span("integrator.bounce", i=i):
            state = bounce(state, i)
            if i + 1 < max_depth:
                # dead-bounce skip (changes no value); one host sync a bounce
                count_sync()
                if not bool(state["alive"].any()):
                    break
    return state["rad"]


@torch.no_grad()
def path_trace_while(scene: SceneFlat, origins, dirs, times, max_depth: int, source,
                     rr_depth: int = 0, light_sampling: str = "all"):
    """Forward-only form of ``path_trace`` (the JAX package's
    ``lax.while_loop`` backend): the same bounce, no autograd graph, the
    loop leaving once every lane is dead. Equal to ``path_trace`` at equal
    draws."""
    return path_trace(scene, origins, dirs, times, max_depth, source,
                      rr_depth=rr_depth, light_sampling=light_sampling)


def trace_normals(scene: SceneFlat, origins, dirs, times):
    """Normals debug view: n * 0.5 + 0.5 of the shading normal the
    integrator uses (bumped where the material has a bump map), black on a
    miss."""
    hit = trace_closest(scene, origins, dirs, times)
    found = hit.prim >= 0
    n = hit.normal
    if scene.has_bump:
        t_safe = torch.where(found, hit.t, 0.0)
        bmp = scene.prim_bump[torch.clamp(hit.prim, min=0).long()]
        n = bump_normal(n, origins + dirs * t_safe[..., None], bmp[..., 0], bmp[..., 1])
    n = n * 0.5 + 0.5
    return torch.where(found[..., None], n, torch.zeros_like(n))


@torch.no_grad()
def traversal_costs(scene: SceneFlat, origins, dirs, times):
    """(R,) f32 traversal cost per ray: each big mesh primitive adds its
    walk's step count with tmax = +inf in its local frame (kernel K7, one
    launch over every big-mesh primitive with per-lane offsets), a mesh of
    at most BLOCK_SIZE triangles adds its padded triangle count, every other
    primitive adds 1. Integer-valued, so the order of the sum is exact."""
    r = origins.shape[0]
    cost = torch.zeros((r,), dtype=torch.float32, device=origins.device)
    big = []
    for i, ps in enumerate(scene.prim_static):
        if ps.type != MESH:
            cost = cost + 1.0
        elif ps.mesh.num_tris <= BLOCK_SIZE:
            cost = cost + float(ps.mesh.num_tris)
        else:
            big.append(i)
    if big:
        _, o_l, d_l = _local_rays(scene, big, origins, dirs, times)
        noff, toff, slots = _offsets([scene.prim_static[i].mesh for i in big], origins.device)
        steps = ops_bvh.traversal_steps(
            scene.pool, lane_offsets(noff, r), lane_offsets(toff, r),
            o_l.reshape(-1, 3).contiguous(), d_l.reshape(-1, 3).contiguous(), slots,
        )
        cost = cost + steps.reshape(len(big), r).sum(dim=0)
    return cost


def trace_complexity(scene: SceneFlat, origins, dirs, times, scale: float = 256.0):
    """Traversal-cost heat view: ``traversal_costs`` mapped through an HSV
    blue -> red ramp, saturating at ``scale``."""
    x = torch.clamp(traversal_costs(scene, origins, dirs, times) / scale, 0.0, 1.0)
    one = torch.ones_like(x)
    return hsv_to_rgb((1.0 - x) * 2.0 / 3.0, one, one)
