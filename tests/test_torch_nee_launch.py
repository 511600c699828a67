"""NEE's dispatch (ops/nee.py) on the CPU: which path ``sample_lights``
takes, what its kernel wrappers hand the C interface, the counters, and
that the plain functions, composed as ``sample_lights`` composes them,
give the values of the eager chain they came from bit for bit. The
kernels themselves run in tests/test_torch_nee_cuda.py on the card.

"The card" is simulated where a test needs it: ``nee._on_card`` says yes
for CPU tensors, and either the library's entry points are replaced by a
recorder, so the wrappers run up to the C call, or the kernels are
emulated by their plain versions, so the autograd.Functions around them
run here and their gradients can be held against the plain path's.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import pytest
import torch

import nee_cases as cases
from tinsel_tpu_torch.bsdf.disney import bsdf_eval, bsdf_pdf
from tinsel_tpu_torch.core.math import dot, face_forward, length_sq, safe_normalize, \
    transform_point, transform_vector
from tinsel_tpu_torch.core.sampling import NumpyUniforms, Prefixed, uniform_sample_sphere, \
    uniform_sample_triangle
from tinsel_tpu_torch.core.search import lower_bound
from tinsel_tpu_torch.ops import nee
from tinsel_tpu_torch.render import lights, trace
from tinsel_tpu_torch.render.probe import probe_sample_uniforms
from tinsel_tpu_torch.scene.model import MESH, SPHERE

torch.set_num_threads(1)
R = 257


@pytest.fixture(scope="module")
def cornell():
    return cases.cornell_lights().flatten(device="cpu")


@pytest.fixture(scope="module")
def envmesh():
    return cases.envmesh_probe(samples=3, detail=12).flatten(device="cpu")


# ------------------------------------------ the eager chain, as it was


def _present_primitive_sample(scene, j, times, uniforms):
    ps = scene.prim_static[j]
    tr = trace.prim_transform(scene, j, times)
    u0, u1, u2 = uniforms
    shape = times.shape
    if ps.type == SPHERE:
        radius = scene.prims.radius[j]
        d = uniform_sample_sphere(u0, u1)
        pos = transform_point(tr, d * radius)
        normal = safe_normalize(pos - tr.p)
        area = 4.0 * math.pi * (radius * tr.s) ** 2
    else:
        assert ps.type == MESH
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
    return pos, normal, area * torch.ones(shape, dtype=torch.float32, device=times.device)


def _present_probe_nee(scene, mat, eta_i, eta_o, p, n, wo, times, source):
    shape = tuple(times.shape)
    r1 = source.uniform((0,), shape)
    r2 = source.uniform((1,), shape)
    wi, sky_color, sky_pdf = probe_sample_uniforms(scene.probe, r1, r2)
    shadow_o = p + face_forward(n, wi) * lights.RAY_EPS
    visible = ~trace.trace_any(scene, shadow_o, wi, times,
                               torch.full(shape, math.inf, device=p.device))
    bpdf = bsdf_pdf(mat, eta_i, eta_o, n, wo, wi)
    f = bsdf_eval(mat, eta_i, eta_o, n, wo, wi)
    c_bsdf, c_sky = 0.5, 0.5
    weight = c_sky * sky_pdf / torch.clamp(c_bsdf * bpdf + c_sky * sky_pdf, min=1e-12)
    contrib = ((weight * torch.abs(dot(wi, n)) / torch.clamp(sky_pdf, min=1e-12))[..., None]
               * sky_color * f)
    ok = visible & (bpdf > 0.0) & (sky_pdf > 0.0) & (weight > 0.0)
    return torch.where(ok[..., None], contrib, torch.zeros_like(contrib)) / 1.0


def _present_sample_lights(scene, mat, eta_i, eta_o, p, n, wo, times, source, closest):
    """render/lights.py::sample_lights before its steps moved to
    ops/nee.py ("all" mode)."""
    total = torch.zeros_like(p)
    shape = tuple(times.shape)
    draw = 0
    if scene.probe is not None:
        total = total + _present_probe_nee(scene, mat, eta_i, eta_o, p, n, wo, times,
                                           Prefixed(source, draw))
        draw += 1
    for j in scene.light_indices:
        n_samples = scene.prim_static[j].light_samples
        lj = torch.zeros_like(p)
        for s in range(n_samples):
            ks = Prefixed(source, draw, s)
            uni = [ks.uniform((k,), shape) for k in range(3)]
            light_pos, light_nrm, area = _present_primitive_sample(scene, j, times, uni)
            wi_un = light_pos - p
            dist = torch.sqrt(torch.clamp(length_sq(wi_un), min=1e-20))
            wi = wi_un / dist[..., None]
            shadow_o = p + face_forward(n, wi) * lights.RAY_EPS
            if closest:
                accept, light_t, emission = lights._closest_shadow(scene, shadow_o, wi, times,
                                                                   dist)
            else:
                occ = trace.trace_any(scene, shadow_o, wi, times,
                                      torch.clamp(dist - lights.PORTAL_TOL, min=0.0))
                accept = ~occ
                light_t = dist
                emission = torch.broadcast_to(scene.materials.emission[j], p.shape)
            nl = torch.abs(dot(light_nrm, wi))
            accept = accept & (nl >= 1e-6)
            light_pdf = (light_t * light_t) / torch.clamp(area * nl, min=1e-12)
            bpdf = bsdf_pdf(mat, eta_i, eta_o, n, wo, wi)
            f = bsdf_eval(mat, eta_i, eta_o, n, wo, wi)
            accept = accept & (bpdf > 0.0)
            ns_ = n_samples + 1.0
            c_bsdf = 1.0 / ns_
            c_light = n_samples / ns_
            weight = c_light * light_pdf / torch.clamp(c_bsdf * bpdf + c_light * light_pdf,
                                                       min=1e-12)
            contrib = ((weight * torch.abs(dot(wi, n)) / torch.clamp(light_pdf, min=1e-3))
                       [..., None] * f * emission)
            lj = lj + torch.where(accept[..., None], contrib, torch.zeros_like(contrib))
        draw += 1
        total = total + lj / max(n_samples, 1)
    return total


def _present_power_nee(scene, mat, eta_i, eta_o, p, n, wo, times, source, closest):
    """render/lights.py::_power_nee before its steps moved to ops/nee.py."""
    shape = tuple(times.shape)
    li = list(scene.light_indices)
    pmf_l = torch.stack([scene.light_pmf[j] for j in li])
    cdf = torch.cumsum(pmf_l, dim=0)
    u = source.uniform((999,), shape)
    sel = torch.clamp(torch.searchsorted(cdf, u, right=True), 0, len(li) - 1)
    pos = torch.zeros_like(p)
    nrm = torch.zeros_like(p)
    area = torch.zeros(shape, dtype=torch.float32)
    pmf_sel = torch.zeros(shape, dtype=torch.float32)
    emission = torch.zeros_like(p)
    for jj, j in enumerate(li):
        kj = Prefixed(source, jj)
        pj, nj, aj = _present_primitive_sample(scene, j, times,
                                               [kj.uniform((k,), shape) for k in range(3)])
        m = sel == jj
        pos = torch.where(m[..., None], pj, pos)
        nrm = torch.where(m[..., None], nj, nrm)
        area = torch.where(m, aj, area)
        pmf_sel = torch.where(m, pmf_l[jj], pmf_sel)
        if not closest:
            emission = torch.where(m[..., None], scene.materials.emission[j], emission)
    wi_un = pos - p
    dist = torch.sqrt(torch.clamp(length_sq(wi_un), min=1e-20))
    wi = wi_un / dist[..., None]
    shadow_o = p + face_forward(n, wi) * lights.RAY_EPS
    if closest:
        accept, light_t, emission = lights._closest_shadow(scene, shadow_o, wi, times, dist)
    else:
        accept = ~trace.trace_any(scene, shadow_o, wi, times,
                                  torch.clamp(dist - lights.PORTAL_TOL, min=0.0))
        light_t = dist
    nl = torch.abs(dot(nrm, wi))
    accept = accept & (nl >= 1e-6) & (pmf_sel > 0.0)
    light_pdf = pmf_sel * (light_t * light_t) / torch.clamp(area * nl, min=1e-12)
    bpdf = bsdf_pdf(mat, eta_i, eta_o, n, wo, wi)
    f = bsdf_eval(mat, eta_i, eta_o, n, wo, wi)
    accept = accept & (bpdf > 0.0)
    weight = light_pdf / torch.clamp(bpdf + light_pdf, min=1e-12)
    contrib = ((weight * torch.abs(dot(wi, n)) / torch.clamp(light_pdf, min=1e-3))[..., None]
               * f * emission)
    return torch.where(accept[..., None], contrib, torch.zeros_like(contrib))


@pytest.mark.parametrize("closest", [False, True], ids=["occlusion", "closest"])
@pytest.mark.parametrize("which", ["cornell", "envmesh"])
def test_plain_power_mode_keeps_the_present_values(which, closest, request, monkeypatch):
    flat = request.getfixturevalue(which)
    monkeypatch.setattr(lights, "NEE_CLOSEST_SHADOW", closest)
    m, eta_i, eta_o, p, n, wo, times = cases.bounce_inputs(flat, R, 9, "cpu")
    src = NumpyUniforms(2025, "cpu")
    with torch.no_grad():
        got = lights.sample_lights(flat, m, eta_i, eta_o, p, n, wo, times, src,
                                   light_sampling="power")
        want = torch.zeros_like(p)
        draw = 0
        if flat.probe is not None:
            want = want + _present_probe_nee(flat, m, eta_i, eta_o, p, n, wo, times,
                                             Prefixed(src, 0))
            draw = 1
        want = want + _present_power_nee(flat, m, eta_i, eta_o, p, n, wo, times,
                                         Prefixed(src, draw), closest)
    assert torch.equal(got, want)
    assert (got != 0).any()


@pytest.mark.parametrize("closest", [False, True], ids=["occlusion", "closest"])
@pytest.mark.parametrize("which", ["cornell", "envmesh"])
def test_plain_path_keeps_the_present_values(which, closest, request, monkeypatch):
    flat = request.getfixturevalue(which)
    monkeypatch.setattr(lights, "NEE_CLOSEST_SHADOW", closest)
    args = cases.bounce_inputs(flat, R, 7, "cpu")
    src = NumpyUniforms(2024, "cpu")
    with torch.no_grad():
        got = lights.sample_lights(flat, *args, src)
        want = _present_sample_lights(flat, *args, src, closest)
    assert torch.equal(got, want)
    assert (got != 0).any()


def test_plain_light_sample_is_the_present_primitive_sample(cornell):
    times = torch.from_numpy(np.random.default_rng(0).random(R, dtype=np.float32))
    src = NumpyUniforms(5, "cpu")
    for j in cornell.light_indices:
        uni = [src.uniform((j, k), (R,)) for k in range(3)]
        tr = trace.prim_transform(cornell, j, times)
        got = nee.sample_point(cornell, j, tr, times, uni)
        want = _present_primitive_sample(cornell, j, times, uni)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert torch.equal(lights.primitive_sample(cornell, j, times, uni)[0], want[0])


# ------------------------------------------------------------ dispatch


class _Library:
    """Stands in for the built library: records each entry's arguments."""

    def __init__(self):
        self.calls = []

    def entry(self, kernel):
        def fn(args_ref, stream):
            a = args_ref._obj
            self.calls.append((kernel, {f: getattr(a, f) for f, _ in a._fields_
                                        if f not in ("tri", "nrm")}))
            if kernel == "nee_light":  # outputs of zeros
                for f, width in (("shadow_o", 3), ("wi", 3), ("dist", 1), ("tmax", 1),
                                 ("area_nl", 1)):
                    ctypes.memset(getattr(a, f), 0, 4 * width * a.lanes)
            return 0
        return fn


@pytest.fixture
def card(monkeypatch):
    """CPU tensors taken for the card's: the wrappers run up to the C call,
    which a recorder takes."""
    lib = _Library()
    monkeypatch.setattr(nee, "_on_card", lambda t: True)
    monkeypatch.setattr(nee, "_entry", lib.entry)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: _Stream())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    nee.reset_launch_counts()
    return lib


def _samples(flat):
    return int(flat.probe is not None) + sum(flat.prim_static[j].light_samples
                                             for j in flat.light_indices)


def test_cpu_takes_the_plain_path(envmesh, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a kernel was called on the CPU")

    monkeypatch.setattr(nee, "_light_kernel", refuse)
    monkeypatch.setattr(nee, "_shade_kernel", refuse)
    nee.reset_launch_counts()
    args = cases.bounce_inputs(envmesh, R, 1, "cpu")
    with torch.no_grad():
        lights.sample_lights(envmesh, *args, NumpyUniforms(1, "cpu"))
        lights.sample_lights(envmesh, *args, NumpyUniforms(1, "cpu"), light_sampling="power")
    p = args[3].clone().requires_grad_(True)
    with torch.enable_grad():
        lights.sample_lights(envmesh, *args[:3], p, *args[4:], NumpyUniforms(1, "cpu"))
    assert nee.launch_counts == {"nee_light": 0, "nee_shade": 0}
    assert not nee.fuses(torch.zeros(3))
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        nee.light_sample(envmesh, envmesh.light_indices[0], None, args[3], args[4], args[6],
                         [args[6]] * 3)


@pytest.mark.parametrize("which", ["cornell", "envmesh"])
def test_the_card_takes_the_kernels_once_a_sample(which, request, card):
    flat = request.getfixturevalue(which)
    with torch.no_grad():
        lights.sample_lights(flat, *cases.bounce_inputs(flat, R, 1, "cpu"),
                             NumpyUniforms(1, "cpu"))
    lights_samples = sum(flat.prim_static[j].light_samples for j in flat.light_indices)
    probe = int(flat.probe is not None)
    assert nee.launch_counts == {"nee_light": lights_samples, "nee_shade": lights_samples + probe}
    kinds = [k for k, _ in card.calls]
    assert kinds.count("nee_light") == lights_samples
    assert kinds.count("nee_shade") == lights_samples + probe


def test_light_arguments_reach_the_kernel(cornell, card):
    m, eta_i, eta_o, p, n, wo, times = cases.bounce_inputs(cornell, R, 2, "cpu")
    src = NumpyUniforms(3, "cpu")
    uni = [src.uniform((k,), (R,)) for k in range(3)]
    for j in cornell.light_indices:
        tr = trace.prim_transform(cornell, j, times)
        out = nee.light_sample(cornell, j, tr, p, n, times, uni)
        kernel, a = card.calls[-1]
        ps = cornell.prim_static[j]
        assert kernel == "nee_light" and a["lanes"] == R
        assert a["tr_lanes"] == int(ps.motion) and a["mesh"] == int(ps.type == MESH)
        assert (a["p"], a["n"], a["u0"], a["u2"]) == (p.data_ptr(), n.data_ptr(),
                                                    uni[0].data_ptr(), uni[2].data_ptr())
        assert (a["shadow_o"], a["area_nl"]) == (out.shadow_o.data_ptr(),
                                                 out.area_nl.data_ptr())
        assert out.shadow_o.shape == (R, 3) and out.tmax.shape == (R,)
        if ps.type == MESH:
            h = ps.mesh
            assert (a["tri_offset"], a["num_tris"]) == (h.tri_offset, h.num_tris)
            assert a["steps"] == int(np.ceil(np.log2(h.num_tris))) + 1
            assert a["cdf_last"] == cornell.pool.tri_cdf.shape[0] - 1
            assert a["mesh_area"] == pytest.approx(h.area, rel=1e-7)
        else:
            assert a["radius"] == cornell.prims.radius[j].data_ptr()


@pytest.mark.parametrize("probe", [False, True])
def test_shade_arguments_reach_the_kernel(cornell, card, probe):
    m, eta_i, eta_o, p, n, wo, times = cases.bounce_inputs(cornell, R, 2, "cpu")
    vis = torch.zeros(R, dtype=torch.bool)
    t = torch.ones(R)
    emission = torch.ones(R, 3) if probe else cornell.materials.emission[5]
    out = torch.zeros(R, 3)
    pmf = None if probe else torch.full((R,), 0.5)
    got = nee.shade(m, eta_i, eta_o, n, wo, n, vis, True, t, None if probe else t, emission,
                    0.25, 0.75, 1e-12 if probe else 1e-3, out, probe=probe, pmf=pmf)
    kernel, a = card.calls[-1]
    assert got is out
    assert kernel == "nee_shade" and a["lanes"] == R and a["out"] == out.data_ptr()
    assert (a["probe"], a["emission_lanes"], a["occludes"]) == (int(probe), int(probe), 1)
    assert (a["c_bsdf"], a["c_light"]) == (0.25, 0.75)
    assert a["pdf_floor"] == np.float32(1e-12 if probe else 1e-3)
    assert (a["area_nl"] is None) == probe
    assert a["pmf"] == (None if probe else pmf.data_ptr())
    assert a["color"] == m.color.data_ptr() and a["vis"] == vis.data_ptr()
    with pytest.raises(ValueError, match="area lights only"):
        nee.shade(m, eta_i, eta_o, n, wo, n, vis, True, t, None, emission, 0.5, 0.5, 1e-12,
                  out, probe=True, pmf=torch.ones(R))


@pytest.fixture
def emulated(monkeypatch):
    """CPU tensors taken for the card's, each kernel emulated by its plain
    version outside autograd (an in-place sum for K9), so that the
    dispatch and the autograd.Functions around the kernels run here."""
    monkeypatch.setattr(nee, "_on_card", lambda t: True)

    def light(scene, j, tr, p, n, uniforms):
        assert not torch.is_grad_enabled()
        nee.launch_counts["nee_light"] += 1
        return nee.light_sample_plain(scene, j, tr, p, n, p[:, 0], uniforms)

    def shade(static, out, eta_i, eta_o, n, wo, wi, light_t, area_nl, emission, pmf, *fields):
        assert not torch.is_grad_enabled()
        mat, vis, occludes, c_bsdf, c_light, pdf_floor, probe = static
        m = dataclasses.replace(mat, **dict(zip(nee._MATERIAL, fields)))
        nee.launch_counts["nee_shade"] += 1
        out += nee.shade_plain(m, eta_i, eta_o, n, wo, wi, vis, occludes, light_t, area_nl,
                               emission, c_bsdf, c_light, pdf_floor, probe, pmf)

    monkeypatch.setattr(nee, "_light_kernel", light)
    monkeypatch.setattr(nee, "_shade_kernel", shade)
    nee.reset_launch_counts()


@pytest.mark.parametrize("closest", [False, True], ids=["occlusion", "closest"])
@pytest.mark.parametrize("case", ["cornell", "envmesh", "cornell-vertex"])
def test_grad_takes_the_plain_path(case, closest, request, monkeypatch):
    """Under autograd on the card the kernels run forward (launch counts)
    and the gradient is the plain path's: value bit for bit (the emulated
    kernels are the plain versions), gradients to rounding."""
    which, vertex = case.split("-")[0], case.endswith("vertex")
    monkeypatch.setattr(lights, "NEE_CLOSEST_SHADOW", closest)
    monkeypatch.setattr(trace, "MESH_VERTEX_GRADS", vertex)
    flat = cases.leaf_scene(request.getfixturevalue(which), vertex)
    args = cases.bounce_inputs(flat, R, 4, "cpu")
    want, want_g = cases.nee_grads(flat, args, "all", NumpyUniforms(4, "cpu"))
    request.getfixturevalue("emulated")
    got, got_g = cases.nee_grads(flat, args, "all", NumpyUniforms(4, "cpu"))
    lights_samples = sum(flat.prim_static[j].light_samples for j in flat.light_indices)
    probe = int(flat.probe is not None)
    assert nee.launch_counts == {"nee_light": lights_samples, "nee_shade": lights_samples + probe}
    assert torch.equal(got, want) and (want != 0).any()
    for g, w in zip(got_g, want_g):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    assert sum(bool((w != 0).any()) for w in want_g) >= 8


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_power_mode_takes_the_plain_path(cornell, emulated, monkeypatch, grad):
    """On the CPU power mode's sample is the plain chain (kept bit for bit,
    above); on the card it is one K8 a light and one K9, and under autograd
    its gradient is the plain chain's."""
    args = cases.bounce_inputs(cornell, R, 5, "cpu")
    with torch.no_grad():
        got = lights.sample_lights(cornell, *args, NumpyUniforms(5, "cpu"),
                                   light_sampling="power")
    assert nee.launch_counts == {"nee_light": len(cornell.light_indices), "nee_shade": 1}
    monkeypatch.setattr(nee, "_on_card", lambda t: False)
    with torch.no_grad():
        want = lights.sample_lights(cornell, *args, NumpyUniforms(5, "cpu"),
                                    light_sampling="power")
    assert torch.equal(got, want) and (want != 0).any()
    if grad:
        flat = cases.leaf_scene(cornell, False)
        want, want_g = cases.nee_grads(flat, args, "power", NumpyUniforms(5, "cpu"))
        monkeypatch.setattr(nee, "_on_card", lambda t: True)
        got, got_g = cases.nee_grads(flat, args, "power", NumpyUniforms(5, "cpu"))
        assert torch.equal(got, want)
        for g, w in zip(got_g, want_g):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
