"""Next-event estimation as CUDA kernels, and its dispatchers.

One light sample of ``render/lights.py::sample_lights`` was some 470
eager torch launches on (R,) and (R, 3) tensors: the sample on the light,
the shadow ray, the Disney BSDF's pdf and value, the MIS weight and the
masked sum. Here it is two kernels around the shadow-ray trace, which
stays as it is (``trace_any``, or ``_closest_shadow`` under
``NEE_CLOSEST_SHADOW``):

- K8, ``light_sample`` (``csrc/nee.cu::nee_light_kernel``): one sample on
  light primitive j at the light's transform ``tr`` (a sphere, or a mesh
  through its area CDF) and its shadow ray from p, one thread a lane.
  Returns ``LightSample``: the ray (``shadow_o``, ``wi``), the light
  distance ``dist``, the occlusion bound ``tmax = max(dist - PORTAL_TOL,
  0)`` and ``area_nl``, the light's area times |n_l . wi|, or ``REJECTED``
  where |n_l . wi| < 1e-6 (no contribution).
- K9, ``shade`` (``nee_shade_kernel``): one sample's BSDF pdf and value
  (``bsdf/disney.py``, the whole Disney form), light pdf, balance-heuristic
  weight and acceptance, its contribution added in place to an (R, 3)
  accumulator. The probe's sample (``probe=True``) takes its pdf and
  per-lane radiance from the probe and adds its own acceptance terms;
  power mode's sample multiplies the light pdf by each lane's
  light-selection probability (``pmf``).

The JAX package has no kernel here (XLA fuses the chain); the kernels
replace none of its Pallas kernels. Both are bounded by device-memory
bytes: K8 reads 36 bytes a lane (68 where the light moves) and writes 36,
K9 reads 109 (121 with per-lane emission, 4 more with ``pmf``) and writes
the accumulator's 12;
every intermediate stays in registers. ``csrc/nee.cu`` follows the eager
chain's order of operations as the card computes it, so K8's shadow ray
equals the plain version's bit for bit there and K9 equals it to the last
bits (its note says how).

The plain versions (``light_sample_plain``, ``shade_plain``) are the
eager chain itself, differentiable. ``fuses`` is the dispatch rule: the
kernels take the lanes wherever they lie on CUDA, the plain versions run
on the CPU. Where a gradient is asked, each kernel runs as the forward of
an autograd.Function whose backward recomputes its plain version from the
saved inputs and takes that gradient (``ops/nlm.py``'s pattern): the
gradient is the plain chain's, and no sample's eager chain runs forward.
The CUDA wrappers raise on tensors elsewhere.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..bsdf.disney import bsdf_eval, bsdf_pdf
from ..core.math import Transform, dot, face_forward, length_sq, safe_normalize, \
    transform_point, transform_vector
from ..core.sampling import uniform_sample_sphere, uniform_sample_triangle
from ..core.search import lower_bound
from ..scene.model import MESH, SPHERE
from . import _build

# Launches per kernel since the last reset; a wrapper adds one where it
# launches its kernel and nowhere else.
launch_counts = {"nee_light": 0, "nee_shade": 0}
RAY_EPS = 1e-4  # kRayEpsilon
PORTAL_TOL = 1e-2  # kTolerance
REJECTED = -1.0  # area_nl where the sample faces away: never a product of areas

_entries: dict = {}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


class LightSample(NamedTuple):
    shadow_o: torch.Tensor  # (R, 3)
    wi: torch.Tensor  # (R, 3) unit direction to the light point
    dist: torch.Tensor  # (R,)
    tmax: torch.Tensor  # (R,) max(dist - PORTAL_TOL, 0)
    area_nl: torch.Tensor  # (R,) area * |n_l . wi|, REJECTED where that cosine < 1e-6


# ------------------------------------------------------------- dispatch


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


def needs_grad(*xs) -> bool:
    """Whether autograd would record through any tensor in ``xs`` (tensors,
    or dataclasses and tuples of them)."""
    return torch.is_grad_enabled() and any(t.requires_grad for x in xs for t in _tensors(x))


def _on_card(t) -> bool:
    return t.device.type == "cuda"


def fuses(p) -> bool:
    """The dispatch rule of NEE: the kernels where the lanes (``p``) lie on
    CUDA, with or without a gradient asked; the plain versions on the CPU."""
    return _on_card(p)


# ------------------------------------------------------- plain versions


def sample_point(scene, j: int, tr, times, uniforms, vertex_grads: bool = False):
    """Uniform-area sample on light primitive j at its transform ``tr``
    (``render/trace.py::prim_transform`` at the rays' times), from three
    uniforms ``(u0, u1, u2)``. Returns world-space (pos (R,3), normal
    (R,3), area (R,)), the area at the interpolated scale. A mesh light's
    vertices and normals are detached unless ``vertex_grads``
    (``trace.MESH_VERTEX_GRADS``): its position and size gradients flow
    through the transform."""
    return _sample_point(scene.prim_static[j], scene.prims.radius, scene.pool, j, tr, times,
                         uniforms, vertex_grads)


def _sample_point(ps, radii, pool, j: int, tr, times, uniforms, vertex_grads: bool):
    """``sample_point`` of light j, static record ``ps``, from the scene's
    radius table ``radii`` and mesh pool ``pool``."""
    u0, u1, u2 = uniforms
    shape = times.shape

    if ps.type == SPHERE:
        radius = radii[j]
        d = uniform_sample_sphere(u0, u1)
        pos = transform_point(tr, d * radius)
        normal = safe_normalize(pos - tr.p)
        area = 4.0 * math.pi * (radius * tr.s) ** 2
    elif ps.type == MESH:
        h = ps.mesh
        lo = torch.full(shape, h.tri_offset, dtype=torch.int32, device=times.device)
        tri = lower_bound(pool.tri_cdf, lo, h.num_tris, u0)
        tri = torch.clamp(tri, h.tri_offset, h.tri_offset + h.num_tris - 1).long()
        bu, bv = uniform_sample_triangle(u1, u2)
        bw = 1.0 - bu - bv
        rows = pool.gather_tri(tri) + pool.gather_normals(tri)
        a, b, c, n0, n1, n2 = rows if vertex_grads else tuple(x.detach() for x in rows)
        pos_l = bu[..., None] * a + bv[..., None] * b + bw[..., None] * c
        nrm_l = bu[..., None] * n0 + bv[..., None] * n1 + bw[..., None] * n2
        pos = transform_point(tr, pos_l)
        normal = safe_normalize(transform_vector(tr, nrm_l))
        area = h.area * tr.s * tr.s
    else:
        raise ValueError("plane primitives cannot be area lights")
    return pos, normal, area * torch.ones(shape, dtype=torch.float32, device=times.device)


def light_sample_plain(scene, j: int, tr, p, n, times, uniforms,
                       vertex_grads: bool = False) -> LightSample:
    """K8's plain version: ``sample_point`` and the shadow ray from p
    (offset along n, faced towards the light)."""
    return _light_sample_plain(scene.prim_static[j], scene.prims.radius, scene.pool, j, tr, p,
                               n, times, uniforms, vertex_grads)


def _light_sample_plain(ps, radii, pool, j: int, tr, p, n, times, uniforms,
                        vertex_grads: bool) -> LightSample:
    light_pos, light_nrm, area = _sample_point(ps, radii, pool, j, tr, times, uniforms,
                                               vertex_grads)
    wi_un = light_pos - p
    dist = torch.sqrt(torch.clamp(length_sq(wi_un), min=1e-20))
    wi = wi_un / dist[..., None]
    shadow_o = p + face_forward(n, wi) * RAY_EPS
    # segment occlusion: anything strictly before the sampled point (minus
    # the portal tolerance) blocks
    tmax = torch.clamp(dist - PORTAL_TOL, min=0.0)
    nl = torch.abs(dot(light_nrm, wi))
    area_nl = torch.where(nl >= 1e-6, area * nl, REJECTED)
    return LightSample(shadow_o, wi, dist, tmax, area_nl)


def shade_plain(mat, eta_i, eta_o, n, wo, wi, vis, occludes: bool, light_t, area_nl,
                emission, c_bsdf: float, c_light: float, pdf_floor: float,
                probe: bool = False, pmf=None):
    """K9's plain version: one sample's (R, 3) contribution, zero where not
    accepted. ``vis`` is the shadow ray's (R,) bool, an occlusion where
    ``occludes`` (then True blocks), else an acceptance. An area light
    (``probe`` False): the light pdf is light_t^2 / (area * n_l.wi)
    (``area_nl``), times the lane's light-selection probability ``pmf``
    (R,) where one is given (power mode; a lane needs pmf > 0), the
    contribution weight * |wi.n| / max(pdf, pdf_floor) * f * emission. The
    probe (``area_nl`` None): ``light_t`` is its pdf, ``emission`` its
    per-lane radiance, the product weight * |wi.n| / max(pdf, pdf_floor) *
    emission * f, and a lane needs pdf > 0 and weight > 0 besides.
    ``emission`` is one (3,) row or (R, 3)."""
    accept = ~vis if occludes else vis
    if probe:
        pdf = light_t
    else:
        accept = accept & (area_nl != REJECTED)
        tt = light_t * light_t
        if pmf is not None:
            accept = accept & (pmf > 0.0)
            tt = pmf * tt
        pdf = tt / torch.clamp(area_nl, min=1e-12)
    bpdf = bsdf_pdf(mat, eta_i, eta_o, n, wo, wi)
    f = bsdf_eval(mat, eta_i, eta_o, n, wo, wi)
    accept = accept & (bpdf > 0.0)
    weight = c_light * pdf / torch.clamp(c_bsdf * bpdf + c_light * pdf, min=1e-12)
    scale = (weight * torch.abs(dot(wi, n)) / torch.clamp(pdf, min=pdf_floor))[..., None]
    if probe:
        accept = accept & (pdf > 0.0) & (weight > 0.0)
        contrib = scale * emission * f
    else:
        contrib = scale * f * torch.broadcast_to(emission, f.shape)
    return torch.where(accept[..., None], contrib, torch.zeros_like(contrib))


# ------------------------------------------------------------- kernels

_P = ctypes.c_void_p


class _LightArgs(ctypes.Structure):
    """csrc/nee.cu's LightArgs, field for field."""
    _fields_ = [
        ("p", _P), ("n", _P), ("u0", _P), ("u1", _P), ("u2", _P),
        ("tp", _P), ("tq", _P), ("ts", _P), ("radius", _P), ("cdf", _P),
        ("tri", _P * 9), ("nrm", _P * 9),
        ("shadow_o", _P), ("wi", _P), ("dist", _P), ("tmax", _P), ("area_nl", _P),
        ("lanes", ctypes.c_int), ("tr_lanes", ctypes.c_int), ("mesh", ctypes.c_int),
        ("tri_offset", ctypes.c_int), ("num_tris", ctypes.c_int), ("steps", ctypes.c_int),
        ("cdf_last", ctypes.c_int), ("mesh_area", ctypes.c_float),
    ]


class _ShadeArgs(ctypes.Structure):
    """csrc/nee.cu's ShadeArgs, field for field."""
    _fields_ = [
        ("color", _P), ("specular", _P), ("specular_tint", _P), ("metallic", _P),
        ("roughness", _P), ("subsurface", _P), ("transmission", _P), ("clearcoat", _P),
        ("clearcoat_gloss", _P), ("eta_i", _P), ("eta_o", _P), ("n", _P), ("wo", _P),
        ("wi", _P), ("vis", _P), ("light_t", _P), ("area_nl", _P), ("emission", _P),
        ("pmf", _P), ("out", _P),
        ("lanes", ctypes.c_int), ("occludes", ctypes.c_int), ("probe", ctypes.c_int),
        ("emission_lanes", ctypes.c_int),
        ("c_bsdf", ctypes.c_float), ("c_light", ctypes.c_float), ("pdf_floor", ctypes.c_float),
    ]


_MATERIAL = ("color", "specular", "specular_tint", "metallic", "roughness", "subsurface",
             "transmission", "clearcoat", "clearcoat_gloss")


def _entry(kernel: str):
    fn = _entries.get(kernel)
    if fn is None:
        fn = getattr(_build.load("nee"), f"tinsel_{kernel}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]  # args, stream
        fn.restype = ctypes.c_int
        _entries[kernel] = fn
    return fn


def _launch(kernel: str, args, dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index is None or dev.index == torch.cuda.current_device():
        err = _entry(kernel)(ctypes.byref(args), stream)
    else:
        with torch.cuda.device(dev):
            err = _entry(kernel)(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err} "
                           f"({args.lanes} lanes)")
    launch_counts[kernel] += 1


def _f32(x, dev, shape, name: str):
    """``x`` as a contiguous f32 tensor of ``shape`` on ``dev`` (a view
    where it already is one)."""
    if not isinstance(x, torch.Tensor) or x.device != dev or x.dtype != torch.float32:
        raise ValueError(f"{name}: expected an f32 tensor on {dev}")
    if tuple(x.shape) != tuple(shape):
        x = torch.broadcast_to(x, shape)
    return x.contiguous()


def _cuda_lanes(what: str, p):
    if not _on_card(p):
        raise ValueError(f"{what}: expected CUDA tensors, got {p.device}")
    return p.device, p.shape[0]


def _leaves(ctx, skip: int):
    """A Function's saved tensors as fresh leaves, asking a gradient where
    its input did (``skip``: the inputs before them that are not tensors)."""
    return [None if t is None else t.detach().requires_grad_(need)
            for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[skip:])]


def _grads(ins, outs, grads):
    """The gradients of ``ins`` from ``outs`` against ``grads``, None where
    an input asks for none."""
    want = [t for t in ins if t is not None and t.requires_grad]
    pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
    got = iter(torch.autograd.grad([o for o, _ in pairs], want, [g for _, g in pairs],
                                   allow_unused=True) if pairs and want else [None] * len(want))
    return [next(got) if t is not None and t.requires_grad else None for t in ins]


def light_sample(scene, j: int, tr, p, n, times, uniforms,
                 vertex_grads: bool = False) -> LightSample:
    """Kernel K8: ``light_sample_plain`` on CUDA tensors, the shadow ray
    bit for bit. ``tr`` is the light's transform, one row or per lane.
    Where a gradient is asked of ``tr``, p, n, the radii or (with
    ``vertex_grads``) the mesh pool's planes, the plain version gives it."""
    _cuda_lanes("nee_light", p)
    pool = scene.pool
    planes = (*pool.tri_planes, *pool.nrm_planes) if vertex_grads else ()
    ins = (tr.p, tr.q, tr.s, p, n, scene.prims.radius, *planes)
    if needs_grad(*ins):
        return LightSample(*_LightSampleFn.apply((scene, j, times, uniforms, vertex_grads),
                                                 *ins))
    return _light_kernel(scene, j, tr, p, n, uniforms)


class _LightSampleFn(torch.autograd.Function):
    """K8 under autograd: the kernel forward, the plain version's gradient."""

    @staticmethod
    def forward(ctx, static, tp, tq, ts, p, n, radii, *planes):
        ctx.static = static
        scene, j, _, uniforms, _ = static
        ctx.save_for_backward(tp, tq, ts, p, n, radii, *planes)
        return tuple(_light_kernel(scene, j, Transform(p=tp, q=tq, s=ts), p, n, uniforms))

    @staticmethod
    def backward(ctx, *grads):
        scene, j, times, uniforms, vertex_grads = ctx.static
        ins = _leaves(ctx, 1)
        tp, tq, ts, p, n, radii, *planes = ins
        pool = scene.pool
        if planes:
            pool = dataclasses.replace(pool, tri_planes=tuple(planes[:9]),
                                       nrm_planes=tuple(planes[9:]))
        with torch.enable_grad():
            outs = _light_sample_plain(scene.prim_static[j], radii, pool, j,
                                       Transform(p=tp, q=tq, s=ts), p, n, times, uniforms,
                                       vertex_grads)
            return (None, *_grads(ins, outs, grads))


def _light_kernel(scene, j: int, tr, p, n, uniforms) -> LightSample:
    dev, r = _cuda_lanes("nee_light", p)
    ps = scene.prim_static[j]
    if ps.type not in (SPHERE, MESH):
        raise ValueError("plane primitives cannot be area lights")
    per_lane = tr.s.dim() == 1
    rows = (r,) if per_lane else ()
    tp = _f32(tr.p, dev, rows + (3,), "tr.p")
    tq = _f32(tr.q, dev, rows + (4,), "tr.q")
    ts = _f32(tr.s, dev, rows, "tr.s")
    p = _f32(p, dev, (r, 3), "p")
    n = _f32(n, dev, (r, 3), "n")
    u = [_f32(x, dev, (r,), f"u{k}") for k, x in enumerate(uniforms)]
    out = LightSample(*(torch.empty(s, dtype=torch.float32, device=dev)
                        for s in ((r, 3), (r, 3), (r,), (r,), (r,))))
    if r == 0:
        return out
    a = _LightArgs(p=p.data_ptr(), n=n.data_ptr(), u0=u[0].data_ptr(), u1=u[1].data_ptr(),
                   u2=u[2].data_ptr(), tp=tp.data_ptr(), tq=tq.data_ptr(), ts=ts.data_ptr(),
                   shadow_o=out.shadow_o.data_ptr(), wi=out.wi.data_ptr(),
                   dist=out.dist.data_ptr(), tmax=out.tmax.data_ptr(),
                   area_nl=out.area_nl.data_ptr(), lanes=r, tr_lanes=int(per_lane))
    if ps.type == SPHERE:
        a.radius = _f32(scene.prims.radius[j], dev, (), "radius").data_ptr()
    else:
        h, pool = ps.mesh, scene.pool
        planes = [_f32(x, dev, tuple(x.shape), "pool") for x in (*pool.tri_planes,
                                                                 *pool.nrm_planes)]
        cdf = _f32(pool.tri_cdf, dev, tuple(pool.tri_cdf.shape), "tri_cdf")
        a.mesh, a.cdf, a.cdf_last = 1, cdf.data_ptr(), cdf.shape[0] - 1
        a.tri_offset, a.num_tris, a.mesh_area = h.tri_offset, h.num_tris, h.area
        a.steps = int(np.ceil(np.log2(max(h.num_tris, 2)))) + 1  # core/search.py's
        for k in range(9):
            a.tri[k], a.nrm[k] = planes[k].data_ptr(), planes[9 + k].data_ptr()
    _launch("nee_light", a, dev)
    return out


def shade(mat, eta_i, eta_o, n, wo, wi, vis, occludes: bool, light_t, area_nl, emission,
          c_bsdf: float, c_light: float, pdf_floor: float, out, probe: bool = False,
          pmf=None):
    """Kernel K9: ``out + shade_plain(...)`` on CUDA tensors (``out`` (R, 3)
    f32), added to ``out`` in place and returned. Where a gradient is asked
    of an input, ``out`` is left as it is and the sum is a new tensor, the
    plain version's gradient behind it."""
    _cuda_lanes("nee_shade", n)
    fields = tuple(getattr(mat, k) for k in _MATERIAL)
    ins = (out, eta_i, eta_o, n, wo, wi, light_t, area_nl, emission, pmf, *fields)
    static = (mat, vis, occludes, c_bsdf, c_light, pdf_floor, probe)
    if needs_grad(*ins):
        return _ShadeFn.apply(static, *ins)
    _shade_kernel(static, *ins)
    return out


class _ShadeFn(torch.autograd.Function):
    """K9 under autograd: the kernel forward into a copy of the sum, the
    plain version's gradient."""

    @staticmethod
    def forward(ctx, static, out, *rest):
        ctx.static = static
        ctx.save_for_backward(*rest)
        out = out.clone()
        _shade_kernel(static, out, *rest)
        return out

    @staticmethod
    def backward(ctx, g):
        mat, vis, occludes, c_bsdf, c_light, pdf_floor, probe = ctx.static
        ins = _leaves(ctx, 2)
        eta_i, eta_o, n, wo, wi, light_t, area_nl, emission, pmf, *fields = ins
        m = dataclasses.replace(mat, **dict(zip(_MATERIAL, fields)))
        with torch.enable_grad():
            c = shade_plain(m, eta_i, eta_o, n, wo, wi, vis, occludes, light_t, area_nl,
                            emission, c_bsdf, c_light, pdf_floor, probe, pmf)
            return (None, g if ctx.needs_input_grad[1] else None, *_grads(ins, (c,), (g,)))


def _shade_kernel(static, out, eta_i, eta_o, n, wo, wi, light_t, area_nl, emission, pmf,
                  *fields):
    _, vis, occludes, c_bsdf, c_light, pdf_floor, probe = static
    dev, r = _cuda_lanes("nee_shade", n)
    if out.shape != (r, 3) or out.dtype != torch.float32 or not out.is_contiguous() \
            or out.device != dev:
        raise ValueError(f"nee_shade: out must be a contiguous f32 (R, 3) tensor on {dev}")
    if vis.shape != (r,) or vis.dtype != torch.bool or vis.device != dev:
        raise ValueError(f"nee_shade: vis must be an (R,) bool tensor on {dev}")
    if (area_nl is None) != probe or (probe and pmf is not None):
        raise ValueError("nee_shade: area_nl and pmf are given for area lights only")
    m = [_f32(x, dev, (r, 3) if k == "color" else (r,), k) for k, x in zip(_MATERIAL, fields)]
    rays = [_f32(x, dev, s, k) for x, s, k in ((eta_i, (r,), "eta_i"), (eta_o, (r,), "eta_o"),
                                                (n, (r, 3), "n"), (wo, (r, 3), "wo"),
                                                (wi, (r, 3), "wi"), (light_t, (r,), "light_t"))]
    emission_lanes = emission.dim() == 2
    em = _f32(emission, dev, (r, 3) if emission_lanes else (3,), "emission")
    anl = None if probe else _f32(area_nl, dev, (r,), "area_nl")
    sel = None if pmf is None else _f32(pmf, dev, (r,), "pmf")
    vis = vis.contiguous()
    if r == 0:
        return
    a = _ShadeArgs(*(x.data_ptr() for x in m), *(x.data_ptr() for x in rays[:5]),
                   vis.data_ptr(), rays[5].data_ptr(), 0 if anl is None else anl.data_ptr(),
                   em.data_ptr(), 0 if sel is None else sel.data_ptr(), out.data_ptr(), r,
                   int(occludes), int(probe), int(emission_lanes), c_bsdf, c_light, pdf_floor)
    _launch("nee_shade", a, dev)
