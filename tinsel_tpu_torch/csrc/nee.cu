// Next-event estimation for Hopper (sm_90a): kernels K8 (nee_light_kernel:
// one light sample and its shadow ray a lane) and K9 (nee_shade_kernel: one
// sample's shading, added to the light's (R, 3) accumulator in place).
//
// Replaces no TPU kernel. The JAX package's NEE (tinsel_tpu/render/
// lights.py:sample_lights) is plain JAX that XLA fuses; in the port it was
// an eager torch chain of some 470 launches a light sample, each moving a
// few bytes a lane and waiting on the host. K8 computes
// ops/nee.py::light_sample_plain (render/lights.py's sample on a sphere or
// through a mesh's area CDF, then the shadow ray); K9 computes
// ops/nee.py::shade_plain (bsdf/disney.py's bsdf_pdf and bsdf_eval, the
// light pdf, the balance-heuristic weight, the acceptance mask, the
// contribution). The shadow-ray trace between them stays in the caller.
//
// Bound: device-memory bytes. K8 reads p, n, three uniforms (36 bytes a
// lane), the light's transform (none, or 32 bytes a lane when it moves)
// and on a mesh some log2(T) CDF entries and 72 bytes of its triangle;
// writes 36. K9 reads 44 bytes of material, 8 of refractive indices, 36 of
// n, wo and wi, 9 of visibility and the light's terms (12 more with
// per-lane emission, 4 with power mode's selection pmf) and reads and
// writes 12 of the accumulator. Its some
// 300 operations and 14 IEEE divisions a lane are far below the card's
// rate. One thread a lane, every intermediate in registers.
//
// Rounding: compiled with -fmad=false, and every expression follows the
// eager chain's order of operations as PyTorch's CUDA kernels compute it,
// so K8's shadow ray (shadow_o, wi, tmax, dist) equals the plain version's
// on the card bit for bit and K9's sum equals it to its last bits:
//   * torch.sum over a trailing axis of 3 (core/math.py: dot, length_sq)
//     splits its three terms over two threads, (x0 + x2) + x1, each from
//     the reduction's identity 0, so a -0 comes out +0: dot3.
//   * torch.linalg.cross (core/math.py: quat_rotate) is compiled with
//     contraction, a1 b2 - a2 b1 as fma(a1, b2, -(a2 b1)): msub.
//   * a Python number is an f32 constant, the double rounded once; the card
//     divides by a Python number as a product with its reciprocal.
//   * torch.clamp, torch.minimum and torch.maximum propagate NaN (nmin /
//     nmax of frame.cuh).
//   * division and sqrtf are IEEE; cosf, sinf, logf and rsqrtf are the CUDA
//     math library's, which PyTorch's kernels call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "frame.cuh"  // V3, nmin / nmax, sub

// The kernels' arguments, as ops/nee.py's _LightArgs and _ShadeArgs lay
// them out (outside the unnamed namespace: the C entries take them).
struct LightArgs {
  const float *p, *n, *u0, *u1, *u2;
  const float *tp, *tq, *ts;  // the light's transform: a row, or one a lane
  const float* radius;        // a sphere's
  const float* cdf;           // a mesh's: the pool's area CDF and planes
  const float* tri[9];
  const float* nrm[9];
  float *shadow_o, *wi, *dist, *tmax, *area_nl;
  int lanes, tr_lanes, mesh, tri_offset, num_tris, steps, cdf_last;
  float mesh_area;
};

struct ShadeArgs {
  const float *color, *specular, *specular_tint, *metallic, *roughness, *subsurface,
      *transmission, *clearcoat, *clearcoat_gloss;
  const float *eta_i, *eta_o, *n, *wo, *wi;
  const uint8_t* vis;  // the shadow ray's bool: an occlusion where occludes
  const float *light_t, *area_nl;  // the probe: its pdf, and no area_nl
  const float* emission;           // one row, or one a lane
  const float* pmf;                // power mode's light selection a lane, or none
  float* out;
  int lanes, occludes, probe, emission_lanes;
  float c_bsdf, c_light, pdf_floor;
};

namespace {

constexpr int THREADS = 256;

// core/math.py's and bsdf/disney.py's constants: Python doubles, rounded
// to f32 where they meet a tensor
constexpr double PI_D = 3.141592653589793;  // math.pi
constexpr float PI = (float)PI_D;
constexpr float TWO_PI = (float)(2.0 * PI_D);
constexpr float INV_PI = (float)(1.0 / PI_D);
constexpr float INV_2PI = (float)(0.5 / PI_D);
constexpr float FOUR_PI = (float)(4.0 * PI_D);
constexpr float EPS = (float)1e-6;  // bsdf/disney.py::_EPS
constexpr float RAY_EPS = (float)1e-4;
constexpr float PORTAL_TOL = (float)1e-2;
constexpr float REJECTED = -1.0f;  // ops/nee.py::REJECTED

__device__ __forceinline__ V3 load3(const float* x, int i) {
  return {x[3 * i], x[3 * i + 1], x[3 * i + 2]};
}
__device__ __forceinline__ void store3(float* x, int i, V3 v) {
  x[3 * i] = v.x;
  x[3 * i + 1] = v.y;
  x[3 * i + 2] = v.z;
}
__device__ __forceinline__ V3 scale(V3 v, float s) { return {v.x * s, v.y * s, v.z * s}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }

// torch.sum(a * b, dim=-1) on the card
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return ((a.x * b.x + a.z * b.z) + a.y * b.y) + 0.0f;
}

// a b - c d as torch.linalg.cross computes it on the card
__device__ __forceinline__ float msub(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -(c * d));
}
__device__ __forceinline__ V3 tcross(V3 a, V3 b) {
  return {msub(a.y, b.z, a.z, b.y), msub(a.z, b.x, a.x, b.z), msub(a.x, b.y, a.y, b.x)};
}

// core/math.py::quat_rotate: v + w t + u x t, t = 2 u x v
__device__ __forceinline__ V3 quat_rotate(V3 u, float w, V3 v) {
  V3 t = tcross(u, v);
  t = {2.0f * t.x, 2.0f * t.y, 2.0f * t.z};
  return add(add(v, scale(t, w)), tcross(u, t));
}

// core/math.py::safe_normalize, zero fallback
__device__ __forceinline__ V3 safe_normalize(V3 a) {
  const float lsq = dot3(a, a);
  const bool ok = lsq > (float)1e-20;
  const float inv = rsqrtf(ok ? lsq : 1.0f);
  return ok ? scale(a, inv) : V3{0.0f, 0.0f, 0.0f};
}

__device__ __forceinline__ float lerp(float a, float b, float t) { return a + (b - a) * t; }
__device__ __forceinline__ float clamp01(float x) { return nmin(nmax(x, 0.0f), 1.0f); }

// ------------------------------------------------------------------ K8

__global__ void __launch_bounds__(THREADS) nee_light_kernel(const LightArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.lanes) return;
  const int l = a.tr_lanes ? i : 0;
  const V3 tp = load3(a.tp, l);
  const V3 qu = {a.tq[4 * l], a.tq[4 * l + 1], a.tq[4 * l + 2]};
  const float qw = a.tq[4 * l + 3], s = a.ts[l];
  const float u0 = a.u0[i], u1 = a.u1[i], u2 = a.u2[i];

  V3 pos, nrm;
  float area;
  if (!a.mesh) {
    // core/sampling.py::uniform_sample_sphere(u0, u1), scaled by the radius
    const float radius = *a.radius;
    const float z = 1.0f - 2.0f * u0;
    const float r = sqrtf(nmax(1.0f - z * z, 0.0f));
    const float phi = TWO_PI * u1;
    const V3 d = {r * cosf(phi), r * sinf(phi), z};
    pos = add(tp, quat_rotate(qu, qw, scale(scale(d, radius), s)));
    nrm = safe_normalize(sub(pos, tp));
    const float rs = radius * s;
    area = FOUR_PI * (rs * rs);
  } else {
    // core/search.py::lower_bound over the mesh's CDF window, then clamped
    int lo = a.tri_offset, hi = a.tri_offset + a.num_tris;
    for (int k = 0; k < a.steps; ++k) {
      const bool active = lo < hi;
      const int mid = lo + (hi - lo) / 2;  // hi >= lo: the floor
      const bool right = a.cdf[min(max(mid, 0), a.cdf_last)] < u0;
      if (active && right) lo = mid + 1;
      if (active && !right) hi = mid;
    }
    const int t = min(max(lo, a.tri_offset), a.tri_offset + a.num_tris - 1);
    // core/sampling.py::uniform_sample_triangle(u1, u2)
    const float rt = sqrtf(u1);
    const float bu = 1.0f - rt, bv = u2 * rt;
    const float bw = (1.0f - bu) - bv;
    V3 c[3], m[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      c[k] = {a.tri[3 * k][t], a.tri[3 * k + 1][t], a.tri[3 * k + 2][t]};
      m[k] = {a.nrm[3 * k][t], a.nrm[3 * k + 1][t], a.nrm[3 * k + 2][t]};
    }
    const V3 pl = add(add(scale(c[0], bu), scale(c[1], bv)), scale(c[2], bw));
    const V3 nl = add(add(scale(m[0], bu), scale(m[1], bv)), scale(m[2], bw));
    pos = add(tp, quat_rotate(qu, qw, scale(pl, s)));
    nrm = safe_normalize(quat_rotate(qu, qw, scale(nl, s)));
    area = (a.mesh_area * s) * s;
  }

  const V3 p = load3(a.p, i), n = load3(a.n, i);
  const V3 wu = sub(pos, p);
  const float dist = sqrtf(nmax(dot3(wu, wu), (float)1e-20));
  const V3 wi = {wu.x / dist, wu.y / dist, wu.z / dist};
  // core/math.py::face_forward(n, wi), offset by RAY_EPS
  const float side = dot3(wi, n) < 0.0f ? -1.0f : 1.0f;
  store3(a.shadow_o, i, add(p, scale(scale(n, side), RAY_EPS)));
  store3(a.wi, i, wi);
  a.dist[i] = dist;
  a.tmax[i] = nmax(dist - PORTAL_TOL, 0.0f);
  const float nl = fabsf(dot3(nrm, wi));
  a.area_nl[i] = nl >= EPS ? area * nl : REJECTED;
}

// ------------------------------------------------------------------ K9

struct Mat {
  V3 color;
  float specular, specular_tint, metallic, roughness, subsurface, transmission, clearcoat,
      clearcoat_gloss;
};

__device__ __forceinline__ float nonzero(float x) { return fabsf(x) > EPS ? x : EPS; }

__device__ __forceinline__ float schlick_fresnel(float u) {
  const float m = clamp01(1.0f - u);
  const float m2 = m * m;
  return (m2 * m2) * m;
}

__device__ __forceinline__ float gtr1(float ndh, float a) {
  const float a2 = a * a;
  const float t = 1.0f + ((a2 - 1.0f) * ndh) * ndh;
  const float safe = (a2 - 1.0f) / ((PI * logf(nmax(a2, EPS))) * nmax(t, EPS));
  return a >= 1.0f ? INV_PI : safe;
}

__device__ __forceinline__ float gtr2(float ndh, float a) {
  const float a2 = a * a;
  const float t = 1.0f + ((a2 - 1.0f) * ndh) * ndh;
  return a2 / (PI * nmax(t * t, (float)1e-20));
}

__device__ __forceinline__ float smith_ggx(float ndv, float ag) {
  const float a = ag * ag, b = ndv * ndv;
  return 1.0f / nmax(ndv + sqrtf(nmax((a + b) - a * b, 0.0f)), EPS);
}

__device__ __forceinline__ float fresnel_dielectric(float vdn, float eta_i, float eta_o) {
  const float x = eta_i / eta_o;
  const float sin2_t = (x * x) * (1.0f - vdn * vdn);
  const float ldn = sqrtf(nmax(1.0f - sin2_t, (float)1e-12));
  const float eta = eta_o / nmax(eta_i, EPS);
  const float r1 = (vdn - eta * ldn) / nonzero(vdn + eta * ldn);
  const float r2 = (ldn - eta * vdn) / nonzero(ldn + eta * vdn);
  const float f = 0.5f * (r1 * r1 + r2 * r2);
  return sin2_t > 1.0f ? 1.0f : clamp01(f);
}

// bsdf/disney.py::_spec_color
__device__ __forceinline__ V3 spec_color(const Mat& m) {
  const V3 cd = m.color;
  const float lum = ((float)0.3 * cd.x + (float)0.6 * cd.y) + (float)0.1 * cd.z;
  const float cl = nmax(lum, EPS);
  const V3 tint = lum > 0.0f ? V3{cd.x / cl, cd.y / cl, cd.z / cl} : V3{1.0f, 1.0f, 1.0f};
  const float sp = m.specular * (float)0.08;
  const V3 diel = {sp * lerp(1.0f, tint.x, m.specular_tint),
                   sp * lerp(1.0f, tint.y, m.specular_tint),
                   sp * lerp(1.0f, tint.z, m.specular_tint)};
  return {lerp(diel.x, cd.x, m.metallic), lerp(diel.y, cd.y, m.metallic),
          lerp(diel.z, cd.z, m.metallic)};
}

// bsdf/disney.py::bsdf_pdf(m, eta_i, eta_o, n, v, l)
__device__ __forceinline__ float bsdf_pdf(const Mat& m, float eta_i, float eta_o, V3 n, V3 v,
                                          V3 l) {
  const float ndl = dot3(l, n);
  const float brdf_below = (INV_2PI * m.subsurface) * 0.5f;
  const float f = fresnel_dielectric(dot3(n, v), eta_i, eta_o);
  const float a = nmax(m.roughness, (float)0.001);
  const V3 hv = safe_normalize(add(l, v));
  const float cth = fabsf(dot3(hv, n));
  const float pdf_half = gtr2(cth, a) * cth;
  const float pdf_spec = (0.25f * pdf_half) / nmax(dot3(l, hv), EPS);
  const float pdf_diff = (fabsf(ndl) * INV_PI) * (1.0f - m.subsurface);
  const float above = lerp(lerp(pdf_diff, pdf_spec, 0.5f), pdf_spec * f, m.transmission);
  const float below = lerp(brdf_below, 0.0f, m.transmission);
  return ndl <= 0.0f ? below : above;
}

// bsdf/disney.py::bsdf_eval(m, eta_i, eta_o, n, v, l)
__device__ __forceinline__ V3 bsdf_eval(const Mat& m, float eta_i, float eta_o, V3 n, V3 v,
                                        V3 l) {
  const float ndl = dot3(n, l), ndv = dot3(n, v);
  const V3 lv = add(l, v);
  const float len = sqrtf(nmax(dot3(lv, lv), (float)1e-30));
  const V3 h = {lv.x / len, lv.y / len, lv.z / len};
  const float ndh = dot3(n, h), ldh = dot3(l, h);
  const V3 cd = m.color;
  const V3 cs = spec_color(m);
  const bool below = ndl <= 0.0f;
  const float a = nmax(m.roughness, (float)0.001);
  const float omm = 1.0f - m.metallic;

  // transmissive side
  const float f_v = fresnel_dielectric(ndv, eta_i, eta_o);
  const float bsdf_below = ((m.transmission * (1.0f - f_v)) / nmax(fabsf(ndl), EPS)) * omm;
  const float ds = gtr2(ndh, a);
  const float fh_diel = fresnel_dielectric(ldh, eta_i, eta_o);
  const float gs = smith_ggx(ndv, a) * smith_ggx(ndl, a);
  const float gsds = gs * ds;
  const V3 bsdf = below ? V3{bsdf_below, bsdf_below, bsdf_below}
                        : V3{gsds * lerp(cs.x, 1.0f, fh_diel), gsds * lerp(cs.y, 1.0f, fh_diel),
                             gsds * lerp(cs.z, 1.0f, fh_diel)};

  // reflective side
  V3 brdf;
  if (below) {
    const float fl_b = schlick_fresnel(fabsf(ndl)), fv_b = schlick_fresnel(ndv);
    const float fd_b = (1.0f - 0.5f * fl_b) * (1.0f - 0.5f * fv_b);
    const float k = ((INV_PI * m.subsurface) * fd_b) * omm;
    brdf = m.subsurface > 0.0f
               ? V3{k * sqrtf(nmax(cd.x, (float)1e-12)), k * sqrtf(nmax(cd.y, (float)1e-12)),
                    k * sqrtf(nmax(cd.z, (float)1e-12))}
               : V3{0.0f, 0.0f, 0.0f};
  } else {
    const float fh = schlick_fresnel(ldh);
    const float fl = schlick_fresnel(ndl), fv = schlick_fresnel(ndv);
    const float fd90 = 0.5f + ((2.0f * ldh) * ldh) * m.roughness;
    const float fd = lerp(1.0f, fd90, fl) * lerp(1.0f, fd90, fv);
    const float dr = gtr1(ndh, (float)0.1 + (float)(0.001 - 0.1) * m.clearcoat_gloss);
    const float fc = (float)0.04 + (float)(1.0 - 0.04) * fh;
    const float gr = smith_ggx(ndl, 0.25f) * smith_ggx(ndv, 0.25f);
    const float kd = ((INV_PI * fd) * omm) * (1.0f - m.subsurface);
    const float kc = ((m.clearcoat * gr) * fc) * dr;
    brdf = {(kd * cd.x + gsds * lerp(cs.x, 1.0f, fh)) + kc,
            (kd * cd.y + gsds * lerp(cs.y, 1.0f, fh)) + kc,
            (kd * cd.z + gsds * lerp(cs.z, 1.0f, fh)) + kc};
  }
  return {lerp(brdf.x, bsdf.x, m.transmission), lerp(brdf.y, bsdf.y, m.transmission),
          lerp(brdf.z, bsdf.z, m.transmission)};
}

__global__ void __launch_bounds__(THREADS) nee_shade_kernel(const ShadeArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.lanes) return;
  const Mat m = {load3(a.color, i), a.specular[i],     a.specular_tint[i], a.metallic[i],
                 a.roughness[i],    a.subsurface[i],   a.transmission[i],  a.clearcoat[i],
                 a.clearcoat_gloss[i]};
  const float eta_i = a.eta_i[i], eta_o = a.eta_o[i];
  const V3 n = load3(a.n, i), wo = load3(a.wo, i), wi = load3(a.wi, i);

  bool accept = a.occludes ? !a.vis[i] : a.vis[i];
  float pdf;
  if (a.probe) {
    pdf = a.light_t[i];
  } else {
    const float t = a.light_t[i], anl = a.area_nl[i];
    accept = accept && anl != REJECTED;
    float tt = t * t;
    if (a.pmf) {
      const float sel = a.pmf[i];
      accept = accept && sel > 0.0f;
      tt = sel * tt;
    }
    pdf = tt / nmax(anl, (float)1e-12);
  }
  const float bpdf = bsdf_pdf(m, eta_i, eta_o, n, wo, wi);
  const V3 f = bsdf_eval(m, eta_i, eta_o, n, wo, wi);
  accept = accept && bpdf > 0.0f;
  const float weight =
      (a.c_light * pdf) / nmax(a.c_bsdf * bpdf + a.c_light * pdf, (float)1e-12);
  const float k = (weight * fabsf(dot3(wi, n))) / nmax(pdf, a.pdf_floor);
  const V3 e = load3(a.emission, a.emission_lanes ? i : 0);
  V3 c;
  if (a.probe) {
    accept = accept && pdf > 0.0f && weight > 0.0f;
    c = {(k * e.x) * f.x, (k * e.y) * f.y, (k * e.z) * f.z};
  } else {
    c = {(k * f.x) * e.x, (k * f.y) * e.y, (k * f.z) * e.z};
  }
  if (!accept) c = {0.0f, 0.0f, 0.0f};
  store3(a.out, i, add(load3(a.out, i), c));
}

}  // namespace

extern "C" int tinsel_nee_light(const LightArgs* a, cudaStream_t stream) {
  if (a->lanes <= 0) return 9001;
  nee_light_kernel<<<(a->lanes + THREADS - 1) / THREADS, THREADS, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int tinsel_nee_shade(const ShadeArgs* a, cudaStream_t stream) {
  if (a->lanes <= 0) return 9001;
  nee_shade_kernel<<<(a->lanes + THREADS - 1) / THREADS, THREADS, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}
