// A world ray in an instance's frame, and its root-box test: the device
// functions that sweep.cu (kernels K5c / K5a, the tiny groups' instances)
// and bvh.cu (kernels K6c / K6a, the shortlist rounds' instances) share.
// Both files are compiled with -fmad=false and every expression follows
// its plain version's order of operations (accel/sweep.py: lerp_transform,
// inverse_rotate / local_ray, box_entry), so the kernels equal it bit for
// bit. ops/_build.py hashes this header into both libraries' names.

#pragma once

#include <cuda_runtime.h>

namespace {

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// torch.minimum / torch.maximum / torch.clamp: NaN if an operand is NaN
__device__ __forceinline__ float nmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 xyz(float4 a) { return {a.x, a.y, a.z}; }

// accel/sweep.py::inverse_rotate: quat_rotate(conj(q), v) / s, u = -q.xyz;
// x / 1 = x, so a scale of 1 (divide false) skips the divisions
__device__ __forceinline__ V3 inverse_rotate(V3 u, float qw, V3 v, float s, bool divide) {
  V3 t = cross3(u, v);
  t = {2.0f * t.x, 2.0f * t.y, 2.0f * t.z};
  const V3 c = cross3(u, t);
  V3 r = {(v.x + qw * t.x) + c.x, (v.y + qw * t.y) + c.y, (v.z + qw * t.z) + c.z};
  if (divide) r = {r.x / s, r.y / s, r.z / s};
  return r;
}

// An instance's frame for one ray: (u = -q.xyz, q.w, p, s), the moving
// form interpolated at the ray's time (accel/sweep.py::lerp_transform)
struct Frame {
  V3 u, p;
  float qw, s;
};

__device__ __forceinline__ Frame moving_frame(float4 a, float4 q0, float4 b, float4 dq,
                                              float time) {
  float q[4] = {q0.x + dq.x * time, q0.y + dq.y * time, q0.z + dq.z * time, q0.w + dq.w * time};
  const float n = sqrtf(nmax(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3], 1e-30f));
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = q[k] / n;
  return {{-q[0], -q[1], -q[2]},
          {a.x + b.x * time, a.y + b.y * time, a.z + b.z * time},
          q[3],
          a.w + b.w * time};
}

// accel/sweep.py::box_entry: may the ray hit the root box before tmax;
// tn its entry distance (clamped at 0)
__device__ __forceinline__ float rcp_nudged(float d) {
  const float eps = 1e-30f;
  return 1.0f / (fabsf(d) < eps ? (d < 0.0f ? -eps : eps) : d);
}
__device__ __forceinline__ bool box_entry(float4 lo, float4 hi, V3 o, V3 d, float tmax,
                                          float& tn) {
  const float rx = rcp_nudged(d.x), ry = rcp_nudged(d.y), rz = rcp_nudged(d.z);
  const float t0x = (lo.x - o.x) * rx, t1x = (hi.x - o.x) * rx;
  const float t0y = (lo.y - o.y) * ry, t1y = (hi.y - o.y) * ry;
  const float t0z = (lo.z - o.z) * rz, t1z = (hi.z - o.z) * rz;
  tn = nmax(nmax(nmax(nmin(t0x, t1x), nmin(t0y, t1y)), nmin(t0z, t1z)), 0.0f);
  const float tf = nmin(nmin(nmax(t0x, t1x), nmax(t0y, t1y)), nmax(t0z, t1z));
  return tn <= tf && tn < tmax;
}
__device__ __forceinline__ bool box_entry(float4 lo, float4 hi, V3 o, V3 d, float tmax) {
  float tn;
  return box_entry(lo, hi, o, d, tmax, tn);
}

}  // namespace
