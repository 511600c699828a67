// The sweep over spheres, planes and tiny meshes for Hopper (sm_90a):
// kernels K5c (closest hit: t, prim, tri per ray) and K5a (occlusion with
// 0 < t < tmax, ending at the ray's first occluding row).
//
// Replaces: the sphere and plane rows and their merge in
// tinsel_tpu/render/trace.py:388-424 (trace_closest) and :576
// (trace_any), and the brute sweep over meshes of at most 16 triangles,
// tinsel_tpu/accel/traverse.py:981 _intersect_mesh_brute, with the
// re-intersection of its winner (trace.py:439-446). In the JAX package
// these are pure-JAX (rows, rays) broadcasts and row-by-row merges; the
// port ran them as some 450 eager torch ops a call before this file.
//
// The plain versions are accel/sweep.py::sweep_closest and ::sweep_any.
// The scene comes as a table of records in their merge order (packed by
// ops/sweep.py::pack_records, which lays the records out):
//   sphere (12 floats), plane (6), group (11 + 9 n: a tiny mesh's root
//   box, first triangle and n triangles), instance (18: start and end
//   transform), end of group (1); ints as their bits.
//
// Per ray (one thread, state in registers): each sphere and plane row
// replaces the best hit only with a strictly smaller t (the plain
// version's first row attaining the minimum); a group opens with its
// bound = the best t so far; each instance takes the ray into its frame
// (the transform interpolated at the ray's time where the group's motion
// flag is set: lerp p, nlerp q, lerp s), culls on its root box against
// the bound, and tests its triangles (two-sided Moller-Trumbore, eps
// 1e-9) against the candidate's t, strictly, so the lowest instance and
// triangle win a tie; each new candidate is intersected again with
// intersect_ray_tri's formula; at the group's end that t replaces the
// best only if it is > 0 and below it. K5a ends at the first sphere,
// plane or triangle with 0 < t < tmax.
//
// Chunks: a block stages the table in chunks of at most 12,288 floats
// (48 KB of shared memory, the largest chunk's size; a chunk that starts
// inside a group repeats its group record), so any number of primitives
// works. Every thread reads the same record at once: a broadcast, no
// bank conflict. K5a's blocks stop staging once every ray of the block
// is occluded.
//
// What bounds it on this card. The work a ray is a few hundred f32
// operations (chip_smoke.py::sweep_work counts them from the plain
// version on the same rays: Cornell's 2 spheres, 5 planes and one
// 2-triangle instance, whose root box culls most rays, about 300 for
// K5c) against 36 bytes of device traffic (origin and direction in, t,
// prim and tri out; 29 for K5a: tmax in, one byte out): at the H100's
// 67 TFLOP/s f32 and 3.35 TB/s that is 4.5 ms of operations and 10.7 ms
// of bytes per billion rays, so bytes bound it for Cornell, and
// operations for a scene of more than about twenty rows. The design
// keeps the traffic at that floor: one coalesced read of each ray, the
// table from shared memory, one write of each output, no temporaries.
// Measured (chip_smoke.py on an H100 80GB HBM3 at 700 W): 0.26-0.32 of
// that bound on Cornell's 1M-ray calls.
//
// Rounding: this file is compiled with -fmad=false and every expression
// follows the plain version's order of operations (dot products summed
// x, y, z; crosses as (a1 b2 - a2 b1, ...)), so t, prim and tri equal the
// plain version's bit for bit. Division and square root are IEEE (no fast
// math); min/max propagate NaN as torch.minimum / torch.clamp do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK_FLOATS = 12288;
enum : int { SPHERE = 0, PLANE = 1, GROUP = 2, INSTANCE = 3, END = 4 };
constexpr int SPHERE_LEN = 12, PLANE_LEN = 6, GROUP_HEAD = 11, INSTANCE_LEN = 18;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ int bits(float x) { return __float_as_int(x); }

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

__device__ __forceinline__ float nonzero(float x) { return fabsf(x) > 1e-30f ? x : 1e-30f; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ float dot3(V3 a, V3 b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 at(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ float lerp(float a, float b, float t) { return a + (b - a) * t; }

// accel/sweep.py::sphere_hit: the stable quadratic, far root from inside
__device__ __forceinline__ bool sphere_hit(V3 c, float rad, V3 o, V3 d, float& t) {
  const V3 q = sub(o, c);
  const float b = 2.0f * dot3(q, d);
  const float cc = dot3(q, q) - rad * rad;
  const float disc = b * b - 4.0f * cc;
  const float sq = sqrtf(nmax(disc, 1e-12f));
  const float tq = -0.5f * (b + (b >= 0.0f ? sq : -sq));
  const float t1 = cc / nonzero(tq);
  const float lo = nmin(tq, t1);
  t = lo < 0.0f ? nmax(tq, t1) : lo;
  return disc >= 0.0f && t > 0.0f;
}

// accel/sweep.py::plane_hit
__device__ __forceinline__ bool plane_hit(const float* pl, V3 o, V3 d, float& t) {
  const V3 n = at(pl);
  const float dn = dot3(n, d);
  t = -(dot3(n, o) + pl[3]) / nonzero(dn);
  return fabsf(dn) > 1e-30f && t > 0.0f;
}

// accel/sweep.py::inverse_rotate: quat_rotate(conj(q), v) / s
__device__ __forceinline__ V3 inverse_rotate(const float* q, float qw, V3 v, float s) {
  const V3 u = {-q[0], -q[1], -q[2]};
  V3 t = cross3(u, v);
  t = {2.0f * t.x, 2.0f * t.y, 2.0f * t.z};
  const V3 c = cross3(u, t);
  return {((v.x + qw * t.x) + c.x) / s, ((v.y + qw * t.y) + c.y) / s,
          ((v.z + qw * t.z) + c.z) / s};
}

// The ray in an instance's frame; r: the instance record, motion: its
// group's flag (accel/sweep.py::lerp_transform, local_ray)
__device__ __forceinline__ void local_ray(const float* r, bool motion, float time, V3 o, V3 d,
                                          V3& ol, V3& dl) {
  V3 p = at(r + 2);
  float q[4] = {r[5], r[6], r[7], r[8]};
  float s = r[9];
  if (motion) {
    p = {lerp(p.x, r[10], time), lerp(p.y, r[11], time), lerp(p.z, r[12], time)};
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = lerp(q[k], r[13 + k], time);
    const float n = sqrtf(nmax(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3], 1e-30f));
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = q[k] / n;
    s = lerp(s, r[17], time);
  }
  ol = inverse_rotate(q, q[3], sub(o, p), s);
  dl = inverse_rotate(q, q[3], d, s);
}

// accel/sweep.py::box_entry: may the ray hit the root box before tmax
__device__ __forceinline__ float rcp_nudged(float d) {
  const float eps = 1e-30f;
  return 1.0f / (fabsf(d) < eps ? (d < 0.0f ? -eps : eps) : d);
}
__device__ __forceinline__ bool box_entry(const float* lo, const float* hi, V3 o, V3 d,
                                          float tmax) {
  const float rx = rcp_nudged(d.x), ry = rcp_nudged(d.y), rz = rcp_nudged(d.z);
  const float t0x = (lo[0] - o.x) * rx, t1x = (hi[0] - o.x) * rx;
  const float t0y = (lo[1] - o.y) * ry, t1y = (hi[1] - o.y) * ry;
  const float t0z = (lo[2] - o.z) * rz, t1z = (hi[2] - o.z) * rz;
  const float tn = nmax(nmax(nmax(nmin(t0x, t1x), nmin(t0y, t1y)), nmin(t0z, t1z)), 0.0f);
  const float tf = nmin(nmin(nmax(t0x, t1x), nmax(t0y, t1y)), nmax(t0z, t1z));
  return tn <= tf && tn < tmax;
}

// accel/traverse.py::_tri_hit: two-sided Moller-Trumbore, eps 1e-9; v:
// the triangle's 9 floats (v0, v1, v2)
__device__ __forceinline__ bool tri_hit(const float* v, V3 o, V3 d, float& t) {
  const float abx = v[3] - v[0], aby = v[4] - v[1], abz = v[5] - v[2];
  const float acx = v[6] - v[0], acy = v[7] - v[1], acz = v[8] - v[2];
  const float px = d.y * acz - d.z * acy;
  const float py = d.z * acx - d.x * acz;
  const float pz = d.x * acy - d.y * acx;
  const float det = (abx * px + aby * py) + abz * pz;
  const bool ok = fabsf(det) >= 1e-9f;
  const float inv = 1.0f / (ok ? det : 1.0f);
  const float tx = o.x - v[0], ty = o.y - v[1], tz = o.z - v[2];
  const float u = ((tx * px + ty * py) + tz * pz) * inv;
  const float qx = ty * abz - tz * aby;
  const float qy = tz * abx - tx * abz;
  const float qz = tx * aby - ty * abx;
  const float w = ((d.x * qx + d.y * qy) + d.z * qz) * inv;
  t = ((acx * qx + acy * qy) + acz * qz) * inv;
  return ok && u >= 0.0f && w >= 0.0f && u + w <= 1.0f && t > 0.0f;
}

// accel/sweep.py::ray_tri (intersect_ray_tri's formula): t, +inf on a miss
__device__ __forceinline__ float ray_tri_t(const float* vt, V3 o, V3 d) {
  const V3 a = at(vt), b = at(vt + 3), c = at(vt + 6);
  const V3 ab = sub(b, a), ac = sub(c, a);
  const V3 n = cross3(ab, ac);
  const V3 nd = {-d.x, -d.y, -d.z};
  const float dn = dot3(nd, n);
  const float ood = 1.0f / nonzero(dn);
  const V3 ap = sub(o, a);
  const float t = dot3(ap, n) * ood;
  const V3 e = cross3(nd, ap);
  const float v = dot3(ac, e) * ood;
  const float w = -dot3(ab, e) * ood;
  const bool hit = fabsf(dn) > 1e-30f && t > 0.0f && v >= 0.0f && v <= 1.0f && w >= 0.0f &&
                   v + w <= 1.0f;
  return hit ? t : inf();
}

// A sphere record's center and scaled radius at the ray's time
__device__ __forceinline__ bool sphere_row(const float* r, V3 o, V3 d, float time, float& t) {
  V3 c = at(r + 4);
  float s = r[7];
  if (r[2] != 0.0f) {
    c = {lerp(c.x, r[8], time), lerp(c.y, r[9], time), lerp(c.z, r[10], time)};
    s = lerp(s, r[11], time);
  }
  return sphere_hit(c, r[3] * s, o, d, t);
}

// Stage chunk c of the table into shared memory (the caller syncs before)
__device__ __forceinline__ int stage(float* rec, const float* __restrict__ table,
                                     const int* __restrict__ chunks, int c) {
  const int begin = __ldg(chunks + c), len = __ldg(chunks + c + 1) - begin;
  for (int k = threadIdx.x; k < len; k += THREADS) rec[k] = __ldg(table + begin + k);
  return len;
}

__global__ void __launch_bounds__(THREADS)
sweep_closest_kernel(const float* __restrict__ table, const int* __restrict__ chunks,
                     int n_chunks, const float* __restrict__ origins,
                     const float* __restrict__ dirs, const float* __restrict__ times, int n,
                     float* __restrict__ t_out, int* __restrict__ prim_out,
                     int* __restrict__ tri_out) {
  extern __shared__ float rec[];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool live = i < n;
  V3 o = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 0.0f};
  float time = 0.0f;
  if (live) {
    o = {__ldg(origins + 3 * i), __ldg(origins + 3 * i + 1), __ldg(origins + 3 * i + 2)};
    d = {__ldg(dirs + 3 * i), __ldg(dirs + 3 * i + 1), __ldg(dirs + 3 * i + 2)};
    if (times) time = __ldg(times + i);
  }
  float best_t = inf();
  int best_prim = -1, best_tri = -1;
  // the open group: its bound, its candidate (t, prim, tri) and the
  // candidate's t by intersect_ray_tri's formula
  float g_bound = inf(), g_t = inf(), g_tre = inf();
  int g_prim = -1, g_tri = -1;
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // the previous chunk is read
    const int len = stage(rec, table, chunks, c);
    __syncthreads();
    if (!live) continue;
    int grp = 0;  // the group record in this chunk
    for (int pos = 0; pos < len;) {
      const float* r = rec + pos;
      const int kind = bits(r[0]);
      if (kind == SPHERE) {
        float t;
        if (sphere_row(r, o, d, time, t) && isfinite(t) && t < best_t) {
          best_t = t;
          best_prim = bits(r[1]);
          best_tri = -1;
        }
        pos += SPHERE_LEN;
      } else if (kind == PLANE) {
        float t;
        if (plane_hit(r + 2, o, d, t) && isfinite(t) && t < best_t) {
          best_t = t;
          best_prim = bits(r[1]);
          best_tri = -1;
        }
        pos += PLANE_LEN;
      } else if (kind == GROUP) {
        grp = pos;
        if (r[2] != 0.0f) {  // opens the group
          g_bound = g_t = best_t;
          g_tre = inf();
          g_prim = g_tri = -1;
        }
        pos += GROUP_HEAD + 9 * bits(r[1]);
      } else if (kind == INSTANCE) {
        const float* g = rec + grp;
        V3 ol, dl;
        local_ray(r, g[3] != 0.0f, time, o, d, ol, dl);
        if (box_entry(g + 5, g + 8, ol, dl, g_bound)) {
          const int nt = bits(g[1]);
          const float* v = g + GROUP_HEAD;
          for (int j = 0; j < nt; ++j, v += 9) {
            float t;
            if (tri_hit(v, ol, dl, t) && t < g_t) {
              g_t = t;
              g_prim = bits(r[1]);
              g_tri = bits(g[4]) + j;
              g_tre = ray_tri_t(v, ol, dl);
            }
          }
        }
        pos += INSTANCE_LEN;
      } else {  // END: the group's winner, at its own t
        if (g_prim >= 0 && g_tre > 0.0f && g_tre < best_t) {
          best_t = g_tre;
          best_prim = g_prim;
          best_tri = g_tri;
        }
        g_prim = -1;
        pos += 1;
      }
    }
  }
  if (live) {
    t_out[i] = best_t;
    prim_out[i] = best_prim;
    tri_out[i] = best_tri;
  }
}

__global__ void __launch_bounds__(THREADS)
sweep_any_kernel(const float* __restrict__ table, const int* __restrict__ chunks, int n_chunks,
                 const float* __restrict__ origins, const float* __restrict__ dirs,
                 const float* __restrict__ times, const float* __restrict__ tmaxs, int n,
                 uint8_t* __restrict__ occ_out) {
  extern __shared__ float rec[];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool live = i < n;
  V3 o = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 0.0f};
  float time = 0.0f, tmax = 0.0f;
  if (live) {
    o = {__ldg(origins + 3 * i), __ldg(origins + 3 * i + 1), __ldg(origins + 3 * i + 2)};
    d = {__ldg(dirs + 3 * i), __ldg(dirs + 3 * i + 1), __ldg(dirs + 3 * i + 2)};
    if (times) time = __ldg(times + i);
    tmax = __ldg(tmaxs + i);
  }
  bool occ = false;
  bool done = !live;
  for (int c = 0; c < n_chunks; ++c) {
    if (__syncthreads_and(done)) break;  // also: the previous chunk is read
    const int len = stage(rec, table, chunks, c);
    __syncthreads();
    if (done) continue;
    int grp = 0;
    for (int pos = 0; pos < len && !occ;) {
      const float* r = rec + pos;
      const int kind = bits(r[0]);
      float t;
      if (kind == SPHERE) {
        occ = sphere_row(r, o, d, time, t) && t < tmax;
        pos += SPHERE_LEN;
      } else if (kind == PLANE) {
        occ = plane_hit(r + 2, o, d, t) && t < tmax;
        pos += PLANE_LEN;
      } else if (kind == GROUP) {
        grp = pos;
        pos += GROUP_HEAD + 9 * bits(r[1]);
      } else if (kind == INSTANCE) {
        const float* g = rec + grp;
        V3 ol, dl;
        local_ray(r, g[3] != 0.0f, time, o, d, ol, dl);
        if (box_entry(g + 5, g + 8, ol, dl, tmax)) {
          const int nt = bits(g[1]);
          const float* v = g + GROUP_HEAD;
          for (int j = 0; j < nt && !occ; ++j, v += 9) occ = tri_hit(v, ol, dl, t) && t < tmax;
        }
        pos += INSTANCE_LEN;
      } else {
        pos += 1;
      }
    }
    done = occ;
  }
  if (live) occ_out[i] = occ ? 1 : 0;
}

bool geometry_ok(int n_chunks, int smem_floats, int n, int threads, int grid) {
  return threads == THREADS && n >= 1 && grid == (n + THREADS - 1) / THREADS && n_chunks >= 0 &&
         smem_floats >= 0 && smem_floats <= CHUNK_FLOATS;
}

}  // namespace

extern "C" int tinsel_sweep_closest(const float* table, const int* chunks, int n_chunks,
                                    int smem_floats, const float* origins, const float* dirs,
                                    const float* times, int n, int threads, int grid,
                                    float* t_out, int* prim_out, int* tri_out,
                                    cudaStream_t stream) {
  if (!geometry_ok(n_chunks, smem_floats, n, threads, grid)) return 9001;
  sweep_closest_kernel<<<grid, threads, smem_floats * sizeof(float), stream>>>(
      table, chunks, n_chunks, origins, dirs, times, n, t_out, prim_out, tri_out);
  return (int)cudaGetLastError();
}

extern "C" int tinsel_sweep_any(const float* table, const int* chunks, int n_chunks,
                                int smem_floats, const float* origins, const float* dirs,
                                const float* times, const float* tmax, int n, int threads,
                                int grid, uint8_t* occ_out, cudaStream_t stream) {
  if (!geometry_ok(n_chunks, smem_floats, n, threads, grid)) return 9001;
  sweep_any_kernel<<<grid, threads, smem_floats * sizeof(float), stream>>>(
      table, chunks, n_chunks, origins, dirs, times, tmax, n, occ_out);
  return (int)cudaGetLastError();
}
