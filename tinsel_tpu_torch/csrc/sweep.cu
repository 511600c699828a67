// The sweep over spheres, planes and tiny meshes for Hopper (sm_90a):
// kernels K5c (closest hit: t, prim, tri per ray) and K5a (occlusion with
// 0 < t < tmax).
//
// Replaces: the sphere and plane rows and their merge in
// tinsel_tpu/render/trace.py:388-424 (trace_closest) and :576
// (trace_any), and the brute sweep over meshes of at most 16 triangles,
// tinsel_tpu/accel/traverse.py:981 _intersect_mesh_brute, with the
// re-intersection of its winner (trace.py:439-446). In the JAX package
// these are pure-JAX (rows, rays) broadcasts and row-by-row merges.
//
// The plain versions are accel/sweep.py::sweep_closest and ::sweep_any.
// The scene comes as a table in their merge order (packed by
// ops/sweep.py::pack_records, whose docstring lays it out), cut into
// chunks; a chunk is runs of one kind with counts in its header:
// spheres, planes, then each tiny group (its head, its triangles, its
// instances). Every record is a multiple of 16 bytes and is read with
// 16-byte shared loads.
//
// Per ray (state in registers): each sphere and plane replaces the best
// hit only with a strictly smaller t (the plain version's first row
// attaining the minimum); a group opens with its bound = the best t so
// far; each instance takes the ray into its frame (the transform
// interpolated at the ray's time where the group moves: lerp p, nlerp q,
// lerp s), culls on its root box against the bound, and tests its
// triangles (two-sided Moller-Trumbore, eps 1e-9) against the candidate's
// t, strictly, so the lowest instance and triangle win a tie; each new
// candidate is intersected again with intersect_ray_tri's formula; where
// the group closes, that t replaces the best only if it is > 0 and below
// it. K5a ORs the same tests with t < tmax.
//
// What bounds it on this card. The work a ray is a few hundred f32
// operations (chip_smoke.py::sweep_work counts them from the plain
// version on the same rays: Cornell's 2 spheres, 5 planes and one
// 2-triangle instance, whose root box culls most rays, about 300 for
// K5c) against 36 bytes of device traffic (origin and direction in, t,
// prim and tri out; 29 for K5a: tmax in, one byte out): at the H100's
// 67 TFLOP/s f32 and 3.35 TB/s that is 4.5 ms of operations and 10.7 ms
// of bytes per billion rays, so bytes bound it for Cornell, and
// operations for a scene of more than about twenty rows. Rounding must
// follow the plain version (below), so no multiply-add is fused: a case
// bound by operations reaches at most about 0.5 of that bound, which
// counts a multiply-add as the card's one fused instruction. What the
// first design (one ray a thread, a kind tag and a branch per record, a
// scalar shared load per field, every 256-ray block staging the table)
// lost was issue slots: about 550 instructions a ray on Cornell, twice
// the arithmetic, and one dependent chain a thread.
//
// The design:
// - Two rays a thread (consecutive, read and written as vectors): each
//   record's fields come from shared memory once for all of them, and
//   two tests are independent chains that hide each other's shared
//   load, divide and square-root latencies.
// - Runs with trip counts from the chunk header: no kind load or branch
//   per record. The host precomputes what has the same bits in numpy as
//   here (one f32 subtraction, product or negation): a triangle's edges
//   and normal, a static sphere's radius * s, an interpolation's
//   end - start, an instance's -q. A static instance of scale 1 skips
//   its six divisions (x / 1 = x), a branch every thread of a block
//   takes alike.
// - A persistent grid: one block per resident slot strides over tiles
//   of THREADS * RAYS rays. One thread stages the table with TMA bulk
//   copies (cp.async.bulk, completion on an mbarrier): once for the
//   whole launch where it is one chunk; else chunk after chunk for every
//   tile, two buffers, the next chunk's copy in flight while the current
//   one is swept. A block stages at most 112 KB (ops/sweep.py: one chunk
//   of up to SMEM_FLOATS, or two buffers of up to CHUNK_FLOATS), above
//   the 48 KB that needs no opt-in, and two blocks fit an SM.
// - Blocks wait together only to restage a chunk of a table of several.
//   A warp of K5a whose rays are all occluded sweeps on: a vote to let
//   it leave cost more than it saved on every case measured (PERF.md).
// - K5c loads the next tile's rays while it sweeps a tile (about 8
//   registers; 2-3 % on Cornell); K5a is held to 80 registers, 3 blocks
//   an SM, where the same prefetch would spill.
// - Each kernel is built for static tables and for tables with motion
//   (times NULL or not), so a static scene carries no interpolation code.
// Measured (against the first design in one run, H100 80GB HBM3 at
// 700 W; PERF.md): 0.35-0.42 of the bound on Cornell's 1M-ray calls
// (first design 0.26-0.33), 0.16-0.23 on veach_mis.json, 0.20-0.22 on
// a 2,000-sphere, 300-instance table of three chunks. What holds it
// there: dependent IEEE divide and square-root chains at 16 (K5c, 107
// registers) and 24 (K5a, 79) warps an SM.
//
// Rounding: this file is compiled with -fmad=false and every expression
// follows the plain version's order of operations (dot products summed
// x, y, z; crosses as (a1 b2 - a2 b1, ...)), so t, prim and tri equal the
// plain version's bit for bit. Division and square root are IEEE (no fast
// math); min/max propagate NaN as torch.minimum / torch.clamp do.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "frame.cuh"  // V3, nmin / nmax, an instance's frame and its root-box test

namespace {

constexpr int THREADS = 256;
constexpr int RAYS = 2;  // rays a thread (read and written as pairs)
constexpr int TILE = THREADS * RAYS;
constexpr int HEAD = 4, SPHERE_STATIC = 4, SPHERE_MOVING = 12, PLANE_LEN = 4;
constexpr int GROUP_HEAD = 12, TRI_LEN = 12, INSTANCE_STATIC = 8, INSTANCE_MOVING = 16;
enum : int { SPHERES_MOVE = 1 };
enum : int { OPENS = 1, CLOSES = 2, MOVES = 4 };

__device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ float nonzero(float x) { return fabsf(x) > 1e-30f ? x : 1e-30f; }
__device__ __forceinline__ float dot3(V3 a, V3 b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }

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
__device__ __forceinline__ bool plane_hit(float4 pl, V3 o, V3 d, float& t) {
  const V3 n = xyz(pl);
  const float dn = dot3(n, d);
  t = -(dot3(n, o) + pl.w) / nonzero(dn);
  return fabsf(dn) > 1e-30f && t > 0.0f;
}

// A triangle record: v0, ab = v1 - v0, ac = v2 - v0, n = ab x ac
struct Tri {
  V3 v0, ab, ac, n;
};
__device__ __forceinline__ Tri tri_at(const float4* r) {
  const float4 a = r[0], b = r[1], c = r[2];
  return {{a.x, a.y, a.z}, {a.w, b.x, b.y}, {b.z, b.w, c.x}, {c.y, c.z, c.w}};
}

// accel/traverse.py::_tri_hit: two-sided Moller-Trumbore, eps 1e-9
__device__ __forceinline__ bool tri_hit(const Tri& v, V3 o, V3 d, float& t) {
  const V3 ab = v.ab, ac = v.ac;
  const float px = d.y * ac.z - d.z * ac.y;
  const float py = d.z * ac.x - d.x * ac.z;
  const float pz = d.x * ac.y - d.y * ac.x;
  const float det = (ab.x * px + ab.y * py) + ab.z * pz;
  const bool ok = fabsf(det) >= 1e-9f;
  const float inv = 1.0f / (ok ? det : 1.0f);
  const float tx = o.x - v.v0.x, ty = o.y - v.v0.y, tz = o.z - v.v0.z;
  const float u = ((tx * px + ty * py) + tz * pz) * inv;
  const float qx = ty * ab.z - tz * ab.y;
  const float qy = tz * ab.x - tx * ab.z;
  const float qz = tx * ab.y - ty * ab.x;
  const float w = ((d.x * qx + d.y * qy) + d.z * qz) * inv;
  t = ((ac.x * qx + ac.y * qy) + ac.z * qz) * inv;
  return ok && u >= 0.0f && w >= 0.0f && u + w <= 1.0f && t > 0.0f;
}

// accel/sweep.py::ray_tri (intersect_ray_tri's formula): t, +inf on a miss
__device__ __forceinline__ float ray_tri_t(const Tri& v, V3 o, V3 d) {
  const V3 nd = {-d.x, -d.y, -d.z};
  const float dn = dot3(nd, v.n);
  const float ood = 1.0f / nonzero(dn);
  const V3 ap = sub(o, v.v0);
  const float t = dot3(ap, v.n) * ood;
  const V3 e = cross3(nd, ap);
  const float vv = dot3(v.ac, e) * ood;
  const float w = -dot3(v.ab, e) * ood;
  const bool hit = fabsf(dn) > 1e-30f && t > 0.0f && vv >= 0.0f && vv <= 1.0f && w >= 0.0f &&
                   vv + w <= 1.0f;
  return hit ? t : inf();
}

// ------------------------------------------------------------ rays

struct Rays {
  V3 o[RAYS], d[RAYS];
  float time[RAYS];
};

// Thread x of a tile holds rays first .. first + RAYS - 1; a full set is
// read with 8-byte loads (first is even)
template <int N>
__device__ __forceinline__ void load_floats(const float* __restrict__ p, float (&v)[N], bool full,
                                            int valid) {
  static_assert(N % 2 == 0, "a full set is read as float2");
  if (full) {
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(p) + k);
      v[2 * k] = a.x, v[2 * k + 1] = a.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = k < valid ? __ldg(p + k) : 0.0f;
  }
}

__device__ __forceinline__ void load_rays(Rays& r, const float* __restrict__ origins,
                                          const float* __restrict__ dirs,
                                          const float* __restrict__ times, int first, int n) {
  const int valid = min(RAYS, n - first);  // may be <= 0: a thread past the last ray
  const bool full = valid == RAYS;
  float o[3 * RAYS], d[3 * RAYS], tm[RAYS];
  load_floats<3 * RAYS>(origins + 3 * (size_t)first, o, full, 3 * valid);
  load_floats<3 * RAYS>(dirs + 3 * (size_t)first, d, full, 3 * valid);
  if (times) {
    load_floats<RAYS>(times + first, tm, full, valid);
  } else {
#pragma unroll
    for (int j = 0; j < RAYS; ++j) tm[j] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < RAYS; ++j) {
    r.o[j] = {o[3 * j], o[3 * j + 1], o[3 * j + 2]};
    r.d[j] = {d[3 * j], d[3 * j + 1], d[3 * j + 2]};
    r.time[j] = tm[j];
  }
}

// ------------------------------------------------------------ staging

__device__ __forceinline__ uint32_t sptr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(sptr(b)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = sptr(b);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// One thread: copy chunk c of the table into dst, completing on bar
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ table,
                                      const int* __restrict__ chunks, int c, uint64_t* bar) {
  const int begin = __ldg(chunks + c);
  const uint32_t bytes = 4u * (uint32_t)(__ldg(chunks + c + 1) - begin);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(sptr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(sptr(dst)),
      "l"(__cvta_generic_to_global(table + begin)), "r"(bytes), "r"(sptr(bar))
      : "memory");
}

// The tile loop shared by both kernels: sweep(rec, first) for each tile
// of this block, the table in shared memory. Returns nothing; sweep reads
// and writes its rays itself.
template <bool PREFETCH, class Sweep>
__device__ __forceinline__ void tiles(float* rec, uint64_t* bars, const float* __restrict__ table,
                                      const int* __restrict__ chunks, int n_chunks,
                                      int chunk_floats, int n, Sweep&& sweep) {
  const int n_tiles = (n + TILE - 1) / TILE;
  const int block = (int)blockIdx.x, blocks = (int)gridDim.x;
  const int mine = block < n_tiles ? (n_tiles - 1 - block) / blocks + 1 : 0;
  if (mine == 0) return;
  if (threadIdx.x == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (n_chunks <= 1) {  // staged once for every tile of the block
    if (n_chunks == 1) {
      if (threadIdx.x == 0) stage(rec, table, chunks, 0, &bars[0]);
      mbar_wait(&bars[0], 0);
    }
    const int lane0 = threadIdx.x * RAYS;
    for (int k = 0; k < mine; ++k) {
      if (k == 0 || !PREFETCH) sweep.fetch((block + k * blocks) * TILE + lane0);
      sweep.begin();
      // the next tile's rays in flight while this one is swept
      if (PREFETCH && k + 1 < mine) sweep.fetch((block + (k + 1) * blocks) * TILE + lane0);
      if (n_chunks == 1) sweep.chunk(rec);
      sweep.end();
    }
    return;
  }
  // several chunks: sequence s = k * n_chunks + c of (tile k, chunk c)
  // in buffer s & 1, its copy issued two sequence numbers ahead
  const int total = mine * n_chunks;
  if (threadIdx.x == 0) {
    stage(rec, table, chunks, 0, &bars[0]);
    if (total > 1) stage(rec + chunk_floats, table, chunks, 1, &bars[1]);
  }
  for (int s = 0; s < total; ++s) {
    const int k = s / n_chunks, c = s - k * n_chunks, b = s & 1;
    if (c == 0) {
      sweep.fetch((block + k * blocks) * TILE + threadIdx.x * RAYS);
      sweep.begin();
    }
    float* buf = rec + (b ? chunk_floats : 0);
    mbar_wait(&bars[b], (uint32_t)((s >> 1) & 1));
    sweep.chunk(buf);
    __syncthreads();  // every thread is done with buffer b
    if (threadIdx.x == 0 && s + 2 < total) stage(buf, table, chunks, (s + 2) % n_chunks, &bars[b]);
    if (c == n_chunks - 1) sweep.end();
  }
}

// ------------------------------------------------------------ K5c

template <bool MOTION>
struct Closest {
  const float* origins;
  const float* dirs;
  const float* times;
  int n;
  float* t_out;
  int* prim_out;
  int* tri_out;
  int first;
  int next_first;
  Rays r, next;
  float best_t[RAYS];
  int best_prim[RAYS], best_tri[RAYS];
  // the open group: its bound, its candidate (t, prim, tri) and the
  // candidate's t by intersect_ray_tri's formula
  float g_bound[RAYS], g_t[RAYS], g_tre[RAYS];
  int g_prim[RAYS], g_tri[RAYS];

  // load the rays of the thread that start at first_ray
  __device__ __forceinline__ void fetch(int first_ray) {
    next_first = first_ray;
    load_rays(next, origins, dirs, times, first_ray, n);
  }

  // sweep the fetched rays
  __device__ __forceinline__ void begin() {
    first = next_first;
    r = next;
#pragma unroll
    for (int j = 0; j < RAYS; ++j) {
      best_t[j] = inf();
      best_prim[j] = best_tri[j] = -1;
      g_bound[j] = g_t[j] = g_tre[j] = inf();
      g_prim[j] = g_tri[j] = -1;
    }
  }

  __device__ __forceinline__ void take(float t, bool hit, int j, int id) {
    if (hit && isfinite(t) && t < best_t[j]) {
      best_t[j] = t;
      best_prim[j] = id;
      best_tri[j] = -1;
    }
  }

  __device__ __forceinline__ void chunk(const float* rec) {
    const int4 head = *reinterpret_cast<const int4*>(rec);
    const int ns = head.x, np = head.y, ng = head.z;
    const int* ids = reinterpret_cast<const int*>(rec + HEAD);
    const float4* recs = reinterpret_cast<const float4*>(rec + HEAD + pad4(ns));
    if (MOTION && (head.w & SPHERES_MOVE)) {
      for (int k = 0; k < ns; ++k) {
        const float4 a = recs[3 * k], b = recs[3 * k + 1], c = recs[3 * k + 2];
        const int id = ids[k];
#pragma unroll
        for (int j = 0; j < RAYS; ++j) {
          const float tm = r.time[j];
          const V3 ctr = {a.x + b.x * tm, a.y + b.y * tm, a.z + b.z * tm};
          float t;
          const bool hit = sphere_hit(ctr, c.x * (a.w + b.w * tm), r.o[j], r.d[j], t);
          take(t, hit, j, id);
        }
      }
    } else {
      for (int k = 0; k < ns; ++k) {
        const float4 a = recs[k];
        const int id = ids[k];
#pragma unroll
        for (int j = 0; j < RAYS; ++j) {
          float t;
          const bool hit = sphere_hit(xyz(a), a.w, r.o[j], r.d[j], t);
          take(t, hit, j, id);
        }
      }
    }
    const int sl = MOTION && (head.w & SPHERES_MOVE) ? SPHERE_MOVING : SPHERE_STATIC;
    const float* p = rec + HEAD + pad4(ns) + sl * ns;
    ids = reinterpret_cast<const int*>(p);
    recs = reinterpret_cast<const float4*>(p + pad4(np));
    for (int k = 0; k < np; ++k) {
      const float4 pl = recs[k];
      const int id = ids[k];
#pragma unroll
      for (int j = 0; j < RAYS; ++j) {
        float t;
        const bool hit = plane_hit(pl, r.o[j], r.d[j], t);
        take(t, hit, j, id);
      }
    }
    p += pad4(np) + PLANE_LEN * np;
    for (int gi = 0; gi < ng; ++gi) p = group(p);
  }

  __device__ __forceinline__ const float* group(const float* g) {
    const int4 head = *reinterpret_cast<const int4*>(g);
    const float4 lo = reinterpret_cast<const float4*>(g)[1];
    const float4 hi = reinterpret_cast<const float4*>(g)[2];
    const int nt = head.x, ni = head.y, flags = head.z, tri_base = head.w;
    const float4* tris = reinterpret_cast<const float4*>(g + GROUP_HEAD);
    const int* ids = reinterpret_cast<const int*>(g + GROUP_HEAD + TRI_LEN * nt);
    const float4* inst = reinterpret_cast<const float4*>(g + GROUP_HEAD + TRI_LEN * nt + pad4(ni));
    const bool moves = MOTION && (flags & MOVES);
    if (flags & OPENS) {
#pragma unroll
      for (int j = 0; j < RAYS; ++j) {
        g_bound[j] = g_t[j] = best_t[j];
        g_tre[j] = inf();
        g_prim[j] = g_tri[j] = -1;
      }
    }
    for (int k = 0; k < ni; ++k) {
      const int id = ids[k];
      V3 ol[RAYS], dl[RAYS];
      bool pass[RAYS];
      bool any = false;
      if (moves) {
        const float4 a = inst[4 * k], q = inst[4 * k + 1], b = inst[4 * k + 2],
                     dq = inst[4 * k + 3];
#pragma unroll
        for (int j = 0; j < RAYS; ++j) {
          const Frame f = moving_frame(a, q, b, dq, r.time[j]);
          ol[j] = inverse_rotate(f.u, f.qw, sub(r.o[j], f.p), f.s, true);
          dl[j] = inverse_rotate(f.u, f.qw, r.d[j], f.s, true);
        }
      } else {
        const float4 a = inst[2 * k], b = inst[2 * k + 1];
        const bool divide = a.w != 1.0f;
#pragma unroll
        for (int j = 0; j < RAYS; ++j) {
          ol[j] = inverse_rotate(xyz(b), b.w, sub(r.o[j], xyz(a)), a.w, divide);
          dl[j] = inverse_rotate(xyz(b), b.w, r.d[j], a.w, divide);
        }
      }
#pragma unroll
      for (int j = 0; j < RAYS; ++j) {
        pass[j] = box_entry(lo, hi, ol[j], dl[j], g_bound[j]);
        any |= pass[j];
      }
      if (!any) continue;
      for (int m = 0; m < nt; ++m) {
        const Tri v = tri_at(tris + 3 * m);
#pragma unroll
        for (int j = 0; j < RAYS; ++j) {
          if (!pass[j]) continue;
          float t;
          if (tri_hit(v, ol[j], dl[j], t) && t < g_t[j]) {
            g_t[j] = t;
            g_prim[j] = id;
            g_tri[j] = tri_base + m;
            g_tre[j] = ray_tri_t(v, ol[j], dl[j]);
          }
        }
      }
    }
    if (flags & CLOSES) {  // the group's winner, at its own t
#pragma unroll
      for (int j = 0; j < RAYS; ++j) {
        if (g_prim[j] >= 0 && g_tre[j] > 0.0f && g_tre[j] < best_t[j]) {
          best_t[j] = g_tre[j];
          best_prim[j] = g_prim[j];
          best_tri[j] = g_tri[j];
        }
        g_prim[j] = -1;
      }
    }
    return g + GROUP_HEAD + TRI_LEN * nt + pad4(ni) +
           (moves ? INSTANCE_MOVING : INSTANCE_STATIC) * ni;
  }

  __device__ __forceinline__ void end() {
    const int valid = min(RAYS, n - first);
    if (valid == RAYS) {  // 8-byte stores: first is even
      *reinterpret_cast<float2*>(t_out + first) = make_float2(best_t[0], best_t[1]);
      *reinterpret_cast<int2*>(prim_out + first) = make_int2(best_prim[0], best_prim[1]);
      *reinterpret_cast<int2*>(tri_out + first) = make_int2(best_tri[0], best_tri[1]);
      return;
    }
#pragma unroll
    for (int j = 0; j < RAYS; ++j) {
      if (j < valid) {
        t_out[first + j] = best_t[j];
        prim_out[first + j] = best_prim[j];
        tri_out[first + j] = best_tri[j];
      }
    }
  }
};

// ------------------------------------------------------------ K5a

template <bool MOTION>
struct Any {
  const float* origins;
  const float* dirs;
  const float* times;
  const float* tmaxs;
  int n;
  uint8_t* occ_out;
  int first, next_first;
  Rays r, next;
  float tmax[RAYS], next_tmax[RAYS];
  bool occ[RAYS];

  __device__ __forceinline__ void fetch(int first_ray) {
    next_first = first_ray;
    load_rays(next, origins, dirs, times, first_ray, n);
    const int valid = min(RAYS, n - first_ray);
    load_floats<RAYS>(tmaxs + first_ray, next_tmax, valid == RAYS, valid);
  }

  __device__ __forceinline__ void begin() {
    first = next_first;
    r = next;
#pragma unroll
    for (int j = 0; j < RAYS; ++j) {
      tmax[j] = next_tmax[j];
      occ[j] = false;
    }
  }

  __device__ __forceinline__ void chunk(const float* rec) {
    const int4 head = *reinterpret_cast<const int4*>(rec);
    const int ns = head.x, np = head.y, ng = head.z;
    const float4* recs = reinterpret_cast<const float4*>(rec + HEAD + pad4(ns));
    if (MOTION && (head.w & SPHERES_MOVE)) {
      for (int k = 0; k < ns; ++k) {
        const float4 a = recs[3 * k], b = recs[3 * k + 1], c = recs[3 * k + 2];
#pragma unroll
        for (int j = 0; j < RAYS; ++j) {
          const float tm = r.time[j];
          const V3 ctr = {a.x + b.x * tm, a.y + b.y * tm, a.z + b.z * tm};
          float t;
          occ[j] |= sphere_hit(ctr, c.x * (a.w + b.w * tm), r.o[j], r.d[j], t) && t < tmax[j];
        }
      }
    } else {
      for (int k = 0; k < ns; ++k) {
        const float4 a = recs[k];
#pragma unroll
        for (int j = 0; j < RAYS; ++j) {
          float t;
          occ[j] |= sphere_hit(xyz(a), a.w, r.o[j], r.d[j], t) && t < tmax[j];
        }
      }
    }
    const int sl = MOTION && (head.w & SPHERES_MOVE) ? SPHERE_MOVING : SPHERE_STATIC;
    const float* p = rec + HEAD + pad4(ns) + sl * ns;
    recs = reinterpret_cast<const float4*>(p + pad4(np));
    for (int k = 0; k < np; ++k) {
      const float4 pl = recs[k];
#pragma unroll
      for (int j = 0; j < RAYS; ++j) {
        float t;
        occ[j] |= plane_hit(pl, r.o[j], r.d[j], t) && t < tmax[j];
      }
    }
    p += pad4(np) + PLANE_LEN * np;
    for (int gi = 0; gi < ng; ++gi) p = group(p);
  }

  __device__ __forceinline__ const float* group(const float* g) {
    const int4 head = *reinterpret_cast<const int4*>(g);
    const float4 lo = reinterpret_cast<const float4*>(g)[1];
    const float4 hi = reinterpret_cast<const float4*>(g)[2];
    const int nt = head.x, ni = head.y, flags = head.z;
    const float4* tris = reinterpret_cast<const float4*>(g + GROUP_HEAD);
    const float4* inst = reinterpret_cast<const float4*>(g + GROUP_HEAD + TRI_LEN * nt + pad4(ni));
    const bool moves = MOTION && (flags & MOVES);
    for (int k = 0; k < ni; ++k) {
      V3 ol[RAYS], dl[RAYS];
      bool pass[RAYS];
      bool any = false;
      if (moves) {
        const float4 a = inst[4 * k], q = inst[4 * k + 1], b = inst[4 * k + 2],
                     dq = inst[4 * k + 3];
#pragma unroll
        for (int j = 0; j < RAYS; ++j) {
          const Frame f = moving_frame(a, q, b, dq, r.time[j]);
          ol[j] = inverse_rotate(f.u, f.qw, sub(r.o[j], f.p), f.s, true);
          dl[j] = inverse_rotate(f.u, f.qw, r.d[j], f.s, true);
        }
      } else {
        const float4 a = inst[2 * k], b = inst[2 * k + 1];
        const bool divide = a.w != 1.0f;
#pragma unroll
        for (int j = 0; j < RAYS; ++j) {
          ol[j] = inverse_rotate(xyz(b), b.w, sub(r.o[j], xyz(a)), a.w, divide);
          dl[j] = inverse_rotate(xyz(b), b.w, r.d[j], a.w, divide);
        }
      }
#pragma unroll
      for (int j = 0; j < RAYS; ++j) {
        pass[j] = !occ[j] && box_entry(lo, hi, ol[j], dl[j], tmax[j]);
        any |= pass[j];
      }
      if (any) {
        for (int m = 0; m < nt; ++m) {
          const Tri v = tri_at(tris + 3 * m);
          bool left = false;
#pragma unroll
          for (int j = 0; j < RAYS; ++j) {
            if (!pass[j]) continue;
            float t;
            pass[j] = !(tri_hit(v, ol[j], dl[j], t) && t < tmax[j]);
            occ[j] |= !pass[j];
            left |= pass[j];
          }
          if (!left) break;
        }
      }
    }
    return g + GROUP_HEAD + TRI_LEN * nt + pad4(ni) +
           (moves ? INSTANCE_MOVING : INSTANCE_STATIC) * ni;
  }

  __device__ __forceinline__ void end() {
    const int valid = min(RAYS, n - first);
    if (valid == RAYS) {  // one 2-byte store: first is even
      *reinterpret_cast<uint16_t*>(occ_out + first) = (uint16_t)(occ[0] | (occ[1] << 8));
      return;
    }
#pragma unroll
    for (int j = 0; j < RAYS; ++j)
      if (j < valid) occ_out[first + j] = occ[j] ? 1 : 0;
  }
};

// K5c: the next tile's rays in flight; K5a: held to 3 blocks an SM (80
// registers), where that prefetch would spill
template <bool MOTION>
__global__ void __launch_bounds__(THREADS, 1)
sweep_closest_kernel(const float* __restrict__ table, const int* __restrict__ chunks,
                     int n_chunks, int chunk_floats, const float* __restrict__ origins,
                     const float* __restrict__ dirs, const float* __restrict__ times, int n,
                     float* __restrict__ t_out, int* __restrict__ prim_out,
                     int* __restrict__ tri_out) {
  extern __shared__ __align__(128) float rec[];
  __shared__ uint64_t bars[2];
  Closest<MOTION> sweep;
  sweep.origins = origins, sweep.dirs = dirs, sweep.times = times, sweep.n = n;
  sweep.t_out = t_out, sweep.prim_out = prim_out, sweep.tri_out = tri_out;
  tiles<true>(rec, bars, table, chunks, n_chunks, chunk_floats, n, sweep);
}

template <bool MOTION>
__global__ void __launch_bounds__(THREADS, 3)
sweep_any_kernel(const float* __restrict__ table, const int* __restrict__ chunks, int n_chunks,
                 int chunk_floats, const float* __restrict__ origins, const float* __restrict__ dirs,
                 const float* __restrict__ times, const float* __restrict__ tmaxs, int n,
                 uint8_t* __restrict__ occ_out) {
  extern __shared__ __align__(128) float rec[];
  __shared__ uint64_t bars[2];
  Any<MOTION> sweep;
  sweep.origins = origins, sweep.dirs = dirs, sweep.times = times, sweep.tmaxs = tmaxs;
  sweep.n = n, sweep.occ_out = occ_out;
  tiles<false>(rec, bars, table, chunks, n_chunks, chunk_floats, n, sweep);
}

// Per device and kernel: the card's opt-in limit and SM count, the shared
// bytes the kernel is allowed (the attribute belongs to the device's
// context) and its resident blocks at the last shared size asked for.
struct DeviceCache {
  bool ready;
  int optin, sms, allowed[4], smem[4], per_sm[4];  // [2 * any + motion]
};
constexpr int CACHED_DEVICES = 64;
DeviceCache cache[CACHED_DEVICES];
std::mutex cache_mutex;

// Launch geometry for the current device: the shared bytes (chunk_floats,
// the largest chunk; two buffers when the table has several chunks) and
// a grid of at most one block per resident slot. Returns 0; 9001 on bad
// arguments, 9002 when the shared memory is above what a block of this
// card may opt in to; else the CUDA error.
template <class K>
int geometry(K kernel, int which, int n_chunks, int chunk_floats, int n, int& grid, int& smem) {
  if (n < 1 || n_chunks < 0 || chunk_floats < 0 || chunk_floats % 4 != 0 ||
      (n_chunks > 0 && chunk_floats == 0) || chunk_floats > (1 << 20))
    return 9001;
  smem = 4 * chunk_floats * (n_chunks > 1 ? 2 : 1);
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= CACHED_DEVICES) return 9001;
  std::lock_guard<std::mutex> lock(cache_mutex);
  DeviceCache& c = cache[dev];
  if (!c.ready) {
    e = cudaDeviceGetAttribute(&c.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    for (int k = 0; k < 4; ++k) c.allowed[k] = c.smem[k] = -1;
    c.ready = true;
  }
  if (smem + 16 > c.optin) return 9002;  // 16: the static mbarriers
  if (c.allowed[which] < smem) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    c.allowed[which] = smem;
  }
  if (c.smem[which] != smem) {
    int per_sm;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return 9002;
    c.smem[which] = smem;
    c.per_sm[which] = per_sm;
  }
  const int n_tiles = (n + TILE - 1) / TILE, slots = c.sms * c.per_sm[which];
  grid = slots < n_tiles ? slots : n_tiles;
  return 0;
}

}  // namespace

// The launch geometry a call would take: tile (rays a block sweeps at a
// time) and grid; returns 0, or the launch's error code.
extern "C" int tinsel_sweep_geometry(int closest, int motion, int n_chunks, int chunk_floats,
                                     int n, int* tile, int* grid) {
  int smem;
  *tile = TILE;
  if (closest)
    return motion ? geometry(sweep_closest_kernel<true>, 1, n_chunks, chunk_floats, n, *grid, smem)
                  : geometry(sweep_closest_kernel<false>, 0, n_chunks, chunk_floats, n, *grid, smem);
  return motion ? geometry(sweep_any_kernel<true>, 3, n_chunks, chunk_floats, n, *grid, smem)
                : geometry(sweep_any_kernel<false>, 2, n_chunks, chunk_floats, n, *grid, smem);
}

// times NULL: no record moves, and the kernels without motion run
extern "C" int tinsel_sweep_closest(const float* table, const int* chunks, int n_chunks,
                                    int chunk_floats, const float* origins, const float* dirs,
                                    const float* times, int n, float* t_out, int* prim_out,
                                    int* tri_out, cudaStream_t stream) {
  int grid, smem;
  const auto kernel = times ? sweep_closest_kernel<true> : sweep_closest_kernel<false>;
  const int err = geometry(kernel, times ? 1 : 0, n_chunks, chunk_floats, n, grid, smem);
  if (err) return err;
  kernel<<<grid, THREADS, smem, stream>>>(table, chunks, n_chunks, chunk_floats, origins, dirs,
                                          times, n, t_out, prim_out, tri_out);
  return (int)cudaGetLastError();
}

extern "C" int tinsel_sweep_any(const float* table, const int* chunks, int n_chunks,
                                int chunk_floats, const float* origins, const float* dirs,
                                const float* times, const float* tmax, int n, uint8_t* occ_out,
                                cudaStream_t stream) {
  int grid, smem;
  const auto kernel = times ? sweep_any_kernel<true> : sweep_any_kernel<false>;
  const int err = geometry(kernel, times ? 3 : 2, n_chunks, chunk_floats, n, grid, smem);
  if (err) return err;
  kernel<<<grid, THREADS, smem, stream>>>(table, chunks, n_chunks, chunk_floats, origins, dirs,
                                          times, tmax, n, occ_out);
  return (int)cudaGetLastError();
}
