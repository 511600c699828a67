// Wide-BVH walks for Hopper (sm_90a): kernels K3 (closest hit) and K4
// (any hit with t < tmax).
//
// Replaces: tinsel_tpu/accel/traverse.py:761 intersect_mesh (its walk
// _run_tiled / _traverse_tile / _step, :390-489) and :903
// intersect_mesh_any (_traverse_tile_any, :811). In the JAX package these
// are pure JAX lockstep loops; here each lane is one thread that walks
// its own sub-BVH to the end.
//
// Layout (accel/build.py, built on the host):
//   node row (72 floats): cols [0,16) x, [16,32) y, [32,48) z child boxes,
//     one u32 per child and axis with bf16(upper) in the high half and
//     bf16(lower) in the low half, both rounded outward; empty slots are
//     bf16 NaN and always miss; cols [48,64) i32 child words: >= 0 an
//     internal child, < 0 the leaf block ~word.
//   block row (192 floats): 16 x v0x, 16 x v0y, 16 x v0z, 16 x v1x, ...,
//     16 x v2z, 48 pad.
//
// The walk (the plain version is accel/traverse.py::_walk): at a node the
// lane tests, in slot order, each hit leaf child's 16 triangles under its
// current best t (strict <, first slot on a tie); then it descends into
// the first hit internal child at slot >= ic, pushing one compressed
// entry (cur << 4 | next hit internal slot) if there is one; with none it
// pops, re-tests that node's children under the tightened best t and
// resumes at the stored slot. The stack is per thread, in local memory,
// at most 128 entries (MeshHandle.stack_slots bounds it exactly).
//
// Bound: a walk is a chain of dependent loads (node row -> leaf block ->
// next node), so it is bounded by memory latency and divergence more than
// by bytes or operations; this kernel is the simple one-thread-per-lane
// form. Rows go through the read-only cache (__ldg).
//
// Rounding: this file is compiled with -fmad=false, so every product and
// sum rounds on its own, in the plain version's order, and t and the
// winning triangle equal the plain version's bit for bit. Division is
// IEEE (no fast math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 16;          // node fan-out
constexpr int ROW = 72;        // floats per node row
constexpr int BS = 16;         // triangles per leaf block
constexpr int BROW = 12 * BS;  // floats per block row
constexpr int SLOT_BITS = 4;
constexpr int MAX_STACK = 128;

struct Ray {
  float ox, oy, oz, dx, dy, dz, rx, ry, rz;
};

// torch.minimum / torch.maximum: NaN if either operand is NaN
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float safe_rcp(float d) {
  const float eps = 1e-30f;
  float x = fabsf(d) < eps ? (d < 0.0f ? -eps : eps) : d;
  return 1.0f / x;
}

__device__ __forceinline__ int child_word(const float* row, int c) {
  return __float_as_int(__ldg(row + 3 * K + c));
}

// slab test of child c: tn <= tf and tn < best_t
__device__ __forceinline__ bool child_hit(const float* row, int c, const Ray& r,
                                          float best_t) {
  const uint32_t bx = __float_as_uint(__ldg(row + c));
  const uint32_t by = __float_as_uint(__ldg(row + K + c));
  const uint32_t bz = __float_as_uint(__ldg(row + 2 * K + c));
  const float t0x = (__uint_as_float(bx << 16) - r.ox) * r.rx;
  const float t1x = (__uint_as_float(bx & 0xFFFF0000u) - r.ox) * r.rx;
  const float t0y = (__uint_as_float(by << 16) - r.oy) * r.ry;
  const float t1y = (__uint_as_float(by & 0xFFFF0000u) - r.oy) * r.ry;
  const float t0z = (__uint_as_float(bz << 16) - r.oz) * r.rz;
  const float t1z = (__uint_as_float(bz & 0xFFFF0000u) - r.oz) * r.rz;
  const float tn = nmax(nmax(nmin(t0x, t1x), nmin(t0y, t1y)), nmax(nmin(t0z, t1z), 0.0f));
  const float tf = nmin(nmin(nmax(t0x, t1x), nmax(t0y, t1y)), nmax(t0z, t1z));
  return tn <= tf && tn < best_t;
}

// two-sided Moller-Trumbore (accel/traverse.py::_tri_hit), eps 1e-9
__device__ __forceinline__ bool tri_hit(const float* b, int j, const Ray& r, float* t_out) {
  const float v0x = __ldg(b + j), v0y = __ldg(b + BS + j), v0z = __ldg(b + 2 * BS + j);
  const float v1x = __ldg(b + 3 * BS + j), v1y = __ldg(b + 4 * BS + j), v1z = __ldg(b + 5 * BS + j);
  const float v2x = __ldg(b + 6 * BS + j), v2y = __ldg(b + 7 * BS + j), v2z = __ldg(b + 8 * BS + j);
  const float abx = v1x - v0x, aby = v1y - v0y, abz = v1z - v0z;
  const float acx = v2x - v0x, acy = v2y - v0y, acz = v2z - v0z;
  const float px = r.dy * acz - r.dz * acy;
  const float py = r.dz * acx - r.dx * acz;
  const float pz = r.dx * acy - r.dy * acx;
  const float det = abx * px + aby * py + abz * pz;
  const bool ok = fabsf(det) >= 1e-9f;
  const float inv = 1.0f / (ok ? det : 1.0f);
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv;
  const float qx = ty * abz - tz * aby;
  const float qy = tz * abx - tx * abz;
  const float qz = tx * aby - ty * abx;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
  const float t = (acx * qx + acy * qy + acz * qz) * inv;
  *t_out = t;
  return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f;
}

__device__ __forceinline__ Ray load_ray(const float* o, const float* d, int i) {
  Ray r;
  r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
  r.dx = d[3 * i]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
  r.rx = safe_rcp(r.dx); r.ry = safe_rcp(r.dy); r.rz = safe_rcp(r.dz);
  return r;
}

// The walk shared by both kernels. ANY: stop at the first triangle with
// t < tmax. Returns (in best_t / best_tri) the closest hit, or whether
// any hit was found (best_tri >= 0).
template <bool ANY>
__device__ __forceinline__ void walk(const float* __restrict__ node_rows,
                                     const float* __restrict__ block_rows,
                                     int noff, int bbase, const Ray& r, int slots,
                                     float& best_t, int& best_tri) {
  int stack[MAX_STACK];
  int sp = 0, cur = 0, lc = 0, ic = 0;
  while (cur >= 0) {
    const float* row = node_rows + (size_t)(noff + cur) * ROW;
    // leaf children in slot order, each under the best t of the blocks
    // tested before it
    for (int c = lc; c < K; ++c) {
      const int w = child_word(row, c);
      if (w >= 0 || !child_hit(row, c, r, best_t)) continue;
      const int blk = ~w;
      const float* b = block_rows + (size_t)(bbase + blk) * BROW;
      float m = best_t;
      int slot = -1;
      for (int j = 0; j < BS; ++j) {
        float t;
        if (tri_hit(b, j, r, &t) && t < m) {
          m = t;
          slot = j;
          if (ANY) break;
        }
      }
      if (slot >= 0) {
        best_tri = blk * BS + slot;
        if (ANY) return;
        best_t = m;
      }
    }
    // internal children: descend into the first hit slot >= ic, keep the
    // next one in one stack entry
    int first = K, second = K;
    for (int c = ic; c < K; ++c) {
      const int w = child_word(row, c);
      if (w < 0 || !child_hit(row, c, r, best_t)) continue;
      if (first == K) {
        first = c;
      } else {
        second = c;
        break;
      }
    }
    if (first < K) {
      if (second < K) {
        if (sp < slots) stack[sp] = (cur << SLOT_BITS) | second;
        ++sp;
      }
      cur = child_word(row, first);
      ic = 0;
      lc = 0;
    } else if (sp > 0) {
      --sp;
      const int e = sp < slots ? stack[sp] : -1;
      cur = e < 0 ? -1 : (e >> SLOT_BITS);
      ic = e & (K - 1);
      lc = K;  // this node's leaves were tested before the push
    } else {
      cur = -1;
    }
  }
}

__global__ void __launch_bounds__(128)
bvh_closest_kernel(const float* __restrict__ node_rows, const float* __restrict__ block_rows,
                   const float* __restrict__ origins, const float* __restrict__ dirs,
                   const float* __restrict__ tmax, const int* __restrict__ noffs,
                   const int* __restrict__ toffs, int noff0, int toff0, int n, int slots,
                   float* __restrict__ t_out, int* __restrict__ tri_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(origins, dirs, i);
  const int noff = noffs ? noffs[i] : noff0;
  const int toff = toffs ? toffs[i] : toff0;
  float best_t = tmax[i];
  int best_tri = -1;
  walk<false>(node_rows, block_rows, noff, toff / BS, r, slots, best_t, best_tri);
  t_out[i] = best_tri >= 0 ? best_t : __int_as_float(0x7f800000);
  tri_out[i] = best_tri;
}

__global__ void __launch_bounds__(128)
bvh_any_kernel(const float* __restrict__ node_rows, const float* __restrict__ block_rows,
               const float* __restrict__ origins, const float* __restrict__ dirs,
               const float* __restrict__ tmax, const int* __restrict__ noffs,
               const int* __restrict__ toffs, int noff0, int toff0, int n, int slots,
               uint8_t* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(origins, dirs, i);
  const int noff = noffs ? noffs[i] : noff0;
  const int toff = toffs ? toffs[i] : toff0;
  float best_t = tmax[i];
  int best_tri = -1;
  walk<true>(node_rows, block_rows, noff, toff / BS, r, slots, best_t, best_tri);
  occ_out[i] = best_tri >= 0 ? 1 : 0;
}

}  // namespace

extern "C" int tinsel_bvh_closest(const float* node_rows, const float* block_rows,
                                  const float* origins, const float* dirs, const float* tmax,
                                  const int* noffs, const int* toffs, int noff0, int toff0,
                                  int n, int slots, int threads, float* t_out, int* tri_out,
                                  cudaStream_t stream) {
  if (threads != 128 || slots < 1 || slots > MAX_STACK) return 9001;
  const int blocks = (n + threads - 1) / threads;
  bvh_closest_kernel<<<blocks, threads, 0, stream>>>(node_rows, block_rows, origins, dirs,
                                                     tmax, noffs, toffs, noff0, toff0, n,
                                                     slots, t_out, tri_out);
  return (int)cudaGetLastError();
}

extern "C" int tinsel_bvh_any(const float* node_rows, const float* block_rows,
                              const float* origins, const float* dirs, const float* tmax,
                              const int* noffs, const int* toffs, int noff0, int toff0, int n,
                              int slots, int threads, uint8_t* occ_out, cudaStream_t stream) {
  if (threads != 128 || slots < 1 || slots > MAX_STACK) return 9001;
  const int blocks = (n + threads - 1) / threads;
  bvh_any_kernel<<<blocks, threads, 0, stream>>>(node_rows, block_rows, origins, dirs, tmax,
                                                 noffs, toffs, noff0, toff0, n, slots,
                                                 occ_out);
  return (int)cudaGetLastError();
}
