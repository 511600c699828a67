// The non-local-means denoiser kernels for Hopper (sm_90a), K1
// (tinsel_nlm_filter) and K2 (tinsel_nlm_guided), built by ops/_build.py
// into one library with a plain C interface. The shared parts come first,
// then each kernel with its entry point.
//
// Both kernels compute what tinsel_tpu_torch/render/nlm.py computes
// (nlm_filter, nlm_guided): a box mean of the RGB image over a clipped
// window divided by the count of in-bounds taps, then NLM weights
// exp(-falloff * d2 [- g2]) over the in-bounds taps of the search window,
// and out = sum(w * img_q) / max(sum(w), 1e-12).
//
// What bounds them. K1 moves 24 B per pixel and K2 52 B; K1 at r = 1 is
// bounded by bytes, K2 at r = 2 by f32 operations (chip_smoke.py counts
// both). The first version of these kernels issued ~35 instructions and
// 6-13 shared loads per search tap, plus integer divides and bounds tests
// per staged element; what the card spent was instruction issue. This
// design cuts instructions per pixel:
//
// - Tiles of 32 x 32 outputs. Lane = column; each thread walks R rows.
//   For one column offset dx, a thread loads each q row of its strip once
//   and uses it for every (pixel, dy) pair that needs it, so a staged
//   value is read from shared memory (R + 2r) / R times per dx instead of
//   (2r+1) times.
// - Staging by TMA when the (H, W*C) rows are 16-byte multiples and every
//   base is 16-byte aligned (W % 4 == 0 and aligned tensors: the 512^2
//   and 2160x3840 shapes of chip_smoke.py): one CUtensorMap per input,
//   one thread issues the boxes, an mbarrier signals completion, and the
//   out-of-bounds zero fill replaces every bounds test. A box must start
//   on a 16-byte boundary of its row (the card raises an illegal
//   instruction otherwise), so each staged row begins `lead` floats
//   early. Other widths and offset pointers (37x53, 33x49, 1x5) take the
//   second path of the same kernel: cp.async of 4 bytes per element, row
//   by row, zero-filled by a source size of 0, no divisions.
// - A persistent grid walks the tiles; with two stages the next tile's
//   loads are in flight while the current one computes.
// - Box means are separable: each thread walks one column of the mean
//   region, keeping the last 2m+1 row sums in registers; the count is the
//   product of the clipped row and column extents.
// - Interior tiles run the search without any test; edge tiles mask the
//   weight sum by absolute image coordinates (staged zeros keep the
//   weighted sum exact). r = 1, 2, 3 are compiled for their radius; any
//   other radius, or a negative factor, runs the runtime-r search.
// - The factors are folded into the staged data (sqrt(factor * log2 e)),
//   so a weight is ex2 of minus one sum of squared differences.
//
// Sums run in another order than the plain version's (separable means,
// dx-major taps), ex2.approx replaces expf and one reciprocal the three
// divides: the result stays within the 1e-5 that chip_smoke.py and the
// card tests hold it to.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int TX = 32;  // tile width: one warp, one column per lane
constexpr int TY = 32;  // tile height
constexpr int SMEM_MAX = 232448;
constexpr float LOG2E = 1.4426950408889634f;

// Error codes of the C interface besides CUDA's own.
constexpr int ERR_GEOMETRY = 9001;   // geometry disagrees with the kernel
constexpr int ERR_NO_ENCODE = 9002;  // cuTensorMapEncodeTiled unavailable
constexpr int ERR_ENCODE = 9100;     // + CUresult of a failed encode

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ constexpr int align128(int b) { return (b + 127) & ~127; }

// Shared-memory layout, mirrored by ops/nlm.py::_smem_bytes. Bytes:
// [alignment slack 128][mbarriers 128][stage 0][stage 1][means]. A stage
// holds each staged input as rows x pitch floats (the TMA box), starting
// `halo` rows and columns before the tile. A TMA box must start on a
// 16-byte boundary of the row, so each row begins `lead` floats early.
struct Layout {
  int n;
  int ch[4], halo[4], lead[4], rows[4], pitch[4], off[4];
  int stage, tx_bytes;
  int mrows, mpitch, mean_off, total;
};

__host__ __device__ inline void add_input(Layout& L, int ch, int halo) {
  const int k = L.n++;
  L.ch[k] = ch;
  L.halo[k] = halo;
  L.lead[k] = (4 - (ch * halo) % 4) % 4;
  L.rows[k] = TY + 2 * halo;
  L.pitch[k] = round4(L.lead[k] + ch * (TX + 2 * halo));
  L.off[k] = L.stage;
  L.stage += align128(L.rows[k] * L.pitch[k] * 4);
  L.tx_bytes += L.rows[k] * L.pitch[k] * 4;
}

// K1 stages the image with halo 2r (means of radius r at the r-halo of
// the tile); K2 the image with halo r+1 (radius-1 means) and the normal,
// albedo and depth guides with halo r.
__host__ __device__ inline Layout make_layout(bool guided, int r, int stages) {
  Layout L{};
  if (guided) {
    add_input(L, 3, r + 1);
    add_input(L, 3, r);
    add_input(L, 3, r);
    add_input(L, 1, r);
  } else {
    add_input(L, 3, 2 * r);
  }
  L.mrows = TY + 2 * r;
  L.mpitch = 3 * (TX + 2 * r);
  L.mean_off = 256 + stages * L.stage;
  L.total = L.mean_off + align128(L.mrows * L.mpitch * 4);
  return L;
}

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t sptr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// out = acc / max(wsum, 1e-12) as the plain version divides, to 2 ulp
__device__ __forceinline__ void store_rgb(float* __restrict__ out, int y, int x, int w,
                                          float a0, float a1, float a2, float ws) {
  const float inv = rcp(fmaxf(ws, 1e-12f));
  float* o = out + ((size_t)y * w + x) * 3;
  o[0] = a0 * inv;
  o[1] = a1 * inv;
  o[2] = a2 * inv;
}

__device__ __forceinline__ void mbar_init(uint64_t* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(sptr(b)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(sptr(b)),
               "r"(bytes)
               : "memory");
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

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0,
                                         int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(sptr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(sptr(bar))
      : "memory");
}

// 4-byte copy; a source size of 0 writes a zero and reads nothing.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(sptr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ------------------------------------------------------------- staging

// Kernel inputs: device pointers (cp.async) and one tensor map each (TMA),
// the maps a __grid_constant__ parameter read in place.
template <int NIN>
struct Inputs {
  const float* p[NIN];
};

template <int NIN>
struct Maps {
  CUtensorMap m[NIN];
};

// Start the loads of one tile's inputs into a stage.
template <int NIN>
__device__ void issue_stage(const Layout& L, const Inputs<NIN>& in,
                            const Maps<NIN>& maps, unsigned char* st,
                            uint64_t* bar, bool tma, int y0, int x0, int h, int w,
                            int nt) {
  const int tid = threadIdx.x;
  if (tma) {
    if (tid == 0) {
      mbar_expect(bar, L.tx_bytes);
#pragma unroll
      for (int k = 0; k < NIN; ++k)
        tma_load(st + L.off[k], &maps.m[k], L.ch[k] * (x0 - L.halo[k]) - L.lead[k],
                 y0 - L.halo[k], bar);
    }
    return;
  }
  const int lane = tid & 31, nw = nt >> 5;
#pragma unroll
  for (int k = 0; k < NIN; ++k) {
    const int rowlen = w * L.ch[k], e0 = L.ch[k] * (x0 - L.halo[k]) - L.lead[k];
    const int pitch = L.pitch[k];
    float* dst = reinterpret_cast<float*>(st + L.off[k]);
    for (int row = tid >> 5; row < L.rows[k]; row += nw) {
      const int gy = y0 - L.halo[k] + row;
      const bool rok = gy >= 0 && gy < h;
      const float* srow = in.p[k] + (size_t)(rok ? gy : 0) * rowlen;
      for (int e = lane; e < pitch; e += 32) {
        const int ge = e0 + e;
        const bool ok = rok && ge >= 0 && ge < rowlen;
        cp_async4(dst + row * pitch + e, ok ? srow + ge : in.p[k], ok ? 4 : 0);
      }
    }
  }
  cp_commit();
}

// The persistent loop over tiles: stage, compute(stage, y0, x0), repeat.
template <int NIN, class F>
__device__ void tile_loop(unsigned char* base, const Layout& L, const Inputs<NIN>& in,
                          const Maps<NIN>& maps, bool tma, int stages, int h, int w,
                          int tiles_x, int ntiles, int nt, F&& compute) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + 128);
  if (tma && threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto stage = [&](int s) { return base + 256 + s * L.stage; };
  auto issue = [&](int t, int s) {
    const int ty = t / tiles_x;
    issue_stage<NIN>(L, in, maps, stage(s), &bars[s], tma, ty * TY,
                     (t - ty * tiles_x) * TX, h, w, nt);
  };
  int tile = blockIdx.x;
  if (tile < ntiles) issue(tile, 0);
  for (int it = 0; tile < ntiles; ++it, tile += gridDim.x) {
    const int s = stages == 2 ? (it & 1) : 0;
    const int next = tile + gridDim.x;
    const bool ahead = stages == 2 && next < ntiles;
    if (ahead) issue(next, s ^ 1);
    if (tma) {
      mbar_wait(&bars[s], (uint32_t)((it / stages) & 1));
    } else {
      if (ahead)
        cp_wait<1>();
      else
        cp_wait<0>();
      __syncthreads();
    }
    const int ty = tile / tiles_x;
    compute(stage(s), ty * TY, (tile - ty * tiles_x) * TX);
    // generic-proxy writes (K2's in-place scaling) before the next TMA write
    if (tma) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (stages == 1 && next < ntiles) issue(next, 0);
  }
}

// ---------------------------------------------------------- box means

template <int M>
__device__ __forceinline__ float row_sum(const float* p) {
  float s = p[0];
#pragma unroll
  for (int k = 1; k <= 2 * M; ++k) s += p[3 * k];
  return s;
}

__device__ __forceinline__ int clipped(int g, int m, int n) {
  return max(min(g + m, n - 1) - max(g - m, 0) + 1, 1);
}

// Means of radius M (times `scale`) over the mrows x mpitch/3 region whose
// first pixel is (gy0, gx0); the staged image starts M rows and columns
// earlier with row pitch `pin`. A thread walks one element column (pixel
// column and channel) of a row segment, keeping 2M+1 row sums. Channel c
// of mean pixel (m, x) goes to s_mean[m * orow + x * ostep + c].
template <int M>
__device__ void means_walk(const float* s_in, int pin, float* s_mean, int mrows,
                           int mpitch, int orow, int ostep, int gy0, int gx0, int h,
                           int w, float scale, int nt) {
  const int nseg = max(1, nt / mpitch);
  const int seglen = (mrows + nseg - 1) / nseg;
  for (int u = threadIdx.x; u < mpitch * nseg; u += nt) {
    const int seg = u / mpitch, e = u - seg * mpitch;
    const int mx = e / 3, o = mx * ostep + (e - 3 * mx);
    const float sx = scale / (float)clipped(gx0 + mx, M, w);
    const int m0 = seg * seglen, m1 = min(mrows, m0 + seglen);
    float ring[2 * M + 1];
#pragma unroll
    for (int k = 0; k < 2 * M; ++k) ring[k + 1] = row_sum<M>(s_in + (m0 + k) * pin + e);
    for (int m = m0; m < m1; ++m) {
#pragma unroll
      for (int k = 0; k < 2 * M; ++k) ring[k] = ring[k + 1];
      ring[2 * M] = row_sum<M>(s_in + (m + 2 * M) * pin + e);
      float s = ring[0];
#pragma unroll
      for (int k = 1; k <= 2 * M; ++k) s += ring[k];
      const int cy = clipped(gy0 + m, M, h);
      s_mean[m * orow + o] = s * sx * (cy == 2 * M + 1 ? 1.f / (2 * M + 1) : __frcp_rn((float)cy));
    }
  }
}

// The same for a radius known only at run time (K1's runtime-r search).
__device__ void means_gather(const float* s_in, int pin, float* s_mean, int mrows,
                             int mpitch, int gy0, int gx0, int h, int w, int m,
                             int nt) {
  for (int u = threadIdx.x; u < mrows * mpitch; u += nt) {
    const int row = u / mpitch, e = u - row * mpitch;
    float s = 0.f;
    for (int dy = 0; dy <= 2 * m; ++dy) {
      const float* p = s_in + (row + dy) * pin + e;
      float hs = p[0];
      for (int k = 1; k <= 2 * m; ++k) hs += p[3 * k];
      s = dy ? s + hs : hs;
    }
    const float cnt = (float)clipped(gx0 + e / 3, m, w) * (float)clipped(gy0 + row, m, h);
    s_mean[u] = s / cnt;
  }
}

// Bit j set when row y0 + ty0 + j - r of the image exists.
__device__ __forceinline__ uint32_t row_bits(int first, int n, int h) {
  uint32_t b = 0;
  for (int j = 0; j < n; ++j) b |= (uint32_t)(first + j >= 0 && first + j < h) << j;
  return b;
}

// ---------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, reached through the CUDA runtime's
// entry-point query, so the library does not link against libcuda.
inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// One box per staged input over the (H, W*C) view; outside the image the
// box is filled with zeros.
inline int encode(CUtensorMap* m, const float* p, int h, int w, const Layout& L, int k) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t dim[2] = {(cuuint64_t)w * L.ch[k], (cuuint64_t)h};
  const cuuint64_t stride[1] = {(cuuint64_t)w * L.ch[k] * 4};
  const cuuint32_t box[2] = {(cuuint32_t)L.pitch[k], (cuuint32_t)L.rows[k]};
  const cuuint32_t one[2] = {1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dim,
                        stride, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

// Allow the card's largest dynamic shared memory. The attribute belongs to
// the current device's context, so it is set on every call.
inline int opt_in(const void* fn) {
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
}

// The compiled radius: 1, 2 or 3 with non-negative factors, else 0 (runtime r).
inline int compiled_radius(int r, bool folds) { return (folds && r >= 1 && r <= 3) ? r : 0; }

}  // namespace

// ======================================================================
// K1: tinsel_nlm_filter, the NLM denoiser with mean-patch distances.
//
// Replaces the Pallas kernel tinsel_tpu/ops/pallas/nlm.py:44
// _nlm_band_kernel; computes tinsel_tpu_torch/render/nlm.py::nlm_filter.
// Bounded by bytes at its default r = 1 (24 B per pixel). K1 comes in two
// shapes: 4 warps x 8 rows for large images (more reuse of each staged
// value), 8 warps x 4 rows when the image has fewer tiles than the card
// has CTA slots (more warps per tile); ops/nlm.py::launch_geometry
// chooses.

namespace {

template <int R>
struct K1Shape {
  static constexpr int NT = 32 * TY / R, MIN_CTAS = R == 8 ? 4 : 2;
};

// Search of radius RAD. Means are pre-scaled by sqrt(falloff * log2 e).
template <int RAD, int R, bool EDGE>
__device__ void k1_search(const float* s_in, int pin, const float* s_mean, int pm,
                          float* __restrict__ out, int y0, int x0, int h, int w) {
  constexpr int J = R + 2 * RAD;
  const int lane = threadIdx.x & 31, ty0 = (threadIdx.x >> 5) * R;
  float mp[R][3], acc[R][3], ws[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float* p = s_mean + (ty0 + i + RAD) * pm + 3 * (lane + RAD);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      mp[i][c] = p[c];
      acc[i][c] = 0.f;
    }
    ws[i] = 0.f;
  }
  const uint32_t rows = EDGE ? row_bits(y0 + ty0 - RAD, J, h) : 0u;
#pragma unroll 1
  for (int dx = -RAD; dx <= RAD; ++dx) {
    const bool colok = !EDGE || (unsigned)(x0 + lane + dx) < (unsigned)w;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float* mq = s_mean + (ty0 + j) * pm + 3 * (lane + RAD + dx);
      const float* iq = s_in + (ty0 + j + RAD) * pin + 3 * (lane + 2 * RAD + dx);
      const float q0 = mq[0], q1 = mq[1], q2 = mq[2];
      const float v0 = iq[0], v1 = iq[1], v2 = iq[2];
      const bool ok = !EDGE || (colok && ((rows >> j) & 1u));
#pragma unroll
      for (int dy = -RAD; dy <= RAD; ++dy) {
        const int i = j - RAD - dy;
        if (i < 0 || i >= R) continue;
        const float e0 = mp[i][0] - q0, e1 = mp[i][1] - q1, e2 = mp[i][2] - q2;
        const float d = fmaf(e2, e2, fmaf(e1, e1, e0 * e0));
        const float wt = ex2(-d);
        acc[i][0] = fmaf(wt, v0, acc[i][0]);
        acc[i][1] = fmaf(wt, v1, acc[i][1]);
        acc[i][2] = fmaf(wt, v2, acc[i][2]);
        ws[i] += EDGE ? (ok ? wt : 0.f) : wt;
      }
    }
  }
  const int x = x0 + lane;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int y = y0 + ty0 + i;
    if (y < h && x < w) store_rgb(out, y, x, w, acc[i][0], acc[i][1], acc[i][2], ws[i]);
  }
}

// Runtime radius: unscaled means, falloff * log2 e applied per tap.
template <int R>
__device__ void k1_search_any(const float* s_in, int pin, const float* s_mean, int pm,
                              float* __restrict__ out, int y0, int x0, int h, int w,
                              int r, float fl) {
  const int lane = threadIdx.x & 31, ty0 = (threadIdx.x >> 5) * R;
  const int x = x0 + lane;
  for (int i = 0; i < R; ++i) {
    const int y = y0 + ty0 + i;
    const float* mp = s_mean + (ty0 + i + r) * pm + 3 * (lane + r);
    const float* ip = s_in + (ty0 + i + 2 * r) * pin + 3 * (lane + 2 * r);
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, ws = 0.f;
    for (int dy = -r; dy <= r; ++dy) {
      if ((unsigned)(y + dy) >= (unsigned)h) continue;
      for (int dx = -r; dx <= r; ++dx) {
        if ((unsigned)(x + dx) >= (unsigned)w) continue;
        const float* mq = mp + dy * pm + 3 * dx;
        const float* iq = ip + dy * pin + 3 * dx;
        const float e0 = mp[0] - mq[0], e1 = mp[1] - mq[1], e2 = mp[2] - mq[2];
        const float wt = ex2(-fl * fmaf(e2, e2, fmaf(e1, e1, e0 * e0)));
        a0 = fmaf(wt, iq[0], a0);
        a1 = fmaf(wt, iq[1], a1);
        a2 = fmaf(wt, iq[2], a2);
        ws += wt;
      }
    }
    if (y < h && x < w) store_rgb(out, y, x, w, a0, a1, a2, ws);
  }
}

template <int RAD, int R>
__global__ void __launch_bounds__(K1Shape<R>::NT, K1Shape<R>::MIN_CTAS)
    nlm_filter_kernel(const __grid_constant__ Maps<1> maps,
                      const float* __restrict__ img, float* __restrict__ out, int h,
                      int w, float falloff, int r_arg, int stages, int tma, int tiles_x,
                      int ntiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = smem + ((128 - (sptr(smem) & 127)) & 127);
  const int r = RAD ? RAD : r_arg;
  const Layout L = make_layout(false, r, stages);
  Inputs<1> in;
  in.p[0] = img;
  const float fl = falloff * LOG2E;
  const float scale = RAD ? sqrtf(fl) : 1.f;
  float* s_mean = reinterpret_cast<float*>(base + L.mean_off);
  constexpr int NT = K1Shape<R>::NT;
  tile_loop<1>(base, L, in, maps, tma != 0, stages, h, w, tiles_x, ntiles, NT,
               [&](unsigned char* st, int y0, int x0) {
                 const float* s_in = reinterpret_cast<const float*>(st) + L.lead[0];
                 const int pin = L.pitch[0];
                 if constexpr (RAD > 0) {
                   means_walk<RAD>(s_in, pin, s_mean, L.mrows, L.mpitch, L.mpitch, 3,
                                   y0 - r, x0 - r, h, w, scale, NT);
                   __syncthreads();
                   if (y0 >= r && y0 + TY + r <= h && x0 >= r && x0 + TX + r <= w)
                     k1_search<RAD, R, false>(s_in, pin, s_mean, L.mpitch, out, y0, x0, h, w);
                   else
                     k1_search<RAD, R, true>(s_in, pin, s_mean, L.mpitch, out, y0, x0, h, w);
                 } else {
                   means_gather(s_in, pin, s_mean, L.mrows, L.mpitch, y0 - r, x0 - r,
                                h, w, r, NT);
                   __syncthreads();
                   k1_search_any<R>(s_in, pin, s_mean, L.mpitch, out, y0, x0, h, w, r, fl);
                 }
               });
}

}  // namespace

// Plain C interface, loaded with ctypes. The geometry (tile, threads,
// stages, grid, shared bytes, staging path) comes from ops/nlm.py::
// launch_geometry; it is checked against make_layout. Each call
// launches on `stream` and returns 0 when launched, a CUDA error, or one
// of the ERR_* codes above.
extern "C" int tinsel_nlm_filter(const float* img, float* out, int h, int w,
                                 float falloff, int radius, int tile_w, int tile_h,
                                 int threads, int stages, int grid, int smem, int tma,
                                 void* stream) {
  if (radius < 0 || tile_w != TX || tile_h != TY || grid < 1 ||
      (threads != K1Shape<8>::NT && threads != K1Shape<4>::NT) ||
      (stages != 1 && stages != 2))
    return ERR_GEOMETRY;
  const Layout L = make_layout(false, radius, stages);
  if (L.total != smem || smem > SMEM_MAX) return ERR_GEOMETRY;
  Maps<1> maps;
  memset(&maps, 0, sizeof(maps));
  if (tma) {
    const int e = encode(&maps.m[0], img, h, w, L, 0);
    if (e) return e;
  }
  const int tiles_x = (w + TX - 1) / TX, ntiles = tiles_x * ((h + TY - 1) / TY);
  const int rad = compiled_radius(radius, falloff >= 0.f);
  typedef decltype(&nlm_filter_kernel<0, 8>) Kernel;
  static const Kernel kernels[8] = {
      nlm_filter_kernel<0, 8>, nlm_filter_kernel<1, 8>, nlm_filter_kernel<2, 8>,
      nlm_filter_kernel<3, 8>, nlm_filter_kernel<0, 4>, nlm_filter_kernel<1, 4>,
      nlm_filter_kernel<2, 4>, nlm_filter_kernel<3, 4>};
  const int idx = rad + (threads == K1Shape<4>::NT ? 4 : 0);
  const Kernel fn = kernels[idx];
  const int e = opt_in((const void*)fn);
  if (e) return e;
  fn<<<grid, threads, smem, (cudaStream_t)stream>>>(maps, img, out, h, w, falloff, radius,
                                                     stages, tma, tiles_x, ntiles);
  return (int)cudaGetLastError();
}

// ======================================================================
// K2: tinsel_nlm_guided, the joint NLM denoiser guided by the normal,
// albedo and depth AOVs.
//
// Replaces the Pallas kernel tinsel_tpu/ops/pallas/nlm.py:199
// _guided_band_kernel; computes tinsel_tpu_torch/render/nlm.py::nlm_guided.
// Bounded by f32 operations at its default r = 2 (ten squared differences
// and one exp per tap). Here 8 warps walk 4 rows each. The depth
// normalisation runs in the kernel: the wrapper passes a device pointer to
// max(depth) and staging scales depth by sqrt(f_depth * log2 e) /
// max(dmax, 1e-6), so no host sync.

namespace {

constexpr int K2_NT = 256, K2_R = 4, K2_MIN_CTAS = 2;  // 8 warps x 4 rows

struct GuideTile {
  const float *img, *mean, *nrm, *alb, *dep;
  int pi, pm, pg, pd;
};

// Search of radius RAD over pre-scaled means and guides: the exponent is
// minus one sum of ten squared differences.
template <int RAD, bool EDGE>
__device__ void k2_search(const GuideTile& g, float* __restrict__ out, int y0, int x0,
                          int h, int w) {
  constexpr int R = K2_R, J = R + 2 * RAD;
  const int lane = threadIdx.x & 31, ty0 = (threadIdx.x >> 5) * R;
  float P[R][10], acc[R][3], ws[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = ty0 + i + RAD, col = lane + RAD;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      P[i][c] = g.mean[row * g.pm + 3 * col + c];
      P[i][3 + c] = g.nrm[row * g.pg + 3 * col + c];
      P[i][6 + c] = g.alb[row * g.pg + 3 * col + c];
      acc[i][c] = 0.f;
    }
    P[i][9] = g.dep[row * g.pd + col];
    ws[i] = 0.f;
  }
  const uint32_t rows = EDGE ? row_bits(y0 + ty0 - RAD, J, h) : 0u;
#pragma unroll 1
  for (int dx = -RAD; dx <= RAD; ++dx) {
    const int col = lane + RAD + dx;
    const bool colok = !EDGE || (unsigned)(x0 + lane + dx) < (unsigned)w;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int row = ty0 + j;
      float Q[10];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        Q[c] = g.mean[row * g.pm + 3 * col + c];
        Q[3 + c] = g.nrm[row * g.pg + 3 * col + c];
        Q[6 + c] = g.alb[row * g.pg + 3 * col + c];
      }
      Q[9] = g.dep[row * g.pd + col];
      const float* iq = g.img + (row + 1) * g.pi + 3 * (col + 1);
      const float v0 = iq[0], v1 = iq[1], v2 = iq[2];
      const bool ok = !EDGE || (colok && ((rows >> j) & 1u));
#pragma unroll
      for (int dy = -RAD; dy <= RAD; ++dy) {
        const int i = j - RAD - dy;
        if (i < 0 || i >= R) continue;
        float e = P[i][0] - Q[0], f = P[i][5] - Q[5];
        float d = e * e, d2 = f * f;  // two chains of five
#pragma unroll
        for (int k = 1; k < 5; ++k) {
          e = P[i][k] - Q[k];
          f = P[i][k + 5] - Q[k + 5];
          d = fmaf(e, e, d);
          d2 = fmaf(f, f, d2);
        }
        const float wt = ex2(-(d + d2));
        acc[i][0] = fmaf(wt, v0, acc[i][0]);
        acc[i][1] = fmaf(wt, v1, acc[i][1]);
        acc[i][2] = fmaf(wt, v2, acc[i][2]);
        ws[i] += EDGE ? (ok ? wt : 0.f) : wt;
      }
    }
  }
  const int x = x0 + lane;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int y = y0 + ty0 + i;
    if (y < h && x < w) store_rgb(out, y, x, w, acc[i][0], acc[i][1], acc[i][2], ws[i]);
  }
}

// Runtime radius or a negative factor: unscaled means and guides (depth
// normalised), factors times log2 e applied per tap.
__device__ void k2_search_any(const GuideTile& g, float* __restrict__ out, int y0,
                              int x0, int h, int w, int r, float fl, float fn,
                              float fa, float fd) {
  const int lane = threadIdx.x & 31, ty0 = (threadIdx.x >> 5) * K2_R;
  const int x = x0 + lane;
  for (int i = 0; i < K2_R; ++i) {
    const int y = y0 + ty0 + i, row = ty0 + i + r, col = lane + r;
    const float* mp = g.mean + row * g.pm + 3 * col;
    const float* np = g.nrm + row * g.pg + 3 * col;
    const float* ap = g.alb + row * g.pg + 3 * col;
    const float* zp = g.dep + row * g.pd + col;
    const float* ip = g.img + (row + 1) * g.pi + 3 * (col + 1);
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, ws = 0.f;
    for (int dy = -r; dy <= r; ++dy) {
      if ((unsigned)(y + dy) >= (unsigned)h) continue;
      for (int dx = -r; dx <= r; ++dx) {
        if ((unsigned)(x + dx) >= (unsigned)w) continue;
        const int qm = dy * g.pm + 3 * dx, qg = dy * g.pg + 3 * dx;
        float d2 = 0.f, n2 = 0.f, a2s = 0.f;
        for (int c = 0; c < 3; ++c) {
          const float e = mp[c] - mp[qm + c];
          const float u = np[c] - np[qg + c];
          const float v = ap[c] - ap[qg + c];
          d2 = fmaf(e, e, d2);
          n2 = fmaf(u, u, n2);
          a2s = fmaf(v, v, a2s);
        }
        const float dz = zp[0] - zp[dy * g.pd + dx];
        const float wt = ex2(-(fl * d2 + fn * n2 + fa * a2s + fd * (dz * dz)));
        const float* iq = ip + dy * g.pi + 3 * dx;
        a0 = fmaf(wt, iq[0], a0);
        a1 = fmaf(wt, iq[1], a1);
        a2 = fmaf(wt, iq[2], a2);
        ws += wt;
      }
    }
    if (y < h && x < w) store_rgb(out, y, x, w, a0, a1, a2, ws);
  }
}

__device__ __forceinline__ void scale_in_place(float* p, int n, float s, int nt) {
  float4* q = reinterpret_cast<float4*>(p);  // n is a multiple of 4
  for (int u = threadIdx.x; u < n / 4; u += nt) {
    float4 v = q[u];
    v.x *= s;
    v.y *= s;
    v.z *= s;
    v.w *= s;
    q[u] = v;
  }
}

template <int RAD>
__global__ void __launch_bounds__(K2_NT, K2_MIN_CTAS)
    nlm_guided_kernel(const __grid_constant__ Maps<4> maps,
                      const float* __restrict__ img, const float* __restrict__ normal,
                      const float* __restrict__ albedo, const float* __restrict__ depth,
                      const float* __restrict__ dmax, float* __restrict__ out, int h,
                      int w, float falloff, int r_arg, float f_normal, float f_albedo,
                      float f_depth, int stages, int tma, int tiles_x, int ntiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = smem + ((128 - (sptr(smem) & 127)) & 127);
  const int r = RAD ? RAD : r_arg;
  const Layout L = make_layout(true, r, stages);
  Inputs<4> in;
  in.p[0] = img;
  in.p[1] = normal;
  in.p[2] = albedo;
  in.p[3] = depth;
  // max(dmax, 1e-6) as torch.clamp takes it: a NaN maximum stays NaN
  const float dm = __ldg(dmax);
  const float inv_d = 1.f / (isnan(dm) ? dm : fmaxf(dm, 1e-6f));
  const float fl = falloff * LOG2E, fn = f_normal * LOG2E, fa = f_albedo * LOG2E,
              fd = f_depth * LOG2E;
  // folded: means, normals, albedo, depth scaled; else only depth / dmax
  const float sm = sqrtf(fl), sn = sqrtf(fn), sa = sqrtf(fa),
              sd = RAD ? sqrtf(fd) * inv_d : inv_d;
  float* s_mean = reinterpret_cast<float*>(base + L.mean_off);
  tile_loop<4>(base, L, in, maps, tma != 0, stages, h, w, tiles_x, ntiles, K2_NT,
               [&](unsigned char* st, int y0, int x0) {
                 const float* s_img =
                     reinterpret_cast<const float*>(st + L.off[0]) + L.lead[0];
                 float* nrm = reinterpret_cast<float*>(st + L.off[1]) + L.lead[1];
                 float* alb = reinterpret_cast<float*>(st + L.off[2]) + L.lead[2];
                 float* dep = reinterpret_cast<float*>(st + L.off[3]) + L.lead[3];
                 if constexpr (RAD > 0) {
                   scale_in_place(nrm - L.lead[1], L.rows[1] * L.pitch[1], sn, K2_NT);
                   scale_in_place(alb - L.lead[2], L.rows[2] * L.pitch[2], sa, K2_NT);
                 }
                 scale_in_place(dep - L.lead[3], L.rows[3] * L.pitch[3], sd, K2_NT);
                 means_walk<1>(s_img, L.pitch[0], s_mean, L.mrows, L.mpitch, L.mpitch, 3,
                               y0 - r, x0 - r, h, w, RAD ? sm : 1.f, K2_NT);
                 __syncthreads();
                 GuideTile g;
                 g.img = s_img;
                 g.mean = s_mean;
                 g.nrm = nrm;
                 g.alb = alb;
                 g.dep = dep;
                 g.pi = L.pitch[0];
                 g.pm = L.mpitch;
                 g.pg = L.pitch[1];
                 g.pd = L.pitch[3];
                 if constexpr (RAD > 0) {
                   if (y0 >= r && y0 + TY + r <= h && x0 >= r && x0 + TX + r <= w)
                     k2_search<RAD, false>(g, out, y0, x0, h, w);
                   else
                     k2_search<RAD, true>(g, out, y0, x0, h, w);
                 } else {
                   k2_search_any(g, out, y0, x0, h, w, r, fl, fn, fa, fd);
                 }
               });
}

}  // namespace

// Plain C interface, loaded with ctypes; see tinsel_nlm_filter.
extern "C" int tinsel_nlm_guided(const float* img, const float* normal,
                                 const float* albedo, const float* depth,
                                 const float* dmax, float* out, int h, int w,
                                 float falloff, int radius, float f_normal,
                                 float f_albedo, float f_depth, int tile_w, int tile_h,
                                 int threads, int stages, int grid, int smem, int tma,
                                 void* stream) {
  if (radius < 0 || tile_w != TX || tile_h != TY || threads != K2_NT || grid < 1 ||
      (stages != 1 && stages != 2))
    return ERR_GEOMETRY;
  const Layout L = make_layout(true, radius, stages);
  if (L.total != smem || smem > SMEM_MAX) return ERR_GEOMETRY;
  Maps<4> maps;
  memset(&maps, 0, sizeof(maps));
  if (tma) {
    const float* ptrs[4] = {img, normal, albedo, depth};
    for (int k = 0; k < 4; ++k) {
      const int e = encode(&maps.m[k], ptrs[k], h, w, L, k);
      if (e) return e;
    }
  }
  const int tiles_x = (w + TX - 1) / TX, ntiles = tiles_x * ((h + TY - 1) / TY);
  const bool folds = falloff >= 0.f && f_normal >= 0.f && f_albedo >= 0.f && f_depth >= 0.f;
  const int rad = compiled_radius(radius, folds);
  decltype(&nlm_guided_kernel<0>) fn = rad == 1   ? nlm_guided_kernel<1>
                                       : rad == 2 ? nlm_guided_kernel<2>
                                       : rad == 3 ? nlm_guided_kernel<3>
                                                  : nlm_guided_kernel<0>;
  const int e = opt_in((const void*)fn);
  if (e) return e;
  fn<<<grid, threads, smem, (cudaStream_t)stream>>>(
      maps, img, normal, albedo, depth, dmax, out, h, w,
      falloff, radius, f_normal, f_albedo, f_depth, stages, tma, tiles_x, ntiles);
  return (int)cudaGetLastError();
}
