// Non-local-means denoiser kernels for Hopper (sm_90a).
//
// K1 tinsel_nlm_filter replaces the Pallas kernel
//    tinsel_tpu/ops/pallas/nlm.py:44 _nlm_band_kernel
// K2 tinsel_nlm_guided replaces
//    tinsel_tpu/ops/pallas/nlm.py:199 _guided_band_kernel
// Both compute what tinsel_tpu_torch/render/nlm.py computes (nlm_filter,
// nlm_guided): a box mean of the RGB image over a clipped window divided
// by the count of in-bounds taps, then NLM weights exp(-falloff * d2 [- g2])
// over the in-bounds taps of the search window, and
// out = sum(w * img_q) / max(sum(w), 1e-12).
//
// Bound. Each kernel reads its input planes once and writes 3 output
// planes: K1 moves 24 B per pixel, K2 52 B per pixel (img, normal, albedo,
// normalized depth in; img out). K1 does ~20 f32 operations per search tap
// (one expf among them), K2 ~41. The card does ~20 f32 operations per
// byte of HBM bandwidth (67 TFLOP/s over 3.35 TB/s), so K1 at r = 1
// (9 taps, ~8 ops per byte) is bounded by bytes, and K2 at its default
// r = 2 (25 taps, ~20 ops per byte) sits at the balance point; larger
// radii tip both to operations.
//
// Design. One CTA per TX x TY output tile. The CTA stages its tile plus
// halo in shared memory once (coalesced: a tile row of the interleaved
// (H, W, 3) image is one contiguous run), computes the box means for the
// tile plus the search radius in shared memory, then each thread computes
// one output pixel from shared memory alone. So device memory sees each
// input byte about once (plus the halo) instead of the (2r+1)^2 shifted
// copies of the plain version. Every validity test uses absolute image
// coordinates, exactly like the Pallas kernel (nlm.py:69-81), so staged
// padding never enters a sum. expf (not __expf) and no fast-math, so the
// kernel matches the plain version to f32 rounding. Pipelining the staging
// (cp.async / TMA) and tuning the tile are left for later.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int NT = TX * TY;

__device__ __forceinline__ bool inside(int y, int x, int h, int w) {
  return y >= 0 && y < h && x >= 0 && x < w;
}

// Stage `nc` interleaved channels of an (h, w, nc) image over the region
// [y0, y0+rh) x [x0, x0+rw) into planar shared arrays dst[c][rh][rw];
// outside the image -> 0 (never read into a sum: all taps are masked).
__device__ __forceinline__ void stage(const float* __restrict__ src, int nc,
                                      float* dst, int y0, int x0, int rh,
                                      int rw, int h, int w, int tid) {
  const int n = rh * rw * nc;
  for (int i = tid; i < n; i += NT) {
    const int yy = i / (rw * nc);
    const int rem = i - yy * rw * nc;
    const int xx = rem / nc;
    const int c = rem - xx * nc;
    const int gy = y0 + yy, gx = x0 + xx;
    float v = 0.f;
    if (inside(gy, gx, h, w)) v = src[((size_t)gy * w + gx) * nc + c];
    dst[(c * rh + yy) * rw + xx] = v;
  }
}

// Box means (radius mr) of the 3 staged image planes `s_img` (region of
// size ih x iw starting at image row/col iy0/ix0) at every position of the
// mh x mw region starting at my0/mx0; positions outside the image get 0.
__device__ __forceinline__ void box_means(const float* s_img, int ih, int iw,
                                          int iy0, int ix0, float* s_mean,
                                          int mh, int mw, int my0, int mx0,
                                          int mr, int h, int w, int tid) {
  for (int i = tid; i < mh * mw; i += NT) {
    const int my = i / mw, mx = i - my * mw;
    const int gy = my0 + my, gx = mx0 + mx;
    float m0 = 0.f, m1 = 0.f, m2 = 0.f;
    if (inside(gy, gx, h, w)) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, cnt = 0.f;
      for (int dy = -mr; dy <= mr; ++dy) {
        for (int dx = -mr; dx <= mr; ++dx) {
          if (!inside(gy + dy, gx + dx, h, w)) continue;
          const int sy = gy + dy - iy0, sx = gx + dx - ix0;
          a0 += s_img[(0 * ih + sy) * iw + sx];
          a1 += s_img[(1 * ih + sy) * iw + sx];
          a2 += s_img[(2 * ih + sy) * iw + sx];
          cnt += 1.f;
        }
      }
      m0 = a0 / cnt;
      m1 = a1 / cnt;
      m2 = a2 / cnt;
    }
    s_mean[(0 * mh + my) * mw + mx] = m0;
    s_mean[(1 * mh + my) * mw + mx] = m1;
    s_mean[(2 * mh + my) * mw + mx] = m2;
  }
}

__global__ void __launch_bounds__(NT)
nlm_filter_kernel(const float* __restrict__ img, float* __restrict__ out,
                  int h, int w, float falloff, int r) {
  extern __shared__ float smem[];
  const int iw = TX + 4 * r, ih = TY + 4 * r;  // tile + 2r halo
  const int mw = TX + 2 * r, mh = TY + 2 * r;  // tile + r halo
  float* s_img = smem;
  float* s_mean = smem + 3 * ih * iw;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;

  stage(img, 3, s_img, y0 - 2 * r, x0 - 2 * r, ih, iw, h, w, tid);
  __syncthreads();
  box_means(s_img, ih, iw, y0 - 2 * r, x0 - 2 * r, s_mean, mh, mw, y0 - r,
            x0 - r, r, h, w, tid);
  __syncthreads();

  const int px = x0 + threadIdx.x, py = y0 + threadIdx.y;
  if (px >= w || py >= h) return;
  const int my = threadIdx.y + r, mx = threadIdx.x + r;
  const float p0 = s_mean[(0 * mh + my) * mw + mx];
  const float p1 = s_mean[(1 * mh + my) * mw + mx];
  const float p2 = s_mean[(2 * mh + my) * mw + mx];
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, wsum = 0.f;
  for (int dy = -r; dy <= r; ++dy) {
    for (int dx = -r; dx <= r; ++dx) {
      if (!inside(py + dy, px + dx, h, w)) continue;
      const int qy = my + dy, qx = mx + dx;
      const float e0 = p0 - s_mean[(0 * mh + qy) * mw + qx];
      const float e1 = p1 - s_mean[(1 * mh + qy) * mw + qx];
      const float e2 = p2 - s_mean[(2 * mh + qy) * mw + qx];
      const float d2 = e0 * e0 + e1 * e1 + e2 * e2;
      const float wgt = expf(-falloff * d2);
      const int sy = qy + r, sx = qx + r;
      acc0 += s_img[(0 * ih + sy) * iw + sx] * wgt;
      acc1 += s_img[(1 * ih + sy) * iw + sx] * wgt;
      acc2 += s_img[(2 * ih + sy) * iw + sx] * wgt;
      wsum += wgt;
    }
  }
  const float den = fmaxf(wsum, 1e-12f);
  float* o = out + ((size_t)py * w + px) * 3;
  o[0] = acc0 / den;
  o[1] = acc1 / den;
  o[2] = acc2 / den;
}

__global__ void __launch_bounds__(NT)
nlm_guided_kernel(const float* __restrict__ img,
                  const float* __restrict__ normal,
                  const float* __restrict__ albedo,
                  const float* __restrict__ dn, float* __restrict__ out,
                  int h, int w, float falloff, int r, float f_normal,
                  float f_albedo, float f_depth) {
  extern __shared__ float smem[];
  const int iw = TX + 2 * (r + 1), ih = TY + 2 * (r + 1);  // tile + r+1
  const int gw = TX + 2 * r, gh = TY + 2 * r;              // tile + r
  const int gsz = gh * gw;
  float* s_img = smem;
  float* s_mean = s_img + 3 * ih * iw;
  float* s_nrm = s_mean + 3 * gsz;
  float* s_alb = s_nrm + 3 * gsz;
  float* s_dn = s_alb + 3 * gsz;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;

  stage(img, 3, s_img, y0 - r - 1, x0 - r - 1, ih, iw, h, w, tid);
  stage(normal, 3, s_nrm, y0 - r, x0 - r, gh, gw, h, w, tid);
  stage(albedo, 3, s_alb, y0 - r, x0 - r, gh, gw, h, w, tid);
  stage(dn, 1, s_dn, y0 - r, x0 - r, gh, gw, h, w, tid);
  __syncthreads();
  // the color distance uses radius-1 means (average_filter(img, 1))
  box_means(s_img, ih, iw, y0 - r - 1, x0 - r - 1, s_mean, gh, gw, y0 - r,
            x0 - r, 1, h, w, tid);
  __syncthreads();

  const int px = x0 + threadIdx.x, py = y0 + threadIdx.y;
  if (px >= w || py >= h) return;
  const int gy = threadIdx.y + r, gx = threadIdx.x + r;
  const int pi = gy * gw + gx;
  const float p0 = s_mean[pi], p1 = s_mean[gsz + pi], p2 = s_mean[2 * gsz + pi];
  const float n0 = s_nrm[pi], n1 = s_nrm[gsz + pi], n2 = s_nrm[2 * gsz + pi];
  const float a0 = s_alb[pi], a1 = s_alb[gsz + pi], a2 = s_alb[2 * gsz + pi];
  const float z = s_dn[pi];
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, wsum = 0.f;
  for (int dy = -r; dy <= r; ++dy) {
    for (int dx = -r; dx <= r; ++dx) {
      if (!inside(py + dy, px + dx, h, w)) continue;
      const int qi = (gy + dy) * gw + gx + dx;
      const float e0 = p0 - s_mean[qi];
      const float e1 = p1 - s_mean[gsz + qi];
      const float e2 = p2 - s_mean[2 * gsz + qi];
      const float d2 = e0 * e0 + e1 * e1 + e2 * e2;
      const float u0 = n0 - s_nrm[qi];
      const float u1 = n1 - s_nrm[gsz + qi];
      const float u2 = n2 - s_nrm[2 * gsz + qi];
      const float v0 = a0 - s_alb[qi];
      const float v1 = a1 - s_alb[gsz + qi];
      const float v2 = a2 - s_alb[2 * gsz + qi];
      const float dz = z - s_dn[qi];
      const float g2 = f_normal * (u0 * u0 + u1 * u1 + u2 * u2) +
                       f_albedo * (v0 * v0 + v1 * v1 + v2 * v2) +
                       f_depth * (dz * dz);
      const float wgt = expf(-falloff * d2 - g2);
      const int sy = gy + dy + 1, sx = gx + dx + 1;
      acc0 += s_img[(0 * ih + sy) * iw + sx] * wgt;
      acc1 += s_img[(1 * ih + sy) * iw + sx] * wgt;
      acc2 += s_img[(2 * ih + sy) * iw + sx] * wgt;
      wsum += wgt;
    }
  }
  const float den = fmaxf(wsum, 1e-12f);
  float* o = out + ((size_t)py * w + px) * 3;
  o[0] = acc0 / den;
  o[1] = acc1 / den;
  o[2] = acc2 / den;
}

// Opt in to more than 48 KB of dynamic shared memory when a large radius
// needs it; a request above the card's limit fails here and is reported.
cudaError_t smem_opt_in(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// Plain C interface, loaded with ctypes. Each call launches on `stream`
// and returns cudaGetLastError() (0 = launched).
extern "C" int tinsel_nlm_filter(const float* img, float* out, int h, int w,
                                 float falloff, int radius, void* stream) {
  const size_t smem =
      sizeof(float) * (3 * (size_t)(TY + 4 * radius) * (TX + 4 * radius) +
                       3 * (size_t)(TY + 2 * radius) * (TX + 2 * radius));
  cudaError_t e = smem_opt_in((const void*)nlm_filter_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((w + TX - 1) / TX, (h + TY - 1) / TY);
  nlm_filter_kernel<<<grid, dim3(TX, TY), smem, (cudaStream_t)stream>>>(
      img, out, h, w, falloff, radius);
  return (int)cudaGetLastError();
}

extern "C" int tinsel_nlm_guided(const float* img, const float* normal,
                                 const float* albedo, const float* dn,
                                 float* out, int h, int w, float falloff,
                                 int radius, float f_normal, float f_albedo,
                                 float f_depth, void* stream) {
  const size_t smem =
      sizeof(float) *
      (3 * (size_t)(TY + 2 * radius + 2) * (TX + 2 * radius + 2) +
       10 * (size_t)(TY + 2 * radius) * (TX + 2 * radius));
  cudaError_t e = smem_opt_in((const void*)nlm_guided_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((w + TX - 1) / TX, (h + TY - 1) / TY);
  nlm_guided_kernel<<<grid, dim3(TX, TY), smem, (cudaStream_t)stream>>>(
      img, normal, albedo, dn, out, h, w, falloff, radius, f_normal, f_albedo,
      f_depth);
  return (int)cudaGetLastError();
}
