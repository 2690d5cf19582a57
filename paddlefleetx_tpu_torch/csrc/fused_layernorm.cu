// Fused LayerNorm (+ optional residual add) for Hopper (sm_90a): forward
// and backward, bf16 and f32 inputs, float32 statistics and affine.
//
// Replaces the TPU kernels of paddlefleetx_tpu/ops/fused_layernorm.py:
//   _fwd_kernel (:45, launched by _run_fwd :114)       -> fused_ln_fwd (K1)
//   _bwd_kernel (:61, launched by _fused_ln_bwd :162)  -> fused_ln_bwd (K2)
//
// Layout: x, res, y, g, dx are [rows, n] contiguous in the input type T;
// scale and bias float32 [n]; mean and rstd float32 [rows].
//
// What each computes (the math of the TPU kernels):
//  K1: v = x (+ res) in f32; mean = sum(v) / n; var = sum((v - mean)^2) / n
//      (two passes, not E[v^2] - mean^2); rstd = rsqrt(var + eps);
//      y = (v - mean) * rstd * scale + bias, written in T; mean and rstd
//      written for the backward.
//  K2: xhat = (v - mean) * rstd from the saved stats, gs = g * scale,
//      m1 = sum(gs) / n, m2 = sum(gs * xhat) / n,
//      dx = rstd * (gs - m1 - xhat * m2) in T (dres is dx);
//      dscale = sum over rows of g * xhat, dbias = sum over rows of g.
//
// dscale/dbias: the TPU kernel adds each row block's column sums into one
// output block because its grid runs in order (:77-85, initialised at
// program 0).  Here the blocks run in parallel, so each CTA writes the
// column sums of its own band of kBand rows to float32 partials
// [bands, n], and a second launch adds the bands in a fixed order: the
// result does not depend on the schedule (no float atomics).
//
// What bounds it on the card: bytes.  At GPT-345M (8192 rows of n = 1024
// per micro-batch, bf16) K1 reads x and writes y (33.6 MB) and K2 reads
// x and g and writes dx (50.3 MB) against a few operations per element.
//
// Design, a simple kernel that is right first:
//  * K1: one warp per row, 8 rows per CTA.  Three passes over the row
//    (sum, squared deviations, output), lane i taking columns i, i+32, ..:
//    coalesced scalar loads that take any n and any alignment; the second
//    and third passes find the row in L1/L2.  128-bit loads and rows held
//    in registers are later work.
//  * K2: one CTA per band of kBand rows.  Phase A: each warp takes rows of
//    the band and reduces m1, m2 with shuffles into shared memory.
//    Phase B: thread t takes columns t, t+256, .. and walks the band's
//    rows, writing dx and keeping its columns' dscale/dbias sums in
//    registers, then writes them to the band's partial row.
//  * K2 reduce: a 32 x 16 block per 32 columns; each of the 16 row lanes
//    adds every 16th band, then the 16 partial sums are added in order.
//
// Plain C interface (loaded with ctypes); every entry point launches on
// the given stream and returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFwdWarps = 8;       // rows per K1 CTA
constexpr int kBand = 32;          // rows per K2 CTA
constexpr int kBwdThreads = 256;
constexpr int kRedCols = 32;       // reduce block: 32 columns x 16 band lanes
constexpr int kRedLanes = 16;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// x (+ res) at flat index i, in f32
template <typename T>
__device__ __forceinline__ float load_v(const T* __restrict__ x, const T* __restrict__ res,
                                        int64_t i) {
  float v = to_f(x[i]);
  if (res != nullptr) v += to_f(res[i]);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kFwdWarps * 32)
fused_ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    T* __restrict__ y, float* __restrict__ mean_out,
                    float* __restrict__ rstd_out, int64_t rows, int n, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kFwdWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int64_t off = row * n;
  const float inv_n = 1.0f / static_cast<float>(n);

  float sum = 0.f;
  for (int c = lane; c < n; c += 32) sum += load_v(x, res, off + c);
  const float mean = warp_sum(sum) * inv_n;

  float sq = 0.f;
  for (int c = lane; c < n; c += 32) {
    const float d = load_v(x, res, off + c) - mean;
    sq += d * d;
  }
  const float rstd = rsqrtf(warp_sum(sq) * inv_n + eps);

  for (int c = lane; c < n; c += 32) {
    const float xhat = (load_v(x, res, off + c) - mean) * rstd;
    y[off + c] = from_f<T>(xhat * scale[c] + bias[c]);
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
fused_ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                    const float* __restrict__ scale, const float* __restrict__ mean,
                    const float* __restrict__ rstd, const T* __restrict__ g,
                    T* __restrict__ dx, float* __restrict__ part_scale,
                    float* __restrict__ part_bias, int64_t rows, int n) {
  __shared__ float s_mu[kBand], s_rs[kBand], s_m1[kBand], s_m2[kBand];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kBand;
  const int band = static_cast<int>(rows - r0 < kBand ? rows - r0 : kBand);
  const float inv_n = 1.0f / static_cast<float>(n);

  // phase A: the row sums m1 = mean(g * scale), m2 = mean(g * scale * xhat)
  for (int i = warp; i < band; i += kBwdThreads / 32) {
    const int64_t off = (r0 + i) * n;
    const float mu = mean[r0 + i], rs = rstd[r0 + i];
    float a = 0.f, b = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float xhat = (load_v(x, res, off + c) - mu) * rs;
      const float gs = to_f(g[off + c]) * scale[c];
      a += gs;
      b += gs * xhat;
    }
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      s_mu[i] = mu;
      s_rs[i] = rs;
      s_m1[i] = a * inv_n;
      s_m2[i] = b * inv_n;
    }
  }
  __syncthreads();

  // phase B: dx, and this band's column sums of g * xhat and g
  for (int c = threadIdx.x; c < n; c += kBwdThreads) {
    const float sc = scale[c];
    float ds = 0.f, db = 0.f;
    for (int i = 0; i < band; ++i) {
      const int64_t at = (r0 + i) * n + c;
      const float xhat = (load_v(x, res, at) - s_mu[i]) * s_rs[i];
      const float gv = to_f(g[at]);
      dx[at] = from_f<T>(s_rs[i] * (gv * sc - s_m1[i] - xhat * s_m2[i]));
      ds += gv * xhat;
      db += gv;
    }
    part_scale[static_cast<int64_t>(blockIdx.x) * n + c] = ds;
    part_bias[static_cast<int64_t>(blockIdx.x) * n + c] = db;
  }
}

__global__ void __launch_bounds__(kRedCols * kRedLanes)
fused_ln_bwd_reduce_kernel(const float* __restrict__ part_scale,
                           const float* __restrict__ part_bias, int bands, int n,
                           float* __restrict__ dscale, float* __restrict__ dbias) {
  __shared__ float s_s[kRedLanes][kRedCols], s_b[kRedLanes][kRedCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * kRedCols + tx;
  float s = 0.f, b = 0.f;
  if (c < n) {
    for (int i = ty; i < bands; i += kRedLanes) {
      s += part_scale[static_cast<int64_t>(i) * n + c];
      b += part_bias[static_cast<int64_t>(i) * n + c];
    }
  }
  s_s[ty][tx] = s;
  s_b[ty][tx] = b;
  __syncthreads();
  if (ty == 0 && c < n) {
    float ts = 0.f, tb = 0.f;
    for (int j = 0; j < kRedLanes; ++j) {
      ts += s_s[j][tx];
      tb += s_b[j][tx];
    }
    dscale[c] = ts;
    dbias[c] = tb;
  }
}

template <typename T>
cudaError_t fwd(const void* x, const void* res, const void* scale, const void* bias, void* y,
                void* mean, void* rstd, int64_t rows, int n, float eps, cudaStream_t st) {
  const int64_t grid = (rows + kFwdWarps - 1) / kFwdWarps;
  fused_ln_fwd_kernel<T><<<static_cast<unsigned>(grid), kFwdWarps * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const float*>(scale), static_cast<const float*>(bias), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), rows, n, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* x, const void* res, const void* scale, const void* mean,
                const void* rstd, const void* g, void* dx, void* part_scale, void* part_bias,
                void* dscale, void* dbias, int64_t rows, int n, cudaStream_t st) {
  const int bands = static_cast<int>((rows + kBand - 1) / kBand);
  fused_ln_bwd_kernel<T><<<bands, kBwdThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const float*>(scale),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const T*>(g), static_cast<T*>(dx), static_cast<float*>(part_scale),
      static_cast<float*>(part_bias), rows, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 block(kRedCols, kRedLanes);
  fused_ln_bwd_reduce_kernel<<<(n + kRedCols - 1) / kRedCols, block, 0, st>>>(
      static_cast<const float*>(part_scale), static_cast<const float*>(part_bias), bands, n,
      static_cast<float*>(dscale), static_cast<float*>(dbias));
  return cudaGetLastError();
}

bool bad_shape(int64_t rows, int n) {
  return rows < 1 || n < 1 ||
         (rows + kFwdWarps - 1) / kFwdWarps > 0x7fffffffLL ||
         (rows + kBand - 1) / kBand > 0x7fffffffLL;
}

}  // namespace

extern "C" {

// The number of float32 partial rows fused_ln_bwd needs ([bands, n] each
// for dscale and dbias), for the wrapper to allocate.
int64_t fused_ln_bwd_bands(int64_t rows) { return (rows + kBand - 1) / kBand; }

// y [rows, n] in the input type; mean, rstd float32 [rows].  res may be
// null (no residual).
int fused_ln_fwd(const void* x, const void* res, const void* scale, const void* bias,
                 void* y, void* mean, void* rstd, int64_t rows, int n, float eps, int dtype,
                 void* stream) {
  if (bad_shape(rows, n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(fwd<float>(x, res, scale, bias, y, mean, rstd, rows, n, eps, st));
  if (dtype == 1)
    return static_cast<int>(
        fwd<__nv_bfloat16>(x, res, scale, bias, y, mean, rstd, rows, n, eps, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// dx [rows, n] in the input type; dscale, dbias float32 [n]; part_scale,
// part_bias float32 [fused_ln_bwd_bands(rows), n] scratch.  res may be
// null.
int fused_ln_bwd(const void* x, const void* res, const void* scale, const void* mean,
                 const void* rstd, const void* g, void* dx, void* part_scale, void* part_bias,
                 void* dscale, void* dbias, int64_t rows, int n, int dtype, void* stream) {
  if (bad_shape(rows, n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(bwd<float>(x, res, scale, mean, rstd, g, dx, part_scale, part_bias,
                                       dscale, dbias, rows, n, st));
  if (dtype == 1)
    return static_cast<int>(bwd<__nv_bfloat16>(x, res, scale, mean, rstd, g, dx, part_scale,
                                               part_bias, dscale, dbias, rows, n, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fused_ln_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
