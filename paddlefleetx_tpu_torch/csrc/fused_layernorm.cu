// Fused LayerNorm (+ optional residual add) for Hopper (sm_90a): forward
// and backward, bf16, f16 and f32 inputs, float32 statistics and affine.
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
//  Stores round to nearest (f16: __float2half_rn), so a value past the
//  type's range becomes inf, never the largest finite value: a float16
//  step under a loss scale must see its overflow to skip.
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
// Design:
//  * One route rule for both kernels, applied by the entry points alone
//    (reg_vecs; exported as fused_ln_register_vecs for the wrapper's
//    labels): the register path where n is a multiple of the 16-byte
//    vector, every row start, scale and bias (and the outputs) are 16-byte
//    aligned and n is at most 32 * kMaxVecs vectors (2048 bf16 or f16,
//    1024 float32); the strided path for any other n or alignment.
//  * K1, register path: one warp per row, 8 rows per CTA.  Each lane issues
//    all of its 16-byte loads of x (and res) at once (n = 1024 bf16: four
//    per tensor, 2 KB per warp in flight) and holds the row in float32
//    registers, so each byte of x is read from device memory once; mean,
//    then the squared deviations, come from shuffles over those registers;
//    scale and bias arrive as float4 through __ldg and y leaves in 16-byte
//    stores.  __launch_bounds__ keeps the VPL <= 4 instances within 64
//    registers, so four CTAs (32 warps, 64 KB of loads in flight) share an
//    SM.  Strided path: three passes over the row (sum, squared deviations,
//    output), lane i taking columns i, i+32, ..: coalesced scalar loads that
//    take any n and any alignment, the second and third passes finding the
//    row in L1/L2.
//  * K2: one CTA of 8 warps per band of kBand rows (256 CTAs, about two
//    per SM, at 8192 rows).  Register path: one warp per row holds x
//    (+ res) and g in registers from 16-byte loads (n = 1024 bf16: four
//    per lane and tensor), so each is read from device memory once; m1 and
//    m2 come from shuffles, dx leaves in 16-byte stores, and each lane
//    keeps its own columns' dscale/dbias sums over its warp's rows in its
//    warp's slice of shared memory (float4 slots, lane-contiguous: no bank
//    conflicts); held in registers instead, they left room for one CTA per
//    SM, two waves at 8192 rows.  The warps' sums are added in warp order
//    into the band's partial row.  Strided path: phase A, a warp per row,
//    reduces m1, m2 with shuffles; phase B, a thread per column walks the
//    band's rows for dx and the column sums (x and g read twice).
//  * K2 reduce: a 32 x 16 block per 32 columns; each of the 16 row lanes
//    adds every 16th band, then the 16 partial sums are added in order.
//    Every sum has a fixed order: the same inputs give the same bits.
//
// Plain C interface (loaded with ctypes); every entry point launches on
// the given stream and returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kFwdWarps = 8;       // rows per K1 CTA
constexpr int kBand = 32;          // rows per K2 CTA
constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kMaxVecs = 8;        // register paths: 16-byte vectors per lane and tensor
constexpr int kRedCols = 32;       // reduce block: 32 columns x 16 band lanes
constexpr int kRedLanes = 16;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
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

// K1 on the strided path: three passes over the row, lane i taking columns
// i, i + 32, ..
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

// 16-byte vectors: 8 bf16 or f16, or 4 float32
template <typename T>
struct Vec {
  static constexpr int kN = 16 / static_cast<int>(sizeof(T));
};

// a 16-byte vector of T as float32 (pairs: the low half is the lower index)
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[Vec<T>::kN]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      f[i] = __uint_as_float(w[i]);
    } else if constexpr (std::is_same<T, __half>::value) {
      const float2 p = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    } else {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// float32 values as a 16-byte vector of T, rounded to nearest
template <typename T>
__device__ __forceinline__ uint4 pack(const float (&f)[Vec<T>::kN]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      w[i] = __float_as_uint(f[i]);
    } else if constexpr (std::is_same<T, __half>::value) {
      __half2 h = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&h);
    } else {
      __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&h);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// scale[c .. c + E) as float32
template <int E>
__device__ __forceinline__ void load_scale(const float* __restrict__ scale, int c, float (&f)[E]) {
#pragma unroll
  for (int i = 0; i < E; i += 4) {
    const float4 s4 = __ldg(reinterpret_cast<const float4*>(scale + c + i));
    f[i] = s4.x;
    f[i + 1] = s4.y;
    f[i + 2] = s4.z;
    f[i + 3] = s4.w;
  }
}

// K1 on the register path (VPL 16-byte vectors per lane): one warp per row;
// every lane's loads of x (+ res) are issued before any is used, the row
// stays in float32 registers, and mean and the squared deviations come from
// shuffles over them; y leaves in 16-byte stores.  VPL <= 4 is held to 64
// registers (four CTAs per SM), VPL = 8 to 128.
template <typename T, int VPL>
__global__ void __launch_bounds__(kFwdWarps * 32, VPL <= 4 ? 4 : 2)
fused_ln_fwd_reg_kernel(const T* __restrict__ x, const T* __restrict__ res,
                        const float* __restrict__ scale, const float* __restrict__ bias,
                        T* __restrict__ y, float* __restrict__ mean_out,
                        float* __restrict__ rstd_out, int64_t rows, int n, float eps) {
  constexpr int E = Vec<T>::kN;
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kFwdWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nvec = n / E;
  const float inv_n = 1.0f / static_cast<float>(n);
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * n);
  const uint4* rr = reinterpret_cast<const uint4*>(res + row * n);
  uint4 xu[VPL], ru[VPL];
#pragma unroll
  for (int u = 0; u < VPL; ++u) {
    const int vi = lane + 32 * u;
    if (vi < nvec) {
      xu[u] = xr[vi];
      if (res != nullptr) ru[u] = rr[vi];
    }
  }
  float v[VPL][E];  // x (+ res), in float32
  float sum = 0.f;
#pragma unroll
  for (int u = 0; u < VPL; ++u) {
    if (lane + 32 * u < nvec) {
      unpack<T>(xu[u], v[u]);
      if (res != nullptr) {
        float rf[E];
        unpack<T>(ru[u], rf);
#pragma unroll
        for (int e = 0; e < E; ++e) v[u][e] += rf[e];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) sum += v[u][e];
    }
  }
  const float mean = warp_sum(sum) * inv_n;
  float sq = 0.f;
#pragma unroll
  for (int u = 0; u < VPL; ++u) {
    if (lane + 32 * u < nvec) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = v[u][e] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) * inv_n + eps);
  uint4* yr = reinterpret_cast<uint4*>(y + row * n);
#pragma unroll
  for (int u = 0; u < VPL; ++u) {
    const int vi = lane + 32 * u;
    if (vi < nvec) {
      float sc[E], bi[E], o[E];
      load_scale<E>(scale, vi * E, sc);
      load_scale<E>(bias, vi * E, bi);
#pragma unroll
      for (int e = 0; e < E; ++e) o[e] = (v[u][e] - mean) * rstd * sc[e] + bi[e];
      yr[vi] = pack<T>(o);
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// K2 over a band of kBand rows, one CTA each.  VPL > 0: the register path
// (16-byte vectors, VPL per lane and tensor; the host takes it when n is a
// multiple of the vector and every row start is 16-byte aligned).  One warp
// per row: x (+ res) and g stay in registers, so each is read once; m1 and m2
// come from shuffles; dx leaves in 16-byte stores; each lane keeps its own
// columns' dscale/dbias sums over the warp's rows in the warp's shared
// memory, and the warps' sums are added in warp order into the band's
// partial row.  VPL == 0: the strided
// path for any n and alignment (phase A: the row sums, a warp per row;
// phase B: a thread per column walks the band's rows for dx and the column
// sums).
template <typename T, int VPL>
__global__ void __launch_bounds__(kBwdThreads)
fused_ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                    const float* __restrict__ scale, const float* __restrict__ mean,
                    const float* __restrict__ rstd, const T* __restrict__ g,
                    T* __restrict__ dx, float* __restrict__ part_scale,
                    float* __restrict__ part_bias, int64_t rows, int n) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kBand;
  const int band = static_cast<int>(rows - r0 < kBand ? rows - r0 : kBand);
  const float inv_n = 1.0f / static_cast<float>(n);

  if constexpr (VPL > 0) {
    constexpr int E = Vec<T>::kN;
    constexpr int Q = VPL * E / 4;  // float4 slots of a lane's columns
    // per warp, its lanes' dscale and dbias sums: slot q of lane l at
    // [q * 32 + l], columns (l + 32 * (q / (E / 4))) * E + 4 * (q % (E / 4))
    // + 0..3, so a warp's float4 accesses are contiguous
    extern __shared__ float4 s_acc[];  // [kBwdWarps][2][Q * 32]
    float4* my_ds = s_acc + warp * 2 * Q * 32;
    float4* my_db = my_ds + Q * 32;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      my_ds[q * 32 + lane] = make_float4(0.f, 0.f, 0.f, 0.f);
      my_db[q * 32 + lane] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const int nvec = n / E;
    for (int i = warp; i < band; i += kBwdWarps) {
      const int64_t row = r0 + i;
      const uint4* xr = reinterpret_cast<const uint4*>(x + row * n);
      const uint4* rr = reinterpret_cast<const uint4*>(res + row * n);
      const uint4* gr = reinterpret_cast<const uint4*>(g + row * n);
      uint4 gv[VPL];
      float v[VPL][E];  // x (+ res), in float32
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        const int vi = lane + 32 * u;
        if (vi < nvec) {
          const uint4 xu = xr[vi];
          gv[u] = gr[vi];
          unpack<T>(xu, v[u]);
          if (res != nullptr) {
            float rf[E];
            unpack<T>(rr[vi], rf);
#pragma unroll
            for (int e = 0; e < E; ++e) v[u][e] += rf[e];
          }
        }
      }
      const float mu = mean[row], rs = rstd[row];
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        const int vi = lane + 32 * u;
        if (vi < nvec) {
          float gf[E], sc[E];
          unpack<T>(gv[u], gf);
          load_scale<E>(scale, vi * E, sc);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float xhat = (v[u][e] - mu) * rs;
            const float gs = gf[e] * sc[e];
            a += gs;
            b += gs * xhat;
          }
        }
      }
      const float m1 = warp_sum(a) * inv_n;
      const float m2 = warp_sum(b) * inv_n;
      uint4* dr = reinterpret_cast<uint4*>(dx + row * n);
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        const int vi = lane + 32 * u;
        if (vi < nvec) {
          float gf[E], sc[E], d[E], xg[E];
          unpack<T>(gv[u], gf);
          load_scale<E>(scale, vi * E, sc);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float xhat = (v[u][e] - mu) * rs;
            d[e] = rs * (gf[e] * sc[e] - m1 - xhat * m2);
            xg[e] = gf[e] * xhat;
          }
          dr[vi] = pack<T>(d);
#pragma unroll
          for (int e4 = 0; e4 < E / 4; ++e4) {
            const int at = (u * (E / 4) + e4) * 32 + lane;
            float4 sd = my_ds[at], sb = my_db[at];
            sd.x += xg[4 * e4];
            sd.y += xg[4 * e4 + 1];
            sd.z += xg[4 * e4 + 2];
            sd.w += xg[4 * e4 + 3];
            sb.x += gf[4 * e4];
            sb.y += gf[4 * e4 + 1];
            sb.z += gf[4 * e4 + 2];
            sb.w += gf[4 * e4 + 3];
            my_ds[at] = sd;
            my_db[at] = sb;
          }
        }
      }
    }
    __syncthreads();
    // the warps' sums, added in warp order, are the band's partial row
    for (int at = threadIdx.x; at < Q * 32; at += kBwdThreads) {
      const int q = at / 32, l = at % 32;
      const int c = (l + 32 * (q / (E / 4))) * E + 4 * (q % (E / 4));
      if (c < n) {
        float4 sd = s_acc[at], sb = s_acc[Q * 32 + at];
        for (int w = 1; w < kBwdWarps; ++w) {
          const float4 od = s_acc[w * 2 * Q * 32 + at], ob = s_acc[(w * 2 + 1) * Q * 32 + at];
          sd.x += od.x;
          sd.y += od.y;
          sd.z += od.z;
          sd.w += od.w;
          sb.x += ob.x;
          sb.y += ob.y;
          sb.z += ob.z;
          sb.w += ob.w;
        }
        *reinterpret_cast<float4*>(part_scale + static_cast<int64_t>(blockIdx.x) * n + c) = sd;
        *reinterpret_cast<float4*>(part_bias + static_cast<int64_t>(blockIdx.x) * n + c) = sb;
      }
    }
  } else {
    __shared__ float s_mu[kBand], s_rs[kBand], s_m1[kBand], s_m2[kBand];
    // phase A: the row sums m1 = mean(g * scale), m2 = mean(g * scale * xhat)
    for (int i = warp; i < band; i += kBwdWarps) {
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

template <typename T, int VPL>
cudaError_t fwd_rows(const void* x, const void* res, const void* scale, const void* bias,
                     void* y, void* mean, void* rstd, int64_t rows, int n, float eps,
                     cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>((rows + kFwdWarps - 1) / kFwdWarps);
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* mu = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  if constexpr (VPL > 0)
    fused_ln_fwd_reg_kernel<T, VPL><<<grid, kFwdWarps * 32, 0, st>>>(
        xt, rt, sc, bi, static_cast<T*>(y), mu, rs, rows, n, eps);
  else
    fused_ln_fwd_kernel<T><<<grid, kFwdWarps * 32, 0, st>>>(xt, rt, sc, bi, static_cast<T*>(y),
                                                            mu, rs, rows, n, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd(const void* x, const void* res, const void* scale, const void* bias, void* y,
                void* mean, void* rstd, int64_t rows, int n, float eps, int vpl,
                cudaStream_t st) {
  switch (vpl) {
    case 1: return fwd_rows<T, 1>(x, res, scale, bias, y, mean, rstd, rows, n, eps, st);
    case 2: return fwd_rows<T, 2>(x, res, scale, bias, y, mean, rstd, rows, n, eps, st);
    case 4: return fwd_rows<T, 4>(x, res, scale, bias, y, mean, rstd, rows, n, eps, st);
    case 8: return fwd_rows<T, 8>(x, res, scale, bias, y, mean, rstd, rows, n, eps, st);
    default: return fwd_rows<T, 0>(x, res, scale, bias, y, mean, rstd, rows, n, eps, st);
  }
}

// 16-byte vectors per lane and tensor on the register paths of K1 and K2 at
// n (0: the strided path): n a multiple of the vector, every address
// (`addr`, the OR of the tensors' addresses) 16-byte aligned, and n within
// 32 * kMaxVecs vectors (exported as fused_ln_register_vecs).
template <typename T>
int reg_vecs(uintptr_t addr, int n) {
  constexpr int E = Vec<T>::kN;
  if (n % E != 0 || (addr & 15) != 0 || n > 32 * kMaxVecs * E) return 0;
  int vpl = 1;
  while (32 * vpl * E < n) vpl *= 2;
  return vpl;
}

uintptr_t addr_or(std::initializer_list<const void*> ptrs) {
  uintptr_t a = 0;
  for (const void* p : ptrs) a |= reinterpret_cast<uintptr_t>(p);
  return a;
}

template <typename T, int VPL>
cudaError_t bwd_band(const void* x, const void* res, const void* scale, const void* mean,
                     const void* rstd, const void* g, void* dx, void* part_scale,
                     void* part_bias, int64_t rows, int n, int bands, cudaStream_t st) {
  // the register path's per-warp dscale/dbias sums
  const int smem = VPL > 0 ? kBwdWarps * 2 * 32 * VPL * Vec<T>::kN * 4 : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_ln_bwd_kernel<T, VPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  fused_ln_bwd_kernel<T, VPL><<<bands, kBwdThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const float*>(scale),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const T*>(g), static_cast<T*>(dx), static_cast<float*>(part_scale),
      static_cast<float*>(part_bias), rows, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* x, const void* res, const void* scale, const void* mean,
                const void* rstd, const void* g, void* dx, void* part_scale, void* part_bias,
                void* dscale, void* dbias, int64_t rows, int n, int vpl, cudaStream_t st) {
  const int bands = static_cast<int>((rows + kBand - 1) / kBand);
  cudaError_t err;
  switch (vpl) {
    case 1:
      err = bwd_band<T, 1>(x, res, scale, mean, rstd, g, dx, part_scale, part_bias, rows, n,
                           bands, st);
      break;
    case 2:
      err = bwd_band<T, 2>(x, res, scale, mean, rstd, g, dx, part_scale, part_bias, rows, n,
                           bands, st);
      break;
    case 4:
      err = bwd_band<T, 4>(x, res, scale, mean, rstd, g, dx, part_scale, part_bias, rows, n,
                           bands, st);
      break;
    case 8:
      err = bwd_band<T, 8>(x, res, scale, mean, rstd, g, dx, part_scale, part_bias, rows, n,
                           bands, st);
      break;
    default:
      err = bwd_band<T, 0>(x, res, scale, mean, rstd, g, dx, part_scale, part_bias, rows, n,
                           bands, st);
  }
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

// 16-byte vectors per lane that K1 and K2 take for rows of n elements
// (dtype 0 float32, 1 bfloat16, 2 float16) over tensors whose addresses OR to `addr`:
// the register path's VPL, or 0 for the strided path; -1 for another
// dtype.  The entry points below choose their path by this rule; the
// wrapper asks it only to label a launch.
int fused_ln_register_vecs(int dtype, int n, uintptr_t addr) {
  if (dtype == 0) return reg_vecs<float>(addr, n);
  if (dtype == 1) return reg_vecs<__nv_bfloat16>(addr, n);
  if (dtype == 2) return reg_vecs<__half>(addr, n);
  return -1;
}

// y [rows, n] in the input type; mean, rstd float32 [rows].  res may be
// null (no residual).
int fused_ln_fwd(const void* x, const void* res, const void* scale, const void* bias,
                 void* y, void* mean, void* rstd, int64_t rows, int n, float eps, int dtype,
                 void* stream) {
  if (bad_shape(rows, n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vpl = fused_ln_register_vecs(dtype, n, addr_or({x, res, scale, bias, y}));
  if (dtype == 0)
    return static_cast<int>(fwd<float>(x, res, scale, bias, y, mean, rstd, rows, n, eps, vpl, st));
  if (dtype == 1)
    return static_cast<int>(
        fwd<__nv_bfloat16>(x, res, scale, bias, y, mean, rstd, rows, n, eps, vpl, st));
  if (dtype == 2)
    return static_cast<int>(fwd<__half>(x, res, scale, bias, y, mean, rstd, rows, n, eps, vpl, st));
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
  const int vpl = fused_ln_register_vecs(dtype, n, addr_or({x, res, scale, g, dx}));
  if (dtype == 0)
    return static_cast<int>(bwd<float>(x, res, scale, mean, rstd, g, dx, part_scale, part_bias,
                                       dscale, dbias, rows, n, vpl, st));
  if (dtype == 1)
    return static_cast<int>(bwd<__nv_bfloat16>(x, res, scale, mean, rstd, g, dx, part_scale,
                                               part_bias, dscale, dbias, rows, n, vpl, st));
  if (dtype == 2)
    return static_cast<int>(bwd<__half>(x, res, scale, mean, rstd, g, dx, part_scale, part_bias,
                                        dscale, dbias, rows, n, vpl, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fused_ln_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
