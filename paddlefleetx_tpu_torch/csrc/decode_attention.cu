// Contiguous flash-decode attention for Hopper (sm_90a), f32/bf16/f16 and int8 KV.
//
// Replaces the TPU kernels of paddlefleetx_tpu/ops/decode_attention.py:
//   _decode_kernel    (:256, launched by _decode_pallas :374)  -> flash_decode
//   _decode_kernel_q8 (:295, launched by _decode_pallas :358)  -> flash_decode_q8
//
// What it computes (the math of _decode_lax, not its blocking): for each
// (batch b, head h) and query row r of q [b, n, t, d], whose global
// position is  limit - t + r,  attention over the cache keys col with
//     col <= limit - t + r      (causal)
//     col >= kv_valid_from[b]   (left-padded serving buckets)
// as an online softmax with float32 state (running max m, denominator l,
// accumulator acc), output float32 [b, n, t, d] = acc / max(l, 1e-30): a
// row with no visible key (a left-pad row during prefill) is 0, not NaN.
// f32/bf16/f16 caches: s = scale * (q . k) accumulated in f32, and the
// probabilities are rounded to the cache dtype before p @ v (the Pallas
// kernel's p.astype(v.dtype)).  int8 caches: s = scale * (q . k) * k_scale[col]
// and p * v_scale[col] multiplies the values, so no dequantized cache is
// ever written; q arrives in the model dtype and is used as f32.
//
// What bounds it on the card: device-memory bytes.  Decode (t = 1) at
// batch 8 reads 2 * b * n * limit * d * 2 bytes of bf16 K/V per layer
// (33.5 MB at n=16, d=64, limit=1024: 10 us at 3.35 TB/s) against
// 4 * b * n * limit * d flops (0.03 us of the bf16 tensor-core peak).
// Prefill (t = P) does t times the flops on the same bytes and is still
// far below the ridge for P <= 1024.
//
// Design, against that bound:
//  * The TPU kernel streamed the whole [max_len, d] cache row into VMEM
//    per program (decode_attention.py:22-31).  Here a CTA loads only the
//    key tiles that can be visible to its rows: from kv_valid_from[b]
//    (tiles wholly inside the left pad are skipped) up to its own last
//    causal column.  Keys past limit are never read.
//  * One CTA = one (b, head) and a tile of up to 16 query rows, so
//    prefill (t up to 1024) spreads over t/16 CTAs per head instead of
//    one program holding all t rows.  Each of the 4 warps takes every 4th
//    key tile (32 keys, one per lane) into its own shared-memory slice,
//    keeps per-row (m, l, acc) in registers, and the warps' partial
//    softmax states are merged once at the end.  At t = 1 this splits the
//    cache row four ways inside the CTA.
//  * A simple first kernel: each full key tile is read with 16-byte
//    loads (several in flight per lane) and converted to f32 in shared
//    memory; the math is CUDA-core FMAs, no tensor cores, no TMA.
//    Split-K across CTAs for small batches and tensor-core tiles for
//    prefill are the next steps.
//
// Plain C interface (loaded with ctypes); every entry point returns
// cudaGetLastError() after its launch and launches on the given stream.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kQT = 16;   // query rows per CTA
constexpr int kBK = 32;   // keys per tile: one per lane
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

// p rounded to the cache dtype before the p @ v product
__device__ __forceinline__ float round_to(float p, const float*) { return p; }
__device__ __forceinline__ float round_to(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
}
__device__ __forceinline__ float round_to(float p, const __half*) {
  return __half2float(__float2half_rn(p));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Copy keys [c0, c0 + kBK) of one head's K and V into the warp's tiles as
// f32, zero past col_end.  A full tile is one contiguous [kBK, d] chunk:
// read it with 16-byte loads, kChunk per lane in flight at once; a ragged
// or unaligned tile takes the element-wise path.
template <typename TKV>
__device__ __forceinline__ void stage_tile(const TKV* k_head, const TKV* v_head, int c0,
                                           int col_end, int d, float* k_tile,
                                           float* v_tile, int lane) {
  constexpr int kPer = 16 / sizeof(TKV);  // elements per 16-byte load
  constexpr int kChunk = 4;
  const int ldk = d + 1;
  const TKV* kb = k_head + static_cast<size_t>(c0) * d;
  const TKV* vb = v_head + static_cast<size_t>(c0) * d;
  const bool aligned = ((reinterpret_cast<uintptr_t>(kb) | reinterpret_cast<uintptr_t>(vb)) & 15) == 0;
  if (c0 + kBK <= col_end && d % kPer == 0 && aligned) {
    const int nvec = kBK * d / kPer;
    const uint4* kv = reinterpret_cast<const uint4*>(kb);
    const uint4* vv = reinterpret_cast<const uint4*>(vb);
    for (int i0 = lane; i0 < nvec; i0 += 32 * kChunk) {
      uint4 kr[kChunk], vr[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int i = i0 + 32 * u;
        if (i < nvec) {
          kr[u] = kv[i];
          vr[u] = vv[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int i = i0 + 32 * u;
        if (i < nvec) {
          const int e = i * kPer;  // a 16-byte chunk never crosses a key row
          const int j = e / d;
          const int c = e - j * d;
          const TKV* ke = reinterpret_cast<const TKV*>(&kr[u]);
          const TKV* ve = reinterpret_cast<const TKV*>(&vr[u]);
#pragma unroll
          for (int x = 0; x < kPer; ++x) {
            k_tile[j * ldk + c + x] = to_f(ke[x]);
            v_tile[j * d + c + x] = to_f(ve[x]);
          }
        }
      }
    }
  } else {
    for (int j = 0; j < kBK; ++j) {
      const bool in = c0 + j < col_end;
      for (int c = lane; c < d; c += 32) {
        const size_t off = static_cast<size_t>(j) * d + c;
        k_tile[j * ldk + c] = in ? to_f(kb[off]) : 0.f;
        v_tile[j * d + c] = in ? to_f(vb[off]) : 0.f;
      }
    }
  }
}

size_t smem_bytes(int d) {
  // query tile + per warp: K tile (row stride d+1, no bank conflicts on
  // the per-lane dot products), V tile, and the two per-key scale rows
  return sizeof(float) * (static_cast<size_t>(kQT) * d +
                          static_cast<size_t>(kWarps) * kBK * (2 * d + 3));
}

// DPL: head dims per lane in the p @ v accumulator (d <= 32 * DPL)
template <typename TQ, typename TKV, bool QUANT, int DPL>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ valid_from, float* __restrict__ out,
                    int n, int t, int L, int d, int limit, float scale) {
  extern __shared__ float smem[];
  const int bn = blockIdx.y;  // batch * n + head
  const int bi = bn / n;
  const int r0 = blockIdx.x * kQT;
  const int nrows = min(kQT, t - r0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ldk = d + 1;

  float* qs = smem;  // [kQT][d]
  float* kv_region = qs + kQT * d;
  float* k_tile = kv_region + warp * kBK * (2 * d + 3);  // [kBK][d+1]
  float* v_tile = k_tile + kBK * ldk;                     // [kBK][d]
  float* ks_tile = v_tile + kBK * d;                      // [kBK]
  float* vs_tile = ks_tile + kBK;                         // [kBK]

  const TQ* q_rows = q + (static_cast<size_t>(bn) * t + r0) * d;
  for (int e = threadIdx.x; e < nrows * d; e += kThreads) qs[e] = to_f(q_rows[e]);
  __syncthreads();

  const int q_first = limit - t + r0;  // global position of row 0
  const int col_end = min(q_first + nrows, L);  // keys >= col_end are masked for every row
  const int valid = valid_from != nullptr ? max(valid_from[bi], 0) : 0;
  const int tile_begin = valid / kBK;
  const int tile_end = (col_end + kBK - 1) / kBK;

  float m[kQT], l[kQT], acc[kQT][DPL];
#pragma unroll
  for (int r = 0; r < kQT; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  const TKV* k_head = k + static_cast<size_t>(bn) * L * d;
  const TKV* v_head = v + static_cast<size_t>(bn) * L * d;
  for (int tile = tile_begin + warp; tile < tile_end; tile += kWarps) {
    const int c0 = tile * kBK;
    stage_tile(k_head, v_head, c0, col_end, d, k_tile, v_tile, lane);
    const int col = c0 + lane;  // this lane's key
    if (QUANT) {
      const bool in = col < col_end;
      const size_t off = static_cast<size_t>(bn) * L + col;
      ks_tile[lane] = in ? k_scale[off] : 0.f;
      vs_tile[lane] = in ? v_scale[off] : 0.f;
    }
    __syncwarp();

#pragma unroll
    for (int r = 0; r < kQT; ++r) {
      if (r < nrows) {  // uniform across the warp
        const float* qr = qs + r * d;
        const float* kr = k_tile + lane * ldk;
        float s = 0.f;
        for (int c = 0; c < d; ++c) s = fmaf(qr[c], kr[c], s);
        s = scale * s;
        if (QUANT) s *= ks_tile[lane];
        const bool ok = col <= q_first + r && col >= valid && col < L;
        s = ok ? s : kNegInf;
        const float m_new = fmaxf(m[r], warp_max(s));
        const float p = ok ? expf(s - m_new) : 0.f;
        const float alpha = expf(m[r] - m_new);
        l[r] = l[r] * alpha + warp_sum(p);
        float pv;
        if constexpr (QUANT) {
          pv = p * vs_tile[lane];
        } else {
          pv = round_to(p, k);
        }
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
#pragma unroll 8
        for (int j = 0; j < kBK; ++j) {
          const float pj = __shfl_sync(kFull, pv, j);
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int c = lane + 32 * i;
            if (c < d) acc[r][i] = fmaf(pj, v_tile[j * d + c], acc[r][i]);
          }
        }
        m[r] = m_new;
      }
    }
    __syncwarp();
  }

  // merge the four warps' partial softmax states (reusing the kv region)
  __syncthreads();
  const int ldr = d + 2;
  float* red = kv_region;  // [kWarps][kQT][d + 2]
#pragma unroll
  for (int r = 0; r < kQT; ++r) {
    if (r < nrows) {
      float* row = red + (warp * kQT + r) * ldr;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int c = lane + 32 * i;
        if (c < d) row[c] = acc[r][i];
      }
      if (lane == 0) {
        row[d] = m[r];
        row[d + 1] = l[r];
      }
    }
  }
  __syncthreads();
  float* o_rows = out + (static_cast<size_t>(bn) * t + r0) * d;
  for (int e = threadIdx.x; e < nrows * d; e += kThreads) {
    const int r = e / d;
    const int c = e - r * d;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red[(w * kQT + r) * ldr + d]);
    float den = 0.f, num = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* row = red + (w * kQT + r) * ldr;
      const float f = expf(row[d] - mx);
      den += row[d + 1] * f;
      num += row[c] * f;
    }
    o_rows[e] = num / fmaxf(den, 1e-30f);
  }
}

template <typename TQ, typename TKV, bool QUANT, int DPL>
cudaError_t launch_dpl(const void* q, const void* k, const void* v, const float* ks,
                       const float* vs, const int* vf, float* out, int b, int n, int t,
                       int L, int d, int limit, float scale, cudaStream_t stream) {
  auto kern = flash_decode_kernel<TQ, TKV, QUANT, DPL>;
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kQT - 1) / kQT, b * n);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      ks, vs, vf, out, n, t, L, d, limit, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* vf, void* out, int b, int n, int t, int L, int d, int limit,
           float scale, void* stream) {
  if (d < 1 || d > kMaxD || t < 1 || t > limit || limit > L || b < 1 || n < 1 ||
      b * n > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  const int* vfi = static_cast<const int*>(vf);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      d <= 64 ? launch_dpl<TQ, TKV, QUANT, 2>(q, k, v, ksf, vsf, vfi, o, b, n, t, L, d,
                                              limit, scale, s)
              : launch_dpl<TQ, TKV, QUANT, 4>(q, k, v, ksf, vsf, vfi, o, b, n, t, L, d,
                                              limit, scale, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q and both caches share it).
// valid_from may be null (no left padding).  out: float32 [b, n, t, d].
int flash_decode(const void* q, const void* k, const void* v, const void* valid_from,
                 void* out, int b, int n, int t, int L, int d, int limit, float scale,
                 int dtype, void* stream) {
  if (dtype == 0) {
    return launch<float, float, false>(q, k, v, nullptr, nullptr, valid_from, out, b, n,
                                       t, L, d, limit, scale, stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, __nv_bfloat16, false>(q, k, v, nullptr, nullptr,
                                                       valid_from, out, b, n, t, L, d,
                                                       limit, scale, stream);
  }
  if (dtype == 2) {
    return launch<__half, __half, false>(q, k, v, nullptr, nullptr, valid_from, out, b, n, t,
                                         L, d, limit, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// int8 caches with float32 per-(slot, head) scales [b, n, L];
// q_dtype: 0 = float32, 1 = bfloat16, 2 = float16.
int flash_decode_q8(const void* q, const void* k, const void* v, const void* k_scale,
                    const void* v_scale, const void* valid_from, void* out, int b, int n,
                    int t, int L, int d, int limit, float scale, int q_dtype,
                    void* stream) {
  if (q_dtype == 0) {
    return launch<float, int8_t, true>(q, k, v, k_scale, v_scale, valid_from, out, b, n,
                                       t, L, d, limit, scale, stream);
  }
  if (q_dtype == 1) {
    return launch<__nv_bfloat16, int8_t, true>(q, k, v, k_scale, v_scale, valid_from,
                                               out, b, n, t, L, d, limit, scale, stream);
  }
  if (q_dtype == 2) {
    return launch<__half, int8_t, true>(q, k, v, k_scale, v_scale, valid_from, out, b, n, t,
                                        L, d, limit, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
