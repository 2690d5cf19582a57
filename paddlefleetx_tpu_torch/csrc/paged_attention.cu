// Paged decode / verify attention for Hopper (sm_90a), f32/bf16/f16 and int8 KV pools.
//
// Replaces the TPU kernel of paddlefleetx_tpu/ops/decode_attention.py:
//   _paged_kernel (:524, launched by _paged_pallas :646) -> paged_decode (f32/bf16/f16 pools)
//                                                        -> paged_decode_q8 (int8 pools)
//
// What it computes (the math of _paged_lax / _paged_kernel): q [b, n, t, d]
// holds a chunk of t queries per row; query r of row i sits at logical slot
// positions[i] + r and attends over the row's logical slots col with
//     col <= positions[i] + r        (per-row, per-query causal bound)
// where logical slot col lives in pool block tables[i, col / bs] at offset
// col % bs (pools [num_blocks, n, bs, d]).  Online softmax with float32
// state (m, l, acc); out float32 [b, n, t, d] = acc / max(l, 1e-30), so a
// row that sees no key is 0, not NaN.  f32/bf16/f16 pools: s = scale * (q . k)
// in f32 and the probabilities are rounded to the pool dtype before p @ v
// (the Pallas kernel's p.astype(v.dtype)).  int8 pools: float32 scale
// tiles [num_blocks, n, bs] ride with each pool block; the key scale
// multiplies the scores column-wise and the value scale the probabilities,
// so the dequantized block never exists.  Scales are indexed by POOL
// block, like the payload.
//
// What bounds it on the card: device-memory bytes.  A decode step (t = 1)
// of the GPT-345M engine at batch 8 reads each row's visible K/V once:
// 2 * n * keys * d * 2 bytes in bf16 (n = 16, d = 64: 4 KiB per key, so
// 14.5 MB for 3544 keys, 4.3 us at 3.35 TB/s) against 4 * d * n * keys
// flops (0.015 us at the bf16 tensor-core peak).
//
// Design, against that bound, and where it differs from the TPU kernel:
//  * Per-row loop bound instead of the clamp trick.  The TPU grid walks
//    all M table entries of every row and re-addresses the row's last
//    needed block past its end (kv_index, :611-617), so no new DMA is
//    issued.  Here a CTA loops over its own row's logical keys
//    [0, positions[i] + t) only, i.e. blocks 0 .. (pos + t - 1) / bs, and
//    never reads a table entry or a pool block past that: null padding
//    and blocks of other rows stay unread.
//  * Small blocks.  bs is 16 by default (any multiple of 8 up to 128),
//    smaller than the 32-key tile a warp scores at once (one key per
//    lane).  A tile is cut by logical key, not by block: lane j looks up
//    the pool block of key c0 + j once, and the warp's 16-byte loads each
//    read within one key row of one pool block, so no load crosses a
//    block boundary (the next block is elsewhere in the pool).
//  * One CTA = one (row, head) and up to 16 queries, so the verify chunk
//    (t = draft_k + 1 <= 16) runs in one CTA like the decode step.  Its 4
//    warps take every 4th key tile, keep per-query (m, l, acc) in
//    registers, and merge their partial softmax states at the end.
//    Nothing carries between CTAs.
//  * A simple first kernel: CUDA-core FMAs in f32, no tensor cores, no
//    TMA, the same structure as flash_decode (csrc/decode_attention.cu).
//
// Plain C interface (loaded with ctypes); every entry point returns
// cudaGetLastError() after its launch and launches on the given stream.
// tables and positions are int32 device arrays.  Table entries a row
// reads must lie in [0, num_blocks): the kernel trusts them, as the plain
// version's gather does (the engine checks its host tables before each
// upload).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kQT = 16;   // queries per CTA
constexpr int kBK = 32;   // keys per tile: one per lane
constexpr int kMaxD = 128;
constexpr int kMaxBlock = 128;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

// p rounded to the pool dtype before the p @ v product
__device__ __forceinline__ float round_to(float p, const float*) { return p; }
__device__ __forceinline__ float round_to(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
}
__device__ __forceinline__ float round_to(float p, const __half*) {
  return __half2float(__float2half_rn(p));
}
__device__ __forceinline__ float round_to(float p, const int8_t*) { return p; }

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

// Copy logical keys [c0, c0 + kBK) of one row and head into the warp's f32
// tiles, zero from col_end on.  Lane j resolves key c0 + j to its flat pool
// slot ((block * n + head) * bs + offset), and every load reads within one
// key row.  vec: 16-byte loads (d * sizeof(TKV) % 16 == 0 and aligned
// pools), kChunk in flight per lane; else element-wise.
template <typename TKV, bool QUANT>
__device__ __forceinline__ void stage_tile(const TKV* k_pool, const TKV* v_pool,
                                           const float* k_scale, const float* v_scale,
                                           const int* table_row, int n, int h, int bs,
                                           int d, int c0, int col_end,
                                           bool vec, float* k_tile, float* v_tile,
                                           float* ks_tile, float* vs_tile, int lane) {
  const int col = c0 + lane;
  long long slot = -1;  // -1: masked (past col_end)
  if (col < col_end) {
    const int j = col / bs;
    slot = (static_cast<long long>(table_row[j]) * n + h) * bs + (col - j * bs);
  }
  if (QUANT) {
    ks_tile[lane] = slot >= 0 ? k_scale[slot] : 0.f;
    vs_tile[lane] = slot >= 0 ? v_scale[slot] : 0.f;
  }
  const int ldk = d + 1;
  if (vec) {
    constexpr int kPer = 16 / sizeof(TKV);  // elements per 16-byte load
    constexpr int kChunk = 4;
    const int cpr = d / kPer;   // 16-byte chunks per key row
    const int nvec = kBK * cpr;  // a multiple of 32: loop bounds are warp-uniform
    for (int i0 = lane; i0 < nvec; i0 += 32 * kChunk) {
      uint4 kr[kChunk], vr[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int i = i0 + 32 * u;
        const long long s = __shfl_sync(kFull, slot, min(i / cpr, kBK - 1));
        if (i < nvec) {
          const long long e = s * d + static_cast<long long>(i - (i / cpr) * cpr) * kPer;
          if (s >= 0) {
            kr[u] = *reinterpret_cast<const uint4*>(k_pool + e);
            vr[u] = *reinterpret_cast<const uint4*>(v_pool + e);
          } else {
            kr[u] = make_uint4(0u, 0u, 0u, 0u);
            vr[u] = make_uint4(0u, 0u, 0u, 0u);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int i = i0 + 32 * u;
        if (i < nvec) {
          const int j = i / cpr;
          const int c = (i - j * cpr) * kPer;
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
      const long long s = __shfl_sync(kFull, slot, j);
      for (int c = lane; c < d; c += 32) {
        k_tile[j * ldk + c] = s >= 0 ? to_f(k_pool[s * d + c]) : 0.f;
        v_tile[j * d + c] = s >= 0 ? to_f(v_pool[s * d + c]) : 0.f;
      }
    }
  }
}

size_t smem_bytes(int d) {
  // query tile + per warp: K tile (row stride d+1), V tile, two scale rows;
  // the final merge reuses the per-warp region ([kWarps][kQT][d+2] fits)
  return sizeof(float) * (static_cast<size_t>(kQT) * d +
                          static_cast<size_t>(kWarps) * kBK * (2 * d + 3));
}

// DPL: head dims per lane in the p @ v accumulator (d <= 32 * DPL)
template <typename TQ, typename TKV, bool QUANT, int DPL>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                    const TKV* __restrict__ v_pool, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ tables,
                    const int* __restrict__ positions, float* __restrict__ out, int n,
                    int t, int M, int bs, int d, float scale, bool vec) {
  extern __shared__ float smem[];
  const int bn = blockIdx.y;  // row * n + head
  const int bi = bn / n;
  const int h = bn - bi * n;
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

  // query r0 + r sits at slot q_first + r.  Keys at or past col_end are
  // masked for every query of this CTA, and a slot past the table's M
  // blocks has no entry to read: the loop stops at the row's own last
  // needed block, (pos + t - 1) / bs at most.
  const int q_first = positions[bi] + r0;
  const int col_end = min(q_first + nrows, M * bs);
  const int ntiles = col_end > 0 ? (col_end + kBK - 1) / kBK : 0;
  const int* table_row = tables + static_cast<size_t>(bi) * M;

  float m[kQT], l[kQT], acc[kQT][DPL];
#pragma unroll
  for (int r = 0; r < kQT; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int tile = warp; tile < ntiles; tile += kWarps) {
    const int c0 = tile * kBK;
    stage_tile<TKV, QUANT>(k_pool, v_pool, k_scale, v_scale, table_row, n, h, bs, d, c0,
                           col_end, vec, k_tile, v_tile, ks_tile, vs_tile, lane);
    __syncwarp();
    const int col = c0 + lane;  // this lane's key

#pragma unroll
    for (int r = 0; r < kQT; ++r) {
      if (r < nrows) {  // uniform across the warp
        const float* qr = qs + r * d;
        const float* kr = k_tile + lane * ldk;
        float s = 0.f;
        for (int c = 0; c < d; ++c) s = fmaf(qr[c], kr[c], s);
        s = scale * s;
        if (QUANT) s *= ks_tile[lane];
        const bool ok = col <= q_first + r && col < col_end;
        s = ok ? s : kNegInf;
        const float m_new = fmaxf(m[r], warp_max(s));
        const float p = ok ? expf(s - m_new) : 0.f;
        const float alpha = expf(m[r] - m_new);
        l[r] = l[r] * alpha + warp_sum(p);
        const float pv = QUANT ? p * vs_tile[lane] : round_to(p, k_pool);
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
                       const float* vs, const int* tables, const int* positions, float* out,
                       int b, int n, int t, int M, int bs, int d, float scale, bool vec,
                       cudaStream_t stream) {
  auto kern = paged_decode_kernel<TQ, TKV, QUANT, DPL>;
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kQT - 1) / kQT, b * n);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v), ks,
      vs, tables, positions, out, n, t, M, bs, d, scale, vec);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* tables, const void* positions, void* out, int b, int n, int t,
           int M, int bs, int d, int num_blocks, float scale, void* stream) {
  if (d < 1 || d > kMaxD || t < 1 || b < 1 || n < 1 || b * n > 65535 || M < 1 ||
      bs < 8 || bs > kMaxBlock || bs % 8 != 0 || num_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = (d * sizeof(TKV)) % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  const int* tab = static_cast<const int*>(tables);
  const int* pos = static_cast<const int*>(positions);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      d <= 64 ? launch_dpl<TQ, TKV, QUANT, 2>(q, k, v, ksf, vsf, tab, pos, o, b, n, t, M, bs,
                                              d, scale, vec, s)
              : launch_dpl<TQ, TKV, QUANT, 4>(q, k, v, ksf, vsf, tab, pos, o, b, n, t, M, bs,
                                              d, scale, vec, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q and both pools share it).
// q [b, n, t, d]; pools [num_blocks, n, bs, d]; tables int32 [b, M];
// positions int32 [b]; out float32 [b, n, t, d].
int paged_decode(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                 const void* positions, void* out, int b, int n, int t, int M, int bs, int d,
                 int num_blocks, float scale, int dtype, void* stream) {
  if (dtype == 0) {
    return launch<float, float, false>(q, k_pool, v_pool, nullptr, nullptr, tables,
                                       positions, out, b, n, t, M, bs, d, num_blocks, scale,
                                       stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, __nv_bfloat16, false>(q, k_pool, v_pool, nullptr, nullptr,
                                                       tables, positions, out, b, n, t, M,
                                                       bs, d, num_blocks, scale, stream);
  }
  if (dtype == 2) {
    return launch<__half, __half, false>(q, k_pool, v_pool, nullptr, nullptr, tables, positions,
                                         out, b, n, t, M, bs, d, num_blocks, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// int8 pools with float32 per-(slot, head) scale tiles [num_blocks, n, bs];
// q_dtype: 0 = float32, 1 = bfloat16, 2 = float16.
int paged_decode_q8(const void* q, const void* k_pool, const void* v_pool,
                    const void* k_scale, const void* v_scale, const void* tables,
                    const void* positions, void* out, int b, int n, int t, int M, int bs,
                    int d, int num_blocks, float scale, int q_dtype, void* stream) {
  if (q_dtype == 0) {
    return launch<float, int8_t, true>(q, k_pool, v_pool, k_scale, v_scale, tables,
                                       positions, out, b, n, t, M, bs, d, num_blocks, scale,
                                       stream);
  }
  if (q_dtype == 1) {
    return launch<__nv_bfloat16, int8_t, true>(q, k_pool, v_pool, k_scale, v_scale, tables,
                                               positions, out, b, n, t, M, bs, d, num_blocks,
                                               scale, stream);
  }
  if (q_dtype == 2) {
    return launch<__half, int8_t, true>(q, k_pool, v_pool, k_scale, v_scale, tables, positions,
                                        out, b, n, t, M, bs, d, num_blocks, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
