// Contiguous flash-decode attention over bfloat16 caches at head dim 64 or
// 128 on Hopper (sm_90a): the bf16 route of K7.
//
// Replaces, for bfloat16 q and caches at d in {64, 128}, the TPU kernel of
// paddlefleetx_tpu/ops/decode_attention.py:
//   _decode_kernel (:256, launched by _decode_pallas :374) -> flash_decode_sm90
// csrc/decode_attention.cu keeps float32, bfloat16 at other head dims and the
// int8 kernel (K8).
//
// What it computes (the contract of csrc/decode_attention.cu, unchanged): for
// each (batch b, head h) and query row r of q [b, n, t, d], at position
// limit - t + r, attention over the cache keys col with
//     kv_valid_from[b] <= col <= limit - t + r
// as an online softmax with float32 state; output float32 [b, n, t, d] =
// acc / max(l, 1e-30), so a row with no visible key is 0, not NaN.  The
// probabilities are rounded to bf16 before p @ v (the Pallas kernel's
// p.astype(v.dtype)).  No key at or past `limit` is ever read.
//
// What bounds it on the card: device-memory bytes.  Decode (t = 1) reads
// 2 * b * n * keys * d * 2 bytes of K/V for 4 * d operations per key and
// head; a prefill of t rows does t / 2 times that work on the same bytes
// and stays under the ridge (295 operations a byte) below t ~ 600 at d = 64.
//
// Two regimes behind the one entry, chosen by t:
//  * t <= 16 (decode, speculative verify): flash-decoding.  The grid is
//    (b * n, splits, row groups of up to 4 rows); the host picks the split
//    count from b * n and the key count (ops/decode_attention.decode_splits)
//    so that batch 1 fills the card: 16 heads at limit 1024 take 8 splits
//    of 128 keys.  At batch 8 the 128 CTAs already hold an SM each, and
//    more splits measured slower (their partials and combining step cost
//    more than the extra copies in flight bring).  A CTA takes its share
//    of the keys [kv_valid_from, its last causal column], so left-pad keys
//    and keys past `limit` are never read, and fetches them into a 4-stage
//    shared-memory ring (16 KB of K and V a stage) with cp.async.bulk,
//    completing on mbarriers; K/V stay bf16 there.  Each CTA streams its
//    keys on its own, so the ring's depth, not the split count, hides the
//    copies' latency.  A lane group of d / 8 lanes takes one key at a time
//    (16 bytes of its row per lane: a quarter-warp reads one contiguous
//    row, no bank conflicts), sums q.k with shuffles and keeps its own
//    (m, l, acc) in registers; the groups' states merge by butterflies and
//    then in warp order.  With more than one split each CTA writes its
//    float32 partial state to scratch, and the last CTA of its (b, h, row
//    group) to arrive (an integer counter, no float atomics) combines all
//    partials in split order and resets the counter for the next call: one
//    launch per call, no memset, and the same bits on every call.
//  * t > 16 (prefill): the tensor cores, on K3's skeleton
//    (csrc/flash_attention_sm90.cu).  A CTA is one warpgroup on a 64-row
//    query tile plus one TMA warp; K/V tiles (128 keys at d = 64, 64 at
//    d = 128: 32 KB a stage) arrive through a 2-stage mbarrier ring;
//    S = Q.K^T is wgmma from shared memory, and P, rounded to bf16, feeds
//    P.V as the register A operand.  The causal mask carries the row offset
//    limit - t; tiles wholly before kv_valid_from[b] or past the CTA's last
//    causal column are never loaded.  The K/V tensor maps declare `limit`
//    keys, not L, so TMA zero-fills keys at or past `limit`: a NaN there
//    cannot reach P.V through 0 x NaN.
//
// Plain C interface (loaded with ctypes); every entry point launches on the
// given stream and returns a CUDA error code (or kMapFailed) after its
// launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kMapFailed = 10001;  // cuTensorMapEncodeTiled refused a map
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSplitMaxRows = 16;  // t up to this takes the split-K kernel

// ---------------------------------------------------------------------------
// t <= 16: split-K over bulk copies
// ---------------------------------------------------------------------------

constexpr int kDecThreads = 128;
constexpr int kDecStages = 4;    // the bulk-copy ring
constexpr int kKeysPerGroup = 4;  // keys a lane group takes from each stage

template <int D>
struct DecGeom {
  static constexpr int kLanesPerKey = D / 8;          // 16 bytes of a key row per lane
  static constexpr int kGroups = 32 / kLanesPerKey;  // lane groups per warp
  static constexpr int kStreams = 4 * kGroups;       // lane groups per CTA: 16 or 8
  static constexpr int kKeys = kStreams * kKeysPerGroup;  // keys per stage: 64 or 32
  static constexpr int kTile = kKeys * D * 2;         // bytes of K (or V) per stage: 8 KB
  static constexpr int kK = 0;                        // kDecStages stages
  static constexpr int kV = kDecStages * kTile;       // kDecStages stages
  static constexpr int kBar = 2 * kDecStages * kTile;  // kDecStages mbarriers
  static constexpr int kFlag = kBar + 8 * kDecStages;
  static constexpr int kBytes = kFlag + 16 + 128;     // + slack to align the base to 128
};

__device__ __forceinline__ uint8_t* align128(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 127u) & ~127u) - a);
}

// `bytes` contiguous bytes from global into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the 8 bf16 of a 16-byte chunk as float32 (the low half is the lower index)
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float round_bf16(float p) {
  return __bfloat162float(__float2bfloat16(p));
}

// R: query rows per CTA (1 at t = 1, else 4; grid.z covers t).  Scores and
// the running max are kept in the log2 domain (scale * log2(e) folded in).
template <int D, int R>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_split_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, const int* __restrict__ valid_from,
                          float* __restrict__ out, float* __restrict__ part,
                          int* __restrict__ counters, int n, int t, int L, int limit,
                          float scale_log2e) {
  using G = DecGeom<D>;
  constexpr int ldr = D + 2;  // a partial row: acc[D], m, l
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align128(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::kBar);
  int* last = reinterpret_cast<int*>(smem + G::kFlag);
  const int bn = blockIdx.x;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int r0 = blockIdx.z * R;
  const int nrows = min(R, t - r0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = lane % G::kLanesPerKey;
  const int stream = warp * G::kGroups + lane / G::kLanesPerKey;

  // this CTA's keys: its split's share of [valid_from, the last row's position]
  const int valid = valid_from != nullptr ? max(valid_from[bn / n], 0) : 0;
  const int pos0 = limit - t + r0;  // position of the CTA's first row
  const int col_end = pos0 + nrows;  // <= limit
  const int total = max(col_end - valid, 0);
  const int chunk = (total + splits - 1) / splits;
  const int lo = valid + split * chunk;
  const int hi = min(lo + chunk, col_end);
  const int nstages = hi > lo ? (hi - lo + G::kKeys - 1) / G::kKeys : 0;
  const __nv_bfloat16* k_head = k + static_cast<size_t>(bn) * L * D;
  const __nv_bfloat16* v_head = v + static_cast<size_t>(bn) * L * D;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kDecStages; ++i) mbar_init(full + i, 1);
    fence_barrier_init();
  }
  __syncthreads();
  auto issue = [&](int s) {
    const int c0 = lo + s * G::kKeys;
    const uint32_t bytes = static_cast<uint32_t>(min(G::kKeys, hi - c0)) * D * 2;
    const int st = s % kDecStages;
    uint64_t* bar = full + st;
    mbar_expect_tx(bar, 2 * bytes);
    bulk_load(smem + G::kK + st * G::kTile, k_head + static_cast<size_t>(c0) * D, bytes, bar);
    bulk_load(smem + G::kV + st * G::kTile, v_head + static_cast<size_t>(c0) * D, bytes, bar);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < min(kDecStages, nstages); ++s) issue(s);
  }

  float qf[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < nrows) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          q + (static_cast<size_t>(bn) * t + r0 + r) * D + sub * 8);
      unpack8(u, qf[r]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[r][e] = 0.f;
    }
  }
  float m[R], l[R], acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }

  for (int s = 0; s < nstages; ++s) {
    const int st = s % kDecStages;
    mbar_wait(full + st, (s / kDecStages) & 1);
    const int c0 = lo + s * G::kKeys;
    const int cnt = min(G::kKeys, hi - c0);
    const uint8_t* kt = smem + G::kK + st * G::kTile;
    const uint8_t* vt = smem + G::kV + st * G::kTile;
    // scores of this group's keys: key j of the stage is 16 bytes per lane
    float sc[kKeysPerGroup][R];
#pragma unroll
    for (int kk = 0; kk < kKeysPerGroup; ++kk) {
      const int j = stream + G::kStreams * kk;
      float kf[8];
      unpack8(*reinterpret_cast<const uint4*>(kt + j * D * 2 + sub * 16), kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(qf[r][e], kf[e], dot);
#pragma unroll
        for (int o = 1; o < G::kLanesPerKey; o <<= 1) dot += __shfl_xor_sync(kFull, dot, o);
        const bool ok = j < cnt && r < nrows && c0 + j <= pos0 + r;
        sc[kk][r] = ok ? dot * scale_log2e : -INFINITY;
      }
    }
    // online softmax over the group's keys of this stage
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = sc[0][r];
#pragma unroll
      for (int kk = 1; kk < kKeysPerGroup; ++kk) mx = fmaxf(mx, sc[kk][r]);
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKeysPerGroup; ++kk) {
        sc[kk][r] = exp2f(sc[kk][r] - m_new);  // a masked key gives exp2(-inf) = 0
        sum += sc[kk][r];
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] *= alpha;
      m[r] = m_new;
    }
    // acc += p_bf16 . v
#pragma unroll
    for (int kk = 0; kk < kKeysPerGroup; ++kk) {
      const int j = stream + G::kStreams * kk;
      if (j < cnt) {  // a slot past cnt holds stale bytes: never multiplied
        float vf[8];
        unpack8(*reinterpret_cast<const uint4*>(vt + j * D * 2 + sub * 16), vf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float p = round_bf16(sc[kk][r]);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
        }
      }
    }
    __syncthreads();  // the stage is read: refill it
    if (threadIdx.x == 0 && s + kDecStages < nstages) issue(s + kDecStages);
  }

  // merge the warp's lane groups (xor butterflies: every lane gets the same bits)
#pragma unroll
  for (int o = G::kLanesPerKey; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float mo = __shfl_xor_sync(kFull, m[r], o);
      const float lo_ = __shfl_xor_sync(kFull, l[r], o);
      const float mm = fmaxf(m[r], mo);
      const float fa = exp2f(m[r] - mm), fb = exp2f(mo - mm);
      l[r] = l[r] * fa + lo_ * fb;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float ao = __shfl_xor_sync(kFull, acc[r][e], o);
        acc[r][e] = acc[r][e] * fa + ao * fb;
      }
      m[r] = mm;
    }
  }
  // then the four warps, in warp order, through shared memory (the ring is idle)
  float* red = reinterpret_cast<float*>(smem);  // [4 warps][R][D + 2]
  if (lane < G::kLanesPerKey) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float* row = red + (warp * R + r) * ldr;
#pragma unroll
      for (int e = 0; e < 8; ++e) row[sub * 8 + e] = acc[r][e];
      if (sub == 0) {
        row[D] = m[r];
        row[D + 1] = l[r];
      }
    }
  }
  __syncthreads();
  const int idx = bn * gridDim.z + blockIdx.z;  // (b, h, row group)
  float* mine = splits > 1 ? part + (static_cast<size_t>(idx) * splits + split) * R * ldr : nullptr;
  for (int e = threadIdx.x; e < R * D; e += kDecThreads) {
    const int r = e / D, c = e - r * D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) mm = fmaxf(mm, red[(w * R + r) * ldr + D]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float* row = red + (w * R + r) * ldr;
      const float f = exp2f(row[D] - mm);
      den += row[D + 1] * f;
      num += row[c] * f;
    }
    if (splits == 1) {
      if (r < nrows) out[(static_cast<size_t>(bn) * t + r0 + r) * D + c] = num / fmaxf(den, 1e-30f);
    } else {
      mine[r * ldr + c] = num;
      if (c == 0) {
        mine[r * ldr + D] = mm;
        mine[r * ldr + D + 1] = den;
      }
    }
  }
  if (splits == 1) return;

  // the last split of this (b, h, row group) to arrive combines them all
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *last = atomicAdd(counters + idx, 1) == splits - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  const float* all = part + static_cast<size_t>(idx) * splits * R * ldr;
  for (int e = threadIdx.x; e < R * D; e += kDecThreads) {
    const int r = e / D, c = e - r * D;
    if (r >= nrows) continue;
    float mm = kNegInf;
    for (int sp = 0; sp < splits; ++sp) mm = fmaxf(mm, __ldcg(all + (sp * R + r) * ldr + D));
    float den = 0.f, num = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const float* row = all + (sp * R + r) * ldr;
      const float f = exp2f(__ldcg(row + D) - mm);
      den += __ldcg(row + D + 1) * f;
      num += __ldcg(row + c) * f;
    }
    out[(static_cast<size_t>(bn) * t + r0 + r) * D + c] = num / fmaxf(den, 1e-30f);
  }
  if (threadIdx.x == 0) counters[idx] = 0;  // ready for the next call
}

// ---------------------------------------------------------------------------
// t > 16: prefill on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kPreConsumers = 128;               // one warpgroup: 64 query rows
constexpr int kPreThreads = kPreConsumers + 32;  // + the TMA warp
constexpr int kPreStages = 2;
constexpr int kQBox = 64 * 128;  // bytes of a [64 rows, 64 bf16] box

// Key tiles of 128 at d = 64 and of 64 at d = 128: 32 KB of K and V a
// stage either way, so two CTAs fit on an SM at d = 128 too.
template <int D>
struct PreSmem {
  static constexpr int kBoxes = D / 64;
  static constexpr int kKeys = D == 64 ? 128 : 64;  // keys per tile
  static constexpr int kKBox = kKeys * 128;         // bytes of a [kKeys, 64 bf16] box
  static constexpr int kTile = kBoxes * kKBox;      // [kKeys, D] bf16
  static constexpr int kQ = 0;                      // [64 rows, D] bf16
  static constexpr int kK = kQ + kBoxes * kQBox;
  static constexpr int kV = kK + kPreStages * kTile;
  static constexpr int kBar = kV + kPreStages * kTile;
  static constexpr int kBytes = kBar + 64 + 1024;  // + slack to align the base to 1024
};

template <int D>
__global__ void __launch_bounds__(kPreThreads)
flash_decode_prefill_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const int* __restrict__ valid_from, float* __restrict__ out, int n,
                            int bn_total, int t, int limit, float scale_log2e) {
  using S = PreSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + S::kBar);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kPreStages;
  const int ntq = (t + 63) / 64;
  const int qi = ntq - 1 - static_cast<int>(blockIdx.x) / bn_total;  // longest rows first
  const int bn = static_cast<int>(blockIdx.x) % bn_total;
  const int q0 = 64 * qi;
  const int valid = valid_from != nullptr ? max(valid_from[bn / n], 0) : 0;
  const int pos_first = limit - t + q0;  // position of the tile's first row
  const int pos_last = limit - t + min(q0 + 63, t - 1);
  const int j0 = valid / S::kKeys;  // the first key tile holding a visible key
  const int nkv = valid <= pos_last ? pos_last / S::kKeys - j0 + 1 : 0;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int i = 0; i < kPreStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kPreConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kPreConsumers) {  // the TMA warp
    if (threadIdx.x == kPreConsumers && nkv > 0) {
      mbar_expect_tx(bar_q, S::kBoxes * kQBox);
      for (int c = 0; c < S::kBoxes; ++c)
        tma_load(smem + S::kQ + c * kQBox, &tm_q, bar_q, 64 * c, q0, bn);
      for (int j = 0; j < nkv; ++j) {
        const int st = j % kPreStages;
        if (j >= kPreStages) mbar_wait(empty + st, ((j / kPreStages) - 1) & 1);
        mbar_expect_tx(full + st, 2 * S::kTile);
        const int key = S::kKeys * (j0 + j);
        for (int c = 0; c < S::kBoxes; ++c) {
          tma_load(smem + S::kK + st * S::kTile + c * S::kKBox, &tm_k, full + st, 64 * c, key,
                   bn);
          tma_load(smem + S::kV + st * S::kTile + c * S::kKBox, &tm_v, full + st, 64 * c, key,
                   bn);
        }
      }
    }
    return;
  }

  // the warpgroup: thread t holds rows r_in and r_in + 8 of the tile
  const int lane = threadIdx.x % 32;
  const int r_in = 16 * (threadIdx.x / 32) + lane / 4;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint32_t q_s = smem_u32(smem + S::kQ);
  if (nkv > 0) mbar_wait(bar_q, 0);
  for (int j = 0; j < nkv; ++j) {
    const int st = j % kPreStages;
    mbar_wait(full + st, (j / kPreStages) & 1);
    const uint32_t k_s = smem_u32(smem + S::kK + st * S::kTile);
    const uint32_t v_s = smem_u32(smem + S::kV + st * S::kTile);
    // S = Q.K^T: [64 rows, kKeys], K-major operands, d in k16 steps
    constexpr int NS = S::kKeys / 2;  // S's accumulator registers a thread
    float sc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      const uint64_t dq = sw128_desc(q_s + (kk / 4) * kQBox + col, 16, 1024);
      const uint64_t dk = sw128_desc(k_s + (kk / 4) * S::kKBox + col, 16, 1024);
      if constexpr (S::kKeys == 128)
        wgmma_ss_n128<0, 0>(sc, dq, dk, kk > 0);
      else
        wgmma_ss_n64<0, 0>(sc, dq, dk, kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);
    const int k0 = S::kKeys * (j0 + j);
    if (k0 < valid || k0 + S::kKeys - 1 > pos_first) {  // crosses valid_from or the diagonal
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int col = k0 + key_of(i, lane);
        if (col < valid || col > pos_first + r_in + 8 * ((i >> 1) & 1)) sc[i] = -INFINITY;
      }
    }
    // online softmax in the log2 domain: a row's values sit in a quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2], neg_m[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h] * scale_log2e);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      neg_m[h] = -m_new;
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int h = (i >> 1) & 1;
      sc[i] = exp2f(fmaf(sc[i], scale_log2e, neg_m[h]));  // masked: exp2(-inf) = 0
      sum[h] += sc[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(kFull, sum[h], 1);
      sum[h] += __shfl_xor_sync(kFull, sum[h], 2);
      l[h] = l[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    // o += P_bf16.V: P from registers, V [keys, d] an MN-major B whose
    // 64-column boxes are kKBox apart
    constexpr int KS = S::kKeys / 16;
    uint32_t pf[KS][4];
    to_a_frags<KS>(sc, pf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint64_t bv = sw128_desc(v_s + kk * 16 * 128, S::kKBox, 1024);
      if constexpr (D == 64)
        wgmma_rs_n64<1>(o, pf[kk], bv, 1);
      else
        wgmma_rs_n128<1>(o, pf[kk], bv, 1);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
    fence_regs(pf);
    mbar_arrive(empty + st);
  }
  // epilogue: out = o / max(l, 1e-30) in float32, rows past t dropped
  float l_safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) l_safe[h] = fmaxf(l[h], 1e-30f);
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int h = (i >> 1) & 1;
    const int row = q0 + r_in + 8 * h;
    if (row < t) {
      const int col = 8 * (i >> 2) + 2 * (lane & 3);
      *reinterpret_cast<float2*>(out + (static_cast<size_t>(bn) * t + row) * D + col) =
          make_float2(o[i] / l_safe[h], o[i + 1] / l_safe[h]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// a 3-D bf16 map over [bn, rows, d] (innermost first): `rows` rows readable
// per head (rows past it read as zeros), heads `head_rows` rows apart, with a
// [box_rows, 64] box and 128-byte swizzle
bool make_map(CUtensorMap* map, const void* ptr, int bn, int rows, int head_rows, int d,
              int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(bn)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(head_rows) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int R>
int launch_split(const void* q, const void* k, const void* v, const int* vf, float* out, float* part,
          int* counters, int bn, int n, int t, int L, int limit, int splits, float scale_log2e,
          cudaStream_t st) {
  auto kern = flash_decode_split_kernel<D, R>;
  const int smem = DecGeom<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bn, splits, (t + R - 1) / R);
  kern<<<grid, kDecThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), vf, out, part, counters, n, t, L, limit, scale_log2e);
  return cudaGetLastError();
}

template <int D>
int launch_prefill(const void* q, const void* k, const void* v, const int* vf, float* out, int bn, int n,
            int t, int L, int limit, float scale_log2e, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  constexpr int keys = PreSmem<D>::kKeys;
  if (!make_map(&tq, q, bn, t, t, D, 64) || !make_map(&tk, k, bn, limit, L, D, keys) ||
      !make_map(&tv, v, bn, limit, L, D, keys))
    return kMapFailed;
  auto kern = flash_decode_prefill_kernel<D>;
  const int smem = PreSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<bn * ((t + 63) / 64), kPreThreads, smem, st>>>(tq, tk, tv, vf, out, n, bn, t, limit,
                                                        scale_log2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bfloat16 q [b, n, t, d] and caches [b, n, L, d], d = 64 or 128; valid_from
// int32 [b] or null; out float32 [b, n, t, d].  t <= 16 takes the split-K
// kernel over `splits` CTAs per (b, h, row group), rows = 1 at t = 1, else
// 4: with splits > 1, `part` is float32 scratch of groups * splits * rows *
// (d + 2) floats and `counters` int32 scratch of groups = b * n *
// ceil(t / rows) zeros, which every call leaves zeroed.  t > 16 takes the
// tensor-core prefill (splits, part and counters unused).
int flash_decode_sm90(const void* q, const void* k, const void* v, const void* valid_from,
                      void* out, void* part, void* counters, int b, int n, int t, int L, int d,
                      int limit, int splits, float scale, void* stream) {
  const long long bn = static_cast<long long>(b) * n;
  if ((d != 64 && d != 128) || t < 1 || t > limit || limit > L || b < 1 || n < 1 ||
      bn * ((t + 63) / 64) > 0x7fffffffLL || splits < 1 || splits > 65535 ||
      (t <= kSplitMaxRows && splits > 1 && (part == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* vf = static_cast<const int*>(valid_from);
  float* o = static_cast<float*>(out);
  float* pt = static_cast<float*>(part);
  int* ct = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * kLog2e;
  const int bni = static_cast<int>(bn);
  if (t > kSplitMaxRows) {
    return d == 64 ? launch_prefill<64>(q, k, v, vf, o, bni, n, t, L, limit, sl2, st)
                   : launch_prefill<128>(q, k, v, vf, o, bni, n, t, L, limit, sl2, st);
  }
  if (t == 1) {
    return d == 64 ? launch_split<64, 1>(q, k, v, vf, o, pt, ct, bni, n, t, L, limit, splits, sl2, st)
                   : launch_split<128, 1>(q, k, v, vf, o, pt, ct, bni, n, t, L, limit, splits, sl2, st);
  }
  return d == 64 ? launch_split<64, 4>(q, k, v, vf, o, pt, ct, bni, n, t, L, limit, splits, sl2, st)
                 : launch_split<128, 4>(q, k, v, vf, o, pt, ct, bni, n, t, L, limit, splits, sl2, st);
}

const char* flash_decode_sm90_error_string(int code) {
  if (code == kMapFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
