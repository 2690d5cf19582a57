// Contiguous flash-decode attention at head dim 64 or 128 on Hopper
// (sm_90a), for bfloat16 or float16 q over caches of q's type (the sm90
// route of K7) or over int8 caches with per-key scales (the sm90 route of
// K8).  One template per element type E (the entries' `dtype` argument: 1
// bfloat16, 2 float16); the two types share every tile, swizzle and copy.
//
// Replaces, for bfloat16 and float16 q at d in {64, 128}, the TPU kernels of
// paddlefleetx_tpu/ops/decode_attention.py:
//   _decode_kernel    (:256, launched by _decode_pallas :374) -> flash_decode_sm90
//   _decode_kernel_q8 (:295, launched by _decode_pallas :358) -> flash_decode_q8_sm90
// csrc/decode_attention.cu keeps float32 q and other head dims.
//
// What it computes (the contract of csrc/decode_attention.cu, unchanged): for
// each (batch b, head h) and query row r of q [b, n, t, d], at position
// limit - t + r, attention over the cache keys col with
//     kv_valid_from[b] <= col <= limit - t + r
// as an online softmax with float32 state; output float32 [b, n, t, d] =
// acc / max(l, 1e-30), so a row with no visible key is 0, not NaN.  bf16 /
// f16 caches: the probabilities are rounded to the cache's type before p @ v
// (the Pallas kernel's p.astype(v.dtype)).  int8 caches: s = scale * (q . k) *
// k_scale[col] with k taken as float32, and acc += (p * v_scale[col]) @ v
// with p * v_scale kept in float32 (the TPU's q8 kernel rounds nothing).  No
// key, and no scale, at or past `limit` is ever read.
//
// What bounds it on the card: device-memory bytes.  Decode (t = 1) reads
// 2 * b * n * keys * d bytes of K/V per cache byte (2 for bf16, 1 for int8,
// plus 8 bytes of scales a key) for 4 * d operations per key and head; a
// prefill of t rows does t / 2 times that work on the same bytes and stays
// under the ridge (295 operations a byte) below t ~ 600 at d = 64.
//
// Two regimes behind each entry, chosen by t:
//  * t <= 16 (decode, speculative verify): flash-decoding.  The grid is
//    (b * n, splits, row groups of up to 4 rows); the host picks the split
//    count from b * n and the key count (ops/decode_attention.decode_splits)
//    so that batch 1 fills the card: 16 heads at limit 1024 take 8 splits
//    of 128 keys.  At batch 8 the 128 CTAs already hold an SM each, and
//    more splits measured slower (their partials and combining step cost
//    more than the extra copies in flight bring).  A CTA takes its share
//    of the keys [kv_valid_from, its last causal column], so left-pad keys
//    and keys past `limit` are never read, and fetches them into a 4-stage
//    shared-memory ring (8 KB of K and of V a stage) with cp.async.bulk,
//    completing on mbarriers; the cache stays in its own type there.  Each
//    CTA streams its keys on its own, so the ring's depth, not the split
//    count, hides the copies' latency.  A lane group takes one key at a time,
//    16 bytes of its row per lane (bf16 / f16: d / 8 lanes, 8 values; int8:
//    d / 16 lanes, 16 values widened to float32 by a byte permute into 2^23's
//    mantissa, which is exact), sums q.k with shuffles and keeps its own
//    (m, l, acc) in registers; the groups' states merge by butterflies and
//    then in warp order.  int8: a stage's k_scale / v_scale slices travel in
//    the same ring: every thread copies a key's 4-byte scale with cp.async
//    (zeros, nothing read, past the CTA's last key), and the stage's
//    mbarrier counts each thread's copies as one arrival beside the bulk
//    copies' bytes, so no slice needs 16-byte alignment or can run past the
//    end of the [b, n, L] scales.  With more than one split each CTA writes
//    its float32 partial state to scratch, and the last CTA of its (b, h,
//    row group) to arrive (an integer counter, no float atomics) combines
//    all partials in split order and resets the counter for the next call:
//    one launch per call, no memset, and the same bits on every call.
//  * t > 16 (prefill): the tensor cores, on K3's skeleton
//    (csrc/flash_attention_sm90.cu).  bf16 / f16: a CTA is one warpgroup on a
//    64-row query tile plus one TMA warp; K/V tiles (128 keys at d = 64, 64
//    at d = 128: 32 KB a stage) arrive through a 2-stage mbarrier ring;
//    S = Q.K^T is wgmma from shared memory, and P, rounded to the type, feeds
//    P.V as the register A operand.  The K/V tensor maps declare `limit`
//    keys, not L, so TMA zero-fills keys at or past `limit`: a NaN there
//    cannot reach P.V through 0 x NaN.  int8: one warpgroup that issues its
//    own copies: int8 K/V rows (bulk copies that end at `limit`) and their
//    scales (cp.async, zeros past `limit`) into a 2-stage ring; the
//    warpgroup widens each tile to bf16 (exact) in the 128-byte-swizzled
//    layout wgmma reads, S = Q.K^T on the tensor cores (bf16 x int8-valued
//    bf16 products are exact, float32 sums) times k_scale per column, and
//    P.V with p * v_scale split into a bf16 high part and a bf16 low part
//    (hi = bf16(x), lo = bf16(x - hi)): two wgmmas into one float32
//    accumulator keep p * v_scale to ~2^-17 of itself, where one bf16
//    rounding (2^-9) would miss the int8 gate of 1e-4.  Under float16 q the
//    K tile is widened to f16 (S = Q.K^T takes both operands in one type),
//    and the V tile still to bf16, so P.V keeps its two bf16 parts: the
//    parts of p * v_scale (v_scale = amax / 127, p down to 2^-126) need
//    bf16's float32-sized exponent; as f16 parts they would fall under
//    f16's smallest normal (6.1e-5) wherever p is small and lose the bits
//    the int8 gate holds.  int8 values are exact in either type.  Both: the
//    causal mask carries the row offset limit - t; tiles wholly before
//    kv_valid_from[b] or past the CTA's last causal column are never loaded.
//
// The split-K kernel's geometry, stage compute and merge live in
// csrc/sm90.cuh (DecGeom, split_stage, split_finish), and so do the
// prefill's tile softmax, int8 widening and output rows (tile_softmax,
// widen_tile, store_tile_rows), shared with the paged kernels
// (csrc/paged_attention_sm90.cu).
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

constexpr int kSplitMaxRows = 16;  // t up to this takes the split-K kernel

// ---------------------------------------------------------------------------
// t <= 16: split-K over bulk copies
// ---------------------------------------------------------------------------

// 4 bytes from global into shared memory with cp.async, or 4 zero bytes
// (nothing read) when !read
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool read) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(read ? 4 : 0)
               : "memory");
}

// one arrival on `bar` once every cp.async this thread has issued has
// landed (the barrier's count includes it: .noinc)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// R: query rows per CTA (1 at t = 1, else 4; grid.z covers t).  Q8: int8
// caches, with k_scale / v_scale [b, n, L] (else caches of E, scales null).
// E: q's element type, bf16 or f16.  Scores and the running max are kept in
// the log2 domain (scale * log2(e) folded in).
template <int D, int R, bool Q8, typename E>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_split_kernel(const E* __restrict__ q, const uint8_t* __restrict__ k,
                          const uint8_t* __restrict__ v, const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale, const int* __restrict__ valid_from,
                          float* __restrict__ out, float* __restrict__ part,
                          int* __restrict__ counters, int n, int t, int L, int limit,
                          float scale_log2e) {
  using G = DecGeom<D, Q8>;
  constexpr int P = G::kPer;
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
  const uint8_t* k_head = k + static_cast<size_t>(bn) * L * G::kRow;
  const uint8_t* v_head = v + static_cast<size_t>(bn) * L * G::kRow;

  if (threadIdx.x == 0) {
    // int8: each stage also waits for every thread's scale copies
    for (int i = 0; i < kDecStages; ++i) mbar_init(full + i, Q8 ? 1 + kDecThreads : 1);
    fence_barrier_init();
  }
  __syncthreads();
  auto issue = [&](int s) {  // thread 0: the stage's K and V rows
    const int c0 = lo + s * G::kKeys;
    const uint32_t bytes = static_cast<uint32_t>(min(G::kKeys, hi - c0)) * G::kRow;
    const int st = s % kDecStages;
    uint64_t* bar = full + st;
    mbar_expect_tx(bar, 2 * bytes);
    bulk_load(smem + G::kK + st * G::kTile, k_head + static_cast<size_t>(c0) * G::kRow, bytes, bar);
    bulk_load(smem + G::kV + st * G::kTile, v_head + static_cast<size_t>(c0) * G::kRow, bytes, bar);
  };
  auto issue_scales = [&](int s) {  // every thread (int8): the stage's scales, zeros past hi
    const int c0 = lo + s * G::kKeys;
    const int st = s % kDecStages;
    float* dst = reinterpret_cast<float*>(smem + G::kScl) + st * 2 * G::kKeys;
    const size_t row = static_cast<size_t>(bn) * L;
    for (int i = threadIdx.x; i < 2 * G::kKeys; i += kDecThreads) {
      const int col = c0 + i % G::kKeys;
      const float* src = (i < G::kKeys ? k_scale : v_scale) + row + min(col, hi - 1);
      cp_async4(dst + i, src, col < hi);
    }
    cp_async_arrive(full + st);
  };
  if constexpr (Q8)
    for (int s = 0; s < min(kDecStages, nstages); ++s) issue_scales(s);
  if (threadIdx.x == 0) {
    for (int s = 0; s < min(kDecStages, nstages); ++s) issue(s);
  }

  float qf[R][P];
  split_load_q<D, R, Q8, E>(q + (static_cast<size_t>(bn) * t + r0) * D, nrows, sub, qf);
  float m[R], l[R], acc[R][P];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < P; ++e) acc[r][e] = 0.f;
  }

  for (int s = 0; s < nstages; ++s) {
    const int st = s % kDecStages;
    mbar_wait(full + st, (s / kDecStages) & 1);
    const int c0 = lo + s * G::kKeys;
    split_stage<D, R, Q8, E>(smem + G::kK + st * G::kTile, smem + G::kV + st * G::kTile,
                          reinterpret_cast<const float*>(smem + G::kScl) + st * 2 * G::kKeys,
                             stream, sub, c0, min(G::kKeys, hi - c0), pos0, nrows, scale_log2e,
                             qf, m, l, acc);
    __syncthreads();  // the stage is read: refill it
    if (s + kDecStages < nstages) {
      if constexpr (Q8) issue_scales(s + kDecStages);
      if (threadIdx.x == 0) issue(s + kDecStages);
    }
  }

  const int idx = bn * gridDim.z + blockIdx.z;  // (b, h, row group)
  split_finish<D, R, Q8>(m, l, acc, reinterpret_cast<float*>(smem), last,
                         out + (static_cast<size_t>(bn) * t + r0) * D, nrows,
                         splits > 1 ? part + static_cast<size_t>(idx) * splits * R * (D + 2)
                                    : nullptr,
                         counters + idx, split, splits);
}

// ---------------------------------------------------------------------------
// t > 16: prefill on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kPreConsumers = 128;               // one warpgroup: 64 query rows
constexpr int kPreThreads = kPreConsumers + 32;  // + the TMA warp
constexpr int kPreStages = 2;

// Key tiles of 128 at d = 64 and of 64 at d = 128: 32 KB of K and V a
// stage either way, so two CTAs fit on an SM at d = 128 too.
template <int D>
struct PreSmem {
  static constexpr int kBoxes = D / 64;
  static constexpr int kKeys = D == 64 ? 128 : 64;  // keys per tile
  static constexpr int kKBox = kKeys * 128;         // bytes of a [kKeys, 64 E] box
  static constexpr int kTile = kBoxes * kKBox;      // [kKeys, D] E
  static constexpr int kQ = 0;                      // [64 rows, D] E
  static constexpr int kK = kQ + kBoxes * kQBox;
  static constexpr int kV = kK + kPreStages * kTile;
  static constexpr int kBar = kV + kPreStages * kTile;
  static constexpr int kBytes = kBar + 64 + 1024;  // + slack to align the base to 1024
};

// E: the element type of q and the caches, bf16 or f16
template <int D, typename E>
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
        wgmma_ss_n128<0, 0, E>(sc, dq, dk, kk > 0);
      else
        wgmma_ss_n64<0, 0, E>(sc, dq, dk, kk > 0);
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
    tile_softmax(sc, o, m, l, scale_log2e);
    // o += P_E.V: P (rounded to E) from registers, V [keys, d] an MN-major
    // B whose 64-column boxes are kKBox apart
    constexpr int KS = S::kKeys / 16;
    uint32_t pf[KS][4];
    to_a_frags<KS, E>(sc, pf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint64_t bv = sw128_desc(v_s + kk * 16 * 128, S::kKBox, 1024);
      if constexpr (D == 64)
        wgmma_rs_n64<1, E>(o, pf[kk], bv, 1);
      else
        wgmma_rs_n128<1, E>(o, pf[kk], bv, 1);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
    fence_regs(pf);
    mbar_arrive(empty + st);
  }
  store_tile_rows<D>(o, l, out + static_cast<size_t>(bn) * t * D, q0, t, r_in, lane);
}

// int8 caches: one warpgroup issues its own copies into a 2-stage ring and
// widens each tile before its products: K to q's type E, V to bf16
constexpr int kPq8Threads = kWgThreads;
constexpr int kPq8Stages = 2;

template <int D>
struct PreQ8Smem {
  static constexpr int kBoxes = D / 64;
  static constexpr int kKeys = D == 64 ? 128 : 64;  // keys per tile
  static constexpr int kKBox = kKeys * 128;         // bytes of a [kKeys, 64] 2-byte box
  static constexpr int kTile = kBoxes * kKBox;      // [kKeys, D] of E (K) or bf16 (V)
  static constexpr int kRaw = kKeys * D;            // [kKeys, D] int8
  static constexpr int kQ = 0;                      // [64 rows, D] E (TMA, swizzled)
  static constexpr int kK = kQ + kBoxes * kQBox;    // the tile's K, widened
  static constexpr int kV = kK + kTile;             // the tile's V, widened
  static constexpr int kRawK = kV + kTile;          // kPq8Stages stages of int8 K rows
  static constexpr int kRawV = kRawK + kPq8Stages * kRaw;
  static constexpr int kScl = kRawV + kPq8Stages * kRaw;    // stages of k_scale, v_scale [kKeys]
  static constexpr int kCur = kScl + kPq8Stages * 2 * kKeys * 4;  // the tile's scales [2][kKeys]
  static constexpr int kBar = kCur + 2 * kKeys * 4;
  static constexpr int kBytes = kBar + 8 * (1 + kPq8Stages) + 1024;  // + slack to align to 1024
};

template <int D, typename E>
__global__ void __launch_bounds__(kPq8Threads)
flash_decode_prefill_q8_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const uint8_t* __restrict__ k, const uint8_t* __restrict__ v,
                               const float* __restrict__ k_scale,
                               const float* __restrict__ v_scale,
                               const int* __restrict__ valid_from, float* __restrict__ out,
                               int n, int bn_total, int t, int L, int limit, float scale_log2e) {
  using S = PreQ8Smem<D>;
  constexpr int kKeys = S::kKeys;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + S::kBar);
  uint64_t* full = bar_q + 1;
  float* cur = reinterpret_cast<float*>(smem + S::kCur);  // [k_scale, v_scale][kKeys]
  const int ntq = (t + 63) / 64;
  const int qi = ntq - 1 - static_cast<int>(blockIdx.x) / bn_total;  // longest rows first
  const int bn = static_cast<int>(blockIdx.x) % bn_total;
  const int q0 = 64 * qi;
  const int valid = valid_from != nullptr ? max(valid_from[bn / n], 0) : 0;
  const int pos_first = limit - t + q0;  // position of the tile's first row
  const int pos_last = limit - t + min(q0 + 63, t - 1);
  const int j0 = valid / kKeys;  // the first key tile holding a visible key
  const int nkv = valid <= pos_last ? pos_last / kKeys - j0 + 1 : 0;
  const uint8_t* k_head = k + static_cast<size_t>(bn) * L * D;
  const uint8_t* v_head = v + static_cast<size_t>(bn) * L * D;
  const size_t srow = static_cast<size_t>(bn) * L;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int i = 0; i < kPq8Stages; ++i) mbar_init(full + i, 1 + kPq8Threads);
    fence_barrier_init();
  }
  __syncthreads();
  // tile j into stage j % kPq8Stages: every thread copies scales (zeros at
  // or past `limit`), thread 0 the K and V rows up to `limit`
  auto issue = [&](int j) {
    const int st = j % kPq8Stages;
    const int key0 = kKeys * (j0 + j);  // <= pos_last < limit
    float* dst = reinterpret_cast<float*>(smem + S::kScl) + st * 2 * kKeys;
    for (int i = threadIdx.x; i < 2 * kKeys; i += kPq8Threads) {
      const int col = key0 + i % kKeys;
      cp_async4(dst + i, (i < kKeys ? k_scale : v_scale) + srow + min(col, limit - 1),
                col < limit);
    }
    cp_async_arrive(full + st);
    if (threadIdx.x == 0) {
      const uint32_t bytes = static_cast<uint32_t>(min(kKeys, limit - key0)) * D;
      mbar_expect_tx(full + st, 2 * bytes);
      bulk_load(smem + S::kRawK + st * S::kRaw, k_head + static_cast<size_t>(key0) * D, bytes,
                full + st);
      bulk_load(smem + S::kRawV + st * S::kRaw, v_head + static_cast<size_t>(key0) * D, bytes,
                full + st);
    }
  };
  if (nkv > 0) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, S::kBoxes * kQBox);
      for (int c = 0; c < S::kBoxes; ++c)
        tma_load(smem + S::kQ + c * kQBox, &tm_q, bar_q, 64 * c, q0, bn);
    }
    for (int j = 0; j < min(kPq8Stages, nkv); ++j) issue(j);
  }

  // thread t holds rows r_in and r_in + 8 of the tile
  const int lane = threadIdx.x % 32;
  const int r_in = 16 * (threadIdx.x / 32) + lane / 4;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint32_t q_s = smem_u32(smem + S::kQ);
  const uint32_t k_s = smem_u32(smem + S::kK);
  const uint32_t v_s = smem_u32(smem + S::kV);
  if (nkv > 0) mbar_wait(bar_q, 0);
  for (int j = 0; j < nkv; ++j) {
    const int st = j % kPq8Stages;
    const int k0 = kKeys * (j0 + j);
    mbar_wait(full + st, (j / kPq8Stages) & 1);
    __syncthreads();  // the last tile's products have read K, V and `cur`
    const int cnt = min(kKeys, limit - k0);
    widen_tile<D, kKeys, E>(smem + S::kRawK + st * S::kRaw, smem + S::kK, cnt);
    widen_tile<D, kKeys, __nv_bfloat16>(smem + S::kRawV + st * S::kRaw, smem + S::kV, cnt);
    const float* scl = reinterpret_cast<const float*>(smem + S::kScl) + st * 2 * kKeys;
    for (int i = threadIdx.x; i < 2 * kKeys; i += kPq8Threads) cur[i] = scl[i];
    fence_proxy_async();  // the widened tiles, for wgmma
    __syncthreads();
    if (j + kPq8Stages < nkv) issue(j + kPq8Stages);  // the stage is free
    // S = Q.K^T: [64 rows, kKeys], K-major operands, d in k16 steps
    constexpr int NS = kKeys / 2;  // S's accumulator registers a thread
    float sc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      const uint64_t dq = sw128_desc(q_s + (kk / 4) * kQBox + col, 16, 1024);
      const uint64_t dk = sw128_desc(k_s + (kk / 4) * S::kKBox + col, 16, 1024);
      if constexpr (kKeys == 128)
        wgmma_ss_n128<0, 0, E>(sc, dq, dk, kk > 0);
      else
        wgmma_ss_n64<0, 0, E>(sc, dq, dk, kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);
    // k_scale per column, then the masks (a select: 0 x a NaN never survives)
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] *= cur[key_of(i, lane)];
    if (k0 < valid || k0 + kKeys - 1 > pos_first) {  // crosses valid_from or the diagonal
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int col = k0 + key_of(i, lane);
        if (col < valid || col > pos_first + r_in + 8 * ((i >> 1) & 1)) sc[i] = -INFINITY;
      }
    }
    tile_softmax(sc, o, m, l, scale_log2e);
    // o += (P * v_scale).V, P * v_scale as bf16 high + low parts from
    // registers (whatever q's type); V [keys, d] bf16, an MN-major B whose
    // 64-column boxes are kKBox apart
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] *= cur[kKeys + key_of(i, lane)];
    constexpr int KS = kKeys / 16;
    uint32_t ph[KS][4], pl[KS][4];
    to_a_frags_split<KS>(sc, ph, pl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint64_t bv = sw128_desc(v_s + kk * 16 * 128, S::kKBox, 1024);
      if constexpr (D == 64) {
        wgmma_rs_n64<1>(o, ph[kk], bv, 1);
        wgmma_rs_n64<1>(o, pl[kk], bv, 1);
      } else {
        wgmma_rs_n128<1>(o, ph[kk], bv, 1);
        wgmma_rs_n128<1>(o, pl[kk], bv, 1);
      }
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
  }
  store_tile_rows<D>(o, l, out + static_cast<size_t>(bn) * t * D, q0, t, r_in, lane);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int D, int R, bool Q8, typename E>
int launch_split(const void* q, const void* k, const void* v, const float* ks, const float* vs,
                 const int* vf, float* out, float* part, int* counters, int bn, int n, int t,
                 int L, int limit, int splits, float scale_log2e, cudaStream_t st) {
  auto kern = flash_decode_split_kernel<D, R, Q8, E>;
  const int smem = DecGeom<D, Q8>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bn, splits, (t + R - 1) / R);
  kern<<<grid, kDecThreads, smem, st>>>(
      static_cast<const E*>(q), static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(v), ks, vs, vf, out, part, counters, n, t, L, limit,
      scale_log2e);
  return cudaGetLastError();
}

template <int D, typename E>
int launch_prefill(const void* q, const void* k, const void* v, const int* vf, float* out,
                   int bn, int n, int t, int L, int limit, float scale_log2e, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  constexpr int keys = PreSmem<D>::kKeys;
  if (!make_map<E>(&tq, q, bn, t, t, D, 64) || !make_map<E>(&tk, k, bn, limit, L, D, keys) ||
      !make_map<E>(&tv, v, bn, limit, L, D, keys))
    return kMapFailed;
  auto kern = flash_decode_prefill_kernel<D, E>;
  const int smem = PreSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<bn * ((t + 63) / 64), kPreThreads, smem, st>>>(tq, tk, tv, vf, out, n, bn, t, limit,
                                                        scale_log2e);
  return cudaGetLastError();
}

template <int D, typename E>
int launch_prefill_q8(const void* q, const void* k, const void* v, const float* ks,
                      const float* vs, const int* vf, float* out, int bn, int n, int t, int L,
                      int limit, float scale_log2e, cudaStream_t st) {
  CUtensorMap tq;
  if (!make_map<E>(&tq, q, bn, t, t, D, 64)) return kMapFailed;
  auto kern = flash_decode_prefill_q8_kernel<D, E>;
  const int smem = PreQ8Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<bn * ((t + 63) / 64), kPq8Threads, smem, st>>>(
      tq, static_cast<const uint8_t*>(k), static_cast<const uint8_t*>(v), ks, vs, vf, out, n, bn,
      t, L, limit, scale_log2e);
  return cudaGetLastError();
}

// the split-K kernel at t <= kSplitMaxRows: one row per CTA at t = 1, else 4
template <bool Q8, typename E>
int launch_decode(const void* q, const void* k, const void* v, const float* ks, const float* vs,
                  const int* vf, float* o, float* pt, int* ct, int bn, int n, int t, int L, int d,
                  int limit, int splits, float sl2, cudaStream_t st) {
  if (t == 1)
    return d == 64 ? launch_split<64, 1, Q8, E>(q, k, v, ks, vs, vf, o, pt, ct, bn, n, t, L,
                                                limit, splits, sl2, st)
                   : launch_split<128, 1, Q8, E>(q, k, v, ks, vs, vf, o, pt, ct, bn, n, t, L,
                                                 limit, splits, sl2, st);
  return d == 64 ? launch_split<64, 4, Q8, E>(q, k, v, ks, vs, vf, o, pt, ct, bn, n, t, L, limit,
                                              splits, sl2, st)
                 : launch_split<128, 4, Q8, E>(q, k, v, ks, vs, vf, o, pt, ct, bn, n, t, L,
                                               limit, splits, sl2, st);
}

// what neither entry takes
bool bad_args(const void* part, const void* counters, int b, int n, int t, int L, int d,
              int limit, int splits) {
  const long long bn = static_cast<long long>(b) * n;
  return (d != 64 && d != 128) || t < 1 || t > limit || limit > L || b < 1 || n < 1 ||
         bn * ((t + 63) / 64) > 0x7fffffffLL || splits < 1 || splits > 65535 ||
         (t <= kSplitMaxRows && splits > 1 && (part == nullptr || counters == nullptr));
}

}  // namespace

extern "C" {

// q [b, n, t, d] and caches [b, n, L, d] of one element type, `dtype` 1
// bfloat16 or 2 float16, d = 64 or 128; valid_from int32 [b] or null; out
// float32 [b, n, t, d].  t <= 16 takes the split-K
// kernel over `splits` CTAs per (b, h, row group), rows = 1 at t = 1, else
// 4: with splits > 1, `part` is float32 scratch of groups * splits * rows *
// (d + 2) floats and `counters` int32 scratch of groups = b * n *
// ceil(t / rows) zeros, which every call leaves zeroed.  t > 16 takes the
// tensor-core prefill (splits, part and counters unused).
int flash_decode_sm90(const void* q, const void* k, const void* v, const void* valid_from,
                      void* out, void* part, void* counters, int b, int n, int t, int L, int d,
                      int limit, int splits, float scale, int dtype, void* stream) {
  if (bad_args(part, counters, b, n, t, L, d, limit, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* vf = static_cast<const int*>(valid_from);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * kLog2e;
  const int bn = b * n;
  return by_dtype(dtype, [&](auto tag) {
    using E = decltype(tag);
    if (t > kSplitMaxRows)
      return d == 64 ? launch_prefill<64, E>(q, k, v, vf, o, bn, n, t, L, limit, sl2, st)
                     : launch_prefill<128, E>(q, k, v, vf, o, bn, n, t, L, limit, sl2, st);
    return launch_decode<false, E>(q, k, v, nullptr, nullptr, vf, o, static_cast<float*>(part),
                                   static_cast<int*>(counters), bn, n, t, L, d, limit, splits,
                                   sl2, st);
  });
}

// The same over int8 caches [b, n, L, d] with float32 k_scale / v_scale
// [b, n, L]; q of `dtype` (1 bfloat16, 2 float16), the rest as
// flash_decode_sm90.
int flash_decode_q8_sm90(const void* q, const void* k, const void* v, const void* k_scale,
                         const void* v_scale, const void* valid_from, void* out, void* part,
                         void* counters, int b, int n, int t, int L, int d, int limit,
                         int splits, float scale, int dtype, void* stream) {
  if (bad_args(part, counters, b, n, t, L, d, limit, splits) || k_scale == nullptr ||
      v_scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* vf = static_cast<const int*>(valid_from);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * kLog2e;
  const int bn = b * n;
  return by_dtype(dtype, [&](auto tag) {
    using E = decltype(tag);
    if (t > kSplitMaxRows)
      return d == 64
                 ? launch_prefill_q8<64, E>(q, k, v, ks, vs, vf, o, bn, n, t, L, limit, sl2, st)
                 : launch_prefill_q8<128, E>(q, k, v, ks, vs, vf, o, bn, n, t, L, limit, sl2, st);
    return launch_decode<true, E>(q, k, v, ks, vs, vf, o, static_cast<float*>(part),
                                  static_cast<int*>(counters), bn, n, t, L, d, limit, splits, sl2,
                                  st);
  });
}

const char* flash_decode_sm90_error_string(int code) { return error_string(code); }

}  // extern "C"
