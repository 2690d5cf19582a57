// Paged decode / verify / chunk attention at head dim 64 or 128 on Hopper
// (sm_90a), for bfloat16 or float16 q over pools of q's type or over int8
// pools with per-slot scales.  One template per element type E (the
// entries' `dtype` argument: 1 bfloat16, 2 float16), sharing every tile,
// swizzle and copy.
//
// Replaces, for bfloat16 and float16 q at d in {64, 128} and block sizes 8,
// 16, 32, 64 or 128, the TPU kernel of paddlefleetx_tpu/ops/decode_attention.py:
//   _paged_kernel (:524, launched by _paged_pallas :646) -> paged_decode_sm90 (bf16 / f16)
//                                                        -> paged_decode_q8_sm90 (int8)
// csrc/paged_attention.cu keeps float32 q, other head dims and block sizes
// (ops/decode_attention.paged_kernel_route).
//
// What it computes (the contract of csrc/paged_attention.cu, unchanged): q
// [b, n, t, d] holds a chunk of t queries per row; query r of row i sits at
// logical slot positions[i] + r and attends over the row's logical slots col
// <= positions[i] + r, where slot col lives in pool block tables[i, col / bs]
// at offset col % bs (pools [num_blocks, n, bs, d]).  Online softmax with
// float32 state; out float32 [b, n, t, d] = acc / max(l, 1e-30).  bf16 / f16
// pools: the probabilities are rounded to the pool's type before p @ v (the
// Pallas kernel's p.astype(v.dtype)).  int8 pools: the scores are multiplied by k_scale per
// key, and p * v_scale stays in float32 (nothing is rounded).  Scales
// [num_blocks, n, bs] float32 are indexed by pool block, like the payload.
// Slots below positions[i] + t hold written keys; slots at or past it may
// hold anything (NaN included), and never reach the output.
//
// Two kernels behind each entry, chosen by t, as K7/K8's
// (csrc/decode_attention_sm90.cu):
//
// t <= 16 (decode, speculative verify).  What bounds it on the card:
// device-memory bytes.  A decode step reads each row's visible K/V once, 2 *
// n * d bytes a key per pool byte (plus 8 bytes of scales a key for int8),
// for 4 * d operations a key and head: far under the ridge, so the tensor
// cores are not used.  Design, against that bound:
//  * Split-K over each row's keys (flash-decoding).  The grid is (b * n,
//    splits, row groups of R rows: 1 at t = 1, else 4).  Split s takes the
//    row's logical keys [s * split_keys, (s + 1) * split_keys), clipped on
//    the card to [0, positions[i] + r0 + rows): the host picks split_keys and
//    the split count from shapes alone (ops/decode_attention.paged_splits:
//    enough splits for a table of M blocks), never from positions, so no
//    launch waits on a copy to the host.  A split past its row's end exits at
//    once, so a long row is cut into many CTAs while a short one takes one,
//    and the CTAs of rows of any mix of lengths finish together.
//  * A ring of bulk copies fed through the block table.  Each (pool block,
//    head) is one contiguous run of bs * d elements (16-byte aligned), and
//    its scales one run of 4 * bs bytes (a multiple of 32: bs % 8 == 0).  A
//    stage holds 8 KB of K and of V (DecGeom: 64 / 32 keys of bf16 / f16 at d = 64
//    / 128, 128 / 64 of int8), a whole number of blocks (bs <= stage) or a
//    stage-sized run of one block (bs > stage); the threads first stage the
//    split's table entries in shared memory, then for each stage warp 0's
//    lanes issue one cp.async.bulk per block or run, for K, V and the two
//    scale runs, all completing on the stage's mbarrier.  The pools stay in
//    their own type in shared memory.  Only the row's blocks up to its last
//    needed one, (positions[i] + t - 1) / bs, and only their table entries,
//    are read: null padding and other rows' blocks stay unread.
//  * The lane-group-per-key compute of K7/K8's split-K kernel (csrc/sm90.cuh:
//    split_stage): 16 bytes of a key row a lane, q . k summed with shuffles,
//    int8 widened by a byte permute into 2^23's mantissa, per-group float32
//    (m, l, acc) merged by butterflies and then in warp order.  A copied
//    block's slots past a row's bound are selected away, never multiplied
//    (0 x NaN would be NaN).
//  * The splits merge in one launch (csrc/sm90.cuh: split_finish): the last
//    CTA of each (row, head, row group) to bump an integer counter combines
//    the partials in split order and resets the counter.  No memset, and the
//    same bits on every call.  The scratch (partials and counters) is the
//    wrapper's, sized from shapes; a CUDA-graph capture must size it first.
//
// t > 16 (a chunked prefill's chunk, a prefix hit's suffix, a wide verify).
// Every key read serves up to t queries: at t = 256 over a 512-token prefix
// (d = 64) ~210 operations a pool byte, near the bf16 ridge (295) and far
// past what CUDA-core FMAs sustain, so the tensor cores carry it.
// Design (K7/K8's tensor-core prefill, fed through the block table):
//  * A CTA is one warpgroup on a 64-row query tile of one (row, head) and
//    one split of its keys; S = Q.K^T by wgmma from shared memory, the
//    online softmax in registers (csrc/sm90.cuh: tile_softmax), P as the
//    register A operand of P.V (bf16 / f16: P rounded to the pool's type;
//    int8: p * v_scale as a bf16 high and a bf16 low part under either q
//    type, tools/q8_prefill_precision.py, with K widened to q's type and V
//    to bf16, as csrc/decode_attention_sm90.cu's int8 prefill says why).
//    Key tiles of 128 keys at d = 64, 64 at d = 128, through a 2-stage
//    mbarrier ring; a tile is assembled from the row's pool blocks, one copy
//    per block (or per tile-sized run of a block larger than the tile):
//    bf16 / f16 by TMA through one 4-D map over the pool [nb, n, bs, d] with
//    a [64 values, min(bs, tile)] box and 128-byte swizzle, each block landing on
//    a 1024-byte boundary of the tile (bs * 128 bytes, bs % 8 == 0), so on
//    the swizzle phase the wgmma descriptors expect; int8 by cp.async.bulk of
//    the block's bs * d payload bytes and its two scale runs, widened (K to
//    q's type, V to bf16) in the same swizzled layout (csrc/sm90.cuh:
//    widen_tile) before the
//    products.  warp 0's lanes issue one block each.
//  * Only the table entries and blocks below the tile's causal end are read
//    (blocks up to (positions[i] + t - 1) / bs at most); a query tile skips
//    the key tiles past its last row, and tiles are ordered longest rows
//    first.
//  * Keys at or past the tile's bound (the tail of a row's last block, a
//    tile's rows no block filled) are selected away in S, and their V rows
//    (int8: their v_scale) are zeroed in shared memory before P.V: wgmma
//    multiplies every row, and 0 x NaN is NaN.
//  * Split-K from shapes alone, as above: split s takes keys [s *
//    split_keys, (s + 1) * split_keys) of the tile's range, split_keys a
//    multiple of 128 (whole key tiles), the count from the table width;
//    with more than one split, each CTA writes its float32 partial (o, m,
//    l per row) and the last to bump an integer counter merges them in
//    split order and resets it.  The same bits on every call.
//
// Plain C interface (loaded with ctypes); every entry point launches on the
// given stream and returns a CUDA error code (or kMapFailed) after its
// launch.  tables and positions are int32 device arrays; the table entries a
// row reads must lie in [0, num_blocks) (the engine checks its host tables
// before each upload).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kMaxRows = 16;        // t up to this takes the split-K kernel
constexpr int kSplitKeysUnit = 128;  // split_keys is a multiple: of every stage and block size
constexpr int kMaxSplitKeys = 512;
constexpr int kMaxEntries = kMaxSplitKeys / 8;  // table entries of a split at bs = 8

template <int D, bool Q8>
struct PagedSmem {
  using G = DecGeom<D, Q8>;
  static constexpr int kTab = G::kFlag + 16;  // kMaxEntries pool block ids
  static constexpr int kBytes = G::kBytes + 4 * kMaxEntries;
};

// R: query rows per CTA.  Q8: int8 pools with k_scale / v_scale [nb, n, bs]
// (else pools of E, scales null).  E: q's element type, bf16 or f16.  Pools
// are read as bytes: a pool row is G::kRow bytes.
template <int D, int R, bool Q8, typename E>
__global__ void __launch_bounds__(kDecThreads)
paged_decode_split_kernel(const E* __restrict__ q, const uint8_t* __restrict__ k_pool,
                          const uint8_t* __restrict__ v_pool, const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale, const int* __restrict__ tables,
                          const int* __restrict__ positions, float* __restrict__ out,
                          float* __restrict__ part, int* __restrict__ counters, int n, int t,
                          int M, int bs, int split_keys, float scale_log2e) {
  using G = DecGeom<D, Q8>;
  using S = PagedSmem<D, Q8>;
  constexpr int P = G::kPer;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align128(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::kBar);
  int* last = reinterpret_cast<int*>(smem + G::kFlag);
  int* entries = reinterpret_cast<int*>(smem + S::kTab);
  const int bn = blockIdx.x;
  const int row = bn / n;
  const int head = bn - row * n;
  const int split = blockIdx.y;
  const int r0 = blockIdx.z * R;
  const int nrows = min(R, t - r0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = lane % G::kLanesPerKey;
  const int stream = warp * G::kGroups + lane / G::kLanesPerKey;

  // the row group's keys [0, col_end) (no slot past the table's M blocks);
  // split 0 always runs, so a row with no key still writes its zeros
  const int pos0 = positions[row] + r0;  // slot of the CTA's first query
  const int col_end = min(pos0 + nrows, M * bs);
  const int active = max(1, (col_end + split_keys - 1) / split_keys);
  if (split >= active) return;  // the whole CTA: past its row's end
  const int lo = split * split_keys;
  const int hi = max(min(lo + split_keys, col_end), lo);
  const int nstages = (hi - lo + G::kKeys - 1) / G::kKeys;
  const int unit = min(bs, G::kKeys);  // keys a copy takes: a block, or a stage's run of one
  const int e0 = lo / bs;              // lo is a multiple of bs
  const int nent = hi > lo ? (hi - 1) / bs - e0 + 1 : 0;

  const int* table_row = tables + static_cast<size_t>(row) * M;
  for (int e = threadIdx.x; e < nent; e += kDecThreads) entries[e] = table_row[e0 + e];
  if (threadIdx.x == 0) {
    for (int i = 0; i < kDecStages; ++i) mbar_init(full + i, 1);
    fence_barrier_init();
  }
  __syncthreads();
  auto issue = [&](int s) {  // warp 0: the stage's K, V (and scale) runs
    const int c0 = lo + s * G::kKeys;
    const int units = (min(G::kKeys, hi - c0) + unit - 1) / unit;
    const int st = s % kDecStages;
    uint64_t* bar = full + st;
    const uint32_t bytes = static_cast<uint32_t>(unit) * (G::kRow + (Q8 ? 4 : 0));
    if (lane == 0) mbar_expect_tx(bar, 2 * units * bytes);
    __syncwarp();
    for (int j = lane; j < units; j += 32) {
      const int c = c0 + j * unit;
      const int blk = c / bs;
      const size_t slot = (static_cast<size_t>(entries[blk - e0]) * n + head) * bs + (c - blk * bs);
      const uint32_t run = static_cast<uint32_t>(unit) * G::kRow;
      bulk_load(smem + G::kK + st * G::kTile + j * run, k_pool + slot * G::kRow, run, bar);
      bulk_load(smem + G::kV + st * G::kTile + j * run, v_pool + slot * G::kRow, run, bar);
      if constexpr (Q8) {
        float* scl = reinterpret_cast<float*>(smem + G::kScl) + st * 2 * G::kKeys + j * unit;
        bulk_load(scl, k_scale + slot, 4 * unit, bar);
        bulk_load(scl + G::kKeys, v_scale + slot, 4 * unit, bar);
      }
    }
  };
  if (warp == 0)
    for (int s = 0; s < min(kDecStages, nstages); ++s) issue(s);

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
    if (warp == 0 && s + kDecStages < nstages) issue(s + kDecStages);
  }

  const int idx = bn * gridDim.z + blockIdx.z;  // (row, head, row group)
  split_finish<D, R, Q8>(m, l, acc, reinterpret_cast<float*>(smem), last,
                         out + (static_cast<size_t>(bn) * t + r0) * D, nrows,
                         active > 1 ? part + static_cast<size_t>(idx) * gridDim.y * R * (D + 2)
                                    : nullptr,
                         counters + idx, split, active);
}

template <int D, int R, bool Q8, typename E>
int launch_split(const void* q, const void* k, const void* v, const float* ks, const float* vs,
                 const int* tables, const int* positions, float* out, float* part,
                 int* counters, int bn, int n, int t, int M, int bs, int splits, int split_keys,
                 float scale_log2e, cudaStream_t st) {
  auto kern = paged_decode_split_kernel<D, R, Q8, E>;
  const int smem = PagedSmem<D, Q8>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bn, splits, (t + R - 1) / R);
  kern<<<grid, kDecThreads, smem, st>>>(
      static_cast<const E*>(q), static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(v), ks, vs, tables, positions, out, part, counters, n, t, M,
      bs, split_keys, scale_log2e);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// t > 16: chunks on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kChunkRows = 64;  // query rows a CTA: one warpgroup's wgmma tile
constexpr int kChunkStages = 2;

// Key tiles of 128 keys at d = 64 and of 64 at d = 128 (K7/K8's prefill
// tiles).  bf16 / f16: the ring's stages hold K and V as TMA lands them;
// int8: the ring holds the raw rows and their scales, widened into one K
// tile (q's type) and one V tile (bf16) before the products.
template <int D, bool Q8>
struct ChunkSmem {
  static constexpr int kBoxes = D / 64;
  static constexpr int kKeys = D == 64 ? 128 : 64;     // keys per tile
  static constexpr int kKBox = kKeys * 128;            // bytes of a [kKeys, 64] 2-byte box
  static constexpr int kTile = kBoxes * kKBox;         // [kKeys, D] 2-byte values
  static constexpr int kTiles = Q8 ? 1 : kChunkStages;  // 2-byte K (and V) tiles
  static constexpr int kRaw = Q8 ? kKeys * D : 0;      // int8 rows [kKeys, D] a stage
  static constexpr int kQ = 0;                         // [64 rows, D] q (TMA, swizzled)
  static constexpr int kK = kQ + kBoxes * kQBox;
  static constexpr int kV = kK + kTiles * kTile;
  static constexpr int kRawK = kV + kTiles * kTile;
  static constexpr int kRawV = kRawK + kChunkStages * kRaw;
  static constexpr int kScl = kRawV + kChunkStages * kRaw;  // stages of k_scale, v_scale [kKeys]
  static constexpr int kCur = kScl + (Q8 ? kChunkStages * 2 * kKeys * 4 : 0);  // the tile's scales
  static constexpr int kBar = kCur + (Q8 ? 2 * kKeys * 4 : 0);  // bar_q, full[kChunkStages]
  static constexpr int kFlag = kBar + 8 * (1 + kChunkStages);
  static constexpr int kBytes = kFlag + 16 + 1024;  // + slack to align the base to 1024
};

// One CTA: query tile qi of (row, head) bn, split `split` of the tile's
// keys.  E: q's element type (bf16 or f16), and the pools' unless Q8.
// tm_q: q [b * n, t, D]; tm_k / tm_v (pools of E): the pools as [nb, n,
// bs, D] with a [64, min(bs, kKeys)] box; k_pool / v_pool and the scales
// (int8 pools): read by bulk copies.  Scores and the running max are kept
// in the log2 domain (scale * log2(e) folded in).
template <int D, bool Q8, typename E>
__global__ void __launch_bounds__(kWgThreads)
paged_chunk_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const uint8_t* __restrict__ k_pool,
                   const uint8_t* __restrict__ v_pool, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, const int* __restrict__ tables,
                   const int* __restrict__ positions, float* __restrict__ out,
                   float* __restrict__ part, int* __restrict__ counters, int n, int bn_total,
                   int t, int M, int bs, int splits, int split_keys, float scale_log2e) {
  using S = ChunkSmem<D, Q8>;
  constexpr int KT = S::kKeys;
  constexpr int NS = KT / 2;   // S's accumulator registers a thread
  constexpr int KS = KT / 16;  // k16 steps of P.V
  constexpr int ldp = D + 2;   // a partial row: o[D], m, l
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + S::kBar);
  uint64_t* full = bar_q + 1;
  int* last = reinterpret_cast<int*>(smem + S::kFlag);
  float* cur = reinterpret_cast<float*>(smem + S::kCur);  // int8: [k_scale, v_scale][KT]
  // CTAs in order: query tiles from the last (longest rows) to the first,
  // then the tile's splits, then (row, head)
  const int ntq = (t + kChunkRows - 1) / kChunkRows;
  const int bn = static_cast<int>(blockIdx.x % bn_total);
  const int split = static_cast<int>(blockIdx.x / bn_total) % splits;
  const int qi = ntq - 1 - static_cast<int>(blockIdx.x / bn_total) / splits;
  const int q0 = kChunkRows * qi;
  const int row = bn / n;
  const int head = bn - row * n;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // the tile's keys [0, col_end) (no slot past the table's M blocks); split
  // 0 always runs, so a row with no key still writes its zeros
  const int pos_first = positions[row] + q0;  // slot of the tile's first query
  const int col_end = min(pos_first + min(kChunkRows, t - q0), M * bs);
  const int active = max(1, (col_end + split_keys - 1) / split_keys);
  if (split >= active) return;  // the whole CTA: past the tile's last key
  const int lo = split * split_keys;
  const int hi = max(min(lo + split_keys, col_end), lo);
  const int ntiles = (hi - lo + KT - 1) / KT;
  const int unit = min(bs, KT);  // keys a copy takes: a block, or a tile's run of one
  const int* table_row = tables + static_cast<size_t>(row) * M;
  const CUtensorMap* map_k = &tm_k;
  const CUtensorMap* map_v = &tm_v;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int i = 0; i < kChunkStages; ++i) mbar_init(full + i, 1);
    fence_barrier_init();
  }
  __syncthreads();
  // warp 0: key tile j into stage j % kChunkStages, a lane per block (or a
  // tile's run of one) below hi, for K and V (int8: and their scale runs).
  // Each copy lands `unit` rows on, a multiple of 8 rows (1024 bytes): the
  // 128-byte swizzle's phase, which the wgmma descriptors expect
  auto issue = [&](int j) {
    const int st = j % kChunkStages;
    const int k0 = lo + j * KT;
    const int units = (min(KT, hi - k0) + unit - 1) / unit;
    uint64_t* bar = full + st;
    const uint32_t bytes = static_cast<uint32_t>(unit) * (Q8 ? D + 4 : 2 * D);  // K (or V) a unit
    if (lane == 0) mbar_expect_tx(bar, 2 * units * bytes);
    __syncwarp();
    for (int u = lane; u < units; u += 32) {
      const int c = k0 + u * unit;
      const int blk = c / bs;
      const int off = c - blk * bs;
      const int id = table_row[blk];
      if constexpr (Q8) {
        const size_t slot = (static_cast<size_t>(id) * n + head) * bs + off;
        const uint32_t run = static_cast<uint32_t>(unit) * D;
        bulk_load(smem + S::kRawK + st * S::kRaw + u * run, k_pool + slot * D, run, bar);
        bulk_load(smem + S::kRawV + st * S::kRaw + u * run, v_pool + slot * D, run, bar);
        float* scl = reinterpret_cast<float*>(smem + S::kScl) + st * 2 * KT + u * unit;
        bulk_load(scl, k_scale + slot, 4 * unit, bar);
        bulk_load(scl + KT, v_scale + slot, 4 * unit, bar);
      } else {
#pragma unroll
        for (int c2 = 0; c2 < S::kBoxes; ++c2) {
          const int at = st * S::kTile + c2 * S::kKBox + u * unit * 128;
          tma_load_4d(smem + S::kK + at, map_k, bar, 64 * c2, off, head, id);
          tma_load_4d(smem + S::kV + at, map_v, bar, 64 * c2, off, head, id);
        }
      }
    }
  };
  if (warp == 0 && ntiles > 0) {
    if (lane == 0) {
      mbar_expect_tx(bar_q, S::kBoxes * kQBox);
      for (int c2 = 0; c2 < S::kBoxes; ++c2)
        tma_load(smem + S::kQ + c2 * kQBox, &tm_q, bar_q, 64 * c2, q0, bn);
    }
    __syncwarp();
    for (int j = 0; j < min(kChunkStages, ntiles); ++j) issue(j);
  }

  // thread t holds rows r_in and r_in + 8 of the tile; lim: the last key each
  // sees (its causal bound, below col_end); key tiles past diag need masks
  const int r_in = 16 * warp + lane / 4;
  const int lim[2] = {min(pos_first + r_in, col_end - 1), min(pos_first + r_in + 8, col_end - 1)};
  const int diag = min(pos_first, col_end - 1);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint32_t q_s = smem_u32(smem + S::kQ);
  if (ntiles > 0) mbar_wait(bar_q, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int st = j % kChunkStages;
    const int k0 = lo + j * KT;
    const int cnt = min(KT, hi - k0);  // rows of the tile at or past cnt hold no key
    mbar_wait(full + st, (j / kChunkStages) & 1);
    uint8_t* kt = smem + S::kK + (Q8 ? 0 : st * S::kTile);
    uint8_t* vt = smem + S::kV + (Q8 ? 0 : st * S::kTile);
    if constexpr (Q8) {
      // widen (rows past cnt: zeros) and take the scales (past cnt: zeros)
      widen_tile<D, KT, E>(smem + S::kRawK + st * S::kRaw, kt, cnt);
      widen_tile<D, KT, __nv_bfloat16>(smem + S::kRawV + st * S::kRaw, vt, cnt);
      const float* scl = reinterpret_cast<const float*>(smem + S::kScl) + st * 2 * KT;
      for (int i = threadIdx.x; i < 2 * KT; i += kWgThreads) cur[i] = i % KT < cnt ? scl[i] : 0.f;
      fence_proxy_async();  // the widened tiles, for wgmma
      __syncthreads();
      if (warp == 0 && j + kChunkStages < ntiles) issue(j + kChunkStages);  // the raw stage is free
    } else if (cnt < KT) {
      // V rows [cnt, KT) hold a block's slots past the bound or no copy at
      // all: zeroed (a row's 128 bytes of a box hold only that row, whatever
      // the swizzle)
      for (int i = threadIdx.x; i < (KT - cnt) * S::kBoxes * 8; i += kWgThreads) {
        const int r = cnt + i / (S::kBoxes * 8);
        const int c = i % (S::kBoxes * 8);
        *reinterpret_cast<uint4*>(vt + (c / 8) * S::kKBox + r * 128 + (c % 8) * 16) =
            make_uint4(0u, 0u, 0u, 0u);
      }
      fence_proxy_async();  // the zeros, for wgmma
      __syncthreads();
    }
    const uint32_t k_s = smem_u32(kt);
    const uint32_t v_s = smem_u32(vt);
    // S = Q.K^T: [64 rows, KT], K-major operands, d in k16 steps
    float sc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      const uint64_t dq = sw128_desc(q_s + (kk / 4) * kQBox + col, 16, 1024);
      const uint64_t dk = sw128_desc(k_s + (kk / 4) * S::kKBox + col, 16, 1024);
      if constexpr (KT == 128)
        wgmma_ss_n128<0, 0, E>(sc, dq, dk, kk > 0);
      else
        wgmma_ss_n64<0, 0, E>(sc, dq, dk, kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);
    // int8: k_scale per column; then the bounds (a select: a NaN never survives)
    if constexpr (Q8) {
#pragma unroll
      for (int i = 0; i < NS; ++i) sc[i] *= cur[key_of(i, lane)];
    }
    if (k0 + KT - 1 > diag) {
#pragma unroll
      for (int i = 0; i < NS; ++i)
        if (k0 + key_of(i, lane) > lim[(i >> 1) & 1]) sc[i] = -INFINITY;
    }
    tile_softmax(sc, o, m, l, scale_log2e);
    // o += P.V: P from registers, V [KT, d] an MN-major B whose 64-column
    // boxes are kKBox apart; native: P rounded to E; int8: P * v_scale as
    // bf16 high and low parts over bf16 V, whatever q's type
    if constexpr (Q8) {
#pragma unroll
      for (int i = 0; i < NS; ++i) sc[i] *= cur[KT + key_of(i, lane)];
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
    } else {
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
    }
    __syncthreads();  // the tile's products have read its K and V (int8: and `cur`)
    if (!Q8 && warp == 0 && j + kChunkStages < ntiles) issue(j + kChunkStages);
  }

  float* out_head = out + static_cast<size_t>(bn) * t * D;
  if (active == 1) {
    store_tile_rows<D>(o, l, out_head, q0, t, r_in, lane);
    return;
  }
  // this split's float32 partial, o then m and l for each of the tile's
  // rows, in the thread's own accumulator layout
  const int group = qi * bn_total + bn;  // (query tile, row, head)
  float* group_part = part + static_cast<size_t>(group) * splits * kChunkRows * ldp;
  float* mine = group_part + static_cast<size_t>(split) * kChunkRows * ldp;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int rr = r_in + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    *reinterpret_cast<float2*>(mine + rr * ldp + col) = make_float2(o[i], o[i + 1]);
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mine[(r_in + 8 * h) * ldp + D] = m[h];
      mine[(r_in + 8 * h) * ldp + D + 1] = l[h];
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *last = atomicAdd(counters + group, 1) == active - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  // the last split to arrive merges all of them in split order
  float mm[2] = {kNegInf, kNegInf}, den[2] = {0.f, 0.f};
  for (int sp = 0; sp < active; ++sp)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mm[h] = fmaxf(mm[h], __ldcg(group_part + (sp * kChunkRows + r_in + 8 * h) * ldp + D));
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  for (int sp = 0; sp < active; ++sp) {
    const float* pp = group_part + static_cast<size_t>(sp) * kChunkRows * ldp;
    float f[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* prow = pp + (r_in + 8 * h) * ldp;
      f[h] = exp2f(__ldcg(prow + D) - mm[h]);
      den[h] += __ldcg(prow + D + 1) * f[h];
    }
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int h = (i >> 1) & 1;
      const int col = 8 * (i >> 2) + 2 * (lane & 3);
      const float2 v = __ldcg(reinterpret_cast<const float2*>(pp + (r_in + 8 * h) * ldp + col));
      o[i] += v.x * f[h];
      o[i + 1] += v.y * f[h];
    }
  }
  store_tile_rows<D>(o, den, out_head, q0, t, r_in, lane);
  if (threadIdx.x == 0) counters[group] = 0;  // ready for the next call
}

// a 4-D map over a pool [nb, n, bs, d] of E (bf16 or f16; innermost first:
// d, slot, head, block) with a [64, box_rows, 1, 1] box and 128-byte swizzle
template <typename E>
bool make_pool_map(CUtensorMap* map, const void* pool, int nb, int n, int bs, int d,
                   int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(bs),
                              static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(nb)};
  const cuuint64_t row = static_cast<cuuint64_t>(d) * 2;
  const cuuint64_t strides[3] = {row, row * bs, row * bs * n};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, kMapType<E>, 4, const_cast<void*>(pool), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool Q8, typename E>
int launch_chunk(const void* q, const void* k, const void* v, const float* ks, const float* vs,
                 const int* tables, const int* positions, float* out, float* part,
                 int* counters, int bn, int n, int t, int M, int bs, int nb, int splits,
                 int split_keys, float scale_log2e, cudaStream_t st) {
  constexpr int keys = ChunkSmem<D, Q8>::kKeys;
  const int box_rows = bs < keys ? bs : keys;
  CUtensorMap tq, tk = {}, tv = {};
  if (!make_map<E>(&tq, q, bn, t, t, D, kChunkRows)) return kMapFailed;
  if (!Q8 && (!make_pool_map<E>(&tk, k, nb, n, bs, D, box_rows) ||
              !make_pool_map<E>(&tv, v, nb, n, bs, D, box_rows)))
    return kMapFailed;
  auto kern = paged_chunk_kernel<D, Q8, E>;
  const int smem = ChunkSmem<D, Q8>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int ctas = bn * ((t + kChunkRows - 1) / kChunkRows) * splits;
  kern<<<ctas, kWgThreads, smem, st>>>(tq, tk, tv, static_cast<const uint8_t*>(k),
                                       static_cast<const uint8_t*>(v), ks, vs, tables, positions,
                                       out, part, counters, n, bn, t, M, bs, splits, split_keys,
                                       scale_log2e);
  return cudaGetLastError();
}

// t <= 16: the split-K kernel, one row per CTA at t = 1, else 4; above:
// the tensor-core chunk kernel; q of `dtype` (1 bfloat16, 2 float16)
template <bool Q8>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int* tab, const int* pos, float* o, float* pt, int* ct, int bn, int n, int t,
           int M, int bs, int d, int nb, int splits, int split_keys, float sl2, int dtype,
           cudaStream_t st) {
  return by_dtype(dtype, [&](auto tag) {
    using E = decltype(tag);
    if (t > kMaxRows)
      return d == 64 ? launch_chunk<64, Q8, E>(q, k, v, ks, vs, tab, pos, o, pt, ct, bn, n, t, M,
                                               bs, nb, splits, split_keys, sl2, st)
                     : launch_chunk<128, Q8, E>(q, k, v, ks, vs, tab, pos, o, pt, ct, bn, n, t,
                                                M, bs, nb, splits, split_keys, sl2, st);
    if (t == 1)
      return d == 64 ? launch_split<64, 1, Q8, E>(q, k, v, ks, vs, tab, pos, o, pt, ct, bn, n, t,
                                                  M, bs, splits, split_keys, sl2, st)
                     : launch_split<128, 1, Q8, E>(q, k, v, ks, vs, tab, pos, o, pt, ct, bn, n,
                                                   t, M, bs, splits, split_keys, sl2, st);
    return d == 64 ? launch_split<64, 4, Q8, E>(q, k, v, ks, vs, tab, pos, o, pt, ct, bn, n, t,
                                                M, bs, splits, split_keys, sl2, st)
                   : launch_split<128, 4, Q8, E>(q, k, v, ks, vs, tab, pos, o, pt, ct, bn, n, t,
                                                 M, bs, splits, split_keys, sl2, st);
  });
}

// what neither entry takes; splits * split_keys must cover the table's
// M * bs slots, and more than one split needs the scratch.  The split-K
// kernel takes split_keys up to 512 (its table entries in shared memory),
// the chunk kernel any multiple of 128 (whole key tiles)
bool bad_args(const void* part, const void* counters, int b, int n, int t, int M, int bs, int d,
              int num_blocks, int splits, int split_keys) {
  const long long bn = static_cast<long long>(b) * n;
  const bool chunk = t > kMaxRows;
  const long long ctas = chunk ? bn * ((t + kChunkRows - 1) / kChunkRows) * splits : bn;
  return (d != 64 && d != 128) || t < 1 || b < 1 || n < 1 || bn > 0x7fffffffLL ||
         ctas > 0x7fffffffLL || M < 1 || num_blocks < 1 ||
         (bs != 8 && bs != 16 && bs != 32 && bs != 64 && bs != 128) ||
         split_keys < kSplitKeysUnit || (!chunk && split_keys > kMaxSplitKeys) ||
         split_keys % kSplitKeysUnit != 0 || splits < 1 || (!chunk && splits > 65535) ||
         static_cast<long long>(splits) * split_keys < static_cast<long long>(M) * bs ||
         (splits > 1 && (part == nullptr || counters == nullptr));
}

}  // namespace

extern "C" {

// q [b, n, t, d] (d = 64 or 128) over pools [num_blocks, n, bs, d] (bs =
// 8, 16, 32, 64 or 128) of one element type, `dtype` 1 bfloat16 or 2
// float16; tables int32 [b, M]; positions
// int32 [b]; out float32 [b, n, t, d].  Split s of a row group takes its
// keys [s * split_keys, (s + 1) * split_keys) (split_keys a multiple of 128,
// at most 512 for t <= 16; splits * split_keys >= M * bs).  With splits > 1,
// `part` is float32 scratch of groups * splits * rows * (d + 2) floats and
// `counters` int32 scratch of groups = b * n * ceil(t / rows) zeros, rows =
// 1 at t = 1, 4 at t <= 16 (the split-K kernel), else 64 (the chunk
// kernel's query tile); every call leaves the counters zeroed.
int paged_decode_sm90(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                      const void* positions, void* out, void* part, void* counters, int b, int n,
                      int t, int M, int bs, int d, int num_blocks, int splits, int split_keys,
                      float scale, int dtype, void* stream) {
  if (bad_args(part, counters, b, n, t, M, bs, d, num_blocks, splits, split_keys))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(q, k_pool, v_pool, nullptr, nullptr, static_cast<const int*>(tables),
                       static_cast<const int*>(positions), static_cast<float*>(out),
                       static_cast<float*>(part), static_cast<int*>(counters), b * n, n, t, M, bs,
                       d, num_blocks, splits, split_keys, scale * kLog2e, dtype,
                       static_cast<cudaStream_t>(stream));
}

// The same over int8 pools with float32 k_scale / v_scale [num_blocks, n,
// bs]; q of `dtype` (1 bfloat16, 2 float16).
int paged_decode_q8_sm90(const void* q, const void* k_pool, const void* v_pool,
                         const void* k_scale, const void* v_scale, const void* tables,
                         const void* positions, void* out, void* part, void* counters, int b,
                         int n, int t, int M, int bs, int d, int num_blocks, int splits,
                         int split_keys, float scale, int dtype, void* stream) {
  if (bad_args(part, counters, b, n, t, M, bs, d, num_blocks, splits, split_keys) ||
      k_scale == nullptr || v_scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(q, k_pool, v_pool, static_cast<const float*>(k_scale),
                      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
                      static_cast<const int*>(positions), static_cast<float*>(out),
                      static_cast<float*>(part), static_cast<int*>(counters), b * n, n, t, M, bs,
                      d, num_blocks, splits, split_keys, scale * kLog2e, dtype,
                      static_cast<cudaStream_t>(stream));
}

const char* paged_decode_sm90_error_string(int code) { return error_string(code); }

}  // extern "C"
