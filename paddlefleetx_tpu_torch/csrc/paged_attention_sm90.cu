// Paged decode / verify attention at head dim 64 or 128 on Hopper (sm_90a),
// for bfloat16 q over bfloat16 pools or over int8 pools with per-slot scales.
//
// Replaces, for bfloat16 q at d in {64, 128}, t <= 16 and block sizes 8, 16,
// 32, 64 or 128, the TPU kernel of paddlefleetx_tpu/ops/decode_attention.py:
//   _paged_kernel (:524, launched by _paged_pallas :646) -> paged_decode_sm90 (bf16 pools)
//                                                        -> paged_decode_q8_sm90 (int8 pools)
// csrc/paged_attention.cu keeps float32 q, other head dims and block sizes,
// and t > 16 (ops/decode_attention.paged_kernel_route).
//
// What it computes (the contract of csrc/paged_attention.cu, unchanged): q
// [b, n, t, d] holds a chunk of t queries per row; query r of row i sits at
// logical slot positions[i] + r and attends over the row's logical slots col
// <= positions[i] + r, where slot col lives in pool block tables[i, col / bs]
// at offset col % bs (pools [num_blocks, n, bs, d]).  Online softmax with
// float32 state; out float32 [b, n, t, d] = acc / max(l, 1e-30).  bf16 pools:
// the probabilities are rounded to bf16 before p @ v (the Pallas kernel's
// p.astype(v.dtype)).  int8 pools: the scores are multiplied by k_scale per
// key, and p * v_scale stays in float32 (nothing is rounded).  Scales
// [num_blocks, n, bs] float32 are indexed by pool block, like the payload.
//
// What bounds it on the card: device-memory bytes.  A decode step reads each
// row's visible K/V once, 2 * n * d bytes a key per pool byte (plus 8 bytes
// of scales a key for int8), for 4 * d operations a key and head: far under
// the ridge, so the tensor cores are not used.
//
// Design, against that bound:
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
//    stage holds 8 KB of K and of V (DecGeom: 64 / 32 keys of bf16 at d = 64
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
// Plain C interface (loaded with ctypes); every entry point launches on the
// given stream and returns a CUDA error code after its launch.  tables and
// positions are int32 device arrays; the table entries a row reads must lie
// in [0, num_blocks) (the engine checks its host tables before each upload).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kMaxRows = 16;        // t up to this
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
// (else bf16 pools, scales null).  Pools are read as bytes: a pool row is
// G::kRow bytes.
template <int D, int R, bool Q8>
__global__ void __launch_bounds__(kDecThreads)
paged_decode_split_kernel(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k_pool,
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
  split_load_q<D, R, Q8>(q + (static_cast<size_t>(bn) * t + r0) * D, nrows, sub, qf);
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
    split_stage<D, R, Q8>(smem + G::kK + st * G::kTile, smem + G::kV + st * G::kTile,
                          reinterpret_cast<const float*>(smem + G::kScl) + st * 2 * G::kKeys,
                          stream, sub, c0, min(G::kKeys, hi - c0), pos0, nrows, scale_log2e, qf,
                          m, l, acc);
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

template <int D, int R, bool Q8>
int launch_split(const void* q, const void* k, const void* v, const float* ks, const float* vs,
                 const int* tables, const int* positions, float* out, float* part,
                 int* counters, int bn, int n, int t, int M, int bs, int splits, int split_keys,
                 float scale_log2e, cudaStream_t st) {
  auto kern = paged_decode_split_kernel<D, R, Q8>;
  const int smem = PagedSmem<D, Q8>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bn, splits, (t + R - 1) / R);
  kern<<<grid, kDecThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(v), ks, vs, tables, positions, out, part, counters, n, t, M,
      bs, split_keys, scale_log2e);
  return cudaGetLastError();
}

// one row per CTA at t = 1, else 4
template <bool Q8>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int* tab, const int* pos, float* o, float* pt, int* ct, int bn, int n, int t,
           int M, int bs, int d, int splits, int split_keys, float sl2, cudaStream_t st) {
  if (t == 1)
    return d == 64 ? launch_split<64, 1, Q8>(q, k, v, ks, vs, tab, pos, o, pt, ct, bn, n, t, M,
                                             bs, splits, split_keys, sl2, st)
                   : launch_split<128, 1, Q8>(q, k, v, ks, vs, tab, pos, o, pt, ct, bn, n, t, M,
                                              bs, splits, split_keys, sl2, st);
  return d == 64 ? launch_split<64, 4, Q8>(q, k, v, ks, vs, tab, pos, o, pt, ct, bn, n, t, M, bs,
                                           splits, split_keys, sl2, st)
                 : launch_split<128, 4, Q8>(q, k, v, ks, vs, tab, pos, o, pt, ct, bn, n, t, M,
                                            bs, splits, split_keys, sl2, st);
}

// what neither entry takes; splits * split_keys must cover the table's
// M * bs slots, and more than one split needs the scratch
bool bad_args(const void* part, const void* counters, int b, int n, int t, int M, int bs, int d,
              int num_blocks, int splits, int split_keys) {
  const long long bn = static_cast<long long>(b) * n;
  return (d != 64 && d != 128) || t < 1 || t > kMaxRows || b < 1 || n < 1 ||
         bn > 0x7fffffffLL || M < 1 || num_blocks < 1 ||
         (bs != 8 && bs != 16 && bs != 32 && bs != 64 && bs != 128) ||
         split_keys < kSplitKeysUnit || split_keys > kMaxSplitKeys ||
         split_keys % kSplitKeysUnit != 0 || splits < 1 || splits > 65535 ||
         static_cast<long long>(splits) * split_keys < static_cast<long long>(M) * bs ||
         (splits > 1 && (part == nullptr || counters == nullptr));
}

}  // namespace

extern "C" {

// bfloat16 q [b, n, t, d] (d = 64 or 128, t <= 16) over bfloat16 pools
// [num_blocks, n, bs, d] (bs = 8, 16, 32, 64 or 128); tables int32 [b, M];
// positions int32 [b]; out float32 [b, n, t, d].  Split s of a row takes its
// keys [s * split_keys, (s + 1) * split_keys) (split_keys a multiple of 128,
// at most 512; splits * split_keys >= M * bs).  With splits > 1, `part` is
// float32 scratch of groups * splits * rows * (d + 2) floats and `counters`
// int32 scratch of groups = b * n * ceil(t / rows) zeros, rows = 1 at t = 1,
// else 4; every call leaves the counters zeroed.
int paged_decode_sm90(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                      const void* positions, void* out, void* part, void* counters, int b, int n,
                      int t, int M, int bs, int d, int num_blocks, int splits, int split_keys,
                      float scale, void* stream) {
  if (bad_args(part, counters, b, n, t, M, bs, d, num_blocks, splits, split_keys))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(q, k_pool, v_pool, nullptr, nullptr, static_cast<const int*>(tables),
                       static_cast<const int*>(positions), static_cast<float*>(out),
                       static_cast<float*>(part), static_cast<int*>(counters), b * n, n, t, M, bs,
                       d, splits, split_keys, scale * kLog2e, static_cast<cudaStream_t>(stream));
}

// The same over int8 pools with float32 k_scale / v_scale [num_blocks, n, bs].
int paged_decode_q8_sm90(const void* q, const void* k_pool, const void* v_pool,
                         const void* k_scale, const void* v_scale, const void* tables,
                         const void* positions, void* out, void* part, void* counters, int b,
                         int n, int t, int M, int bs, int d, int num_blocks, int splits,
                         int split_keys, float scale, void* stream) {
  if (bad_args(part, counters, b, n, t, M, bs, d, num_blocks, splits, split_keys) ||
      k_scale == nullptr || v_scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(q, k_pool, v_pool, static_cast<const float*>(k_scale),
                      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
                      static_cast<const int*>(positions), static_cast<float*>(out),
                      static_cast<float*>(part), static_cast<int*>(counters), b * n, n, t, M, bs,
                      d, splits, split_keys, scale * kLog2e, static_cast<cudaStream_t>(stream));
}

const char* paged_decode_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
