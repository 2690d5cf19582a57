// Causal flash attention on Hopper's tensor cores (sm_90a): every bfloat16
// and float16 kernel of the family, the forward (K3), the split backward
// (K4 dq, K5 dk/dv) and the fused backward (K6), head dim 64 or 128.
//
// Replaces, for bfloat16 and float16 inputs, the TPU kernels of
// paddlefleetx_tpu/ops/flash_attention.py:
//   _fwd_kernel       (:121, launched by _flash_fwd :179)        -> flash_fwd_sm90       (K3)
//   _dq_kernel        (:215, launched by _flash_bwd :400)        -> flash_bwd_dq_sm90    (K4)
//   _dkv_kernel       (:249, launched by _flash_bwd :416)        -> flash_bwd_dkv_sm90   (K5)
//   _bwd_fused_kernel (:305, launched by _flash_bwd_fused :359)  -> flash_bwd_fused_sm90 (K6)
// csrc/flash_attention.cu keeps the float32 K3-K6 (full FP32 on CUDA
// cores: tensor cores would make them TF32).
//
// Layout: q, k, v, out, do, dq, dk, dv are [bh, s, d] contiguous, all of
// one element type T (bfloat16 or float16); lse and delta float32 [bh, s];
// dq32 a zeroed float32 [bh, s, d] slab.  Causal: query row r sees keys
// col <= r.
//
// The element type: every kernel is a template on T.  Both types are 2
// bytes, so the TMA boxes, swizzles, descriptors and shared-memory layouts
// are the same; what changes is the wgmma instruction (.bf16 / .f16), the
// roundings to T (p, ds and the outputs, as the TPU kernels round p to
// v.dtype and ds to q.dtype), the tensor maps' data type and K3's parity
// window (near_boundary: f16 keeps 3 more mantissa bits, so its rounding
// boundaries are 8x denser, and below 2^-14 a subnormal's fixed step).
// Float16 roundings are to nearest and overflow to inf: under a loss scale
// a ds past 65504 must reach the grads as inf, so the step is skipped.
//
// The math is the TPU kernels' (and the plain versions' in
// ops/flash_attention.py), only the blocking is Hopper's:
//  K3: s = scale * q.k (float32 sums of exact products), masked to
//      -1e30; online softmax per 128-key tile with float32 (m, l, acc):
//      m_new = max(m, rowmax), p = exp(s - m_new), alpha = exp(m -
//      m_new), l = l * alpha + sum p, acc = acc * alpha + p_T @ v;
//      out = acc / max(l, 1e-30) in T, lse = m + log(max(l, 1e-30))
//      in float32 (natural log: the backward kernels read it back).
//  K4: per 128-row query tile, over the 64-key tiles up to the diagonal:
//      p = exp(scale * q.k - lse) left in float32 (0 where masked), ds =
//      p * (do.v - delta) * scale rounded to T, dq += ds @ k in float32
//      registers for the whole sweep, written once in T.
//  K5: per 128-key tile, over the 64-row query tiles from the diagonal
//      on: the same p and ds, both rounded to T; dv += p^T @ do, dk +=
//      ds^T @ q in float32 registers for the whole sweep.
//  K6: K5, and dq += ds @ k added to the float32 slab by TMA
//      reduce-adds.  The TPU kernel could read-modify-write its dq block
//      because its grid runs in order; here the key tiles of one head run
//      at the same time, so the adds are reductions in L2 whose order
//      varies from run to run.
//
// What bounds them: operations.  At the GPT-345M training shape (b*h =
// 128 per micro-batch of 8, s = 1024, d = 64) the causal forward does 4d
// operations per (query, key) pair, 17.2 GFLOP (17 us at 989 TFLOP/s bf16
// against 20 us to move its 67 MB: bytes by a hair), the fused backward
// 10d, 43 GFLOP (44 us against 31 us of bytes); the split backward's K4
// 6d (26 us) and K5 8d (35 us).  The CUDA-core kernels they replace ran
// at ~25 TFLOP/s; only the tensor cores can move them.
//
// Design:
//  * wgmma: every product runs on the tensor cores as warpgroup
//    wgmma.mma_async (bf16 in, float32 accumulators in registers).  The
//    softmax's P and the backward's P^T and dS^T stay in registers and
//    feed the next product as its A operand: the accumulator layout of
//    an m64nNk16 result is the A-fragment layout of the next product, so
//    they are only rounded to bf16 and packed in pairs.
//  * TMA: tiles arrive by cp.async.bulk.tensor from 3-D tensor maps over
//    [bh, s, d] (a box never crosses into the next head; rows past s read
//    as zeros) with 128-byte swizzle (a bf16 row of 64 is 128 bytes; d =
//    128 is two 64-column boxes), which is the layout the wgmma
//    descriptors read without bank conflicts.  The maps are built on the
//    host per call (cuTensorMapEncodeTiled of libcuda, its address from
//    the runtime, so the library links cudart only) and passed as
//    __grid_constant__ parameters.
//  * Roles: 288 threads.  Warpgroups 0 and 1 compute, each on 64 rows
//    (wgmma's M); one thread of warp 8 keeps the TMA loads of a 2-stage
//    ring (3 for K4) in flight, with a full and an empty mbarrier per stage.  (A
//    third warpgroup would not buy registers: ptxas holds every thread of
//    a CTA of more than 8 warps to 168 registers, setmaxnreg or not.)
//  * K3: a CTA takes 128 query rows of one head.  Q [128, d] is loaded
//    once; K and V tiles of 128 keys stream through the ring.  S = Q.K^T
//    is m64n128k16 with both operands K-major in shared memory; P.V takes
//    P from registers and V as an MN-major B (the transpose bit), into a
//    fresh accumulator per tile that is then added as the plain version
//    adds it, o = o * alpha + p.v.  Only the diagonal tile is masked,
//    tiles past it are never loaded.  out leaves through the Q tile's
//    shared memory and a TMA store (rows past s are clipped); lse is
//    written per row.
//  * K3's roundings: the plain version sums each score in index order and
//    rounds p to bf16 before p.v; the tensor cores sum in another order, a
//    few float32 ulps away, and the bulk of p comes from exp2 of those
//    scores.  Wherever that could flip p's bf16 rounding (its float32 bits
//    within kBoundaryUlps of a rounding boundary), p is computed again as
//    the plain version computes it, expf(x - m), with the score and the
//    row's running max summed in index order on CUDA cores.  A warp's
//    requests are spread over its lanes through a mailbox in shared memory:
//    one dot product's latency per tile.  So K3's bf16 outputs differ from
//    the plain version's about as rarely as a CUDA-core kernel's did.
//  * K6: a CTA owns 128 keys (64 per warpgroup); its K and V stay in
//    shared memory for the whole sweep, while Q, dO and the rows' lse and
//    delta come through the ring.  Per query tile each warpgroup computes
//    S^T = K.Q^T and dP^T = V.dO^T (m64n64k16, shared memory), P^T and
//    dS^T in registers, dV += P^T.dO and dK += dS^T.Q (A from registers,
//    B MN-major).  dS^T goes to shared memory (bf16, double-buffered);
//    after a barrier of the two warpgroups each computes half of dQ's
//    columns, dQ = dS.K over all 128 keys (A read transposed from shared
//    memory), stages it in shared memory and adds it to the slab with one
//    TMA reduce-add per 32-column box: 16 KB per (key tile, query tile)
//    pair instead of 4096 scalar atomics per 64 x 64 pair.  Query row 0
//    sees key 0 alone, so out[0] = v[0] exactly and dp - delta there is 0
//    in exact arithmetic; summed in two orders it leaves rounding noise
//    that would be all of dq's row 0.  bf16: the plain version's product
//    and a sum in index order give the same dp (bf16 products are 16-bit),
//    so that one dot product is summed in index order here (dp = delta
//    would cost K4 15%: ptxas schedules it worse without the loop).
//    float16 products carry 22 bits and no order agrees with the
//    plain version's; there the kernels and the plain versions take dp =
//    delta at (0, 0), so ds[0, 0] is exactly 0.
//  * K5 is K6's kernel with the dq half compiled out (kDq = false): no
//    dS^T staging, no barrier between the warpgroups, no dQ product and no
//    reduce-adds, so each warpgroup's sweep runs on its own.  The row-0
//    rule stays, since ds[0, 0] feeds dk[0].
//  * K4: a CTA takes 128 query rows of one head (64 per warpgroup).  Q
//    and dO [128, d] are loaded once; K and V tiles of 64 keys stream
//    through a 3-stage ring, up to the diagonal (warpgroup 0 skips the
//    last tile, all of it above its rows).  Per tile S = Q.K^T and dP =
//    dO.V^T (m64n64k16, K-major operands), then dQ += dS.K with dS from
//    registers and K as an MN-major B.  64-key tiles keep S, dP and dQ
//    (32 + 32 + d / 2 floats) within the 168 registers a thread has.  dQ
//    leaves once, in bf16, through the Q tile's shared memory and a TMA
//    store: no slab, no atomics, the same result every run.  Query row 0
//    gets K6's rule; p is not rounded (the TPU's
//    _dq_kernel leaves it in float32), and it is computed as the plain
//    version rounds it, scale * s then - lse, unfused.
//  * Work per CTA grows along the causal triangle, so the grid starts
//    the longest ones first: the last query tiles for K3 and K4, the first
//    key tiles for K5 and K6.
//
// Plain C interface (loaded with ctypes); every entry point launches on
// the given stream and returns a CUDA error code (or kMapFailed) after its
// launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kConsumers = 256;    // warpgroups 0 and 1 compute
constexpr int kThreads = kConsumers + 32;  // warp 8 loads
constexpr int kStages = 2;

// ---------------------------------------------------------------------------
// K3: forward
// ---------------------------------------------------------------------------

constexpr int kBox = 128 * 128;  // bytes of a [128 rows, 64 T] box

template <int D>
struct FwdSmem {
  static constexpr int kBoxes = D / 64;
  static constexpr int kTile = kBoxes * kBox;  // [128, D] bf16
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;         // kStages tiles
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kMail = kBar + 64;           // 256 bytes per consumer warp
  static constexpr int kBytes = kMail + 8 * 256 + 1024;  // + slack to align the base to 1024
};

// K3's roundings (see the header): a p whose float32 bits lie within
// kBoundaryUlps of a rounding boundary of T is computed again from scores
// summed in index order.  The window covers the tensor cores' summation
// order, the exp2 of the bulk and the running max taken from tensor-core
// scores: a few ulps to a few tens of ulps each.
constexpr int kBoundaryUlps = 96;

template <typename T>
__device__ __forceinline__ bool near_boundary(float p) {
  if constexpr (kIsF16<T>) {
    // the midpoint of the two float16 values around p (exact in float32;
    // p itself when it is one), within kBoundaryUlps float32 ulps of p
    const float lo = __half2float(__float2half_rd(p)), hi = __half2float(__float2half_ru(p));
    const int dist = static_cast<int>(__float_as_uint(p)) -
                     static_cast<int>(__float_as_uint(0.5f * (lo + hi)));
    return lo != hi && dist <= kBoundaryUlps && dist >= -kBoundaryUlps;
  } else {
    // the low 16 bits within kBoundaryUlps of 0x8000, where bf16 rounding flips
    return ((__float_as_uint(p) + (0x8000u + kBoundaryUlps)) & 0xffffu) <= 2u * kBoundaryUlps;
  }
}

// q.k of row qr of a Q tile in shared memory (D / 64 swizzled 64-column
// boxes kBox apart) and a K row in global memory, summed in index order
template <int D, typename T>
__device__ __forceinline__ float dot_in_order(const uint8_t* qt, int qr,
                                              const T* __restrict__ krow) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const uint4 a = *reinterpret_cast<const uint4*>(qt + (c / 8) * kBox + sw128(qr, (c % 8) * 16));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(krow) + c);
    const uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {  // pairs: the low half is the lower index
      const float2 x = unpack2<T>(av[w]), y = unpack2<T>(bv[w]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
  return acc;
}

// For each register i flagged in `redo` (row h = (i / 2) % 2 of this
// lane's two), p = expf(x - m) with x = scale * q.k of its key and m =
// scale * q.k of the row's running-max key mkey[h], both summed in index
// order; apply(i, p) runs in the lane that owns i.  The warp's requests
// (two per flag) are spread over its 32 lanes through a mailbox in shared
// memory, so a batch of 32 costs one dot product's latency however the
// flags fall.
template <int D, typename T, typename F>
__device__ __forceinline__ void redo_p_in_order(uint64_t redo, uint32_t* box,
                                                const uint8_t* q_rows, int r_in,
                                                const T* __restrict__ k_head,
                                                int k0, const int (&mkey)[2], int lane,
                                                float scale, F apply) {
  const int cnt = 2 * __popcll(redo);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  const int base = incl - cnt;  // even, so a flag's two requests share a batch
  float* res = reinterpret_cast<float*>(box + 32);
  for (int b0 = 0; b0 < total; b0 += 32) {
    uint64_t left = redo;
    for (int k = base; left != 0; k += 2) {  // post: (row of the Q tile, key)
      const int i = __ffsll(static_cast<long long>(left)) - 1;
      left &= left - 1;
      if (k >= b0 && k < b0 + 32) {
        const uint32_t row = r_in + 8 * ((i >> 1) & 1);
        box[k - b0] = row | static_cast<uint32_t>(k0 + key_of(i, lane)) << 6;
        box[k + 1 - b0] = row | static_cast<uint32_t>(mkey[(i >> 1) & 1]) << 6;
      }
    }
    __syncwarp();
    if (b0 + lane < total) {
      const uint32_t req = box[lane];
      res[lane] = dot_in_order<D, T>(q_rows, req & 63, k_head + static_cast<size_t>(req >> 6) * D);
    }
    __syncwarp();
    left = redo;
    for (int k = base; left != 0; k += 2) {  // collect
      const int i = __ffsll(static_cast<long long>(left)) - 1;
      left &= left - 1;
      if (k >= b0 && k < b0 + 32)  // rounded as the plain version's sc - m_new, unfused
        apply(i, expf(__fsub_rn(__fmul_rn(scale, res[k - b0]), __fmul_rn(scale, res[k + 1 - b0]))));
    }
    __syncwarp();
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
           const T* __restrict__ k, float* __restrict__ lse, int bh, int s,
           float scale) {
  using L = FwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kStages;
  const int ntq = (s + 127) / 128;
  const int qi = ntq - 1 - static_cast<int>(blockIdx.x) / bh;  // longest rows first
  const int b = static_cast<int>(blockIdx.x) % bh;
  const int q0 = qi * 128;
  const int nkv = qi + 1;  // key tiles up to the diagonal
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer warp
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(bar_q, L::kTile);
      for (int c = 0; c < L::kBoxes; ++c)
        tma_load(smem + L::kQ + c * kBox, &tm_q, bar_q, 64 * c, q0, b);
      for (int j = 0; j < nkv; ++j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(empty + st, ((j / kStages) - 1) & 1);
        mbar_expect_tx(full + st, 2 * L::kTile);
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load(smem + L::kK + st * L::kTile + c * kBox, &tm_k, full + st, 64 * c, 128 * j, b);
          tma_load(smem + L::kV + st * L::kTile + c * kBox, &tm_v, full + st, 64 * c, 128 * j, b);
        }
      }
    }
  } else {  // consumers: warpgroup 0 takes rows q0 .. q0 + 63, warpgroup 1 the next 64
    const int half = wg;
    const int t = threadIdx.x - 128 * wg;
    const int lane = t % 32;
    const int r_in = 16 * (t / 32) + lane / 4;  // row in the half (+ 8 for h = 1)
    const int row0 = q0 + 64 * half + r_in;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    int mkey[2] = {0, 0};  // the key of each row's running max
    const T* k_head = k + static_cast<size_t>(b) * s * D;
    const uint8_t* q_rows = smem + L::kQ + 64 * 128 * half;
    uint32_t* mail = reinterpret_cast<uint32_t*>(smem + L::kMail + 256 * (threadIdx.x / 32));
    const uint32_t q_half = smem_u32(q_rows);
    mbar_wait(bar_q, 0);
    for (int j = 0; j < nkv; ++j) {
      const int st = j % kStages;
      mbar_wait(full + st, (j / kStages) & 1);
      const uint32_t k_s = smem_u32(smem + L::kK + st * L::kTile);
      const uint32_t v_s = smem_u32(smem + L::kV + st * L::kTile);
      // S = Q.K^T: [64 rows, 128 keys], K-major operands, d in k16 steps
      float sc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
        wgmma_ss_n128<0, 0, T>(sc, sw128_desc(q_half + off, 16, 1024),
                            sw128_desc(k_s + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(sc);
      // online softmax: a row's 128 values sit in the 4 lanes of a quad
      const int k0 = 128 * j;
      if (j == nkv - 1) {  // the diagonal tile, and the only one crossing s
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int col = k0 + key_of(i, lane);
          if (col > row0 + 8 * ((i >> 1) & 1) || col >= s) sc[i] = -INFINITY;
        }
      }
      // the running max m (as the plain version's scale * q.k) and its key
      float best[2] = {-INFINITY, -INFINITY};
      int arg[2] = {0, 0};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int h = (i >> 1) & 1;
        if (sc[i] > best[h]) {
          best[h] = sc[i];
          arg[h] = i;
        }
      }
      float alpha[2], neg_mlog[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float top = best[h];
        int key = k0 + key_of(arg[h], lane);
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {  // quad argmax, ties to the lower key
          const float other = __shfl_xor_sync(kFull, top, o);
          const int other_key = __shfl_xor_sync(kFull, key, o);
          if (other > top || (other == top && other_key < key)) {
            top = other;
            key = other_key;
          }
        }
        const float x = scale * top;
        if (x > m[h]) mkey[h] = key;
        const float m_new = fmaxf(m[h], x);
        alpha[h] = expf(m[h] - m_new);
        m[h] = m_new;
        neg_mlog[h] = -m_new * kLog2e;
      }
      // p = exp(scale * s - m) by exp2, and as the plain version computes
      // it next to a rounding boundary of T
      const float scale_log2e = scale * kLog2e;
      uint64_t redo = 0;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        sc[i] = exp2f(fmaf(sc[i], scale_log2e, neg_mlog[(i >> 1) & 1]));
        if (near_boundary<T>(sc[i])) redo |= 1ull << i;
      }
      redo_p_in_order<D, T>(redo, mail, q_rows, r_in, k_head, k0, mkey, lane, scale,
                         [&](int at, float p) {
#pragma unroll
                           for (int i = 0; i < 64; ++i)
                             if (i == at) sc[i] = p;
                         });
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[(i >> 1) & 1] += sc[i];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(kFull, sum[h], 1);
        sum[h] += __shfl_xor_sync(kFull, sum[h], 2);
        l[h] = __fadd_rn(__fmul_rn(l[h], alpha[h]), sum[h]);
      }
      // pv = P_T.V on this tile: P from registers, V [keys, d] an MN-major
      // B; then o = o * alpha + pv, rounded as the plain version rounds
      uint32_t pf[8][4];
      to_a_frags<8, T>(sc, pf);
      float pv[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) pv[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t bv = sw128_desc(v_s + kk * 16 * 128, kBox, 1024);
        if constexpr (D == 64)
          wgmma_rs_n64<1, T>(pv, pf[kk], bv, kk > 0);
        else
          wgmma_rs_n128<1, T>(pv, pf[kk], bv, kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(pv);
      fence_regs(pf);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = __fadd_rn(__fmul_rn(o[i], alpha[(i >> 1) & 1]), pv[i]);
      mbar_arrive(empty + st);
    }
    // epilogue: out through this half's rows of the Q tile, then a TMA store
    float l_safe[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) l_safe[h] = fmaxf(l[h], 1e-30f);
    uint8_t* ob = smem + L::kQ + 64 * 128 * half;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int h = (i >> 1) & 1;
      const int col = 8 * (i >> 2) + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(ob + (col / 64) * kBox + sw128(r_in + 8 * h, (col % 64) * 2)) =
          pack2<T>(o[i] / l_safe[h], o[i + 1] / l_safe[h]);
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row < s) lse[static_cast<size_t>(b) * s + row] = m[h] + logf(l_safe[h]);
      }
    }
    fence_proxy_async();
    named_bar_sync(1 + half, 128);
    if (t == 0) {
      for (int c = 0; c < L::kBoxes; ++c) tma_store(&tm_o, ob + c * kBox, 64 * c, q0 + 64 * half, b);
      bulk_commit();
      bulk_wait();
    }
  }
}

// ---------------------------------------------------------------------------
// K6: fused backward
// ---------------------------------------------------------------------------

// kDq: K6 (dq by TMA reduce-adds) or K5 (dk and dv only)
template <int D, bool kDq>
struct BwdSmem {
  static constexpr int kBoxes = D / 64;
  static constexpr int kKV = kBoxes * kBox;      // [128 keys, D] T
  static constexpr int kQBox = 64 * 128;         // [64 rows, 64 T]
  static constexpr int kQT = kBoxes * kQBox;     // [64 queries, D] T
  static constexpr int kDSBuf = 128 * 128;       // dS^T [128 keys, 64 queries] T
  static constexpr int kDQBox = 64 * 128;        // [64 rows, 32 float32]
  static constexpr int kDQ = (D / 64) * kDQBox;  // a warpgroup's [64, D / 2] float32
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKV;
  static constexpr int kQ = kV + kKV;             // kStages tiles
  static constexpr int kDO = kQ + kStages * kQT;  // kStages tiles
  static constexpr int kDS = kDO + kStages * kQT; // 2 buffers (K6)
  static constexpr int kDQs = kDS + (kDq ? 2 * kDSBuf : 0);  // 2 warpgroups (K6)
  static constexpr int kStat = kDQs + (kDq ? 2 * kDQ : 0);   // kStages x (lse[64], delta[64])
  static constexpr int kBar = kStat + kStages * 128 * 4;
  static constexpr int kBytes = kBar + 64 + 1024;
};

template <int D, bool kDq, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_kv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
           const __grid_constant__ CUtensorMap tm_dq, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk,
           T* __restrict__ dv, int bh, int s, float scale) {
  using L = BwdSmem<D, kDq>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + kStages;
  float* stats = reinterpret_cast<float*>(smem + L::kStat);
  const int ntq = (s + 63) / 64;
  const int kj = static_cast<int>(blockIdx.x) / bh;  // longest sweeps first
  const int b = static_cast<int>(blockIdx.x) % bh;
  const int k0 = kj * 128;
  const int it0 = 2 * kj;      // the query tile that holds row k0
  const int nq = ntq - it0;    // query tiles from the diagonal on
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1 + 32);  // the TMA's expect_tx and the producer warp's 32 lanes
      mbar_init(empty + i, kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer warp: K, V once; Q, dO by TMA and lse, delta by its lanes per tile
    {
      const int lane = threadIdx.x - kConsumers;
      if (lane == 0) {
        mbar_expect_tx(bar_kv, 2 * L::kKV);
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load(smem + L::kK + c * kBox, &tm_k, bar_kv, 64 * c, k0, b);
          tma_load(smem + L::kV + c * kBox, &tm_v, bar_kv, 64 * c, k0, b);
        }
      }
      for (int it = 0; it < nq; ++it) {
        const int st = it % kStages;
        const int q0 = 64 * (it0 + it);
        if (it >= kStages) mbar_wait(empty + st, ((it / kStages) - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(full + st, 2 * L::kQT);
          for (int c = 0; c < L::kBoxes; ++c) {
            tma_load(smem + L::kQ + st * L::kQT + c * L::kQBox, &tm_q, full + st, 64 * c, q0, b);
            tma_load(smem + L::kDO + st * L::kQT + c * L::kQBox, &tm_do, full + st, 64 * c, q0,
                     b);
          }
        }
        float* sl = stats + st * 128;
        for (int r = lane; r < 64; r += 32) {
          const int row = q0 + r;
          const bool in = row < s;
          sl[r] = in ? lse[static_cast<size_t>(b) * s + row] : 0.f;
          sl[64 + r] = in ? delta[static_cast<size_t>(b) * s + row] : 0.f;
        }
        mbar_arrive(full + st);
      }
    }
  } else {  // consumers: warpgroup 0 owns keys k0 .. k0 + 63, warpgroup 1 the next 64
    const int half = wg;
    const int t = threadIdx.x - 128 * wg;
    const int lane = t % 32;
    const int r_in = 16 * (t / 32) + lane / 4;  // key row in the half (+ 8 for h = 1)
    const int key0 = k0 + 64 * half + r_in;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const uint32_t k_half = smem_u32(smem + L::kK) + 64 * 128 * half;
    const uint32_t v_half = smem_u32(smem + L::kV) + 64 * 128 * half;
    mbar_wait(bar_kv, 0);
    for (int it = 0; it < nq; ++it) {
      const int st = it % kStages;
      const int q0 = 64 * (it0 + it);
      mbar_wait(full + st, (it / kStages) & 1);
      const uint32_t q_s = smem_u32(smem + L::kQ + st * L::kQT);
      const uint32_t do_s = smem_u32(smem + L::kDO + st * L::kQT);
      const float* sl = stats + st * 128;
      // S^T = K.Q^T and dP^T = V.dO^T: [64 keys, 64 queries], K-major operands
      float sT[32], dpT[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sT[i] = dpT[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
        const uint32_t offq = (kk / 4) * L::kQBox + (kk % 4) * 32;
        wgmma_ss_n64<0, 0, T>(sT, sw128_desc(k_half + off, 16, 1024),
                           sw128_desc(q_s + offq, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
        const uint32_t offq = (kk / 4) * L::kQBox + (kk % 4) * 32;
        wgmma_ss_n64<0, 0, T>(dpT, sw128_desc(v_half + off, 16, 1024),
                           sw128_desc(do_s + offq, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(sT);
      fence_regs(dpT);
      // Query row 0 sees key 0 alone, so out[0] = v[0] and dp - delta there
      // is 0 in exact arithmetic (the header's row-0 rule): bf16 sums that
      // one dot product in index order, as the plain version's product
      // comes out; float16 takes dp = delta, as its plain version does.
      if (q0 == 0 && key0 == 0 && lane == 0) {  // holds (key 0, query 0): register 0
        if constexpr (kIsF16<T>) {
          dpT[0] = sl[64];
        } else {
          const size_t at = static_cast<size_t>(b) * s * D;
          float acc = 0.f;
          for (int c = 0; c < D; ++c)
            acc = fmaf(__bfloat162float(dout[at + c]), __bfloat162float(v[at + c]), acc);
          dpT[0] = acc;
        }
      }
      // P^T = exp(scale * S^T - lse) (0 where masked), dS^T = P^T (dP^T - delta) scale
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = key0 + 8 * ((i >> 1) & 1);
        const int qc = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int row = q0 + qc;
        const float p = (key <= row && row < s && key < s) ? expf(scale * sT[i] - sl[qc]) : 0.f;
        dpT[i] = p * (dpT[i] - sl[64 + qc]) * scale;
        sT[i] = p;
      }
      uint32_t pf[4][4], df[4][4];
      to_a_frags<4, T>(sT, pf);
      to_a_frags<4, T>(dpT, df);
      // dV += P^T.dO and dK += dS^T.Q: A from registers, B [queries, d] MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bd = sw128_desc(do_s + kk * 16 * 128, L::kQBox, 1024);
        if constexpr (D == 64)
          wgmma_rs_n64<1, T>(dv_acc, pf[kk], bd, 1);
        else
          wgmma_rs_n128<1, T>(dv_acc, pf[kk], bd, 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bq = sw128_desc(q_s + kk * 16 * 128, L::kQBox, 1024);
        if constexpr (D == 64)
          wgmma_rs_n64<1, T>(dk_acc, df[kk], bq, 1);
        else
          wgmma_rs_n128<1, T>(dk_acc, df[kk], bq, 1);
      }
      wgmma_commit();
      if constexpr (kDq) {
        // dS^T (in T) to shared memory, [128 keys, 64 queries] with queries
        // contiguous: the MN-major A of dQ = dS.K
        uint8_t* ds_s = smem + L::kDS + (it & 1) * L::kDSBuf;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int qb = (16 * kk + 2 * (lane & 3)) * 2;
          *reinterpret_cast<uint32_t*>(ds_s + sw128(64 * half + r_in, qb)) = df[kk][0];
          *reinterpret_cast<uint32_t*>(ds_s + sw128(64 * half + r_in + 8, qb)) = df[kk][1];
          *reinterpret_cast<uint32_t*>(ds_s + sw128(64 * half + r_in, qb + 16)) = df[kk][2];
          *reinterpret_cast<uint32_t*>(ds_s + sw128(64 * half + r_in + 8, qb + 16)) = df[kk][3];
        }
        fence_proxy_async();
        named_bar_sync(1, kConsumers);  // both halves' dS^T are in
        // dQ[:, half's columns] = dS [64 queries, 128 keys] . K [128 keys, D / 2]
        const uint32_t k_cols = smem_u32(smem + L::kK) + (D == 64 ? 64 * half : kBox * half);
        float dq[D / 4];
#pragma unroll
        for (int i = 0; i < D / 4; ++i) dq[i] = 0.f;
        const uint32_t ds_a = smem_u32(ds_s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint64_t da = sw128_desc(ds_a + kk * 16 * 128, kBox, 1024);
          const uint64_t db = sw128_desc(k_cols + kk * 16 * 128, kBox, 1024);
          if constexpr (D == 64)
            wgmma_ss_n32<1, 1, T>(dq, da, db, kk > 0);
          else
            wgmma_ss_n64<1, 1, T>(dq, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(dk_acc);
        fence_regs(dv_acc);
        fence_regs(dq);
        fence_regs(pf);
        fence_regs(df);
        mbar_arrive(empty + st);  // Q, dO, lse and delta of this stage are read
        // dQ to this half's staging boxes (after the previous reduce-add has
        // read them), then one TMA reduce-add per 32-column box
        uint8_t* dq_s = smem + L::kDQs + half * L::kDQ;
        if (t == 0) bulk_wait_read();
        named_bar_sync(2 + half, 128);
#pragma unroll
        for (int i = 0; i < D / 4; i += 2) {
          const int col = 8 * (i >> 2) + 2 * (lane & 3);
          *reinterpret_cast<float2*>(dq_s + (col / 32) * L::kDQBox +
                                     sw128(r_in + 8 * ((i >> 1) & 1), (col % 32) * 4)) =
              make_float2(dq[i], dq[i + 1]);
        }
        fence_proxy_async();
        named_bar_sync(2 + half, 128);
        if (t == 0) {
          for (int c = 0; c < D / 64; ++c)
            tma_reduce_add(&tm_dq, dq_s + c * L::kDQBox, (D / 2) * half + 32 * c, q0, b);
          bulk_commit();
        }
      } else {
        wgmma_wait();
        fence_regs(dk_acc);
        fence_regs(dv_acc);
        fence_regs(pf);
        fence_regs(df);
        mbar_arrive(empty + st);  // Q, dO, lse and delta of this stage are read
      }
    }
    if (kDq && t == 0) bulk_wait();
    // dk, dv: this half's 64 key rows, rows past s not written
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int key = key0 + 8 * ((i >> 1) & 1);
      if (key >= s) continue;
      const size_t at = (static_cast<size_t>(b) * s + key) * D + 8 * (i >> 2) + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(dk + at) = pack2<T>(dk_acc[i], dk_acc[i + 1]);
      *reinterpret_cast<uint32_t*>(dv + at) = pack2<T>(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K4: dq of the split backward
// ---------------------------------------------------------------------------

constexpr int kDqStages = 3;  // 64-key tiles are small: one more in flight

template <int D>
struct DqSmem {
  static constexpr int kBoxes = D / 64;
  static constexpr int kTile = kBoxes * kBox;   // [128 rows, D] T
  static constexpr int kKBox = 64 * 128;        // [64 keys, 64 T]
  static constexpr int kKT = kBoxes * kKBox;    // [64 keys, D] T
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kTile;
  static constexpr int kK = kDO + kTile;        // kDqStages tiles
  static constexpr int kV = kK + kDqStages * kKT;
  static constexpr int kBar = kV + kDqStages * kKT;
  static constexpr int kBytes = kBar + 64 + 1024;
};

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
           const __grid_constant__ CUtensorMap tm_dq, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, int bh, int s, float scale) {
  using L = DqSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kDqStages;
  const int ntq = (s + 127) / 128;
  const int qi = ntq - 1 - static_cast<int>(blockIdx.x) / bh;  // longest rows first
  const int b = static_cast<int>(blockIdx.x) % bh;
  const int q0 = qi * 128;
  const int nkv = min(2 * qi + 2, (s + 63) / 64);  // 64-key tiles up to the diagonal
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int i = 0; i < kDqStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer warp: Q and dO once, K and V tiles through the ring
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(bar_q, 2 * L::kTile);
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load(smem + L::kQ + c * kBox, &tm_q, bar_q, 64 * c, q0, b);
        tma_load(smem + L::kDO + c * kBox, &tm_do, bar_q, 64 * c, q0, b);
      }
      for (int j = 0; j < nkv; ++j) {
        const int st = j % kDqStages;
        if (j >= kDqStages) mbar_wait(empty + st, ((j / kDqStages) - 1) & 1);
        mbar_expect_tx(full + st, 2 * L::kKT);
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load(smem + L::kK + st * L::kKT + c * L::kKBox, &tm_k, full + st, 64 * c, 64 * j, b);
          tma_load(smem + L::kV + st * L::kKT + c * L::kKBox, &tm_v, full + st, 64 * c, 64 * j, b);
        }
      }
    }
  } else {  // consumers: warpgroup 0 takes rows q0 .. q0 + 63, warpgroup 1 the next 64
    const int half = wg;
    const int t = threadIdx.x - 128 * wg;
    const int lane = t % 32;
    const int r_in = 16 * (t / 32) + lane / 4;  // row in the half (+ 8 for h = 1)
    const int row0 = q0 + 64 * half + r_in;
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      const bool in = row < s;
      lse_r[h] = in ? lse[static_cast<size_t>(b) * s + row] : 0.f;
      delta_r[h] = in ? delta[static_cast<size_t>(b) * s + row] : 0.f;
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    const uint32_t q_half = smem_u32(smem + L::kQ) + 64 * 128 * half;
    const uint32_t do_half = smem_u32(smem + L::kDO) + 64 * 128 * half;
    const int diag = 2 * qi + half;  // the key tile that holds this half's diagonal
    mbar_wait(bar_q, 0);
    for (int j = 0; j < nkv; ++j) {
      const int st = j % kDqStages;
      mbar_wait(full + st, (j / kDqStages) & 1);
      if (j <= diag) {  // past it every key is masked for this half's rows
        const uint32_t k_s = smem_u32(smem + L::kK + st * L::kKT);
        const uint32_t v_s = smem_u32(smem + L::kV + st * L::kKT);
        // S = Q.K^T and dP = dO.V^T: [64 rows, 64 keys], K-major operands
        float sc[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t offq = (kk / 4) * kBox + (kk % 4) * 32;
          const uint32_t offk = (kk / 4) * L::kKBox + (kk % 4) * 32;
          wgmma_ss_n64<0, 0, T>(sc, sw128_desc(q_half + offq, 16, 1024),
                             sw128_desc(k_s + offk, 16, 1024), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t offq = (kk / 4) * kBox + (kk % 4) * 32;
          const uint32_t offk = (kk / 4) * L::kKBox + (kk % 4) * 32;
          wgmma_ss_n64<0, 0, T>(dp, sw128_desc(do_half + offq, 16, 1024),
                             sw128_desc(v_s + offk, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(sc);
        fence_regs(dp);
        // query row 0 sees key 0 alone: K6's row-0 rule
        if (q0 == 0 && half == 0 && j == 0 && t == 0) {  // holds (row 0, key 0): register 0
          if constexpr (kIsF16<T>) {
            dp[0] = delta_r[0];
          } else {
            const size_t at = static_cast<size_t>(b) * s * D;
            float acc = 0.f;
#pragma unroll 1
            for (int c = 0; c < D; ++c)
              acc = fmaf(__bfloat162float(dout[at + c]), __bfloat162float(v[at + c]), acc);
            dp[0] = acc;
          }
        }
        // P = exp(scale * S - lse), left in float32 (0 where masked; only the
        // diagonal tile and one crossing s are), dS = P (dP - delta) scale
        const int k0 = 64 * j;
        const bool edge = j == diag || k0 + 64 > s;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int h = (i >> 1) & 1;
          const int row = row0 + 8 * h;
          const int key = k0 + key_of(i, lane);
          float p = expf(__fsub_rn(__fmul_rn(scale, sc[i]), lse_r[h]));
          if (edge && !(key <= row && row < s)) p = 0.f;
          sc[i] = p * (dp[i] - delta_r[h]) * scale;
        }
        uint32_t df[4][4];
        to_a_frags<4, T>(sc, df);
        // dQ += dS.K: A from registers, B = K [keys, d] MN-major
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t bk = sw128_desc(k_s + kk * 16 * 128, L::kKBox, 1024);
          if constexpr (D == 64)
            wgmma_rs_n64<1, T>(dq, df[kk], bk, 1);
          else
            wgmma_rs_n128<1, T>(dq, df[kk], bk, 1);
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(dq);
        fence_regs(df);
      }
      mbar_arrive(empty + st);
    }
    // epilogue: dq in T through this half's rows of the Q tile, then a
    // TMA store (rows past s are clipped)
    uint8_t* ob = smem + L::kQ + 64 * 128 * half;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int h = (i >> 1) & 1;
      const int col = 8 * (i >> 2) + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(ob + (col / 64) * kBox + sw128(r_in + 8 * h, (col % 64) * 2)) =
          pack2<T>(dq[i], dq[i + 1]);
    }
    fence_proxy_async();
    named_bar_sync(1 + half, 128);
    if (t == 0) {
      for (int c = 0; c < L::kBoxes; ++c) tma_store(&tm_dq, ob + c * kBox, 64 * c, q0 + 64 * half, b);
      bulk_commit();
      bulk_wait();
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// a 3-D map over [bh, s, d] of T (innermost first) with a [rows, cols] box
// and 128-byte swizzle; rows past s read as zeros and are not written
template <typename T>
bool flash_map(CUtensorMap* map, const void* ptr, int bh, int s, int d, int rows, int cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t elt = sizeof(T);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {d * elt, static_cast<cuuint64_t>(s) * d * elt};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols), static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, kMapType<T>, 3, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool bad_shape(int bh, int s, int d) {
  return bh < 1 || s < 1 || (d != 64 && d != 128) ||
         static_cast<long long>(bh) * ((s + 63) / 64) > 0x7fffffffLL;
}

template <int D, typename T>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse, int bh, int s,
        float scale, cudaStream_t st) {
  CUtensorMap tq, tk, tv, to;
  if (!flash_map<T>(&tq, q, bh, s, D, 128, 64) || !flash_map<T>(&tk, k, bh, s, D, 128, 64) ||
      !flash_map<T>(&tv, v, bh, s, D, 128, 64) || !flash_map<T>(&to, out, bh, s, D, 64, 64))
    return kMapFailed;
  auto kern = flash_fwd_sm90_kernel<D, T>;
  const int smem = FwdSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<bh * ((s + 127) / 128), kThreads, smem, st>>>(
      tq, tk, tv, to, static_cast<const T*>(k), static_cast<float*>(lse), bh, s, scale);
  return cudaGetLastError();
}

// K6 (kDq: dq32 a zeroed float32 slab) or K5 (dq32 unused)
template <int D, bool kDq, typename T>
int bwd_kv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq32, void* dk, void* dv, int bh, int s, float scale,
           cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo, tdq;
  if (!flash_map<T>(&tq, q, bh, s, D, 64, 64) || !flash_map<T>(&tk, k, bh, s, D, 128, 64) ||
      !flash_map<T>(&tv, v, bh, s, D, 128, 64) || !flash_map<T>(&tdo, dout, bh, s, D, 64, 64))
    return kMapFailed;
  if (!kDq)
    tdq = tq;  // not read
  else if (!flash_map<float>(&tdq, dq32, bh, s, D, 64, 32))
    return kMapFailed;
  auto kern = flash_bwd_kv_sm90_kernel<D, kDq, T>;
  const int smem = BwdSmem<D, kDq>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<bh * ((s + 127) / 128), kThreads, smem, st>>>(
      tq, tk, tv, tdo, tdq, static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), bh, s, scale);
  return cudaGetLastError();
}

template <int D, typename T>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, int bh, int s, float scale, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo, tdq;
  if (!flash_map<T>(&tq, q, bh, s, D, 128, 64) || !flash_map<T>(&tk, k, bh, s, D, 64, 64) ||
      !flash_map<T>(&tv, v, bh, s, D, 64, 64) || !flash_map<T>(&tdo, dout, bh, s, D, 128, 64) ||
      !flash_map<T>(&tdq, dq, bh, s, D, 64, 64))
    return kMapFailed;
  auto kern = flash_bwd_dq_sm90_kernel<D, T>;
  const int smem = DqSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<bh * ((s + 127) / 128), kThreads, smem, st>>>(
      tq, tk, tv, tdo, tdq, static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), bh, s, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry point takes q, k, v (and do, dq, dk, dv) of one element type,
// `dtype` 1 bfloat16 or 2 float16; lse, delta float32 [bh, s].

// q, k, v -> out [bh, s, d] in their type, lse float32 [bh, s]
int flash_fwd_sm90(const void* q, const void* k, const void* v, void* out, void* lse, int bh,
                   int s, int d, float scale, int dtype, void* stream) {
  if (bad_shape(bh, s, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    return d == 64 ? fwd<64, T>(q, k, v, out, lse, bh, s, scale, st)
                   : fwd<128, T>(q, k, v, out, lse, bh, s, scale, st);
  });
}

// dq32 float32 [bh, s, d], zeroed by the caller and accumulated with
// TMA reduce-adds; dk, dv [bh, s, d] in the input type
int flash_bwd_fused_sm90(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dq32, void* dk, void* dv,
                         int bh, int s, int d, float scale, int dtype, void* stream) {
  if (bad_shape(bh, s, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    return d == 64
               ? bwd_kv<64, true, T>(q, k, v, dout, lse, delta, dq32, dk, dv, bh, s, scale, st)
               : bwd_kv<128, true, T>(q, k, v, dout, lse, delta, dq32, dk, dv, bh, s, scale, st);
  });
}

// dq [bh, s, d] in the input type
int flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int s, int d,
                      float scale, int dtype, void* stream) {
  if (bad_shape(bh, s, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    return d == 64 ? bwd_dq<64, T>(q, k, v, dout, lse, delta, dq, bh, s, scale, st)
                   : bwd_dq<128, T>(q, k, v, dout, lse, delta, dq, bh, s, scale, st);
  });
}

// dk, dv [bh, s, d] in the input type
int flash_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh, int s,
                       int d, float scale, int dtype, void* stream) {
  if (bad_shape(bh, s, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    return d == 64
               ? bwd_kv<64, false, T>(q, k, v, dout, lse, delta, nullptr, dk, dv, bh, s, scale, st)
               : bwd_kv<128, false, T>(q, k, v, dout, lse, delta, nullptr, dk, dv, bh, s, scale,
                                       st);
  });
}

const char* flash_sm90_error_string(int code) { return error_string(code); }

}  // extern "C"
