// Hopper (sm_90a) building blocks shared by the port's kernels:
// shared-memory addresses, mbarriers, TMA loads / stores / reduce-adds and
// bulk groups, wgmma (bf16 or f16 in, float32 accumulators) with its 128-byte
// swizzled shared-memory descriptors, the accumulator-to-A-fragment
// packing, the pieces of the tensor-core attention tiles (a key tile's
// online softmax, int8 tiles widened to bf16 or f16, the output rows), the
// split-K decode pieces (bulk copies, the bf16, f16 and int8 widening, a
// stage's scores and online softmax, the merge of the splits) and the
// host's route to cuTensorMapEncodeTiled, its tensor maps and the element
// type of a dtype code.
//
// Included by csrc/flash_attention_sm90.cu (K3-K6),
// csrc/decode_attention_sm90.cu (K7, K8) and csrc/paged_attention_sm90.cu
// (K9); each builds into its own library, so everything here has internal
// linkage.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// PTX wrappers: shared-memory addresses, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of the given parity has completed.  A wait of more
// than kWaitLimitNs traps: a lost transfer or arrival then ends the launch
// with an error instead of hanging the card.
constexpr uint64_t kWaitLimitNs = 20000000000ull;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(addr, parity))
    if (global_ns() - t0 > kWaitLimitNs) __trap();
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// a 4-D box (coordinates innermost first)
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0,
                                          int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_reduce_add(const CUtensorMap* map, const void* src, int c0,
                                               int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the issuing thread's bulk groups have finished reading shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// the issuing thread's bulk groups have completed
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory become visible to TMA and wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across this point (after wgmma_wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (K-major: rows 128 bytes
// apart, 8-row groups `sbo` apart; MN-major: 64-element chunks `lbo`
// apart, 8-row groups along K `sbo` apart), layout 1 = 128B swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (static_cast<uint64_t>(1) << 62);
}

// byte offset of byte `col_byte` of row `row` in a tile of 128-byte rows
// stored with TMA's 128-byte swizzle (16-byte chunk index XOR row % 8);
// the tile starts on a 1024-byte boundary
__device__ __forceinline__ uint32_t sw128(int row, int col_byte) {
  return row * 128 + ((((col_byte >> 4) ^ (row & 7)) << 4) | (col_byte & 15));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the element type E of a wgmma operand: bfloat16 or float16 (both 2
// bytes, so tiles, swizzles and descriptors are the same for both)
template <typename E>
constexpr bool kIsF16 = std::is_same<E, __half>::value;

// two float32 values rounded to nearest into a pair of E (an overflow
// becomes inf), the lower index in the low half
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsF16<E>)
    return pack_f16(lo, hi);
  else
    return pack_bf16(lo, hi);
}

// a pair of E (the lower index in the low half) as float32, exactly
template <typename E>
__device__ __forceinline__ float2 unpack2(uint32_t w) {
  if constexpr (kIsF16<E>)
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  else
    return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// D (+)= A.B for one k16 step, A and B of element type E (bf16 or f16),
// D float32.  ss: A and B from shared memory (TA, TB: the transpose bits,
// 1 = MN-major); rs: A from registers.  Each thread of the warpgroup holds
// N/2 floats of D: register i is row 16 * warp + lane / 4 + 8 * ((i / 2) %
// 2), column 8 * (i / 4) + 2 * (lane % 4) + i % 2.  The two types differ
// only in the instruction's .bf16 / .f16 (TY below).

#define PFX_D16                                                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),     \
  "+f"(d[14]), "+f"(d[15])

#define PFX_D32                                                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),     \
  "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),  \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),  \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define PFX_D64                                                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),     \
  "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),  \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),  \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),  \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),  \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),  \
  "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),  \
  "+f"(d[63])


#define PFX_WGMMA_SS_N32(TY)                                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                                   \
               "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "                    \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "     \
               "%16, %17, p, 1, 1, %19, %20;\n}\n"                                            \
               : PFX_D16                                                                      \
               : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))

template <int TA, int TB, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                              int scale_d) {
  if constexpr (kIsF16<E>)
    PFX_WGMMA_SS_N32("f16");
  else
    PFX_WGMMA_SS_N32("bf16");
}

#define PFX_WGMMA_SS_N64(TY)                                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                   \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                    \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
               "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "       \
               "%31}, "                                                                       \
               "%32, %33, p, 1, 1, %35, %36;\n}\n"                                            \
               : PFX_D32                                                                      \
               : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))

template <int TA, int TB, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                              int scale_d) {
  if constexpr (kIsF16<E>)
    PFX_WGMMA_SS_N64("f16");
  else
    PFX_WGMMA_SS_N64("bf16");
}

#define PFX_WGMMA_SS_N128(TY)                                                                 \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                   \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "                   \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
               "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
               "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "  \
               "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "  \
               "%62, %63}, "                                                                  \
               "%64, %65, p, 1, 1, %67, %68;\n}\n"                                            \
               : PFX_D64                                                                      \
               : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))

template <int TA, int TB, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  if constexpr (kIsF16<E>)
    PFX_WGMMA_SS_N128("f16");
  else
    PFX_WGMMA_SS_N128("bf16");
}

#define PFX_WGMMA_RS_N64(TY)                                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                   \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                    \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
               "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "       \
               "%31}, "                                                                       \
               "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"                                \
               : PFX_D32                                                                      \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB))

template <int TB, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
  if constexpr (kIsF16<E>)
    PFX_WGMMA_RS_N64("f16");
  else
    PFX_WGMMA_RS_N64("bf16");
}

#define PFX_WGMMA_RS_N128(TY)                                                                 \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                   \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "                   \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
               "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
               "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "  \
               "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "  \
               "%62, %63}, "                                                                  \
               "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"                                \
               : PFX_D64                                                                      \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB))

template <int TB, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
  if constexpr (kIsF16<E>)
    PFX_WGMMA_RS_N128("f16");
  else
    PFX_WGMMA_RS_N128("bf16");
}

#undef PFX_WGMMA_SS_N32
#undef PFX_WGMMA_SS_N64
#undef PFX_WGMMA_SS_N128
#undef PFX_WGMMA_RS_N64
#undef PFX_WGMMA_RS_N128
#undef PFX_D16
#undef PFX_D32
#undef PFX_D64

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// pack rows of float32 probabilities (an m64nNk16 accumulator) into the
// A fragments (element type E, bf16 or f16) of the next product: 16
// columns per k16 step
template <int KS, typename E = __nv_bfloat16>
__device__ __forceinline__ void to_a_frags(const float* x, uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack2<E>(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack2<E>(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack2<E>(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack2<E>(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// the key (row of the K tile) of accumulator register i of an m64nNk16
// product
__device__ __forceinline__ int key_of(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// ---------------------------------------------------------------------------
// tensor-core attention tiles (K7/K8's prefill, K9's chunks): one warpgroup
// on a 64-row query tile; thread t holds rows r_in = 16 * warp + lane / 4
// and r_in + 8 (h = (i >> 1) & 1 of accumulator register i)
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;
constexpr int kQBox = 64 * 128;  // bytes of a [64 rows, 64 2-byte values] box

// One key tile's online softmax in the log2 domain: sc holds S = Q.K^T of
// the tile (scale not yet applied, masked scores already -inf); a row's
// values sit in a quad.  Leaves p = exp2(s * scale_log2e - m) in sc and
// rescales l and the output accumulator o by the change of m.
template <int NS, int NO>
__device__ __forceinline__ void tile_softmax(float (&sc)[NS], float (&o)[NO], float (&m)[2],
                                             float (&l)[2], float scale_log2e) {
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
  for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// out = o / max(l, 1e-30) in float32 for the tile's rows q0 + r of one
// head's [t, D] output rows, rows at or past t dropped
template <int D>
__device__ __forceinline__ void store_tile_rows(const float (&o)[D / 2], const float (&l)[2],
                                                float* out_head, int q0, int t, int r_in,
                                                int lane) {
  float l_safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) l_safe[h] = fmaxf(l[h], 1e-30f);
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int h = (i >> 1) & 1;
    const int row = q0 + r_in + 8 * h;
    if (row < t) {
      const int col = 8 * (i >> 2) + 2 * (lane & 3);
      *reinterpret_cast<float2*>(out_head + static_cast<size_t>(row) * D + col) =
          make_float2(o[i] / l_safe[h], o[i + 1] / l_safe[h]);
    }
  }
}

// float32 values x (an m64nNk16 accumulator) as the bf16 A fragments of
// their high parts bf16(x) and of their low parts bf16(x - bf16(x))
template <int KS>
__device__ __forceinline__ void to_a_frags_split(const float* x, uint32_t (&hi)[KS][4],
                                                 uint32_t (&lo)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = x[8 * kk + 2 * i], b = x[8 * kk + 2 * i + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(h);
      hi[kk][i] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][i] = pack_bf16(a - hf.x, b - hf.y);
    }
}

// ---------------------------------------------------------------------------
// split-K decode (K7, K8 and K9 at t <= 16): a CTA of four warps streams its
// share of one (row, head)'s keys through a ring of bulk copies; a lane group
// takes one key at a time, 16 bytes of its row per lane, and keeps its own
// float32 (m, l, acc) for R query rows, in the log2 domain
// ---------------------------------------------------------------------------

constexpr int kDecThreads = 128;
constexpr int kDecStages = 4;    // the bulk-copy ring
constexpr int kKeysPerGroup = 4;  // keys a lane group takes from each stage

// Q8: int8 caches with float32 scales; else bf16 or f16 (2 bytes a value)
template <int D, bool Q8>
struct DecGeom {
  static constexpr int kPer = Q8 ? 16 : 8;             // values of a key row per lane: 16 bytes
  static constexpr int kLanesPerKey = D / kPer;
  static constexpr int kGroups = 32 / kLanesPerKey;  // lane groups per warp
  static constexpr int kStreams = 4 * kGroups;       // lane groups per CTA
  static constexpr int kKeys = kStreams * kKeysPerGroup;  // a stage: 2-byte 64 / 32, int8 128 / 64
  static constexpr int kRow = Q8 ? D : 2 * D;         // bytes of a key row
  static constexpr int kTile = kKeys * kRow;          // bytes of K (or V) per stage: 8 KB
  static constexpr int kK = 0;                        // kDecStages stages
  static constexpr int kV = kDecStages * kTile;       // kDecStages stages
  static constexpr int kScl = 2 * kDecStages * kTile;  // int8: k_scale, v_scale [kKeys] a stage
  static constexpr int kBar = kScl + (Q8 ? kDecStages * 2 * kKeys * 4 : 0);  // kDecStages mbarriers
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

// the 8 E (bf16: a shift into a float32's high half; f16: a conversion) of
// a 16-byte chunk as float32, exactly (the low half is the lower index)
template <typename E>
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = unpack2<E>(w[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// p rounded to nearest in E and back: the Pallas kernels' p.astype(v.dtype)
// before P.V
template <typename E>
__device__ __forceinline__ float round_to(float p) {
  if constexpr (kIsF16<E>)
    return __half2float(__float2half_rn(p));
  else
    return __bfloat162float(__float2bfloat16(p));
}

// the 16 int8 of a 16-byte chunk as float32 (byte i is value i): each byte,
// biased to unsigned, becomes the low mantissa byte of 2^23, and 2^23 + 128
// is subtracted; exact, and a permute and an add where a conversion
// instruction runs at a quarter of the rate
__device__ __forceinline__ void unpack16_s8(const uint4& u, float (&f)[16]) {
  const uint32_t w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u, u.z ^ 0x80808080u,
                         u.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[4 * i + b] = __uint_as_float(__byte_perm(w[i], 0x4b000000u, 0x7540u | b)) - 8388736.0f;
}

// int8 rows [KEYS, D] at `raw` (rows at or past `cnt` read as zeros) into
// [KEYS, 64] boxes of E (bf16 or f16) at `dst` in TMA's 128-byte swizzle,
// the layout the wgmma descriptors read; the warpgroup's threads widen 16
// values of a row each (exact: int8 values are bf16 and f16 values)
template <int D, int KEYS, typename E>
__device__ __forceinline__ void widen_tile(const uint8_t* raw, uint8_t* dst, int cnt) {
  constexpr int kChunks = D / 16;
  for (int i = threadIdx.x; i < KEYS * kChunks; i += kWgThreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
    if (r < cnt) {
      float f[16];
      unpack16_s8(*reinterpret_cast<const uint4*>(raw + r * D + 16 * c), f);
      a = make_uint4(pack2<E>(f[0], f[1]), pack2<E>(f[2], f[3]), pack2<E>(f[4], f[5]),
                     pack2<E>(f[6], f[7]));
      b = make_uint4(pack2<E>(f[8], f[9]), pack2<E>(f[10], f[11]), pack2<E>(f[12], f[13]),
                     pack2<E>(f[14], f[15]));
    }
    uint8_t* box = dst + (16 * c / 64) * KEYS * 128;
    const int col_byte = 2 * (16 * c % 64);
    *reinterpret_cast<uint4*>(box + sw128(r, col_byte)) = a;
    *reinterpret_cast<uint4*>(box + sw128(r, col_byte + 16)) = b;
  }
}

// 16 bytes of a key row at p as float32: 8 E (bf16 or f16) or 16 int8
template <bool Q8, typename E, int P>
__device__ __forceinline__ void load_row(const uint8_t* p, float (&f)[P]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  if constexpr (Q8)
    unpack16_s8(u, f);
  else
    unpack8<E>(u, f);
}

// the lane's 16-byte slices of the CTA's R query rows of q [bn, t, D] of
// element type E as float32 (zeros past nrows)
template <int D, int R, bool Q8, typename E>
__device__ __forceinline__ void split_load_q(const E* q_rows, int nrows, int sub,
                                             float (&qf)[R][DecGeom<D, Q8>::kPer]) {
  constexpr int P = DecGeom<D, Q8>::kPer;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < nrows) {
      const uint4* qp = reinterpret_cast<const uint4*>(q_rows + r * D + sub * P);
#pragma unroll
      for (int h = 0; h < P / 8; ++h) {
        float f8[8];
        unpack8<E>(qp[h], f8);
#pragma unroll
        for (int e = 0; e < 8; ++e) qf[r][8 * h + e] = f8[e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < P; ++e) qf[r][e] = 0.f;
    }
  }
}

// One stage of the ring: key j of the stage (row j of kt / vt) is key c0 + j;
// the first cnt are the CTA's, and row r sees keys up to pos0 + r.  kss: the
// stage's k_scale[kKeys] then v_scale[kKeys] (int8).  E: the element type of
// a native cache (bf16 or f16; unused for int8).  A masked score is
// selected away, never multiplied, and a slot past cnt is never multiplied
// into acc: stale or NaN bytes there cannot reach the output.
template <int D, int R, bool Q8, typename E>
__device__ __forceinline__ void split_stage(const uint8_t* kt, const uint8_t* vt,
                                            const float* kss, int stream, int sub, int c0,
                                            int cnt, int pos0, int nrows, float scale_log2e,
                                            const float (&qf)[R][DecGeom<D, Q8>::kPer],
                                            float (&m)[R], float (&l)[R],
                                            float (&acc)[R][DecGeom<D, Q8>::kPer]) {
  using G = DecGeom<D, Q8>;
  constexpr int P = G::kPer;
  // scores of this group's keys: key j of the stage is 16 bytes per lane
  float sc[kKeysPerGroup][R];
#pragma unroll
  for (int kk = 0; kk < kKeysPerGroup; ++kk) {
    const int j = stream + G::kStreams * kk;
    float kf[P];
    load_row<Q8, E>(kt + j * G::kRow + sub * 16, kf);
    const float sl2 = Q8 ? scale_log2e * kss[j] : scale_log2e;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < P; ++e) dot = fmaf(qf[r][e], kf[e], dot);
#pragma unroll
      for (int o = 1; o < G::kLanesPerKey; o <<= 1) dot += __shfl_xor_sync(kFull, dot, o);
      const bool ok = j < cnt && r < nrows && c0 + j <= pos0 + r;
      sc[kk][r] = ok ? dot * sl2 : -INFINITY;
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
    for (int e = 0; e < P; ++e) acc[r][e] *= alpha;
    m[r] = m_new;
  }
  // acc += p_E . v (native, p rounded to E) or (p * v_scale) . v (int8, p *
  // v_scale in float32)
#pragma unroll
  for (int kk = 0; kk < kKeysPerGroup; ++kk) {
    const int j = stream + G::kStreams * kk;
    if (j < cnt) {  // a slot past cnt holds stale bytes: never multiplied
      float vf[P];
      load_row<Q8, E>(vt + j * G::kRow + sub * 16, vf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = Q8 ? sc[kk][r] * kss[G::kKeys + j] : round_to<E>(sc[kk][r]);
#pragma unroll
        for (int e = 0; e < P; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
      }
    }
  }
}

// The end of a split-K CTA, once its ring is idle.  Its lane groups merge by
// xor butterflies (every lane gets the same bits), then its four warps in
// warp order through `red` (shared memory, 4 * R * (D + 2) floats).  With one
// active split of the CTA's (row, head, row group), it writes its nrows rows
// of out_rows [.., D]; else it writes its float32 partial (acc, m, l per row)
// to group_part + split * R * (D + 2), and the last of the `active` splits to
// bump *counter (an integer, no float atomics) combines all partials in split
// order and resets the counter for the next call: the same bits every call.
template <int D, int R, bool Q8>
__device__ __forceinline__ void split_finish(float (&m)[R], float (&l)[R],
                                             float (&acc)[R][DecGeom<D, Q8>::kPer], float* red,
                                             int* last, float* out_rows, int nrows,
                                             float* group_part, int* counter, int split,
                                             int active) {
  using G = DecGeom<D, Q8>;
  constexpr int P = G::kPer;
  constexpr int ldr = D + 2;  // a partial row: acc[D], m, l
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = lane % G::kLanesPerKey;
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
      for (int e = 0; e < P; ++e) {
        const float ao = __shfl_xor_sync(kFull, acc[r][e], o);
        acc[r][e] = acc[r][e] * fa + ao * fb;
      }
      m[r] = mm;
    }
  }
  if (lane < G::kLanesPerKey) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float* row = red + (warp * R + r) * ldr;
#pragma unroll
      for (int e = 0; e < P; ++e) row[sub * P + e] = acc[r][e];
      if (sub == 0) {
        row[D] = m[r];
        row[D + 1] = l[r];
      }
    }
  }
  __syncthreads();
  float* mine = active > 1 ? group_part + split * R * ldr : nullptr;
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
    if (active == 1) {
      if (r < nrows) out_rows[r * D + c] = num / fmaxf(den, 1e-30f);
    } else {
      mine[r * ldr + c] = num;
      if (c == 0) {
        mine[r * ldr + D] = mm;
        mine[r * ldr + D + 1] = den;
      }
    }
  }
  if (active == 1) return;

  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *last = atomicAdd(counter, 1) == active - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  for (int e = threadIdx.x; e < R * D; e += kDecThreads) {
    const int r = e / D, c = e - r * D;
    if (r >= nrows) continue;
    float mm = kNegInf;
    for (int sp = 0; sp < active; ++sp) mm = fmaxf(mm, __ldcg(group_part + (sp * R + r) * ldr + D));
    float den = 0.f, num = 0.f;
    for (int sp = 0; sp < active; ++sp) {
      const float* row = group_part + (sp * R + r) * ldr;
      const float f = exp2f(__ldcg(row + D) - mm);
      den += __ldcg(row + D + 1) * f;
      num += __ldcg(row + c) * f;
    }
    out_rows[r * D + c] = num / fmaxf(den, 1e-30f);
  }
  if (threadIdx.x == 0) *counter = 0;  // ready for the next call
}

// ---------------------------------------------------------------------------
// host: cuTensorMapEncodeTiled, from libcuda, and the error strings
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; the runtime hands out its
// address, so the library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int kMapFailed = 10001;  // cuTensorMapEncodeTiled refused a map

// the tensor-map data type of an element type
template <typename T>
constexpr CUtensorMapDataType kMapType =
    std::is_same<T, float>::value
        ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
        : (kIsF16<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);

// a 3-D map over [bn, rows, d] of E (bf16 or f16; innermost first): `rows`
// rows readable per head (rows past it read as zeros), heads `head_rows`
// rows apart, with a [box_rows, 64] box and 128-byte swizzle
template <typename E>
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
  return encode(map, kMapType<E>, 3, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the element type of a dtype code (1 bfloat16, 2 float16), as a tag
template <typename F>
int by_dtype(int dtype, F&& f) {
  if (dtype == 1) return f(__nv_bfloat16{});
  if (dtype == 2) return f(__half{});
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* error_string(int code) {
  if (code == kMapFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace
