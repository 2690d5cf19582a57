// Causal flash attention on CUDA cores (sm_90a), float32 only: the forward
// (K3), the split backward (K4 + K5) and the fused backward (K6), head dim
// 64 or 128.  The bf16 kernels run on the tensor cores, in
// csrc/flash_attention_sm90.cu; the f32 ones stay here in full FP32
// (tensor cores would make them TF32).
//
// Replaces, for float32 inputs, the TPU kernels of
// paddlefleetx_tpu/ops/flash_attention.py:
//   _fwd_kernel       (:121, launched by _flash_fwd :179)        -> flash_fwd       (K3)
//   _dq_kernel        (:215, launched by _flash_bwd :400)        -> flash_bwd_dq    (K4)
//   _dkv_kernel       (:249, launched by _flash_bwd :416)        -> flash_bwd_dkv   (K5)
//   _bwd_fused_kernel (:305, launched by _flash_bwd_fused :359)  -> flash_bwd_fused (K6)
//
// Layout: q, k, v, out, do, dq, dk, dv are [bh, s, d] contiguous float32;
// lse and delta are float32 [bh, s].  Causal: query row r sees keys col
// <= r.
//
// What each computes (the math of the TPU kernels, not their blocking;
// the TPU kernels round p and ds to the input type before a dot, which
// in float32 changes nothing):
//  K3: s = scale * q.k (f32 sums), masked to -1e30, online softmax with
//      f32 (m, l, acc); out = acc / max(l, 1e-30), lse = m + log(max(l,
//      1e-30)) (natural log: K4-K6 read it back).
//  K4: per query tile, over the key tiles up to the diagonal:
//      p = exp(scale * q.k - lse) (0 where masked), dp = do.v,
//      ds = p * (dp - delta) * scale, dq += ds @ k.
//  K5: per key tile, over the query tiles from the diagonal on, the same
//      p and ds (the TPU's shared _bwd_tile :288): dv += p^T @ do and
//      dk += ds^T @ q.
//  K6: K5 plus dq: each (key tile, query tile) pair adds ds @ k to a
//      zeroed f32 [bh, s, d] slab with atomicAdd.  The TPU kernel could
//      read-modify-write its dq block because its grid runs in order
//      (:319-321, :345); here the key tiles of one row run at the same
//      time, so the adds are atomic and their order varies from run to
//      run.  The wrapper casts the slab to q's type afterwards.
//
// What bounds it on the card: operations.  At GPT-345M (b*h = 128 per
// micro-batch of 8, s = 1024, d = 64) the causal forward does about
// 4 * d * bh * s^2 / 2 = 17.2 GFLOP on 134 MB of float32 q/k/v/out; the
// backward 2.5x (fused) to 3.5x (split) that.  These kernels run the
// products as f32 FMAs on CUDA cores (plain FP32, no TF32).
//
// Design, a simple kernel that is right first:
//  * 64 x 64 tiles, 128 threads.  Each tile is staged in shared memory
//    as f32 (16-byte global loads, rows padded to d + 1 floats so the
//    row-wise reads of 4 or 8 distinct rows per warp hit distinct banks).
//    Thread (ty = tid / 8, tx = tid % 8) owns rows ty*4 .. ty*4+3 and
//    columns tx, tx+8, ..: a row's 8 threads are adjacent lanes, so row
//    maxima and sums are three xor-shuffles.
//  * Partial tiles (s not a multiple of 64, e.g. 40 or 200) load zeros
//    past s and mask those keys; rows past s are not written.
//  * Work per tile grows along the causal triangle, so the grid starts
//    the longest tiles first: the last query tiles for K3/K4, the first
//    key tiles for K5/K6.
//
// Plain C interface (loaded with ctypes); every entry point launches on
// the given stream and returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;        // query and key tile
constexpr int kThreads = 128;
constexpr int kLP = kB + 1;   // padded row of a [64, 64] score tile
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float row_max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 2));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 4));
}

__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  x += __shfl_xor_sync(kFull, x, 2);
  return x + __shfl_xor_sync(kFull, x, 4);
}

// Rows [r0, r0 + 64) of one head's [s, D] matrix into a padded f32 tile;
// rows at or past s are zero.
template <int D>
__device__ __forceinline__ void load_tile(const float* __restrict__ g, int r0, int s,
                                          float* __restrict__ t) {
  constexpr int kVec = 4;
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kB * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * kVec;
    float* dst = t + r * (D + 1) + c;
    if (r0 + r < s) {
      const uint4 raw = *reinterpret_cast<const uint4*>(g + static_cast<size_t>(r0 + r) * D + c);
      const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
      for (int u = 0; u < kVec; ++u) dst[u] = e[u];
    } else {
#pragma unroll
      for (int u = 0; u < kVec; ++u) dst[u] = 0.f;
    }
  }
}

// acc[i][j] = sum_k A[ty*4+i][k] * B[tx+8j][k] over padded [64, D] tiles
template <int D>
__device__ __forceinline__ void tile_dot(const float* __restrict__ A,
                                         const float* __restrict__ B, int ty, int tx,
                                         float acc[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < D; ++k) {
    float a[4], b[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * (D + 1) + k];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = B[(tx + 8 * j) * (D + 1) + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// out[i][c] += sum_j P[ty*4+i][j] * V[j][tx+8c]; P is [64, 64] padded to
// kLP, V a padded [64, D] tile.  With TRANS, P is read transposed:
// P[j][ty*4+i].
template <int D, bool TRANS>
__device__ __forceinline__ void tile_pv(const float* __restrict__ P,
                                        const float* __restrict__ V, int ty, int tx,
                                        float out[4][D / 8]) {
#pragma unroll 4
  for (int j = 0; j < kB; ++j) {
    float p[4], v[D / 8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = TRANS ? P[j * kLP + ty * 4 + i] : P[(ty * 4 + i) * kLP + j];
#pragma unroll
    for (int c = 0; c < D / 8; ++c) v[c] = V[j * (D + 1) + tx + 8 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < D / 8; ++c) out[i][c] = fmaf(p[i], v[c], out[i][c]);
  }
}

template <int D>
__host__ __device__ constexpr size_t tile_floats() { return static_cast<size_t>(kB) * (D + 1); }

// ---------------------------------------------------------------------------
// K3: forward
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int bh, int s, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + tile_floats<D>();
  float* sV = sK + tile_floats<D>();
  float* sP = sV + tile_floats<D>();
  const int ntiles = (s + kB - 1) / kB;
  const int qi = ntiles - 1 - static_cast<int>(blockIdx.x) / bh;
  const int b = static_cast<int>(blockIdx.x) % bh;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const size_t base = static_cast<size_t>(b) * s * D;
  const int q0 = qi * kB;

  load_tile<D>(q + base, q0, s, sQ);
  float m[4], l[4], acc[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;
  }
  const int kv_end = min(s, q0 + kB);
  const int nkv = (kv_end + kB - 1) / kB;
  for (int j = 0; j < nkv; ++j) {
    const int k0 = j * kB;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(k + base, k0, s, sK);
    load_tile<D>(v + base, k0, s, sV);
    __syncthreads();
    float sc[4][8];
    tile_dot<D>(sQ, sK, ty, tx, sc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = k0 + tx + 8 * jj;
        sc[i][jj] = (col <= row && col < s) ? scale * sc[i][jj] : kNegInf;
        mx = fmaxf(mx, sc[i][jj]);
      }
      const float m_new = fmaxf(m[i], row_max8(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float p = expf(sc[i][jj] - m_new);
        sum += p;
        sP[(ty * 4 + i) * kLP + tx + 8 * jj] = p;
      }
      l[i] = l[i] * alpha + row_sum8(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    tile_pv<D, false>(sP, sV, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= s) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    float* o = out + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) o[tx + 8 * c] = acc[i][c] / l_safe;
    if (tx == 0) lse[static_cast<size_t>(b) * s + row] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// K4: dq (split schedule)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int bh, int s, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + tile_floats<D>();
  float* sK = sDO + tile_floats<D>();
  float* sV = sK + tile_floats<D>();
  float* sDS = sV + tile_floats<D>();
  const int ntiles = (s + kB - 1) / kB;
  const int qi = ntiles - 1 - static_cast<int>(blockIdx.x) / bh;
  const int b = static_cast<int>(blockIdx.x) % bh;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const size_t base = static_cast<size_t>(b) * s * D;
  const int q0 = qi * kB;

  load_tile<D>(q + base, q0, s, sQ);
  load_tile<D>(dout + base, q0, s, sDO);
  float lse_r[4], delta_r[4], acc[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse_r[i] = row < s ? lse[static_cast<size_t>(b) * s + row] : 0.f;
    delta_r[i] = row < s ? delta[static_cast<size_t>(b) * s + row] : 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;
  }
  const int kv_end = min(s, q0 + kB);
  const int nkv = (kv_end + kB - 1) / kB;
  for (int j = 0; j < nkv; ++j) {
    const int k0 = j * kB;
    __syncthreads();
    load_tile<D>(k + base, k0, s, sK);
    load_tile<D>(v + base, k0, s, sV);
    __syncthreads();
    float sc[4][8], dp[4][8];
    tile_dot<D>(sQ, sK, ty, tx, sc);
    tile_dot<D>(sDO, sV, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = k0 + tx + 8 * jj;
        const float p = (col <= row && col < s && row < s)
                            ? expf(scale * sc[i][jj] - lse_r[i]) : 0.f;
        sDS[(ty * 4 + i) * kLP + tx + 8 * jj] =
            p * (dp[i][jj] - delta_r[i]) * scale;
      }
    }
    __syncthreads();
    tile_pv<D, false>(sDS, sK, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= s) continue;
    float* o = dq + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) o[tx + 8 * c] = acc[i][c];
  }
}

// ---------------------------------------------------------------------------
// K5 (FUSED = false) and K6 (FUSED = true): per key tile, sweep the query
// tiles from the diagonal on
// ---------------------------------------------------------------------------

template <int D, bool FUSED>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq32, float* __restrict__ dk, float* __restrict__ dv,
                     int bh, int s, float scale) {
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + tile_floats<D>();
  float* sQ = sV + tile_floats<D>();
  float* sDO = sQ + tile_floats<D>();
  float* sPT = sDO + tile_floats<D>();  // [key][query], p
  float* sDST = sPT + kB * kLP;         // [key][query], ds
  float* sLSE = sDST + kB * kLP;
  float* sDelta = sLSE + kB;
  const int ntiles = (s + kB - 1) / kB;
  const int kj = static_cast<int>(blockIdx.x) / bh;
  const int b = static_cast<int>(blockIdx.x) % bh;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const size_t base = static_cast<size_t>(b) * s * D;
  const int k0 = kj * kB;

  load_tile<D>(k + base, k0, s, sK);
  load_tile<D>(v + base, k0, s, sV);
  float dk_acc[4][D / 8], dv_acc[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int qt = kj; qt < ntiles; ++qt) {  // causal: query tiles from the diagonal on
    const int q0 = qt * kB;
    __syncthreads();
    load_tile<D>(q + base, q0, s, sQ);
    load_tile<D>(dout + base, q0, s, sDO);
    if (threadIdx.x < kB) {
      const int row = q0 + threadIdx.x;
      sLSE[threadIdx.x] = row < s ? lse[static_cast<size_t>(b) * s + row] : 0.f;
      sDelta[threadIdx.x] = row < s ? delta[static_cast<size_t>(b) * s + row] : 0.f;
    }
    __syncthreads();
    {
      float st[4][8], dpt[4][8];  // rows: keys ty*4+i; cols: queries tx+8jj
      tile_dot<D>(sK, sQ, ty, tx, st);
      tile_dot<D>(sV, sDO, ty, tx, dpt);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + ty * 4 + i;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int qc = tx + 8 * jj;
          const int row = q0 + qc;
          const float p = (col <= row && row < s && col < s)
                              ? expf(scale * st[i][jj] - sLSE[qc]) : 0.f;
          const float ds = p * (dpt[i][jj] - sDelta[qc]) * scale;
          sPT[(ty * 4 + i) * kLP + qc] = p;
          sDST[(ty * 4 + i) * kLP + qc] = ds;
        }
      }
    }
    __syncthreads();
    tile_pv<D, false>(sPT, sDO, ty, tx, dv_acc);
    tile_pv<D, false>(sDST, sQ, ty, tx, dk_acc);
    if (FUSED) {
      // dq rows q0 + ty*4+i: sum over this tile's keys of ds^T @ k
      float dq_t[4][D / 8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < D / 8; ++c) dq_t[i][c] = 0.f;
      tile_pv<D, true>(sDST, sK, ty, tx, dq_t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
        if (row >= s) continue;
        float* o = dq32 + base + static_cast<size_t>(row) * D;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) atomicAdd(o + tx + 8 * c, dq_t[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= s) continue;
    float* ok = dk + base + static_cast<size_t>(row) * D;
    float* ov = dv + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      ok[tx + 8 * c] = dk_acc[i][c];
      ov[tx + 8 * c] = dv_acc[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem() { return (3 * tile_floats<D>() + kB * kLP) * sizeof(float); }
template <int D>
constexpr size_t dq_smem() { return (4 * tile_floats<D>() + kB * kLP) * sizeof(float); }
template <int D>
constexpr size_t dkv_smem() {
  return (4 * tile_floats<D>() + 2 * kB * kLP + 2 * kB) * sizeof(float);
}

// every kernel here takes more than the default 48 KB of shared memory
template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

bool bad_shape(int bh, int s, int d) {
  return bh < 1 || s < 1 || (d != 64 && d != 128) ||
         static_cast<long long>(bh) * ((s + kB - 1) / kB) > 0x7fffffffLL;
}

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out, void* lse, int bh,
                int s, float scale, cudaStream_t st) {
  auto kern = flash_fwd_kernel<D>;
  const size_t smem = fwd_smem<D>();
  const int grid = bh * ((s + kB - 1) / kB);
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, st>>>(static_cast<const float*>(q),
                                     static_cast<const float*>(k),
                                     static_cast<const float*>(v), static_cast<float*>(out),
                                     static_cast<float*>(lse), bh, s, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int bh, int s, float scale,
                   cudaStream_t st) {
  auto kern = flash_bwd_dq_kernel<D>;
  const size_t smem = dq_smem<D>();
  const int grid = bh * ((s + kB - 1) / kB);
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), bh, s, scale);
  return cudaGetLastError();
}

template <int D, bool FUSED>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dq32, void* dk, void* dv,
                    int bh, int s, float scale, cudaStream_t st) {
  auto kern = flash_bwd_dkv_kernel<D, FUSED>;
  const size_t smem = dkv_smem<D>();
  const int grid = bh * ((s + kB - 1) / kB);
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq32), static_cast<float*>(dk), static_cast<float*>(dv), bh, s,
      scale);
  return cudaGetLastError();
}

// dtype: 0 = float32 (bf16 runs on the tensor cores: csrc/flash_attention_sm90.cu)
#define PFX_DISPATCH_F32(dtype, d, CALL)                          \
  do {                                                            \
    if (dtype == 0 && d == 64) { constexpr int D = 64; return static_cast<int>(CALL); } \
    if (dtype == 0 && d == 128) { constexpr int D = 128; return static_cast<int>(CALL); } \
    return static_cast<int>(cudaErrorInvalidValue);               \
  } while (0)

}  // namespace

extern "C" {

// float32 only: out [bh, s, d], lse float32 [bh, s]
int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int bh,
              int s, int d, float scale, int dtype, void* stream) {
  if (bad_shape(bh, s, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PFX_DISPATCH_F32(dtype, d, (fwd<D>(q, k, v, out, lse, bh, s, scale, st)));
}

// float32 only: dq [bh, s, d]
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dq, int bh, int s, int d,
                 float scale, int dtype, void* stream) {
  if (bad_shape(bh, s, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PFX_DISPATCH_F32(dtype, d, (bwd_dq<D>(q, k, v, dout, lse, delta, dq, bh, s, scale, st)));
}

// float32 only: dk, dv [bh, s, d]
int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dk, void* dv, int bh, int s,
                  int d, float scale, int dtype, void* stream) {
  if (bad_shape(bh, s, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PFX_DISPATCH_F32(dtype, d, (bwd_dkv<D, false>(q, k, v, dout, lse, delta, nullptr, dk,
                                                    dv, bh, s, scale, st)));
}

// float32 only: dq32 float32 [bh, s, d], zeroed by the caller and
// accumulated with atomics; dk, dv [bh, s, d]
int flash_bwd_fused(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dq32, void* dk, void* dv,
                    int bh, int s, int d, float scale, int dtype, void* stream) {
  if (bad_shape(bh, s, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PFX_DISPATCH_F32(dtype, d, (bwd_dkv<D, true>(q, k, v, dout, lse, delta, dq32, dk, dv,
                                                   bh, s, scale, st)));
}

const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
