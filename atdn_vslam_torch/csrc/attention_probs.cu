// Attention probabilities P = softmax(scale * q k^T), written once in
// the spatial layout the GMA update loop reads: (B, N, N_pad), which is
// (B, H, W, N_pad) in memory, with the columns N_kv..N_pad-1 exact zeros.
//
// Replaces the TPU kernel atdn_vslam_tpu/ops/attention.py:
// flash_probs_spatial (_probs_stats_kernel, _probs_write_kernel).
//
// Bound on an H100 at the KITTI main-path shape (B = 1, N = 7238,
// D = 128, bf16): the probabilities are 7238 x 7296 x 2 B = 105.6 MB,
// 31.5 us of writes at 3.35 TB/s, against 13.4 GFLOP (13.6 us at the
// bf16 tensor-core peak) for one q k^T. The kernel is bound by the
// bytes it writes, so its design spends compute to write each
// probability exactly once and never stores a score:
//   pass 1 (probs_stats_kernel): one block per 64 query rows walks all
//     key tiles, staged in shared memory, and keeps the row max m and
//     the exp-sum l online (the TPU's sequential key grid becomes a
//     loop inside the block);
//   pass 2 (probs_write_kernel): one block per (64 queries, 64 keys)
//     tile recomputes the scores and writes exp(s - m) / l in q's type.
// bf16 tiles go through the tensor cores (WMMA 16x16x16, float32
// accumulation); float32 tiles through plain FMA. wgmma, TMA and a
// fused single pass are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math_constants.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // keys per tile
constexpr int THREADS = 128;  // four warps
constexpr int KPAD = 8;       // shared-memory row padding of q/k tiles (elements)
constexpr int LDS = BN + 4;   // row stride of the float score tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [row0, row0 + 64) of a row-major (n, d) matrix into shared
// memory with row stride d + KPAD; rows >= n are zero-filled
template <typename T>
__device__ void load_tile(const T* __restrict__ g, int n, int d, int row0, T* s) {
  constexpr int PER = 16 / sizeof(T);
  const int vecs = d / PER;
  const int ld = d + KPAD;
  for (int i = threadIdx.x; i < BM * vecs; i += THREADS) {
    const int r = i / vecs, c = (i % vecs) * PER;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) v = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * d + c);
    *reinterpret_cast<uint4*>(s + r * ld + c) = v;
  }
}

// S[64][LDS] = qs . ks^T (unscaled), bf16 through the tensor cores:
// warp w owns score rows 16w .. 16w + 15
__device__ void scores_tile(const __nv_bfloat16* qs, const __nv_bfloat16* ks, float* S, int d) {
  const int warp = threadIdx.x / 32;
  const int ld = d + KPAD;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int kk = 0; kk < d; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::load_matrix_sync(a, qs + warp * 16 * ld + kk, ld);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      // B = k^T: element (kk, key) sits at ks[key * ld + kk], i.e. column-major
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(b, ks + j * 16 * ld + kk, ld);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
    wmma::store_matrix_sync(S + warp * 16 * LDS + j * 16, acc[j], LDS, wmma::mem_row_major);
}

// the same for float32 with plain FMA: thread (ty, tx) of a 8 x 16
// layout owns rows 8ty .. 8ty + 7 and columns tx + 16j
__device__ void scores_tile(const float* qs, const float* ks, float* S, int d) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ld = d + KPAD;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int kk = 0; kk < d; ++kk) {
    float a[8], b[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = qs[(ty * 8 + i) * ld + kk];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * ld + kk];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) S[(ty * 8 + i) * LDS + tx + 16 * j] = acc[i][j];
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ void carve(unsigned char* smem, int d, T*& qs, T*& ks, float*& S) {
  qs = reinterpret_cast<T*>(smem);
  ks = qs + BM * (d + KPAD);
  S = reinterpret_cast<float*>(ks + BN * (d + KPAD));
}

// pass 1: per query row, m = max_j s_ij and l = sum_j exp(s_ij - m)
template <typename T>
__global__ void __launch_bounds__(THREADS)
probs_stats_kernel(const T* __restrict__ q, const T* __restrict__ k, float* __restrict__ m_out,
                   float* __restrict__ l_out, int n, int n_kv, int d, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  T *qs, *ks;
  float* S;
  carve(smem, d, qs, ks, S);
  const int b = blockIdx.y, row0 = blockIdx.x * BM;
  q += (size_t)b * n * d;
  k += (size_t)b * n_kv * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile(q, n, d, row0, qs);
  float m_run[16], l_run[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    m_run[i] = -CUDART_INF_F;
    l_run[i] = 0.0f;
  }
  for (int col0 = 0; col0 < n_kv; col0 += BN) {
    __syncthreads();  // the previous tile's scores are consumed
    load_tile(k, n_kv, d, col0, ks);
    __syncthreads();
    scores_tile(qs, ks, S, d);
    __syncthreads();
    const bool ok0 = col0 + lane < n_kv, ok1 = col0 + lane + 32 < n_kv;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float* srow = S + (warp * 16 + i) * LDS;
      const float s0 = ok0 ? srow[lane] * scale : -CUDART_INF_F;
      const float s1 = ok1 ? srow[lane + 32] * scale : -CUDART_INF_F;
      const float m_new = fmaxf(m_run[i], warp_max(fmaxf(s0, s1)));
      const float e = warp_sum(__expf(s0 - m_new) + __expf(s1 - m_new));
      l_run[i] = l_run[i] * __expf(m_run[i] - m_new) + e;
      m_run[i] = m_new;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int row = row0 + warp * 16 + i;
      if (row < n) {
        m_out[(size_t)b * n + row] = m_run[i];
        l_out[(size_t)b * n + row] = l_run[i];
      }
    }
  }
}

// pass 2: recompute one 64 x 64 score tile and write its probabilities
template <typename T>
__global__ void __launch_bounds__(THREADS)
probs_write_kernel(const T* __restrict__ q, const T* __restrict__ k, const float* __restrict__ m_in,
                   const float* __restrict__ l_in, T* __restrict__ out, int n, int n_kv, int n_pad,
                   int d, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float ms[BM], inv_l[BM];
  T *qs, *ks;
  float* S;
  carve(smem, d, qs, ks, S);
  const int b = blockIdx.z, row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  T* ob = out + (size_t)b * n * n_pad;
  if (col0 >= n_kv) {  // a tile of pad columns: exact zeros
    for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
      const int row = row0 + i / BN, col = col0 + i % BN;
      if (row < n && col < n_pad) ob[(size_t)row * n_pad + col] = from_float<T>(0.0f);
    }
    return;
  }
  q += (size_t)b * n * d;
  k += (size_t)b * n_kv * d;
  load_tile(q, n, d, row0, qs);
  load_tile(k, n_kv, d, col0, ks);
  if (threadIdx.x < BM) {
    const int row = min(row0 + (int)threadIdx.x, n - 1);
    ms[threadIdx.x] = m_in[(size_t)b * n + row];
    inv_l[threadIdx.x] = 1.0f / l_in[(size_t)b * n + row];
  }
  __syncthreads();
  scores_tile(qs, ks, S, d);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int row = row0 + r, col = col0 + c;
    if (row >= n || col >= n_pad) continue;
    const float p = col < n_kv ? __expf(S[r * LDS + c] * scale - ms[r]) * inv_l[r] : 0.0f;
    ob[(size_t)row * n_pad + col] = from_float<T>(p);
  }
}

template <typename T>
int launch(const void* q, const void* k, float* m, float* l, void* out, int b, int n, int n_kv,
           int n_pad, int d, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(BM + BN) * (d + KPAD) * sizeof(T) + (size_t)BM * LDS * sizeof(float);
  cudaFuncSetAttribute(probs_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncSetAttribute(probs_write_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  probs_stats_kernel<T><<<dim3((n + BM - 1) / BM, b), THREADS, smem, stream>>>(
      qt, kt, m, l, n, n_kv, d, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  probs_write_kernel<T><<<dim3(n_pad / BN, (n + BM - 1) / BM, b), THREADS, smem, stream>>>(
      qt, kt, m, l, static_cast<T*>(out), n, n_kv, n_pad, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (b, n, d), k (b, n_kv, d) contiguous, both bf16 (is_bf16 = 1) or
// float32; m, l float32 scratch of b * n entries; out (b, n, n_pad) in
// q's type. Requires d % 16 == 0, d <= 256, n_pad % 64 == 0 and
// n_pad >= n_kv >= 1. Returns a cudaError_t (0 on success).
extern "C" int atdn_attention_probs(const void* q, const void* k, void* m, void* l, void* out, int b,
                                    int n, int n_kv, int n_pad, int d, float scale, int is_bf16,
                                    int device, void* stream) {
  if (d % 16 != 0 || d > 256 || n_pad % BN != 0 || n_pad < n_kv || n_kv < 1 || n < 1 || b < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto st = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  if (is_bf16) return launch<__nv_bfloat16>(q, k, mf, lf, out, b, n, n_kv, n_pad, d, scale, st);
  return launch<float>(q, k, mf, lf, out, b, n, n_kv, n_pad, d, scale, st);
}
