// Attention probabilities P = softmax(scale * q k^T), written once in
// the spatial layout the GMA update loop reads: (B, N, N_pad), which is
// (B, H, W, N_pad) in memory, with the columns N_kv..N_pad-1 exact zeros.
//
// Replaces the TPU kernel atdn_vslam_tpu/ops/attention.py:
// flash_probs_spatial (_probs_stats_kernel, _probs_write_kernel).
//
// Bound on an H100 at the KITTI main-path shape (B = 1, N = N_kv = 7238,
// D = 128, bf16): the probabilities are 7238 x 7296 x 2 B = 105.6 MB,
// plus 3.7 MB of q and k read, 32.6 us at 3.35 TB/s, against 13.4 GFLOP
// for one q k^T (13.6 us at the bf16 tensor-core peak) and 52.4 M
// exponentials (~14 us at 16 per clock per SM). The kernel is bound by
// the bytes it writes, with the products and the exponentials close
// behind, so it keeps the TPU kernel's two passes (each probability is
// written exactly once, no score is ever stored) and runs both on the
// tensor cores with their exponentials between the products:
//   pass 1 (probs_stats_wgmma_kernel, statistics): one block of two
//     warpgroups per (128 query rows, key split, batch). The host picks
//     the split count S (ops/attention.py _probs_splits) so that the grid
//     fills two blocks per SM (57 x 4 at KITTI; one pass over all keys
//     would be 57 blocks on 132 SMs). q's tile is loaded once by TMA and
//     stays resident (ceil(D / 64) boxes of 128 rows x 64 channels, 64 KB
//     at D = 256); 128-key tiles of k stream through a 2-stage mbarrier
//     ring. Each warpgroup computes its 64 x 128 scores with
//     4 ceil(D / 64) wgmma m64n128k16 (K5's qk_product; TMA zero-fills the
//     channels past D, so both passes issue the same products) and keeps
//     the row max m and the sum l of 2^(x - m), x = scale log2(e) s,
//     online in registers (a row lives on the four lanes of a quad: 2
//     shuffles for the max; the sums are reduced once at the end). It
//     writes the split's partial (m, l), float32 (B, S, N) pairs, to a
//     workspace the wrapper allocates; a split with no key writes
//     (-inf, 0);
//   pass 2 (corr_dot_wgmma_kernel<SoftmaxProbs>, write): K3's core
//     (corr_dot_wgmma.cuh: one 128 x 128 tile per block, 3-stage TMA ring
//     of 64-channel boxes, wgmma, two blocks per SM, 16-byte streaming
//     row stores) with a softmax epilogue. Before the main loop each block
//     merges the S partials of its 128 rows into (m, 1/l) in shared memory
//     (weights 2^(m_s - m), splits with no key skipped); the epilogue
//     writes p = 2^(fma(s, scale log2(e), -m)) / l for columns < N_kv and
//     exact 0 for N_kv <= column < N_pad. N_pad = roundup(N_kv, 128) keeps
//     every row 16-byte aligned and no tile pad-only.
// Both passes issue the same wgmma sequence for a tile, so they see the
// same scores and use the same m. TMA zero-fills q rows >= N (never
// stored) and k rows >= N_kv (masked in both passes: a zero row would
// score 0, not -inf). float32 inputs (the GPU-vs-CPU agreement) take the
// FMA kernels below, one block per 64 rows in pass 1 and per 64 x 64
// tile in pass 2.

#include "corr_dot_wgmma.cuh"
#include <math_constants.h>

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// --- bf16 pass 1: split-KV statistics (TMA + wgmma) ------------------------

constexpr int ROWS = 128;                 // query rows per block
constexpr int KEYS = 128;                 // keys per tile
constexpr int STATS_THREADS = 256;        // two consumer warpgroups
constexpr int STATS_STAGES = 2;           // k ring depth
constexpr int BOX = ROWS * 64 * 2;        // one TMA box: 128 rows x 64 channels, 16 KB

// one tile's scores (acc, unscaled sums) into the thread's running max m
// and partial sum l of rows g and g + 8 (registers i with bit 1 clear,
// set), in units of c = scale log2(e). With MASK, keys at column >= valid
// of the tile do not count.
template <bool MASK>
__device__ __forceinline__ void stats_update(const float (&acc)[64], float (&m)[2], float (&l)[2],
                                             float c, int valid) {
  const int t = threadIdx.x % 4;
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int i = 0; i < 64; ++i)
    if (!MASK || 8 * (i >> 2) + 2 * t + (i & 1) < valid)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], acc[i] * c);
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the four lanes of a quad hold one row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r]);  // finite: every tile holds a key
    l[r] *= ex2(m[r] - mn);               // 0 while m = -inf
    m[r] = mn;
    neg_m[r] = -mn;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i)
    if (!MASK || 8 * (i >> 2) + 2 * t + (i & 1) < valid)
      l[(i >> 1) & 1] += ex2(fmaf(acc[i], c, neg_m[(i >> 1) & 1]));
}

// BOXES = ceil(D / 64) boxes of 64 channels (TMA zero-fills the columns
// past D): the 4 BOXES products of a tile are unrolled, so ptxas keeps the
// accumulator in place between them
template <int BOXES>
__global__ void __launch_bounds__(STATS_THREADS, 2)
probs_stats_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k, float2* __restrict__ ws,
                         int n, int n_kv, int splits, float c) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int stage_bytes = BOXES * BOX;
  unsigned char* qs = align1024(smem_raw);
  unsigned char* ks = qs + stage_bytes;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(ks + STATS_STAGES * stage_bytes);
  uint64_t* full = full_q + 1;
  uint64_t* empty = full + STATS_STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < STATS_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], STATS_THREADS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int row0 = blockIdx.x * ROWS, split = blockIdx.y, b = blockIdx.z;
  const int tiles = (n_kv + KEYS - 1) / KEYS;
  const int t0 = (int)((long long)split * tiles / splits);
  const int nt = (int)((long long)(split + 1) * tiles / splits) - t0;  // may be 0
  auto load = [&](int j) {  // key tile t0 + j into stage j % STATS_STAGES
    const int s = j % STATS_STAGES;
    mbar_arrive_expect_tx(&full[s], stage_bytes);
#pragma unroll
    for (int bx = 0; bx < BOXES; ++bx)
      tma_load_3d(ks + s * stage_bytes + bx * BOX, &map_k, &full[s], 64 * bx, (t0 + j) * KEYS, b);
  };
  if (tid == 0 && nt > 0) {
    mbar_arrive_expect_tx(full_q, stage_bytes);
    for (int bx = 0; bx < BOXES; ++bx) tma_load_3d(qs + bx * BOX, &map_q, full_q, 64 * bx, row0, b);
    for (int j = 0; j < STATS_STAGES && j < nt; ++j) load(j);
  }

  // warpgroup wg: rows 64 wg .. + 63 of the q tile against each key tile
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const unsigned char* qw = qs + wg * (BOX / 2);
  float acc[64], m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f};
  if (nt > 0) mbar_wait(full_q, 0);
  for (int j = 0; j < nt; ++j) {
    const int s = j % STATS_STAGES;
    const unsigned char* kt = ks + s * stage_bytes;
    mbar_wait(&full[s], (j / STATS_STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * BOXES; ++kk)
      wgmma_m64n128k16_ss<0>(acc, desc_sw128(qw + (kk / 4) * BOX + (kk % 4) * 32, 16, 1024),
                             desc_sw128(kt + (kk / 4) * BOX + (kk % 4) * 32, 16, 1024), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
    const int valid = n_kv - (t0 + j) * KEYS;  // keys of this tile that exist
    if (valid < KEYS)
      stats_update<true>(acc, m, l, c, valid);
    else
      stats_update<false>(acc, m, l, c, valid);
    if (tid == 0 && j + STATS_STAGES < nt) {  // refill once both warpgroups are done
      mbar_wait(&empty[s], (j / STATS_STAGES) & 1);
      load(j + STATS_STAGES);
    }
  }
  const int wtid = tid % 128, g = (wtid % 32) / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 64 * wg + 16 * (wtid / 32) + g + 8 * r;
    if (wtid % 4 == 0 && row < n) ws[((size_t)b * splits + split) * n + row] = make_float2(m[r], l[r]);
  }
}

int stats_smem(int d) {  // alignment slack, q, the k ring, barriers
  const int boxes = (d + 63) / 64;
  return 1024 + (1 + STATS_STAGES) * boxes * BOX + (1 + 2 * STATS_STAGES) * 8;
}

// the statistics kernel for head width d (16 <= d <= 256)
decltype(&probs_stats_wgmma_kernel<1>) stats_kernel(int d) {
  switch ((d + 63) / 64) {
    case 1: return probs_stats_wgmma_kernel<1>;
    case 2: return probs_stats_wgmma_kernel<2>;
    case 3: return probs_stats_wgmma_kernel<3>;
    default: return probs_stats_wgmma_kernel<4>;
  }
}

// --- bf16 pass 2: the write, K3's core with a softmax epilogue ---------------

struct SoftmaxProbs {
  typedef bf16 Tout;
  static constexpr int EXTRA_SMEM = 2 * corr_dot_wgmma::BM * 4;  // m and 1/l of the tile's rows
  struct Row {
    float neg_m, inv_l;
  };
  bf16* out;
  const float2* ws;  // (B, S, N) partial (m, l)
  int n, n_kv, n_pad, splits;
  float c;  // scale log2(e)

  // thread r < 128 merges the partials of row row0 + r (rows >= n take
  // row n - 1's and are never stored)
  __device__ __forceinline__ void prologue(float* extra, int row0, int b) const {
    const int r = threadIdx.x;
    if (r >= corr_dot_wgmma::BM) return;
    const float2* p = ws + (size_t)b * splits * n + min(row0 + r, n - 1);
    float mx = -CUDART_INF_F;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, p[(size_t)s * n].x);
    float sum = 0.0f;
    for (int s = 0; s < splits; ++s) {
      const float2 v = p[(size_t)s * n];
      if (v.x != -CUDART_INF_F) sum += v.y * ex2(v.x - mx);  // a split with no key adds nothing
    }
    extra[r] = -mx;
    extra[corr_dot_wgmma::BM + r] = 1.0f / sum;
  }
  __device__ __forceinline__ Row row(const float* extra, int r) const {
    return Row{extra[r], extra[corr_dot_wgmma::BM + r]};
  }
  __device__ __forceinline__ float value(float sum, Row rp, int col) const {
    return col < n_kv ? ex2(fmaf(sum, c, rp.neg_m)) * rp.inv_l : 0.0f;
  }
  __device__ __forceinline__ size_t ld() const { return (size_t)n_pad; }
  __device__ __forceinline__ int cols(int) const { return corr_dot_wgmma::BN; }
};

int launch_bf16(const void* q, const void* k, void* ws, void* out, int b, int n, int n_kv, int n_pad,
                int d, int splits, float c, cudaStream_t stream) {
  CUtensorMap map_q, map_k;
  int e = encode_bf16_3d(&map_q, q, d, n, b, 64, ROWS);
  if (e == 0) e = encode_bf16_3d(&map_k, k, d, n_kv, b, 64, KEYS);
  if (e != 0) return e;
  const int smem = stats_smem(d);
  const auto kernel = stats_kernel(d);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  float2* w = static_cast<float2*>(ws);
  kernel<<<dim3((n + ROWS - 1) / ROWS, splits, b), STATS_THREADS, smem, stream>>>(
      map_q, map_k, w, n, n_kv, splits, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const SoftmaxProbs epi{static_cast<bf16*>(out), w, n, n_kv, n_pad, splits, c};
  return corr_dot_wgmma::launch_tiles(q, k, epi, b, n, n_kv, d, stream);
}

// --- float32: plain FMA ------------------------------------------------------

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // keys per tile
constexpr int THREADS = 128;  // four warps
constexpr int KPAD = 8;       // shared-memory row padding of q/k tiles (elements)
constexpr int LDS = BN + 4;   // row stride of the float score tile

// rows [row0, row0 + 64) of a row-major (n, d) matrix into shared
// memory with row stride d + KPAD; rows >= n are zero-filled
__device__ void load_tile(const float* __restrict__ g, int n, int d, int row0, float* s) {
  const int vecs = d / 4;
  const int ld = d + KPAD;
  for (int i = threadIdx.x; i < BM * vecs; i += THREADS) {
    const int r = i / vecs, c = (i % vecs) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < n) v = *reinterpret_cast<const float4*>(g + (size_t)(row0 + r) * d + c);
    *reinterpret_cast<float4*>(s + r * ld + c) = v;
  }
}

// S[64][LDS] = qs . ks^T (unscaled): thread (ty, tx) of a 8 x 16 layout
// owns rows 8ty .. 8ty + 7 and columns tx + 16j
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

__device__ __forceinline__ void carve(unsigned char* smem, int d, float*& qs, float*& ks, float*& S) {
  qs = reinterpret_cast<float*>(smem);
  ks = qs + BM * (d + KPAD);
  S = ks + BN * (d + KPAD);
}

// pass 1: per query row, m = max_j s_ij and l = sum_j exp(s_ij - m)
__global__ void __launch_bounds__(THREADS)
probs_stats_kernel(const float* __restrict__ q, const float* __restrict__ k, float* __restrict__ m_out,
                   float* __restrict__ l_out, int n, int n_kv, int d, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float *qs, *ks, *S;
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
__global__ void __launch_bounds__(THREADS)
probs_write_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ m_in, const float* __restrict__ l_in,
                   float* __restrict__ out, int n, int n_kv, int n_pad, int d, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float ms[BM], inv_l[BM];
  float *qs, *ks, *S;
  carve(smem, d, qs, ks, S);
  const int b = blockIdx.z, row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float* ob = out + (size_t)b * n * n_pad;
  if (col0 >= n_kv) {  // a tile of pad columns: exact zeros
    for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
      const int row = row0 + i / BN, col = col0 + i % BN;
      if (row < n && col < n_pad) ob[(size_t)row * n_pad + col] = 0.0f;
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
    ob[(size_t)row * n_pad + col] = col < n_kv ? __expf(S[r * LDS + c] * scale - ms[r]) * inv_l[r] : 0.0f;
  }
}

int launch_f32(const void* q, const void* k, float* ws, void* out, int b, int n, int n_kv, int n_pad,
               int d, float scale, cudaStream_t stream) {
  const int smem = (BM + BN) * (d + KPAD) * 4 + BM * LDS * 4;
  cudaFuncSetAttribute(probs_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(probs_write_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  float* m = ws;
  float* l = ws + (size_t)b * n;
  probs_stats_kernel<<<dim3((n + BM - 1) / BM, b), THREADS, smem, stream>>>(qf, kf, m, l, n, n_kv, d,
                                                                          scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  probs_write_kernel<<<dim3(n_pad / BN, (n + BM - 1) / BM, b), THREADS, smem, stream>>>(
      qf, kf, m, l, static_cast<float*>(out), n, n_kv, n_pad, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (b, n, d), k (b, n_kv, d) contiguous with 16-byte aligned starts,
// both bf16 (is_bf16 = 1) or float32; out (b, n, n_pad) in q's type,
// 16-byte aligned. ws: float32 scratch of 2 * b * splits * n entries (bf16:
// the (b, splits, n) partial (m, l) pairs of the statistics pass; float32:
// m and l of b * n rows, splits = 1). Requires 16 <= d <= 256 with d % 16
// == 0, n_kv >= 1, n_pad = n_kv rounded up to a multiple of 128 (bf16) or
// a multiple of 64 at least n_kv (float32), splits >= 1 (bf16: split s
// takes key tiles [s T / splits, (s + 1) T / splits) of the T tiles of
// 128 keys; more splits than tiles leaves some without a key). Returns a
// cudaError_t (0 on success), or hopper::TENSOR_MAP_ERROR + a CUresult.
extern "C" int atdn_attention_probs(const void* q, const void* k, void* ws, void* out, int b, int n,
                                    int n_kv, int n_pad, int d, int splits, float scale, int is_bf16,
                                    int device, void* stream) {
  if (d % 16 != 0 || d < 16 || d > 256 || n_pad < n_kv || n_kv < 1 || n < 1 || b < 1 ||
      b > 65535 || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  if (is_bf16 ? n_pad != (n_kv + KEYS - 1) / KEYS * KEYS || (n + ROWS - 1) / ROWS > 65535
              : n_pad % BN != 0 || splits != 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bf16(q, k, ws, out, b, n, n_kv, n_pad, d, splits, scale * 1.4426950408889634f, st);
  return launch_f32(q, k, static_cast<float*>(ws), out, b, n, n_kv, n_pad, d, scale, st);
}

// blocks per SM of the bf16 statistics pass (pass = 1) at head width d,
// or of the write pass (pass = 2); returns a cudaError_t
extern "C" int atdn_attention_probs_occupancy(int pass, int d, int* blocks, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (pass == 2) return corr_dot_wgmma::occupancy<SoftmaxProbs>(blocks);
  const int smem = stats_smem(d);
  const auto kernel = stats_kernel(d);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, STATS_THREADS, smem);
}
