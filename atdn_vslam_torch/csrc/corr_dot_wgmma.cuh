// The bf16-input core of the correlation-volume kernels K3 (corr_dot.cu)
// and K3t (corr_dot_tiled.cu): out[b, n, m] = scale * sum_c f1[b, n, c]
// f2[b, m, c], with f1 (B, N, C) and f2 (B, M, C) both contiguous bf16
// (K-major: the channels are the reduction), the sum float32, scaled in
// float32 and cast once to bf16 or float32, written row-major (B, N, M):
// the contract of the TPU kernel atdn_vslam_tpu/ops/corr_lookup.py:31-37.
//
// Bound on an H100 at 2x KITTI level 0 (N = M = 28952, C = 256, bf16 out):
// 1.68 GB of output (0.50 ms at 3.35 TB/s) against 4.29e11 FLOP (0.43 ms
// at the bf16 tensor-core peak). Bytes first, the products close behind,
// so both have to run at once, and every output byte is written once in
// full 32-byte sectors. The design:
//   - one block of two warpgroups (256 threads) per 128 x 128 output
//     tile; warpgroup wg owns the tile's rows 64 wg .. 64 wg + 63;
//   - loads: two 3-D tensor maps (C, rows, batch) with boxes of 64
//     channels x 128 rows and the 128-byte swizzle (hopper.cuh). TMA
//     zero-fills ragged rows, C below 64 and the tail of a C that is not a
//     multiple of 64, so no load is masked; C % 8 == 0 is TMA's 16-byte
//     stride rule. Thread 0 issues every load into a ring of STAGES
//     stages of (128 x 64 of f1 + 128 x 64 of f2), 32 KB each, with a
//     full and an empty mbarrier per stage;
//   - products: per stage, four wgmma m64n128k16 per warpgroup with both
//     operands K-major in shared memory (K5's qk_product, flash_attend.cu);
//     the 64-float accumulator stays in registers;
//   - two blocks per SM (__launch_bounds__(256, 2): at most 128 registers,
//     ~97 KB of shared memory each), so one block's epilogue stores run
//     while the other block's products do. The block scheduler gives that
//     overlap for free: no producer warp, no setmaxnreg, no persistent loop;
//   - epilogue: once the last product is waited on, each warpgroup stages
//     its scaled, cast rows in the ring's shared memory, every row shifted
//     by its start address modulo 16 bytes, so that each row's body goes
//     out in 16-byte stores that are 16-byte aligned in device memory and
//     only the head and tail (up to the first and last 16-byte boundary)
//     in 2- or 4-byte element stores, whatever M is (rows of M = 7238
//     start at four alignments, of odd M at eight). The body stores are
//     streaming stores (st.global.cs), so the output lines, written once,
//     are the first to leave L2. Rows >= N and columns >= M are never
//     written.
// The epilogue is a template parameter: K3 and K3t take ScaleCast below
// (scale, cast); K1's write pass (attention_probs.cu) takes a softmax
// epilogue over the same main loop and stores.
// Left undone: a persistent tile loop, TMA stores (they need M * 2 to be a
// multiple of 16, which of the chip_smoke shapes only 2x level 0 meets),
// a cluster multicast of the f1 tile shared by a row of blocks.

#pragma once

#include "hopper.cuh"

namespace corr_dot_wgmma {

typedef __nv_bfloat16 bf16;
using namespace hopper;

constexpr int BM = 128;                       // rows of f1 per tile
constexpr int BN = 128;                       // rows of f2 per tile (output columns)
constexpr int BK = 64;                        // channels per stage: one 128-byte box
constexpr int THREADS = 256;                  // two consumer warpgroups
constexpr int STAGES = 3;                     // ring depth
constexpr int MIN_BLOCKS = 2;                 // blocks resident per SM
constexpr int BOX = BM * BK * 2;              // one TMA box, 16 KB
constexpr int STAGE_BYTES = 2 * BOX;          // f1 box + f2 box
constexpr int RING = STAGES * STAGE_BYTES;
constexpr int SMEM = 1024 + RING + 2 * STAGES * 8;  // 1024-byte alignment slack, barriers

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

// the epilogue's staging of one warpgroup's 64 rows in its half of the
// ring: VEC elements per 16 bytes; a row holds BN elements shifted by up
// to VEC - 1
template <typename Tout> struct Staging {
  static constexpr int VEC = 16 / (int)sizeof(Tout);
  static constexpr int LD = BN + VEC;                     // elements per staged row
  static constexpr int CHUNKS = BN / VEC + 1;             // 16-byte pieces of a shifted row
  static_assert(64 * LD * (int)sizeof(Tout) <= RING / 2, "a warpgroup's rows do not fit its half of the ring");
};

// The epilogue of K3 and K3t: out[b, row, col] = scale * sum, cast to
// Tout, row-major (B, N, M). An epilogue type gives the output (out, n,
// ld: elements per output row, cols: columns of the tile at col0 that
// exist), EXTRA_SMEM bytes of shared memory after the barriers, a
// prologue run by every thread before the main loop (its shared-memory
// writes are read after the loop's closing __syncthreads), per-row
// parameters (row) and the value of each sum (value).
template <typename T> struct ScaleCast {
  typedef T Tout;
  static constexpr int EXTRA_SMEM = 0;
  struct Row {};
  T* out;
  int n, m;
  float scale;
  __device__ __forceinline__ void prologue(float*, int, int) const {}
  __device__ __forceinline__ Row row(const float*, int) const { return Row{}; }
  __device__ __forceinline__ float value(float sum, Row, int) const { return sum * scale; }
  __device__ __forceinline__ size_t ld() const { return (size_t)m; }
  __device__ __forceinline__ int cols(int col0) const { return min(BN, m - col0); }
};

// one 128 x 128 tile at (row0 = 128 blockIdx.y, col0 = 128 blockIdx.x) of
// batch blockIdx.z; f1 through map_a (C, N, B), f2 through map_b (C, M, B)
template <typename Epi>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
corr_dot_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b, const Epi epi, int c) {
  typedef typename Epi::Tout Tout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + RING);
  uint64_t* empty = full + STAGES;
  float* extra = reinterpret_cast<float*>(empty + STAGES);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], THREADS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM, b = blockIdx.z;
  const int ksteps = (c + BK - 1) / BK;
  auto load = [&](int j) {  // channels [64 j, 64 j + 64) into stage j % STAGES
    unsigned char* st = ring + (j % STAGES) * STAGE_BYTES;
    uint64_t* bar = &full[j % STAGES];
    mbar_arrive_expect_tx(bar, STAGE_BYTES);
    tma_load_3d(st, &map_a, bar, j * BK, row0, b);
    tma_load_3d(st + BOX, &map_b, bar, j * BK, col0, b);
  };
  if (tid == 0)
    for (int j = 0; j < STAGES && j < ksteps; ++j) load(j);
  epi.prologue(extra, row0, b);

  // warpgroup wg: rows 64 wg .. + 63 of the f1 box against all 128 f2 rows
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  float acc[64];
  for (int kt = 0; kt < ksteps; ++kt) {
    const int s = kt % STAGES;
    const unsigned char* a = ring + s * STAGE_BYTES + wg * (BOX / 2);
    const unsigned char* bt = ring + s * STAGE_BYTES + BOX;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n128k16_ss<0>(acc, desc_sw128(a + kk * 32, 16, 1024),
                             desc_sw128(bt + kk * 32, 16, 1024), kt > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(&empty[s]);
    if (tid == 0 && kt + STAGES < ksteps) {  // refill the stage once both warpgroups are done
      mbar_wait(&empty[s], (kt / STAGES) & 1);
      load(kt + STAGES);
    }
  }
  fence_regs(acc);
  __syncthreads();  // every product has read its stage: the ring is free

  // epilogue: accumulator register i of thread (warp w, lane 4 g + t)
  // holds row 16 w + g + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 t + (i & 1)
  typedef Staging<Tout> S;
  constexpr int VEC = S::VEC, LD = S::LD;
  Tout* stage = reinterpret_cast<Tout*>(ring + wg * (RING / 2));
  const int wtid = tid % 128, w = wtid / 32, g = (wtid % 32) / 4, t = wtid % 4;
  const int n = epi.n, cols = epi.cols(col0);
  Tout* out = epi.out;
  // element index of (row, col0) in the whole output; its residue mod VEC
  // is the row's shift (out itself is 16-byte aligned)
  auto row_start = [&](int row) { return ((size_t)b * n + row) * epi.ld() + col0; };
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * w + g + 8 * h;  // row within the warpgroup's 64
    const typename Epi::Row rp = epi.row(extra, 64 * wg + r);
    Tout* dst = stage + r * LD + (int)(row_start(row0 + 64 * wg + r) % VEC);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + 8 * j + 2 * t;
      dst[8 * j + 2 * t] = from_float<Tout>(epi.value(acc[4 * j + 2 * h], rp, col));
      dst[8 * j + 2 * t + 1] = from_float<Tout>(epi.value(acc[4 * j + 2 * h + 1], rp, col + 1));
    }
  }
  named_bar_sync(1 + wg, 128);
  for (int i = wtid; i < 64 * S::CHUNKS; i += 128) {
    const int r = i / S::CHUNKS, k = i % S::CHUNKS;
    const int row = row0 + 64 * wg + r;
    if (row >= n) continue;
    const size_t g0 = row_start(row);
    const int shift = (int)(g0 % VEC);
    const int lo = k * VEC;  // staged elements [lo, lo + VEC) <-> out[g0 - shift + lo ...]
    if (lo + VEC <= shift || lo >= shift + cols) continue;
    const Tout* src = stage + r * LD + lo;
    Tout* dst = out + (g0 - shift) + lo;
    if (lo >= shift && lo + VEC <= shift + cols) {  // written once, read later: streaming store
      __stcs(reinterpret_cast<uint4*>(dst), *reinterpret_cast<const uint4*>(src));
    } else {  // head or tail of the row
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (lo + e >= shift && lo + e < shift + cols) dst[e] = src[e];
    }
  }
}

// the tiles of the (b, n, m) product of f1 (b, n, c) and f2 (b, m, c),
// both contiguous bf16 with 16-byte aligned starts, c a multiple of 8,
// through the epilogue epi. Returns a cudaError_t, or TENSOR_MAP_ERROR +
// a CUresult.
template <typename Epi>
int launch_tiles(const void* f1, const void* f2, const Epi& epi, int b, int n, int m, int c,
                 cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  int e = encode_bf16_3d(&map_a, f1, c, n, b, BK, BM);
  if (e == 0) e = encode_bf16_3d(&map_b, f2, c, m, b, BK, BN);
  if (e != 0) return e;
  constexpr int smem = SMEM + Epi::EXTRA_SMEM;
  cudaError_t err = cudaFuncSetAttribute(corr_dot_wgmma_kernel<Epi>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM, b);
  corr_dot_wgmma_kernel<Epi><<<grid, THREADS, smem, stream>>>(map_a, map_b, epi, c);
  return (int)cudaGetLastError();
}

// out (b, n, m) = scale * f1 f2^T for f1 (b, n, c), f2 (b, m, c): both
// contiguous bf16 with 16-byte aligned starts, c a multiple of 8; out
// contiguous and 16-byte aligned. Returns a cudaError_t, or
// TENSOR_MAP_ERROR + a CUresult.
template <typename Tout>
int launch(const void* f1, const void* f2, void* out, int b, int n, int m, int c, float scale,
           cudaStream_t stream) {
  return launch_tiles(f1, f2, ScaleCast<Tout>{static_cast<Tout*>(out), n, m, scale}, b, n, m, c,
                      stream);
}

// blocks of the kernel with epilogue Epi resident per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
template <typename Epi>
int occupancy(int* blocks) {
  constexpr int smem = SMEM + Epi::EXTRA_SMEM;
  cudaError_t err = cudaFuncSetAttribute(corr_dot_wgmma_kernel<Epi>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, corr_dot_wgmma_kernel<Epi>,
                                                            THREADS, smem);
}

}  // namespace corr_dot_wgmma
