// out = P v over the materialised spatial attention probabilities:
// out[b, i, :] = sum_k P[b, i, k] v[b, k, :], float32 accumulation, cast
// once to v's type. P (B, M, K) is K1's (B, H, W, N_pad) output seen as
// rows (M = H * W); its columns k >= N_v are exact zeros, and v (B, N_v,
// Dv) is read as if zero-extended to K rows (v's rows >= N_v are never
// read), so P is neither padded nor copied.
//
// Replaces the TPU kernel atdn_vslam_tpu/ops/attention.py:
// flash_apply_probs (_apply_probs_kernel via _flash_apply_probs_impl).
// The TPU wrapper padded P's columns to its 1024-key grid (a full copy
// of the matrix at KITTI, :803-813) and its rows to the 8-row block
// (:816, :847); here the last key tile is ragged and exactly M rows
// are written.
//
// Bound on an H100 at the KITTI shape (M = 7238, K = 7296, Dv = 128,
// bf16): P is 105.6 MB, read once, 31.5 us at 3.35 TB/s; the
// 2 * M * K * Dv = 1.35e10 FLOP take 13.7 us at the bf16 peak: bound by
// bytes. What the bf16 design does about it:
//   - a tile is 128 rows of P and all Dv (<= 128) columns, taken by two
//     consumer warpgroups of 64 rows, each a wgmma m64n128k16 chain
//     with P (K-major) and v (MN-major, the transpose flag) both read
//     from shared memory and the 64 x 128 float32 accumulator in
//     registers. 128 rows read each 16 KB v tile once per 16 KB of P,
//     so v's L2 reads equal P's device-memory bytes (64-row blocks read
//     twice as much);
//   - one producer warp keeps TMA loads in flight through six stages of
//     64 keys (16 KB of P and 16 KB of v each): up to 80 KB of P in
//     flight per SM, more than the ~40 KB that 3.35 TB/s over 132 SMs
//     needs at device-memory latency; P is loaded with the evict-first
//     L2 policy (read once);
//   - 3-D tensor maps, (K, M, B) for P and (Dv, N_v, B) for v, so TMA's
//     zero fill gives the contract: P's ragged last key tile, its rows
//     past M and v's rows past N_v read as zero, and no box reaches into
//     the next batch. Dv < 128 loads zero-filled columns that are never
//     stored;
//   - every SM is busy: the (tile, 64-key step) units are split evenly
//     over `grid` blocks (grid = the SM count at KITTI, 57 tiles x 114
//     steps over 132 blocks), each block taking a contiguous range of
//     units. A tile that one block covers whole is written directly; a
//     tile split between blocks has each segment's float32 partial sum
//     written to a workspace, and the last segment to finish (a counter
//     per tile and warpgroup, which it sets back to zero) adds all
//     segments in the order of their keys and writes the tile: no float
//     atomics, so the result is the same bit for bit from launch to
//     launch.
// float32 inputs take a plain-FMA kernel (one stage, 64 x 32 tiles).

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;
using namespace hopper;

constexpr int BM = 64;      // float32: rows of P per block
constexpr int MAXDV = 128;

constexpr int TM = 128;                         // bf16: rows of P per tile
constexpr int TK = 64;                          // keys per stage: a 128-byte row of P
constexpr int STAGES = 6;
constexpr int P_TILE = TM * TK * 2;             // 16 KB
constexpr int V_BOX = TK * 64 * 2;              // 8 KB: 64 keys x 64 values
constexpr int STAGE_BYTES = P_TILE + 2 * V_BOX;
constexpr int CONSUMERS = 256;                  // two warpgroups
constexpr int THREADS = CONSUMERS + 32;         // and one producer warp
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
constexpr int PART = 64 * 128;                  // floats of one warpgroup's partial tile

// the block that takes unit x when `units` are split over `grid` blocks,
// block i taking [i * units / grid, (i + 1) * units / grid)
__device__ __forceinline__ int unit_block(long long x, long long units, int grid) {
  return (int)(((x + 1) * grid + units - 1) / units - 1);
}

// the partial-sum slot of block i for `tile`: 0 for the tile its range
// starts in, 1 for the tile it ends in; then the warpgroup's half
__device__ __forceinline__ float* part_slot(float* ws, int i, int tile, long long units, int grid,
                                            int kt, int wg) {
  const int first = (int)((long long)i * units / grid / kt);
  return ws + ((size_t)(2 * i + (tile == first ? 0 : 1)) * 2 + wg) * PART;
}

// this warpgroup's 64 rows, from row0, of out (m, dv), from the
// accumulator fragment (rows g and g + 8 of the warp's 16)
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, const float (&acc)[64], int row0,
                                           int m, int dv) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = row0 + (threadIdx.x % 128) / 32 * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * t;
    if (c < dv) {
      if (r0 < m)
        *reinterpret_cast<uint32_t*>(out + (size_t)r0 * dv + c) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
      if (r1 < m)
        *reinterpret_cast<uint32_t*>(out + (size_t)r1 * dv + c) =
            pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
apply_probs_bf16_kernel(const __grid_constant__ CUtensorMap map_p,
                        const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ out,
                        float* __restrict__ ws, int* __restrict__ counters, int m, int dv,
                        int row_tiles, int kt, long long units) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int last[2];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int grid = gridDim.x, blk = blockIdx.x;
  const long long u0 = (long long)blk * units / grid, u1 = (long long)(blk + 1) * units / grid;

  if (threadIdx.x >= CONSUMERS) {
    // producer: one thread walks the block's units through the ring
    if (threadIdx.x == CONSUMERS) {
      int i = 0;
      for (long long u = u0; u < u1; ++u, ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        const int tile = (int)(u / kt), k0 = (int)(u % kt) * TK;
        const int b = tile / row_tiles, row0 = (tile % row_tiles) * TM;
        unsigned char* st = smem + s * STAGE_BYTES;
        mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        tma_load_3d_hint(st, &map_p, &full[s], k0, row0, b, EVICT_FIRST);
        tma_load_3d(st + P_TILE, &map_v, &full[s], 0, k0, b);
        tma_load_3d(st + P_TILE + V_BOX, &map_v, &full[s], 64, k0, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63 of each tile
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  float acc[64];
  int i = 0;
  long long u = u0;
  while (u < u1) {
    const int tile = (int)(u / kt);
    const long long t0 = (long long)tile * kt, t1 = t0 + kt;
    const long long end = t1 < u1 ? t1 : u1;
#pragma unroll
    for (int r = 0; r < 64; ++r) acc[r] = 0.0f;
    int prev = 0;
    for (; u < end; ++u, ++i) {
      const int s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const unsigned char* st = smem + s * STAGE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        const uint64_t da = desc_sw128(st + wg * (P_TILE / 2) + kk * 32, 16, 1024);
        const uint64_t db = desc_sw128(st + P_TILE + kk * 16 * 128, V_BOX, 1024);
        wgmma_m64n128k16_ss<1>(acc, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous unit's products are done: free its stage
      if (u > t0 && u > u0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[prev]);

    const int b = tile / row_tiles, row0 = (tile % row_tiles) * TM + wg * 64;
    bf16* ob = out + (size_t)b * m * dv;
    if (t0 >= u0 && t1 <= u1) {  // the whole tile
      store_rows(ob, acc, row0, m, dv);
      continue;
    }
    // one segment of a tile split between blocks
    float4* mine = reinterpret_cast<float4*>(part_slot(ws, blk, tile, units, grid, kt, wg));
#pragma unroll
    for (int e = 0; e < 16; ++e)
      __stcg(mine + e * 128 + tid, make_float4(acc[4 * e], acc[4 * e + 1], acc[4 * e + 2], acc[4 * e + 3]));
    __threadfence();
    named_bar_sync(1 + wg, 128);
    const int bf = unit_block(t0, units, grid), bl = unit_block(t1 - 1, units, grid);
    if (tid == 0) last[wg] = atomicAdd(&counters[2 * tile + wg], 1) == bl - bf;
    named_bar_sync(1 + wg, 128);
    if (!last[wg]) continue;
    __threadfence();
#pragma unroll
    for (int r = 0; r < 64; ++r) acc[r] = 0.0f;
    for (int i2 = bf; i2 <= bl; ++i2) {  // every segment, this one too, in the order of its keys
      const float4* src = reinterpret_cast<const float4*>(part_slot(ws, i2, tile, units, grid, kt, wg));
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float4 x = __ldcg(src + e * 128 + tid);
        acc[4 * e] += x.x;
        acc[4 * e + 1] += x.y;
        acc[4 * e + 2] += x.z;
        acc[4 * e + 3] += x.w;
      }
    }
    store_rows(ob, acc, row0, m, dv);
    if (tid == 0) counters[2 * tile + wg] = 0;  // zero again for the next launch
  }
}

// float32: one stage of 64 rows x 32 keys; thread (ty, tx) of a 16 x 16
// layout owns rows 4ty .. 4ty + 3 and columns tx + 16j
constexpr int FBK = 32;

__global__ void __launch_bounds__(256)
apply_probs_f32_kernel(const float* __restrict__ p, const float* __restrict__ v,
                       float* __restrict__ out, int m, int kp, int nv, int dv) {
  __shared__ float ps[BM][FBK + 1];
  __shared__ float vs[FBK][MAXDV + 4];
  const int b = blockIdx.y, row0 = blockIdx.x * BM;
  p += (size_t)b * m * kp;
  v += (size_t)b * nv * dv;
  out += (size_t)b * m * dv;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][MAXDV / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MAXDV / 16; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < kp; k0 += FBK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < BM * FBK; i += 256) {
      const int r = i / FBK, c = i % FBK;
      ps[r][c] = (row0 + r < m && k0 + c < kp) ? p[(size_t)(row0 + r) * kp + k0 + c] : 0.0f;
    }
    for (int i = threadIdx.x; i < FBK * dv; i += 256) {
      const int r = i / dv, c = i % dv;
      vs[r][c] = k0 + r < nv ? v[(size_t)(k0 + r) * dv + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ps[4 * ty + i][kk];
#pragma unroll
      for (int j = 0; j < MAXDV / 16; ++j) {
        if (tx + 16 * j < dv) {
          const float bv = vs[kk][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], bv, acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < MAXDV / 16; ++j)
      if (r < m && tx + 16 * j < dv) out[(size_t)r * dv + tx + 16 * j] = acc[i][j];
  }
}

}  // namespace

// p (b, m, kp) contiguous, 16-byte aligned, kp a multiple of 8; v
// (b, nv, dv) contiguous, 16-byte aligned, nv <= kp, dv a multiple of
// 16 up to 128; out (b, m, dv) contiguous; all bf16 (is_bf16 = 1) or
// all float32. bf16 only: `grid` blocks, 1 <= grid <= the number of
// (128-row tile, 64-key step) units; ws holds 4 * grid * 64 * 128
// floats; counters 2 * b * ceil(m / 128) ints, zero (and zero again
// when the kernel ends). Returns a
// cudaError_t (0 on success), or hopper::TENSOR_MAP_ERROR + a CUresult.
extern "C" int atdn_apply_probs(const void* p, const void* v, void* out, void* ws, void* counters,
                                int b, int m, int kp, int nv, int dv, int grid, int is_bf16,
                                int device, void* stream) {
  if (b < 1 || b > 65535 || m < 1 || kp < 1 || kp % 8 || nv < 1 || nv > kp || dv < 16 ||
      dv > MAXDV || dv % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const int row_tiles = (m + TM - 1) / TM, kt = (kp + TK - 1) / TK;
    const long long units = (long long)b * row_tiles * kt;
    if (grid < 1 || grid > units || ws == nullptr || counters == nullptr)
      return (int)cudaErrorInvalidValue;
    CUtensorMap map_p, map_v;
    int e = encode_bf16_3d(&map_p, p, kp, m, b, TK, TM);
    if (e == 0) e = encode_bf16_3d(&map_v, v, dv, nv, b, 64, TK);
    if (e != 0) return e;
    err = cudaFuncSetAttribute(apply_probs_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    apply_probs_bf16_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
        map_p, map_v, static_cast<bf16*>(out), static_cast<float*>(ws), static_cast<int*>(counters),
        m, dv, row_tiles, kt, units);
  } else {
    const dim3 fgrid((unsigned)((m + BM - 1) / BM), (unsigned)b);
    apply_probs_f32_kernel<<<fgrid, 256, 0, st>>>(static_cast<const float*>(p),
                                                  static_cast<const float*>(v),
                                                  static_cast<float*>(out), m, kp, nv, dv);
  }
  return (int)cudaGetLastError();
}
