// Attention out = softmax(scale * q k^T) v with an online (flash)
// softmax: one pass over the keys, the (Nq x Nk) scores never reach
// device memory. q (B, Nq, D), k (B, Nk, D), v (B, Nk, Dv), out
// (B, Nq, Dv) in v's type; Nq and Nk may differ.
//
// Replaces the TPU kernel atdn_vslam_tpu/ops/attention.py:flash_attend
// (_flash_kernel).
//
// Bound on an H100 at the 2x KITTI shape (B = 1, Nq = Nk = 28952,
// D = Dv = 128, bf16): 4 * Nq * Nk * D = 4.29e11 FLOP, 0.434 ms at the
// bf16 tensor-core peak, against 4 x 7.4 MB of q, k, v and out (8.8 us
// at 3.35 TB/s): bound by operations. A second floor is the softmax's
// 8.4e8 exponentials, ~0.2 ms at 16 per clock per SM, so the softmax has
// to run while the tensor cores work, not between their products. The
// bf16 design (FlashAttention-3's forward, written with raw PTX):
//   - one block per 128 query rows: two consumer warpgroups of 64 rows
//     and one producer warpgroup. setmaxnreg moves registers from the
//     producer (24) to the consumers (240), which keep S (64 x 128),
//     the output accumulator (64 x 128, float32) and P (bf16) in
//     registers;
//   - q is loaded once by TMA (two 64-column boxes, 32 KB); k and v
//     tiles of 128 keys (32 KB each) go through a ring of two stages,
//     filled by one producer thread, with a full and an empty mbarrier
//     per stage and operand, so a stage of k is refilled as soon as its
//     scores are computed;
//   - S = q k^T is a wgmma with both operands K-major in shared memory
//     (128-byte swizzle). P = 2^(S scale log2(e) - m), cast to v's type
//     as the TPU kernel does (:98), stays in registers as wgmma's A
//     operand: the accumulator layout of m64n128k16 is the A layout of
//     the next product, so no shuffle is needed. v arrives row-major
//     (keys x values), read as an MN-major B with the transpose flag;
//     nothing is transposed by hand;
//   - within a warpgroup, the scores of tile j are issued together with
//     P V of tile j - 1, and the softmax of tile j runs while P V is on
//     the tensor cores; between the two warpgroups, named barriers hand
//     the tensor cores back and forth (ping-pong), so one group's
//     softmax overlaps the other group's products;
//   - only the last key tile is masked: keys at or past Nk score -1e30
//     (the TPU kernel's mask value, not -inf), so p = 0; 3-D tensor maps zero-fill
//     ragged rows, D and Dv below 128 (zero columns never stored) and
//     never read into the next batch; no row >= Nq is written; the row
//     sum l is float32 over the unrounded p.
// Grid at 2x KITTI: 227 blocks of 128 rows on 132 SMs, one block per SM
// (164 KB of shared memory), so the second wave is 72% full; a split of
// the keys between blocks is not done. float32 inputs take a plain-FMA
// kernel with 64-row blocks (the GPU-vs-CPU agreement runs the model in
// float32), or, for value widths of at most 4, the narrow kernel below
// (GMFlow's float32 global matching and propagation).

#include "corr_dot_tiles.cuh"
#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;
using namespace hopper;

constexpr int BM = 64;         // float32: query rows per block, 16 per warp
constexpr int FBN = 32;        // keys per tile (float32)
constexpr int THREADS = 128;   // float32: four warps
constexpr int MAXD = 128;      // D and Dv up to 128, multiples of 16
constexpr int FPAD = 4;        // float32 shared-memory row padding
constexpr float NEG = -1e30f;  // the TPU kernel's mask value

// rows [row0, row0 + rows) of a row-major (n, d) matrix into shared
// memory with row stride d + pad, 16 bytes per thread; rows >= n are zero
template <typename T>
__device__ void load_rows(const T* __restrict__ g, int n, int d, int row0, int rows, int pad,
                          T* s) {
  constexpr int PER = 16 / sizeof(T);
  const int vecs = d / PER;
  const int ld = d + pad;
  for (int i = threadIdx.x; i < rows * vecs; i += THREADS) {
    const int r = i / vecs, c = (i % vecs) * PER;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) v = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * d + c);
    *reinterpret_cast<uint4*>(s + r * ld + c) = v;
  }
}

constexpr int QM = 128;                   // bf16: query rows per block
constexpr int KN = 128;                   // keys per stage
constexpr int KSTAGES = 2;
constexpr int BOX = 128 * 64 * 2;         // one TMA box: 128 rows x 64 columns, 16 KB
constexpr int TILE = 2 * BOX;             // 128 rows x 128 columns (D or Dv)
constexpr int FLASH_THREADS = 384;        // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int FLASH_SMEM = 1024 + (1 + 2 * KSTAGES) * TILE + (1 + 4 * KSTAGES) * 8;
constexpr int TURN = 1;                   // named barriers TURN + wg: warpgroup wg's turn
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = q k^T: the warpgroup's 64 query rows (q) against the 128 keys of
// a stage (k), both as two 64-column boxes
__device__ __forceinline__ void qk_product(float (&s)[64], const unsigned char* q,
                                           const unsigned char* k) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t da = desc_sw128(q + (kk / 4) * BOX + (kk % 4) * 32, 16, 1024);
    const uint64_t db = desc_sw128(k + (kk / 4) * BOX + (kk % 4) * 32, 16, 1024);
    wgmma_m64n128k16_ss<0>(s, da, db, kk > 0);
  }
}

// o += P v: P the warpgroup's 64 x 128 probabilities as bf16 pairs
// (p[4 kc .. 4 kc + 3] for keys 16 kc .. 16 kc + 15), v a stage of 128
// keys x 128 values
__device__ __forceinline__ void pv_product(float (&o)[64], const uint32_t (&p)[32],
                                           const unsigned char* v) {
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    const uint64_t db = desc_sw128(v + kc * 16 * 128, BOX, 1024);
    wgmma_m64n128k16_rs<1>(o, p[4 * kc], p[4 * kc + 1], p[4 * kc + 2], p[4 * kc + 3], db, 1);
  }
}

// online softmax of one tile of scores for the thread's rows g and g + 8
// (registers i with bit 1 clear, set): s becomes p = 2^(c s - m), m the
// running row max of c s; l takes the tile's row sums; corr is the
// factor that rescales the accumulator to the new max. With MASK, keys
// at or past `valid` score NEG, so p = 0. With REGIONS, score i counts
// only where bit i of `same` is set, and p = 0 exactly for the others,
// also while every key of a row so far was masked (m still NEG).
template <bool MASK, bool REGIONS>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float c, int valid, uint64_t same) {
  const int t = threadIdx.x % 4;
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    float x = s[i] * c;
    if (MASK && 8 * (i >> 2) + 2 * t + (i & 1) >= valid) x = NEG;
    if (REGIONS && !((same >> i) & 1ull)) x = NEG;
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the four lanes of a row group hold one row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r]);
    corr[r] = ex2(m[r] - mn);
    m[r] = mn;
    base[r] = (REGIONS && mn == NEG) ? 0.0f : mn;
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float p = ex2(s[i] - base[(i >> 1) & 1]);
    s[i] = p;
    sum[(i >> 1) & 1] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] = l[r] * corr[r] + sum[r];
  }
}

template <bool REGIONS>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float c, int valid, bool mask,
                                             uint64_t same) {
  if (mask)
    softmax_tile<true, REGIONS>(s, m, l, corr, c, valid, same);
  else
    softmax_tile<false, REGIONS>(s, m, l, corr, c, valid, same);
}

// K5r: bit i of the result is set where the key of the thread's score
// register i in the tile of keys from col0 (column col0 + 8 (i >> 2) +
// 2 t + (i & 1), t = lane % 4) lies before nk and in the region of the
// register's row (r0 for (i >> 1) & 1 == 0, r1 otherwise); kreg is the
// batch's row of key ids
__device__ __forceinline__ uint64_t region_bits(const int* __restrict__ kreg, int col0, int nk,
                                                int r0, int r1) {
  const int t = threadIdx.x % 4;
  uint64_t bits = 0;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + 8 * jj + 2 * t + e;
      if (col < nk) {
        const int r = __ldg(kreg + col);
        bits |= static_cast<uint64_t>(r == r0) << (4 * jj + e);
        bits |= static_cast<uint64_t>(r == r1) << (4 * jj + 2 + e);
      }
    }
  }
  return bits;
}

// the bf16 kernel's body; REGIONS (K5r) reads the (b, nk) key ids
// `regions` (nq = nk: the queries' ids are the same row)
template <bool REGIONS>
__device__ __forceinline__ void flash_bf16_body(const CUtensorMap* map_q, const CUtensorMap* map_k,
                                                const CUtensorMap* map_v, bf16* __restrict__ out,
                                                int nq, int nk, int dv, float c,
                                                const int* __restrict__ regions) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);  // q, then the k stages, then the v stages
  unsigned char* ks = qs + TILE;
  unsigned char* vs = ks + KSTAGES * TILE;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(vs + KSTAGES * TILE);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + KSTAGES;
  uint64_t* empty_k = full_v + KSTAGES;
  uint64_t* empty_v = empty_k + KSTAGES;
  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < KSTAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 256);
      mbar_init(&empty_v[s], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int row0 = blockIdx.x * QM, b = blockIdx.y;
  const int tiles = (nk + KN - 1) / KN;
  // the warpgroup, read through a shuffle so that the compiler sees it is
  // uniform in each warp: the roles then take their setmaxnreg budgets
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (wg == 2) {
    // producer warpgroup: one thread issues every load
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(full_q, TILE);
      tma_load_3d(qs, map_q, full_q, 0, row0, b);
      tma_load_3d(qs + BOX, map_q, full_q, 64, row0, b);
      for (int j = 0; j < tiles; ++j) {
        const int s = j % KSTAGES;
        const uint32_t free_parity = ((j / KSTAGES) & 1) ^ 1;
        unsigned char* kt = ks + s * TILE;
        unsigned char* vt = vs + s * TILE;
        mbar_wait(&empty_k[s], free_parity);
        mbar_arrive_expect_tx(&full_k[s], TILE);
        tma_load_3d(kt, map_k, &full_k[s], 0, j * KN, b);
        tma_load_3d(kt + BOX, map_k, &full_k[s], 64, j * KN, b);
        mbar_wait(&empty_v[s], free_parity);
        mbar_arrive_expect_tx(&full_v[s], TILE);
        tma_load_3d(vt, map_v, &full_v[s], 0, j * KN, b);
        tma_load_3d(vt + BOX, map_v, &full_v[s], 64, j * KN, b);
      }
    }
  } else {
    // consumer warpgroup wg: query rows row0 + 64 wg .. + 63
    setmaxnreg_inc<240>();
    const unsigned char* qw = qs + wg * (BOX / 2);
    const int last_valid = nk - (tiles - 1) * KN;  // keys in the last tile
    float o[64], s[64], m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f}, corr[2];
    uint32_t p[32];
    // K5r: the ids of rows g and g + 8 of the warp's 16 (r0, r1 below)
    const int qrow = row0 + wg * 64 + (threadIdx.x % 128) / 32 * 16 + (threadIdx.x % 32) / 4;
    const int* kreg = REGIONS ? regions + (size_t)b * nk : nullptr;
    const int reg0 = REGIONS && qrow < nq ? __ldg(kreg + qrow) : 0;
    const int reg1 = REGIONS && qrow + 8 < nq ? __ldg(kreg + qrow + 8) : 0;
    uint64_t same = 0;
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.0f;
    // the turns alternate between the warpgroups, warpgroup 0 first
    if (wg == 1) named_bar_arrive(TURN, 256);
    mbar_wait(full_q, 0);

    // tile 0: its scores and softmax
    named_bar_sync(TURN + wg, 256);
    mbar_wait(&full_k[0], 0);
    wgmma_fence();
    qk_product(s, qw, ks);
    wgmma_commit();
    named_bar_arrive(TURN + 1 - wg, 256);
    if (REGIONS) same = region_bits(kreg, 0, nk, reg0, reg1);
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(&empty_k[0]);
    softmax_tile<REGIONS>(s, m, l, corr, c, last_valid, tiles == 1 && last_valid < KN, same);
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);

    for (int j = 1; j < tiles; ++j) {
      // scores of tile j and P v of tile j - 1 on the tensor cores ...
      const int sk = j % KSTAGES, sv = (j - 1) % KSTAGES;
      named_bar_sync(TURN + wg, 256);
      mbar_wait(&full_k[sk], (j / KSTAGES) & 1);
      wgmma_fence();
      qk_product(s, qw, ks + sk * TILE);
      wgmma_commit();
      mbar_wait(&full_v[sv], ((j - 1) / KSTAGES) & 1);
      pv_product(o, p, vs + sv * TILE);
      wgmma_commit();
      named_bar_arrive(TURN + 1 - wg, 256);
      if (REGIONS) same = region_bits(kreg, j * KN, nk, reg0, reg1);
      // ... the softmax of tile j while P v runs
      wgmma_wait<1>();
      fence_regs(s);
      mbar_arrive(&empty_k[sk]);
      softmax_tile<REGIONS>(s, m, l, corr, c, last_valid, j == tiles - 1 && last_valid < KN, same);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      mbar_arrive(&empty_v[sv]);
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    }

    // P v of the last tile
    const int sv = (tiles - 1) % KSTAGES;
    named_bar_sync(TURN + wg, 256);
    mbar_wait(&full_v[sv], ((tiles - 1) / KSTAGES) & 1);
    wgmma_fence();
    pv_product(o, p, vs + sv * TILE);
    wgmma_commit();
    if (wg == 0) named_bar_arrive(TURN + 1, 256);
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&empty_v[sv]);

    // rows g and g + 8 of the warp's 16, columns 8j + 2t and + 1
    const int tid = threadIdx.x % 128, g = (tid % 32) / 4, t = tid % 4;
    const int r0 = row0 + wg * 64 + tid / 32 * 16 + g, r1 = r0 + 8;
    const float inv0 = __frcp_rn(l[0]), inv1 = __frcp_rn(l[1]);
    out += (size_t)b * nq * dv;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < dv) {
        if (r0 < nq)
          *reinterpret_cast<uint32_t*>(out + (size_t)r0 * dv + col) =
              pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
        if (r1 < nq)
          *reinterpret_cast<uint32_t*>(out + (size_t)r1 * dv + col) =
              pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
    }
  }
}

__global__ void __launch_bounds__(FLASH_THREADS, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ out, int nq,
                  int nk, int dv, float c) {
  flash_bf16_body<false>(&map_q, &map_k, &map_v, out, nq, nk, dv, c, nullptr);
}

__global__ void __launch_bounds__(FLASH_THREADS, 1)
flash_regions_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ out,
                          int n, int dv, float c, const int* __restrict__ regions) {
  flash_bf16_body<true>(&map_q, &map_k, &map_v, out, n, n, dv, c, regions);
}

// float32: the same loop with plain FMA over shared-memory tiles. For
// the scores and the output, thread (ty, tx) of a 16 x 8 layout owns
// rows 4ty .. 4ty + 3 and columns tx + 8j; for the softmax, threads 2r
// and 2r + 1 own row r, 16 key columns each.
// (REGIONS: K5r, a key counts only where its id in the (b, nk) `regions`
// equals the query's, nq = nk; p = 0 exactly for the others, also while
// every key of a row so far was masked)
template <bool REGIONS>
__device__ __forceinline__ void flash_f32_body(const float* __restrict__ q,
                                               const float* __restrict__ k,
                                               const float* __restrict__ v,
                                               float* __restrict__ out, int nq, int nk, int d,
                                               int dv, float scale, const int* __restrict__ regions) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float corr[BM], lsum[BM];
  const int ldq = d + FPAD, ldv = dv + FPAD, ldp = FBN + 1;
  float* qs = reinterpret_cast<float*>(smem);  // BM x ldq
  float* ks = qs + BM * ldq;                   // FBN x ldq
  float* vs = ks + FBN * ldq;                  // FBN x ldv
  float* ps = vs + FBN * ldv;                  // BM x ldp
  const int b = blockIdx.y, row0 = blockIdx.x * BM;
  q += (size_t)b * nq * d;
  k += (size_t)b * nk * d;
  v += (size_t)b * nk * dv;
  out += (size_t)b * nq * dv;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const int pr = threadIdx.x / 2, ph = threadIdx.x % 2;
  const int* kreg = REGIONS ? regions + (size_t)b * nk : nullptr;
  int qreg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    qreg[i] = REGIONS && row < nq ? __ldg(kreg + row) : 0;
  }

  load_rows(q, nq, d, row0, BM, FPAD, qs);
  float acc[4][MAXD / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MAXD / 8; ++j) acc[i][j] = 0.0f;
  float m_run = NEG, l_run = 0.0f;  // row pr

  for (int col0 = 0; col0 < nk; col0 += FBN) {
    __syncthreads();
    load_rows(k, nk, d, col0, FBN, FPAD, ks);
    load_rows(v, nk, dv, col0, FBN, FPAD, vs);
    __syncthreads();
    float s[4][FBN / 8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < FBN / 8; ++j) s[i][j] = 0.0f;
    for (int kk = 0; kk < d; ++kk) {
      float a[4], bk[FBN / 8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * ldq + kk];
#pragma unroll
      for (int j = 0; j < FBN / 8; ++j) bk[j] = ks[(tx + 8 * j) * ldq + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < FBN / 8; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < FBN / 8; ++j)
        ps[(ty * 4 + i) * ldp + tx + 8 * j] =
            col0 + tx + 8 * j < nk && (!REGIONS || __ldg(kreg + col0 + tx + 8 * j) == qreg[i])
                ? s[i][j] * scale
                : NEG;
    __syncthreads();

    float* prow = ps + pr * ldp + ph * (FBN / 2);
    float mx = NEG;
#pragma unroll
    for (int c = 0; c < FBN / 2; ++c) mx = fmaxf(mx, prow[c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float mn = fmaxf(m_run, mx);
    const float cr = expf(m_run - mn);
    const float base = REGIONS && mn == NEG ? 0.0f : mn;
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < FBN / 2; ++c) {
      const float p = expf(prow[c] - base);
      prow[c] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = cr * l_run + sum;
    m_run = mn;
    if (ph == 0) corr[pr] = cr;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const float c = corr[r];
#pragma unroll
      for (int j = 0; j < MAXD / 8; ++j) acc[i][j] *= c;
      for (int kk = 0; kk < FBN; ++kk) {
        const float p = ps[r * ldp + kk];
#pragma unroll
        for (int j = 0; j < MAXD / 8; ++j)
          if (8 * j < dv) acc[i][j] = fmaf(p, vs[kk * ldv + tx + 8 * j], acc[i][j]);
      }
    }
  }
  if (ph == 0) lsum[pr] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (row0 + r >= nq) continue;
    const float l = lsum[r];
#pragma unroll
    for (int j = 0; j < MAXD / 8; ++j)
      if (8 * j < dv) out[(size_t)(row0 + r) * dv + tx + 8 * j] = acc[i][j] / l;
  }
}

__global__ void __launch_bounds__(THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int nq, int nk, int d,
                 int dv, float scale) {
  flash_f32_body<false>(q, k, v, out, nq, nk, d, dv, scale, nullptr);
}

__global__ void __launch_bounds__(THREADS)
flash_regions_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out, int n, int d,
                         int dv, float scale, const int* __restrict__ regions) {
  flash_f32_body<true>(q, k, v, out, n, n, d, dv, scale, regions);
}

// ---------------------------------------------------------------------
// float32 with narrow values (1 <= Dv <= 4): GMFlow's global matching
// (v the pixel grid) and propagation (v the flow), 2 value columns over
// all 7,392 tokens at KITTI, D = 128. It replaces, for such values, the
// plain-FMA loop above, which needs Dv in multiples of 16 (GMFlow padded
// its 2 columns to 16), runs 116 blocks of four warps on 132 SMs, loads
// 8 floats from shared memory for every 16 FMAs and passes P through
// shared memory with four barriers a tile.
//
// Bound: 2 Nq Nk (D + Dv) = 14.2 GFLOP a call at 7,392 tokens, 0.212 ms
// at the H100's 67 TFLOP/s of float32 FMA; ~8.5 MB of q, k, v and out
// (2.5 us at 3.35 TB/s): bound by operations, nearly all of them the
// q k^T products (P v is 1.5% of the work). The design:
//   - one block of eight warps per 128 query rows and one of S parts of
//     the keys (the wrapper picks S from the SM count, so that the grid
//     fills the card in whole waves); a 128 x 128 score tile a step, each
//     thread 8 x 8 scores in registers (rows ry + 16i, keys cx + 16j, a
//     warp 2 rows ry x 16 keys cx), so every float read from shared
//     memory feeds 4 FMAs, read as float4 along D from rows padded to
//     D + 4 floats (no bank conflicts: the 16 key rows a warp reads fill
//     the banks twice, its 2 query rows are broadcast);
//   - q's tile stays in shared memory for the block's life; k and v
//     tiles go through two stages filled by cp.async while the FMAs run,
//     one barrier a tile; keys at or past Nk are zero-filled and masked;
//   - the softmax stays in registers: each thread keeps a running max,
//     sum and Dv value sums for each of its 8 rows over its own keys, so
//     no tile needs a shuffle or a barrier for the softmax; p goes
//     straight into the value sums and is never stored;
//   - at the part's end the 16 threads of a half-warp that share rows
//     merge by shuffles and write the rows' (m, l, o) to a float32
//     scratch; a second kernel merges the S parts of each row in a fixed
//     order and divides. No atomics: the same inputs give the same bits.
// Full float32 throughout: FMA products, float32 exponentials (ex2 of
// the scores scaled by scale log2(e)) and sums.

constexpr int NB = 128;            // query rows per block, keys per tile
constexpr int NLD = MAXD + 4;      // shared-memory row stride of q and k (floats)
constexpr int NTHREADS = 256;      // eight warps
constexpr int NARROW_MAX_DV = 4;

template <int DV>
constexpr int narrow_smem() {
  return (3 * NB * NLD + 2 * NB * DV) * (int)sizeof(float);  // q, two k stages, two v stages
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 4 : 0));
}

// rows [row0, row0 + NB) of a row-major (n, d) float32 matrix into shared
// memory at row stride NLD, one warp a row; rows >= n are zero
__device__ __forceinline__ void narrow_load_rows(const float* __restrict__ g, int n, int d, int row0,
                                                 float* s) {
  for (int r = threadIdx.x / 32; r < NB; r += NTHREADS / 32) {
    const bool ok = row0 + r < n;
    for (int c = threadIdx.x % 32 * 4; c < d; c += 128)
      corr_dot_tiles::cp_async16(s + r * NLD + c, ok ? g + (size_t)(row0 + r) * d + c : g, ok);
  }
}

// v's rows [key0, key0 + NB), DV floats each; rows >= n are zero
template <int DV>
__device__ __forceinline__ void narrow_load_values(const float* __restrict__ v, int n, int key0, float* s) {
  for (int i = threadIdx.x; i < NB * DV; i += NTHREADS) {
    const bool ok = key0 + i / DV < n;
    cp_async4(s + i, ok ? v + (size_t)key0 * DV + i : v, ok);
  }
}

// s[i][j] = q[ry + 16i] . k[cx + 16j] over d, in order of d; qa and kb
// point at the thread's first q and k rows in shared memory
__device__ __forceinline__ void narrow_scores(float (&s)[8][8], const float* qa, const float* kb, int d) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
  for (int d0 = 0; d0 < d; d0 += 16) {
#pragma unroll
    for (int dd = 0; dd < 16; dd += 4) {
      float4 a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(qa + 16 * i * NLD + d0 + dd);
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = *reinterpret_cast<const float4*>(kb + 16 * j * NLD + d0 + dd);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }
  }
}

// one tile's online softmax and p v for the thread's 8 rows over its 8
// keys cx + 16j of the tile: x = c s, m the row's running max of x over
// the thread's keys so far, l the sum of 2^(x - m), o the DV sums of
// 2^(x - m) v. With MASK, keys at or past `valid` (of the tile) get
// p = 0, also while every key the thread saw was masked (m still NEG).
template <int DV, bool MASK>
__device__ __forceinline__ void narrow_softmax(float (&s)[8][8], float (&m)[8], float (&l)[8],
                                               float (&o)[8][DV], const float* vs, int cx, float c,
                                               int valid) {
  float vk[8][DV];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < DV; ++e) vk[j][e] = vs[(cx + 16 * j) * DV + e];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float x = s[i][j] * c;
      if (MASK && cx + 16 * j >= valid) x = NEG;
      s[i][j] = x;
      mx = fmaxf(mx, x);
    }
    const float mn = fmaxf(m[i], mx);
    const float corr = ex2(m[i] - mn);  // 0 while m was NEG
    const float base = MASK && mn == NEG ? 0.0f : mn;
    m[i] = mn;
    float sum = 0.0f, acc[DV];
#pragma unroll
    for (int e = 0; e < DV; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p = ex2(s[i][j] - base);
      sum += p;
#pragma unroll
      for (int e = 0; e < DV; ++e) acc[e] = fmaf(p, vk[j][e], acc[e]);
    }
    l[i] = fmaf(l[i], corr, sum);
#pragma unroll
    for (int e = 0; e < DV; ++e) o[i][e] = fmaf(o[i][e], corr, acc[e]);
  }
}

// grid (row blocks, S parts, b); ws (b, nq, S, 2 + DV): each row's
// (m, l, o) per part
template <int DV>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_narrow_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ ws, int nq, int nk, int d,
                        float c) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // NB x NLD
  float* ks = qs + NB * NLD;                   // 2 stages of NB x NLD
  float* vs = ks + 2 * NB * NLD;               // 2 stages of NB x DV
  const int row0 = blockIdx.x * NB, part = blockIdx.y, parts = gridDim.y, b = blockIdx.z;
  const int tiles = (nk + NB - 1) / NB;
  const int t0 = part * tiles / parts, t1 = (part + 1) * tiles / parts;
  q += (size_t)b * nq * d;
  k += (size_t)b * nk * d;
  v += (size_t)b * nk * DV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ry = warp * 2 + lane / 16, cx = lane % 16;

  narrow_load_rows(q, nq, d, row0, qs);
  narrow_load_rows(k, nk, d, t0 * NB, ks);
  narrow_load_values<DV>(v, nk, t0 * NB, vs);
  corr_dot_tiles::cp_async_commit();

  float m[8], l[8], o[8][DV];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < DV; ++e) o[i][e] = 0.0f;
  }
  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) & 1;
    corr_dot_tiles::cp_async_wait<0>();
    __syncthreads();  // tile t has landed, and every thread is done with tile t - 1's stage
    if (t + 1 < t1) {
      narrow_load_rows(k, nk, d, (t + 1) * NB, ks + (st ^ 1) * NB * NLD);
      narrow_load_values<DV>(v, nk, (t + 1) * NB, vs + (st ^ 1) * NB * DV);
      corr_dot_tiles::cp_async_commit();
    }
    float s[8][8];
    narrow_scores(s, qs + ry * NLD, ks + st * NB * NLD + cx * NLD, d);
    const int valid = nk - t * NB;
    if (valid < NB)
      narrow_softmax<DV, true>(s, m, l, o, vs + st * NB * DV, cx, c, valid);
    else
      narrow_softmax<DV, false>(s, m, l, o, vs + st * NB * DV, cx, c, NB);
  }

  // the 16 lanes that share rows merge
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], off);
      float oo[DV];
#pragma unroll
      for (int e = 0; e < DV; ++e) oo[e] = __shfl_xor_sync(0xffffffffu, o[i][e], off);
      const float mn = fmaxf(m[i], mo);
      const float wa = ex2(m[i] - mn), wb = ex2(mo - mn);
      l[i] = l[i] * wa + lo * wb;
#pragma unroll
      for (int e = 0; e < DV; ++e) o[i][e] = o[i][e] * wa + oo[e] * wb;
      m[i] = mn;
    }
  }
  if (cx == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + ry + 16 * i;
      if (row >= nq) continue;
      float* w = ws + (((size_t)b * nq + row) * parts + part) * (2 + DV);
      w[0] = m[i];
      w[1] = l[i];
#pragma unroll
      for (int e = 0; e < DV; ++e) w[2 + e] = o[i][e];
    }
  }
}

// out row r = (sum_p o_p 2^(m_p - m)) / (sum_p l_p 2^(m_p - m)) over the
// row's `parts` scratch entries in order, m their largest m
template <int DV>
__global__ void __launch_bounds__(256)
flash_narrow_merge_kernel(const float* __restrict__ ws, float* __restrict__ out, int rows, int parts) {
  const int r = blockIdx.x * 256 + threadIdx.x;
  if (r >= rows) return;
  const float* w = ws + (size_t)r * parts * (2 + DV);
  float m = NEG;
  for (int p = 0; p < parts; ++p) m = fmaxf(m, w[p * (2 + DV)]);
  float l = 0.0f, o[DV];
#pragma unroll
  for (int x = 0; x < DV; ++x) o[x] = 0.0f;
  for (int p = 0; p < parts; ++p) {
    const float* we = w + p * (2 + DV);
    const float a = ex2(we[0] - m);
    l = fmaf(we[1], a, l);
#pragma unroll
    for (int x = 0; x < DV; ++x) o[x] = fmaf(we[2 + x], a, o[x]);
  }
#pragma unroll
  for (int x = 0; x < DV; ++x) out[(size_t)r * DV + x] = o[x] / l;
}

template <int DV>
int launch_narrow(const float* q, const float* k, const float* v, float* ws, float* out, int b, int nq,
                  int nk, int d, int parts, float c, cudaStream_t st) {
  constexpr int smem = narrow_smem<DV>();
  cudaError_t err = cudaFuncSetAttribute(flash_narrow_f32_kernel<DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nq + NB - 1) / NB, parts, b);
  flash_narrow_f32_kernel<DV><<<grid, NTHREADS, smem, st>>>(q, k, v, ws, nq, nk, d, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows = b * nq;
  flash_narrow_merge_kernel<DV><<<(rows + 255) / 256, 256, 0, st>>>(ws, out, rows, parts);
  return (int)cudaGetLastError();
}

}  // namespace

namespace {

// the launch of K5 (regions == nullptr) or K5r (nq = nk, regions (b, nk))
int launch(const void* q, const void* k, const void* v, const int* regions, void* out, int b,
           int nq, int nk, int d, int dv, float scale, int is_bf16, int device, void* stream) {
  if (b < 1 || b > 65535 || nq < 1 || nk < 1 || d % 16 || dv % 16 || d < 16 || dv < 16 ||
      d > MAXD || dv > MAXD || (regions != nullptr && nq != nk))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    CUtensorMap map_q, map_k, map_v;
    int e = encode_bf16_3d(&map_q, q, d, nq, b, 64, QM);
    if (e == 0) e = encode_bf16_3d(&map_k, k, d, nk, b, 64, KN);
    if (e == 0) e = encode_bf16_3d(&map_v, v, dv, nk, b, 64, KN);
    if (e != 0) return e;
    const dim3 grid((nq + QM - 1) / QM, b);
    if (regions == nullptr) {
      err = cudaFuncSetAttribute(flash_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 FLASH_SMEM);
      if (err != cudaSuccess) return (int)err;
      flash_bf16_kernel<<<grid, FLASH_THREADS, FLASH_SMEM, st>>>(
          map_q, map_k, map_v, static_cast<bf16*>(out), nq, nk, dv, scale * LOG2E);
    } else {
      err = cudaFuncSetAttribute(flash_regions_bf16_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, FLASH_SMEM);
      if (err != cudaSuccess) return (int)err;
      flash_regions_bf16_kernel<<<grid, FLASH_THREADS, FLASH_SMEM, st>>>(
          map_q, map_k, map_v, static_cast<bf16*>(out), nq, dv, scale * LOG2E, regions);
    }
  } else {
    const dim3 grid((nq + BM - 1) / BM, b);
    const int smem =
        ((BM + FBN) * (d + FPAD) + FBN * (dv + FPAD) + BM * (FBN + 1)) * (int)sizeof(float);
    const auto* qf = static_cast<const float*>(q);
    const auto* kf = static_cast<const float*>(k);
    const auto* vf = static_cast<const float*>(v);
    if (regions == nullptr) {
      err = cudaFuncSetAttribute(flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return (int)err;
      flash_f32_kernel<<<grid, THREADS, smem, st>>>(qf, kf, vf, static_cast<float*>(out), nq, nk,
                                                    d, dv, scale);
    } else {
      err = cudaFuncSetAttribute(flash_regions_f32_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      flash_regions_f32_kernel<<<grid, THREADS, smem, st>>>(
          qf, kf, vf, static_cast<float*>(out), nq, d, dv, scale, regions);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q (b, nq, d), k (b, nk, d), v (b, nk, dv), out (b, nq, dv), all
// contiguous with 16-byte aligned starts, all bf16 (is_bf16 = 1) or all
// float32. Requires d and dv multiples of 16 in [16, 128]. Returns a
// cudaError_t (0 on success), or hopper::TENSOR_MAP_ERROR + a CUresult.
extern "C" int atdn_flash_attend(const void* q, const void* k, const void* v, void* out, int b,
                                 int nq, int nk, int d, int dv, float scale, int is_bf16,
                                 int device, void* stream) {
  return launch(q, k, v, nullptr, out, b, nq, nk, d, dv, scale, is_bf16, device, stream);
}

// K5r: as atdn_flash_attend with nq = nk = n, and the contiguous int32
// (b, n) region ids `regions`: a key counts for a query only where their
// ids agree (every query's own key does, so no row is empty).
extern "C" int atdn_flash_attend_regions(const void* q, const void* k, const void* v,
                                         const int* regions, void* out, int b, int n, int d,
                                         int dv, float scale, int is_bf16, int device,
                                         void* stream) {
  if (regions == nullptr) return (int)cudaErrorInvalidValue;
  return launch(q, k, v, regions, out, b, n, n, d, dv, scale, is_bf16, device, stream);
}

// K5 for float32 values 1 to 4 wide: q (b, nq, d), k (b, nk, d), v (b,
// nk, dv), out (b, nq, dv), all float32 and contiguous, q and k with
// 16-byte aligned starts; d a multiple of 16 in [16, 128]. The keys are
// cut into `parts` parts of whole 128-key tiles (1 <= parts <= the
// tiles); ws is a float32 scratch of b * nq * parts * (2 + dv) floats. Returns a cudaError_t (0 on success).
extern "C" int atdn_flash_attend_narrow(const float* q, const float* k, const float* v, float* ws,
                                        float* out, int b, int nq, int nk, int d, int dv, int parts,
                                        float scale, int device, void* stream) {
  if (b < 1 || b > 65535 || nq < 1 || nk < 1 || d % 16 || d < 16 || d > MAXD || dv < 1 ||
      dv > NARROW_MAX_DV || parts < 1 || parts > (nk + NB - 1) / NB || parts > 65535 ||
      (size_t)b * nq > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto st = static_cast<cudaStream_t>(stream);
  const float c = scale * LOG2E;
  switch (dv) {
    case 1: return launch_narrow<1>(q, k, v, ws, out, b, nq, nk, d, parts, c, st);
    case 2: return launch_narrow<2>(q, k, v, ws, out, b, nq, nk, d, parts, c, st);
    case 3: return launch_narrow<3>(q, k, v, ws, out, b, nq, nk, d, parts, c, st);
    default: return launch_narrow<4>(q, k, v, ws, out, b, nq, nk, d, parts, c, st);
  }
}
