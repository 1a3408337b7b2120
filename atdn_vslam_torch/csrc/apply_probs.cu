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
// bytes. So the design streams P through shared memory with enough
// bytes in flight and keeps the products on the tensor cores:
//   - one block of four warps per 64 rows of P and all Dv (<= 128)
//     columns; each warp owns 16 rows, their 16 x Dv float32
//     accumulators in mma.sync m16n8k16 registers;
//   - tiles of 64 keys of P (64 x 64) and v (64 x Dv) go through four
//     cp.async stages in shared memory, three in flight while one is
//     consumed (24 KB of P in flight per block);
//   - P's fragments are 32-bit shared-memory loads; v stays row-major
//     as it arrives and its fragments come from ldmatrix.trans, so
//     nothing is transposed by hand.
// 64-row blocks give 114 blocks at KITTI on the 132 SMs, one wave. A
// smaller row tile would fill every SM but read v (1.87 MB) once per
// block from L2: 114 blocks already read 213 MB of v from L2 against
// the 105.6 MB of P from device memory, and 32-row blocks would double
// that; splitting the keys across blocks needs a reduction between
// them. Both are later work, with wgmma and TMA.
// float32 inputs take a plain-FMA kernel (one stage, 64 x 32 tiles).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;              // rows of P per block
constexpr int BK = 64;              // keys per stage
constexpr int STAGES = 4;
constexpr int THREADS = 128;        // four warps
constexpr int MAXDV = 128;
constexpr int LDP = BK + 8;         // P tile row stride (elements)
constexpr int LDV = MAXDV + 8;      // v tile row stride (elements)
constexpr int STAGE_ELEMS = BM * LDP + BK * LDV;
constexpr int SMEM_BYTES = STAGES * STAGE_ELEMS * (int)sizeof(bf16);

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices, transposed: lanes 8j .. 8j+7 give the row
// addresses of matrix j, and register j of a lane holds (row 2t, col g)
// and (row 2t + 1, col g) of matrix j (g = lane / 4, t = lane % 4)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// 16-byte asynchronous copy; with valid false the 16 bytes are zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// keys [k0, k0 + BK): P rows [row0, row0 + BM) and v rows; P's rows
// >= m and columns >= kp, and v's rows >= nv, are zero-filled
__device__ void load_stage(const bf16* __restrict__ p, const bf16* __restrict__ v, int m, int kp,
                          int nv, int dv, int row0, int k0, bf16* s) {
  bf16* ps = s;
  bf16* vs = s + BM * LDP;
  for (int i = threadIdx.x; i < BM * (BK / 8); i += THREADS) {
    const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
    const bool ok = row0 + r < m && k0 + c < kp;
    cp_async16(ps + r * LDP + c, ok ? p + (size_t)(row0 + r) * kp + k0 + c : p, ok);
  }
  const int vecs = dv / 8;
  for (int i = threadIdx.x; i < BK * vecs; i += THREADS) {
    const int r = i / vecs, c = (i % vecs) * 8;
    const bool ok = k0 + r < nv;
    cp_async16(vs + r * LDV + c, ok ? v + (size_t)(k0 + r) * dv + c : v, ok);
  }
}

__global__ void __launch_bounds__(THREADS)
apply_probs_bf16_kernel(const bf16* __restrict__ p, const bf16* __restrict__ v,
                        bf16* __restrict__ out, int m, int kp, int nv, int dv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int b = blockIdx.y, row0 = blockIdx.x * BM;
  p += (size_t)b * m * kp;
  v += (size_t)b * nv * dv;
  out += (size_t)b * m * dv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  float acc[MAXDV / 8][4];
#pragma unroll
  for (int j = 0; j < MAXDV / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  const int tiles = (kp + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles) load_stage(p, v, m, kp, nv, dv, row0, s * BK, smem + s * STAGE_ELEMS);
    cp_async_commit();
  }
  // the lane's row address within an x4 ldmatrix of v: matrices
  // (keys 0-7, cols 0-7), (keys 8-15, cols 0-7), (keys 0-7, cols 8-15),
  // (keys 8-15, cols 8-15) give b0, b1 of two adjacent 8-column tiles
  const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8, vcol = (lane >> 4) * 8;
  for (int kt = 0; kt < tiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt has landed; stage kt - 1 is consumed by all
    const int nxt = kt + STAGES - 1;
    if (nxt < tiles) load_stage(p, v, m, kp, nv, dv, row0, nxt * BK, smem + (nxt % STAGES) * STAGE_ELEMS);
    cp_async_commit();

    const bf16* ps = smem + (kt % STAGES) * STAGE_ELEMS;
    const bf16* vs = ps + BM * LDP;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const bf16* pa = ps + (warp * 16 + g) * LDP + kk + 2 * t;
      const uint32_t a[4] = {ld32(pa), ld32(pa + 8 * LDP), ld32(pa + 8), ld32(pa + 8 * LDP + 8)};
#pragma unroll
      for (int j2 = 0; j2 < MAXDV / 16; ++j2) {
        if (j2 * 16 < dv) {
          uint32_t bfrag[4];
          ldmatrix_x4_trans(bfrag, vs + (kk + vrow) * LDV + j2 * 16 + vcol);
          mma_bf16(acc[2 * j2], a, bfrag[0], bfrag[1]);
          mma_bf16(acc[2 * j2 + 1], a, bfrag[2], bfrag[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // rows g and g + 8 of the warp's 16, columns 8j + 2t and + 1
  const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < MAXDV / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (c < dv) {
      if (r0 < m)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r0 * dv + c) =
            __floats2bfloat162_rn(acc[j][0], acc[j][1]);
      if (r1 < m)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r1 * dv + c) =
            __floats2bfloat162_rn(acc[j][2], acc[j][3]);
    }
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
// all float32. Returns a cudaError_t (0 on success).
extern "C" int atdn_apply_probs(const void* p, const void* v, void* out, int b, int m, int kp,
                                int nv, int dv, int is_bf16, int device, void* stream) {
  if (b < 1 || b > 65535 || m < 1 || kp < 1 || kp % 8 || nv < 1 || nv > kp || dv < 16 ||
      dv > MAXDV || dv % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)b);
  if (is_bf16) {
    err = cudaFuncSetAttribute(apply_probs_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    apply_probs_bf16_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
        static_cast<const bf16*>(p), static_cast<const bf16*>(v), static_cast<bf16*>(out), m, kp,
        nv, dv);
  } else {
    apply_probs_f32_kernel<<<grid, 256, 0, st>>>(static_cast<const float*>(p),
                                                 static_cast<const float*>(v),
                                                 static_cast<float*>(out), m, kp, nv, dv);
  }
  return (int)cudaGetLastError();
}
