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
// at 3.35 TB/s). The kernel is bound by operations, so both products
// run on the tensor cores and nothing else touches device memory:
//   - one block of four warps per 64 query rows; each warp owns 16 rows
//     for the whole key loop (the TPU's sequential key grid becomes this
//     loop), with the running max m, the running sum l and the 16 x Dv
//     float32 accumulator in registers, laid out as mma.sync m16n8k16
//     fragments;
//   - tiles of 64 keys and values are staged in shared memory (v stored
//     transposed, so each value fragment is one 32-bit load);
//   - s = q k^T and acc += p v are mma.sync bf16 products with float32
//     accumulation; the score accumulators are re-packed in registers as
//     the A fragments of p v, with p cast to v's type first as the TPU
//     kernel does (:98), so p never goes through shared memory.
// Key columns >= Nk are masked to -1e30 (not -inf: a fully masked tile
// would give exp(-inf + inf) = NaN), ragged rows load as zeros, and no
// row >= Nq is written. Grid: 64-row blocks give 453 blocks at 2x KITTI
// (about 1.1 waves at the three blocks an SM holds) and 114 at KITTI
// size, fewer than the 132 SMs; larger blocks would cut the 453 to 227
// and leave a worse tail. float32 inputs take a plain-FMA kernel with
// the same loop (the GPU-vs-CPU agreement runs the model in float32).
// cp.async staging, ldmatrix, wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;         // query rows per block, 16 per warp
constexpr int BN = 64;         // keys per tile (bf16)
constexpr int FBN = 32;        // keys per tile (float32)
constexpr int THREADS = 128;   // four warps
constexpr int MAXD = 128;      // D and Dv up to 128, multiples of 16
constexpr int PAD = 8;         // bf16 shared-memory row padding (elements)
constexpr int FPAD = 4;        // float32 shared-memory row padding
constexpr float NEG = -1e30f;  // the TPU kernel's mask value

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a b, a 16x16 (row), b 16x8 (col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

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

// rows [row0, row0 + BN) of the row-major (n, dv) bf16 values, stored
// transposed: vt[c * (BN + PAD) + r]; rows >= n are zero. Consecutive
// threads take consecutive rows, so their 2-byte stores share banks
// only pairwise.
__device__ void load_rows_t(const bf16* __restrict__ g, int n, int dv, int row0, bf16* vt) {
  const int vecs = dv / 8;
  for (int i = threadIdx.x; i < BN * vecs; i += THREADS) {
    const int r = i % BN, c = (i / BN) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) v = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * dv + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) vt[(c + j) * (BN + PAD) + r] = e[j];
  }
}

__global__ void __launch_bounds__(THREADS)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out, int nq, int nk, int d,
                  int dv, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldq = d + PAD, ldv = BN + PAD;
  bf16* qs = reinterpret_cast<bf16*>(smem);  // BM x ldq
  bf16* ks = qs + BM * ldq;                  // BN x ldq
  bf16* vt = ks + BN * ldq;                  // dv x ldv
  const int b = blockIdx.y, row0 = blockIdx.x * BM;
  q += (size_t)b * nq * d;
  k += (size_t)b * nk * d;
  v += (size_t)b * nk * dv;
  out += (size_t)b * nq * dv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group and column pair
  const bf16* qw = qs + warp * 16 * ldq;

  load_rows(q, nq, d, row0, BM, PAD, qs);

  // this thread's rows of the warp's 16: g (fragment slots 0, 1) and
  // g + 8 (slots 2, 3)
  float acc[MAXD / 8][4];
#pragma unroll
  for (int j = 0; j < MAXD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  float m0 = NEG, m1 = NEG, l0 = 0.0f, l1 = 0.0f;

  for (int col0 = 0; col0 < nk; col0 += BN) {
    __syncthreads();  // the previous tile is consumed
    load_rows(k, nk, d, col0, BN, PAD, ks);
    load_rows_t(v, nk, dv, col0, vt);
    __syncthreads();

    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < MAXD; kk += 16) {
      if (kk < d) {
        const bf16* qa = qw + g * ldq + kk + 2 * t;
        const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * ldq);
        const uint32_t a2 = ld32(qa + 8), a3 = ld32(qa + 8 * ldq + 8);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const bf16* kb = ks + (j * 8 + g) * ldq + kk + 2 * t;
          mma_bf16(s[j], a0, a1, a2, a3, ld32(kb), ld32(kb + 8));
        }
      }
    }

    // scale, mask, and the online softmax of rows g and g + 8
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = col0 + j * 8 + 2 * t + e < nk;
        s[j][e] = ok ? s[j][e] * scale : NEG;
        s[j][2 + e] = ok ? s[j][2 + e] * scale : NEG;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
    // the four lanes of a row group hold one row between them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = __expf(m0 - mn0), c1 = __expf(m1 - mn1);
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = __expf(s[j][e] - mn0);
        s[j][2 + e] = __expf(s[j][2 + e] - mn1);
        sum0 += s[j][e];
        sum1 += s[j][2 + e];
      }
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    l0 = c0 * l0 + sum0;
    l1 = c1 * l1 + sum1;
    m0 = mn0;
    m1 = mn1;

    // acc = acc * correction + p v, p in bf16: the accumulators of two
    // adjacent 8-key score tiles are the A fragment of one 16-key step
#pragma unroll
    for (int j = 0; j < MAXD / 8; ++j) {
      acc[j][0] *= c0;
      acc[j][1] *= c0;
      acc[j][2] *= c1;
      acc[j][3] *= c1;
    }
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      const uint32_t a0 = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      const uint32_t a1 = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      const uint32_t a2 = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int j = 0; j < MAXD / 8; ++j) {
        if (j * 8 < dv) {
          const bf16* vb = vt + (j * 8 + g) * ldv + kc * 16 + 2 * t;
          mma_bf16(acc[j], a0, a1, a2, a3, ld32(vb), ld32(vb + 8));
        }
      }
    }
  }

  const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < MAXD / 8; ++j) {
    if (j * 8 < dv) {
      const int col = j * 8 + 2 * t;
      if (r0 < nq)
        *reinterpret_cast<uint32_t*>(out + (size_t)r0 * dv + col) =
            pack_bf16(acc[j][0] / l0, acc[j][1] / l0);
      if (r1 < nq)
        *reinterpret_cast<uint32_t*>(out + (size_t)r1 * dv + col) =
            pack_bf16(acc[j][2] / l1, acc[j][3] / l1);
    }
  }
}

// float32: the same loop with plain FMA over shared-memory tiles. For
// the scores and the output, thread (ty, tx) of a 16 x 8 layout owns
// rows 4ty .. 4ty + 3 and columns tx + 8j; for the softmax, threads 2r
// and 2r + 1 own row r, 16 key columns each.
__global__ void __launch_bounds__(THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int nq, int nk, int d,
                 int dv, float scale) {
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
        ps[(ty * 4 + i) * ldp + tx + 8 * j] = col0 + tx + 8 * j < nk ? s[i][j] * scale : NEG;
    __syncthreads();

    float* prow = ps + pr * ldp + ph * (FBN / 2);
    float mx = NEG;
#pragma unroll
    for (int c = 0; c < FBN / 2; ++c) mx = fmaxf(mx, prow[c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float mn = fmaxf(m_run, mx);
    const float cr = expf(m_run - mn);
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < FBN / 2; ++c) {
      const float p = expf(prow[c] - mn);
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

}  // namespace

// q (b, nq, d), k (b, nk, d), v (b, nk, dv), out (b, nq, dv), all
// contiguous with 16-byte aligned starts, all bf16 (is_bf16 = 1) or all
// float32. Requires d and dv multiples of 16 in [16, 128]. Returns a
// cudaError_t (0 on success).
extern "C" int atdn_flash_attend(const void* q, const void* k, const void* v, void* out, int b,
                                 int nq, int nk, int d, int dv, float scale, int is_bf16,
                                 int device, void* stream) {
  if (b < 1 || b > 65535 || nq < 1 || nk < 1 || d % 16 || dv % 16 || d < 16 || dv < 16 ||
      d > MAXD || dv > MAXD)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((nq + BM - 1) / BM, b);
  if (is_bf16) {
    const int smem = ((BM + BN) * (d + PAD) + dv * (BN + PAD)) * (int)sizeof(bf16);
    err = cudaFuncSetAttribute(flash_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bf16_kernel<<<grid, THREADS, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(out), nq, nk, d, dv, scale);
  } else {
    const int smem =
        ((BM + FBN) * (d + FPAD) + FBN * (dv + FPAD) + BM * (FBN + 1)) * (int)sizeof(float);
    err = cudaFuncSetAttribute(flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    flash_f32_kernel<<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(out), nq, nk, d, dv, scale);
  }
  return (int)cudaGetLastError();
}
