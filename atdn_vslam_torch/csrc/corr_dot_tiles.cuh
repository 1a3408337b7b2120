// Device code shared by the correlation-volume kernels K3
// (corr_dot.cu, f2 row-major) and K3t (corr_dot_tiled.cu, f2 read
// through its strides): out[b, n, m] = scale * sum_c f1[b, n, c] f2[b, m, c]
// summed in float32, cast once, written row-major (B, N, M).
//
//   - one block of eight warps per 128 x 128 output tile; each warp
//     computes 64 x 32 with mma.sync m16n8k16 bf16, float32 accumulation
//     (float32 inputs: plain FMA, 8 x 8 outputs per thread);
//   - f1 and f2 tiles of 32 channels go through shared memory in two
//     stages (f1 by cp.async, ragged rows zero-filled by the copy; f2 by
//     the kernel's own loader);
//   - the epilogue scales, casts, stages the tile in shared memory and
//     writes each row with 16-byte stores when every row of the output
//     starts 16-byte aligned (M a multiple of 8 for bf16, of 4 for
//     float32), and with element stores by consecutive threads otherwise.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace corr_dot_tiles {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;       // rows of f1 per tile
constexpr int BN = 128;       // rows of f2 per tile
constexpr int BK = 32;        // channels per stage
constexpr int THREADS = 256;  // eight warps

template <typename T> struct Ld;  // shared-memory row strides (elements)
template <> struct Ld<bf16> { static constexpr int IN = BK + 8, OUT = BN + 8; };
template <> struct Ld<float> { static constexpr int IN = BK + 4, OUT = BN + 4; };

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

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

// rows [row0, row0 + 128) x channels [k0, k0 + BK) of a row-major
// (n, c) matrix into shared memory; rows >= n and channels >= c are zero
template <typename T>
__device__ void load_stage(const T* __restrict__ g, int n, int c, int row0, int k0, T* s) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = BK / VEC;
  for (int i = threadIdx.x; i < BM * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, cc = (i % CHUNKS) * VEC;
    const bool ok = row0 + r < n && k0 + cc < c;
    const T* src = ok ? g + (size_t)(row0 + r) * c + k0 + cc : g;
    cp_async16(s + r * Ld<T>::IN + cc, src, ok);
  }
}

// bf16 tiles: warp (wm, wn) of a 2 x 4 layout owns rows 64wm .. +63 and
// columns 32wn .. +31: 4 x 4 fragments of 16 x 8
struct MmaTile {
  float acc[4][4][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;
  }

  __device__ void step(const bf16* as, const bf16* bs) {
    constexpr int LD = Ld<bf16>::IN;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / 4, wn = warp % 4, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bf16* p = as + (wm * 64 + i * 16 + g) * LD + kk + 2 * t;
        a[i][0] = ld32(p);
        a[i][1] = ld32(p + 8 * LD);
        a[i][2] = ld32(p + 8);
        a[i][3] = ld32(p + 8 * LD + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16* p = bs + (wn * 32 + j * 8 + g) * LD + kk + 2 * t;
        b[j][0] = ld32(p);
        b[j][1] = ld32(p + 8);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }

  template <typename Tout>
  __device__ void stage_out(Tout* cs, float scale) const {
    constexpr int LD = Ld<Tout>::OUT;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / 4, wn = warp % 4, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = wm * 64 + i * 16 + g, c = wn * 32 + j * 8 + 2 * t;
        cs[r * LD + c] = from_float<Tout>(acc[i][j][0] * scale);
        cs[r * LD + c + 1] = from_float<Tout>(acc[i][j][1] * scale);
        cs[(r + 8) * LD + c] = from_float<Tout>(acc[i][j][2] * scale);
        cs[(r + 8) * LD + c + 1] = from_float<Tout>(acc[i][j][3] * scale);
      }
  }
};

// float32 tiles: thread (ty, tx) of a 16 x 16 layout owns rows
// ty + 16i and columns tx + 16j
struct FmaTile {
  float acc[8][8];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  __device__ void step(const float* as, const float* bs) {
    constexpr int LD = Ld<float>::IN;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = as[(ty + 16 * i) * LD + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = bs[(tx + 16 * j) * LD + kk];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  template <typename Tout>
  __device__ void stage_out(Tout* cs, float scale) const {
    constexpr int LD = Ld<Tout>::OUT;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) cs[(ty + 16 * i) * LD + tx + 16 * j] = from_float<Tout>(acc[i][j] * scale);
  }
};

template <typename Tin> struct TileFor;
template <> struct TileFor<bf16> { typedef MmaTile type; };
template <> struct TileFor<float> { typedef FmaTile type; };

template <typename Tin, typename Tout>
constexpr int smem_bytes() {
  constexpr int main_loop = 2 * (BM + BN) * Ld<Tin>::IN * (int)sizeof(Tin);
  constexpr int epilogue = BM * Ld<Tout>::OUT * (int)sizeof(Tout);
  return main_loop > epilogue ? main_loop : epilogue;
}

// One 128 x 128 output tile at (row0, col0) of the (n, m) product of f1
// (n, c, row-major) and the f2 rows that load_b(col0, k0, dst) stages
// into shared memory as BN x BK (row stride Ld<Tin>::IN, zeros past m
// and c). f1 and out point at this batch's matrices.
template <typename Tin, typename Tout, typename LoadB>
__device__ void corr_dot_tile(const Tin* __restrict__ f1, const LoadB& load_b,
                              Tout* __restrict__ out, int n, int m, int c, float scale, int row0,
                              int col0) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = Ld<Tin>::IN;
  Tin* as = reinterpret_cast<Tin*>(smem);  // 2 stages of BM x LD
  Tin* bs = as + 2 * BM * LD;              // 2 stages of BN x LD

  typename TileFor<Tin>::type tile;
  tile.zero();
  const int stages = (c + BK - 1) / BK;
  load_stage(f1, n, c, row0, 0, as);
  load_b(col0, 0, bs);
  cp_async_commit();
  for (int kt = 0; kt < stages; ++kt) {
    if (kt + 1 < stages) {
      const int nxt = (kt + 1) & 1;
      load_stage(f1, n, c, row0, (kt + 1) * BK, as + nxt * BM * LD);
      load_b(col0, (kt + 1) * BK, bs + nxt * BN * LD);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    tile.step(as + (kt & 1) * BM * LD, bs + (kt & 1) * BN * LD);
    __syncthreads();  // the stage is consumed before it is refilled
  }

  // epilogue: through shared memory, then whole rows to device memory
  constexpr int LDC = Ld<Tout>::OUT;
  Tout* cs = reinterpret_cast<Tout*>(smem);
  tile.template stage_out<Tout>(cs, scale);
  __syncthreads();
  const int cols = min(BN, m - col0);
  constexpr int VEC = 16 / sizeof(Tout);
  if (m % VEC == 0) {  // every row starts 16-byte aligned
    constexpr int PER_ROW = BN / VEC;
    for (int i = threadIdx.x; i < BM * PER_ROW; i += THREADS) {
      const int r = i / PER_ROW, cc = (i % PER_ROW) * VEC;
      if (row0 + r < n && cc < cols)
        *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * m + col0 + cc) =
            *reinterpret_cast<const uint4*>(cs + r * LDC + cc);
    }
  } else {
    for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
      const int r = i / BN, cc = i % BN;
      if (row0 + r < n && cc < cols) out[(size_t)(row0 + r) * m + col0 + cc] = cs[r * LDC + cc];
    }
  }
}

}  // namespace corr_dot_tiles
