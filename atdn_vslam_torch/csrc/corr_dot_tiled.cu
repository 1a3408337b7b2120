// One level of the correlation pyramid with f2 given as a 4-D map:
// out[b, n, h, w] = inv_sqrt_c * sum_c f1[b, n, c] f2[b, h, w, c], summed
// in float32, scaled in float32, cast once, written as (B, N, Hl, Wl):
// each query's whole (Hl, Wl) window of the level, whole Wl-runs back
// to back, the layout the window lookup (csrc/corr_lookup.cu) reads.
//
// Replaces the TPU kernel tools/profiling/exp_r5_tileddot.py:
// corr_dot_tiled (_tiled_dot_kernel), which emitted the volume as the
// 4-D array so that no relayout copy of the *output* followed it on the
// TPU. The output's layout is kept here: (B, N, Hl, Wl) is the same bytes
// as (B, N, M) row-major with M = Hl * Wl.
//
// Bound on an H100 at the KITTI pyramid (N = 7238, C = 256, levels
// 47x154, 23x77, 11x38, 5x19; bf16 in and out): it writes
// 7238 x 9522 x 2 B = 138 MB (41 us at 3.35 TB/s) and does
// 2 x 7238 x 9522 x 256 = 3.5e10 FLOP (36 us at the bf16 peak): bound by
// bytes, with the products close behind. bf16 inputs run the TMA +
// wgmma core of corr_dot_wgmma.cuh (two blocks per SM, 16-byte stores of
// every row's body: all four KITTI widths 7238, 1771, 418 and 95 leave
// rows unaligned). The core reads f2 through a tensor map, which needs
// every stride but the channels' to be a multiple of 16 bytes. A
// contiguous channels-last f2 is read as it is. Any other f2 is first
// staged K-major into a (B, M, C) scratch buffer by stage_f2_kernel, a
// shared-memory transpose: level 0 of the pyramid is the NHWC view of
// the feature encoder's NCHW output, whose channel stride Hl * Wl * 2 =
// 14,476 bytes at KITTI is no multiple of 16, so no tensor map can
// describe it. The staging pass moves 2 x 3.7 MB there, a few us against
// the kernel's 44 us bound. float32 inputs keep the FMA tile loop of
// corr_dot_tiles.cuh with a loader that reads f2 through its strides.
// Not done: a persistent tile loop, TMA stores, a cluster multicast of f1.

#include "corr_dot_tiles.cuh"
#include "corr_dot_wgmma.cuh"

namespace {

using namespace corr_dot_tiles;

// f2 positions [col0, col0 + BN) x channels [k0, k0 + BK) of a float32
// (Hl, Wl, C) map with element strides (sh, sw, sc); position p is
// (p / wl, p % wl); zeros past m = Hl * Wl and c
struct StridedRows {
  const float* g;
  long long sh, sw, sc;
  int wl, m, c;
  __device__ void operator()(int col0, int k0, float* s) const {
    const bool channels_fastest = sc == 1;
    for (int i = threadIdx.x; i < BN * BK; i += THREADS) {
      const int r = channels_fastest ? i / BK : i % BN;
      const int kc = channels_fastest ? i % BK : i / BN;
      const int p = col0 + r, ch = k0 + kc;
      float v = 0.0f;
      if (p < m && ch < c) v = g[(p / wl) * sh + (p % wl) * sw + ch * sc];
      s[r * LD_IN + kc] = v;
    }
  }
};

template <typename Tout>
__global__ void __launch_bounds__(THREADS)
corr_dot_tiled_kernel(const float* __restrict__ f1, const float* __restrict__ f2, Tout* __restrict__ out,
                      int n, int hl, int wl, int c, long long sb, long long sh, long long sw,
                      long long sc, float inv_sqrt_c) {
  const int b = blockIdx.z, m = hl * wl;
  corr_dot_tile<Tout>(f1 + (size_t)b * n * c, StridedRows{f2 + b * sb, sh, sw, sc, wl, m, c},
                      out + (size_t)b * n * m, n, m, c, inv_sqrt_c, blockIdx.y * BM,
                      blockIdx.x * BN);
}

template <typename Tout>
int launch_f32(const void* f1, const void* f2, void* out, int b, int n, int hl, int wl, int c,
               long long sb, long long sh, long long sw, long long sc, float scale,
               cudaStream_t stream) {
  constexpr int smem = smem_bytes<Tout>();
  cudaError_t err = cudaFuncSetAttribute(corr_dot_tiled_kernel<Tout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((hl * wl + BN - 1) / BN, (n + BM - 1) / BM, b);
  corr_dot_tiled_kernel<Tout><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(f1), static_cast<const float*>(f2), static_cast<Tout*>(out), n, hl,
      wl, c, sb, sh, sw, sc, scale);
  return (int)cudaGetLastError();
}

constexpr int TP = 64;  // staging tile: positions
constexpr int TC = 64;  // staging tile: channels

// dst (b, m, c) contiguous = the bf16 (b, hl, wl, c) map f2 with element
// strides (sb, sh, sw, sc). Reads walk the unit-stride axis with
// consecutive threads (positions for a channels-first map, channels
// otherwise); writes are 16 bytes (8 channels) a thread.
__global__ void __launch_bounds__(256)
stage_f2_kernel(const bf16* __restrict__ f2, bf16* __restrict__ dst, int hl, int wl, int c,
                long long sb, long long sh, long long sw, long long sc) {
  __shared__ __align__(16) bf16 tile[TP][TC + 8];
  const int p0 = blockIdx.x * TP, c0 = blockIdx.y * TC, b = blockIdx.z, m = hl * wl;
  const bf16* src = f2 + b * sb;
  const bool channels_fastest = sc == 1;
  for (int i = threadIdx.x; i < TP * TC; i += 256) {
    const int pp = channels_fastest ? i / TC : i % TP;
    const int cc = channels_fastest ? i % TC : i / TP;
    const int p = p0 + pp, ch = c0 + cc;
    bf16 v = __float2bfloat16(0.0f);
    if (p < m && ch < c) v = src[(p / wl) * sh + (p % wl) * sw + ch * sc];
    tile[pp][cc] = v;
  }
  __syncthreads();
  bf16* out = dst + (size_t)b * m * c;
  for (int i = threadIdx.x; i < TP * (TC / 8); i += 256) {
    const int pp = i / (TC / 8), cc = (i % (TC / 8)) * 8;
    const int p = p0 + pp, ch = c0 + cc;
    if (p < m && ch < c)  // c is a multiple of 8: a chunk is wholly in or out
      *reinterpret_cast<uint4*>(out + (size_t)p * c + ch) = *reinterpret_cast<const uint4*>(&tile[pp][cc]);
  }
}

}  // namespace

// f1 (b, n, c) contiguous with a 16-byte aligned start; f2 (b, hl, wl, c)
// with element strides (sb, sh, sw, sc), the same type as f1, bf16
// (in_bf16 = 1) or float32; out (b, n, hl, wl) contiguous, 16-byte
// aligned, bf16 (out_bf16 = 1) or float32. Requires c a multiple of 8
// and hl, wl >= 1. For bf16 inputs, scratch is null when f2 is contiguous
// with a 16-byte aligned start (read as it is), and otherwise a
// contiguous (b, hl * wl, c) bf16 buffer with a 16-byte aligned start,
// which f2 is copied into first; float32 inputs ignore it. Returns a
// cudaError_t (0 on success), or hopper::TENSOR_MAP_ERROR + a CUresult.
extern "C" int atdn_corr_dot_tiled(const void* f1, const void* f2, void* scratch, void* out, int b,
                                   int n, int hl, int wl, int c, long long sb, long long sh,
                                   long long sw, long long sc, float inv_sqrt_c, int in_bf16,
                                   int out_bf16, int device, void* stream) {
  if (b < 1 || b > 65535 || n < 1 || hl < 1 || wl < 1 || c < 8 || c % 8 ||
      (n + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto st = static_cast<cudaStream_t>(stream);
  const int m = hl * wl;
  if (!in_bf16)
    return out_bf16
               ? launch_f32<bf16>(f1, f2, out, b, n, hl, wl, c, sb, sh, sw, sc, inv_sqrt_c, st)
               : launch_f32<float>(f1, f2, out, b, n, hl, wl, c, sb, sh, sw, sc, inv_sqrt_c, st);
  const void* rows = f2;
  if (scratch != nullptr) {
    const dim3 grid((m + TP - 1) / TP, (c + TC - 1) / TC, b);
    stage_f2_kernel<<<grid, 256, 0, st>>>(static_cast<const bf16*>(f2), static_cast<bf16*>(scratch),
                                          hl, wl, c, sb, sh, sw, sc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rows = scratch;
  } else {
    // read as it is: dense channels-last (strides of unit dimensions aside)
    const bool dense = sc == 1 && (wl == 1 || sw == c) && (hl == 1 || sh == (long long)wl * c) &&
                       (b == 1 || sb == (long long)m * c);
    if (!dense || reinterpret_cast<uintptr_t>(f2) % 16) return (int)cudaErrorInvalidValue;
  }
  return out_bf16 ? corr_dot_wgmma::launch<bf16>(f1, rows, out, b, n, m, c, inv_sqrt_c, st)
                  : corr_dot_wgmma::launch<float>(f1, rows, out, b, n, m, c, inv_sqrt_c, st);
}

// blocks of the bf16-input kernel resident per SM, for bf16 (out_bf16 =
// 1) or float32 output; returns a cudaError_t
extern "C" int atdn_corr_dot_tiled_occupancy(int out_bf16, int* blocks, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return out_bf16 ? corr_dot_wgmma::occupancy<corr_dot_wgmma::ScaleCast<bf16>>(blocks)
                  : corr_dot_wgmma::occupancy<corr_dot_wgmma::ScaleCast<float>>(blocks);
}
