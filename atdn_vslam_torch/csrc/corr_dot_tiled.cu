// One level of the correlation pyramid with f2 given as a 4-D map:
// out[b, n, h, w] = inv_sqrt_c * sum_c f1[b, n, c] f2[b, h, w, c], summed
// in float32, scaled in float32, cast once, written as (B, N, Hl, Wl):
// each query's whole (Hl, Wl) window of the level, whole Wl-runs back
// to back, the layout the window lookup (csrc/corr_lookup.cu) reads.
//
// Replaces the TPU kernel tools/profiling/exp_r5_tileddot.py:
// corr_dot_tiled (_tiled_dot_kernel), which emitted the volume as the
// 4-D array so that no relayout copy followed it on the TPU.
//
// Bound on an H100 at the KITTI pyramid (N = 7238, C = 256, levels
// 47x154, 23x77, 11x38, 5x19; bf16 in and out): it writes
// 7238 x 9522 x 2 B = 138 MB (41 us at 3.35 TB/s) and does
// 2 x 7238 x 9522 x 256 = 3.5e10 FLOP (36 us at the bf16 peak): bound by
// bytes, with the products close behind. The products run on the tensor
// cores through the tile loop of corr_dot_tiles.cuh (128 x 128 tiles,
// mma.sync bf16 or FMA float32), and every output byte is written once.
// What differs from K3 (corr_dot.cu): f2 is read through its four
// strides, so the NHWC view of the feature encoder's NCHW output (level
// 0 of the pyramid, channel stride Hl * Wl) needs no copy first; the
// loader walks the unit-stride axis with consecutive threads (channels
// for a channels-last map, positions for a channels-first one) and
// stores the tile to shared memory as K3's loader does.

#include "corr_dot_tiles.cuh"

namespace {

using namespace corr_dot_tiles;

// f2 positions [col0, col0 + BN) x channels [k0, k0 + BK) of a
// (Hl, Wl, C) map with element strides (sh, sw, sc); position p is
// (p / wl, p % wl); zeros past m = Hl * Wl and c
template <typename T>
struct StridedRows {
  const T* g;
  long long sh, sw, sc;
  int wl, m, c;
  __device__ void operator()(int col0, int k0, T* s) const {
    constexpr int LD = Ld<T>::IN;
    const bool channels_fastest = sc == 1;
    for (int i = threadIdx.x; i < BN * BK; i += THREADS) {
      const int r = channels_fastest ? i / BK : i % BN;
      const int kc = channels_fastest ? i % BK : i / BN;
      const int p = col0 + r, ch = k0 + kc;
      T v = from_float<T>(0.0f);
      if (p < m && ch < c) v = g[(p / wl) * sh + (p % wl) * sw + ch * sc];
      s[r * LD + kc] = v;
    }
  }
};

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
corr_dot_tiled_kernel(const Tin* __restrict__ f1, const Tin* __restrict__ f2, Tout* __restrict__ out,
                      int n, int hl, int wl, int c, long long sb, long long sh, long long sw,
                      long long sc, float inv_sqrt_c) {
  const int b = blockIdx.z, m = hl * wl;
  corr_dot_tile<Tin, Tout>(f1 + (size_t)b * n * c, StridedRows<Tin>{f2 + b * sb, sh, sw, sc, wl, m, c},
                           out + (size_t)b * n * m, n, m, c, inv_sqrt_c, blockIdx.y * BM,
                           blockIdx.x * BN);
}

template <typename Tin, typename Tout>
int launch(const void* f1, const void* f2, void* out, int b, int n, int hl, int wl, int c,
           long long sb, long long sh, long long sw, long long sc, float scale,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<Tin, Tout>();
  cudaError_t err = cudaFuncSetAttribute(corr_dot_tiled_kernel<Tin, Tout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((hl * wl + BN - 1) / BN, (n + BM - 1) / BM, b);
  corr_dot_tiled_kernel<Tin, Tout><<<grid, THREADS, smem, stream>>>(
      static_cast<const Tin*>(f1), static_cast<const Tin*>(f2), static_cast<Tout*>(out), n, hl,
      wl, c, sb, sh, sw, sc, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// f1 (b, n, c) contiguous with a 16-byte aligned start; f2 (b, hl, wl, c)
// with element strides (sb, sh, sw, sc), the same type as f1, bf16
// (in_bf16 = 1) or float32; out (b, n, hl, wl) contiguous, 16-byte
// aligned, bf16 (out_bf16 = 1) or float32. Requires c a multiple of 8
// and hl, wl >= 1. Returns a cudaError_t (0 on success).
extern "C" int atdn_corr_dot_tiled(const void* f1, const void* f2, void* out, int b, int n, int hl,
                                   int wl, int c, long long sb, long long sh, long long sw,
                                   long long sc, float inv_sqrt_c, int in_bf16, int out_bf16,
                                   int device, void* stream) {
  if (b < 1 || b > 65535 || n < 1 || hl < 1 || wl < 1 || c < 8 || c % 8 ||
      (n + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto st = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return out_bf16
               ? launch<bf16, bf16>(f1, f2, out, b, n, hl, wl, c, sb, sh, sw, sc, inv_sqrt_c, st)
               : launch<bf16, float>(f1, f2, out, b, n, hl, wl, c, sb, sh, sw, sc, inv_sqrt_c, st);
  return out_bf16
             ? launch<float, bf16>(f1, f2, out, b, n, hl, wl, c, sb, sh, sw, sc, inv_sqrt_c, st)
             : launch<float, float>(f1, f2, out, b, n, hl, wl, c, sb, sh, sw, sc, inv_sqrt_c, st);
}
