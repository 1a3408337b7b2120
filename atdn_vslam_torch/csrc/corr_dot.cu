// One level of the all-pairs correlation pyramid:
// out[b, n, m] = inv_sqrt_c * sum_c f1[b, n, c] f2[b, m, c], summed in
// float32, scaled in float32, cast once and written row-major (B, N, M):
// the (B, N1, H_l, W_l) layout the window lookup (csrc/corr_lookup.cu)
// reads, with no copy in between.
//
// Replaces the TPU kernel atdn_vslam_tpu/ops/corr_lookup.py:
// corr_dot_rowmajor (_corr_dot_kernel).
//
// Bound on an H100 at 2x KITTI level 0 (N = M = 28952, C = 256, bf16 in
// and out): it writes 28952^2 x 2 B = 1.68 GB (0.50 ms at 3.35 TB/s)
// and does 2 * N * M * C = 4.29e11 FLOP (0.434 ms at the bf16 peak):
// bound by bytes, with the products close behind. So the design keeps
// the products on the tensor cores and writes every output byte once,
// in full sectors, with the tile loop of corr_dot_tiles.cuh (mma.sync
// bf16 or FMA float32, 128 x 128 tiles, both operands staged by
// cp.async, rows written with 16-byte stores where M allows): at 2x the
// level widths are 28952 (vector stores), 7238, 1771 and 418 (element
// stores; 418 x 2 B = 836 B rows).
// wgmma, TMA and a persistent tile loop are later work.

#include "corr_dot_tiles.cuh"

namespace {

using namespace corr_dot_tiles;

// f2 rows [col0, col0 + BN) x channels [k0, k0 + BK): row-major (m, c)
template <typename T>
struct RowMajorRows {
  const T* g;
  int m, c;
  __device__ void operator()(int col0, int k0, T* s) const { load_stage(g, m, c, col0, k0, s); }
};

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
corr_dot_kernel(const Tin* __restrict__ f1, const Tin* __restrict__ f2, Tout* __restrict__ out,
                int n, int m, int c, float inv_sqrt_c) {
  const int b = blockIdx.z;
  corr_dot_tile<Tin, Tout>(f1 + (size_t)b * n * c, RowMajorRows<Tin>{f2 + (size_t)b * m * c, m, c},
                           out + (size_t)b * n * m, n, m, c, inv_sqrt_c, blockIdx.y * BM,
                           blockIdx.x * BN);
}

template <typename Tin, typename Tout>
int launch(const void* f1, const void* f2, void* out, int b, int n, int m, int c, float scale,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<Tin, Tout>();
  cudaError_t err = cudaFuncSetAttribute(corr_dot_kernel<Tin, Tout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM, b);
  corr_dot_kernel<Tin, Tout><<<grid, THREADS, smem, stream>>>(
      static_cast<const Tin*>(f1), static_cast<const Tin*>(f2), static_cast<Tout*>(out), n, m, c,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// f1 (b, n, c), f2 (b, m, c): contiguous with 16-byte aligned starts,
// both bf16 (in_bf16 = 1) or both float32; out (b, n, m) contiguous,
// bf16 (out_bf16 = 1) or float32, 16-byte aligned. Requires c a multiple
// of 8. Returns a cudaError_t (0 on success).
extern "C" int atdn_corr_dot(const void* f1, const void* f2, void* out, int b, int n, int m, int c,
                             float inv_sqrt_c, int in_bf16, int out_bf16, int device,
                             void* stream) {
  if (b < 1 || b > 65535 || n < 1 || m < 1 || c < 8 || c % 8 || (n + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto st = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return out_bf16 ? launch<bf16, bf16>(f1, f2, out, b, n, m, c, inv_sqrt_c, st)
                    : launch<bf16, float>(f1, f2, out, b, n, m, c, inv_sqrt_c, st);
  return out_bf16 ? launch<float, bf16>(f1, f2, out, b, n, m, c, inv_sqrt_c, st)
                  : launch<float, float>(f1, f2, out, b, n, m, c, inv_sqrt_c, st);
}
