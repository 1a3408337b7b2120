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
// bound by bytes, with the products close behind, so the products have
// to run on the tensor cores at close to their full rate while the
// output streams out. bf16 inputs take the core of corr_dot_wgmma.cuh as
// it is (f1 and f2 are both row-major (rows, C), the K-major operands of
// its tensor maps): TMA loads into an mbarrier ring, wgmma products, two
// blocks per SM so that one block's stores overlap the other's products,
// and 16-byte stores of every row's body whatever M is (2x KITTI's
// level widths 28952, 7238, 1771 and 418 start their rows at one, four,
// eight and four alignments). float32 inputs (the GPU-vs-CPU agreement
// runs the model in float32) keep the FMA tile loop of corr_dot_tiles.cuh.
// Not done: a persistent tile loop, TMA stores, a cluster multicast of f1.

#include "corr_dot_tiles.cuh"
#include "corr_dot_wgmma.cuh"

namespace {

using namespace corr_dot_tiles;

// f2 rows [col0, col0 + BN) x channels [k0, k0 + BK): row-major (m, c)
struct RowMajorRows {
  const float* g;
  int m, c;
  __device__ void operator()(int col0, int k0, float* s) const { load_stage(g, m, c, col0, k0, s); }
};

template <typename Tout>
__global__ void __launch_bounds__(THREADS)
corr_dot_kernel(const float* __restrict__ f1, const float* __restrict__ f2, Tout* __restrict__ out,
                int n, int m, int c, float inv_sqrt_c) {
  const int b = blockIdx.z;
  corr_dot_tile<Tout>(f1 + (size_t)b * n * c, RowMajorRows{f2 + (size_t)b * m * c, m, c},
                      out + (size_t)b * n * m, n, m, c, inv_sqrt_c, blockIdx.y * BM,
                      blockIdx.x * BN);
}

template <typename Tout>
int launch_f32(const void* f1, const void* f2, void* out, int b, int n, int m, int c, float scale,
               cudaStream_t stream) {
  constexpr int smem = smem_bytes<Tout>();
  cudaError_t err = cudaFuncSetAttribute(corr_dot_kernel<Tout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM, b);
  corr_dot_kernel<Tout><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(f1), static_cast<const float*>(f2), static_cast<Tout*>(out), n, m,
      c, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// f1 (b, n, c), f2 (b, m, c): contiguous with 16-byte aligned starts,
// both bf16 (in_bf16 = 1) or both float32; out (b, n, m) contiguous,
// bf16 (out_bf16 = 1) or float32, 16-byte aligned. Requires c a multiple
// of 8. Returns a cudaError_t (0 on success), or
// hopper::TENSOR_MAP_ERROR + a CUresult.
extern "C" int atdn_corr_dot(const void* f1, const void* f2, void* out, int b, int n, int m, int c,
                             float inv_sqrt_c, int in_bf16, int out_bf16, int device,
                             void* stream) {
  if (b < 1 || b > 65535 || n < 1 || m < 1 || c < 8 || c % 8 || (n + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto st = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return out_bf16 ? corr_dot_wgmma::launch<bf16>(f1, f2, out, b, n, m, c, inv_sqrt_c, st)
                    : corr_dot_wgmma::launch<float>(f1, f2, out, b, n, m, c, inv_sqrt_c, st);
  return out_bf16 ? launch_f32<bf16>(f1, f2, out, b, n, m, c, inv_sqrt_c, st)
                  : launch_f32<float>(f1, f2, out, b, n, m, c, inv_sqrt_c, st);
}

// blocks of the bf16-input kernel resident per SM, for bf16 (out_bf16 =
// 1) or float32 output; returns a cudaError_t
extern "C" int atdn_corr_dot_occupancy(int out_bf16, int* blocks, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return out_bf16 ? corr_dot_wgmma::occupancy<corr_dot_wgmma::ScaleCast<bf16>>(blocks)
                  : corr_dot_wgmma::occupancy<corr_dot_wgmma::ScaleCast<float>>(blocks);
}
