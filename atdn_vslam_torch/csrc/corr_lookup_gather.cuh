// The gather of the correlation-window lookups over (B * N, Hl, Wl)
// levels, all levels of a query in one launch: K2 (corr_lookup.cu) and
// K2s (corr_lookup_slab.cu, whose levels are row-padded to Hp). Only the
// arithmetic that turns a level's taps into its window differs, and it
// is a template parameter, the epilogue.
//
// One warp takes one query, all levels:
//   - its lanes load the query's whole patches first, a level's
//     (2r+2)^2 taps around the centre over 32 lanes (lanes on
//     neighbouring columns of a patch row, so one load instruction
//     touches a few 32-byte sectors), all loads of all levels issued
//     before any is used. The patch rows start at any 2-byte alignment
//     (a query's level-0 slice is 14,476 bytes at KITTI), so the loads
//     stay scalar. Rows outside [0, H) and columns outside [0, W) are
//     zero, H being the level's stored rows (K2s's padding rows are read
//     from memory and are zero there). Each tap is staged in the warp's
//     slice of shared memory (3.2 KB) as the pair (tap, its right
//     neighbour), taken from the next lane by a shuffle, so an output
//     reads two 8-byte words;
//   - per level, Epi::store writes the level's (2r+1)^2 consecutive
//     floats: lane i computes outputs i, i + 32, ..., so each store
//     instruction writes 128 contiguous bytes.
// Far-off centres are clamped before the int conversion (any start
// outside the clamp reads only out-of-bounds taps, zero either way);
// non-finite coordinates load nothing and give NaN windows.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace corr_gather {

constexpr int MAX_LEVELS = 4;
constexpr int WARPS = 8;  // queries per block
constexpr int THREADS = 32 * WARPS;

struct Levels {
  const void* vol[MAX_LEVELS];
  int h[MAX_LEVELS];  // stored rows (K2s: padded to Hp)
  int w[MAX_LEVELS];
};

__device__ __forceinline__ float load_tap(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_tap(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }

// the first tap column and row of a centre's patch, clamped so that the
// int conversion stays defined
template <int R>
__device__ __forceinline__ int patch_start(float c, int size) {
  constexpr int SPAN = 2 * R + 1;
  return (int)fminf(fmaxf(floorf(c), -2.0f * SPAN), (float)(size + SPAN)) - R;
}

// Epi::template store<R>(patch, cx, cy, h, w, o, lane) writes one level's
// window o[0 .. (2r+1)^2) from its staged (tap, right neighbour) pairs,
// patch[y * (2r+2) + x] for tap row y and column x; (cx, cy) is the
// centre at the level's scale, h and w its stored rows and columns
template <typename T, int R, typename Epi>
__global__ void __launch_bounds__(THREADS)
corr_lookup_kernel(Levels lv, const float* __restrict__ coords, float* __restrict__ out,
                   int n_total, int levels) {
  constexpr int SPAN = 2 * R + 1, SIDE = 2 * R + 2;
  constexpr int TAPS = SIDE * SIDE, WIN = SPAN * SPAN, PER_LANE = (TAPS + 31) / 32;
  __shared__ float2 patches[WARPS][MAX_LEVELS * TAPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long qi = (long long)blockIdx.x * WARPS + warp;
  if (qi >= n_total) return;  // the whole warp
  const float px = coords[2 * qi], py = coords[2 * qi + 1];
  float2* patch = patches[warp];

  float taps[MAX_LEVELS][PER_LANE];
#pragma unroll
  for (int l = 0; l < MAX_LEVELS; ++l) {
    const int H = lv.h[l], W = lv.w[l];
    const float scale = 1.0f / (float)(1 << l);
    const float cx = px * scale, cy = py * scale;
    const bool use = l < levels && isfinite(cx) && isfinite(cy);
    const int x0 = patch_start<R>(cx, W), y0 = patch_start<R>(cy, H);
    const T* vol = static_cast<const T*>(lv.vol[l]) + qi * (long long)H * W;
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int t = lane + 32 * k;
      const int y = y0 + t / SIDE, x = x0 + t % SIDE;
      taps[l][k] = (use && t < TAPS && y >= 0 && y < H && x >= 0 && x < W)
                       ? load_tap(vol + (long long)y * W + x)
                       : 0.0f;
    }
  }
#pragma unroll
  for (int l = 0; l < MAX_LEVELS; ++l)
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      // (tap t, tap t + 1): the next lane's, or lane 0's of the next round
      const float down = __shfl_down_sync(0xffffffffu, taps[l][k], 1);
      const float wrap = __shfl_sync(0xffffffffu, k + 1 < PER_LANE ? taps[l][k + 1] : 0.0f, 0);
      if (lane + 32 * k < TAPS)
        patch[l * TAPS + lane + 32 * k] = make_float2(taps[l][k], lane < 31 ? down : wrap);
    }
  __syncwarp();

  float* o = out + qi * (long long)(levels * WIN);
#pragma unroll
  for (int l = 0; l < MAX_LEVELS; ++l) {
    if (l >= levels) break;
    const float scale = 1.0f / (float)(1 << l);
    Epi::template store<R>(patch + l * TAPS, px * scale, py * scale, lv.h[l], lv.w[l],
                           o + l * WIN, lane);
  }
}

template <typename Epi>
int launch(const void* const vol[MAX_LEVELS], const int h[MAX_LEVELS], const int w[MAX_LEVELS],
           const void* coords, void* out, int b, int n, int levels, int radius, int is_bf16,
           int device, void* stream) {
  if (levels < 1 || levels > MAX_LEVELS || b < 1 || n < 1) return (int)cudaErrorInvalidValue;
  if (radius != 4) return (int)cudaErrorInvalidValue;  // only radius 4 is built
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Levels lv;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    lv.vol[l] = vol[l];
    lv.h[l] = h[l];
    lv.w[l] = w[l];
  }
  const int n_total = b * n;
  const unsigned blocks = (unsigned)((n_total + WARPS - 1) / WARPS);
  auto st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  if (is_bf16)
    corr_lookup_kernel<__nv_bfloat16, 4, Epi><<<blocks, THREADS, 0, st>>>(lv, c, o, n_total, levels);
  else
    corr_lookup_kernel<float, 4, Epi><<<blocks, THREADS, 0, st>>>(lv, c, o, n_total, levels);
  return (int)cudaGetLastError();
}

// blocks of the radius-4 kernel resident per SM, bf16 (is_bf16 = 1) or
// float32 volumes; returns a cudaError_t
template <typename Epi>
int occupancy(int is_bf16, int* blocks, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)(is_bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                             blocks, corr_lookup_kernel<__nv_bfloat16, 4, Epi>, THREADS, 0)
                       : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                             blocks, corr_lookup_kernel<float, 4, Epi>, THREADS, 0));
}

}  // namespace corr_gather
