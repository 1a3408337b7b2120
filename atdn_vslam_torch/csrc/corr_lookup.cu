// Correlation-window lookup over all pyramid levels in one launch.
//
// Replaces the TPU kernel atdn_vslam_tpu/ops/corr_lookup_pallas.py:
// lookup_level_pallas (_lookup_kernel), which computes the same
// function as ops/corr_lookup.py lookup_corr_pyramid.
//
// For query n and level l the centre is coords[n] / 2^l; the output is
// the (2r+1)^2 window of bilinear samples at integer offsets around it,
// zero outside the level (grid_sample(zeros, align_corners=True)).
// Every sample of one window shares the centre's fractional part, so a
// window is a lerp over one (2r+2) x (2r+2) patch of taps. Channels are
// dx-major within a level (k = ix * (2r+1) + iy, as the reference's
// CorrBlock flattens) and levels are concatenated: out (B*N, L*(2r+1)^2)
// float32.
//
// Bound on an H100 at the KITTI main-path shape (7238 queries, four
// bf16 levels, r = 4): at most 7238 x 4 x 100 taps x 2 B = 5.8 MB read
// and 9.4 MB written per call, about 4.5 us at 3.35 TB/s (2x KITTI,
// 28,952 queries: ~23 MB of taps and 37.5 MB written, ~18 us): bytes
// bound, and a gather, so what counts is how many memory sectors each
// query touches and how many requests are in flight. The TPU kernel
// rolled whole rows through VMEM and contracted a hat matrix on the MXU
// to avoid gathers; on Hopper one warp takes one query, all levels:
//   - its lanes load the query's whole patches first, a level's 100 taps
//     over 32 lanes (lanes on neighbouring columns of a patch row, so one
//     load instruction touches a few 32-byte sectors), all 16 loads per
//     lane issued before any is used. The patch rows start at any 2-byte
//     alignment (a query's level-0 slab is 14,476 bytes at KITTI), so the
//     loads stay scalar. Each tap is staged in the warp's slice of shared
//     memory (3.2 KB) as the pair (tap, its right neighbour), taken from
//     the next lane by a shuffle, so an output reads two 8-byte words;
//   - per level (the level's centre and fractions computed once), lane i
//     computes outputs i, i + 32, ... of its (2r+1)^2 consecutive floats,
//     so each store instruction writes 128 contiguous bytes, with the
//     lerp of the thread-per-row design it replaces: (1 - fx) a + fx b
//     along x, then along y, in float32.
// What is left (kernel_variants.py on an H100): at 2x KITTI the gathers
// alone take ~37 us, as the rows' 20 bytes cost whole DRAM sectors once
// the touched sectors (~70 MB) no longer fit L2.
// Far-off centres are clamped before the int conversion (any start
// outside the clamp reads only out-of-bounds taps, zero either way);
// non-finite coordinates give NaN windows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 4;
constexpr int WARPS = 8;  // queries per block
constexpr int THREADS = 32 * WARPS;

struct Levels {
  const void* vol[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
};

__device__ __forceinline__ float load_tap(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_tap(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }

template <typename T, int R>
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
    // clamp before the int conversion: any start outside this range
    // reads only out-of-bounds taps, which are zero either way
    const int x0 = (int)fminf(fmaxf(floorf(cx), -2.0f * SPAN), (float)(W + SPAN)) - R;
    const int y0 = (int)fminf(fmaxf(floorf(cy), -2.0f * SPAN), (float)(H + SPAN)) - R;
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
    const float cx = px * scale, cy = py * scale;
    const bool finite = isfinite(cx) && isfinite(cy);
    const float fx = cx - floorf(cx), fy = cy - floorf(cy);
    const float2* pl = patch + l * TAPS;
#pragma unroll
    for (int i = 0; i < (WIN + 31) / 32; ++i) {
      const int k = lane + 32 * i;
      if (k < WIN) {
        const int ix = k / SPAN, iy = k % SPAN;
        const float2 a = pl[iy * SIDE + ix], c = pl[(iy + 1) * SIDE + ix];
        const float top = (1.0f - fx) * a.x + fx * a.y;
        const float bot = (1.0f - fx) * c.x + fx * c.y;
        o[l * WIN + k] = finite ? (1.0f - fy) * top + fy * bot : CUDART_NAN_F;
      }
    }
  }
}

template <typename T>
int launch(const Levels& lv, const float* coords, float* out, int n_total, int levels, int radius,
           cudaStream_t stream) {
  if (radius != 4) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n_total + WARPS - 1) / WARPS);
  corr_lookup_kernel<T, 4><<<blocks, THREADS, 0, stream>>>(lv, coords, out, n_total, levels);
  return (int)cudaGetLastError();
}

}  // namespace

// vol[l]: (b * n, h[l], w[l]) contiguous, bf16 (is_bf16 = 1) or
// float32; coords (b * n, 2) float32 (x, y) at level-0 scale; out
// (b * n, levels * (2r+1)^2) float32. Only radius 4 is built. Returns a
// cudaError_t (0 on success).
extern "C" int atdn_corr_lookup(const void* vol0, const void* vol1, const void* vol2,
                                const void* vol3, const void* coords, void* out, int h0, int h1,
                                int h2, int h3, int w0, int w1, int w2, int w3, int b, int n,
                                int levels, int radius, int is_bf16, int device, void* stream) {
  if (levels < 1 || levels > MAX_LEVELS || b < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Levels lv = {{vol0, vol1, vol2, vol3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  auto st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  if (is_bf16) return launch<__nv_bfloat16>(lv, c, o, b * n, levels, radius, st);
  return launch<float>(lv, c, o, b * n, levels, radius, st);
}

// blocks of the radius-4 kernel resident per SM, bf16 (is_bf16 = 1) or
// float32 volumes; returns a cudaError_t
extern "C" int atdn_corr_lookup_occupancy(int is_bf16, int* blocks, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)(is_bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                             blocks, corr_lookup_kernel<__nv_bfloat16, 4>, THREADS, 0)
                       : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                             blocks, corr_lookup_kernel<float, 4>, THREADS, 0));
}
