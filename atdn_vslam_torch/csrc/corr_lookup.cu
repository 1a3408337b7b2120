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
// and 9.4 MB written per call, about 4.5 us at 3.35 TB/s: bytes bound.
// The TPU kernel rolled whole rows through VMEM and contracted a hat
// matrix on the MXU to avoid gathers; on Hopper this is a gather: one
// thread per (query, level, window row) reads the two patch rows it
// needs straight from the query's slice of the volume (neighbouring
// threads share rows through L1) and writes its 2r+1 outputs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 4;
constexpr int THREADS = 128;

struct Levels {
  const void* vol[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int R>
__global__ void __launch_bounds__(THREADS)
corr_lookup_kernel(Levels lv, const float* __restrict__ coords, float* __restrict__ out,
                   int n_total, int levels) {
  constexpr int SPAN = 2 * R + 1;
  const long t = (long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= (long)n_total * levels * SPAN) return;
  const int iy = (int)(t % SPAN);
  const int l = (int)((t / SPAN) % levels);
  const long qi = t / ((long)SPAN * levels);
  const int H = lv.h[l], W = lv.w[l];
  float* o = out + qi * (levels * SPAN * SPAN) + l * SPAN * SPAN + iy;

  const float scale = 1.0f / (float)(1 << l);
  const float cx = coords[2 * qi] * scale, cy = coords[2 * qi + 1] * scale;
  if (!isfinite(cx) || !isfinite(cy)) {
#pragma unroll
    for (int ix = 0; ix < SPAN; ++ix) o[ix * SPAN] = CUDART_NAN_F;
    return;
  }
  const float x0f = floorf(cx), y0f = floorf(cy);
  const float fx = cx - x0f, fy = cy - y0f;
  // clamp before the int conversion: any start outside this range
  // reads only out-of-bounds taps, which are zero either way
  const int x0 = (int)fminf(fmaxf(x0f, -2.0f * SPAN), (float)(W + SPAN)) - R;
  const int ya = (int)fminf(fmaxf(y0f, -2.0f * SPAN), (float)(H + SPAN)) - R + iy;
  const int yb = ya + 1;
  const T* vol = static_cast<const T*>(lv.vol[l]) + qi * (long)H * W;
  const bool oka = ya >= 0 && ya < H, okb = yb >= 0 && yb < H;

  float ra[SPAN + 1], rb[SPAN + 1];
#pragma unroll
  for (int j = 0; j <= SPAN; ++j) {
    const int xx = x0 + j;
    const bool okx = xx >= 0 && xx < W;
    ra[j] = (okx && oka) ? to_float(vol[(long)ya * W + xx]) : 0.0f;
    rb[j] = (okx && okb) ? to_float(vol[(long)yb * W + xx]) : 0.0f;
  }
#pragma unroll
  for (int ix = 0; ix < SPAN; ++ix) {
    const float top = (1.0f - fx) * ra[ix] + fx * ra[ix + 1];
    const float bot = (1.0f - fx) * rb[ix] + fx * rb[ix + 1];
    o[ix * SPAN] = (1.0f - fy) * top + fy * bot;
  }
}

template <typename T>
int launch(const Levels& lv, const float* coords, float* out, int n_total, int levels, int radius,
           cudaStream_t stream) {
  if (radius != 4) return (int)cudaErrorInvalidValue;
  const long threads = (long)n_total * levels * (2 * 4 + 1);
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
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
