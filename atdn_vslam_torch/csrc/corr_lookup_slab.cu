// Correlation-window lookup over all levels of a row-padded pyramid in
// one launch.
//
// Replaces the TPU kernel atdn_vslam_tpu/ops/corr_lookup_slab.py:
// lookup_corr_pyramid_slab (_lookup_kernel, _level_kernel) and computes
// its function: for query n and level l the centre is
// (x, y) = coords[n] / 2^l, and the window value at offsets (a, c), each
// in [-r, r], is
//   sum_w (sum_h hat((y - r + a_index) - h) vol[n, h, w]) hat((x + c) - w),
// hat(t) = max(0, 1 - |t|), all in float32 with no rounding, the rows
// contracted first (:112-131). Level l is stored (B * N, Hp, Wl) with
// its rows zero-padded from the level's own row count to Hp by
// pad_pyramid_for_slab, so every row below Hp reads memory (the padding
// reads zeros) and only rows outside [0, Hp) and columns outside
// [0, Wl) are tested: the level is zero-padded as grid_sample pads it.
// Non-finite coordinates give NaN windows, as the port's K2
// (corr_lookup.cu) does. Output (B * N, L * (2r+1)^2) float32, dx-major
// per level (k = c_index * (2r+1) + a_index).
//
// Bound on an H100 at the KITTI main-path shape (7238 queries, four
// bf16 levels, r = 4): at most 7238 x 4 x 100 taps x 2 B = 5.8 MB read
// and 9.4 MB written per call, about 4.5 us at 3.35 TB/s: bytes bound.
// The TPU kernel sliced an 8-aligned 24-row slab per query out of VMEM,
// because its dynamic slices must start on a sublane boundary; on
// Hopper this is a gather, as in K2: one thread per (query, level,
// window row) reads the two volume rows that window row needs straight
// from the query's slice of the volume (neighbouring threads share rows
// through L1) and writes its 2r+1 outputs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 4;
constexpr int THREADS = 128;

struct Levels {
  const void* vol[MAX_LEVELS];
  int h[MAX_LEVELS];  // padded rows Hp
  int w[MAX_LEVELS];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float hat(float t) { return fmaxf(0.0f, 1.0f - fabsf(t)); }

template <typename T, int R>
__global__ void __launch_bounds__(THREADS)
slab_kernel(Levels lv, const float* __restrict__ coords, float* __restrict__ out, int n_total,
            int levels) {
  constexpr int SPAN = 2 * R + 1;
  const long t = (long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= (long)n_total * levels * SPAN) return;
  const int ia = (int)(t % SPAN);
  const int l = (int)((t / SPAN) % levels);
  const long qi = t / ((long)SPAN * levels);
  const int H = lv.h[l], W = lv.w[l];
  float* o = out + qi * (levels * SPAN * SPAN) + l * SPAN * SPAN + ia;

  const float scale = 1.0f / (float)(1 << l);
  const float xc = coords[2 * qi] * scale, yc = coords[2 * qi + 1] * scale;
  if (!isfinite(xc) || !isfinite(yc)) {
#pragma unroll
    for (int ic = 0; ic < SPAN; ++ic) o[ic * SPAN] = CUDART_NAN_F;
    return;
  }
  // clamp before the int conversion: any start outside this range
  // reads only out-of-bounds taps, which are zero either way
  const int x0 = (int)fminf(fmaxf(floorf(xc), -2.0f * SPAN), (float)(W + SPAN)) - R;
  const int h0 = (int)fminf(fmaxf(floorf(yc), -2.0f * SPAN), (float)(H + SPAN)) - R + ia;
  const int h1 = h0 + 1;
  const T* vol = static_cast<const T*>(lv.vol[l]) + qi * (long)H * W;
  const bool ok0 = h0 >= 0 && h0 < H, ok1 = h1 >= 0 && h1 < H;

  // the rows first: window row ia at y - r + ia
  const float ty = (yc - (float)R) + (float)ia;
  const float wy0 = hat(ty - (float)h0), wy1 = hat(ty - (float)h1);
  float row[SPAN + 1];
#pragma unroll
  for (int j = 0; j <= SPAN; ++j) {
    const int w = x0 + j;
    const bool okx = w >= 0 && w < W;
    const float v0 = (okx && ok0) ? to_float(vol[(long)h0 * W + w]) : 0.0f;
    const float v1 = (okx && ok1) ? to_float(vol[(long)h1 * W + w]) : 0.0f;
    row[j] = __fadd_rn(__fmul_rn(wy0, v0), __fmul_rn(wy1, v1));
  }
  // then the columns: window column ic at x + ic - r
#pragma unroll
  for (int ic = 0; ic < SPAN; ++ic) {
    const float tx = xc + (float)(ic - R);
    const float wx0 = hat(tx - (float)(x0 + ic)), wx1 = hat(tx - (float)(x0 + ic + 1));
    o[ic * SPAN] = __fadd_rn(__fmul_rn(row[ic], wx0), __fmul_rn(row[ic + 1], wx1));
  }
}

template <typename T>
int launch(const Levels& lv, const float* coords, float* out, int n_total, int levels, int radius,
           cudaStream_t stream) {
  if (radius != 4) return (int)cudaErrorInvalidValue;
  const long threads = (long)n_total * levels * (2 * 4 + 1);
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  slab_kernel<T, 4><<<blocks, THREADS, 0, stream>>>(lv, coords, out, n_total, levels);
  return (int)cudaGetLastError();
}

}  // namespace

// vol[l]: (b * n, hp[l], w[l]) contiguous with its rows zero-padded to
// hp[l], bf16 (is_bf16 = 1) or float32; coords (b * n, 2) float32 (x, y)
// at level-0 scale; out (b * n, levels * (2r+1)^2) float32. Only radius
// 4 is built. Returns a cudaError_t (0 on success).
extern "C" int atdn_corr_lookup_slab(const void* vol0, const void* vol1, const void* vol2,
                                     const void* vol3, const void* coords, void* out, int hp0,
                                     int hp1, int hp2, int hp3, int w0, int w1, int w2, int w3,
                                     int b, int n, int levels, int radius, int is_bf16, int device,
                                     void* stream) {
  if (levels < 1 || levels > MAX_LEVELS || b < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Levels lv = {{vol0, vol1, vol2, vol3}, {hp0, hp1, hp2, hp3}, {w0, w1, w2, w3}};
  auto st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  if (is_bf16) return launch<__nv_bfloat16>(lv, c, o, b * n, levels, radius, st);
  return launch<float>(lv, c, o, b * n, levels, radius, st);
}
