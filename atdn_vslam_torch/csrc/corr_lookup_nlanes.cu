// Correlation-window lookup over pyramid levels stored with the queries
// innermost, (B, Hl, Wl, N), several levels in one launch.
//
// Replaces the TPU kernel atdn_vslam_tpu/ops/corr_lookup_nlanes.py:
// nlanes_lookup_level (_nlanes_level_kernel) and computes its function,
// rounding included: for query n of level l the centre is
// (x, y) = coords[n] / 2^l; the output window value at offsets (a, c),
// each in [-r, r], is
//   sum_w round(sum_h vol[h, w, n] * round(hat(y - h + a)))
//         * round(hat(x + c - w)),        hat(t) = max(0, 1 - |t|),
// where round() goes through the volume's type (bf16; nothing for
// float32) and the inner float32 sum over rows is rounded before the sum
// over columns, as the TPU kernel does (:48-53, :86). A hat weight is
// non-zero for two rows and two columns only, so a window needs the
// (2r+2) x (2r+2) taps around the centre; rows and columns outside the
// level count as zero (grid_sample's zero padding). Non-finite
// coordinates give NaN windows, as the port's K2 (corr_lookup.cu) does.
// Output: (B * N, out_cols) float32, level l's window at columns
// [l * (2r+1)^2, (l+1) * (2r+1)^2), dx-major (k = c_index * (2r+1) +
// a_index), the order of the port's K2 and the reference's CorrBlock.
//
// Bound on an H100 at the KITTI main path (levels 1-3: 23x77, 11x38,
// 5x19 over N = 7238 queries, bf16, r = 4): at most 7238 x 3 x 100 taps
// x 2 B = 4.3 MB read and 7 MB written per call, about 3.4 us at
// 3.35 TB/s: bytes bound. The TPU kernel contracted all Hl rows densely
// because its vector unit has no per-lane gather; on Hopper one thread
// per query reads only its 100 taps. Queries are the unit-stride axis,
// so the 32 queries of a warp read neighbouring addresses wherever
// their windows share a tap (neighbouring pixels, halved or more at
// these levels). Each block holds 128 queries of one level; the 81
// results of each thread go through shared memory and leave as whole
// rows of the output.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 4;
constexpr int THREADS = 128;
constexpr int R = 4;
constexpr int SPAN = 2 * R + 1;
constexpr int WIN = SPAN * SPAN;

struct Levels {
  const void* vol[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// round through the volume's type
__device__ __forceinline__ float round_like(float x, float) { return x; }
__device__ __forceinline__ float round_like(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float hat(float t) { return fmaxf(0.0f, 1.0f - fabsf(t)); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
nlanes_kernel(Levels lv, const float* __restrict__ coords, float* __restrict__ out, int n,
              int n_total, int first_level, int out_cols) {
  __shared__ float tile[THREADS * WIN];  // 41.5 KB; stride 81 words: no bank conflicts
  const int l = blockIdx.y;
  const int q0 = blockIdx.x * THREADS;
  const int qi = q0 + threadIdx.x;
  float* my = tile + threadIdx.x * WIN;

  if (qi < n_total) {
    const int H = lv.h[l], W = lv.w[l];
    const float scale = 1.0f / (float)(1 << (first_level + l));
    const float xc = coords[2 * (size_t)qi] * scale, yc = coords[2 * (size_t)qi + 1] * scale;
    if (!isfinite(xc) || !isfinite(yc)) {
      for (int k = 0; k < WIN; ++k) my[k] = CUDART_NAN_F;
    } else {
      // clamp before the int conversion: any start outside this range
      // reads only out-of-bounds taps, which are zero either way
      const int x0 = (int)fminf(fmaxf(floorf(xc), -2.0f * SPAN), (float)(W + SPAN)) - R;
      const int y0 = (int)fminf(fmaxf(floorf(yc), -2.0f * SPAN), (float)(H + SPAN)) - R;
      const size_t qb = (size_t)(qi / n), qn = (size_t)(qi % n);
      const T* vol = static_cast<const T*>(lv.vol[l]) + qb * H * W * n + qn;
      const T zero_t = T(0.0f);

      // column weights, rounded: tap c reads columns x0 + c and x0 + c + 1
      float wx0[SPAN], wx1[SPAN];
#pragma unroll
      for (int c = 0; c < SPAN; ++c) {
        const float t = xc + (float)(c - R);
        wx0[c] = round_like(hat(t - (float)(x0 + c)), zero_t);
        wx1[c] = round_like(hat(t - (float)(x0 + c + 1)), zero_t);
      }
      // row a of the window reads rows y0 + a and y0 + a + 1; the lower
      // row of one is the upper row of the next, so each row loads once
      float lo[SPAN + 1], hi[SPAN + 1];
      {
        const int h = y0;
        const bool okh = h >= 0 && h < H;
#pragma unroll
        for (int j = 0; j <= SPAN; ++j) {
          const int w = x0 + j;
          hi[j] = (okh && w >= 0 && w < W) ? to_float(vol[((size_t)h * W + w) * n]) : 0.0f;
        }
      }
#pragma unroll
      for (int a = 0; a < SPAN; ++a) {
        const int h0 = y0 + a, h1 = h0 + 1;
        const bool okh = h1 >= 0 && h1 < H;
#pragma unroll
        for (int j = 0; j <= SPAN; ++j) {
          lo[j] = hi[j];
          const int w = x0 + j;
          hi[j] = (okh && w >= 0 && w < W) ? to_float(vol[((size_t)h1 * W + w) * n]) : 0.0f;
        }
        const float wy0 = round_like(hat((yc - (float)h0) + (float)(a - R)), zero_t);
        const float wy1 = round_like(hat((yc - (float)h1) + (float)(a - R)), zero_t);
        float row[SPAN + 1];
#pragma unroll
        for (int j = 0; j <= SPAN; ++j)
          row[j] = round_like(__fadd_rn(__fmul_rn(lo[j], wy0), __fmul_rn(hi[j], wy1)), zero_t);
#pragma unroll
        for (int c = 0; c < SPAN; ++c)
          my[c * SPAN + a] = __fadd_rn(__fmul_rn(row[c], wx0[c]), __fmul_rn(row[c + 1], wx1[c]));
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < THREADS * WIN; i += THREADS) {
    const int r = i / WIN, k = i % WIN;
    if (q0 + r < n_total) out[(size_t)(q0 + r) * out_cols + l * WIN + k] = tile[i];
  }
}

template <typename T>
int launch(const Levels& lv, const float* coords, float* out, int n, int n_total, int levels,
           int first_level, cudaStream_t stream) {
  const dim3 grid((unsigned)((n_total + THREADS - 1) / THREADS), (unsigned)levels);
  nlanes_kernel<T><<<grid, THREADS, 0, stream>>>(lv, coords, out, n, n_total, first_level,
                                                 levels * WIN);
  return (int)cudaGetLastError();
}

}  // namespace

// vol[l]: (b, h[l], w[l], n) contiguous, bf16 (is_bf16 = 1) or float32,
// level first_level + l of the pyramid; coords (b * n, 2) float32 (x, y)
// at level-0 scale; out (b * n, levels * (2r+1)^2) float32. Only radius
// 4 is built. Returns a cudaError_t (0 on success).
extern "C" int atdn_corr_lookup_nlanes(const void* vol0, const void* vol1, const void* vol2,
                                       const void* vol3, const void* coords, void* out, int h0,
                                       int h1, int h2, int h3, int w0, int w1, int w2, int w3,
                                       int b, int n, int levels, int first_level, int radius,
                                       int is_bf16, int device, void* stream) {
  if (levels < 1 || levels > MAX_LEVELS || b < 1 || n < 1 || radius != R || first_level < 0 ||
      first_level + levels > 30)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Levels lv = {{vol0, vol1, vol2, vol3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  auto st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  if (is_bf16) return launch<__nv_bfloat16>(lv, c, o, n, b * n, levels, first_level, st);
  return launch<float>(lv, c, o, n, b * n, levels, first_level, st);
}
