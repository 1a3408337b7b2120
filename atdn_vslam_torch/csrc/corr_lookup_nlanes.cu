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
// 3.35 TB/s: bytes bound, and a gather whose cost is how many requests
// are in flight and how many sectors they touch. The TPU kernel
// contracted all Hl rows densely because its vector unit has no per-lane
// gather; on Hopper each query reads only its 100 taps per level.
// Queries are the unit-stride axis, so the lanes stay on queries: a
// load instruction over 32 consecutive queries touches one sector for
// every 16 of them whose windows share that tap. The design:
//   - a block takes QUERIES = 32 consecutive queries (of any batch:
//     each lane finds its own), one per lane, and splits the work by
//     level and window rows: warp task (l, a0) computes window rows
//     a0 .. a0 + ROWS - 1 of level l for its 32 queries. ROWS = 3, so a
//     level is 3 tasks and a block has the 9 warps of three levels'
//     tasks (the main path's count); a fourth level's tasks go round
//     again, fewer levels launch fewer warps;
//   - each lane issues all loads of its ROWS + 1 tap rows (40 taps)
//     before it uses any, so one round trip covers a task; the row two
//     tasks share is read twice, the second time mostly from L1;
//   - the results go into a shared [32][levels * (2r+1)^2] float tile at
//     (query, level, window column, window row); the row stride, 243
//     words for three levels, is odd, so the 32 lanes' writes hit 32
//     banks;
//   - the block's rows of the output are one contiguous run of 32 x 243
//     floats (16-byte aligned whenever the output is), written from the
//     tile in 16-byte stores.
// ~90 registers, 2 blocks per SM. What is left (kernel_variants.py on
// an H100, KITTI): latency, not bytes or instructions. The same grid
// returning at once takes ~30% of the time; loads and stores without
// the arithmetic ~50%, the arithmetic without loads ~70%, all 32 lanes
// on one window (perfect coalescing) ~90%. One wave of 227 blocks
// leaves ~15 warps per SM to hide each phase. Staging the small levels
// whole in shared memory, one warp per window row or per level, 3
// blocks per SM, and 32-bit per-column tap offsets (~10 fewer
// instructions per tap) all measured no faster.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 4;
constexpr int R = 4;
constexpr int SPAN = 2 * R + 1;
constexpr int SIDE = SPAN + 1;
constexpr int WIN = SPAN * SPAN;
constexpr int QUERIES = 32;                     // per block, one per lane
constexpr int ROWS = 3;                         // window rows per warp task
constexpr int TASKS = (SPAN + ROWS - 1) / ROWS;  // warp tasks per level
constexpr int WARPS = 3 * TASKS;                 // three levels' tasks at once
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 2;

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

// window rows a0 .. a0 + ROWS - 1 of one level for one query into its
// row of the tile, my[c * SPAN + a]
template <typename T>
__device__ __forceinline__ void window_rows(const T* __restrict__ vol, int H, int W, int n,
                                            float xc, float yc, int a0, float* my) {
  if (!isfinite(xc) || !isfinite(yc)) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (a0 + r < SPAN)
#pragma unroll
        for (int c = 0; c < SPAN; ++c) my[c * SPAN + a0 + r] = CUDART_NAN_F;
    return;
  }
  // clamp before the int conversion: any start outside this range
  // reads only out-of-bounds taps, which are zero either way
  const int x0 = (int)fminf(fmaxf(floorf(xc), -2.0f * SPAN), (float)(W + SPAN)) - R;
  const int y0 = (int)fminf(fmaxf(floorf(yc), -2.0f * SPAN), (float)(H + SPAN)) - R;
  const T zero_t = T(0.0f);

  // tap rows y0 + a0 .. y0 + a0 + ROWS, every load issued before any use
  float v[ROWS + 1][SIDE];
#pragma unroll
  for (int r = 0; r <= ROWS; ++r) {
    const int h = y0 + a0 + r;
    const bool okh = a0 + r <= SPAN && h >= 0 && h < H;
#pragma unroll
    for (int j = 0; j < SIDE; ++j) {
      const int w = x0 + j;
      v[r][j] = (okh && w >= 0 && w < W) ? to_float(vol[((size_t)h * W + w) * n]) : 0.0f;
    }
  }
  // column weights, rounded: window column c reads columns x0 + c and
  // x0 + c + 1
  float wx0[SPAN], wx1[SPAN];
#pragma unroll
  for (int c = 0; c < SPAN; ++c) {
    const float t = xc + (float)(c - R);
    wx0[c] = round_like(hat(t - (float)(x0 + c)), zero_t);
    wx1[c] = round_like(hat(t - (float)(x0 + c + 1)), zero_t);
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int a = a0 + r;
    if (a >= SPAN) break;
    const int h0 = y0 + a, h1 = h0 + 1;
    const float wy0 = round_like(hat((yc - (float)h0) + (float)(a - R)), zero_t);
    const float wy1 = round_like(hat((yc - (float)h1) + (float)(a - R)), zero_t);
    float row[SIDE];
#pragma unroll
    for (int j = 0; j < SIDE; ++j)
      row[j] = round_like(__fadd_rn(__fmul_rn(v[r][j], wy0), __fmul_rn(v[r + 1][j], wy1)), zero_t);
#pragma unroll
    for (int c = 0; c < SPAN; ++c)
      my[c * SPAN + a] = __fadd_rn(__fmul_rn(row[c], wx0[c]), __fmul_rn(row[c + 1], wx1[c]));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
nlanes_kernel(Levels lv, const float* __restrict__ coords, float* __restrict__ out, int n,
              int n_total, int first_level, int levels) {
  __shared__ __align__(16) float tile[QUERIES * MAX_LEVELS * WIN];
  const int cols = levels * WIN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * QUERIES, qi = q0 + lane;

  if (qi < n_total) {
    const float px = coords[2 * (size_t)qi], py = coords[2 * (size_t)qi + 1];
    const size_t qb = (size_t)(qi / n), qn = (size_t)(qi % n);
    for (int t = warp; t < levels * TASKS; t += blockDim.x / 32) {
      const int l = t / TASKS, a0 = (t % TASKS) * ROWS;
      const int H = lv.h[l], W = lv.w[l];
      const float scale = 1.0f / (float)(1 << (first_level + l));
      const T* vol = static_cast<const T*>(lv.vol[l]) + qb * H * W * n + qn;
      window_rows(vol, H, W, n, px * scale, py * scale, a0, tile + lane * cols + l * WIN);
    }
  }
  __syncthreads();
  // the block's rows of out: one contiguous run
  const int len = min(QUERIES, n_total - q0) * cols;
  float* dst = out + (size_t)q0 * cols;
  int i = threadIdx.x;
  if (reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
    for (; i < len / 4; i += blockDim.x)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(tile)[i];
    i = len / 4 * 4 + threadIdx.x;
  }
  for (; i < len; i += blockDim.x) dst[i] = tile[i];
}

template <typename T>
int launch(const Levels& lv, const float* coords, float* out, int n, int n_total, int levels,
           int first_level, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n_total + QUERIES - 1) / QUERIES);
  const int threads = 32 * TASKS * (levels < 3 ? levels : 3);
  nlanes_kernel<T><<<blocks, threads, 0, stream>>>(lv, coords, out, n, n_total, first_level,
                                                   levels);
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

// blocks resident per SM of the kernel for three levels (the main
// path's block), bf16 (is_bf16 = 1) or float32 volumes; returns a
// cudaError_t
extern "C" int atdn_corr_lookup_nlanes_occupancy(int is_bf16, int* blocks, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)(is_bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                             blocks, nlanes_kernel<__nv_bfloat16>, THREADS, 0)
                       : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                             blocks, nlanes_kernel<float>, THREADS, 0));
}
