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
//   - the gather (corr_lookup_gather.cuh, shared with K2s): the
//     query's patches loaded up front, a level's 100 taps over 32
//     lanes, staged in shared memory as (tap, right neighbour) pairs;
//   - the epilogue (Lerp below): per level (the centre's fractions
//     computed once), lane i computes outputs i, i + 32, ... of its
//     (2r+1)^2 consecutive floats, so each store instruction writes 128
//     contiguous bytes, with the lerp of the thread-per-row design it
//     replaces: (1 - fx) a + fx b along x, then along y, in float32.
// What is left (kernel_variants.py on an H100): at 2x KITTI the gathers
// alone take ~37 us, as the rows' 20 bytes cost whole DRAM sectors once
// the touched sectors (~70 MB) no longer fit L2.
// Far-off centres are clamped before the int conversion (any start
// outside the clamp reads only out-of-bounds taps, zero either way);
// non-finite coordinates give NaN windows.

#include "corr_lookup_gather.cuh"

namespace {

// bilinear: each window value lerps its 2 x 2 taps along x, then along y
struct Lerp {
  template <int R>
  static __device__ __forceinline__ void store(const float2* pl, float cx, float cy, int, int,
                                               float* o, int lane) {
    constexpr int SPAN = 2 * R + 1, SIDE = 2 * R + 2, WIN = SPAN * SPAN;
    const bool finite = isfinite(cx) && isfinite(cy);
    const float fx = cx - floorf(cx), fy = cy - floorf(cy);
#pragma unroll
    for (int i = 0; i < (WIN + 31) / 32; ++i) {
      const int k = lane + 32 * i;
      if (k < WIN) {
        const int ix = k / SPAN, iy = k % SPAN;
        const float2 a = pl[iy * SIDE + ix], c = pl[(iy + 1) * SIDE + ix];
        const float top = (1.0f - fx) * a.x + fx * a.y;
        const float bot = (1.0f - fx) * c.x + fx * c.y;
        o[k] = finite ? (1.0f - fy) * top + fy * bot : CUDART_NAN_F;
      }
    }
  }
};

}  // namespace

// vol[l]: (b * n, h[l], w[l]) contiguous, bf16 (is_bf16 = 1) or
// float32; coords (b * n, 2) float32 (x, y) at level-0 scale; out
// (b * n, levels * (2r+1)^2) float32. Only radius 4 is built. Returns a
// cudaError_t (0 on success).
extern "C" int atdn_corr_lookup(const void* vol0, const void* vol1, const void* vol2,
                                const void* vol3, const void* coords, void* out, int h0, int h1,
                                int h2, int h3, int w0, int w1, int w2, int w3, int b, int n,
                                int levels, int radius, int is_bf16, int device, void* stream) {
  const void* vol[] = {vol0, vol1, vol2, vol3};
  const int h[] = {h0, h1, h2, h3}, w[] = {w0, w1, w2, w3};
  return corr_gather::launch<Lerp>(vol, h, w, coords, out, b, n, levels, radius, is_bf16, device,
                                   stream);
}

// blocks of the radius-4 kernel resident per SM, bf16 (is_bf16 = 1) or
// float32 volumes; returns a cudaError_t
extern "C" int atdn_corr_lookup_occupancy(int is_bf16, int* blocks, int device) {
  return corr_gather::occupancy<Lerp>(is_bf16, blocks, device);
}
