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
// and 9.4 MB written per call, about 4.5 us at 3.35 TB/s: bytes bound,
// and a gather. The TPU kernel sliced an 8-aligned 24-row slab per query
// out of VMEM, because its dynamic slices must start on a sublane
// boundary; on Hopper a query's padded level is one contiguous slice, so
// this is K2's gather (corr_lookup_gather.cuh): one warp per query, all
// levels, the taps loaded up front with the padded Hp as row pitch and
// row bound, staged in shared memory as (tap, right neighbour) pairs.
// The epilogue (RowsThenColumns below) keeps this kernel's arithmetic:
// per level, lane i computes outputs i, i + 32, ... of its (2r+1)^2
// consecutive floats, each the two rows' hat-weighted sums at the two
// columns, then the columns' hat-weighted sum, all in float32.
// What is left (kernel_variants.py on an H100, KITTI): ~20% over K2 on
// the same gather. The differences are the epilogue (four hat weights
// and unfused sums per output, where K2 lerps) and the padded level 0
// (125 MB against 105); computing the hat weights once per level
// (lanes 0-8, read back from shared memory) or from float indices
// measured no faster.

#include "corr_lookup_gather.cuh"

namespace {

__device__ __forceinline__ float hat(float t) { return fmaxf(0.0f, 1.0f - fabsf(t)); }

// rows first with their hat weights, then columns (the TPU kernel's
// order, :112-131); window row ia lies at y - r + ia, column ic at
// x + ic - r
struct RowsThenColumns {
  template <int R>
  static __device__ __forceinline__ void store(const float2* pl, float xc, float yc, int H, int W,
                                               float* o, int lane) {
    constexpr int SPAN = 2 * R + 1, SIDE = 2 * R + 2, WIN = SPAN * SPAN;
    const bool finite = isfinite(xc) && isfinite(yc);
    const int x0 = corr_gather::patch_start<R>(xc, W), y0 = corr_gather::patch_start<R>(yc, H);
#pragma unroll
    for (int i = 0; i < (WIN + 31) / 32; ++i) {
      const int k = lane + 32 * i;
      if (k < WIN) {
        const int ic = k / SPAN, ia = k % SPAN;
        const int h0 = y0 + ia;
        const float ty = (yc - (float)R) + (float)ia;
        const float wy0 = hat(ty - (float)h0), wy1 = hat(ty - (float)(h0 + 1));
        const float tx = xc + (float)(ic - R);
        const float wx0 = hat(tx - (float)(x0 + ic)), wx1 = hat(tx - (float)(x0 + ic + 1));
        const float2 a = pl[ia * SIDE + ic], c = pl[(ia + 1) * SIDE + ic];
        const float left = __fadd_rn(__fmul_rn(wy0, a.x), __fmul_rn(wy1, c.x));
        const float right = __fadd_rn(__fmul_rn(wy0, a.y), __fmul_rn(wy1, c.y));
        o[k] = finite ? __fadd_rn(__fmul_rn(left, wx0), __fmul_rn(right, wx1)) : CUDART_NAN_F;
      }
    }
  }
};

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
  const void* vol[] = {vol0, vol1, vol2, vol3};
  const int h[] = {hp0, hp1, hp2, hp3}, w[] = {w0, w1, w2, w3};
  return corr_gather::launch<RowsThenColumns>(vol, h, w, coords, out, b, n, levels, radius,
                                              is_bf16, device, stream);
}

// blocks of the radius-4 kernel resident per SM, bf16 (is_bf16 = 1) or
// float32 volumes; returns a cudaError_t
extern "C" int atdn_corr_lookup_slab_occupancy(int is_bf16, int* blocks, int device) {
  return corr_gather::occupancy<RowsThenColumns>(is_bf16, blocks, device);
}
