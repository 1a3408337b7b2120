// Raw PTX helpers for the Hopper (sm_90a) kernels: mbarriers, TMA tile
// loads, wgmma descriptors and issue, named barriers, setmaxnreg, and
// the host function that encodes a TMA tensor map.
//
// The tile layout every user of this header shares: a TMA box whose
// inner dimension is 64 bf16 (128 bytes) lands in shared memory as rows
// of 128 bytes with the 128-byte swizzle, 8 rows (1024 bytes) per
// swizzle atom, at a 1024-byte aligned address. wgmma reads such a tile
// through a descriptor of layout type "128-byte swizzle":
//   - K-major (the reduction dimension contiguous, e.g. q and k rows, or
//     P's rows of keys): SBO = 1024 bytes between 8-row groups; a step
//     of 16 along K inside the 128-byte row adds 32 bytes to the start.
//   - MN-major (the output dimension contiguous, e.g. v stored keys x
//     values, read as B with the transpose flag): SBO = 1024 bytes
//     between groups of 8 keys, LBO = the distance between two 64-column
//     boxes; a step of 16 keys adds 16 rows = 2048 bytes to the start.
// The host links no libcuda: the tensor-map encoder is looked up with
// cudaGetDriverEntryPoint.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

// --- shared memory and barriers ---------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory rounded up to 1024 bytes (the swizzle atom);
// callers ask for 1024 bytes more than they use
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t s = smem_u32(p);
  return p + ((1024u - (s & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the TMA unit (async proxy)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also announces `bytes` of TMA transfers to the phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// waits until the barrier's current phase parity differs from `parity`
// (the phase with that parity has completed). No trap on a long wait: a
// trap in the kernel makes ptxas ignore setmaxnreg's register budgets.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// named barriers among `count` threads (id 0 is __syncthreads')
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// warpgroup register budget (all four warps of the warpgroup execute it)
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// --- TMA ----------------------------------------------------------------

// L2 policy for data read exactly once (CUTLASS's CacheHintSm90::EVICT_FIRST)
constexpr uint64_t EVICT_FIRST = 0x12F0000000000000ull;

// box at element coordinates (c0 innermost, c1, c2) of a 3-D tensor map
// into shared memory; completion counts its bytes on `bar`. Elements
// outside the tensor are zero-filled.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d_hint(void* dst, const CUtensorMap* map, uint64_t* bar,
                                                 int c0, int c1, int c2, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "l"(policy)
      : "memory");
}

// --- wgmma ---------------------------------------------------------------

// descriptor of a 128-byte-swizzled tile at `p` (1024-byte aligned atom
// base plus the in-row offset of a K step); offsets in bytes
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32;
  d |= 1ull << 62;  // layout type 1: 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the wait (or the issue) that precedes
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N> __device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define HOPPER_D8(i)                                                                         \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),            \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_D64                                                                           \
  HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24), HOPPER_D8(32), HOPPER_D8(40),    \
      HOPPER_D8(48), HOPPER_D8(56)
#define HOPPER_R64                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "         \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "          \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128 float32, the warpgroup's accumulator fragment) (+)= A B:
// A 64 x 16 and B 16 x 128 bf16, both from shared memory. B is K-major
// (TRANS_B = 0) or MN-major (TRANS_B = 1). scale_d = 0 overwrites d.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_R64
      ", %64, %65, p, 1, 1, 0, %67;\n}\n"
      : HOPPER_D64
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// the same with A from registers: a0..a3 hold the thread's bf16 pairs
// (rows g and g + 8 of its warp's 16, keys 2t, 2t + 1 and 2t + 8, 2t + 9)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                                    uint32_t a2, uint32_t a3, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : HOPPER_D64
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

#undef HOPPER_D8
#undef HOPPER_D64
#undef HOPPER_R64

// accumulator fragment of m64nNk16, float32: register i of thread
// (warp w of the warpgroup, lane = 4 g + t) holds row 16 w + g + 8 ((i >> 1) & 1),
// column 8 (i >> 2) + 2 t + (i & 1)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// --- host: tensor maps -----------------------------------------------------

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
                                            : nullptr;
  }();
  return fn;
}

// failures of the encoding are returned as this plus their CUresult
constexpr int TENSOR_MAP_ERROR = 0x10000;

// the map of a contiguous row-major bf16 tensor (d2, d1, d0) with boxes
// of (1, box1, box0) elements, 128-byte swizzle (box0 = 64), elements
// outside the tensor read as zero; an L2 miss fetches 256 bytes (the next
// 128-byte box of the same rows is usually the next load). Returns 0 or
// TENSOR_MAP_ERROR + CUresult.
inline int encode_bf16_3d(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1,
                          uint64_t d2, uint32_t box0, uint32_t box1) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return TENSOR_MAP_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};  // bytes, of dims 1 and 2
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)r;
}

}  // namespace hopper
