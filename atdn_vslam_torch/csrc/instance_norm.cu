// K6: the non-affine instance norm of a contiguous NCHW tensor, with the
// ReLU that follows it, in one launch.
//
// Replaces no TPU kernel: the JAX package's feature encoders
// (atdn_vslam_tpu/models/flow/extractor.py:72, instance_norm) leave the
// norm to XLA, which fuses it with its neighbours. The port's encoders
// (GMA's fnet, GMFlow's backbone) ran it as PyTorch's chain: a float32
// copy of the bf16 convolution output, training-mode batch norm over the
// (1, B * C, H, W) view (a statistics kernel of one block per plane,
// then a transform kernel), a cast back to bf16 and a separate ReLU:
// five launches and ~28 bytes of traffic an element.
//
// Function: per (b, c) plane of n = H * W elements, the biased mean and
// variance in float32, y = (x - mean) * (1 / sqrt(var + eps)) in
// float32, then max(y, 0) when relu is set (NaN stays NaN, as F.relu),
// rounded once to the input's type (bf16 or float32). No atomics: the
// same input gives the same bits on every run.
//
// Bound on an H100: bytes. An element is read once and written once, 4
// bytes in bf16: a KITTI frame's 15 norms (55.6M elements) take at least
// 0.066 ms at 3.35 TB/s. The work per element is a few operations, so
// what keeps a norm from its bound is the number of bytes it moves and
// whether it fills the 132 SMs: at batch 1 a plane per block gives 64-128
// blocks.
//
// Design (instance_norm_kernel<T, kCluster>): a thread-block cluster of
// k blocks per plane, k chosen by the wrapper from the shape
// (ops/norm.py _plan: the smallest k that fits a slice into shared
// memory and puts about two blocks per SM, at most 16). Each block reads
// its slice of the plane once from device memory, 16 bytes a thread,
// into shared memory, summing it as it lands; from the resident copy it
// takes the slice's mean and then its sum of squared deviations from
// that mean (a second pass over shared memory, not device memory). The
// blocks swap their (count, mean, M2) through distributed shared memory
// and each merges all k in rank order (Chan's update), so every block
// holds the same moments. Each block then normalises its resident slice
// and stores it 16 bytes a thread: one read and one write of the plane.
// Slices start at 16-byte aligned elements of the tensor; only a plane's
// unaligned ends (KITTI's 1/8 planes of 7,238 elements) are read as
// scalars.
// A plane too large for 16 blocks' shared memory takes the two-pass form
// of the same code: kPartials writes each slice's moments to a float32
// scratch (its two passes read device memory; the second mostly from
// L2), kFinish merges them in rank order and normalises from device
// memory.
// Measured on an H100 (chip_smoke.py): a KITTI frame's 15 calls 0.19 ms,
// 35% of the bound (the chain took 1.63 ms), Cityscapes' 0.64 ms, 47%;
// the two-pass form 0.23 and 0.77 ms. What is left is latency: the 1/4
// and 1/8 planes take 6-8 us a call whatever k, against a 1-3 us bound.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // 16-byte loads a thread keeps in flight
constexpr int kMaxCluster = 16;  // a plane's clustered slices, at most (non-portable)

enum Mode : int { kCluster = 0, kPartials = 1, kFinish = 2 };

// (count, mean, sum of squared deviations from the mean) of a run
struct Moments {
  float n, mean, m2;
};

// Chan, Golub and LeVeque's update: the moments of run a followed by run b
__device__ __forceinline__ Moments merge(const Moments& a, const Moments& b) {
  if (b.n == 0.0f) return a;
  const float n = a.n + b.n, wb = b.n / n, delta = b.mean - a.mean;
  return {n, fmaf(delta, wb, a.mean), a.m2 + b.m2 + delta * delta * (a.n * wb)};
}

// 16 bytes of T as floats, and back (round to nearest even)
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float (&f)[V]) {
    f[0] = __uint_as_float(r.x), f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z), f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[V]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
  static __device__ __forceinline__ float to_float(float v) { return v; }
  static __device__ __forceinline__ float from_float(float v) { return v; }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ void unpack(const uint4& r, float (&f)[V]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint32_t pair(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[V]) {
    return make_uint4(pair(f[0], f[1]), pair(f[2], f[3]), pair(f[4], f[5]), pair(f[6], f[7]));
  }
  static __device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float v) {
    return __float2bfloat16_rn(v);
  }
};

// the block's sum of v, the same bits in every thread (xor butterflies
// are symmetric, then every warp reduces the warps' sums alike)
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = lane < kWarps ? red[lane] : 0.0f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  __syncthreads();  // red is reused
  return t;
}

__device__ __forceinline__ float activate(float v, float mean, float inv, int relu) {
  const float y = (v - mean) * inv;
  return relu && y < 0.0f ? 0.0f : y;  // NaN stays NaN
}

// Visits the thread's share of the elements [g0, g1) of the flattened
// tensor: the scalars before the first and after the last 16-byte
// boundary one element a thread, then the aligned vectors kUnroll at a
// time, vector i of a round at v + i * kThreads. one(g) takes an element,
// vecs(v, count) a round of vectors.
template <int V, typename One, typename Vecs>
__device__ __forceinline__ void visit(long long g0, long long g1, One&& one, Vecs&& vecs) {
  const long long vb = (g0 + V - 1) / V, ve = max(g1 / V, vb);
  const long long head_end = min(vb * V, g1);
  for (long long g = g0 + threadIdx.x; g < head_end; g += kThreads) one(g);
  for (long long g = ve * V + threadIdx.x; g < g1; g += kThreads) one(g);
  for (long long v = vb + threadIdx.x; v < ve; v += (long long)kThreads * kUnroll) {
    const long long left = (ve - v + kThreads - 1) / kThreads;
    vecs(v, left < kUnroll ? (int)left : kUnroll);
  }
}

// kCluster: grid (planes * k), clusters of k blocks, a plane's slices;
// dynamic shared memory holds a slice. kPartials: the same grid without
// clusters, writing each slice's moments to parts (planes, k, 3).
// kFinish: merges parts and writes y.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    instance_norm_kernel(const T* __restrict__ x, T* __restrict__ y, float* __restrict__ parts,
                         long long n, int k, float eps, int relu) {
  using P = Pack<T>;
  constexpr int V = P::V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[kWarps];
  __shared__ Moments own, all[kThreads];

  const long long plane = blockIdx.x / k;
  const int rank = blockIdx.x % k;
  // slice bounds: plane-interior ones rounded up to 16-byte boundaries
  const long long base = plane * n, per = (n + k - 1) / k;
  auto bound = [&](int r) -> long long {
    if (r <= 0) return base;
    if (r >= k) return base + n;
    return min((base + r * per + V - 1) / V * V, base + n);
  };
  const long long g0 = bound(rank), g1 = bound(rank + 1);
  // the resident slice (kCluster): element g at sm[g - so], so the
  // vectors lie 16-byte aligned in shared memory too
  const long long so = g0 / V * V;
  T* sm = reinterpret_cast<T*>(smem_raw);
  uint4* smv = reinterpret_cast<uint4*>(smem_raw);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  // element g and vector v of the slice, from the resident copy
  // (kCluster) or device memory
  auto elem = [&](long long g) -> float {
    if constexpr (MODE == kCluster) return P::to_float(sm[g - so]);
    else return P::to_float(x[g]);
  };
  auto vec = [&](long long v) -> uint4 {
    if constexpr (MODE == kCluster) return smv[v - so / V];
    else return __ldg(xv + v);
  };

  if constexpr (MODE == kFinish) {
    if (threadIdx.x < k) {
      const float* p = parts + 3 * (plane * k + threadIdx.x);
      all[threadIdx.x] = {p[0], p[1], p[2]};
    }
    __syncthreads();
  } else {
    // the slice's sum (and, clustered, its copy in shared memory)
    float s = 0.0f;
    visit<V>(
        g0, g1,
        [&](long long g) {
          const T v = x[g];
          if constexpr (MODE == kCluster) sm[g - so] = v;
          s += P::to_float(v);
        },
        [&](long long v, int count) {
          uint4 r[kUnroll];
#pragma unroll
          for (int i = 0; i < kUnroll; ++i)
            if (i < count) r[i] = __ldg(xv + v + i * kThreads);
#pragma unroll
          for (int i = 0; i < kUnroll; ++i) {
            if (i < count) {
              if constexpr (MODE == kCluster) smv[v + i * kThreads - so / V] = r[i];
              float f[V];
              P::unpack(r[i], f);
#pragma unroll
              for (int j = 0; j < V; ++j) s += f[j];
            }
          }
        });
    // (each thread reads back only what it wrote: no barrier needed)
    const float count = (float)(g1 - g0), total = block_sum(s, red);
    const float slice_mean = count > 0.0f ? total / count : 0.0f;
    // the squared deviations from the slice's own mean
    float m2 = 0.0f;
    visit<V>(
        g0, g1,
        [&](long long g) {
          const float d = elem(g) - slice_mean;
          m2 = fmaf(d, d, m2);
        },
        [&](long long v, int count) {
          uint4 r[kUnroll];
#pragma unroll
          for (int i = 0; i < kUnroll; ++i)
            if (i < count) r[i] = vec(v + i * kThreads);
#pragma unroll
          for (int i = 0; i < kUnroll; ++i) {
            if (i < count) {
              float f[V];
              P::unpack(r[i], f);
#pragma unroll
              for (int j = 0; j < V; ++j) {
                const float d = f[j] - slice_mean;
                m2 = fmaf(d, d, m2);
              }
            }
          }
        });
    m2 = block_sum(m2, red);
    if constexpr (MODE == kPartials) {
      if (threadIdx.x == 0) {
        float* p = parts + 3 * (plane * k + rank);
        p[0] = count, p[1] = slice_mean, p[2] = m2;
      }
      return;
    } else {
      // swap the slices' moments through distributed shared memory
      cg::cluster_group cluster = cg::this_cluster();
      if (threadIdx.x == 0) own = {count, slice_mean, m2};
      cluster.sync();
      if (threadIdx.x < k) all[threadIdx.x] = *cluster.map_shared_rank(&own, threadIdx.x);
      cluster.sync();  // no block leaves while a peer still reads its moments
    }
  }
  // every thread merges the k slices in rank order: the same bits
  Moments m = all[0];
  for (int r = 1; r < k; ++r) m = merge(m, all[r]);
  const float mean = m.mean, inv = 1.0f / sqrtf(m.m2 / (float)n + eps);

  uint4* yv = reinterpret_cast<uint4*>(y);
  visit<V>(
      g0, g1,
      [&](long long g) { y[g] = P::from_float(activate(elem(g), mean, inv, relu)); },
      [&](long long v, int count) {
        uint4 r[kUnroll];
#pragma unroll
        for (int i = 0; i < kUnroll; ++i)
          if (i < count) r[i] = vec(v + i * kThreads);
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) {
          if (i < count) {
            float f[V];
            P::unpack(r[i], f);
#pragma unroll
            for (int j = 0; j < V; ++j) f[j] = activate(f[j], mean, inv, relu);
            yv[v + i * kThreads] = P::pack(f);
          }
        }
      });
}

// the resident slice's bytes for k blocks a plane of n elements
template <typename T>
size_t slice_bytes(long long n, int k) {
  constexpr int V = Pack<T>::V;
  return (size_t)((n + k - 1) / k + 2 * V) * sizeof(T);
}

template <typename T, int MODE>
cudaError_t launch(const void* x, void* y, float* parts, long long planes, long long n, int k,
                   float eps, int relu, cudaStream_t stream) {
  auto kernel = instance_norm_kernel<T, MODE>;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3((unsigned)(planes * k));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  if constexpr (MODE == kCluster) {
    cfg.dynamicSmemBytes = slice_bytes<T>(n, k);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)cfg.dynamicSmemBytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = k;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), static_cast<T*>(y),
                                       parts, n, k, eps, relu);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* x, void* y, float* parts, long long planes, long long n, int k,
                int two_pass, float eps, int relu, cudaStream_t stream) {
  if (!two_pass) return launch<T, kCluster>(x, y, nullptr, planes, n, k, eps, relu, stream);
  cudaError_t err = launch<T, kPartials>(x, y, parts, planes, n, k, eps, relu, stream);
  return err != cudaSuccess ? err : launch<T, kFinish>(x, y, parts, planes, n, k, eps, relu, stream);
}

}  // namespace

// x, y: (planes, n) contiguous, 16-byte aligned, bf16 (is_bf16 = 1) or
// float32; k: the blocks (slices) a plane; two_pass = 0: one clustered
// launch, k <= 16, its slices resident in shared memory (at most the
// device's per-block limit); two_pass = 1: moments of k <= 256 slices a
// plane into parts ((planes, k, 3) float32 scratch), then a second
// launch that merges them and writes y. Returns a cudaError_t (0 on success).
extern "C" int atdn_instance_norm(const void* x, void* y, void* parts, long long planes,
                                  long long n, int k, int two_pass, int is_bf16, int relu,
                                  float eps, int device, void* stream) {
  if (k < 1 || k > (two_pass ? kThreads : kMaxCluster) || planes < 1 || n < 1 ||
      planes * k > 0x7fffffffLL || (two_pass && parts == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(parts);
  return (int)(is_bf16 ? run<__nv_bfloat16>(x, y, p, planes, n, k, two_pass, eps, relu, s)
                       : run<float>(x, y, p, planes, n, k, two_pass, eps, relu, s));
}

// blocks of the clustered kernel resident per SM (two_pass = 0, its slice
// for k blocks a plane of n elements in shared memory) or of the
// two-pass kernels (two_pass = 1); returns a cudaError_t
extern "C" int atdn_instance_norm_occupancy(int is_bf16, int two_pass, long long n, int k,
                                            int* blocks, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (two_pass)
    return (int)(is_bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                               blocks, instance_norm_kernel<__nv_bfloat16, kPartials>, kThreads, 0)
                         : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                               blocks, instance_norm_kernel<float, kPartials>, kThreads, 0));
  if (is_bf16) {
    const size_t smem = slice_bytes<__nv_bfloat16>(n, k);
    err = cudaFuncSetAttribute(instance_norm_kernel<__nv_bfloat16, kCluster>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, instance_norm_kernel<__nv_bfloat16, kCluster>, kThreads, smem);
  }
  const size_t smem = slice_bytes<float>(n, k);
  err = cudaFuncSetAttribute(instance_norm_kernel<float, kCluster>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, instance_norm_kernel<float, kCluster>, kThreads, smem);
}
