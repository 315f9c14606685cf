// K2b: the backward of K2, InstanceNorm (+ optional ReLU), for Hopper
// (sm_90a), on fp32 or bf16 tensors.
//
// Replaces the gradient of the custom-vjp entry `instance_norm_fused` in
// animateportrait_tpu/ops/pallas_instnorm.py (`_bwd`): there the backward
// is `jax.vjp` of the XLA formulation `_xla_instance_norm`, not a Pallas
// kernel; the port writes it as a kernel of its own.
//
// Computes, for every (n, c) plane of contiguous NCHW x and upstream
// gradient g, with the plane's k = E[x], m = E[x - k] and rstd that K2
// saved in its stats buffer ((planes, 3) fp32):
//   xhat = ((x - k) - m) * rstd,  gy = g * [xhat > 0] with ReLU, else g,
//   dx = rstd * (gy - E[gy] - xhat * E[gy * xhat]).
// xhat takes K2's steps on K2's numbers, so it is K2's pre-ReLU output bit
// for bit and the ReLU mask is the one the forward applied.
// The plain version (ops/instnorm.py:instance_norm_backward_plain) computes
// the same steps.
//
// Storage type T is float or __nv_bfloat16, one body for both. In bf16, as
// jax.vjp of the XLA formulation does (it upcasts the cotangent), x and g
// are widened to fp32 on load (__bfloat162float), xhat, both plane means
// and dx are fp32, and dx is rounded to bf16 once, to nearest even
// (__float2bfloat16_rn).
//
// Design, simple first (making it fast is later work):
// - A plane, or for a large plane each CTA's 1/k of it, is read once from
//   device memory into shared memory as x and g in their storage type
//   (2 * sizeof(T) bytes an element: 8 in fp32, 4 in bf16, so a bf16 plane
//   needs half the CTAs), and the two sums are taken in the same sweep;
//   the second sweep recomputes xhat and gy from shared memory, by the same
//   steps, so they are the first sweep's bit for bit. Loads and stores take
//   4 elements at a time (16 bytes in fp32, 8 in bf16) where the plane
//   allows it (hw % 4 == 0, aligned tensors), one otherwise: the
//   discriminators' 31 x 31 planes (hw = 961) take the scalar branch.
// - A plane over the wrapper's per-CTA budget is split over a thread block
//   cluster of k = 2, 4 or 8 CTAs (portable sizes), as in K2: every CTA adds
//   the cluster's partial sums in rank order through distributed shared
//   memory, so all slices use identical sums.
// - dx is computed from shared memory and written with coalesced stores:
//   device traffic is one read of x and g and one write of dx.
// - A plane over 8 CTAs' shared memory (on no path of the port) takes the
//   streaming branch: one block per plane, two sweeps over device memory.
//
// What bounds it on this card: memory, 3 * sizeof(T) bytes an element
// (read x and g, write dx: 12 in fp32, 6 in bf16) over 3.35 TB/s; ~10 flops
// an element.
#include <algorithm>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxClusterSize = 8;            // portable cluster size
// dynamic shared memory a CTA may take (227 KB less the static arrays)
constexpr int kMaxSliceBytes = 232448 - 1024;

// four consecutive elements of T as one load or store
template <typename T>
struct Pack4;
template <>
struct Pack4<float> {
  using type = float4;
};
template <>
struct Pack4<bf16> {
  using type = uint2;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 narrow<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float4 widen4(float4 v) { return v; }
__device__ __forceinline__ float4 widen4(uint2 u) {
  const bf16* h = reinterpret_cast<const bf16*>(&u);
  return make_float4(__bfloat162float(h[0]), __bfloat162float(h[1]),
                     __bfloat162float(h[2]), __bfloat162float(h[3]));
}

template <typename T>
__device__ __forceinline__ typename Pack4<T>::type narrow4(float4 v);
template <>
__device__ __forceinline__ float4 narrow4<float>(float4 v) { return v; }
template <>
__device__ __forceinline__ uint2 narrow4<bf16>(float4 v) {
  uint2 u;
  bf16* h = reinterpret_cast<bf16*>(&u);
  h[0] = __float2bfloat16_rn(v.x);
  h[1] = __float2bfloat16_rn(v.y);
  h[2] = __float2bfloat16_rn(v.z);
  h[3] = __float2bfloat16_rn(v.w);
  return u;
}

__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float part_a[32];
  __shared__ float part_b[32];
  __shared__ float total_a;
  __shared__ float total_b;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    part_a[warp] = a;
    part_b[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    a = lane < n_warps ? part_a[lane] : 0.f;
    b = lane < n_warps ? part_b[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (lane == 0) {
      total_a = a;
      total_b = b;
    }
  }
  __syncthreads();
  a = total_a;
  b = total_b;
}

// xhat and gy of one element; adds gy and gy * xhat to the sums
__device__ __forceinline__ void prep1(float xv, float gv, float k, float mean,
                                      float rstd, bool relu, float& xh,
                                      float& gy, float& s1, float& s2) {
  xh = ((xv - k) - mean) * rstd;
  gy = (relu && !(xh > 0.f)) ? 0.f : gv;
  s1 += gy;
  s2 += gy * xh;
}

__device__ __forceinline__ float dx1(float xh, float gy, float m1, float m2,
                                     float rstd) {
  return rstd * ((gy - m1) - xh * m2);
}

// dx of one element from x and g, with the plane's means m1 and m2
__device__ __forceinline__ float grad1(float xv, float gv, float k,
                                       float mean, float rstd, bool relu,
                                       float m1, float m2) {
  float xh, gy, u1 = 0.f, u2 = 0.f;
  prep1(xv, gv, k, mean, rstd, relu, xh, gy, u1, u2);
  return dx1(xh, gy, m1, m2, rstd);
}

// ---------------------------------------------------------------------------
// Shared-memory kernel: cluster rank r of a plane holds x and g of elements
// [r * slice, min((r + 1) * slice, hw)) in dynamic shared memory, in their
// storage type (x in the first `slice` elements, g in the next). kVec:
// 4-element loads and stores (hw % 4 == 0 and aligned tensors).
template <typename T, bool kVec, bool kCluster>
__global__ void __launch_bounds__(512)
instance_norm_bwd_smem_kernel(const T* __restrict__ x,
                              const T* __restrict__ g,
                              const float* __restrict__ stats,
                              T* __restrict__ dx, int hw, int slice,
                              int relu) {
  using P = typename Pack4<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float part[2];                   // this CTA's two sums

  cg::cluster_group cluster = cg::this_cluster();
  const int k = kCluster ? static_cast<int>(cluster.num_blocks()) : 1;
  const int rank = kCluster ? static_cast<int>(cluster.block_rank()) : 0;
  const size_t plane = blockIdx.x / k;
  const int begin = rank * slice;
  const int count = max(0, min(slice, hw - begin));
  const size_t offset = plane * static_cast<size_t>(hw) + begin;
  const float k0 = stats[3 * plane];
  const float mean = stats[3 * plane + 1];
  const float rstd = stats[3 * plane + 2];
  const bool r = relu != 0;
  const int tid = threadIdx.x;
  T* xs = reinterpret_cast<T*>(smem);
  T* gs = xs + slice;

  // 1. one read of x and g into shared memory, and the sums
  float s1 = 0.f;
  float s2 = 0.f;
  float xh, gy;
  if (kVec) {
    const P* x4 = reinterpret_cast<const P*>(x + offset);
    const P* g4 = reinterpret_cast<const P*>(g + offset);
    P* xs4 = reinterpret_cast<P*>(xs);
    P* gs4 = reinterpret_cast<P*>(gs);
#pragma unroll 4
    for (int i = tid; i < count / 4; i += blockDim.x) {
      const P pa = x4[i];
      const P pb = g4[i];
      xs4[i] = pa;
      gs4[i] = pb;
      const float4 a = widen4(pa);
      const float4 b = widen4(pb);
      prep1(a.x, b.x, k0, mean, rstd, r, xh, gy, s1, s2);
      prep1(a.y, b.y, k0, mean, rstd, r, xh, gy, s1, s2);
      prep1(a.z, b.z, k0, mean, rstd, r, xh, gy, s1, s2);
      prep1(a.w, b.w, k0, mean, rstd, r, xh, gy, s1, s2);
    }
  } else {
    const T* xp = x + offset;
    const T* gp = g + offset;
    for (int i = tid; i < count; i += blockDim.x) {
      const T a = xp[i];
      const T b = gp[i];
      xs[i] = a;
      gs[i] = b;
      prep1(widen(a), widen(b), k0, mean, rstd, r, xh, gy, s1, s2);
    }
  }
  block_sum2(s1, s2);
  float t1 = s1;
  float t2 = s2;
  if (kCluster) {
    if (tid == 0) {
      part[0] = s1;
      part[1] = s2;
    }
    cluster.sync();
    t1 = 0.f;
    t2 = 0.f;
    for (int q = 0; q < k; ++q) {
      t1 += *cluster.map_shared_rank(&part[0], q);
      t2 += *cluster.map_shared_rank(&part[1], q);
    }
    // done with the other CTAs' shared memory; wait for theirs at the end
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  }
  const float cnt = static_cast<float>(hw);
  const float m1 = t1 / cnt;
  const float m2 = t2 / cnt;

  // 2. dx from shared memory (each thread reads back what it wrote)
  if (kVec) {
    const P* xs4 = reinterpret_cast<const P*>(xs);
    const P* gs4 = reinterpret_cast<const P*>(gs);
    P* d4 = reinterpret_cast<P*>(dx + offset);
    for (int i = tid; i < count / 4; i += blockDim.x) {
      const float4 a = widen4(xs4[i]);
      const float4 b = widen4(gs4[i]);
      d4[i] = narrow4<T>(make_float4(
          grad1(a.x, b.x, k0, mean, rstd, r, m1, m2),
          grad1(a.y, b.y, k0, mean, rstd, r, m1, m2),
          grad1(a.z, b.z, k0, mean, rstd, r, m1, m2),
          grad1(a.w, b.w, k0, mean, rstd, r, m1, m2)));
    }
  } else {
    T* dp = dx + offset;
    for (int i = tid; i < count; i += blockDim.x) {
      dp[i] = narrow<T>(grad1(widen(xs[i]), widen(gs[i]), k0, mean, rstd, r,
                              m1, m2));
    }
  }
  if (kCluster) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Streaming branch, for planes over 8 CTAs' shared memory: one block per
// plane, two sweeps over device memory (sums, then dx).
template <typename T>
__global__ void instance_norm_bwd_stream_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ stats, T* __restrict__ dx, int hw, int relu) {
  const size_t offset = static_cast<size_t>(blockIdx.x) * hw;
  const T* xp = x + offset;
  const T* gp = g + offset;
  T* dp = dx + offset;
  const float k0 = stats[3 * blockIdx.x];
  const float mean = stats[3 * blockIdx.x + 1];
  const float rstd = stats[3 * blockIdx.x + 2];
  const bool r = relu != 0;
  float s1 = 0.f;
  float s2 = 0.f;
  float xh, gy;
  for (int i = threadIdx.x; i < hw; i += blockDim.x) {
    prep1(widen(xp[i]), widen(gp[i]), k0, mean, rstd, r, xh, gy, s1, s2);
  }
  block_sum2(s1, s2);
  const float cnt = static_cast<float>(hw);
  const float m1 = s1 / cnt;
  const float m2 = s2 / cnt;
  for (int i = threadIdx.x; i < hw; i += blockDim.x) {
    dp[i] = narrow<T>(grad1(widen(xp[i]), widen(gp[i]), k0, mean, rstd, r,
                            m1, m2));
  }
}

template <typename T, bool kVec, bool kCluster>
cudaError_t launch_smem(const T* x, const T* g, const float* stats, T* dx,
                        int planes, int hw, int cluster, int slice, int relu,
                        cudaStream_t stream) {
  // raise the kernel's dynamic shared memory limit once per size and
  // card: the attribute belongs to the current card, and one process may
  // launch on several (a renderer with a replica on each card)
  constexpr int kCards = 64;
  static int limit[kCards] = {};
  int card = 0;
  const cudaError_t got = cudaGetDevice(&card);
  if (got != cudaSuccess) return got;
  const int bytes = 2 * static_cast<int>(sizeof(T)) * slice;
  if (card >= kCards || bytes > std::max(limit[card], 48 * 1024)) {
    const cudaError_t e = cudaFuncSetAttribute(
        instance_norm_bwd_smem_kernel<T, kVec, kCluster>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    if (card < kCards) limit[card] = bytes;
  }
  // about 16 elements a thread, 64 to 512 threads
  int threads = 64;
  while (threads < 512 && threads * 16 < slice) threads *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(planes) * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kCluster ? 1 : 0;
  return cudaLaunchKernelEx(&cfg,
                            instance_norm_bwd_smem_kernel<T, kVec, kCluster>,
                            x, g, stats, dx, hw, slice, relu);
}

template <typename T, bool kVec>
cudaError_t launch_smem(const T* x, const T* g, const float* stats, T* dx,
                        int planes, int hw, int cluster, int slice, int relu,
                        cudaStream_t stream) {
  return cluster > 1
             ? launch_smem<T, kVec, true>(x, g, stats, dx, planes, hw,
                                          cluster, slice, relu, stream)
             : launch_smem<T, kVec, false>(x, g, stats, dx, planes, hw,
                                           cluster, slice, relu, stream);
}

template <typename T>
int run(const T* x, const T* g, const float* stats, T* dx, int planes,
        int hw, int relu, int cluster, cudaStream_t stream) {
  if (cluster == 0) {
    instance_norm_bwd_stream_kernel<T><<<planes, 512, 0, stream>>>(
        x, g, stats, dx, hw, relu);
    return static_cast<int>(cudaGetLastError());
  }
  if (cluster < 1 || cluster > kMaxClusterSize ||
      (cluster & (cluster - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // each slice a multiple of 4 elements, so that every slice starts on a
  // 4-element boundary (ops/instnorm.py:slice_elems)
  const int slice = ((hw + cluster - 1) / cluster + 3) / 4 * 4;
  if (2 * static_cast<int>(sizeof(T)) * slice > kMaxSliceBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = (hw % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(x) % align == 0) &&
                   (reinterpret_cast<uintptr_t>(g) % align == 0) &&
                   (reinterpret_cast<uintptr_t>(dx) % align == 0);
  const cudaError_t err =
      vec ? launch_smem<T, true>(x, g, stats, dx, planes, hw, cluster, slice,
                                 relu, stream)
          : launch_smem<T, false>(x, g, stats, dx, planes, hw, cluster, slice,
                                  relu, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cluster: CTAs per plane, 1, 2, 4 or 8, whose slices (2 * sizeof(T) bytes
// an element) must fit a CTA's shared memory, or 0 for the streaming
// branch. The wrapper picks it (ops/instnorm.py:cluster_size); anything
// else returns cudaErrorInvalidValue and launches nothing. stats: the
// (planes, 3) k, m and rstd that K2 wrote.
extern "C" int ap_instance_norm_bwd(const float* x, const float* g,
                                    const float* stats, float* dx, int planes,
                                    int hw, int relu, int cluster,
                                    cudaStream_t stream) {
  return run<float>(x, g, stats, dx, planes, hw, relu, cluster, stream);
}

// The same on bf16 x, g and dx (stats fp32).
extern "C" int ap_instance_norm_bwd_bf16(const bf16* x, const bf16* g,
                                         const float* stats, bf16* dx,
                                         int planes, int hw, int relu,
                                         int cluster, cudaStream_t stream) {
  return run<bf16>(x, g, stats, dx, planes, hw, relu, cluster, stream);
}
