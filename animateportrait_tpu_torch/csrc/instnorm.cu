// K2: fused InstanceNorm (+ optional ReLU), forward only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel`, launched by `_pallas_forward`
// (custom-vjp entry `instance_norm_fused`) in
// animateportrait_tpu/ops/pallas_instnorm.py.
//
// Computes, for every (n, c) plane of a contiguous NCHW fp32 tensor,
//   k = E[x], d = x - k, m = E[d], var = max(E[d^2] - m^2, 0),
//   y = (d - m) * rsqrt(var + eps)
// and optionally y = max(y, 0): the one-pass statistics with the clamp that
// the JAX package uses by default (`_xla_instance_norm`, onepass), over the
// plane shifted by its mean k. Unshifted, the form loses digits to
// cancellation in proportion to mean^2 / var; the landmark encoder's mostly
// flat planes (mean/std ~12) lost enough that two summation orders
// disagreed by ~1e-4. Shifted, m is nearly 0 and nothing cancels. The TPU
// kernel, too, takes the mean before the variance. The plain version in
// ops/instnorm.py computes the same steps.
//
// Design: one read and one write of device memory.
// - A plane, or for a large plane each CTA's 1/k of it, is copied once
//   into shared memory by 1-D TMA bulk copies
//   (cp.async.bulk ... mbarrier::complete_tx), in 8 KB chunks with one
//   mbarrier each, so the first sum starts while later chunks arrive.
// - The mean, then the shifted sums, are taken from shared memory, so the
//   mean shift costs no device-memory traffic. Sums are fp32, reduced by
//   warp shuffles, across warps through shared memory, and across the
//   cluster through distributed shared memory (every CTA adds the k
//   partials in rank order, so all get the same statistics).
// - The output is normalized from shared memory and written with coalesced
//   float4 stores: device traffic is one read and one write. (Normalizing
//   in place and writing each chunk back by a bulk store was 2-19% slower
//   at every main-path shape on the H100; PERF.md.)
// - A plane larger than the wrapper's per-CTA budget is split over a
//   thread block cluster of k = 2, 4 or 8 CTAs (portable sizes), launched
//   with cudaLaunchKernelEx; the wrapper picks k. That also fills the SMs: (1, 64, 512, 512) runs
//   512 CTAs of 128 KB. The budget sets how many CTAs share an SM (about
//   227 KB / budget), so that one CTA's loads overlap another's stores.
// - A plane or slice that is not 16-byte aligned (or hw % 4 != 0) is
//   staged with scalar loads and written with scalar stores.
// - A plane that one CTA holds skips the cluster barriers and reductions.
// - A plane over 8 CTAs' shared memory (~1.8 MB, on no path of the port)
//   takes the streaming branch of the same entry point: one block per plane
//   and three sweeps over device memory (mean, shifted sums, normalize).
//
// What bounds it on this card: memory. Each element is read once and
// written once and costs a handful of flops, so the bound is
// 8 bytes per element over 3.35 TB/s.
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 2048;                  // floats per bulk copy (8 KB)
constexpr int kMaxChunks = 32;
constexpr int kMaxClusterSize = 8;            // portable cluster size
// dynamic shared memory a CTA may take (227 KB less the static arrays)
constexpr int kMaxSliceBytes = 232448 - 1024;

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

// Sum of a over the block, in every thread.
__device__ __forceinline__ float block_sum(float a) {
  float unused = 0.f;
  block_sum2(a, unused);
  return a;
}

__device__ __forceinline__ float norm1(float v, float k, float mean,
                                       float inv, bool relu) {
  const float y = ((v - k) - mean) * inv;
  return relu ? fmaxf(y, 0.f) : y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// Shared-memory kernel: cluster rank r of a plane holds elements
// [r * slice, min((r + 1) * slice, hw)) of it in dynamic shared memory.
// kCluster is false for a plane that one CTA holds: it then needs no
// cluster barrier.
template <bool kBulk, bool kCluster>
__global__ void __launch_bounds__(512)
instance_norm_smem_kernel(const float* __restrict__ x, float* __restrict__ y,
                          int hw, int slice, float eps, int relu) {
  extern __shared__ __align__(128) float buf[];
  __shared__ __align__(8) uint64_t bars[kMaxChunks];
  __shared__ float part[3];                   // this CTA's s0, s1, s2

  cg::cluster_group cluster = cg::this_cluster();
  const int k = kCluster ? static_cast<int>(cluster.num_blocks()) : 1;
  const int rank = kCluster ? static_cast<int>(cluster.block_rank()) : 0;
  const size_t plane = blockIdx.x / k;
  const int begin = rank * slice;
  const int count = max(0, min(slice, hw - begin));
  const size_t offset = plane * static_cast<size_t>(hw) + begin;
  const float* xp = x + offset;
  float* yp = y + offset;
  const int n_chunks = (count + kChunk - 1) / kChunk;
  const float cnt = static_cast<float>(hw);
  const int tid = threadIdx.x;

  if (kBulk) {
    if (tid == 0) {
      for (int c = 0; c < n_chunks; ++c) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                     :: "r"(smem_addr(&bars[c])) : "memory");
      }
      if (kCluster) {
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      for (int c = 0; c < n_chunks; ++c) {
        const int c0 = c * kChunk;
        const uint32_t bytes = 4u * static_cast<uint32_t>(
            min(kChunk, count - c0));
        const uint32_t bar = smem_addr(&bars[c]);
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
            :: "r"(bar), "r"(bytes) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];\n"
            :: "r"(smem_addr(buf + c0)), "l"(xp + c0), "r"(bytes), "r"(bar)
            : "memory");
      }
    }
    // the barriers are initialised before any thread waits on them
    __syncthreads();
  } else {
    for (int i = tid; i < count; i += blockDim.x) buf[i] = xp[i];
    __syncthreads();
  }

  // 1. the plane's mean k, chunk by chunk as the chunks arrive
  float s0 = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * kChunk;
    const int c1 = min(count, c0 + kChunk);
    if (kBulk) {
      mbar_wait(smem_addr(&bars[c]), 0);
      const float4* b4 = reinterpret_cast<const float4*>(buf);
      for (int i = c0 / 4 + tid; i < c1 / 4; i += blockDim.x) {
        const float4 v = b4[i];
        s0 += (v.x + v.y) + (v.z + v.w);
      }
    } else {
      for (int i = c0 + tid; i < c1; i += blockDim.x) s0 += buf[i];
    }
  }
  float total = block_sum(s0);
  if (kCluster) {
    if (tid == 0) part[0] = total;
    cluster.sync();
    total = 0.f;
    for (int r = 0; r < k; ++r) {
      total += *cluster.map_shared_rank(&part[0], r);
    }
  }
  const float kmean = total / cnt;

  // 2. the shifted sums
  float s1 = 0.f;
  float s2 = 0.f;
  if (kBulk) {
    const float4* b4 = reinterpret_cast<const float4*>(buf);
    for (int i = tid; i < count / 4; i += blockDim.x) {
      const float4 v = b4[i];
      const float a = v.x - kmean, b = v.y - kmean, c = v.z - kmean,
                  d = v.w - kmean;
      s1 += (a + b) + (c + d);
      s2 += (a * a + b * b) + (c * c + d * d);
    }
  } else {
    for (int i = tid; i < count; i += blockDim.x) {
      const float d = buf[i] - kmean;
      s1 += d;
      s2 += d * d;
    }
  }
  block_sum2(s1, s2);
  float t1 = s1;
  float t2 = s2;
  if (kCluster) {
    if (tid == 0) {
      part[1] = s1;
      part[2] = s2;
    }
    cluster.sync();
    t1 = 0.f;
    t2 = 0.f;
    for (int r = 0; r < k; ++r) {
      t1 += *cluster.map_shared_rank(&part[1], r);
      t2 += *cluster.map_shared_rank(&part[2], r);
    }
    // done with the other CTAs' shared memory; wait for theirs at the end
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  }
  const float mean = t1 / cnt;
  const float var = fmaxf(t2 / cnt - mean * mean, 0.f);
  const float inv = rsqrtf(var + eps);
  const bool r = relu != 0;

  // 3. normalize from shared memory, coalesced float4 stores to y (a bulk
  // store of each normalized chunk was 2-19% slower at every shape)
  if (kBulk) {
    const float4* b4 = reinterpret_cast<const float4*>(buf);
    float4* y4 = reinterpret_cast<float4*>(yp);
    for (int i = tid; i < count / 4; i += blockDim.x) {
      float4 v = b4[i];
      v.x = norm1(v.x, kmean, mean, inv, r);
      v.y = norm1(v.y, kmean, mean, inv, r);
      v.z = norm1(v.z, kmean, mean, inv, r);
      v.w = norm1(v.w, kmean, mean, inv, r);
      y4[i] = v;
    }
  } else {
    for (int i = tid; i < count; i += blockDim.x) {
      yp[i] = norm1(buf[i], kmean, mean, inv, r);
    }
  }
  if (kCluster) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Streaming branch, for planes over 8 CTAs' shared memory: one block per
// plane, three sweeps over device memory, float4 loads where aligned.
template <bool kVec>
__global__ void instance_norm_stream_kernel(const float* __restrict__ x,
                                            float* __restrict__ y, int hw,
                                            float eps, int relu) {
  const size_t offset = static_cast<size_t>(blockIdx.x) * hw;
  const float* xp = x + offset;
  float* yp = y + offset;
  const float4* x4 = reinterpret_cast<const float4*>(xp);
  const int n4 = hw >> 2;
  const float cnt = static_cast<float>(hw);

  float s0 = 0.f;
  if (kVec) {
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      const float4 v = x4[i];
      s0 += (v.x + v.y) + (v.z + v.w);
    }
  } else {
    for (int i = threadIdx.x; i < hw; i += blockDim.x) {
      s0 += xp[i];
    }
  }
  const float k = block_sum(s0) / cnt;

  float s1 = 0.f;
  float s2 = 0.f;
  if (kVec) {
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      const float4 v = x4[i];
      const float a = v.x - k, b = v.y - k, c = v.z - k, d = v.w - k;
      s1 += (a + b) + (c + d);
      s2 += (a * a + b * b) + (c * c + d * d);
    }
  } else {
    for (int i = threadIdx.x; i < hw; i += blockDim.x) {
      const float d = xp[i] - k;
      s1 += d;
      s2 += d * d;
    }
  }
  block_sum2(s1, s2);
  const float mean = s1 / cnt;
  const float var = fmaxf(s2 / cnt - mean * mean, 0.f);
  const float inv = rsqrtf(var + eps);
  const bool r = relu != 0;

  if (kVec) {
    float4* y4 = reinterpret_cast<float4*>(yp);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      const float4 v = x4[i];
      float4 o;
      o.x = norm1(v.x, k, mean, inv, r);
      o.y = norm1(v.y, k, mean, inv, r);
      o.z = norm1(v.z, k, mean, inv, r);
      o.w = norm1(v.w, k, mean, inv, r);
      y4[i] = o;
    }
  } else {
    for (int i = threadIdx.x; i < hw; i += blockDim.x) {
      yp[i] = norm1(xp[i], k, mean, inv, r);
    }
  }
}

template <bool kBulk, bool kCluster>
cudaError_t launch_smem(const float* x, float* y, int planes, int hw,
                        int cluster, int slice, float eps, int relu,
                        cudaStream_t stream) {
  // raise the kernel's dynamic shared memory limit once per size
  static int limit = 48 * 1024;
  const int bytes = 4 * slice;
  if (bytes > limit) {
    const cudaError_t e = cudaFuncSetAttribute(
        instance_norm_smem_kernel<kBulk, kCluster>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    limit = bytes;
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
  return cudaLaunchKernelEx(&cfg, instance_norm_smem_kernel<kBulk, kCluster>,
                            x, y, hw, slice, eps, relu);
}

template <bool kBulk>
cudaError_t launch_smem(const float* x, float* y, int planes, int hw,
                        int cluster, int slice, float eps, int relu,
                        cudaStream_t stream) {
  return cluster > 1
             ? launch_smem<kBulk, true>(x, y, planes, hw, cluster, slice,
                                        eps, relu, stream)
             : launch_smem<kBulk, false>(x, y, planes, hw, cluster, slice,
                                         eps, relu, stream);
}

}  // namespace

// cluster: CTAs per plane, 1, 2, 4 or 8, whose slices must fit a CTA's
// shared memory, or 0 for the streaming branch. The wrapper picks it
// (ops/instnorm.py:cluster_size); anything else returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int ap_instance_norm(const float* x, float* y, int planes,
                                int hw, float eps, int relu, int cluster,
                                cudaStream_t stream) {
  const bool aligned = (hw % 4 == 0) &&
                       (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  if (cluster == 0) {
    const int threads = 512;
    if (aligned) {
      instance_norm_stream_kernel<true><<<planes, threads, 0, stream>>>(
          x, y, hw, eps, relu);
    } else {
      instance_norm_stream_kernel<false><<<planes, threads, 0, stream>>>(
          x, y, hw, eps, relu);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (cluster < 1 || cluster > kMaxClusterSize ||
      (cluster & (cluster - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // each slice a multiple of 4 elements, so that every slice is 16-byte
  // aligned (ops/instnorm.py:slice_elems)
  const int slice = ((hw + cluster - 1) / cluster + 3) / 4 * 4;
  if (4 * slice > kMaxSliceBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err =
      aligned ? launch_smem<true>(x, y, planes, hw, cluster, slice, eps, relu,
                                  stream)
              : launch_smem<false>(x, y, planes, hw, cluster, slice, eps,
                                   relu, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
