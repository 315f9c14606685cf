// K2: fused InstanceNorm (+ optional ReLU), forward, for Hopper (sm_90a),
// on fp32 or bf16 tensors. Its backward is K2b (instnorm_bwd.cu).
//
// Replaces the Pallas TPU kernel `_kernel`, launched by `_pallas_forward`
// (custom-vjp entry `instance_norm_fused`) in
// animateportrait_tpu/ops/pallas_instnorm.py.
//
// Computes, for every (n, c) plane of a contiguous NCHW tensor,
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
// Storage type T is float or __nv_bfloat16, one body for both. As the TPU
// kernel does for any dtype (`x.astype(f32)` ... `y.astype(o_ref.dtype)`),
// a bf16 element is widened to fp32 on load (__bfloat162float), every
// statistic and y (and its ReLU) is computed in fp32, and y is rounded to
// bf16 once, to nearest even (__float2bfloat16_rn), as `.to(torch.bfloat16)`
// and XLA's convert round. The statistics K2 saves stay fp32.
//
// Design: one read and one write of device memory.
// - A plane, or for a large plane each CTA's 1/k of it, is copied once
//   into shared memory, in its storage type, by 1-D TMA bulk copies
//   (cp.async.bulk ... mbarrier::complete_tx), in 8 KB chunks with one
//   mbarrier each, so the first sum starts while later chunks arrive.
// - The mean, then the shifted sums, are taken from shared memory, so the
//   mean shift costs no device-memory traffic. Sums are fp32, reduced by
//   warp shuffles, across warps through shared memory, and across the
//   cluster through distributed shared memory (every CTA adds the k
//   partials in rank order, so all get the same statistics).
// - The output is normalized from shared memory and written with coalesced
//   stores of 4 elements (16 bytes in fp32, 8 in bf16): device traffic is
//   one read and one write. (Normalizing in place and writing each chunk
//   back by a bulk store was 2-19% slower at every main-path shape on the
//   H100; PERF.md.)
// - A plane larger than the wrapper's per-CTA budget is split over a
//   thread block cluster of k = 2, 4 or 8 CTAs (portable sizes), launched
//   with cudaLaunchKernelEx; the wrapper picks k. That also fills the SMs:
//   (1, 64, 512, 512) fp32 runs 512 CTAs of 128 KB. The budget sets how
//   many CTAs share an SM (about 227 KB / budget), so that one CTA's loads
//   overlap another's stores. A bf16 plane takes half the shared memory,
//   so fewer CTAs.
// - A bulk copy moves 16-byte-aligned runs of a multiple of 16 bytes, so a
//   slice is a multiple of 16 bytes (4 fp32 or 8 bf16 elements). A plane
//   or slice that is not 16-byte aligned (hw not a multiple of 4 in fp32,
//   of 8 in bf16, or a tensor that starts off 16 bytes) is staged with
//   scalar loads and written with scalar stores: the discriminators' 31 x 31
//   planes take that path.
// - A plane that one CTA holds skips the cluster barriers and reductions.
// - A plane over 8 CTAs' shared memory (~1.8 MB, on no path of the port)
//   takes the streaming branch of the same entry point: one block per plane
//   and three sweeps over device memory (mean, shifted sums, normalize).
//
// - Given a stats buffer (training), rank 0 of each plane also writes the
//   plane's k, m and rstd = rsqrt(var + eps) there, (planes, 3) fp32, for
//   K2b, which then recomputes each pre-ReLU output bit for bit, so its
//   ReLU mask is this forward's; the inference path passes null and writes
//   nothing more.
//
// What bounds it on this card: memory. Each element is read once and
// written once and costs a handful of flops, so the bound is
// 2 * sizeof(T) bytes per element (8 in fp32, 4 in bf16) over 3.35 TB/s.
#include <algorithm>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kChunkBytes = 8192;             // bytes per bulk copy
constexpr int kMaxChunks = 32;
constexpr int kMaxClusterSize = 8;            // portable cluster size
// dynamic shared memory a CTA may take (227 KB less the static arrays)
constexpr int kMaxSliceBytes = 232448 - 1024;

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

// Elements 4i .. 4i+3 of p, widened: one 16-byte load in fp32, one 8-byte
// load in bf16 (p + 4i must be aligned to that).
__device__ __forceinline__ float4 load4(const float* p, int i) {
  return reinterpret_cast<const float4*>(p)[i];
}
__device__ __forceinline__ float4 load4(const bf16* p, int i) {
  const uint2 u = reinterpret_cast<const uint2*>(p)[i];
  const bf16* h = reinterpret_cast<const bf16*>(&u);
  return make_float4(__bfloat162float(h[0]), __bfloat162float(h[1]),
                     __bfloat162float(h[2]), __bfloat162float(h[3]));
}

// Store v as elements 4i .. 4i+3 of p, each rounded once to p's type.
__device__ __forceinline__ void store4(float* p, int i, float4 v) {
  reinterpret_cast<float4*>(p)[i] = v;
}
__device__ __forceinline__ void store4(bf16* p, int i, float4 v) {
  uint2 u;
  bf16* h = reinterpret_cast<bf16*>(&u);
  h[0] = __float2bfloat16_rn(v.x);
  h[1] = __float2bfloat16_rn(v.y);
  h[2] = __float2bfloat16_rn(v.z);
  h[3] = __float2bfloat16_rn(v.w);
  reinterpret_cast<uint2*>(p)[i] = u;
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

__device__ __forceinline__ float4 norm4(float4 v, float k, float mean,
                                        float inv, bool relu) {
  return make_float4(norm1(v.x, k, mean, inv, relu),
                     norm1(v.y, k, mean, inv, relu),
                     norm1(v.z, k, mean, inv, relu),
                     norm1(v.w, k, mean, inv, relu));
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
// [r * slice, min((r + 1) * slice, hw)) of it in dynamic shared memory, in
// its storage type T. kBulk: TMA bulk copies and 4-element stores (hw a
// multiple of 16 bytes, 16-byte-aligned tensors); else scalar loads and
// stores. kCluster is false for a plane that one CTA holds: it then needs no
// cluster barrier.
template <typename T, bool kBulk, bool kCluster>
__global__ void __launch_bounds__(512)
instance_norm_smem_kernel(const T* __restrict__ x, T* __restrict__ y,
                          float* __restrict__ stats, int hw, int slice,
                          float eps, int relu) {
  constexpr int kChunk = kChunkBytes / static_cast<int>(sizeof(T));
  extern __shared__ __align__(128) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);
  __shared__ __align__(8) uint64_t bars[kMaxChunks];
  __shared__ float part[3];                   // this CTA's s0, s1, s2

  cg::cluster_group cluster = cg::this_cluster();
  const int k = kCluster ? static_cast<int>(cluster.num_blocks()) : 1;
  const int rank = kCluster ? static_cast<int>(cluster.block_rank()) : 0;
  const size_t plane = blockIdx.x / k;
  const int begin = rank * slice;
  const int count = max(0, min(slice, hw - begin));
  const size_t offset = plane * static_cast<size_t>(hw) + begin;
  const T* xp = x + offset;
  T* yp = y + offset;
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
        const uint32_t bytes = static_cast<uint32_t>(sizeof(T)) *
                               static_cast<uint32_t>(min(kChunk, count - c0));
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
      for (int i = c0 / 4 + tid; i < c1 / 4; i += blockDim.x) {
        const float4 v = load4(buf, i);
        s0 += (v.x + v.y) + (v.z + v.w);
      }
    } else {
      for (int i = c0 + tid; i < c1; i += blockDim.x) s0 += widen(buf[i]);
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
    for (int i = tid; i < count / 4; i += blockDim.x) {
      const float4 v = load4(buf, i);
      const float a = v.x - kmean, b = v.y - kmean, c = v.z - kmean,
                  d = v.w - kmean;
      s1 += (a + b) + (c + d);
      s2 += (a * a + b * b) + (c * c + d * d);
    }
  } else {
    for (int i = tid; i < count; i += blockDim.x) {
      const float d = widen(buf[i]) - kmean;
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
  if (stats != nullptr && rank == 0 && tid == 0) {
    stats[3 * plane] = kmean;
    stats[3 * plane + 1] = mean;
    stats[3 * plane + 2] = inv;
  }

  // 3. normalize from shared memory, coalesced 4-element stores to y (a
  // bulk store of each normalized chunk was 2-19% slower at every shape)
  if (kBulk) {
    for (int i = tid; i < count / 4; i += blockDim.x) {
      store4(yp, i, norm4(load4(buf, i), kmean, mean, inv, r));
    }
  } else {
    for (int i = tid; i < count; i += blockDim.x) {
      yp[i] = narrow<T>(norm1(widen(buf[i]), kmean, mean, inv, r));
    }
  }
  if (kCluster) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Streaming branch, for planes over 8 CTAs' shared memory: one block per
// plane, three sweeps over device memory, 4-element loads where aligned.
template <typename T, bool kVec>
__global__ void instance_norm_stream_kernel(const T* __restrict__ x,
                                            T* __restrict__ y,
                                            float* __restrict__ stats, int hw,
                                            float eps, int relu) {
  const size_t offset = static_cast<size_t>(blockIdx.x) * hw;
  const T* xp = x + offset;
  T* yp = y + offset;
  const int n4 = hw >> 2;
  const float cnt = static_cast<float>(hw);

  float s0 = 0.f;
  if (kVec) {
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      const float4 v = load4(xp, i);
      s0 += (v.x + v.y) + (v.z + v.w);
    }
  } else {
    for (int i = threadIdx.x; i < hw; i += blockDim.x) {
      s0 += widen(xp[i]);
    }
  }
  const float k = block_sum(s0) / cnt;

  float s1 = 0.f;
  float s2 = 0.f;
  if (kVec) {
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      const float4 v = load4(xp, i);
      const float a = v.x - k, b = v.y - k, c = v.z - k, d = v.w - k;
      s1 += (a + b) + (c + d);
      s2 += (a * a + b * b) + (c * c + d * d);
    }
  } else {
    for (int i = threadIdx.x; i < hw; i += blockDim.x) {
      const float d = widen(xp[i]) - k;
      s1 += d;
      s2 += d * d;
    }
  }
  block_sum2(s1, s2);
  const float mean = s1 / cnt;
  const float var = fmaxf(s2 / cnt - mean * mean, 0.f);
  const float inv = rsqrtf(var + eps);
  const bool r = relu != 0;
  if (stats != nullptr && threadIdx.x == 0) {
    stats[3 * blockIdx.x] = k;
    stats[3 * blockIdx.x + 1] = mean;
    stats[3 * blockIdx.x + 2] = inv;
  }

  if (kVec) {
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      store4(yp, i, norm4(load4(xp, i), k, mean, inv, r));
    }
  } else {
    for (int i = threadIdx.x; i < hw; i += blockDim.x) {
      yp[i] = narrow<T>(norm1(widen(xp[i]), k, mean, inv, r));
    }
  }
}

template <typename T, bool kBulk, bool kCluster>
cudaError_t launch_smem(const T* x, T* y, float* stats, int planes, int hw,
                        int cluster, int slice, float eps, int relu,
                        cudaStream_t stream) {
  // raise the kernel's dynamic shared memory limit once per size and
  // card: the attribute belongs to the current card, and one process may
  // launch on several (a renderer with a replica on each card)
  constexpr int kCards = 64;
  static int limit[kCards] = {};
  int card = 0;
  const cudaError_t got = cudaGetDevice(&card);
  if (got != cudaSuccess) return got;
  const int bytes = static_cast<int>(sizeof(T)) * slice;
  if (card >= kCards || bytes > std::max(limit[card], 48 * 1024)) {
    const cudaError_t e = cudaFuncSetAttribute(
        instance_norm_smem_kernel<T, kBulk, kCluster>,
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
                            instance_norm_smem_kernel<T, kBulk, kCluster>, x,
                            y, stats, hw, slice, eps, relu);
}

template <typename T, bool kBulk>
cudaError_t launch_smem(const T* x, T* y, float* stats, int planes, int hw,
                        int cluster, int slice, float eps, int relu,
                        cudaStream_t stream) {
  return cluster > 1
             ? launch_smem<T, kBulk, true>(x, y, stats, planes, hw, cluster,
                                           slice, eps, relu, stream)
             : launch_smem<T, kBulk, false>(x, y, stats, planes, hw, cluster,
                                            slice, eps, relu, stream);
}

template <typename T>
int run(const T* x, T* y, float* stats, int planes, int hw, float eps,
        int relu, int cluster, cudaStream_t stream) {
  // elements in 16 bytes: a bulk copy's alignment and size granule
  constexpr int kAlign = 16 / static_cast<int>(sizeof(T));
  const uintptr_t x_addr = reinterpret_cast<uintptr_t>(x);
  const uintptr_t y_addr = reinterpret_cast<uintptr_t>(y);
  if (cluster == 0) {
    const int threads = 512;
    const bool vec = (hw % 4 == 0) && (x_addr % (4 * sizeof(T)) == 0) &&
                     (y_addr % (4 * sizeof(T)) == 0);
    if (vec) {
      instance_norm_stream_kernel<T, true><<<planes, threads, 0, stream>>>(
          x, y, stats, hw, eps, relu);
    } else {
      instance_norm_stream_kernel<T, false><<<planes, threads, 0, stream>>>(
          x, y, stats, hw, eps, relu);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (cluster < 1 || cluster > kMaxClusterSize ||
      (cluster & (cluster - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // each slice a multiple of 16 bytes, so that every slice is 16-byte
  // aligned (ops/instnorm.py:slice_elems)
  const int slice = ((hw + cluster - 1) / cluster + kAlign - 1) / kAlign *
                    kAlign;
  if (static_cast<int>(sizeof(T)) * slice > kMaxSliceBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool bulk = (hw % kAlign == 0) && (x_addr % 16 == 0) &&
                    (y_addr % 16 == 0);
  const cudaError_t err =
      bulk ? launch_smem<T, true>(x, y, stats, planes, hw, cluster, slice,
                                  eps, relu, stream)
           : launch_smem<T, false>(x, y, stats, planes, hw, cluster, slice,
                                   eps, relu, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cluster: CTAs per plane, 1, 2, 4 or 8, whose slices must fit a CTA's
// shared memory, or 0 for the streaming branch. The wrapper picks it
// (ops/instnorm.py:cluster_size); anything else returns
// cudaErrorInvalidValue and launches nothing. stats: null, or (planes, 3)
// fp32 that receives each plane's k, m and rstd.
extern "C" int ap_instance_norm(const float* x, float* y, float* stats,
                                int planes, int hw, float eps, int relu,
                                int cluster, cudaStream_t stream) {
  return run<float>(x, y, stats, planes, hw, eps, relu, cluster, stream);
}

// The same on bf16 x and y (statistics and stats fp32).
extern "C" int ap_instance_norm_bf16(const bf16* x, bf16* y, float* stats,
                                     int planes, int hw, float eps, int relu,
                                     int cluster, cudaStream_t stream) {
  return run<bf16>(x, y, stats, planes, hw, eps, relu, cluster, stream);
}
