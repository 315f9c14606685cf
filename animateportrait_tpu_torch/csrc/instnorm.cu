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
// plane shifted by its mean k from a first sweep. Unshifted, the form loses
// digits to cancellation in proportion to mean^2 / var; the landmark
// encoder's mostly flat planes (mean/std ~12) lost enough that two summation
// orders disagreed by ~1e-4. Shifted, m is nearly 0 and nothing cancels. The
// TPU kernel, too, takes the mean before the variance. The plain version in
// ops/instnorm.py computes the same steps.
//
// Design. One block per plane; a plane is contiguous in NCHW. Three sweeps,
// each with float4 loads: the first sums x for k; the second sums d and d^2;
// the third normalizes, applies the ReLU and writes. Sums are fp32, reduced
// within each warp by shuffles and across warps through shared memory. A
// plane whose length is not a multiple of 4, or whose pointers are not
// 16-byte aligned, takes the scalar loops.
//
// What bounds it on this card: memory. Each element is read three times and
// written once and costs a handful of flops. The second and third reads hit
// the 50 MB L2 when the planes in flight fit there, so the device-memory
// traffic is then close to one read and one write. With planes of 256x256
// and more (the landmark encoder, up1, the once-per-photo nets) the blocks
// in flight hold more than L2, so the re-reads likely come from HBM; that
// was not measured. A tensor with few planes,
// e.g. (1, 64, 512, 512), launches only 64 blocks for 132 SMs; a split
// reduction across blocks would fix both and is left for later.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

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

template <bool kVec>
__global__ void instance_norm_kernel(const float* __restrict__ x,
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

}  // namespace

extern "C" int ap_instance_norm(const float* x, float* y, int planes,
                                int hw, float eps, int relu,
                                cudaStream_t stream) {
  const bool vec = (hw % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  const int threads = hw >= 65536 ? 512 : 256;
  if (vec) {
    instance_norm_kernel<true><<<planes, threads, 0, stream>>>(
        x, y, hw, eps, relu);
  } else {
    instance_norm_kernel<false><<<planes, threads, 0, stream>>>(
        x, y, hw, eps, relu);
  }
  return static_cast<int>(cudaGetLastError());
}
