// K1: fused STFT magnitude for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_stft_kernel`, launched by
// `stft_magnitude_pallas` in animateportrait_tpu/ops/pallas_stft.py.
//
// Computes |STFT| of a mono signal with the pySTFT conventions of the
// reference front end: reflect pad n_fft/2 (numpy 'reflect', no edge
// repeat), periodic Hann window, n_fft 1024, hop 256. Output is
// (n_frames, 513) row-major with n_frames = n / 256 + 1.
//
// Design. A 2-D grid over (frame tiles x bin tiles). Each block stages the
// signal span its frames cover in shared memory, reading the UNPADDED
// signal through reflected indices, so neither a padded copy nor the
// (n_frames, 1024) frame matrix ever reaches device memory. Each thread
// owns one frequency bin and accumulates re/im for the block's frames over
// the 1024 taps in fp32 FMA (no TF32: 1024-term sums have to stay inside
// a 2e-3 absolute tolerance). The window-folded cos/sin basis
// (1024 x 513 fp32 each, ~4 MB) is built once per device by the wrapper and
// stays L2-resident; neighbouring threads read neighbouring bins, so its
// loads coalesce, and every thread of a block reads the same signal sample
// at each step (a shared-memory broadcast).
//
// What bounds it on this card: at the slice's size (6 s, 376 frames) the
// whole transform is ~0.8 GFLOP over ~120 blocks, far under the card's
// fp32 rate and its memory bandwidth: the kernel is latency-bound (one
// wave, serial 1024-step FMA chains). More frames per block or a tensor-core
// formulation would only pay at much longer clips.
#include <cuda_runtime.h>

namespace {

constexpr int kNfft = 1024;
constexpr int kHop = 256;
constexpr int kBins = kNfft / 2 + 1;          // 513
constexpr int kFramesPerBlock = 8;
constexpr int kBinsPerBlock = 128;            // one thread per bin
constexpr int kSpan = (kFramesPerBlock - 1) * kHop + kNfft;  // 2816 samples

__device__ __forceinline__ int reflect_index(int i, int n) {
  // numpy 'reflect' for -n < i < 2n - 1 (the wrapper checks n > n_fft/2)
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

__global__ void __launch_bounds__(kBinsPerBlock)
stft_magnitude_kernel(const float* __restrict__ x, int n,
                      const float* __restrict__ cos_basis,
                      const float* __restrict__ sin_basis,
                      float* __restrict__ out, int n_frames) {
  __shared__ float span[kSpan];
  const int frame0 = blockIdx.x * kFramesPerBlock;
  // first sample of the block's span, in unpadded-signal coordinates
  const int start = frame0 * kHop - kNfft / 2;
  const int padded_end = n + kNfft / 2;  // one past the padded signal
  for (int i = threadIdx.x; i < kSpan; i += blockDim.x) {
    const int p = start + i;
    // samples past the padded end are read only by frames >= n_frames
    span[i] = (p < padded_end) ? x[reflect_index(p, n)] : 0.f;
  }
  __syncthreads();

  const int bin = blockIdx.y * kBinsPerBlock + threadIdx.x;
  if (bin >= kBins) return;

  float re[kFramesPerBlock];
  float im[kFramesPerBlock];
#pragma unroll
  for (int f = 0; f < kFramesPerBlock; ++f) {
    re[f] = 0.f;
    im[f] = 0.f;
  }
  for (int t = 0; t < kNfft; ++t) {
    const float c = cos_basis[t * kBins + bin];
    const float s = sin_basis[t * kBins + bin];
#pragma unroll
    for (int f = 0; f < kFramesPerBlock; ++f) {
      const float v = span[f * kHop + t];
      re[f] = fmaf(v, c, re[f]);
      im[f] = fmaf(v, s, im[f]);
    }
  }
#pragma unroll
  for (int f = 0; f < kFramesPerBlock; ++f) {
    const int frame = frame0 + f;
    if (frame < n_frames) {
      out[static_cast<size_t>(frame) * kBins + bin] =
          sqrtf(re[f] * re[f] + im[f] * im[f]);
    }
  }
}

}  // namespace

extern "C" int ap_stft_magnitude(const float* x, int n,
                                 const float* cos_basis,
                                 const float* sin_basis, float* out,
                                 int n_frames, cudaStream_t stream) {
  const dim3 grid((n_frames + kFramesPerBlock - 1) / kFramesPerBlock,
                  (kBins + kBinsPerBlock - 1) / kBinsPerBlock);
  stft_magnitude_kernel<<<grid, kBinsPerBlock, 0, stream>>>(
      x, n, cos_basis, sin_basis, out, n_frames);
  return static_cast<int>(cudaGetLastError());
}
