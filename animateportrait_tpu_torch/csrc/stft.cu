// K1: fused STFT magnitude for Hopper (sm_90a), by an FFT in shared memory.
//
// Replaces the Pallas TPU kernel `_stft_kernel`, launched by
// `stft_magnitude_pallas` in animateportrait_tpu/ops/pallas_stft.py.
//
// Computes |STFT| of a mono signal with the pySTFT conventions of the
// reference front end: reflect pad n_fft/2 (numpy 'reflect', no edge
// repeat), periodic Hann window, n_fft 1024, hop 256. Output is
// (n_frames, 513) row-major with n_frames = n / 256 + 1.
//
// Design. One block takes kFrames consecutive frames, 128 threads each.
// It stages the signal span those frames cover in shared memory, reading
// the UNPADDED signal through reflected indices (float4 loads where the
// span lies inside the signal), so neither a padded copy nor a frame
// matrix reaches device memory. Each frame's 1024 windowed real samples
// are packed as 512 complex ones, z[m] = x[2m] + i x[2m+1], and go through
// a 512-point Stockham FFT in shared memory: four radix-4 stages and one
// radix-2 stage, ping-ponging between two buffers, one butterfly (or two
// in the radix-2 stage) per thread and stage. The real spectrum then
// follows from the even/odd split
//   X[k] = (Z[k] + conj Z[512-k]) / 2 + W^k (Z[k] - conj Z[512-k]) / (2i),
// W = exp(-2 pi i / 1024), for bins 0..512, and |X[k]| is written with
// neighbouring threads on neighbouring bins. Twiddles come from sincospif
// (a 512-entry table of exp(-2 pi i k / 512) per block, and W^k per bin);
// the Hann window from cospif. All arithmetic is fp32: the FFT's rounding
// error grows as log2(1024) against the 1024-term sums of a direct DFT.
//
// What bounds it on this card: neither resource at the slice's sizes. A
// 6 s clip (376 frames) is ~10 MFLOP (0.15 us at 67 TFLOP/s fp32) and
// 1.15 MB of traffic (0.35 us at 3.35 TB/s); the launch and the five
// barrier-separated stages set the time. The direct DFT this replaces did
// ~0.8 GFLOP, about 80 times the FFT's arithmetic, and read a 4 MB basis.
#include <cuda_runtime.h>

namespace {

constexpr int kNfft = 1024;
constexpr int kHop = 256;
constexpr int kBins = kNfft / 2 + 1;          // 513
constexpr int kHalf = kNfft / 2;              // 512-point complex FFT
constexpr int kThreadsPerFrame = 128;         // one radix-4 butterfly each
constexpr int kFrames = 2;                    // frames per block
constexpr int kThreads = kFrames * kThreadsPerFrame;
constexpr int kSpan = (kFrames - 1) * kHop + kNfft;  // 1280 samples

__device__ __forceinline__ int reflect_index(int i, int n) {
  // numpy 'reflect' for -n < i < 2n - 1 (the wrapper checks n > n_fft/2)
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
// -i * a
__device__ __forceinline__ float2 cmul_mi(float2 a) {
  return make_float2(a.y, -a.x);
}

// One radix-4 Stockham stage of a 512-point FFT: sub-transform length n,
// stride s (n * s == 512). Thread t (0..127) takes p = t / s, q = t % s.
__device__ __forceinline__ void radix4_stage(const float2* __restrict__ x,
                                             float2* __restrict__ y,
                                             const float2* __restrict__ tw,
                                             int n, int s, int t) {
  const int p = t / s;
  const int q = t - p * s;
  const int n4 = kHalf / 4;                   // s * n / 4 == 128
  const float2 a = x[t];
  const float2 b = x[t + n4];
  const float2 c = x[t + 2 * n4];
  const float2 d = x[t + 3 * n4];
  const float2 apc = cadd(a, c), amc = csub(a, c);
  const float2 bpd = cadd(b, d), mjbmd = cmul_mi(csub(b, d));
  // W_n^p = W_512^(p * 512 / n) = tw[p * s]
  const int e = p * s;
  float2* out = y + q + s * 4 * p;
  out[0] = cadd(apc, bpd);
  out[s] = cmul(tw[e], cadd(amc, mjbmd));
  out[2 * s] = cmul(tw[2 * e], csub(apc, bpd));
  out[3 * s] = cmul(tw[3 * e], csub(amc, mjbmd));
}

__global__ void __launch_bounds__(kThreads)
stft_fft_kernel(const float* __restrict__ x, int n, float* __restrict__ out,
                int n_frames) {
  __shared__ __align__(16) float span[kSpan];
  __shared__ float2 buf_a[kFrames][kHalf];
  __shared__ float2 buf_b[kFrames][kHalf];
  __shared__ float2 tw[kHalf];                // exp(-2 pi i k / 512)

  const int frame0 = blockIdx.x * kFrames;
  // first sample of the block's span, in unpadded-signal coordinates
  const int start = frame0 * kHop - kNfft / 2;
  const int padded_end = n + kNfft / 2;       // one past the padded signal
  const bool interior = start >= 0 && start + kSpan <= n &&
                        (reinterpret_cast<size_t>(x) & 15) == 0;
  if (interior) {
    // start is a multiple of 256, so x + start is 16-byte aligned too
    const float4* src = reinterpret_cast<const float4*>(x + start);
    float4* dst = reinterpret_cast<float4*>(span);
    for (int i = threadIdx.x; i < kSpan / 4; i += kThreads) dst[i] = src[i];
  } else {
    for (int i = threadIdx.x; i < kSpan; i += kThreads) {
      const int p = start + i;
      // samples past the padded end are read only by frames >= n_frames
      span[i] = (p < padded_end) ? x[reflect_index(p, n)] : 0.f;
    }
  }
  for (int k = threadIdx.x; k < kHalf; k += kThreads) {
    float s, c;
    sincospif(-static_cast<float>(k) / (kHalf / 2), &s, &c);
    tw[k] = make_float2(c, s);
  }
  __syncthreads();

  const int f = threadIdx.x / kThreadsPerFrame;   // frame within the block
  const int t = threadIdx.x % kThreadsPerFrame;
  float2* a = buf_a[f];
  float2* b = buf_b[f];
  const float* fr = span + f * kHop;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = t + j * kThreadsPerFrame;
    // periodic Hann: 0.5 - 0.5 cos(2 pi i / 1024)
    const float w0 = 0.5f - 0.5f * cospif(static_cast<float>(2 * m) / kHalf);
    const float w1 =
        0.5f - 0.5f * cospif(static_cast<float>(2 * m + 1) / kHalf);
    a[m] = make_float2(fr[2 * m] * w0, fr[2 * m + 1] * w1);
  }
  __syncthreads();
  radix4_stage(a, b, tw, 512, 1, t);
  __syncthreads();
  radix4_stage(b, a, tw, 128, 4, t);
  __syncthreads();
  radix4_stage(a, b, tw, 32, 16, t);
  __syncthreads();
  radix4_stage(b, a, tw, 8, 64, t);
  __syncthreads();
  // radix-2 stage: n = 2, s = 256, no twiddle
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = t + j * kThreadsPerFrame;
    const float2 u = a[q], v = a[q + 256];
    b[q] = cadd(u, v);
    b[q + 256] = csub(u, v);
  }
  __syncthreads();

  const int frame = frame0 + f;
  if (frame >= n_frames) return;
  float* row = out + static_cast<size_t>(frame) * kBins;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = t + j * kThreadsPerFrame;   // 0..511
    float re, im;
    if (k == 0) {
      re = b[0].x + b[0].y;
      im = 0.f;
    } else {
      const float2 zk = b[k];
      const float2 zn = make_float2(b[kHalf - k].x, -b[kHalf - k].y);
      const float2 xe = make_float2(0.5f * (zk.x + zn.x), 0.5f * (zk.y + zn.y));
      // (zk - zn) / (2i)
      const float2 xo = make_float2(0.5f * (zk.y - zn.y), -0.5f * (zk.x - zn.x));
      float s, c;
      sincospif(-static_cast<float>(k) / kHalf, &s, &c);
      const float2 v = cmul(make_float2(c, s), xo);
      re = xe.x + v.x;
      im = xe.y + v.y;
    }
    row[k] = sqrtf(re * re + im * im);
  }
  if (t == 0) row[kHalf] = fabsf(b[0].x - b[0].y);
}

}  // namespace

extern "C" int ap_stft_magnitude(const float* x, int n, float* out,
                                 int n_frames, cudaStream_t stream) {
  const int blocks = (n_frames + kFrames - 1) / kFrames;
  stft_fft_kernel<<<blocks, kThreads, 0, stream>>>(x, n, out, n_frames);
  return static_cast<int>(cudaGetLastError());
}
