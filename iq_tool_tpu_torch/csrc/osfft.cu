// K5: overlap-save FFT filter, y = last outputs of ifft(fft(window) * H)
// per 2b-sample window of the tail-extended input ext = state(b) ++ x.
//
// Replaces iq_tool_tpu/ops/pallas_kernels.py:osfft_apply
// (_osfft_kernel).  The TPU kernel runs a four-step DFT as 128-wide
// matmuls in 3-term split bf16 (the MXU is its engine, and Mosaic caps
// nfft to [16384, 32768]); none of that is copied.  Here one CTA owns one
// (channel, window) and runs a radix-2 FFT in float32 in shared memory.
//
// What bounds it on the card: shared-memory traffic and barriers.  Each
// of the 2*log2(nfft) stages reads and writes the whole window once in
// shared memory (nfft = 16384: 28 stages of 128 KiB each way) between two
// __syncthreads; device memory sees the window once in (8 B/sample, with
// the overlap re-read) and the emitted outputs once out.  The window
// takes nfft*8 bytes of dynamic shared memory: 128 KiB at nfft 16384, so
// one CTA per SM; nfft 32768 (256 KiB) does not fit one CTA and is
// refused (the wrapper raises before launching).
//
// Design: no bit-reversal pass.  The forward transform is a decimation-
// in-frequency pass over the natural-order window, which leaves the
// spectrum in bit-reversed order; the host hands H/nfft in that same
// bit-reversed order (an exact scaling: nfft is a power of two), so the
// pointwise product needs no permutation; the inverse is a decimation-in-
// time pass with conjugate twiddles, which takes bit-reversed input and
// writes natural order.  Twiddles exp(-2 pi i m / nfft), m < nfft/2, are
// computed on the host in float64 and read through the read-only cache.
//
// Windows come as a table: window w starts at ext[starts[w]] and emits
// its outputs j in [heads[w], nfft) to y[starts[w] + j - b].  The table
// holds the whole step's schedule: the 3/4-advance windows (heads b/2),
// the half-advance windows (heads b) and the re-anchored ragged last
// window, so one launch covers a block (ops/filters.py osfft_windows).

#include <cuda_runtime.h>

namespace iqk {

constexpr int kFftThreads = 1024;

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {  // a * conj(b)
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

struct OsfftArgs {
  const float* ext_r;  // (C, total)
  const float* ext_i;
  long long total;
  const int* starts;  // (n_win,)
  const int* heads;   // (n_win,)
  const float2* h_br;  // (nfft,) H / nfft in bit-reversed order
  const float2* tw;    // (nfft/2,) exp(-2 pi i m / nfft)
  int log2n;
  int block;
  float* out_r;  // (C, n_out)
  float* out_i;
  long long n_out;
};

__global__ void __launch_bounds__(kFftThreads) osfft_kernel(const OsfftArgs a) {
  extern __shared__ float2 buf[];
  const int nfft = 1 << a.log2n;
  const int half_n = nfft >> 1;
  const int c = blockIdx.y;
  const int w = blockIdx.x;
  const int t = threadIdx.x;
  const int step = blockDim.x;
  const long long start = a.starts[w];
  const float* xr = a.ext_r + static_cast<long long>(c) * a.total + start;
  const float* xi = a.ext_i + static_cast<long long>(c) * a.total + start;
  for (int i = t; i < nfft; i += step) buf[i] = make_float2(xr[i], xi[i]);
  __syncthreads();

  // forward, decimation in frequency: natural in, bit-reversed out
  for (int lh = a.log2n - 1; lh >= 0; --lh) {
    const int half = 1 << lh;
    const int tw_shift = a.log2n - 1 - lh;  // twiddle stride nfft / (2 half)
    for (int k = t; k < half_n; k += step) {
      const int j = k & (half - 1);
      const int i0 = ((k >> lh) << (lh + 1)) + j;
      const float2 u = buf[i0];
      const float2 v = buf[i0 + half];
      buf[i0] = cadd(u, v);
      buf[i0 + half] = cmul(csub(u, v), __ldg(&a.tw[j << tw_shift]));
    }
    __syncthreads();
  }
  for (int i = t; i < nfft; i += step) buf[i] = cmul(buf[i], __ldg(&a.h_br[i]));
  __syncthreads();
  // inverse, decimation in time with conjugate twiddles: bit-reversed in,
  // natural out (the 1/nfft is already in h_br)
  for (int lh = 0; lh < a.log2n; ++lh) {
    const int half = 1 << lh;
    const int tw_shift = a.log2n - 1 - lh;
    for (int k = t; k < half_n; k += step) {
      const int j = k & (half - 1);
      const int i0 = ((k >> lh) << (lh + 1)) + j;
      const float2 u = buf[i0];
      const float2 v = cmul_conj(buf[i0 + half], __ldg(&a.tw[j << tw_shift]));
      buf[i0] = cadd(u, v);
      buf[i0 + half] = csub(u, v);
    }
    __syncthreads();
  }
  const long long o0 = start - a.block;  // output index of window sample 0
  float* yr = a.out_r + static_cast<long long>(c) * a.n_out;
  float* yi = a.out_i + static_cast<long long>(c) * a.n_out;
  for (int j = a.heads[w] + t; j < nfft; j += step) {
    const float2 v = buf[j];
    yr[o0 + j] = v.x;
    yi[o0 + j] = v.y;
  }
}

}  // namespace iqk

// Launch on `stream`; returns the launch's cudaError_t (0 on success).
extern "C" int iq_osfft_apply(const float* ext_r, const float* ext_i,
                              int channels, long long total, const int* starts,
                              const int* heads, int n_win, const void* h_br,
                              const void* tw, int log2n, int block,
                              float* out_r, float* out_i, long long n_out,
                              void* stream) {
  if (channels <= 0 || n_win <= 0 || log2n < 1 || log2n > 30 || block < 0) {
    return cudaErrorInvalidValue;
  }
  const int nfft = 1 << log2n;
  const size_t smem = sizeof(float2) * static_cast<size_t>(nfft);
  int dev = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (smem > static_cast<size_t>(smem_max)) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      iqk::osfft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int threads = nfft / 2 < iqk::kFftThreads ? nfft / 2 : iqk::kFftThreads;
  iqk::OsfftArgs a{ext_r, ext_i, total, starts, heads,
                   static_cast<const float2*>(h_br),
                   static_cast<const float2*>(tw), log2n, block,
                   out_r, out_i, n_out};
  const dim3 grid(n_win, channels);
  iqk::osfft_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
