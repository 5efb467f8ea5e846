// The I/Q estimator's greedy descent: a helper kernel, not a TPU kernel.
//
// Replaces the descent of iq_tool_tpu/ops/iq_balance.py (_optimize_core
// and the power gate of maybe_update), which the JAX package runs in XLA
// as one fused program.  In PyTorch's eager mode the same descent is ~28
// small tensor ops per pass, 25 passes per block: ~700 launches whose
// host time (~15 ms per step at 128 channels, measured on the H100) was
// 3/4 of config #4's step.  Here it is one launch.
//
// For each channel, from the shifted spectra base = FFT(w x) and
// image = FFT(w Re x) of the block's first nfft samples, the spectrum of
// the corrected signal for factors (g, phi) is base + (g + i phi) image,
// in dB 20 log10(|.| / nfft + 1e-12).  The utility is the sum over the
// band [lo, hi) of (P(+f) - P(-f))^2 where either side is above the
// floor; each pass tries the 4 diagonal moves and keeps the best if it
// beats the current utility (first maximum on a tie, as torch.argmax).
// The kernel also returns the power gate, the band's peak-to-average in
// dB at the starting factors.
//
// What bounds it: nothing much; 25 x 4 x 2 x 461 spectrum points per
// channel.  Design: one CTA per channel; the spectra stay in registers,
// each thread owning a few band bins on both sides; each pass reduces
// the 4 candidates' sums across the CTA with warp shuffles, and every
// thread, holding the same sums, takes the same move.  Sums run in
// another order than torch's reductions, so the kernel and its plain twin
// (ops/kernels.py iq_descent_ref) may part on a near-tie of two
// candidates: they are held to a few moves.

#include <cuda_runtime.h>

namespace iqk {

constexpr int kEstThreads = 256;
constexpr int kEstWarps = kEstThreads / 32;
constexpr int kEstPer = 2;  // band bins per thread (band <= 512 bins)

struct EstArgs {
  const float2* base;   // (C, nfft) shifted spectra
  const float2* image;  // (C, nfft)
  const float* factors;  // (C, 2) starting [g, phi]
  const float* moves;    // (4, 2) the diagonal moves, +-step
  int nfft;
  int lo;
  int hi;
  int passes;
  float floor_db;
  float* out;      // (C, 2) factors after the descent (unsmoothed)
  float* gate_db;  // (C,) peak-to-average over the band at the start
};

__device__ __forceinline__ float spec_db(float2 b, float2 m, float g, float phi,
                                         float n) {
  const float re = b.x + (g * m.x - phi * m.y);
  const float im = b.y + (g * m.y + phi * m.x);
  return 20.0f * log10f(hypotf(re, im) / n + 1e-12f);
}

// Sum of `v` over the CTA, returned to every thread; `red` holds
// kEstWarps floats per value and `v` has kVals values.
template <int kVals>
__device__ __forceinline__ void cta_sum(float (&v)[kVals], float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kVals; ++k) {
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
    if (lane == 0) red[k * kEstWarps + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kVals; ++k) {
    float s = 0.0f;
    for (int w = 0; w < kEstWarps; ++w) s += red[k * kEstWarps + w];
    v[k] = s;
  }
  __syncthreads();  // red is reused by the next call
}

__global__ void __launch_bounds__(kEstThreads) iq_descent_kernel(const EstArgs a) {
  __shared__ float red[4 * kEstWarps];
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int nb = a.hi - a.lo;
  const float n = static_cast<float>(a.nfft);
  const float2* base = a.base + static_cast<long long>(c) * a.nfft;
  const float2* image = a.image + static_cast<long long>(c) * a.nfft;
  // this thread's bins: p_neg at lo + i, p_pos at nfft - lo - 1 - i
  float2 bn[kEstPer], mn[kEstPer], bp[kEstPer], mp[kEstPer];
  bool own[kEstPer];
#pragma unroll
  for (int j = 0; j < kEstPer; ++j) {
    const int i = t + j * kEstThreads;
    own[j] = i < nb;
    const int ineg = own[j] ? a.lo + i : 0;
    const int ipos = own[j] ? a.nfft - a.lo - 1 - i : 0;
    bn[j] = base[ineg];
    mn[j] = image[ineg];
    bp[j] = base[ipos];
    mp[j] = image[ipos];
  }
  float g = a.factors[c * 2];
  float phi = a.factors[c * 2 + 1];

  // the utility, the band's sums and its peak at the starting factors
  float s[3] = {0.0f, 0.0f, 0.0f};  // utility, sum of P(+f), sum of P(-f)
  float mx = -3.0e38f;
#pragma unroll
  for (int j = 0; j < kEstPer; ++j) {
    if (!own[j]) continue;
    const float pn = spec_db(bn[j], mn[j], g, phi, n);
    const float pp = spec_db(bp[j], mp[j], g, phi, n);
    const float d = pp - pn;
    if (pp > a.floor_db || pn > a.floor_db) s[0] += d * d;
    s[1] += pp;
    s[2] += pn;
    mx = fmaxf(mx, fmaxf(pp, pn));
  }
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((t & 31) == 0) red[3 * kEstWarps + (t >> 5)] = mx;
  cta_sum<3>(s, red);  // its first barrier also publishes the warp peaks
  if (t == 0) {
    for (int w = 0; w < kEstWarps; ++w) mx = fmaxf(mx, red[3 * kEstWarps + w]);
    a.gate_db[c] = mx - (s[1] + s[2]) / (2.0f * static_cast<float>(nb));
  }
  __syncthreads();  // the peaks are read before the passes reuse red
  float cur_u = s[0];

  // every thread reduces the same sums in the same order, so all of
  // them take the same move: no broadcast is needed
  for (int p = 0; p < a.passes; ++p) {
    float u[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float cg[4], cp[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      cg[k] = g + a.moves[k * 2];
      cp[k] = phi + a.moves[k * 2 + 1];
    }
#pragma unroll
    for (int j = 0; j < kEstPer; ++j) {
      if (!own[j]) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float pn = spec_db(bn[j], mn[j], cg[k], cp[k], n);
        const float pp = spec_db(bp[j], mp[j], cg[k], cp[k], n);
        const float d = pp - pn;
        if (pp > a.floor_db || pn > a.floor_db) u[k] += d * d;
      }
    }
    cta_sum<4>(u, red);
    int best = 0;
    for (int k = 1; k < 4; ++k) {
      if (u[k] > u[best]) best = k;
    }
    if (u[best] > cur_u) {
      g = cg[best];
      phi = cp[best];
      cur_u = u[best];
    }
  }
  if (t == 0) {
    a.out[c * 2] = g;
    a.out[c * 2 + 1] = phi;
  }
}

}  // namespace iqk

// Launch on `stream`; returns the launch's cudaError_t (0 on success).
extern "C" int iq_est_descent(const void* base, const void* image,
                              const float* factors, const float* moves,
                              int channels, int nfft, int lo, int hi,
                              int passes, float floor_db, float* out,
                              float* gate_db, void* stream) {
  if (channels <= 0 || nfft <= 0 || lo < 0 || hi <= lo || 2 * hi > nfft ||
      hi - lo > iqk::kEstThreads * iqk::kEstPer || passes < 0) {
    return cudaErrorInvalidValue;
  }
  iqk::EstArgs a{static_cast<const float2*>(base), static_cast<const float2*>(image),
                 factors, moves, nfft, lo, hi, passes, floor_db, out, gate_db};
  iqk::iq_descent_kernel<<<channels, iqk::kEstThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
