// K1 prologue: packed-wire decode -> DC block -> NCO mix over whole
// channels, writing the processed planes, their last `hist` samples (the
// resampler stage's next carried history) and the new DC state.  The
// port's K1 is this launch followed by the K2 banded kernel over the
// processed planes (ops/kernels.py banded_apply_dc).
//
// Replaces iq_tool_tpu/ops/pallas_kernels.py:banded_apply_dc
// (_banded_dc_kernel with _wire_decode, _dc_plane_tile and
// _nco_mix_base).  The TPU kernel carries the DC state and the previous
// tile's processed window context in scratch memory from one time tile
// to the next, which relies on the TPU walking tiles in order; CUDA gives
// no order between CTAs.
//
// What bounds it on the card: bytes.  Per sample it reads one packed wire
// element (4 B for 16-bit wires) and writes two float32 planes (8 B); the
// banded product that follows re-reads the planes (8 B).  That is about
// 16 B per sample more than a fully fused kernel would move, the price of
// the two-launch design.
//
// Design: one CTA per channel walks the channel in chunks of kDcChunk
// samples, in order, so the recurrence's carry never crosses CTAs.  Inside
// a chunk the recurrence y[n] = a*y[n-1] + x[n] - x[n-1] runs as a
// two-level scan: each thread runs kDcPer samples from zero, a block scan
// carries the per-thread ends across threads (the combine of
// ops/dc_block.py with a constant coefficient), and each sample adds
// a^(j+1) times the value carried into its thread.  This arithmetic runs
// in float64 (the decoded samples and the outputs stay float32): the pole
// keeps every rounding error for ~32.6k samples, and in float32 two
// equally valid summation orders already differ at ~100 dB on a
// full-scale noise wire.  In float64 it costs nothing that shows, since
// the prologue is bound by bytes and by its chunk loop, not arithmetic.
// Wire loads and plane stores go through shared memory so both are
// coalesced.

#include <cuda_runtime.h>

#include "wire.cuh"

namespace iqk {

constexpr int kDcThreads = 512;
constexpr int kDcPer = 8;
constexpr int kDcChunk = kDcThreads * kDcPer;
constexpr int kDcPad = kDcPer + 1;  // staged row stride: no bank conflicts
constexpr int kDcLevels = 9;        // log2(kDcThreads) doubling steps
static_assert(kDcThreads == 1 << kDcLevels, "one scan level per doubling");

__global__ void __launch_bounds__(kDcThreads)
    dc_prologue_kernel(const void* wire, int kind, float norm, float gain,
                       const float* dc_in, double a, const long long* phase,
                       unsigned dtheta, int n, int hist, float* y_r,
                       float* y_i, float* tail_r, float* tail_i,
                       float* dc_out) {
  __shared__ float stage_r[kDcThreads * kDcPad];
  __shared__ float stage_i[kDcThreads * kDcPad];
  __shared__ double scan_r[kDcThreads];
  __shared__ double scan_i[kDcThreads];
  __shared__ double level_coef[kDcLevels];  // a^(kDcPer * 2^k)
  __shared__ double carry[4];  // x_prev r/i, y_prev r/i

  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int elem = kind == kCs16 || kind == kCu16 ? 4 : 2;
  const char* row =
      static_cast<const char*>(wire) + static_cast<long long>(c) * n * elem;
  const unsigned ph0 = dtheta ? static_cast<unsigned>(phase[c]) : 0u;
  double apow[kDcPer];  // a^(j+1)
#pragma unroll
  for (int j = 0; j < kDcPer; ++j) apow[j] = pow(a, j + 1);
  const double carry_coef = pow(a, static_cast<double>(kDcPer) * t);
  if (t < kDcLevels) level_coef[t] = pow(a, static_cast<double>(kDcPer) * (1 << t));
  if (t < 4) carry[t] = dc_in[c * 4 + t];

  // wire elements of the next chunk, loaded one chunk ahead so that their
  // latency hides behind the current chunk's scan (r = t + j * kDcThreads)
  int next[kDcPer];
#pragma unroll
  for (int j = 0; j < kDcPer; ++j) {
    const int r = t + j * kDcThreads;
    next[j] = r < n ? wire_load(row, kind, r) : 0;
  }
  for (long long base = 0; base < n; base += kDcChunk) {
#pragma unroll
    for (int j = 0; j < kDcPer; ++j) {
      const int r = t + j * kDcThreads;
      float vr = 0.0f, vi = 0.0f;
      if (base + r < n) wire_decode_value(next[j], kind, norm, gain, &vr, &vi);
      stage_r[(r / kDcPer) * kDcPad + r % kDcPer] = vr;
      stage_i[(r / kDcPer) * kDcPad + r % kDcPer] = vi;
      const long long ahead = base + kDcChunk + r;
      next[j] = ahead < n ? wire_load(row, kind, ahead) : 0;
    }
    __syncthreads();
    const long long my0 = base + static_cast<long long>(t) * kDcPer;
    const long long left = n - my0;
    const int m = left <= 0 ? 0 : (left >= kDcPer ? kDcPer : static_cast<int>(left));
    float xr[kDcPer], xi[kDcPer];
#pragma unroll
    for (int j = 0; j < kDcPer; ++j) {
      xr[j] = stage_r[t * kDcPad + j];
      xi[j] = stage_i[t * kDcPad + j];
    }
    // local recurrence from zero over this thread's m samples; x[n-1] of
    // its first sample is the previous thread's last, still staged
    double pr = t ? stage_r[t * kDcPad - kDcPad + kDcPer - 1] : carry[0];
    double pi = t ? stage_i[t * kDcPad - kDcPad + kDcPer - 1] : carry[1];
    double lr[kDcPer], li[kDcPer];
    double accr = 0.0, acci = 0.0;
#pragma unroll
    for (int j = 0; j < kDcPer; ++j) {
      if (j < m) {
        accr = fma(a, accr, xr[j] - pr);
        acci = fma(a, acci, xi[j] - pi);
      }
      pr = xr[j];
      pi = xi[j];
      lr[j] = accr;
      li[j] = acci;
    }
    __syncthreads();  // the staged x rows are read before results overwrite them
    // block scan of the per-thread ends: B[t] = sum_u a^(kDcPer*(t-u)) e_u.
    // Every thread before the last valid one holds kDcPer samples, so the
    // coefficient is one constant and each doubling step takes its power.
    scan_r[t] = accr;
    scan_i[t] = acci;
    __syncthreads();
    int level = 0;
    for (int off = 1; off < kDcThreads; off <<= 1, ++level) {
      double pbr = 0.0, pbi = 0.0;
      if (t >= off) {
        pbr = scan_r[t - off];
        pbi = scan_i[t - off];
      }
      __syncthreads();
      if (t >= off) {
        scan_r[t] = fma(level_coef[level], pbr, scan_r[t]);
        scan_i[t] = fma(level_coef[level], pbi, scan_i[t]);
      }
      __syncthreads();
    }
    // y value entering this thread's first sample
    const double yin_r = t ? fma(carry_coef, carry[2], scan_r[t - 1]) : carry[2];
    const double yin_i = t ? fma(carry_coef, carry[3], scan_i[t - 1]) : carry[3];
    const long long last = (n - base < kDcChunk ? n - base : kDcChunk) - 1;
    const int own_t = static_cast<int>(last / kDcPer);
    const int own_j = static_cast<int>(last % kDcPer);
    double nx_r = 0.0, nx_i = 0.0, ny_r = 0.0, ny_i = 0.0;
#pragma unroll
    for (int j = 0; j < kDcPer; ++j) {
      const double dr = fma(apow[j], yin_r, lr[j]);
      const double di = fma(apow[j], yin_i, li[j]);
      if (t == own_t && j == own_j) {
        nx_r = xr[j];
        nx_i = xi[j];
        ny_r = dr;
        ny_i = di;
      }
      float vr = static_cast<float>(dr);
      float vi = static_cast<float>(di);
      if (dtheta) nco_rotate(ph0, dtheta, my0 + j, &vr, &vi);
      stage_r[t * kDcPad + j] = vr;
      stage_i[t * kDcPad + j] = vi;
    }
    __syncthreads();  // every thread has read carry and written its samples
    if (t == own_t) {
      carry[0] = nx_r;
      carry[1] = nx_i;
      carry[2] = ny_r;
      carry[3] = ny_i;
    }
    const long long out_row = static_cast<long long>(c) * n;
    const long long tail0 = n - hist;
    for (int r = t; r < kDcChunk; r += kDcThreads) {
      const long long idx = base + r;
      if (idx >= n) break;
      const float vr = stage_r[(r / kDcPer) * kDcPad + r % kDcPer];
      const float vi = stage_i[(r / kDcPer) * kDcPad + r % kDcPer];
      y_r[out_row + idx] = vr;
      y_i[out_row + idx] = vi;
      if (idx >= tail0) {
        tail_r[static_cast<long long>(c) * hist + (idx - tail0)] = vr;
        tail_i[static_cast<long long>(c) * hist + (idx - tail0)] = vi;
      }
    }
    __syncthreads();  // carry visible; staged samples consumed
  }
  if (t < 4) dc_out[c * 4 + t] = static_cast<float>(carry[t]);
}

}  // namespace iqk

// Launch on `stream`; returns the launch's cudaError_t (0 on success).
extern "C" int iq_dc_prologue(const void* wire, int kind, float norm,
                              float gain, const float* dc_in, double a,
                              const long long* phase, unsigned dtheta,
                              int channels, int n, int hist, float* y_r,
                              float* y_i, float* tail_r, float* tail_i,
                              float* dc_out, void* stream) {
  if (channels <= 0 || n <= 0 || hist < 0 || hist > n ||
      kind == iqk::kPlanar) {
    return cudaErrorInvalidValue;
  }
  iqk::dc_prologue_kernel<<<channels, iqk::kDcThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      wire, kind, norm, gain, dc_in, a, phase, dtheta, n, hist, y_r, y_i,
      tail_r, tail_i, dc_out);
  return cudaGetLastError();
}
