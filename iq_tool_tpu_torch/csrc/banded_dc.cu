// The DC-block pre-stage: one templated kernel serves two entry points.
//
// * K1 prologue (iq_dc_prologue): packed-wire decode -> DC block -> NCO
//   mix over whole channels, writing the processed planes, their last
//   `hist` samples (the resampler stage's next carried history) and the
//   new DC state.  The port's K1 is this launch followed by the K2 banded
//   kernel over the processed planes (ops/kernels.py banded_apply_dc).
//   Replaces iq_tool_tpu/ops/pallas_kernels.py:banded_apply_dc
//   (_banded_dc_kernel with _wire_decode, _dc_plane_tile and
//   _nco_mix_base).
// * K3 (iq_dc_block_apply): packed wire or float32 planes in -> DC block
//   -> I/Q apply I' = (1+g)I, Q' = Q + phi*I -> NCO mix, writing the
//   planes and the new DC state, no tail.  Replaces
//   iq_tool_tpu/ops/pallas_kernels.py:dc_block_apply (_dc_kernel).  It
//   takes any N: the TPU's N % 128 gate (dc_geometry) is not copied.
//
// Both are the same recurrence with a different front and back, so they
// share one __global__ with template flags (planar input, I/Q apply) and
// a runtime tail pointer, rather than two copies of the scan.  The DC
// state written is the pre-I/Q, pre-NCO state, as _dc_kernel writes it.
//
// The TPU kernels carry the DC state and the previous tile's context in
// scratch memory from one time tile to the next, which relies on the TPU
// walking tiles in order; CUDA gives no order between CTAs.
//
// What bounds it on the card: bytes and the in-order chunk walk.  Per
// sample it reads one packed wire element (4 B for 16-bit wires) or two
// float32 planes (8 B) and writes two float32 planes (8 B).
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
// the kernel is bound by bytes and by its chunk loop, not arithmetic.
// Loads and plane stores go through shared memory so both are coalesced;
// the next chunk's input is loaded into registers while the current
// chunk's scan runs.

#include <cuda_runtime.h>

#include "wire.cuh"

namespace iqk {

constexpr int kDcThreads = 512;
constexpr int kDcPer = 8;
constexpr int kDcChunk = kDcThreads * kDcPer;
constexpr int kDcPad = kDcPer + 1;  // staged row stride: no bank conflicts
constexpr int kDcLevels = 9;        // log2(kDcThreads) doubling steps
static_assert(kDcThreads == 1 << kDcLevels, "one scan level per doubling");

struct DcArgs {
  const void* wire;  // packed wire (C, n), or
  int kind;
  float norm;
  float gain;
  const float* x_r;  // planar input (C, n) when the kernel is planar
  const float* x_i;
  const float* dc_in;  // (C, 4) [xr, xi, yr, yi] prevs
  double a;            // pole 1 - alpha
  const float* iq;     // (C, 2) [g, phi] when the kernel applies I/Q
  const long long* phase;  // (C,) uint32 NCO phase of sample 0, or null
  unsigned dtheta;
  int n;
  int hist;  // tail length, when tail_r is set
  float* y_r;
  float* y_i;
  float* tail_r;  // (C, hist) processed tail, or null
  float* tail_i;
  float* dc_out;  // (C, 4)
};

// One input sample as loaded ahead of its chunk: the raw packed element,
// or both planes' values.
template <bool kPlanarIn>
struct Raw {
  int v;
};
template <>
struct Raw<true> {
  float r, i;
};

template <bool kPlanarIn>
__device__ __forceinline__ Raw<kPlanarIn> load_raw(const DcArgs& a,
                                                   const char* row,
                                                   long long row0,
                                                   long long idx) {
  Raw<kPlanarIn> out;
  if constexpr (kPlanarIn) {
    out.r = idx < a.n ? a.x_r[row0 + idx] : 0.0f;
    out.i = idx < a.n ? a.x_i[row0 + idx] : 0.0f;
  } else {
    out.v = idx < a.n ? wire_load(row, a.kind, idx) : 0;
  }
  return out;
}

template <bool kPlanarIn>
__device__ __forceinline__ void decode_raw(const DcArgs& a,
                                           const Raw<kPlanarIn>& raw,
                                           float* vr, float* vi) {
  if constexpr (kPlanarIn) {
    *vr = raw.r;
    *vi = raw.i;
  } else {
    wire_decode_value(raw.v, a.kind, a.norm, a.gain, vr, vi);
  }
}

template <bool kPlanarIn, bool kIq>
__global__ void __launch_bounds__(kDcThreads) dc_kernel(const DcArgs a) {
  __shared__ float stage_r[kDcThreads * kDcPad];
  __shared__ float stage_i[kDcThreads * kDcPad];
  __shared__ double scan_r[kDcThreads];
  __shared__ double scan_i[kDcThreads];
  __shared__ double level_coef[kDcLevels];  // a^(kDcPer * 2^k)
  __shared__ double carry[4];  // x_prev r/i, y_prev r/i

  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int n = a.n;
  const long long row0 = static_cast<long long>(c) * n;
  const char* row = nullptr;
  if constexpr (!kPlanarIn) {
    const int elem = a.kind == kCs16 || a.kind == kCu16 ? 4 : 2;
    row = static_cast<const char*>(a.wire) + row0 * elem;
  }
  const unsigned ph0 = a.dtheta ? static_cast<unsigned>(a.phase[c]) : 0u;
  float g1 = 1.0f, phi = 0.0f;
  if constexpr (kIq) {
    g1 = __fadd_rn(1.0f, a.iq[c * 2]);
    phi = a.iq[c * 2 + 1];
  }
  const double pa = a.a;
  double apow[kDcPer];  // a^(j+1)
#pragma unroll
  for (int j = 0; j < kDcPer; ++j) apow[j] = pow(pa, j + 1);
  const double carry_coef = pow(pa, static_cast<double>(kDcPer) * t);
  if (t < kDcLevels) level_coef[t] = pow(pa, static_cast<double>(kDcPer) * (1 << t));
  if (t < 4) carry[t] = a.dc_in[c * 4 + t];

  // inputs of the next chunk, loaded one chunk ahead so that their
  // latency hides behind the current chunk's scan (r = t + j * kDcThreads)
  Raw<kPlanarIn> next[kDcPer];
#pragma unroll
  for (int j = 0; j < kDcPer; ++j) {
    next[j] = load_raw<kPlanarIn>(a, row, row0, t + j * kDcThreads);
  }
  for (long long base = 0; base < n; base += kDcChunk) {
#pragma unroll
    for (int j = 0; j < kDcPer; ++j) {
      const int r = t + j * kDcThreads;
      float vr = 0.0f, vi = 0.0f;
      if (base + r < n) decode_raw<kPlanarIn>(a, next[j], &vr, &vi);
      stage_r[(r / kDcPer) * kDcPad + r % kDcPer] = vr;
      stage_i[(r / kDcPer) * kDcPad + r % kDcPer] = vi;
      next[j] = load_raw<kPlanarIn>(a, row, row0, base + kDcChunk + r);
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
        accr = fma(pa, accr, xr[j] - pr);
        acci = fma(pa, acci, xi[j] - pi);
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
      if constexpr (kIq) {
        // I' = (1+g) I, Q' = Q + phi I (ops/iq_balance.py apply_planar)
        const float qr = __fmul_rn(vr, g1);
        vi = __fadd_rn(vi, __fmul_rn(phi, vr));
        vr = qr;
      }
      if (a.dtheta) nco_rotate(ph0, a.dtheta, my0 + j, &vr, &vi);
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
    const long long tail0 = n - a.hist;
    for (int r = t; r < kDcChunk; r += kDcThreads) {
      const long long idx = base + r;
      if (idx >= n) break;
      const float vr = stage_r[(r / kDcPer) * kDcPad + r % kDcPer];
      const float vi = stage_i[(r / kDcPer) * kDcPad + r % kDcPer];
      a.y_r[row0 + idx] = vr;
      a.y_i[row0 + idx] = vi;
      if (a.tail_r != nullptr && idx >= tail0) {
        a.tail_r[static_cast<long long>(c) * a.hist + (idx - tail0)] = vr;
        a.tail_i[static_cast<long long>(c) * a.hist + (idx - tail0)] = vi;
      }
    }
    __syncthreads();  // carry visible; staged samples consumed
  }
  if (t < 4) a.dc_out[c * 4 + t] = static_cast<float>(carry[t]);
}

int launch_dc(const DcArgs& a, int channels, bool planar_in, bool iq,
              cudaStream_t stream) {
  if (channels <= 0 || a.n <= 0 || (planar_in && (!a.x_r || !a.x_i)) ||
      (!planar_in && (!a.wire || a.kind == kPlanar)) || (iq && !a.iq) ||
      (a.dtheta && !a.phase) ||
      (a.tail_r && (a.hist < 0 || a.hist > a.n))) {
    return cudaErrorInvalidValue;
  }
  if (planar_in) {
    if (iq) {
      dc_kernel<true, true><<<channels, kDcThreads, 0, stream>>>(a);
    } else {
      dc_kernel<true, false><<<channels, kDcThreads, 0, stream>>>(a);
    }
  } else {
    if (iq) {
      dc_kernel<false, true><<<channels, kDcThreads, 0, stream>>>(a);
    } else {
      dc_kernel<false, false><<<channels, kDcThreads, 0, stream>>>(a);
    }
  }
  return cudaGetLastError();
}

}  // namespace iqk

// K1 prologue.  Launch on `stream`; returns the launch's cudaError_t.
extern "C" int iq_dc_prologue(const void* wire, int kind, float norm,
                              float gain, const float* dc_in, double a,
                              const long long* phase, unsigned dtheta,
                              int channels, int n, int hist, float* y_r,
                              float* y_i, float* tail_r, float* tail_i,
                              float* dc_out, void* stream) {
  if (!tail_r || !tail_i) return cudaErrorInvalidValue;
  iqk::DcArgs args{wire, kind, norm, gain, nullptr, nullptr, dc_in, a,
                   nullptr, phase, dtheta, n, hist, y_r, y_i, tail_r, tail_i,
                   dc_out};
  return iqk::launch_dc(args, channels, false, false,
                        static_cast<cudaStream_t>(stream));
}

// K3: `wire` with kind >= 0, or planes x_r/x_i with kind == kPlanar;
// `iq` (C, 2) or null; `phase` needed when dtheta != 0.
extern "C" int iq_dc_block_apply(const void* wire, int kind, float norm,
                                 float gain, const float* x_r,
                                 const float* x_i, const float* dc_in,
                                 double a, const float* iq,
                                 const long long* phase, unsigned dtheta,
                                 int channels, int n, float* y_r, float* y_i,
                                 float* dc_out, void* stream) {
  iqk::DcArgs args{wire, kind, norm, gain, x_r, x_i, dc_in, a, iq, phase,
                   dtheta, n, 0, y_r, y_i, nullptr, nullptr, dc_out};
  return iqk::launch_dc(args, channels, kind == iqk::kPlanar, iq != nullptr,
                        static_cast<cudaStream_t>(stream));
}
