// The I/Q estimator, whole, as one kernel: a helper kernel, not a TPU
// kernel.
//
// Replaces the estimator branch of the JAX package's fused pre-stage
// (iq_tool_tpu/pipeline/chain.py:309-328): convert.decode_packed on the
// wire's first m = min(n, 1024) frames, dc_block._apply_plane on both
// planes from the carried state, then iq_balance.maybe_update_planar
// (iq_tool_tpu/ops/iq_balance.py:169-224), which XLA runs as one program
// under lax.cond.  In PyTorch's eager mode that was ~130 tensor ops a
// step, ~75 of them kernel launches (the decode, a float64 tile matmul
// and log-depth scans per plane, the window, two FFTs and rolls, the
// descent, the gate, the smoothing and the counter), run and masked on
// every step: their host time was most of config #4's idle share.  Here
// it is one launch, which reads the carried counter on the device and,
// when no update is due, does no estimator work at all.
//
// For each channel (one CTA, 512 threads):
//
// 1. Due check: counter >= interval (always due without a counter, as
//    for the pre-stream calibration).  A CTA that is not due copies its
//    factors and goes to step 5.
// 2. The prefix: the first m frames of the packed wire (decoded with
//    decode_packed's order ((x - off) * norm) * gain) or of two float32
//    planes, optionally DC-blocked, y[k] = a y[k-1] + x[k] - x[k-1] with
//    a = 1 - alpha, in float64 from the carried (C, 4) state and rounded
//    to float32 once (ops/dc_block.py scan_plane).  A thread owns two
//    consecutive samples; a warp-shuffle scan and a Horner pass over the
//    warp totals give each its incoming y (the scheme of csrc/banded.cu's
//    DC-wire loader).  Samples past m are zero, as maybe_update pads.
// 3. The spectra FFT(w y) and FFT(w Re y) of the float32 Hamming-windowed
//    block, 1024 points each, in shared memory: two warps, one a
//    transform, as 32 x 32 (a radix-32 pass in registers over the
//    columns, the twiddles W_1024^(j k1), a transpose through a 33-pitch
//    buffer, a radix-32 pass over the rows).  The fftshift is an index:
//    shifted[k] = X[(k + 512) mod 1024].
// 4. The power gate (the band's peak-to-average in dB at the starting
//    factors) and the greedy descent: for factors (g, phi) the corrected
//    spectrum is base + (g + i phi) image, in dB 20 log10(|.| / 1024 +
//    1e-12); the utility is the sum over the band [lo, hi) of (P(+f) -
//    P(-f))^2 where either side is above the floor; each pass tries the 4
//    diagonal moves and keeps the best if it beats the current utility
//    (first maximum on a tie, as torch.argmax).  Then, where due and
//    gated, the smoothing (1 - 0.05) f + 0.05 new; without smoothing (the
//    calibration) the descent's factors as they are.
// 5. The counter: ran = due & any(gate) over every channel.  Each CTA adds
//    one, and one more in the high word when it ran, to a 64-bit ticket;
//    the CTA that draws the last ticket writes ran ? 0 :
//    min(min(counter, SAT) + advance, SAT) and re-arms the ticket to 0
//    itself, so no memset runs between launches.  Exact and order-free.
//
// What bounds it: on a due step the descent, 25 passes x 4 moves x 2
// sides x 461 band bins of a complex product, a hypot and a log10 per
// channel: instructions, not bytes (8 KiB in a channel).  Design: 512
// threads own one band bin each (both sides, base and image in
// registers), so the 16 warps of one CTA per SM hide each other's
// latency; each pass reduces the 4 candidates' sums together (the warp's
// 4 x 32 values transposed down in 6 shuffles, one barrier, the 16 warp
// sums in 2 shared loads and 3 shuffles), into one of two slots in turn,
// so a pass needs one barrier.  Every thread reduces the same values in
// the same order, so all take the same move.  On a step that is not due
// the kernel is a launch and a ticket.
//
// The greedy argmax is discontinuous on a near-tie of two candidates, so
// the plain twin (ops/iq_balance.py: _fft1024, _spectrum_db, _band_sum)
// rounds as this kernel does, operation for operation: the decode, the
// window, the 32 x 32 FFT, the corrected spectrum and the smoothing in
// float32 with _rn intrinsics (no contraction), and the band sums in
// cta_sum4's fixed tree.  Torch's CUDA hypot and log10 are the CUDA
// library's hypotf and log10f, so on the card the two hold the same bits
// and decide alike on a near-tie; only the float64 DC prefix runs in
// another order.  (Sums in float64 made the due step slower than its
// budget allows on an H100; in float32 in one shared order the
// comparisons are exact all the same.)

#include <cuda_runtime.h>

#include "wire.cuh"

namespace iqk {
namespace est {

constexpr int kN = 1024;  // IQ_FFT_SIZE
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPitch = 33;  // the transpose's row pitch (float2)
constexpr long long kSat = 0xF0000000LL;

// exp(-2 pi i k / 32), k < 16
__constant__ float2 kW32[16] = {
    {1.000000000e+00f, 0.000000000e+00f},
    {9.807852804e-01f, -1.950903220e-01f},
    {9.238795325e-01f, -3.826834324e-01f},
    {8.314696123e-01f, -5.555702330e-01f},
    {7.071067812e-01f, -7.071067812e-01f},
    {5.555702330e-01f, -8.314696123e-01f},
    {3.826834324e-01f, -9.238795325e-01f},
    {1.950903220e-01f, -9.807852804e-01f},
    {0.000000000e+00f, -1.000000000e+00f},
    {-1.950903220e-01f, -9.807852804e-01f},
    {-3.826834324e-01f, -9.238795325e-01f},
    {-5.555702330e-01f, -8.314696123e-01f},
    {-7.071067812e-01f, -7.071067812e-01f},
    {-8.314696123e-01f, -5.555702330e-01f},
    {-9.238795325e-01f, -3.826834324e-01f},
    {-9.807852804e-01f, -1.950903220e-01f}};

struct Args {
  const void* wire;  // packed wire (kind >= 0) or null
  int kind;
  float norm;
  float gain;
  const float* xr;  // float32 planes (kind == kPlanar)
  const float* xi;
  long long ld;   // row stride of the source, elements
  long long inc;  // element stride along a row (planes)
  int m;          // prefix frames, 1..kN; zero-padded to kN
  const float* dc;  // (C, 4) [xr_prev, xi_prev, yr_prev, yi_prev] or null
  double pole;      // 1 - alpha
  const float* window;    // (kN,) float32 Hamming window
  const float2* twiddle;  // (kN,) exp(-2 pi i k / kN)
  const float* factors;   // (C, 2) [g, phi] in
  const long long* counter;  // () uint32 value, or null: due, no counter out
  long long interval;
  long long advance;
  int passes;
  float step;
  float floor_db;
  float gate_min;
  float keep;  // 1 - smoothing, rounded to float32
  float mix;   // smoothing
  int smooth;  // 0: write the descent's factors as they are
  int lo;
  int hi;
  int channels;
  float* out;              // (C, 2) factors out
  float* gate;             // (C,) gate dB (NaN where not due) or null
  long long* counter_out;  // () or null
  unsigned long long* ticket;  // zero between launches
};

// complex arithmetic rounded at each operation, as the twin's tensor ops
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                     __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

__device__ __forceinline__ float2 rot32(float2 z, int k) {
  if (k == 0) return z;
  if (k == 8) return make_float2(z.y, -z.x);
  return cmul(z, kW32[k]);
}

__device__ __forceinline__ constexpr int brev5(int j) {
  return ((j & 1) << 4) | ((j & 2) << 2) | (j & 4) | ((j & 8) >> 2) | ((j & 16) >> 4);
}

// A 32-point DFT in registers by radix-2 decimation in frequency: x[n]
// in, X[brev5(r)] in register r out.
__device__ __forceinline__ void dft32(float2 (&x)[32]) {
#pragma unroll
  for (int b = 4; b >= 0; --b) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (j & (1 << b)) continue;
      const float2 u = x[j], v = x[j + (1 << b)];
      x[j] = cadd(u, v);
      x[j + (1 << b)] = rot32(csub(u, v), (j & ((1 << b) - 1)) << (4 - b));
    }
  }
}

// The 1024-point DFT of buf[0, kN) in place, by one warp: X[k1 + 32 k2] =
// sum_j W32^(j k2) W1024^(j k1) sum_n1 x[j + 32 n1] W32^(n1 k1).  buf
// holds kN + kN / 32 points (the transpose's padding).
__device__ __forceinline__ void fft1024(float2* buf, const float2* __restrict__ tw) {
  const int j = threadIdx.x & 31;
  float2 x[32];
#pragma unroll
  for (int n1 = 0; n1 < 32; ++n1) x[n1] = buf[j + 32 * n1];
  dft32(x);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const int k1 = brev5(r);
    buf[j * kPitch + k1] = k1 == 0 ? x[r] : cmul(x[r], __ldg(&tw[(j * k1) & (kN - 1)]));
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = buf[i * kPitch + j];  // lane j is now k1
  dft32(x);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 32; ++r) buf[j + 32 * brev5(r)] = x[r];
}

// Sums of v[0..3] over the CTA, returned to every thread.  Within a warp
// the 4 x 32 values are transposed down (lanes 8k..8k+7 end with value
// k's warp sum), written to `red` (4 x kWarps), then, after the one
// barrier, every warp sums the 16 warp sums alike.  Each value's sum
// takes the same tree (iq_balance._band_sum).
__device__ __forceinline__ void cta_sum4(float (&v)[4], float* red) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool h16 = lane & 16, h8 = lane & 8;
  float k0 = h16 ? v[2] : v[0];
  float k1 = h16 ? v[3] : v[1];
  k0 += __shfl_xor_sync(full, h16 ? v[0] : v[2], 16);
  k1 += __shfl_xor_sync(full, h16 ? v[1] : v[3], 16);
  float s = h8 ? k1 : k0;
  s += __shfl_xor_sync(full, h8 ? k0 : k1, 8);
  s += __shfl_xor_sync(full, s, 4);
  s += __shfl_xor_sync(full, s, 2);
  s += __shfl_xor_sync(full, s, 1);
  const int k = lane >> 3, i = lane & 7;
  if (i == 0) red[k * kWarps + warp] = s;
  __syncthreads();
  float w = red[k * kWarps + 2 * i] + red[k * kWarps + 2 * i + 1];
  w += __shfl_xor_sync(full, w, 4);
  w += __shfl_xor_sync(full, w, 2);
  w += __shfl_xor_sync(full, w, 1);
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = __shfl_sync(full, w, 8 * q);
}

// 20 log10(|b + (g + i phi) m| / kN + 1e-12), as iq_balance._spectrum_db
__device__ __forceinline__ float spec_db(float2 b, float2 m, float g, float phi) {
  const float re = __fadd_rn(b.x, __fsub_rn(__fmul_rn(g, m.x), __fmul_rn(phi, m.y)));
  const float im = __fadd_rn(b.y, __fadd_rn(__fmul_rn(g, m.y), __fmul_rn(phi, m.x)));
  // x / kN: a product by 2^-10, exact as the twin's division
  const float mag = __fadd_rn(__fmul_rn(hypotf(re, im), 1.0f / kN), 1e-12f);
  return __fmul_rn(20.0f, log10f(mag));
}

// (pp - pn)^2 where either side is above the floor
__device__ __forceinline__ float util_term(float pp, float pn, float floor_db) {
  const float d = __fsub_rn(pp, pn);
  return (pp > floor_db || pn > floor_db) ? __fmul_rn(d, d) : 0.0f;
}

// Sample k of one channel's source, decoded (0 past m).
template <bool kWire>
__device__ __forceinline__ void load_sample(const Args& a, int c, int k, float* xr,
                                            float* xi) {
  *xr = 0.0f;
  *xi = 0.0f;
  if (k >= a.m) return;
  if constexpr (kWire) {
    const int elem = a.kind == kCs16 || a.kind == kCu16 ? 4 : 2;
    const char* row = static_cast<const char*>(a.wire) + c * a.ld * elem;
    wire_decode(row, a.kind, k, a.norm, a.gain, xr, xi);
  } else {
    const long long o = c * a.ld + k * a.inc;
    *xr = a.xr[o];
    *xi = a.xi[o];
  }
}

// Steps 2 and the window: the windowed prefix into base (w y) and image
// (w Re y), natural order.  Holds a barrier when kDc.
template <bool kWire, bool kDc>
__device__ __forceinline__ void stage_prefix(const Args& a, int c, float2* base,
                                             float2* image, double (*wtot)[kWarps]) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int k0 = 2 * t;
  float x[2][2];  // [sample][plane]
  load_sample<kWire>(a, c, k0, &x[0][0], &x[0][1]);
  load_sample<kWire>(a, c, k0 + 1, &x[1][0], &x[1][1]);
  float y[2][2] = {{x[0][0], x[0][1]}, {x[1][0], x[1][1]}};
  if constexpr (kDc) {
    const double pa = a.pole;
    float xp[2];
    if (t == 0) {
      xp[0] = a.dc[c * 4 + 0];
      xp[1] = a.dc[c * 4 + 1];
    } else {
      load_sample<kWire>(a, c, k0 - 1, &xp[0], &xp[1]);
    }
    // the two samples' increments and the run from y = 0
    double b[2][2], e[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      b[0][p] = static_cast<double>(x[0][p]) - static_cast<double>(xp[p]);
      b[1][p] = static_cast<double>(x[1][p]) - static_cast<double>(x[0][p]);
      e[p] = fma(pa, b[0][p], b[1][p]);
    }
    // warp scan of the runs: lane l's level-k partner lies 2^(k+1)
    // samples back
    const double p2 = pa * pa;
    double lev = p2;
    double s[2] = {e[0], e[1]};
#pragma unroll
    for (int q = 0; q < 5; ++q) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const double u = __shfl_up_sync(0xffffffffu, s[p], 1 << q);
        if (lane >= (1 << q)) s[p] = fma(lev, u, s[p]);
      }
      lev *= lev;  // p2^(2^(q+1))
    }
    // lev = a^64, a warp's samples
    double z[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      z[p] = __shfl_up_sync(0xffffffffu, s[p], 1);
      if (lane == 0) z[p] = 0.0;
      if (lane == 31) wtot[p][warp] = s[p];
    }
    __syncthreads();
    const double lane_pow = ipow(p2, static_cast<unsigned>(lane));
    const double start_pow = ipow(p2, static_cast<unsigned>(t));
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      double w = 0.0;
      for (int v = 0; v < warp; ++v) w = fma(lev, w, wtot[p][v]);
      const double yin = fma(start_pow, static_cast<double>(a.dc[c * 4 + 2 + p]),
                             fma(lane_pow, w, z[p]));
      const double y0 = fma(pa, yin, b[0][p]);
      const double y1 = fma(pa, y0, b[1][p]);
      y[0][p] = k0 < a.m ? static_cast<float>(y0) : 0.0f;
      y[1][p] = k0 + 1 < a.m ? static_cast<float>(y1) : 0.0f;
    }
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const float w = a.window[k0 + s];
    const float wr = __fmul_rn(w, y[s][0]);
    base[k0 + s] = make_float2(wr, __fmul_rn(w, y[s][1]));
    image[k0 + s] = make_float2(wr, 0.0f);
  }
}

template <bool kWire, bool kDc>
__global__ void __launch_bounds__(kThreads) iq_estimate_kernel(const Args a) {
  __shared__ float2 base[kN + kN / 32];
  __shared__ float2 image[kN + kN / 32];
  __shared__ double wtot[2][kWarps];
  __shared__ float red[2][4 * kWarps];
  __shared__ float peak[kWarps];
  const int c = blockIdx.x, t = threadIdx.x;
  const bool due = a.counter == nullptr || *a.counter >= a.interval;
  bool ran = false;
  if (due) {
    stage_prefix<kWire, kDc>(a, c, base, image, wtot);
    __syncthreads();
    if (t < 32) {
      fft1024(base, a.twiddle);
    } else if (t < 64) {
      fft1024(image, a.twiddle);
    }
    __syncthreads();

    // this thread's band bin: p_neg at lo + t, p_pos at kN - lo - 1 - t,
    // read from the unshifted spectra at (i + kN / 2) mod kN
    const int nb = a.hi - a.lo;
    const bool own = t < nb;
    const int ineg = ((own ? a.lo + t : 0) + kN / 2) & (kN - 1);
    const int ipos = ((own ? kN - a.lo - 1 - t : 0) + kN / 2) & (kN - 1);
    const float2 bn = base[ineg], mn = image[ineg], bp = base[ipos], mp = image[ipos];
    float g = a.factors[c * 2];
    float phi = a.factors[c * 2 + 1];

    // the utility, the band's sums and its peak at the starting factors
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float mx = -3.0e38f;
    if (own) {
      const float pn = spec_db(bn, mn, g, phi);
      const float pp = spec_db(bp, mp, g, phi);
      v[0] = util_term(pp, pn, a.floor_db);
      v[1] = pp;
      v[2] = pn;
      mx = fmaxf(pp, pn);
    }
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if ((t & 31) == 0) peak[t >> 5] = mx;
    cta_sum4(v, red[1]);  // its barrier also publishes the warp peaks
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, peak[w]);
    const float gate_db =
        __fsub_rn(mx, __fdiv_rn(__fadd_rn(v[1], v[2]), static_cast<float>(2 * nb)));
    float cur_u = v[0];

    // every thread reduces the same sums in the same order, so all of
    // them take the same move; pass p reduces through slot p & 1, which
    // no thread reads again before the next pass's barrier
    for (int p = 0; p < a.passes; ++p) {
      float u[4], cg[4], cp[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        cg[k] = __fadd_rn(g, k < 2 ? a.step : -a.step);
        cp[k] = __fadd_rn(phi, (k & 1) ? -a.step : a.step);
        u[k] = 0.0f;
        if (own) {
          u[k] = util_term(spec_db(bp, mp, cg[k], cp[k]), spec_db(bn, mn, cg[k], cp[k]),
                           a.floor_db);
        }
      }
      cta_sum4(u, red[p & 1]);
      int best = 0;
#pragma unroll
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
      const float f0 = a.factors[c * 2], f1 = a.factors[c * 2 + 1];
      float o0 = g, o1 = phi;
      if (a.smooth) {
        ran = gate_db >= a.gate_min;
        o0 = ran ? __fadd_rn(__fmul_rn(a.keep, f0), __fmul_rn(a.mix, g)) : f0;
        o1 = ran ? __fadd_rn(__fmul_rn(a.keep, f1), __fmul_rn(a.mix, phi)) : f1;
      }
      a.out[c * 2] = o0;
      a.out[c * 2 + 1] = o1;
      if (a.gate) a.gate[c] = gate_db;
    }
  } else if (t == 0) {
    a.out[c * 2] = a.factors[c * 2];
    a.out[c * 2 + 1] = a.factors[c * 2 + 1];
    if (a.gate) a.gate[c] = __int_as_float(0x7fffffff);
  }
  if (t == 0 && a.counter != nullptr) {
    const unsigned long long mine = 1ull | (ran ? (1ull << 32) : 0ull);
    const unsigned long long before = atomicAdd(a.ticket, mine);
    if ((before & 0xffffffffull) == static_cast<unsigned long long>(a.channels - 1)) {
      const bool any_ran = ((before >> 32) != 0ull) || ran;
      const long long cnt = *a.counter;
      const long long held = cnt < kSat ? cnt : kSat;
      const long long next = held + a.advance < kSat ? held + a.advance : kSat;
      *a.counter_out = any_ran ? 0LL : next;
      *a.ticket = 0ull;  // re-armed for the next launch
    }
  }
}

template <bool kWire, bool kDc>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  iq_estimate_kernel<kWire, kDc><<<a.channels, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace est
}  // namespace iqk

// Launch on `stream`; returns the launch's cudaError_t (0 on success).
// wire: packed wire of `kind` (>= 0) or null for the float32 planes
// xr/xi (kind -1); ld/inc: the source's row and element strides; dc: the
// (C, 4) DC state or null; counter: the () int64 counter or null (always
// due, no counter_out, no ticket).
extern "C" int iq_estimate(const void* wire, int kind, float norm, float gain,
                           const float* xr, const float* xi, long long ld,
                           long long inc, int m, const float* dc, double pole,
                           const float* window, const void* twiddle,
                           const float* factors, const long long* counter,
                           long long interval, long long advance, int passes,
                           float step, float floor_db, float gate_min, float keep,
                           float mix, int smooth, int lo, int hi, int channels,
                           float* out, float* gate, long long* counter_out,
                           void* ticket, void* stream) {
  using namespace iqk::est;
  const bool wired = kind != iqk::kPlanar;
  if (channels <= 0 || m <= 0 || m > kN || lo < 0 || hi <= lo || 2 * hi > kN ||
      hi - lo > kThreads || passes < 0 || (wired ? wire == nullptr : (xr == nullptr || xi == nullptr)) ||
      (counter != nullptr && (counter_out == nullptr || ticket == nullptr))) {
    return cudaErrorInvalidValue;
  }
  Args a{wire, kind, norm, gain, xr, xi, ld, inc, m, dc, pole, window,
         static_cast<const float2*>(twiddle), factors, counter, interval, advance,
         passes, step, floor_db, gate_min, keep, mix, smooth, lo, hi, channels,
         out, gate, counter_out, static_cast<unsigned long long*>(ticket)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wired) return dc ? launch<true, true>(a, s) : launch<true, false>(a, s);
  return dc ? launch<false, true>(a, s) : launch<false, false>(a, s);
}
