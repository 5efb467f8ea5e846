// K2: strided-window banded map, y = windows(state ++ x; stride s,
// length s + hist) @ A, for one resampler stage.
//
// Replaces iq_tool_tpu/ops/pallas_kernels.py:banded_apply (the
// _banded_kernel, _banded_kernel_complex, _shift_kernel and
// _shift_kernel_complex bodies): planar or packed-wire input with an
// optional NCO mix at each sample's global index, planar float32 or
// quantized packed-wire output.
//
// What bounds it on the card: the band products.  A polyphase column has
// K non-zero taps (32 at flagship stage 0, 96 at stage 1 with the lowpass
// composed in) out of s + hist rows, so the work is 4*C*nb*G*K FP32 FMA
// flops for real taps; the bytes are the input planes (or wire) once and
// the output once.  In this first version every product is an FP32 FMA
// that reads both operands from shared memory, so shared-memory bandwidth
// (one load per FMA) is the limit, about a quarter of the FMA rate.
//
// Design: the host compresses A to its band, each column's first
// non-zero row and K taps (the same linear map with exact zeros skipped).
// A CTA owns one channel and a run of windows; it stages the band taps in
// shared memory once, then walks its windows in groups of kWinGroup:
// the group's input span (decoded and NCO-mixed from the wire when given)
// is staged in shared memory, each thread takes output columns and keeps
// kWinGroup windows of accumulators in registers, reusing each tap
// kWinGroup times.  A warp takes only as many consecutive columns as have
// their band starts within 32 words (`cols_per_warp`, from the host):
// their span loads then hit 32 distinct banks, where 32 columns of a
// decimating stage (start spacing q/p > 1 word) would conflict 2-way.
// Windows need no order between CTAs: the carried history arrives as
// `state` and every CTA reads its own left context.  Any stride and
// history work; nothing is tied to 128-lane tiles.

#include <cuda_runtime.h>

#include "wire.cuh"

namespace iqk {

constexpr int kWinGroup = 8;
constexpr int kMaxThreads = 512;

struct BandedArgs {
  const float* xr;  // planar input (C, n), when kind == kPlanar
  const float* xi;
  const void* wire;  // packed wire (C, n), otherwise
  int kind;
  float norm;
  float gain;
  const long long* phase;  // (C,) uint32 NCO phase of sample 0, or null
  unsigned dtheta;
  const float* st_r;  // (C, hist) carried history (processed, pre-rotated)
  const float* st_i;
  const int* first;  // (G,) first band row of each column
  const float* taps_r;  // (K, G) band taps
  const float* taps_i;  // (K, G) or null for real taps
  int k;
  int cols_per_warp;  // consecutive columns one warp takes (<= 32)
  int n, s, hist, g, nb, win_per_cta;
  float* out_r;  // (C, nb*G) planar output, or
  float* out_i;
  void* out_packed;  // (C, nb*G) packed wire output when q.bits != 0
  PackParams q;
};

// Sample e of one channel's extended input state ++ x.
__device__ __forceinline__ void load_ext(const BandedArgs& a, int c,
                                         long long e, float* vr, float* vi) {
  if (e < a.hist) {
    *vr = a.st_r[static_cast<long long>(c) * a.hist + e];
    *vi = a.st_i[static_cast<long long>(c) * a.hist + e];
    return;
  }
  const long long idx = e - a.hist;
  const long long row = static_cast<long long>(c) * a.n;
  if (a.kind == kPlanar) {
    *vr = a.xr[row + idx];
    *vi = a.xi[row + idx];
    return;
  }
  const int elem = a.kind == kCs16 || a.kind == kCu16 ? 4 : 2;
  const char* base = static_cast<const char*>(a.wire) + row * elem;
  wire_decode(base, a.kind, idx, a.norm, a.gain, vr, vi);
  if (a.dtheta) {
    nco_rotate(static_cast<unsigned>(a.phase[c]), a.dtheta, idx, vr, vi);
  }
}

template <bool kComplex>
__global__ void __launch_bounds__(kMaxThreads)
    banded_kernel(const BandedArgs a) {
  extern __shared__ float smem[];
  const int kg = a.k * a.g;
  const int seg_cap = kWinGroup * a.s + a.hist;
  float* tap_r = smem;
  float* tap_i = smem + kg;  // only when kComplex
  float* seg_r = smem + (kComplex ? 2 : 1) * kg;
  float* seg_i = seg_r + seg_cap;
  int* first = reinterpret_cast<int*>(seg_i + seg_cap);

  const int c = blockIdx.y;
  const int b_begin = blockIdx.x * a.win_per_cta;
  const int b_end = min(b_begin + a.win_per_cta, a.nb);
  for (int j = threadIdx.x; j < kg; j += blockDim.x) {
    tap_r[j] = a.taps_r[j];
    if (kComplex) tap_i[j] = a.taps_i[j];
  }
  for (int j = threadIdx.x; j < a.g; j += blockDim.x) first[j] = a.first[j];

  const long long out_row = static_cast<long long>(c) * a.nb * a.g;
  for (int b0 = b_begin; b0 < b_end; b0 += kWinGroup) {
    const int nw = min(kWinGroup, b_end - b0);
    const int seg_len = nw * a.s + a.hist;
    __syncthreads();  // taps staged; the previous group's reads are done
    for (int r = threadIdx.x; r < seg_len; r += blockDim.x) {
      float vr, vi;
      load_ext(a, c, static_cast<long long>(b0) * a.s + r, &vr, &vi);
      seg_r[r] = vr;
      seg_i[r] = vi;
    }
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int col_step = (blockDim.x >> 5) * a.cols_per_warp;
    const int i0 = lane < a.cols_per_warp
                       ? (threadIdx.x >> 5) * a.cols_per_warp + lane : a.g;
    for (int i = i0; i < a.g; i += col_step) {
      float yr[kWinGroup], yi[kWinGroup];
#pragma unroll
      for (int w = 0; w < kWinGroup; ++w) {
        yr[w] = 0.0f;
        yi[w] = 0.0f;
      }
      // windows past nw read stale span data; their sums are discarded
      const float* xr0 = seg_r + first[i];
      const float* xi0 = seg_i + first[i];
      for (int k = 0; k < a.k; ++k) {
        const float wr = tap_r[k * a.g + i];
        if (kComplex) {
          const float wi = tap_i[k * a.g + i];
#pragma unroll
          for (int w = 0; w < kWinGroup; ++w) {
            const float xr = xr0[w * a.s + k];
            const float xi = xi0[w * a.s + k];
            yr[w] = fmaf(xr, wr, yr[w]);
            yr[w] = fmaf(-xi, wi, yr[w]);
            yi[w] = fmaf(xr, wi, yi[w]);
            yi[w] = fmaf(xi, wr, yi[w]);
          }
        } else {
#pragma unroll
          for (int w = 0; w < kWinGroup; ++w) {
            yr[w] = fmaf(xr0[w * a.s + k], wr, yr[w]);
            yi[w] = fmaf(xi0[w * a.s + k], wr, yi[w]);
          }
        }
      }
#pragma unroll
      for (int w = 0; w < kWinGroup; ++w) {
        if (w < nw) {
          const long long o = out_row + static_cast<long long>(b0 + w) * a.g + i;
          if (a.q.bits) {
            store_packed(a.out_packed, o, yr[w], yi[w], a.q);
          } else {
            a.out_r[o] = yr[w];
            a.out_i[o] = yi[w];
          }
        }
      }
    }
  }
}

// Shared-memory bytes of one CTA.
inline size_t banded_smem_bytes(int k, int g, int s, int hist, bool cplx) {
  const size_t seg_cap = static_cast<size_t>(kWinGroup) * s + hist;
  return sizeof(float) * ((cplx ? 2 : 1) * static_cast<size_t>(k) * g +
                          2 * seg_cap) +
         sizeof(int) * g;
}

// Launch on `stream`; returns the launch's cudaError_t (0 on success).
int launch_banded(BandedArgs a, int channels, cudaStream_t stream) {
  if (channels <= 0 || a.s <= 0 || a.hist < 0 || a.g <= 0 || a.k <= 0 ||
      a.cols_per_warp < 1 || a.cols_per_warp > 32) {
    return cudaErrorInvalidValue;
  }
  a.nb = a.n / a.s;
  if (a.nb <= 0) return cudaErrorInvalidValue;
  const bool cplx = a.taps_i != nullptr;
  const size_t smem = banded_smem_bytes(a.k, a.g, a.s, a.hist, cplx);
  int dev = 0, sms = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (smem > static_cast<size_t>(smem_max)) return cudaErrorInvalidConfiguration;
  cudaError_t err =
      cplx ? cudaFuncSetAttribute(banded_kernel<true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))
           : cudaFuncSetAttribute(banded_kernel<false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem));
  if (err != cudaSuccess) return err;

  // warps of cols_per_warp columns; passes over G balanced so that one CTA
  // has <= kMaxThreads threads
  const int warps = (a.g + a.cols_per_warp - 1) / a.cols_per_warp;
  const int passes = (warps + kMaxThreads / 32 - 1) / (kMaxThreads / 32);
  const int threads = (warps + passes - 1) / passes * 32;
  // enough CTAs for a few waves, each owning whole window groups
  const int groups = (a.nb + kWinGroup - 1) / kWinGroup;
  int per_ch = (4 * sms + channels - 1) / channels;
  per_ch = per_ch < 1 ? 1 : (per_ch > groups ? groups : per_ch);
  a.win_per_cta = (groups + per_ch - 1) / per_ch * kWinGroup;
  const dim3 grid((a.nb + a.win_per_cta - 1) / a.win_per_cta, channels);
  if (cplx) {
    banded_kernel<true><<<grid, threads, smem, stream>>>(a);
  } else {
    banded_kernel<false><<<grid, threads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace iqk

extern "C" int iq_banded_apply(
    const float* xr, const float* xi, const void* wire, int kind, float norm,
    float gain, const long long* phase, unsigned dtheta, const float* st_r,
    const float* st_i, const int* first, const float* taps_r,
    const float* taps_i, int k, int cols_per_warp, int channels, int n, int s,
    int hist, int g,
    float* out_r, float* out_i, void* out_packed, int q_bits, int q_signed,
    float q_scale, float q_offset, float q_lo, float q_hi, void* stream) {
  iqk::BandedArgs a;
  a.xr = xr;
  a.xi = xi;
  a.wire = wire;
  a.kind = kind;
  a.norm = norm;
  a.gain = gain;
  a.phase = phase;
  a.dtheta = dtheta;
  a.st_r = st_r;
  a.st_i = st_i;
  a.first = first;
  a.taps_r = taps_r;
  a.taps_i = taps_i;
  a.k = k;
  a.cols_per_warp = cols_per_warp;
  a.n = n;
  a.s = s;
  a.hist = hist;
  a.g = g;
  a.nb = 0;
  a.win_per_cta = 0;
  a.out_r = out_r;
  a.out_i = out_i;
  a.out_packed = out_packed;
  a.q = iqk::PackParams{q_bits, q_signed, q_scale, q_offset, q_lo, q_hi};
  return iqk::launch_banded(a, channels, static_cast<cudaStream_t>(stream));
}
