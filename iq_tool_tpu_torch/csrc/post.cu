// K4: the fused post stage, and the AGC's per-segment gain scan.
//
// * iq_post_apply replaces iq_tool_tpu/ops/pallas_kernels.py:post_apply
//   (_post_kernel): post-NCO mix, then the AGC gain (one per
//   `seg`-sample segment, or one per channel when seg == 0), then the
//   quantize-and-interleave to a packable wire, in one pass.  Samples past
//   the last whole segment take the last segment's gain, as the TPU
//   kernel's padded gains give them.  The TPU lays the gains out
//   (grid, C, seg_m) for Mosaic's block rule; here each thread indexes
//   the (C, n_seg) gains directly.
// * iq_agc_rms_scan is not a TPU kernel: it replaces the lax.scan of
//   iq_tool_tpu/ops/agc.py:rms_scan, which XLA ran as a loop.  One block
//   has ~1500 sequential segments, and a loop of torch ops on the card
//   would be several launches per segment, so the loop is one thread per
//   channel here, in float32 with the reference's operation order and
//   clamp.
//
// What bounds K4 on the card: bytes.  Per sample it reads two float32
// planes and writes one packed element (12 B for 16-bit wires); the
// gains are (C, N/128) and stay in L1/L2.  Design: a grid-stride
// elementwise pass, one sample per thread per step, the NCO and the
// epilogue from wire.cuh (shared with K2), so the kernel rounds exactly
// as its plain twin does (ops/kernels.py post_apply_ref) up to sin/cos.
//
// The scan is bound by its sequential dependency (log, exp per segment):
// a warp of channels reads one (n_seg, C) row per step, coalesced.

#include <cuda_runtime.h>

#include "wire.cuh"

namespace iqk {

constexpr int kPostThreads = 256;
constexpr int kScanThreads = 128;

__global__ void __launch_bounds__(kPostThreads)
    post_kernel(const float* x_r, const float* x_i, const float* gains,
                int seg, int n_seg, const long long* phase, unsigned dtheta,
                int n, void* out, PackParams q) {
  const int c = blockIdx.y;
  const long long row0 = static_cast<long long>(c) * n;
  const unsigned ph0 = dtheta ? static_cast<unsigned>(phase[c]) : 0u;
  const float* g_row = gains + static_cast<long long>(c) * (seg ? n_seg : 1);
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < n; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    float yr = x_r[row0 + idx];
    float yi = x_i[row0 + idx];
    if (dtheta) nco_rotate(ph0, dtheta, idx, &yr, &yi);
    int k = 0;
    if (seg) {
      k = static_cast<int>(idx / seg);
      if (k > n_seg - 1) k = n_seg - 1;
    }
    const float g = g_row[k];
    store_packed(out, row0 + idx, __fmul_rn(yr, g), __fmul_rn(yi, g), q);
  }
}

__global__ void __launch_bounds__(kScanThreads)
    agc_rms_scan_kernel(const float* e_in, const float* gain0,
                        const float* e2_0, float beta, float one_m_beta,
                        float neg_half_beta, float t2, int n_seg, int channels,
                        float* gains, float* gain_out, float* e2_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= channels) return;
  float g = gain0[c];
  float e2 = e2_0[c];
  for (int k = 0; k < n_seg; ++k) {
    const float e = e_in[static_cast<long long>(k) * channels + c];
    const float e_out = __fmul_rn(__fmul_rn(e, g), g);
    e2 = __fadd_rn(__fmul_rn(one_m_beta, e2), __fmul_rn(beta, e_out));
    const float ratio = __fdiv_rn(fmaxf(e2, 1e-16f), t2);
    g = __fmul_rn(g, expf(__fmul_rn(neg_half_beta, logf(ratio))));
    // silence would drive g -> inf; clamp like a real AGC's gain range
    g = fminf(fmaxf(g, 1e-6f), 1e6f);
    gains[static_cast<long long>(k) * channels + c] = g;
  }
  gain_out[c] = g;
  e2_out[c] = e2;
}

}  // namespace iqk

// K4.  gains: (C, n_seg) when seg > 0, else (C, 1).  Launch on `stream`;
// returns the launch's cudaError_t (0 on success).
extern "C" int iq_post_apply(const float* x_r, const float* x_i,
                             const float* gains, int seg, int n_seg,
                             const long long* phase, unsigned dtheta,
                             int channels, int n, void* out, int q_bits,
                             int q_signed, float q_scale, float q_offset,
                             float q_lo, float q_hi, void* stream) {
  if (channels <= 0 || n <= 0 || seg < 0 || (seg && n_seg <= 0) ||
      (dtheta && !phase) || (q_bits != 8 && q_bits != 16)) {
    return cudaErrorInvalidValue;
  }
  const long long want = (n + iqk::kPostThreads - 1) / iqk::kPostThreads;
  const int blocks_x = static_cast<int>(want < 1024 ? want : 1024);
  const dim3 grid(blocks_x, channels);
  iqk::post_kernel<<<grid, iqk::kPostThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      x_r, x_i, gains, seg, n_seg, phase, dtheta, n, out,
      iqk::PackParams{q_bits, q_signed, q_scale, q_offset, q_lo, q_hi});
  return cudaGetLastError();
}

// The AGC scan.  e_in and gains are (n_seg, C); gain0/e2_0 and the
// outputs gain_out/e2_out are (C,).
extern "C" int iq_agc_rms_scan(const float* e_in, const float* gain0,
                               const float* e2_0, float beta,
                               float one_m_beta, float neg_half_beta,
                               float t2, int n_seg, int channels,
                               float* gains, float* gain_out, float* e2_out,
                               void* stream) {
  if (channels <= 0 || n_seg <= 0) return cudaErrorInvalidValue;
  const int blocks = (channels + iqk::kScanThreads - 1) / iqk::kScanThreads;
  iqk::agc_rms_scan_kernel<<<blocks, iqk::kScanThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      e_in, gain0, e2_0, beta, one_m_beta, neg_half_beta, t2, n_seg,
      channels, gains, gain_out, e2_out);
  return cudaGetLastError();
}
