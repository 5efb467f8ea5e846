// K4: the fused post stage, and the AGC's per-segment gains.
//
// * iq_post_apply replaces iq_tool_tpu/ops/pallas_kernels.py:post_apply
//   (_post_kernel): post-NCO mix, then the AGC gain (one per
//   `seg`-sample segment, or one per channel when seg == 0), then the
//   quantize-and-interleave to a packable wire, in one pass.  Samples past
//   the last whole segment take the last segment's gain, as the TPU
//   kernel's padded gains give them.  The TPU lays the gains out
//   (grid, C, seg_m) for Mosaic's block rule; here each thread indexes
//   the (C, n_seg) gains directly.
// * iq_agc_rms_gains is not a TPU kernel: it replaces the segment
//   energies and the lax.scan of iq_tool_tpu/ops/agc.py:rms_gains and
//   rms_scan, which XLA ran as a reduction and a loop.  A channel's block
//   may be `rows` consecutive rows (a time fold): the segments are laid
//   per row and the one chain runs over all of them in time order.
// * iq_agc_energies runs that kernel's producer warps alone: the
//   segment energies of a block, which the sharded chain's time shards
//   each compute and all-gather.
// * iq_agc_chain runs that kernel's gain loop alone, one thread a
//   channel over given energies in shared memory: the sharded chain's
//   gain loop over the gathered energies, and the timed floor of
//   iq_agc_rms_gains (chip_smoke.py's AGC bound).
//
// What bounds K4 on the card: bytes.  Per sample it reads two float32
// planes and writes one packed element (12 B for 16-bit wires); the
// gains are (C, N/128) and stay in L1/L2.  Design: a grid-stride
// elementwise pass, one sample per thread per step, the NCO and the
// epilogue from wire.cuh (shared with K2), so the kernel rounds exactly
// as its plain twin does (ops/kernels.py post_apply_ref) up to sin/cos.
//
// What bounds the AGC gains: the sequential chain of one channel's
// segments (two multiplies, the smoothing, a division, logf, expf and
// the clamp each), ~1500 a block; the planes' 8 B a sample are a second,
// smaller term.  Design: one CTA per channel.  Warp 0's first lane runs
// the chain from shared memory, in float32 with the reference's
// operation order and clamp, full-precision logf and expf; the other
// warps meanwhile compute the next chunk of segment energies (mean of
// xr^2 + xi^2, a warp a segment, coalesced loads and a shuffle sum) into
// the other half of a double buffer, and store the previous chunk's
// gains from shared memory, so the planes' reads hide under the chain.
// One barrier a chunk hands both buffers over.  With a target whose
// square is a power of two the chain's division is the multiplication by
// its exact reciprocal, which gives the same bits and takes the IEEE
// division off the chain (0.151 against 0.184 ms at config #4's shape
// on an H100).

#include <cuda_runtime.h>

#include "wire.cuh"

namespace iqk {

constexpr int kPostThreads = 256;
constexpr int kAgcThreads = 1024;
constexpr int kAgcWarps = kAgcThreads / 32;
constexpr int kAgcChunk = 64;        // segments a double-buffer half
// Warp 0 runs the chain.  Warps w and w + 4 share one of the SM's four
// schedulers, so the warps on warp 0's (w % 4 == 0) compute no energies:
// the chain's instructions never wait for an issue slot (measured slower
// with all 31 other warps computing energies)
constexpr int kAgcProducers = kAgcWarps - kAgcWarps / 4;

__device__ __forceinline__ bool agc_producer(int warp) { return (warp & 3) != 0; }

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

// One chunk's segment energies, mean(xr^2 + xi^2) over `seg` samples,
// a producer warp a segment (called by producer warps only).  Segment s
// is segment s % row_seg of row s / row_seg, rows n_row samples apart.
__device__ __forceinline__ void agc_energies(const float* __restrict__ xr,
                                             const float* __restrict__ xi,
                                             int seg, int row_seg, int n_row,
                                             int s_begin, int s_end,
                                             float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this producer's index among the warps with warp % 4 != 0
  for (int s = s_begin + warp - (warp >> 2) - 1; s < s_end; s += kAgcProducers) {
    const int r = s / row_seg;
    const long long base = static_cast<long long>(r) * n_row +
                           static_cast<long long>(s - r * row_seg) * seg;
    float acc = 0.0f;
#pragma unroll 4
    for (int i = lane; i < seg; i += 32) {
      const float r = xr[base + i];
      const float q = xi[base + i];
      acc = __fadd_rn(acc, __fadd_rn(__fmul_rn(r, r), __fmul_rn(q, q)));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    }
    if (lane == 0) out[s - s_begin] = __fdiv_rn(acc, static_cast<float>(seg));
  }
}

// The chain's constants: t2 = target^2, inv_t2 its exact reciprocal
// when t2 is a power of two (kPow2), else unused.
struct AgcConsts {
  float beta, one_m_beta, neg_half_beta, t2, inv_t2;
};

// One segment of the AGC's chain, in the reference's float32 order.
template <bool kPow2>
__device__ __forceinline__ void agc_step(float e, const AgcConsts& k, float* g,
                                         float* e2) {
  const float e_out = __fmul_rn(__fmul_rn(e, *g), *g);
  *e2 = __fadd_rn(__fmul_rn(k.one_m_beta, *e2), __fmul_rn(k.beta, e_out));
  const float m = fmaxf(*e2, 1e-16f);
  const float ratio = kPow2 ? __fmul_rn(m, k.inv_t2) : __fdiv_rn(m, k.t2);
  const float gn = __fmul_rn(*g, expf(__fmul_rn(k.neg_half_beta, logf(ratio))));
  // silence would drive g -> inf; clamp like a real AGC's gain range
  *g = fminf(fmaxf(gn, 1e-6f), 1e6f);
}

template <bool kPow2>
__global__ void __launch_bounds__(kAgcThreads)
    agc_rms_gains_kernel(const float* __restrict__ x_r,
                         const float* __restrict__ x_i, int n, int n_row,
                         int seg, int row_seg, int n_seg,
                         const float* __restrict__ gain0,
                         const float* __restrict__ e2_0, const AgcConsts kc,
                         float* __restrict__ gains,
                         float* __restrict__ gain_out,
                         float* __restrict__ e2_out) {
  __shared__ float energy[2][kAgcChunk];
  __shared__ float staged[2][kAgcChunk];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const float* xr = x_r + static_cast<long long>(c) * n;
  const float* xi = x_i + static_cast<long long>(c) * n;
  float* g_row = gains + static_cast<long long>(c) * n_seg;
  const int chunks = (n_seg + kAgcChunk - 1) / kAgcChunk;
  float g = 0.0f, e2 = 0.0f;
  if (tid == 0) {
    g = gain0[c];
    e2 = e2_0[c];
  }
  const bool producer = agc_producer(tid >> 5);
  if (producer) {
    agc_energies(xr, xi, seg, row_seg, n_row, 0, min(n_seg, kAgcChunk), energy[0]);
  }
  __syncthreads();
  for (int k = 0; k < chunks; ++k) {
    const int b = k & 1;
    if (tid == 0) {
      const int cnt = min(kAgcChunk, n_seg - k * kAgcChunk);
      const float* e_in = energy[b];
      float* g_out = staged[b];
      // the next energy is read a segment ahead, off the chain
      float e_next = e_in[0];
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        const float e = e_next;
        if (j + 1 < cnt) e_next = e_in[j + 1];
        agc_step<kPow2>(e, kc, &g, &e2);
        g_out[j] = g;
      }
    } else if (producer) {
      const int next = (k + 1) * kAgcChunk;
      if (next < n_seg) {
        agc_energies(xr, xi, seg, row_seg, n_row, next, min(n_seg, next + kAgcChunk),
                     energy[b ^ 1]);
      }
    }
    if (k > 0 && tid >= 32 && tid < 32 + kAgcChunk) {
      g_row[(k - 1) * kAgcChunk + tid - 32] = staged[b ^ 1][tid - 32];
    }
    __syncthreads();
  }
  const int last = (chunks - 1) * kAgcChunk;
  if (tid < n_seg - last) g_row[last + tid] = staged[(chunks - 1) & 1][tid];
  if (tid == 0) {
    gain_out[c] = g;
    e2_out[c] = e2;
  }
}

// The energies alone: channel c's (rows * row_seg) segment energies by
// the fused kernel's producer warps, written straight to global memory.
__global__ void __launch_bounds__(kAgcThreads)
    agc_energies_kernel(const float* __restrict__ x_r,
                        const float* __restrict__ x_i, int n, int n_row,
                        int seg, int row_seg, int n_seg,
                        float* __restrict__ energies) {
  const long long c = blockIdx.x;
  if (!agc_producer(threadIdx.x >> 5)) return;
  agc_energies(x_r + c * n, x_i + c * n, seg, row_seg, n_row, 0, n_seg,
               energies + c * n_seg);
}

constexpr int kChainThreads = 128;
constexpr int kChainChunk = 2048;    // energies staged at a time

// The chain alone: channel c's energies e (C, n_seg) through agc_step by
// one thread, from shared memory as in the fused kernel.
template <bool kPow2>
__global__ void __launch_bounds__(kChainThreads)
    agc_chain_kernel(const float* __restrict__ e, int n_seg,
                     const float* __restrict__ gain0,
                     const float* __restrict__ e2_0, const AgcConsts kc,
                     float* __restrict__ gains, float* __restrict__ gain_out,
                     float* __restrict__ e2_out) {
  __shared__ float energy[kChainChunk];
  const int c = blockIdx.x;
  const float* e_row = e + static_cast<long long>(c) * n_seg;
  float* g_row = gains + static_cast<long long>(c) * n_seg;
  float g = gain0[c], e2 = e2_0[c];
  for (int k0 = 0; k0 < n_seg; k0 += kChainChunk) {
    const int cnt = min(kChainChunk, n_seg - k0);
    for (int j = threadIdx.x; j < cnt; j += kChainThreads) energy[j] = e_row[k0 + j];
    __syncthreads();
    if (threadIdx.x == 0) {
      float e_next = energy[0];
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        const float en = e_next;
        if (j + 1 < cnt) e_next = energy[j + 1];
        agc_step<kPow2>(en, kc, &g, &e2);
        g_row[k0 + j] = g;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    gain_out[c] = g;
    e2_out[c] = e2;
  }
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

// The AGC's RMS gains of a block: x_r/x_i (C, n) planes, each channel's
// block `rows` rows of n / rows samples -> gains (C, rows * row_seg), row
// r's segments [k seg, (k + 1) seg) at r * row_seg + k, the final gain
// and e2 (C,), from gain0/e2_0 (C,).  inv_t2: t2's exact reciprocal when
// t2 is a power of two, else 0 (the chain divides).
extern "C" int iq_agc_rms_gains(const float* x_r, const float* x_i, int n,
                                int rows, int seg, int row_seg,
                                const float* gain0, const float* e2_0,
                                float beta, float one_m_beta,
                                float neg_half_beta, float t2, float inv_t2,
                                int channels, float* gains, float* gain_out,
                                float* e2_out, void* stream) {
  if (channels <= 0 || n <= 0 || rows <= 0 || n % rows || seg <= 0 ||
      row_seg <= 0 || static_cast<long long>(seg) * row_seg > n / rows) {
    return cudaErrorInvalidValue;
  }
  const int n_row = n / rows;
  const int n_seg = rows * row_seg;
  const iqk::AgcConsts kc{beta, one_m_beta, neg_half_beta, t2, inv_t2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (inv_t2 != 0.0f) {
    iqk::agc_rms_gains_kernel<true><<<channels, iqk::kAgcThreads, 0, st>>>(
        x_r, x_i, n, n_row, seg, row_seg, n_seg, gain0, e2_0, kc, gains,
        gain_out, e2_out);
  } else {
    iqk::agc_rms_gains_kernel<false><<<channels, iqk::kAgcThreads, 0, st>>>(
        x_r, x_i, n, n_row, seg, row_seg, n_seg, gain0, e2_0, kc, gains,
        gain_out, e2_out);
  }
  return cudaGetLastError();
}

// The AGC's segment energies of a block, as iq_agc_rms_gains computes
// them: x_r/x_i (C, n), each channel's block `rows` rows -> energies (C,
// rows * row_seg), laid out as that kernel's gains.
extern "C" int iq_agc_energies(const float* x_r, const float* x_i, int n,
                               int rows, int seg, int row_seg, int channels,
                               float* energies, void* stream) {
  if (channels <= 0 || n <= 0 || rows <= 0 || n % rows || seg <= 0 ||
      row_seg <= 0 || static_cast<long long>(seg) * row_seg > n / rows) {
    return cudaErrorInvalidValue;
  }
  iqk::agc_energies_kernel<<<channels, iqk::kAgcThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      x_r, x_i, n, n / rows, seg, row_seg, rows * row_seg, energies);
  return cudaGetLastError();
}

// The AGC's chain alone over given energies e (C, n_seg): gains (C,
// n_seg), the final gain and e2 (C,), from gain0/e2_0 (C,); inv_t2 as
// iq_agc_rms_gains takes it.
extern "C" int iq_agc_chain(const float* e, int n_seg, const float* gain0,
                            const float* e2_0, float beta, float one_m_beta,
                            float neg_half_beta, float t2, float inv_t2,
                            int channels, float* gains, float* gain_out,
                            float* e2_out, void* stream) {
  if (channels <= 0 || n_seg <= 0) return cudaErrorInvalidValue;
  const iqk::AgcConsts kc{beta, one_m_beta, neg_half_beta, t2, inv_t2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (inv_t2 != 0.0f) {
    iqk::agc_chain_kernel<true><<<channels, iqk::kChainThreads, 0, st>>>(
        e, n_seg, gain0, e2_0, kc, gains, gain_out, e2_out);
  } else {
    iqk::agc_chain_kernel<false><<<channels, iqk::kChainThreads, 0, st>>>(
        e, n_seg, gain0, e2_0, kc, gains, gain_out, e2_out);
  }
  return cudaGetLastError();
}
