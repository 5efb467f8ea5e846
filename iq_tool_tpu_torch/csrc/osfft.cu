// K5: overlap-save FFT filter, y = last outputs of ifft(fft(window) * H)
// per 2b-sample window of the tail-extended input ext = tail(b) ++ x.
//
// Replaces iq_tool_tpu/ops/pallas_kernels.py:osfft_apply
// (_osfft_kernel).  The TPU kernel runs a four-step DFT as 128-wide
// matmuls in 3-term split bf16 (the MXU is its engine); none of that is
// copied.  Here a cluster of CTAs owns one (channel, window) and runs the
// transform pair in float32 with the points in registers.
//
// What bounds it on the card: device memory, at ~5 N log2 N flops per
// transform against 8 B in and <= 8 B out per point.  A window of 16384
// complex points is 128 KiB: half the SM's register file, most of its
// shared memory.  So one window per SM leaves nothing to overlap a
// window's loads and stores with another's arithmetic; what the design
// does about it is to split each window over a cluster of CTAs.
//
// Design:
// * A window of N = C * Nl points (Nl <= 16384 and C = 1, 2 or 4: up
//   to N = 65536) runs on a cluster of C CTAs of Nl / 32
//   threads.  The first radix-C stage of the decimation in frequency is
//   taken while reading: CTA q reads the C sub-blocks of the window (L2
//   serves the repeats) and forms X_q[p] = W_N^(pq) sum_m x[p + m Nl]
//   W_C^(mq), whose Nl-point DFT holds the bins k = C k' + q.  Each CTA
//   then transforms its X_q alone: nothing crosses CTAs until the end.
//   (The one-CTA form of a 32768-point window, 1024 threads of 32 points
//   exchanging through 128 KiB in two halves, needs 64 registers of
//   points per thread where 1024 threads get 64 in all: it would spill.)
// * Radix 32 in registers.  Each thread holds 32 points; a pass does the
//   radix-2 decimation-in-frequency stages of 5 index bits on them (the
//   in-register twiddles exp(-2 pi i k / 32) sit in constant memory), then
//   one twiddle per point, and stores them back in place.  Nl = 2^Ll
//   takes ceil(Ll / 5) passes (the last covers the remaining bits), 3 each
//   way at Nl 8192 and 16384: 4 exchanges through shared memory per
//   transform pair, where a radix-2 form has 26.  The first pass reads
//   from device memory into registers and the last one writes from them.
// * No permutation pass.  The in-place decimation in frequency leaves the
//   spectrum in bit-reversed order; the host hands H/N in that order per
//   CTA, laid out so that thread t's 32 points are read coalesced
//   (h_k[q Nl + j Nl/32 + t] = H[C bitrev(32 t + j) + q] / N), and the
//   product is taken in registers between the forward's last pass and the
//   inverse's first, which share one layout.  The inverse is the exact
//   mirror: conjugate pass twiddles first, then decimation-in-time stages.
// * The last radix-C stage, y[p + m Nl] = sum_q W_C^(-mq) W_N^(-pq)
//   z_q[p], is the one exchange between CTAs: each CTA leaves its z_q in
//   its shared memory and CTA m reads the C values of its outputs through
//   distributed shared memory, 16 bytes at a time.
// * No bank conflicts.  Between passes the points lie in shared memory as
//   (re, im) pairs, one 8-byte access each, padded by one pair per 32
//   (index p -> p + p / 32): a pass's 32 points of one thread, 32 apart or
//   consecutive, then fall in distinct banks within each half-warp.
// * Pass twiddles exp(-2 pi i m / N) from two small tables in shared
//   memory, W(m) = hi[m >> B] * lo[m & (2^B - 1)] (B = log2(N) / 2; 3 KiB
//   at N 32768), built on the host in float64.  A thread reads the 5
//   powers W^(n2 2^b) of its pass and builds its 31 twiddles as products
//   of them along a bit tree: one complex product per twiddle, no
//   device-memory read per butterfly.
// * Two pointers in.  The carried tail and the block are read where they
//   lie: ext[e] is tail[e] for e < tail_len, else x[e - tail_len], so the
//   caller builds no concatenated copy.
//
// Windows come as a table: window w starts at ext[starts[w]] and emits
// its outputs j in [heads[w], N) to y[starts[w] + j - b].  The table
// holds the whole step's schedule: the 3/4-advance windows (heads b/2),
// the half-advance windows (heads b) and the re-anchored ragged last
// window, so one launch covers a block (ops/filters.py osfft_windows).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace iqk {

constexpr int kPts = 32;            // points per thread (radix 32)
constexpr int kMaxThreads = 512;    // Nl <= 16384
constexpr int kMaxClusterLog = 2;   // C <= 4: the quarter-turn radix-C stages

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

// z * exp(-+2 pi i k / 32) for a compile-time k (conjugate when kConj)
template <bool kConj>
__device__ __forceinline__ float2 rot32(float2 z, int k) {
  if (k == 0) return z;
  if (k == 8) return kConj ? make_float2(-z.y, z.x) : make_float2(z.y, -z.x);
  return kConj ? cmul_conj(z, kW32[k]) : cmul(z, kW32[k]);
}

// z * exp(-+2 pi i k / 4): k quarter turns, exact
template <bool kConj>
__device__ __forceinline__ float2 rot4(float2 z, int k) {
  switch (k & 3) {
    case 0: return z;
    case 1: return kConj ? make_float2(-z.y, z.x) : make_float2(z.y, -z.x);
    case 2: return make_float2(-z.x, -z.y);
    default: return kConj ? make_float2(z.y, -z.x) : make_float2(-z.y, z.x);
  }
}

// Decimation-in-frequency stages on bits NB-1 .. 0 of the register index.
template <int NB>
__device__ __forceinline__ void dif(float2 (&x)[kPts]) {
#pragma unroll
  for (int b = NB - 1; b >= 0; --b) {
#pragma unroll
    for (int j = 0; j < kPts; ++j) {
      if (j & (1 << b)) continue;
      const float2 u = x[j], v = x[j + (1 << b)];
      x[j] = cadd(u, v);
      x[j + (1 << b)] = rot32<false>(csub(u, v), (j & ((1 << b) - 1)) << (4 - b));
    }
  }
}

// Its mirror: decimation-in-time stages on bits 0 .. NB-1, conjugate
// twiddles.
template <int NB>
__device__ __forceinline__ void dit(float2 (&x)[kPts]) {
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int j = 0; j < kPts; ++j) {
      if (j & (1 << b)) continue;
      const float2 u = x[j];
      const float2 v = rot32<true>(x[j + (1 << b)], (j & ((1 << b) - 1)) << (4 - b));
      x[j] = cadd(u, v);
      x[j + (1 << b)] = csub(u, v);
    }
  }
}

__device__ __forceinline__ void dif_bits(float2 (&x)[kPts], int nb) {
  switch (nb) {
    case 1: dif<1>(x); break;
    case 2: dif<2>(x); break;
    case 3: dif<3>(x); break;
    case 4: dif<4>(x); break;
    default: dif<5>(x); break;
  }
}

__device__ __forceinline__ void dit_bits(float2 (&x)[kPts], int nb) {
  switch (nb) {
    case 1: dit<1>(x); break;
    case 2: dit<2>(x); break;
    case 3: dit<3>(x); break;
    case 4: dit<4>(x); break;
    default: dit<5>(x); break;
  }
}

__device__ __forceinline__ constexpr int brev5(int j) {
  return ((j & 1) << 4) | ((j & 2) << 2) | (j & 4) | ((j & 8) >> 2) | ((j & 16) >> 4);
}

// padded plane index
__device__ __forceinline__ int pad(int p) { return p + (p >> 5); }

struct OsfftArgs {
  const float* tail_r;  // (C, tail_len), ext's head; null when tail_len 0
  const float* tail_i;
  int tail_len;
  const float* x_r;  // (C, x_len), the rest of ext
  const float* x_i;
  long long x_len;
  const int* starts;  // (n_win,)
  const int* heads;   // (n_win,)
  const float2* h_k;  // (N,) H / N, per CTA in bit-reversed thread order
  const float2* tw_lo;  // (2^B,) exp(-2 pi i m / N)
  const float2* tw_hi;  // (2^(L-B),) exp(-2 pi i (m << B) / N)
  int tw_bits;          // B
  int log2n;            // L
  int log2c;            // log2 of the CTAs per window
  int block;
  float* out_r;  // (C, n_out)
  float* out_i;
  long long n_out;
};

struct Twiddles {
  const float2* lo;
  const float2* hi;
  int bits;
  // exp(-2 pi i m / N), m < N
  __device__ __forceinline__ float2 operator()(int m) const {
    return cmul(hi[m >> bits], lo[m & ((1 << bits) - 1)]);
  }
};

// x[brev5(K)] *= (or by the conjugate of) acc * prod of pw[b] over the
// set bits b < B of the rest of its index: a depth-first walk over the 5
// bits, one complex product per register.
template <bool kConj, int K, int B>
__device__ __forceinline__ void twiddle_tree(float2 (&x)[kPts], const float2 (&pw)[5],
                                             float2 acc) {
  if constexpr (B < 0) {
    if constexpr (K > 0) {
      x[brev5(K)] = kConj ? cmul_conj(x[brev5(K)], acc) : cmul(x[brev5(K)], acc);
    }
  } else {
    twiddle_tree<kConj, K, B - 1>(x, pw, acc);
    twiddle_tree<kConj, K | (1 << B), B - 1>(x, pw, K == 0 ? pw[B] : cmul(acc, pw[B]));
  }
}

// The pass twiddles of one thread: register j (frequency k1 = brev5(j)
// of the pass's radix-32 DFT) at in-block offset n2 of a sub-transform of
// 2^hi points takes exp(-+2 pi i n2 k1 / 2^hi) = W_N^((n2 k1) << shift),
// the product of the powers W_N^((n2 << b) << shift) over k1's set bits b
// (5 table reads a pass instead of 31; 4 products deep at most).
template <bool kConj>
__device__ __forceinline__ void pass_twiddles(float2 (&x)[kPts], int n2, int shift,
                                              const Twiddles& tw) {
  float2 pw[5];
#pragma unroll
  for (int b = 0; b < 5; ++b) pw[b] = tw((n2 << b) << shift);
  twiddle_tree<kConj, 0, 4>(x, pw, make_float2(1.0f, 0.0f));
}

template <bool kCluster>
__global__ void __launch_bounds__(kMaxThreads) osfft_kernel(const OsfftArgs a) {
  extern __shared__ float4 smem4[];
  const int L = a.log2n;
  const int lc = kCluster ? a.log2c : 0;
  const int cs = 1 << lc;
  const int ll = L - lc;
  const int nl = 1 << ll;  // points of this CTA's sub-transform
  const int bits = a.tw_bits;
  float2* tlo = reinterpret_cast<float2*>(smem4);
  float2* thi = tlo + (1 << bits);
  float2* z = thi + (1 << (L - bits));  // pad(nl) points
  const Twiddles tw{tlo, thi, bits};
  const int t = threadIdx.x;
  const int q = kCluster ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int s0 = nl / kPts;  // pass 0's point stride
  const int w = blockIdx.x >> lc;
  const int c = blockIdx.y;
  const int n_pass = (ll + 4) / 5;

  for (int i = t; i < (1 << bits); i += blockDim.x) tlo[i] = a.tw_lo[i];
  for (int i = t; i < (1 << (L - bits)); i += blockDim.x) thi[i] = a.tw_hi[i];

  // pass 0 reads the window: point p = t + j nl/32 of X_q, the C
  // sub-blocks' radix-C combination
  const long long start = a.starts[w];
  float2 x[kPts];
  {
    const long long tail_row = static_cast<long long>(c) * a.tail_len;
    const long long x_row = static_cast<long long>(c) * a.x_len - a.tail_len;
    // sub-block m's 32 points; past the tail (every window but the
    // first few) through one base pointer
    auto block_m = [&](int m, float2 (&v)[kPts]) {
      const long long e0 = start + t + static_cast<long long>(m) * nl;
      if (e0 >= a.tail_len) {
        const float* pr = a.x_r + x_row + e0;
        const float* pi = a.x_i + x_row + e0;
#pragma unroll
        for (int j = 0; j < kPts; ++j) v[j] = make_float2(pr[j * s0], pi[j * s0]);
      } else {
#pragma unroll
        for (int j = 0; j < kPts; ++j) {
          const long long e = e0 + j * s0;
          v[j] = e < a.tail_len ? make_float2(a.tail_r[tail_row + e], a.tail_i[tail_row + e])
                                : make_float2(a.x_r[x_row + e], a.x_i[x_row + e]);
        }
      }
    };
    block_m(0, x);
    for (int m = 1; m < cs; ++m) {
      const int k4 = ((m * q) & (cs - 1)) << (kMaxClusterLog - lc);
      float2 v[kPts];
      block_m(m, v);
#pragma unroll
      for (int j = 0; j < kPts; ++j) x[j] = cadd(x[j], rot4<false>(v[j], k4));
    }
  }
  __syncthreads();  // the tables are staged
  if (kCluster) {
#pragma unroll
    for (int j = 0; j < kPts; ++j) x[j] = cmul(x[j], tw((t + j * s0) * q));
  }

  dif<5>(x);
  pass_twiddles<false>(x, t, lc, tw);
#pragma unroll
  for (int j = 0; j < kPts; ++j) {
    const int o = pad(t + j * s0);
    z[o] = x[j];
  }
  __syncthreads();

  // the middle passes
  for (int pass = 1; pass < n_pass - 1; ++pass) {
    const int hi = ll - 5 * pass, lo = hi - 5;
    const int n2 = t & ((1 << lo) - 1);
    const int p0 = ((t >> lo) << hi) + n2;
#pragma unroll
    for (int j = 0; j < kPts; ++j) {
      const int o = pad(p0 + (j << lo));
      x[j] = z[o];
    }
    dif<5>(x);
    pass_twiddles<false>(x, n2, ll - hi + lc, tw);
#pragma unroll
    for (int j = 0; j < kPts; ++j) {
      const int o = pad(p0 + (j << lo));
      z[o] = x[j];
    }
    __syncthreads();
  }

  // the last pass: 32 consecutive points of the bit-reversed spectrum,
  // times H/N, and back through the inverse's first pass
  {
    const int nb = ll - 5 * (n_pass - 1);
    const int p0 = t * kPts;
#pragma unroll
    for (int j = 0; j < kPts; ++j) x[j] = z[pad(p0 + j)];
    dif_bits(x, nb);
    const float2* h = a.h_k + q * nl + t;
#pragma unroll
    for (int j = 0; j < kPts; ++j) x[j] = cmul(x[j], __ldg(h + j * s0));
    dit_bits(x, nb);
#pragma unroll
    for (int j = 0; j < kPts; ++j) {
      z[pad(p0 + j)] = x[j];
    }
    __syncthreads();
  }

  for (int pass = n_pass - 2; pass >= 1; --pass) {
    const int hi = ll - 5 * pass, lo = hi - 5;
    const int n2 = t & ((1 << lo) - 1);
    const int p0 = ((t >> lo) << hi) + n2;
#pragma unroll
    for (int j = 0; j < kPts; ++j) {
      const int o = pad(p0 + (j << lo));
      x[j] = z[o];
    }
    pass_twiddles<true>(x, n2, ll - hi + lc, tw);
    dit<5>(x);
#pragma unroll
    for (int j = 0; j < kPts; ++j) {
      const int o = pad(p0 + (j << lo));
      z[o] = x[j];
    }
    __syncthreads();
  }

  // the inverse's pass 0
#pragma unroll
  for (int j = 0; j < kPts; ++j) {
    const int o = pad(t + j * s0);
    x[j] = z[o];
  }
  pass_twiddles<true>(x, t, lc, tw);
  dit<5>(x);
  const int head = a.heads[w];
  const long long o0 = start - a.block + static_cast<long long>(c) * a.n_out;
  if (!kCluster) {
#pragma unroll
    for (int j = 0; j < kPts; ++j) {
      const int p = t + j * s0;
      if (p >= head) {
        a.out_r[o0 + p] = x[j].x;
        a.out_i[o0 + p] = x[j].y;
      }
    }
    return;
  }

  // the last radix-C stage: z_q[p] W_N^(-pq) into this CTA's points
  // (unpadded, for 16-byte reads), then CTA m forms the outputs
  // y[p + m nl] = sum_q W_C^(-mq) (z_q W_N^(-pq))[p] from all C CTAs'
  __syncthreads();  // every thread has read the padded points
#pragma unroll
  for (int j = 0; j < kPts; ++j) {
    const int p = t + j * s0;
    z[p] = cmul_conj(x[j], tw(p * q));
  }
  cg::this_cluster().sync();
  for (int p = 2 * t; p < nl; p += 2 * blockDim.x) {
    float2 y0 = make_float2(0.0f, 0.0f), y1 = y0;
    for (int r = 0; r < cs; ++r) {
      const float4 v =
          *reinterpret_cast<const float4*>(cg::this_cluster().map_shared_rank(z + p, r));
      const int k4 = ((q * r) & (cs - 1)) << (kMaxClusterLog - lc);
      y0 = cadd(y0, rot4<true>(make_float2(v.x, v.y), k4));
      y1 = cadd(y1, rot4<true>(make_float2(v.z, v.w), k4));
    }
    const int pg = p + q * nl;  // position in the window
    if (pg >= head) {
      a.out_r[o0 + pg] = y0.x;
      a.out_i[o0 + pg] = y0.y;
    }
    if (pg + 1 >= head) {
      a.out_r[o0 + pg + 1] = y1.x;
      a.out_i[o0 + pg + 1] = y1.y;
    }
  }
  // keep this CTA's shared memory until the cluster has read it
  cg::this_cluster().sync();
}

inline size_t osfft_smem_bytes(int log2n, int bits, int log2c) {
  const size_t nl = static_cast<size_t>(1) << (log2n - log2c);
  return sizeof(float2) * ((static_cast<size_t>(1) << bits) +
                           (static_cast<size_t>(1) << (log2n - bits))) +
         sizeof(float2) * (nl + nl / 32);
}

}  // namespace iqk

// Launch on `stream`; returns the launch's cudaError_t (0 on success).
extern "C" int iq_osfft_apply(const float* tail_r, const float* tail_i, int tail_len,
                              const float* x_r, const float* x_i, long long x_len,
                              int channels, const int* starts, const int* heads,
                              int n_win, const void* h_k, const void* tw_lo,
                              const void* tw_hi, int tw_bits, int log2n, int log2c,
                              int block, float* out_r, float* out_i, long long n_out,
                              void* stream) {
  using namespace iqk;
  const int ll = log2n - log2c;
  if (channels <= 0 || n_win <= 0 || tail_len < 0 || block < 0 || log2c < 0 ||
      log2c > kMaxClusterLog || ll < 10 || (1 << ll) / kPts > kMaxThreads ||
      tw_bits < 1 || tw_bits >= log2n) {
    return cudaErrorInvalidValue;
  }
  const int cs = 1 << log2c;
  const int threads = (1 << ll) / kPts;
  const size_t smem = osfft_smem_bytes(log2n, tw_bits, log2c);
  OsfftArgs a{tail_r, tail_i, tail_len, x_r, x_i, x_len, starts, heads,
              static_cast<const float2*>(h_k), static_cast<const float2*>(tw_lo),
              static_cast<const float2*>(tw_hi), tw_bits, log2n, log2c, block,
              out_r, out_i, n_out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cs == 1) {
    err = cudaFuncSetAttribute(osfft_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    osfft_kernel<false><<<dim3(n_win, channels), threads, smem, st>>>(a);
    return cudaGetLastError();
  }
  err = cudaFuncSetAttribute(osfft_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_win * cs, channels);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, osfft_kernel<true>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
