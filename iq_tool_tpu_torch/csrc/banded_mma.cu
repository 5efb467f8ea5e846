// K2 on the sm_80 product core: the same strided-window banded map as
// csrc/banded.cu's K2, y = windows(state ++ x; stride s, length s + hist)
// @ A, with products on mma.sync.  It replaces the same Pallas kernels
// (iq_tool_tpu/ops/pallas_kernels.py:banded_apply: _banded_kernel,
// _banded_kernel_complex, _shift_kernel, _shift_kernel_complex) at the
// geometries the rule in ops/kernels.py banded_core() gives it: K2 over a
// narrow band (fewer than 96 non-zero taps a column: stage 0 of every
// configuration, stage 1 without the composed lowpass, the NRSC5 stages,
// FIRs of fewer taps), where on an H100 this core measured 10-22 % faster
// than the wgmma core (PERF.md).  K1's banded launch always takes the
// wgmma core.
//
// What bounds it: the bytes (the input planes or wire read once, the
// output written once); the products are cheap on the tensor cores and the
// limit is the instructions that feed them: loading, splitting and
// addressing the A operand, which the design spends on as few products as
// it can.
//
// Design:
// * Products on the tensor cores in 3xTF32: mma.sync.m16n8k8 with M = 16
//   windows, N = 8 consecutive output columns, K = 8 rows of the column
//   tile's band span.  Each operand is split x = x_hi + x_lo into TF32
//   values (split() below) and y += x_lo*a_hi + x_hi*a_lo + x_hi*a_hi is
//   accumulated in FP32: about 2^-21 relative per product.
// * Column tiles.  The host cuts A into tiles of 16 columns (two mma
//   n-blocks, so that each A fragment, loaded and split once, feeds six
//   products); a tile's span starts at the lowest first band row of its
//   columns (rounded down to even) and is `span` rows long, so tile t
//   computes y[b, 16t + j] = sum_r ext[b*s + first[t] + r] * B_t[r, j]
//   exactly.  B_t lies in device memory in fragment order, unsplit
//   (Band.build's frag_r/frag_i), one 16-byte load per lane and chunk,
//   reused for both planes; the loads run kPf chunks ahead of the
//   products.  Complex taps stack [x_r, x_i] against [[a_r, a_i], [-a_i,
//   a_r]]: four products per chunk and n-block.
// * Paired k.  Lane (gid, tig) holds k = 2 tig and 2 tig + 1 (where the
//   mma's layout names tig and tig + 4) in both A and B: the two A values
//   are adjacent in the staged span and, for an even stride, come in one
//   8-byte load.
// * Staging.  A CTA walks a contiguous run of (channel, 16-window group)
//   items; each group's input span (16 s + hist + span samples) is staged
//   in shared memory as two float planes.  Planar input: two buffers of
//   planes, the next group's span copied with cp.async while the current
//   one is multiplied.  Packed-wire input: one buffer of planes and a
//   separate raw buffer (stage_raw): while a group is multiplied, cp.async
//   copies the next group's raw wire into it (16-byte copies from the
//   group's first 16-byte aligned byte, landed at the same alignment; the
//   few elements of the unaligned head and tail are loaded into registers
//   and stored after the products), its carried history (4-byte copies)
//   and the channel's NCO phase; after the products one pass (decode())
//   decodes and NCO-mixes each staged sample from shared memory into the
//   planes, with wire.cuh's helpers, so the planes hold the floats a
//   per-sample load would give, bit for bit.  The raw buffer takes less
//   than the second buffer of planes it replaces, so a wire launch never
//   takes less occupancy than a planar one.  The planes are zeroed once,
//   so a span's read-ahead past the group's samples (multiplied by B's
//   zeros) reads finite values.
// * Bank conflicts.  The span is staged as rows of s samples at a pitch of
//   s + skew words, the skew (0-15) making the pitch 8 mod 16: the 4 rows
//   of a half-warp's 8-byte loads start 8, 24, 40, 56 words apart mod 32
//   and each row's 4 lanes read 8 consecutive words, 32 distinct banks.
// * Balance.  The grid is one wave of CTAs (occupancy x SMs), each taking
//   an equal share of the C * groups items.  Three CTAs of 256 threads
//   share an SM where their staging buffers fit (registers capped to fit
//   three), else two, else one CTA of 512 threads.

#include <cuda_runtime.h>

#include "wire.cuh"

namespace iqk {
namespace mma {

constexpr int kWin = 16;  // windows per group (mma M)
constexpr int kNb = 2;    // 8-column n-blocks per tile
constexpr int kPf = 4;    // chunks of B fragments loaded ahead

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
  const float4* taps_r;   // (n_tiles, span / 8, 32) B fragments per lane
  const float4* taps_i;   // the same for the imaginary taps, or null
  const int* tile_first;  // (n_tiles,) first span row of each tile, even
  int n_tiles;
  int span;  // rows of every tile's span, a multiple of 8
  int n, s, hist, g, nb;
  int pitch;    // staged row pitch: s + skew, 8 mod 16
  int buf_len;  // floats per staged plane
  int groups;   // window groups per channel
  long long items;  // channels * groups
  float* out_r;  // (C, nb*G) planar output, or
  float* out_i;
  void* out_packed;  // (C, nb*G) packed wire output when q.bits != 0
  PackParams q;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// Wait until at most the latest committed group is in flight.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage windows [b0, b0 + nw) of channel c from planar input: ext[b0*s +
// e] for e < nw*s + hist at row e / s, column e % s of the padded planes.
__device__ void stage(const BandedArgs& a, int c, int b0, int nw, float* seg_r, float* seg_i) {
  const int len = nw * a.s + a.hist;
  const int rows = (len + a.s - 1) / a.s;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const long long e0 = static_cast<long long>(b0) * a.s;
  for (int q = threadIdx.x >> 5; q < rows; q += nwarps) {
    const int u_end = min(a.s, len - q * a.s);
    for (int u = lane; u < u_end; u += 32) {
      const long long e = e0 + static_cast<long long>(q) * a.s + u;
      const int o = q * a.pitch + u;
      const bool st = e < a.hist;
      const long long idx = st ? static_cast<long long>(c) * a.hist + e
                               : static_cast<long long>(c) * a.n + (e - a.hist);
      cp_async4(seg_r + o, (st ? a.st_r : a.xr) + idx);
      cp_async4(seg_i + o, (st ? a.st_i : a.xi) + idx);
    }
  }
}

// Bytes of a packed element: an int32 for 16-bit kinds, an int16 for 8-bit.
__host__ __device__ inline int wire_elem(int kind) {
  return kind == kCs16 || kind == kCu16 ? 4 : 2;
}

// The raw buffer of a wire launch holds one group: the channel's NCO
// phase (bytes 0-7), the carried history's e_w samples of each plane from
// byte 16, then the wire's cnt elements from the next 16-byte boundary
// plus the source's offset within 16 bytes, so that both sides of each
// 16-byte copy are aligned.  The largest group (e_w = hist, or 16 s + hist
// wire elements) fits in raw_bytes(), which is less than the 8 buf_len
// bytes of the second buffer of planes a wire launch goes without.
__host__ __device__ inline int raw_bytes(int s, int hist, int kind) {
  return (16 + 8 * hist + 15 + 15 + wire_elem(kind) * kWin * s + 15) / 16 * 16;
}

// A group's place in the raw buffer and in its channel's wire.
struct RawGroup {
  int len;        // staged samples: nw s + hist
  int e_w;        // of which carried history (e < e_w)
  long long i0;   // wire index of the first wire sample (staged at e_w)
  int cnt;        // wire samples: len - e_w
  const char* src;  // its packed element in global memory
  int mis;        // src's byte offset within 16 bytes
  int wire_at;    // its byte in the raw buffer, at the same offset
};

__device__ __forceinline__ RawGroup raw_group(const BandedArgs& a, int c, int b0, int nw) {
  RawGroup g;
  g.len = nw * a.s + a.hist;
  const long long e0 = static_cast<long long>(b0) * a.s;
  g.e_w = static_cast<int>(max(0LL, min(static_cast<long long>(g.len), a.hist - e0)));
  g.i0 = e0 + g.e_w - a.hist;
  g.cnt = g.len - g.e_w;
  const int elem = wire_elem(a.kind);
  g.src = static_cast<const char*>(a.wire) + (static_cast<long long>(c) * a.n + g.i0) * elem;
  g.mis = static_cast<int>(reinterpret_cast<size_t>(g.src) & 15);
  g.wire_at = 16 + (8 * g.e_w + 15) / 16 * 16 + g.mis;
  return g;
}

// A head or tail element of a group's wire, loaded into a register while
// the group before is multiplied and stored into the raw buffer after.
struct Pending {
  int at = -1;  // byte in the raw buffer, or -1
  int v = 0;

  __device__ __forceinline__ void store(char* raw, int elem) {
    if (at < 0) return;
    if (elem == 4) {
      *reinterpret_cast<int*>(raw + at) = v;
    } else {
      *reinterpret_cast<short*>(raw + at) = static_cast<short>(v);
    }
    at = -1;
  }
};

// Start the copies of group (c, b0, nw)'s raw input into `raw`: the
// wire's 16-byte aligned body by cp.async, the carried history and the
// NCO phase by cp.async, the head and tail elements into `pend`.
__device__ void stage_raw(const BandedArgs& a, int c, int b0, int nw, char* raw, Pending& pend) {
  const RawGroup g = raw_group(a, c, b0, nw);
  const int elem = wire_elem(a.kind);
  if (threadIdx.x == 0 && a.dtheta) cp_async8(raw, a.phase + c);
  float* hist = reinterpret_cast<float*>(raw + 16);
  const long long st0 = static_cast<long long>(c) * a.hist + static_cast<long long>(b0) * a.s;
  for (int e = threadIdx.x; e < g.e_w; e += blockDim.x) {
    cp_async4(hist + e, a.st_r + st0 + e);
    cp_async4(hist + g.e_w + e, a.st_i + st0 + e);
  }
  char* dst = raw + g.wire_at;
  const int head = min(g.cnt, ((16 - g.mis) & 15) / elem);
  const int chunks = (g.cnt - head) * elem / 16;
  const int tail = head + chunks * (16 / elem);
  for (int k = threadIdx.x; k < chunks; k += blockDim.x) {
    cp_async16(dst + head * elem + 16 * k, g.src + head * elem + 16 * k);
  }
  // head elements [0, head) and tail elements [tail, cnt): one a thread
  const int tid = threadIdx.x;
  const int j = tid < head ? tid : tail + tid - head;
  if (j < g.cnt) {
    pend.at = g.wire_at + j * elem;
    pend.v = elem == 4 ? reinterpret_cast<const int*>(g.src)[j]
                       : static_cast<int>(reinterpret_cast<const short*>(g.src)[j]);
  }
}

// Stage group (c, b0, nw) from the raw buffer into the planes: sample e
// at row e / s, column e % s, the history as copied, the wire decoded and
// NCO-mixed at its index (wire.cuh).
__device__ void decode(const BandedArgs& a, int c, int b0, int nw, const char* raw,
                       float* seg_r, float* seg_i) {
  const RawGroup g = raw_group(a, c, b0, nw);
  const float* hist = reinterpret_cast<const float*>(raw + 16);
  const char* w = raw + g.wire_at;
  const bool wide = wire_elem(a.kind) == 4;
  const unsigned phase0 =
      a.dtheta ? static_cast<unsigned>(*reinterpret_cast<const long long*>(raw)) : 0u;
  const int step = blockDim.x;
  const int dq = step / a.s, du = step - dq * a.s;
  int q = threadIdx.x / a.s, u = threadIdx.x - q * a.s;
  for (int e = threadIdx.x; e < g.len; e += step) {
    float vr, vi;
    if (e < g.e_w) {
      vr = hist[e];
      vi = hist[g.e_w + e];
    } else {
      const int j = e - g.e_w;
      const int v = wide ? reinterpret_cast<const int*>(w)[j]
                         : static_cast<int>(reinterpret_cast<const short*>(w)[j]);
      wire_decode_value(v, a.kind, a.norm, a.gain, &vr, &vi);
      if (a.dtheta) nco_rotate(phase0, a.dtheta, g.i0 + j, &vr, &vi);
    }
    const int o = q * a.pitch + u;
    seg_r[o] = vr;
    seg_i[o] = vi;
    u += du;
    q += dq;
    if (u >= a.s) {
      u -= a.s;
      ++q;
    }
  }
}

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away, as
// cvt.rna.tf32.f32, in two integer operations instead of the conversion
// unit's quarter rate); lo = x - hi is exact in float32, and the tensor
// cores read its top 19 bits (sign, exponent, 10 mantissa bits)
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct SplitB {
  unsigned h0, h1, l0, l1;
};

__device__ __forceinline__ SplitB split_b(float b0, float b1) {
  SplitB r;
  split(b0, r.h0, r.l0);
  split(b1, r.h1, r.l1);
  return r;
}

__device__ __forceinline__ SplitB negate(const SplitB& b) {
  return SplitB{b.h0 ^ 0x80000000u, b.h1 ^ 0x80000000u, b.l0 ^ 0x80000000u,
                b.l1 ^ 0x80000000u};
}

// d += x * b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const unsigned (&xh)[4],
                                     const unsigned (&xl)[4], const SplitB& b) {
  mma_tf32(d, xl, b.h0, b.h1);
  mma_tf32(d, xh, b.l0, b.l1);
  mma_tf32(d, xh, b.h0, b.h1);
}

// (q, r) = divmod(x, s) -> divmod(x + 8, s)
__device__ __forceinline__ void step8(int& q, int& r, int s) {
  r += 8;
  if (r >= s) {
    r -= s;
    ++q;
    if (r >= s) {  // strides below 8 only
      q += r / s;
      r %= s;
    }
  }
}

// The A fragment of one plane, split: rows gid (at o) and gid + 8 (at
// o + p8), k = 2 tig and 2 tig + 1 at o and o_next (o + 1 unless the pair
// straddles a staged row, which only an odd stride allows).
template <bool kPair>
__device__ __forceinline__ void load_a(const float* seg, int o, int o_next, int p8,
                                       unsigned (&h)[4], unsigned (&l)[4]) {
  float v0, v1, v2, v3;
  if (kPair) {
    const float2 top = *reinterpret_cast<const float2*>(seg + o);
    const float2 bot = *reinterpret_cast<const float2*>(seg + o + p8);
    v0 = top.x;
    v2 = top.y;
    v1 = bot.x;
    v3 = bot.y;
  } else {
    v0 = seg[o];
    v2 = seg[o_next];
    v1 = seg[o + p8];
    v3 = seg[o_next + p8];
  }
  split(v0, h[0], l[0]);
  split(v1, h[1], l[1]);
  split(v2, h[2], l[2]);
  split(v3, h[3], l[3]);
}

template <bool kComplex, bool kPair, bool kWire, int kThreads, int kMinCtas>
__global__ void __launch_bounds__(kThreads, kMinCtas) banded_mma_kernel(const BandedArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const long long i_begin = a.items * blockIdx.x / gridDim.x;
  const long long i_end = a.items * (blockIdx.x + 1) / gridDim.x;
  const int n_chunks = a.span >> 3;
  const int p8 = 8 * a.pitch;
  const int gp = gid * a.pitch;
  // packed wire: one buffer of planes, then the raw buffer
  char* raw = reinterpret_cast<char*>(smem + 2 * a.buf_len);
  const int elem = kWire ? wire_elem(a.kind) : 0;
  Pending pend;

  for (int i = threadIdx.x; i < (kWire ? 2 : 4) * a.buf_len; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();
  if (i_begin < i_end) {
    const int c = static_cast<int>(i_begin / a.groups);
    const int b0 = static_cast<int>(i_begin % a.groups) * kWin;
    if constexpr (kWire) {
      stage_raw(a, c, b0, min(kWin, a.nb - b0), raw, pend);
    } else {
      stage(a, c, b0, min(kWin, a.nb - b0), smem, smem + a.buf_len);
    }
  }
  cp_async_commit();

  int buf = 0;
  for (long long item = i_begin; item < i_end; ++item, buf ^= 1) {
    const int c = static_cast<int>(item / a.groups);
    const int b0 = static_cast<int>(item % a.groups) * kWin;
    const int b_end = min(b0 + kWin, a.nb);
    const bool more = item + 1 < i_end;
    const int cn = static_cast<int>((item + 1) / a.groups);
    const int bn = static_cast<int>((item + 1) % a.groups) * kWin;
    if constexpr (kWire) {
      // this group's raw input has landed (the products before hid the
      // copies); decode it into the planes, then start the next group's
      pend.store(raw, elem);
      cp_async_wait_all();
      __syncthreads();
      decode(a, c, b0, b_end - b0, raw, smem, smem + a.buf_len);
      __syncthreads();
      if (more) stage_raw(a, cn, bn, min(kWin, a.nb - bn), raw, pend);
      cp_async_commit();
    } else {
      if (more) {
        float* nxt = smem + (buf ^ 1) * 2 * a.buf_len;
        stage(a, cn, bn, min(kWin, a.nb - bn), nxt, nxt + a.buf_len);
      }
      cp_async_commit();
      cp_async_wait_prior();
      __syncthreads();
    }
    const float* seg_r = smem + (kWire ? 0 : buf * 2 * a.buf_len);
    const float* seg_i = seg_r + a.buf_len;

    for (int t = warp; t < a.n_tiles; t += nwarps) {
      float acc[kNb][2][4];
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          acc[nb][0][v] = 0.0f;
          acc[nb][1][v] = 0.0f;
        }
      }
      // span row x = f0 + 8 kc + 2 tig sits at (x / s) * pitch + x % s,
      // plus gid * pitch for this lane's window; (q, r) walks up the span
      // (and (q1, r1) for x + 1 where pairs may straddle rows)
      const int f0 = a.tile_first[t] + 2 * tig;
      int q0 = f0 / a.s, r0 = f0 - q0 * a.s;
      int q1 = (f0 + 1) / a.s, r1 = f0 + 1 - q1 * a.s;
      const float4* br = a.taps_r + static_cast<long long>(t) * n_chunks * 32 + lane;
      const float4* bi =
          kComplex ? a.taps_i + static_cast<long long>(t) * n_chunks * 32 + lane : br;
      // B fragments kPf chunks ahead, so that their loads overlap the
      // products of the chunks before
      float4 bq_r[kPf], bq_i[kPf];
#pragma unroll
      for (int j = 0; j < kPf; ++j) {
        bq_r[j] = j < n_chunks ? __ldg(br + j * 32) : make_float4(0.f, 0.f, 0.f, 0.f);
        if (kComplex) {
          bq_i[j] = j < n_chunks ? __ldg(bi + j * 32) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      for (int kc0 = 0; kc0 < n_chunks; kc0 += kPf) {
        float4 nq_r[kPf], nq_i[kPf];
#pragma unroll
        for (int j = 0; j < kPf; ++j) {
          const int kn = kc0 + kPf + j;
          nq_r[j] = kn < n_chunks ? __ldg(br + kn * 32) : make_float4(0.f, 0.f, 0.f, 0.f);
          if (kComplex) {
            nq_i[j] = kn < n_chunks ? __ldg(bi + kn * 32) : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int j = 0; j < kPf; ++j) {
          if (kc0 + j >= n_chunks) break;
          const int o = (q0 * a.pitch + r0) + gp;
          const int o_next = kPair ? o + 1 : (q1 * a.pitch + r1) + gp;
          step8(q0, r0, a.s);
          if (!kPair) step8(q1, r1, a.s);
          unsigned xrh[4], xrl[4], xih[4], xil[4];
          load_a<kPair>(seg_r, o, o_next, p8, xrh, xrl);
          load_a<kPair>(seg_i, o, o_next, p8, xih, xil);
          const SplitB b_r[kNb] = {split_b(bq_r[j].x, bq_r[j].y), split_b(bq_r[j].z, bq_r[j].w)};
#pragma unroll
          for (int nb = 0; nb < kNb; ++nb) {
            mma3(acc[nb][0], xrh, xrl, b_r[nb]);
            mma3(acc[nb][1], xih, xil, b_r[nb]);
          }
          if (kComplex) {
            const SplitB b_i[kNb] = {split_b(bq_i[j].x, bq_i[j].y),
                                     split_b(bq_i[j].z, bq_i[j].w)};
#pragma unroll
            for (int nb = 0; nb < kNb; ++nb) {
              mma3(acc[nb][0], xih, xil, negate(b_i[nb]));
              mma3(acc[nb][1], xrh, xrl, b_i[nb]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kPf; ++j) {
          bq_r[j] = nq_r[j];
          if (kComplex) bq_i[j] = nq_i[j];
        }
      }
      // D fragment of n-block nb: v = 2h + j holds window gid + 8h, column
      // 16 t + 8 nb + 2 tig + j
      const long long out_row = static_cast<long long>(c) * a.nb * a.g;
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int w = b0 + gid + 8 * (v >> 1);
          const int i = 16 * t + 8 * nb + 2 * tig + (v & 1);
          if (w < b_end && i < a.g) {
            const long long o = out_row + static_cast<long long>(w) * a.g + i;
            if (a.q.bits) {
              store_packed(a.out_packed, o, acc[nb][0][v], acc[nb][1][v], a.q);
            } else {
              a.out_r[o] = acc[nb][0][v];
              a.out_i[o] = acc[nb][1][v];
            }
          }
        }
      }
    }
    if (!kWire) __syncthreads();  // this buffer is restaged next
  }
}

// A launch's geometry: what chip_smoke.py prints beside the kernel.
struct Plan {
  int grid, threads, smem, ctas_per_sm, groups, wire;
};

template <bool kComplex, bool kPair, bool kWire>
cudaError_t launch_t(const BandedArgs& a, int sms, int smem_max, Plan* plan,
                     cudaStream_t stream) {
  // two buffers of planes, or one and the raw buffer
  const size_t smem =
      kWire ? 2 * sizeof(float) * static_cast<size_t>(a.buf_len) + raw_bytes(a.s, a.hist, a.kind)
            : 4 * sizeof(float) * static_cast<size_t>(a.buf_len);
  if (smem > static_cast<size_t>(smem_max)) return cudaErrorInvalidConfiguration;
  // Three CTAs of 256 threads where their shared memory fits an SM (the
  // registers capped to fit them too: a few spill, and it still gains),
  // else two of 256 under the looser cap, else one of 512.
  auto small = banded_mma_kernel<kComplex, kPair, kWire, 256, 3>;
  auto large = banded_mma_kernel<kComplex, kPair, kWire, 512, 1>;
  int per_sm = 0, threads = 256;
  cudaError_t err = cudaFuncSetAttribute(small, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, small, threads, smem);
  if (err != cudaSuccess) return err;
  auto kernel = small;
  if (per_sm < 3) {
    kernel = large;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 2) {
      threads = 512;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
      if (err != cudaSuccess) return err;
    }
  }
  const long long slots = static_cast<long long>(per_sm < 1 ? 1 : per_sm) * sms;
  const int grid = static_cast<int>(a.items < slots ? a.items : slots);
  if (plan) {
    *plan = Plan{grid, threads, static_cast<int>(smem), per_sm, a.groups, kWire};
    return cudaSuccess;
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kWire>
cudaError_t launch_input(const BandedArgs& a, int sms, int smem_max, Plan* plan,
                         cudaStream_t stream) {
  const bool pair = a.s % 2 == 0;
  if (a.taps_i != nullptr) {
    return pair ? launch_t<true, true, kWire>(a, sms, smem_max, plan, stream)
                : launch_t<true, false, kWire>(a, sms, smem_max, plan, stream);
  }
  return pair ? launch_t<false, true, kWire>(a, sms, smem_max, plan, stream)
              : launch_t<false, false, kWire>(a, sms, smem_max, plan, stream);
}

// Launch on `stream`, or with `plan` fill in the launch's geometry and
// launch nothing; returns the launch's cudaError_t (0 on success).
int launch_banded(BandedArgs a, int channels, Plan* plan, cudaStream_t stream) {
  if (channels <= 0 || a.s <= 0 || a.hist < 0 || a.g <= 0 || a.n_tiles <= 0 ||
      a.n_tiles * 8 * kNb < a.g || a.span <= 0 || a.span % 8 != 0) {
    return cudaErrorInvalidValue;
  }
  a.nb = a.n / a.s;
  if (a.nb <= 0) return cudaErrorInvalidValue;
  a.pitch = a.s + ((8 - a.s % 16) + 16) % 16;
  const long long rows = (static_cast<long long>(kWin) * a.s + a.hist + a.span + a.s - 1) / a.s;
  a.buf_len = static_cast<int>(rows * a.pitch);
  a.groups = (a.nb + kWin - 1) / kWin;
  a.items = static_cast<long long>(a.groups) * channels;
  int dev = 0, sms = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return a.kind != kPlanar ? launch_input<true>(a, sms, smem_max, plan, stream)
                           : launch_input<false>(a, sms, smem_max, plan, stream);
}

}  // namespace mma
}  // namespace iqk

// The arguments of iq_banded_apply (csrc/banded.cu), the taps in the
// fragment layout of 16-column tiles (Band.build's frag_*).
extern "C" int iq_banded_mma_apply(
    const float* xr, const float* xi, const void* wire, int kind, float norm, float gain,
    const long long* phase, unsigned dtheta, const float* st_r, const float* st_i,
    const void* taps_r, const void* taps_i, const int* tile_first, int n_tiles, int span,
    int channels, int n, int s, int hist, int g, float* out_r, float* out_i, void* out_packed,
    int q_bits, int q_signed, float q_scale, float q_offset, float q_lo, float q_hi,
    void* stream) {
  iqk::mma::BandedArgs a{};
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
  a.taps_r = static_cast<const float4*>(taps_r);
  a.taps_i = static_cast<const float4*>(taps_i);
  a.tile_first = tile_first;
  a.n_tiles = n_tiles;
  a.span = span;
  a.n = n;
  a.s = s;
  a.hist = hist;
  a.g = g;
  a.out_r = out_r;
  a.out_i = out_i;
  a.out_packed = out_packed;
  a.q = iqk::PackParams{q_bits, q_signed, q_scale, q_offset, q_lo, q_hi};
  return iqk::mma::launch_banded(a, channels, nullptr, static_cast<cudaStream_t>(stream));
}

// The geometry a launch at these shapes over input of `kind` (a wire
// kind, or -1 for planes) takes: out = [grid, threads, shared bytes, CTAs
// an SM, groups a channel, 1 if it stages a packed wire].  Launches
// nothing.
extern "C" int iq_banded_mma_plan(int complex, int kind, int n_tiles, int span, int channels,
                                  int n, int s, int hist, int g, int* out) {
  iqk::mma::BandedArgs a{};
  a.kind = kind;
  // only whether taps_i is set is read (the complex instantiation)
  a.taps_i = complex ? reinterpret_cast<const float4*>(16) : nullptr;
  a.n_tiles = n_tiles;
  a.span = span;
  a.n = n;
  a.s = s;
  a.hist = hist;
  a.g = g;
  iqk::mma::Plan p{};
  const int rc = iqk::mma::launch_banded(a, channels, &p, nullptr);
  out[0] = p.grid;
  out[1] = p.threads;
  out[2] = p.smem;
  out[3] = p.ctas_per_sm;
  out[4] = p.groups;
  out[5] = p.wire;
  return rc;
}
