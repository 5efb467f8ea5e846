// K2: strided-window banded map, y = windows(state ++ x; stride s,
// length s + hist) @ A, for one resampler stage.
//
// Replaces iq_tool_tpu/ops/pallas_kernels.py:banded_apply (the
// _banded_kernel, _banded_kernel_complex, _shift_kernel and
// _shift_kernel_complex bodies): planar or packed-wire input with an
// optional NCO mix at each sample's global index, planar float32 or
// quantized packed-wire output, real or complex taps, any stride and
// history.  With the DC-wire loader (kDc, iq_banded_dc_apply) it is K1's
// second launch, behind the DC kernel's carry pass (csrc/banded_dc.cu):
// with it, iq_tool_tpu/ops/pallas_kernels.py:banded_apply_dc
// (_banded_dc_kernel), stage 0 with the wire decode, DC block and NCO in
// front, one read of the wire and no processed planes in device memory.
//
// Which core runs (ops/kernels.py banded_core, a static rule by geometry):
// this one for K1's banded launch at every geometry and for K2 over a wide
// band (96 or more non-zero taps a column: the flagship's stage 1 with
// its lowpass composed in, long FIR bands); K2 over a narrower band takes
// the sm_80 mma.sync core of csrc/banded_mma.cu, which measured 10-22 %
// faster there on an H100 (PERF.md).
//
// What bounds it on the card: a polyphase column has K non-zero taps (32
// at flagship stage 0, 96 at stage 1 with the lowpass composed in) out of
// s + hist rows, so the band's work is 3 x 2 x 2 x C x nb x G x K
// operations of 3xTF32 (28.1 GFLOP at flagship stage 1, 11.1 at stage 0:
// 0.057 and 0.022 ms at 495 TFLOP/s) against the input planes (or wire)
// read once and the output written once: the bytes bound it (0.098 ms at
// stage 1, 0.109 ms at stage 0).  The tensor cores are not the limit:
// on an H100 the kernel with its products taken out ran nearly as long.
// What is: the instructions a warp spends on each product step (loading
// and splitting its windows, the descriptors, the warpgroup fences and
// waits), the taps' stream from L2 through the ring, and at stride 512
// the staging, which no second CTA overlaps (one fits an SM).
//
// Design (Hopper: wgmma, bulk copies, mbarriers, producer warps):
// * Products: wgmma.mma_async.m64n32k8.f32.tf32.tf32 in 3xTF32, each
//   operand x = x_hi + x_lo (split() below) and y += x_lo a_hi + x_hi a_lo
//   + x_hi a_hi in FP32 (about 2^-21 relative a product; one TF32 product
//   gives ~66 dB, short of the 100 dB kernel-vs-twin gate).  x_hi a_hi
//   accumulates apart from the two small terms (a 2048-tap band's sum
//   held 98 dB from the twin in one accumulator, 100+ in two).
// * A, from registers (tf32 wgmma reads shared-memory operands K-major
//   only, and windows s samples apart fit no descriptor): M = 64 rows =
//   32 windows x 2 planes.  Warp q of a warpgroup holds windows 8q + gid:
//   row gid its real plane, row gid + 8 its imaginary plane, so one
//   product covers both planes and a lane's accumulators hold both parts
//   of each (window, column), as the packed epilogue and complex taps need
//   them.  Each lane loads its k pair (2 tig, 2 tig + 1: a sum over k takes
//   k in any order) from the staged span and splits it.
// * B, the taps, from shared memory: N = 32 columns of a column tile
//   (on an H100, tiles of 16 took longer at both flagship stages: an
//   m64n16k8 product costs a step's instructions for half the work), K
//   = 8 rows of the tile's span a product.  Band.build (ops/kernels.py)
//   splits them once, on the host, into the TF32 hi part (rounded as
//   split() rounds) and the lo part, in core-matrix order with the k pair
//   permutation: step j of tile t is 1 KB, column n = 8 ng + nr and span
//   row 8 j + 2 kq + kh at float (ng * 64 + kh * 32 + nr * 4 + kq), no
//   swizzle, LBO 128 bytes (the two k halves), SBO 256 (the column
//   octets).  taps[t] = [hi, lo] x span / 8 steps (and [hi_i, lo_i] for
//   complex taps, whose products D_r = X a_r, D_i = X a_i combine in the
//   epilogue: y_r = D_r[re] - D_i[im], y_i = D_i[re] + D_r[im]).
// * A CTA is two consumer warpgroups (four in K1) and a producer warp for
//   each.  The warpgroups multiply the same staged 32-window group,
//   warpgroup w of W the tiles t = w mod W; producer warp w streams
//   warpgroup w's taps through
//   a ring of `ring` slots of `cs` steps (cp.async.bulk into the slot,
//   completion on the slot's full mbarrier; the warpgroup frees the slot
//   on its empty mbarrier once the products that read it are done).  No
//   lane loads or splits a tap.  The products of step j run while the
//   lanes load and split the next steps' windows: three register sets
//   and wait_group 2 where two warpgroups have an SM's registers, two and
//   wait_group 1 otherwise.
// * Shared memory (227 KB a CTA), per geometry: the staged span of a
//   group, 32 s + hist + span samples as rows of s at a pitch of s + skew
//   (8 mod 16 words, so the 8-byte loads of a warp's 8 windows x 4 k pairs
//   hit 32 banks), two float planes: 72 KB at stride 256 (flagship stage
//   1), 137 KB at 512 (stage 0), 104 KB for a 2048-tap FIR at 256.  The
//   whole band does not fit beside it (244 KB at stage 1, 258 KB at stage
//   0, 532 KB for one tile of the 2048-tap FIR), so the taps stream once
//   per group, 7.6 KB a window at stage 1 (the sm_80 design streamed 13 KB
//   a window, its groups 16 windows).  The rings: W x ring x cs x 2 KB (4
//   KB complex).  Stage 1: 72 + 32 KB (cs 4, ring 2), two CTAs an SM, one
//   staging while the other multiplies.  Stage 0, K1: 137 + 64 KB (the
//   next group's raw cs16 wire) + 24 KB (four rings, cs 1, ring 3) + the
//   scan's constants, 228,224 bytes, one CTA an SM, whose float64 scan
//   (33 samples a thread) no other CTA hides: four warpgroups scan it in
//   half the time of two.  The launcher prefers two CTAs an SM, then two
//   staged groups (K2: the next group's cp.async copy in flight during
//   the products), then the deepest ring; K1 and complex taps (four
//   accumulators) take one CTA an SM.
// * Staging.  Planar input by cp.async, packed wire decoded and NCO-mixed
//   once per staged sample (load_ext).  K1's DC-wire loader (below) reads
//   the group's raw wire, which producer warp 0 bulk-copies into shared
//   memory while the consumers multiply the group before.  The buffers are
//   zeroed once, so a span's read-ahead past the group (multiplied by zero
//   taps) reads finite values.
// * Balance.  The grid is one wave of CTAs (occupancy x SMs), each taking
//   an equal share of the C x groups items.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wire.cuh"

namespace iqk {

constexpr int kWin = 32;         // windows per group: M = 64 rows (window, plane)
constexpr int kN = 32;           // columns per tile: the products' N
constexpr int kStep = kN * 8;    // floats of one 8-row step of a tile's taps
constexpr int kMaxWgs = 4;       // consumer warpgroups a CTA: 2 or 4
constexpr int kMaxRing = 4;
// the B descriptor's strides (no swizzle, K-major): LBO between the two
// 4-k core matrices of a step, SBO between its two 8-column octets
constexpr int kLbo = 128, kSbo = 256;

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
  const float* taps_r;  // (n_tiles, 2, span / 8, 256): hi, lo steps
  const float* taps_i;  // the same for the imaginary taps, or null
  const int* tile_first;  // (n_tiles,) first span row of each tile, even
  int n_tiles;
  int span;  // rows of every tile's span, a multiple of 8
  int n, s, hist, g, nb;
  int pitch;    // staged row pitch: s + skew, 8 mod 16
  int buf_len;  // floats per staged plane
  int groups;   // window groups per channel
  long long items;  // channels * groups
  int cs;       // steps of taps a ring slot holds
  int ring;     // slots a ring
  int nbuf;     // staged groups: 2 (the next group's copy in flight), or 1
  int wgs;      // consumer warpgroups, each with its ring
  float* out_r;  // (C, nb*G) planar output, or
  float* out_i;
  void* out_packed;  // (C, nb*G) packed wire output when q.bits != 0
  PackParams q;
  // K1's DC-wire loader (kDc): the carry pass's state before each group
  // and the processed samples before it (csrc/banded_dc.cu iq_dc_carry)
  const double* bound;  // (C, groups, 4) [yr, yi, xr, xi]
  const float* halo_r;  // (C, groups, hist)
  const float* halo_i;
  double pole;   // the DC pole 1 - alpha
  int per;       // new samples a consumer thread scans: odd, per * consumers >= 32 s
  int raw_vec;   // wire rows 16-byte aligned: the raw wire by bulk copy
};

// ---- barriers, bulk copies, wgmma ---------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The consumer warps' barrier (the producer warp runs on its own).
__device__ __forceinline__ void consumers_sync(int consumers) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(consumers) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The B descriptor of one step of taps at `p` (no swizzle).
__device__ __forceinline__ uint64_t b_desc(const float* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(kLbo >> 4) << 16) | (static_cast<uint64_t>(kSbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// d (64 x 32, FP32) += a (64 x 8, TF32, registers) * b (8 x 32, TF32, at
// the descriptor)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const unsigned (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,%19}, %20, p, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// ---- staging ---------------------------------------------------------------

// Sample e of one channel's extended input state ++ x with x the packed
// wire, decoded and NCO-mixed.
__device__ __forceinline__ void load_ext(const BandedArgs& a, int c,
                                         long long e, float* vr, float* vi) {
  if (e < a.hist) {
    *vr = a.st_r[static_cast<long long>(c) * a.hist + e];
    *vi = a.st_i[static_cast<long long>(c) * a.hist + e];
    return;
  }
  const long long idx = e - a.hist;
  const long long row = static_cast<long long>(c) * a.n;
  const int elem = a.kind == kCs16 || a.kind == kCu16 ? 4 : 2;
  const char* base = static_cast<const char*>(a.wire) + row * elem;
  wire_decode(base, a.kind, idx, a.norm, a.gain, vr, vi);
  if (a.dtheta) {
    nco_rotate(static_cast<unsigned>(a.phase[c]), a.dtheta, idx, vr, vi);
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = smem_u32(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of the thread's committed cp.async groups
// are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Stage windows [b0, b0 + nw) of channel c: ext[b0*s + e] for e < nw*s +
// hist at row e / s, column e % s of the padded planes (the consumers).
__device__ void stage(const BandedArgs& a, int consumers, int c, int b0, int nw,
                      float* seg_r, float* seg_i) {
  const int len = nw * a.s + a.hist;
  const int rows = (len + a.s - 1) / a.s;
  const int lane = threadIdx.x & 31;
  const long long e0 = static_cast<long long>(b0) * a.s;
  for (int q = threadIdx.x >> 5; q < rows; q += consumers / 32) {
    const int u_end = min(a.s, len - q * a.s);
    for (int u = lane; u < u_end; u += 32) {
      const long long e = e0 + static_cast<long long>(q) * a.s + u;
      const int o = q * a.pitch + u;
      if (a.kind == kPlanar) {
        const bool st = e < a.hist;
        const long long idx = st ? static_cast<long long>(c) * a.hist + e
                                 : static_cast<long long>(c) * a.n + (e - a.hist);
        cp_async4(seg_r + o, (st ? a.st_r : a.xr) + idx);
        cp_async4(seg_i + o, (st ? a.st_i : a.xi) + idx);
      } else {
        float vr, vi;
        load_ext(a, c, e, &vr, &vi);
        seg_r[o] = vr;
        seg_i[o] = vi;
      }
    }
  }
}

// ---- K1's DC-wire loader ----------------------------------------------
//
// A group's span is its `hist` samples before the group (the carried
// history for group 0, the carry pass's halo after) and its nw * s new
// samples x[p, p + nw s), p = 32 s g.  Group i + 1's raw wire is copied
// into shared memory (`raw`: producer warp 0's bulk copy, or the
// consumers' loads where the wire's rows are not 16-byte aligned) while
// group i multiplies; then each consumer thread decodes its row of `per`
// consecutive new samples from `raw` into their staged places and runs
// them from y = 0; a warp-shuffle scan plus a Horner pass over the warp
// totals (the DC kernel's scheme, float64) gives each row its incoming y
// from the carry pass's y[p - 1]; the thread reruns its row from there,
// rounds each sample to float32 once, NCO-mixes it at its index in the
// block and overwrites its staged place.  `per` is odd, so a warp's rows
// start in distinct banks.  The carry pass writes its states at the same
// 32-window groups (ops/kernels.py BAND_WIN).

struct DcScan {
  double level[6];    // a^(per 2^k); level[5] = a^(32 per), a warp's samples
  double lane_pow[32];  // a^(per lane)
  double warp_r[kMaxWgs * 4];  // warp totals from y = 0 at the group start
  double warp_i[kMaxWgs * 4];
};

__host__ __device__ __forceinline__ int wire_elem(int kind) {
  return kind == kCs16 || kind == kCu16 ? 4 : 2;
}

// Bytes of the raw buffer: a group's new samples, rounded up to 16.
__host__ __device__ inline int dc_raw_bytes(int s, int elem) { return (kWin * s * elem + 15) / 16 * 16; }

__device__ __forceinline__ const char* raw_src(const BandedArgs& a, int c, int g) {
  const long long first = static_cast<long long>(c) * a.n + static_cast<long long>(g) * kWin * a.s;
  return static_cast<const char*>(a.wire) + first * wire_elem(a.kind);
}

// The consumers copy group (c, g)'s raw wire with plain loads (rows not
// 16-byte aligned).
__device__ __forceinline__ void load_raw(const BandedArgs& a, int consumers, int c, int g,
                                         int nw, char* raw) {
  const char* src = raw_src(a, c, g);
  const int len = nw * a.s;
  if (wire_elem(a.kind) == 4) {
    for (int i = threadIdx.x; i < len; i += consumers) {
      reinterpret_cast<int*>(raw)[i] = reinterpret_cast<const int*>(src)[i];
    }
  } else {
    for (int i = threadIdx.x; i < len; i += consumers) {
      reinterpret_cast<short*>(raw)[i] = reinterpret_cast<const short*>(src)[i];
    }
  }
}

// Stage group (c, g) of nw windows from the halo and the raw buffer, as
// stage() stages ext[b0 s + e] for e < nw s + hist.  Every consumer
// calls it (it holds a consumer barrier).  my_pow = a^(per threadIdx.x).
__device__ __forceinline__ void stage_dc(const BandedArgs& a, int consumers, int c, int g,
                                         int nw, const char* raw, DcScan& sc, double my_pow,
                                         float* seg_r, float* seg_i) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long p = static_cast<long long>(g) * kWin * a.s;  // x index of the group
  for (int j = tid; j < a.hist; j += consumers) {
    const long long e = p + j;  // ext index
    float vr, vi;
    if (e < a.hist) {
      vr = a.st_r[static_cast<long long>(c) * a.hist + e];
      vi = a.st_i[static_cast<long long>(c) * a.hist + e];
    } else {
      const long long h = (static_cast<long long>(c) * a.groups + g) * a.hist + j;
      vr = a.halo_r[h];
      vi = a.halo_i[h];
    }
    const int o = (j / a.s) * a.pitch + j % a.s;
    seg_r[o] = vr;
    seg_i[o] = vi;
  }

  const double pa = a.pole;
  const int len = nw * a.s;
  const int first = tid * a.per;
  const int m = len - first <= 0 ? 0 : (len - first >= a.per ? a.per : len - first);
  const double* rec = a.bound + (static_cast<long long>(c) * a.groups + g) * 4;
  // x of the sample before this thread's row
  float px_r = 0.0f, px_i = 0.0f;
  if (tid == 0) {
    px_r = static_cast<float>(rec[2]);
    px_i = static_cast<float>(rec[3]);
  } else if (m > 0) {
    wire_decode(raw, a.kind, first - 1, a.norm, a.gain, &px_r, &px_i);
  }
  // staged place of this row's first sample: e = hist + first
  const int q0 = (a.hist + first) / a.s, r0 = a.hist + first - q0 * a.s;
  double er = 0.0, ei = 0.0;
  {
    double pr = px_r, pi = px_i;
    int q = q0, r = r0;
    // unrolled, so that the decodes (and below, the NCO's sincos) of
    // several samples overlap the recurrence's dependent chain
#pragma unroll 8
    for (int k = 0; k < m; ++k) {
      float xr, xi;
      wire_decode(raw, a.kind, first + k, a.norm, a.gain, &xr, &xi);
      seg_r[q * a.pitch + r] = xr;
      seg_i[q * a.pitch + r] = xi;
      er = fma(pa, er, static_cast<double>(xr) - pr);
      ei = fma(pa, ei, static_cast<double>(xi) - pi);
      pr = xr;
      pi = xi;
      if (++r == a.s) {
        r = 0;
        ++q;
      }
    }
  }
  // warp scan of the row ends: every row before the last valid one holds
  // per samples, so each level's coefficient is one constant
  double sr = er, si = ei;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const double ur = __shfl_up_sync(0xffffffffu, sr, 1 << k);
    const double ui = __shfl_up_sync(0xffffffffu, si, 1 << k);
    if (lane >= (1 << k)) {
      sr = fma(sc.level[k], ur, sr);
      si = fma(sc.level[k], ui, si);
    }
  }
  double zr = __shfl_up_sync(0xffffffffu, sr, 1);
  double zi = __shfl_up_sync(0xffffffffu, si, 1);
  if (lane == 0) zr = zi = 0.0;
  if (lane == 31) {
    sc.warp_r[warp] = sr;
    sc.warp_i[warp] = si;
  }
  consumers_sync(consumers);
  if (m == 0) return;
  {
    double wr = 0.0, wi = 0.0;
    for (int v = 0; v < warp; ++v) {
      wr = fma(sc.level[5], wr, sc.warp_r[v]);
      wi = fma(sc.level[5], wi, sc.warp_i[v]);
    }
    zr = fma(sc.lane_pow[lane], wr, zr);
    zi = fma(sc.lane_pow[lane], wi, zi);
  }
  double yr = fma(my_pow, rec[0], zr);
  double yi = fma(my_pow, rec[1], zi);
  double pr = px_r, pi = px_i;
  const unsigned ph0 = a.dtheta ? static_cast<unsigned>(a.phase[c]) : 0u;
  int q = q0, r = r0;
#pragma unroll 8
  for (int k = 0; k < m; ++k) {
    const int o = q * a.pitch + r;
    const float xr = seg_r[o], xi = seg_i[o];
    yr = fma(pa, yr, static_cast<double>(xr) - pr);
    yi = fma(pa, yi, static_cast<double>(xi) - pi);
    pr = xr;
    pi = xi;
    float vr = static_cast<float>(yr);
    float vi = static_cast<float>(yi);
    if (a.dtheta) nco_rotate(ph0, a.dtheta, p + first + k, &vr, &vi);
    seg_r[o] = vr;
    seg_i[o] = vi;
    if (++r == a.s) {
      r = 0;
      ++q;
    }
  }
}

// ---- the product core ------------------------------------------------------

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away, as
// cvt.rna.tf32.f32, in two integer operations instead of the conversion
// unit's quarter rate); lo = x - hi is exact in float32, and the tensor
// cores read its top 19 bits (sign, exponent, 10 mantissa bits).
// Band.build splits the taps on the host by the same arithmetic.
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// One lane's A fragment of one step, split: rows gid (real plane) and
// gid + 8 (imaginary plane) of its warp, k = 2 tig and 2 tig + 1 (the
// fragment's k = tig and tig + 4) at o and o_next (o + 1 unless the pair
// straddles a staged row, which only an odd stride allows).
template <bool kPair>
__device__ __forceinline__ void load_a(const float* seg_r, const float* seg_i, int o,
                                       int o_next, unsigned (&h)[4], unsigned (&l)[4]) {
  float v0, v1, v2, v3;
  if (kPair) {
    const float2 re = *reinterpret_cast<const float2*>(seg_r + o);
    const float2 im = *reinterpret_cast<const float2*>(seg_i + o);
    v0 = re.x;
    v2 = re.y;
    v1 = im.x;
    v3 = im.y;
  } else {
    v0 = seg_r[o];
    v2 = seg_r[o_next];
    v1 = seg_i[o];
    v3 = seg_i[o_next];
  }
  split(v0, h[0], l[0]);
  split(v1, h[1], l[1]);
  split(v2, h[2], l[2]);
  split(v3, h[3], l[3]);
}

// Shared memory of a CTA: the two rings, the staged planes, the
// barriers, then (kDc) the scan's constants and the raw wire.
struct Smem {
  size_t ring_bytes;  // one ring
  size_t planes;      // offset of the staged planes
  size_t bars;
  size_t scan;
  size_t raw;
  size_t total;
};

__host__ __device__ inline Smem smem_layout(const BandedArgs& a, bool dc) {
  Smem m{};
  const int parts = a.taps_i ? 4 : 2;
  m.ring_bytes = static_cast<size_t>(a.ring) * parts * a.cs * kStep * sizeof(float);
  m.planes = a.wgs * m.ring_bytes;
  m.bars = m.planes + 2 * sizeof(float) * static_cast<size_t>(a.nbuf) * a.buf_len;
  m.bars = (m.bars + 15) / 16 * 16;
  m.scan = m.bars + 8 * (2 * kMaxWgs * kMaxRing + 2);
  m.raw = m.scan;
  m.total = m.scan;
  if (dc) {
    m.raw = (m.scan + sizeof(DcScan) + 15) / 16 * 16;
    m.total = m.raw + dc_raw_bytes(a.s, wire_elem(a.kind));
  }
  return m;
}

template <bool kComplex, bool kPair, bool kDc, int kWgs, int kMinCtas>
__global__ void __launch_bounds__(kWgs * 160, kMinCtas) banded_kernel(const BandedArgs a) {
  constexpr int kConsumers = kWgs * 128;
  constexpr int kThreads = kWgs * 160;  // and a producer warp a warpgroup
  // steps whose products may be in flight: three where two warpgroups
  // have an SM's registers, else two
  constexpr int kDepth = kMinCtas == 1 && kWgs == 2 ? 3 : 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L = smem_layout(a, kDc);
  float* ring0 = reinterpret_cast<float*>(smem);
  float* seg_r0 = reinterpret_cast<float*>(smem + L.planes);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem + L.bars);
  unsigned long long* full = bars;                        // [kMaxWgs][kMaxRing]
  unsigned long long* empty = bars + kMaxWgs * kMaxRing;  // [kMaxWgs][kMaxRing]
  unsigned long long* raw_full = bars + 2 * kMaxWgs * kMaxRing;
  unsigned long long* raw_empty = raw_full + 1;
  DcScan* sc = reinterpret_cast<DcScan*>(smem + L.scan);
  char* raw = reinterpret_cast<char*>(smem + L.raw);
  const int lane = threadIdx.x & 31;
  const long long i_begin = a.items * blockIdx.x / gridDim.x;
  const long long i_end = a.items * (blockIdx.x + 1) / gridDim.x;
  const int steps = a.span >> 3;
  const int n_chunks = (steps + a.cs - 1) / a.cs;
  constexpr int kParts = kComplex ? 4 : 2;
  const int slot_floats = kParts * a.cs * kStep;
  // descriptor units (16 bytes) from a slot's hi taps to its lo taps
  const uint64_t lo_off = static_cast<uint64_t>(a.cs) * kStep * sizeof(float) / 16;
  // (channel, group, windows) of an item
  auto item_at = [&](long long i, int& c, int& g, int& nw) {
    c = static_cast<int>(i / a.groups);
    g = static_cast<int>(i % a.groups);
    nw = min(kWin, a.nb - g * kWin);
  };

  for (int i = threadIdx.x; i < 2 * a.nbuf * a.buf_len; i += kThreads) seg_r0[i] = 0.0f;
  if (threadIdx.x == 0) {
    for (int r = 0; r < kMaxWgs * kMaxRing; ++r) {
      mbar_init(full + r, 1);
      mbar_init(empty + r, 4);  // lane 0 of each warp of the warpgroup
    }
    mbar_init(raw_full, 1);
    mbar_init(raw_empty, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  double my_pow = 0.0;
  if constexpr (kDc) {
    if (threadIdx.x < kConsumers) my_pow = ipow(a.pole, static_cast<unsigned>(a.per * threadIdx.x));
    if (threadIdx.x < 32) sc->lane_pow[threadIdx.x] = ipow(a.pole, a.per * threadIdx.x);
    if (threadIdx.x >= 32 && threadIdx.x < 38) {
      sc->level[threadIdx.x - 32] = ipow(a.pole, a.per << (threadIdx.x - 32));
    }
  }
  __syncthreads();  // the buffers are zeroed, the barriers and constants set

  if (threadIdx.x >= kConsumers) {
    // ---- producer warp w: warpgroup w's taps, and (w = 0, K1) the raw wire
    if (lane != 0) return;
    const int w = (threadIdx.x - kConsumers) >> 5;
    const bool raw_mine = kDc && w == 0 && a.raw_vec;
    auto issue_raw = [&](long long item) {
      int c, g, nw;
      item_at(item, c, g, nw);
      const unsigned bytes = (nw * a.s * wire_elem(a.kind) + 15) / 16 * 16;
      mbar_expect(raw_full, bytes);
      bulk_copy(raw, raw_src(a, c, g), bytes, raw_full);
    };
    if (raw_mine && i_begin < i_end) issue_raw(i_begin);
    int slot = 0;
    unsigned round = 0;
    float* ring = ring0 + w * (L.ring_bytes / sizeof(float));
    for (long long item = i_begin; item < i_end; ++item) {
      // the next group's raw wire goes out once the consumers have staged
      // this one, after the ring's first slots of this group
      bool raw_done = !(raw_mine && item + 1 < i_end);
      int issued = 0;
      const unsigned k = static_cast<unsigned>(item - i_begin);
      for (int t = w; t < a.n_tiles; t += kWgs) {
        for (int ch = 0; ch < n_chunks; ++ch) {
          if (!raw_done && issued == a.ring) {
            mbar_wait(raw_empty, k & 1u);
            issue_raw(item + 1);
            raw_done = true;
          }
          mbar_wait(empty + w * kMaxRing + slot, (round & 1u) ^ 1u);
          const int n = min(a.cs, steps - ch * a.cs);
          const unsigned part = n * kStep * 4;
          mbar_expect(full + w * kMaxRing + slot, kParts * part);
          float* dst = ring + slot * slot_floats;
          const long long src = (static_cast<long long>(t) * 2 * steps + ch * a.cs) * kStep;
          bulk_copy(dst, a.taps_r + src, part, full + w * kMaxRing + slot);
          bulk_copy(dst + a.cs * kStep, a.taps_r + src + steps * kStep, part,
                    full + w * kMaxRing + slot);
          if constexpr (kComplex) {
            bulk_copy(dst + 2 * a.cs * kStep, a.taps_i + src, part, full + w * kMaxRing + slot);
            bulk_copy(dst + 3 * a.cs * kStep, a.taps_i + src + steps * kStep, part,
                      full + w * kMaxRing + slot);
          }
          ++issued;
          if (++slot == a.ring) {
            slot = 0;
            ++round;
          }
        }
      }
      if (!raw_done) {
        mbar_wait(raw_empty, k & 1u);
        issue_raw(item + 1);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg, warp wq of it
  const int wg = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3;
  const int gid = lane >> 2, tig = lane & 3;
  const int win = 8 * wq + gid;  // this lane's window in the group
  const int wrow = win * a.pitch;
  float* ring = ring0 + wg * (L.ring_bytes / sizeof(float));
  unsigned long long* my_full = full + wg * kMaxRing;
  unsigned long long* my_empty = empty + wg * kMaxRing;
  int slot = 0;
  unsigned round = 0;
  if (!kDc && i_begin < i_end) {
    int c, g, nw;
    item_at(i_begin, c, g, nw);
    stage(a, kConsumers, c, g * kWin, nw, seg_r0, seg_r0 + a.buf_len);
    cp_async_commit();
  }
  for (long long item = i_begin; item < i_end; ++item) {
    int c, g, nw;
    item_at(item, c, g, nw);
    const int b0 = g * kWin;
    const int buf = a.nbuf == 2 ? static_cast<int>((item - i_begin) & 1) : 0;
    const float* seg_r = seg_r0 + buf * 2 * a.buf_len;
    const float* seg_i = seg_r + a.buf_len;
    if constexpr (kDc) {
      const unsigned k = static_cast<unsigned>(item - i_begin);
      if (a.raw_vec) {
        mbar_wait(raw_full, k & 1u);
      } else {
        load_raw(a, kConsumers, c, g, nw, raw);
        consumers_sync(kConsumers);
      }
      stage_dc(a, kConsumers, c, g, nw, raw, *sc, my_pow, seg_r0, seg_r0 + a.buf_len);
      consumers_sync(kConsumers);  // staged; the raw buffer is free
      if (threadIdx.x == 0 && a.raw_vec) mbar_arrive(raw_empty);
    } else {
      // with two buffers the next group's copy goes out before this
      // group's products, and this group's was the one before
      if (a.nbuf == 2) {
        if (item + 1 < i_end) {
          int cn, gn, nwn;
          item_at(item + 1, cn, gn, nwn);
          float* nxt = seg_r0 + (buf ^ 1) * 2 * a.buf_len;
          stage(a, kConsumers, cn, gn * kWin, nwn, nxt, nxt + a.buf_len);
        }
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      consumers_sync(kConsumers);
    }

    for (int t = wg; t < a.n_tiles; t += kWgs) {
      // x_hi a_hi accumulates apart from the two small terms: a long
      // band's sum then rounds a third as often where it is large
      float acc[kN / 2], acc_s[kN / 2], acc_i[kN / 2], acc_is[kN / 2];
#pragma unroll
      for (int v = 0; v < kN / 2; ++v) {
        acc[v] = acc_s[v] = 0.0f;
        acc_i[v] = acc_is[v] = 0.0f;
      }
      // span row x = f0 + 8 j + 2 tig sits at (x / s) * pitch + x % s,
      // plus win * pitch for this lane's window: o walks up the span, r is
      // its place in the staged row (and o1, r1 for x + 1 where pairs may
      // straddle rows)
      const int f0 = a.tile_first[t] + 2 * tig;
      int r0 = f0 % a.s, o0 = (f0 / a.s) * a.pitch + r0 + wrow;
      int r1 = (f0 + 1) % a.s, o1 = ((f0 + 1) / a.s) * a.pitch + r1 + wrow;
      unsigned xh[kDepth][4], xl[kDepth][4];
      uint64_t desc = 0;  // the current step's hi taps
      int jc = 0, left = steps;  // step within the chunk, steps after it
      // the slot each of the last kDepth - 1 steps emptied (its chunk's
      // last), or -1: a slot is freed once the products that read it are
      // done, kDepth - 1 steps later
      int ends[kDepth - 1];
#pragma unroll
      for (int d = 0; d < kDepth - 1; ++d) ends[d] = -1;
      auto free_slot = [&](int sl) {
        __syncwarp();
        if (sl >= 0 && lane == 0) mbar_arrive(my_empty + sl);
      };
      // step j: wait for its slot at a chunk's start, load and split the
      // windows into register set d, issue its products, then wait until
      // at most kDepth - 1 steps' products are in flight
      auto step = [&](unsigned(&h)[4], unsigned(&l)[4]) {
        if (jc == 0) {
          mbar_wait(my_full + slot, round & 1u);
          desc = b_desc(ring + slot * slot_floats);
        }
        load_a<kPair>(seg_r, seg_i, o0, kPair ? o0 + 1 : o1, h, l);
        o0 += 8;
        r0 += 8;
        while (r0 >= a.s) {  // once at most, but for strides below 8
          r0 -= a.s;
          o0 += a.pitch - a.s;
        }
        if (!kPair) {
          o1 += 8;
          r1 += 8;
          while (r1 >= a.s) {
            r1 -= a.s;
            o1 += a.pitch - a.s;
          }
        }
        wgmma_fence();
        wgmma_rs(acc_s, l, desc);
        wgmma_rs(acc_s, h, desc + lo_off);
        wgmma_rs(acc, h, desc);
        if constexpr (kComplex) {
          wgmma_rs(acc_is, l, desc + 2 * lo_off);
          wgmma_rs(acc_is, h, desc + 3 * lo_off);
          wgmma_rs(acc_i, h, desc + 2 * lo_off);
        }
        wgmma_commit();
        wgmma_wait<kDepth - 1>();
        free_slot(ends[0]);
#pragma unroll
        for (int d = 0; d + 1 < kDepth - 1; ++d) ends[d] = ends[d + 1];
        desc += kStep * sizeof(float) / 16;
        --left;
        ends[kDepth - 2] = -1;
        if (++jc == a.cs || left == 0) {
          ends[kDepth - 2] = slot;
          jc = 0;
          if (++slot == a.ring) {
            slot = 0;
            ++round;
          }
        }
      };
      while (left > 0) {
#pragma unroll
        for (int d = 0; d < kDepth; ++d) {
          if (left > 0) step(xh[d], xl[d]);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int d = 0; d < kDepth - 1; ++d) free_slot(ends[d]);
      // accumulator v: row gid + 8 ((v >> 1) & 1) of the warp (the real,
      // then the imaginary plane of window win), column 8 (v >> 2) + 2 tig
      // + (v & 1) of the tile
      const int w = b0 + win;
      if (w < a.nb) {
        const long long o = (static_cast<long long>(c) * a.nb + w) * a.g + kN * t + 2 * tig;
        const int cols = a.g - kN * t - 2 * tig;  // columns of the row left at o
#pragma unroll
        for (int nb = 0; nb < kN / 8; ++nb) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int v = 4 * nb + j;
            float yr = acc_s[v] + acc[v], yi = acc_s[v + 2] + acc[v + 2];
            if (kComplex) {
              yr -= acc_is[v + 2] + acc_i[v + 2];
              yi += acc_is[v] + acc_i[v];
            }
            if (8 * nb + j < cols) {
              if (a.q.bits) {
                store_packed(a.out_packed, o + 8 * nb + j, yr, yi, a.q);
              } else {
                a.out_r[o + 8 * nb + j] = yr;
                a.out_i[o + 8 * nb + j] = yi;
              }
            }
          }
        }
      }
    }
    consumers_sync(kConsumers);  // this buffer is restaged next
    if (!kDc && a.nbuf == 1 && item + 1 < i_end) {
      int cn, gn, nwn;
      item_at(item + 1, cn, gn, nwn);
      stage(a, kConsumers, cn, gn * kWin, nwn, seg_r0, seg_r0 + a.buf_len);
      cp_async_commit();
    }
  }
}

// Floats per staged plane.
inline int banded_buf_len(int s, int hist, int span, int pitch) {
  const long long rows = (static_cast<long long>(kWin) * s + hist + span + s - 1) / s;
  return static_cast<int>(rows * pitch);
}

// The staging and the ring: two CTAs an SM where they fit, one staging
// while the other multiplies, else one; two warpgroups a CTA, four for
// K1 with real taps (its float64 scan runs on every consumer thread, and
// no second CTA hides it); then two staged groups where they fit (K2; K1
// stages one), then the deepest (cs, ring); false if nothing fits.
inline bool choose_ring(BandedArgs& a, bool dc, int smem_max, int smem_sm, int reserved) {
  static const int kCand[][2] = {{8, 2}, {4, 4}, {4, 3}, {4, 2}, {2, 4}, {2, 3},
                                 {2, 2}, {1, 4}, {1, 3}, {1, 2}};
  const bool complex_taps = a.taps_i != nullptr;
  for (int ctas = dc || complex_taps ? 1 : 2; ctas >= 1; --ctas) {
    a.wgs = dc && !complex_taps ? 4 : 2;
    for (a.nbuf = dc ? 1 : 2; a.nbuf >= 1; --a.nbuf) {
      for (const auto& cr : kCand) {
        a.cs = cr[0];
        a.ring = cr[1];
        const size_t total = smem_layout(a, dc).total;
        if (total <= static_cast<size_t>(smem_max) &&
            ctas * (total + reserved) <= static_cast<size_t>(smem_sm)) {
          return true;
        }
      }
    }
  }
  return false;
}

// A launch's geometry: what chip_smoke.py prints beside the kernel.
struct Plan {
  int grid, threads, smem, cs, ring, ctas_per_sm, groups, nbuf;
};

template <bool kComplex, bool kPair, bool kDc, int kWgs, int kMinCtas>
cudaError_t run_k(const BandedArgs& a, size_t smem, int sms, Plan* plan, cudaStream_t stream) {
  auto kernel = banded_kernel<kComplex, kPair, kDc, kWgs, kMinCtas>;
  constexpr int kThreads = kWgs * 160;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long slots = static_cast<long long>(per_sm < 1 ? 1 : per_sm) * sms;
  const int grid = static_cast<int>(a.items < slots ? a.items : slots);
  if (plan) {
    *plan = Plan{grid, kThreads, static_cast<int>(smem), a.cs, a.ring, per_sm, a.groups, a.nbuf};
    return cudaSuccess;
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Launch on `stream`, or with `plan` fill in the launch's geometry and
// launch nothing.
template <bool kComplex, bool kPair, bool kDc>
cudaError_t launch_t(BandedArgs a, int sms, int smem_max, int smem_sm, int reserved,
                     Plan* plan, cudaStream_t stream) {
  if (!choose_ring(a, kDc, smem_max, smem_sm, reserved)) return cudaErrorInvalidConfiguration;
  const size_t smem = smem_layout(a, kDc).total;
  if constexpr (kDc) {
    // the smallest odd row length that covers a group's 32 s samples
    a.per = (kWin * a.s + a.wgs * 128 - 1) / (a.wgs * 128);
    a.per |= 1;
  }
  if constexpr (kComplex) {
    return run_k<kComplex, kPair, kDc, 2, 1>(a, smem, sms, plan, stream);
  } else if constexpr (kDc) {
    return run_k<kComplex, kPair, kDc, 4, 1>(a, smem, sms, plan, stream);
  } else {
    // two CTAs an SM where their shared memory fits (the registers capped
    // to fit them too), else one
    if (2 * (smem + reserved) <= static_cast<size_t>(smem_sm)) {
      return run_k<kComplex, kPair, kDc, 2, 2>(a, smem, sms, plan, stream);
    }
    return run_k<kComplex, kPair, kDc, 2, 1>(a, smem, sms, plan, stream);
  }
}

int launch_banded(BandedArgs a, int channels, bool dc, Plan* plan, cudaStream_t stream) {
  if (channels <= 0 || a.s <= 0 || a.hist < 0 || a.g <= 0 || a.n_tiles <= 0 ||
      a.n_tiles * kN < a.g || a.span <= 0 || a.span % 8 != 0 ||
      (dc && (a.kind == kPlanar || (!plan && (!a.wire || !a.bound || !a.halo_r || !a.halo_i ||
                                              (a.dtheta && !a.phase)))))) {
    return cudaErrorInvalidValue;
  }
  a.nb = a.n / a.s;
  if (a.nb <= 0) return cudaErrorInvalidValue;
  a.pitch = a.s + ((8 - a.s % 16) + 16) % 16;
  a.buf_len = banded_buf_len(a.s, a.hist, a.span, a.pitch);
  const int groups = (a.nb + kWin - 1) / kWin;
  if (dc && !plan && a.groups != groups) return cudaErrorInvalidValue;  // the carry pass's
  a.groups = groups;
  a.items = static_cast<long long>(a.groups) * channels;
  int dev = 0, sms = 0, smem_max = 0, smem_sm = 0, reserved = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  const bool pair = a.s % 2 == 0;
  const int m = sms;
  if (dc) {
    const int elem = wire_elem(a.kind);
    a.raw_vec = (reinterpret_cast<unsigned long long>(a.wire) & 15u) == 0 &&
                (static_cast<long long>(a.n) * elem) % 16 == 0;
    if (a.taps_i != nullptr) {
      return pair ? launch_t<true, true, true>(a, m, smem_max, smem_sm, reserved, plan, stream)
                  : launch_t<true, false, true>(a, m, smem_max, smem_sm, reserved, plan, stream);
    }
    return pair ? launch_t<false, true, true>(a, m, smem_max, smem_sm, reserved, plan, stream)
                : launch_t<false, false, true>(a, m, smem_max, smem_sm, reserved, plan, stream);
  }
  if (a.taps_i != nullptr) {
    return pair ? launch_t<true, true, false>(a, m, smem_max, smem_sm, reserved, plan, stream)
                : launch_t<true, false, false>(a, m, smem_max, smem_sm, reserved, plan, stream);
  }
  return pair ? launch_t<false, true, false>(a, m, smem_max, smem_sm, reserved, plan, stream)
              : launch_t<false, false, false>(a, m, smem_max, smem_sm, reserved, plan, stream);
}

}  // namespace iqk

extern "C" int iq_banded_apply(
    const float* xr, const float* xi, const void* wire, int kind, float norm,
    float gain, const long long* phase, unsigned dtheta, const float* st_r,
    const float* st_i, const void* taps_r, const void* taps_i, const int* tile_first,
    int n_tiles, int span, int channels, int n, int s, int hist, int g,
    float* out_r, float* out_i, void* out_packed, int q_bits, int q_signed,
    float q_scale, float q_offset, float q_lo, float q_hi, void* stream) {
  iqk::BandedArgs a{};
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
  a.taps_r = static_cast<const float*>(taps_r);
  a.taps_i = static_cast<const float*>(taps_i);
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
  return iqk::launch_banded(a, channels, false, nullptr, static_cast<cudaStream_t>(stream));
}

// K1's banded kernel: stage 0 over the packed wire, decoded, DC-blocked
// from the carry pass's group states and halos (iq_dc_carry, `groups`
// its group count: ceil((n / s) / 32)) and NCO-mixed in the loader.
extern "C" int iq_banded_dc_apply(
    const void* wire, int kind, float norm, float gain, const long long* phase,
    unsigned dtheta, double pole, const double* bound, const float* halo_r,
    const float* halo_i, int groups, const float* st_r, const float* st_i,
    const void* taps_r, const void* taps_i, const int* tile_first, int n_tiles,
    int span, int channels, int n, int s, int hist, int g, float* out_r,
    float* out_i, void* out_packed, int q_bits, int q_signed, float q_scale,
    float q_offset, float q_lo, float q_hi, void* stream) {
  iqk::BandedArgs a{};
  a.wire = wire;
  a.kind = kind;
  a.norm = norm;
  a.gain = gain;
  a.phase = phase;
  a.dtheta = dtheta;
  a.pole = pole;
  a.bound = bound;
  a.halo_r = halo_r;
  a.halo_i = halo_i;
  a.groups = groups;
  a.st_r = st_r;
  a.st_i = st_i;
  a.taps_r = static_cast<const float*>(taps_r);
  a.taps_i = static_cast<const float*>(taps_i);
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
  return iqk::launch_banded(a, channels, true, nullptr, static_cast<cudaStream_t>(stream));
}

// The geometry a launch at these shapes takes (`complex`: complex taps,
// `dc`: K1's loader over wire `kind`): out = [grid, threads, shared
// bytes, steps a ring slot, slots a ring, CTAs an SM, groups a channel,
// staged groups].
// Launches nothing; returns the cudaError_t a launch would meet first.
extern "C" int iq_banded_plan(int complex, int dc, int kind, int n_tiles, int span,
                              int channels, int n, int s, int hist, int g, int* out) {
  iqk::BandedArgs a{};
  a.kind = dc ? kind : iqk::kPlanar;
  // only whether taps_i is set is read (four parts a ring slot, not two)
  a.taps_i = complex ? reinterpret_cast<const float*>(16) : nullptr;
  a.n_tiles = n_tiles;
  a.span = span;
  a.n = n;
  a.s = s;
  a.hist = hist;
  a.g = g;
  iqk::Plan p{};
  const int rc = iqk::launch_banded(a, channels, dc != 0, &p, nullptr);
  out[0] = p.grid;
  out[1] = p.threads;
  out[2] = p.smem;
  out[3] = p.cs;
  out[4] = p.ring;
  out[5] = p.ctas_per_sm;
  out[6] = p.groups;
  out[7] = p.nbuf;
  return rc;
}
