// The DC-block pre-stage: one templated kernel serves three entry points.
//
// * K1's carry pass (iq_dc_carry): packed-wire decode -> DC block over
//   whole channels, writing no planes: the state before each of the
//   banded kernel's window groups, the `hist` processed (NCO-mixed)
//   samples before each group, the block's last `hist` processed samples
//   (the resampler stage's next carried history) and the new DC state.
//   The port's K1 is this launch followed by the banded kernel, which
//   decodes, DC-blocks and NCO-mixes the wire in its loader from those
//   states (csrc/banded.cu, ops/kernels.py banded_apply_dc).  Replaces,
//   with it, iq_tool_tpu/ops/pallas_kernels.py:banded_apply_dc
//   (_banded_dc_kernel with _wire_decode, _dc_plane_tile and
//   _nco_mix_base).
// * The prologue (iq_dc_prologue): the same over whole channels, writing
//   the processed planes, their last `hist` samples and the new DC state
//   (the sharded chain's stage 0, parallel/sharded.py).
// * K3 (iq_dc_block_apply): packed wire or float32 planes in -> DC block
//   -> I/Q apply I' = (1+g)I, Q' = Q + phi*I -> NCO mix, writing the
//   planes and the new DC state, no tail.  Replaces
//   iq_tool_tpu/ops/pallas_kernels.py:dc_block_apply (_dc_kernel).  It
//   takes any N: the TPU's N % 128 gate (dc_geometry) is not copied.
//
// All are the same recurrence with a different front and back, so they
// share one __global__ with template flags (planar input, I/Q apply,
// carry pass) and a runtime tail pointer.  The DC state written is the
// pre-I/Q, pre-NCO state, as _dc_kernel writes it.
//
// What bounds it on the card: bytes.  Per sample it reads one packed
// wire element (4 B for 16-bit wires, 2 B for 8-bit) or two float32
// planes (8 B) and writes two float32 planes (8 B); the carry pass writes
// ~0.4 % of that (33 floats a group of 32 s samples).
//
// The TPU kernels carry the DC state from one time tile to the next in
// scratch memory, which relies on the TPU walking tiles in order.  Here
// the grid is (tiles, C): every tile of kDcTile samples of every channel
// is its own CTA, and the recurrence y[n] = a*y[n-1] + x[n] - x[n-1]
// crosses tiles by a single-pass chained scan with decoupled look-back
// (Merrill & Garland 2016, the design of CUB's DeviceScan):
//
// * The input term x[n] - x[n-1] needs only the sample before the tile,
//   read from the input (tile 0 takes the carried x), so the one carry
//   between tiles is y.  A tile's aggregate A (its y at the end, from
//   y = 0 at its start) composes as y_out = a^T y_in + A.
// * A tile is loaded with 16-byte loads (neighbouring threads on
//   neighbouring chunks) when the rows are 16-byte aligned, decoded into
//   shared memory, and each thread runs its row of kDcPer consecutive
//   samples from zero; a 5-level warp-shuffle scan and one Horner pass
//   over the warp totals carry that across threads (constant coefficient
//   a^kDcPer per thread).  Four barriers a tile.
// * Every tile publishes A.  Tiles come in groups of kDcGroup: the last
//   tile q of each group also publishes its inclusive y.  Tile t folds
//   the aggregates of the tiles of its own group before it and the
//   inclusive y of the previous group's last tile (or the carried DC
//   state), one lane a tile, in one fixed warp reduction.  The
//   combination order is the same on every run, so two runs on the same
//   input give the same bits.  The chain of waits is one per group.
// * Each status word holds the launch's sequence number (from the
//   wrapper), so the scratch buffer needs no clearing launch: a word left
//   by an earlier launch never matches.  Flags are written with release
//   and read with acquire semantics after the value they guard; waiting
//   lanes back off with __nanosleep.  CTAs of one channel are dispatched
//   in blockIdx.x order, so a tile waits only on tiles already resident
//   or done.
// * Then each thread reruns its samples from its true incoming y, rounds
//   each to float32 once, applies the I/Q correction and the NCO at the
//   global sample index, back into its row; the tile then stores from
//   shared memory with 16-byte stores, neighbouring threads on
//   neighbouring chunks.  (Each thread loading and storing its own row
//   straight from registers, 16 bytes at a time, measured markedly
//   slower: a warp's stores then half-fill 64 sectors each.)
//
// The recurrence runs in float64 (the decoded samples and the outputs
// stay float32): the pole keeps every rounding error for ~32.6k samples,
// and in float32 two equally valid summation orders already differ at
// ~100 dB on a full-scale noise wire.

#include <cuda_runtime.h>

#include "wire.cuh"

namespace iqk {

constexpr int log2i(int v) { return v > 1 ? 1 + log2i(v / 2) : 0; }

constexpr int kDcThreads = 256;
constexpr int kDcWarps = kDcThreads / 32;
constexpr int kDcPer = 16;                      // samples a thread
constexpr int kDcTile = kDcThreads * kDcPer;    // samples a tile (CTA)
constexpr int kDcPad = kDcPer + 1;              // staged row stride: no bank conflicts
constexpr int kDcGroup = 32;                    // tiles a look-back group
constexpr int kDcLevels = log2i(kDcThreads) + 1;  // a^(kDcPer 2^k): up to a^kDcTile
constexpr int kDcMinBlocks = 6;                 // CTAs an SM keeps resident
constexpr unsigned kDcSleepMax = 1024;          // ns, the look-back's longest backoff
static_assert(kDcTile == kDcPer << (kDcLevels - 1), "a^T is the last level");
static_assert(kDcPer % 8 == 0, "a thread's row takes whole 16-byte chunks");
static_assert(kDcThreads >= 32 + kDcLevels, "a thread for each level");

// The look-back scratch of one launch: for each (channel, tile) the
// aggregate and the inclusive y (r, i) and their two status words.
struct DcLook {
  double2* agg;
  double2* inc;
  unsigned* agg_flag;
  unsigned* inc_flag;
};

__host__ __device__ inline long long dc_tiles(int n) {
  return (static_cast<long long>(n) + kDcTile - 1) / kDcTile;
}

__device__ __forceinline__ DcLook dc_look(void* base, long long entries) {
  DcLook l;
  l.agg = static_cast<double2*>(base);
  l.inc = l.agg + entries;
  l.agg_flag = reinterpret_cast<unsigned*>(l.inc + entries);
  l.inc_flag = l.agg_flag + entries;
  return l;
}

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
  void* look;     // scratch of iq_dc_scratch_bytes(C, n) bytes
  unsigned seq;   // this launch's sequence number, never 0
  int vec;        // rows 16-byte aligned and n % 8 == 0: vector loads/stores
  // the carry pass only: the fused banded kernel's window groups, each bw
  // = 32 s samples wide (ops/kernels.py BAND_WIN), `groups` a channel
  int bw;
  int groups;
  double* bound;  // (C, groups, 4) [yr, yi, xr, xi] before each group
  float* halo_r;  // (C, groups, hist) processed samples before each group
  float* halo_i;
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void wait_flag(const unsigned* p, unsigned seq) {
  unsigned ns = 32;
  while (ld_acquire(p) != seq) {
    __nanosleep(ns);
    if (ns < kDcSleepMax) ns <<= 1;
  }
}

// Publish a value, then its status word.
__device__ __forceinline__ void publish(double2* slot, unsigned* flag,
                                        double r, double i, unsigned seq) {
  *slot = make_double2(r, i);
  __threadfence();
  st_release(flag, seq);
}

// Staged position of tile sample `idx`: thread idx / kDcPer's row.
__device__ __forceinline__ int staged(int idx) {
  return (idx / kDcPer) * kDcPad + idx % kDcPer;
}

// One sample of a wire row or of the planes, decoded.
template <bool kPlanarIn>
__device__ __forceinline__ void load_one(const DcArgs& a, const char* row,
                                         long long row0, long long idx,
                                         float* vr, float* vi) {
  if constexpr (kPlanarIn) {
    *vr = a.x_r[row0 + idx];
    *vi = a.x_i[row0 + idx];
  } else {
    wire_decode(row, a.kind, idx, a.norm, a.gain, vr, vi);
  }
}

// The tile's `len` samples from s0, decoded into the staged rows: 16-byte
// loads, neighbouring threads on neighbouring chunks, when the rows are
// aligned, else one element a thread at a time.  A thread's loads are
// all issued before the first is used.
template <bool kPlanarIn>
__device__ __forceinline__ void load_tile(const DcArgs& a, const char* row,
                                          int elem, long long row0,
                                          long long s0, int len, float* sr,
                                          float* si) {
  const int tid = threadIdx.x;
  constexpr int kChunks = kDcPer / 4;  // 16-byte chunks a thread, 4 samples each
  if (a.vec) {
    if constexpr (kPlanarIn) {
      const float4* xr4 = reinterpret_cast<const float4*>(a.x_r + row0 + s0);
      const float4* xi4 = reinterpret_cast<const float4*>(a.x_i + row0 + s0);
      const int chunks = len >> 2;
      float4 br[kChunks], bi[kChunks];
#pragma unroll
      for (int r = 0; r < kChunks; ++r) {
        const int k = tid + r * kDcThreads;
        if (k < chunks) {
          br[r] = __ldg(xr4 + k);
          bi[r] = __ldg(xi4 + k);
        }
      }
#pragma unroll
      for (int r = 0; r < kChunks; ++r) {
        const int k = tid + r * kDcThreads;
        if (k < chunks) {
          const float vr[4] = {br[r].x, br[r].y, br[r].z, br[r].w};
          const float vi[4] = {bi[r].x, bi[r].y, bi[r].z, bi[r].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sr[staged(4 * k + e)] = vr[e];
            si[staged(4 * k + e)] = vi[e];
          }
        }
      }
    } else {
      const int4* w4 = reinterpret_cast<const int4*>(row + s0 * elem);
      const int per = 16 / elem;  // samples a chunk: 4 (16-bit kinds) or 8
      const int chunks = len / per;
      int4 buf[kChunks];
#pragma unroll
      for (int r = 0; r < kChunks; ++r) {
        const int k = tid + r * kDcThreads;
        if (k < chunks) buf[r] = __ldg(w4 + k);
      }
#pragma unroll
      for (int r = 0; r < kChunks; ++r) {
        const int k = tid + r * kDcThreads;
        if (k >= chunks) continue;
        const int w[4] = {buf[r].x, buf[r].y, buf[r].z, buf[r].w};
        float vr, vi;
        if (elem == 4) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            wire_decode_value(w[e], a.kind, a.norm, a.gain, &vr, &vi);
            sr[staged(4 * k + e)] = vr;
            si[staged(4 * k + e)] = vi;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            // element e of the chunk: the low or high int16 of word e / 2,
            // sign-extended as wire_load returns it
            const int v = static_cast<int>(
                static_cast<short>((e & 1) ? (w[e >> 1] >> 16) : w[e >> 1]));
            wire_decode_value(v, a.kind, a.norm, a.gain, &vr, &vi);
            sr[staged(8 * k + e)] = vr;
            si[staged(8 * k + e)] = vi;
          }
        }
      }
    }
  } else {
#pragma unroll 4
    for (int idx = tid; idx < len; idx += kDcThreads) {
      float vr, vi;
      load_one<kPlanarIn>(a, row, row0, s0 + idx, &vr, &vi);
      sr[staged(idx)] = vr;
      si[staged(idx)] = vi;
    }
  }
}

template <bool kPlanarIn, bool kIq, bool kCarry>
__global__ void __launch_bounds__(kDcThreads, kDcMinBlocks) dc_kernel(const DcArgs a) {
  __shared__ float stage_r[kDcThreads * kDcPad];
  __shared__ float stage_i[kDcThreads * kDcPad];
  __shared__ double level[kDcLevels];  // a^(kDcPer * 2^k)
  __shared__ double lane_pow[32];      // a^(kDcPer * lane)
  __shared__ double warp_r[kDcWarps];  // warp totals from y = 0 at the tile start
  __shared__ double warp_i[kDcWarps];
  __shared__ double y_before[2];       // y of the sample before the tile
  __shared__ float x_before[2];        // x of the sample before the tile

  const int tile = blockIdx.x;
  const int tiles = gridDim.x;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = a.n;
  const long long row0 = static_cast<long long>(c) * n;
  const long long s0 = static_cast<long long>(tile) * kDcTile;
  const int len = static_cast<int>(n - s0 < kDcTile ? n - s0 : kDcTile);
  const char* row = nullptr;
  int elem = 0;
  if constexpr (!kPlanarIn) {
    elem = a.kind == kCs16 || a.kind == kCu16 ? 4 : 2;
    row = static_cast<const char*>(a.wire) + row0 * elem;
  }
  const double pa = a.a;
  const DcLook look = dc_look(a.look, static_cast<long long>(gridDim.y) * tiles);
  const long long slot = static_cast<long long>(c) * tiles + tile;

  load_tile<kPlanarIn>(a, row, elem, row0, s0, len, stage_r, stage_i);
  const double my_pow = ipow(pa, kDcPer * tid);  // a^(kDcPer tid)
  if (tid < 32) lane_pow[tid] = my_pow;
  if (tid >= 32 && tid < 32 + kDcLevels) level[tid - 32] = ipow(pa, kDcPer << (tid - 32));
  if constexpr (kCarry) {
    if (tile == 0) {
      // group 0 starts from the carried state; halo entries before the
      // block (the banded kernel takes those from its carried history)
      // are zeroed
      if (tid < 4) {
        a.bound[static_cast<long long>(c) * a.groups * 4 + tid] = a.dc_in[c * 4 + (tid + 2) % 4];
      }
      for (long long g = 0; g < a.groups && g * a.bw < a.hist; ++g) {
        const long long h0 = (static_cast<long long>(c) * a.groups + g) * a.hist;
        for (long long j = tid; j < a.hist - g * a.bw; j += kDcThreads) {
          a.halo_r[h0 + j] = 0.0f;
          a.halo_i[h0 + j] = 0.0f;
        }
      }
    }
  }
  if (tid == 0) {
    if (tile == 0) {
      x_before[0] = a.dc_in[c * 4];
      x_before[1] = a.dc_in[c * 4 + 1];
    } else {
      load_one<kPlanarIn>(a, row, row0, s0 - 1, &x_before[0], &x_before[1]);
    }
  }
  __syncthreads();

  // this thread's samples from y = 0; x[n-1] of its first sample is the
  // previous thread's last
  float* my_r = stage_r + tid * kDcPad;
  float* my_i = stage_i + tid * kDcPad;
  const int first = tid * kDcPer;
  const int m = len - first <= 0 ? 0 : (len - first >= kDcPer ? kDcPer : len - first);
  const double px_r = tid ? stage_r[tid * kDcPad - kDcPad + kDcPer - 1] : x_before[0];
  const double px_i = tid ? stage_i[tid * kDcPad - kDcPad + kDcPer - 1] : x_before[1];
  double er = 0.0, ei = 0.0;
  {
    double pr = px_r, pi = px_i;
#pragma unroll
    for (int j = 0; j < kDcPer; ++j) {
      if (j < m) {
        const double xr = my_r[j], xi = my_i[j];
        er = fma(pa, er, xr - pr);
        ei = fma(pa, ei, xi - pi);
        pr = xr;
        pi = xi;
      }
    }
  }
  // warp scan of the thread ends: every thread before the last valid one
  // holds kDcPer samples, so each level's coefficient is one constant
  double sr = er, si = ei;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const double ur = __shfl_up_sync(0xffffffffu, sr, 1 << k);
    const double ui = __shfl_up_sync(0xffffffffu, si, 1 << k);
    if (lane >= (1 << k)) {
      sr = fma(level[k], ur, sr);
      si = fma(level[k], ui, si);
    }
  }
  double zr = __shfl_up_sync(0xffffffffu, sr, 1);
  double zi = __shfl_up_sync(0xffffffffu, si, 1);
  if (lane == 0) zr = zi = 0.0;
  if (lane == 31) {
    warp_r[warp] = sr;
    warp_i[warp] = si;
  }
  __syncthreads();
  {
    // y at the end of the warp before, from y = 0 at the tile start
    double wr = 0.0, wi = 0.0;
    for (int v = 0; v < warp; ++v) {
      wr = fma(level[5], wr, warp_r[v]);
      wi = fma(level[5], wi, warp_i[v]);
    }
    zr = fma(lane_pow[lane], wr, zr);
    zi = fma(lane_pow[lane], wi, zi);
  }

  // The carry pass keeps nothing of a tile that holds no sample before a
  // group boundary, no halo or tail sample and not the block's last, and
  // that publishes no inclusive y: the tile publishes its aggregate and
  // stops, with no look-back.
  bool keeps = true;
  if constexpr (kCarry) {
    const long long g1 = s0 / a.bw + 1;  // the first boundary after s0
    keeps = s0 + len > n - max(a.hist, 1) ||
            (g1 < a.groups && g1 * a.bw - max(a.hist, 1) < s0 + len) ||
            ((tile & (kDcGroup - 1)) == kDcGroup - 1 && tile + 1 < tiles);
  }
  if (!keeps && warp != 0) return;
  if (warp == 0) {
    double agg_r = 0.0, agg_i = 0.0;
    if (lane == 0) {
      for (int v = 0; v < kDcWarps; ++v) {
        agg_r = fma(level[5], agg_r, warp_r[v]);
        agg_i = fma(level[5], agg_i, warp_i[v]);
      }
      if (tile + 1 < tiles) {
        publish(look.agg + slot, look.agg_flag + slot, agg_r, agg_i, a.seq);
      }
    }
    if (!keeps) return;
    // look-back: lane l < na takes tile - 1 - l's aggregate, lane na the
    // inclusive y of the previous group's last tile (or the carried
    // state), each times a^(T l)
    const int na = tile & (kDcGroup - 1);
    double vr = 0.0, vi = 0.0;
    if (lane <= na) {
      const int p = tile - 1 - lane;
      double2 v;
      if (lane < na) {
        wait_flag(look.agg_flag + slot - 1 - lane, a.seq);
        v = __ldcg(look.agg + slot - 1 - lane);
      } else if (p < 0) {
        v = make_double2(a.dc_in[c * 4 + 2], a.dc_in[c * 4 + 3]);
      } else {
        wait_flag(look.inc_flag + slot - 1 - lane, a.seq);
        v = __ldcg(look.inc + slot - 1 - lane);
      }
      const double co = ipow(pa, kDcTile * lane);
      vr = co * v.x;
      vi = co * v.y;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      vr += __shfl_xor_sync(0xffffffffu, vr, off);
      vi += __shfl_xor_sync(0xffffffffu, vi, off);
    }
    if (lane == 0) {
      y_before[0] = vr;
      y_before[1] = vi;
      if (na == kDcGroup - 1 && tile + 1 < tiles) {
        publish(look.inc + slot, look.inc_flag + slot,
                fma(level[kDcLevels - 1], vr, agg_r),
                fma(level[kDcLevels - 1], vi, agg_i), a.seq);
      }
    }
  }
  __syncthreads();

  // the carry pass keeps, of this thread's row, the sample before a group
  // boundary (row position rec_j) and the samples (bits of `keep`) in the
  // halos before the boundaries and in the tail
  int rec_j = -1;
  unsigned keep = 0;
  if constexpr (kCarry) {
    const int f = static_cast<int>(s0) + first;
    const int g_lo = f / a.bw + 1;
    if (g_lo < a.groups && g_lo * a.bw <= f + kDcPer) rec_j = g_lo * a.bw - 1 - f;
    const int g_hi = min(a.groups - 1, (f + kDcPer - 1 + a.hist) / a.bw);
    // bits [lo - f, hi - f) of the row
    auto span = [f](int lo, int hi) {
      lo = max(lo - f, 0);
      hi = min(hi - f, kDcPer);
      return lo < hi ? ((1u << hi) - 1u) & ~((1u << lo) - 1u) : 0u;
    };
    if (g_lo <= g_hi) keep = span(g_lo * a.bw - a.hist, g_hi * a.bw);
    keep |= span(n - a.hist, n);
    // only rows that hold a group state, a halo or tail sample or the
    // block's last sample are rerun
    if (rec_j < 0 && keep == 0 && !(m > 0 && f + m == n)) return;
  }

  // rerun this thread's samples from its true incoming y
  const unsigned ph0 = a.dtheta ? static_cast<unsigned>(a.phase[c]) : 0u;
  float g1 = 1.0f, phi = 0.0f;
  if constexpr (kIq) {
    g1 = __fadd_rn(1.0f, a.iq[c * 2]);
    phi = a.iq[c * 2 + 1];
  }
  {
    double yr = fma(my_pow, y_before[0], zr);
    double yi = fma(my_pow, y_before[1], zi);
    double pr = px_r, pi = px_i;
#pragma unroll
    for (int j = 0; j < kDcPer; ++j) {
      if (j < m) {
        const float xr = my_r[j], xi = my_i[j];
        yr = fma(pa, yr, static_cast<double>(xr) - pr);
        yi = fma(pa, yi, static_cast<double>(xi) - pi);
        pr = xr;
        pi = xi;
        const long long idx = s0 + first + j;
        if (idx == n - 1) {
          a.dc_out[c * 4] = xr;
          a.dc_out[c * 4 + 1] = xi;
          a.dc_out[c * 4 + 2] = static_cast<float>(yr);
          a.dc_out[c * 4 + 3] = static_cast<float>(yi);
        }
        if constexpr (kCarry) {
          if (j == rec_j) {
            double* b = a.bound + (static_cast<long long>(c) * a.groups + (idx + 1) / a.bw) * 4;
            b[0] = yr;
            b[1] = yi;
            b[2] = xr;
            b[3] = xi;
          }
          if ((keep >> j) & 1u) {
            float vr = static_cast<float>(yr);
            float vi = static_cast<float>(yi);
            if (a.dtheta) nco_rotate(ph0, a.dtheta, idx, &vr, &vi);
            const int at = static_cast<int>(idx);
            if (at >= n - a.hist) {
              a.tail_r[static_cast<long long>(c) * a.hist + (at - (n - a.hist))] = vr;
              a.tail_i[static_cast<long long>(c) * a.hist + (at - (n - a.hist))] = vi;
            }
            for (int g = at / a.bw + 1; g < a.groups && g * a.bw - a.hist <= at; ++g) {
              const long long h = (static_cast<long long>(c) * a.groups + g) * a.hist +
                                  (at - (g * a.bw - a.hist));
              a.halo_r[h] = vr;
              a.halo_i[h] = vi;
            }
          }
          continue;
        }
        float vr = static_cast<float>(yr);
        float vi = static_cast<float>(yi);
        if constexpr (kIq) {
          // I' = (1+g) I, Q' = Q + phi I (ops/iq_balance.py apply_planar)
          const float qr = __fmul_rn(vr, g1);
          vi = __fadd_rn(vi, __fmul_rn(phi, vr));
          vr = qr;
        }
        if (a.dtheta) nco_rotate(ph0, a.dtheta, idx, &vr, &vi);
        my_r[j] = vr;
        my_i[j] = vi;
      }
    }
  }
  if constexpr (kCarry) return;  // no planes
  __syncthreads();

  const long long tail0 = n - a.hist;
  if (a.vec) {
    float4* yr4 = reinterpret_cast<float4*>(a.y_r + row0 + s0);
    float4* yi4 = reinterpret_cast<float4*>(a.y_i + row0 + s0);
    for (int k = tid; k < (len >> 2); k += kDcThreads) {
      float vr[4], vi[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        vr[e] = stage_r[staged(4 * k + e)];
        vi[e] = stage_i[staged(4 * k + e)];
      }
      yr4[k] = make_float4(vr[0], vr[1], vr[2], vr[3]);
      yi4[k] = make_float4(vi[0], vi[1], vi[2], vi[3]);
      if (a.tail_r != nullptr && s0 + 4 * k + 3 >= tail0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long idx = s0 + 4 * k + e;
          if (idx >= tail0) {
            a.tail_r[static_cast<long long>(c) * a.hist + (idx - tail0)] = vr[e];
            a.tail_i[static_cast<long long>(c) * a.hist + (idx - tail0)] = vi[e];
          }
        }
      }
    }
  } else {
    for (int r = tid; r < len; r += kDcThreads) {
      const long long idx = s0 + r;
      const float vr = stage_r[staged(r)];
      const float vi = stage_i[staged(r)];
      a.y_r[row0 + idx] = vr;
      a.y_i[row0 + idx] = vi;
      if (a.tail_r != nullptr && idx >= tail0) {
        a.tail_r[static_cast<long long>(c) * a.hist + (idx - tail0)] = vr;
        a.tail_i[static_cast<long long>(c) * a.hist + (idx - tail0)] = vi;
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
}


int launch_dc(DcArgs a, int channels, bool planar_in, bool iq, bool carry,
              cudaStream_t stream) {
  if (channels <= 0 || channels > 65535 || a.n <= 0 ||
      (planar_in && (!a.x_r || !a.x_i)) ||
      (!planar_in && (!a.wire || a.kind == kPlanar)) || (iq && !a.iq) ||
      (a.dtheta && !a.phase) || !a.look || a.seq == 0 ||
      (a.tail_r && (a.hist < 0 || a.hist > a.n)) ||
      (carry && (planar_in || iq || !a.tail_r || !a.tail_i || !a.bound ||
                 !a.halo_r || !a.halo_i || a.bw <= 0 || a.groups <= 0 ||
                 static_cast<long long>(a.groups - 1) * a.bw >= a.n)) ||
      (!carry && (!a.y_r || !a.y_i))) {
    return cudaErrorInvalidValue;
  }
  const bool in_aligned = planar_in ? aligned16(a.x_r) && aligned16(a.x_i)
                                    : aligned16(a.wire);
  a.vec = a.n % 8 == 0 && in_aligned && aligned16(a.y_r) && aligned16(a.y_i);
  const dim3 grid(static_cast<unsigned>(dc_tiles(a.n)), channels);
  if (carry) {
    dc_kernel<false, false, true><<<grid, kDcThreads, 0, stream>>>(a);
  } else if (planar_in) {
    if (iq) {
      dc_kernel<true, true, false><<<grid, kDcThreads, 0, stream>>>(a);
    } else {
      dc_kernel<true, false, false><<<grid, kDcThreads, 0, stream>>>(a);
    }
  } else {
    if (iq) {
      dc_kernel<false, true, false><<<grid, kDcThreads, 0, stream>>>(a);
    } else {
      dc_kernel<false, false, false><<<grid, kDcThreads, 0, stream>>>(a);
    }
  }
  return cudaGetLastError();
}

}  // namespace iqk

// Bytes of the look-back scratch a launch over (channels, n) needs.  The
// caller keeps one buffer per stream, zeroed once when it is allocated,
// and passes a new nonzero sequence number to every launch.
extern "C" long long iq_dc_scratch_bytes(int channels, int n) {
  return static_cast<long long>(channels) * iqk::dc_tiles(n) *
         (2 * sizeof(double2) + 2 * sizeof(unsigned));
}

// The tiling, for the host's emulation and tests: out[0..2] = threads a
// CTA, samples a thread, tiles a look-back group.
extern "C" void iq_dc_geometry(int* out) {
  out[0] = iqk::kDcThreads;
  out[1] = iqk::kDcPer;
  out[2] = iqk::kDcGroup;
}

// K1 prologue.  Launch on `stream`; returns the launch's cudaError_t.
extern "C" int iq_dc_prologue(const void* wire, int kind, float norm,
                              float gain, const float* dc_in, double a,
                              const long long* phase, unsigned dtheta,
                              int channels, int n, int hist, float* y_r,
                              float* y_i, float* tail_r, float* tail_i,
                              float* dc_out, void* look, unsigned seq,
                              void* stream) {
  if (!tail_r || !tail_i) return cudaErrorInvalidValue;
  iqk::DcArgs args{wire, kind, norm, gain, nullptr, nullptr, dc_in, a,
                   nullptr, phase, dtheta, n, hist, y_r, y_i, tail_r, tail_i,
                   dc_out, look, seq, 0};
  return iqk::launch_dc(args, channels, false, false, false,
                        static_cast<cudaStream_t>(stream));
}

// K1's carry pass: the prologue's recurrence over the packed wire, writing
// no planes.  For the fused banded kernel's window groups (group g starts
// at sample g * bw, bw = 32 s; groups = ceil((n / s) / 32)) it writes the
// state just before each group (bound, float64 [yr, yi, xr, xi]; group 0's
// is dc_in's) and the `hist` processed samples before it (halo; entries
// before the block are zeroed), and, as the prologue, the block's last
// `hist` processed samples and the new DC state.
extern "C" int iq_dc_carry(const void* wire, int kind, float norm, float gain,
                           const float* dc_in, double a, const long long* phase,
                           unsigned dtheta, int channels, int n, int hist, int bw,
                           int groups, double* bound, float* halo_r, float* halo_i,
                           float* tail_r, float* tail_i, float* dc_out, void* look,
                           unsigned seq, void* stream) {
  iqk::DcArgs args{wire, kind, norm, gain, nullptr, nullptr, dc_in, a,
                   nullptr, phase, dtheta, n, hist, nullptr, nullptr, tail_r, tail_i,
                   dc_out, look, seq, 0, bw, groups, bound, halo_r, halo_i};
  return iqk::launch_dc(args, channels, false, false, true,
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
                                 float* dc_out, void* look, unsigned seq,
                                 void* stream) {
  iqk::DcArgs args{wire, kind, norm, gain, x_r, x_i, dc_in, a, iq, phase,
                   dtheta, n, 0, y_r, y_i, nullptr, nullptr, dc_out, look,
                   seq, 0};
  return iqk::launch_dc(args, channels, kind == iqk::kPlanar, iq != nullptr, false,
                        static_cast<cudaStream_t>(stream));
}
