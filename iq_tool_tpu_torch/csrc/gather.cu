// The gather resampler stage (ops/resample.py _ArbStage, kernels.gather_apply):
// output j of row block b, for each channel and plane, is the dot of the
// plan's K weights w[j, :] with ext[starts[j] + b n_in : ... + K], where
// ext = history ++ block.  The chain runs it for a ratio whose prime
// factors no split into small stages takes (4766/64043 at the HackRF's 10
// Msps, 449/36371 at 2469/200000).
//
// It replaces no TPU kernel: the JAX package runs this stage as an XLA
// gather and an einsum (iq_tool_tpu/ops/resample.py _ArbStage), outside
// any Pallas kernel, and the port ran it as torch ops: ext built by three
// cats and a transposing copy into (L, 2C), then embedding_bag's weighted
// bag sums (kernels.gather_apply_ref, the CPU twin).
//
// What bounds it on the card: bytes.  At the HackRF step (64 channels x
// 256,172 frames in, 19,064 outputs a row, K = 216, 13.44 inputs an
// output) the products are 527 M FP32 FMAs, ~16 us at the card's FP32
// rate, against the planes in (131 MB), the planes out (9.8 MB) and the
// weights (16.5 MB): ~47 us at 3.35 TB/s, once each input is read once.
//
// Design:
// * A CTA owns G groups of 4 consecutive outputs (of the flattened r x M
//   outputs: a row block's outputs follow the last one's, since the plan
//   repeats every n_in inputs) and cg channels, both planes: kCols = 2 cg
//   columns.  It stages its input span, from the first group's window
//   start to the last one's end, into shared memory once, reading the
//   history and the block planes where they lie (no concatenated copy);
//   only the halo of each CTA is read twice.  Rows are (frame, column):
//   a thread's 4 columns are one 16-byte chunk, XOR-swizzled by the row
//   so that the chunks of one frame, and one chunk of 8 frame quads, fall
//   in distinct banks.
// * Staging is what costs (at the HackRF plan, the staged input alone
//   takes two thirds of the kernel's time, the products a third): where
//   every plane row is 16-byte aligned, a thread loads 4 frames of 4
//   columns by four 16-byte streaming loads and stores them as 4 rows of
//   its chunk; the history, the ragged ends and the zeros past ext's end
//   go a frame at a time by cp.async (a frame at a time throughout, the
//   staging took 1.6 times as long).  Staging each next tile while the
//   last one is multiplied (one CTA an SM, double-buffered, every copy a
//   cp.async into column-major rows) measured no faster.
// * A thread holds a 4 x 4 register tile: the 4 outputs of its group by
//   4 columns.  It walks its group's window frame by frame: one 16-byte
//   read of the frame's 4 columns and one of the 4 outputs' weights at
//   that frame feed 16 FMAs, so each input value is read from shared
//   memory once a group and not once an output.  The weights come
//   prepared (kernels.gather_windows): each group's 4 rows on one
//   zero-padded window, output i d_i frames after the first (d_3 ~ 40 at
//   the HackRF plan), so span = max(d_3) + K frames (260 at K = 216) and
//   a frame's 4 weights are 16 bytes, copied by cp.async; the padding's
//   zeros are the price of the shared reads (83 % of the FMAs do work).
//   They serve all 2 cg columns, so their L2 traffic is C / cg times the
//   table.
// * Sums are FP32 FMAs in a fixed order, frame by frame: the window is cut
//   into `slices` runs that threads of the same (group, chunk) take, and
//   the runs' partial sums are added in run order through shared memory
//   at the end.  No atomics and no split of K across CTAs: two launches
//   give the same bits.  A window longer than the shared memory takes
//   (K of thousands of taps) is staged in passes of `pass` frames.
// * The tile is chosen on the host (kernels.gather_tiles) from what the
//   plan and the input show: K, the spacing of the outputs' windows
//   (q/p), the channels and the row blocks.  Of the column widths and
//   group counts whose shared memory fits two CTAs an SM, it takes the
//   one that stages the fewest bytes an output column.  The HackRF plan
//   gets 16 channels by 8 groups; 449/36371 (K = 1,298, q/p = 81) at 128
//   channels 8 channels by 3 groups in passes, not a second kernel.

#include <cuda_runtime.h>

namespace iqk {

constexpr int kGatherThreads = 256;

struct GatherArgs {
  const float* x_r;  // block planes (C, n), n = rows * n_in
  const float* x_i;
  const float* h_r;  // history planes (C, hist)
  const float* h_i;
  const float4* wt;     // (ceil(M / 4), span): each group's 4 weights at each frame
  const int* starts;    // (M,): output j's window starts at ext[starts[j]]
  float* y_r;           // (C, rows * M)
  float* y_i;
  int channels, n, hist, m, n_in, rows;
  int groups;     // groups of 4 outputs a CTA
  int slices;     // runs of a pass, one thread each
  int slice_len;  // frames a run (a multiple of 4)
  int span;       // a group's zero-padded window (a multiple of 4)
  int pass;       // frames of the window staged at once (a multiple of 4)
  int wstride;    // float4s between two groups' staged weights
  int tile_rows;  // the input rows staged, at most
};

// The staged input's layout for kCols columns: kB columns a chunk (a
// thread's), chunk c of row r at r * kCols + (c ^ (r / 4 mod chunks)) * kB:
// the chunks of one row, and one chunk of rows 4 apart (the quads' rows),
// fall in distinct banks.
template <int kCols>
struct Cols {
  static constexpr int kB = kCols >= 4 ? 4 : kCols;
  static constexpr int kChunks = kCols / kB;
  __device__ __forceinline__ static int at(int row, int chunk) {
    const int sw = kChunks > 1 ? (row >> 2) & (kChunks - 1) : 0;
    return row * kCols + (chunk ^ sw) * kB;
  }
};

template <int kB>
struct VecOf;
template <>
struct VecOf<4> {
  using T = float4;
};
template <>
struct VecOf<2> {
  using T = float2;
};

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}
__device__ __forceinline__ float lane_of(const float2& v, int j) { return j == 0 ? v.x : v.y; }

// 4 bytes from device memory into shared memory by cp.async, or zeros
// where !valid (the source is then not read).
__device__ __forceinline__ void copy4(float* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void copy16(float4* dst, const float4* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int kCols>
__global__ void __launch_bounds__(kGatherThreads) gather_kernel(const GatherArgs a) {
  using L = Cols<kCols>;
  constexpr int kB = L::kB;
  constexpr int kSlots = L::kChunks;  // threads of a group in a run
  constexpr int kCg = kCols / 2;      // channels a CTA
  using V = typename VecOf<kB>::T;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float4* ws = reinterpret_cast<float4*>(smem + ((a.tile_rows * kCols + 3) & ~3));

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int gr = (a.m + 3) >> 2;  // groups a row block
  const long long gi0 = static_cast<long long>(blockIdx.x) * a.groups;
  const long long left = static_cast<long long>(gr) * a.rows - gi0;
  const int ng = left < a.groups ? static_cast<int>(left) : a.groups;
  const int cg0 = blockIdx.y * kCg;
  auto origin = [&](long long gi) {
    return static_cast<long long>(a.starts[4 * static_cast<int>(gi % gr)]) +
           (gi / gr) * static_cast<long long>(a.n_in);
  };
  const long long e0 = origin(gi0);
  const int spread = static_cast<int>(origin(gi0 + ng - 1) - e0);
  const long long ext_len = static_cast<long long>(a.hist) + a.n;
  // the block planes' rows are read 16 bytes at a time where they are all
  // 16-byte aligned and a thread takes 4 columns
  const bool vec = kB == 4 && (a.n & 3) == 0 &&
                   ((reinterpret_cast<unsigned long long>(a.x_r) |
                     reinterpret_cast<unsigned long long>(a.x_i)) & 15) == 0;

  // this thread's (run, group, chunk)
  const int slot = tid % kSlots;
  const int g = (tid / kSlots) % a.groups;
  const int s = tid / (kSlots * a.groups);
  const int xo = g < ng ? static_cast<int>(origin(gi0 + g) - e0) : 0;
  const float4* wg = ws + g * a.wstride;

  float acc[4][kB];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < kB; ++j) acc[i][j] = 0.0f;
  }

  for (int p0 = 0; p0 < a.span; p0 += a.pass) {
    const int pl = min(a.pass, a.span - p0);
    if (p0 > 0) __syncthreads();  // the last pass's reads are done
    // the input rows of this pass: ext[e0 + p0 + r] for r < spread + pl,
    // zeros past ext's end (their weights are zero)
    const int len = spread + pl;
    const long long e_lo = e0 + p0;
    // the 16-byte quads of the block planes inside the rows, where every
    // plane row is 16-byte aligned (ex = e - hist a multiple of 4)
    long long v_lo = e_lo, v_hi = e_lo;
    if (vec) {
      const long long lo = (max(e_lo, static_cast<long long>(a.hist)) - a.hist + 3) & ~3LL;
      const long long hi = (min(e_lo + len, ext_len) - a.hist) & ~3LL;
      if (hi > lo) {
        v_lo = a.hist + lo;
        v_hi = a.hist + hi;
      }
    }
    const int head = static_cast<int>(v_lo - e_lo);
    const int quads = static_cast<int>(v_hi - v_lo) >> 2;
    // the rest a frame at a time: the history, the quads' ragged ends,
    // zeros past ext's end and for channels past the last
    const int rest = len - 4 * quads;
    for (int c = 0; c < kCols; ++c) {
      const int ch = cg0 + c % kCg;
      const bool live = ch < a.channels;
      const bool im = c >= kCg;
      const float* hp = (im ? a.h_i : a.h_r) + static_cast<long long>(live ? ch : 0) * a.hist;
      const float* xp = (im ? a.x_i : a.x_r) + static_cast<long long>(live ? ch : 0) * a.n;
      float* col = xs + (c % kB);
      for (int i = tid; i < rest; i += nt) {
        const int r = i < head ? i : i + 4 * quads;
        const long long e = e_lo + r;
        const bool ok = live && e < ext_len;
        const float* src = !ok ? xp : e < a.hist ? hp + e : xp + (e - a.hist);
        copy4(col + L::at(r, c / kB), src, ok);
      }
    }
    // the quads: 4 columns x 4 frames a thread, 16-byte streaming loads
    // (neighbouring threads on neighbouring quads), transposed into 4 rows
    // of the chunk
    if constexpr (kB == 4) {
      const int items = kSlots * quads;
      for (int i0 = tid; i0 < items; i0 += 2 * nt) {
        float4 v[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int it = i0 + h * nt;
          const int chunk = it / max(quads, 1);
          const long long ex = v_lo - a.hist + 4LL * (it - chunk * quads);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = chunk * 4 + j;
            const int ch = cg0 + c % kCg;
            v[h][j] = it < items && ch < a.channels
                          ? __ldcs(reinterpret_cast<const float4*>(
                                (c >= kCg ? a.x_i : a.x_r) + static_cast<long long>(ch) * a.n + ex))
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int it = i0 + h * nt;
          if (it >= items) break;
          const int chunk = it / quads;
          const int r = head + 4 * (it - chunk * quads);
          *reinterpret_cast<float4*>(xs + L::at(r, chunk)) =
              make_float4(v[h][0].x, v[h][1].x, v[h][2].x, v[h][3].x);
          *reinterpret_cast<float4*>(xs + L::at(r + 1, chunk)) =
              make_float4(v[h][0].y, v[h][1].y, v[h][2].y, v[h][3].y);
          *reinterpret_cast<float4*>(xs + L::at(r + 2, chunk)) =
              make_float4(v[h][0].z, v[h][1].z, v[h][2].z, v[h][3].z);
          *reinterpret_cast<float4*>(xs + L::at(r + 3, chunk)) =
              make_float4(v[h][0].w, v[h][1].w, v[h][2].w, v[h][3].w);
        }
      }
    }
    // this pass's frames of the tile's group windows, 16 bytes a frame
    for (int gg = 0; gg < ng; ++gg) {
      const float4* src = a.wt + static_cast<long long>((gi0 + gg) % gr) * a.span + p0;
      for (int t = tid; t < pl; t += nt) copy16(ws + gg * a.wstride + t, src + t);
    }
    copies_done();
    __syncthreads();

    if (g < ng) {
      const int t0 = s * a.slice_len;
      const int t1 = min(pl, t0 + a.slice_len);
      for (int t = t0; t < t1; t += 4) {
        float4 wv[4];
        V xv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          wv[u] = wg[t + u];
          xv[u] = *reinterpret_cast<const V*>(xs + L::at(xo + t + u, slot));
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < kB; ++j) {
              acc[i][j] = fmaf(lane_of(wv[u], i), lane_of(xv[u], j), acc[i][j]);
            }
          }
        }
      }
    }
  }

  if (a.slices > 1) {
    // the runs' partial sums, added in run order
    const int per = kSlots * a.groups;  // threads a run
    const int local = tid % per;
    __syncthreads();  // every read of the staged input and weights is done
    if (s > 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < kB; ++j) {
          smem[((s - 1) * 4 * kB + i * kB + j) * per + local] = acc[i][j];
        }
      }
    }
    __syncthreads();
    if (s == 0) {
      for (int r = 1; r < a.slices; ++r) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < kB; ++j) {
            acc[i][j] += smem[((r - 1) * 4 * kB + i * kB + j) * per + local];
          }
        }
      }
    }
  }
  if (s != 0 || g >= ng) return;

  const long long gi = gi0 + g;
  const int j0 = 4 * static_cast<int>(gi % gr);
  const long long o0 = (gi / gr) * a.m + j0;  // flattened output of the group's first
  const long long row_len = static_cast<long long>(a.rows) * a.m;
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    const int c = slot * kB + j;
    const int ch = cg0 + c % kCg;
    if (ch >= a.channels) continue;
    float* y = (c >= kCg ? a.y_i : a.y_r) + static_cast<long long>(ch) * row_len + o0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (j0 + i < a.m) y[i] = acc[i][j];
    }
  }
}

// The kernel for kCols columns with its shared memory granted, the
// carveout at its largest so that several CTAs share an SM.
template <int kCols>
cudaError_t prepare_gather(int smem) {
  cudaError_t err = cudaFuncSetAttribute(gather_kernel<kCols>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(gather_kernel<kCols>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int kCols>
cudaError_t launch_gather(const GatherArgs& a, dim3 grid, int threads, int smem,
                          cudaStream_t stream) {
  const cudaError_t err = prepare_gather<kCols>(smem);
  if (err != cudaSuccess) return err;
  gather_kernel<kCols><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace iqk

// The gather stage over a block of rows * n_in frames a channel, the
// weights as `wt` (ceil(m / 4), span, 4) floats (kernels.gather_windows), with
// the tile kernels.gather_tiles chose: `cols` columns (cols / 2 channels) and
// `groups` groups of 4 outputs a CTA, `slices` runs of `slice_len` frames,
// the window of `span` frames staged in passes of `pass`, `smem` bytes of
// shared memory.  Launch on `stream`; returns the launch's cudaError_t.
extern "C" int iq_gather_apply(const float* x_r, const float* x_i, const float* h_r,
                               const float* h_i, const float* wt, const int* starts,
                               int channels, int n, int hist, int m, int n_in, int rows,
                               int cols, int groups, int slices, int slice_len, int span,
                               int pass, int wstride, int tile_rows, int smem, float* y_r,
                               float* y_i, void* stream) {
  const int kb = cols >= 4 ? 4 : cols;
  const int threads = groups * (cols / kb) * slices;
  const long long gr = (m + 3) / 4;
  const long long ctas = (gr * rows + groups - 1) / (groups > 0 ? groups : 1);
  if (!x_r || !x_i || !h_r || !h_i || !wt || !starts || !y_r || !y_i || channels <= 0 ||
      m <= 0 || hist < 0 || rows <= 0 || n_in <= 0 ||
      static_cast<long long>(rows) * n_in != n || groups <= 0 || slices <= 0 ||
      threads > iqk::kGatherThreads || span <= 0 || span % 4 || pass <= 0 || pass % 4 ||
      slice_len <= 0 || slice_len % 4 || static_cast<long long>(slice_len) * slices < pass ||
      wstride < pass || tile_rows <= 0 || smem <= 0 || smem > 232448 || ctas > 0x7fffffff ||
      (reinterpret_cast<unsigned long long>(wt) & 15) ||
      (channels + cols / 2 - 1) / (cols / 2) > 65535) {
    return cudaErrorInvalidValue;
  }
  const iqk::GatherArgs a{x_r,    x_i,      h_r,       h_i,  reinterpret_cast<const float4*>(wt),
                          starts, y_r,      y_i,       channels, n,    hist,   m,
                          n_in,   rows,     groups,    slices,   slice_len, span, pass,
                          wstride, tile_rows};
  const dim3 grid(static_cast<unsigned>(ctas),
                  static_cast<unsigned>((channels + cols / 2 - 1) / (cols / 2)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cols) {
    case 2:
      return iqk::launch_gather<2>(a, grid, threads, smem, st);
    case 4:
      return iqk::launch_gather<4>(a, grid, threads, smem, st);
    case 8:
      return iqk::launch_gather<8>(a, grid, threads, smem, st);
    case 16:
      return iqk::launch_gather<16>(a, grid, threads, smem, st);
    case 32:
      return iqk::launch_gather<32>(a, grid, threads, smem, st);
    default:
      return cudaErrorInvalidValue;
  }
}

