// K3pre: the chain's pre-stage when it has no DC block.  Packed wire or
// float32 planes in -> I/Q apply I' = (1+g)I, Q' = Q + phi*I -> NCO mix,
// writing the two float32 planes, in one pass.
//
// It replaces no TPU kernel: the JAX chain runs this stage as XLA
// elementwise ops (iq_tool_tpu/pipeline/chain.py, the no-DC branch of
// _pre), as the port did in torch ops (convert.to_planar,
// iq_balance.apply_planar, nco.mix: some twenty elementwise kernels a
// step, the int64 phase arithmetic most of their time).  With a DC block
// the same work runs inside K3 (csrc/banded_dc.cu); that kernel's tiling
// (4096-sample CTAs, four barriers, the look-back scratch) exists only
// for the DC scan, so this one shares nothing with it but the device
// helpers of wire.cuh, and rounds as K3 does: the _rn intrinsics keep
// nvcc from contracting a multiply and an add, so every value rounds as
// in the plain twin (ops/kernels.py pre_apply_ref) up to sin and cos.
//
// What bounds it on the card: bytes.  Per frame it reads one packed wire
// element (4 B for 16-bit wires, 2 B for 8-bit) or two float32 planes
// (8 B) and writes two float32 planes (8 B); the sincos and the rotation
// are ~40 float32 operations a frame, under a fifth of the bytes' time.
// Design: a (tiles, C) grid of 256-thread CTAs, no shared memory and no
// barrier.  A row is cut into 4-frame vectors from its first 16-byte
// aligned output frame: a 16-byte load of the 16-bit wire (8 bytes of an
// 8-bit wire, two 16-byte loads of planes) and one 16-byte store to each
// plane a vector, neighbouring threads on neighbouring vectors, each
// thread's four vectors loaded before the first is used.  The up to
// three frames before the first aligned one and after the last whole
// vector are CTA 0's, one a thread.  A row whose input cannot be read in
// vectors at the output's alignment (a wire view at an odd offset) runs
// one frame a thread, coalesced, over the same grid.

#include <cuda_runtime.h>

#include "wire.cuh"

namespace iqk {

constexpr int kPreThreads = 256;
constexpr int kPreVecs = 4;                              // vectors a thread
constexpr int kPreTile = kPreThreads * kPreVecs * 4;     // frames a CTA

struct PreArgs {
  const void* wire;  // packed wire (C, n), or
  int kind;
  float norm;
  float gain;
  const float* x_r;  // planar input (C, n)
  const float* x_i;
  const float* iq;   // (C, 2) [g, phi], or null
  const long long* phase;  // (C,) uint32 NCO phase of frame 0, or null
  unsigned dtheta;
  int n;
  float* y_r;
  float* y_i;
};

// A vector of 4 input frames: kElem 4 (int32 wire elements), 2 (int16)
// or 0 (planes).
template <int kElem>
struct PreVec {
  int4 w;
  float4 r, i;
};

template <int kElem>
__device__ __forceinline__ PreVec<kElem> load_vec(const void* in_r, const float* in_i,
                                                  long long k) {
  PreVec<kElem> v;
  if constexpr (kElem == 4) {
    v.w = __ldg(static_cast<const int4*>(in_r) + k);
  } else if constexpr (kElem == 2) {
    const int2 h = __ldg(static_cast<const int2*>(in_r) + k);
    v.w = make_int4(h.x, h.y, 0, 0);
  } else {
    v.r = __ldg(static_cast<const float4*>(in_r) + k);
    v.i = __ldg(reinterpret_cast<const float4*>(in_i) + k);
  }
  return v;
}

// Frame e of a vector, decoded.
template <int kElem>
__device__ __forceinline__ void vec_frame(const PreArgs& a, const PreVec<kElem>& v, int e,
                                          float* xr, float* xi) {
  if constexpr (kElem == 0) {
    const float r[4] = {v.r.x, v.r.y, v.r.z, v.r.w};
    const float i[4] = {v.i.x, v.i.y, v.i.z, v.i.w};
    *xr = r[e];
    *xi = i[e];
  } else {
    const int w[4] = {v.w.x, v.w.y, v.w.z, v.w.w};
    // 8-bit kinds: the low or high int16 of word e / 2, sign-extended as
    // wire_load returns it
    const int el = kElem == 4 ? w[e]
                              : static_cast<int>(static_cast<short>(
                                    (e & 1) ? (w[e >> 1] >> 16) : w[e >> 1]));
    wire_decode_value(el, a.kind, a.norm, a.gain, xr, xi);
  }
}

// Frame `idx` of a row, decoded.
template <int kElem>
__device__ __forceinline__ void load_frame(const PreArgs& a, const void* in_r,
                                           const float* in_i, long long idx, float* xr,
                                           float* xi) {
  if constexpr (kElem == 0) {
    *xr = static_cast<const float*>(in_r)[idx];
    *xi = in_i[idx];
  } else {
    wire_decode(in_r, a.kind, idx, a.norm, a.gain, xr, xi);
  }
}

// I/Q apply, then the NCO at the frame's index in the block.
template <bool kIq>
__device__ __forceinline__ void pre_frame(const PreArgs& a, float g1, float phi, unsigned ph0,
                                          long long idx, float* xr, float* xi) {
  if constexpr (kIq) {
    // I' = (1+g) I, Q' = Q + phi I (ops/iq_balance.py apply_planar)
    const float qr = __fmul_rn(*xr, g1);
    *xi = __fadd_rn(*xi, __fmul_rn(phi, *xr));
    *xr = qr;
  }
  if (a.dtheta) nco_rotate(ph0, a.dtheta, idx, xr, xi);
}

template <int kElem, bool kIq>
__global__ void __launch_bounds__(kPreThreads) pre_kernel(const PreArgs a) {
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const int n = a.n;
  const long long row0 = static_cast<long long>(c) * n;
  const void* in_r;
  const float* in_i = nullptr;
  if constexpr (kElem == 0) {
    in_r = a.x_r + row0;
    in_i = a.x_i + row0;
  } else {
    in_r = static_cast<const char*>(a.wire) + row0 * kElem;
  }
  float* out_r = a.y_r + row0;
  float* out_i = a.y_i + row0;
  const unsigned ph0 = a.dtheta ? static_cast<unsigned>(a.phase[c]) : 0u;
  float g1 = 1.0f, phi = 0.0f;
  if constexpr (kIq) {
    g1 = __fadd_rn(1.0f, a.iq[c * 2]);
    phi = a.iq[c * 2 + 1];
  }

  // the row's vectors start at its first 16-byte aligned output frame
  const unsigned long long ar = reinterpret_cast<unsigned long long>(out_r);
  const int head_raw = static_cast<int>(((16u - (ar & 15u)) & 15u) >> 2);
  const int head = head_raw < n ? head_raw : n;
  const unsigned in_align = kElem == 2 ? 8u : 16u;
  const unsigned long long ain =
      reinterpret_cast<unsigned long long>(in_r) + static_cast<unsigned long long>(head) *
                                                       (kElem == 0 ? 4 : kElem);
  bool vec = (ar & 3u) == 0 && ((reinterpret_cast<unsigned long long>(out_i) ^ ar) & 15u) == 0 &&
             (ain & (in_align - 1)) == 0;
  if constexpr (kElem == 0) {
    vec = vec && ((reinterpret_cast<unsigned long long>(in_i + head) & 15u) == 0);
  }

  if (!vec) {
    // one frame a thread, neighbouring threads on neighbouring frames
    const long long f0 = static_cast<long long>(blockIdx.x) * kPreTile;
#pragma unroll 4
    for (int j = 0; j < kPreTile / kPreThreads; ++j) {
      const long long idx = f0 + j * kPreThreads + tid;
      if (idx < n) {
        float xr, xi;
        load_frame<kElem>(a, in_r, in_i, idx, &xr, &xi);
        pre_frame<kIq>(a, g1, phi, ph0, idx, &xr, &xi);
        out_r[idx] = xr;
        out_i[idx] = xi;
      }
    }
    return;
  }

  const long long nv = (n - head) >> 2;  // whole vectors
  if (blockIdx.x == 0 && tid < 8) {
    // the head's frames, then the tail's past the last whole vector
    const long long idx = tid < 4 ? tid : head + 4 * nv + (tid - 4);
    if ((tid < 4 && idx < head) || (tid >= 4 && idx < n)) {
      float xr, xi;
      load_frame<kElem>(a, in_r, in_i, idx, &xr, &xi);
      pre_frame<kIq>(a, g1, phi, ph0, idx, &xr, &xi);
      out_r[idx] = xr;
      out_i[idx] = xi;
    }
  }
  const void* vin_r = static_cast<const char*>(in_r) + head * (kElem == 0 ? 4 : kElem);
  const float* vin_i = kElem == 0 ? in_i + head : nullptr;
  float4* vout_r = reinterpret_cast<float4*>(out_r + head);
  float4* vout_i = reinterpret_cast<float4*>(out_i + head);
  const long long k0 = static_cast<long long>(blockIdx.x) * (kPreThreads * kPreVecs) + tid;
  PreVec<kElem> buf[kPreVecs];
#pragma unroll
  for (int r = 0; r < kPreVecs; ++r) {
    const long long k = k0 + r * kPreThreads;
    if (k < nv) buf[r] = load_vec<kElem>(vin_r, vin_i, k);
  }
#pragma unroll
  for (int r = 0; r < kPreVecs; ++r) {
    const long long k = k0 + r * kPreThreads;
    if (k >= nv) continue;
    float vr[4], vi[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      vec_frame<kElem>(a, buf[r], e, &vr[e], &vi[e]);
      pre_frame<kIq>(a, g1, phi, ph0, head + 4 * k + e, &vr[e], &vi[e]);
    }
    vout_r[k] = make_float4(vr[0], vr[1], vr[2], vr[3]);
    vout_i[k] = make_float4(vi[0], vi[1], vi[2], vi[3]);
  }
}

template <int kElem>
void launch_pre(const PreArgs& a, dim3 grid, cudaStream_t stream) {
  if (a.iq) {
    pre_kernel<kElem, true><<<grid, kPreThreads, 0, stream>>>(a);
  } else {
    pre_kernel<kElem, false><<<grid, kPreThreads, 0, stream>>>(a);
  }
}

}  // namespace iqk

// K3pre: `wire` with kind >= 0, or planes x_r/x_i with kind == kPlanar;
// `iq` (C, 2) or null; `phase` needed when dtheta != 0.  Any n.  Launch on
// `stream`; returns the launch's cudaError_t.
extern "C" int iq_pre_apply(const void* wire, int kind, float norm, float gain,
                            const float* x_r, const float* x_i, const float* iq,
                            const long long* phase, unsigned dtheta, int channels,
                            int n, float* y_r, float* y_i, void* stream) {
  const bool planar = kind == iqk::kPlanar;
  if (channels <= 0 || channels > 65535 || n <= 0 || !y_r || !y_i ||
      (planar && (!x_r || !x_i)) || (!planar && (!wire || kind < 0 || kind > iqk::kCs8)) ||
      (dtheta && !phase)) {
    return cudaErrorInvalidValue;
  }
  const iqk::PreArgs a{wire, kind, norm, gain, x_r, x_i, iq, phase, dtheta, n, y_r, y_i};
  const dim3 grid(static_cast<unsigned>((n + iqk::kPreTile - 1) / iqk::kPreTile), channels);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (planar) {
    iqk::launch_pre<0>(a, grid, st);
  } else if (kind == iqk::kCs16 || kind == iqk::kCu16) {
    iqk::launch_pre<4>(a, grid, st);
  } else {
    iqk::launch_pre<2>(a, grid, st);
  }
  return cudaGetLastError();
}
