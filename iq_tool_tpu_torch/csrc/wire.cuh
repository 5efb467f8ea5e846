// Device helpers shared by the banded kernels: packed-wire decode, the NCO
// mix at a global sample index, and the quantize-and-pack epilogue.
//
// Each helper is the CUDA twin of a plain-PyTorch function in the port
// (ops/convert.py decode_packed / quantize, ops/nco.py mix) and keeps its
// operation order.  The _rn intrinsics stop nvcc from contracting a
// multiply and an add into one FMA, so decode and quantization round
// exactly as the plain path does.

#pragma once

#include <cuda_runtime.h>

namespace iqk {

// Wire kinds of ops/convert.py wire_pack: one element per frame.
enum WireKind : int {
  kPlanar = -1,  // float32 planes, no wire
  kCs16 = 0,     // int32 element, I = low int16, Q = high int16 (also sc16q11)
  kCu16 = 1,     // int32 element, unsigned 16-bit halves, mid-code 32767.5
  kCu8 = 2,      // int16 element, unsigned bytes, mid-code 127.5
  kCs8 = 3,      // int16 element, signed bytes
};

// 2*pi / 2^32 rounded once to float32, as nco.TWO_PI_OVER_2_32 is.
static constexpr float kPhaseScale =
    static_cast<float>(2.0 * 3.141592653589793 / 4294967296.0);

// Packed element `idx` of one channel's wire row (16-bit kinds hold an
// int32 per frame, 8-bit kinds an int16, returned sign-extended).
__device__ __forceinline__ int wire_load(const void* row, int kind,
                                         long long idx) {
  return kind == kCs16 || kind == kCu16
             ? static_cast<const int*>(row)[idx]
             : static_cast<int>(static_cast<const short*>(row)[idx]);
}

// Decode one packed element to (xr, xi): ((x - off) * norm) * gain in
// float32.
__device__ __forceinline__ void wire_decode_value(int v, int kind, float norm,
                                                  float gain, float* xr,
                                                  float* xi) {
  int iv, qv;
  float off = 0.0f;
  if (kind == kCs16 || kind == kCu16) {
    if (kind == kCs16) {
      iv = static_cast<int>(static_cast<short>(v & 0xFFFF));
      qv = v >> 16;
    } else {
      iv = v & 0xFFFF;
      qv = static_cast<int>((static_cast<unsigned>(v) >> 16) & 0xFFFFu);
      off = 32767.5f;
    }
  } else {
    if (kind == kCu8) {
      iv = v & 0xFF;
      qv = (v >> 8) & 0xFF;
      off = 127.5f;
    } else {
      iv = static_cast<int>(static_cast<signed char>(v & 0xFF));
      qv = static_cast<int>(static_cast<signed char>((v >> 8) & 0xFF));
    }
  }
  float fr = static_cast<float>(iv);
  float fi = static_cast<float>(qv);
  if (off != 0.0f) {
    fr = __fsub_rn(fr, off);
    fi = __fsub_rn(fi, off);
  }
  *xr = __fmul_rn(__fmul_rn(fr, norm), gain);
  *xi = __fmul_rn(__fmul_rn(fi, norm), gain);
}

__device__ __forceinline__ void wire_decode(const void* row, int kind,
                                            long long idx, float norm,
                                            float gain, float* xr, float* xi) {
  wire_decode_value(wire_load(row, kind, idx), kind, norm, gain, xr, xi);
}

// Rotate (xr, xi) by the NCO phase of sample `idx`: phase0 + idx * dtheta
// wrapping mod 2^32, converted as uint32 to float32 for the angle
// (ops/nco.py).
__device__ __forceinline__ void nco_rotate(unsigned phase0, unsigned dtheta,
                                           long long idx, float* xr,
                                           float* xi) {
  const unsigned ph = phase0 + static_cast<unsigned>(idx) * dtheta;
  const float ang = __fmul_rn(__uint2float_rn(ph), kPhaseScale);
  float s, c;
  sincosf(ang, &s, &c);
  const float r = __fsub_rn(__fmul_rn(*xr, c), __fmul_rn(*xi, s));
  const float i = __fadd_rn(__fmul_rn(*xr, s), __fmul_rn(*xi, c));
  *xr = r;
  *xi = i;
}

// Output quantizer of one packable format (ops/convert.py quantize).
struct PackParams {
  int bits;       // 0: planar float32 output; 16 -> int32 element; 8 -> int16
  int is_signed;
  float scale;
  float offset;   // unsigned formats: mid-code added after scaling
  float lo;       // signed clamp bounds; unsigned clamps to [0, hi]
  float hi;
};

__device__ __forceinline__ int quantize(float v, const PackParams& q) {
  if (q.is_signed) {
    v = __fmul_rn(v, q.scale);
    v = truncf(v > 0.0f ? __fadd_rn(v, 0.5f) : __fsub_rn(v, 0.5f));
    v = fminf(fmaxf(v, q.lo), q.hi);
  } else {
    v = __fadd_rn(__fmul_rn(v, q.scale), q.offset);
    v = fminf(fmaxf(v, 0.0f), q.hi);
    v = floorf(__fadd_rn(v, 0.5f));
  }
  return static_cast<int>(v);
}

// Store one packed frame: I in the low code, Q in the high, so the bytes
// equal the little-endian interleaved wire.
__device__ __forceinline__ void store_packed(void* out, long long idx,
                                             float yr, float yi,
                                             const PackParams& q) {
  const unsigned mask = (1u << q.bits) - 1u;
  const unsigned packed = (static_cast<unsigned>(quantize(yr, q)) & mask) |
                          ((static_cast<unsigned>(quantize(yi, q)) & mask)
                           << q.bits);
  if (q.bits == 16) {
    static_cast<int*>(out)[idx] = static_cast<int>(packed);
  } else {
    static_cast<short*>(out)[idx] =
        static_cast<short>(static_cast<unsigned short>(packed & 0xFFFFu));
  }
}

}  // namespace iqk
