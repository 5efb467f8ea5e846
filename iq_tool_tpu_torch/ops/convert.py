"""Sample-format conversion (wire ints <-> planar float32) in torch.

The port of ``iq_tool_tpu.ops.convert``, bit-identical to it on all 16
formats (the 9 complex ones convert; the 7 real ones are refused the same
way):

* wire -> f32: per-format normalizer; unsigned formats subtract the
  mid-code offset first; then ``(x * normalizer) * gain``, all f32.
* f32 -> wire: signed formats scale, round half away from zero (via
  ``trunc``), clamp to f32 bounds that cast to an in-range int; unsigned
  formats scale and offset, clamp to ``[0, max]``, then ``floor(x + .5)``.

torch has no general uint32 arithmetic, so every place the reference
computes in uint32 computes here in int64 masked to 32 bits; unsigned
wires are read through same-width signed views.  Every scalar is rounded
to float32 on the host first, so the arithmetic is f32 op for f32 op.
"""

from __future__ import annotations

import numpy as np
import torch

from iq_tool_tpu_torch.formats import SampleFormat, get_format

_F32 = torch.float32


def _fmt(fmt: SampleFormat | str) -> SampleFormat:
    return get_format(fmt) if isinstance(fmt, str) else fmt


def _f32(v: float) -> float:
    """v rounded to float32, as a Python float (exact in f32 arithmetic)."""
    return float(np.float32(v))


def _require_complex(fmt: SampleFormat) -> None:
    if not fmt.is_complex:
        raise ValueError(
            f"format '{fmt.name}' is real; the pipeline processes complex I/Q "
            "streams only")


_TORCH_DTYPES = {
    np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int16): torch.int16, np.dtype(np.uint16): torch.uint16,
    np.dtype(np.int32): torch.int32, np.dtype(np.uint32): torch.uint32,
    np.dtype(np.float32): torch.float32,
}
# same-width signed views of the unsigned wires
_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def wire_dtype(fmt: SampleFormat | str) -> np.dtype:
    """The numpy dtype host code uses to view the raw byte stream."""
    fmt = _fmt(fmt)
    return np.dtype(np.uint8) if fmt.wire_dtype is None else fmt.wire_dtype


def torch_wire_dtype(fmt: SampleFormat | str) -> torch.dtype:
    return _TORCH_DTYPES[wire_dtype(fmt)]


def _unsigned_as_int64(raw: torch.Tensor) -> torch.Tensor:
    """A uint16/uint32 wire widened to int64, values kept."""
    bits = 8 * raw.element_size()
    return raw.view(_SIGNED_VIEW[raw.dtype]).to(torch.int64) & ((1 << bits) - 1)


def to_planar(raw: torch.Tensor, fmt: SampleFormat | str, gain: float = 1.0):
    """(..., N*items_per_frame) wire tensor -> two (..., N) float32 planes."""
    fmt = _fmt(fmt)
    _require_complex(fmt)
    n = raw.shape[-1] // fmt.items_per_frame
    lead = raw.shape[:-1]

    if fmt.name == "cf32":
        pairs = raw.reshape(*lead, n, 2).to(_F32)
        g = _f32(gain)
        return pairs[..., 0] * g, pairs[..., 1] * g

    if fmt.name == "cs24":
        b = raw.reshape(*lead, n, 6).to(torch.int64)

        def s24(b0, b1, b2):
            v = b0 | (b1 << 8) | (b2 << 16)
            return v - ((v >> 23) << 24)          # little-endian sign extension
        scale = _f32(fmt.normalizer * gain)
        i_val = s24(b[..., 0], b[..., 1], b[..., 2])
        q_val = s24(b[..., 3], b[..., 4], b[..., 5])
        return i_val.to(_F32) * scale, q_val.to(_F32) * scale

    ints = _unsigned_as_int64(raw) if raw.dtype in _SIGNED_VIEW else raw
    pairs = ints.reshape(*lead, n, 2).to(_F32)
    if not fmt.signed:
        pairs = pairs - _f32(fmt.offset)
    pairs = (pairs * _f32(fmt.normalizer)) * _f32(gain)
    return pairs[..., 0], pairs[..., 1]


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    return torch.trunc(torch.where(x > 0, x + 0.5, x - 0.5))


def _safe_f32_bound(value: float, upper: bool) -> float:
    """Largest/smallest float32 clamp bound that casts to an in-range int
    (2^31-1 and 2^32-1 round UP in float32; clamping to them would wrap)."""
    f = np.float32(value)
    if upper and float(f) > value:
        f = np.nextafter(f, np.float32(-np.inf))
    elif not upper and float(f) < value:
        f = np.nextafter(f, np.float32(np.inf))
    return float(f)


def quantize(v: torch.Tensor, fmt: SampleFormat) -> torch.Tensor:
    """f32 values -> int64 codes of ``fmt`` (the quantizer of from_planar)."""
    if fmt.signed:
        v = _round_half_away(v * _f32(fmt.scale))
        v = torch.clamp(v, _safe_f32_bound(fmt.min_code, upper=False),
                        _safe_f32_bound(fmt.max_code, upper=True))
        return v.to(torch.int64)
    v = v * _f32(fmt.scale) + _f32(fmt.offset_out)
    v = torch.clamp(v, 0.0, _safe_f32_bound(fmt.max_code, upper=True))
    return torch.floor(v + 0.5).to(torch.int64)


def _narrow(codes: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 codes -> the wire dtype, unsigned values reinterpreted (not
    range-checked: the quantizer already clamped them)."""
    if dtype in _SIGNED_VIEW:
        bits = 8 * torch.empty((), dtype=dtype).element_size()
        signed = codes - ((codes >> (bits - 1)) << bits)
        return signed.to(_SIGNED_VIEW[dtype]).view(dtype)
    return codes.to(dtype)


def from_planar(xr: torch.Tensor, xi: torch.Tensor,
                fmt: SampleFormat | str) -> torch.Tensor:
    """Quantize planar float32 (..., N) planes to the (..., N*items) wire."""
    fmt = _fmt(fmt)
    _require_complex(fmt)
    lead = xr.shape[:-1]
    pairs = torch.stack([xr, xi], dim=-1).to(_F32)
    if fmt.name == "cf32":
        return pairs.reshape(*lead, -1)
    codes = quantize(pairs, fmt)
    if fmt.name == "cs24":
        out = torch.stack([codes & 0xFF, (codes >> 8) & 0xFF,
                           (codes >> 16) & 0xFF], dim=-1)
        return out.reshape(*lead, -1).to(torch.uint8)
    return _narrow(codes, torch_wire_dtype(fmt)).reshape(*lead, -1)


def wire_kind(fmt: SampleFormat | str):
    """(element dtype, kind) of the format's packed wire, or None when it
    has none: kind "cs16" (also sc16q11) and "cu16" are int32 with I in
    the low 16 bits; "cu8"/"cs8" are int16 with I in the low byte."""
    fmt = _fmt(fmt)
    if fmt.wire_dtype == np.int16 and fmt.signed and fmt.items_per_frame == 2:
        return torch.int32, "cs16"
    if fmt.name in ("cu16", "cu8", "cs8"):
        return (torch.int32 if fmt.name == "cu16" else torch.int16), fmt.name
    return None


def wire_pack(raw: torch.Tensor, fmt: SampleFormat | str):
    """(packed wire, kind) with one element per frame, or None when the
    format has no such packing (``wire_kind``): the same zero-copy views
    as the reference."""
    packing = wire_kind(fmt)
    if packing is None:
        return None
    raw = raw.contiguous()
    if raw.dtype == torch.uint16:
        raw = raw.view(torch.int16)
    return raw.view(packing[0]), packing[1]


def packed_to_wire(packed: torch.Tensor, fmt: SampleFormat | str) -> torch.Tensor:
    """A kernel-packed (C, N) output (int32 for 16-bit wires, int16 for
    8-bit, I in the low code) viewed as the (C, N*items) wire: the same
    bytes from_planar writes."""
    fmt = _fmt(fmt)
    wd = torch_wire_dtype(fmt)
    if wd in _SIGNED_VIEW:
        return packed.view(_SIGNED_VIEW[wd]).view(wd)
    return packed.view(wd)


def decode_packed(w: torch.Tensor, kind: str, norm: float, gain: float):
    """Decode a wire_pack tensor to (xr, xi) float32 with to_planar's
    operation order: ``((x - off) * norm) * gain``."""
    v = w.to(torch.int64)
    if kind == "cs16":
        lo = v & 0xFFFF
        i_val, q_val, off = lo - ((lo >> 15) << 16), v >> 16, 0.0
    elif kind == "cu8":
        i_val, q_val, off = v & 0xFF, (v >> 8) & 0xFF, 127.5
    elif kind == "cs8":
        lo, hi = v & 0xFF, (v >> 8) & 0xFF
        i_val, q_val, off = lo - ((lo >> 7) << 8), hi - ((hi >> 7) << 8), 0.0
    elif kind == "cu16":
        i_val, q_val, off = v & 0xFFFF, (v >> 16) & 0xFFFF, 32767.5
    else:
        raise ValueError(f"unknown packed wire kind {kind!r}")
    xr = i_val.to(_F32)
    xi = q_val.to(_F32)
    if off:
        xr = xr - _f32(off)
        xi = xi - _f32(off)
    g, n = _f32(gain), _f32(norm)
    return (xr * n) * g, (xi * n) * g
