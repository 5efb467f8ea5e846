"""Hand-written CUDA kernels of the chain and their plain PyTorch twins
(the port of ``iq_tool_tpu.ops.pallas_kernels``).

* K2 ``banded_apply`` (``csrc/banded.cu``): one resampler stage, the
  strided-window banded map, with optional packed-wire + NCO prologue and
  quantize-and-pack epilogue.
* K1 ``banded_apply_dc`` (``csrc/banded_dc.cu`` then ``csrc/banded.cu``):
  stage 0 with the wire decode, DC block and NCO mix in front.

Each wrapper keeps the reference's signature minus ``interpret`` and the
TPU tiling, and dispatches on where its input lies: a CPU tensor runs the
twin (``*_ref``), a CUDA tensor launches the kernel or raises.  There is
no fallback from one to the other.  ``<wrapper>.launches`` counts kernel
launches (twin runs do not count).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from iq_tool_tpu.formats import get_format
from iq_tool_tpu_torch.ops import banded, convert, dc_block, nco

# Formats the kernels quantize and pack in their epilogue: two codes per
# element, element dtype sized so a bitcast gives the interleaved wire.
_PACK_INFO = {  # fmt name -> (element dtype, bits per code)
    "cs16": (torch.int32, 16), "sc16q11": (torch.int32, 16),
    "cu16": (torch.int32, 16), "cu8": (torch.int16, 8), "cs8": (torch.int16, 8),
}
_WIRE_KINDS = {"cs16": 0, "cu16": 1, "cu8": 2, "cs8": 3}
_PLANAR = -1


def packable_out(fmt_name: str) -> bool:
    return fmt_name in _PACK_INFO


def pack_wire_ref(yr: torch.Tensor, yi: torch.Tensor, fmt_name: str) -> torch.Tensor:
    """Quantize + interleave into one element per frame, I in the low
    code: the plain twin of the kernels' packed epilogue."""
    fmt = get_format(fmt_name)
    dt, bits = _PACK_INFO[fmt_name]
    mask = (1 << bits) - 1
    packed = (convert.quantize(yr, fmt) & mask) | ((convert.quantize(yi, fmt) & mask) << bits)
    # two's-complement value of the 2*bits-wide element
    return (packed - ((packed >> (2 * bits - 1)) << (2 * bits))).to(dt)


@dataclasses.dataclass(frozen=True)
class Band:
    """A banded matrix A (L, G) ready for both paths: the dense float32
    tensors for the twin, and for the kernel each column's first band row
    and its K taps (the same linear map with exact zeros skipped), plus
    how many consecutive columns have their first rows within 32 words
    (one warp's share: its shared-memory loads then avoid bank
    conflicts)."""
    a_r: torch.Tensor
    a_i: torch.Tensor | None
    first: torch.Tensor          # (G,) int32
    taps_r: torch.Tensor         # (K, G) float32
    taps_i: torch.Tensor | None
    cols_per_warp: int

    @staticmethod
    def build(a_r: np.ndarray, a_i: np.ndarray | None, device) -> "Band":
        a_r = np.ascontiguousarray(a_r, np.float32)
        a_i = None if a_i is None or not np.any(a_i) else np.ascontiguousarray(a_i, np.float32)
        rows, g = a_r.shape
        nz = (a_r != 0) | (a_i != 0 if a_i is not None else False)
        has = nz.any(axis=0)
        lo = np.where(has, nz.argmax(axis=0), 0)
        hi = np.where(has, rows - 1 - nz[::-1].argmax(axis=0), 0)
        k = max(1, int((hi - lo + 1).max()))
        first = np.minimum(lo, rows - k)           # keep every band inside A
        take = first[None, :] + np.arange(k)[:, None]
        cols = np.arange(g)[None, :]
        cpw = 1
        for length in range(2, min(32, g) + 1):
            win = np.lib.stride_tricks.sliding_window_view(first, length)
            if (win.max(axis=1) - win.min(axis=1)).max() > 31:
                break
            cpw = length
        dev = torch.device(device)
        t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        return Band(a_r=t(a_r), a_i=None if a_i is None else t(a_i),
                    first=t(first.astype(np.int32)), taps_r=t(a_r[take, cols]),
                    taps_i=None if a_i is None else t(a_i[take, cols]),
                    cols_per_warp=cpw)

    @property
    def rows(self) -> int:
        return self.a_r.shape[0]

    @property
    def g(self) -> int:
        return self.a_r.shape[1]

    @property
    def k(self) -> int:
        return self.taps_r.shape[0]


def _band(a_r, a_i, device) -> Band:
    return a_r if isinstance(a_r, Band) else Band.build(a_r, a_i, device)


def _ptr(t: torch.Tensor | None):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream():
    """The current stream of the current device (callers select the
    device of their tensors first)."""
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def _require_cuda(*tensors: torch.Tensor | None) -> None:
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"kernel input on {t.device}, expected a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def _require_dtypes(wire, kind: int, nco_phase, *planes) -> None:
    if wire is not None:
        want = torch.int32 if kind in (0, 1) else torch.int16
        if wire.dtype != want:
            raise ValueError(f"packed wire must be {want}, got {wire.dtype}")
    if nco_phase is not None and nco_phase.dtype != torch.int64:
        raise ValueError("nco_phase must be int64 (uint32 values)")
    for p in planes:
        if p is not None and p.dtype != torch.float32:
            raise ValueError(f"planes and states must be float32, got {p.dtype}")


def _pack_args(pack_fmt: str | None):
    if not pack_fmt:
        return (0, 0, 0.0, 0.0, 0.0, 0.0)
    fmt = get_format(pack_fmt)
    f = convert._f32
    return (_PACK_INFO[pack_fmt][1], int(fmt.signed), f(fmt.scale),
            f(fmt.offset_out), f(fmt.min_code), f(fmt.max_code))


def _check_args(wire_i32, wire_norm, nco_dtheta, nco_phase, pack_fmt):
    if wire_i32 is not None and not wire_norm:
        raise ValueError("wire_i32 requires wire_norm (the format normalizer)")
    if nco_dtheta and (wire_i32 is None or nco_phase is None):
        raise ValueError("nco_dtheta needs wire input and nco_phase")
    if pack_fmt and not packable_out(pack_fmt):
        raise ValueError(f"format {pack_fmt!r} has no packed epilogue")


# ------------------------------ K2 --------------------------------------------

def banded_apply_ref(state_r, state_i, xr, xi, a_r, a_i, stride: int, hist: int,
                     pack_fmt=None, wire_i32=None, wire_norm: float = 0.0,
                     wire_gain: float = 1.0, nco_dtheta: int = 0,
                     nco_phase=None, wire_kind: str = "cs16"):
    """Plain twin of banded_apply: decode + NCO in torch ops, windows +
    dense float32 matmul (ops/banded.py), then the packed epilogue."""
    x0 = wire_i32 if wire_i32 is not None else xr
    band = _band(a_r, a_i, x0.device)
    if wire_i32 is not None:
        xr, xi = convert.decode_packed(wire_i32, wire_kind, wire_norm, wire_gain)
        if nco_dtheta:
            xr, xi = nco.mix(xr, xi, nco_phase, nco_dtheta)
    yr, yi = banded.apply_planar(state_r, state_i, xr, xi, band.a_r, band.a_i,
                                 stride, hist)
    return pack_wire_ref(yr, yi, pack_fmt) if pack_fmt else (yr, yi)


def _launch_banded(lib, band: Band, state_r, state_i, xr, xi, wire, kind: int,
                   wire_norm, wire_gain, nco_dtheta, nco_phase, stride, hist,
                   pack_fmt):
    x0 = wire if wire is not None else xr
    ch, n = x0.shape
    nb = n // stride
    if band.rows != stride + hist:
        raise ValueError(f"A has {band.rows} rows, expected stride + hist = {stride + hist}")
    if nb <= 0:
        raise ValueError(f"block of {n} samples is shorter than the stride {stride}")
    _require_cuda(state_r, state_i, xr, xi, wire, nco_phase, band.taps_r)
    _require_dtypes(wire, kind, nco_phase, state_r, state_i, xr, xi)
    if state_r.shape != (ch, hist) or state_i.shape != (ch, hist):
        raise ValueError(f"state must be ({ch}, {hist})")
    dev = x0.device
    out_len = nb * band.g
    if pack_fmt:
        packed = torch.empty((ch, out_len), dtype=_PACK_INFO[pack_fmt][0], device=dev)
        out_r = out_i = None
    else:
        packed = None
        out_r = torch.empty((ch, out_len), dtype=torch.float32, device=dev)
        out_i = torch.empty_like(out_r)
    with torch.cuda.device(dev):
        rc = lib.iq_banded_apply(
            _ptr(xr), _ptr(xi), _ptr(wire), kind, convert._f32(wire_norm),
            convert._f32(wire_gain), _ptr(nco_phase), int(nco_dtheta) & 0xFFFFFFFF,
            _ptr(state_r), _ptr(state_i), _ptr(band.first), _ptr(band.taps_r),
            _ptr(band.taps_i), band.k, band.cols_per_warp, ch, n, stride, hist,
            band.g, _ptr(out_r), _ptr(out_i), _ptr(packed), *_pack_args(pack_fmt),
            _stream())
    _check(rc, "banded kernel")
    return packed if pack_fmt else (out_r, out_i)


def banded_apply(state_r, state_i, xr, xi, a_r, a_i, stride: int, hist: int,
                 pack_fmt=None, wire_i32=None, wire_norm: float = 0.0,
                 wire_gain: float = 1.0, nco_dtheta: int = 0, nco_phase=None,
                 wire_kind: str = "cs16"):
    """K2: strided-window banded map over one block.

    state_*: (C, hist) carried history (processed, pre-rotated);
    x*: (C, n) float32 planes, or ``wire_i32`` (C, n) packed wire
    (convert.wire_pack) decoded with wire_norm/wire_gain and, with
    ``nco_dtheta``, NCO-mixed at each sample's index after ``nco_phase``
    ((C,) int64 uint32 values); a_r/a_i: (stride + hist, G) numpy
    matrix, or a_r a prepared Band.  Returns (yr, yi) (C, (n//stride)*G)
    float32, or with ``pack_fmt`` one packed-wire tensor."""
    _check_args(wire_i32, wire_norm, nco_dtheta, nco_phase, pack_fmt)
    x0 = wire_i32 if wire_i32 is not None else xr
    if x0.device.type == "cpu":
        return banded_apply_ref(state_r, state_i, xr, xi, a_r, a_i, stride, hist,
                                pack_fmt, wire_i32, wire_norm, wire_gain,
                                nco_dtheta, nco_phase, wire_kind)
    from iq_tool_tpu_torch.ops import _build
    lib = _build.library()
    band = _band(a_r, a_i, x0.device)
    kind = _WIRE_KINDS[wire_kind] if wire_i32 is not None else _PLANAR
    out = _launch_banded(lib, band, state_r, state_i, xr, xi, wire_i32, kind,
                         wire_norm, wire_gain, nco_dtheta if wire_i32 is not None else 0,
                         nco_phase, stride, hist, pack_fmt)
    banded_apply.launches += 1
    return out


banded_apply.launches = 0


# ------------------------------ K1 --------------------------------------------

def banded_apply_dc_ref(state_r, state_i, dc_state, dc_alpha: float, a_r, a_i,
                        stride: int, hist: int, wire_i32, wire_norm: float,
                        wire_gain: float = 1.0, nco_dtheta: int = 0,
                        nco_phase=None, pack_fmt=None, wire_kind: str = "cs16"):
    """Plain twin of banded_apply_dc: decode, the two-level DC scan
    (ops/dc_block.py), NCO mix, then the plain banded map."""
    xr, xi = convert.decode_packed(wire_i32, wire_kind, wire_norm, wire_gain)
    yr, yi, new_dc = dc_block.apply_planar(xr, xi, dc_state, dc_alpha)
    if nco_dtheta:
        yr, yi = nco.mix(yr, yi, nco_phase, nco_dtheta)
    out = banded_apply_ref(state_r, state_i, yr, yi, a_r, a_i, stride, hist,
                           pack_fmt)
    return (out, banded.new_tail(state_r, yr, hist),
            banded.new_tail(state_i, yi, hist), new_dc)


def banded_apply_dc(state_r, state_i, dc_state, dc_alpha: float, a_r, a_i,
                    stride: int, hist: int, wire_i32, wire_norm: float,
                    wire_gain: float = 1.0, nco_dtheta: int = 0,
                    nco_phase=None, pack_fmt=None, wire_kind: str = "cs16"):
    """K1: stage 0 with the wire decode + DC block + NCO prologue.

    state_*: (C, hist) PROCESSED stage history (post-DC, pre-rotated);
    dc_state: (C, 4) [xr, xi, yr, yi] prevs.  Returns (y | packed wire,
    tail_r, tail_i, new_dc_state), tail_* the processed (C, hist)
    history for the next block.  On CUDA this is two launches: the
    prologue kernel writes the processed planes, then the K2 banded
    kernel runs over them."""
    if not wire_norm:
        raise ValueError("banded_apply_dc requires wire input")
    _check_args(wire_i32, wire_norm, nco_dtheta, nco_phase, pack_fmt)
    if wire_i32.device.type == "cpu":
        return banded_apply_dc_ref(state_r, state_i, dc_state, dc_alpha, a_r, a_i,
                                   stride, hist, wire_i32, wire_norm, wire_gain,
                                   nco_dtheta, nco_phase, pack_fmt, wire_kind)
    from iq_tool_tpu_torch.ops import _build
    lib = _build.library()
    _require_cuda(wire_i32, dc_state, nco_phase)
    _require_dtypes(wire_i32, _WIRE_KINDS[wire_kind], nco_phase, dc_state)
    ch, n = wire_i32.shape
    if n < hist:
        raise ValueError(f"block of {n} samples is shorter than the history {hist}")
    if dc_state.shape != (ch, 4):
        raise ValueError(f"dc_state must be ({ch}, 4)")
    dev = wire_i32.device
    yr = torch.empty((ch, n), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    tail_r = torch.empty((ch, hist), dtype=torch.float32, device=dev)
    tail_i = torch.empty_like(tail_r)
    new_dc = torch.empty((ch, 4), dtype=torch.float32, device=dev)
    dth = int(nco_dtheta) & 0xFFFFFFFF
    with torch.cuda.device(dev):
        rc = lib.iq_dc_prologue(
            _ptr(wire_i32), _WIRE_KINDS[wire_kind], convert._f32(wire_norm),
            convert._f32(wire_gain), _ptr(dc_state), float(1.0 - dc_alpha),
            _ptr(nco_phase), dth, ch, n, hist, _ptr(yr), _ptr(yi), _ptr(tail_r),
            _ptr(tail_i), _ptr(new_dc), _stream())
    _check(rc, "dc prologue kernel")
    out = _launch_banded(lib, _band(a_r, a_i, dev), state_r, state_i, yr, yi,
                         None, _PLANAR, 0.0, 1.0, 0, None, stride, hist, pack_fmt)
    banded_apply_dc.launches += 1
    return out, tail_r, tail_i, new_dc


banded_apply_dc.launches = 0


def reset_launch_counts() -> None:
    banded_apply.launches = 0
    banded_apply_dc.launches = 0
