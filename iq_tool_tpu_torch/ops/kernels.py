"""Hand-written CUDA kernels of the chain and their plain PyTorch twins
(the port of ``iq_tool_tpu.ops.pallas_kernels``).

* K2 ``banded_apply`` (``csrc/banded.cu``, the wgmma core; over a band
  of fewer than 96 taps a column ``csrc/banded_mma.cu``, the mma.sync
  core: ``banded_core``): one resampler stage, the strided-window banded
  map, with optional packed-wire + NCO prologue and quantize-and-pack
  epilogue.
* K1 ``banded_apply_dc``: stage 0 with the wire decode, DC block and NCO
  mix in front, as two launches that write no processed planes: the DC
  kernel's carry pass ``dc_carry`` (``csrc/banded_dc.cu``: each window
  group's DC state and halo, the tail, the new DC state), then the banded
  kernel (``csrc/banded.cu``) decoding, DC-blocking and NCO-mixing the
  wire in its loader.  ``dc_prologue``, the DC kernel writing the
  processed planes, serves the sharded chain's stage 0.
* K3 ``dc_block_apply`` (``csrc/banded_dc.cu``, the prologue's kernel):
  the chain's pre-stage, DC block + I/Q apply + NCO mix over packed wire
  or planes.
* K3pre ``pre_apply`` (``csrc/pre.cu``): the same pre-stage without the
  DC block (no TPU kernel: XLA ran it as elementwise ops).
* K4 ``post_apply`` (``csrc/post.cu``): post-NCO + AGC gains + quantize
  and pack; beside it ``rms_gains``, the AGC's segment energies and
  sequential gain loop in one launch, and its two halves alone:
  ``segment_energies`` and ``agc_chain``, the loop over given energies
  (helper kernels, not TPU kernels).
* K5 ``osfft_apply`` (``csrc/osfft.cu``): the overlap-save FFT filter.
* ``iq_estimate`` (``csrc/iq_est.cu``): the I/Q estimator of a step,
  whole (prefix decode, float64 DC prefix, both spectra, power gate,
  descent, smoothing and the due counter; a helper kernel, not a TPU
  kernel), which exits early when no update is due.
* ``gather_apply`` (``csrc/gather.cu``): the gather resampler stage,
  each output the dot of its own K weights with a window of history ++
  block, FP32 over windows staged in shared memory (no TPU kernel: the
  JAX package leaves the stage to XLA's gather and einsum).

Each wrapper keeps the reference's signature minus ``interpret`` and the
TPU tiling, and dispatches on where its input lies: a CPU tensor runs the
twin (``*_ref``), a CUDA tensor launches the kernel or raises.  There is
no fallback from one to the other.  ``<wrapper>.launches`` counts kernel
launches (twin runs do not count), and each launch is noted in the
stage record under the CUDA symbol the profiler prints
(``pipeline/trace.py`` ``note``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from iq_tool_tpu_torch import constants as C
from iq_tool_tpu_torch.formats import get_format
from iq_tool_tpu_torch.ops import banded, convert, dc_block, iq_balance, nco
from iq_tool_tpu_torch.ops import fft as tfft
from iq_tool_tpu_torch.pipeline import trace

# Formats the kernels quantize and pack in their epilogue: two codes per
# element, element dtype sized so a bitcast gives the interleaved wire.
_PACK_INFO = {  # fmt name -> (element dtype, bits per code)
    "cs16": (torch.int32, 16), "sc16q11": (torch.int32, 16),
    "cu16": (torch.int32, 16), "cu8": (torch.int16, 8), "cs8": (torch.int16, 8),
}
_WIRE_KINDS = {"cs16": 0, "cu16": 1, "cu8": 2, "cs8": 3}
_PLANAR = -1


def _launched(symbol: str, *wrappers) -> None:
    """One launch of the CUDA kernel ``symbol``: each wrapper's
    ``launches`` counts it, and the stage record notes it."""
    for fn in wrappers:
        fn.launches += 1
    trace.note(symbol)


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


TILE_COLS = 32     # output columns of one column tile: the wgmma products' N
BAND_STEP = 8      # span rows of one product step: the products' K
FRAG_COLS = 16     # the mma.sync core's column tile: two n-blocks of 8


def tf32_split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """x = hi + lo in float32, as csrc/banded.cu split() cuts its
    operands: hi is x rounded to TF32 (half a TF32 ulp added to the bit
    pattern, the low 13 bits cleared: to nearest, ties away from zero),
    lo = x - hi, exact."""
    x = np.ascontiguousarray(x, np.float32)
    bits = x.view(np.uint32)
    hi = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    return hi, (x - hi).astype(np.float32)


def _tile_blocks(mats, lo, hi, cols):
    """Cut each (L, G) matrix of ``mats`` into tiles of ``cols`` columns
    over the rows that hold their non-zeros (band rows lo..hi a column):
    (first row of each tile, even; span, the widest tile's rounded up to
    8; [(T, span, cols) dense blocks, zeros outside the band and past the
    edges])."""
    rows, g = mats[0].shape
    n_tiles = -(-g // cols)
    pad = n_tiles * cols - g
    lo_t = np.concatenate([lo, np.full(pad, rows)]).reshape(n_tiles, -1).min(axis=1)
    hi_t = np.concatenate([hi, np.full(pad, -1)]).reshape(n_tiles, -1).max(axis=1)
    first = np.where(hi_t >= lo_t, lo_t, 0) & ~1
    span = BAND_STEP * -(-max(1, int((hi_t - first + 1).max())) // BAND_STEP)
    take = first[:, None] + np.arange(span)[None, :]               # (T, span)
    col = np.arange(n_tiles * cols).reshape(n_tiles, 1, cols)
    blocks = []
    for a in mats:
        dense = np.zeros((rows + span, n_tiles * cols), np.float32)
        dense[:rows, :g] = a
        blocks.append(dense[take[:, :, None], col])
    return first.astype(np.int32), span, blocks


@dataclasses.dataclass(frozen=True)
class Band:
    """A banded matrix A (L, G) ready for both paths: the dense float32
    tensors for the twin, and for the kernels A cut into column tiles
    over the rows that hold their columns' non-zeros, once for each
    product core (``banded_core`` picks one by geometry).

    For the wgmma core (csrc/banded.cu), tiles of TILE_COLS = 32
    columns: tile t covers the rows [tile_first[t], tile_first[t] +
    span) (tile_first even, span the widest tile's rounded up to 8) as a
    dense (span, 32) block B_t of A (zeros outside the band and past A's
    edges), split once into its TF32 hi and lo parts (``tf32_split``) and
    stored as the kernel's tensor-core operand reads it from shared
    memory: taps[t, h, j] (h = 0 hi, 1 lo) is the 8-row step j, 256
    floats in core-matrix order with the k pair permutation, B_t[8 j + 2
    kq + kh, 8 ng + nr] at float ng * 64 + kh * 32 + nr * 4 + kq.

    For the mma.sync core (csrc/banded_mma.cu), tiles of FRAG_COLS = 16
    columns cut the same way (frag_first, frag_span), unsplit, in the
    order its B fragments take with k paired: frag[t, kc, lane] =
    (B_t[r, c], B_t[r + 1, c], B_t[r, c + 8], B_t[r + 1, c + 8]) for
    r = 8 kc + 2 (lane % 4), c = lane // 4."""
    a_r: torch.Tensor
    a_i: torch.Tensor | None
    tile_first: torch.Tensor     # (n_tiles,) int32
    taps_r: torch.Tensor         # (n_tiles, 2, span // 8, 256) float32
    taps_i: torch.Tensor | None
    k: int                       # the longest column band (non-zero taps)
    span: int
    frag_first: torch.Tensor     # (frag_tiles,) int32
    frag_r: torch.Tensor         # (frag_tiles, frag_span // 8, 32, 4) float32
    frag_i: torch.Tensor | None
    frag_span: int

    @staticmethod
    def build(a_r: np.ndarray, a_i: np.ndarray | None, device) -> "Band":
        a_r = np.ascontiguousarray(a_r, np.float32)
        a_i = None if a_i is None or not np.any(a_i) else np.ascontiguousarray(a_i, np.float32)
        rows, g = a_r.shape
        nz = (a_r != 0) | (a_i != 0 if a_i is not None else False)
        has = nz.any(axis=0)
        lo = np.where(has, nz.argmax(axis=0), rows)
        hi = np.where(has, rows - 1 - nz[::-1].argmax(axis=0), -1)
        k = max(1, int((hi - lo + 1).max()))
        mats = [a_r] if a_i is None else [a_r, a_i]

        first, span, blocks = _tile_blocks(mats, lo, hi, TILE_COLS)
        steps = span // BAND_STEP

        def operand(b):
            # (T, step, kq, kh, ng, nr) -> (T, step, ng, kh, nr, kq)
            parts = [p.reshape(-1, steps, 4, 2, TILE_COLS // 8, 8)
                     .transpose(0, 1, 4, 3, 5, 2).reshape(-1, steps, 8 * TILE_COLS)
                     for p in tf32_split(b)]
            return np.stack(parts, axis=1)

        f_first, f_span, f_blocks = _tile_blocks(mats, lo, hi, FRAG_COLS)
        lane = np.arange(32)
        r, c = 2 * (lane % 4), lane // 4

        def fragments(b):
            b = b.reshape(b.shape[0], f_span // BAND_STEP, BAND_STEP, FRAG_COLS)
            return np.stack([b[:, :, r, c], b[:, :, r + 1, c],
                             b[:, :, r, c + 8], b[:, :, r + 1, c + 8]], axis=-1)

        dev = torch.device(device)
        t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        imag = lambda f, blk: None if a_i is None else t(f(blk[1]))
        return Band(a_r=t(a_r), a_i=None if a_i is None else t(a_i),
                    tile_first=t(first), taps_r=t(operand(blocks[0])),
                    taps_i=imag(operand, blocks), k=k, span=span,
                    frag_first=t(f_first), frag_r=t(fragments(f_blocks[0])),
                    frag_i=imag(fragments, f_blocks), frag_span=f_span)

    @property
    def rows(self) -> int:
        return self.a_r.shape[0]

    @property
    def g(self) -> int:
        return self.a_r.shape[1]

    @property
    def n_tiles(self) -> int:
        return self.tile_first.shape[0]

    @property
    def frag_tiles(self) -> int:
        return self.frag_first.shape[0]


# K2 over a band of fewer non-zero taps a column takes the mma.sync core
WIDE_BAND = 96


def banded_core(band: Band, dc: bool = False) -> str:
    """The product core a banded launch takes, a static rule by geometry:
    "wgmma" (csrc/banded.cu) for K1's banded launch (``dc``) and for K2
    over a wide band (band.k >= WIDE_BAND: the flagship's stage 1 with
    its lowpass composed in, as configs #2 and #5 have it, and FIR bands
    of 96 taps or more, whose longest, 2048 taps, held 98 dB from the
    twin summed in one accumulator, as the mma.sync core sums, and 100+
    in the wgmma core's two); "mma" (csrc/banded_mma.cu, the sm_80
    mma.sync core) for K2 over a narrower band (stage 0 of every
    configuration, stage 1 without the lowpass, the NRSC5 stages, FIRs
    of fewer taps), where on an H100 the wgmma core measured 10-22 %
    slower (PERF.md)."""
    return "wgmma" if dc or band.k >= WIDE_BAND else "mma"


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
                   pack_fmt, dc=None, core="wgmma"):
    """K2's launch on ``core``, or with ``dc`` = (pole, bound, halo_r,
    halo_i), the carry pass's outputs, K1's banded kernel with the
    DC-wire loader (the wgmma core)."""
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
    if core == "mma":
        tiles = (band.frag_r, band.frag_i, band.frag_first, band.frag_tiles, band.frag_span)
    else:
        tiles = (band.taps_r, band.taps_i, band.tile_first, band.n_tiles, band.span)
    geo = (_ptr(state_r), _ptr(state_i), *map(_ptr, tiles[:3]), *tiles[3:], ch, n,
           stride, hist, band.g, _ptr(out_r), _ptr(out_i), _ptr(packed),
           *_pack_args(pack_fmt), _stream())
    norm, gain = convert._f32(wire_norm), convert._f32(wire_gain)
    dth = int(nco_dtheta) & 0xFFFFFFFF
    with torch.cuda.device(dev):
        if dc:
            pole, bound, halo_r, halo_i = dc
            rc = lib.iq_banded_dc_apply(
                _ptr(wire), kind, norm, gain, _ptr(nco_phase), dth, float(pole),
                _ptr(bound), _ptr(halo_r), _ptr(halo_i), bound.shape[1], *geo)
        else:
            launch = lib.iq_banded_mma_apply if core == "mma" else lib.iq_banded_apply
            rc = launch(_ptr(xr), _ptr(xi), _ptr(wire), kind, norm, gain,
                        _ptr(nco_phase), dth, *geo)
    _check(rc, "banded kernel")
    return packed if pack_fmt else (out_r, out_i)


def banded_plan(band: Band, stride: int, hist: int, n: int, channels: int,
                dc_kind: str | None = None, core: str | None = None,
                wire_kind: str | None = None) -> dict:
    """The launch geometry of K2 over planes, or over the packed wire of
    ``wire_kind`` (with ``dc_kind``, of K1's banded launch over that
    wire) at these shapes on the current card, from the launchers' own
    rules: the core (``banded_core``, or ``core``), grid, threads and
    shared bytes a CTA, CTAs an SM, window groups a channel, the input's
    staging ("wire": decoded from the packed wire, on the mma.sync core
    from its raw buffer; "planar"), and on the wgmma core steps a ring
    slot, slots a ring and staged groups (2: the next one's copy in
    flight).  Launches nothing."""
    from iq_tool_tpu_torch.ops import _build
    lib = _build.library()
    core = core or banded_core(band, dc_kind is not None)
    cplx = int(band.taps_i is not None)
    if core == "mma":
        out = (ctypes.c_int * 6)()
        rc = lib.iq_banded_mma_plan(cplx, _WIRE_KINDS[wire_kind] if wire_kind else _PLANAR,
                                    band.frag_tiles, band.frag_span, channels, n, stride,
                                    hist, band.g, out)
        keys = ("grid", "threads", "smem", "ctas_per_sm", "groups")
        wire = bool(out[5])
    else:
        out = (ctypes.c_int * 8)()
        rc = lib.iq_banded_plan(cplx, int(dc_kind is not None),
                                _WIRE_KINDS[dc_kind] if dc_kind else _PLANAR, band.n_tiles,
                                band.span, channels, n, stride, hist, band.g, out)
        keys = ("grid", "threads", "smem", "cs", "ring", "ctas_per_sm", "groups", "nbuf")
        wire = bool(dc_kind or wire_kind)
    _check(rc, "banded plan")
    return {"core": core, **dict(zip(keys, out)), "staging": "wire" if wire else "planar"}


def banded_apply(state_r, state_i, xr, xi, a_r, a_i, stride: int, hist: int,
                 pack_fmt=None, wire_i32=None, wire_norm: float = 0.0,
                 wire_gain: float = 1.0, nco_dtheta: int = 0, nco_phase=None,
                 wire_kind: str = "cs16", core: str | None = None):
    """K2: strided-window banded map over one block.

    state_*: (C, hist) carried history (processed, pre-rotated);
    x*: (C, n) float32 planes, or ``wire_i32`` (C, n) packed wire
    (convert.wire_pack) decoded with wire_norm/wire_gain and, with
    ``nco_dtheta``, NCO-mixed at each sample's index after ``nco_phase``
    ((C,) int64 uint32 values); a_r/a_i: (stride + hist, G) numpy
    matrix, or a_r a prepared Band.  Returns (yr, yi) (C, (n//stride)*G)
    float32, or with ``pack_fmt`` one packed-wire tensor.  On CUDA the
    product core is ``banded_core``'s, or ``core`` ("wgmma" | "mma");
    ``launches`` counts every launch, ``banded_apply_mma.launches`` those
    on the mma.sync core."""
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
    core = core or banded_core(band)
    if core not in ("wgmma", "mma"):
        raise ValueError(f"unknown product core {core!r}")
    out = _launch_banded(lib, band, state_r, state_i, xr, xi, wire_i32, kind,
                         wire_norm, wire_gain, nco_dtheta if wire_i32 is not None else 0,
                         nco_phase, stride, hist, pack_fmt, core=core)
    if core == "mma":
        _launched("banded_mma_kernel", banded_apply, banded_apply_mma)
    else:
        _launched("banded_kernel", banded_apply)
    return out


banded_apply.launches = 0


def banded_apply_mma(*args, **kwargs):
    """K2 on the mma.sync core whatever the rule says: banded_apply(...,
    core="mma").  Its ``launches`` counts K2's launches on that core,
    through either name."""
    return banded_apply(*args, **kwargs, core="mma")


banded_apply_mma.launches = 0


# ------------------------------ K1 --------------------------------------------

def banded_apply_dc_ref(state_r, state_i, dc_state, dc_alpha: float, a_r, a_i,
                        stride: int, hist: int, wire_i32, wire_norm: float,
                        wire_gain: float = 1.0, nco_dtheta: int = 0,
                        nco_phase=None, pack_fmt=None, wire_kind: str = "cs16"):
    """Plain twin of banded_apply_dc: decode, DC block and NCO over the
    whole block (the prologue's twin), then the plain banded map."""
    yr, yi, _, _, new_dc = dc_prologue_ref(wire_i32, dc_state, dc_alpha, hist,
                                           wire_norm, wire_gain, nco_dtheta,
                                           nco_phase, wire_kind)
    out = banded_apply_ref(state_r, state_i, yr, yi, a_r, a_i, stride, hist,
                           pack_fmt)
    return (out, banded.new_tail(state_r, yr, hist),
            banded.new_tail(state_i, yi, hist), new_dc)


# csrc/banded_dc.cu's tiling: a CTA takes DC_THREADS x DC_PER samples of
# one channel, and tiles look back in groups of DC_GROUP.  The library
# exports its own (iq_dc_geometry); the first launch checks they agree.
DC_THREADS, DC_PER, DC_GROUP = 256, 16, 32
DC_TILE = DC_THREADS * DC_PER
_DC_SCRATCH: dict = {}   # (device index, stream) -> the DC look-back buffer
_dc_seq = 0
# csrc/banded_dc.cu's DcLook: per (channel, tile) two double2 values, then
# the two status-word arrays of 4 bytes each
_DC_VALUE_BYTES, _DC_FLAG_BYTES = 32, 8


def _per_stream(table: dict, dev: torch.device, need: int, make, what: str):
    """The scratch buffer of this device and stream in ``table``, made by
    ``make()`` when missing or smaller than ``need`` elements.  A buffer
    made while the stream captures a CUDA graph would come from the
    graph's pool and be made anew at every replay: that raises, as the
    graph's warm-up steps on the capture stream allocate every one."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    buf = table.get(key)
    if buf is None or buf.numel() < need:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"the {what} buffer of this stream was not made "
                               "before the CUDA graph capture (warm up on the "
                               "capture stream first)")
        buf = table[key] = make()
    return buf


def stream_scratch(dev: torch.device, stream) -> list:
    """The per-stream scratch buffers (the DC look-back, the estimator's
    ticket) of ``stream`` on ``dev`` (without an index: the current
    device).  A launch captured into a CUDA graph
    keeps its buffer's address, while a later launch on the same stream
    that needs a larger one replaces the table's entry: a graph holds these
    references so that its buffers outlive the entry."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    key = (index, stream.cuda_stream)
    return [t[key] for t in (_DC_SCRATCH, _EST_TICKETS) if key in t]


def _dc_look(lib, dev: torch.device, channels: int, n: int):
    """(scratch, sequence number) of one DC kernel launch: the look-back
    status buffer of this device and stream, zeroed once when it is
    allocated or grown (its status words hold the launch's sequence
    number, so no eager launch clears it), and a new nonzero sequence
    number.  A launch captured into a CUDA graph keeps its number at every
    replay, so a replay would take the words its previous replay left as
    this launch's: under capture a memset of the launch's status words
    goes into the graph ahead of the kernel."""
    global _dc_seq
    if _dc_seq == 0:
        geo = (ctypes.c_int * 3)()
        lib.iq_dc_geometry(geo)
        if tuple(geo) != (DC_THREADS, DC_PER, DC_GROUP):
            raise RuntimeError(f"csrc/banded_dc.cu tiles {tuple(geo)}, "
                               f"ops/kernels.py {(DC_THREADS, DC_PER, DC_GROUP)}")
    need = int(lib.iq_dc_scratch_bytes(channels, n))
    entries = channels * -(-n // DC_TILE)
    if need != entries * (_DC_VALUE_BYTES + _DC_FLAG_BYTES):
        raise RuntimeError(f"csrc/banded_dc.cu wants {need} scratch bytes for "
                           f"{entries} tiles, ops/kernels.py's layout "
                           f"{entries * (_DC_VALUE_BYTES + _DC_FLAG_BYTES)}")
    buf = _per_stream(_DC_SCRATCH, dev, need,
                      lambda: torch.zeros(need, dtype=torch.uint8, device=dev),
                      "DC look-back")
    if torch.cuda.is_current_stream_capturing():
        buf[entries * _DC_VALUE_BYTES:need].zero_()
    _dc_seq = _dc_seq % 0x7FFFFFFF + 1
    return buf, _dc_seq


def dc_prologue_ref(wire_i32, dc_state, dc_alpha: float, hist: int,
                    wire_norm: float, wire_gain: float = 1.0, nco_dtheta: int = 0,
                    nco_phase=None, wire_kind: str = "cs16"):
    """Plain twin of dc_prologue: decode, the two-level DC scan
    (ops/dc_block.py), NCO mix, the last ``hist`` samples."""
    xr, xi = convert.decode_packed(wire_i32, wire_kind, wire_norm, wire_gain)
    yr, yi, new_dc = dc_block.apply_planar_ref(xr, xi, dc_state, dc_alpha)
    if nco_dtheta:
        yr, yi = nco.mix(yr, yi, nco_phase, nco_dtheta)
    n = yr.shape[-1]
    return yr, yi, yr[:, n - hist:].contiguous(), yi[:, n - hist:].contiguous(), new_dc


def dc_prologue(wire_i32, dc_state, dc_alpha: float, hist: int,
                wire_norm: float, wire_gain: float = 1.0, nco_dtheta: int = 0,
                nco_phase=None, wire_kind: str = "cs16"):
    """K1's prologue: packed wire (C, n) -> decode -> DC block -> NCO mix.
    Returns (yr, yi, tail_r, tail_i, new_dc_state): the processed (C, n)
    planes, their last ``hist`` samples and the (C, 4) DC state."""
    if not wire_norm:
        raise ValueError("dc_prologue requires wire input")
    _check_args(wire_i32, wire_norm, nco_dtheta, nco_phase, None)
    ch, n = wire_i32.shape
    if not 0 <= hist <= n:
        raise ValueError(f"block of {n} samples is shorter than the history {hist}")
    if wire_i32.device.type == "cpu":
        return dc_prologue_ref(wire_i32, dc_state, dc_alpha, hist, wire_norm,
                               wire_gain, nco_dtheta, nco_phase, wire_kind)
    from iq_tool_tpu_torch.ops import _build
    lib = _build.library()
    _require_cuda(wire_i32, dc_state, nco_phase)
    _require_dtypes(wire_i32, _WIRE_KINDS[wire_kind], nco_phase, dc_state)
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
        look, seq = _dc_look(lib, dev, ch, n)
        rc = lib.iq_dc_prologue(
            _ptr(wire_i32), _WIRE_KINDS[wire_kind], convert._f32(wire_norm),
            convert._f32(wire_gain), _ptr(dc_state), float(1.0 - dc_alpha),
            _ptr(nco_phase), dth, ch, n, hist, _ptr(yr), _ptr(yi), _ptr(tail_r),
            _ptr(tail_i), _ptr(new_dc), _ptr(look), seq, _stream())
    _check(rc, "dc prologue kernel")
    _launched("dc_kernel", dc_prologue)
    return yr, yi, tail_r, tail_i, new_dc


dc_prologue.launches = 0


# csrc/banded.cu's window group: a CTA stages and multiplies 32 windows of
# one channel at a time (the products' M: 32 windows x 2 planes), so K1's
# carry pass cuts the block at every 32 strides
BAND_WIN = 32


def dc_groups(n: int, stride: int) -> int:
    """Window groups of a channel's block of n samples at this stride."""
    return -(-(n // stride) // BAND_WIN)


def dc_carry_ref(wire_i32, dc_state, dc_alpha: float, stride: int, hist: int,
                 wire_norm: float, wire_gain: float = 1.0, nco_dtheta: int = 0,
                 nco_phase=None, wire_kind: str = "cs16"):
    """Plain twin of dc_carry: the float64 DC scan of the whole block
    (ops/dc_block.py), read at the group boundaries, then rounded and
    NCO-mixed for the halos and the tail."""
    xr, xi = convert.decode_packed(wire_i32, wire_kind, wire_norm, wire_gain)
    yr64 = dc_block.scan_plane(xr, dc_state[:, 0], dc_state[:, 2], dc_alpha)
    yi64 = dc_block.scan_plane(xi, dc_state[:, 1], dc_state[:, 3], dc_alpha)
    ch, n = xr.shape
    groups, bw = dc_groups(n, stride), BAND_WIN * stride
    yr, yi = yr64.float(), yi64.float()
    new_dc = torch.stack([xr[:, -1], xi[:, -1], yr[:, -1], yi[:, -1]], dim=-1)
    if nco_dtheta:
        yr, yi = nco.mix(yr, yi, nco_phase, nco_dtheta)
    before = bw * torch.arange(1, groups, device=xr.device) - 1
    bound = torch.cat([dc_state[:, None, [2, 3, 0, 1]].double(),
                       torch.stack([yr64[:, before], yi64[:, before],
                                    xr[:, before].double(), xi[:, before].double()],
                                   dim=-1)], dim=1)
    pos = (bw * torch.arange(groups, device=xr.device)[:, None] - hist
           + torch.arange(hist, device=xr.device)[None, :])
    halo_r, halo_i = (torch.where(pos >= 0, y[:, pos.clamp(min=0)], 0.0)
                      for y in (yr, yi))
    return (bound, halo_r, halo_i, yr[:, n - hist:].contiguous(),
            yi[:, n - hist:].contiguous(), new_dc)


def dc_carry(wire_i32, dc_state, dc_alpha: float, stride: int, hist: int,
             wire_norm: float, wire_gain: float = 1.0, nco_dtheta: int = 0,
             nco_phase=None, wire_kind: str = "cs16"):
    """K1's carry pass: the DC kernel over the packed wire (C, n), writing
    no planes.  Returns (bound, halo_r, halo_i, tail_r, tail_i, new_dc):
    for each window group g of ``dc_groups(n, stride)`` (its first sample
    at 16 * stride * g) the float64 state [yr, yi, xr, xi] just before it
    (C, groups, 4) and the ``hist`` processed samples before it (C,
    groups, hist; zeros before the block), the block's last ``hist``
    processed samples and the new (C, 4) DC state."""
    if not wire_norm:
        raise ValueError("dc_carry requires wire input")
    _check_args(wire_i32, wire_norm, nco_dtheta, nco_phase, None)
    ch, n = wire_i32.shape
    if stride <= 0 or n < stride:
        raise ValueError(f"block of {n} samples is shorter than the stride {stride}")
    if not 0 <= hist <= n:
        raise ValueError(f"block of {n} samples is shorter than the history {hist}")
    if wire_i32.device.type == "cpu":
        return dc_carry_ref(wire_i32, dc_state, dc_alpha, stride, hist, wire_norm,
                            wire_gain, nco_dtheta, nco_phase, wire_kind)
    from iq_tool_tpu_torch.ops import _build
    lib = _build.library()
    _require_cuda(wire_i32, dc_state, nco_phase)
    _require_dtypes(wire_i32, _WIRE_KINDS[wire_kind], nco_phase, dc_state)
    if dc_state.shape != (ch, 4):
        raise ValueError(f"dc_state must be ({ch}, 4)")
    dev = wire_i32.device
    groups = dc_groups(n, stride)
    bound = torch.empty((ch, groups, 4), dtype=torch.float64, device=dev)
    halo_r = torch.empty((ch, groups, hist), dtype=torch.float32, device=dev)
    halo_i = torch.empty_like(halo_r)
    tail_r = torch.empty((ch, hist), dtype=torch.float32, device=dev)
    tail_i = torch.empty_like(tail_r)
    new_dc = torch.empty((ch, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        look, seq = _dc_look(lib, dev, ch, n)
        rc = lib.iq_dc_carry(
            _ptr(wire_i32), _WIRE_KINDS[wire_kind], convert._f32(wire_norm),
            convert._f32(wire_gain), _ptr(dc_state), float(1.0 - dc_alpha),
            _ptr(nco_phase), int(nco_dtheta) & 0xFFFFFFFF, ch, n, hist,
            BAND_WIN * stride, groups, _ptr(bound), _ptr(halo_r), _ptr(halo_i),
            _ptr(tail_r), _ptr(tail_i), _ptr(new_dc), _ptr(look), seq, _stream())
    _check(rc, "dc carry kernel")
    _launched("dc_kernel", dc_carry)
    return bound, halo_r, halo_i, tail_r, tail_i, new_dc


dc_carry.launches = 0


def banded_apply_dc(state_r, state_i, dc_state, dc_alpha: float, a_r, a_i,
                    stride: int, hist: int, wire_i32, wire_norm: float,
                    wire_gain: float = 1.0, nco_dtheta: int = 0,
                    nco_phase=None, pack_fmt=None, wire_kind: str = "cs16"):
    """K1: stage 0 with the wire decode + DC block + NCO prologue.

    state_*: (C, hist) PROCESSED stage history (post-DC, pre-rotated);
    dc_state: (C, 4) [xr, xi, yr, yi] prevs.  Returns (y | packed wire,
    tail_r, tail_i, new_dc_state), tail_* the processed (C, hist)
    history for the next block.  On CUDA this is two launches and no
    processed planes: the carry pass (``dc_carry``), then the banded
    kernel, which decodes, DC-blocks (from the carry pass's group states)
    and NCO-mixes the wire in its loader.  A geometry it cannot take
    raises."""
    if not wire_norm:
        raise ValueError("banded_apply_dc requires wire input")
    _check_args(wire_i32, wire_norm, nco_dtheta, nco_phase, pack_fmt)
    if wire_i32.device.type == "cpu":
        return banded_apply_dc_ref(state_r, state_i, dc_state, dc_alpha, a_r, a_i,
                                   stride, hist, wire_i32, wire_norm, wire_gain,
                                   nco_dtheta, nco_phase, pack_fmt, wire_kind)
    from iq_tool_tpu_torch.ops import _build
    bound, halo_r, halo_i, tail_r, tail_i, new_dc = dc_carry(
        wire_i32, dc_state, dc_alpha, stride, hist, wire_norm, wire_gain,
        nco_dtheta, nco_phase, wire_kind)
    dev = wire_i32.device
    out = _launch_banded(_build.library(), _band(a_r, a_i, dev), state_r, state_i,
                         None, None, wire_i32, _WIRE_KINDS[wire_kind], wire_norm,
                         wire_gain, nco_dtheta, nco_phase, stride, hist, pack_fmt,
                         dc=(1.0 - dc_alpha, bound, halo_r, halo_i))
    _launched("banded_kernel", banded_apply_dc)
    return out, tail_r, tail_i, new_dc


banded_apply_dc.launches = 0


# ------------------------------ K3 --------------------------------------------

def dc_block_apply_ref(xr, xi, state, alpha: float, iq_factors=None,
                       phase_acc=None, dtheta: int = 0, wire_i32=None,
                       wire_norm: float = 0.0, wire_gain: float = 1.0,
                       wire_kind: str = "cs16"):
    """Plain twin of dc_block_apply: decode, the two-level DC scan
    (ops/dc_block.py), I/Q apply, NCO mix."""
    if wire_i32 is not None:
        xr, xi = convert.decode_packed(wire_i32, wire_kind, wire_norm, wire_gain)
    yr, yi, new_state = dc_block.apply_planar_ref(xr, xi, state, alpha)
    if iq_factors is not None:
        yr, yi = iq_balance.apply_planar(yr, yi, iq_factors)
    if dtheta:
        yr, yi = nco.mix(yr, yi, phase_acc, dtheta)
    return yr, yi, new_state


def dc_block_apply(xr, xi, state, alpha: float, iq_factors=None,
                   phase_acc=None, dtheta: int = 0, wire_i32=None,
                   wire_norm: float = 0.0, wire_gain: float = 1.0,
                   wire_kind: str = "cs16"):
    """K3: DC block with the I/Q apply and NCO mix behind it.

    x*: (C, N) float32 planes, or ``wire_i32`` (C, N) packed wire
    (convert.wire_pack) decoded with wire_norm/wire_gain; state: (C, 4)
    [xr, xi, yr, yi] prevs; iq_factors: (C, 2) [g, phi] or None;
    phase_acc: (C,) int64 uint32 phases, needed when dtheta != 0.  Any N.
    Returns (yr, yi, new_state); the state is the pre-I/Q DC state."""
    if wire_i32 is not None and not wire_norm:
        raise ValueError("wire_i32 requires wire_norm (the format normalizer)")
    if dtheta and phase_acc is None:
        raise ValueError("dtheta needs phase_acc")
    x0 = wire_i32 if wire_i32 is not None else xr
    if x0.device.type == "cpu":
        return dc_block_apply_ref(xr, xi, state, alpha, iq_factors, phase_acc,
                                  dtheta, wire_i32, wire_norm, wire_gain,
                                  wire_kind)
    from iq_tool_tpu_torch.ops import _build
    lib = _build.library()
    if wire_i32 is not None:
        xr = xi = None
        kind = _WIRE_KINDS[wire_kind]
    else:
        kind = _PLANAR
    dth = int(dtheta) & 0xFFFFFFFF
    _require_cuda(wire_i32, xr, xi, state, iq_factors, phase_acc if dth else None)
    _require_dtypes(wire_i32, kind, phase_acc if dth else None, xr, xi, state,
                    iq_factors)
    ch, n = x0.shape
    if state.shape != (ch, 4):
        raise ValueError(f"state must be ({ch}, 4)")
    if iq_factors is not None and iq_factors.shape != (ch, 2):
        raise ValueError(f"iq_factors must be ({ch}, 2)")
    dev = x0.device
    yr = torch.empty((ch, n), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    new_state = torch.empty((ch, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        look, seq = _dc_look(lib, dev, ch, n)
        rc = lib.iq_dc_block_apply(
            _ptr(wire_i32), kind, convert._f32(wire_norm), convert._f32(wire_gain),
            _ptr(xr), _ptr(xi), _ptr(state), float(1.0 - alpha), _ptr(iq_factors),
            _ptr(phase_acc if dth else None), dth, ch, n, _ptr(yr), _ptr(yi),
            _ptr(new_state), _ptr(look), seq, _stream())
    _check(rc, "dc block kernel")
    _launched("dc_kernel", dc_block_apply)
    return yr, yi, new_state


dc_block_apply.launches = 0


# ------------------------------ K3pre -----------------------------------------

def pre_apply_ref(xr, xi, iq_factors=None, phase_acc=None, dtheta: int = 0,
                  wire_i32=None, wire_norm: float = 0.0, wire_gain: float = 1.0,
                  wire_kind: str = "cs16"):
    """Plain twin of pre_apply: decode, I/Q apply, NCO mix in tensor ops
    (the chain's pre-stage without a DC block as it ran before the kernel)."""
    if wire_i32 is not None:
        xr, xi = convert.decode_packed(wire_i32, wire_kind, wire_norm, wire_gain)
    if iq_factors is not None:
        xr, xi = iq_balance.apply_planar(xr, xi, iq_factors)
    if dtheta:
        xr, xi = nco.mix(xr, xi, phase_acc, dtheta)
    return xr.contiguous(), xi.contiguous()


def pre_apply(xr, xi, iq_factors=None, phase_acc=None, dtheta: int = 0,
              wire_i32=None, wire_norm: float = 0.0, wire_gain: float = 1.0,
              wire_kind: str = "cs16"):
    """K3pre (``csrc/pre.cu``): the chain's pre-stage without a DC block,
    I/Q apply + NCO mix, in one pass.

    x*: (C, N) float32 planes, or ``wire_i32`` (C, N) packed wire
    (convert.wire_pack) decoded with wire_norm/wire_gain; iq_factors:
    (C, 2) [g, phi] or None; phase_acc: (C,) int64 uint32 phases, needed
    when dtheta != 0.  Any N and any alignment.  Returns (yr, yi)."""
    if wire_i32 is not None and not wire_norm:
        raise ValueError("wire_i32 requires wire_norm (the format normalizer)")
    if dtheta and phase_acc is None:
        raise ValueError("dtheta needs phase_acc")
    x0 = wire_i32 if wire_i32 is not None else xr
    if x0.device.type == "cpu":
        return pre_apply_ref(xr, xi, iq_factors, phase_acc, dtheta, wire_i32,
                             wire_norm, wire_gain, wire_kind)
    from iq_tool_tpu_torch.ops import _build
    lib = _build.library()
    if wire_i32 is not None:
        xr = xi = None
        kind = _WIRE_KINDS[wire_kind]
    else:
        kind = _PLANAR
    dth = int(dtheta) & 0xFFFFFFFF
    phase = phase_acc if dth else None
    _require_cuda(wire_i32, xr, xi, iq_factors, phase)
    _require_dtypes(wire_i32, kind, phase, xr, xi, iq_factors)
    ch, n = x0.shape
    dev = x0.device
    if any(t is not None and t.device != dev for t in (xi, iq_factors, phase)):
        raise ValueError(f"kernel inputs must all lie on {dev}")
    if xi is not None and xi.shape != (ch, n):
        raise ValueError(f"xi must be ({ch}, {n})")
    if iq_factors is not None and iq_factors.shape != (ch, 2):
        raise ValueError(f"iq_factors must be ({ch}, 2)")
    if phase is not None and phase.shape != (ch,):
        raise ValueError(f"phase_acc must be ({ch},)")
    yr = torch.empty((ch, n), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    with torch.cuda.device(dev):
        rc = lib.iq_pre_apply(
            _ptr(wire_i32), kind, convert._f32(wire_norm), convert._f32(wire_gain),
            _ptr(xr), _ptr(xi), _ptr(iq_factors), _ptr(phase), dth, ch, n,
            _ptr(yr), _ptr(yi), _stream())
    _check(rc, "pre-stage kernel")
    _launched("pre_kernel", pre_apply)
    return yr, yi


pre_apply.launches = 0


# ------------------------------ K4 --------------------------------------------

def _segment_gains(gains: torch.Tensor, seg: int, n: int) -> torch.Tensor:
    """(C, n) or (C, 1) per-sample gains: samples past the last whole
    segment take the last segment's gain."""
    if not seg:
        return gains[:, :1]
    idx = torch.clamp(torch.arange(n, device=gains.device) // seg,
                      max=gains.shape[-1] - 1)
    return gains[:, idx]


def post_apply_ref(xr, xi, gains, seg: int, phase_acc=None, dtheta: int = 0,
                   out_fmt: str = "cs16"):
    """Plain twin of post_apply: NCO mix, gain multiply, pack."""
    if dtheta:
        xr, xi = nco.mix(xr, xi, phase_acc, dtheta)
    g = _segment_gains(gains, seg, xr.shape[-1])
    return pack_wire_ref(xr * g, xi * g, out_fmt)


def post_apply(xr, xi, gains, seg: int, phase_acc=None, dtheta: int = 0,
               out_fmt: str = "cs16"):
    """K4: post-NCO + AGC gains + quantize-and-pack over (C, N) planes.

    gains: (C, n_seg) float32 gains of consecutive ``seg``-sample segments
    (the chain's AGC gives seg 128; samples past n_seg*seg take the last
    gain), or (C, 1) with seg 0 (one gain per channel: the digital
    profile, or no AGC); phase_acc: (C,) int64 uint32 phases when
    dtheta != 0.  Returns the (C, N) packed wire (int32 for 16-bit
    formats, int16 for 8-bit)."""
    if not packable_out(out_fmt):
        raise ValueError(f"format {out_fmt!r} has no packed epilogue")
    if seg < 0 or (not seg and gains.shape[-1] != 1):
        raise ValueError("seg 0 takes (C, 1) gains; seg > 0 takes (C, n_seg)")
    if dtheta and phase_acc is None:
        raise ValueError("dtheta needs phase_acc")
    if xr.device.type == "cpu":
        return post_apply_ref(xr, xi, gains, seg, phase_acc, dtheta, out_fmt)
    from iq_tool_tpu_torch.ops import _build
    lib = _build.library()
    dth = int(dtheta) & 0xFFFFFFFF
    _require_cuda(xr, xi, gains, phase_acc if dth else None)
    _require_dtypes(None, 0, phase_acc if dth else None, xr, xi, gains)
    ch, n = xr.shape
    if xi.shape != (ch, n) or gains.shape[0] != ch or gains.dim() != 2:
        raise ValueError(f"planes must be ({ch}, {n}) and gains ({ch}, m)")
    out = torch.empty((ch, n), dtype=_PACK_INFO[out_fmt][0], device=xr.device)
    with torch.cuda.device(xr.device):
        rc = lib.iq_post_apply(
            _ptr(xr), _ptr(xi), _ptr(gains), int(seg), gains.shape[-1],
            _ptr(phase_acc if dth else None), dth, ch, n, _ptr(out),
            *_pack_args(out_fmt), _stream())
    _check(rc, "post kernel")
    _launched("post_kernel", post_apply)
    return out


post_apply.launches = 0


def _scan_consts(beta: float, target: float):
    """(beta, 1 - beta, -beta/2, target^2) rounded to float32 as the
    reference's float32 scan computes them."""
    b = convert._f32(beta)
    return (b, convert._f32(1.0 - b), convert._f32(-0.5 * b),
            convert._f32(target * target))


def _chain_consts(beta: float, target: float):
    """_scan_consts and inv_t2, as csrc/post.cu's chains take them: t2's
    reciprocal when t2 is a power of two (the multiplication by it gives
    the division's bits, without the division on the chain), else 0."""
    b, omb, nhb, t2 = _scan_consts(beta, target)
    pow2 = math.frexp(t2)[0] == 0.5 and 1.0 / t2 < float(np.finfo(np.float32).max)
    return b, omb, nhb, t2, 1.0 / t2 if pow2 else 0.0


def rms_scan_ref(e_in, gain, e2, beta: float, target: float):
    """The AGC's per-segment gain loop in tensor ops, the reference's
    rms_scan: e_in (n_seg, C) mean input energies, gain/e2 (C,) ->
    (gains (n_seg, C), final gain, final e2)."""
    b, omb, nhb, t2 = _scan_consts(beta, target)
    g, e2_ = gain, e2
    gains = []
    for k in range(e_in.shape[0]):
        e_out = e_in[k] * g * g
        e2_ = omb * e2_ + b * e_out
        g = g * torch.exp(nhb * torch.log(torch.clamp(e2_, min=1e-16) / t2))
        g = torch.clamp(g, 1e-6, 1e6)
        gains.append(g)
    return torch.stack(gains), g, e2_


def agc_segments(n: int) -> tuple[int, int]:
    """(n_seg, seg): the AGC's segments of a block of n samples, about
    AGC_SEGMENT samples each; samples past n_seg * seg take no part."""
    n_seg = max(n // C.AGC_SEGMENT, 1)
    return n_seg, n // n_seg


def segment_energies_ref(xr, xi, rows: int = 1):
    """Plain twin of segment_energies: torch.mean over each segment."""
    c, n = xr.shape
    n_seg, seg = agc_segments(n // rows)
    xsr = xr.reshape(c * rows, n // rows)[:, :n_seg * seg].reshape(c, rows * n_seg, seg)
    xsi = xi.reshape(c * rows, n // rows)[:, :n_seg * seg].reshape(c, rows * n_seg, seg)
    return torch.mean(xsr * xsr + xsi * xsi, dim=-1)


def segment_energies(xr, xi, rows: int = 1):
    """The AGC's segment energies of a block, mean(xr^2 + xi^2) over each
    of the agc_segments(n // rows) segments of each of ``rows`` rows, as
    rms_gains computes them (its producer warps alone, csrc/post.cu
    iq_agc_energies): (C, n) float32 planes -> (C, rows * n_seg).  The
    sharded chain's time shards each compute theirs for the gain loop
    over the gathered sequence (agc_chain)."""
    if xr.device.type == "cpu":
        return segment_energies_ref(xr, xi, rows)
    from iq_tool_tpu_torch.ops import _build
    lib = _build.library()
    _require_cuda(xr, xi)
    _require_dtypes(None, 0, None, xr, xi)
    ch, n = xr.shape
    if xi.shape != (ch, n):
        raise ValueError(f"planes must both be ({ch}, {n})")
    if n % rows:
        raise ValueError(f"a block of {n} samples is not {rows} rows")
    n_seg, seg = agc_segments(n // rows)
    energies = torch.empty((ch, rows * n_seg), dtype=torch.float32, device=xr.device)
    with torch.cuda.device(xr.device):
        rc = lib.iq_agc_energies(_ptr(xr), _ptr(xi), n, rows, seg, n_seg, ch,
                                 _ptr(energies), _stream())
    _check(rc, "agc energies kernel")
    _launched("agc_energies_kernel", segment_energies)
    return energies


segment_energies.launches = 0


def rms_gains_ref(xr, xi, gain, e2, beta: float, target: float, rows: int = 1):
    """Plain twin of rms_gains: the segment energies by torch.mean, then
    the per-segment loop (rms_scan_ref)."""
    e_in = segment_energies_ref(xr, xi, rows).T.contiguous()   # (rows n_seg, C)
    gains, g_fin, e2_fin = rms_scan_ref(e_in, gain, e2, beta, target)
    return gains.T.contiguous(), g_fin, e2_fin


def rms_gains(xr, xi, gain, e2, beta: float, target: float, rows: int = 1):
    """The AGC's RMS gains of a block (helper kernel in csrc/post.cu; the
    reference runs a mean and a lax.scan): (C, n) float32 planes and the
    (C,) gain and smoothed energy carried in -> (gains (C, rows * n_seg),
    final gain, final e2).  Each channel's block is ``rows`` consecutive
    rows (a time fold), each cut into the agc_segments(n // rows)
    segments; the gain loop runs once over all rows' segments in time
    order."""
    if xr.device.type == "cpu":
        return rms_gains_ref(xr, xi, gain, e2, beta, target, rows)
    from iq_tool_tpu_torch.ops import _build
    lib = _build.library()
    _require_cuda(xr, xi, gain, e2)
    _require_dtypes(None, 0, None, xr, xi, gain, e2)
    ch, n = xr.shape
    if xi.shape != (ch, n) or gain.shape != (ch,) or e2.shape != (ch,):
        raise ValueError(f"planes must be ({ch}, {n}) and gain, e2 ({ch},)")
    if n % rows:
        raise ValueError(f"a block of {n} samples is not {rows} rows")
    n_seg, seg = agc_segments(n // rows)
    gains = torch.empty((ch, rows * n_seg), dtype=torch.float32, device=xr.device)
    g_fin = torch.empty_like(gain)
    e2_fin = torch.empty_like(e2)
    with torch.cuda.device(xr.device):
        rc = lib.iq_agc_rms_gains(_ptr(xr), _ptr(xi), n, rows, seg, n_seg, _ptr(gain),
                                  _ptr(e2), *_chain_consts(beta, target), ch,
                                  _ptr(gains), _ptr(g_fin), _ptr(e2_fin), _stream())
    _check(rc, "agc gains kernel")
    _launched("agc_rms_gains_kernel", rms_gains)
    return gains, g_fin, e2_fin


rms_gains.launches = 0


def agc_chain(e_in, gain, e2, beta: float, target: float):
    """The AGC's gain loop alone over given energies e_in (C, n_seg), one
    thread a channel (csrc/post.cu iq_agc_chain): the sharded chain's
    gain loop over the segment energies gathered from its time shards
    (``parallel/sharded.py``), and the dependency chain of rms_gains,
    timed by chip_smoke.py as that kernel's floor.  Returns (gains (C,
    n_seg), final gain, final e2); a CPU tensor runs rms_scan_ref."""
    if e_in.device.type == "cpu":
        gains, g_fin, e2_fin = rms_scan_ref(e_in.T, gain, e2, beta, target)
        return gains.T.contiguous(), g_fin, e2_fin
    from iq_tool_tpu_torch.ops import _build
    lib = _build.library()
    _require_cuda(e_in, gain, e2)
    _require_dtypes(None, 0, None, e_in, gain, e2)
    ch, n_seg = e_in.shape
    if gain.shape != (ch,) or e2.shape != (ch,):
        raise ValueError(f"gain and e2 must be ({ch},)")
    gains = torch.empty((ch, n_seg), dtype=torch.float32, device=e_in.device)
    g_fin = torch.empty_like(gain)
    e2_fin = torch.empty_like(e2)
    with torch.cuda.device(e_in.device):
        rc = lib.iq_agc_chain(_ptr(e_in), n_seg, _ptr(gain), _ptr(e2),
                              *_chain_consts(beta, target), ch, _ptr(gains),
                              _ptr(g_fin), _ptr(e2_fin), _stream())
    _check(rc, "agc chain kernel")
    _launched("agc_chain_kernel", agc_chain)
    return gains, g_fin, e2_fin


agc_chain.launches = 0


# ------------------------------ K5 --------------------------------------------

# A window of nfft points runs on one CTA up to OSFFT_LOCAL points, above
# that on a cluster of nfft / OSFFT_LOCAL CTAs (csrc/osfft.cu takes up to
# 4): 32768 is the largest size a filter of up to 8193 taps gets
# (choose_fft_block), 65536 what 8194-16385 taps get.
OSFFT_LOCAL = 16384
OSFFT_MIN_NFFT = 1024
OSFFT_MAX_NFFT = 4 * OSFFT_LOCAL


def _bitrev(nfft: int) -> np.ndarray:
    bits = nfft.bit_length() - 1
    idx = np.arange(nfft)
    rev = np.zeros(nfft, np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@dataclasses.dataclass(frozen=True)
class Spectrum:
    """A filter's frequency response ready for both paths: H (nfft,)
    complex64 for the twin, and for the kernel, split over a cluster of
    C = 2^log2c CTAs of nl = nfft / C points, H/nfft in each CTA's
    bit-reversed order laid out by thread (h_k[q nl + j nl/32 + t] =
    H[C bitrev(32 t + j) + q] / nfft: thread t's 32 points of CTA q's
    last pass) and the two twiddle tables exp(-2 pi i m / nfft), m < 2^B
    and m = i * 2^B, as interleaved float32 pairs (computed in
    float64)."""
    h: torch.Tensor
    h_k: torch.Tensor            # (nfft, 2) float32
    tw_lo: torch.Tensor          # (2^B, 2) float32
    tw_hi: torch.Tensor          # (nfft / 2^B, 2) float32
    tw_bits: int                 # B
    log2c: int

    @staticmethod
    def build(h, device) -> "Spectrum":
        h = np.asarray(h, np.complex64)
        nfft = h.shape[0]
        if nfft < 2 or nfft & (nfft - 1):
            raise ValueError(f"nfft must be a power of two >= 2, got {nfft}")
        log2n = nfft.bit_length() - 1
        bits = max(1, log2n // 2)
        cs = max(1, nfft // OSFFT_LOCAL)
        nl = nfft // cs
        k = cs * _bitrev(nl)[None, :] + np.arange(cs)[:, None]      # (C, nl)
        h_k = h[k] / np.float32(nfft)                         # exact: nfft is 2^k
        if nl >= 32:
            h_k = h_k.reshape(cs, nl // 32, 32).transpose(0, 2, 1)
        w = lambda m: np.exp(-2j * np.pi * m / nfft)
        pairs = lambda z: np.ascontiguousarray(
            np.stack([z.real, z.imag], axis=-1).reshape(-1, 2).astype(np.float32))
        dev = torch.device(device)
        t = lambda z: torch.from_numpy(pairs(z)).to(dev)
        return Spectrum(h=torch.from_numpy(h).to(dev), h_k=t(h_k),
                        tw_lo=t(w(np.arange(1 << bits))),
                        tw_hi=t(w(np.arange(nfft >> bits) << bits)), tw_bits=bits,
                        log2c=cs.bit_length() - 1)

    @property
    def nfft(self) -> int:
        return self.h.shape[0]


def _spectrum(h, device) -> Spectrum:
    return h if isinstance(h, Spectrum) else Spectrum.build(h, device)


@dataclasses.dataclass(frozen=True)
class Windows:
    """An overlap-save schedule over ext = tail(b) ++ x: window w reads
    ext[starts[w] : starts[w] + 2b] and emits its samples j >= heads[w]
    as outputs starts[w] + j - b, which must tile [0, n) in order.  The
    kernel reads the two tables from the device."""
    starts: tuple
    heads: tuple
    starts_t: torch.Tensor       # (n_win,) int32
    heads_t: torch.Tensor

    @staticmethod
    def build(starts, heads, device) -> "Windows":
        starts, heads = tuple(map(int, starts)), tuple(map(int, heads))
        t = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
        return Windows(starts, heads, t(starts), t(heads))

    @staticmethod
    def uniform(total: int, block: int, advance, device) -> "Windows":
        """The reference's schedule: windows advancing by b (default) or
        3b/2 over total - b outputs, window w emitting [w*adv, (w+1)*adv)."""
        adv = block if advance is None else int(advance)
        if adv not in (block, 3 * block // 2) or adv <= 0:
            raise ValueError(f"advance must be b or 3b/2 (b = {block}), got {adv}")
        n_full = total - block
        if n_full <= 0 or n_full % adv:
            raise ValueError(f"{n_full} outputs are not a positive multiple of "
                             f"the advance {adv}")
        nw = n_full // adv
        return Windows.build([w * adv + adv - block for w in range(nw)],
                             [2 * block - adv] * nw, device)


def osfft_apply_ref(xr, xi, h, block: int, advance=None, windows=None, tail=None):
    """Plain twin of osfft_apply: build ext, gather the windows,
    torch.fft, pick each window's emitted outputs."""
    spec = _spectrum(h, xr.device)
    nfft = spec.nfft
    if tail is not None:
        xr, xi = torch.cat([tail[0], xr], dim=-1), torch.cat([tail[1], xi], dim=-1)
    if windows is None:
        windows = Windows.uniform(xr.shape[-1], block, advance, xr.device)
    ext = torch.complex(xr, xi)
    idx = (torch.tensor(windows.starts, device=ext.device)[:, None]
           + torch.arange(nfft, device=ext.device)[None, :])
    y = tfft.ifft(tfft.fft(ext[:, idx]) * spec.h)           # (C, n_win, nfft)
    out = torch.cat([y[:, w, hd:] for w, hd in enumerate(windows.heads)], dim=-1)
    return out.real.contiguous(), out.imag.contiguous()


def osfft_apply(xr, xi, h, block: int, advance=None, windows=None, tail=None):
    """K5: overlap-save over ext = tail ++ x, (C, total) planes.

    ``tail`` is the carried (tail_r, tail_i) (C, b) pair, or None when
    (xr, xi) already are ext; the kernel reads both where they lie (no
    concatenated copy).  h: the filter's (2b,) frequency response (numpy)
    or a prepared Spectrum.  With ``advance`` (b, the default, or 3b/2)
    the windows advance uniformly over total - b outputs, as the
    reference's osfft_apply; ``windows`` (a Windows schedule) instead
    gives each window's start and first emitted sample: ops/filters.py
    passes the whole step's mixed schedule, the re-anchored ragged last
    window included, so one launch covers a block (``launches`` counts
    one per step).  Returns (yr, yi) (C, n_out) float32."""
    if xr.device.type == "cpu":
        return osfft_apply_ref(xr, xi, h, block, advance, windows, tail)
    from iq_tool_tpu_torch.ops import _build
    spec = _spectrum(h, xr.device)
    nfft = spec.nfft
    if nfft != 2 * block:
        raise ValueError(f"H has {nfft} points, expected 2b = {2 * block}")
    if not OSFFT_MIN_NFFT <= nfft <= OSFFT_MAX_NFFT:
        raise NotImplementedError(
            f"overlap-save kernel at nfft {nfft}: it takes {OSFFT_MIN_NFFT} to "
            f"{OSFFT_MAX_NFFT} points; StreamingFilter runs larger windows through "
            f"ops/filters.py's torch.fft route (overlap_save_fft)")
    lib = _build.library()
    tail_r, tail_i = (None, None) if tail is None else tail
    _require_cuda(xr, xi, tail_r, tail_i, spec.h_k)
    _require_dtypes(None, 0, None, xr, xi, tail_r, tail_i)
    ch, n_x = xr.shape
    tail_len = 0 if tail is None else tail_r.shape[-1]
    if xi.shape != (ch, n_x) or (tail is not None and (
            tail_r.shape != (ch, tail_len) or tail_i.shape != (ch, tail_len))):
        raise ValueError(f"planes must be ({ch}, n) pairs")
    total = tail_len + n_x
    if windows is None:
        windows = Windows.uniform(total, block, advance, xr.device)
    _require_cuda(windows.starts_t, windows.heads_t)
    pos = 0
    for st, hd in zip(windows.starts, windows.heads):
        if (st < 0 or st + nfft > total or not 0 <= hd < nfft
                or st + hd - block != pos):
            raise ValueError("overlap-save windows must tile the output in order")
        pos += nfft - hd
    dev = xr.device
    out_r = torch.empty((ch, pos), dtype=torch.float32, device=dev)
    out_i = torch.empty_like(out_r)
    with torch.cuda.device(dev):
        rc = lib.iq_osfft_apply(
            _ptr(tail_r), _ptr(tail_i), tail_len, _ptr(xr), _ptr(xi), n_x, ch,
            _ptr(windows.starts_t), _ptr(windows.heads_t), len(windows.starts),
            _ptr(spec.h_k), _ptr(spec.tw_lo), _ptr(spec.tw_hi), spec.tw_bits,
            nfft.bit_length() - 1, spec.log2c, block, _ptr(out_r), _ptr(out_i), pos,
            _stream())
    _check(rc, "overlap-save kernel")
    _launched("osfft_kernel", osfft_apply)
    return out_r, out_i


osfft_apply.launches = 0


# ------------------------------ the I/Q estimator -----------------------------

def iq_descent_ref(base, image, factors, passes: int = 25):
    """The estimator's descent and power gate in tensor ops: base/image
    (C, nfft) complex64 shifted spectra of the windowed block and of its
    real part, factors (C, 2) -> (factors after ``passes`` passes,
    unsmoothed, and the (C,) gate in dB at the starting factors)."""
    gate_db = iq_balance._power_gate(
        iq_balance._spectrum_db(base, image, factors[:, 0], factors[:, 1]))
    return iq_balance._optimize_core(base, image, factors, passes), gate_db


_EST_TICKETS: dict = {}   # (device index, stream) -> the estimator's ticket


@functools.lru_cache(maxsize=8)
def _est_consts(device: str):
    """(window, twiddles) of the estimator kernel on `device`: the float32
    Hamming window and exp(-2 pi i k / 1024) from float64, made once."""
    _, _, t_r, t_i = iq_balance._fft_consts(device)
    return (iq_balance._window(C.IQ_FFT_SIZE, device),
            torch.stack([t_r, t_i], dim=-1).contiguous())


def _est_ticket(dev: torch.device) -> torch.Tensor:
    """The estimator's ticket of this device and stream: zeroed once when
    it is allocated; each launch's last CTA re-arms it, so a graph's
    replays find it armed too."""
    return _per_stream(_EST_TICKETS, dev, 1,
                       lambda: torch.zeros(1, dtype=torch.int64, device=dev),
                       "I/Q estimator's ticket")


def iq_estimate_ref(xr, xi, factors, counter, interval: int = 0, advance: int = 0,
                    dc_state=None, dc_alpha: float = 0.0, wire_i32=None,
                    wire_norm: float = 0.0, wire_gain: float = 1.0,
                    wire_kind: str = "cs16", passes: int = 25):
    """Plain twin of iq_estimate: the decode of the prefix, the float64 DC
    prefix (``dc_block.apply_prefix``), then ``iq_balance.maybe_update``
    with the descent in tensor ops, run whether or not an update is due
    and masked.  The gate is NaN where no update was due, as the kernel
    leaves it."""
    src = wire_i32 if wire_i32 is not None else xr
    m = min(src.shape[-1], C.IQ_FFT_SIZE)
    if wire_i32 is not None:
        xr, xi = convert.decode_packed(wire_i32[:, :m], wire_kind, wire_norm, wire_gain)
    if dc_state is not None:
        xr, xi = dc_block.apply_prefix(xr, xi, dc_state, dc_alpha, m)
    seg = torch.complex(xr[:, :m], xi[:, :m])
    if counter is None:
        seg = torch.nn.functional.pad(seg, (0, C.IQ_FFT_SIZE - m))
        new, gate_db = iq_descent_ref(*iq_balance._spectra(seg), factors, passes)
        return new, None, gate_db
    state, gate_db = iq_balance._update(seg, iq_balance.IqState(factors, counter),
                                        interval, passes, advance)
    due = counter >= int(interval)
    return (state.factors, state.samples_since_opt,
            torch.where(due, gate_db, torch.full_like(gate_db, float("nan"))))


def iq_estimate(xr, xi, factors, counter, interval: int = 0, advance: int = 0,
                dc_state=None, dc_alpha: float = 0.0, wire_i32=None,
                wire_norm: float = 0.0, wire_gain: float = 1.0,
                wire_kind: str = "cs16", passes: int = 25):
    """The I/Q estimator of one step (helper kernel in csrc/iq_est.cu; the
    reference runs it in XLA under lax.cond).

    Its input is the first m = min(n, 1024) frames of ``wire_i32`` (C, n)
    (convert.wire_pack, decoded with wire_norm/wire_gain) or of the planes
    xr/xi (C, n) float32 (any strides, the same for both), DC-blocked from
    the (C, 4) ``dc_state`` when one is given, zero-padded to 1024.
    factors (C, 2) float32; counter () int64 holding the uint32 samples
    since the last update.  Returns (factors, counter, gate_db): where the
    counter reaches ``interval`` the power gate (C,) in dB and, where it
    passes, the factors smoothed toward the descent's; the counter reset
    when any channel ran, else advanced by ``advance`` (saturating).
    ``counter=None`` is the calibration: always due, the descent's factors
    unsmoothed, no counter out.  On a step that is not due the kernel
    does no estimator work; the gate is then NaN."""
    src = wire_i32 if wire_i32 is not None else xr
    if src.device.type == "cpu":
        return iq_estimate_ref(xr, xi, factors, counter, interval, advance, dc_state,
                               dc_alpha, wire_i32, wire_norm, wire_gain, wire_kind,
                               passes)
    from iq_tool_tpu_torch.ops import _build
    lib = _build.library()
    dev = src.device
    if wire_i32 is not None:
        if not wire_norm:
            raise ValueError("wire_i32 requires wire_norm (the format normalizer)")
        kind = _WIRE_KINDS[wire_kind]
        _require_dtypes(wire_i32, kind, None)
        if wire_i32.stride(-1) != 1:
            raise ValueError("the packed wire's rows must be contiguous")
        xr = xi = None
        ld, inc = wire_i32.stride(0), 1
    else:
        kind = _PLANAR
        _require_dtypes(None, kind, None, xr, xi)
        if xr.shape != xi.shape or xr.stride() != xi.stride():
            raise ValueError("xr and xi must have one shape and one layout")
        ld, inc = xr.stride()
    _require_cuda(factors, counter, dc_state)
    _require_dtypes(None, kind, None, factors, dc_state)
    for t in (xr, xi):
        if t is not None and t.device != dev:
            raise ValueError(f"kernel input on {t.device}, expected {dev}")
    ch, n = src.shape
    if factors.shape != (ch, 2) or factors.device != dev:
        raise ValueError(f"factors must be ({ch}, 2) on {dev}")
    if dc_state is not None and (dc_state.shape != (ch, 4) or dc_state.device != dev):
        raise ValueError(f"dc_state must be ({ch}, 4) on {dev}")
    if counter is not None and (counter.dtype != torch.int64 or counter.shape != ()
                                or counter.device != dev):
        raise ValueError(f"counter must be a () int64 tensor on {dev}")
    lo, hi = iq_balance.band_edges(C.IQ_FFT_SIZE)
    sm = convert._f32(C.IQ_SMOOTHING)
    out = torch.empty_like(factors)
    gate_db = torch.empty((ch,), dtype=torch.float32, device=dev)
    new_counter = None if counter is None else torch.empty_like(counter)
    with torch.cuda.device(dev):
        window, twiddle = _est_consts(str(dev))
        ticket = None if counter is None else _est_ticket(dev)
        rc = lib.iq_estimate(
            _ptr(wire_i32), kind, convert._f32(wire_norm), convert._f32(wire_gain),
            _ptr(xr), _ptr(xi), ld, inc, min(n, C.IQ_FFT_SIZE), _ptr(dc_state),
            float(1.0 - dc_alpha), _ptr(window), _ptr(twiddle), _ptr(factors),
            _ptr(counter), int(interval), int(advance), int(passes),
            convert._f32(C.IQ_EST_STEP), float(C.IQ_SPECTRUM_FLOOR_DB),
            float(C.IQ_POWER_GATE_DB), convert._f32(1.0 - sm), sm,
            int(counter is not None), lo, hi, ch, _ptr(out), _ptr(gate_db),
            _ptr(new_counter), _ptr(ticket), _stream())
    _check(rc, "I/Q estimator kernel")
    _launched("iq_estimate_kernel", iq_estimate)
    return out, new_counter, gate_db


iq_estimate.launches = 0


# ------------------------------ the gather stage ------------------------------

GATHER_THREADS = 256          # csrc/gather.cu kGatherThreads
GATHER_SMEM = 115712          # a CTA's shared memory at most: two CTAs an SM
_GATHER_MAX_GROUPS = 16


def _group_offsets(starts: np.ndarray, k: int) -> tuple[np.ndarray, int]:
    """(d, span) of the outputs' groups of 4: d[g, i] = starts[4g + i] -
    starts[4g] (0 past the last output), and the window every group's four
    windows fit, span = max d + k rounded up to a multiple of 4."""
    s = np.asarray(starts, np.int64)
    gr = -(-s.shape[0] // 4)
    pad = np.concatenate([s, np.repeat(s[-1:], 4 * gr - s.shape[0])]).reshape(gr, 4)
    d = pad - pad[:, :1]
    d[(4 * np.arange(gr)[:, None] + np.arange(4)) >= s.shape[0]] = 0
    return d, _ceil4(int(d.max()) + k)


def gather_windows(weights: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """The weights as csrc/gather.cu reads them: (ceil(M / 4), span, 4)
    float32, out[g, t, i] = weights[4g + i, t - d[g, i]] where that tap
    exists, else 0 (``_group_offsets``): each group's four windows on one
    zero-padded window, so that a frame's four weights are 16 bytes."""
    m, k = weights.shape
    d, span = _group_offsets(starts, k)
    gr = d.shape[0]
    out = np.zeros((gr, span, 4), np.float32)
    j = 4 * np.arange(gr)[:, None] + np.arange(4)                     # (gr, 4)
    live = j < m
    g, i = np.nonzero(live)
    out[g[:, None], d[g, i][:, None] + np.arange(k)[None, :], i[:, None]] = weights[j[g, i]]
    return out


@dataclasses.dataclass(frozen=True)
class Gather:
    """The gather stage's plan (ops/resample.py ``ArbPlan``) on a device:
    the (M,) int32 window starts (output j reads ext[starts[j] : starts[j]
    + K], ext = history ++ block); for the kernel (on CUDA) the weights as
    ``gather_windows`` lays them out, for the twin (on the CPU unless
    ``twin`` says otherwise) the (M, K) weights, the flat (M K,) window
    rows and the bag starts ``embedding_bag`` takes.  ``tiles`` keeps each
    launch shape's ``gather_tiles``."""
    starts: torch.Tensor
    n_in: int
    hist: int
    k: int
    starts_host: np.ndarray
    windows: torch.Tensor | None = None
    weights: torch.Tensor | None = None
    cols: torch.Tensor | None = None
    bags: torch.Tensor | None = None
    tiles: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @staticmethod
    def build(weights: np.ndarray, starts: np.ndarray, n_in: int, hist: int, device,
              twin: bool | None = None) -> "Gather":
        dev = torch.device(device)
        m, k = weights.shape
        t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        fields = {}
        if dev.type == "cuda":
            fields["windows"] = t(gather_windows(weights, starts))
        if dev.type == "cpu" if twin is None else twin:
            rows = starts.astype(np.int64)[:, None] + np.arange(k)[None, :]
            fields.update(weights=t(weights.astype(np.float32)), cols=t(rows.reshape(-1)),
                          bags=torch.arange(0, m * k, k, device=dev))
        return Gather(starts=t(starts.astype(np.int32)), n_in=n_in, hist=hist, k=k,
                      starts_host=starts.astype(np.int64), **fields)


@dataclasses.dataclass(frozen=True)
class GatherTiles:
    """A gather launch's tiling (``gather_tiles``): a CTA owns ``groups``
    groups of 4 consecutive outputs and ``cols`` // 2 channels (both
    planes); their ``span``-frame windows are staged ``pass_len`` frames
    at a time; ``slices`` threads of each (group, 4-column chunk) take
    ``slice_len`` frames of a pass each."""
    cols: int
    groups: int
    slices: int
    slice_len: int
    span: int
    pass_len: int
    wstride: int      # float4s between two groups' staged weights
    tile_rows: int    # input frames a pass stages, at most
    smem: int         # bytes of shared memory
    threads: int
    grid: tuple[int, int]


def _ceil4(x: int) -> int:
    return -(-x // 4) * 4


def gather_tiles(starts: np.ndarray, k: int, n_in: int, channels: int,
                 rows: int) -> GatherTiles:
    """The tile csrc/gather.cu runs a block of ``rows`` row blocks of
    ``channels`` channels with, from what the plan shows: K, the
    distance between the outputs' windows (q/p), the channels and the
    rows.  Of the channel groups (16, 8, ..., 1, at most the channels
    rounded up to a power of two) and group counts (1-16) whose staged
    input and weights fit GATHER_SMEM (a window too long for it staged in
    passes), it takes the one that stages the fewest bytes an output
    column (the staged input, halo included, and the weights, over the
    outputs times columns they serve), then as many threads as runs of
    at least 16 frames give, up to GATHER_THREADS."""
    s = np.asarray(starts, np.int64)
    gr = -(-s.shape[0] // 4)
    first = s[0::4]
    span = _group_offsets(s, k)[1]
    total = gr * rows
    reps = min(rows, -(-_GATHER_MAX_GROUPS // gr) + 1)
    orig = (first[None, :] + n_in * np.arange(reps)[:, None]).ravel()

    def spread(g):
        """The widest distance between the window starts of a tile's
        first and last group."""
        if g >= orig.size:
            return int(orig[-1] - orig[0])
        return int((orig[g - 1:] - orig[:orig.size - g + 1]).max())

    def need(cols, g, sp, p):
        wstride = p + (2 - p % 8) % 8          # groups 8 banks apart
        return _ceil4((sp + p) * cols) * 4 + g * wstride * 16, wstride

    best = None
    cg = min(16, 1 << max(0, channels - 1).bit_length())
    while cg >= 1:
        cols = 2 * cg
        for g in range(min(_GATHER_MAX_GROUPS, total), 0, -1):
            sp = spread(g)
            p = span
            if need(cols, g, sp, p)[0] > GATHER_SMEM:
                p = (GATHER_SMEM - sp * cols * 4 - g * 16 * 8 - 16) // (cols * 4 + g * 16)
                p = min(span, p - p % 4)
                while p >= 16 and need(cols, g, sp, p)[0] > GATHER_SMEM:
                    p -= 4
                if p < 16:
                    continue
            passes = -(-span // p)
            staged = passes * (sp + p) * cols * 4 + g * span * 16
            key = (staged / (4 * g * cols), -g * cols)
            if best is None or key < best[0]:
                best = (key, cols, g, sp, p)
        cg //= 2
    if best is None:
        raise ValueError(f"gather stage: no tile fits {GATHER_SMEM} bytes (K {k})")
    _, cols, g, sp, p = best
    kb = 4 if cols >= 4 else 2
    per = g * cols // kb
    slices = max(1, min(GATHER_THREADS // per, p // 16))
    slice_len = _ceil4(-(-p // slices))
    slices = -(-p // slice_len)
    smem, wstride = need(cols, g, sp, p)
    smem = max(smem, (slices - 1) * 4 * kb * per * 4)
    return GatherTiles(cols=cols, groups=g, slices=slices, slice_len=slice_len, span=span,
                       pass_len=p, wstride=wstride, tile_rows=sp + p, smem=smem,
                       threads=per * slices,
                       grid=(-(-total // g), -(-channels // (cols // 2))))


def gather_apply_ref(xr, xi, state_r, state_i, g: Gather):
    """Plain twin of gather_apply: ext = history ++ block as the columns
    of an (L, 2C) tensor, each output row one weighted bag sum over K
    rows of it (``embedding_bag``): no window tensor is built, the sums
    run in a fixed order, and on the CPU they are the JAX package's
    gather and einsum bit for bit.  A block of r row blocks takes the
    plan's rows r times, each n_in further on, in one call."""
    if g.cols is None:
        raise ValueError("this Gather was built without the twin's window rows")
    k = g.k
    ext = torch.cat([torch.cat([state_r, xr], -1),
                     torch.cat([state_i, xi], -1)]).T.contiguous()   # (L, 2C)
    cols, bags, w = g.cols, g.bags, g.weights.reshape(-1)
    r = xr.shape[-1] // g.n_in
    if r > 1:
        cols = (cols[None, :] + g.n_in * torch.arange(r, device=cols.device)[:, None]
                ).reshape(-1)
        bags = torch.arange(0, cols.numel(), k, device=cols.device)
        w = w.repeat(r)
    y = torch.nn.functional.embedding_bag(cols, ext, bags, mode="sum",
                                          per_sample_weights=w).T     # (2C, M')
    ch = xr.shape[0]
    return y[:ch].contiguous(), y[ch:].contiguous()


def gather_apply(xr, xi, state_r, state_i, g: Gather):
    """The gather stage (``csrc/gather.cu``): (yr, yi), each (C, r M),
    output j of row block b the dot of the plan's K weights w[j] with
    ext[starts[j] + b n_in : ... + K], ext = history ++ block.

    x*: (C, r n_in) float32 planes; state_*: (C, hist) float32, the
    history.  One launch, the tile from ``gather_tiles``; the outputs
    are allocated here."""
    ch, n = xr.shape
    if n % g.n_in:
        raise ValueError(f"block of {n} samples is not a multiple of {g.n_in}")
    if xr.device.type == "cpu":
        return gather_apply_ref(xr, xi, state_r, state_i, g)
    from iq_tool_tpu_torch.ops import _build
    lib = _build.library()
    if g.windows is None:
        raise ValueError("this Gather was built without the kernel's windows")
    _require_cuda(xr, xi, state_r, state_i, g.windows, g.starts)
    _require_dtypes(None, _PLANAR, None, xr, xi, state_r, state_i, g.windows)
    if g.starts.dtype != torch.int32:
        raise ValueError(f"window starts must be int32, got {g.starts.dtype}")
    dev = xr.device
    if any(t.device != dev for t in (xi, state_r, state_i, g.windows, g.starts)):
        raise ValueError(f"kernel inputs must all lie on {dev}")
    if xi.shape != (ch, n):
        raise ValueError(f"xi must be ({ch}, {n})")
    if state_r.shape != (ch, g.hist) or state_i.shape != (ch, g.hist):
        raise ValueError(f"history planes must be ({ch}, {g.hist})")
    m = g.starts.shape[0]
    rows = n // g.n_in
    t = g.tiles.get((ch, rows))
    if t is None:
        t = g.tiles[(ch, rows)] = gather_tiles(g.starts_host, g.k, g.n_in, ch, rows)
    yr = torch.empty((ch, rows * m), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    with torch.cuda.device(dev):
        rc = lib.iq_gather_apply(
            _ptr(xr), _ptr(xi), _ptr(state_r), _ptr(state_i), _ptr(g.windows),
            _ptr(g.starts), ch, n, g.hist, m, g.n_in, rows, t.cols, t.groups, t.slices,
            t.slice_len, t.span, t.pass_len, t.wstride, t.tile_rows, t.smem, _ptr(yr),
            _ptr(yi), _stream())
    _check(rc, "gather kernel")
    _launched("gather_kernel", gather_apply)
    return yr, yi


gather_apply.launches = 0


_COUNTED = [banded_apply, banded_apply_mma, banded_apply_dc, dc_carry, dc_prologue, dc_block_apply,
            pre_apply, post_apply, rms_gains, segment_energies, agc_chain, osfft_apply,
            iq_estimate, gather_apply]


def counted(fn):
    """Give ``fn``, a route of the step outside this module, a
    ``launches`` counter that launch_counts and reset_launch_counts
    include (a decorator)."""
    fn.launches = 0
    _COUNTED.append(fn)
    return fn


def launch_counts() -> dict:
    """{wrapper name: launches} of every kernel wrapper."""
    return {fn.__name__: fn.launches for fn in _COUNTED}


def reset_launch_counts() -> None:
    for fn in _COUNTED:
        fn.launches = 0
