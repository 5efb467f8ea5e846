"""The port's kernel twins (ops/kernels.py) against the JAX package's
Pallas kernels, run in interpret mode on the CPU as the JAX tests run
them, at the flagship stage geometries and BASELINE config #4's.  The
kernels themselves are held against the twins on the card in
tests/test_torch_gpu.py.

Bounds: the Pallas kernels multiply in 3-term split bf16 (~88 dB), the
twins in float32, so planar outputs, tails and DC state are held to
>= 80 dB and packed cs16 codes to |delta| <= 2.  The twins' own packed
epilogue is checked bit for bit against their planar output.  K3 (DC,
I/Q, NCO) is held to 80 dB as K1 is; K4 (NCO, gain, pack: no product
sums) to one code on 0.1 % of samples; K5 (the Pallas four-step DFT in
3-term bf16 against torch.fft) to 80 dB; the AGC scan (the same float32
loop in XLA and in torch) to 1e-5 relative.  A float64 emulation of the
DC kernel's tile decomposition is held to a direct recurrence.
"""

import numpy as np
import pytest
import scipy.signal

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from iq_tool_tpu.formats import get_format  # noqa: E402
from iq_tool_tpu.ops import agc as jagc  # noqa: E402
from iq_tool_tpu.ops import pallas_kernels  # noqa: E402
from iq_tool_tpu_torch.ops import agc, convert, kernels  # noqa: E402
from iq_tool_tpu_torch.ops.filters import StreamingFilter  # noqa: E402
from iq_tool_tpu_torch.ops.fir_design import FilterRequest  # noqa: E402
from iq_tool_tpu_torch.pipeline.chain import Chain, ChainConfig  # noqa: E402
from tests import ref_dsp  # noqa: E402

CH = 8
DC_ALPHA = 3.0679615757712826e-05        # 10 Hz pole at 2.048 Msps
DTHETA = 209715200                       # +100 kHz at 2.048 Msps


def _flagship_stages(block=131072):
    cfg = ChainConfig(input_format="cs16", output_format="cs16",
                      input_rate=2_048_000.0, target_rate=1_488_375.0,
                      dc_block=True, freq_shift_pre_hz=100e3,
                      filters=(FilterRequest("lowpass", 400e3),),
                      target_block=block)
    return Chain(cfg, device="cpu").resampler.stages


def _cs16_wire(rng, n, ch=CH):
    t = np.arange(n) / 2.048e6
    x = (0.4 * np.exp(2j * np.pi * 51e3 * t)[None, :]
         + 0.05 * (rng.standard_normal((ch, n)) + 1j * rng.standard_normal((ch, n)))
         + 0.08)
    pairs = np.stack([x.real, x.imag], -1).reshape(ch, 2 * n)
    return np.clip(np.round(pairs * 32767), -32768, 32767).astype(np.int16)


def _snr(want, got):
    return ref_dsp.snr_db(np.asarray(want, np.float64).ravel(),
                          np.asarray(got, np.float64).ravel())


def _codes(packed):
    """(I, Q) int codes of a packed cs16 tensor / array."""
    p = np.asarray(packed).astype(np.int64) & 0xFFFFFFFF
    lo, hi = p & 0xFFFF, p >> 16
    return lo - ((lo >> 15) << 16), hi - ((hi >> 15) << 16)


def _max_code_diff(a, b):
    (ai, aq), (bi, bq) = _codes(a), _codes(b)
    return max(np.abs(ai - bi).max(), np.abs(aq - bq).max())


def _t(a, dtype=None):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if dtype is None else a.astype(dtype))


@pytest.mark.parametrize("with_nco", [False, True])
def test_k1_twin_matches_pallas(rng, with_nco):
    st0 = _flagship_stages()[0]
    s, hist, g = st0.stride, st0.hist, st0._a.shape[1]
    assert (s, hist, g) == (512, 31, 441)
    nb = 16
    n = nb * s
    raw = _cs16_wire(rng, n)
    sr = (rng.standard_normal((CH, hist)) * 0.1).astype(np.float32)
    si = (rng.standard_normal((CH, hist)) * 0.1).astype(np.float32)
    dc = (rng.standard_normal((CH, 4)) * 0.05).astype(np.float32)
    pacc = rng.integers(0, 2 ** 32, (CH,), dtype=np.uint32)
    dth = DTHETA if with_nco else 0
    norm = get_format("cs16").normalizer
    wire = _t(raw).view(torch.int32)
    jwire = jnp.asarray(wire.numpy())
    launches = kernels.banded_apply_dc.launches
    for pack in (None, "cs16"):
        want = pallas_kernels.banded_apply_dc(
            jnp.asarray(sr), jnp.asarray(si), jnp.asarray(dc), DC_ALPHA,
            st0._a, None, s, hist, wire_i32=jwire, wire_norm=norm,
            nco_dtheta=dth, nco_phase=jnp.asarray(pacc)[:, None] if dth else None,
            pack_fmt=pack, interpret=True)
        got = kernels.banded_apply_dc(
            _t(sr), _t(si), _t(dc), DC_ALPHA, st0._a, None, s, hist,
            wire_i32=wire, wire_norm=norm, nco_dtheta=dth,
            nco_phase=_t(pacc, np.int64) if dth else None, pack_fmt=pack)
        assert kernels.banded_apply_dc.launches == launches   # CPU: the twin
        for w, gt in zip(want[1:], got[1:]):             # tails and DC state
            assert _snr(w, gt.numpy()) >= 80.0
        if pack:
            assert _max_code_diff(want[0], got[0].numpy()) <= 2
            planar = kernels.banded_apply_dc(
                _t(sr), _t(si), _t(dc), DC_ALPHA, st0._a, None, s, hist,
                wire_i32=wire, wire_norm=norm, nco_dtheta=dth,
                nco_phase=_t(pacc, np.int64) if dth else None)[0]
            np.testing.assert_array_equal(
                convert.packed_to_wire(got[0], "cs16").numpy(),
                convert.from_planar(*planar, "cs16").numpy())
        else:
            for w, gt in zip(want[0], got[0]):
                assert _snr(w, gt.numpy()) >= 80.0


def test_k2_twin_matches_pallas_shift_packed(rng):
    st1 = _flagship_stages()[1]
    s, hist, g = st1.stride, st1.hist, st1._a.shape[1]
    assert (s, hist, g) == (256, 287, 216)
    n = 24 * s
    xr = (rng.standard_normal((CH, n)) * 0.2).astype(np.float32)
    xi = (rng.standard_normal((CH, n)) * 0.2).astype(np.float32)
    sr = (rng.standard_normal((CH, hist)) * 0.2).astype(np.float32)
    si = (rng.standard_normal((CH, hist)) * 0.2).astype(np.float32)
    args = lambda f: (f(sr), f(si), f(xr), f(xi), st1._a, None, s, hist)
    want = pallas_kernels.banded_apply(*args(jnp.asarray), interpret=True,
                                       pack_fmt="cs16")
    launches = kernels.banded_apply.launches
    got = kernels.banded_apply(*args(_t), pack_fmt="cs16")
    assert kernels.banded_apply.launches == launches     # CPU runs the twin
    assert _max_code_diff(want, got.numpy()) <= 2
    planar = kernels.banded_apply(*args(_t))
    want_planar = pallas_kernels.banded_apply(*args(jnp.asarray), interpret=True)
    for w, gt in zip(want_planar, planar):
        assert _snr(w, gt.numpy()) >= 80.0
    np.testing.assert_array_equal(convert.packed_to_wire(got, "cs16").numpy(),
                                  convert.from_planar(*planar, "cs16").numpy())


def test_k2_twin_matches_pallas_assemble_wire_nco(rng):
    st0 = _flagship_stages()[0]
    s, hist = st0.stride, st0.hist
    n = 16 * s
    raw = _cs16_wire(rng, n)
    sr = (rng.standard_normal((CH, hist)) * 0.2).astype(np.float32)
    si = (rng.standard_normal((CH, hist)) * 0.2).astype(np.float32)
    pacc = rng.integers(0, 2 ** 32, (CH,), dtype=np.uint32)
    norm = get_format("cs16").normalizer
    wire = _t(raw).view(torch.int32)
    for pack in (None, "cs16"):
        want = pallas_kernels.banded_apply(
            jnp.asarray(sr), jnp.asarray(si), None, None, st0._a, None, s, hist,
            interpret=True, pack_fmt=pack, wire_i32=jnp.asarray(wire.numpy()),
            wire_norm=norm, nco_dtheta=DTHETA,
            nco_phase=jnp.asarray(pacc)[:, None])
        got = kernels.banded_apply(
            _t(sr), _t(si), None, None, st0._a, None, s, hist, pack_fmt=pack,
            wire_i32=wire, wire_norm=norm, nco_dtheta=DTHETA,
            nco_phase=_t(pacc, np.int64))
        if pack:
            assert _max_code_diff(want, got.numpy()) <= 2
        else:
            for w, gt in zip(want, got):
                assert _snr(w, gt.numpy()) >= 80.0


def _stage_matrix(which):
    """(A_r, A_i) of one stage geometry the tests and the chain run."""
    if which.startswith("flagship"):
        block, idx = {"flagship-16384-0": (16384, 0), "flagship-16384-1": (16384, 1),
                      "flagship-262144-0": (262144, 0),
                      "flagship-262144-1": (262144, 1)}[which]
        st = _flagship_stages(block)[idx]
        return st._a, st._a_i
    if which.startswith("nrsc5"):
        cfg = ChainConfig(input_format="cu8", output_format="cu8",
                          input_rate=2_400_000.0, target_rate=1_488_375.0,
                          dc_block=True, target_block=16384)
        st = Chain(cfg, device="cpu").resampler.stages[int(which[-1])]
        return st._a, st._a_i
    if which == "complex-taps":
        st = _flagship_stages(16384)[1]
        st.compose_output_fir(np.exp(2j * np.pi * 0.1 * np.arange(9)) / 9)
        return st._a, st._a_i
    taps = np.hanning(77)[1:-1].astype(np.complex64)         # a 75-tap FIR
    f = StreamingFilter(taps, "fir")
    band = f._band(256, "cpu")
    return band.a_r.numpy(), None


def _tile_blocks(band, taps):
    """Invert the wgmma core's operand layout: (T, span, 32) hi and lo
    of each tile's dense block B_t, step j's float ng * 64 + kh * 32 + nr
    * 4 + kq holding B_t[8 j + 2 kq + kh, 8 ng + nr]."""
    t = taps.numpy()
    w = kernels.TILE_COLS
    n_tiles, parts, steps, width = t.shape
    assert (parts, width, steps) == (2, 8 * w, band.span // 8)
    b = t.reshape(n_tiles, 2, steps, w // 8, 2, 8, 4).transpose(0, 1, 2, 6, 4, 3, 5)
    hi, lo = b.reshape(n_tiles, 2, band.span, w).transpose(1, 0, 2, 3)
    return hi, lo


def _frag_blocks(band, taps):
    """Invert the mma.sync core's B-fragment layout (16-column tiles, k
    paired): (T, frag_span, 16) dense blocks."""
    t = taps.numpy()
    n_tiles, n_chunks = t.shape[:2]
    assert t.shape[2:] == (32, 4) and n_chunks == band.frag_span // 8
    lane = np.arange(32)
    r, c = 2 * (lane % 4), lane // 4
    b = np.zeros((n_tiles, n_chunks, 8, kernels.FRAG_COLS), np.float32)
    b[:, :, r, c], b[:, :, r + 1, c] = t[..., 0], t[..., 1]
    b[:, :, r, c + 8], b[:, :, r + 1, c + 8] = t[..., 2], t[..., 3]
    return b.reshape(n_tiles, band.frag_span, kernels.FRAG_COLS)


def _dense_from_blocks(band, blocks, first, span, w):
    """The (L, G) matrix the tiles hold, checking that nothing lies past
    A's edges and that the tiles do not overlap."""
    dense = np.zeros((band.rows + span, len(first) * w), np.float32)
    for i, f in enumerate(first):
        assert f % 2 == 0
        assert not dense[f:f + span, w * i:w * (i + 1)].any()
        dense[f:f + span, w * i:w * (i + 1)] = blocks[i]
    assert not dense[band.rows:].any() and not dense[:, band.g:].any()
    return dense[:band.rows, :band.g]


def _dense_from_tiles(band, taps):
    """The (L, G) matrix the wgmma core's tiles hold (hi + lo, exact in
    float32)."""
    hi, lo = _tile_blocks(band, taps)
    return _dense_from_blocks(band, hi + lo, band.tile_first.numpy(), band.span,
                              kernels.TILE_COLS)


def _dense_from_frags(band, taps):
    """The (L, G) matrix the mma.sync core's tiles hold."""
    return _dense_from_blocks(band, _frag_blocks(band, taps), band.frag_first.numpy(),
                              band.frag_span, kernels.FRAG_COLS)


@pytest.mark.parametrize("which", ["flagship-16384-0", "flagship-16384-1",
                                   "flagship-262144-0", "flagship-262144-1",
                                   "nrsc5-0", "nrsc5-1", "complex-taps", "fir-toeplitz"])
def test_band_compression_is_the_same_map(which):
    """Both cores' column tiles rebuild the dense A exactly, at every
    stage geometry the tests run (the flagship stages at both block sizes,
    strides 512, 224 and 256; the NRSC5 strides 400 and 144; complex taps;
    a FIR filter's Toeplitz band): the wgmma core's 32 columns over the
    rows that hold their non-zeros, split into TF32 hi and lo parts in the
    order its shared-memory operand takes, and the mma.sync core's 16
    columns in B-fragment order."""
    a_r, a_i = _stage_matrix(which)
    band = kernels.Band.build(a_r, a_i, "cpu")
    cplx = a_i is not None and np.any(a_i)
    assert (band.taps_i is not None) == cplx and (band.frag_i is not None) == cplx
    w = kernels.TILE_COLS
    assert band.span % 8 == 0 and band.n_tiles == -(-band.g // w)
    np.testing.assert_array_equal(_dense_from_tiles(band, band.taps_r), a_r)
    if cplx:
        np.testing.assert_array_equal(_dense_from_tiles(band, band.taps_i), a_i)
    f = kernels.FRAG_COLS
    assert band.frag_span % 8 == 0 and band.frag_tiles == -(-band.g // f)
    np.testing.assert_array_equal(_dense_from_frags(band, band.frag_r), a_r)
    if cplx:
        np.testing.assert_array_equal(_dense_from_frags(band, band.frag_i), a_i)
    # the span is the band plus the tile's spread of band starts, a
    # fraction of the window
    assert band.k <= band.span < band.k + 8 + 2 * w * 4
    assert band.k <= band.frag_span < band.k + 8 + 2 * f * 4
    if not which.startswith("fir"):
        assert band.span < a_r.shape[0] and band.frag_span < a_r.shape[0] // 2


def _tf32(x: torch.Tensor, rounded: bool) -> torch.Tensor:
    """float32 to TF32's 10 mantissa bits by masking the low 13: rounded
    to nearest, ties away from zero (half a TF32 ulp added to the
    magnitude bits first, as csrc/banded.cu does for the high part), or
    truncated (as the tensor cores read the low part)."""
    b = x.contiguous().view(torch.int32)
    return ((b + (0x1000 if rounded else 0)) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x, True)
    return hi, _tf32(x - hi, False)


@pytest.mark.parametrize("which", ["flagship-262144-0", "flagship-262144-1",
                                   "complex-taps", "fir-toeplitz"])
def test_band_split_is_the_kernels_split(which):
    """The taps Band.build splits on the host are, bit for bit, what the
    kernel's split() makes of them (hi: the float's bits plus 0x1000 with
    the low 13 cleared, in int32 arithmetic; lo = x - hi in float32), also
    on values whose rounding carries into the exponent."""
    a_r, a_i = _stage_matrix(which)
    band = kernels.Band.build(a_r, a_i, "cpu")
    for taps in (band.taps_r, band.taps_i):
        if taps is None:
            continue
        hi, lo = _tile_blocks(band, taps)
        x = torch.from_numpy(np.ascontiguousarray(hi + lo))
        want_hi = ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
        want_lo = x - want_hi
        assert torch.equal(torch.from_numpy(np.ascontiguousarray(hi)).view(torch.int32),
                           want_hi.view(torch.int32))
        assert torch.equal(torch.from_numpy(np.ascontiguousarray(lo)).view(torch.int32),
                           want_lo.view(torch.int32))
    edge = np.array([1.0, 1.0 - 2.0 ** -24, 2.0 - 2.0 ** -12, -(2.0 - 2.0 ** -11),
                     3.0e-39, 0.0, -0.0], np.float32)
    hi, lo = kernels.tf32_split(edge)
    t = torch.from_numpy(edge)
    want_hi = ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    assert torch.equal(torch.from_numpy(hi).view(torch.int32), want_hi.view(torch.int32))
    assert torch.equal(torch.from_numpy(lo).view(torch.int32),
                       (t - want_hi).view(torch.int32))
    np.testing.assert_array_equal(hi + lo, edge)


def test_3xtf32_split_precision(rng):
    """The precision argument for K2's tensor-core products, before any
    chip run: the windows of the flagship's stage-1 input times its band
    matrix, the windows split in two TF32 parts as the kernel splits them
    and the taps as Band.build split them on the host, and the three
    leading products summed in float32 (x_lo a_hi + x_hi a_lo + x_hi
    a_hi, as csrc/banded.cu accumulates them) agree with the float64
    product to >= 110 dB; one TF32 product falls short of the kernels'
    100 dB gate."""
    st1 = _flagship_stages(262144)[1]
    s, hist = st1.stride, st1.hist
    assert (s, hist) == (256, 287)
    band = kernels.Band.build(st1._a, None, "cpu")
    a = torch.from_numpy(np.ascontiguousarray(st1._a, np.float32))
    # the host's parts, back in the dense (L, G) layout
    w = kernels.TILE_COLS
    ah, al = (torch.zeros((band.rows + band.span, band.n_tiles * w)) for _ in range(2))
    for part, dense in zip(_tile_blocks(band, band.taps_r), (ah, al)):
        for i, f in enumerate(band.tile_first.numpy()):
            dense[f:f + band.span, w * i:w * (i + 1)] = torch.from_numpy(part[i])
    ah, al = ah[:band.rows, :band.g], al[:band.rows, :band.g]
    assert torch.equal(ah + al, a)
    x = torch.from_numpy((rng.standard_normal((4, 64 * s + hist)) * 0.3).astype(np.float32))
    win = x.unfold(-1, s + hist, s)                              # (4, 64, 543)
    exact = torch.matmul(win.double(), a.double())
    xh, xl = _split(win)
    # the two parts hold x to 2^-21 relative (lo keeps 11 of x's 13
    # remaining bits)
    assert bool(((xh + xl - win).abs() <= win.abs() * 2.0 ** -21).all())
    # the tensor cores read the taps' lo part truncated to TF32
    got = torch.matmul(xl, ah) + torch.matmul(xh, _tf32(al, False)) + torch.matmul(xh, ah)
    one = torch.matmul(xh, ah)
    snr3 = _snr(exact.numpy(), got.numpy())
    snr1 = _snr(exact.numpy(), one.numpy())
    assert snr3 >= 110.0, snr3
    assert snr1 < 80.0, snr1


def _stage_geometry(which):
    """(A_r, A_i, stride, hist) of a stage geometry."""
    if which == "fir-2048":
        taps = (np.hanning(2050)[1:-1] / 1024).astype(np.complex64)
        band = StreamingFilter(taps, "fft")._band(256, "cpu")
        return band.a_r.numpy(), None, 256, 2047
    a_r, a_i = _stage_matrix(which)
    if which == "fir-toeplitz":
        stride = 256
    elif which.startswith("nrsc5"):
        cfg = ChainConfig(input_format="cu8", output_format="cu8", input_rate=2_400_000.0,
                          target_rate=1_488_375.0, dc_block=True, target_block=16384)
        stride = Chain(cfg, device="cpu").resampler.stages[int(which[-1])].stride
    elif which == "complex-taps":
        stride = _flagship_stages(16384)[1].stride
    else:
        stride = _flagship_stages(int(which.split("-")[1]))[int(which[-1])].stride
    return a_r, a_i, stride, a_r.shape[0] - stride


def _banded_core_emulated(band, ext_r, ext_i, s, hist, nb, grid, cs, ring, wgs):
    """csrc/banded.cu's product core in float64, by its own index
    arithmetic: CTA b takes items [I b / grid, I (b + 1) / grid) of the I
    = C x ceil(nb / 32) window groups; the consumers stage a group's 32 s
    + hist samples at (e // s) * pitch + e % s of two planes (whatever
    else the planes hold is finite garbage, 1e30 here, which only zero
    taps may meet); warpgroup w of ``wgs`` multiplies the tiles t = w mod
    wgs, its producer warp copying each chunk of `cs` steps of a tile's hi and lo
    taps into the next of its `ring` slots; lane (warp q, gid, tig) feeds
    rows 16 q + gid (window 8 q + gid, real plane) and 16 q + gid + 8
    (imaginary plane) at k = tig, tig + 4 from span rows 8 j + 2 tig and
    8 j + 2 tig + 1; the B operand is read through the descriptor's
    addressing (LBO 128 bytes between k halves, SBO 256 between column
    octets) from the slot; accumulator v of lane (q, gid, tig) is row 16 q
    + gid + 8 ((v >> 1) & 1), column 8 (v >> 2) + 2 tig + (v & 1).  hi +
    lo is summed exactly, so this holds the index map, not the rounding.
    Returns (yr, yi) (C, nb * G) float64."""
    ch = ext_r.shape[0]
    g_cols, n_tiles, steps = band.g, band.n_tiles, band.span // 8
    parts = [band.taps_r.numpy().astype(np.float64)]
    if band.taps_i is not None:
        parts.append(band.taps_i.numpy().astype(np.float64))
    first = band.tile_first.numpy()
    pitch = s + ((8 - s % 16) + 16) % 16
    assert pitch % 16 == 8
    buf_len = -(-(32 * s + hist + band.span) // s) * pitch
    groups = -(-nb // 32)
    items = ch * groups
    out = np.full((2, ch, nb * g_cols), np.nan)
    lane = np.arange(32)
    gid, tig = lane // 4, lane % 4
    wq = np.arange(4)[:, None]
    win = 8 * wq + gid[None, :]                                   # (4, 32)
    # B (8 k, 32 n) of one step: the float the descriptor's addressing
    # reads, and the span row of each physical k (the k pair permutation)
    cols = kernels.TILE_COLS
    kk, nn = np.arange(8)[:, None], np.arange(cols)[None, :]
    b_float = ((nn % 8) * 16 + (nn // 8) * 256 + (kk % 4) * 4 + (kk // 4) * 128) // 4
    step = 8 * cols
    slot_floats = len(parts) * 2 * cs * step
    rings = [np.full((ring, slot_floats), np.nan) for _ in range(wgs)]
    slots = [0] * wgs
    for cta in range(grid):
        planes = np.full((2, buf_len), 1e30)
        for item in range(items * cta // grid, items * (cta + 1) // grid):
            c, g = divmod(item, groups)
            b0, nw = 32 * g, min(32, nb - 32 * g)
            e = np.arange(nw * s + hist)
            off = (e // s) * pitch + e % s
            assert off.max() < buf_len
            planes[0, off] = ext_r[c, b0 * s + e]
            planes[1, off] = ext_i[c, b0 * s + e]
            for w in range(wgs):
                for t in range(w, n_tiles, wgs):
                    acc = np.zeros((len(parts), 64, cols))
                    for j in range(steps):
                        chunk, jc = divmod(j, cs)
                        if jc == 0:             # the producer's copy of this chunk
                            n = min(cs, steps - chunk * cs)
                            slot = rings[w][slots[w]]
                            for p, taps in enumerate(parts):
                                for h in (0, 1):
                                    at = (2 * p + h) * cs * step
                                    slot[at:at + n * step] = taps[
                                        t, h, chunk * cs:chunk * cs + n].ravel()
                            slots[w] = (slots[w] + 1) % ring
                        x = first[t] + 8 * j + 2 * tig                # (32,)
                        o = (x // s) * pitch + x % s + win * pitch     # (4, 32)
                        o_next = ((x + 1) // s) * pitch + (x + 1) % s + win * pitch
                        if s % 2 == 0:
                            assert (o_next == o + 1).all()
                        assert max(o.max(), o_next.max()) < buf_len
                        a = np.zeros((64, 8))
                        rows = 16 * wq + gid[None, :]                  # (4, 32)
                        for plane in (0, 1):
                            a[rows + 8 * plane, tig] = planes[plane, o]
                            a[rows + 8 * plane, tig + 4] = planes[plane, o_next]
                        for p in range(len(parts)):
                            at = 2 * p * cs * step + jc * step
                            b = (slot[at + b_float] + slot[at + cs * step + b_float])
                            acc[p] += a @ b
                    # the epilogue: a lane's accumulators v and v + 2 hold
                    # the real and imaginary rows of one (window, column)
                    rows = 16 * wq + gid[None, :]
                    keep_w = b0 + win < nb
                    for v in (v for v in range(cols // 2) if not v & 2):
                        lc = 8 * (v >> 2) + 2 * tig + (v & 1)            # (32,)
                        col = cols * t + lc
                        keep = keep_w & (col < g_cols)[None, :]
                        yr, yi = acc[0, rows, lc], acc[0, rows + 8, lc]
                        if len(parts) == 2:
                            yr = acc[0, rows, lc] - acc[1, rows + 8, lc]
                            yi = acc[1, rows, lc] + acc[0, rows + 8, lc]
                        idx = (b0 + win) * g_cols + col
                        assert np.isnan(out[0, c, idx[keep]]).all()
                        out[0, c, idx[keep]] = yr[keep]
                        out[1, c, idx[keep]] = yi[keep]
    assert not np.isnan(out).any()
    return out[0], out[1]


@pytest.mark.parametrize("which,grid,cs,ring,wgs", [
    ("flagship-262144-0", 3, 4, 3, 2), ("flagship-262144-1", 3, 4, 4, 2),
    ("flagship-262144-0", 2, 1, 3, 4), ("flagship-262144-1", 4, 4, 2, 2),
    ("nrsc5-0", 2, 2, 2, 2), ("nrsc5-1", 5, 1, 3, 4),
    ("complex-taps", 3, 2, 4, 2), ("complex-taps", 5, 1, 2, 2),
    ("fir-toeplitz", 4, 4, 4, 4), ("fir-2048", 2, 4, 4, 4)])
def test_banded_core_index_map(rng, which, grid, cs, ring, wgs):
    """An emulation of the wgmma product core's index map (the grid's
    items, the two or four warpgroups' tiles, the staged rows, each lane's A
    offsets, the producers' ring copies and each step's descriptor
    offset, the accumulators' rows and columns) in float64 equals the
    plain banded map (banded.apply_planar) within 1e-12 of its scale, at
    the flagship's stages 0 and 1 (strides 512 and 256), nrsc5's (400 and
    144), complex taps (four products), a 75-tap FIR's Toeplitz band and
    a 2048-tap one, on a ragged block (the last window group short) and
    grids that cut the items unevenly."""
    from iq_tool_tpu_torch.ops import banded
    a_r, a_i, s, hist = _stage_geometry(which)
    assert a_r.shape[0] == s + hist
    band = kernels.Band.build(a_r, a_i, "cpu")
    ch, nb = 3, 45
    n = nb * s + (s // 3)
    xr, xi, sr, si = (rng.standard_normal(shape) * 0.3
                      for shape in ((ch, n), (ch, n), (ch, hist), (ch, hist)))
    ext_r, ext_i = np.concatenate([sr, xr], -1), np.concatenate([si, xi], -1)
    got = _banded_core_emulated(band, ext_r, ext_i, s, hist, nb, grid, cs, ring, wgs)
    t = lambda v: torch.from_numpy(v)
    want = banded.apply_planar(t(sr), t(si), t(xr), t(xi), band.a_r.double(),
                               None if band.a_i is None else band.a_i.double(), s, hist)
    for w, g in zip(want, got):
        w = w.numpy()
        assert np.abs(w - g).max() <= 1e-12 * np.abs(w).max()


def _mma_wire_staged(mem, base, kind, st_r, st_i, n, s, hist, threads):
    """csrc/banded_mma.cu's staging of a packed wire, by its own index
    arithmetic (raw_group, stage_raw, decode): for each (channel, window
    group), the raw buffer's bytes as its copies land them (the NCO
    phase, the history planes, the wire's 16-byte body from both sides'
    aligned bytes, head and tail elements one a thread), each byte written
    once, then the decode pass's threads stepping (row, column) and
    decoding each element from the raw bytes.  ``mem`` is the device's
    memory as bytes, the wire's (C, n) elements from byte ``base``.
    Yields (c, b0, nw, staged planes)."""
    win = 16
    elem = 4 if kind in ("cs16", "cu16") else 2
    dt = np.int32 if elem == 4 else np.int16
    pitch = s + ((8 - s % 16) + 16) % 16
    raw_bytes = (16 + 8 * hist + 15 + 15 + elem * win * s + 15) // 16 * 16
    nb = n // s
    for c in range(st_r.shape[0]):
        for b0 in range(0, nb, win):
            nw = min(win, nb - b0)
            length, e0 = nw * s + hist, b0 * s
            e_w = max(0, min(length, hist - e0))
            i0, cnt = e0 + e_w - hist, length - e_w
            src = base + (c * n + i0) * elem
            mis = src % 16
            wire_at = 16 + (8 * e_w + 15) // 16 * 16 + mis
            raw = np.zeros(raw_bytes, np.uint8)
            hits = np.zeros(raw_bytes, np.int64)

            def put(at, data):
                assert 0 <= at and at + data.size <= raw_bytes
                raw[at:at + data.size] = data
                hits[at:at + data.size] += 1

            put(0, np.arange(8, dtype=np.uint8))       # the NCO phase
            hist_planes = np.concatenate([st_r[c, e0:e0 + e_w], st_i[c, e0:e0 + e_w]])
            put(16, hist_planes.astype(np.float32).view(np.uint8))
            head = min(cnt, ((16 - mis) % 16) // elem)
            chunks = (cnt - head) * elem // 16
            tail = head + chunks * (16 // elem)
            body = head * elem
            assert (wire_at + body) % 16 == 0 and (src + body) % 16 == 0
            put(wire_at + body, mem[src + body:src + body + 16 * chunks])
            for tid in range(threads):
                j = tid if tid < head else tail + tid - head
                if j < cnt:
                    put(wire_at + j * elem, mem[src + j * elem:src + (j + 1) * elem])
            assert hits.max() == 1
            assert (hits[wire_at:wire_at + cnt * elem] == 1).all()
            wire = raw[wire_at:wire_at + cnt * elem].view(dt)
            seg = np.full((2, -(-(win * s + hist + 8) // s) * pitch), np.nan, np.float32)
            hr = raw[16:16 + 8 * e_w].view(np.float32)
            xr, xi = (v.numpy() for v in convert.decode_packed(torch.from_numpy(wire.copy()),
                                                               kind, 1 / 128, 0.7))
            tid = np.arange(threads)
            q, u = tid // s, tid % s
            dq, du = threads // s, threads % s
            for e in range(0, length, threads):
                e_t = e + tid
                live = e_t < length
                assert (q[live] == e_t[live] // s).all() and (u[live] == e_t[live] % s).all()
                for et, o in zip(e_t[live], (q * pitch + u)[live]):
                    if et < e_w:
                        seg[:, o] = hr[et], hr[e_w + et]
                    else:
                        assert 0 <= i0 + et - e_w == e0 + et - hist < n
                        seg[:, o] = xr[et - e_w], xi[et - e_w]
                u = u + du
                q = q + dq + (u >= s)
                u = np.where(u >= s, u - s, u)
            yield c, b0, nw, seg, pitch


@pytest.mark.parametrize("kind,s,hist,off,threads", [
    ("cs16", 512, 31, 4, 256), ("cu8", 512, 31, 6, 512), ("cu16", 231, 74, 0, 512),
    ("cs8", 231, 74, 14, 256), ("cs16", 3, 74, 12, 256), ("cu8", 16, 0, 2, 256),
    ("cs16", 4, 100, 8, 512)])
def test_mma_wire_staging_map(rng, kind, s, hist, off, threads):
    """An emulation of the mma.sync core's wire staging (_mma_wire_staged)
    stages each window group's ext = history ++ decoded wire at (e // s) *
    pitch + e % s, bit for bit, over rows of n = 37 s + 3 frames that
    start off 16-byte alignment, a wire starting ``off`` bytes past it, at
    stage 0's stride, an odd one, strides below 8, no history and a
    history longer than 16 windows; the raw buffer holds the largest
    group and takes less than the second buffer of planes it replaces."""
    ch, n = 2, 37 * s + 3
    elem = 4 if kind in ("cs16", "cu16") else 2
    mem = rng.integers(0, 256, off + ch * n * elem + 16).astype(np.uint8)
    st_r, st_i = (rng.standard_normal((ch, hist)).astype(np.float32) for _ in range(2))
    wire = mem[off:off + ch * n * elem].view(np.int32 if elem == 4 else np.int16)
    xr, xi = (v.numpy().reshape(ch, n) for v in convert.decode_packed(
        torch.from_numpy(wire.copy()), kind, 1 / 128, 0.7))
    ext_r, ext_i = np.concatenate([st_r, xr], -1), np.concatenate([st_i, xi], -1)
    groups = 0
    for c, b0, nw, seg, pitch in _mma_wire_staged(mem, off, kind, st_r, st_i, n, s, hist,
                                                  threads):
        e = np.arange(nw * s + hist)
        o = (e // s) * pitch + e % s
        assert np.array_equal(seg[0, o], ext_r[c, b0 * s + e])
        assert np.array_equal(seg[1, o], ext_i[c, b0 * s + e])
        buf_len = -(-(16 * s + hist + 8) // s) * pitch
        raw_bytes = (16 + 8 * hist + 15 + 15 + elem * 16 * s + 15) // 16 * 16
        assert o.max() < buf_len and raw_bytes <= 8 * buf_len
        groups += 1
    assert groups == ch * 3


@pytest.mark.parametrize("which,core", [
    ("flagship-262144-0", "mma"), ("flagship-262144-1", "wgmma"),
    ("flagship-16384-1", "wgmma"), ("nrsc5-0", "mma"), ("nrsc5-1", "mma"),
    ("complex-taps", "wgmma"), ("fir-toeplitz", "mma"), ("fir-2048", "wgmma"),
    ("narrow-stage-1", "mma")])
def test_banded_core_rule(rng, which, core):
    """The static rule that picks K2's product core: the wgmma core over
    a band of 96 or more taps a column (the flagship's stage 1 with its
    lowpass at both block sizes, complex taps, a 2048-tap FIR band), the
    mma.sync core below (every stage 0, nrsc5's stage 1, config #4's
    stage 1 without the lowpass, a 75-tap FIR band); K1's banded launch
    takes the wgmma core at
    every geometry.  On the CPU either core's wrapper runs the twin and
    counts no launch."""
    if which == "narrow-stage-1":
        cfg = ChainConfig(input_format="cs16", output_format="cs16", input_rate=2_048_000.0,
                          target_rate=1_488_375.0, channels=2, target_block=262144)
        st = Chain(cfg, device="cpu").resampler.stages[1]
        a_r, a_i, s, hist = st._a, st._a_i, st.stride, st.hist
    else:
        a_r, a_i, s, hist = _stage_geometry(which)
    band = kernels.Band.build(a_r, a_i, "cpu")
    assert (band.k >= kernels.WIDE_BAND) == (core == "wgmma")
    assert kernels.banded_core(band) == core
    assert kernels.banded_core(band, dc=True) == "wgmma"
    x = [_t((rng.standard_normal((2, 3 * s)) * 0.3).astype(np.float32)) for _ in range(2)]
    st_ = [_t((rng.standard_normal((2, hist)) * 0.3).astype(np.float32)) for _ in range(2)]
    before = kernels.launch_counts()
    want = kernels.banded_apply_ref(*st_, *x, band, None, s, hist)
    for forced in ("wgmma", "mma"):
        got = kernels.banded_apply(*st_, *x, band, None, s, hist, core=forced)
        assert all(torch.equal(w, g) for w, g in zip(want, got))
    assert kernels.launch_counts() == before


def test_wrappers_refuse_bad_inputs(rng):
    st0 = _flagship_stages()[0]
    z = torch.zeros((2, st0.hist))
    x = torch.zeros((2, 4 * st0.stride))
    with pytest.raises(ValueError):     # NCO needs wire input
        kernels.banded_apply(z, z, x, x, st0._a, None, st0.stride, st0.hist,
                             nco_dtheta=5, nco_phase=torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError):     # cs24 has no packed epilogue
        kernels.banded_apply(z, z, x, x, st0._a, None, st0.stride, st0.hist,
                             pack_fmt="cs24")
    with pytest.raises(ValueError):     # K1 needs wire input
        kernels.banded_apply_dc(z, z, torch.zeros((2, 4)), DC_ALPHA, st0._a,
                                None, st0.stride, st0.hist, x, 0.0)


# ------------------------------ K3, K4, K5, AGC scan ---------------------------

def _wire(rng, fmt, n, ch=CH):
    """(packed wire tensor, kind, normalizer) of a random wire."""
    if fmt == "cs16":
        raw = _t(_cs16_wire(rng, n, ch))
    else:
        raw = _t(rng.integers(0, 256, (ch, 2 * n)).astype(np.uint8))
    wire, kind = convert.wire_pack(raw, fmt)
    return wire, kind, get_format(fmt).normalizer


@pytest.mark.parametrize("case", [("cs16", False, 0), ("cs16", True, DTHETA),
                                  ("planar", True, DTHETA), ("planar", False, 0),
                                  ("cu8", True, 0)],
                         ids=["cs16", "cs16-iq-nco", "planar-iq-nco", "planar",
                              "cu8-iq"])
def test_k3_twin_matches_pallas(rng, case):
    fmt, with_iq, dth = case
    n = 4096
    dc = (rng.standard_normal((CH, 4)) * 0.05).astype(np.float32)
    fac = (rng.standard_normal((CH, 2)) * 0.02).astype(np.float32) if with_iq else None
    pacc = rng.integers(0, 2 ** 32, (CH,), dtype=np.uint32)
    if fmt == "planar":
        xr = (rng.standard_normal((CH, n)) * 0.3).astype(np.float32)
        xi = (rng.standard_normal((CH, n)) * 0.3).astype(np.float32)
        jx, px, jkw, pkw = (jnp.asarray(xr), jnp.asarray(xi)), (_t(xr), _t(xi)), {}, {}
    else:
        wire, kind, norm = _wire(rng, fmt, n)
        jx = px = (None, None)
        jkw = dict(wire_i32=jnp.asarray(wire.numpy()), wire_norm=norm,
                   wire_gain=1.3, wire_kind=kind)
        pkw = dict(jkw, wire_i32=wire)
    want = pallas_kernels.dc_block_apply(
        *jx, jnp.asarray(dc), DC_ALPHA, None if fac is None else jnp.asarray(fac),
        jnp.asarray(pacc)[:, None] if dth else None, dth, interpret=True, **jkw)
    launches = kernels.dc_block_apply.launches
    got = kernels.dc_block_apply(*px, _t(dc), DC_ALPHA,
                                 None if fac is None else _t(fac),
                                 _t(pacc, np.int64) if dth else None, dth, **pkw)
    assert kernels.dc_block_apply.launches == launches      # CPU runs the twin
    for w, g in zip(want, got):                               # yr, yi, DC state
        assert _snr(w, g.numpy()) >= 80.0


def _codes_of(packed, fmt):
    """(I, Q) integer codes of a packed tensor / array of format fmt."""
    bits = 16 if np.asarray(packed).dtype == np.int32 else 8
    p = np.asarray(packed).astype(np.int64) & ((1 << 2 * bits) - 1)
    lo, hi = p & ((1 << bits) - 1), p >> bits
    if get_format(fmt).signed:
        lo, hi = (v - ((v >> (bits - 1)) << bits) for v in (lo, hi))
    return lo, hi


@pytest.mark.parametrize("case", [("cs16", 128, DTHETA), ("cs16", 0, DTHETA),
                                  ("cu8", 128, 0), ("cu8", 0, DTHETA)],
                         ids=["cs16-seg", "cs16-one-gain", "cu8-seg", "cu8-one-gain"])
def test_k4_twin_matches_pallas(rng, case):
    """A ragged block (37 segments of 128 plus 48) whose tail takes the
    last segment's gain, per-segment and per-channel gains, two formats."""
    fmt, seg, dth = case
    n = 128 * 37 + 48
    xr = (rng.standard_normal((CH, n)) * 0.3).astype(np.float32)
    xi = (rng.standard_normal((CH, n)) * 0.3).astype(np.float32)
    gains = rng.uniform(0.5, 2.0, (CH, n // 128 if seg else 1)).astype(np.float32)
    pacc = rng.integers(0, 2 ** 32, (CH,), dtype=np.uint32)
    want = pallas_kernels.post_apply(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(gains), seg,
        jnp.asarray(pacc)[:, None] if dth else None, dth, interpret=True,
        out_fmt=fmt)
    launches = kernels.post_apply.launches
    got = kernels.post_apply(_t(xr), _t(xi), _t(gains), seg,
                             _t(pacc, np.int64) if dth else None, dth, out_fmt=fmt)
    assert kernels.post_apply.launches == launches
    assert got.numpy().dtype == np.asarray(want).dtype

    def dcode(a):
        return np.maximum(*(np.abs(x - y) for x, y in zip(_codes_of(a, fmt),
                                                           _codes_of(got.numpy(), fmt))))
    d = dcode(want)
    # the Pallas kernel adds NCO angles in signed int32 (ROADMAP Queue 3);
    # the twin takes the XLA convention, so with the NCO on it is also
    # held to JAX's XLA ops at the tight bound
    assert d.max() <= 1 and (d > 0).mean() <= (1e-2 if dth else 1e-3)
    if dth:
        from iq_tool_tpu.ops import convert as jconvert
        from iq_tool_tpu.ops import nco as jnco
        yr, yi, _ = jnco.apply_planar(jnp.asarray(xr), jnp.asarray(xi),
                                      jnp.asarray(pacc), dth)
        g = np.asarray(kernels._segment_gains(_t(gains), seg, n))
        xla = jconvert.wire_pack(jconvert.from_planar(yr * g, yi * g, fmt), fmt)[0]
        d = dcode(np.asarray(xla))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3


@pytest.mark.parametrize("case", [(2175, None, 8192), (5000, 16384, 8192),
                                  (5000, None, 16384), (9000, 32768, 16384)],
                         ids=["advance-3b/2", "advance-b", "nfft32768-advance-3b/2",
                              "nfft32768-advance-b"])
def test_k5_twin_matches_pallas(rng, case):
    """nfft 16384: config #4's 2175-tap notch size (3/4-window advance),
    and 5000 taps forced to b 8192 (half-window advance); nfft 32768:
    5000 taps at the default size (3/4 advance) and 9000 taps with
    --filter-fft-size 32768 (half advance).  The twin also takes the
    carried tail as its own pair, as the chain hands it."""
    taps_n, fft_size, want_b = case
    taps = rng.standard_normal(taps_n).astype(np.complex64)
    taps /= np.abs(taps).sum()
    f = StreamingFilter(taps, "fft", fft_size)
    b, adv = f.block, f.osfft_advance
    assert (b, adv) == (want_b, 3 * want_b // 2 if fft_size is None else want_b)
    ch, total = 2, 2 * adv + b
    er = rng.standard_normal((ch, total)).astype(np.float32)
    ei = rng.standard_normal((ch, total)).astype(np.float32)
    want = pallas_kernels.osfft_apply(jnp.asarray(er), jnp.asarray(ei),
                                      tuple(f._h.tolist()), b, advance=adv,
                                      interpret=True)
    launches = kernels.osfft_apply.launches
    got = kernels.osfft_apply(_t(er), _t(ei), f._h, b, advance=adv)
    split = kernels.osfft_apply(_t(er[:, b:]), _t(ei[:, b:]), f._h, b, advance=adv,
                                tail=(_t(er[:, :b]), _t(ei[:, :b])))
    assert kernels.osfft_apply.launches == launches
    for w, g, g2 in zip(want, got, split):
        assert g.shape == (ch, 2 * adv)
        assert _snr(w, g.numpy()) >= 80.0
        assert torch.equal(g, g2)


@pytest.mark.parametrize("nfft", [4096, 16384, 32768, 65536])
def test_k5_spectrum_layout(nfft):
    """The kernel's tables: with the window split over C = nfft / nl CTAs
    (nl = min(nfft, 16384)), h_k holds H/nfft at bin C bitrev(32 t + j) + q
    for CTA q, thread t, point j (position q nl + j nl/32 + t), and the
    two twiddle tables multiply to exp(-2 pi i m / nfft) for every m."""
    h = (np.arange(nfft) + 1j * np.arange(nfft)[::-1]).astype(np.complex64)
    spec = kernels.Spectrum.build(h, "cpu")
    cs = max(1, nfft // kernels.OSFFT_LOCAL)
    nl = nfft // cs
    assert spec.log2c == cs.bit_length() - 1
    hk = spec.h_k.numpy()
    hk = (hk[:, 0] + 1j * hk[:, 1]).reshape(cs, 32, nl // 32)
    rev = kernels._bitrev(nl)
    q, j, t = np.meshgrid(np.arange(cs), np.arange(32), np.arange(nl // 32), indexing="ij")
    np.testing.assert_array_equal(hk, h[cs * rev[32 * t + j] + q] / np.float32(nfft))
    lo, hi = (z.numpy()[:, 0] + 1j * z.numpy()[:, 1] for z in (spec.tw_lo, spec.tw_hi))
    m = np.arange(nfft)
    w = hi[m >> spec.tw_bits] * lo[m & ((1 << spec.tw_bits) - 1)]
    assert np.abs(w - np.exp(-2j * np.pi * m / nfft)).max() < 3e-7


@pytest.mark.parametrize("profile", ["local", "dx"])
def test_agc_scan_twin_matches_jax(rng, profile):
    """config #4's 1488 segments from a non-unit start: the loop inside
    rms_gains_ref."""
    cfg = agc.AgcConfig.make(profile, 1_488_375.0)
    n_seg, seg, beta = agc.rms_params(cfg, 190512)
    e = (rng.uniform(0.0, 0.2, (n_seg, CH))
         * np.linspace(1e-4, 1.0, n_seg)[:, None]).astype(np.float32)
    g0 = rng.uniform(0.5, 2.0, CH).astype(np.float32)
    e20 = rng.uniform(0.0, 0.1, CH).astype(np.float32)
    want = jagc.rms_scan(jnp.asarray(e), jnp.asarray(g0), jnp.asarray(e20),
                         beta, cfg.target)
    got = kernels.rms_scan_ref(_t(e), _t(g0), _t(e20), beta, cfg.target)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() / w - 1.0).max() <= 1e-5
    # the chain kernel's wrapper takes (C, n_seg) and runs this loop here
    chain = kernels.agc_chain(_t(e.T.copy()), _t(g0), _t(e20), beta, cfg.target)
    for w, g in zip((got[0].T, *got[1:]), chain):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n", [190512, 128 * 40 + 100, 200])
@pytest.mark.parametrize("profile", ["local", "dx"])
def test_agc_gains_twin_matches_jax(rng, profile, n):
    """rms_gains_ref (energies by torch.mean, then the loop) against the
    JAX package's agc.rms_gains on the same planes over 3 carried blocks:
    config #4's 1488 segments and a ragged 48, segments of 130 samples,
    and one segment of 200.  Gains within 1e-5 relative; the carried
    gain and e2 within a few float32 ulps (the two means sum in another
    order)."""
    n_seg, seg = kernels.agc_segments(n)
    assert n_seg * seg <= n < (n_seg + 1) * seg
    cfg = agc.AgcConfig.make(profile, 1_488_375.0)
    _, _, beta = agc.rms_params(cfg, n)
    jstate = jagc.init(CH)
    g, e2 = torch.ones(CH), torch.zeros(CH)
    for blk in range(3):
        scale = np.float32(0.3 * (1 + blk))
        xr = (rng.standard_normal((CH, n)) * scale).astype(np.float32)
        xi = (rng.standard_normal((CH, n)) * scale).astype(np.float32)
        want, want_seg, jstate = jagc.rms_gains(jnp.asarray(xr), jnp.asarray(xi),
                                                jstate, cfg)
        got, g, e2 = kernels.rms_gains(_t(xr), _t(xi), g, e2, beta, cfg.target)
        assert want_seg == seg and got.shape == (CH, n_seg)
        assert np.abs(got.numpy() / np.asarray(want) - 1.0).max() <= 1e-5
        for w, gt in ((jstate.gain, g), (jstate.e2, e2)):
            w = np.asarray(w)
            assert np.abs(gt.numpy() - w).max() <= 8 * np.spacing(np.abs(w)).max()


@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("n", [190512, 128 * 40 + 100, 200])
def test_segment_energies_twin(rng, n, rows):
    """segment_energies' twin (the CPU path of the sharded chain's AGC)
    against the reference's definition, mean(xr^2 + xi^2) over each
    segment of each row in float64, within 1e-6 relative; and the gain
    loop over it is rms_gains_ref, bit for bit."""
    n_seg, seg = kernels.agc_segments(n)
    xr, xi = ((rng.standard_normal((CH, rows * n)) * 0.3).astype(np.float32)
              for _ in range(2))
    got = kernels.segment_energies(_t(xr), _t(xi), rows)
    assert got.shape == (CH, rows * n_seg) and got.dtype == torch.float32
    cut = lambda x: x.reshape(CH, rows, n)[..., :n_seg * seg].reshape(CH, rows * n_seg, seg)
    want = (cut(xr).astype(np.float64) ** 2 + cut(xi).astype(np.float64) ** 2).mean(-1)
    assert np.abs(got.numpy() / want - 1.0).max() <= 1e-6
    cfg = agc.AgcConfig.make("local", 1_488_375.0)
    _, _, beta = agc.rms_params(cfg, n)
    g0, e20 = torch.ones(CH), torch.zeros(CH)
    loop = kernels.agc_chain(got, g0, e20, beta, cfg.target)
    fused = kernels.rms_gains(_t(xr), _t(xi), g0, e20, beta, cfg.target, rows)
    for a, b in zip(loop, fused):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rows", [2, 8])
def test_agc_gains_twin_rows_match_jax(rng, rows):
    """rms_gains_ref over a block of ``rows`` rows (a time fold) against
    the JAX package's rms_scan over the rows' segment energies in time
    order, each row cut as one block is (segments of 130 samples, a
    ragged 100 left out): gains within 1e-5 relative."""
    n = 128 * 40 + 100
    cfg = agc.AgcConfig.make("local", 1_488_375.0)
    n_seg, seg, beta = agc.rms_params(cfg, n)
    xr, xi = ((rng.standard_normal((CH, rows * n)) * 0.3).astype(np.float32)
              for _ in range(2))
    cut = lambda x: x.reshape(CH, rows, n)[..., :n_seg * seg].reshape(CH, rows * n_seg, seg)
    e = (cut(xr).astype(np.float64) ** 2 + cut(xi).astype(np.float64) ** 2).mean(-1)
    g0, e20 = np.ones(CH, np.float32), np.zeros(CH, np.float32)
    want = jagc.rms_scan(jnp.asarray(e.T.astype(np.float32)), jnp.asarray(g0),
                         jnp.asarray(e20), beta, cfg.target)
    got = kernels.rms_gains(_t(xr), _t(xi), _t(g0), _t(e20), beta, cfg.target, rows)
    assert got[0].shape == (CH, rows * n_seg)
    assert np.abs(got[0].numpy() / np.asarray(want[0]).T - 1.0).max() <= 1e-5
    for w, g in zip(want[1:], got[1:]):
        assert np.abs(g.numpy() / np.asarray(w) - 1.0).max() <= 1e-5


def _dc_tiles_emulated(x, x_prev, y_prev, a, threads, per, group):
    """csrc/banded_dc.cu's decomposition of y[k] = a y[k-1] + x[k] -
    x[k-1] in float64, vectorised over (C, tile, thread): each thread's
    samples from y = 0, a 5-level shuffle scan inside each warp of 32
    threads, a Horner pass over the warp totals, each tile's aggregate,
    the look-back (tile t folds the aggregates of the tiles of its group
    before it and the inclusive y of the previous group's last tile, or
    the carried y), and each thread's rerun from its true incoming y.
    Samples past n are not run, as in the kernel's ragged last tile.
    Returns (y (C, n), last y (C,))."""
    c, n = x.shape
    tile = threads * per
    tiles = -(-n // tile)
    warps = threads // 32
    xp = np.zeros((c, tiles * tile))
    xp[:, :n] = x
    valid = (np.arange(tiles * tile) < n).reshape(tiles, threads, per)
    b = (xp - np.concatenate([x_prev[:, None], xp[:, :-1]], axis=1)).reshape(
        c, tiles, threads, per)
    e = np.zeros((c, tiles, threads))
    for j in range(per):
        e = np.where(valid[:, :, j], a * e + b[..., j], e)
    s = e.reshape(c, tiles, warps, 32).copy()
    for k in range(5):
        off = 1 << k
        prev = s.copy()
        s[..., off:] = prev[..., off:] + a ** (per * off) * prev[..., :-off]
    ex = np.concatenate([np.zeros((c, tiles, warps, 1)), s[..., :-1]], axis=-1)
    tot = s[..., -1]                                       # (C, tiles, warps)
    before = np.zeros((c, tiles, warps))
    for w in range(1, warps):
        before[..., w] = a ** (32 * per) * before[..., w - 1] + tot[..., w - 1]
    agg = a ** (32 * per) * before[..., -1] + tot[..., -1]
    z = (ex + a ** (per * np.arange(32)) * before[..., None]).reshape(c, tiles, threads)
    y_in = np.zeros((c, tiles))
    inc = {}
    for t in range(tiles):
        na = t % group
        q = t - 1 - na
        acc = a ** (tile * na) * (inc[q] if q >= 0 else y_prev)
        for lane in range(na):
            acc = acc + a ** (tile * lane) * agg[:, t - 1 - lane]
        y_in[:, t] = acc
        if na == group - 1:
            inc[t] = agg[:, t] + a ** tile * acc
    y = z + a ** (per * np.arange(threads)) * y_in[..., None]
    out = np.zeros((c, tiles, threads, per))
    for j in range(per):
        y = np.where(valid[:, :, j], a * y + b[..., j], y)
        out[..., j] = y
    out = out.reshape(c, -1)[:, :n]
    return out, out[:, -1]


@pytest.mark.parametrize("n_of_tile", ["1", "100", "T-1", "T", "T+1", "33T+5"])
@pytest.mark.parametrize("tiling", [(kernels.DC_THREADS, kernels.DC_PER), (32, 4)],
                         ids=["kernel", "small"])
def test_dc_tile_decomposition(rng, tiling, n_of_tile):
    """The DC kernel's float64 tile decomposition against the direct
    recurrence (scipy's lfilter in float64) within 1e-12 of the planes'
    peak, and rounded to float32 against dc_block.apply_planar_ref (the
    CPU twin) within one float32 ulp, on planes and state: N = 1, 100,
    T - 1, T, T + 1 and 33 T + 5 (past a look-back group) at the
    kernel's tile and at a small one."""
    from iq_tool_tpu_torch.ops import dc_block
    threads, per = tiling
    tile = threads * per
    n = {"1": 1, "100": 100, "T-1": tile - 1, "T": tile, "T+1": tile + 1,
         "33T+5": 33 * tile + 5}[n_of_tile]
    a = 1.0 - DC_ALPHA
    x = (rng.standard_normal((2, 2, n)) * 0.3 + 0.05).astype(np.float32)
    st = (rng.standard_normal((2, 4)) * 0.05).astype(np.float32)
    want_r, want_i, want_st = dc_block.apply_planar_ref(_t(x[0]), _t(x[1]), _t(st),
                                                        DC_ALPHA)
    for p, want in enumerate((want_r, want_i)):
        xp, yp = st[:, p].astype(np.float64), st[:, 2 + p].astype(np.float64)
        got, last = _dc_tiles_emulated(x[p].astype(np.float64), xp, yp, a,
                                       threads, per, kernels.DC_GROUP)
        zi = (a * yp - xp)[:, None]
        exact = scipy.signal.lfilter([1.0, -1.0], [1.0, -a], x[p].astype(np.float64),
                                     axis=-1, zi=zi)[0]
        assert np.abs(got - exact).max() <= 1e-12 * np.abs(exact).max()
        ulp = np.spacing(np.float32(np.abs(exact).max()))
        assert np.abs(got.astype(np.float32) - want.numpy()).max() <= ulp
        np.testing.assert_array_equal(want_st[:, p].numpy(), x[p][:, -1])
        assert np.abs(last.astype(np.float32) - want_st[:, 2 + p].numpy()).max() <= ulp


def test_general_wrappers_refuse_bad_inputs():
    z = torch.zeros((2, 300))
    with pytest.raises(ValueError):     # the NCO needs a phase
        kernels.dc_block_apply(z, z, torch.zeros((2, 4)), DC_ALPHA, dtheta=5)
    with pytest.raises(ValueError):     # cf32 has no packed epilogue
        kernels.post_apply(z, z, torch.ones((2, 1)), 0, out_fmt="cf32")
    with pytest.raises(ValueError):     # seg 0 takes one gain per channel
        kernels.post_apply(z, z, torch.ones((2, 2)), 0)
    with pytest.raises(ValueError):     # a window schedule that leaves a gap
        kernels.Windows.uniform(3 * 64 + 10, 64, 64, "cpu")


# ------------------------------ the gather stage ------------------------------

def _gather_stage(ratio, block):
    from iq_tool_tpu_torch.ops import resample as prs
    (st,) = prs.Resampler(ratio, target_block=block).stages
    return st


GATHER_PLANS = {"hackrf": (4766 / 64043, 256172),      # the HackRF cell: 10 Msps -> 744,187.5
                "2469": (2469 / 200000, 16384)}        # 449/36371, K = 1,298


def _gather_emulation(starts, w, n_in, hist, channels, rows, ext=None):
    """csrc/gather.cu's launch over the tile ``kernels.gather_tiles``
    chooses, CTA by CTA in numpy: the rows each pass stages (which ext
    frame and column lands where in the swizzled layout, by the 16-byte
    quads of the block planes or a frame at a time, nothing written twice,
    inside the tile's shared memory), each group's frames of the weight
    windows (``kernels.gather_windows``), each thread's runs of frames.
    Asserts that every output reads exactly ext[starts[j] + b n_in : ... +
    K], each tap once with its weight and no frame past ext's end with a
    weight; returns how often each (plane, channel, output) is written
    and, where ``ext`` (2, C, hist + n) is given, the outputs summed in
    float64."""
    t = kernels.gather_tiles(starts, w.shape[1], n_in, channels, rows)
    windows = kernels.gather_windows(w, starts)
    m, k = w.shape
    gr = -(-m // 4)
    total = gr * rows
    cols, g_cta = t.cols, t.groups
    cg = cols // 2
    kb = 4 if cols >= 4 else 2
    slots = cols // kb
    n = rows * n_in
    ext_len = hist + n
    vec = kb == 4 and n % 4 == 0
    s64 = starts.astype(np.int64)
    x_floats = -(-t.tile_rows * cols // 4) * 4
    per = g_cta * slots
    tiles = -(-total // g_cta)
    assert windows.shape == (gr, t.span, 4)
    assert t.threads == per * t.slices <= kernels.GATHER_THREADS
    assert x_floats * 4 + g_cta * t.wstride * 16 <= t.smem <= kernels.GATHER_SMEM
    assert (t.slices - 1) * 4 * kb * per * 4 <= t.smem
    assert t.span % 4 == t.pass_len % 4 == t.slice_len % 4 == 0
    assert t.slices * t.slice_len >= t.pass_len <= t.wstride and t.wstride % 8 == 2
    assert t.grid[0] == tiles and (t.grid[1] - 1) * cg < channels <= t.grid[1] * cg

    def at(row, chunk):
        sw = (row >> 2) & (slots - 1) if slots > 1 else 0
        return row * cols + (chunk ^ sw) * kb

    ch_of = lambda by: by * cg + np.arange(cols) % cg            # (cols,)
    plane_of = (np.arange(cols) >= cg).astype(int)
    written = np.zeros((2, channels, rows * m), np.int32)
    y = None if ext is None else np.zeros((2, channels, rows * m))
    for tile in range(tiles):                                      # CTA by CTA
        gis = tile * g_cta + np.arange(min(g_cta, total - tile * g_cta))
        ng = gis.size
        orig = s64[4 * (gis % gr)] + (gis // gr) * n_in          # each group's window start
        e0, spread = orig[0], orig[-1] - orig[0]
        xo = orig - e0
        jj = 4 * (gis % gr)[:, None] + np.arange(4)               # (ng, 4) outputs
        have = jj < m
        d = np.where(have, s64[np.minimum(jj, m - 1)] - orig[:, None]
                     + (gis // gr)[:, None] * n_in, 0)
        taps = np.zeros((ng, 4), np.int64)
        acc = None if ext is None else np.zeros((t.grid[1], ng, 4, cols))
        for p0 in range(0, t.span, t.pass_len):
            pl = min(t.pass_len, t.span - p0)
            e_lo, size = e0 + p0, spread + pl
            assert size <= t.tile_rows
            v_lo = v_hi = e_lo
            if vec:
                lo = -(-(max(e_lo, hist) - hist) // 4) * 4
                hi = (min(e_lo + size, ext_len) - hist) // 4 * 4
                if hi > lo:
                    v_lo, v_hi = hist + lo, hist + hi
            head, quads = v_lo - e_lo, (v_hi - v_lo) // 4
            r = np.arange(size)
            by_quad = (r >= head) & (r < head + 4 * quads)
            ex = e_lo + r[by_quad] - hist                          # the quads' block frames
            assert (ex[::4] % 4 == 0).all() and (ex >= 0).all() and (ex < n).all()
            row_at = np.full(x_floats, -1)
            col_at = np.full(x_floats, -1)
            for path in (by_quad, ~by_quad):                        # 16-byte quads, then frames
                for chunk in range(slots):
                    for j in range(kb):
                        idx = at(r[path], chunk) + j
                        assert (row_at[idx] == -1).all()          # nothing staged twice
                        row_at[idx], col_at[idx] = r[path], chunk * kb + j
            assert (row_at[:size * cols] >= 0).all()
            tt = np.arange(pl)
            assert (tt // t.slice_len < t.slices).all()           # the runs cover the pass
            kk = p0 + tt[None, None, :] - d[:, :, None]           # (ng, 4, pl) tap of each frame
            live = have[:, :, None] & (kk >= 0) & (kk < k)
            taps += live.sum(-1)
            wv = windows[(gis % gr)[:, None], p0 + tt[None, :]].transpose(0, 2, 1)   # (ng, 4, pl)
            want_w = np.where(live, w[np.minimum(jj, m - 1)[:, :, None], np.clip(kk, 0, k - 1)], 0)
            assert np.array_equal(wv, want_w)
            for slot in range(slots):
                for j in range(kb):
                    pos = at(xo[:, None] + tt[None, :], slot) + j   # (ng, pl)
                    assert (row_at[pos] == xo[:, None] + tt[None, :]).all()
                    assert (col_at[pos] == slot * kb + j).all()
            e = e0 + p0 + xo[:, None] + tt[None, :]                # (ng, pl) frame read
            want = orig[:, None, None] + d[:, :, None] + kk       # its tap's frame
            assert (e[:, None, :] == want)[live].all()
            assert np.broadcast_to(e[:, None, :] < ext_len, live.shape)[live].all()
            if ext is not None:
                e_c = np.minimum(e, ext_len - 1)
                for by in range(t.grid[1]):
                    ch = np.minimum(ch_of(by), channels - 1)
                    xv = ext[plane_of[:, None], ch[:, None], e_c.reshape(-1)[None, :]]
                    xv = np.where((e < ext_len).reshape(-1)[None, :], xv, 0.0)
                    xv = xv.reshape(cols, ng, pl)
                    acc[by] += np.einsum("gip,cgp->gic", wv, xv)
        assert (taps[have] == k).all() and (taps[~have] == 0).all()
        b, j = np.broadcast_to((gis // gr)[:, None], jj.shape), jj
        for by in range(t.grid[1]):
            ch = ch_of(by)
            for c in range(cols):
                if ch[c] >= channels:
                    continue
                o = (b * m + j)[have]
                written[plane_of[c], ch[c], o] += 1
                if y is not None:
                    y[plane_of[c], ch[c], o] = acc[by, :, :, c][have]
    return written, y


@pytest.mark.parametrize("plan,channels,rows", [("hackrf", 64, 1), ("hackrf", 2, 2),
                                                ("2469", 128, 1), ("2469", 3, 1),
                                                ("2469", 3, 2), ("2469", 1, 8)])
def test_gather_tiles_read_each_window_once(rng, plan, channels, rows):
    """The gather kernel's tiling (``kernels.gather_tiles``, emulated CTA
    by CTA): channel groups and tiles of groups cover the outputs, the
    ragged last tile and channel group included; each CTA's staged span,
    halo included, fits its shared memory; every output reads exactly its
    window, over r = 2 and 8 row blocks too, and is written once.  At
    few channels, the emulation's float64 sums are the plan's definition."""
    st = _gather_stage(*GATHER_PLANS[plan])
    plan_, hist = st.plan, st.hist
    n = rows * plan_.n_in
    ext = None
    if channels <= 3:
        ext = rng.standard_normal((2, channels, hist + n))
    written, y = _gather_emulation(plan_.starts, plan_.weights, plan_.n_in, hist,
                                   channels, rows, ext)
    assert (written == 1).all()
    if ext is not None:
        w = plan_.weights.astype(np.float64)
        want = np.zeros_like(y)
        outs = (np.arange(rows)[:, None] * plan_.n_in
                + plan_.starts.astype(np.int64)[None, :]).reshape(-1)      # (rows M,)
        for kk in range(w.shape[1]):
            want += np.tile(w[:, kk], rows) * ext[:, :, outs + kk]
        np.testing.assert_allclose(y, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_gather_tiles_adapt_to_the_plan():
    """The tile follows the plan and the input: 16 channels a CTA and
    the whole window in one pass at the HackRF plan's 216 taps, fewer
    channels and the window in passes for 449/36371's 1,298 at 128
    channels and for 1/997's 15,952; two CTAs an SM, within the threads
    a CTA has."""
    hk = _gather_stage(*GATHER_PLANS["hackrf"]).plan
    t = kernels.gather_tiles(hk.starts, hk.weights.shape[1], hk.n_in, 64, 1)
    assert (t.cols, t.pass_len) == (32, t.span) and t.span >= hk.weights.shape[1]
    lg = _gather_stage(2469 / 200000, 262144).plan
    u = kernels.gather_tiles(lg.starts, lg.weights.shape[1], lg.n_in, 128, 1)
    assert u.cols < 32 and u.pass_len < u.span
    xl = _gather_stage(1 / 997, 1 << 20).plan
    v = kernels.gather_tiles(xl.starts, xl.weights.shape[1], xl.n_in, 1, 1)
    assert xl.weights.shape[1] > 15000 and v.pass_len < v.span
    for x in (t, u, v):
        assert 2 * (x.smem + 1024) <= 233472 and x.threads <= kernels.GATHER_THREADS
