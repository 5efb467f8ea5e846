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


def _dense_from_tiles(band, taps):
    """Invert the B-fragment layout (16-column tiles, k paired): the
    (L, G) matrix the tiles hold, checking that nothing lies past A's
    edges and that the tiles do not overlap."""
    t = taps.numpy()
    n_tiles, n_chunks = t.shape[:2]
    lane = np.arange(32)
    r, c = 2 * (lane % 4), lane // 4
    b = np.zeros((n_tiles, n_chunks, 8, kernels.TILE_COLS), np.float32)
    b[:, :, r, c], b[:, :, r + 1, c] = t[..., 0], t[..., 1]
    b[:, :, r, c + 8], b[:, :, r + 1, c + 8] = t[..., 2], t[..., 3]
    b = b.reshape(n_tiles, band.span, kernels.TILE_COLS)
    w = kernels.TILE_COLS
    dense = np.zeros((band.rows + band.span, n_tiles * w), np.float32)
    for i, f in enumerate(band.tile_first.numpy()):
        assert f % 2 == 0
        assert not dense[f:f + band.span, w * i:w * (i + 1)].any()
        dense[f:f + band.span, w * i:w * (i + 1)] = b[i]
    assert not dense[band.rows:].any() and not dense[:, band.g:].any()
    return dense[:band.rows, :band.g]


@pytest.mark.parametrize("which", ["flagship-16384-0", "flagship-16384-1",
                                   "flagship-262144-0", "flagship-262144-1",
                                   "nrsc5-0", "nrsc5-1", "complex-taps", "fir-toeplitz"])
def test_band_compression_is_the_same_map(which):
    """The kernel's column tiles (16 columns over the rows that hold their
    non-zeros, in B-fragment order) rebuild the dense A exactly, at every
    stage geometry the tests run: the flagship stages at both block sizes
    (strides 512, 224 and 256), the NRSC5 strides 400 and 144, complex
    taps, and a FIR filter's Toeplitz band."""
    a_r, a_i = _stage_matrix(which)
    band = kernels.Band.build(a_r, a_i, "cpu")
    assert band.span % 8 == 0 and band.n_tiles == -(-band.g // kernels.TILE_COLS)
    np.testing.assert_array_equal(_dense_from_tiles(band, band.taps_r), a_r)
    if a_i is not None and np.any(a_i):
        np.testing.assert_array_equal(_dense_from_tiles(band, band.taps_i), a_i)
    else:
        assert band.taps_i is None
    # the span is the band plus the tile's spread of band starts, a
    # fraction of the window
    assert band.k <= band.span < band.k + 8 + 2 * 16 * 4
    if not which.startswith("fir"):
        assert band.span < a_r.shape[0] // 2


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


def test_3xtf32_split_precision(rng):
    """The precision argument for K2's tensor-core products, before any
    chip run: the windows of the flagship's stage-1 input times its band
    matrix with both operands split in two TF32 parts and the three
    leading products summed in float32 (x_lo a_hi + x_hi a_lo + x_hi
    a_hi, as csrc/banded.cu accumulates them) agree with the float64
    product to >= 110 dB; one TF32 product falls short of the kernels'
    100 dB gate."""
    st1 = _flagship_stages(262144)[1]
    s, hist = st1.stride, st1.hist
    assert (s, hist) == (256, 287)
    a = torch.from_numpy(np.ascontiguousarray(st1._a, np.float32))
    x = torch.from_numpy((rng.standard_normal((4, 64 * s + hist)) * 0.3).astype(np.float32))
    win = x.unfold(-1, s + hist, s)                              # (4, 64, 543)
    exact = torch.matmul(win.double(), a.double())
    (xh, xl), (ah, al) = _split(win), _split(a)
    # the two parts hold x to 2^-21 relative (lo keeps 11 of x's 13
    # remaining bits)
    assert bool(((xh + xl - win).abs() <= win.abs() * 2.0 ** -21).all())
    got = torch.matmul(xl, ah) + torch.matmul(xh, al) + torch.matmul(xh, ah)
    one = torch.matmul(xh, ah)
    snr3 = _snr(exact.numpy(), got.numpy())
    snr1 = _snr(exact.numpy(), one.numpy())
    assert snr3 >= 110.0, snr3
    assert snr1 < 80.0, snr1


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
