"""The I/Q estimator of a step (``kernels.iq_estimate``, csrc/iq_est.cu) on
the CPU: its plain twin against the JAX chain's estimator path, the twin
against the composition the chain ran before the kernel, and numpy
emulations of the kernel's index arithmetic (the 32 x 32 FFT with its
fftshift by index, the DC prefix's scan, the 4-value CTA sum).

Bounds, each with its reason:
* factors against JAX: the two packages' FFTs and DC recurrences
  (float64 here, float32 there) round differently, so a near-tie in the
  greedy descent's argmax can pick another diagonal move: 2 moves of
  1e-4, times the 0.05 smoothing, per update so far; the counter exact;
* against the former composition: byte-identical (the same tensor ops);
* the emulations: float64, to 1e-9 of the spectrum's peak or exact;
  the twin's FFT and band sums against float32 and float64 emulations of
  the kernel's operations: bit for bit (the two must decide alike on a
  near-tie of two candidates).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from iq_tool_tpu import constants as JC  # noqa: E402
from iq_tool_tpu.ops import convert as jconvert  # noqa: E402
from iq_tool_tpu.ops import dc_block as jdc  # noqa: E402
from iq_tool_tpu.ops import iq_balance as jiq  # noqa: E402
from iq_tool_tpu_torch import constants as C  # noqa: E402
from iq_tool_tpu_torch.formats import get_format  # noqa: E402
from iq_tool_tpu_torch.ops import convert, dc_block, iq_balance, kernels  # noqa: E402

RATE = 2_048_000.0
ALPHA = dc_block.alpha_for_rate(RATE)
STEP = C.IQ_EST_STEP
SM = C.IQ_SMOOTHING


def _signal(rng, ch, n, noise_only=False):
    """Tones at 0.07 and -0.19 of the rate behind a 1 % / 0.012 rad I/Q
    imbalance plus a DC offset and noise, or the noise alone (which
    never passes the power gate): (C, n) complex128 within +-0.6."""
    k = np.arange(n)
    noise = 1e-3 * (rng.standard_normal((ch, n)) + 1j * rng.standard_normal((ch, n)))
    if noise_only:
        return noise
    x = (0.4 * np.exp(2j * np.pi * (0.07 * k[None, :] + rng.random((ch, 1))))
         + 0.1 * np.exp(-2j * np.pi * 0.19 * k) + 0.02 + 0.01j + noise)
    return x.real * 1.01 + 1j * (x.imag + 0.012 * x.real)


def _raw(x, fmt):
    """The wire of `fmt` holding x: (C, n * items) numpy."""
    pairs = np.stack([x.real, x.imag], -1).reshape(x.shape[0], -1)
    if fmt == "cf32":
        return pairs.astype(np.float32)
    if fmt == "cu8":
        return np.clip(np.round(pairs * 127.5 + 127.5), 0, 255).astype(np.uint8)
    return np.clip(np.round(pairs * 32767), -32768, 32767).astype(np.int16)


CASES = {   # name: (format, DC block, frames a block, noise only)
    "cs16-dc": ("cs16", True, 2048, False),
    "cu8-dc": ("cu8", True, 2048, False),
    "planes-dc": ("cf32", True, 2048, False),
    "cs16": ("cs16", False, 2048, False),
    "planes": ("cf32", False, 2048, False),
    "short-dc": ("cs16", True, 700, False),
    "noise-dc": ("cs16", True, 2048, True),
}


def _port_args(raw_t, fmt):
    """The chain's estimator inputs from a torch wire block: the packed
    wire where the format has one, else the planes."""
    packed = convert.wire_pack(raw_t, fmt)
    if packed is None:
        xr, xi = convert.to_planar(raw_t, fmt)
        return dict(xr=xr, xi=xi)
    return dict(xr=None, xi=None, wire_i32=packed[0], wire_norm=get_format(fmt).normalizer,
                wire_gain=1.0, wire_kind=packed[1])


@pytest.mark.parametrize("case", list(CASES))
def test_estimate_ref_matches_jax_chain_path(case):
    """iq_estimate_ref against the JAX chain's estimator branch
    (iq_tool_tpu/pipeline/chain.py:309-328: decode_packed of the prefix,
    dc_block._apply_plane from the carried state, maybe_update_planar)
    over 4 carried blocks at an interval of 1.5 blocks: due, not due,
    due, not due (the noise: due on every block, the counter saturated)."""
    fmt, dc, n, noise_only = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    ch = 3
    x = _signal(rng, ch, 4 * n, noise_only)
    interval = 3 * n // 2
    jstate, state = jiq.init(ch), iq_balance.init(ch)
    jdcs = jdc.init_planar(ch)
    dcs = dc_block.init_planar(ch)
    updates = 0
    for b in range(4):
        raw = _raw(x[:, b * n:(b + 1) * n], fmt)
        jraw = jnp.asarray(raw)
        m = min(n, JC.IQ_FFT_SIZE)
        jpacked = jconvert.wire_pack(jraw, fmt)
        jxr, jxi = jconvert.to_planar(jraw, fmt)
        if jpacked is None:
            pr, pi = jxr[:, :m], jxi[:, :m]
        else:
            pr, pi = jconvert.decode_packed(jpacked[0][:, :m], jpacked[1],
                                            get_format(fmt).normalizer, 1.0)
        if dc:
            pr, _, _ = jdc._apply_plane(pr, jdcs.xr_prev, jdcs.yr_prev, ALPHA)
            pi, _, _ = jdc._apply_plane(pi, jdcs.xi_prev, jdcs.yi_prev, ALPHA)
            yr, xr_l, yr_l = jdc._apply_plane(jxr, jdcs.xr_prev, jdcs.yr_prev, ALPHA)
            yi, xi_l, yi_l = jdc._apply_plane(jxi, jdcs.xi_prev, jdcs.yi_prev, ALPHA)
            jdcs = jdc.PlanarDcState(xr_l, xi_l, yr_l, yi_l)
        due = int(jstate.samples_since_opt) >= interval
        jstate = jiq.maybe_update_planar(pr, pi, jstate, interval, advance_samples=n)

        raw_t = torch.from_numpy(raw)
        args = _port_args(raw_t, fmt)
        fac, counter, gate = kernels.iq_estimate_ref(
            args.pop("xr"), args.pop("xi"), state.factors, state.samples_since_opt,
            interval, n, dc_state=dcs if dc else None, dc_alpha=ALPHA, **args)
        if dc:
            pxr, pxi = convert.to_planar(raw_t, fmt)
            _, _, dcs = dc_block.apply_planar_ref(pxr, pxi, dcs, ALPHA)
        state = iq_balance.IqState(fac, counter)
        updates += due
        assert int(counter) == int(jstate.samples_since_opt)
        assert bool(torch.isnan(gate).all()) != due
        np.testing.assert_allclose(fac.numpy(), np.asarray(jstate.factors), rtol=0,
                                   atol=2 * STEP * SM * max(updates, 1) + 1e-9)
    if noise_only:
        assert int(state.samples_since_opt) == 0xF0000000 and updates == 4
        assert not state.factors.numpy().any()
    else:
        assert updates == 2
        assert (state.factors.numpy() < 0).all()   # toward the correction


@pytest.mark.parametrize("case", ["cs16-dc", "cu8-dc", "planes-dc", "planes", "short-dc"])
def test_estimate_ref_is_the_former_composition(case):
    """The twin is the composition the chain ran before the kernel:
    decode_packed of the prefix, dc_block.apply_prefix, then
    maybe_update on the complex prefix; byte-identical."""
    fmt, dc, n, _ = CASES[case]
    rng = np.random.default_rng(7)
    ch = 2
    raw_t = torch.from_numpy(_raw(_signal(rng, ch, n), fmt))
    state = iq_balance.IqState(torch.from_numpy(rng.normal(0, 1e-3, (ch, 2)).astype(np.float32)),
                               torch.tensor(0xFFFFFFFF, dtype=torch.int64))
    dcs = torch.from_numpy(rng.normal(0, 0.05, (ch, 4)).astype(np.float32))
    args = _port_args(raw_t, fmt)
    m = min(n, C.IQ_FFT_SIZE)
    if "wire_i32" in args:
        pr, pi = convert.decode_packed(args["wire_i32"][:, :m], args["wire_kind"],
                                       args["wire_norm"], 1.0)
    else:
        pr, pi = args["xr"], args["xi"]
    if dc:
        pr, pi = dc_block.apply_prefix(pr, pi, dcs, ALPHA, m)
    want = iq_balance.maybe_update(torch.complex(pr[:, :m], pi[:, :m]), state, 1000,
                                   advance_samples=n)
    got = iq_balance.maybe_update_planar(args.pop("xr", None), args.pop("xi", None),
                                         state, 1000, dc_state=dcs if dc else None,
                                         dc_alpha=ALPHA, **args)
    assert torch.equal(got.factors, want.factors)
    assert torch.equal(got.samples_since_opt, want.samples_since_opt)
    assert not torch.equal(got.factors, state.factors)


# ------------------------------------------------- the kernel's index arithmetic

_W32 = np.exp(-2j * np.pi * np.arange(16) / 32)


def _brev5(j):
    return ((j & 1) << 4) | ((j & 2) << 2) | (j & 4) | ((j & 8) >> 2) | ((j & 16) >> 4)


def _dft32(x):
    """csrc/iq_est.cu dft32: radix-2 decimation in frequency in place over
    the 32 registers; register r ends holding X[brev5(r)]."""
    x = list(x)
    for b in range(4, -1, -1):
        for j in range(32):
            if j & (1 << b):
                continue
            u, v = x[j], x[j + (1 << b)]
            x[j] = u + v
            x[j + (1 << b)] = (u - v) * _W32[(j & ((1 << b) - 1)) << (4 - b)]
    return x


def _fft1024(buf):
    """csrc/iq_est.cu fft1024 on a (1056,) buffer, lane by lane: the column
    pass, the twiddles W_1024^(j k1), the 33-pitch transpose, the row
    pass, the natural-order store."""
    tw = np.exp(-2j * np.pi * np.arange(1024) / 1024)
    regs = [_dft32([buf[j + 32 * n1] for n1 in range(32)]) for j in range(32)]
    for j in range(32):
        for r in range(32):
            k1 = _brev5(r)
            buf[j * 33 + k1] = regs[j][r] * (1 if k1 == 0 else tw[(j * k1) & 1023])
    regs = [_dft32([buf[i * 33 + j] for i in range(32)]) for j in range(32)]
    for j in range(32):
        for r in range(32):
            buf[j + 32 * _brev5(r)] = regs[j][r]
    return buf


def test_fft_factorisation_and_shift_indexing():
    """The kernel's FFT and its fftshift by index against numpy.fft: the
    band the descent reads, p_neg[t] at (lo + t + 512) mod 1024 and p_pos[t]
    at (1024 - lo - 1 - t + 512) mod 1024 of the unshifted spectrum, is
    the reference's slice and flipped slice of the shifted one."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal(1024) + 1j * rng.standard_normal(1024)
    buf = np.zeros(1056, np.complex128)
    buf[:1024] = x
    spec = _fft1024(buf)[:1024]
    want = np.fft.fft(x)
    assert np.abs(spec - want).max() <= 1e-9 * np.abs(want).max()
    shifted = np.fft.fftshift(want)
    lo, hi = iq_balance.band_edges(1024)
    t = np.arange(hi - lo)
    p_neg = spec[(lo + t + 512) & 1023]
    p_pos = spec[(1024 - lo - 1 - t + 512) & 1023]
    np.testing.assert_allclose(p_neg, shifted[lo:hi], rtol=0, atol=1e-9 * np.abs(want).max())
    np.testing.assert_allclose(p_pos, shifted[1024 - hi:1024 - lo][::-1], rtol=0,
                               atol=1e-9 * np.abs(want).max())
    assert hi - lo <= 512     # one bin a thread


def test_dc_prefix_scan_scheme():
    """The kernel's float64 DC prefix (two samples a thread, a warp scan
    at a^(2 2^q), a Horner pass over the 16 warp totals at a^64, the
    incoming a^(2t) y_prev) against the direct recurrence, and zero past m."""
    rng = np.random.default_rng(12)
    m = 1000
    x = rng.standard_normal(m).astype(np.float32).astype(np.float64)
    x_prev, y_prev = 0.3, -0.2
    a = 1.0 - ALPHA * 40
    want = np.zeros(1024)
    y = y_prev
    for k in range(m):
        y = a * y + x[k] - (x[k - 1] if k else x_prev)
        want[k] = y
    xs = np.zeros(1024)
    xs[:m] = x
    xp = np.concatenate([[x_prev], xs[:-1]])
    b = xs - xp
    e = a * b[0::2] + b[1::2]                    # each thread's run from 0
    s = e.reshape(16, 32).copy()
    lev = a * a
    for q in range(5):
        sh = 1 << q
        up = np.concatenate([np.zeros((16, sh)), s[:, :-sh]], axis=1)
        s = np.where(np.arange(32) >= sh, lev * up + s, s)
        lev *= lev
    z = np.concatenate([np.zeros((16, 1)), s[:, :-1]], axis=1)
    w = np.zeros(16)
    for v in range(1, 16):
        w[v] = lev * w[v - 1] + s[v - 1, 31]
    t = np.arange(512)
    yin = (a * a) ** t * y_prev + ((a * a) ** (t % 32)) * w[t // 32] + z.ravel()
    y0 = a * yin + b[0::2]
    y1 = a * y0 + b[1::2]
    got = np.stack([y0, y1], -1).ravel()
    got[m:] = 0.0
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_cta_sum4_lanes():
    """The kernel's 4-value CTA sum: after the xor-16 and xor-8 exchanges
    lane 8k + i holds value k's pair sums, the xor 4/2/1 steps finish the
    warp sum, and the 16 warp sums read as 2 a lane and shuffled give
    every lane the four totals."""
    rng = np.random.default_rng(13)
    v = rng.standard_normal((16, 32, 4))         # (warp, lane, value)
    lane = np.arange(32)
    h16, h8 = (lane & 16) > 0, (lane & 8) > 0
    red = np.zeros((4, 16))
    for w in range(16):
        # each lane keeps two values and sends its partner the other two
        k0 = np.where(h16, v[w, :, 2], v[w, :, 0]) + np.where(h16, v[w, :, 0],
                                                              v[w, :, 2])[lane ^ 16]
        k1 = np.where(h16, v[w, :, 3], v[w, :, 1]) + np.where(h16, v[w, :, 1],
                                                              v[w, :, 3])[lane ^ 16]
        s = np.where(h8, k1, k0) + np.where(h8, k0, k1)[lane ^ 8]
        for off in (4, 2, 1):
            s = s + s[lane ^ off]
        for k in range(4):
            red[k, w] = s[8 * k]
            assert np.allclose(s[8 * k:8 * k + 8], v[w, :, k].sum())
    k, i = lane >> 3, lane & 7
    tot = red[k, 2 * i] + red[k, 2 * i + 1]
    for off in (4, 2, 1):
        tot = tot + tot[lane ^ off]
    np.testing.assert_allclose(tot[8 * np.arange(4)], v.sum(axis=(0, 1)), rtol=1e-12)


def test_estimate_wrapper_on_cpu_is_the_twin():
    """On a CPU tensor the wrapper runs the twin and counts no launch; the
    calibration mode (no counter) is the unsmoothed descent, as
    iq_balance.calibrate's rounds."""
    rng = np.random.default_rng(14)
    x = torch.from_numpy(_signal(rng, 2, 1024).astype(np.complex64))
    before = kernels.iq_estimate.launches
    fac, cnt, gate = kernels.iq_estimate(x.real, x.imag, torch.zeros(2, 2), None,
                                         passes=250)
    assert kernels.iq_estimate.launches == before and cnt is None
    assert torch.equal(fac, iq_balance.calibrate(x))
    assert (gate > C.IQ_POWER_GATE_DB).all()


# ------------------------------------------- near-ties: the twin rounds as the kernel

def _f32_dft32(xr, xi, w_r, w_i):
    """csrc/iq_est.cu dft32 over 32 float32 registers (each a numpy array
    over the channels), each operation rounded: rot32 keeps k = 0, swaps
    at k = 8 and multiplies by kW32 otherwise."""
    xr, xi = list(xr), list(xi)
    for b in range(4, -1, -1):
        for j in range(32):
            if j & (1 << b):
                continue
            ur, ui, vr, vi = xr[j], xi[j], xr[j + (1 << b)], xi[j + (1 << b)]
            xr[j], xi[j] = ur + vr, ui + vi
            dr, di = ur - vr, ui - vi
            k = (j & ((1 << b) - 1)) << (4 - b)
            if k == 8:
                dr, di = di, -dr
            elif k:
                dr, di = dr * w_r[k] - di * w_i[k], dr * w_i[k] + di * w_r[k]
            xr[j + (1 << b)], xi[j + (1 << b)] = dr, di
    return xr, xi


def _f32_fft1024(xr, xi):
    """csrc/iq_est.cu fft1024 in float32, lane by lane: (C, 1024) planes in,
    natural order out."""
    w = np.exp(-2j * np.pi * np.arange(16) / 32).astype(np.complex64)
    tw = np.exp(-2j * np.pi * np.arange(1024) / 1024).astype(np.complex64)
    ch = xr.shape[0]
    br, bi = np.zeros((ch, 1056), np.float32), np.zeros((ch, 1056), np.float32)
    for j in range(32):
        rr, ri = _f32_dft32([xr[:, j + 32 * n] for n in range(32)],
                            [xi[:, j + 32 * n] for n in range(32)], w.real, w.imag)
        for r in range(32):
            k1 = _brev5(r)
            t = tw[(j * k1) & 1023]
            if k1 == 0:
                br[:, j * 33], bi[:, j * 33] = rr[r], ri[r]
            else:
                br[:, j * 33 + k1] = rr[r] * t.real - ri[r] * t.imag
                bi[:, j * 33 + k1] = rr[r] * t.imag + ri[r] * t.real
    out_r, out_i = np.zeros((ch, 1024), np.float32), np.zeros((ch, 1024), np.float32)
    for j in range(32):
        rr, ri = _f32_dft32([br[:, i * 33 + j] for i in range(32)],
                            [bi[:, i * 33 + j] for i in range(32)], w.real, w.imag)
        for r in range(32):
            out_r[:, j + 32 * _brev5(r)], out_i[:, j + 32 * _brev5(r)] = rr[r], ri[r]
    return out_r, out_i


def test_twin_fft_is_the_kernels_fft():
    """iq_balance._fft1024 (the twin's spectra) performs the kernel's
    float32 operations in the kernel's order: bit-identical to a lane-by-
    lane float32 emulation of fft1024, and an FFT (numpy.fft within
    float32 rounding, 1e-6 of the peak)."""
    rng = np.random.default_rng(15)
    x = (rng.standard_normal((3, 1024)) + 1j * rng.standard_normal((3, 1024))) \
        .astype(np.complex64)
    got_r, got_i = iq_balance._fft1024(torch.from_numpy(x.real.copy()),
                                       torch.from_numpy(x.imag.copy()))
    want_r, want_i = _f32_fft1024(x.real.copy(), x.imag.copy())
    assert np.array_equal(got_r.numpy(), want_r) and np.array_equal(got_i.numpy(), want_i)
    ref = np.fft.fft(x.astype(np.complex128))
    assert np.abs(want_r + 1j * want_i - ref).max() <= 1e-6 * np.abs(ref).max()


def _cta_sum4_f32(v):
    """csrc/iq_est.cu cta_sum4 on one value's (16 warps, 32 lanes) float32
    terms, each addition rounded to float32: the lanes' exchanges at 16,
    8, 4, 2, 1, then the warp sums read in pairs and exchanged at 4, 2, 1
    (test_cta_sum4_lanes)."""
    lane = np.arange(32)
    red = np.zeros(16, np.float32)
    for w in range(16):
        s = v[w] + v[w][lane ^ 16]
        for off in (8, 4, 2, 1):
            s = s + s[lane ^ off]
        red[w] = s[0]
    i = np.arange(8)
    tot = red[2 * i] + red[2 * i + 1]
    for off in (4, 2, 1):
        tot = tot + tot[i ^ off]
    return tot[0]


def test_band_sum_is_the_kernels_tree():
    """iq_balance._band_sum, which the twin's utility and gate take, sums
    bin t's float32 term on thread t's lane of the kernel's float64
    reduction: bit-identical to the emulated tree in float32, zero past
    the band, and another sum than float32 in bin order."""
    rng = np.random.default_rng(16)
    lo, hi = iq_balance.band_edges(1024)
    terms = (rng.standard_normal((4, hi - lo)) * 10.0 ** rng.uniform(-3, 4, (4, hi - lo))) \
        .astype(np.float32)
    got = iq_balance._band_sum(torch.from_numpy(terms)).numpy()
    assert got.dtype == np.float32
    flat = np.zeros(4, np.float32)
    for t in range(hi - lo):
        flat = flat + terms[:, t]
    for row, g in zip(terms, got):
        pad = np.zeros(512, np.float32)
        pad[:hi - lo] = row
        assert g == _cta_sum4_f32(pad.reshape(16, 32))
    assert (got != flat).any()


def _db_spectrum(p_pos, p_neg):
    """A shifted (C, 1024) dB spectrum holding the band's two sides."""
    lo, hi = iq_balance.band_edges(1024)
    spec = np.full((len(p_pos), 1024), -120.0, np.float32)
    spec[:, lo:hi] = p_neg
    spec[:, 1024 - hi:1024 - lo] = np.asarray(p_pos)[:, ::-1]
    return torch.from_numpy(spec)


def test_near_tie_decided_by_the_kernels_tree():
    """Two candidates whose order flips between a float32 sum and the
    kernel's tree: A's terms are one 4096 dB difference squared (2^24)
    and 200 of 1 (exact 16777416), B's one (4096 + 3/128)^2 (16777408.0005).
    A float32 sum in bin order drops A's small terms and ranks B first;
    the twin's sum in the kernel's tree adds them in pairs first, reads
    16777416 and ranks A first, and the pass takes A.  On an exact tie
    it takes the first candidate; a candidate equal to the current utility
    does not move."""
    lo, hi = iq_balance.band_edges(1024)
    nb = hi - lo
    p_neg = np.full((2, nb), -100.0, np.float32)     # both below the floor: no term
    p_pos = np.full((2, nb), -100.0, np.float32)
    p_neg[0, :201], p_neg[1, 0] = 0.0, 0.0
    p_pos[0, 0], p_pos[0, 1:201] = 4096.0, 1.0
    p_pos[1, 0] = 4096.0 + 3 / 128
    terms = np.where((p_pos > -80) | (p_neg > -80), (p_pos - p_neg) ** 2, 0).astype(np.float32)
    flat = [np.float32(0)] * 2
    for c in range(2):
        for t in terms[c]:
            flat[c] = np.float32(flat[c] + t)
    assert flat[1] > flat[0]                          # float32 in order: B
    u = iq_balance._utility(_db_spectrum(p_pos, p_neg))
    assert u[0] == 16777416.0 and u[0] > u[1]
    # (4 candidates, 2 channels): B, A, A, B from 0, and A four times from A
    ua, ub = u[0], u[1]
    us = torch.stack([torch.stack([ub, ua, ua, ub]), ua.expand(4)], dim=1)
    best, better = iq_balance._best_move(us, torch.stack([torch.zeros_like(ua), ua]))
    assert best.tolist() == [1, 0] and better.tolist() == [True, False]


def test_exact_tie_takes_the_first_candidate():
    """A descent pass on spectra whose utility is even in phi (real base
    and image, phi = 0): the candidates (g - s, +s) and (g - s, -s) tie
    exactly and beat (g + s, +-s); the pass takes the first, (-s, +s), as
    the kernel's strict comparison does."""
    lo, hi = iq_balance.band_edges(1024)
    base = np.zeros((1, 1024), np.complex64)
    image = np.zeros((1, 1024), np.complex64)
    base[0, lo:hi] = 1024.0                           # p_neg: 0 dB, no image
    base[0, 1024 - hi:1024 - lo] = 0.1 * 1024.0        # p_pos: -20 dB ...
    image[0, 1024 - hi:1024 - lo] = 1024.0             # ... plus (g + i phi)
    b, m = torch.from_numpy(base), torch.from_numpy(image)
    f0 = torch.zeros((1, 2))
    s = np.float32(STEP)
    cands = f0 + torch.from_numpy(np.float32(STEP) * iq_balance._DIRS)
    us = iq_balance._utility(iq_balance._spectrum_db(b, m, cands[:, :1], cands[:, 1:]))
    assert us[2] == us[3] and us[2] > us[0]
    got = iq_balance._optimize_core(b, m, f0, passes=1)
    assert got.tolist() == [[-s, s]]
