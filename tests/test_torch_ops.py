"""The port's I/Q balance, AGC and streaming-filter modules against the
JAX package's on the CPU.

Bounds, each with its reason:
* the I/Q estimator's spectra: torch.fft against JAX's FFT, both float32,
  to 1e-5 of the spectrum's peak; the utility and the power gate are
  held to 1e-3 relative on the same spectra in both packages;
* the estimator's factors: a near-tie in the greedy descent's argmax can
  pick another diagonal move in one package (the two FFTs round
  differently), so factors are held to 2 steps (2e-4) unsmoothed, and
  to 2 steps times the 0.05 smoothing after a rate-limited update;
* AGC: the same float32 recurrences in both, to 1e-5 relative;
* filters: float32 sums in another order, >= 80 dB over carried blocks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from iq_tool_tpu import constants as C  # noqa: E402
from iq_tool_tpu.ops import agc as jagc  # noqa: E402
from iq_tool_tpu.ops import filters as jfilters  # noqa: E402
from iq_tool_tpu.ops import iq_balance as jiq  # noqa: E402
from iq_tool_tpu.ops.fir_design import FilterRequest as JaxFilter  # noqa: E402
from iq_tool_tpu.ops.fir_design import design_chain as jax_design  # noqa: E402
from iq_tool_tpu_torch.ops import agc, iq_balance  # noqa: E402
from iq_tool_tpu_torch.ops.filters import StreamingFilter  # noqa: E402
from tests import ref_dsp  # noqa: E402

STEP = C.IQ_EST_STEP


def _t(a):
    return torch.from_numpy(np.array(a))


def _imbalanced(rng, ch, n, g=0.01, phi=0.012):
    """Tones at 0.07 and -0.19 of the rate (inside the estimator's band)
    behind an I/Q imbalance I*(1+g), Q + phi*I, plus noise."""
    k = np.arange(n)
    x = (0.4 * np.exp(2j * np.pi * 0.07 * k) + 0.1 * np.exp(-2j * np.pi * 0.19 * k)
         + 1e-3 * (rng.standard_normal((ch, n)) + 1j * rng.standard_normal((ch, n))))
    return (x.real * (1 + g) + 1j * (x.imag + phi * x.real)).astype(np.complex64)


# ------------------------------------------------------------------ I/Q balance

def test_iq_spectra_utility_and_gate(rng):
    x = _imbalanced(rng, 3, C.IQ_FFT_SIZE)
    w = jiq._window(C.IQ_FFT_SIZE)
    jbase = np.asarray(jiq.tfft.fftshift(jiq.tfft.fft(w * x)))
    jimage = np.asarray(jiq.tfft.fftshift(jiq.tfft.fft(w * np.real(x))))
    base, image = iq_balance._spectra(_t(x))
    peak = np.abs(jbase).max()
    assert np.abs(base.numpy() - jbase).max() <= 1e-5 * peak
    assert np.abs(image.numpy() - jimage).max() <= 1e-5 * peak
    g = (rng.standard_normal((4, 3)) * 0.01).astype(np.float32)
    phi = (rng.standard_normal((4, 3)) * 0.01).astype(np.float32)
    jspec = np.asarray(jiq._spectrum_db(jnp.asarray(jbase), jnp.asarray(jimage),
                                        jnp.asarray(g), jnp.asarray(phi)))
    spec = iq_balance._spectrum_db(_t(jbase), _t(jimage), _t(g), _t(phi)).numpy()
    np.testing.assert_allclose(spec, jspec, rtol=0, atol=1e-3)       # dB
    np.testing.assert_allclose(iq_balance._utility(_t(jspec)).numpy(),
                               np.asarray(jiq._utility(jnp.asarray(jspec))), rtol=1e-3)
    np.testing.assert_allclose(iq_balance._power_gate(_t(jspec)).numpy(),
                               np.asarray(jiq._power_gate(jnp.asarray(jspec))),
                               rtol=1e-3)


def test_iq_maybe_update_and_calibrate(rng):
    ch, n = 3, 4096
    x = _imbalanced(rng, ch, n)
    xr, xi = x.real.astype(np.float32), x.imag.astype(np.float32)
    interval = 1000
    jstate = jiq.init(ch)
    state = iq_balance.init(ch)
    for blk in range(3):                 # due, then rate-limited, then due
        adv = 600
        jstate = jiq.maybe_update_planar(jnp.asarray(xr), jnp.asarray(xi), jstate,
                                         interval, advance_samples=adv)
        state = iq_balance.maybe_update_planar(_t(xr), _t(xi), state, interval,
                                               advance_samples=adv)
        assert int(state.samples_since_opt) == int(jstate.samples_since_opt)
        np.testing.assert_allclose(state.factors.numpy(), np.asarray(jstate.factors),
                                   rtol=0, atol=2 * STEP * C.IQ_SMOOTHING * (blk + 1))
    # the estimator moves toward the correction: g < 0, phi < 0
    assert (state.factors.numpy() < 0).all()
    jcal = np.asarray(jiq.calibrate(jnp.asarray(x)))
    cal = iq_balance.calibrate(_t(x)).numpy()
    np.testing.assert_allclose(cal, jcal, rtol=0, atol=2 * STEP)
    # ten rounds of 25 moves take the factors most of the way to the
    # correction (g, phi) = (1/1.01 - 1, -0.012/1.01)
    assert (cal[:, 0] < 0.5 * (1 / 1.01 - 1)).all()
    assert (cal[:, 1] < 0.5 * (-0.012 / 1.01)).all()


def test_iq_gate_and_saturating_counter():
    """Silence fails the power gate: factors stay, the counter saturates
    at 0xF0000000 from the fire-at-once sentinel, as the reference's."""
    z = np.zeros((2, 2048), np.float32)
    jstate = jiq.maybe_update_planar(jnp.asarray(z), jnp.asarray(z), jiq.init(2), 10)
    state = iq_balance.maybe_update_planar(_t(z), _t(z), iq_balance.init(2), 10)
    assert int(state.samples_since_opt) == int(jstate.samples_since_opt) == 0xF0000000
    assert not state.factors.numpy().any()
    assert iq_balance.reset(state) is state            # factors survive a reset


# ------------------------------------------------------------------------- AGC

@pytest.mark.parametrize("profile", ["dx", "local", "digital"])
def test_agc_over_blocks(rng, profile):
    """Several blocks: a quiet start, a jump and a ragged block (the RMS
    tail takes the final gain); the digital profile locks after its scan."""
    rate = 48_000.0
    jcfg = jagc.AgcConfig.make(profile, rate)
    cfg = agc.AgcConfig.make(profile, rate)
    assert (cfg.profile, cfg.target) == (jcfg.profile, jcfg.target)
    ch = 3
    jst, st = jagc.init(ch), agc.init(ch)
    for level, n in ((0.01, 4096), (0.6, 4096), (0.3, 128 * 30 + 77),
                     (0.05, 48_000), (0.05, 48_000), (1.5, 4096)):
        x = (level * (rng.standard_normal((ch, n)) + 1j * rng.standard_normal((ch, n)))
             ).astype(np.complex64)
        xr, xi = x.real, x.imag
        jyr, jyi, jst = jagc.apply_planar(jnp.asarray(xr), jnp.asarray(xi), jst, jcfg)
        yr, yi, st = agc.apply_planar(_t(xr), _t(xi), st, cfg)
        for a, b in ((yr, jyr), (yi, jyi)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
        for f in ("gain", "e2", "peak_mem"):
            np.testing.assert_allclose(getattr(st, f).numpy(),
                                       np.asarray(getattr(jst, f)), rtol=1e-5)
        for f in ("locked", "samples_seen", "weak_run"):
            np.testing.assert_array_equal(getattr(st, f).numpy(),
                                          np.asarray(getattr(jst, f)))
    if profile == "digital":
        assert st.locked.numpy().all()
    fresh = agc.reset(st)
    assert float(fresh.gain[0]) == 1.0 and not fresh.locked.numpy().any()


# --------------------------------------------------------------------- filters

def _taps(kind, n_taps=None, rate=1_488_375.0):
    reqs = {"notch": [JaxFilter("stop-range", 0.0, 10e3)],
            "lowpass": [JaxFilter("lowpass", 300e3)],
            "band": [JaxFilter("pass-range", 150e3, 200e3)]}[kind]
    return jax_design(reqs, rate, 60.0, n_taps, None).taps


@pytest.mark.parametrize("case", [("lowpass", "fir", None, 4096),
                                  ("band", "fft", 75, 4096),
                                  ("notch", "auto", None, 11907),
                                  ("lowpass", "fft", 3001, 3 * 8192)],
                         ids=["fir-banded", "fft-banded-complex",
                              "overlap-save-3/4-and-tail", "overlap-save-exact"])
def test_streaming_filter_over_blocks(rng, case):
    kind, method, n_taps, n = case
    taps = _taps(kind, n_taps)
    jf, f = jfilters.StreamingFilter(taps, method), StreamingFilter(taps, method)
    assert (f.method, f.block, f._exec_banded) == (jf.method, jf.block, jf._exec_banded)
    if kind == "notch":
        assert (len(taps), f._exec_banded, f.block) == (2175, False, 8192)
    ch = 2
    js = jf.init_planar(ch)
    ps = f.init_planar(ch)
    for _ in range(3):
        x = (0.3 * (rng.standard_normal((ch, n)) + 1j * rng.standard_normal((ch, n)))
             ).astype(np.complex64)
        jy = jf.apply_planar(jnp.asarray(x.real), jnp.asarray(x.imag), *js)
        y = f.apply_planar(_t(x.real), _t(x.imag), *ps)
        js, ps = jy[2:], y[2:]
        want = np.asarray(jy[0]) + 1j * np.asarray(jy[1])
        got = y[0].numpy() + 1j * y[1].numpy()
        assert ref_dsp.snr_db(want.ravel(), got.ravel()) >= 80.0
        for a, b in zip(ps, js):                        # carried tails: exact copies
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_streaming_filter_single_tap_and_packed(rng):
    f = StreamingFilter(np.array([0.5 - 0.25j], np.complex64), "fir")
    x = rng.standard_normal((2, 64)).astype(np.float32)
    yr, yi, _, _ = f.apply_planar(_t(x), _t(x), *f.init_planar(2))
    np.testing.assert_allclose(yr.numpy(), 0.75 * x, rtol=1e-6)
    np.testing.assert_allclose(yi.numpy(), 0.25 * x, rtol=1e-6)
    assert f.apply_planar_packed(_t(x), _t(x), *f.init_planar(2)) is None
    osf = StreamingFilter(_taps("notch"), "auto")
    assert osf.apply_planar_packed(_t(x), _t(x), *osf.init_planar(2)) is None
    fir = StreamingFilter(_taps("lowpass"), "fir")
    st = fir.init_planar(2)
    packed, _, _ = fir.apply_planar_packed(_t(x), _t(x), *st, out_fmt="cs16")
    from iq_tool_tpu_torch.ops import convert
    yr, yi, _, _ = fir.apply_planar(_t(x), _t(x), *st)
    np.testing.assert_array_equal(convert.packed_to_wire(packed, "cs16").numpy(),
                                  convert.from_planar(yr, yi, "cs16").numpy())
