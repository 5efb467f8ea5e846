"""FIR filter design (setup-time, numpy).

A copy of ``iq_tool_tpu.ops.fir_design``'s Kaiser design: that module
is numpy-only, but importing it runs ``iq_tool_tpu/ops/__init__.py``,
which imports jax.  The port's designed taps must equal the reference's
bit for bit (the chain tests compare the composed resampler matrices
with ``np.array_equal``), so every formula and operation order here is
the reference's, the overlap-save block sizing included.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

from iq_tool_tpu_torch import constants as C

FilterType = Literal["lowpass", "highpass", "pass-range", "stop-range"]


@dataclasses.dataclass(frozen=True)
class FilterRequest:
    """One user filter request (CLI: --lowpass/--highpass/--pass-range/...).

    freq1_hz: cutoff (low/highpass) or center (pass/stop-range)
    freq2_hz: width for pass/stop-range
    """
    type: FilterType
    freq1_hz: float
    freq2_hz: float = 0.0


def kaiser_beta(atten_db: float) -> float:
    a = float(atten_db)
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a > 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def estimate_taps(transition_norm: float, atten_db: float) -> int:
    """Kaiser tap-count estimate: N ~= (A - 7.95) / (14.26 * df)."""
    df = max(float(transition_norm), 1e-9)
    n = int(np.ceil((float(atten_db) - 7.95) / (14.26 * df)))
    return max(n, 1)


def kaiser_lowpass(num_taps: int, fc_norm: float, atten_db: float,
                   mu: float = 0.0) -> np.ndarray:
    """Windowed sinc with cutoff fc_norm in cycles/sample (0 .. 0.5)."""
    n = int(num_taps)
    beta = kaiser_beta(atten_db)
    t = np.arange(n, dtype=np.float64) - (n - 1) / 2.0 + mu
    h = 2.0 * fc_norm * np.sinc(2.0 * fc_norm * t)
    w = np.kaiser(n, beta)
    return (h * w).astype(np.float64)


def spectral_invert(taps: np.ndarray) -> np.ndarray:
    """Negate, +1 at the center tap."""
    out = -taps.copy()
    out[(len(out) - 1) // 2] += 1.0
    return out


def design_request(req: FilterRequest, sample_rate: float, atten_db: float,
                   num_taps: int | None = None,
                   transition_hz: float | None = None) -> np.ndarray:
    """Design one stage's taps (complex128)."""
    fs = float(sample_rate)
    if num_taps is None:
        if transition_hz is None:
            ref = (req.freq1_hz if req.type in ("lowpass", "highpass")
                   else req.freq2_hz)
            transition_hz = abs(ref) * 0.25  # DEFAULT_FILTER_TRANSITION_FACTOR
        transition_hz = max(transition_hz, 1.0)
        n = estimate_taps(transition_hz / fs, atten_db)
        if n % 2 == 0:
            n += 1
        n = max(n, C.FILTER_MIN_TAPS)
    else:
        # odd lengths only: spectral inversion needs an exact center tap
        n = int(num_taps)
        if n % 2 == 0:
            n += 1

    if req.type in ("pass-range", "stop-range") and abs(req.freq1_hz) > 1e-9:
        # off-center band: heterodyne a real LPF prototype to the center,
        # phase ramp referenced to the center tap so H(fc) stays real and
        # positive (spectral inversion below relies on it)
        half_bw = (req.freq2_hz / 2.0) / fs
        proto = kaiser_lowpass(n, half_bw, atten_db)
        fc = req.freq1_hz / fs
        ph = 2.0 * np.pi * fc * (np.arange(n) - (n - 1) / 2.0)
        taps = proto * np.exp(1j * ph)
        if req.type == "stop-range":
            taps = -taps
            taps[(n - 1) // 2] += 1.0
        return taps

    if req.type == "lowpass":
        taps = kaiser_lowpass(n, req.freq1_hz / fs, atten_db)
    elif req.type == "highpass":
        taps = spectral_invert(kaiser_lowpass(n, req.freq1_hz / fs, atten_db))
    elif req.type == "pass-range":   # centered at 0
        taps = kaiser_lowpass(n, (req.freq2_hz / 2.0) / fs, atten_db)
    elif req.type == "stop-range":
        taps = spectral_invert(kaiser_lowpass(n, (req.freq2_hz / 2.0) / fs, atten_db))
    else:
        raise ValueError(f"unknown filter type {req.type!r}")
    return taps.astype(np.complex128)


@dataclasses.dataclass(frozen=True)
class DesignedFilter:
    taps: np.ndarray          # complex64 master taps
    is_complex: bool          # any asymmetric stage
    normalize_by_peak: bool


def design_chain(requests: list[FilterRequest], sample_rate: float,
                 atten_db: float = C.RESAMPLER_ATTENUATION_DB,
                 num_taps: int | None = None,
                 transition_hz: float | None = None) -> DesignedFilter | None:
    """Combine up to FILTER_MAX_CHAIN requests into master taps."""
    if not requests:
        return None
    if len(requests) > C.FILTER_MAX_CHAIN:
        raise ValueError(f"at most {C.FILTER_MAX_CHAIN} chained filters")

    master = np.array([1.0 + 0j])
    normalize_by_peak = False
    is_complex = False
    for req in requests:
        if req.type != "lowpass":
            normalize_by_peak = True
        if req.type in ("pass-range", "stop-range") and abs(req.freq1_hz) > 1e-9:
            is_complex = True
        taps = design_request(req, sample_rate, atten_db, num_taps, transition_hz)
        master = np.convolve(master, taps)

    if normalize_by_peak or is_complex:
        # peak |H| over the frequency grid
        k = np.arange(C.FILTER_NORM_FREQ_POINTS)
        freqs = k / C.FILTER_NORM_FREQ_POINTS - 0.5
        ph = np.exp(-2j * np.pi * np.outer(freqs, np.arange(len(master))))
        mags = np.abs(ph @ master)
        peak = mags.max()
        if peak > 1e-9:
            master = master / peak
    else:
        dc = np.real(master).sum()
        if abs(dc) > 1e-9:
            master = master / dc

    return DesignedFilter(taps=master.astype(np.complex64),
                          is_complex=is_complex,
                          normalize_by_peak=normalize_by_peak)


def max_filter_freq_hz(requests: list[FilterRequest]) -> float:
    """Highest frequency any stage needs."""
    mx = 0.0
    for req in requests:
        if req.type in ("lowpass", "highpass"):
            cur = abs(req.freq1_hz)
        else:
            cur = abs(req.freq1_hz) + req.freq2_hz / 2.0
        mx = max(mx, cur)
    return mx


def choose_fft_block(num_taps: int, user_fft_size: int | None = None) -> int:
    """Overlap-save block size b (outputs per window; the FFT is 2b):
    the next power of two >= taps - 1, doubled if under 2 * taps, at least
    FFT_MIN_BLOCK; a user FFT size overrides.  The doubling guarantees
    b/2 >= taps - 1, which the 3/4-window advance relies on."""
    if user_fft_size is not None and user_fft_size > 0:
        block = user_fft_size // 2
        if block < num_taps - 1:
            raise ValueError(
                f"--filter-fft-size {user_fft_size} too small for {num_taps} taps; "
                f"need at least {(num_taps - 1) * 2}")
        return block
    block = 1
    while block < num_taps - 1:
        block *= 2
    if block < num_taps * 2:
        block *= 2
    return max(block, C.FFT_MIN_BLOCK)
