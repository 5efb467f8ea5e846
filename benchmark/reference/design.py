"""Filter and resampler design, frozen for the benchmark's reference.

A copy of the design half of the port's ``ops/fir_design.py`` and
``ops/resample.py`` (numpy only, run once a configuration), kept here so
that the reference works the design out again without importing the
program: the Kaiser FIR chain, the rational P/Q resampler's stage split
and its per-phase Kaiser-sinc weights, the gather stage of a ratio that
no split stages (written from its equations), and the block framing.  The
weights stay float64 (the program rounds them to float32).  The group
search and the FIR composition are copied too, only so that
``harness/bounds.py`` can count a banded launch's work from the band's
own shape.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import numpy as np

# the numeric contracts the design and the chain use (the port's
# constants.py, which mirrors the upstream tool's constants.h)
RESAMPLER_ATTENUATION_DB = 60.0
DC_BLOCK_CUTOFF_HZ = 10.0
FILTER_MIN_TAPS = 21
FILTER_MAX_CHAIN = 5
FILTER_NORM_FREQ_POINTS = 2048
RESAMPLE_RATIO_MIN = 0.001
RESAMPLE_RATIO_MAX = 1000.0
RESAMP_SEMILENGTH = 16
RESAMP_FC_FACTOR = 0.90
RESAMP_MAX_DENOM = 65536
RESAMP_STAGE_MAX = 512
RESAMP_GROUP_CAP = 256
FFT_MIN_BLOCK = 2048
FUSE_MAX_TAPS = 256
FIR_MAX_TAPS = 1024            # "auto" filters above this run overlap-save
FFT_BANDED_MAX_TAPS = 2048     # FFT-method filters up to this run banded
BANDED_STRIDE_CAP = 256        # a banded filter pass's output group
IQ_FFT_SIZE = 1024
IQ_UPDATE_INTERVAL_SEC = 0.5
IQ_EST_STEP = 1e-4
IQ_SMOOTHING = 0.05
IQ_POWER_GATE_DB = 20.0
IQ_SPECTRUM_FLOOR_DB = -80.0
IQ_BAND_LO = 0.05
IQ_BAND_HI = 0.95
IQ_PASSES = 25
AGC_TARGET = 0.5
AGC_BW_DX = 1e-4
AGC_BW_LOCAL = 1e-2
AGC_SEGMENT = 128
# the digital profile's block state machine (upstream agc.c, the port's
# constants.py): scan the block peaks for 2 s of output at the gain
# target / peak memory, then lock; once locked, a block whose output
# peak passes 1 ratchets the gain to 0.99 / peak, and after 4 s of
# blocks under 0.75 of the target the gain creeps up a block at a time
AGC_DIGITAL_TARGET = 0.9
AGC_DIGITAL_PEAK_INIT = 0.05     # the scan's peak memory at the stream's start
AGC_DIGITAL_PEAK_FLOOR = 1e-4    # the least peak memory the scan's gain divides by
AGC_DIGITAL_SCAN_SEC = 2.0
AGC_DIGITAL_HANG_SEC = 4.0
AGC_DIGITAL_CLIP_RATCHET = 0.99
AGC_DIGITAL_RATCHET_FLOOR = 1e-9
AGC_DIGITAL_CREEP = 1.0005
AGC_DIGITAL_CREEP_THRESH = 0.75


# ------------------------------------------------------------------ FIR chain

def kaiser_beta(atten_db: float) -> float:
    a = float(atten_db)
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a > 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def estimate_taps(transition_norm: float, atten_db: float) -> int:
    df = max(float(transition_norm), 1e-9)
    return max(int(np.ceil((float(atten_db) - 7.95) / (14.26 * df))), 1)


def kaiser_lowpass(num_taps: int, fc_norm: float, atten_db: float) -> np.ndarray:
    n = int(num_taps)
    t = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    return 2.0 * fc_norm * np.sinc(2.0 * fc_norm * t) * np.kaiser(n, kaiser_beta(atten_db))


def spectral_invert(taps: np.ndarray) -> np.ndarray:
    out = -taps.copy()
    out[(len(out) - 1) // 2] += 1.0
    return out


def design_request(kind: str, f1: float, f2: float, fs: float, atten_db: float,
                   num_taps: int | None = None,
                   transition_hz: float | None = None) -> np.ndarray:
    """One filter request's taps (complex128): lowpass/highpass at f1,
    pass-range/stop-range centred at f1, f2 wide."""
    if num_taps is None:
        if transition_hz is None:
            ref = f1 if kind in ("lowpass", "highpass") else f2
            transition_hz = abs(ref) * 0.25
        transition_hz = max(transition_hz, 1.0)
        n = estimate_taps(transition_hz / fs, atten_db)
        n += 1 - n % 2
        n = max(n, FILTER_MIN_TAPS)
    else:
        n = int(num_taps)
        n += 1 - n % 2
    if kind in ("pass-range", "stop-range") and abs(f1) > 1e-9:
        proto = kaiser_lowpass(n, (f2 / 2.0) / fs, atten_db)
        ph = 2.0 * np.pi * (f1 / fs) * (np.arange(n) - (n - 1) / 2.0)
        taps = proto * np.exp(1j * ph)
        if kind == "stop-range":
            taps = -taps
            taps[(n - 1) // 2] += 1.0
        return taps
    if kind == "lowpass":
        taps = kaiser_lowpass(n, f1 / fs, atten_db)
    elif kind == "highpass":
        taps = spectral_invert(kaiser_lowpass(n, f1 / fs, atten_db))
    elif kind == "pass-range":
        taps = kaiser_lowpass(n, (f2 / 2.0) / fs, atten_db)
    elif kind == "stop-range":
        taps = spectral_invert(kaiser_lowpass(n, (f2 / 2.0) / fs, atten_db))
    else:
        raise ValueError(f"unknown filter type {kind!r}")
    return taps.astype(np.complex128)


def design_chain(requests, fs: float, atten_db: float = RESAMPLER_ATTENUATION_DB,
                 num_taps: int | None = None,
                 transition_hz: float | None = None) -> np.ndarray:
    """The master taps (complex128) of up to five chained requests, each
    (kind, f1, f2): normalised by the peak |H| over a 2048-point grid when
    any request is not a lowpass or is off-centre, else by the DC gain."""
    if len(requests) > FILTER_MAX_CHAIN:
        raise ValueError(f"at most {FILTER_MAX_CHAIN} chained filters")
    master = np.array([1.0 + 0j])
    by_peak = False
    for kind, f1, f2 in requests:
        by_peak |= kind != "lowpass" or (kind in ("pass-range", "stop-range")
                                         and abs(f1) > 1e-9)
        master = np.convolve(master, design_request(kind, f1, f2, fs, atten_db,
                                                    num_taps, transition_hz))
    if by_peak:
        freqs = np.arange(FILTER_NORM_FREQ_POINTS) / FILTER_NORM_FREQ_POINTS - 0.5
        ph = np.exp(-2j * np.pi * np.outer(freqs, np.arange(len(master))))
        peak = np.abs(ph @ master).max()
        if peak > 1e-9:
            master = master / peak
    else:
        dc = np.real(master).sum()
        if abs(dc) > 1e-9:
            master = master / dc
    return master


def max_filter_freq_hz(requests) -> float:
    return max((abs(f1) if kind in ("lowpass", "highpass") else abs(f1) + f2 / 2.0)
               for kind, f1, f2 in requests)


def choose_fft_block(num_taps: int, user_fft_size: int | None = None) -> int:
    """Overlap-save block b (the FFT is 2b): the next power of two >= taps
    - 1, doubled if under 2 * taps, at least FFT_MIN_BLOCK."""
    if user_fft_size:
        return user_fft_size // 2
    block = 1
    while block < num_taps - 1:
        block *= 2
    if block < num_taps * 2:
        block *= 2
    return max(block, FFT_MIN_BLOCK)


# ----------------------------------------------------------------- resampler

def rationalize(ratio: float, max_denom: int = RESAMP_MAX_DENOM) -> tuple[int, int]:
    if not (RESAMPLE_RATIO_MIN <= ratio <= RESAMPLE_RATIO_MAX):
        raise ValueError(f"resample ratio {ratio} out of range")
    fr = Fraction(ratio).limit_denominator(max_denom)
    return fr.numerator, fr.denominator


def _prime_factors(n: int) -> list[int]:
    out, d = [], 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return sorted(out, reverse=True)


def decompose_stages(p: int, q: int, max_factor: int = RESAMP_STAGE_MAX):
    """P/Q split into stage ratios (p_i, q_i), each <= max_factor, sorted
    by descending ratio; None when a prime factor is too large."""
    pf, qf = _prime_factors(p), _prime_factors(q)
    if (pf and pf[0] > max_factor) or (qf and qf[0] > max_factor):
        return None
    stages = []
    while pf or qf:
        pi = 1
        while pf and pi * pf[0] <= max_factor:
            pi *= pf.pop(0)
        qi = 1
        while qf and qi * qf[0] <= max_factor and pi / (qi * qf[0]) >= 0.45:
            qi *= qf.pop(0)
        if pi == 1 and qi == 1 and qf:
            qi = qf.pop(0)
        if pi == 1 and qi == 1:
            break
        stages.append((pi, qi))
    stages.sort(key=lambda s: s[0] / s[1], reverse=True)
    return stages


def _sinc_kernel(t: np.ndarray, fc: float, semilen: int, beta: float) -> np.ndarray:
    w_arg = 1.0 - (t / semilen) ** 2
    w = np.where(w_arg > 0, np.i0(beta * np.sqrt(np.maximum(w_arg, 0.0))), 0.0) / np.i0(beta)
    return np.where(np.abs(t) <= semilen, 2.0 * fc * np.sinc(2.0 * fc * t) * w, 0.0)


@dataclasses.dataclass(frozen=True)
class Stage:
    """One p/q polyphase stage: output j (in stage-output time) is the dot
    of weights[j % p] with the 2m inputs from input index
    first[j % p] + (j // p) * q on, counting the stage's input from the
    stream's start (earlier inputs are zero)."""
    p: int
    q: int
    m: int                   # semilength in input samples
    weights: np.ndarray      # (p, 2m) float64, each row sums to 1
    first: np.ndarray        # (p,) int64, may be negative


def make_stage(p: int, q: int, atten_db: float = RESAMPLER_ATTENUATION_DB,
               semilength: int = RESAMP_SEMILENGTH) -> Stage:
    """The stage's per-phase weights: a Kaiser-windowed sinc at each
    phase's fractional delay, cut off at 0.9 of the lower Nyquist,
    normalised to unity DC gain per phase, delayed by m inputs."""
    m = max(semilength, int(np.ceil(semilength * q / (2.0 * p))))
    beta = kaiser_beta(atten_db)
    fc = 0.5 * min(1.0, p / q) * RESAMP_FC_FACTOR
    j = np.arange(p, dtype=np.float64)
    tau = j * q / p - m
    base = np.floor(tau).astype(np.int64)
    frac = tau - base
    k = np.arange(2 * m, dtype=np.float64)
    w = _sinc_kernel(frac[:, None] + (m - 1) - k[None, :], fc, m, beta)
    w = w / np.sum(w, axis=1, keepdims=True)
    return Stage(p, q, m, w, base - m + 1)


@dataclasses.dataclass(frozen=True)
class Gather:
    """The gather stage of a ratio p/q that no split into small stages
    gives (a prime factor above RESAMP_STAGE_MAX): output j of a block
    is the dot of weights[j] with the 2m inputs from starts[j] on, over
    the 2m - 1 inputs of history followed by the block's n_in inputs.
    The outputs' delays repeat every n_in inputs (n_in is a multiple of
    q), so the next block takes the same weights and starts."""
    p: int
    q: int
    m: int                   # semilength in input samples
    weights: np.ndarray      # (n_out, 2m) float64, each row sums to 1
    starts: np.ndarray       # (n_out,) int64, into history ++ block


def make_gather(p: int, q: int, n_in: int, atten_db: float = RESAMPLER_ATTENUATION_DB,
                semilength: int = RESAMP_SEMILENGTH) -> Gather:
    """Output j at input time j q / p - m: 2m Kaiser-windowed sinc taps at
    its fractional delay, cut off at 0.9 of the lower Nyquist, normalised
    to unity DC gain, the semilength widened with the decimation."""
    m = max(semilength, int(np.ceil(semilength * q / (2.0 * p))))
    beta = kaiser_beta(atten_db)
    fc = 0.5 * min(1.0, p / q) * RESAMP_FC_FACTOR
    j = np.arange(n_in * p // q, dtype=np.float64)
    tau = j * q / p - m
    base = np.floor(tau).astype(np.int64)
    k = np.arange(2 * m, dtype=np.float64)
    w = _sinc_kernel((tau - base)[:, None] + (m - 1) - k[None, :], fc, m, beta)
    w = w / np.sum(w, axis=1, keepdims=True)
    starts = base - m + 1 + (2 * m - 1)
    if starts.min() < 0 or starts.max() + 2 * m > n_in + 2 * m - 1:
        raise ValueError(f"the gather stage {p}/{q} reaches outside its block")
    return Gather(p, q, m, w, starts)


@dataclasses.dataclass(frozen=True)
class ResamplePlan:
    p: int
    q: int
    n_in: int
    n_out: int
    stages: tuple          # of Stage, or one Gather


def plan_resampler(ratio: float, target_block: int,
                   atten_db: float = RESAMPLER_ATTENUATION_DB,
                   max_out: int = 1 << 21) -> ResamplePlan:
    """The stream's framing (blocks of n_in inputs give n_out outputs) and
    its stages: the split into small p/q stages, or one gather stage
    where a prime factor of p or q is too large to split."""
    p, q = rationalize(ratio)
    ratios = decompose_stages(p, q)
    blocks = max(1, round(target_block / q))
    while blocks * p > max_out and blocks > 1:
        blocks -= 1
    n_in = blocks * q
    if ratios is None:
        stages = (make_gather(p, q, n_in, atten_db),)
    else:
        stages = tuple(make_stage(a, b, atten_db) for a, b in ratios)
    return ResamplePlan(p, q, n_in, n_in * p // q, stages)


# ------------------------------------------------- banded shapes (for bounds)

def group_stride(p: int, q: int, n_in: int, group_cap: int = RESAMP_GROUP_CAP) -> int:
    """The group g of a banded stage over an n_in block (windows of g*q
    inputs give g*p outputs): the largest divisor of n_in/q under the cap
    whose stride is lane-aligned (128, then 16, then any)."""
    nb_total = n_in // q
    cap = max(1, group_cap // max(p, q))
    for align in (128, 16, 1):
        for d in range(cap, 0, -1):
            if nb_total % d == 0 and (d * q) % align == 0:
                return d
    return 1


def banded_matrix(stage: Stage, g: int) -> np.ndarray:
    """The stage as a banded matrix A[L, g*p] over windows of L = g*q +
    2m - 1 inputs (the last 2m - 1 of the previous window first)."""
    hist = 2 * stage.m - 1
    a = np.zeros((g * stage.q + hist, g * stage.p))
    for i in range(g * stage.p):
        s = stage.first[i % stage.p] + (i // stage.p) * stage.q + hist
        a[s:s + 2 * stage.m, i] = stage.weights[i % stage.p]
    return a


def compose_output_fir(a: np.ndarray, stride: int, taps: np.ndarray) -> np.ndarray:
    """A with an FIR after it folded in: the window grows left by
    ceil((K-1)/G) strides."""
    k = len(taps)
    l_old, gg = a.shape
    ext = -(-(k - 1) // gg) * stride
    out = np.zeros((l_old + ext, gg), np.complex128)
    for j in range(k):
        for i in range(gg):
            d, r = divmod(i - j, gg)
            out[ext + d * stride:ext + d * stride + l_old, i] += taps[j] * a[:, r]
    return out


def largest_divisor_leq(n: int, cap: int) -> int:
    """The largest divisor of n that is at most cap (at least 1)."""
    return next(d for d in range(min(cap, n), 0, -1) if n % d == 0)


def filter_band(taps: np.ndarray, stride: int) -> np.ndarray:
    """A filter pass as a banded matrix T[stride + K - 1, stride]: column i
    the reversed taps at rows i .. i + K - 1, after the K - 1 carried
    inputs."""
    k = len(taps)
    t = np.zeros((stride + k - 1, stride), np.complex128)
    for i in range(stride):
        t[i:i + k, i] = taps[::-1]
    return t


def column_span(a: np.ndarray) -> int:
    """The longest run of rows any column of a banded matrix touches."""
    nz = np.abs(a) > 0
    spans = [np.flatnonzero(c) for c in nz.T]
    return max(int(s[-1] - s[0] + 1) for s in spans if len(s))


def freq_to_dtheta(shift_hz: float, rate: float) -> int:
    """A shift as the 32-bit phase increment a sample of the NCO adds."""
    turns = float(shift_hz) / float(rate)
    return int(round((turns - np.floor(turns)) * 4294967296.0)) & 0xFFFFFFFF
