"""I/Q imbalance correction and estimation, the port of
``iq_tool_tpu.ops.iq_balance``.

* apply: I' = (1+g) I, Q' = Q + phi I.
* estimate: Hamming-windowed 1024-point spectra of the corrected signal,
  computed for any (g, phi) from two FFTs taken once (the correction is
  linear in the factors); a greedy descent of 25 passes over the four
  diagonal +-1e-4 moves maximizes the spectral asymmetry; gated on a
  20 dB peak-to-average ratio; rate-limited to every 0.5 s of input;
  smoothed into the active factors with weight 0.05.

The reference runs the estimator under ``lax.cond`` on its device
counter.  On a CUDA tensor the whole estimator of a step is one helper
kernel (``kernels.iq_estimate``, csrc/iq_est.cu): it reads the counter
on the card, so a chain step never reads a device value back to the
host, and on a step that is not due it does no estimator work (one
launch and a ticket).  It also takes the chain's prefix as it lies: the
packed wire or the planes, DC-blocked in the kernel from the carried
state (``maybe_update_planar``).  Its plain twin, on the CPU, runs the estimator on
every step and masks the result (``maybe_update``): the descent
evaluates the 4 candidates of every channel as one batched tensor op per
pass.

The twin rounds as the kernel does, so the two take the same moves on a
near-tie of two candidates (the descent's argmax is discontinuous there):
the spectra are the kernel's 32 x 32 float32 FFT in the same order of
float32 operations (``_fft1024``), the dB spectrum the same float32
operations (no complex product, whose rounding differs between torch's
CPU and CUDA kernels), and each candidate's band sum is taken in the
kernel's fixed reduction tree (``_band_sum``), so equal terms give equal
sums.  On the CPU only hypot and log10 may round otherwise than CUDA's.

The state is a small dataclass of tensors; the counter is int64 holding
the reference's uint32 value, with its saturation.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from iq_tool_tpu_torch import constants as C
from iq_tool_tpu_torch.ops import fft as tfft

_SAT = 0xF0000000
# the 4 diagonal candidate directions
_DIRS = np.array([[1, 1], [1, -1], [-1, 1], [-1, -1]], np.float32)


def _f32(v: float) -> float:
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class IqState:
    factors: torch.Tensor            # (C, 2) float32: [gain, phase]
    samples_since_opt: torch.Tensor  # () int64 holding a uint32, saturating


def init(channels: int, device=None) -> IqState:
    return IqState(
        factors=torch.zeros((channels, 2), dtype=torch.float32, device=device),
        samples_since_opt=torch.tensor(0xFFFFFFFF, dtype=torch.int64,
                                       device=device))   # fire at once


def reset(state: IqState) -> IqState:
    """Discontinuity: learned factors are kept."""
    return state


def apply_planar(xr: torch.Tensor, xi: torch.Tensor, factors: torch.Tensor):
    """I' = (1+g) I, Q' = Q + phi I with (C, 2) factors [g, phi]."""
    g = factors[:, 0:1]
    phi = factors[:, 1:2]
    return xr * (1.0 + g), xi + phi * xr


# The constants below are made once per device: a host-to-device copy
# inside a step would block the host until the card drains its queue.

@functools.lru_cache(maxsize=8)
def _window(n: int, device: str) -> torch.Tensor:
    """The reference's float32 Hamming window (numpy), on `device`."""
    i = np.arange(n, dtype=np.float32)
    w = (0.54 - 0.46 * np.cos(2.0 * np.pi * i / (n - 1))).astype(np.float32)
    return torch.from_numpy(w).to(device)


@functools.lru_cache(maxsize=8)
def _moves(device: str) -> torch.Tensor:
    """The 4 diagonal candidate moves of one descent pass, (4, 2)."""
    return torch.from_numpy(np.float32(C.IQ_EST_STEP) * _DIRS).to(device)


def _brev5(j: int) -> int:
    return int(f"{j:05b}"[::-1], 2)


_BREV5 = [_brev5(j) for j in range(32)]


@functools.lru_cache(maxsize=8)
def _fft_consts(device: str):
    """(w32 re, w32 im, twiddle re, twiddle im) of csrc/iq_est.cu's FFT in
    float32: exp(-2 pi i k / 32), k < 16, with k = 8 exactly -i (the
    kernel's rot32 swaps there), and exp(-2 pi i k / 1024) from float64,
    the table the kernel reads (``kernels._est_consts``)."""
    w = np.exp(-2j * np.pi * np.arange(16) / 32).astype(np.complex64)
    w[8] = -1j
    tw = np.exp(-2j * np.pi * np.arange(C.IQ_FFT_SIZE) / C.IQ_FFT_SIZE).astype(np.complex64)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (w.real, w.imag, tw.real, tw.imag))


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _dft32(xr: torch.Tensor, xi: torch.Tensor, w_r, w_i):
    """csrc/iq_est.cu dft32 along the last axis (32 points): radix-2
    decimation in frequency, entry r ending as X[brev5(r)]."""
    lead = xr.shape[:-1]
    for b in range(4, -1, -1):
        h = 1 << b
        xr = xr.reshape(*lead, 32 // (2 * h), 2, h)
        xi = xi.reshape(*lead, 32 // (2 * h), 2, h)
        ur, vr, ui, vi = xr[..., 0, :], xr[..., 1, :], xi[..., 0, :], xi[..., 1, :]
        k = torch.arange(h, device=xr.device) << (4 - b)
        tr, ti = _cmul(ur - vr, ui - vi, w_r[k], w_i[k])
        xr = torch.stack([ur + vr, tr], dim=-2).reshape(*lead, 32)
        xi = torch.stack([ui + vi, ti], dim=-2).reshape(*lead, 32)
    return xr, xi


def _fft1024(xr: torch.Tensor, xi: torch.Tensor):
    """The 1024-point DFT of (..., 1024) float32 planes as csrc/iq_est.cu
    fft1024 computes it, operation for operation: a 32-point DFT over each
    column j of x[j + 32 n1], the twiddles W_1024^(j k1), a 32-point DFT
    over each row k1; natural order out."""
    w_r, w_i, t_r, t_i = _fft_consts(str(xr.device))
    lead = xr.shape[:-1]
    idx = torch.tensor(_BREV5, device=xr.device)
    jk = (torch.arange(32, device=xr.device)[:, None]
          * torch.arange(32, device=xr.device)[None, :]) & (C.IQ_FFT_SIZE - 1)
    cr, ci = (v.reshape(*lead, 32, 32).transpose(-1, -2) for v in (xr, xi))  # [j, n1]
    cr, ci = _dft32(cr, ci, w_r, w_i)
    cr, ci = _cmul(cr[..., idx], ci[..., idx], t_r[jk], t_i[jk])            # [j, k1]
    rr, ri = _dft32(cr.transpose(-1, -2), ci.transpose(-1, -2), w_r, w_i)   # [k1, r]
    return tuple(v[..., idx].transpose(-1, -2).reshape(*lead, C.IQ_FFT_SIZE)
                 for v in (rr, ri))                                        # [k2, k1]


def _spectrum_db(base: torch.Tensor, image: torch.Tensor, g: torch.Tensor,
                 phi: torch.Tensor) -> torch.Tensor:
    """dB spectrum of the corrected signal from the precomputed shifted
    spectra base = FFT(w x), image = FFT(w Re x); g/phi may carry leading
    batch dims in front of the channel dim.  In float32 operations, as
    the kernel's spec_db: base + (g + i phi) image, then
    20 log10(|.| / nfft + 1e-12)."""
    g, phi = g[..., None], phi[..., None]
    re = base.real + (g * image.real - phi * image.imag)
    im = base.imag + (g * image.imag + phi * image.real)
    mag = torch.hypot(re, im) / _f32(base.shape[-1])
    return 20.0 * torch.log10(mag + 1e-12)


def band_edges(nfft: int) -> tuple[int, int]:
    """[lo, hi): the utility band's bins below the centre of a shifted
    nfft-point spectrum; its mirror image lies at nfft - hi .. nfft - lo."""
    half = nfft // 2
    return int(C.IQ_BAND_LO * half), int(C.IQ_BAND_HI * half)


def _band(spec_db: torch.Tensor):
    """(p_pos, p_neg): the utility band and its mirror image."""
    nfft = spec_db.shape[-1]
    lo, hi = band_edges(nfft)
    p_neg = spec_db[..., lo:hi]
    p_pos = torch.flip(spec_db[..., nfft - hi: nfft - lo], dims=(-1,))
    return p_pos, p_neg


def _band_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the band (last axis, at most 512 bins) in the order of
    csrc/iq_est.cu cta_sum4 with bin t on thread t: within each warp of 32
    bins the halving tree (t + 16, then + 8, 4, 2, 1), then the 16 warp
    sums in pairs (2i, 2i + 1) and their halving tree."""
    v = torch.nn.functional.pad(v, (0, 512 - v.shape[-1]))
    v = v.reshape(*v.shape[:-1], 16, 32)
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off] + v[..., off:2 * off]
    w = v[..., 0]
    w = w[..., 0::2] + w[..., 1::2]
    for off in (4, 2, 1):
        w = w[..., :off] + w[..., off:2 * off]
    return w[..., 0]


def _utility(spec_db: torch.Tensor) -> torch.Tensor:
    """Sum over the band of (P(+f) - P(-f))^2 where either side is above
    the -80 dB floor (to be maximized), summed by ``_band_sum``."""
    p_pos, p_neg = _band(spec_db)
    d = p_pos - p_neg
    mask = (p_pos > C.IQ_SPECTRUM_FLOOR_DB) | (p_neg > C.IQ_SPECTRUM_FLOOR_DB)
    return _band_sum(torch.where(mask, d * d, 0.0))


def _power_gate(spec_db: torch.Tensor) -> torch.Tensor:
    """Peak-to-average ratio over the utility band, in dB (the band's sums
    by ``_band_sum``)."""
    p_pos, p_neg = _band(spec_db)
    n_band = p_pos.shape[-1]
    mx = torch.maximum(p_pos.amax(dim=-1), p_neg.amax(dim=-1))
    return mx - (_band_sum(p_pos) + _band_sum(p_neg)) / (2.0 * n_band)


def _spectra(x: torch.Tensor):
    """(base, image) shifted spectra of the windowed (C, nfft) block, by
    the kernel's FFT (``_fft1024``)."""
    w = _window(x.shape[-1], str(x.device))
    wr, wi = w * x.real, w * x.imag
    return (tfft.fftshift(torch.complex(*_fft1024(wr, wi))),
            tfft.fftshift(torch.complex(*_fft1024(wr, torch.zeros_like(wi)))))


def _optimize_core(base: torch.Tensor, image: torch.Tensor,
                   factors: torch.Tensor, passes: int = 25) -> torch.Tensor:
    """The greedy descent for every channel at once: base/image (C, nfft),
    factors (C, 2) -> new (C, 2) factors (unsmoothed).  A pass takes the
    first candidate of the largest utility, if it beats the current one;
    so does the kernel."""
    ch = factors.shape[0]
    step = _moves(str(factors.device))
    rows = torch.arange(ch, device=factors.device)
    cur = factors
    cur_u = _utility(_spectrum_db(base, image, cur[:, 0], cur[:, 1]))
    for _ in range(passes):
        cands = cur[None, :, :] + step[:, None, :]                 # (4, C, 2)
        us = _utility(_spectrum_db(base, image, cands[..., 0], cands[..., 1]))
        best, better = _best_move(us, cur_u)
        cur = torch.where(better[:, None], cands[best, rows], cur)
        cur_u = torch.where(better, us[best, rows], cur_u)
    return cur


def _best_move(us: torch.Tensor, cur_u: torch.Tensor):
    """A pass's rule on (4, C) candidate utilities: (C,) the first
    candidate of the largest utility, and whether it beats ``cur_u``."""
    best = torch.argmax(us, dim=0)
    return best, us[best, torch.arange(us.shape[1], device=us.device)] > cur_u


def maybe_update_planar(xr, xi, state: IqState, interval_samples: int,
                        passes: int = 25, advance_samples: int | None = None, *,
                        dc_state=None, dc_alpha: float = 0.0, wire_i32=None,
                        wire_norm: float = 0.0, wire_gain: float = 1.0,
                        wire_kind: str = "cs16") -> IqState:
    """The estimator of one step on the block's prefix (its first
    IQ_FFT_SIZE frames): the float32 (C, N) planes xr/xi or, in their
    place, the packed wire ``wire_i32``, DC-blocked from ``dc_state`` when
    one is given (``kernels.iq_estimate``).  The counter advances by N
    unless ``advance_samples`` says otherwise."""
    from iq_tool_tpu_torch.ops import kernels
    src = wire_i32 if wire_i32 is not None else xr
    factors, counter, _ = kernels.iq_estimate(
        xr, xi, state.factors, state.samples_since_opt, interval_samples,
        src.shape[-1] if advance_samples is None else advance_samples, dc_state,
        dc_alpha, wire_i32, wire_norm, wire_gain, wire_kind, passes)
    return IqState(factors=factors, samples_since_opt=counter)


def _update(x: torch.Tensor, state: IqState, interval_samples: int, passes: int,
            advance_samples: int):
    """maybe_update's body: (new state, (C,) gate dB, computed due or not)."""
    from iq_tool_tpu_torch.ops import kernels
    nfft = C.IQ_FFT_SIZE
    n = x.shape[-1]
    seg = x[:, :nfft] if n >= nfft else torch.cat(
        [x, torch.zeros((x.shape[0], nfft - n), dtype=x.dtype, device=x.device)],
        dim=-1)
    counter = state.samples_since_opt
    due = counter >= int(interval_samples)
    factors = state.factors
    new_raw, gate_db = kernels.iq_descent_ref(*_spectra(seg), factors, passes)
    gate = gate_db >= C.IQ_POWER_GATE_DB                             # (C,)
    sm = _f32(C.IQ_SMOOTHING)
    smoothed = _f32(1.0 - sm) * factors + sm * new_raw
    new_factors = torch.where((due & gate)[:, None], smoothed, factors)
    ran = due & gate.any()
    adv = int(advance_samples)
    new_counter = torch.where(ran, torch.zeros_like(counter),
                              torch.clamp(torch.clamp(counter, max=_SAT) + adv,
                                          max=_SAT))
    return IqState(factors=new_factors, samples_since_opt=new_counter), gate_db


def maybe_update(x: torch.Tensor, state: IqState, interval_samples: int,
                 passes: int = 25, advance_samples: int | None = None) -> IqState:
    """The rate-limited, power-gated estimator on a (C, N) complex64 block
    (the pre-correction signal; its first IQ_FFT_SIZE samples are used),
    in tensor ops on any device: the kernel's plain twin, which runs the
    estimator whether or not an update is due and masks its result."""
    adv = x.shape[-1] if advance_samples is None else advance_samples
    return _update(x, state, interval_samples, passes, adv)[0]


def calibrate(x: torch.Tensor, rounds: int = 10, passes: int = 25) -> torch.Tensor:
    """Synchronous pre-stream calibration (files): (C, nfft) complex64 ->
    (C, 2) factors after several unsmoothed descent rounds from zero.  On
    a CUDA tensor the rounds are one estimator launch of rounds x passes
    passes (a round starts where the last ended, at its utility), which
    takes a full IQ_FFT_SIZE block."""
    from iq_tool_tpu_torch.ops import kernels
    x = x[:, :C.IQ_FFT_SIZE].to(torch.complex64)
    factors = torch.zeros((x.shape[0], 2), dtype=torch.float32, device=x.device)
    if x.device.type == "cpu":
        base, image = _spectra(x)
        for _ in range(rounds):
            factors, _ = kernels.iq_descent_ref(base, image, factors, passes)
        return factors
    if x.shape[-1] != C.IQ_FFT_SIZE:
        raise ValueError(f"calibration on the card takes {C.IQ_FFT_SIZE} frames, "
                         f"got {x.shape[-1]}")
    return kernels.iq_estimate(x.real, x.imag, factors, None,
                               passes=rounds * passes)[0]
