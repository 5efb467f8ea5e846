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
counter.  Here it runs on every call and its result is masked with
``torch.where`` on the device-side ``due`` flag, so a chain step never
reads a device value back to the host: the estimator costs the same on
every block, due or not.  The descent and the power gate are one helper
kernel on a CUDA tensor (``kernels.iq_descent``); its plain twin, here,
evaluates the 4 candidates of every channel as one batched tensor op per
pass.

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


def _spectrum_db(base: torch.Tensor, image: torch.Tensor, g: torch.Tensor,
                 phi: torch.Tensor) -> torch.Tensor:
    """dB spectrum of the corrected signal from the precomputed shifted
    spectra base = FFT(w x), image = FFT(w Re x); g/phi may carry leading
    batch dims in front of the channel dim."""
    k = torch.complex(g, phi)
    spec = base + k[..., None] * image
    mag = torch.abs(spec) / _f32(base.shape[-1])
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


def _utility(spec_db: torch.Tensor) -> torch.Tensor:
    """Sum over the band of (P(+f) - P(-f))^2 where either side is above
    the -80 dB floor (to be maximized)."""
    p_pos, p_neg = _band(spec_db)
    d = p_pos - p_neg
    mask = (p_pos > C.IQ_SPECTRUM_FLOOR_DB) | (p_neg > C.IQ_SPECTRUM_FLOOR_DB)
    return torch.sum(torch.where(mask, d * d, 0.0), dim=-1)


def _power_gate(spec_db: torch.Tensor) -> torch.Tensor:
    """Peak-to-average ratio over the utility band, in dB."""
    p_pos, p_neg = _band(spec_db)
    n_band = p_pos.shape[-1]
    mx = torch.maximum(p_pos.amax(dim=-1), p_neg.amax(dim=-1))
    avg = (p_pos.sum(dim=-1) + p_neg.sum(dim=-1)) / (2.0 * n_band)
    return mx - avg


def _spectra(x: torch.Tensor):
    """(base, image) shifted spectra of the windowed (C, nfft) block."""
    w = _window(x.shape[-1], str(x.device))
    return (tfft.fftshift(tfft.fft(w * x)),
            tfft.fftshift(tfft.fft(w * x.real)))


def _optimize_core(base: torch.Tensor, image: torch.Tensor,
                   factors: torch.Tensor, passes: int = 25) -> torch.Tensor:
    """The greedy descent for every channel at once: base/image (C, nfft),
    factors (C, 2) -> new (C, 2) factors (unsmoothed)."""
    ch = factors.shape[0]
    step = _moves(str(factors.device))
    rows = torch.arange(ch, device=factors.device)
    cur = factors
    cur_u = _utility(_spectrum_db(base, image, cur[:, 0], cur[:, 1]))
    for _ in range(passes):
        cands = cur[None, :, :] + step[:, None, :]                 # (4, C, 2)
        us = _utility(_spectrum_db(base, image, cands[..., 0], cands[..., 1]))
        best = torch.argmax(us, dim=0)                             # (C,)
        best_u = us[best, rows]
        better = best_u > cur_u
        cur = torch.where(better[:, None], cands[best, rows], cur)
        cur_u = torch.where(better, best_u, cur_u)
    return cur


def maybe_update_planar(xr: torch.Tensor, xi: torch.Tensor, state: IqState,
                        interval_samples: int, passes: int = 25,
                        advance_samples: int | None = None) -> IqState:
    """Only the first IQ_FFT_SIZE samples feed the estimator, so the
    complex view is built over that slice alone."""
    n = xr.shape[-1]
    m = min(n, C.IQ_FFT_SIZE)
    seg = torch.complex(xr[:, :m], xi[:, :m])
    return maybe_update(seg, state, interval_samples, passes,
                        advance_samples=n if advance_samples is None
                        else advance_samples)


def maybe_update(x: torch.Tensor, state: IqState, interval_samples: int,
                 passes: int = 25, advance_samples: int | None = None) -> IqState:
    """The rate-limited, power-gated estimator on a (C, N) complex64 block
    (the pre-correction signal; its first IQ_FFT_SIZE samples are used).
    Runs masked: see the module docstring."""
    nfft = C.IQ_FFT_SIZE
    n = x.shape[-1]
    seg = x[:, :nfft] if n >= nfft else torch.cat(
        [x, torch.zeros((x.shape[0], nfft - n), dtype=x.dtype, device=x.device)],
        dim=-1)
    from iq_tool_tpu_torch.ops import kernels
    counter = state.samples_since_opt
    due = counter >= int(interval_samples)
    factors = state.factors
    new_raw, gate_db = kernels.iq_descent(*_spectra(seg), factors, passes)
    gate = gate_db >= C.IQ_POWER_GATE_DB                             # (C,)
    sm = _f32(C.IQ_SMOOTHING)
    smoothed = _f32(1.0 - sm) * factors + sm * new_raw
    new_factors = torch.where((due & gate)[:, None], smoothed, factors)
    ran = due & gate.any()
    adv = int(advance_samples if advance_samples is not None else n)
    new_counter = torch.where(ran, torch.zeros_like(counter),
                              torch.clamp(torch.clamp(counter, max=_SAT) + adv,
                                          max=_SAT))
    return IqState(factors=new_factors, samples_since_opt=new_counter)


def calibrate(x: torch.Tensor, rounds: int = 10, passes: int = 25) -> torch.Tensor:
    """Synchronous pre-stream calibration (files): (C, nfft) complex64 ->
    (C, 2) factors after several unsmoothed descent rounds from zero."""
    from iq_tool_tpu_torch.ops import kernels
    base, image = _spectra(x[:, :C.IQ_FFT_SIZE].to(torch.complex64))
    factors = torch.zeros((x.shape[0], 2), dtype=torch.float32, device=x.device)
    for _ in range(rounds):
        factors, _ = kernels.iq_descent(base, image, factors, passes)
    return factors
