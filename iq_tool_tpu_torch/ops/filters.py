"""Streaming FIR execution, direct and overlap-save: the port of
``iq_tool_tpu.ops.filters``.

Both methods are block maps plus a carried input tail:

* direct (and FFT-method filters up to 2048 taps, whose overlap-save
  output is the same linear convolution): a banded Toeplitz map over
  strided windows, run by the K2 kernel (``kernels.banded_apply``), with
  a packed-wire epilogue when the filter is the chain's last op;
* overlap-save (FFT-method filters above 2048 taps): windows of 2b
  samples transformed, multiplied by H and transformed back, run by the
  K5 kernel (``kernels.osfft_apply``) in one launch per block: as many
  3/4-advance windows as fit, then half-advance windows, then one
  re-anchored window for the ragged tail (``osfft_windows``).  Windows
  above K5's largest (``kernels.OSFFT_MAX_NFFT`` points) take
  ``overlap_save_fft``, the reference's XLA overlap-save in torch.fft, as
  the reference's step takes XLA where its Pallas kernel declines.

The carried tail is ``block`` samples (>= taps - 1) for the fft method
and taps - 1 for the direct one, one per channel, as (state_r, state_i).
"""

from __future__ import annotations

import numpy as np
import torch

from iq_tool_tpu_torch import constants as C
from iq_tool_tpu_torch.ops import banded, kernels
from iq_tool_tpu_torch.ops.fir_design import choose_fft_block


def tail_len(num_taps: int, method: str, user_fft_size: int | None = None) -> int:
    if method == "fir":
        return num_taps - 1
    return choose_fft_block(num_taps, user_fft_size)


def largest_divisor_leq(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap (>= 1)."""
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return 1


def _toeplitz(taps: np.ndarray, stride: int) -> np.ndarray:
    """Banded Toeplitz T[L, S] (L = S + K - 1), column i the reversed taps
    at rows [i, i+K): causal convolution after the K-1 tail history."""
    k = len(taps)
    t = np.zeros((stride + k - 1, stride), taps.dtype)
    rev = taps[::-1]
    for i in range(stride):
        t[i:i + k, i] = rev
    return t


def osfft_windows(n: int, block: int, advances: tuple[int, ...]):
    """The overlap-save schedule of an n-sample block as (starts, heads):
    window w reads ext[starts[w] : starts[w] + 2b] (ext = tail ++ block)
    and emits its samples j >= heads[w] as outputs starts[w] + j - b.
    Each advance in turn takes as many whole windows as fit (a window of
    advance a emits its last a samples); the rest (< b) comes from one
    window re-anchored at n - b whose leading duplicates are dropped."""
    starts, heads = [], []
    s = 0
    for adv in advances:
        for _ in range((n - s) // adv):
            starts.append(s + adv - block)
            heads.append(2 * block - adv)
            s += adv
    while s < n:
        st = min(s, n - block)
        starts.append(st)
        heads.append(block + s - st)
        s = st + block
    return tuple(starts), tuple(heads)


@kernels.counted
def overlap_save_fft(xr, xi, state_r, state_i, h: torch.Tensor, block: int):
    """Overlap-save in torch.fft over ext = tail ++ x (the reference's
    ``StreamingFilter.__call__``, ``iq_tool_tpu/ops/filters.py``): windows
    of 2b samples advancing by b, the last one re-anchored at n - b when b
    does not divide n, each transformed, multiplied by ``h`` (the (2b,)
    complex64 response on x's device) and transformed back, its last b
    samples kept.  (C, n) planes and the (C, b) tail -> (yr, yi, new_r,
    new_i).  The reference leaves this to XLA, so it is torch ops, with
    its own ``launches`` counter (on either device)."""
    c, n = xr.shape
    b = block
    ext = torch.complex(torch.cat([state_r, xr], -1), torch.cat([state_i, xi], -1))
    if n % b == 0:
        segs = ext.reshape(c, n // b + 1, b)
        windows = torch.cat([segs[:, :-1], segs[:, 1:]], -1)
    else:
        # window i starts at i * b, the last one at n - b: no host value
        # reaches the device, so the route can be captured in a CUDA graph
        nc = -(-n // b)
        starts = (torch.arange(nc, device=xr.device) * b).clamp_(max=n - b)
        windows = ext[:, starts[:, None] + torch.arange(2 * b, device=xr.device)[None, :]]
    out = torch.fft.ifft(torch.fft.fft(windows) * h)[..., b:]       # (C, nc, b)
    if n % b:
        out = torch.cat([out[:, :-1].reshape(c, -1), out[:, -1, (nc - 1) * b - n:]], -1)
    y = out.reshape(c, n)
    overlap_save_fft.launches += 1
    return (y.real.contiguous(), y.imag.contiguous(),
            banded.new_tail(state_r, xr, b), banded.new_tail(state_i, xi, b))


class StreamingFilter:
    """A designed filter bound to a method and block geometry; the
    per-stream state is the external tail."""

    def __init__(self, taps: np.ndarray, method: str = "auto",
                 user_fft_size: int | None = None):
        taps = np.asarray(taps, np.complex64)
        if method == "auto":
            method = "fir" if len(taps) <= 1024 else "fft"
        self.method = method
        self.taps = taps
        self.num_taps = len(taps)
        self.block = tail_len(self.num_taps, method, user_fft_size)
        if method == "fft":
            self.nfft = 2 * self.block
            self._h = np.fft.fft(taps, self.nfft).astype(np.complex64)
            # overlap-save with nfft >= taps + block - 1 is exact linear
            # convolution: moderate filters run banded instead
            self._exec_banded = self.num_taps <= 2048
        else:
            self._h = taps
            self._exec_banded = True
        self._bands: dict = {}       # (stride, device) -> kernels.Band
        self._spectra: dict = {}     # device -> kernels.Spectrum
        self._windows: dict = {}     # (n, device) -> kernels.Windows

    def _band(self, stride: int, device) -> kernels.Band:
        key = (stride, str(device))
        if key not in self._bands:
            tr = _toeplitz(np.real(self.taps).astype(np.float32), stride)
            ti = (_toeplitz(np.imag(self.taps).astype(np.float32), stride)
                  if np.any(np.abs(self.taps.imag) > 0) else None)
            self._bands[key] = kernels.Band.build(tr, ti, device)
        return self._bands[key]

    def _spectrum(self, device) -> kernels.Spectrum:
        key = str(device)
        if key not in self._spectra:
            self._spectra[key] = kernels.Spectrum.build(self._h, device)
        return self._spectra[key]

    def _schedule(self, n: int, device) -> kernels.Windows:
        key = (n, str(device))
        if key not in self._windows:
            b = self.block
            advances = (3 * b // 2, b) if self.osfft_advance != b else (b,)
            self._windows[key] = kernels.Windows.build(
                *osfft_windows(n, b, advances), device)
        return self._windows[key]

    def init_planar(self, channels: int, device=None):
        z = lambda: torch.zeros((channels, self.block), dtype=torch.float32,
                                device=device)
        return z(), z()

    def _banded(self, xr, xi, state_r, state_i, pack_fmt=None):
        k = self.num_taps
        hist = self.block if self.method == "fft" else k - 1
        stride = largest_divisor_leq(xr.shape[-1], C.BANDED_STRIDE_CAP)
        y = kernels.banded_apply(
            state_r[:, hist - (k - 1):].contiguous(),
            state_i[:, hist - (k - 1):].contiguous(), xr, xi,
            self._band(stride, xr.device), None, stride, k - 1,
            pack_fmt=pack_fmt)
        return y, banded.new_tail(state_r, xr, hist), banded.new_tail(state_i, xi, hist)

    def apply_planar(self, xr, xi, state_r, state_i):
        """Planar f32 (C, N) -> (yr, yi, new_r, new_i)."""
        if self._exec_banded:
            if self.num_taps == 1:
                hr = float(np.real(self.taps[0]))
                hi = float(np.imag(self.taps[0]))
                return xr * hr - xi * hi, xr * hi + xi * hr, state_r, state_i
            (yr, yi), nr, ni = self._banded(xr, xi, state_r, state_i)
            return yr, yi, nr, ni
        return self._osfft_planar(xr, xi, state_r, state_i)

    @property
    def packs(self) -> bool:
        """Whether the filter has the packed epilogue: a banded kernel (not
        overlap-save, not one tap)."""
        return self._exec_banded and self.num_taps != 1

    def apply_planar_packed(self, xr, xi, state_r, state_i, out_fmt: str = "cs16"):
        """The banded filter with the kernel's quantize-and-pack epilogue,
        for when it is the chain's last op: (packed wire, new_r, new_i), or
        None where it does not ``packs`` or the format has no packed form."""
        if not self.packs or not kernels.packable_out(out_fmt):
            return None
        return self._banded(xr, xi, state_r, state_i, pack_fmt=out_fmt)

    @property
    def osfft_advance(self) -> int:
        """Window advance: 3b/2 when the taps fit a quarter window
        (guaranteed for auto-sized blocks), else b."""
        b = self.block
        return 3 * b // 2 if (self.num_taps - 1) * 2 <= b else b

    def _osfft_planar(self, xr, xi, state_r, state_i):
        b = self.block
        n = xr.shape[-1]
        if n < b:
            raise ValueError(f"block length {n} smaller than filter block {b}")
        if self.nfft > kernels.OSFFT_MAX_NFFT:
            return overlap_save_fft(xr, xi, state_r, state_i,
                                    self._spectrum(xr.device).h, b)
        yr, yi = kernels.osfft_apply(xr, xi, self._spectrum(xr.device), b,
                                     windows=self._schedule(n, xr.device),
                                     tail=(state_r, state_i))
        return (yr, yi, banded.new_tail(state_r, xr, b),
                banded.new_tail(state_i, xi, b))
