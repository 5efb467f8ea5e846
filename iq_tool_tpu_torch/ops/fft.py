"""FFT over the last axis, the port of ``iq_tool_tpu.ops.fft``.

The reference computes its FFTs as four-step DFT matmuls because the TPU
backend has no FFT call.  Here they are ``torch.fft`` (cuFFT on the
card, pocketfft on the CPU) in complex64.  Used by the I/Q estimator and
by the overlap-save kernel's plain twin.
"""

from __future__ import annotations

import torch


def fft(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.fft(x.to(torch.complex64), dim=-1)


def ifft(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.ifft(x.to(torch.complex64), dim=-1)


def fftshift(x: torch.Tensor) -> torch.Tensor:
    """The reference's shift: a roll by n // 2 along the last axis."""
    return torch.roll(x, x.shape[-1] // 2, dims=-1)
