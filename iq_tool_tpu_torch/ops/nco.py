"""NCO complex mixer (frequency shift), the port of ``iq_tool_tpu.ops.nco``.

The phase is a 32-bit fixed-point accumulator computed in closed form,
``phase[n] = acc + n * dtheta mod 2^32``, so a block has no sequential
dependency and any sample's phase is known from its global index.  torch
has no general uint32 arithmetic: the accumulator is an int64 tensor
holding the uint32 value, and every product is masked back to 32 bits.

The angle is the uint32 phase converted to float32 times 2*pi/2^32, as
the reference's XLA path computes it; the CUDA kernels use the same
mapping (``csrc/wire.cuh``), so the plain path, the kernels and the
reference differ only in the rounding of sin and cos.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
TWO_PI_OVER_2_32 = float(np.float32(2.0 * np.pi / 4294967296.0))


def freq_to_dtheta(shift_hz: float, sample_rate: float) -> int:
    """Signed shift -> wrapping uint32 phase increment per sample."""
    turns = float(shift_hz) / float(sample_rate)  # cycles per sample
    return int(round((turns - np.floor(turns)) * 4294967296.0)) & _MASK


def init(channels: int, device=None) -> torch.Tensor:
    return torch.zeros((channels,), dtype=torch.int64, device=device)


def reset(phase_acc: torch.Tensor) -> torch.Tensor:
    """Discontinuity reset: phase -> 0, frequency kept."""
    return torch.zeros_like(phase_acc)


def advance(phase_acc: torch.Tensor, n: int, dtheta: int) -> torch.Tensor:
    """The accumulator n samples later."""
    return (phase_acc + ((int(n) & _MASK) * int(dtheta) & _MASK)) & _MASK


def row_phases(phase_acc: torch.Tensor, rows: int, n_row: int,
               dtheta: int) -> torch.Tensor:
    """(C * rows,) first phases of each channel's block cut into ``rows``
    consecutive rows of n_row samples: row r starts r * n_row samples
    after the accumulator."""
    offs = (torch.arange(rows, dtype=torch.int64, device=phase_acc.device)
            * (int(n_row) & _MASK) * int(dtheta)) & _MASK
    return ((phase_acc[:, None] + offs[None, :]) & _MASK).reshape(-1)


def angles(phase_acc: torch.Tensor, start: int, n: int, dtheta: int) -> torch.Tensor:
    """(C, n) float32 angles of samples start .. start+n-1 after phase_acc."""
    idx = torch.arange(start, start + n, dtype=torch.int64,
                       device=phase_acc.device)
    ph = (phase_acc[:, None] + ((idx * int(dtheta)) & _MASK)) & _MASK
    return ph.to(torch.float32) * TWO_PI_OVER_2_32


def mix(xr: torch.Tensor, xi: torch.Tensor, phase_acc: torch.Tensor,
        dtheta: int, start: int = 0):
    """Rotate (C, n) planes whose first sample sits `start` samples after
    the accumulator's phase."""
    ang = angles(phase_acc, start, xr.shape[-1], dtheta)
    c, s = torch.cos(ang), torch.sin(ang)
    return xr * c - xi * s, xr * s + xi * c


def apply_planar(xr: torch.Tensor, xi: torch.Tensor, phase_acc: torch.Tensor,
                 dtheta: int):
    """Planar mix: (xr, xi) f32 (C, N) -> (yr, yi, new phase accumulator)."""
    yr, yi = mix(xr, xi, phase_acc, dtheta)
    return yr, yi, advance(phase_acc, xr.shape[-1], dtheta)
