"""First-order IIR DC blocker, the port of ``iq_tool_tpu.ops.dc_block``.

H(z) = (1 - z^-1) / (1 - (1-a) z^-1) with a = 2*pi*cutoff / Fs at the
input rate: y[n] = (1-a)*y[n-1] + x[n] - x[n-1].  The recurrence runs as
the reference's two-level scan: tiles of T samples take their local
prefix from one triangular matmul with M[i, j] = (1-a)^(i-j), a scan over
the per-tile ends carries across tiles, and a decay term fixes each tile.
The pole (1 - 3.07e-5 at 2.048 Msps) keeps every rounding error for
~32.6k samples, so the scan runs in float64 and rounds the output to
float32 once: in float32 (the reference's choice) two summation orders
already differ at ~100 dB on a full-scale noise wire, which would leave
no margin to hold the CUDA kernels (csrc/banded_dc.cu, also float64
inside) to their plain twins.

The state is one (C, 4) float32 tensor, columns [xr_prev, xi_prev,
yr_prev, yi_prev] (the reference's PlanarDcState, stacked as its kernels
take it).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from iq_tool_tpu_torch.constants import DC_BLOCK_CUTOFF_HZ


def alpha_for_rate(sample_rate: float, cutoff_hz: float = DC_BLOCK_CUTOFF_HZ) -> float:
    return float(2.0 * np.pi * cutoff_hz / sample_rate)


def init_planar(channels: int, device=None) -> torch.Tensor:
    return torch.zeros((channels, 4), dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=16)
def _tile_consts(a: float, t: int, device: str):
    """(M, decay) float64 on `device`, made once (a host-to-device copy
    inside a step would block the host until the card drains):
    M[i, j] = a^(i-j) for j <= i else 0, so y_local = b @ M^T, and
    decay[j] = a^(j+1)."""
    i = np.arange(t)
    e = i[:, None] - i[None, :]
    m = np.where(e >= 0, np.float64(a) ** np.maximum(e, 0), 0.0)
    decay = np.float64(a) ** np.arange(1, t + 1)
    return torch.from_numpy(m).to(device), torch.from_numpy(decay).to(device)


def _tile_size(n: int, cap: int = 256, floor: int = 32) -> int:
    for d in range(min(cap, n), floor - 1, -1):
        if n % d == 0:
            return d
    return 0


def _scan(coef: float, b: torch.Tensor) -> torch.Tensor:
    """y[k] = coef * y[k-1] + b[k] along the last axis (y[-1] = 0), by
    log-depth doubling (the associative combine (a1*a2, b2 + a2*b1) with a
    constant coefficient, each level's power taken directly)."""
    y = b.clone()
    n = y.shape[-1]
    step = 1
    while step < n:
        y[..., step:] = y[..., step:] + coef ** step * y[..., :-step]
        step *= 2
    return y


def scan_plane(x: torch.Tensor, x_prev: torch.Tensor, y_prev: torch.Tensor,
               alpha: float) -> torch.Tensor:
    """One real plane's y in float64, before the rounding to float32:
    x (C, N) f32, carries (C,)."""
    a = float(1.0 - alpha)
    x64 = x.double()
    xm1 = torch.cat([x_prev.double()[:, None], x64[:, :-1]], dim=-1)
    b = x64 - xm1
    # fold the carried y[-1] into the first element: y[0] = a*y[-1] + b[0]
    b[:, 0] += a * y_prev.double()
    c, n = x.shape
    t = _tile_size(n)
    if t == 0 or n <= t:
        return _scan(a, b)
    nb = n // t
    m, decay = _tile_consts(a, t, str(x.device))
    y_local = torch.matmul(b.reshape(c, nb, t), m.T)
    ends = y_local[:, :, -1]
    carry = _scan(a ** t, ends)
    prev = torch.cat([torch.zeros((c, 1), dtype=b.dtype, device=x.device),
                      carry[:, :-1]], dim=-1)
    return (y_local + prev[:, :, None] * decay).reshape(c, n)


def apply_plane(x: torch.Tensor, x_prev: torch.Tensor, y_prev: torch.Tensor,
                alpha: float):
    """One real plane: x (C, N) f32, carries (C,) f32 -> (y, x_last, y_last),
    y rounded to float32 from the float64 scan."""
    y = scan_plane(x, x_prev, y_prev, alpha).float()
    return y, x[:, -1], y[:, -1]


def apply_planar_ref(xr: torch.Tensor, xi: torch.Tensor, state: torch.Tensor,
                     alpha: float):
    """The plain path on any device: planar f32 (C, N) planes -> (yr, yi,
    new (C, 4) state)."""
    yr, xr_l, yr_l = apply_plane(xr, state[:, 0], state[:, 2], alpha)
    yi, xi_l, yi_l = apply_plane(xi, state[:, 1], state[:, 3], alpha)
    return yr, yi, torch.stack([xr_l, xi_l, yr_l, yi_l], dim=-1)


def apply_planar(xr: torch.Tensor, xi: torch.Tensor, state: torch.Tensor,
                 alpha: float):
    """Planar f32 (C, N) planes -> (yr, yi, new (C, 4) state): the K3
    kernel on a CUDA tensor (``kernels.dc_block_apply``), the plain path
    on the CPU."""
    from iq_tool_tpu_torch.ops import kernels
    return kernels.dc_block_apply(xr, xi, state, alpha)


def apply_prefix(xr: torch.Tensor, xi: torch.Tensor, state: torch.Tensor,
                 alpha: float, m: int):
    """The DC-blocked first ``m`` samples of a block, from the carried
    (C, 4) state: what the I/Q estimator taps (its plain twin's prefix;
    the estimator kernel computes it in its own loader)."""
    yr, _, _ = apply_plane(xr[:, :m], state[:, 0], state[:, 2], alpha)
    yi, _, _ = apply_plane(xi[:, :m], state[:, 1], state[:, 3], alpha)
    return yr, yi
