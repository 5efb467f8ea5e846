"""The seeded capture every cell feeds: per channel a few tones, noise, a
DC offset and an I/Q imbalance at the levels of a real receiver's
capture, quantized to cs16.  Made on the device from the seed in a few
large calls; the same seed gives the same bytes, and every seed the same
sizes."""

from __future__ import annotations

import math

import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def capture(seed: int, channels: int, frames: int, rate: float, sig: dict,
            device) -> torch.Tensor:
    """(channels, 2 * frames) int16 cs16 wire on ``device``.

    ``sig``: ``tones`` (count), ``tone_dbfs`` [lo, hi], ``tone_max_hz``,
    ``noise_dbfs``, ``dc_dbfs``, ``iq_gain_max`` (relative),
    ``iq_phase_max_deg``; levels are of full scale (1.0 = 32768 codes)."""
    dev = torch.device(device)
    g = generator(seed, dev)
    u = lambda *s: torch.rand(*s, generator=g, device=dev, dtype=torch.float64)
    k = int(sig["tones"])
    lo, hi = sig["tone_dbfs"]
    freq = (2.0 * u(channels, k) - 1.0) * float(sig["tone_max_hz"]) / rate   # cycles/sample
    amp = 10.0 ** ((lo + (hi - lo) * u(channels, k)) / 20.0)
    phase0 = u(channels, k)
    dc = 10.0 ** (sig["dc_dbfs"] / 20.0) * torch.polar(
        torch.ones(channels, dtype=torch.float64, device=dev), 2 * math.pi * u(channels))
    eps = (2.0 * u(channels) - 1.0) * float(sig["iq_gain_max"])
    theta = (2.0 * u(channels) - 1.0) * math.radians(float(sig["iq_phase_max_deg"]))
    sigma = 10.0 ** (sig["noise_dbfs"] / 20.0) / math.sqrt(2.0)
    out = torch.empty((channels, 2 * frames), dtype=torch.int16, device=dev)
    step = max(1, (1 << 24) // frames)            # channels a call
    n = torch.arange(frames, dtype=torch.float64, device=dev)
    for c0 in range(0, channels, step):
        c1 = min(channels, c0 + step)
        turns = torch.remainder(freq[c0:c1, :, None] * n + phase0[c0:c1, :, None], 1.0)
        x = (amp[c0:c1, :, None] * torch.exp(2j * math.pi * turns)).sum(1)
        x = x + torch.complex(
            torch.randn((c1 - c0, frames), generator=g, device=dev, dtype=torch.float64),
            torch.randn((c1 - c0, frames), generator=g, device=dev, dtype=torch.float64)
        ) * sigma + dc[c0:c1, None]
        i = (1.0 + eps[c0:c1, None]) * x.real
        q = x.imag * torch.cos(theta[c0:c1, None]) + x.real * torch.sin(theta[c0:c1, None])
        v = torch.stack([i, q], dim=-1).reshape(c1 - c0, 2 * frames) * 32768.0
        out[c0:c1] = torch.clamp(torch.round(v), -32768, 32767).to(torch.int16)
    return out
