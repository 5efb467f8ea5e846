"""The seeded capture every cell feeds: per channel a few tones, noise, a
DC offset and an I/Q imbalance at the levels of a real receiver's
capture, quantized to the configuration's input format (cs16, an
RTL-SDR's cu8 or a HackRF's cs8).  Made on the device from the seed in
a few large calls; the same seed gives the same bytes, and every seed
the same sizes."""

from __future__ import annotations

import math

import torch

# format -> (wire dtype, codes a unit of full scale, offset, lowest and
# highest code), as upstream's quantizers (sample_convert.c): cu8 decodes
# as (x - 127.5) / 128, cs8 as x / 128
WIRES = {"cs16": (torch.int16, 32768.0, 0.0, -32768, 32767),
         "cu8": (torch.uint8, 128.0, 127.5, 0, 255),
         "cs8": (torch.int8, 128.0, 0.0, -128, 127)}


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def capture(seed: int, channels: int, frames: int, rate: float, sig: dict,
            device, fmt: str) -> torch.Tensor:
    """(channels, 2 * frames) wire of format ``fmt`` on ``device``: int16
    for cs16, uint8 for cu8, int8 for cs8; the same draws and signal in
    each.

    ``sig``: ``tones`` (count), ``tone_dbfs`` [lo, hi], ``tone_max_hz``,
    ``noise_dbfs``, ``dc_dbfs``, ``iq_gain_max`` (relative),
    ``iq_phase_max_deg``; levels are of the format's full scale (1.0 =
    32768 cs16 codes, 128 cu8 codes)."""
    if fmt not in WIRES:
        raise ValueError(f"no capture in format {fmt!r}")
    dtype, scale, offset, lo_code, hi_code = WIRES[fmt]
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
    out = torch.empty((channels, 2 * frames), dtype=dtype, device=dev)
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
        v = torch.stack([i, q], dim=-1).reshape(c1 - c0, 2 * frames) * scale
        if offset:
            v = v + offset
        out[c0:c1] = torch.clamp(torch.round(v), lo_code, hi_code).to(dtype)
    return out
