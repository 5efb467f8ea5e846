"""Synthetic tone/noise source (new in this framework; no reference analog).

Generates deterministic test signals without any file or hardware — used
for benchmarks, self-tests, and as the SDR-module stand-in in environments
without radio hardware.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from iq_tool_tpu_torch.formats import get_format
from iq_tool_tpu_torch.modules.base import Block, InputModule, SourceInfo


def _quantize_host(x: np.ndarray, fmt) -> bytes:
    """Host-side (numpy) cf32 -> wire quantization; same contract as
    ops.convert.from_cf32, kept in numpy so synthesis never touches the
    accelerator (eager complex ops are unsupported on some backends)."""
    pairs = np.empty(x.size * 2, np.float32)
    pairs[0::2], pairs[1::2] = x.real, x.imag
    if fmt.name == "cf32":
        return pairs.tobytes()
    if fmt.signed:
        v = pairs * np.float32(fmt.scale)
        v = np.trunc(np.where(v > 0, v + np.float32(0.5), v - np.float32(0.5)))
        v = np.clip(v, fmt.min_code, fmt.max_code)
        codes = v.astype(np.int64)
    else:
        v = pairs * np.float32(fmt.scale) + np.float32(fmt.offset_out)
        v = np.clip(v, 0, fmt.max_code)
        codes = np.floor(v + 0.5).astype(np.int64)
    if fmt.name == "cs24":
        c = codes & 0xFFFFFF
        out = np.empty((x.size * 2, 3), np.uint8)
        out[:, 0] = c & 0xFF
        out[:, 1] = (c >> 8) & 0xFF
        out[:, 2] = (c >> 16) & 0xFF
        return out.tobytes()
    return codes.astype(fmt.wire_dtype).tobytes()


class ToneInput(InputModule):
    name = "tone"

    def __init__(self):
        self._rate = 0.0
        self._freq = 0.0
        self._amp = 0.5
        self._fmt = None
        self._frames = None
        self._pos = 0

    @classmethod
    def add_cli_options(cls, parser) -> None:
        g = parser.add_argument_group("Tone Input Specific Options")
        g.add_argument("--tone-rate", type=float, default=1_000_000.0,
                       help="Sample rate of the synthetic source")
        g.add_argument("--tone-freq", type=float, default=100_000.0,
                       help="Tone frequency in Hz")
        g.add_argument("--tone-amplitude", type=float, default=0.5)
        g.add_argument("--tone-seconds", type=float, default=1.0,
                       help="Stream length in seconds")
        g.add_argument("--tone-format", default="cs16",
                       help="Wire format to synthesize")

    def initialize(self, config, args) -> SourceInfo:
        self._rate = float(getattr(args, "tone_rate", 1_000_000.0))
        self._freq = float(getattr(args, "tone_freq", 100_000.0))
        self._amp = float(getattr(args, "tone_amplitude", 0.5))
        self._fmt = get_format(getattr(args, "tone_format", "cs16"))
        secs = float(getattr(args, "tone_seconds", 1.0))
        self._frames = int(secs * self._rate)
        return SourceInfo(sample_rate=self._rate,
                          sample_format=self._fmt.name,
                          total_frames=self._frames)

    def _synth(self, start: int, n: int) -> bytes:
        t = np.arange(start, start + n, dtype=np.float64) / self._rate
        x = (self._amp * np.exp(2j * np.pi * self._freq * t)).astype(np.complex64)
        return _quantize_host(x, self._fmt)

    def blocks(self, frames_per_block: int) -> Iterator[Block]:
        pos = 0
        while pos < self._frames:
            n = min(frames_per_block, self._frames - pos)
            yield Block(payload=self._synth(pos, n))
            pos += n

    def calibration_frames(self, n: int) -> bytes | None:
        return self._synth(0, n)

    def summary(self) -> dict:
        return {"Source": f"tone {self._freq:.0f} Hz @ {self._rate:.0f} sps"}
