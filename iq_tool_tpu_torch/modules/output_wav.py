"""wav / wav-rf64 outputs (src/output_wav.c, output_wav_rf64.c,
output_wav_common.c).

Only cs16/cu8 payloads are valid (output_wav_common.c:45-52).  Matching
the reference's quirk, the plain 'wav' output actually writes an RF64
container (config.c:153-156) so long captures don't hit the 4 GiB RIFF
limit; 'wav-legacy' forces classic RIFF.
"""

from __future__ import annotations

import os
import stat

from iq_tool_tpu_torch.io.wav import WavWriter
from iq_tool_tpu_torch.modules.base import OutputModule


class _WavOutputBase(OutputModule):
    container = "rf64"
    requires_output_path = True

    def __init__(self):
        self._w: WavWriter | None = None
        self._path = None
        self.bytes_written = 0

    def initialize(self, config, args) -> None:
        self._path = config.output_path
        if self._path is None:
            raise ValueError(f"{self.name} output requires an output file path")
        resume = getattr(config, "resume", False)
        if os.path.lexists(self._path):
            if os.path.islink(self._path) or not stat.S_ISREG(os.stat(self._path).st_mode):
                raise ValueError(f"refusing to overwrite: {self._path}")
            if not resume and not getattr(config, "force_overwrite", False):
                raise ValueError(
                    f"output file exists: {self._path} (use --force-overwrite)")
        self._w = WavWriter(self._path, int(config.output_rate),
                            config.output_format, container=self.container,
                            append=resume)

    def truncate_to_frames(self, frames: int, bytes_per_frame: int) -> None:
        self._w.truncate_data(frames * bytes_per_frame)

    def write(self, payload: bytes) -> None:
        self._w.write(payload)
        self.bytes_written += len(payload)

    def finalize(self) -> None:
        if self._w:
            self._w.finalize()   # patches sizes even on partial streams
            self._w = None

    def summary(self) -> dict:
        return {"Output File": self._path,
                "Container": self.container.upper()}


class WavOutput(_WavOutputBase):
    name = "wav"
    container = "rf64"           # reference quirk: wav defaults to RF64


class WavRf64Output(_WavOutputBase):
    name = "wav-rf64"
    container = "rf64"


class WavLegacyOutput(_WavOutputBase):
    name = "wav-legacy"
    container = "wav"
