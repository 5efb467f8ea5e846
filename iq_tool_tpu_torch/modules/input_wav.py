"""wav input (src/input_wav.c).

cs16/cu8 I/Q WAV/RF64 files; parses 'auxi' metadata chunks and SDR#-style
filenames for center frequency / timestamp; --wav-center-target-freq
computes the module NCO shift = file_center - target
(input_wav.c:614-629).
"""

from __future__ import annotations

import os
from typing import Iterator

from iq_tool_tpu_torch.io import metadata as md
from iq_tool_tpu_torch.io.wav import WavReader
from iq_tool_tpu_torch.modules.base import Block, InputModule, SourceInfo


class WavInput(InputModule):
    name = "wav"

    def __init__(self):
        self._r: WavReader | None = None
        self._meta: md.SdrMetadata | None = None
        self._target_freq = None

    @classmethod
    def add_cli_options(cls, parser) -> None:
        g = parser.add_argument_group("WAV Input Specific Options")
        g.add_argument("--wav-center-target-freq", type=float, metavar="HZ",
                       help="Tune the capture so this absolute frequency is "
                            "at DC (uses file center-frequency metadata)")

    def initialize(self, config, args) -> SourceInfo:
        if config.input_path is None:
            raise ValueError("wav input requires an input file path")
        self._r = WavReader(config.input_path)
        info = self._r.info

        meta = md.SdrMetadata()
        if "auxi" in info.chunks:
            parsed = md.parse_auxi(info.chunks["auxi"])
            if parsed:
                meta.merge_missing(parsed)
        from_name = md.parse_filename(os.path.basename(config.input_path))
        if from_name:
            meta.merge_missing(from_name)
        self._meta = meta

        shift = 0.0
        self._target_freq = getattr(args, "wav_center_target_freq", None)
        if self._target_freq is not None:
            if meta.center_freq_hz is None:
                raise ValueError(
                    "--wav-center-target-freq requires center-frequency "
                    "metadata (auxi chunk or SDR# filename), none found")
            # input_wav.c:614-629: shift = file_center - target
            shift = meta.center_freq_hz - float(self._target_freq)

        return SourceInfo(sample_rate=float(info.sample_rate),
                          sample_format=info.sample_format,
                          total_frames=info.frames,
                          metadata=meta, nco_shift_hz=shift)

    def blocks(self, frames_per_block: int) -> Iterator[Block]:
        while True:
            buf = self._r.read_frames(frames_per_block)
            if not buf:
                return
            yield Block(payload=buf)
            if len(buf) < frames_per_block * self._r.bytes_per_frame:
                return

    def seek_frames(self, frame: int) -> None:
        self._r.seek_frames(frame)

    def calibration_frames(self, n: int) -> bytes | None:
        pos = self._r._pos_frames
        self._r.seek_frames(0)
        buf = self._r.read_frames(n)
        self._r.seek_frames(pos)
        if len(buf) < n * self._r.bytes_per_frame:
            return None
        return buf

    def summary(self) -> dict:
        out = {"Input File": self._r.path,
               "Container": "RF64" if self._r.info.is_rf64 else "WAV",
               "Input Format": self._r.info.sample_format}
        m = self._meta
        if m:
            if m.software_name:
                out["Source Software"] = m.software_name
            if m.radio_model:
                out["Radio Model"] = m.radio_model
            if m.center_freq_hz is not None:
                out["Center Frequency"] = f"{m.center_freq_hz:.0f} Hz"
            if m.timestamp_str:
                out["Capture Time"] = m.timestamp_str
        return out

    def close(self) -> None:
        if self._r:
            self._r.close()
            self._r = None
