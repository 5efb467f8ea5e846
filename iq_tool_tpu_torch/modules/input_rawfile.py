"""raw-file input (src/input_rawfile.c).

Reads headerless I/Q sample files; requires --raw-file-input-rate and
--raw-file-input-sample-format (input_rawfile.c:84-104).  Supports
pre-stream I/Q calibration (read + rewind) and raw passthrough.
"""

from __future__ import annotations

import os
from typing import Iterator

from iq_tool_tpu_torch.formats import get_format, complex_formats
from iq_tool_tpu_torch.modules.base import Block, InputModule, SourceInfo


class RawFileInput(InputModule):
    name = "raw-file"

    def __init__(self):
        self._f = None
        self._fmt = None
        self._path = None

    @classmethod
    def add_cli_options(cls, parser) -> None:
        g = parser.add_argument_group("Raw File Input Specific Options")
        g.add_argument("--raw-file-input-rate", type=float, metavar="HZ",
                       help="Sample rate of the raw input file (required)")
        g.add_argument("--raw-file-input-sample-format", metavar="FMT",
                       help="Sample format of the raw input file (required); "
                            f"one of: {', '.join(complex_formats())}")

    def initialize(self, config, args) -> SourceInfo:
        if config.input_path is None:
            raise ValueError("raw-file input requires an input file path")
        rate = getattr(args, "raw_file_input_rate", None)
        fmt_name = getattr(args, "raw_file_input_sample_format", None)
        if not rate or rate <= 0:
            raise ValueError("raw-file input requires --raw-file-input-rate "
                             "(input_rawfile.c:84-95)")
        if not fmt_name:
            raise ValueError("raw-file input requires "
                             "--raw-file-input-sample-format")
        fmt = get_format(fmt_name)
        if not fmt.is_complex:
            raise ValueError(f"'{fmt.name}' is not a complex I/Q format")
        self._fmt = fmt
        self._path = config.input_path
        self._f = open(self._path, "rb")
        size = os.fstat(self._f.fileno()).st_size
        frames = size // fmt.bytes_per_frame
        return SourceInfo(sample_rate=float(rate), sample_format=fmt.name,
                          total_frames=frames)

    def blocks(self, frames_per_block: int) -> Iterator[Block]:
        bpf = self._fmt.bytes_per_frame
        want = frames_per_block * bpf
        while True:
            buf = self._f.read(want)
            if not buf:
                return
            yield Block(payload=buf[: len(buf) // bpf * bpf])
            if len(buf) < want:
                return

    def seek_frames(self, frame: int) -> None:
        self._f.seek(frame * self._fmt.bytes_per_frame)

    def calibration_frames(self, n: int) -> bytes | None:
        pos = self._f.tell()
        buf = self._f.read(n * self._fmt.bytes_per_frame)
        self._f.seek(pos)
        if len(buf) < n * self._fmt.bytes_per_frame:
            return None
        return buf

    def summary(self) -> dict:
        return {"Input File": self._path,
                "Input Format": self._fmt.description}

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
