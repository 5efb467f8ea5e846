"""raw-file output (src/output_raw_file.c).

Secure create: refuses to follow symlinks and to overwrite non-regular
files (output_raw_file.c:74-117); overwrite requires --force-overwrite
(interactive prompts are replaced by a flag — prompts block autonomous
runs, SURVEY.md non-goals).
"""

from __future__ import annotations

import os
import stat

from iq_tool_tpu_torch.modules.base import OutputModule


class RawFileOutput(OutputModule):
    name = "raw"
    requires_output_path = True

    def __init__(self):
        self._f = None
        self._path = None
        self.bytes_written = 0

    @classmethod
    def add_cli_options(cls, parser) -> None:
        pass  # shares the global --force-overwrite option

    def initialize(self, config, args) -> None:
        self._path = config.output_path
        if self._path is None:
            raise ValueError("raw output requires an output file path")
        flags = os.O_WRONLY | os.O_CREAT | getattr(os, "O_NOFOLLOW", 0)
        exists = os.path.lexists(self._path)
        if exists and getattr(config, "resume", False):
            # resuming a checkpointed stream: append to the partial output
            if os.path.islink(self._path) or not stat.S_ISREG(os.stat(self._path).st_mode):
                raise ValueError(f"refusing to resume into: {self._path}")
            fd = os.open(self._path, os.O_WRONLY | os.O_APPEND
                         | getattr(os, "O_NOFOLLOW", 0))
            self._f = os.fdopen(fd, "wb", buffering=1 << 20)
            return
        if exists:
            if os.path.islink(self._path):
                raise ValueError(f"refusing to write through symlink: {self._path}")
            st = os.stat(self._path)
            if not stat.S_ISREG(st.st_mode):
                raise ValueError(f"not a regular file: {self._path}")
            if not getattr(config, "force_overwrite", False):
                raise ValueError(
                    f"output file exists: {self._path} (use --force-overwrite)")
            flags |= os.O_TRUNC
        else:
            flags |= os.O_EXCL
        fd = os.open(self._path, flags, 0o644)
        self._f = os.fdopen(fd, "wb", buffering=1 << 20)

    def truncate_to_frames(self, frames: int, bytes_per_frame: int) -> None:
        """Resume reconciliation: drop output written after the last
        checkpoint so the stream continues sample-exactly."""
        want = frames * bytes_per_frame
        self._f.flush()
        have = os.path.getsize(self._path)
        if have < want:
            raise ValueError(
                f"output has {have} bytes but the checkpoint expects "
                f"{want}: the file lost data after the checkpoint was "
                "written (cannot resume sample-exactly)")
        if have > want:
            os.ftruncate(self._f.fileno(), want)

    def write(self, payload: bytes) -> None:
        self._f.write(payload)
        self.bytes_written += len(payload)

    def finalize(self) -> None:
        if self._f:
            self._f.flush()
            self._f.close()
            self._f = None

    def summary(self) -> dict:
        return {"Output File": self._path}
