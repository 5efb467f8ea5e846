"""stdout output (src/output_stdout.c): unpaced binary pipe; a closed pipe
(EPIPE) is a graceful shutdown, not an error (output_stdout.c:37-77)."""

from __future__ import annotations

import sys

from iq_tool_tpu_torch.modules.base import OutputClosed, OutputModule

BrokenPipe = OutputClosed    # back-compat alias


class StdoutOutput(OutputModule):
    name = "stdout"
    requires_output_path = False   # pipe provides its own flow control

    def __init__(self):
        self._f = None
        self.bytes_written = 0

    def initialize(self, config, args) -> None:
        self._f = sys.stdout.buffer

    def write(self, payload: bytes) -> None:
        try:
            self._f.write(payload)
            self.bytes_written += len(payload)
        except BrokenPipeError as e:
            raise OutputClosed() from e

    def finalize(self) -> None:
        try:
            if self._f:
                self._f.flush()
        except BrokenPipeError:
            pass

    def summary(self) -> dict:
        return {"Output": "stdout (binary)"}
