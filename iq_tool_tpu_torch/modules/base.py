"""Pluggable input/output module interfaces (module.h:85-178 analog).

Input modules produce wire-format byte blocks (pull iterator); output
modules consume processed byte payloads.  Modules contribute their own CLI
options (module_manager.c:224-258 behavior) and summary key/values.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Iterator

from iq_tool_tpu_torch.io.metadata import SdrMetadata


@dataclasses.dataclass
class SourceInfo:
    """What input->initialize() learns (module.h get_stream_info analog)."""
    sample_rate: float
    sample_format: str
    total_frames: int | None = None        # None: unknown length (live)
    metadata: SdrMetadata | None = None
    nco_shift_hz: float = 0.0              # module-resolved shift (wav target freq)


class OutputClosed(Exception):
    """The sink's consumer went away (e.g. stdout EPIPE): graceful
    shutdown, not an error (output_stdout.c:37-77)."""


@dataclasses.dataclass
class Block:
    """One block of raw input: payload bytes + stream-event flags."""
    payload: bytes
    discontinuity: bool = False            # resets DSP state downstream


class InputModule(abc.ABC):
    name: str = "?"
    is_realtime: bool = False              # live SDR/network source

    @classmethod
    def add_cli_options(cls, parser) -> None:
        """Contribute module-specific CLI options (no-op default)."""

    @abc.abstractmethod
    def initialize(self, config, args) -> SourceInfo:
        """Open the source; may raise ValueError for bad options."""

    @abc.abstractmethod
    def blocks(self, frames_per_block: int) -> Iterator[Block]:
        """Yield blocks of exactly frames_per_block frames (short final ok)."""

    def calibration_frames(self, n: int) -> bytes | None:
        """First n frames for pre-stream I/Q calibration, or None if the
        source can't rewind (files return data and rewind,
        iq_correct.c:237-302)."""
        return None

    def summary(self) -> dict:
        return {}

    def close(self) -> None:
        pass


class OutputModule(abc.ABC):
    name: str = "?"
    requires_output_path: bool = True      # => writer pacing (setup.c:265-267)

    @classmethod
    def add_cli_options(cls, parser) -> None:
        pass

    @abc.abstractmethod
    def initialize(self, config, args) -> None:
        """Open the sink; validate output format."""

    @abc.abstractmethod
    def write(self, payload: bytes) -> None:
        pass

    def finalize(self) -> None:
        """Flush + patch headers; must be safe after partial streams."""

    def summary(self) -> dict:
        return {}
