"""Logging (the rxi log.c role: levels, timestamps, color, pluggable sinks).

Thin configuration over the stdlib logging module; default level INFO
(main.c:116).  All framework messages go through ``get_logger`` so library
users can re-route them.
"""

from __future__ import annotations

import logging
import sys

_LEVELS = {"trace": 5, "debug": logging.DEBUG, "info": logging.INFO,
           "warn": logging.WARNING, "error": logging.ERROR,
           "fatal": logging.CRITICAL}

_COLORS = {5: "\x1b[94m", logging.DEBUG: "\x1b[36m", logging.INFO: "\x1b[32m",
           logging.WARNING: "\x1b[33m", logging.ERROR: "\x1b[31m",
           logging.CRITICAL: "\x1b[35m"}

logging.addLevelName(5, "TRACE")
_configured = False


class _Formatter(logging.Formatter):
    def __init__(self, color: bool):
        super().__init__()
        self.color = color

    def format(self, record):
        ts = self.formatTime(record, "%H:%M:%S")
        lvl = record.levelname
        if self.color:
            c = _COLORS.get(record.levelno, "")
            lvl = f"{c}{lvl:<5}\x1b[0m"
        else:
            lvl = f"{lvl:<5}"
        return f"{ts} {lvl} {record.name}: {record.getMessage()}"


def configure(level: str = "info", stream=None) -> None:
    global _configured
    stream = stream or sys.stderr
    root = logging.getLogger("iq_tool_tpu")
    root.handlers.clear()
    h = logging.StreamHandler(stream)
    h.setFormatter(_Formatter(color=getattr(stream, "isatty", lambda: False)()))
    root.addHandler(h)
    root.setLevel(_LEVELS.get(level.lower(), logging.INFO))
    root.propagate = False
    _configured = True


def get_logger(name: str = "") -> logging.Logger:
    if not _configured:
        configure()
    full = f"iq_tool_tpu.{name}" if name else "iq_tool_tpu"
    return logging.getLogger(full)
