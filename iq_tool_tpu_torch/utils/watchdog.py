"""SDR stream watchdog (src/utility_threads.c:58-107).

A live source stamps a heartbeat on every delivery; the watchdog polls
every WATCHDOG_POLL_SEC and, if the heartbeat is stale for more than
WATCHDOG_STALE_SEC, declares the driver hung and terminates the process
(the reference deliberately hard-exits: a wedged USB driver is not
recoverable from userspace).  The kill action is injectable for tests.
"""

from __future__ import annotations

import os
import sys
import threading
import time

from iq_tool_tpu_torch import constants as C


def _default_kill(msg: str) -> None:
    sys.stderr.write(f"\nFATAL: {msg}\n")
    sys.stderr.flush()
    os._exit(1)


class Watchdog:
    def __init__(self, heartbeat_fn, stale_sec: float = C.WATCHDOG_STALE_SEC,
                 poll_sec: float = C.WATCHDOG_POLL_SEC, on_stale=_default_kill):
        """heartbeat_fn: () -> monotonic seconds of the last delivery."""
        self._hb = heartbeat_fn
        self._stale = stale_sec
        self._poll = poll_sec
        self._on_stale = on_stale
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="sdr-watchdog")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            age = time.monotonic() - self._hb()
            if age > self._stale:
                self._on_stale(
                    f"SDR stream stalled: no samples for {age:.1f} s "
                    f"(> {self._stale:.0f} s); the driver is likely hung.")
                return

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=self._poll + 1)
