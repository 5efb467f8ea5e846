"""Byte ring buffer with the reference's real-time semantics
(src/ring_buffer.c):

* writes are NON-BLOCKING and lossy — a full buffer returns a short count
  and the producer drops data (ring_buffer.c:63-95), because a live SDR
  cannot wait;
* reads BLOCK until data, end-of-stream, or shutdown (ring_buffer.c:97-142);
* ``signal_end_of_stream`` drains-then-EOF; ``signal_shutdown`` wakes
  everyone immediately (ring_buffer.c:144-158).
"""

from __future__ import annotations

import threading


class RingBuffer:
    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._buf = bytearray(self.capacity)
        self._lock = threading.Lock()
        self._readable = threading.Condition(self._lock)
        self._head = 0      # write position
        self._tail = 0      # read position
        self._size = 0
        self._eos = False
        self._shutdown = False

    @property
    def size(self) -> int:
        with self._lock:
            return self._size

    @property
    def free(self) -> int:
        with self._lock:
            return self.capacity - self._size

    def write(self, data: bytes) -> int:
        """Non-blocking; returns bytes accepted (short on overrun)."""
        with self._lock:
            if self._shutdown or self._eos:
                return 0
            n = min(len(data), self.capacity - self._size)
            if n == 0:
                return 0
            first = min(n, self.capacity - self._head)
            self._buf[self._head:self._head + first] = data[:first]
            rest = n - first
            if rest:
                self._buf[:rest] = data[first:first + rest]
            self._head = (self._head + n) % self.capacity
            self._size += n
            self._readable.notify_all()
            return n

    def write_all(self, data: bytes) -> bool:
        """All-or-nothing write: False (nothing written) when the free
        space cannot take the whole message.  Producers of FRAMED or
        sample-aligned streams must use this — a partial write would
        shift every later frame boundary (e.g. 6-byte cs24 frames in a
        pow2 ring)."""
        with self._lock:
            if (self._shutdown or self._eos
                    or len(data) > self.capacity - self._size):
                return False
            n = len(data)
            first = min(n, self.capacity - self._head)
            self._buf[self._head:self._head + first] = data[:first]
            rest = n - first
            if rest:
                self._buf[:rest] = data[first:first + rest]
            self._head = (self._head + n) % self.capacity
            self._size += n
            self._readable.notify_all()
            return True

    def read(self, n: int, timeout: float | None = None) -> bytes:
        """Block until n bytes, EOS (returns what's left), or shutdown
        (returns b'')."""
        out = bytearray()
        with self._lock:
            while len(out) < n:
                if self._size == 0:
                    if self._shutdown:
                        return b""
                    if self._eos:
                        break
                    if not self._readable.wait(timeout):
                        break
                    continue
                take = min(n - len(out), self._size)
                first = min(take, self.capacity - self._tail)
                out += self._buf[self._tail:self._tail + first]
                rest = take - first
                if rest:
                    out += self._buf[:rest]
                self._tail = (self._tail + take) % self.capacity
                self._size -= take
        return bytes(out)

    def signal_end_of_stream(self) -> None:
        with self._lock:
            self._eos = True
            self._readable.notify_all()

    def signal_shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            self._readable.notify_all()

    @property
    def end_of_stream(self) -> bool:
        with self._lock:
            return self._eos and self._size == 0

    @property
    def eos_signaled(self) -> bool:
        with self._lock:
            return self._eos


def make_ring(capacity: int):
    """Native C++ SPSC ring when built (multi-GB/s path), Python fallback."""
    from iq_tool_tpu_torch import native
    if native.available():
        return native.NativeRingBuffer(capacity)
    return RingBuffer(capacity)
