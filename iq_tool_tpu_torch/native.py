"""ctypes bindings for the native host-runtime library (native/iqnative.cpp).

The compute path is XLA; this native layer accelerates host-side byte
handling (ring buffers, cs24 packing, interleave, positional reads) where
pure Python would bottleneck multi-GB/s streams.  Everything degrades
gracefully: ``available()`` is False if the library isn't built and all
users fall back to the numpy/Python implementations.

Build: ``cmake -S native -B native/build && cmake --build native/build``
(or ``ensure_built()``, which runs exactly that).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_HERE, "native")
_SO = os.path.join(_NATIVE_DIR, "build", "libiqnative.so")

_lib = None
_lock = threading.Lock()


def _bind(lib) -> None:
    lib.iq_ring_create.restype = ctypes.c_void_p
    lib.iq_ring_create.argtypes = [ctypes.c_size_t]
    lib.iq_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.iq_ring_write.restype = ctypes.c_size_t
    lib.iq_ring_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_size_t]
    lib.iq_ring_read.restype = ctypes.c_size_t
    lib.iq_ring_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_size_t]
    lib.iq_ring_read_timed.restype = ctypes.c_size_t
    lib.iq_ring_read_timed.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_size_t, ctypes.c_long]
    lib.iq_ring_size.restype = ctypes.c_size_t
    lib.iq_ring_size.argtypes = [ctypes.c_void_p]
    lib.iq_ring_signal_eos.argtypes = [ctypes.c_void_p]
    lib.iq_ring_signal_shutdown.argtypes = [ctypes.c_void_p]
    lib.iq_ring_eos.restype = ctypes.c_int
    lib.iq_ring_eos.argtypes = [ctypes.c_void_p]
    for name in ("iq_unpack_cs24", "iq_pack_cs24"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_size_t]
    lib.iq_interleave_shorts.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_void_p, ctypes.c_size_t]
    lib.iq_native_abi_version.restype = ctypes.c_int


def load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.isfile(_SO):
            return None
        lib = ctypes.CDLL(_SO)
        _bind(lib)
        if lib.iq_native_abi_version() != 2:
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def ensure_built(quiet: bool = True) -> bool:
    """Build the native library if a toolchain is present."""
    if os.path.isfile(_SO):
        return available()
    build = os.path.join(_NATIVE_DIR, "build")
    try:
        kw = {"capture_output": True} if quiet else {}
        subprocess.run(["cmake", "-S", _NATIVE_DIR, "-B", build,
                        "-DCMAKE_BUILD_TYPE=Release"], check=True, **kw)
        subprocess.run(["cmake", "--build", build, "-j"], check=True, **kw)
    except (OSError, subprocess.CalledProcessError):
        return False
    return available()


class NativeRingBuffer:
    """Drop-in for utils.ringbuffer.RingBuffer backed by the C++ ring."""

    def __init__(self, capacity: int):
        lib = load()
        if lib is None:
            raise RuntimeError("native library not built")
        self._lib = lib
        self.capacity = capacity
        self._h = lib.iq_ring_create(capacity)
        if not self._h:
            raise MemoryError("iq_ring_create failed")
        self._eos_flag = False

    def write(self, data: bytes) -> int:
        return self._lib.iq_ring_write(self._h, data, len(data))

    def write_all(self, data: bytes) -> bool:
        """All-or-nothing (safe SPSC: only the producer moves `free` down)."""
        if len(data) > self.free:
            return False
        return self.write(data) == len(data)

    def read(self, n: int, timeout=None) -> bytes:
        out = ctypes.create_string_buffer(n)
        ms = -1 if timeout is None else max(0, int(timeout * 1000))
        got = self._lib.iq_ring_read_timed(self._h, out, n, ms)
        return out.raw[:got]

    @property
    def size(self) -> int:
        return self._lib.iq_ring_size(self._h)

    @property
    def free(self) -> int:
        return self.capacity - self.size

    def signal_end_of_stream(self) -> None:
        self._eos_flag = True
        self._lib.iq_ring_signal_eos(self._h)

    def signal_shutdown(self) -> None:
        self._lib.iq_ring_signal_shutdown(self._h)

    @property
    def end_of_stream(self) -> bool:
        return bool(self._lib.iq_ring_eos(self._h))

    @property
    def eos_signaled(self) -> bool:
        return self._eos_flag

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._h = None
            # destroy wakes + drains blocked readers before freeing
            self._lib.iq_ring_destroy(h)


def unpack_cs24(data: bytes) -> np.ndarray:
    """3-byte LE signed -> int32 array (native if available)."""
    n = len(data) // 3
    lib = load()
    out = np.empty(n, np.int32)
    if lib is not None:
        lib.iq_unpack_cs24(data, out.ctypes.data_as(ctypes.c_void_p), n)
        return out
    b = np.frombuffer(data, np.uint8)[: n * 3].reshape(n, 3).astype(np.int32)
    return ((b[:, 0] << 8) | (b[:, 1] << 16) | (b[:, 2] << 24)) >> 8


def pack_cs24(values: np.ndarray) -> bytes:
    values = np.ascontiguousarray(values, np.int32)
    n = len(values)
    lib = load()
    if lib is not None:
        out = np.empty(n * 3, np.uint8)
        lib.iq_pack_cs24(values.ctypes.data_as(ctypes.c_void_p),
                         out.ctypes.data_as(ctypes.c_void_p), n)
        return out.tobytes()
    v = values.astype(np.uint32)
    out = np.empty((n, 3), np.uint8)
    out[:, 0] = v & 0xFF
    out[:, 1] = (v >> 8) & 0xFF
    out[:, 2] = (v >> 16) & 0xFF
    return out.tobytes()


def interleave_shorts(xi: np.ndarray, xq: np.ndarray) -> np.ndarray:
    xi = np.ascontiguousarray(xi, np.int16)
    xq = np.ascontiguousarray(xq, np.int16)
    if len(xi) != len(xq):
        raise ValueError(f"planar length mismatch: {len(xi)} vs {len(xq)}")
    n = len(xi)
    out = np.empty(n * 2, np.int16)
    lib = load()
    if lib is not None:
        lib.iq_interleave_shorts(xi.ctypes.data_as(ctypes.c_void_p),
                                 xq.ctypes.data_as(ctypes.c_void_p),
                                 out.ctypes.data_as(ctypes.c_void_p), n)
    else:
        out[0::2], out[1::2] = xi, xq
    return out
