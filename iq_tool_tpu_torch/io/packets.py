"""SDR packet serializer: framed protocol over a byte ring buffer.

Wire-compatible with the reference's IQPK framing
(sdr_packet_serializer.c:12-294): a 10-byte little-endian header
``{magic "IQPK", num_samples: u32, flags: u8, format_id: u8}`` followed by
the sample payload.  Flags: bit 0 = payload interleaved (vs planar
I-plane/Q-plane shorts), bit 1 = stream-reset event (empty payload).

The reader re-synchronizes after corruption by scanning byte-by-byte for
the magic (sdr_packet_serializer.c:111-204) and re-interleaves planar
payloads.  Writers split arbitrary sample runs into <= MAX_PACKET_SAMPLES
packets and drop (with a count) on ring overrun
(sdr_packet_serializer.c:265-294).

This is the transport for the buffered capture->process mode: the
reference designed it but never reached it (pipeline_mode is never
assigned, SURVEY.md section 2c quirk); here it is a real feature.
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

from iq_tool_tpu_torch.formats import FORMATS, get_format
from iq_tool_tpu_torch.utils.ringbuffer import RingBuffer

# Fault injection (soak/test only): corrupt the MAGIC of every K-th
# interleaved packet written, driving the reader's magic-scan resync
# exactly as a torn byte stream would (the reference validates this
# path by hand, sdr_packet_serializer.c:111-204; tools/endurance.py
# --iqpk-soak exercises it end-to-end at the CLI level).  0 = off.
_FAULT_EVERY = int(os.environ.get("IQTOOL_FAULT_IQPK_EVERY", "0") or 0)
_fault_written = 0

MAGIC = b"IQPK"
HEADER = struct.Struct("<4sIBB")
FLAG_INTERLEAVED = 0x01
FLAG_RESET = 0x02
MAX_PACKET_SAMPLES = 16384

_FORMAT_IDS = {name: i for i, name in enumerate(FORMATS)}
_ID_FORMATS = {i: name for name, i in _FORMAT_IDS.items()}


@dataclasses.dataclass
class Packet:
    payload: bytes            # interleaved wire bytes (already de-planarized)
    num_samples: int
    format_name: str
    reset: bool = False


def write_reset_event(ring: RingBuffer, fmt_name: str) -> bool:
    hdr = HEADER.pack(MAGIC, 0, FLAG_RESET | FLAG_INTERLEAVED,
                      _FORMAT_IDS[fmt_name])
    # all-or-nothing: a truncated header would inject orphan bytes into
    # the framed stream and force a resync
    return ring.write_all(hdr)


def write_interleaved_chunks(ring: RingBuffer, data: bytes, fmt_name: str) -> int:
    """Split into <= MAX_PACKET_SAMPLES packets; returns samples DROPPED."""
    fmt = get_format(fmt_name)
    bpf = fmt.bytes_per_frame
    total = len(data) // bpf
    dropped = 0
    off = 0
    fid = _FORMAT_IDS[fmt_name]
    while off < total:
        n = min(MAX_PACKET_SAMPLES, total - off)
        chunk = data[off * bpf:(off + n) * bpf]
        hdr = HEADER.pack(MAGIC, n, FLAG_INTERLEAVED, fid)
        if _FAULT_EVERY:
            global _fault_written
            _fault_written += 1
            if _fault_written % _FAULT_EVERY == 0:
                hdr = b"XQPK" + hdr[4:]   # torn header: reader must resync
        if not ring.write_all(hdr + chunk):
            dropped += total - off
            break
        off += n
    return dropped


def write_planar_shorts(ring: RingBuffer, xi: np.ndarray, xq: np.ndarray,
                        fmt_name: str = "cs16") -> int:
    """De-interleaved short planes (the sdrplay callback shape,
    input_sdrplay.c:470).  Returns samples dropped."""
    assert xi.dtype == np.int16 and xq.dtype == np.int16 and len(xi) == len(xq)
    total = len(xi)
    dropped = 0
    off = 0
    fid = _FORMAT_IDS[fmt_name]
    while off < total:
        n = min(MAX_PACKET_SAMPLES, total - off)
        payload = xi[off:off + n].tobytes() + xq[off:off + n].tobytes()
        hdr = HEADER.pack(MAGIC, n, 0, fid)   # planar: interleaved bit clear
        if ring.free < len(hdr) + len(payload):
            dropped += total - off
            break
        ring.write(hdr)
        ring.write(payload)
        off += n
    return dropped


class PacketReader:
    """Streaming reader with byte-wise magic-scan resynchronization."""

    def __init__(self, ring: RingBuffer):
        self.ring = ring
        self.resync_count = 0

    def _read(self, n: int) -> bytes:
        return self.ring.read(n)

    def read_packet(self) -> Packet | None:
        """Next valid packet, or None at end of stream."""
        hdr = self._read(HEADER.size)
        if len(hdr) < HEADER.size:
            return None
        while True:
            magic, num, flags, fid = HEADER.unpack(hdr)
            if magic == MAGIC and fid in _ID_FORMATS and num <= MAX_PACKET_SAMPLES:
                break
            # resync: shift one byte, scan for the magic
            self.resync_count += 1
            nxt = self._read(1)
            if not nxt:
                return None
            hdr = hdr[1:] + nxt
        fmt_name = _ID_FORMATS[fid]
        if flags & FLAG_RESET:
            return Packet(b"", 0, fmt_name, reset=True)
        fmt = get_format(fmt_name)
        size = num * fmt.bytes_per_frame
        payload = self._read(size)
        if len(payload) < size:
            return None
        if not flags & FLAG_INTERLEAVED:
            # planar shorts -> interleave (sdr_packet_serializer.c:228-262)
            xi = np.frombuffer(payload[: size // 2], np.int16)
            xq = np.frombuffer(payload[size // 2:], np.int16)
            inter = np.empty(num * 2, np.int16)
            inter[0::2], inter[1::2] = xi, xq
            payload = inter.tobytes()
        return Packet(payload, num, fmt_name)
