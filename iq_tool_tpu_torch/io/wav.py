"""Streaming WAV / RF64 container reader and writer (libsndfile subset).

Supports what the reference uses (output_wav_common.c:45-116,
input_wav.c:576-586): 2-channel interleaved PCM16 ('cs16') or U8 ('cu8')
I/Q data, RIFF/WAVE and RF64/ds64 containers, plus raw access to metadata
chunks ('auxi').  The writer streams and patches sizes on close (the
sf_close header-fix behavior, output_wav_common.c:165-174); RF64 writes a
ds64 chunk with 64-bit sizes so >4 GiB captures are valid.
"""

from __future__ import annotations

import dataclasses
import io
import os
import struct

_FMT_PCM = 1

_FORMAT_BY_BITS = {16: "cs16", 8: "cu8"}
_BITS_BY_FORMAT = {"cs16": 16, "cu8": 8}


@dataclasses.dataclass
class WavInfo:
    sample_rate: int
    channels: int
    bits: int
    data_offset: int
    data_bytes: int
    frames: int
    sample_format: str          # cs16 / cu8 (2-channel I/Q)
    chunks: dict                # id -> bytes (small non-data chunks)
    is_rf64: bool
    ds64_offset: int = 12       # RF64 size-chunk position (chunk header)


class WavReader:
    """Chunk-walking reader; random access to the data payload."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self.info = self._parse()
        self._pos_frames = 0

    # -- parsing ---------------------------------------------------------------

    def _parse(self) -> WavInfo:
        f = self._f
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] not in (b"RIFF", b"RF64") or riff[8:12] != b"WAVE":
            raise ValueError(f"{self.path}: not a WAV/RF64 file")
        is_rf64 = riff[:4] == b"RF64"
        ds64_data_size = None
        fmt = None
        data_offset = data_bytes = None
        ds64_offset = 12
        chunks: dict[str, bytes] = {}

        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = struct.unpack("<4sI", hdr)
            if cid == b"ds64":
                ds64_offset = f.tell() - 8
                body = f.read(size)
                riff_sz, data_sz = struct.unpack_from("<QQ", body, 0)
                ds64_data_size = data_sz
            elif cid == b"fmt ":
                body = f.read(size)
                fmt = struct.unpack_from("<HHIIHH", body, 0)
            elif cid == b"data":
                data_offset = f.tell()
                if size == 0xFFFFFFFF and ds64_data_size is not None:
                    data_bytes = ds64_data_size
                else:
                    data_bytes = size
                if data_bytes in (0, 0xFFFFFFFF):
                    # crashed writer left a placeholder size: the data
                    # chunk runs to EOF — walking the payload as chunk
                    # headers would scan gigabytes (or corrupt offsets)
                    break
                f.seek(data_bytes + (data_bytes & 1), io.SEEK_CUR)
            else:
                body = f.read(min(size, 1 << 20))
                chunks[cid.decode("latin1").strip()] = body
                extra = size - len(body)
                if extra > 0:
                    f.seek(extra, io.SEEK_CUR)
            if size & 1 and cid != b"data":
                f.seek(1, io.SEEK_CUR)

        if fmt is None or data_offset is None:
            raise ValueError(f"{self.path}: missing fmt/data chunk")
        audio_fmt, channels, rate, _br, block_align, bits = fmt
        if audio_fmt != _FMT_PCM:
            raise ValueError(f"{self.path}: only PCM supported (fmt {audio_fmt})")
        if channels != 2:
            raise ValueError(
                f"{self.path}: I/Q WAV must have 2 channels, found {channels}")
        if bits not in _FORMAT_BY_BITS:
            raise ValueError(f"{self.path}: unsupported bit depth {bits}")
        # clamp to actual file size (truncated captures are common); an
        # unpatched header (crashed writer) reports 0 -> trust the file size
        fsize = os.fstat(f.fileno()).st_size
        if data_bytes in (0, 0xFFFFFFFF):
            data_bytes = fsize - data_offset
        data_bytes = min(data_bytes, fsize - data_offset)
        frames = data_bytes // block_align
        return WavInfo(sample_rate=rate, channels=channels, bits=bits,
                       data_offset=data_offset, data_bytes=frames * block_align,
                       frames=frames, sample_format=_FORMAT_BY_BITS[bits],
                       chunks=chunks, is_rf64=is_rf64,
                       ds64_offset=ds64_offset)

    # -- streaming ---------------------------------------------------------------

    @property
    def bytes_per_frame(self) -> int:
        return self.info.channels * self.info.bits // 8

    def seek_frames(self, frame: int) -> None:
        self._pos_frames = frame
        self._f.seek(self.info.data_offset + frame * self.bytes_per_frame)

    def read_frames(self, n: int) -> bytes:
        if self._pos_frames == 0 and self._f.tell() != self.info.data_offset:
            self.seek_frames(0)
        n = min(n, self.info.frames - self._pos_frames)
        if n <= 0:
            return b""
        buf = self._f.read(n * self.bytes_per_frame)
        got = len(buf) // self.bytes_per_frame
        self._pos_frames += got
        return buf[: got * self.bytes_per_frame]

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class WavWriter:
    """Streaming writer; finalize() patches the header sizes.

    container: 'wav' (classic RIFF, sizes patched, 4 GiB limit) or 'rf64'
    (RF64 + ds64, 64-bit sizes; what `--output wav` actually produces in
    the reference, config.c:153-156).
    """

    def __init__(self, path_or_file, sample_rate: int, sample_format: str,
                 container: str = "rf64", append: bool = False):
        if sample_format not in _BITS_BY_FORMAT:
            raise ValueError(
                f"WAV output supports cs16/cu8 only, not '{sample_format}' "
                "(output_wav_common.c:45-52)")
        self._own = isinstance(path_or_file, (str, os.PathLike))
        self.container = container
        self.bits = _BITS_BY_FORMAT[sample_format]
        self.block_align = 2 * self.bits // 8
        self.sample_rate = int(sample_rate)
        self.data_bytes = 0
        if append and self._own and os.path.exists(path_or_file):
            # resume: adopt the existing container, seek to the end of data
            r = WavReader(str(path_or_file))
            info = r.info
            r.close()
            if info.bits != self.bits or info.sample_rate != self.sample_rate:
                raise ValueError("existing WAV does not match the resumed "
                                 "stream's format/rate")
            if (info.is_rf64) != (container == "rf64"):
                raise ValueError("existing WAV container differs")
            self._f = open(path_or_file, "r+b")
            self.data_bytes = info.data_bytes
            self._data_start = info.data_offset
            if container == "rf64":
                self._ds64_pos = info.ds64_offset
            else:
                self._data_size_pos = info.data_offset - 4
            self._f.seek(info.data_offset + info.data_bytes)
            return
        self._f = open(path_or_file, "wb") if self._own else path_or_file
        self._write_header()

    def truncate_data(self, data_bytes: int) -> None:
        """Resume reconciliation: cut the data chunk back to data_bytes
        (sizes re-patched at finalize).  A SHORTER file means output the
        checkpoint already counted is missing — resuming would splice a
        silent gap, so that is an error."""
        if self.data_bytes < data_bytes:
            raise ValueError(
                f"output has {self.data_bytes} data bytes but the "
                f"checkpoint expects {data_bytes}: the file lost data "
                "after the checkpoint was written (cannot resume "
                "sample-exactly)")
        if data_bytes < self.data_bytes:
            self._f.truncate(self._data_start + data_bytes)
            self.data_bytes = data_bytes
        self._f.seek(self._data_start + self.data_bytes)

    def _write_header(self) -> None:
        f = self._f
        fmt_body = struct.pack("<HHIIHH", _FMT_PCM, 2, self.sample_rate,
                               self.sample_rate * self.block_align,
                               self.block_align, self.bits)
        if self.container == "rf64":
            f.write(struct.pack("<4sI4s", b"RF64", 0xFFFFFFFF, b"WAVE"))
            # ds64 placeholder: riff size, data size, sample count, 0 extras
            self._ds64_pos = f.tell()
            f.write(struct.pack("<4sI", b"ds64", 28))
            f.write(struct.pack("<QQQI", 0, 0, 0, 0))
            f.write(struct.pack("<4sI", b"fmt ", len(fmt_body)))
            f.write(fmt_body)
            f.write(struct.pack("<4sI", b"data", 0xFFFFFFFF))
        else:
            f.write(struct.pack("<4sI4s", b"RIFF", 0, b"WAVE"))
            f.write(struct.pack("<4sI", b"fmt ", len(fmt_body)))
            f.write(fmt_body)
            self._data_size_pos = f.tell() + 4
            f.write(struct.pack("<4sI", b"data", 0))
        self._data_start = f.tell()

    def write(self, payload: bytes) -> None:
        if (self.container != "rf64"
                and self._data_start + self.data_bytes + len(payload)
                > 0xFFFFFFFF):
            raise ValueError(
                "classic WAV cannot exceed 4 GiB; use the rf64 container "
                "(-o wav) for long captures")
        self._f.write(payload)
        self.data_bytes += len(payload)

    @property
    def frames_written(self) -> int:
        return self.data_bytes // self.block_align

    def finalize(self) -> None:
        f = self._f
        try:
            if self.container == "rf64":
                riff_size = self._data_start - 8 + self.data_bytes
                f.seek(self._ds64_pos + 8)
                f.write(struct.pack("<QQQI", riff_size, self.data_bytes,
                                    self.frames_written, 0))
            else:
                if self.data_bytes > 0xFFFFFFFF - 36:
                    raise ValueError(
                        "classic WAV exceeds 4 GiB; use RF64 (wav-rf64)")
                f.seek(4)
                f.write(struct.pack("<I", self._data_start - 8 + self.data_bytes))
                f.seek(self._data_size_pos)
                f.write(struct.pack("<I", self.data_bytes))
            f.flush()
        finally:
            if self._own:
                f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finalize()
