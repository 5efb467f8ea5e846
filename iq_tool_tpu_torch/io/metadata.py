"""SDR capture metadata: auxi chunks and SDR#-style filenames.

Mirrors input_wav.c:104-432:
* `auxi` XML (SDR Console / SDRconnect): <Definition> attributes
  SoftwareName, SoftwareVersion, RadioModel, RadioCenterFreq, UTCSeconds,
  CurrentTimeUTC ("DD-MM-YYYY HH:MM:SS") (input_wav.c:335-432);
* `auxi` binary (SDRuno): 16-byte SYSTEMTIME then uint32 center freq at
  byte offset 32 (input_wav.c:294-333);
* filename: center frequency = the number between the last '_' before a
  case-insensitive "Hz" marker; timestamp "_YYYYMMDD_HHMMSSZ"; software
  inferred (SDR# when either matched; SDRuno_/SDRconnect_ prefixes)
  (input_wav.c:190-271).
"""

from __future__ import annotations

import calendar
import dataclasses
import re
import struct
import xml.etree.ElementTree as ET


@dataclasses.dataclass
class SdrMetadata:
    software_name: str | None = None
    software_version: str | None = None
    radio_model: str | None = None
    center_freq_hz: float | None = None
    timestamp_unix: int | None = None
    timestamp_str: str | None = None
    source_software: str = "Unknown"

    def merge_missing(self, other: "SdrMetadata") -> None:
        for f in dataclasses.fields(self):
            if getattr(self, f.name) in (None, "Unknown"):
                v = getattr(other, f.name)
                if v not in (None, "Unknown"):
                    setattr(self, f.name, v)


def parse_auxi(chunk: bytes) -> SdrMetadata | None:
    md = _parse_auxi_xml(chunk)
    if md is not None:
        return md
    return _parse_auxi_binary(chunk)


def _parse_auxi_xml(chunk: bytes) -> SdrMetadata | None:
    text = chunk.split(b"\x00", 1)[0].strip()
    if not text.startswith(b"<"):
        return None
    try:
        root = ET.fromstring(text.decode("utf-8", "replace"))
    except ET.ParseError:
        return None
    md = SdrMetadata()
    found = False
    elems = [root] if root.tag == "Definition" else root.iter("Definition")
    for el in elems:
        a = el.attrib
        if "SoftwareName" in a:
            md.software_name = a["SoftwareName"]
            found = True
        if "SoftwareVersion" in a:
            md.software_version = a["SoftwareVersion"]
            found = True
        if "RadioModel" in a:
            md.radio_model = a["RadioModel"]
            found = True
        if "RadioCenterFreq" in a:
            try:
                md.center_freq_hz = float(a["RadioCenterFreq"])
                found = True
            except ValueError:
                pass
        if "UTCSeconds" in a and md.timestamp_unix is None:
            try:
                md.timestamp_unix = int(float(a["UTCSeconds"]))
                found = True
            except ValueError:
                pass
        if "CurrentTimeUTC" in a:
            md.timestamp_str = a["CurrentTimeUTC"]
            m = re.match(r"(\d+)-(\d+)-(\d+)\s+(\d+):(\d+):(\d+)",
                         a["CurrentTimeUTC"])
            if m:  # DD-MM-YYYY HH:MM:SS (input_wav.c:389-400)
                d, mo, y, h, mi, s = map(int, m.groups())
                try:
                    md.timestamp_unix = calendar.timegm((y, mo, d, h, mi, s))
                except (ValueError, OverflowError):
                    pass
            found = True
    if not found:
        return None
    if md.software_name and "SDR Console" in md.software_name:
        md.source_software = "SDR Console"
    return md


def _parse_auxi_binary(chunk: bytes) -> SdrMetadata | None:
    if len(chunk) < 36:  # SYSTEMTIME(16) + 16 + uint32 (input_wav.c:295)
        return None
    md = SdrMetadata()
    y, mo, _dow, d, h, mi, s, _ms = struct.unpack_from("<8H", chunk, 0)
    try:
        md.timestamp_unix = calendar.timegm((y, mo, d, h, mi, s))
        md.timestamp_str = f"{y:04d}-{mo:02d}-{d:02d} {h:02d}:{mi:02d}:{s:02d} UTC"
    except (ValueError, OverflowError):
        pass
    (freq,) = struct.unpack_from("<I", chunk, 32)
    if freq > 0:
        md.center_freq_hz = float(freq)
    if md.timestamp_unix is None and md.center_freq_hz is None:
        return None
    return md


def parse_filename(name: str) -> SdrMetadata | None:
    """SDR#-style '..._YYYYMMDD_HHMMSSZ_<freq>Hz...' (input_wav.c:190-271)."""
    md = SdrMetadata()
    inferred_sharp = False

    # take the LAST 'Hz' marker whose preceding _-delimited token is a
    # number: names like 'notch_60Hz_..._145000000Hz.wav' must pick the
    # capture frequency, not an incidental earlier marker
    for m in reversed(list(re.finditer(r"[Hh][Zz]", name))):
        before = name[: m.start()]
        us = before.rfind("_")
        if us >= 0 and us + 1 < len(before):
            try:
                freq = float(before[us + 1:])
            except ValueError:
                continue
            if freq > 0:
                md.center_freq_hz = freq
                inferred_sharp = True
                break

    tm = re.search(r"_(\d{4})(\d{2})(\d{2})_(\d{2})(\d{2})(\d{2})Z", name)
    if tm:
        y, mo, d, h, mi, s = map(int, tm.groups())
        try:
            md.timestamp_unix = calendar.timegm((y, mo, d, h, mi, s))
            md.timestamp_str = (f"{y:04d}-{mo:02d}-{d:02d} "
                                f"{h:02d}:{mi:02d}:{s:02d} UTC")
            inferred_sharp = True
        except (ValueError, OverflowError):
            pass

    if inferred_sharp:
        md.source_software = "SDR#"
        md.software_name = "SDR#"
    elif name.startswith("SDRuno_"):
        md.source_software = "SDRuno"
        md.software_name = "SDRuno"
    elif name.startswith("SDRconnect_"):
        md.source_software = "SDRconnect"
        md.software_name = "SDRconnect"
    else:
        return None
    return md
