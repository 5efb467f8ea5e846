"""spyserver-client input (src/input_spyserver_client.c).

Implements the SpyServer protocol v2.0.1700: HELLO handshake -> DeviceInfo
-> ClientSync, decimation-stage sample-rate negotiation (closest of
max_rate / 2^i), device settings (frequency, decimation, format, gain,
digital gain, streaming mode/enable), then a producer thread that frames
IQ messages into a 16 MB ring buffer; the consumer pre-buffers to 50%
before streaming starts (input_spyserver_client.c:330-610,
constants.h:238-239).
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Iterator

from iq_tool_tpu_torch import __version__
from iq_tool_tpu_torch.formats import get_format
from iq_tool_tpu_torch.modules.base import Block, InputModule, SourceInfo
from iq_tool_tpu_torch.utils.ringbuffer import RingBuffer
from iq_tool_tpu_torch.utils.ringbuffer import make_ring as _make_ring

PROTOCOL_VERSION = (2 << 24) | (0 << 16) | 1700

CMD_HELLO = 0
CMD_SET_SETTING = 2

SETTING_STREAMING_MODE = 0
SETTING_STREAMING_ENABLED = 1
SETTING_GAIN = 2
SETTING_IQ_FORMAT = 100
SETTING_IQ_FREQUENCY = 101
SETTING_IQ_DECIMATION = 102
SETTING_IQ_DIGITAL_GAIN = 103

STREAM_MODE_IQ_ONLY = 1

MSG_DEVICE_INFO = 0
MSG_CLIENT_SYNC = 1
MSG_UINT8_IQ = 100
MSG_INT16_IQ = 101
MSG_INT24_IQ = 102
MSG_FLOAT_IQ = 103

DEV_AIRSPY_ONE = 1

_MSG_HEADER = struct.Struct("<5I")        # ProtocolID, MsgType, StreamType, Seq, BodySize
_CMD_HEADER = struct.Struct("<2I")
_DEVICE_INFO = struct.Struct("<12I")
_CLIENT_SYNC = struct.Struct("<9I")

_FMT_TO_ENUM = {"cu8": 1, "cs16": 2, "cs24": 3, "cf32": 4}
_ENUM_TO_FMT = {v: k for k, v in _FMT_TO_ENUM.items()}

STREAM_BUFFER_BYTES = 16 << 20            # constants.h:238
PREBUFFER_HIGH_WATER = 0.5                # constants.h:239


def _recv_all(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if not buf:
                # clean close at a message boundary = end of stream
                raise EOFError("spyserver closed the stream")
            raise ConnectionError("connection lost mid-message")
        buf += chunk
    return bytes(buf)


class SpyServerInput(InputModule):
    name = "spyserver-client"
    is_realtime = True

    def __init__(self):
        self._sock: socket.socket | None = None
        self._ring: RingBuffer | None = None
        self._producer: threading.Thread | None = None
        self._fmt = None
        self._rate = 0.0
        self._device_info = None
        self._stop = threading.Event()
        self._error: Exception | None = None
        self._dropped_msgs = 0
        self.heartbeat = 0.0

    @classmethod
    def add_cli_options(cls, parser) -> None:
        g = parser.add_argument_group("SpyServer Client Options")
        g.add_argument("--spyserver-client-host", metavar="HOST",
                       help="Hostname or IP of the spyserver instance (required)")
        g.add_argument("--spyserver-client-port", type=int, metavar="PORT",
                       help="Port of the spyserver instance (required)")
        g.add_argument("--spyserver-client-gain", type=int, metavar="G",
                       help="Manual gain index (disables server AGC)")
        g.add_argument("--spyserver-client-format", default="cu8", metavar="F",
                       help="Sample format {cu8|cs16|cs24|cf32}, default cu8")

    # ------------------------------------------------------------- protocol

    def _send_command(self, cmd: int, body: bytes) -> None:
        self._sock.sendall(_CMD_HEADER.pack(cmd, len(body)) + body)

    def _send_setting(self, setting: int, value: int) -> None:
        self._send_command(CMD_SET_SETTING,
                           struct.pack("<2I", setting, int(value) & 0xFFFFFFFF))

    def _recv_message(self):
        hdr = _recv_all(self._sock, _MSG_HEADER.size)
        proto, mtype, stype, seq, body_size = _MSG_HEADER.unpack(hdr)
        body = _recv_all(self._sock, body_size) if body_size else b""
        return mtype, body

    def initialize(self, config, args) -> SourceInfo:
        host = getattr(args, "spyserver_client_host", None)
        port = getattr(args, "spyserver_client_port", None)
        if not host or not port:
            raise ValueError("spyserver-client requires --spyserver-client-host "
                             "and --spyserver-client-port")
        rf_freq = getattr(args, "sdr_rf_freq", None)
        if not rf_freq:
            raise ValueError("SDR inputs require --sdr-rf-freq")
        self._gain = getattr(args, "spyserver_client_gain", None)
        req_fmt = getattr(args, "spyserver_client_format", "cu8")
        if req_fmt not in _FMT_TO_ENUM:
            raise ValueError(f"spyserver format must be one of "
                             f"{sorted(_FMT_TO_ENUM)}, got '{req_fmt}'")

        self._sock = socket.create_connection((host, int(port)), timeout=30)
        # keep a deadline through the handshake: a service that accepts TCP
        # but never answers must error out, not hang the CLI forever
        self._sock.settimeout(30)

        # HELLO: protocol version + user agent
        agent = f"iq_tool_tpu version {__version__}".encode()
        self._send_command(CMD_HELLO,
                           struct.pack("<I", PROTOCOL_VERSION) + agent)

        mtype, body = self._recv_message()
        if mtype != MSG_DEVICE_INFO:
            raise ValueError(
                f"did not receive DeviceInfo after handshake (type={mtype}); "
                "server may have rejected the connection")
        if len(body) != _DEVICE_INFO.size:
            raise ValueError(f"DeviceInfo size {len(body)} != {_DEVICE_INFO.size}")
        di = _DEVICE_INFO.unpack(body)
        (dev_type, serial, max_sr, max_bw, dec_count, gain_stages,
         max_gain, min_freq, max_freq, resolution, min_dec, forced_fmt) = di
        self._device_info = di

        mtype, body = self._recv_message()
        if mtype != MSG_CLIENT_SYNC:
            raise ValueError("did not receive ClientSync after DeviceInfo")
        if len(body) < _CLIENT_SYNC.size:
            raise ValueError("ClientSync too small; protocol mismatch")
        sync = _CLIENT_SYNC.unpack(body[:_CLIENT_SYNC.size])
        if sync[0] == 0:
            raise ValueError("cannot control the remote device "
                             "(another client has control)")
        # full ClientSync decode (input_spyserver_client.c:154-164): gain,
        # device/IQ center frequencies and the tunable IQ range — kept for
        # the configuration summary and range checks
        (self._can_control, self._sync_gain, self._dev_center_hz,
         self._iq_center_hz, _fft_center, self._iq_min_hz,
         self._iq_max_hz, _fft_min, _fft_max) = sync

        # format negotiation: server may force one
        final_fmt = req_fmt
        if forced_fmt != 0 and forced_fmt in _ENUM_TO_FMT:
            if _ENUM_TO_FMT[forced_fmt] != req_fmt:
                final_fmt = _ENUM_TO_FMT[forced_fmt]
        self._fmt = get_format(final_fmt)

        # rate negotiation: closest of max_sr / 2^i, i in [min_dec, dec_count]
        rates = [max_sr / (1 << i) for i in range(min_dec, dec_count + 1)][:32]
        if not rates:
            rates = [float(max_sr)]
        user_rate = getattr(args, "sdr_sample_rate", None) or rates[0]
        best = min(range(len(rates)), key=lambda i: abs(rates[i] - user_rate))
        self._rate = rates[best]
        dec_index = min_dec + best

        self._send_setting(SETTING_IQ_FREQUENCY, int(rf_freq))
        self._send_setting(SETTING_IQ_DECIMATION, dec_index)
        self._send_setting(SETTING_IQ_FORMAT, _FMT_TO_ENUM[final_fmt])
        if self._gain is not None:
            self._send_setting(SETTING_GAIN, self._gain)
        # digital gain formula per device type (input_spyserver_client.c:507-515)
        if dev_type == DEV_AIRSPY_ONE:
            gidx = self._gain if self._gain is not None else 0
            dg = float(max_gain - gidx) + dec_index * 3.01
        else:
            dg = dec_index * 3.01
        self._send_setting(SETTING_IQ_DIGITAL_GAIN, int(dg))
        self._send_setting(SETTING_STREAMING_MODE, STREAM_MODE_IQ_ONLY)

        self._ring = _make_ring(STREAM_BUFFER_BYTES)
        return SourceInfo(sample_rate=self._rate,
                          sample_format=final_fmt, total_frames=None)

    # ------------------------------------------------------------- streaming

    def _producer_loop(self) -> None:
        # handshake done; streaming reads block indefinitely (watchdog covers stalls)
        self._sock.settimeout(None)
        import time
        try:
            while not self._stop.is_set():
                mtype, body = self._recv_message()
                if mtype not in (MSG_UINT8_IQ, MSG_INT16_IQ, MSG_INT24_IQ,
                                 MSG_FLOAT_IQ):
                    continue
                if not body:
                    continue
                # all-or-nothing: a partial write would shift every later
                # sample/frame boundary (cs24 frames in a pow2 ring)
                if not self._ring.write_all(body):
                    self._dropped_msgs += 1
                    if self._dropped_msgs in (1, 100, 10000):
                        from iq_tool_tpu_torch.utils.log import get_logger
                        get_logger("spyserver").warning(
                            "ring full: dropped %d IQ messages so far",
                            self._dropped_msgs)
                self.heartbeat = time.monotonic()
        except EOFError:
            pass  # clean end of stream
        except (ConnectionError, OSError) as e:
            if not self._stop.is_set():
                self._error = e
        finally:
            self._ring.signal_end_of_stream()

    def blocks(self, frames_per_block: int) -> Iterator[Block]:
        import time
        self._send_setting(SETTING_STREAMING_ENABLED, 1)
        self.heartbeat = time.monotonic()
        self._producer = threading.Thread(target=self._producer_loop,
                                          daemon=True, name="spyserver-rx")
        self._producer.start()

        # pre-buffer to the high-water mark before streaming starts
        high = int(STREAM_BUFFER_BYTES * PREBUFFER_HIGH_WATER)
        while (self._ring.size < high and not self._ring.eos_signaled
               and not self._stop.is_set() and self._error is None):
            time.sleep(0.05)

        bpf = self._fmt.bytes_per_frame
        want = frames_per_block * bpf
        while True:
            buf = self._ring.read(want)
            if self._error is not None:
                raise ConnectionError(f"spyserver stream lost: {self._error}")
            if not buf:
                return
            yield Block(payload=buf[: len(buf) // bpf * bpf])
            if len(buf) < want:
                return

    def summary(self) -> dict:
        out = {"SpyServer Rate": f"{self._rate:.0f} Hz",
               "SpyServer Format": self._fmt.name if self._fmt else "?"}
        if self._device_info:
            out["Device Type"] = {1: "Airspy One", 2: "Airspy HF",
                                  3: "RTL-SDR"}.get(self._device_info[0],
                                                    "unknown")
        if getattr(self, "_dev_center_hz", None) is not None:
            out["Device Center"] = f"{self._dev_center_hz / 1e6:.6f} MHz"
            out["IQ Center"] = f"{self._iq_center_hz / 1e6:.6f} MHz"
            out["IQ Tunable Range"] = (f"{self._iq_min_hz / 1e6:.3f}-"
                                       f"{self._iq_max_hz / 1e6:.3f} MHz")
            out["Server Gain"] = str(self._sync_gain)
        return out

    def close(self) -> None:
        self._stop.set()
        if self._sock:
            try:
                self._send_setting(SETTING_STREAMING_ENABLED, 0)
            except OSError:
                pass
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sock.close()
            self._sock = None
        if self._ring:
            self._ring.signal_shutdown()
        if self._producer and self._producer.is_alive():
            self._producer.join(timeout=2)
