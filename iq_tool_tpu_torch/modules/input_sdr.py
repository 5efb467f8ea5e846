"""Local SDR hardware inputs: rtlsdr, sdrplay, hackrf, bladerf.

TPU hosts have no radio hardware attached, but the modules keep full
option-surface and behavioral parity with the reference
(input_rtlsdr.c / input_sdrplay.c / input_hackrf.c / input_bladerf.c):

* every CLI option is registered so --help and validation match;
* device-independent logic (rtlsdr 10x integer gain mapping, bladerf
  adaptive stream profiles and dynamic transfer sizing, rate bounds) is
  implemented and unit-tested;
* rtlsdr (sync reads), hackrf (libusb-async RX callback), bladerf
  (sync RX with adaptive stream profiles + FPGA load) and sdrplay
  (API-service planar-short callbacks, modules/sdrplay_api.py binding)
  all have real ctypes driver paths used when the shared library is
  present (the reference similarly dlopen()s vendor DLLs at runtime,
  input_sdrplay.c:57-167, input_bladerf.c:79-143).

All hardware callbacks feed the same lossy RingBuffer + heartbeat pattern
as the SpyServer client (SURVEY.md section 3.3).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import sys
import threading
import time
from typing import Iterator

from iq_tool_tpu_torch import constants as C
from iq_tool_tpu_torch.modules.base import Block, InputModule, SourceInfo
from iq_tool_tpu_torch.utils.ringbuffer import make_ring as _make_ring


def find_driver_lib(*names: str) -> str | None:
    """Resolve a vendor driver library: the IQTOOL_<NAME>_LIB env var
    (explicit path, checked first — the runtime analog of the
    reference's manual dependency-path overrides, CMakeLists.txt:96-120,
    and what the fake-driver e2e harness uses) or ctypes.util's search.
    """
    for name in names:
        override = os.environ.get(f"IQTOOL_{name.upper()}_LIB")
        if override:
            return override
    for name in names:
        found = ctypes.util.find_library(name)
        if found:
            return found
    return None


def _require(args, name: str, flag: str):
    v = getattr(args, name, None)
    if not v:
        raise ValueError(f"SDR inputs require {flag}")
    return v


# ------------------------------- pure logic ----------------------------------

def rtlsdr_gain_to_tenths(gain_db: float) -> int:
    """rtlsdr API takes tenths of dB as int (input_rtlsdr.c:113-116)."""
    return int(round(gain_db * 10.0))


def bladerf_stream_profile(sample_rate_hz: float) -> dict:
    """Adaptive stream profiles by rate (input_bladerf.c:537-552,
    constants.h:224-234): <1 / 1-5 / >=5 MSPS."""
    if sample_rate_hz < 1e6:
        return {"num_buffers": 16, "buffer_size": 8192, "num_transfers": 8}
    if sample_rate_hz < 5e6:
        return {"num_buffers": 32, "buffer_size": 16384, "num_transfers": 16}
    return {"num_buffers": 64, "buffer_size": 32768, "num_transfers": 32}


def bladerf_transfer_samples(sample_rate_hz: float) -> int:
    """Dynamic transfer size: 0.25 s of samples clamped to [4096, 16384],
    1024-aligned (input_bladerf.c:591-595)."""
    n = int(sample_rate_hz * 0.25)
    n = max(4096, min(16384, n))
    return (n // 1024) * 1024


#: bladerf_fpga_size enum (bladeRF.h) -> hosted bitstream filename
#: (input_bladerf.c:806-812).
BLADERF_FPGA_FILENAMES = {
    40: "hostedx40.rbf",      # BLADERF_FPGA_40KLE
    115: "hostedx115.rbf",    # BLADERF_FPGA_115KLE
    49: "hostedxA4.rbf",      # BLADERF_FPGA_A4
    77: "hostedxA5.rbf",      # BLADERF_FPGA_A5
    301: "hostedxA9.rbf",     # BLADERF_FPGA_A9
}


def bladerf_fpga_filename(fpga_size: int) -> str:
    """Map the device's reported FPGA size to the hosted bitstream name
    (input_bladerf.c:806-812); unknown sizes are a hard error there too
    (:813-815)."""
    try:
        return BLADERF_FPGA_FILENAMES[int(fpga_size)]
    except KeyError:
        raise ValueError(
            f"unknown or unsupported BladeRF FPGA size ({fpga_size}); "
            "cannot determine the FPGA file (input_bladerf.c:813-815)"
        ) from None


def bladerf_fpga_search_paths(filename: str) -> list:
    """Candidate paths for an auto-loaded bitstream, probed in order
    (input_bladerf.c:873-877: exe dir, its parent, then the system share
    dirs, each + fpga/bladerf/<name>).  IQTOOL_BLADERF_FPGA_DIR, when
    set, is an explicit single directory checked first — the runtime
    analog of the reference's manual dependency-path overrides."""
    bases = []
    override = os.environ.get("IQTOOL_BLADERF_FPGA_DIR")
    if override:
        return [os.path.join(override, filename)]
    exe_dir = os.path.dirname(os.path.abspath(sys.argv[0] or "."))
    bases += [exe_dir, os.path.dirname(exe_dir)]
    bases += ["/usr/local/share/iq_tool_tpu", "/usr/share/iq_tool_tpu"]
    return [os.path.join(b, "fpga", "bladerf", filename) for b in bases]


def hackrf_validate_rate(rate_hz: float) -> None:
    """hackrf supports 2-20 MHz (input_hackrf.c:130)."""
    if not (2e6 <= rate_hz <= 20e6):
        raise ValueError(f"hackrf sample rate must be 2-20 MHz, got {rate_hz}")


def bladerf_needs_oversample(rate_hz: float) -> bool:
    """>61.44 MHz requires the oversample feature + 8-bit mode
    (input_bladerf.c:389-399)."""
    return rate_hz > 61.44e6


def bladerf_resolve_bit_depth(rate_hz: float,
                              bit_depth_arg: int | None) -> tuple[int, bool]:
    """(active_bits, auto_switched).  input_bladerf.c:251-275: rates above
    61.44 MHz force 8-bit (12-bit request there is an error); otherwise
    the user choice (default 12)."""
    if bladerf_needs_oversample(rate_hz):
        if bit_depth_arg == 12:
            raise ValueError(
                "the BladeRF does not support 12-bit mode for sample rates "
                "above 61440000 Hz (input_bladerf.c:258-260)")
        return 8, bit_depth_arg is None
    if bit_depth_arg is None:
        return 12, False
    if bit_depth_arg not in (8, 12):
        raise ValueError("--bladerf-bit-depth must be 8 or 12")
    return bit_depth_arg, False


# ------------------------------- base class ----------------------------------

class _SdrInputBase(InputModule):
    is_realtime = True
    native_format = "cu8"
    default_rate = 2_400_000.0
    ring_bytes = 64 << 20

    def __init__(self):
        self._ring = _make_ring(self.ring_bytes)
        self._stop = threading.Event()
        self.heartbeat = 0.0
        self._rate = self.default_rate
        self._fmt = None
        self._buffered = False
        self._reset_pending = False
        self._dropped = 0
        self._dropped_warns = 0
        # monotonic event counter, not a flag: the driver-thread producer
        # only increments and the consumer only compares/latches, so a
        # reset arriving between the consumer's read and its state update
        # is seen on the next block instead of erased (a read-then-clear
        # flag would lose it entirely)
        self._rt_reset = 0
        self._rt_reset_seen = 0
        self._reader_thread: threading.Thread | None = None

    def _common_init(self, args) -> None:
        from iq_tool_tpu_torch.formats import get_format
        _require(args, "sdr_rf_freq", "--sdr-rf-freq")
        self._rate = getattr(args, "sdr_sample_rate", None) or self.default_rate
        self._fmt = get_format(self.native_format)
        self._buffered = bool(getattr(args, "sdr_buffered", False))

    # -- producer-side helpers (hardware callbacks call these) ----------------

    def _deliver(self, payload: bytes) -> None:
        """Samples from the hardware callback into the ring (realtime: raw
        bytes; buffered: IQPK packets with resync framing)."""
        if self._buffered:
            from iq_tool_tpu_torch.io import packets
            if self._reset_pending:
                # a reset event was dropped on a full ring earlier: it MUST
                # precede any further data or the gap would be spliced
                if packets.write_reset_event(self._ring, self._fmt.name):
                    self._reset_pending = False
            dropped = packets.write_interleaved_chunks(self._ring, payload,
                                                       self._fmt.name)
            if dropped:
                self._dropped += dropped
                if self._dropped_warns < 5:
                    self._dropped_warns += 1
                    from iq_tool_tpu_torch.utils.log import get_logger
                    get_logger(self.name).warning(
                        "capture ring overrun: dropped %d samples total",
                        self._dropped)
        else:
            self._ring.write(payload)
        self.heartbeat = time.monotonic()

    def _deliver_reset(self) -> None:
        """Stream discontinuity (e.g. sdrplay stream-reset events,
        input_sdrplay.c:384-395).  Buffered mode frames it as an in-band
        IQPK reset packet (exactly ordered); realtime mode sets a flag the
        consumer applies to its NEXT block — ordering is then bounded by
        the ring depth, matching the reference's realtime reset chunk that
        also overtakes ring-buffered bytes.  Kept pending until it fits in
        the ring — losing it would splice the gap."""
        if self._buffered:
            from iq_tool_tpu_torch.io import packets
            if not packets.write_reset_event(self._ring, self._fmt.name):
                self._reset_pending = True
        else:
            self._rt_reset += 1

    # -- consumer side ----------------------------------------------------------

    def blocks(self, frames_per_block: int) -> Iterator[Block]:
        self._start_hardware()
        if self._buffered:
            yield from self._packet_blocks(frames_per_block)
            return
        bpf = self._fmt.bytes_per_frame
        want = frames_per_block * bpf
        while True:
            buf = self._ring.read(want)
            if not buf:
                return
            pending = self._rt_reset
            disc = pending != self._rt_reset_seen
            self._rt_reset_seen = pending
            yield Block(payload=buf[: len(buf) // bpf * bpf],
                        discontinuity=disc)
            if len(buf) < want:
                return

    def _packet_blocks(self, frames_per_block: int) -> Iterator[Block]:
        from iq_tool_tpu_torch.io.packets import PacketReader
        reader = PacketReader(self._ring)
        bpf = self._fmt.bytes_per_frame
        want = frames_per_block * bpf
        buf = bytearray()
        next_disc = False
        while True:
            p = reader.read_packet()
            if p is None:
                if reader.resync_count:
                    from iq_tool_tpu_torch.utils.log import get_logger
                    get_logger(self.name).warning(
                        "IQPK stream: %d resync byte-scan(s) recovered "
                        "corrupted framing", reader.resync_count)
                if buf:
                    yield Block(payload=bytes(buf), discontinuity=next_disc)
                return
            if p.reset:
                if buf:
                    yield Block(payload=bytes(buf), discontinuity=next_disc)
                    buf.clear()
                next_disc = True
                continue
            buf.extend(p.payload)
            while len(buf) >= want:
                yield Block(payload=bytes(buf[:want]), discontinuity=next_disc)
                next_disc = False
                del buf[:want]

    def _start_hardware(self) -> None:
        raise NotImplementedError

    def _join_reader(self, timeout: float = 3.0) -> bool:
        """Wait for the reader thread to exit so the device handle cannot be
        freed while a blocking read is (about to be) running on it — the
        shutdown-time use-after-free the round-1 advisor flagged.  Returns
        False if the thread is stuck in the driver; callers must then LEAK
        the handle rather than free it under the blocked read."""
        t = self._reader_thread
        if t is not None and t.is_alive():
            t.join(timeout)
            if t.is_alive():
                from iq_tool_tpu_torch.utils.log import get_logger
                get_logger(self.name).warning(
                    "reader thread stuck in driver read; leaking device "
                    "handle instead of freeing it mid-read")
                return False
        return True

    def close(self) -> None:
        self._stop.set()
        self._ring.signal_shutdown()


# --------------------------------- rtlsdr ------------------------------------

class RtlSdrInput(_SdrInputBase):
    name = "rtlsdr"
    native_format = "cu8"                  # input_rtlsdr.c:250
    default_rate = float(C.RTLSDR_DEFAULT_RATE)

    @classmethod
    def add_cli_options(cls, parser) -> None:
        g = parser.add_argument_group("RTL-SDR Options")
        g.add_argument("--rtlsdr-device-idx", type=int, default=0,
                       help="Select RTL-SDR device by index (default 0)")
        g.add_argument("--rtlsdr-gain", type=float, metavar="DB",
                       help="Manual tuner gain in dB (disables AGC)")
        g.add_argument("--rtlsdr-ppm", type=int, default=0,
                       help="Frequency correction in ppm")
        g.add_argument("--rtlsdr-direct-sampling", type=int, choices=(1, 2),
                       help="Direct sampling for HF (1=I branch, 2=Q branch)")

    def initialize(self, config, args) -> SourceInfo:
        self._common_init(args)
        libname = find_driver_lib("rtlsdr")
        if not libname:
            raise ValueError(
                "rtlsdr input: librtlsdr not found on this host. TPU hosts "
                "have no USB radio hardware; use the spyserver-client input "
                "to stream from a remote SDR instead.")
        self._lib = ctypes.CDLL(libname)
        self._args = args
        dev = ctypes.c_void_p()
        idx = getattr(args, "rtlsdr_device_idx", 0)
        if self._lib.rtlsdr_open(ctypes.byref(dev), idx) != 0:
            raise ValueError(f"rtlsdr device {idx} could not be opened")
        self._dev = dev
        lib = self._lib
        lib.rtlsdr_set_sample_rate(dev, int(self._rate))
        lib.rtlsdr_set_center_freq(dev, int(args.sdr_rf_freq))
        if getattr(args, "rtlsdr_ppm", 0):
            lib.rtlsdr_set_freq_correction(dev, int(args.rtlsdr_ppm))
        if getattr(args, "rtlsdr_gain", None) is not None:
            lib.rtlsdr_set_tuner_gain_mode(dev, 1)
            lib.rtlsdr_set_tuner_gain(dev,
                                      rtlsdr_gain_to_tenths(args.rtlsdr_gain))
        else:
            lib.rtlsdr_set_tuner_gain_mode(dev, 0)
        if getattr(args, "rtlsdr_direct_sampling", None):
            lib.rtlsdr_set_direct_sampling(dev, int(args.rtlsdr_direct_sampling))
        if getattr(args, "sdr_bias_t", False):
            lib.rtlsdr_set_bias_tee(dev, 1)
        lib.rtlsdr_reset_buffer(dev)
        return SourceInfo(sample_rate=self._rate, sample_format="cu8",
                          total_frames=None)

    def close(self) -> None:
        super().close()
        dev = getattr(self, "_dev", None)
        if dev is not None:
            try:
                # unblock any in-flight read, then wait for the reader to
                # exit BEFORE freeing the handle (signal_handler.c:104-147
                # rtlsdr special-case + join semantics)
                self._lib.rtlsdr_cancel_async(dev)
            except Exception:
                pass
            if not self._join_reader():
                return                     # leak rather than free mid-read
            self._dev = None
            try:
                if getattr(self._args, "sdr_bias_t", False):
                    self._lib.rtlsdr_set_bias_tee(dev, 0)
                self._lib.rtlsdr_close(dev)
            except Exception:
                pass  # device teardown is best-effort on exit

    def _start_hardware(self) -> None:
        def reader():
            n_read = ctypes.c_int(0)
            buflen = 16384 * 2
            buf = (ctypes.c_ubyte * buflen)()
            dev = self._dev
            while not self._stop.is_set():
                r = self._lib.rtlsdr_read_sync(dev, buf, buflen,
                                               ctypes.byref(n_read))
                if r != 0:
                    break
                self._deliver(bytes(buf[: n_read.value]))
            self._ring.signal_end_of_stream()

        self._reader_thread = threading.Thread(target=reader, daemon=True,
                                               name="rtlsdr-rx")
        self._reader_thread.start()

    def summary(self) -> dict:
        return {"RTL-SDR Rate": f"{self._rate:.0f} Hz"}


# --------------------------------- sdrplay ------------------------------------

class SdrPlayInput(_SdrInputBase):
    """SDRplay API service capture (input_sdrplay.c:169-890 behavior):
    planar short xi/xq callbacks interleaved into the ring (realtime) or
    written as planar IQPK packets (buffered, :470); stream-reset events
    become discontinuities (:384-395); power-overload events are logged
    and acknowledged (:491-509); per-family antenna/bias-T/HDR/LNA option
    matrix (:633-750, helpers in modules/sdrplay_api.py)."""

    name = "sdrplay"
    native_format = "cs16"                 # input_sdrplay.c:752
    default_rate = 2_000_000.0

    @classmethod
    def add_cli_options(cls, parser) -> None:
        g = parser.add_argument_group("SDRplay Options")
        g.add_argument("--sdrplay-device-idx", type=int, default=0)
        g.add_argument("--sdrplay-bandwidth", type=float, metavar="HZ",
                       default=1_536_000.0,
                       help="Analog bandwidth in Hz (default 1.536e6)")
        g.add_argument("--sdrplay-lna-state", type=int, metavar="N",
                       help="LNA state, 0 = min gain (disables AGC)")
        g.add_argument("--sdrplay-if-gain", type=int, metavar="DB",
                       help="IF gain in dB (e.g. -20..-59; disables AGC)")
        g.add_argument("--sdrplay-antenna", metavar="PORT",
                       help="Antenna port (device-specific)")
        g.add_argument("--sdrplay-hdr-mode", action="store_true",
                       help="Enable HDR mode (RSPdx/RSPdxR2)")
        g.add_argument("--sdrplay-hdr-bw", type=float, metavar="HZ",
                       help="HDR mode bandwidth (requires --sdrplay-hdr-mode)")

    def initialize(self, config, args) -> SourceInfo:
        import numpy as np

        from iq_tool_tpu_torch.modules import sdrplay_api as sp
        from iq_tool_tpu_torch.utils.log import get_logger
        log = get_logger(self.name)
        self._np = np
        self._sp = sp
        self._common_init(args)
        libname = find_driver_lib("sdrplay_api", "sdrplay")
        if not libname:
            raise ValueError(
                "sdrplay input: libsdrplay_api not found on this host. TPU "
                "hosts have no USB radio hardware; use the spyserver-client "
                "input to stream from a remote SDR instead.")
        lib = sp.bind(ctypes.CDLL(libname))
        self._lib = lib
        self._args = args
        self._api_open = False
        self._dev = None
        self._inited = False

        err = lib.sdrplay_api_Open()
        if err != sp.SUCCESS:
            raise ValueError(f"sdrplay_api_Open failed: {self._errstr(err)}")
        self._api_open = True
        try:
            devs = (sp.DeviceT * sp.MAX_DEVICES)()
            n = ctypes.c_uint(0)
            err = lib.sdrplay_api_GetDevices(devs, ctypes.byref(n),
                                             sp.MAX_DEVICES)
            if err != sp.SUCCESS:
                raise ValueError(
                    f"sdrplay_api_GetDevices failed: {self._errstr(err)}")
            idx = int(getattr(args, "sdrplay_device_idx", 0) or 0)
            if n.value == 0:
                raise ValueError("no SDRplay devices found")
            if idx >= n.value:
                raise ValueError(
                    f"device index {idx} out of range (found {n.value})")
            self._dev = sp.DeviceT()
            ctypes.memmove(ctypes.byref(self._dev),
                           ctypes.byref(devs[idx]),
                           ctypes.sizeof(sp.DeviceT))
            if self._dev.hwVer == sp.RSPduo:
                # single-tuner mode on tuner A (input_sdrplay.c:692-695)
                self._dev.rspDuoMode = sp.RSPDUO_MODE_SINGLE_TUNER
                self._dev.tuner = sp.TUNER_A
            err = lib.sdrplay_api_SelectDevice(ctypes.byref(self._dev))
            if err != sp.SUCCESS:
                self._dev = None
                raise ValueError(
                    f"sdrplay_api_SelectDevice failed: {self._errstr(err)}")
            log.info("Using SDRplay device: %s (S/N: %s)",
                     sp.device_name(self._dev.hwVer),
                     self._dev.SerNo.decode(errors="replace"))
            self._configure(args, sp, log)
        except Exception:
            self._teardown_api()
            raise
        return SourceInfo(sample_rate=self._rate, sample_format="cs16",
                          total_frames=None)

    def _errstr(self, err: int) -> str:
        try:
            s = self._lib.sdrplay_api_GetErrorString(err)
            return s.decode() if s else str(err)
        except Exception:
            return str(err)

    def _configure(self, args, sp, log) -> None:
        """Program device params: rate/bw/freq + the per-family option
        matrix (input_sdrplay.c:614-756)."""
        lib = self._lib
        params = ctypes.POINTER(sp.DeviceParamsT)()
        err = lib.sdrplay_api_GetDeviceParams(self._dev.dev,
                                              ctypes.byref(params))
        if err != sp.SUCCESS or not params:
            raise ValueError(
                f"sdrplay_api_GetDeviceParams failed: {self._errstr(err)}")
        dev_params = params.contents.devParams.contents
        ch = params.contents.rxChannelA.contents
        hw = self._dev.hwVer

        bw_hz = float(getattr(args, "sdrplay_bandwidth", None) or 1_536_000.0)
        bw_enum = sp.bw_hz_to_enum(bw_hz)
        if bw_enum == sp.BW_UNDEFINED:
            raise ValueError(
                f"unsupported --sdrplay-bandwidth {bw_hz:.0f}; valid: "
                "200e3 300e3 600e3 1.536e6 5e6 6e6 7e6 8e6")
        dev_params.fsFreq.fsHz = float(self._rate)
        ch.tunerParams.bwType = bw_enum
        ch.tunerParams.ifType = sp.IF_ZERO
        ch.tunerParams.rfFreq.rfHz = float(args.sdr_rf_freq)

        hdr = bool(getattr(args, "sdrplay_hdr_mode", False))
        if hdr:
            if hw not in (sp.RSPdx, sp.RSPdxR2):
                raise ValueError(
                    "--sdrplay-hdr-mode is only supported on RSPdx and "
                    "RSPdx-R2 devices")
            dev_params.rspDxParams.hdrEnable = 1
            hdr_bw = getattr(args, "sdrplay_hdr_bw", None)
            if hdr_bw is not None:
                enum = sp.hdr_bw_to_enum(float(hdr_bw))
                if enum is None:
                    raise ValueError(
                        f"invalid --sdrplay-hdr-bw {hdr_bw}; valid: "
                        "200e3 500e3 1.2e6 1.7e6")
                ch.rspDxTunerParams.hdrBw = enum
            else:
                ch.rspDxTunerParams.hdrBw = sp.HDRMODE_BW_1_700

        antenna = getattr(args, "sdrplay_antenna", None)
        bias_t = bool(getattr(args, "sdr_bias_t", False))
        hiz = False
        handled_ant = handled_bias = False
        if antenna or bias_t:
            port = (antenna or "").upper()
            if hw in (sp.RSP1A, sp.RSP1B):
                if bias_t:
                    ch.rsp1aTunerParams.biasTEnable = 1
                    handled_bias = True
            elif hw == sp.RSP2:
                if bias_t:
                    ch.rsp2TunerParams.biasTEnable = 1
                    handled_bias = True
                if antenna:
                    if port == "A":
                        ch.rsp2TunerParams.antennaSel = sp.RSP2_ANTENNA_A
                    elif port == "B":
                        ch.rsp2TunerParams.antennaSel = sp.RSP2_ANTENNA_B
                    elif port == "HIZ":
                        ch.rsp2TunerParams.amPortSel = sp.RSP2_AMPORT_2
                        hiz = True
                    else:
                        raise ValueError(
                            f"invalid antenna port '{antenna}' for RSP2; "
                            "use A, B, or HIZ")
                    handled_ant = True
            elif hw == sp.RSPduo:
                if bias_t:
                    ch.rspDuoTunerParams.biasTEnable = 1
                    handled_bias = True
                if antenna:
                    if port == "A":
                        pass               # default port
                    elif port == "HIZ":
                        ch.rspDuoTunerParams.tuner1AmPortSel = \
                            sp.RSPDUO_AMPORT_2
                        hiz = True
                    else:
                        raise ValueError(
                            f"invalid antenna port '{antenna}' for RSPduo; "
                            "use A or HIZ")
                    handled_ant = True
            elif hw in (sp.RSPdx, sp.RSPdxR2):
                if bias_t:
                    dev_params.rspDxParams.biasTEnable = 1
                    handled_bias = True
                if antenna:
                    sel = {"A": sp.RSPDX_ANTENNA_A, "B": sp.RSPDX_ANTENNA_B,
                           "C": sp.RSPDX_ANTENNA_C}.get(port)
                    if sel is None:
                        raise ValueError(
                            f"invalid antenna port '{antenna}' for "
                            "RSPdx/RSPdx-R2; use A, B, or C")
                    dev_params.rspDxParams.antennaSel = sel
                    handled_ant = True
        if antenna and not handled_ant:
            log.warning("antenna selection not applicable for %s",
                        sp.device_name(hw))
        if bias_t and not handled_bias:
            log.warning("Bias-T is not supported on %s", sp.device_name(hw))

        lna = getattr(args, "sdrplay_lna_state", None)
        if_gain = getattr(args, "sdrplay_if_gain", None)
        if lna is not None or if_gain is not None:
            ch.ctrlParams.agc.enable = sp.AGC_DISABLE
            log.info("SDRplay: AGC disabled due to manual gain setting")
        if if_gain is not None:
            ch.tunerParams.gain.gRdB = -int(if_gain)
        if lna is not None:
            n_states = sp.num_lna_states(hw, float(args.sdr_rf_freq),
                                         hdr, hiz)
            if not (0 <= int(lna) < n_states):
                raise ValueError(
                    f"invalid LNA state {lna}; valid range for this "
                    f"device/frequency is 0 (min gain) to {n_states - 1} "
                    "(max gain)")
            ch.tunerParams.gain.LNAstate = sp.lna_state_for_api(int(lna),
                                                                n_states)

    def _start_hardware(self) -> None:
        sp = self._sp
        np = self._np

        def stream_cb(xi, xq, _params, num_samples, reset, _ctx):
            if self._stop.is_set():
                return
            if reset:
                from iq_tool_tpu_torch.utils.log import get_logger
                get_logger(self.name).info(
                    "SDRplay stream reset detected; propagating "
                    "discontinuity (input_sdrplay.c:384-395)")
                self._deliver_reset()
            if num_samples == 0:
                return
            n = int(num_samples)
            i_arr = np.ctypeslib.as_array(xi, (n,))
            q_arr = np.ctypeslib.as_array(xq, (n,))
            if self._buffered:
                # planar packet write (input_sdrplay.c:470 parity)
                from iq_tool_tpu_torch.io import packets
                dropped = packets.write_planar_shorts(
                    self._ring, i_arr, q_arr, self._fmt.name)
                if dropped:
                    self._dropped += dropped
                import time as _t
                self.heartbeat = _t.monotonic()
            else:
                inter = np.empty(2 * n, np.int16)
                inter[0::2] = i_arr
                inter[1::2] = q_arr
                self._deliver(inter.tobytes())

        def event_cb(event_id, tuner, params, _ctx):
            from iq_tool_tpu_torch.utils.log import get_logger
            log = get_logger(self.name)
            if event_id == sp.EVT_POWER_OVERLOAD:
                state = params.contents.powerOverloadParams \
                    .powerOverloadChangeType
                if state == sp.OVERLOAD_DETECTED:
                    log.warning("SDRplay: power overload detected — reduce "
                                "gain (input_sdrplay.c:491-509)")
                else:
                    log.info("SDRplay: power overload corrected")
                # acknowledge so the API keeps streaming
                self._lib.sdrplay_api_Update(
                    self._dev.dev, tuner, sp.UPDATE_CTRL_OVERLOAD_MSG_ACK,
                    sp.UPDATE_EXT1_NONE)
            elif event_id in (sp.EVT_DEVICE_REMOVED, sp.EVT_DEVICE_FAILURE):
                log.error("SDRplay device removed/failed; ending stream")
                self._ring.signal_end_of_stream()

        # keep CFUNCTYPE objects alive for the stream's lifetime
        self._stream_cb = sp.STREAM_CB(stream_cb)
        self._event_cb = sp.EVENT_CB(event_cb)
        self._cbfns = sp.CallbackFnsT(StreamACbFn=self._stream_cb,
                                      StreamBCbFn=sp.STREAM_CB(),
                                      EventCbFn=self._event_cb)
        err = self._lib.sdrplay_api_Init(self._dev.dev,
                                         ctypes.byref(self._cbfns), None)
        # tolerate Success and the benign Start/StopPending transients
        # (input_sdrplay.c:832).  Pending is matched via the API's own
        # error string rather than a hard-coded enum value: the vendor
        # header is not available here to pin the ordinal, and the
        # string is stable across sdrplay_api 3.x releases.
        if err != sp.SUCCESS and \
                "pending" not in self._errstr(err).lower():
            raise ValueError(f"sdrplay_api_Init failed: {self._errstr(err)}")
        self._inited = True
        # bias-T on RSP1A/2/duo/dx additionally needs a post-Init Update
        # (input_sdrplay.c:797-830)
        if getattr(self._args, "sdr_bias_t", False):
            hw = self._dev.hwVer
            reason, ext1 = sp.UPDATE_NONE, sp.UPDATE_EXT1_NONE
            if hw in (sp.RSP1A, sp.RSP1B):
                reason = sp.UPDATE_RSP1A_BIAST
            elif hw == sp.RSP2:
                reason = sp.UPDATE_RSP2_BIAST
            elif hw == sp.RSPduo:
                reason = sp.UPDATE_RSPDUO_BIAST
            elif hw in (sp.RSPdx, sp.RSPdxR2):
                ext1 = sp.UPDATE_EXT1_RSPDX_BIAST
            if reason != sp.UPDATE_NONE or ext1 != sp.UPDATE_EXT1_NONE:
                self._lib.sdrplay_api_Update(self._dev.dev, self._dev.tuner,
                                             reason, ext1)

    def _teardown_api(self) -> None:
        sp = getattr(self, "_sp", None)
        if sp is None:
            return
        if self._dev is not None:
            if self._inited:
                self._lib.sdrplay_api_Uninit(self._dev.dev)
                self._inited = False
            self._lib.sdrplay_api_ReleaseDevice(ctypes.byref(self._dev))
            self._dev = None
        if self._api_open:
            self._lib.sdrplay_api_Close()
            self._api_open = False

    def close(self) -> None:
        super().close()
        try:
            self._teardown_api()
        except Exception:
            pass  # device teardown is best-effort on exit

    def summary(self) -> dict:
        sp = getattr(self, "_sp", None)
        items = {"SDRplay Rate": f"{self._rate:.0f} Hz"}
        if sp is not None and self._dev is not None:
            items["SDRplay Device"] = sp.device_name(self._dev.hwVer)
        return items


class _HackRfTransfer(ctypes.Structure):
    """libhackrf's hackrf_transfer (the fields the RX callback touches)."""
    _fields_ = [("device", ctypes.c_void_p),
                ("buffer", ctypes.POINTER(ctypes.c_ubyte)),
                ("buffer_length", ctypes.c_int),
                ("valid_length", ctypes.c_int),
                ("rx_ctx", ctypes.c_void_p),
                ("tx_ctx", ctypes.c_void_p)]


_HACKRF_RX_CB = ctypes.CFUNCTYPE(ctypes.c_int,
                                 ctypes.POINTER(_HackRfTransfer))


class HackRfInput(_SdrInputBase):
    """libusb-async capture via libhackrf's RX callback
    (input_hackrf.c:186-219 semantics: each transfer's valid bytes are
    delivered to the ring; rate validated 2-20 MHz)."""

    name = "hackrf"
    native_format = "cs8"                  # input_hackrf.c:303
    default_rate = 10_000_000.0

    @classmethod
    def add_cli_options(cls, parser) -> None:
        g = parser.add_argument_group("HackRF Options")
        g.add_argument("--hackrf-lna-gain", type=int, default=16, metavar="DB",
                       help="LNA (IF) gain in dB (default 16)")
        g.add_argument("--hackrf-vga-gain", type=int, default=0, metavar="DB",
                       help="VGA (baseband) gain in dB (default 0)")
        g.add_argument("--hackrf-amp-enable", action="store_true",
                       help="Enable the +14 dB front-end RF amplifier")

    def initialize(self, config, args) -> SourceInfo:
        self._common_init(args)
        hackrf_validate_rate(self._rate)
        libname = find_driver_lib("hackrf")
        if not libname:
            raise ValueError(
                "hackrf input: libhackrf not found on this host. TPU hosts "
                "have no USB radio hardware; use the spyserver-client input "
                "to stream from a remote SDR instead.")
        lib = ctypes.CDLL(libname)
        self._lib = lib
        self._args = args
        if lib.hackrf_init() != 0:
            raise ValueError("hackrf_init failed")
        dev = ctypes.c_void_p()
        if lib.hackrf_open(ctypes.byref(dev)) != 0:
            raise ValueError("no HackRF device could be opened")
        self._dev = dev
        lib.hackrf_set_sample_rate.argtypes = [ctypes.c_void_p,
                                               ctypes.c_double]
        lib.hackrf_set_freq.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.hackrf_set_sample_rate(dev, float(self._rate))
        lib.hackrf_set_freq(dev, int(args.sdr_rf_freq))
        lib.hackrf_set_lna_gain(dev, int(getattr(args, "hackrf_lna_gain", 16)))
        lib.hackrf_set_vga_gain(dev, int(getattr(args, "hackrf_vga_gain", 0)))
        if getattr(args, "hackrf_amp_enable", False):
            lib.hackrf_set_amp_enable(dev, 1)
        if getattr(args, "sdr_bias_t", False):
            lib.hackrf_set_antenna_enable(dev, 1)
        return SourceInfo(sample_rate=self._rate, sample_format="cs8",
                          total_frames=None)

    def _start_hardware(self) -> None:
        def cb(transfer_ptr):
            t = transfer_ptr.contents
            n = t.valid_length
            if n > 0 and not self._stop.is_set():
                self._deliver(ctypes.string_at(t.buffer, n))
            return 0 if not self._stop.is_set() else 1

        # keep the CFUNCTYPE object alive for the stream's lifetime
        self._cb = _HACKRF_RX_CB(cb)
        if self._lib.hackrf_start_rx(self._dev, self._cb, None) != 0:
            raise ValueError("hackrf_start_rx failed")

    def close(self) -> None:
        super().close()
        dev = getattr(self, "_dev", None)
        if dev is not None:
            self._dev = None
            try:
                self._lib.hackrf_stop_rx(dev)
                if getattr(self._args, "sdr_bias_t", False):
                    self._lib.hackrf_set_antenna_enable(dev, 0)
                self._lib.hackrf_close(dev)
                self._lib.hackrf_exit()
            except Exception:
                pass  # device teardown is best-effort on exit

    def summary(self) -> dict:
        return {"HackRF Rate": f"{self._rate:.0f} Hz"}


class _BladeRfRationalRate(ctypes.Structure):
    """struct bladerf_rational_rate (bladeRF.h): integer + num/den."""
    _fields_ = [("integer", ctypes.c_uint64),
                ("num", ctypes.c_uint64),
                ("den", ctypes.c_uint64)]


class BladeRfInput(_SdrInputBase):
    """Sync-RX capture via libbladeRF (input_bladerf.c: sync interface with
    adaptive stream profiles by rate; FPGA load; sc16q11 or cs8; >61.44 MHz
    high-speed mode via oversample feature + rational rate + 8-bit)."""

    name = "bladerf"
    native_format = "sc16q11"              # input_bladerf.c:431
    default_rate = 2_000_000.0

    # libbladeRF enums (bladeRF.h): channel macro (ch << 1) | RX(0),
    # formats SC16_Q11 = 0, SC8_Q7 = 2; features DEFAULT = 0, OVERSAMPLE = 1
    _FMT_SC16_Q11 = 0
    _FMT_SC8_Q7 = 2
    _FEATURE_OVERSAMPLE = 1

    @classmethod
    def add_cli_options(cls, parser) -> None:
        g = parser.add_argument_group("BladeRF Options")
        g.add_argument("--bladerf-device-idx", type=int, default=0)
        g.add_argument("--bladerf-load-fpga", metavar="FILE",
                       help="Load an FPGA bitstream from the given file")
        g.add_argument("--bladerf-bandwidth", type=float, metavar="HZ")
        g.add_argument("--bladerf-gain", type=int, metavar="DB",
                       help="Overall manual gain in dB (disables AGC)")
        g.add_argument("--bladerf-channel", type=int, choices=(0, 1), default=0,
                       help="BladeRF 2.0 RX channel (default 0)")
        g.add_argument("--bladerf-bit-depth", type=int, choices=(8, 12),
                       default=None,
                       help="Capture bit depth (default 12); 8-bit is "
                            "BladeRF 2.0 only, auto-selected above "
                            "61.44 MHz")

    def initialize(self, config, args) -> SourceInfo:
        self._common_init(args)
        libname = find_driver_lib("bladeRF")
        if not libname:
            raise ValueError(
                "bladerf input: libbladeRF not found on this host. TPU "
                "hosts have no USB radio hardware; use the spyserver-client "
                "input to stream from a remote SDR instead.")
        lib = ctypes.CDLL(libname)
        self._lib = lib
        self._args = args
        from iq_tool_tpu_torch.utils.log import get_logger
        log = get_logger(self.name)
        oversample = bladerf_needs_oversample(self._rate)
        bits, auto8 = bladerf_resolve_bit_depth(
            self._rate, getattr(args, "bladerf_bit_depth", None))
        if auto8:
            log.warning(
                "sample rate %.0f Hz exceeds the 61.44 MHz limit for "
                "12-bit mode; switching to 8-bit (input_bladerf.c:262-265)",
                self._rate)
        bw = getattr(args, "bladerf_bandwidth", None)
        if oversample and bw:
            raise ValueError(
                "--bladerf-bandwidth cannot be used in 8-bit high-speed "
                "mode; the library sets the analog bandwidth automatically "
                "(input_bladerf.c:277-280)")
        from iq_tool_tpu_torch.formats import get_format
        self._fmt = get_format("cs8" if bits == 8 else "sc16q11")
        dev = ctypes.c_void_p()
        # BLADERF_ERR_UPDATE_FPGA (-8) is a successful open that still
        # needs a bitstream (input_bladerf.c:317) — the load below fixes it
        st = lib.bladerf_open(ctypes.byref(dev), None)
        if st not in (0, -8):
            raise ValueError("no BladeRF device could be opened")
        self._dev = dev
        fpga = getattr(args, "bladerf_load_fpga", None)
        if fpga:
            log.info("Manual FPGA load requested: %s", fpga)
            if lib.bladerf_load_fpga(dev, fpga.encode()) != 0:
                raise ValueError(f"FPGA load failed: {fpga}")
            log.info("Manual FPGA loaded successfully.")
        else:
            # input_bladerf.c:334-347: query the FPGA state; when not
            # configured, find + load the hosted bitstream automatically
            st = lib.bladerf_is_fpga_configured(dev)
            if st < 0:
                raise ValueError("failed to query BladeRF FPGA state")
            if st == 0:
                log.info("BladeRF FPGA not configured; attempting to find "
                         "and load it automatically...")
                self._autoload_fpga(lib, dev, log)
            else:
                log.info("BladeRF FPGA is already configured. Proceeding.")
        ch = (int(getattr(args, "bladerf_channel", 0) or 0) << 1) | 0
        self._ch = ch
        lib.bladerf_set_frequency.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_uint64]
        if oversample:
            # BladeRF 2.0 high-speed path (input_bladerf.c:445-484):
            # oversample feature + rational rate; bandwidth is automatic
            if lib.bladerf_enable_feature(dev, self._FEATURE_OVERSAMPLE,
                                          1) != 0:
                raise ValueError(
                    "failed to enable the BladeRF oversample feature "
                    "(BladeRF 2.0 only)")
            want = _BladeRfRationalRate(integer=0, num=int(self._rate),
                                        den=1)
            got = _BladeRfRationalRate()
            lib.bladerf_set_rational_sample_rate.argtypes = [
                ctypes.c_void_p, ctypes.c_int,
                ctypes.POINTER(_BladeRfRationalRate),
                ctypes.POINTER(_BladeRfRationalRate)]
            if lib.bladerf_set_rational_sample_rate(
                    dev, ch, ctypes.byref(want), ctypes.byref(got)) != 0:
                raise ValueError("bladerf_set_rational_sample_rate failed")
            if got.den == 0:
                raise ValueError(
                    "BladeRF returned an invalid rational sample rate "
                    "(denominator is zero)")
            self._rate = float(got.integer) + got.num / got.den
            log.info("BladeRF high-speed: actual rate %.0f Hz, bandwidth "
                     "set automatically by the library", self._rate)
        else:
            actual = ctypes.c_uint()
            lib.bladerf_set_sample_rate(dev, ch, int(self._rate),
                                        ctypes.byref(actual))
            if actual.value:
                self._rate = float(actual.value)
        lib.bladerf_set_frequency(dev, ch, int(args.sdr_rf_freq))
        if bw and not oversample:
            lib.bladerf_set_bandwidth(dev, ch, int(bw), None)
        gain = getattr(args, "bladerf_gain", None)
        if gain is not None:
            lib.bladerf_set_gain_mode(dev, ch, 0)     # MGC
            lib.bladerf_set_gain(dev, ch, int(gain))
        if getattr(args, "sdr_bias_t", False):
            lib.bladerf_set_bias_tee(dev, ch, 1)
        # adaptive stream profile by rate (input_bladerf.c:537-595)
        prof = bladerf_stream_profile(self._rate)
        fmt_enum = self._FMT_SC8_Q7 if bits == 8 else self._FMT_SC16_Q11
        rx_x1 = 0                     # bladerf_channel_layout BLADERF_RX_X1
        if lib.bladerf_sync_config(dev, rx_x1, fmt_enum,
                                   prof["num_buffers"], prof["buffer_size"],
                                   prof["num_transfers"], 1000) != 0:
            raise ValueError("bladerf_sync_config failed")
        if lib.bladerf_enable_module(dev, ch, 1) != 0:
            raise ValueError("bladerf_enable_module failed")
        self._xfer = bladerf_transfer_samples(self._rate)
        return SourceInfo(sample_rate=self._rate,
                          sample_format=self._fmt.name, total_frames=None)

    @staticmethod
    def _autoload_fpga(lib, dev, log) -> None:
        """FPGA auto-detect + auto-load (input_bladerf.c:794-894): query
        the FPGA size, map it to the hosted*.rbf name, probe the search
        paths in order, and load the first hit."""
        size = ctypes.c_int(0)
        if lib.bladerf_get_fpga_size(dev, ctypes.byref(size)) != 0:
            raise ValueError("could not determine BladeRF FPGA size")
        filename = bladerf_fpga_filename(size.value)
        for path in bladerf_fpga_search_paths(filename):
            if not os.access(path, os.F_OK):
                continue
            log.info("Found FPGA file at: %s", path)
            if lib.bladerf_load_fpga(dev, path.encode()) != 0:
                raise ValueError(
                    f"found FPGA file, but failed to load it: {path}")
            log.info("Automatic FPGA load successful.")
            return
        raise ValueError(
            f"could not automatically find the required FPGA file "
            f"'{filename}'; place it in fpga/bladerf/ next to the "
            f"executable or a system share dir, point "
            f"IQTOOL_BLADERF_FPGA_DIR at its directory, or pass "
            f"--bladerf-load-fpga (input_bladerf.c:892-894)")

    def _start_hardware(self) -> None:
        def reader():
            bpf = self._fmt.bytes_per_frame
            n = self._xfer
            buf = (ctypes.c_ubyte * (n * bpf))()
            dev = self._dev
            while not self._stop.is_set():
                if self._lib.bladerf_sync_rx(dev, buf, n, None, 2000) != 0:
                    break
                self._deliver(ctypes.string_at(buf, n * bpf))
            self._ring.signal_end_of_stream()

        self._reader_thread = threading.Thread(target=reader, daemon=True,
                                               name="bladerf-rx")
        self._reader_thread.start()

    def close(self) -> None:
        super().close()
        dev = getattr(self, "_dev", None)
        if dev is not None:
            # bladerf_sync_rx has a 2 s timeout, so the reader observes
            # _stop within one timeout; join before freeing the handle
            if not self._join_reader():
                return                     # leak rather than free mid-read
            self._dev = None
            try:
                self._lib.bladerf_enable_module(dev, self._ch, 0)
                if getattr(self._args, "sdr_bias_t", False):
                    self._lib.bladerf_set_bias_tee(dev, self._ch, 0)
                self._lib.bladerf_close(dev)
            except Exception:
                pass  # device teardown is best-effort on exit

    def summary(self) -> dict:
        return {"BladeRF Rate": f"{self._rate:.0f} Hz",
                "BladeRF Format": self._fmt.name}


ALL = [RtlSdrInput, SdrPlayInput, HackRfInput, BladeRfInput]
