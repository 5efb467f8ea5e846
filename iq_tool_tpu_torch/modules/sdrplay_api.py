"""ctypes binding for the SDRplay API service (libsdrplay_api >= 3.08).

Struct layouts follow the public sdrplay_api 3.x headers (the same
layouts every open-source consumer binds against).  Only the parameter
fields the input module touches are *used*, but each struct spells out
its full field list so offsets are correct.

Reference behavior being reproduced: /root/reference/src/input_sdrplay.c
(device select :560-640, family option matrix :633-750, stream callbacks
:374-475, event callback :476-509, teardown :860-892).
"""

from __future__ import annotations

import ctypes as ct

# ---- enums (ints on the wire) ----------------------------------------------

SUCCESS = 0
# NB: the benign Start/StopPending Init statuses are recognized by the
# API's error STRING (see input_sdr.SdrPlayInput), not a hard-coded
# ordinal — the vendor header is unavailable here to pin the value.

# hwVer ids (sdrplay_api.h SDRPLAY_RSP*_ID)
RSP1, RSP2, RSPduo, RSPdx = 1, 2, 3, 4
RSP1A, RSP1B, RSPdxR2 = 255, 6, 7

# sdrplay_api_Bw_MHzT
BW_UNDEFINED = 0
_BW_ENUM = {200_000.0: 200, 300_000.0: 300, 600_000.0: 600,
            1_536_000.0: 1536, 5_000_000.0: 5000, 6_000_000.0: 6000,
            7_000_000.0: 7000, 8_000_000.0: 8000}

# sdrplay_api_If_kHzT
IF_ZERO = 0

# sdrplay_api_TunerSelectT
TUNER_NEITHER, TUNER_A, TUNER_B, TUNER_BOTH = 0, 1, 2, 3

# sdrplay_api_RspDuoModeT
RSPDUO_MODE_SINGLE_TUNER = 1

# sdrplay_api_AgcControlT
AGC_DISABLE, AGC_100HZ, AGC_50HZ, AGC_5HZ, AGC_CTRL_EN = 0, 1, 2, 3, 4

# antenna selects
RSP2_ANTENNA_A, RSP2_ANTENNA_B = 5, 6
RSP2_AMPORT_1, RSP2_AMPORT_2 = 1, 0      # sdrplay_api_Rsp2_AmPortSelectT
RSPDUO_AMPORT_1, RSPDUO_AMPORT_2 = 1, 0
RSPDX_ANTENNA_A, RSPDX_ANTENNA_B, RSPDX_ANTENNA_C = 0, 1, 2

# sdrplay_api_RspDx_HdrModeBwT
HDRMODE_BW_0_200, HDRMODE_BW_0_500, HDRMODE_BW_1_200, HDRMODE_BW_1_700 = \
    0, 1, 2, 3

# sdrplay_api_EventT
EVT_GAIN_CHANGE, EVT_POWER_OVERLOAD, EVT_DEVICE_REMOVED, \
    EVT_RSPDUO_MODE_CHANGE, EVT_DEVICE_FAILURE = 0, 1, 2, 3, 4
OVERLOAD_DETECTED, OVERLOAD_CORRECTED = 0, 1

# ReasonForUpdate bits used here (sdrplay_api_ReasonForUpdateT)
UPDATE_NONE = 0
UPDATE_CTRL_OVERLOAD_MSG_ACK = 0x04000000
UPDATE_RSP1A_BIAST = 0x00000010
UPDATE_RSP2_BIAST = 0x00000080
UPDATE_RSPDUO_BIAST = 0x08000000
UPDATE_EXT1_NONE = 0
UPDATE_EXT1_RSPDX_BIAST = 0x00000002


def bw_hz_to_enum(bw_hz: float) -> int:
    """map_bw_hz_to_enum parity (input_sdrplay.c:362-372)."""
    for hz, enum in _BW_ENUM.items():
        if abs(bw_hz - hz) < 1.0:
            return enum
    return BW_UNDEFINED


def hdr_bw_to_enum(bw_hz: float) -> int | None:
    """HDR bandwidth enum (input_sdrplay.c:280-284); None = invalid."""
    table = {200_000.0: HDRMODE_BW_0_200, 500_000.0: HDRMODE_BW_0_500,
             1_200_000.0: HDRMODE_BW_1_200, 1_700_000.0: HDRMODE_BW_1_700}
    for hz, enum in table.items():
        if abs(bw_hz - hz) < 1.0:
            return enum
    return None


def num_lna_states(hw_ver: int, rf_freq_hz: float, hdr_mode: bool,
                   hiz_port: bool) -> int:
    """Per-device LNA state count matrix (input_sdrplay.c:328-360)."""
    mhz = rf_freq_hz / 1e6
    if hw_ver == RSP1:
        return 4
    if hw_ver in (RSP1A, RSP1B):
        return 7 if mhz <= 60.0 else (10 if mhz <= 1000.0 else 9)
    if hw_ver == RSP2:
        if hiz_port and mhz <= 60.0:
            return 5
        return 9 if mhz <= 420.0 else 6
    if hw_ver == RSPduo:
        if hiz_port and mhz <= 60.0:
            return 5
        return 7 if mhz <= 60.0 else (10 if mhz <= 1000.0 else 9)
    if hw_ver in (RSPdx, RSPdxR2):
        if hdr_mode and mhz <= 2.0:
            return 21
        if mhz <= 50.0:
            return 14
        if mhz <= 60.0:
            return 28
        if mhz <= 420.0:
            return 27
        if mhz <= 1000.0:
            return 21
        return 19
    return 10


def lna_state_for_api(user_level: int, n_states: int) -> int:
    """User level (0 = min gain) -> API LNAstate (0 = max gain)
    (input_sdrplay.c:745-750 inversion)."""
    return (n_states - 1) - user_level


def device_name(hw_ver: int) -> str:
    return {RSP1: "RSP1", RSP1A: "RSP1A", RSP1B: "RSP1B", RSP2: "RSP2",
            RSPduo: "RSPduo", RSPdx: "RSPdx",
            RSPdxR2: "RSPdx-R2"}.get(hw_ver, f"unknown (hwVer {hw_ver})")


# ---- structs (sdrplay_api 3.x layouts) -------------------------------------

HANDLE = ct.c_void_p
MAX_DEVICES = 16
SER_NO_LEN = 64


class DeviceT(ct.Structure):
    _fields_ = [("SerNo", ct.c_char * SER_NO_LEN),
                ("hwVer", ct.c_ubyte),
                ("tuner", ct.c_int),
                ("rspDuoMode", ct.c_int),
                ("valid", ct.c_ubyte),
                ("rspDuoSampleFreq", ct.c_double),
                ("dev", HANDLE)]


class FsFreqT(ct.Structure):
    _fields_ = [("fsHz", ct.c_double), ("syncUpdate", ct.c_ubyte),
                ("reCal", ct.c_ubyte)]


class SyncUpdateT(ct.Structure):
    _fields_ = [("sampleNum", ct.c_uint), ("period", ct.c_uint)]


class ResetFlagsT(ct.Structure):
    _fields_ = [("resetGainUpdate", ct.c_ubyte),
                ("resetRfUpdate", ct.c_ubyte),
                ("resetFsUpdate", ct.c_ubyte)]


class Rsp1aParamsT(ct.Structure):
    _fields_ = [("rfNotchEnable", ct.c_ubyte),
                ("rfDabNotchEnable", ct.c_ubyte)]


class Rsp2ParamsT(ct.Structure):
    _fields_ = [("extRefOutputEn", ct.c_ubyte)]


class RspDuoParamsT(ct.Structure):
    _fields_ = [("extRefOutputEn", ct.c_int)]


class RspDxParamsT(ct.Structure):
    _fields_ = [("hdrEnable", ct.c_ubyte), ("biasTEnable", ct.c_ubyte),
                ("antennaSel", ct.c_int), ("rfNotchEnable", ct.c_ubyte),
                ("rfDabNotchEnable", ct.c_ubyte)]


class DevParamsT(ct.Structure):
    _fields_ = [("ppm", ct.c_double),
                ("fsFreq", FsFreqT),
                ("syncUpdate", SyncUpdateT),
                ("resetFlags", ResetFlagsT),
                ("mode", ct.c_int),
                ("samplesPerPkt", ct.c_uint),
                ("rsp1aParams", Rsp1aParamsT),
                ("rsp2Params", Rsp2ParamsT),
                ("rspDuoParams", RspDuoParamsT),
                ("rspDxParams", RspDxParamsT)]


class GainValuesT(ct.Structure):
    _fields_ = [("curr", ct.c_float), ("max", ct.c_float),
                ("min", ct.c_float)]


class GainT(ct.Structure):
    _fields_ = [("gRdB", ct.c_int), ("LNAstate", ct.c_ubyte),
                ("syncUpdate", ct.c_ubyte), ("minGr", ct.c_int),
                ("gainVals", GainValuesT)]


class RfFreqT(ct.Structure):
    _fields_ = [("rfHz", ct.c_double), ("syncUpdate", ct.c_ubyte)]


class DcOffsetTunerT(ct.Structure):
    _fields_ = [("dcCal", ct.c_ubyte), ("speedUp", ct.c_ubyte),
                ("trackTime", ct.c_int), ("refreshRateTime", ct.c_int)]


class TunerParamsT(ct.Structure):
    _fields_ = [("bwType", ct.c_int), ("ifType", ct.c_int),
                ("loMode", ct.c_int), ("gain", GainT),
                ("rfFreq", RfFreqT), ("dcOffsetTuner", DcOffsetTunerT)]


class DcOffsetT(ct.Structure):
    _fields_ = [("DCenable", ct.c_ubyte), ("IQenable", ct.c_ubyte)]


class DecimationT(ct.Structure):
    _fields_ = [("enable", ct.c_ubyte), ("decimationFactor", ct.c_ubyte),
                ("wideBandSignal", ct.c_ubyte)]


class AgcT(ct.Structure):
    _fields_ = [("enable", ct.c_int), ("setPoint_dBfs", ct.c_int),
                ("attack_ms", ct.c_ushort), ("decay_ms", ct.c_ushort),
                ("decay_delay_ms", ct.c_ushort),
                ("decay_threshold_dB", ct.c_ushort),
                ("syncUpdate", ct.c_int)]


class Rsp1aTunerParamsT(ct.Structure):
    _fields_ = [("biasTEnable", ct.c_ubyte)]


class Rsp2TunerParamsT(ct.Structure):
    _fields_ = [("biasTEnable", ct.c_ubyte), ("amPortSel", ct.c_int),
                ("antennaSel", ct.c_int), ("rfNotchEnable", ct.c_ubyte)]


class RspDuoTunerParamsT(ct.Structure):
    _fields_ = [("biasTEnable", ct.c_ubyte), ("tuner1AmPortSel", ct.c_int),
                ("tuner1AmNotchEnable", ct.c_ubyte),
                ("rfNotchEnable", ct.c_ubyte),
                ("rfDabNotchEnable", ct.c_ubyte)]


class RspDxTunerParamsT(ct.Structure):
    _fields_ = [("hdrBw", ct.c_int)]


class CtrlParamsT(ct.Structure):
    _fields_ = [("dcOffset", DcOffsetT), ("decimation", DecimationT),
                ("agc", AgcT), ("adsbMode", ct.c_int)]


class RxChannelParams(ct.Structure):
    _fields_ = [("tunerParams", TunerParamsT),
                ("ctrlParams", CtrlParamsT),
                ("rsp1aTunerParams", Rsp1aTunerParamsT),
                ("rsp2TunerParams", Rsp2TunerParamsT),
                ("rspDuoTunerParams", RspDuoTunerParamsT),
                ("rspDxTunerParams", RspDxTunerParamsT)]


class DeviceParamsT(ct.Structure):
    _fields_ = [("devParams", ct.POINTER(DevParamsT)),
                ("rxChannelA", ct.POINTER(RxChannelParams)),
                ("rxChannelB", ct.POINTER(RxChannelParams))]


class StreamCbParamsT(ct.Structure):
    _fields_ = [("firstSampleNum", ct.c_uint), ("grChanged", ct.c_int),
                ("rfChanged", ct.c_int), ("fsChanged", ct.c_int),
                ("numSamples", ct.c_uint)]


class PowerOverloadCbParamT(ct.Structure):
    _fields_ = [("powerOverloadChangeType", ct.c_int)]


class EventParamsT(ct.Union):
    _fields_ = [("powerOverloadParams", PowerOverloadCbParamT),
                ("_pad", ct.c_byte * 32)]


STREAM_CB = ct.CFUNCTYPE(None, ct.POINTER(ct.c_short),
                         ct.POINTER(ct.c_short),
                         ct.POINTER(StreamCbParamsT),
                         ct.c_uint, ct.c_uint, ct.c_void_p)
EVENT_CB = ct.CFUNCTYPE(None, ct.c_int, ct.c_int,
                        ct.POINTER(EventParamsT), ct.c_void_p)


class CallbackFnsT(ct.Structure):
    _fields_ = [("StreamACbFn", STREAM_CB), ("StreamBCbFn", STREAM_CB),
                ("EventCbFn", EVENT_CB)]


def bind(lib: ct.CDLL) -> ct.CDLL:
    """Declare argtypes/restypes for the entry points we call."""
    lib.sdrplay_api_Open.restype = ct.c_int
    lib.sdrplay_api_Close.restype = ct.c_int
    lib.sdrplay_api_GetDevices.restype = ct.c_int
    lib.sdrplay_api_GetDevices.argtypes = [ct.POINTER(DeviceT),
                                           ct.POINTER(ct.c_uint), ct.c_uint]
    lib.sdrplay_api_SelectDevice.restype = ct.c_int
    lib.sdrplay_api_SelectDevice.argtypes = [ct.POINTER(DeviceT)]
    lib.sdrplay_api_ReleaseDevice.restype = ct.c_int
    lib.sdrplay_api_ReleaseDevice.argtypes = [ct.POINTER(DeviceT)]
    lib.sdrplay_api_GetDeviceParams.restype = ct.c_int
    lib.sdrplay_api_GetDeviceParams.argtypes = [
        HANDLE, ct.POINTER(ct.POINTER(DeviceParamsT))]
    lib.sdrplay_api_Init.restype = ct.c_int
    lib.sdrplay_api_Init.argtypes = [HANDLE, ct.POINTER(CallbackFnsT),
                                     ct.c_void_p]
    lib.sdrplay_api_Uninit.restype = ct.c_int
    lib.sdrplay_api_Uninit.argtypes = [HANDLE]
    lib.sdrplay_api_Update.restype = ct.c_int
    lib.sdrplay_api_Update.argtypes = [HANDLE, ct.c_int, ct.c_uint,
                                       ct.c_uint]
    lib.sdrplay_api_GetErrorString.restype = ct.c_char_p
    lib.sdrplay_api_GetErrorString.argtypes = [ct.c_int]
    return lib
