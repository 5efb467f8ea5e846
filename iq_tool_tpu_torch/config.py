"""Application configuration: CLI/preset resolution and validation (the
port of ``iq_tool_tpu.config``, which cannot be imported without jax).

Three-layer precedence: module defaults < preset values < explicit CLI
flags, each preset key applied only if not already set, plus the
combination rules of the reference tool.
"""

from __future__ import annotations

import dataclasses

from iq_tool_tpu_torch import constants as C
from iq_tool_tpu_torch.formats import get_format
from iq_tool_tpu_torch.presets import Preset
from iq_tool_tpu_torch.ops.fir_design import FilterRequest


@dataclasses.dataclass
class AppConfig:
    """Resolved user intent."""
    input_type: str = ""
    output_type: str = ""
    input_path: str | None = None
    output_path: str | None = None
    output_format: str | None = None
    target_rate: float | None = None
    no_resample: bool = False
    raw_passthrough: bool = False
    gain: float = 1.0
    freq_shift_hz: float | None = None
    shift_after_resample: bool = False
    dc_block: bool = False
    iq_correction: bool = False
    output_agc: bool = False
    agc_profile: str | None = None
    agc_target: float | None = None
    filters: list = dataclasses.field(default_factory=list)
    transition_width_hz: float | None = None
    filter_taps: int | None = None
    attenuation_db: float | None = None
    filter_type: str | None = None
    filter_fft_size: int | None = None
    preset_name: str | None = None
    force_overwrite: bool = False
    resume: bool = False
    # filled at setup time
    input_rate: float | None = None
    input_format: str | None = None
    output_rate: float | None = None
    nco_shift_hz: float = 0.0


def parse_range(spec: str, opt: str) -> tuple[float, float]:
    """'start:end' -> (center, width)."""
    try:
        lo_s, _, hi_s = spec.partition(":")
        lo, hi = float(lo_s), float(hi_s)
    except ValueError:
        raise ValueError(f"--{opt} expects 'start_freq:end_freq', got {spec!r}") from None
    if hi <= lo:
        raise ValueError(f"--{opt}: end frequency must exceed start ({spec!r})")
    return (lo + hi) / 2.0, hi - lo


def collect_filter_requests(args) -> list[FilterRequest]:
    """Assemble up to 5 chained requests from --lowpass[-2..5] etc."""
    reqs: list[FilterRequest] = []
    for i in range(1, C.FILTER_MAX_CHAIN + 1):
        sfx = "" if i == 1 else f"_{i}"
        lp = getattr(args, f"lowpass{sfx}", None)
        hp = getattr(args, f"highpass{sfx}", None)
        pr = getattr(args, f"pass_range{sfx}", None)
        sb = getattr(args, f"stopband{sfx}", None)
        if lp:
            reqs.append(FilterRequest("lowpass", float(lp)))
        if hp:
            reqs.append(FilterRequest("highpass", float(hp)))
        if pr:
            c_, w = parse_range(pr, "pass-range")
            reqs.append(FilterRequest("pass-range", c_, w))
        if sb:
            c_, w = parse_range(sb, "stopband")
            reqs.append(FilterRequest("stop-range", c_, w))
    if len(reqs) > C.FILTER_MAX_CHAIN:
        raise ValueError(
            f"at most {C.FILTER_MAX_CHAIN} filters may be chained "
            f"({len(reqs)} requested)")
    return reqs


def apply_preset(cfg: AppConfig, preset: Preset) -> None:
    """Preset values fill only unset fields."""
    v = preset.values
    if cfg.target_rate is None and "target_rate" in v:
        cfg.target_rate = v["target_rate"]
    if cfg.output_format is None and "output_sample_format_name" in v:
        cfg.output_format = v["output_sample_format_name"]
    if cfg.gain == 1.0 and "gain-multiplier" in v:
        cfg.gain = v["gain-multiplier"]
    if not cfg.dc_block and "dc_block" in v:
        cfg.dc_block = v["dc_block"]
    if not cfg.iq_correction and "iq_correction" in v:
        cfg.iq_correction = v["iq_correction"]
    if "agc_profile" in v:
        cfg.output_agc = True
        if cfg.agc_profile is None:
            cfg.agc_profile = v["agc_profile"]
    if cfg.agc_target is None and "agc_target" in v:
        cfg.agc_target = v["agc_target"]
    if not cfg.filters:
        reqs = []
        if "lowpass" in v:
            reqs.append(FilterRequest("lowpass", v["lowpass"]))
        if "highpass" in v:
            reqs.append(FilterRequest("highpass", v["highpass"]))
        if "pass_range" in v:
            c_, w = parse_range(v["pass_range"], "pass-range")
            reqs.append(FilterRequest("pass-range", c_, w))
        if "stopband" in v:
            c_, w = parse_range(v["stopband"], "stopband")
            reqs.append(FilterRequest("stop-range", c_, w))
        cfg.filters = reqs
    if cfg.transition_width_hz is None and "transition_width" in v:
        cfg.transition_width_hz = v["transition_width"]
    if cfg.filter_taps is None and "filter_taps" in v:
        cfg.filter_taps = v["filter_taps"]
    if cfg.attenuation_db is None and "attenuation" in v:
        cfg.attenuation_db = v["attenuation"]
    if cfg.filter_type is None and "filter_type" in v:
        cfg.filter_type = v["filter_type"]


def validate(cfg: AppConfig) -> None:
    """Combination rules of the reference tool."""
    if cfg.iq_correction and not cfg.dc_block:
        raise ValueError("--iq-correction requires --dc-block")
    if cfg.raw_passthrough:
        incompatible = (cfg.dc_block or cfg.iq_correction or cfg.filters
                        or cfg.output_agc or cfg.freq_shift_hz
                        or (cfg.target_rate is not None))
        if incompatible:
            raise ValueError("--raw-passthrough bypasses all processing and "
                             "cannot be combined with DSP options")
    elif not cfg.no_resample and cfg.target_rate is None:
        raise ValueError("an output rate is required: use --output-rate, a "
                         "--preset, or --no-resample")
    if cfg.no_resample and cfg.target_rate is not None:
        raise ValueError("--no-resample conflicts with --output-rate/preset rate")
    if cfg.filter_type and cfg.filter_type not in ("fir", "fft"):
        raise ValueError(f"--filter-type must be fir or fft, got {cfg.filter_type!r}")
    if cfg.filter_fft_size is not None:
        n = cfg.filter_fft_size
        if n <= 0 or (n & (n - 1)):
            raise ValueError("--filter-fft-size must be a power of two")
    if cfg.agc_profile and cfg.agc_profile not in ("dx", "local", "digital"):
        raise ValueError(f"--agc-profile must be dx|local|digital, got "
                         f"{cfg.agc_profile!r}")
    if cfg.agc_target is not None and not (0.0 < cfg.agc_target <= 1.0):
        raise ValueError("--agc-target must be in (0, 1]")
    if cfg.output_format is not None:
        fmt = get_format(cfg.output_format)
        if not fmt.is_complex:
            raise ValueError(f"output format '{fmt.name}' is not complex I/Q")
    if cfg.output_type in ("wav", "wav-rf64", "wav-legacy"):
        if cfg.output_format not in (None, "cs16", "cu8"):
            raise ValueError("WAV output supports cs16/cu8 only")


def resolve_rates(cfg: AppConfig, input_rate: float, input_format: str) -> None:
    """Finalize rates/formats once the input module reports the source."""
    cfg.input_rate = input_rate
    cfg.input_format = input_format
    if cfg.raw_passthrough or cfg.no_resample or cfg.target_rate is None:
        cfg.output_rate = input_rate
    else:
        cfg.output_rate = cfg.target_rate
        ratio = cfg.target_rate / input_rate
        if not (C.RESAMPLE_RATIO_MIN <= ratio <= C.RESAMPLE_RATIO_MAX):
            raise ValueError(
                f"resample ratio {ratio:.6g} outside "
                f"[{C.RESAMPLE_RATIO_MIN}, {C.RESAMPLE_RATIO_MAX}]")
    if cfg.output_format is None:
        cfg.output_format = input_format
    if cfg.raw_passthrough and cfg.output_format != input_format:
        raise ValueError("--raw-passthrough requires input and output "
                         "formats to match")
