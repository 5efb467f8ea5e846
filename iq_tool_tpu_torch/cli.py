"""Command-line interface of the torch port (the port of
``iq_tool_tpu.cli`` for the chain this package runs).

    python -m iq_tool_tpu_torch -i raw-file -o raw in.raw out.raw \\
        --raw-file-input-rate 2048000 --raw-file-input-sample-format cs16 \\
        --output-rate 1488375 --dc-block --freq-shift 100000 \\
        --lowpass 400000 --device cuda

The flags are the reference parser's, plus ``--device`` (the
counterpart of the reference's JAX_PLATFORMS).  ``--device cuda``
without a card is an error; nothing falls back to the CPU.  The mesh
flags shard the chain over the visible cards (``parallel/sharded.py``);
with ``--device cpu`` the CPU stands in for CPU_MESH_DEVICES devices, as
the reference's tests give JAX eight virtual CPU devices.  ``--profile-dir``
writes a torch.profiler trace (CPU activity on every thread, so the
engine's reader and writer spans too, plus the card's kernels on CUDA)
that Perfetto or chrome://tracing opens.  The final summary gives the
median of each of the engine's spans (``pipeline/runtime.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import signal
import statistics
import sys
import time

from iq_tool_tpu_torch import __version__
from iq_tool_tpu_torch import constants as C
from iq_tool_tpu_torch.formats import complex_formats
from iq_tool_tpu_torch.modules import INPUT_MODULES, OUTPUT_MODULES, get_input, get_output
from iq_tool_tpu_torch.presets import load_presets
from iq_tool_tpu_torch.config import (AppConfig, apply_preset,
                                      collect_filter_requests, resolve_rates,
                                      validate)

# the devices --device cpu offers the mesh flags
CPU_MESH_DEVICES = 8


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="iq_tool_tpu_torch",
        description="I/Q stream processor on PyTorch + CUDA "
                    "(resample / shift / filter / AGC)")
    p.add_argument("input_file", nargs="?", help="Input file (file sources)")
    p.add_argument("output_file", nargs="?", help="Output file (file sinks)")
    p.add_argument("--version", action="version",
                   version=f"iq_tool_tpu_torch {__version__}")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Device the chain runs on (default cuda; no fallback)")

    g = p.add_argument_group("Required Input & Output")
    g.add_argument("-i", "--input", required=True, metavar="TYPE",
                   help="Input type {%s}" % "|".join(sorted(INPUT_MODULES)))
    g.add_argument("-o", "--output", required=True, metavar="TYPE",
                   help="Output type {%s}" % "|".join(sorted(OUTPUT_MODULES)))

    g = p.add_argument_group("Output Options")
    g.add_argument("--output-sample-format", metavar="FMT",
                   help="Sample format for output data {%s}" %
                        "|".join(complex_formats()))
    g.add_argument("--force-overwrite", action="store_true",
                   help="Overwrite existing output files without prompting")

    g = p.add_argument_group("Processing Options")
    g.add_argument("--output-rate", type=float, metavar="HZ",
                   help="Output sample rate in Hz")
    g.add_argument("--gain-multiplier", type=float, default=1.0, metavar="G",
                   help="Linear gain multiplier applied to input samples")
    g.add_argument("--freq-shift", type=float, metavar="HZ",
                   help="Frequency shift in Hz (e.g. -100e3)")
    g.add_argument("--shift-after-resample", action="store_true",
                   help="Apply the frequency shift AFTER resampling")
    g.add_argument("--no-resample", action="store_true",
                   help="Process at the native input rate")
    g.add_argument("--raw-passthrough", action="store_true",
                   help="Bypass all processing; copy raw bytes")
    g.add_argument("--iq-correction", action="store_true",
                   help="Enable automatic I/Q imbalance correction")
    g.add_argument("--dc-block", action="store_true",
                   help="Enable DC offset removal")
    g.add_argument("--preset", metavar="NAME", help="Apply a named preset")
    g.add_argument("--list-presets", action="store_true",
                   help="List available presets and exit")

    g = p.add_argument_group("Output Automatic Gain Control (AGC)")
    g.add_argument("--output-agc", action="store_true",
                   help="Enable automatic gain control on the output")
    g.add_argument("--agc-profile", metavar="P",
                   help="AGC profile {dx|local|digital} (default: local)")
    g.add_argument("--agc-target", type=float, metavar="T",
                   help="AGC target magnitude (0.0 - 1.0)")

    g = p.add_argument_group(
        "Filtering Options (chain up to 5 with suffixes -2..-5)")
    for i in range(1, C.FILTER_MAX_CHAIN + 1):
        sfx = "" if i == 1 else f"-{i}"
        show = i == 1
        g.add_argument(f"--lowpass{sfx}", type=float, metavar="HZ",
                       help="Keep -<hz>..+<hz> around DC" if show
                       else argparse.SUPPRESS)
        g.add_argument(f"--highpass{sfx}", type=float, metavar="HZ",
                       help="Reject -<hz>..+<hz> around DC" if show
                       else argparse.SUPPRESS)
        g.add_argument(f"--pass-range{sfx}", metavar="LO:HI",
                       help="Isolate a band, e.g. 102e3:215e3" if show
                       else argparse.SUPPRESS)
        g.add_argument(f"--stopband{sfx}", metavar="LO:HI",
                       help="Notch a band, e.g. -10e3:10e3" if show
                       else argparse.SUPPRESS)

    g = p.add_argument_group("Filter Quality Options")
    g.add_argument("--transition-width", type=float, metavar="HZ",
                   help="Filter sharpness (transition width in Hz)")
    g.add_argument("--filter-taps", type=int, metavar="N",
                   help="Exact filter length (overrides --transition-width)")
    g.add_argument("--attenuation", type=float, metavar="DB",
                   help="Stop-band attenuation in dB (default 60)")
    g.add_argument("--filter-type", metavar="T",
                   help="Filter implementation {fir|fft} (default auto)")
    g.add_argument("--filter-fft-size", type=int, metavar="N",
                   help="FFT size for the fft filter (power of two)")

    g = p.add_argument_group("SDR General Options")
    g.add_argument("--sdr-rf-freq", type=float, metavar="HZ",
                   help="(Required for SDR inputs) Tuner center frequency in Hz")
    g.add_argument("--sdr-sample-rate", type=float, metavar="HZ",
                   help="SDR sample rate in Hz (device-specific default)")
    g.add_argument("--sdr-bias-t", action="store_true",
                   help="Enable Bias-T power")
    g.add_argument("--sdr-buffered", action="store_true",
                   help="Buffered capture mode (IQPK packets)")

    g = p.add_argument_group("Performance Options")
    g.add_argument("--block-size", type=int, default=C.DEFAULT_BLOCK_SIZE,
                   metavar="N", help="Device block size in frames "
                   "(per time shard when --mesh-time > 1)")
    g.add_argument("--pipeline-depth", type=int, default=C.PIPELINE_DEPTH,
                   metavar="N", help="Device steps kept in flight before a "
                   "readback")
    g.add_argument("--channels", type=int, default=1, metavar="N",
                   help="Process N independent streams as one batch. File "
                        "paths then take a {ch} placeholder (in_{ch}.raw) "
                        "or N comma-separated paths")
    g.add_argument("--mesh-channel", type=int, metavar="N",
                   help="Shard the channel axis over N devices (default: "
                        "the largest divisor of --channels that fits the "
                        "device budget left by --mesh-time)")
    g.add_argument("--mesh-time", type=int, metavar="N",
                   help="Shard each block over N devices along time "
                        "(halo-exchange sequence parallelism; default: "
                        "remaining devices / --mesh-channel)")
    g.add_argument("--time-fold", type=int, metavar="F",
                   help="Run each channel's block as F consecutive row blocks in "
                        "one step (default: automatic, 8 // --channels rows on "
                        "the card as the JAX CLI on its TPU, 1 on the CPU)")
    g.add_argument("--profile-dir", metavar="DIR",
                   help="Write a torch.profiler trace of the run into DIR "
                        "(open with Perfetto or chrome://tracing)")

    g = p.add_argument_group("Reliability Options")
    g.add_argument("--log-level", default="info", metavar="L",
                   help="Log level {trace|debug|info|warn|error} (default info)")
    g.add_argument("--checkpoint", metavar="FILE",
                   help="Periodically persist stream state for resume")
    g.add_argument("--checkpoint-interval", type=float, default=30.0,
                   metavar="SEC", help="Checkpoint cadence (default 30 s)")
    g.add_argument("--resume", action="store_true",
                   help="Resume from an existing --checkpoint file")
    g.add_argument("--no-watchdog", action="store_true",
                   help="Disable the stalled-stream watchdog on live inputs")

    for mod in list(INPUT_MODULES.values()) + list(OUTPUT_MODULES.values()):
        mod.add_cli_options(p)
    return p


def config_from_args(args) -> AppConfig:
    cfg = AppConfig(
        input_type=args.input, output_type=args.output,
        input_path=args.input_file, output_path=args.output_file,
        output_format=args.output_sample_format,
        target_rate=args.output_rate,
        no_resample=args.no_resample,
        raw_passthrough=args.raw_passthrough,
        gain=args.gain_multiplier,
        freq_shift_hz=args.freq_shift,
        shift_after_resample=args.shift_after_resample,
        dc_block=args.dc_block, iq_correction=args.iq_correction,
        output_agc=args.output_agc, agc_profile=args.agc_profile,
        agc_target=args.agc_target,
        filters=collect_filter_requests(args),
        transition_width_hz=args.transition_width,
        filter_taps=args.filter_taps,
        attenuation_db=args.attenuation,
        filter_type=args.filter_type,
        filter_fft_size=args.filter_fft_size,
        preset_name=args.preset,
        force_overwrite=args.force_overwrite,
        resume=args.resume,
    )
    if cfg.preset_name:
        presets, path = load_presets()
        pr = presets.get(cfg.preset_name.lower())
        if pr is None:
            raise ValueError(
                f"unknown preset '{cfg.preset_name}'"
                + (f" (presets file: {path})" if path else " (no presets file found)"))
        apply_preset(cfg, pr)
    return cfg


def expand_channel_paths(path: str | None, n: int, what: str) -> list:
    """N per-channel paths from a '{ch}' template or a comma-separated list."""
    if n == 1:
        return [path]
    if path is None:
        raise ValueError(f"--channels {n} needs {n} {what} paths")
    if "{ch}" in path:
        return [path.replace("{ch}", str(c)) for c in range(n)]
    parts = [s for s in path.split(",") if s]
    if len(parts) != n:
        raise ValueError(
            f"--channels {n}: give a '{{ch}}' template or {n} "
            f"comma-separated {what} paths (got {len(parts)})")
    return parts


def build_mesh(device: str, channels: int, mesh_channel: int | None,
               mesh_time: int | None):
    """The (channel, time) mesh the mesh flags ask for, over distinct
    devices (the visible cards, or the CPU's CPU_MESH_DEVICES): an
    unspecified axis takes what the stream supports (the channel axis
    divides --channels) over a subset of them, as the reference CLI's."""
    from iq_tool_tpu_torch.parallel.sharded import make_mesh, visible_devices
    devices = visible_devices() if device == "cuda" else ["cpu"] * CPU_MESH_DEVICES
    n_dev = len(devices)
    mc, mt = mesh_channel, mesh_time
    if (mc or 1) * (mt or 1) > n_dev or (mc or 1) < 1 or (mt or 1) < 1:
        raise ValueError(f"mesh {mc or 1}x{mt or 1} needs {(mc or 1) * (mt or 1)} "
                         f"devices, have {n_dev}")
    if mc is None:
        cap = n_dev // mt
        mc = max(d for d in range(1, max(min(channels, cap), 1) + 1) if channels % d == 0)
    if mt is None:
        mt = n_dev // mc
    return make_mesh(devices[:mc * mt], mc, mt)


def choose_time_fold(time_fold: int | None, channels: int, device,
                     meshed: bool) -> tuple[int, bool]:
    """(rows per channel, whether the fold was chosen automatically) for
    --time-fold: an explicit F as given; the automatic fold (None) is the
    JAX CLI's rule on its accelerator, ``auto_fold`` (8 rows at one
    channel, 1 past 8 channels), on the card, and 1 on the CPU or with a
    mesh flag."""
    from iq_tool_tpu_torch.pipeline.folded import auto_fold
    if time_fold is not None:
        return time_fold, False
    if meshed or str(device).split(":")[0] != "cuda":
        return 1, True
    return auto_fold(channels), True


def fold_chain(cfg, fold: int, auto: bool, device):
    """A FoldedChain of ``fold`` rows (a Chain at fold <= 1).  A fold the
    configuration cannot take raises when it was asked for and falls
    back to the unfolded Chain when it was chosen automatically."""
    from iq_tool_tpu_torch.pipeline.chain import Chain
    from iq_tool_tpu_torch.pipeline.folded import FoldedChain
    if fold <= 1:
        return Chain(cfg, device=device)
    try:
        return FoldedChain(cfg, fold, device=device)
    except ValueError:
        if not auto:
            raise
        return Chain(cfg, device=device)


def build_chain(cfg: AppConfig, block_size: int, channels: int, device,
                time_fold: int | None = None, mesh_channel: int | None = None,
                mesh_time: int | None = None):
    """The Chain the flags ask for: a ShardedChain with a mesh flag, else
    the fold ``choose_time_fold`` picks (``fold_chain``)."""
    from iq_tool_tpu_torch.parallel.sharded import ShardedChain
    from iq_tool_tpu_torch.pipeline.chain import ChainConfig
    if cfg.raw_passthrough:
        return None
    shift = cfg.freq_shift_hz if cfg.freq_shift_hz is not None else cfg.nco_shift_hz
    pre = 0.0 if cfg.shift_after_resample else (shift or 0.0)
    post = (shift or 0.0) if cfg.shift_after_resample else 0.0
    fold, auto = choose_time_fold(time_fold, channels, device,
                                  bool(mesh_channel or mesh_time))
    make = lambda c, device: fold_chain(c, fold, auto, device)    # noqa: E731
    if mesh_channel or mesh_time:
        if fold > 1:
            raise ValueError("--time-fold does not combine with --mesh-channel/--mesh-time "
                             "(the sharded path has its own per-shard batching)")
        mesh = build_mesh(device, channels, mesh_channel, mesh_time)
        make = lambda c, device: ShardedChain(c, mesh)      # noqa: E731
    return make(ChainConfig(
        channels=channels,
        input_format=cfg.input_format,
        output_format=cfg.output_format,
        input_rate=cfg.input_rate,
        target_rate=None if cfg.no_resample else cfg.target_rate,
        gain=cfg.gain,
        dc_block=cfg.dc_block,
        iq_correction=cfg.iq_correction,
        freq_shift_pre_hz=pre,
        freq_shift_post_hz=post,
        filters=tuple(cfg.filters),
        filter_method=cfg.filter_type or "auto",
        filter_fft_size=cfg.filter_fft_size,
        filter_taps=cfg.filter_taps,
        filter_transition_hz=cfg.transition_width_hz,
        filter_attenuation_db=cfg.attenuation_db or C.RESAMPLER_ATTENUATION_DB,
        agc_profile=(cfg.agc_profile or "local") if cfg.output_agc else None,
        agc_target=cfg.agc_target,
        target_block=block_size,
    ), device=device)


def calibrate_carry(chain, sources, gain: float):
    """The pre-stream I/Q calibration for rewindable sources: the chain's
    initial carry with factors calibrated on each channel's first
    IQ_FFT_SIZE frames, or None when a source cannot rewind."""
    import numpy as np
    import torch

    from iq_tool_tpu_torch.ops import convert, iq_balance
    cals = [src.calibration_frames(C.IQ_FFT_SIZE) for src in sources]
    if any(c is None for c in cals):
        return None
    wire = torch.from_numpy(np.stack([np.frombuffer(c, chain.in_wire_dtype)
                                      for c in cals], axis=0)).to(chain.device)
    xr, xi = convert.to_planar(wire, chain.fmt_in, gain)
    factors = iq_balance.calibrate(torch.complex(xr, xi))
    tree = chain.carry_to_numpy(chain.init_carry(len(sources)))
    tree["iq"] = (factors.cpu().numpy(), tree["iq"][1])
    return chain.carry_from_numpy(tree)


def _print_summary_table(title: str, items: dict, file=sys.stderr) -> None:
    if not items:
        return
    print(f"--- {title} ---", file=file)
    width = max(len(k) for k in items)
    for k, v in items.items():
        print(f"  {k:<{width}} : {v}", file=file)


def _progress(summary, elapsed, total_frames) -> None:
    mb = summary.bytes_out / 1e6
    rate = mb / elapsed if elapsed > 0 else 0.0
    msps = summary.frames_in / 1e6 / elapsed if elapsed > 0 else 0.0
    pct = ""
    if total_frames:
        pct = f" ({100.0 * summary.frames_in / total_frames:5.1f}%)"
    print(f"\r  {summary.frames_out} frames out{pct}  {mb:.1f} MB  "
          f"{rate:.1f} MB/s  {msps:.1f} Msps", end="", file=sys.stderr,
          flush=True)


_NUM_RE = re.compile(r"^-\d+(\.\d*)?([eE][+-]?\d+)?"
                     r"(:[+-]?\d+(\.\d*)?([eE][+-]?\d+)?)?$")


def _fix_negative_numbers(argv: list[str]) -> list[str]:
    """argparse rejects '--freq-shift -50e3' and '--stopband -5e3:5e3' (a
    leading '-' looks like an option): merge such values into
    '--opt=value' form."""
    out = []
    i = 0
    while i < len(argv):
        tok = argv[i]
        if (tok.startswith("--") and "=" not in tok and i + 1 < len(argv)
                and _NUM_RE.match(argv[i + 1])):
            out.append(f"{tok}={argv[i + 1]}")
            i += 2
        else:
            out.append(tok)
            i += 1
    return out


def _check_preset_pseudo_flags(parser, argv) -> None:
    """Catch '--cu8-nrsc5' style mistakes (a preset name used as a flag)
    before argparse's generic error."""
    flagged = [t for t in argv if t.startswith("--")]
    if not flagged:
        return
    try:
        presets, _ = load_presets()
    except (OSError, ValueError):
        return
    for tok in flagged:
        name = tok[2:].split("=")[0].lower()
        if name in presets:
            parser.error(
                f"'{tok}' is a preset name, not an option; presets are "
                f"applied with --preset {name}")


def _span_medians(serial: int) -> dict:
    """{span name: its median ms and count} of the engine's spans of the
    run ``serial`` (the newest spans the record holds)."""
    from iq_tool_tpu_torch.pipeline import trace
    ms: dict = {}
    for sp in trace.record():
        if sp.run == serial and sp.name.startswith("engine."):
            ms.setdefault(sp.name, []).append((sp.end_ns - sp.start_ns) / 1e6)
    return {name: f"{statistics.median(v):.3f} ms (x{len(v)})" for name, v in ms.items()}


def _stage_rows(engine, noted: dict) -> dict:
    """{stage: its host ms and the kernels it launches, a step} of the
    engine's run ``engine.serial``: a graphed step's kernels as its
    capture noted them (a replay runs no span, so its stages have no
    host time), an eager step's as the run noted them since ``noted``
    (``trace.launches()`` before it)."""
    from iq_tool_tpu_torch.pipeline import trace
    ms: dict = {}
    blocks = 0
    for sp in trace.record():
        if sp.run == engine.serial:
            blocks += sp.name == "engine.step"
            if sp.name.startswith("chain."):
                ms[sp.name] = ms.get(sp.name, 0.0) + (sp.end_ns - sp.start_ns) / 1e6
    blocks = max(blocks, 1)
    kern = getattr(engine.stepper, "stage_kernels", None)
    if kern is None:
        kern = {st: {sym: n / blocks for sym, n in k.items()}
                for st, k in trace.stage_launches(noted, trace.launches()).items()}
    rows = {}
    for stage in dict.fromkeys([*ms, *kern]):
        if stage is None:
            continue
        t = f"{ms[stage] / blocks:.3f} ms" if stage in ms else "in the graph"
        k = ", ".join(f"{sym} x{n:g}" for sym, n in kern.get(stage, {}).items())
        rows[stage] = f"{t}; {k or 'no kernel'}"
    return rows


def _run(engine, profile_dir, on_cuda: bool, log):
    """engine.run(), under torch.profiler when a profile directory is
    given: CPU activity on every thread (the engine's reader and writer
    too), plus CUDA on the card, synchronised before the trace closes so
    the last steps' kernels are in it."""
    if not profile_dir:
        return engine.run()
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    every_thread = torch.profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=acts, experimental_config=every_thread) as prof:
        s = engine.run()
        if on_cuda:
            torch.cuda.synchronize()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"iq_tool_tpu_torch_{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)
    return s


def main(argv=None) -> int:
    parser = build_parser()
    argv = _fix_negative_numbers(list(sys.argv[1:] if argv is None else argv))
    _check_preset_pseudo_flags(parser, argv)
    args = parser.parse_args(argv)
    if (args.mesh_channel or args.mesh_time) and (args.time_fold or 1) > 1:
        parser.error("--time-fold does not combine with --mesh-channel/--mesh-time "
                     "(the sharded path has its own per-shard batching)")

    if args.list_presets:
        presets, path = load_presets()
        print(f"Presets from {path}:" if path else "No presets file found.")
        for name, pr in sorted(presets.items()):
            print(f"  {name:<22} {pr.values.get('description', '')}")
        return 0

    from iq_tool_tpu_torch.utils.log import configure as configure_log, get_logger
    configure_log(args.log_level)
    log = get_logger("cli")

    def _sigterm(_sig, _frm):
        raise KeyboardInterrupt
    try:
        signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:
        pass  # not the main thread (library use)

    from iq_tool_tpu_torch.pipeline import trace
    from iq_tool_tpu_torch.pipeline.runtime import StreamEngine
    watchdog = None
    try:
        cfg = config_from_args(args)
        n_ch = max(1, args.channels)
        in_paths = expand_channel_paths(cfg.input_path, n_ch, "input")
        out_paths = expand_channel_paths(cfg.output_path, n_ch, "output")
        sources, sinks, infos = [], [], []
        for c in range(n_ch):
            src = get_input(cfg.input_type)
            src_cfg = (cfg if n_ch == 1
                       else dataclasses.replace(cfg, input_path=in_paths[c],
                                                output_path=out_paths[c]))
            infos.append(src.initialize(src_cfg, args))
            sources.append(src)
        source, info = sources[0], infos[0]
        if n_ch > 1:
            if source.is_realtime:
                raise ValueError("--channels needs file/network sources")
            for c, other in enumerate(infos[1:], 1):
                if (other.sample_rate != info.sample_rate
                        or other.sample_format != info.sample_format):
                    raise ValueError(
                        f"channel {c} ({in_paths[c]}) has rate/format "
                        f"{other.sample_rate}/{other.sample_format}, "
                        f"channel 0 has {info.sample_rate}/{info.sample_format}")
        cfg.nco_shift_hz = info.nco_shift_hz
        resolve_rates(cfg, info.sample_rate, info.sample_format)
        validate(cfg)
        chain = build_chain(cfg, args.block_size, n_ch, args.device, args.time_fold,
                            args.mesh_channel, args.mesh_time)
        for c in range(n_ch):
            snk = get_output(cfg.output_type)
            snk_cfg = (cfg if n_ch == 1
                       else dataclasses.replace(cfg, input_path=in_paths[c],
                                                output_path=out_paths[c]))
            snk.initialize(snk_cfg, args)
            sinks.append(snk)
        sink = sinks[0]
        initial_carry = None
        if chain is not None and cfg.iq_correction:
            initial_carry = calibrate_carry(chain, sources, cfg.gain)

        if source.is_realtime and not args.no_watchdog and hasattr(source, "heartbeat"):
            from iq_tool_tpu_torch.utils.watchdog import Watchdog
            t_grace = time.monotonic()
            watchdog = Watchdog(lambda: max(getattr(source, "heartbeat", 0.0), t_grace))
            watchdog.start()

        summary_items = {"Device": args.device,
                         "Input Type": cfg.input_type,
                         "Input Rate": f"{cfg.input_rate:.6g} Hz",
                         "Output Rate": f"{cfg.output_rate:.6g} Hz",
                         "Output Format": cfg.output_format}
        summary_items.update(source.summary())
        summary_items.update(sink.summary())
        if chain is not None:
            from iq_tool_tpu_torch.pipeline.graphed import step_form
            summary_items["Time Fold"] = getattr(chain, "fold", 1)
            summary_items["Step"] = step_form(chain)
        if chain is not None and chain.resampler is not None:
            pl = chain.resampler.plan
            summary_items["Resample Ratio"] = f"{pl.p}/{pl.q} = {pl.p / pl.q:.9g}"
        if sink.requires_output_path:
            _print_summary_table("Configuration Summary", summary_items)

        engine = StreamEngine(chain, sources if n_ch > 1 else source,
                              sinks if n_ch > 1 else sink,
                              raw_passthrough=cfg.raw_passthrough,
                              progress=_progress if sink.requires_output_path else None,
                              progress_total_frames=info.total_frames,
                              checkpoint_path=args.checkpoint,
                              checkpoint_interval_sec=args.checkpoint_interval,
                              resume=args.resume,
                              initial_carry=initial_carry,
                              pipeline_depth=args.pipeline_depth)
        try:
            # the build and the capture, ahead of the stream and of the
            # profiler's window
            engine.prepare()
            noted = trace.launches()
            s = _run(engine, args.profile_dir,
                     chain is not None and chain.device.type == "cuda", log)
        finally:
            # finalize even when the stream fails (a partial WAV with its
            # sizes patched), each sink on its own, after stopping the
            # watchdog so it cannot hard-exit a process already unwinding
            if watchdog:
                watchdog.stop()
            for snk in sinks:
                try:
                    snk.finalize()
                except Exception as fin_err:
                    log.warning("finalize failed: %s", fin_err)
            for src in sources:
                src.close()
        if sink.requires_output_path:
            print(file=sys.stderr)
            _print_summary_table("Final Summary", {
                "Start-up": f"{getattr(engine.stepper, 'capture_sec', 0.0):.2f} s "
                            "(kernel build, graph capture)",
                "Duration": f"{s.duration_sec:.2f} s",
                "Frames In": s.frames_in,
                "Frames Out": s.frames_out,
                "Bytes Out": s.bytes_out,
                "Average Speed": f"{s.avg_mb_per_sec:.2f} MB/s",
                "Status": "interrupted" if s.interrupted else "complete",
            })
            if engine.serial is not None:
                _print_summary_table("Engine Spans (median, count)",
                                     _span_medians(engine.serial))
                _print_summary_table("Step Stages (host ms, kernels; a step)",
                                     _stage_rows(engine, noted))
        return 130 if s.interrupted else 0
    except (ValueError, OSError, NotImplementedError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        if watchdog:        # a set-up error after it started: it must not fire later
            watchdog.stop()


if __name__ == "__main__":
    sys.exit(main())
