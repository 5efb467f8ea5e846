#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (iq_tool_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the checkout around this file, and refuses jax,
jaxlib and the JAX package.  One line per phase, exits non-zero at the
first failure:

1. card: nvidia-smi name and power limit, torch and CUDA versions;
2. build: nvcc compiles the kernels from csrc/ (registers, spills);
3. kernels vs their plain twins on the card, at the flagship shapes
   (K1 stage 0, the carry pass then the banded kernel with the DC-wire
   loader, with a bit-for-bit repeat, and at nrsc5's stage 0; its carry
   pass alone; the two-launch route it replaced, the DC prologue then K2
   over its planes, timed in turns with it; K2 decoding the wire and NCO
   in its staging against K2 over planes at stage 0; the DC prologue
   alone with a bit-for-bit repeat, K2 stage 1 packed, with a
   bit-for-bit repeat, on the wgmma core its rule gives and on the
   mma.sync core, timed in turns) and at the strides 224, 400 and 144
   and config #4's stages 512 and 256 (planar and packed, with
   bit-for-bit repeats, on both product cores, the rule's first; K2mma,
   K2 on the mma.sync core, at #4's stage 0; K2dec, K2 as the AM cell's
   43:1 decimator at its 64 x 1,056,768 planes, on the wgmma core with a
   bit-for-bit repeat), the banded core's design
   and launch geometry printed beside K1 and K2 (its bound counts the
   band's own operations, the padded products beside them), each timed
   twin, kernel, kernel, twin with CUDA events (K2 beside one float32
   matmul of the unfolded windows);
4. the slice: the flagship Chain (128 channels x 262144 frames) for 6
   steps; K1, its carry pass and K2 (on the wgmma core) must each count
   6, the DC prologue and K2 on the mma.sync core 0; output against the
   CPU twin
   chain on 2 channels and a tone SNR check; steady-state Msps and peak
   device memory;
5. the general step's kernels vs their twins at BASELINE config #4's
   shapes (128 channels): K3 dc_block_apply (cs16 and cu8 wire), K3pre
   pre_apply (the pre-stage without the DC block; cs16 wire with I/Q and
   NCO, cu8 wire bit for bit), K4 post_apply, K5 osfft_apply (at nfft 16384 and, on the schedule the
   chain makes for --filter-fft-size 32768, at nfft 32768, each beside
   the twin's torch.fft core; above K5's sizes, [osfft], the torch.fft
   route that takes nfft 131072 in its place, against K5's twin, timed
   and its peak memory) and two helper kernels, the AGC's gains
   (segment energies and gain loop; its bound the larger of its bytes
   and its dependency chain, the chain alone timed over the same
   energies) and the I/Q estimator ([iq]: the whole estimator of a step
   in one launch, on config #4's cs16 wire with the DC prefix, on a due
   step, factors within 2 moves, gate within 1e-3 dB and the counter
   equal, the same over 64 seeded draws of tone, imbalance, noise, start
   factors and DC state (``iq_draws``), and on one that is not, factors
   bit-identical and the counter exact), timed the same way;
6. the general step: config #4 (DC + I/Q + pre-shift, resampler,
   2175-tap overlap-save notch, post-shift, local AGC) at 128 x 262144
   for 6 steps with exact launch counters (the estimator one launch a
   step), against the CPU twin chain on 2 channels, tone SNR, ms per
   step, Msps, peak memory, all device launches a step (torch.profiler)
   and the estimator's call as the step makes it, due and not; then
   configs #5 and #3, and #4 with --filter-fft-size 32768 ([full32k]),
   131072 ([full128k], the torch.fft route once a step) and without the
   DC block ([full4], the benchmark's chain: K3pre in K3's place), the
   same way at 4 steps;
7. [gather]: the gather resampler stage (2.048 Msps -> 25282.56 sps,
   449/36371) behind the DC kernel and in front of K4 (local AGC), 128 x
   254597 frames for 4 steps with exact launch counters, against the CPU
   twin chain on 2 channels and an in-band tone's SNR; ms per step, Msps
   and peak device memory; then the stage alone (the gather kernel,
   csrc/gather.cu) timed, repeated bit for bit and held against its
   float64 definition; then the kernel at the HackRF cell's shape (64 x
   256172, 4766/64043, K 216) against its definition and its twin, bit
   for bit twice, timed beside the twin and embedding_bag alone, its
   bound and the benchmark's cs8-wire bound beside it;
8. [fold]: one stream at the CLI's 16384-frame block, the flagship and
   config #4: FoldedChain at F = 8 for 3 folded blocks against the same
   fold on the CPU (the twins) and against the row chain run 8 times a
   block on the card, its launches per step; config #4's AGC gains and
   K4 against their twins at the fold's shapes; then ms per step and
   Msps at F = 1, 2, 4, 8, 16;
8b. [shard]: the sharded chain on meshes that repeat cuda:0 (one card):
   1x1 flagship byte-identical to Chain, its ms and host wall per step
   beside Chain's; 1x4 flagship and config #4 and 2x2 flagship (each
   shard a 128 x 262144 block) against Chain at the per-shard framing
   (>= 60 dB, <= 32 codes) and against the same mesh on the CPU (the
   twins, the first channel of each slab, <= 4 codes), ms per step and
   exact launches per step (the DC kernel twice a shard, the AGC's
   segment energies once a shard and its chain kernel once a step); the
   AGC's two halves against their twins at the shapes the 1x4 config #4
   step gave them (one shard's planes; the four shards' gathered
   energies), timed; the first DC pass's cost a shard; 4x1 flagship
   (a channel mesh, one Chain step a position); every one of these
   meshes also graphed (GraphedStep over the ShardedChain): 4 replays of
   distinct blocks with a reset and a carry from carry_from_numpy,
   bit-identical to the eager sharded step, the captured kernels its
   exact launches; 1x4 flagship and config #4 eager and graphed in
   turns;
8c. [graph]: the step as one CUDA graph (pipeline/graphed.py) for the
   flagship and config #4 at 128 x 262144, and "c1", "4c1" and "4c1f8"
   (config #4 as one stream at the CLI's automatic fold): 10 replays of
   distinct blocks with a reset at the fifth and a carry handed in from
   carry_from_numpy at the eighth, every output and carry bit-identical
   to the eager step's; the kernels each capture recorded; its stage map
   (GraphedStep.stages) counting every device node of the graph; then eager
   and graphed steps timed in turns (eager, graph, graph, eager) by
   profile_steps: wall, busy, kernels and copies a step, idle, and the
   graph's device kernels held against the eager step's; then configs
   #1, #2, #3, #5, the gather chain, #4 at nfft 32768 and 131072 and
   with the dx and digital AGC, the HackRF chain at 16 channels, 6 replays each with a
   reset and a carry from carry_from_numpy, bit-identical to the eager
   step, the captured kernels its exact launches;
9. the CLI on a 10 s, 2.048 Msps cs16 tone file (the automatic fold: F =
   8 at one channel): the flagship flags, then the general step's (I/Q
   correction, notch, post-shift, AGC), each run's wall split into its
   start-up (kernel build, graph capture), its streaming and the rest;
10. [ckpt]: the CLI (in this process, so the launch counters see it) on a
   2 s tone file with the flagship flags: an uninterrupted run, a run on
   the file cut off a block boundary with --checkpoint, a --resume run
   against the whole file: byte-identical; with --time-fold 1, 4 and the
   automatic fold;
11. [profile]: the CLI with --profile-dir: the trace names K1's two
   kernels, the DC kernel's carry pass and the banded kernel with the
   DC-wire loader, replayed in the step's graph;
12. [bench]: ``python -m iq_tool_tpu_torch.bench --flagship-only``: the
   flagship as a GraphedStep at 128 x 262144, CUDA events over 3 and 13
   queued replays, and the C baseline on this host: bench.py's JSON line;
13. [host]: ``python -m iq_tool_tpu_torch.host_budget`` at 128 x 262144
   (the native ring built first where cmake can): every stage of the
   host's feed path timed alone, and the serial host Msps beside the
   device step's;
14. [cli128]: the CLI file to file at 128 channels (the flagship's flags,
   --channels 128 --block-size 262144) on 128 '{ch}'-templated cs16
   files of a seeded tone, 4.5 blocks each (576 MiB): every channel's
   output byte-identical to a GraphedStep of the flagship stepped over
   the same blocks (the last zero-padded, the output trimmed to
   expected_out_frames); the run cut after its second block and resumed
   from its checkpoint, byte-identical to the uncut run; wall, start-up,
   streaming seconds and Msps beside the device step's ([bench]);

then one JSON line per the kernels (each with its bound, the bytes or
operations that set it, the library call's time where there is one, and
its launches per step in each phase), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Inputs are made from a fixed seed.
"""

import importlib.abc
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS = 6
GENERAL_STEPS = 4           # configs #5 and #3, and #4 at nfft 32768
GATHER_STEPS = 4
FOLDS = (1, 2, 4, 8, 16)
FOLD_STEPS = 20             # timed steps per fold factor
SHARD_STEPS = 3             # sharded steps ([shard]); the first is not timed
SHARD_GRAPH_STEPS = 4       # graphed sharded replays against eager steps ([shard])
GRAPH_STEPS = 10            # graph replays against eager steps ([graph])
GRAPH_RESET = 4             # the step (from 0) that takes a reset
GRAPH_MORE_STEPS = 6        # replays of the other chains ([graph], 16 channels)
GRAPH_MORE_CH = 16
IQ_DRAWS = 64               # seeded draws of the I/Q estimator's due step ([iq])
# NVIDIA's data sheet for the H100 SXM (dense): the bounds below divide by
# these
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_TF32_S = 495e12


def bound(nbytes: float, ops: float, rate: float):
    """(ms, "bytes" | "operations"): the least time the card could take
    for work that moves nbytes and does ops operations at peak rate."""
    t_b, t_o = nbytes / PEAK_BYTES_S * 1e3, ops / rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def tf32x3_ops(band, channels: int, nb: int) -> float:
    """The band's own work in 3xTF32: three products for every non-zero
    tap of every column (K a column, the band's longest), two planes (four
    products with complex taps), 2 operations per multiply-add.  The
    kernel's tile padding is not the function's work."""
    planes = 4 if band.taps_i is not None else 2
    return 3 * 2 * planes * channels * nb * band.g * band.k


def tf32x3_padded(band, channels: int, nb: int, core: str) -> float:
    """The 3xTF32 operations the kernel issues: every column tile's
    whole span for every window of its window groups (a ragged last group
    multiplies a whole one), the padding included; on the wgmma core
    32-window groups and 32-column tiles, on the mma.sync core 16 and 16."""
    planes = 4 if band.taps_i is not None else 2
    if core == "mma":
        win, cols, tiles, span = 16, 16, band.frag_tiles, band.frag_span
    else:
        win, cols, tiles, span = 32, 32, band.n_tiles, band.span
    return 3 * 2 * planes * channels * -(-nb // win) * win * tiles * cols * span


def plan_line(kernels, band, stride: int, hist: int, n: int, channels: int,
              dc_kind=None, core=None, wire_kind=None) -> str:
    """The banded kernel's design and launch geometry at these shapes (the
    core kernels.banded_core picks, or ``core``), over planes or the
    packed wire of ``wire_kind``."""
    p = kernels.banded_plan(band, stride, hist, n, channels, dc_kind, core, wire_kind)
    if p["core"] == "mma":
        return (f"design: mma.sync m16n8k8 3xTF32 (csrc/banded_mma.cu), 16 windows "
                f"x tiles of 16 columns, taps split in the loop; span {band.frag_span}, "
                f"{band.frag_tiles} tiles; grid {p['grid']} x {p['threads']} threads, "
                f"{p['ctas_per_sm']} CTA(s) an SM, {p['smem']} B shared, {p['groups']} "
                f"groups a channel, staging {p['staging']}")
    return (f"design: wgmma m64n{kernels.TILE_COLS}k8 3xTF32 (csrc/banded.cu), A = 32 "
            f"windows x 2 planes from registers, B = host-split taps in shared memory; "
            f"tiles of {kernels.TILE_COLS} columns, span {band.span}, {band.n_tiles} tiles; "
            f"grid {p['grid']} x {p['threads']} threads, {p['ctas_per_sm']} CTA(s) "
            f"an SM, {p['smem']} B shared, {p['nbuf']} staged group(s), ring "
            f"{p['ring']} x {p['cs']} steps, {p['groups']} groups a channel")


class _NoJax(importlib.abc.MetaPathFinder):
    """The port must run without jax and without the JAX package: refuse
    them outright."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "iq_tool_tpu"):
            raise ImportError(f"chip_smoke refuses to import {name}")
        return None


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def snr_db(ref, test) -> float:
    ref = np.asarray(ref, np.complex128).ravel()
    err = ref - np.asarray(test, np.complex128).ravel()
    p_err = np.mean(np.abs(err) ** 2)
    return float("inf") if p_err == 0 else float(
        10 * np.log10(np.mean(np.abs(ref) ** 2) / p_err))


def tone_snr_db(iq: np.ndarray, freq_hz: float, rate: float, start: int) -> float:
    """SNR of a complex tone fitted (amplitude and phase) over iq[start:]."""
    seg = iq[start:].astype(np.complex128)
    m = np.arange(start, start + seg.size)
    ideal = np.exp(2j * np.pi * (freq_hz / rate) * m)
    a = np.vdot(ideal, seg) / np.vdot(ideal, ideal)
    return float(10 * np.log10(np.mean(np.abs(a * ideal) ** 2)
                               / np.mean(np.abs(seg - a * ideal) ** 2)))


def nco_hz(shift_hz: float, rate: float) -> float:
    """The shift an NCO realises: its 32-bit phase increment rounds the
    requested one (by up to 1.7e-4 Hz at 1.488375 Msps, which a fit over
    9 s at the requested frequency would already see at ~45 dB)."""
    from iq_tool_tpu_torch.ops import nco
    d = nco.freq_to_dtheta(shift_hz, rate)
    return (d - ((d >> 31) << 32)) / 2 ** 32 * rate


def cli_times(stderr: str) -> tuple[float, float, int]:
    """(start-up s, streaming s, time fold) from the CLI's summaries: the
    kernel build and the graph capture, the stream itself, and the fold
    it ran."""
    def value(key):
        line = next(ln for ln in stderr.splitlines() if ln.strip().startswith(key))
        return float(line.split(":", 1)[1].split()[0])
    return value("Start-up"), value("Duration"), int(value("Time Fold"))


def cs16_iq(wire: np.ndarray) -> np.ndarray:
    w = wire.astype(np.float64).reshape(-1, 2) / 32768.0
    return w[:, 0] + 1j * w[:, 1]


def iq_draws(dev, draws: int = IQ_DRAWS, channels: int = 128, seed: int = 20261017) -> dict:
    """The I/Q estimator's due step, kernel against twin, over ``draws``
    seeded draws of config #4's estimator input (its cs16 wire decoded and
    DC-blocked from a carried state; 2048 frames a channel, the estimator
    reads the first 1024): per channel a tone at +-0.03 to 0.45 of the rate
    (inside the estimator's band) of amplitude 0.1 to 0.6, an imbalance of
    up to +-2 % and +-0.02 rad, white noise at 1e-5 to 1e-3, start factors
    of 1e-3 and a DC state of 0.01.  Returns the largest distance in
    smoothed moves (0.05 x 1e-4 a move), the draws and channels that differ
    at all, the gate's largest difference and the draws whose counter
    differs."""
    import torch
    from iq_tool_tpu_torch.ops import kernels
    from iq_tool_tpu_torch.pipeline.chain import Chain
    from iq_tool_tpu_torch.profile_steps import BLOCK, config
    ch4 = Chain(config("4", channels, 16384), device=dev)
    worst, n_draws, n_ch, gate_err, bad_counter = 0.0, 0, 0, 0.0, 0
    n = 2048
    for d in range(draws):
        gen = torch.Generator(device=dev).manual_seed(seed + d)

        def u(lo, hi, shape=(channels, 1)):
            return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev,
                                               dtype=torch.float64)
        k = torch.arange(n, device=dev, dtype=torch.float64)
        sign = torch.where(u(0, 1) < 0.5, -1.0, 1.0)
        ph = 2 * np.pi * (sign * u(0.03, 0.45) * k[None, :] + u(0, 1))
        amp, eg, ep, noise = u(0.1, 0.6), u(-0.02, 0.02), u(-0.02, 0.02), 10 ** u(-5, -3)
        xr, xi = amp * torch.cos(ph), amp * torch.sin(ph)
        pairs = torch.stack([xr * (1 + eg), xi + ep * xr], dim=-1)
        pairs = pairs + noise[..., None] * torch.randn(pairs.shape, generator=gen, device=dev,
                                                        dtype=torch.float64)
        wire = torch.clamp(torch.round(pairs * 32767), -32768, 32767).to(torch.int16)
        wire = wire.reshape(channels, -1).view(torch.int32)
        f0 = (1e-3 * torch.randn((channels, 2), generator=gen, device=dev)).float()
        dc = (0.01 * torch.randn((channels, 4), generator=gen, device=dev)).float()
        cnt = torch.tensor(0xFFFFFFFF, dtype=torch.int64, device=dev)
        args = (None, None, f0, cnt, ch4.iq_interval, BLOCK)
        kw = dict(dc_state=dc, dc_alpha=ch4.dc_alpha, wire_i32=wire,
                  wire_norm=ch4.fmt_in.normalizer, wire_gain=1.0, wire_kind="cs16")
        got = kernels.iq_estimate(*args, **kw)
        want = kernels.iq_estimate_ref(*args, **kw)
        moves = (got[0] - want[0]).abs().amax(-1) / (1e-4 * 0.05)
        worst = max(worst, float(moves.max()))
        n_ch += int((moves > 0).sum())
        n_draws += bool((moves > 0).any())
        gate_err = max(gate_err, float((got[2] - want[2]).abs().max()))
        bad_counter += int(got[1]) != int(want[1])
    return dict(draws=draws, channels=channels, moves=worst, draws_differ=n_draws,
                channels_differ=n_ch, gate_err=gate_err, counter_differs=bad_counter)


def main() -> int:
    sys.meta_path.insert(0, _NoJax())
    import torch

    # ---------------------------------------------------------------- 1. card
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA card")
    sys.path.insert(0, HERE)
    try:
        import iq_tool_tpu_torch
    except ImportError as e:
        fail(f"the port is not importable next to this script: {e}")
    if not os.path.abspath(iq_tool_tpu_torch.__file__).startswith(HERE + os.sep):
        fail("iq_tool_tpu_torch was not imported from this checkout")
    from iq_tool_tpu_torch.ops import _build, convert, filters, kernels
    from iq_tool_tpu_torch.pipeline.chain import Chain, ChainConfig
    # the measured chains and their seeded tone, shared with the profiler
    from iq_tool_tpu_torch.profile_steps import (
        BLOCK, CHANNELS as CH, GATHER_RATE, GATHER_TONE_HZ, IN_RATE, OUT_RATE,
        POST_SHIFT_HZ, SEED, SHIFT_HZ, TONE_HZ, config, device_events, make_chain, to_cs8,
        to_cu8, tone_wire)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: not available"
    device_name = torch.cuda.get_device_name(0)
    say(f"[card] {smi_line}")
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {device_name} count {torch.cuda.device_count()}")
    # the twins are the float32 reference: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        fail("float32 matmuls are not in full precision")

    # --------------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    _build.library()
    say(f"[build] {time.perf_counter() - t0:.1f} s -> {_build.build_dir()}")
    for line in _build.build_log().splitlines():
        if ("registers" in line or "spill" in line or "Compiling entry" in line
                or "wgmma" in line):
            say(f"[build] {line.strip()}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def nrsc5(block):
        return ChainConfig(input_format="cu8", output_format="cu8",
                           input_rate=2_400_000.0, target_rate=OUT_RATE,
                           dc_block=True, target_block=block)

    def time_turns(fns, reps=5):
        """ms per call of each of ``fns``, timed in turns (in order, then
        in reverse, the two averaged) after one warm-up of each.  A spin
        kernel ahead of each run lets the host queue all its launches
        first, so the events time the card, not the wrappers' host code."""
        def timed(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(50_000_000)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / reps
        for fn in fns:
            fn()
        torch.cuda.synchronize()
        first = [timed(fn) for fn in fns]
        second = [timed(fn) for fn in reversed(fns)][::-1]
        return [(x + y) / 2 for x, y in zip(first, second)]

    def time_pair(run_kernel, run_twin, reps=5, run_library=None):
        """(kernel ms, twin ms) per call, interleaved twin, kernel,
        kernel, twin (time_turns); with ``run_library`` also its ms, timed
        in the same turns (twin, library, kernel, kernel, library, twin)."""
        fns = [run_twin] + ([run_library] if run_library else []) + [run_kernel]
        ms = time_turns(fns, reps)
        if run_library:
            return ms[2], ms[0], ms[1]
        return ms[1], ms[0]

    def max_abs(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    def launch_counts():
        return {"K1": kernels.banded_apply_dc.launches,
                "K2": kernels.banded_apply.launches,
                "K2mma": kernels.banded_apply_mma.launches,
                "K3": kernels.dc_block_apply.launches,
                "K3pre": kernels.pre_apply.launches,
                "K4": kernels.post_apply.launches,
                "K5": kernels.osfft_apply.launches,
                "AGC": kernels.rms_gains.launches,
                "IQest": kernels.iq_estimate.launches,
                "K1pro": kernels.dc_prologue.launches,
                "K1carry": kernels.dc_carry.launches,
                "OSfft": filters.overlap_save_fft.launches,
                "Gather": kernels.gather_apply.launches}

    def codes(packed):
        p = packed.to(torch.int64) & 0xFFFFFFFF
        lo, hi = p & 0xFFFF, p >> 16
        return lo - ((lo >> 15) << 16), hi - ((hi >> 15) << 16)

    # --------------------------------------------------- 3. kernels vs twins
    report = {}
    big = Chain(config("flagship"), device=dev)
    st0, st1 = big.resampler.stages
    norm = big.fmt_in.normalizer
    wire = tone_wire(CH, BLOCK, gen).view(torch.int32)
    phase0 = torch.randint(0, 2 ** 32, (CH,), generator=gen, device=dev,
                           dtype=torch.int64)
    dc_st = (0.01 * torch.randn((CH, 4), generator=gen, device=dev)).float()
    s0r, s0i = (0.1 * torch.randn((CH, st0.hist), generator=gen, device=dev)
                for _ in range(2))
    k1_args = (s0r, s0i, dc_st, big.dc_alpha, st0.band, None, st0.stride,
               st0.hist, wire, norm, 1.0, big.dtheta_pre, phase0)
    got = kernels.banded_apply_dc(*k1_args)
    want = kernels.banded_apply_dc_ref(*k1_args)
    again = kernels.banded_apply_dc(*k1_args)
    torch.cuda.synchronize()
    snrs = [snr_db(w.cpu().numpy(), g.cpu().numpy()) for w, g in
            zip((*want[0], want[1], want[2], want[3]), (*got[0], got[1], got[2], got[3]))]
    k1_err = max_abs((*want[0], *want[1:]), (*got[0], *got[1:]))
    same = all(torch.equal(x, y) for x, y in zip((*got[0], *got[1:]), (*again[0], *again[1:])))
    say(f"[k1] C={CH} n={BLOCK} s={st0.stride} hist={st0.hist} G={st0.band.g} "
        f"K={st0.band.k}: SNR planar {snrs[0]:.1f}/{snrs[1]:.1f} dB, tail "
        f"{snrs[2]:.1f}/{snrs[3]:.1f} dB, dc state {snrs[4]:.1f} dB, "
        f"max |err| {k1_err:.3e}; two launches {'bit-identical' if same else 'DIFFER'}")
    if min(snrs) < 100.0:
        fail(f"K1 disagrees with its twin: min SNR {min(snrs):.1f} dB < 100 dB")
    if not same:
        fail("two launches of K1 on the same input differ")
    del again
    # nrsc5's stage 0 (cu8, stride 400: window groups of 6400 samples cut
    # the DC kernel's 4096-sample tiles) on a block of 40 strides and a
    # ragged 77 samples, with the NCO
    ch_n = Chain(nrsc5(16384), device=dev)
    st_n = ch_n.resampler.stages[0]
    n_n = 40 * st_n.stride + 77
    wire_n, kind_n = convert.wire_pack(to_cu8(tone_wire(CH, n_n, gen)), "cu8")
    sn_r, sn_i = (0.1 * torch.randn((CH, st_n.hist), generator=gen, device=dev)
                  for _ in range(2))
    n_args = (sn_r, sn_i, dc_st, ch_n.dc_alpha, st_n.band, None, st_n.stride, st_n.hist,
              wire_n, ch_n.fmt_in.normalizer, 1.0, big.dtheta_pre, phase0)
    got_n = kernels.banded_apply_dc(*n_args, wire_kind=kind_n)
    want_n = kernels.banded_apply_dc_ref(*n_args, wire_kind=kind_n)
    torch.cuda.synchronize()
    snrs_n = [snr_db(w.cpu().numpy(), g.cpu().numpy()) for w, g in
              zip((*want_n[0], *want_n[1:]), (*got_n[0], *got_n[1:]))]
    say(f"[k1] nrsc5 stage 0 (cu8) n={n_n} s={st_n.stride} G={st_n.band.g}: SNR planar "
        f"{snrs_n[0]:.1f}/{snrs_n[1]:.1f} dB, tail {snrs_n[2]:.1f}/{snrs_n[3]:.1f} dB, "
        f"dc state {snrs_n[4]:.1f} dB")
    if min(snrs_n) < 100.0:
        fail(f"K1 disagrees with its twin at nrsc5's stage 0: {min(snrs_n):.1f} dB")
    del got_n, want_n, wire_n
    k1_ms, k1_plain = time_pair(lambda: kernels.banded_apply_dc(*k1_args),
                                lambda: kernels.banded_apply_dc_ref(*k1_args))
    pro_args = (wire, dc_st, big.dc_alpha, st0.hist, norm, 1.0, big.dtheta_pre, phase0)

    def old_route():
        """The two-launch route K1 replaced: the DC prologue writes the
        processed planes, K2 reads them back."""
        yr, yi, _, _, _ = kernels.dc_prologue(*pro_args)
        return kernels.banded_apply(s0r, s0i, yr, yi, st0.band, None, st0.stride,
                                    st0.hist)
    k1_again, old_ms = time_pair(lambda: kernels.banded_apply_dc(*k1_args), old_route)
    nb0 = BLOCK // st0.stride
    fl0 = 4 * CH * nb0 * st0.band.g * st0.band.k
    # wire, states and DC state in; planes, tails and DC state out
    k1_bytes = CH * (4 * BLOCK + 2 * (16 + 8 * st0.hist)) + CH * nb0 * st0.band.g * 8
    k1_bound = bound(k1_bytes, tf32x3_ops(st0.band, CH, nb0), PEAK_TF32_S)
    # the design's own floor: the carry pass reads the wire too
    k1_floor = (k1_bytes + CH * 4 * BLOCK) / PEAK_BYTES_S * 1e3
    say(f"[k1] kernel {k1_ms:.3f} ms ({k1_again:.3f} in turns with the two-launch "
        f"route's {old_ms:.3f}), twin {k1_plain:.3f} ms; band product "
        f"{fl0 / 1e9:.2f} GFLOP -> {fl0 / k1_ms / 1e9:.2f} TFLOP/s; bound "
        f"{k1_bound[0]:.4f} ms ({k1_bound[1]}: {k1_bytes / 1e6:.1f} MB, "
        f"{tf32x3_ops(st0.band, CH, nb0) / 1e9:.2f} GFLOP of 3xTF32; the kernel "
        f"issues {tf32x3_padded(st0.band, CH, nb0, 'wgmma') / 1e9:.2f} with its padding) -> "
        f"{100 * k1_bound[0] / k1_ms:.1f}% of bound; the design's floor (the wire "
        f"read twice) {k1_floor:.4f} ms")
    say(f"[k1] {plan_line(kernels, st0.band, st0.stride, st0.hist, BLOCK, CH, 'cs16')}")
    report["K1"] = dict(err=k1_err, ms=k1_ms, plain=k1_plain, lib=None, bound=k1_bound)

    # the carry pass alone (the DC kernel over the wire, no planes)
    carry_args = (wire, dc_st, big.dc_alpha, st0.stride, st0.hist, norm, 1.0,
                  big.dtheta_pre, phase0)
    got_c = kernels.dc_carry(*carry_args)
    want_c = kernels.dc_carry_ref(*carry_args)
    torch.cuda.synchronize()
    c_scale = float(want_c[0].abs().max())
    c_bound_err = float((got_c[0] - want_c[0]).abs().max())
    snrs = [snr_db(w.cpu().numpy(), g.cpu().numpy()) for w, g in zip(want_c[1:], got_c[1:])]
    carry_err = max(c_bound_err, max_abs(want_c[1:], got_c[1:]))
    say(f"[k1carry] {want_c[0].shape[1]} window groups a channel: group states max "
        f"|err| {c_bound_err:.3e} (of {c_scale:.3e}), SNR halo {snrs[0]:.1f}/{snrs[1]:.1f} "
        f"dB, tail {snrs[2]:.1f}/{snrs[3]:.1f} dB, dc state {snrs[4]:.1f} dB")
    if c_bound_err > 1e-9 * c_scale or min(snrs) < 100.0:
        fail("K1's carry pass disagrees with its twin")
    carry_ms, carry_plain = time_pair(lambda: kernels.dc_carry(*carry_args),
                                      lambda: kernels.dc_carry_ref(*carry_args))
    # wire, DC state and phases in; group states, halos, tails and DC state
    # out; ~20 float32 operations a sample (decode, the DC recurrence twice)
    carry_bytes = CH * (4 * BLOCK + 24 + want_c[0][0].numel() * 8
                        + want_c[1][0].numel() * 8 + 8 * st0.hist + 16)
    carry_bound = bound(carry_bytes, 20 * CH * BLOCK, PEAK_FP32_S)
    say(f"[k1carry] kernel {carry_ms:.3f} ms, twin {carry_plain:.3f} ms; bound "
        f"{carry_bound[0]:.4f} ms ({carry_bound[1]}: {carry_bytes / 1e6:.1f} MB) -> "
        f"{100 * carry_bound[0] / carry_ms:.1f}% of bound")
    report["K1carry"] = dict(err=carry_err, ms=carry_ms, plain=carry_plain, lib=None,
                             bound=carry_bound)
    del got_c, want_c

    # what decoding in the loader costs: K2 at stage 0 over the packed wire
    # with the NCO, against K2 over the prologue's planes, in turns
    yr0, yi0, _, _, _ = kernels.dc_prologue(*pro_args)
    wire_ms, planes_ms = time_pair(
        lambda: kernels.banded_apply(s0r, s0i, None, None, st0.band, None, st0.stride,
                                     st0.hist, wire_i32=wire, wire_norm=norm,
                                     nco_dtheta=big.dtheta_pre, nco_phase=phase0),
        lambda: kernels.banded_apply(s0r, s0i, yr0, yi0, st0.band, None, st0.stride,
                                     st0.hist))
    say(f"[k1] K2 at stage 0 decoding the wire and NCO in its staging {wire_ms:.3f} ms, "
        f"over the prologue's planes {planes_ms:.3f} ms; wire: "
        f"{plan_line(kernels, st0.band, st0.stride, st0.hist, BLOCK, CH, wire_kind='cs16')}; "
        f"planes: {plan_line(kernels, st0.band, st0.stride, st0.hist, BLOCK, CH)}")
    del yr0, yi0

    # the DC prologue alone (the DC kernel's grid of (tiles, C) CTAs; the
    # sharded chain's stage 0), and two launches on the same input compared
    # bit for bit
    got_p = kernels.dc_prologue(*pro_args)
    want_p = kernels.dc_prologue_ref(*pro_args)
    again = kernels.dc_prologue(*pro_args)
    torch.cuda.synchronize()
    snrs = [snr_db(w.cpu().numpy(), g.cpu().numpy()) for w, g in zip(want_p, got_p)]
    pro_err = max_abs(want_p, got_p)
    same = all(torch.equal(x, y) for x, y in zip(got_p, again))
    rep_db = min(snr_db(x.cpu().numpy(), y.cpu().numpy()) for x, y in zip(got_p, again))
    say(f"[k1pro] C={CH} n={BLOCK} tiles of {kernels.DC_TILE}: SNR planar "
        f"{snrs[0]:.1f}/{snrs[1]:.1f} dB, tail {snrs[2]:.1f}/{snrs[3]:.1f} dB, dc "
        f"state {snrs[4]:.1f} dB, max |err| {pro_err:.3e}")
    say(f"[k1pro] determinism: two launches on the same input "
        f"{'bit-identical' if same else f'differ, {rep_db:.1f} dB apart'}")
    if min(snrs) < 100.0:
        fail(f"K1's prologue disagrees with its twin: min SNR {min(snrs):.1f} dB < 100 dB")
    if not same and rep_db < 140.0:
        fail(f"two DC prologue launches differ at {rep_db:.1f} dB (< 140 dB)")
    pro_ms, pro_plain = time_pair(lambda: kernels.dc_prologue(*pro_args),
                                  lambda: kernels.dc_prologue_ref(*pro_args))
    # wire, DC state and phases in; planes, tails and DC state out; ~40
    # float32 operations a sample (decode, DC, sincos, rotate)
    pro_bytes = CH * (12 * BLOCK + 8 * st0.hist + 40)
    pro_bound = bound(pro_bytes, 40 * CH * BLOCK, PEAK_FP32_S)
    say(f"[k1pro] kernel {pro_ms:.3f} ms, twin {pro_plain:.3f} ms; bound "
        f"{pro_bound[0]:.4f} ms ({pro_bound[1]}: {pro_bytes / 1e6:.1f} MB) -> "
        f"{100 * pro_bound[0] / pro_ms:.1f}% of bound")
    report["K1pro"] = dict(err=pro_err, ms=pro_ms, plain=pro_plain, lib=None,
                           bound=pro_bound)
    del got_p, want_p, again

    # K2 at flagship stage 1, fed K1's output (the chain's own stage-1 input)
    x1r, x1i = got[0]
    s1r, s1i = (0.1 * torch.randn((CH, st1.hist), generator=gen, device=dev)
                for _ in range(2))
    k2_args = (s1r, s1i, x1r, x1i, st1.band, None, st1.stride, st1.hist)
    planar = kernels.banded_apply(*k2_args)
    planar_ref = kernels.banded_apply_ref(*k2_args)
    packed = kernels.banded_apply(*k2_args, pack_fmt="cs16")
    packed_ref = kernels.banded_apply_ref(*k2_args, pack_fmt="cs16")
    same_k2 = (all(torch.equal(x, y) for x, y in zip(planar, kernels.banded_apply(*k2_args)))
               and torch.equal(packed, kernels.banded_apply(*k2_args, pack_fmt="cs16")))
    torch.cuda.synchronize()
    s_k2 = min(snr_db(w.cpu().numpy(), g.cpu().numpy())
               for w, g in zip(planar_ref, planar))
    k2_err = max_abs(planar_ref, planar)
    (gi, gq), (wi, wq) = codes(packed), codes(packed_ref)
    dcode = torch.maximum((gi - wi).abs(), (gq - wq).abs())
    frac = float((dcode > 0).float().mean())
    say(f"[k2] C={CH} n={x1r.shape[1]} s={st1.stride} hist={st1.hist} "
        f"G={st1.band.g} K={st1.band.k}: SNR planar {s_k2:.1f} dB, max |err| "
        f"{k2_err:.3e}; packed cs16 max |dcode| {int(dcode.max())} on "
        f"{100 * frac:.4f}% of samples; two launches "
        f"{'bit-identical' if same_k2 else 'DIFFER'}")
    if s_k2 < 100.0 or int(dcode.max()) > 1 or frac > 0.01:
        fail("K2 disagrees with its twin at the flagship stage-1 shape")
    if not same_k2:
        fail("two launches of K2 on the same input differ")
    # the yardstick: one float32 matmul of the unfolded windows (both
    # planes) by the dense A, TF32 off
    ext1 = torch.cat([torch.cat([s1r, x1r], -1), torch.cat([s1i, x1i], -1)])
    a1 = st1.band.a_r
    k2_ms, k2_plain, k2_lib = time_pair(
        lambda: kernels.banded_apply(*k2_args, pack_fmt="cs16"),
        lambda: kernels.banded_apply_ref(*k2_args, pack_fmt="cs16"),
        run_library=lambda: torch.matmul(ext1.unfold(-1, st1.stride + st1.hist,
                                                     st1.stride), a1))
    nb1 = x1r.shape[1] // st1.stride
    fl1 = 4 * CH * nb1 * st1.band.g * st1.band.k
    # planes and states in, packed cs16 out
    k2_bytes = CH * (x1r.shape[1] + st1.hist) * 8 + CH * nb1 * st1.band.g * 4
    k2_ops = tf32x3_ops(st1.band, CH, nb1)
    k2_bound = bound(k2_bytes, k2_ops, PEAK_TF32_S)
    core1 = kernels.banded_core(st1.band)
    if core1 != "wgmma":
        fail(f"K2 at the flagship's stage 1 takes the {core1} core, not the wgmma core")
    say(f"[k2] packed kernel {k2_ms:.3f} ms, twin {k2_plain:.3f} ms, one matmul "
        f"{k2_lib:.3f} ms; band product {fl1 / 1e9:.2f} GFLOP -> "
        f"{fl1 / k2_ms / 1e9:.2f} TFLOP/s; bound {k2_bound[0]:.4f} ms "
        f"({k2_bound[1]}: {k2_bytes / 1e6:.1f} MB, {k2_ops / 1e9:.2f} GFLOP of "
        f"3xTF32; the kernel issues {tf32x3_padded(st1.band, CH, nb1, core1) / 1e9:.2f} "
        f"with its padding) -> {100 * k2_bound[0] / k2_ms:.1f}% of bound")
    say(f"[k2] {plan_line(kernels, st1.band, st1.stride, st1.hist, x1r.shape[1], CH)}")
    report["K2"] = dict(err=k2_err, ms=k2_ms, plain=k2_plain, lib=k2_lib, bound=k2_bound)
    # the other core at the same shape, against the twin and timed in turns
    mma_p = kernels.banded_apply(*k2_args, pack_fmt="cs16", core="mma")
    (gi, gq) = codes(mma_p)
    dcode_m = torch.maximum((gi - wi).abs(), (gq - wq).abs())
    s_m = min(snr_db(w.cpu().numpy(), g.cpu().numpy())
              for w, g in zip(planar_ref, kernels.banded_apply(*k2_args, core="mma")))
    wg_ms, mma_ms = time_turns(
        [lambda: kernels.banded_apply(*k2_args, pack_fmt="cs16"),
         lambda: kernels.banded_apply(*k2_args, pack_fmt="cs16", core="mma")])
    say(f"[k2] the mma.sync core at the same shape: SNR planar {s_m:.1f} dB, packed max "
        f"|dcode| {int(dcode_m.max())}; packed {mma_ms:.3f} ms against the wgmma core's "
        f"{wg_ms:.3f} in the same turns; "
        f"{plan_line(kernels, st1.band, st1.stride, st1.hist, x1r.shape[1], CH, core='mma')}")
    if s_m < 100.0 or int(dcode_m.max()) > 1 or float((dcode_m > 0).float().mean()) > 0.01:
        fail("K2's mma.sync core disagrees with its twin at the flagship stage-1 shape")
    del mma_p
    del ext1
    del got, want, planar, planar_ref, packed, packed_ref, wire

    # K2 at the strides the TPU sent to XLA and at config #4's stages
    # (narrow bands): both cores against the twin, timed in turns; the
    # rule's core first
    for label, cfg, idx in (("flagship@16384 stage 1", config("flagship", 1, 16384), 1),
                            ("nrsc5@16384 stage 0", nrsc5(16384), 0),
                            ("nrsc5@16384 stage 1", nrsc5(16384), 1),
                            ("#4 stage 0", config("4", 1), 0),
                            ("#4 stage 1", config("4", 1), 1)):
        st = Chain(cfg, device=dev).resampler.stages[idx]
        n = (BLOCK // st.stride) * st.stride
        xr, xi = (0.2 * torch.randn((CH, n), generator=gen, device=dev)
                  for _ in range(2))
        sr, si = (0.2 * torch.randn((CH, st.hist), generator=gen, device=dev)
                  for _ in range(2))
        args = (sr, si, xr, xi, st.band, None, st.stride, st.hist)
        w_ = kernels.banded_apply_ref(*args)
        wp = kernels.banded_apply_ref(*args, pack_fmt="cs16")
        rule = kernels.banded_core(st.band)
        cores = (rule, "mma" if rule == "wgmma" else "wgmma")
        res = {}
        for core in cores:
            before = (kernels.banded_apply.launches, kernels.banded_apply_mma.launches)
            g_ = kernels.banded_apply(*args, core=core)
            gp = kernels.banded_apply(*args, pack_fmt="cs16", core=core)
            same = (all(torch.equal(x, y) for x, y in
                        zip(g_, kernels.banded_apply(*args, core=core)))
                    and torch.equal(gp, kernels.banded_apply(*args, pack_fmt="cs16",
                                                             core=core)))
            torch.cuda.synchronize()
            mma_n = 4 if core == "mma" else 0
            if (kernels.banded_apply.launches, kernels.banded_apply_mma.launches) != (
                    before[0] + 4, before[1] + mma_n):
                fail(f"K2 on the {core} core did not launch as counted at stride {st.stride}")
            s_ = min(snr_db(w.cpu().numpy(), g.cpu().numpy()) for w, g in zip(w_, g_))
            (gi, gq), (wi, wq) = codes(gp), codes(wp)
            dcode = torch.maximum((gi - wi).abs(), (gq - wq).abs())
            frac = float((dcode > 0).float().mean())
            say(f"[k2] {label} on the {core} core{' (the rule)' if core == rule else ''}: "
                f"s={st.stride} hist={st.hist} G={st.band.g} K={st.band.k} n={n}: SNR "
                f"{s_:.1f} dB, max |err| {max_abs(w_, g_):.3e}, packed cs16 max |dcode| "
                f"{int(dcode.max())} on {100 * frac:.4f}% of samples; two launches "
                f"{'bit-identical' if same else 'DIFFER'}")
            say(f"[k2] {label}: {plan_line(kernels, st.band, st.stride, st.hist, n, CH, core=core)}")
            if s_ < 100.0 or int(dcode.max()) > 1 or frac > 0.01:
                fail(f"K2 on the {core} core disagrees with its twin at stride {st.stride}")
            if not same:
                fail(f"two launches of K2 on the {core} core differ at stride {st.stride}")
            res[core] = max_abs(w_, g_)
            del g_, gp
        ext = torch.cat([torch.cat([sr, xr], -1), torch.cat([si, xi], -1)])
        plain, lib, t_rule, t_other = time_turns(
            [lambda: kernels.banded_apply_ref(*args),
             lambda: torch.matmul(ext.unfold(-1, st.stride + st.hist, st.stride), st.band.a_r),
             lambda: kernels.banded_apply(*args, core=cores[0]),
             lambda: kernels.banded_apply(*args, core=cores[1])])
        nb_ = n // st.stride
        # planes and states in, planes out
        b_ = CH * (n + st.hist) * 8 + CH * nb_ * st.band.g * 8
        bnd = bound(b_, tf32x3_ops(st.band, CH, nb_), PEAK_TF32_S)
        say(f"[k2] {label}: planar {cores[0]} core {t_rule:.3f} ms (the rule), {cores[1]} "
            f"core {t_other:.3f} ms, in the same turns; twin {plain:.3f} ms, one matmul "
            f"{lib:.3f} ms; bound {bnd[0]:.4f} ms ({bnd[1]})")
        if label == "#4 stage 0":
            if rule != "mma":
                fail(f"K2 at config #4's stage 0 takes the {rule} core, not the mma.sync core")
            report["K2mma"] = dict(err=res["mma"], ms=t_rule, plain=plain, lib=lib, bound=bnd)
        del ext, w_, wp

    # K2 as the AM cell's 43:1 decimator (sdrplay2-am: 2 Msps -> 46,511.71875
    # Hz) at the cell's shape, 64 x 1,056,768 planes in and planes out as the
    # chain runs it before the digital AGC: the rule's core (wgmma: k 687,
    # span 816, one 32-column tile holding 4 columns) against the twin, two
    # launches bit for bit, timed beside the twin and one float32 matmul of
    # the unfolded windows.  Bound: the benchmark's (planes and history in,
    # planes out at 3.35 TB/s; the taps' 3xTF32 operations under it).
    am = Chain(config("sdrplay2-am", 64), device=dev)
    st_d = am.resampler.stages[0]
    n_d, c_d = am.n_in, 64
    xr_d, xi_d, sr_d, si_d = (0.2 * torch.randn((c_d, w), generator=gen, device=dev)
                              for w in (n_d, n_d, st_d.hist, st_d.hist))
    args_d = (sr_d, si_d, xr_d, xi_d, st_d.band, None, st_d.stride, st_d.hist)
    core_d = kernels.banded_core(st_d.band)
    got_d, again_d = kernels.banded_apply(*args_d), kernels.banded_apply(*args_d)
    want_d = kernels.banded_apply_ref(*args_d)
    torch.cuda.synchronize()
    same_d = all(torch.equal(x, y) for x, y in zip(got_d, again_d))
    s_d = min(snr_db(w.cpu().numpy(), g.cpu().numpy()) for w, g in zip(want_d, got_d))
    err_d = max_abs(want_d, got_d)
    del got_d, again_d, want_d
    ext_d = torch.cat([torch.cat([sr_d, xr_d], -1), torch.cat([si_d, xi_d], -1)])
    k2d_ms, k2d_plain, k2d_lib = time_pair(
        lambda: kernels.banded_apply(*args_d), lambda: kernels.banded_apply_ref(*args_d),
        run_library=lambda: torch.matmul(ext_d.unfold(-1, st_d.stride + st_d.hist,
                                                      st_d.stride), st_d.band.a_r))
    nb_d = n_d // st_d.stride
    k2d_bytes = c_d * (n_d + st_d.hist) * 8 + c_d * nb_d * st_d.band.g * 8
    k2d_bound = bound(k2d_bytes, tf32x3_ops(st_d.band, c_d, nb_d), PEAK_TF32_S)
    geo_d = kernels.band_geometry(st_d.band, st_d.stride, core_d)
    say(f"[k2dec] C={c_d} n={n_d} p/q {geo_d['p']}/{geo_d['q']} s={st_d.stride} "
        f"hist={st_d.hist} G={st_d.band.g} K={st_d.band.k} on the {core_d} core: SNR planar "
        f"{s_d:.1f} dB, max |err| {err_d:.3e}; two launches "
        f"{'bit-identical' if same_d else 'DIFFER'}; kernel {k2d_ms:.4f} ms, twin "
        f"{k2d_plain:.4f} ms, one matmul {k2d_lib:.4f} ms; bound {k2d_bound[0]:.4f} ms "
        f"({k2d_bound[1]}: {k2d_bytes / 1e6:.1f} MB; the kernel issues "
        f"{tf32x3_padded(st_d.band, c_d, nb_d, core_d) / 1e9:.2f} GFLOP of 3xTF32, "
        f"{100 * geo_d['useful']:.1f} % of them taps) -> "
        f"{100 * k2d_bound[0] / k2d_ms:.1f}% of bound")
    say(f"[k2dec] {plan_line(kernels, st_d.band, st_d.stride, st_d.hist, n_d, c_d)}")
    if core_d != "wgmma" or s_d < 100.0 or not same_d:
        fail(f"K2 as the AM decimator: core {core_d} (wgmma), {s_d:.1f} dB from its twin "
             f"(>= 100), two launches {'agree' if same_d else 'differ'}")
    report["K2dec"] = dict(err=err_d, ms=k2d_ms, plain=k2d_plain, lib=k2d_lib, bound=k2d_bound)
    del am, st_d, xr_d, xi_d, sr_d, si_d, ext_d, args_d

    # ------------------------------------------------------------ 4. slice
    stream = tone_wire(CH, STEPS * BLOCK, gen)
    carry = big.init_carry()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    outs = []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for k in range(STEPS):
        if k == 2:
            ev[0].record()
        raw = stream[:, k * 2 * BLOCK:(k + 1) * 2 * BLOCK]
        carry, out = big.step(carry, raw)
        outs.append(out[:2].clone())
    ev[1].record()
    torch.cuda.synchronize()
    launches = {"K1": kernels.banded_apply_dc.launches,
                "K2": kernels.banded_apply.launches,
                "K2mma": kernels.banded_apply_mma.launches,
                "K1pro": kernels.dc_prologue.launches,
                "K1carry": kernels.dc_carry.launches}
    step_ms = ev[0].elapsed_time(ev[1]) / (STEPS - 2)
    peak = torch.cuda.max_memory_allocated()
    msps = CH * BLOCK / (step_ms / 1e3) / 1e6
    say(f"[slice] {STEPS} eager steps of {CH} x {BLOCK}: launches {launches}, "
        f"{step_ms:.3f} ms/step over steps 3-{STEPS} -> {msps:.1f} Msps in, "
        f"peak device memory {peak / 2 ** 20:.1f} MiB")
    if launches != {"K1": STEPS, "K2": STEPS, "K2mma": 0, "K1pro": 0, "K1carry": STEPS}:
        fail(f"launch counters {launches}, expected {STEPS} each of K1, its carry "
             f"pass and K2 (on the wgmma core), the DC prologue none")
    got_wire = torch.cat(outs, dim=-1).cpu().numpy()
    if got_wire.shape != (2, STEPS * 2 * big.n_out) or got_wire.dtype != np.int16:
        fail(f"chain output {got_wire.shape} {got_wire.dtype}")
    twin = Chain(config("flagship", 2), device="cpu")
    tc = twin.init_carry()
    twin_outs = []
    host_stream = stream[:2].cpu()
    for k in range(STEPS):
        tc, o = twin.step(tc, host_stream[:, k * 2 * BLOCK:(k + 1) * 2 * BLOCK])
        twin_outs.append(o)
    want_wire = torch.cat(twin_outs, dim=-1).numpy()
    dmax = int(np.abs(got_wire.astype(np.int64) - want_wire).max())
    snr_t = tone_snr_db(cs16_iq(got_wire[0]), TONE_HZ + SHIFT_HZ, OUT_RATE,
                        3 * big.n_out)
    say(f"[slice] vs CPU twin chain (2 channels): max |dcode| {dmax}; tone "
        f"SNR {snr_t:.1f} dB over steps 4-{STEPS}")
    if dmax > 4:
        fail(f"chain differs from its CPU twin by {dmax} codes (> 4)")
    if snr_t < 60.0:
        fail(f"tone SNR {snr_t:.1f} dB < 60 dB")
    del stream, outs, carry, big

    # ------------------------------------ 5. the general step's kernels
    from iq_tool_tpu_torch.formats import get_format
    from iq_tool_tpu_torch.ops import agc, convert, iq_balance, nco

    g4 = Chain(config("4"), device=dev)
    n_out = g4.n_out
    wire = tone_wire(CH, BLOCK, gen).view(torch.int32)
    fac = (0.02 * torch.randn((CH, 2), generator=gen, device=dev)).float()
    k3_args = (None, None, dc_st, g4.dc_alpha, fac, phase0, g4.dtheta_pre)
    k3_kw = dict(wire_i32=wire, wire_norm=norm)
    got = kernels.dc_block_apply(*k3_args, **k3_kw)
    want = kernels.dc_block_apply_ref(*k3_args, **k3_kw)
    torch.cuda.synchronize()
    snrs = [snr_db(w.cpu().numpy(), g.cpu().numpy()) for w, g in zip(want, got)]
    k3_err = max_abs(want, got)
    say(f"[k3] C={CH} n={BLOCK} cs16 wire + DC + I/Q + NCO: SNR planar "
        f"{snrs[0]:.1f}/{snrs[1]:.1f} dB, dc state {snrs[2]:.1f} dB, max |err| "
        f"{k3_err:.3e}")
    if min(snrs) < 100.0:
        fail(f"K3 disagrees with its twin: min SNR {min(snrs):.1f} dB < 100 dB")
    k3_ms, k3_plain = time_pair(lambda: kernels.dc_block_apply(*k3_args, **k3_kw),
                                lambda: kernels.dc_block_apply_ref(*k3_args, **k3_kw))
    # wire in, planes out (+ the (C, 4) DC states, I/Q factors, phases);
    # ~40 float32 operations a sample (decode, DC, I/Q, sincos, rotate)
    k3_bound = bound(CH * (12 * BLOCK + 48), 40 * CH * BLOCK, PEAK_FP32_S)
    say(f"[k3] kernel {k3_ms:.3f} ms, twin {k3_plain:.3f} ms; "
        f"{CH * BLOCK * 12 / k3_ms / 1e6:.1f} GB/s of wire in + planes out; bound "
        f"{k3_bound[0]:.4f} ms ({k3_bound[1]}) -> {100 * k3_bound[0] / k3_ms:.1f}%")
    report["K3"] = dict(err=k3_err, ms=k3_ms, plain=k3_plain, lib=None, bound=k3_bound)

    # K3 on the cu8 wire (config #3's input): DC only
    w8, kind8 = convert.wire_pack(to_cu8(tone_wire(CH, BLOCK, gen)), "cu8")
    k3c_args = (None, None, dc_st, g4.dc_alpha)
    k3c_kw = dict(wire_i32=w8, wire_norm=get_format("cu8").normalizer, wire_kind=kind8)
    got = kernels.dc_block_apply(*k3c_args, **k3c_kw)
    want = kernels.dc_block_apply_ref(*k3c_args, **k3c_kw)
    torch.cuda.synchronize()
    snrs = [snr_db(w.cpu().numpy(), g.cpu().numpy()) for w, g in zip(want, got)]
    k3c_err = max_abs(want, got)
    say(f"[k3] C={CH} n={BLOCK} cu8 wire + DC: SNR planar {snrs[0]:.1f}/{snrs[1]:.1f} "
        f"dB, dc state {snrs[2]:.1f} dB, max |err| {k3c_err:.3e}")
    if min(snrs) < 100.0:
        fail(f"K3 (cu8) disagrees with its twin: min SNR {min(snrs):.1f} dB < 100 dB")
    k3c_ms, k3c_plain = time_pair(lambda: kernels.dc_block_apply(*k3c_args, **k3c_kw),
                                  lambda: kernels.dc_block_apply_ref(*k3c_args, **k3c_kw))
    k3c_bound = bound(CH * (10 * BLOCK + 32), 30 * CH * BLOCK, PEAK_FP32_S)
    say(f"[k3] cu8 kernel {k3c_ms:.3f} ms, twin {k3c_plain:.3f} ms; bound "
        f"{k3c_bound[0]:.4f} ms ({k3c_bound[1]}: {CH * (10 * BLOCK + 32) / 1e6:.1f} MB) "
        f"-> {100 * k3c_bound[0] / k3c_ms:.1f}%")
    report["K3@cu8"] = dict(err=k3c_err, ms=k3c_ms, plain=k3c_plain, lib=None,
                            bound=k3c_bound)
    del w8

    # K3pre: the same pre-stage without the DC block (the benchmark's full4
    # chain): cs16 wire + I/Q + NCO, then cu8 wire alone, bit for bit
    # against the twin without the NCO's sin and cos
    kp_args = (None, None, fac, phase0, g4.dtheta_pre)
    got = kernels.pre_apply(*kp_args, **k3_kw)
    want = kernels.pre_apply_ref(*kp_args, **k3_kw)
    w8, kind8 = convert.wire_pack(to_cu8(tone_wire(CH, BLOCK, gen)), "cu8")
    k8_kw = dict(wire_i32=w8, wire_norm=get_format("cu8").normalizer, wire_kind=kind8)
    got8 = kernels.pre_apply(None, None, **k8_kw)
    want8 = kernels.pre_apply_ref(None, None, **k8_kw)
    torch.cuda.synchronize()
    snrs = [snr_db(w.cpu().numpy(), g.cpu().numpy()) for w, g in zip(want, got)]
    kp_err = max_abs(want, got)
    same8 = all(torch.equal(w, g) for w, g in zip(want8, got8))
    say(f"[k3pre] C={CH} n={BLOCK} cs16 wire + I/Q + NCO: SNR planar "
        f"{snrs[0]:.1f}/{snrs[1]:.1f} dB, max |err| {kp_err:.3e}; cu8 wire alone "
        f"{'bit-identical to' if same8 else 'DIFFERS from'} the twin")
    if min(snrs) < 100.0 or not same8:
        fail(f"K3pre disagrees with its twin: min SNR {min(snrs):.1f} dB, cu8 "
             f"bit-identical {same8}")
    kp_ms, kp_plain = time_pair(lambda: kernels.pre_apply(*kp_args, **k3_kw),
                                lambda: kernels.pre_apply_ref(*kp_args, **k3_kw))
    # wire in once, planes out once (+ the I/Q factors and phases); ~40
    # float32 operations a sample (decode, I/Q, sincos, rotate)
    kp_bound = bound(CH * (12 * BLOCK + 16), 40 * CH * BLOCK, PEAK_FP32_S)
    say(f"[k3pre] kernel {kp_ms:.4f} ms, twin {kp_plain:.3f} ms; "
        f"{CH * BLOCK * 12 / kp_ms / 1e6:.1f} GB/s of wire in + planes out; bound "
        f"{kp_bound[0]:.4f} ms ({kp_bound[1]}) -> {100 * kp_bound[0] / kp_ms:.1f}%")
    report["K3pre"] = dict(err=kp_err, ms=kp_ms, plain=kp_plain, lib=None, bound=kp_bound)
    del w8, got8, want8

    # K4 and the AGC gains on config #4's output-rate planes (C, 190512):
    # 1488 segments of 128 and a ragged 48
    pr, pi = (0.3 * torch.randn((CH, n_out), generator=gen, device=dev)
              for _ in range(2))
    n_seg, seg, beta = agc.rms_params(g4.agc_cfg, n_out)
    g0 = torch.ones(CH, device=dev)
    e20 = torch.zeros(CH, device=dev)
    agc_args = (pr, pi, g0, e20, beta, g4.agc_cfg.target)
    got = kernels.rms_gains(*agc_args)
    want = kernels.rms_gains_ref(*agc_args)
    torch.cuda.synchronize()
    agc_rel = max(float(((g - w).abs() / w.abs()).max()) for w, g in zip(want, got))
    agc_err = max_abs(want, got)
    say(f"[agc] {n_seg} segments x {CH} channels: max relative error "
        f"{agc_rel:.3e}, max |err| {agc_err:.3e}")
    if agc_rel > 1e-4:
        fail(f"AGC gains disagree with their twin: relative error {agc_rel:.3e} > 1e-4")
    agc_ms, agc_plain = time_pair(lambda: kernels.rms_gains(*agc_args),
                                  lambda: kernels.rms_gains_ref(*agc_args), reps=2)
    # the chain alone: one thread a channel over the same energies (the
    # twin's), from shared memory; the fused kernel cannot beat it
    e_seg = torch.mean((pr[:, :n_seg * seg] ** 2 + pi[:, :n_seg * seg] ** 2)
                       .reshape(CH, n_seg, seg), dim=-1)
    chain_args = (e_seg, g0, e20, beta, g4.agc_cfg.target)
    got_c = kernels.agc_chain(*chain_args)
    want_c = kernels.rms_scan_ref(e_seg.T, g0, e20, beta, g4.agc_cfg.target)
    want_c = (want_c[0].T, *want_c[1:])
    torch.cuda.synchronize()
    chain_rel = max(float(((g - w).abs() / w.abs()).max()) for w, g in zip(want_c, got_c))
    if chain_rel > 1e-4:
        fail(f"the AGC chain kernel disagrees with rms_scan_ref: {chain_rel:.3e} > 1e-4")
    chain_err = max_abs(want_c, got_c)
    chain_ms, chain_plain = time_pair(lambda: kernels.agc_chain(*chain_args),
                                      lambda: kernels.rms_scan_ref(e_seg.T, *chain_args[1:]),
                                      reps=2)
    # planes in, gains and the (C,) states out
    agc_bytes = CH * (8 * n_out + 4 * n_seg + 16)
    agc_b_ms = agc_bytes / PEAK_BYTES_S * 1e3
    agc_bound = (chain_ms, "operations") if chain_ms > agc_b_ms else (agc_b_ms, "bytes")
    say(f"[agc] kernel {agc_ms:.3f} ms, twin (a mean and a loop of tensor ops) "
        f"{agc_plain:.3f} ms; bound {agc_bound[0]:.4f} ms ({agc_bound[1]}): bytes "
        f"{agc_bytes / 1e6:.1f} MB -> {agc_b_ms:.4f} ms; the chain alone (one thread "
        f"a channel over {n_seg} given energies, {chain_rel:.1e} from rms_scan_ref, "
        f"timed) {chain_ms:.4f} ms; {100 * agc_bound[0] / agc_ms:.1f}% of bound")
    del e_seg, got_c, want_c
    # the power-of-two path (the default target's t2 = 0.25, the division
    # as a multiplication) against the IEEE division (a target 2^-11 off),
    # interleaved
    if kernels._chain_consts(beta, g4.agc_cfg.target)[4] == 0:
        fail(f"the default AGC target {g4.agc_cfg.target} takes the division path")
    div_args = (pr, pi, g0, e20, beta, g4.agc_cfg.target * (1 + 2 ** -11))
    div_ms, mul_ms = time_pair(lambda: kernels.rms_gains(*div_args),
                               lambda: kernels.rms_gains(*agc_args))
    say(f"[agc] the chain's division: {mul_ms:.4f} ms as a multiplication (t2 a "
        f"power of two), {div_ms:.4f} ms divided (a target 2^-11 off)")
    report["AGC"] = dict(err=agc_err, ms=agc_ms, plain=agc_plain, lib=None, bound=agc_bound)
    gains = got[0]                                       # (C, 1488)

    k4_args = (pr, pi, gains, seg, phase0, g4.dtheta_post)
    got = kernels.post_apply(*k4_args, out_fmt="cs16")
    want = kernels.post_apply_ref(*k4_args, out_fmt="cs16")
    torch.cuda.synchronize()
    (gi, gq), (wi, wq) = codes(got), codes(want)
    dcode = torch.maximum((gi - wi).abs(), (gq - wq).abs())
    frac = float((dcode > 0).float().mean())
    say(f"[k4] C={CH} n={n_out} seg {seg} (ragged {n_out - n_seg * seg}) + NCO -> "
        f"cs16: max |dcode| {int(dcode.max())} on {100 * frac:.4f}% of samples")
    if int(dcode.max()) > 1 or frac > 0.01:
        fail("K4 disagrees with its twin by more than 1 code on 1% of samples")
    k4_ms, k4_plain = time_pair(lambda: kernels.post_apply(*k4_args, out_fmt="cs16"),
                                lambda: kernels.post_apply_ref(*k4_args, out_fmt="cs16"))
    # planes and gains in, wire out; ~30 operations a sample (sincos,
    # rotate, gain, quantize)
    k4_bound = bound(CH * (12 * n_out + 4 * gains.shape[1] + 8), 30 * CH * n_out,
                     PEAK_FP32_S)
    say(f"[k4] kernel {k4_ms:.3f} ms, twin {k4_plain:.3f} ms; "
        f"{CH * n_out * 12 / k4_ms / 1e6:.1f} GB/s of planes in + wire out; bound "
        f"{k4_bound[0]:.4f} ms ({k4_bound[1]}) -> {100 * k4_bound[0] / k4_ms:.1f}%")
    report["K4"] = dict(err=int(dcode.max()), ms=k4_ms, plain=k4_plain, lib=None,
                        bound=k4_bound)

    def k5_check(label, filt, key):
        """K5 against its twin on the schedule the chain makes for
        `filt` over n_out outputs, the carried tail and the block through
        two pointers; timed beside the twin and its torch.fft core."""
        b = filt.block
        spec, windows = filt._spectrum(dev), filt._schedule(n_out, dev)
        xr, xi = (0.3 * torch.randn((CH, n_out), generator=gen, device=dev)
                  for _ in range(2))
        tr, ti = (0.3 * torch.randn((CH, b), generator=gen, device=dev)
                  for _ in range(2))
        args = (xr, xi, spec, b)
        kw = dict(windows=windows, tail=(tr, ti))
        got = kernels.osfft_apply(*args, **kw)
        want = kernels.osfft_apply_ref(*args, **kw)
        torch.cuda.synchronize()
        snrs = [snr_db(w.cpu().numpy(), g.cpu().numpy()) for w, g in zip(want, got)]
        err = max_abs(want, got)
        adv = {2 * b - h for h in windows.heads[:-1]}
        say(f"[k5] {label}: C={CH} n={n_out} taps {filt.num_taps} nfft {2 * b}: "
            f"{len(windows.starts)} windows (advances {sorted(adv)}, then the "
            f"re-anchored tail): SNR {snrs[0]:.1f}/{snrs[1]:.1f} dB vs torch.fft, "
            f"max |err| {err:.3e}")
        if min(snrs) < 100.0:
            fail(f"K5 disagrees with its twin at nfft {2 * b}: min SNR "
                 f"{min(snrs):.1f} dB < 100 dB")
        # the yardstick: the twin's torch.fft core on the gathered windows
        ext = torch.complex(torch.cat([tr, xr], -1), torch.cat([ti, xi], -1))
        idx = (windows.starts_t.long()[:, None]
               + torch.arange(2 * b, device=dev)[None, :])
        win = ext[:, idx]
        ms, plain, lib = time_pair(
            lambda: kernels.osfft_apply(*args, **kw),
            lambda: kernels.osfft_apply_ref(*args, **kw),
            run_library=lambda: torch.fft.ifft(torch.fft.fft(win) * spec.h))
        nfft, nw = 2 * b, len(windows.starts)
        nbytes = CH * (n_out + b) * 8 + CH * n_out * 8 + nfft * 8
        ops = CH * nw * (2 * 5 * nfft * (nfft.bit_length() - 1) + 6 * nfft)
        bd = bound(nbytes, ops, PEAK_FP32_S)
        say(f"[k5] {label}: kernel {ms:.3f} ms, twin {plain:.3f} ms, torch.fft "
            f"core {lib:.3f} ms; bound {bd[0]:.4f} ms ({bd[1]}: {nbytes / 1e6:.1f} "
            f"MB, {ops / 1e9:.2f} GFLOP) -> {100 * bd[0] / ms:.1f}% of bound")
        report[key] = dict(err=err, ms=ms, plain=plain, lib=lib, bound=bd)

    k5_check("config #4's notch", g4.post_filter, "K5")
    # the schedule the chain makes for --filter-fft-size 32768: b 16384, a
    # 2-CTA cluster per window
    g4k = Chain(config("4k32"), device=dev)
    k5_check("config #4's notch at --filter-fft-size 32768", g4k.post_filter,
             "K5@32768")
    del got, want, wire, pr, pi, g4k

    # above K5's largest window, the torch.fft route (ops/filters.py
    # overlap_save_fft; no TPU kernel: the reference's XLA overlap-save) on
    # config #4's notch at --filter-fft-size 131072 (b 65536), against K5's
    # twin over the same half-advance windows and re-anchored tail; timed
    # beside the twin and the transforms alone; its peak device memory
    filt = Chain(config("4k128"), device=dev).post_filter
    b = filt.block
    xr, xi = (0.3 * torch.randn((CH, n_out), generator=gen, device=dev) for _ in range(2))
    tr, ti = (0.3 * torch.randn((CH, b), generator=gen, device=dev) for _ in range(2))
    h_t = filt._spectrum(dev).h
    windows = kernels.Windows.build(*filters.osfft_windows(n_out, b, (b,)), dev)
    torch.cuda.synchronize()
    mem_held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = filters.overlap_save_fft(xr, xi, tr, ti, h_t, b)
    torch.cuda.synchronize()
    os_peak = torch.cuda.max_memory_allocated() - mem_held
    want = kernels.osfft_apply_ref(xr, xi, filt._h, b, windows=windows, tail=(tr, ti))
    torch.cuda.synchronize()
    snrs = [snr_db(w.cpu().numpy(), g.cpu().numpy()) for w, g in zip(want, got[:2])]
    os_err = max_abs(want, got[:2])
    nfft, nw = 2 * b, len(windows.starts)
    say(f"[osfft] config #4's notch at --filter-fft-size 131072: C={CH} n={n_out} taps "
        f"{filt.num_taps} nfft {nfft}, {nw} windows (half advance, the last re-anchored): "
        f"the torch.fft route vs K5's twin SNR {snrs[0]:.1f}/{snrs[1]:.1f} dB, max |err| "
        f"{os_err:.3e}; peak device memory {os_peak / 2 ** 20:.1f} MiB above the "
        f"{mem_held / 2 ** 20:.1f} MiB held (inputs included)")
    if min(snrs) < 100.0:
        fail(f"the torch.fft overlap-save route disagrees with K5's twin at nfft {nfft}: "
             f"min SNR {min(snrs):.1f} dB < 100 dB")
    ext = torch.complex(torch.cat([tr, xr], -1), torch.cat([ti, xi], -1))
    win = ext[:, windows.starts_t.long()[:, None] + torch.arange(nfft, device=dev)[None, :]]
    ms, plain, lib = time_pair(
        lambda: filters.overlap_save_fft(xr, xi, tr, ti, h_t, b),
        lambda: kernels.osfft_apply_ref(xr, xi, filt._h, b, windows=windows, tail=(tr, ti)),
        run_library=lambda: torch.fft.ifft(torch.fft.fft(win) * h_t))
    nbytes = CH * (n_out + b) * 8 + CH * n_out * 8 + nfft * 8
    ops = CH * nw * (2 * 5 * nfft * (nfft.bit_length() - 1) + 6 * nfft)
    bd = bound(nbytes, ops, PEAK_FP32_S)
    say(f"[osfft] route {ms:.3f} ms, twin {plain:.3f} ms, the transforms alone {lib:.3f} "
        f"ms; bound {bd[0]:.4f} ms ({bd[1]}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP) "
        f"-> {100 * bd[0] / ms:.1f}% of bound")
    report["OSfft"] = dict(err=os_err, ms=ms, plain=plain, lib=lib, bound=bd)
    del got, want, xr, xi, tr, ti, ext, win, filt

    # the I/Q estimator, whole, at config #4's step: the cs16 wire (C,
    # 262144) of an in-band tone behind a 1 % / 0.01 rad imbalance, its
    # first 1024 frames decoded and DC-blocked from a carried state; a due
    # step (the fire-at-once counter) and one that is not
    kk = torch.arange(BLOCK, device=dev, dtype=torch.float64)
    ph = 2 * np.pi * 0.07 * kk[None, :] + torch.arange(CH, device=dev)[:, None]
    xr_, xi_ = 0.4 * torch.cos(ph), 0.4 * torch.sin(ph)
    pairs = torch.stack([xr_ * 1.01, xi_ + 0.01 * xr_], dim=-1)
    pairs = pairs + 1e-4 * torch.randn(pairs.shape, generator=gen, device=dev,
                                       dtype=torch.float64)
    iq_wire = torch.round(pairs * 32767).to(torch.int16).reshape(CH, -1).view(torch.int32)
    del kk, ph, xr_, xi_, pairs
    f0 = (1e-3 * torch.randn((CH, 2), generator=gen, device=dev)).float()
    iq_kw = dict(dc_state=dc_st, dc_alpha=g4.dc_alpha, wire_i32=iq_wire,
                 wire_norm=g4.fmt_in.normalizer, wire_gain=1.0, wire_kind="cs16")
    iq_results = {}
    for label, c0 in (("due", 0xFFFFFFFF), ("not due", 0)):
        cnt = torch.tensor(c0, dtype=torch.int64, device=dev)
        args = (None, None, f0, cnt, g4.iq_interval, BLOCK)
        got = kernels.iq_estimate(*args, **iq_kw)
        want = kernels.iq_estimate_ref(*args, **iq_kw)
        torch.cuda.synchronize()
        # factors in the smoothed update's moves (0.05 x 1e-4 a move)
        moves = float((got[0] - want[0]).abs().max()) / (1e-4 * 0.05)
        ms, plain = time_pair(lambda: kernels.iq_estimate(*args, **iq_kw),
                              lambda: kernels.iq_estimate_ref(*args, **iq_kw), reps=3)
        iq_results[label] = (got, want, moves, ms, plain, args)
    got, want, moves, iq_ms, iq_plain, due_args = iq_results["due"]
    # where a due step's time goes: the same launch without the descent
    # (the prefix, both spectra and the gate)
    pre_ms, _ = time_pair(lambda: kernels.iq_estimate(*due_args, passes=0, **iq_kw),
                          lambda: None, reps=3)
    gate_err = float((got[2] - want[2]).abs().max())
    n_gated = int((got[2] >= 20.0).sum())
    say(f"[iq] C={CH}, a due step: factors within {moves:.2f} moves of the twin, gate "
        f"within {gate_err:.2e} dB ({n_gated} of {CH} channels gated), counter "
        f"{int(got[1])} (twin {int(want[1])})")
    if moves > 2.001 or gate_err > 1e-3 or int(got[1]) != int(want[1]):
        fail(f"the I/Q estimator parts from its twin on a due step: {moves:.2f} moves "
             f"(> 2), gate {gate_err:.2e} dB (> 1e-3) or counter {int(got[1])} != "
             f"{int(want[1])}")
    got_s, want_s, _, skip_ms, skip_plain, _ = iq_results["not due"]
    same = torch.equal(got_s[0], f0) and torch.equal(got_s[0], want_s[0])
    t0 = time.perf_counter()
    dr = iq_draws(dev)
    say(f"[iq] {dr['draws']} seeded draws x {dr['channels']} channels of a due step (tone, "
        f"imbalance, noise, start factors, DC state): largest distance {dr['moves']:.2f} "
        f"moves, {dr['draws_differ']} draws ({dr['channels_differ']} channels) differ at "
        f"all, gate within {dr['gate_err']:.2e} dB, counters differ in "
        f"{dr['counter_differs']} draws ({time.perf_counter() - t0:.1f} s)")
    if dr["moves"] > 2.001 or dr["gate_err"] > 1e-3 or dr["counter_differs"]:
        fail(f"the I/Q estimator parts from its twin over {dr['draws']} draws: "
             f"{dr['moves']:.2f} moves (> 2), gate {dr['gate_err']:.2e} dB (> 1e-3) or "
             f"{dr['counter_differs']} counters differ")
    say(f"[iq] a step that is not due: factors {'bit-identical' if same else 'DIFFER'}, "
        f"counter {int(got_s[1])} (twin {int(want_s[1])})")
    if not same or int(got_s[1]) != int(want_s[1]) or int(want_s[1]) != BLOCK:
        fail("the I/Q estimator changed its factors or miscounted on a step that is "
             "not due")
    # a due step: the prefix read once (4 B a frame), the states and
    # factors in and out; operations: the DC scan (float64, ~8 a sample
    # and plane), two 1024-point FFTs (5 N log2 N), the gate and 25 passes
    # x 4 moves x both sides of the band at ~24 operations a bin (complex
    # product, hypot, log10); a step that is not due: the factors in and
    # out, the gate (NaN) and the counter
    lo, hi = iq_balance.band_edges(1024)
    nb = hi - lo
    iq_bound = bound(CH * (1024 * 4 + 16 + 8 + 8 + 4) + 16,
                     CH * (2 * 1024 * 8 + 2 * 5 * 1024 * 10 + (1 + 25 * 4) * 2 * nb * 24),
                     PEAK_FP32_S)
    skip_bound = bound(CH * (16 + 4) + 16, 0, PEAK_FP32_S)
    say(f"[iq] kernel {iq_ms:.4f} ms on a due step, {skip_ms:.4f} ms on one that is "
        f"not; twin (decode, DC prefix, FFTs, 25 passes of tensor ops, masked) "
        f"{iq_plain:.3f} / {skip_plain:.3f} ms; bound {iq_bound[0]:.5f} ms "
        f"({iq_bound[1]}) -> {100 * iq_bound[0] / iq_ms:.1f}%, not due "
        f"{skip_bound[0]:.6f} ms; a due step without the descent (prefix, "
        f"spectra, gate) {pre_ms:.4f} ms ({smi_line})")
    report["IQest"] = dict(err=max(float((got[0] - want[0]).abs().max()), gate_err),
                           ms=iq_ms, plain=iq_plain, lib=None, bound=iq_bound)
    report["IQest@skip"] = dict(err=float((got_s[0] - want_s[0]).abs().max()),
                                ms=skip_ms, plain=skip_plain, lib=None, bound=skip_bound)
    del iq_wire, iq_results, got, want, got_s, want_s

    # ------------------------------------------------- 6. the general step
    def run_general(name, steps):
        """Config `name` at CH x BLOCK for `steps` steps; returns the
        launch counts, and checks output against the CPU twin chain."""
        cfg = config(name)
        label = {"4": "[full]", "4k32": "[full32k]", "4k128": "[full128k]",
                 "full4": "[full4]"}.get(name, f"[config{name}]")
        ch_ = Chain(cfg, device=dev)
        stream = tone_wire(CH, steps * BLOCK, gen)
        if cfg.input_format == "cu8":
            stream = to_cu8(stream)
        carry = ch_.init_carry()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        outs = []
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        for k in range(steps):
            if k == 2:
                ev[0].record()
            carry, out = ch_.step(carry, stream[:, k * 2 * BLOCK:(k + 1) * 2 * BLOCK])
            outs.append(out[:2].clone())
        ev[1].record()
        torch.cuda.synchronize()
        counts = launch_counts()
        step_ms = ev[0].elapsed_time(ev[1]) / (steps - 2)
        peak = torch.cuda.max_memory_allocated()
        say(f"{label} {steps} eager steps of {CH} x {BLOCK}: launches {counts}, "
            f"{step_ms:.3f} ms/step over steps 3-{steps} -> "
            f"{CH * BLOCK / (step_ms / 1e3) / 1e6:.1f} Msps in, peak device "
            f"memory {peak / 2 ** 20:.1f} MiB")
        # all the step's device launches, kernels and copies: 2 more steps
        # (the last block again) under torch.profiler
        held = {"carry": carry}

        def one_step():
            held["carry"], _ = ch_.step(held["carry"],
                                        stream[:, (steps - 1) * 2 * BLOCK:steps * 2 * BLOCK])
        per_step = sum(v[1] for v in device_events(one_step, 2).values()) / 2
        say(f"{label} device launches a step (torch.profiler, 2 steps): {per_step:.1f}")
        if "iq" in carry:
            # the I/Q estimator's call as the step makes it (the chain's
            # wire, DC state and counter), 3 calls between events with no
            # spin in front: host and card together, on a step that is due
            # and on one that is not
            last = stream[:, (steps - 1) * 2 * BLOCK:steps * 2 * BLOCK]
            wire_l, kind_l = convert.wire_pack(last, ch_.fmt_in)
            est_ms = {}
            for label_d, c0 in (("due", 0xFFFFFFFF), ("not due", 0)):
                st_d = iq_balance.IqState(carry["iq"].factors,
                                          torch.tensor(c0, dtype=torch.int64, device=dev))
                call = lambda: iq_balance.maybe_update_planar(  # noqa: E731
                    None, None, st_d, ch_.iq_interval, dc_state=carry.get("dc"),
                    dc_alpha=ch_.dc_alpha, wire_i32=wire_l, wire_norm=ch_.fmt_in.normalizer,
                    wire_gain=cfg.gain, wire_kind=kind_l)
                call()
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                e0.record()
                for _ in range(3):
                    call()
                e1.record()
                torch.cuda.synchronize()
                est_ms[label_d] = e0.elapsed_time(e1) / 3
            say(f"{label} I/Q estimator ({ch_.iq_interval} samples between updates, "
                f"{BLOCK} a step; counter after the run {int(carry['iq'].samples_since_opt)}): "
                f"{est_ms['due']:.4f} ms a due step, {est_ms['not due']:.4f} ms one that "
                f"is not")
        got_w = torch.cat(outs, dim=-1).cpu().numpy()
        if got_w.shape != (2, steps * 2 * ch_.n_out) or got_w.dtype != np.int16:
            fail(f"{label} output {got_w.shape} {got_w.dtype}")
        twin = Chain(config(name, 2), device="cpu")
        tc = twin.init_carry()
        host = stream[:2].cpu()
        twin_outs = []
        for k in range(steps):
            tc, o = twin.step(tc, host[:, k * 2 * BLOCK:(k + 1) * 2 * BLOCK])
            twin_outs.append(o)
        want_w = torch.cat(twin_outs, dim=-1).numpy()
        # an overlap-save notch starts from a zero tail: its first
        # (taps-1)/2 outputs are ~1e-5 of full scale, which the AGC lifts
        # until either path's float32 FFT rounding shows; compare past it
        skip = 2 * (ch_.post_filter.num_taps // 2) if ch_.post_filter else 0
        dmax = int(np.abs(got_w.astype(np.int64) - want_w)[:, skip:].max())
        tone = TONE_HZ
        if name != "3":
            tone += nco_hz(SHIFT_HZ, IN_RATE)
        if name in ("4", "4k32", "4k128", "full4"):
            tone += nco_hz(POST_SHIFT_HZ, OUT_RATE)
        snr_t = tone_snr_db(cs16_iq(got_w[0]), tone, OUT_RATE, 2 * ch_.n_out)
        say(f"{label} vs CPU twin chain (2 channels): max |dcode| {dmax} "
            f"past the first {skip // 2} frames; tone at {tone:.4f} Hz: SNR "
            f"{snr_t:.1f} dB over steps 3-{steps}")
        if dmax > 4:
            fail(f"{label} differs from its CPU twin by {dmax} codes (> 4)")
        # cu8 input: the 8-bit codes alone hold the tone to ~48 dB
        need = 40.0 if cfg.input_format == "cu8" else 60.0
        if snr_t < need:
            fail(f"{label} tone SNR {snr_t:.1f} dB < {need:.0f} dB")
        step_ms_of[label] = step_ms
        return counts

    step_ms_of = {"[slice]": step_ms}
    general_launches = run_general("4", STEPS)
    # K2's launches, and of them those on the mma.sync core (kernels.
    # banded_core: the narrow bands, K < 96)
    want_counts = {"K1": 0, "K2": 2 * STEPS, "K2mma": 2 * STEPS, "K3": STEPS, "K3pre": 0,
                   "K4": STEPS, "K5": STEPS, "AGC": STEPS, "IQest": STEPS, "K1pro": 0,
                   "K1carry": 0, "OSfft": 0, "Gather": 0}
    if general_launches != want_counts:
        fail(f"config #4 launch counters {general_launches}, expected {want_counts}")
    s5 = run_general("5", GENERAL_STEPS)
    if s5 != {"K1": 0, "K2": 2 * GENERAL_STEPS, "K2mma": GENERAL_STEPS, "K3": GENERAL_STEPS,
              "K3pre": 0, "K4": GENERAL_STEPS, "K5": 0, "AGC": GENERAL_STEPS, "IQest": 0,
              "K1pro": 0, "K1carry": 0, "OSfft": 0, "Gather": 0}:
        fail(f"config #5 launch counters {s5}")
    s3 = run_general("3", GENERAL_STEPS)
    if s3 != {"K1": 0, "K2": 3 * GENERAL_STEPS, "K2mma": 3 * GENERAL_STEPS,
              "K3": GENERAL_STEPS, "K3pre": 0,
              "K4": 0, "K5": 0, "AGC": 0, "IQest": 0, "K1pro": 0, "K1carry": 0,
              "OSfft": 0, "Gather": 0}:
        fail(f"config #3 launch counters {s3}")
    s4k = run_general("4k32", GENERAL_STEPS)
    if s4k != {"K1": 0, "K2": 2 * GENERAL_STEPS, "K2mma": 2 * GENERAL_STEPS,
               "K3": GENERAL_STEPS, "K3pre": 0,
               "K4": GENERAL_STEPS, "K5": GENERAL_STEPS, "AGC": GENERAL_STEPS,
               "IQest": GENERAL_STEPS, "K1pro": 0, "K1carry": 0, "OSfft": 0, "Gather": 0}:
        fail(f"config #4 at nfft 32768 launch counters {s4k}")
    # above K5's sizes: the torch.fft route in its place, once a step
    s4r = run_general("4k128", GENERAL_STEPS)
    if s4r != {"K1": 0, "K2": 2 * GENERAL_STEPS, "K2mma": 2 * GENERAL_STEPS,
               "K3": GENERAL_STEPS, "K3pre": 0,
               "K4": GENERAL_STEPS, "K5": 0, "AGC": GENERAL_STEPS,
               "IQest": GENERAL_STEPS, "K1pro": 0, "K1carry": 0, "OSfft": GENERAL_STEPS,
               "Gather": 0}:
        fail(f"config #4 at nfft 131072 launch counters {s4r}")
    # config #4 without the DC block (the benchmark's full4): K3pre in K3's
    # place
    sf4 = run_general("full4", GENERAL_STEPS)
    if sf4 != {"K1": 0, "K2": 2 * GENERAL_STEPS, "K2mma": 2 * GENERAL_STEPS, "K3": 0,
               "K3pre": GENERAL_STEPS, "K4": GENERAL_STEPS, "K5": GENERAL_STEPS,
               "AGC": GENERAL_STEPS, "IQest": GENERAL_STEPS, "K1pro": 0, "K1carry": 0,
               "OSfft": 0, "Gather": 0}:
        fail(f"config #4 without the DC block launch counters {sf4}")
    say(f"[steps] ms/step: " + ", ".join(f"{k} {v:.3f}" for k, v in step_ms_of.items()))

    # ---------------------------------------------------- 7. the gather stage
    gch = Chain(config("gather"), device=dev)
    n_g = gch.n_in
    stream = tone_wire(CH, GATHER_STEPS * n_g, gen, GATHER_TONE_HZ)
    carry = gch.init_carry()
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    outs = []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for k in range(GATHER_STEPS):
        if k == 1:
            ev[0].record()
        carry, out = gch.step(carry, stream[:, k * 2 * n_g:(k + 1) * 2 * n_g])
        outs.append(out[:2].clone())
    ev[1].record()
    torch.cuda.synchronize()
    g_counts = launch_counts()
    g_ms = ev[0].elapsed_time(ev[1]) / (GATHER_STEPS - 1)
    peak = torch.cuda.max_memory_allocated()
    say(f"[gather] {gch.resampler.plan.p}/{gch.resampler.plan.q}: {GATHER_STEPS} steps of "
        f"{CH} x {n_g} -> {gch.n_out} frames, K {gch.resampler.stages[0].plan.weights.shape[1]}: "
        f"eager launches {g_counts}, {g_ms:.3f} ms/step over steps 2-{GATHER_STEPS} -> "
        f"{CH * n_g / (g_ms / 1e3) / 1e6:.1f} Msps in, peak device memory "
        f"{peak / 2 ** 20:.1f} MiB ({(peak - base_mem) / 2 ** 20:.1f} MiB above the "
        f"{base_mem / 2 ** 20:.1f} MiB held before the run, the input stream included)")
    want_g = {k: 0 for k in g_counts}
    want_g.update(K3=GATHER_STEPS, K4=GATHER_STEPS, AGC=GATHER_STEPS, Gather=GATHER_STEPS)
    if g_counts != want_g:
        fail(f"[gather] launch counters {g_counts}, expected {want_g}")
    got_w = torch.cat(outs, dim=-1).cpu().numpy()
    if got_w.shape != (2, GATHER_STEPS * 2 * gch.n_out) or got_w.dtype != np.int16:
        fail(f"[gather] output {got_w.shape} {got_w.dtype}")
    twin = Chain(config("gather", 2), device="cpu")
    tc, twin_outs, host = twin.init_carry(), [], stream[:2].cpu()
    for k in range(GATHER_STEPS):
        tc, o = twin.step(tc, host[:, k * 2 * n_g:(k + 1) * 2 * n_g])
        twin_outs.append(o)
    dmax = int(np.abs(got_w.astype(np.int64) - torch.cat(twin_outs, -1).numpy()).max())
    snr_g = tone_snr_db(cs16_iq(got_w[0]), GATHER_TONE_HZ, GATHER_RATE, gch.n_out)
    say(f"[gather] vs CPU twin chain (2 channels): max |dcode| {dmax}; tone at "
        f"{GATHER_TONE_HZ:.0f} Hz: SNR {snr_g:.1f} dB over steps 2-{GATHER_STEPS}")
    if dmax > 4:
        fail(f"[gather] differs from its CPU twin by {dmax} codes (> 4)")
    if snr_g < 60.0:
        fail(f"[gather] tone SNR {snr_g:.1f} dB < 60 dB")
    step_ms_of["[gather]"] = g_ms
    # the gather stage alone (the gather kernel): timed, twice on the same
    # input compared bit for bit, and held on 8 channels against its
    # definition (the windows gathered and summed in float64)
    st_g = gch.resampler.stages[0]
    m_g, k_g = st_g.plan.weights.shape
    xr_g, xi_g, sr_g, si_g = (0.3 * torch.randn((CH, w), generator=gen, device=dev)
                              for w in (n_g, n_g, st_g.hist, st_g.hist))
    run_g = lambda: st_g.apply_planar(xr_g, xi_g, sr_g, si_g)[0]
    (yr_g, yi_g), again = run_g(), run_g()
    same_g = torch.equal(yr_g, again[0]) and torch.equal(yi_g, again[1])
    ext_g = torch.complex(torch.cat([sr_g[:8], xr_g[:8]], -1),
                          torch.cat([si_g[:8], xi_g[:8]], -1)).to(torch.complex128)
    cols = (torch.from_numpy(st_g.plan.starts).to(dev).long()[:, None]
            + torch.arange(k_g, device=dev)[None, :])
    w64 = torch.from_numpy(st_g.plan.weights).to(dev).double()
    def_g = (ext_g[:, cols] * w64).sum(-1)                     # (8, M)
    torch.cuda.synchronize()
    db_g = snr_db(def_g.cpu().numpy(), torch.complex(yr_g[:8], yi_g[:8]).cpu().numpy())
    gs_ms, _ = time_pair(run_g, run_g, reps=3)
    say(f"[gather] the stage alone ({m_g} outputs x {k_g} taps x {2 * CH} planes, "
        f"the gather kernel): {gs_ms:.3f} ms; against its definition in float64 "
        f"{db_g:.1f} dB; two runs {'bit-identical' if same_g else 'differ'}")
    if db_g < 100.0 or not same_g:
        fail(f"[gather] the stage is {db_g:.1f} dB from its definition (>= 100 dB) "
             f"and two runs {'agree' if same_g else 'differ'} (bit for bit)")
    del stream, outs, carry, gch, twin, ext_g, def_g, again, yr_g, yi_g, xr_g, xi_g
    # the gather kernel at the HackRF cell's shape (64 channels, a carried
    # history): against its twin and its definition in float64, two
    # launches bit for bit; timed beside the twin (cats, a transposing
    # copy, embedding_bag, the planes split) and embedding_bag alone on a
    # built ext, the yardstick the port no longer calls.  Bound: the
    # planes in and out and the weights once at 3.35 TB/s; beside it the
    # benchmark's bound (harness/bounds.py _gather), which reads the cs8
    # wire in the planes' place.
    hk = Chain(config("hackrf10", 64), device=dev)
    st_h = hk.resampler.stages[0]
    m_h, k_h = st_h.plan.weights.shape
    n_h, c_h = st_h.plan.n_in, 64
    tw_h = kernels.Gather.build(st_h.plan.weights, st_h.plan.starts, n_h, st_h.hist, dev,
                                twin=True)
    xr_h, xi_h, sr_h, si_h = (0.3 * torch.randn((c_h, w), generator=gen, device=dev)
                              for w in (n_h, n_h, st_h.hist, st_h.hist))
    run_h = lambda: kernels.gather_apply(xr_h, xi_h, sr_h, si_h, st_h.table)
    twin_h = lambda: kernels.gather_apply_ref(xr_h, xi_h, sr_h, si_h, tw_h)
    ext_h = torch.cat([torch.cat([sr_h, xr_h], -1), torch.cat([si_h, xi_h], -1)]).T.contiguous()
    w_flat = tw_h.weights.reshape(-1)
    lib_h = lambda: torch.nn.functional.embedding_bag(tw_h.cols, ext_h, tw_h.bags, mode="sum",
                                                      per_sample_weights=w_flat)
    kernels.reset_launch_counts()
    (yr_h, yi_h), (ar_h, ai_h) = run_h(), run_h()
    tr_h, ti_h = twin_h()
    torch.cuda.synchronize()
    same_h = torch.equal(yr_h, ar_h) and torch.equal(yi_h, ai_h)
    h_launches = kernels.gather_apply.launches
    ext64 = torch.complex(torch.cat([sr_h, xr_h], -1).double(),
                          torch.cat([si_h, xi_h], -1).double())
    outs_h = torch.from_numpy(st_h.plan.starts).to(dev).long()
    w64_h = torch.from_numpy(st_h.plan.weights).to(dev).double()
    def_h = torch.zeros((c_h, m_h), dtype=torch.complex128, device=dev)
    for kk in range(k_h):
        def_h += w64_h[:, kk] * ext64[:, outs_h + kk]
    y_h = torch.complex(yr_h, yi_h)
    db_h = snr_db(def_h.cpu().numpy(), y_h.cpu().numpy())
    db_twin_h = snr_db(torch.complex(tr_h, ti_h).cpu().numpy(), y_h.cpu().numpy())
    err_h = max_abs((tr_h, ti_h), (yr_h, yi_h))
    gk_ms, gk_plain, gk_lib = time_pair(run_h, twin_h, reps=5, run_library=lib_h)
    g_bytes = c_h * (n_h + st_h.hist) * 8 + c_h * m_h * 8 + m_h * k_h * 4
    g_bound = g_bytes / 3.35e12 * 1e3
    g_wire = (c_h * (n_h * 2 + 8 * st_h.hist) + c_h * m_h * 8) / 3.35e12 * 1e3
    tiles_h = st_h.table.tiles[(c_h, 1)]
    say(f"[gather] the kernel at the HackRF cell's shape ({c_h} x {n_h} -> {m_h}, K {k_h}; "
        f"tile {tiles_h}): {gk_ms:.4f} ms, twin {gk_plain:.4f} ms, embedding_bag alone "
        f"{gk_lib:.4f} ms; bound {g_bound:.4f} ms (planes in and out, weights once: "
        f"{g_bytes / 1e6:.1f} MB), {100 * g_bound / gk_ms:.1f} %; the benchmark's bound "
        f"(the cs8 wire in) {g_wire:.4f} ms, {100 * g_wire / gk_ms:.2f} %; against its "
        f"definition {db_h:.1f} dB, its twin {db_twin_h:.1f} dB, max |err| {err_h:.3e}; "
        f"two launches {'bit-identical' if same_h else 'DIFFER'}, counted {h_launches}")
    if db_h < 120.0 or db_twin_h < 100.0 or not same_h or h_launches != 2:
        fail(f"[gather] the kernel at the HackRF shape: {db_h:.1f} dB from its definition "
             f"(>= 120), {db_twin_h:.1f} from its twin (>= 100), two launches "
             f"{'agree' if same_h else 'differ'}, {h_launches} counted (2)")
    report["Gather"] = dict(err=err_h, ms=gk_ms, plain=gk_plain, lib=gk_lib,
                            bound=(g_bound, "bytes: planes in and out, weights"))
    del hk, st_h, tw_h, xr_h, xi_h, sr_h, si_h, ext_h, ext64, def_h, y_h, tr_h, ti_h
    del yr_h, yi_h, ar_h, ai_h

    # ----------------------------------------------------- 8. one stream, folded
    fold_counts = {}
    for cname, label in (("c1", "flagship"), ("4c1", "config #4")):
        fc, row = make_chain(f"{cname}f8", dev), make_chain(cname, dev)
        n = fc.n_in
        wire = tone_wire(1, 3 * n, gen)
        carry = fc.init_carry()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        outs = []
        for k in range(3):
            carry, out = fc.step(carry, wire[:, k * 2 * n:(k + 1) * 2 * n])
            outs.append(out)
        torch.cuda.synchronize()
        fc_counts = launch_counts()
        fold_counts[label] = fc_counts
        got_f = torch.cat(outs, -1).cpu().numpy().astype(np.int64)
        skip = 2 * (fc.local.post_filter.num_taps // 2) if fc.local.post_filter else 0
        # the same fold on the CPU (the kernels' twins) on the same wire
        twin = make_chain(f"{cname}f8", "cpu")
        tc, outs, host = twin.init_carry(), [], wire.cpu()
        for k in range(3):
            tc, out = twin.step(tc, host[:, k * 2 * n:(k + 1) * 2 * n])
            outs.append(out)
        d_twin = int(np.abs(got_f - torch.cat(outs, -1).numpy())[:, skip:].max())
        # the fold's semantics: the row chain run 8 times a block
        carry, outs, w = row.init_carry(), [], row.in_wire_len
        for k in range(3 * 8):
            carry, out = row.step(carry, wire[:, k * w:(k + 1) * w])
            outs.append(out)
        want_f = torch.cat(outs, -1).cpu().numpy().astype(np.float64)
        diff = (got_f - want_f)[:, skip:]
        snr_f = 10 * np.log10((want_f[:, skip:] ** 2).mean() / max((diff ** 2).mean(), 1e-30))
        say(f"[fold] {label} C=1, F=8 x {row.n_in}: 3 folded blocks vs the CPU twin "
            f"fold: max |dcode| {d_twin}; vs the row chain run 24 times: SNR "
            f"{snr_f:.1f} dB, max |dcode| {int(np.abs(diff).max())}; both past the "
            f"first {skip // 2} frames; eager launches per folded step "
            f"{ {k: v / 3 for k, v in fc_counts.items() if v} }")
        if d_twin > 4:
            fail(f"[fold] {label}: the card's fold differs from its CPU twin by "
                 f"{d_twin} codes (> 4)")
        if snr_f < 60.0 or np.abs(diff).max() > 32:
            fail(f"[fold] {label}: the fold leaves its contract (>= 60 dB, <= 32 codes)")
        if any(fc_counts[k] == 0 for k in (("K1", "K1carry", "K2") if cname == "c1"
                                            else ("K2", "K3", "K4", "K5", "AGC", "IQest"))):
            fail(f"[fold] {label}: a kernel of the path did not launch: {fc_counts}")
        if cname == "4c1":
            # the AGC kernel and K4 at the fold's own shapes: one stream's
            # 8 rows, segments laid per row under one gain scan; K4 with
            # the rows as its channels, each row its own first NCO phase
            lc = fc.local
            n_row = lc.n_out
            ramp = torch.linspace(1e-2, 1.0, 8 * n_row, device=dev)[None, :]
            pr, pi = (0.3 * ramp * torch.randn((1, 8 * n_row), generator=gen, device=dev)
                      for _ in range(2))
            n_seg, seg, beta = agc.rms_params(lc.agc_cfg, n_row)
            a_args = (pr, pi, torch.ones(1, device=dev), torch.zeros(1, device=dev),
                      beta, lc.agc_cfg.target)
            got = kernels.rms_gains(*a_args, rows=8)
            want = kernels.rms_gains_ref(*a_args, rows=8)
            phases = nco.row_phases(phase0[:1], 8, n_row, lc.dtheta_post)
            k4_args = (pr.view(8, n_row), pi.view(8, n_row), want[0].view(8, n_seg),
                       seg, phases, lc.dtheta_post)
            got4 = kernels.post_apply(*k4_args, out_fmt="cs16")
            want4 = kernels.post_apply_ref(*k4_args, out_fmt="cs16")
            torch.cuda.synchronize()
            rel = max(float(((g - w).abs() / w.abs()).max()) for w, g in zip(want, got))
            (gi, gq), (wi, wq) = codes(got4), codes(want4)
            dcode = torch.maximum((gi - wi).abs(), (gq - wq).abs())
            frac = float((dcode > 0).float().mean())
            say(f"[fold] config #4's AGC gains at (1, 8 x {n_row}), {8 * n_seg} segments "
                f"in one scan: max relative error {rel:.3e}; K4 at (8, {n_row}) with "
                f"per-row phases: max |dcode| {int(dcode.max())} on {100 * frac:.4f}% "
                f"of samples")
            if got[0].shape != (1, 8 * n_seg) or rel > 1e-4:
                fail(f"[fold] the AGC gains disagree with their twin at the fold's "
                     f"shape: {tuple(got[0].shape)}, relative error {rel:.3e} > 1e-4")
            if int(dcode.max()) > 1 or frac > 0.01:
                fail("[fold] K4 disagrees with its twin by more than 1 code on 1% of "
                     "samples at the fold's shape")
            del pr, pi, got, want, got4, want4
        rates = []
        for f in FOLDS:
            ch_ = make_chain(f"{cname}f{f}", dev)
            n = ch_.n_in
            wire = tone_wire(1, (2 + FOLD_STEPS) * n, gen)
            carry = ch_.init_carry()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            for k in range(2 + FOLD_STEPS):
                if k == 2:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    ev[0].record()
                carry, _ = ch_.step(carry, wire[:, k * 2 * n:(k + 1) * 2 * n])
            ev[1].record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / FOLD_STEPS
            ms = ev[0].elapsed_time(ev[1]) / FOLD_STEPS
            rates.append(f"F={f}: {ms:.3f} ms/step (host {wall:.3f}), "
                         f"{n / (ms / 1e3) / 1e6:.1f} Msps")
        say(f"[fold] {label} C=1 at {row.n_in} frames a row: " + "; ".join(rates))
        del wire, carry, outs, fc, row, twin, host

    # ---------------------------------------------------------- 8b. shard
    from iq_tool_tpu_torch.parallel import ShardedChain, make_mesh
    from iq_tool_tpu_torch.pipeline.graphed import GraphedStep, _leaves
    from iq_tool_tpu_torch.profile_steps import graph_kernels_differ, profile
    wrapper_key = {"banded_apply_dc": "K1", "banded_apply": "K2", "banded_apply_mma": "K2mma",
                   "dc_block_apply": "K3", "pre_apply": "K3pre",
                   "post_apply": "K4", "osfft_apply": "K5", "rms_gains": "AGC",
                   "iq_estimate": "IQest", "dc_prologue": "K1pro", "dc_carry": "K1carry",
                   "segment_energies": "AGCenergy", "agc_chain": "AGCchain",
                   "overlap_save_fft": "OSfft", "gather_apply": "Gather"}

    def graph_vs_eager(chain, blocks, reset, resume):
        """The eager step of ``chain`` over ``blocks`` (a reset at step
        ``reset``), then its GraphedStep replayed over the same blocks
        written into its input buffer (and a carry from carry_from_numpy
        at step ``resume``): (what differs, the eager launches a step by
        chip_smoke's names, the GraphedStep)."""
        carry, want = chain.init_carry(), []
        kernels.reset_launch_counts()
        for k, raw in enumerate(blocks):
            carry, out = chain.step(carry, raw, k == reset)
            want.append((out.clone(), [t.clone() for t in _leaves(carry)]))
        eager = {wrapper_key[w]: v / len(blocks)
                 for w, v in kernels.launch_counts().items() if v}
        g = GraphedStep(chain)
        g.capture()
        carry, bad = g.init_carry(), []
        for k, raw in enumerate(blocks):
            g.input_buffer.copy_(raw)
            if k == resume:
                carry = g.carry_from_numpy(g.carry_to_numpy(carry))
            carry, out = g.step(carry, g.input_buffer, k == reset)
            if not torch.equal(out, want[k][0]):
                bad.append(f"output of step {k}")
            bad += [f"carry tensor {i} after step {k}"
                    for i, (a, b) in enumerate(zip(_leaves(carry), want[k][1]))
                    if not torch.equal(a, b)]
        torch.cuda.synchronize()
        return bad, eager, g

    def in_turns(tag, name, label):
        """Eager and graphed steps of profile_steps' chain ``name`` timed in
        turns (eager, graph, graph, eager) by profile_steps.profile; fails
        when the graph's device kernels are not the eager step's."""
        runs = [profile(name, graphed) for graphed in (False, True, True, False)]
        if any(r["idle"] is None for r in runs):
            fail(f"[{tag}] {label}: torch.profiler saw no device event in a window")
        form = {"eager": (runs[0], runs[3]), "graph": (runs[1], runs[2])}
        diff = graph_kernels_differ(runs[0], runs[1])
        # the profiler may drop a whole step's device events from a window
        # (every kernel's count a step then reads 7/8 of the truth): a
        # window that differs is measured again, both forms, up to twice
        for _ in range(2):
            if not diff:
                break
            say(f"[{tag}] {label}: profiled kernels differ, measuring again: "
                + "; ".join(diff[:3]))
            diff = graph_kernels_differ(profile(name, False), profile(name, True))
        mean = {f: {key: (a[key] + b[key]) / 2 for key in
                    ("wall_ms", "busy_ms", "kernels_per_step", "copies_per_step", "idle",
                     "queued_ms", "queued_late_ms", "sm_mhz", "power_w")}
                for f, (a, b) in form.items()}
        say(f"[{tag}] {label} in turns (eager, graph, graph, eager; torch.profiler): "
            + "; ".join(
                f"{f} wall {m['wall_ms']:.3f} ms/step ({form[f][0]['wall_ms']:.3f}, "
                f"{form[f][1]['wall_ms']:.3f}), busy {m['busy_ms']:.3f} "
                f"({form[f][0]['busy_ms']:.3f}, {form[f][1]['busy_ms']:.3f}), "
                f"{m['kernels_per_step']:.1f} kernels and {m['copies_per_step']:.1f} "
                f"copies a step, host launches a step "
                f"{1 if f == 'graph' else m['kernels_per_step'] + m['copies_per_step']:.0f}, "
                f"idle {100 * m['idle']:.1f} %, queued behind a spin "
                f"{m['queued_ms']:.3f} ms/step ({form[f][0]['queued_ms']:.3f}, "
                f"{form[f][1]['queued_ms']:.3f}), after 32 steps without a pause "
                f"{m['queued_late_ms']:.3f} ({form[f][0]['queued_late_ms']:.3f}, "
                f"{form[f][1]['queued_late_ms']:.3f}), SM {m['sm_mhz']:.0f} MHz and "
                f"{m['power_w']:.0f} W meanwhile"
                for f, m in mean.items())
            + f"; graphed/eager: busy {mean['graph']['busy_ms'] / mean['eager']['busy_ms']:.4f}"
            f", queued {mean['graph']['queued_ms'] / mean['eager']['queued_ms']:.4f}, "
            f"after 32 steps "
            f"{mean['graph']['queued_late_ms'] / mean['eager']['queued_late_ms']:.4f}")
        if diff:
            fail(f"[{tag}] {label}: the graph's device kernels are not the eager step's: "
                 + "; ".join(diff))

    def shard_counts(steps):
        c = {**launch_counts(), "AGCenergy": kernels.segment_energies.launches,
             "AGCchain": kernels.agc_chain.launches}
        return {k: v / steps for k, v in c.items() if v}

    def run_shard(name, c_, t_, steps, twin=False):
        """ShardedChain over a c_ x t_ mesh of cuda:0 against Chain at the
        per-shard framing over the same stream (t_ chain steps a sharded
        step): (sharded ms, chain ms) per sharded step by CUDA events over
        steps 2.., the host's wall ms of both, launches per step, the
        outputs' max |dcode| and SNR.  With ``twin`` also the same sharded
        chain on a mesh of the CPU (the kernels' twins) over the first
        channel of each slab, held as the CPU twin chains are (<= 4
        codes; past the notch's start-up ramp)."""
        cfg = config(name)
        sc = ShardedChain(cfg, make_mesh([dev] * (c_ * t_), c_, t_))
        ch_ = Chain(cfg, device=dev)
        stream = tone_wire(CH, steps * sc.n_in, gen)
        w = ch_.in_wire_len
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        c1, want = ch_.init_carry(), []
        torch.cuda.synchronize()
        for k in range(steps * t_):
            if k == t_:
                ev[0].record()
                t0 = time.perf_counter()
            c1, o = ch_.step(c1, stream[:, k * w:(k + 1) * w])
            want.append(o)
        ev[1].record()
        torch.cuda.synchronize()
        chain_wall = (time.perf_counter() - t0) * 1e3 / (steps - 1)
        cs, got = sc.init_carry(), []
        kernels.reset_launch_counts()
        for k in range(steps):
            if k == 1:
                ev[2].record()
                t0 = time.perf_counter()
            cs, o = sc.step(cs, stream[:, k * t_ * w:(k + 1) * t_ * w])
            got.append(o)
        ev[3].record()
        torch.cuda.synchronize()
        counts = shard_counts(steps)
        shard_wall = (time.perf_counter() - t0) * 1e3 / (steps - 1)
        got = torch.cat(got, -1)
        a = got.view(torch.int16).to(torch.float64)
        b = torch.cat(want, -1).view(torch.int16).to(torch.float64)
        d = a - b
        dmax = float(d.abs().max())
        snr = (float("inf") if dmax == 0 else
               10 * np.log10(float((b * b).mean()) / float((d * d).mean())))
        d_twin = None
        if twin:
            rows = [ci * (CH // c_) for ci in range(c_)]
            tsc = ShardedChain(config(name, c_), make_mesh(["cpu"] * (c_ * t_), c_, t_))
            tc, outs, host = tsc.init_carry(), [], stream[rows].cpu()
            for k in range(steps):
                tc, o = tsc.step(tc, host[:, k * t_ * w:(k + 1) * t_ * w])
                outs.append(o)
            skip = 2 * (ch_.post_filter.num_taps // 2) if ch_.post_filter else 0
            d_twin = int(np.abs(got[rows].cpu().numpy().astype(np.int64)
                                - torch.cat(outs, -1).numpy())[:, skip:].max())
        del stream, got, want, a, b, d
        return (ev[2].elapsed_time(ev[3]) / (steps - 1),
                ev[0].elapsed_time(ev[1]) / (steps - 1), shard_wall, chain_wall, counts,
                dmax, snr, d_twin)

    shard_report = {}
    # 1 x 1: the position's step is Chain.step; byte-identical, and the
    # sharded step's own cost (the split, the output's assembly) shows as
    # the difference of two runs over one stream, twice in turns
    runs = [run_shard("flagship", 1, 1, SHARD_STEPS) for _ in range(2)]
    sh_ms, ch_ms, sh_wall, ch_wall, counts, dmax, _, _ = runs[0]
    say(f"[shard] 1x1 flagship {CH} x {BLOCK}: {sh_ms:.3f}, {runs[1][0]:.3f} ms/step "
        f"against Chain's {ch_ms:.3f}, {runs[1][1]:.3f} (host wall {sh_wall:.3f}, "
        f"{runs[1][2]:.3f} against {ch_wall:.3f}, {runs[1][3]:.3f}); launches per step "
        f"{counts}; max |dcode| vs Chain {dmax:g}")
    if dmax != 0 or runs[1][5] != 0:
        fail("[shard] a 1x1 mesh is not byte-identical to Chain")
    if counts != {"K1": 1, "K2": 1, "K1carry": 1}:
        fail(f"[shard] 1x1 flagship launches per step {counts}")
    shard_report["1x1 flagship"] = counts
    want_counts = {
        ("flagship", 1, 4): {"K2": 8, "K2mma": 4, "K3": 4, "K1pro": 4},
        ("4", 1, 4): {"K2": 8, "K2mma": 8, "K3": 8, "K4": 4, "K5": 4, "IQest": 1,
                      "AGCenergy": 4, "AGCchain": 1},
        ("flagship", 2, 2): {"K2": 8, "K2mma": 4, "K3": 4, "K1pro": 4},
        ("flagship", 4, 1): {"K1": 4, "K2": 4, "K1carry": 4}}
    for (name, c_, t_), want_c in want_counts.items():
        sh_ms, ch_ms, sh_wall, ch_wall, counts, dmax, snr, d_twin = run_shard(
            name, c_, t_, SHARD_STEPS, twin=True)
        label = "flagship" if name == "flagship" else "config #4"
        say(f"[shard] {c_}x{t_} {label} ({CH} x {t_} x {BLOCK} a step): {sh_ms:.3f} ms/step "
            f"against Chain's {ch_ms:.3f} for its {t_} per-shard steps (host wall "
            f"{sh_wall:.3f} against {ch_wall:.3f}); launches per step {counts}; vs Chain "
            f"at the per-shard framing: max |dcode| {dmax:g}, SNR {snr:.1f} dB; vs the "
            f"same mesh on the CPU (the first channel of each slab): max |dcode| {d_twin}")
        if counts != want_c:
            fail(f"[shard] {c_}x{t_} {label} launches per step {counts}, expected {want_c}")
        if snr < 60.0 or dmax > 32:
            fail(f"[shard] {c_}x{t_} {label}: {snr:.1f} dB, {dmax:g} codes from Chain")
        if d_twin > 4:
            fail(f"[shard] {c_}x{t_} {label} differs from its CPU twin mesh by {d_twin} "
                 f"codes (> 4)")
        shard_report[f"{c_}x{t_} {label}"] = counts

    # the sharded step as one CUDA graph (pipeline/graphed.py) on every mesh
    # above: SHARD_GRAPH_STEPS replays of distinct blocks, a reset at the
    # second and a carry from carry_from_numpy at the third, bit for bit
    # against the eager ShardedChain step, the captured kernels its exact
    # launches a step; then 1x4 flagship and config #4 in turns, eager and
    # graphed
    t0 = time.perf_counter()
    shard_graph_kernels = {}
    for name, c_, t_ in (("flagship", 1, 1), *want_counts):
        label = f"{c_}x{t_} {'flagship' if name == 'flagship' else 'config #4'}"
        sc = ShardedChain(config(name), make_mesh([dev] * (c_ * t_), c_, t_))
        stream = tone_wire(CH, SHARD_GRAPH_STEPS * sc.n_in, gen)
        w = sc.in_wire_len
        blocks = [stream[:, k * w:(k + 1) * w] for k in range(SHARD_GRAPH_STEPS)]
        bad, eager, g = graph_vs_eager(sc, blocks, 1, 2)
        captured = {wrapper_key[k]: v for k, v in g.kernels.items()}
        say(f"[shard] {label} graphed ({CH} x {t_} x {BLOCK} a step): {SHARD_GRAPH_STEPS} "
            f"replays of distinct blocks, a reset at step 2, a carry from carry_from_numpy "
            f"at step 3: outputs and carries "
            f"{'bit-identical to the eager step' if not bad else 'DIFFER: ' + ', '.join(bad[:6])}"
            f"; capture {g.capture_sec:.3f} s; captured kernels a replay {captured} against "
            f"the eager step's {eager} (host launches a step: 1)")
        if bad:
            fail(f"[shard] {label}: the graphed sharded step parts from the eager step")
        if captured != eager or eager != shard_report[label]:
            fail(f"[shard] {label}: captured kernels {captured}, eager launches a step "
                 f"{eager}, expected {shard_report[label]}")
        shard_graph_kernels[label] = (g.kernels, g.replays)
        del sc, stream, blocks, g
    say(f"[shard] graphed meshes: {time.perf_counter() - t0:.1f} s")
    for name in ("flagship@1x4", "4@1x4"):
        in_turns("shard", name, name)

    # the AGC's two halves at the shapes a 1x4 config #4 step gives them:
    # one shard's segment energies, and the gain loop over the four
    # shards' gathered energies (several shared-memory chunks).  Their
    # inputs come from two more such steps, after the counted runs, whose
    # calls to the two wrappers pass through stand-ins that keep the last
    # call's arguments (nothing on the path writes them afterwards)
    seen = {}

    def seeing(name):
        wrapper = getattr(kernels, name)

        def call(*args):
            seen[name] = args
            return wrapper(*args)
        call.launches = 0           # the wrapper counts under its module name
        return wrapper, call

    sc4 = ShardedChain(config("4"), make_mesh([dev] * 4, 1, 4))
    stream = tone_wire(CH, 2 * sc4.n_in, gen)
    stand_ins = [seeing(k) for k in ("segment_energies", "agc_chain")]
    for wrapper, call in stand_ins:
        setattr(kernels, wrapper.__name__, call)
    try:
        cs = sc4.init_carry()
        for k in range(2):
            cs, _ = sc4.step(cs, stream[:, k * sc4.in_wire_len:(k + 1) * sc4.in_wire_len])
        torch.cuda.synchronize()
    finally:
        for wrapper, _ in stand_ins:
            setattr(kernels, wrapper.__name__, wrapper)
    del sc4, stream, cs
    xr_s, xi_s = seen["segment_energies"][:2]
    got_e = kernels.segment_energies(xr_s, xi_s)
    want_e = kernels.segment_energies_ref(xr_s, xi_s)
    torch.cuda.synchronize()
    e_rel = float(((got_e - want_e).abs() / want_e.abs()).max())
    if e_rel > 1e-5:
        fail(f"[shard] the segment energies kernel disagrees with its twin: {e_rel:.3e} > 1e-5")
    e_ms, e_plain = time_pair(lambda: kernels.segment_energies(xr_s, xi_s),
                              lambda: kernels.segment_energies_ref(xr_s, xi_s))
    c_s, n_s = xr_s.shape
    n_seg_s = got_e.shape[1]
    # planes in, energies out; 4 operations a sample
    e_bound = bound(c_s * (8 * n_s + 4 * n_seg_s), 4 * c_s * n_s, PEAK_FP32_S)
    say(f"[shard] segment energies of one shard ({c_s} x {n_s} -> {n_seg_s}): max "
        f"relative error {e_rel:.3e}; kernel {e_ms:.4f} ms, twin {e_plain:.4f} ms; bound "
        f"{e_bound[0]:.4f} ms ({e_bound[1]}) -> {100 * e_bound[0] / e_ms:.1f}%")
    report["AGCenergy"] = dict(err=float((got_e - want_e).abs().max()), ms=e_ms,
                               plain=e_plain, lib=None, bound=e_bound)
    e_g, g_g, e2_g, beta_g, tgt_g = seen["agc_chain"]
    got_c = kernels.agc_chain(e_g, g_g, e2_g, beta_g, tgt_g)
    want_c = kernels.rms_scan_ref(e_g.T, g_g, e2_g, beta_g, tgt_g)
    want_c = (want_c[0].T, *want_c[1:])
    torch.cuda.synchronize()
    chain_rel = max(float(((g - w).abs() / w.abs()).max()) for w, g in zip(want_c, got_c))
    if chain_rel > 1e-4:
        fail(f"[shard] the AGC chain kernel disagrees with rms_scan_ref on the gathered "
             f"energies {tuple(e_g.shape)}: {chain_rel:.3e} > 1e-4")
    chain_ms, chain_plain = time_pair(
        lambda: kernels.agc_chain(e_g, g_g, e2_g, beta_g, tgt_g),
        lambda: kernels.rms_scan_ref(e_g.T, g_g, e2_g, beta_g, tgt_g), reps=2)
    c_g, n_seg_g = e_g.shape
    # the gain recurrence cannot be reassociated: its floor is n_seg steps
    # of one step's dependent latency, the chain of one channel alone,
    # timed; against the bytes (energies and gains in and out)
    one_ms, _ = time_pair(
        lambda: kernels.agc_chain(e_g[:1], g_g[:1], e2_g[:1], beta_g, tgt_g),
        lambda: None, reps=2)
    chain_b = bound(c_g * (8 * n_seg_g + 16), 0, PEAK_FP32_S)
    chain_bound = (one_ms, "operations") if one_ms > chain_b[0] else chain_b
    say(f"[shard] the AGC chain over the gathered energies ({c_g} x {n_seg_g}): max "
        f"relative error {chain_rel:.3e} from rms_scan_ref; kernel {chain_ms:.4f} ms, twin "
        f"{chain_plain:.3f} ms; bound {chain_bound[0]:.5f} ms ({chain_bound[1]}: one "
        f"channel's chain of {n_seg_g} steps, timed; bytes {chain_b[0]:.5f} ms) -> "
        f"{100 * chain_bound[0] / chain_ms:.1f}%")
    report["AGCchain"] = dict(err=max_abs(want_c, got_c), ms=chain_ms, plain=chain_plain,
                              lib=None, bound=chain_bound)
    del seen, xr_s, xi_s, got_e, want_e, e_g, got_c, want_c

    # the extra DC launch a time shard pays: the DC kernel's first pass
    # (zero start, no I/Q or NCO) over one shard's block
    wire1 = tone_wire(CH, BLOCK, gen).view(torch.int32)
    st1 = torch.zeros((CH, 4), device=dev)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fl = Chain(config("flagship", 1), device="cpu")
    pass1 = lambda: kernels.dc_block_apply(None, None, st1, fl.dc_alpha, wire_i32=wire1,  # noqa: E731
                                           wire_norm=fl.fmt_in.normalizer)
    pass1()
    torch.cuda._sleep(50_000_000)
    e0.record()
    for _ in range(5):
        pass1()
    e1.record()
    torch.cuda.synchronize()
    say(f"[shard] the first DC pass over one shard's {CH} x {BLOCK} block: "
        f"{e0.elapsed_time(e1) / 5:.3f} ms a shard a step")
    del wire1

    # ---------------------------------------------------------- 8c. graph
    # the step as one CUDA graph (pipeline/graphed.py) against the eager
    # step, bit for bit, over GRAPH_STEPS replays of distinct blocks with a
    # reset at the fifth and, at the eighth, a carry handed in from
    # carry_from_numpy as a resume hands it; then both forms timed in turns
    k1_path = {"banded_apply": 1, "banded_apply_dc": 1, "dc_carry": 1}
    general_path = {"banded_apply": 2, "banded_apply_mma": 2, "dc_block_apply": 1,
                    "post_apply": 1, "rms_gains": 1, "osfft_apply": 1, "iq_estimate": 1}
    graph_kernels = {}
    for name, label, path in (("flagship", "flagship", k1_path),
                              ("4", "config #4", general_path),
                              ("c1", "flagship C=1", k1_path),
                              ("4c1", "config #4 C=1", general_path),
                              ("4c1f8", "config #4 C=1, the automatic fold F=8",
                               general_path)):
        ch_ = make_chain(name, dev)
        n = ch_.n_in
        stream = tone_wire(ch_.cfg.channels, GRAPH_STEPS * n, gen)
        blocks = [stream[:, k * 2 * n:(k + 1) * 2 * n].contiguous()
                  for k in range(GRAPH_STEPS)]
        del stream
        carry, want, due = ch_.init_carry(), [], []
        for k, raw in enumerate(blocks):
            before = None if "iq" not in carry else int(carry["iq"].samples_since_opt)
            carry, out = ch_.step(carry, raw, k == GRAPH_RESET)
            want.append((out.clone(), [t.clone() for t in _leaves(carry)]))
            if before is not None and int(carry["iq"].samples_since_opt) <= before:
                due.append(k)
        g = GraphedStep(ch_)
        g.capture()
        carry, bad = g.init_carry(), []
        for k, raw in enumerate(blocks):
            g.input_buffer.copy_(raw)
            if k == 7:
                carry = g.carry_from_numpy(g.carry_to_numpy(carry))
            carry, out = g.step(carry, g.input_buffer, k == GRAPH_RESET)
            if not torch.equal(out, want[k][0]):
                bad.append(f"output of step {k}")
            bad += [f"carry tensor {i} after step {k}"
                    for i, (a, b) in enumerate(zip(_leaves(carry), want[k][1]))
                    if not torch.equal(a, b)]
        torch.cuda.synchronize()
        say(f"[graph] {label} ({ch_.cfg.channels} x {n}): {GRAPH_STEPS} replays of distinct "
            f"blocks, a reset at step {GRAPH_RESET + 1}, a carry from carry_from_numpy at "
            f"step 8: outputs and carries "
            f"{'bit-identical to the eager step' if not bad else 'DIFFER: ' + ', '.join(bad[:6])}"
            f"; capture {g.capture_sec:.3f} s; captured kernels a replay {g.kernels} x "
            f"{g.replays} replays (host launches a step: 1)"
            + (f"; the I/Q update fell due at steps {[k + 1 for k in due]}" if due else ""))
        if bad:
            fail(f"[graph] {label}: the graph parts from the eager step")
        if g.kernels != path or g.replays != GRAPH_STEPS:
            fail(f"[graph] {label}: captured kernels {g.kernels} x {g.replays} replays, "
                 f"expected {path} x {GRAPH_STEPS}")
        if name == "4" and not any(k > 0 for k in due):
            fail("[graph] config #4: no I/Q update fell due after the first step")
        mapped = sum(n for _, n in g.stages)
        say(f"[graph] {label}: the stage map {g.stages}, {mapped} device nodes of the "
            f"graph's {g.graph_nodes}")
        if mapped != g.graph_nodes:
            fail(f"[graph] {label}: the stage map counts {mapped} device nodes, the graph "
                 f"holds {g.graph_nodes}")
        graph_kernels[label] = (g.kernels, g.replays)
        del blocks, want, g, carry, out, ch_
        in_turns("graph", name, label)

    # every other chain profile_steps measures, at GRAPH_MORE_CH channels:
    # GRAPH_MORE_STEPS replays of distinct blocks, a reset at the third and
    # a carry from carry_from_numpy at the fifth, bit for bit against the
    # eager step, the captured kernels its exact launches a step
    t0 = time.perf_counter()
    for name, label in (("1", "config #1"), ("2", "config #2"), ("3", "config #3 (cu8)"),
                        ("5", "config #5"), ("gather", "gather"),
                        ("4k32", "config #4 at nfft 32768"),
                        ("4k128", "config #4 at nfft 131072 (the torch.fft route)"),
                        ("4dx", "config #4, dx AGC"), ("4dig", "config #4, digital AGC"),
                        ("full4", "config #4 without the DC block"),
                        ("hackrf10", "the HackRF chain (cs8, the gather stage)")):
        ch_ = Chain(config(name, GRAPH_MORE_CH), device=dev)
        n = ch_.n_in
        stream = tone_wire(GRAPH_MORE_CH, GRAPH_MORE_STEPS * n, gen,
                           GATHER_TONE_HZ if name == "gather" else TONE_HZ)
        if ch_.cfg.input_format == "cu8":
            stream = to_cu8(stream)
        elif ch_.cfg.input_format == "cs8":
            stream = to_cs8(stream)
        blocks = [stream[:, k * 2 * n:(k + 1) * 2 * n] for k in range(GRAPH_MORE_STEPS)]
        bad, eager, g = graph_vs_eager(ch_, blocks, 2, 4)
        captured = {wrapper_key[k]: v for k, v in g.kernels.items()}
        say(f"[graph] {label} ({GRAPH_MORE_CH} x {n}): {GRAPH_MORE_STEPS} replays of "
            f"distinct blocks, a reset at step 3, a carry from carry_from_numpy at step 5: "
            f"outputs and carries "
            f"{'bit-identical to the eager step' if not bad else 'DIFFER: ' + ', '.join(bad[:6])}"
            f"; capture {g.capture_sec:.3f} s; captured kernels a replay {captured} against "
            f"the eager step's {eager}")
        if bad:
            fail(f"[graph] {label}: the graph parts from the eager step")
        if captured != eager or g.replays != GRAPH_MORE_STEPS:
            fail(f"[graph] {label}: captured kernels {captured} x {g.replays} replays, "
                 f"the eager step launches {eager} a step")
        graph_kernels[label] = (g.kernels, g.replays)
        del stream, blocks, g, ch_
    say(f"[graph] the other chains: {time.perf_counter() - t0:.1f} s")

    # -------------------------------------------------------------- 9. CLI
    work = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    inp, outp = os.path.join(work, "tone_in.cs16"), os.path.join(work, "out.cs16")
    frames = int(10 * IN_RATE)
    tone_wire(1, frames, gen).cpu().numpy().tofile(inp)
    cmd = [sys.executable, "-m", "iq_tool_tpu_torch", "-i", "raw-file", "-o", "raw",
           inp, outp, "--raw-file-input-rate", "2048000",
           "--raw-file-input-sample-format", "cs16", "--output-rate", "1488375",
           "--dc-block", "--freq-shift", "100000", "--lowpass", "400000",
           "--block-size", str(BLOCK), "--device", "cuda", "--force-overwrite"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"CLI exited {res.returncode}: {res.stderr[-2000:]}")
    out = np.fromfile(outp, np.int16)
    os.remove(inp)
    os.remove(outp)
    want_frames = frames * 11907 // 16384
    snr_c = tone_snr_db(cs16_iq(out), TONE_HZ + SHIFT_HZ, OUT_RATE, int(OUT_RATE))
    up, streaming, fold = cli_times(res.stderr)
    say(f"[cli] {frames} frames in, {out.size // 2} out (want {want_frames}), "
        f"tone SNR {snr_c:.1f} dB after 1 s, wall {wall:.2f} s: start-up (kernel "
        f"build, graph capture) {up:.2f} s, streaming {streaming:.2f} s, the rest "
        f"(interpreter, imports, set-up) {wall - up - streaming:.2f} s; the automatic "
        f"fold at one channel: F = {fold}")
    if fold != 8:
        fail(f"[cli] the automatic fold at one channel on the card is {fold}, not 8")
    if out.size != 2 * want_frames:
        fail("CLI output length is not n * 11907 // 16384 frames")
    if snr_c < 60.0:
        fail(f"CLI tone SNR {snr_c:.1f} dB < 60 dB")

    # the general step's flags: the shift moves after the resampler and
    # the 0-10 kHz notch runs after it too.  The tone sits at 137 kHz,
    # inside the I/Q estimator's band (5-95 % of Nyquist: 51 kHz and up),
    # so the pre-stream calibration sees it and leaves the factors near 0
    # (a tone outside the band leaves the estimator to noise, which it
    # turns into an image at -35 to -52 dBc: ROADMAP Queue 3); it leaves
    # at 87 kHz
    tone_wire(1, frames, gen, tone_hz=TONE_HZ + SHIFT_HZ).cpu().numpy().tofile(inp)
    cmd = [sys.executable, "-m", "iq_tool_tpu_torch", "-i", "raw-file", "-o", "raw",
           inp, outp, "--raw-file-input-rate", "2048000",
           "--raw-file-input-sample-format", "cs16", "--output-rate", "1488375",
           "--dc-block", "--iq-correction", "--stopband", "0:10000",
           "--freq-shift", str(POST_SHIFT_HZ), "--shift-after-resample", "--output-agc",
           "--agc-profile", "local", "--block-size", str(BLOCK), "--device", "cuda",
           "--force-overwrite"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"CLI (general flags) exited {res.returncode}: {res.stderr[-2000:]}")
    out = np.fromfile(outp, np.int16)
    os.remove(inp)
    os.remove(outp)
    tone_g = TONE_HZ + SHIFT_HZ + nco_hz(POST_SHIFT_HZ, OUT_RATE)
    snr_g = tone_snr_db(cs16_iq(out), tone_g, OUT_RATE, int(OUT_RATE))
    up, streaming, fold = cli_times(res.stderr)
    say(f"[cli] general flags (F = {fold}): {frames} frames in, {out.size // 2} out (want "
        f"{want_frames}), tone at {tone_g:.4f} Hz: SNR {snr_g:.1f} dB after 1 s, wall "
        f"{wall:.2f} s: start-up {up:.2f} s, streaming {streaming:.2f} s, the rest "
        f"{wall - up - streaming:.2f} s")
    if out.size != 2 * want_frames:
        fail("CLI (general flags) output length is not n * 11907 // 16384 frames")
    if snr_g < 60.0:
        fail(f"CLI (general flags) tone SNR {snr_g:.1f} dB < 60 dB")

    # ----------------------------------------- 10. checkpoint and resume
    from iq_tool_tpu_torch.cli import main as cli_main
    from iq_tool_tpu_torch.pipeline.checkpoint import load_checkpoint
    frames = int(2 * IN_RATE)
    cut = 1_234_567                       # off every block boundary
    tone_wire(1, frames, gen).cpu().numpy().tofile(inp)
    half, ck = os.path.join(work, "half.cs16"), os.path.join(work, "state.ckpt")
    with open(inp, "rb") as f_in, open(half, "wb") as f_half:
        f_half.write(f_in.read(4 * cut))
    full, part = os.path.join(work, "full.cs16"), os.path.join(work, "part.cs16")
    flags = ["-i", "raw-file", "-o", "raw", "--raw-file-input-rate", "2048000",
             "--raw-file-input-sample-format", "cs16", "--output-rate", "1488375",
             "--dc-block", "--freq-shift", "100000", "--lowpass", "400000",
             "--device", "cuda", "--checkpoint-interval", "0.05", "--log-level", "warn"]
    kernels.reset_launch_counts()
    for fold in ("1", "4", "automatic"):
        fl = flags + (["--time-fold", fold] if fold != "automatic" else [])
        for p_ in (full, part, ck):
            if os.path.exists(p_):
                os.remove(p_)
        t0 = time.perf_counter()
        rcs = (cli_main(fl + [inp, full]),
               cli_main(fl + [half, part, "--checkpoint", ck]),
               cli_main(fl + [inp, part, "--checkpoint", ck, "--resume"]))
        wall = time.perf_counter() - t0
        if rcs != (0, 0, 0):
            fail(f"[ckpt] --time-fold {fold}: CLI exit codes {rcs}")
        with open(full, "rb") as a, open(part, "rb") as b:
            same, size = a.read() == b.read(), os.path.getsize(full)
        cpu_row = Chain(config("flagship", 1, 16384), device="cpu")
        _, fin, fout, _ = load_checkpoint(ck, cpu_row)
        say(f"[ckpt] --time-fold {fold}: {frames} frames, cut at {cut}: resumed output "
            f"{'byte-identical' if same else 'DIFFERS'} ({size} bytes); the card's "
            f"checkpoint loads on the CPU at {fin} frames in, {fout} out; 3 runs "
            f"{wall:.2f} s")
        if not same or size != 4 * (frames * 11907 // 16384):
            fail(f"[ckpt] --time-fold {fold}: resume is not byte-identical")
    ck_counts = launch_counts()
    say(f"[ckpt] host launches over the 9 runs (each run's graph warm-up and "
        f"capture; its replays launch the captured kernels): {ck_counts}")
    if not all(ck_counts[k] for k in ("K1", "K1carry", "K2")) or ck_counts["K1pro"]:
        fail(f"[ckpt] the CLI runs did not launch the flagship's kernels: {ck_counts}")
    # a mesh flag (1 x 1 on one card): the engine steps the graphed sharded
    # chain (its host launches: the warm-up steps and the capture), the
    # summary says so, and the bytes are the unfolded chain's
    from iq_tool_tpu_torch import cli as cli_mod
    from iq_tool_tpu_torch.pipeline.graphed import WARMUP_STEPS
    shown, tables, runs = cli_mod._print_summary_table, {}, {}
    cli_mod._print_summary_table = lambda title, items, file=sys.stderr: (
        tables.__setitem__(title, items), shown(title, items, file))
    try:
        for label_, extra, path in (("unfolded", ["--time-fold", "1"], full),
                                    ("mesh 1x1", ["--mesh-time", "1"], part)):
            kernels.reset_launch_counts()
            tables.clear()
            rc = cli_main(flags + extra + [inp, path, "--force-overwrite"])
            runs[label_] = (rc, tables.get("Configuration Summary", {}).get("Step"),
                            {k: v for k, v in launch_counts().items() if v})
    finally:
        cli_mod._print_summary_table = shown
    with open(full, "rb") as a, open(part, "rb") as b:
        same = a.read() == b.read()
    say(f"[ckpt] the CLI with --mesh-time 1 against --time-fold 1 on the same file: "
        f"output {'byte-identical' if same else 'DIFFERS'}; (exit code, the summary's "
        f"step form, host launches) {runs}")
    graphed = {k: WARMUP_STEPS + 1 for k in ("K1", "K1carry", "K2")}
    if not same or any(r[:3] != (0, "graph", graphed) for r in runs.values()):
        fail(f"[ckpt] the CLI with a mesh flag did not step the graphed sharded chain "
             f"to the unfolded chain's bytes: {runs}")

    # ------------------------------------------------------------ 11. profile
    import glob
    pdir = os.path.join(work, "profile")
    for old in glob.glob(os.path.join(pdir, "*")):
        os.remove(old)
    if cli_main(flags + [inp, full, "--force-overwrite", "--profile-dir", pdir]) != 0:
        fail("[profile] the CLI with --profile-dir failed")
    traces = glob.glob(os.path.join(pdir, "*.pt.trace.json"))
    if len(traces) != 1:
        fail(f"[profile] expected one trace in {pdir}, found {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kern = sorted({e["name"].split("(")[0] for e in events
                   if e.get("cat") == "kernel" and ("dc_kernel" in e.get("name", "")
                                                    or "banded_kernel" in e.get("name", ""))})
    # K1's two kernels by their template flags: the DC kernel's carry pass
    # (dc_kernel<planar in, I/Q, carry>) and the banded kernel with the
    # DC-wire loader (banded_kernel<complex, pair, dc, ...>)
    k1_names = ("dc_kernel<false, false, true>", "banded_kernel<false, true, true,")
    n_k = sum(1 for e in events if e.get("cat") == "kernel")
    say(f"[profile] {os.path.basename(traces[0])}: {os.path.getsize(traces[0]) / 2 ** 20:.1f} "
        f"MiB, {len(events)} events, {n_k} kernel launches; the chain's kernels in it: {kern}")
    if not all(any(name in k for k in kern) for name in k1_names):
        fail(f"[profile] the trace does not name K1's kernels {k1_names}")
    for p_ in (inp, half, full, part, ck, traces[0]):
        os.remove(p_)

    # ------------------------------------------------------------ 12. bench
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "iq_tool_tpu_torch.bench", "--flagship-only"],
                         cwd=HERE, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        fail(f"[bench] exited {res.returncode}: {res.stderr[-2000:]}")
    bench_line = json.loads(res.stdout.strip().splitlines()[-1])
    missing = {"metric", "value", "unit", "vs_baseline", "configs", "device"} - set(bench_line)
    bench_msps = bench_line.get("value")
    say(f"[bench] {json.dumps(bench_line)} ({time.perf_counter() - t0:.1f} s)")
    if missing or not bench_msps or bench_msps <= 0 or bench_line["device"] != smi_line:
        fail(f"[bench] the JSON line lacks {missing} or a flagship value, or names another "
             f"card: {bench_line}")
    step_ms = CH * BLOCK / bench_msps / 1e3

    # ------------------------------------------------------------- 13. host
    from iq_tool_tpu_torch import native
    t0 = time.perf_counter()
    ring_built = native.ensure_built()
    res = subprocess.run([sys.executable, "-m", "iq_tool_tpu_torch.host_budget",
                          "--channels", str(CH), "--block", str(BLOCK)],
                         cwd=HERE, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        fail(f"[host] exited {res.returncode}: {res.stderr[-2000:]}")
    host_lines = [json.loads(x) for x in res.stdout.strip().splitlines()]
    stages = {r["stage"]: r for r in host_lines if "stage" in r}
    host_sum = host_lines[-1]
    for name_, r in stages.items():
        say(f"[host] {name_}: " + (f"{r['ns_per_sample']:.4f} ns a sample, "
                                   f"{r['standalone_Msps']:.1f} Msps alone"
                                   if "error" not in r else r["error"]))
    want_stages = {"file_read", "frombuffer+stack", "pin_copy", "h2d_pageable", "h2d_pinned",
                   "pinned_out_alloc", "d2h_pinned", "out_tobytes", "sink_write"}
    say(f"[host] {json.dumps(host_sum)}; the native ring "
        f"{'built' if ring_built else 'not built (no toolchain)'} "
        f"({time.perf_counter() - t0:.1f} s)")
    if (want_stages - {k for k, r in stages.items() if "error" not in r}
            or "native_ring" not in stages or "host_Msps" not in host_sum
            or not host_sum.get("device_step_Msps")):
        fail(f"[host] a stage or the summary is missing: {sorted(stages)} {host_sum}")

    # ----------------------------------------------------------- 14. cli128
    import shutil
    from iq_tool_tpu_torch.pipeline.graphed import GraphedStep
    cdir = os.path.join(work, "cli128")
    shutil.rmtree(cdir, ignore_errors=True)
    os.makedirs(cdir)
    ref = GraphedStep(Chain(config("flagship"), device=dev))
    n_in = ref.n_in
    frames = 4 * n_in + n_in // 2
    t0 = time.perf_counter()
    wire_d = tone_wire(CH, frames, torch.Generator(device=dev).manual_seed(SEED + 128))
    wire_h = wire_d.cpu().numpy()
    for c in range(CH):
        wire_h[c].tofile(os.path.join(cdir, f"in_{c}.cs16"))
        wire_h[c, :4 * n_in].tofile(os.path.join(cdir, f"half_{c}.cs16"))
    gen_s = time.perf_counter() - t0
    carry, outs = ref.init_carry(), []
    for k in range(0, frames, n_in):
        blk = torch.zeros((CH, 2 * n_in), dtype=torch.int16, device=dev)
        part_ = wire_d[:, 2 * k:2 * (k + n_in)]
        blk[:, :part_.shape[1]] = part_
        carry, out = ref.step(carry, blk)
        outs.append(out.cpu().numpy().copy())    # the next replay overwrites out
    n_out_total = ref.expected_out_frames(frames)
    want_out = np.concatenate(outs, axis=1)[:, :2 * n_out_total]
    del wire_d, outs, ref, carry, out
    flags128 = ["-i", "raw-file", "-o", "raw", "--raw-file-input-rate", "2048000",
                "--raw-file-input-sample-format", "cs16", "--output-rate", "1488375",
                "--dc-block", "--freq-shift", "100000", "--lowpass", "400000",
                "--channels", str(CH), "--block-size", str(BLOCK), "--device", "cuda",
                "--force-overwrite"]
    ck128 = os.path.join(cdir, "state.ckpt")

    def cli(inp_, out_, *extra):
        t_ = time.perf_counter()
        r_ = subprocess.run([sys.executable, "-m", "iq_tool_tpu_torch",
                             os.path.join(cdir, inp_), os.path.join(cdir, out_),
                             *flags128, *extra], cwd=HERE, capture_output=True,
                            text=True, timeout=600)
        if r_.returncode != 0:
            fail(f"[cli128] the CLI exited {r_.returncode}: {r_.stderr[-2000:]}")
        return time.perf_counter() - t_, r_.stderr

    def outputs(stem):
        return [np.fromfile(os.path.join(cdir, f"{stem}_{c}.cs16"), np.int16)
                for c in range(CH)]

    wall, err = cli("in_{ch}.cs16", "out_{ch}.cs16")
    up, streaming, fold = cli_times(err)
    got_out = outputs("out")
    same_ref = all(g.tobytes() == w.tobytes() for g, w in zip(got_out, want_out))
    cut_wall, _ = cli("half_{ch}.cs16", "part_{ch}.cs16", "--checkpoint", ck128)
    res_wall, _ = cli("in_{ch}.cs16", "part_{ch}.cs16", "--checkpoint", ck128, "--resume")
    same_cut = all(g.tobytes() == w.tobytes() for g, w in zip(outputs("part"), got_out))
    in_mib = CH * frames * 4 / 2 ** 20
    say(f"[cli128] {CH} channels x {frames} frames ({in_mib:.0f} MiB of cs16 in {CH} "
        f"'{{ch}}' files, written in {gen_s:.1f} s), the flagship's flags at "
        f"--block-size {BLOCK} (F = {fold}): output "
        f"{'byte-identical' if same_ref else 'DIFFERS'} to the GraphedStep over the same "
        f"blocks ({n_out_total} frames a channel); cut after block 2 and resumed "
        f"({cut_wall:.2f} s + {res_wall:.2f} s): "
        f"{'byte-identical' if same_cut else 'DIFFERS'} to the uncut run")
    say(f"[cli128] wall {wall:.2f} s: start-up (kernel build, graph capture) {up:.2f} s, "
        f"streaming {streaming:.2f} s ({CH * frames / streaming / 1e6:.1f} Msps in), the "
        f"rest {wall - up - streaming:.2f} s; the device step queued (bench) {step_ms:.3f} ms "
        f"= {bench_msps:.1f} Msps; host serial path (host_budget) "
        f"{host_sum['host_Msps']:.1f} Msps ({smi_line})")
    shutil.rmtree(cdir, ignore_errors=True)
    if fold != 1 or not same_ref or any(len(g) != 2 * n_out_total for g in got_out):
        fail(f"[cli128] the CLI at {CH} channels is not the GraphedStep's bytes "
             f"(F = {fold}, {n_out_total} frames expected)")
    if not same_cut:
        fail("[cli128] the cut and resumed run is not byte-identical to the uncut run")

    # ------------------------------------------------------------ result
    src = {"K1": "iq_tool_tpu_torch/csrc/banded.cu",
           "K2": "iq_tool_tpu_torch/csrc/banded.cu",
           "K2mma": "iq_tool_tpu_torch/csrc/banded_mma.cu",
           "K3": "iq_tool_tpu_torch/csrc/banded_dc.cu",
           "K3pre": "iq_tool_tpu_torch/csrc/pre.cu",
           "K4": "iq_tool_tpu_torch/csrc/post.cu",
           "K5": "iq_tool_tpu_torch/csrc/osfft.cu",
           "AGC": "iq_tool_tpu_torch/csrc/post.cu",
           "IQest": "iq_tool_tpu_torch/csrc/iq_est.cu",
           "K1pro": "iq_tool_tpu_torch/csrc/banded_dc.cu",
           "K1carry": "iq_tool_tpu_torch/csrc/banded_dc.cu",
           "AGCenergy": "iq_tool_tpu_torch/csrc/post.cu",
           "AGCchain": "iq_tool_tpu_torch/csrc/post.cu",
           "OSfft": "iq_tool_tpu_torch/ops/filters.py",
           "Gather": "iq_tool_tpu_torch/csrc/gather.cu"}
    rep = {"K1": "iq_tool_tpu/ops/pallas_kernels.py:772",
           "K2": "iq_tool_tpu/ops/pallas_kernels.py:492",
           "K2mma": "iq_tool_tpu/ops/pallas_kernels.py:492",
           "K3": "iq_tool_tpu/ops/pallas_kernels.py:1121",
           # no TPU kernel: the reference chain's XLA ops without the DC block
           "K3pre": "iq_tool_tpu/pipeline/chain.py:528",
           "K4": "iq_tool_tpu/ops/pallas_kernels.py:1506",
           "K5": "iq_tool_tpu/ops/pallas_kernels.py:1324",
           "AGC": "iq_tool_tpu/ops/agc.py:116",
           "IQest": "iq_tool_tpu/pipeline/chain.py:309",
           "K1pro": "iq_tool_tpu/ops/pallas_kernels.py:772",
           "K1carry": "iq_tool_tpu/ops/pallas_kernels.py:772",
           "AGCenergy": "iq_tool_tpu/parallel/sharded.py:271",
           "AGCchain": "iq_tool_tpu/ops/agc.py:78",
           # no TPU kernel: the reference's XLA overlap-save, where its
           # Pallas kernel declines the size
           "OSfft": "iq_tool_tpu/ops/filters.py:265",
           # no TPU kernel: the reference's XLA gather and einsum
           "Gather": "iq_tool_tpu/ops/resample.py:340"}
    # K1/K1carry/K2 launches from the flagship slice (K2 there on the wgmma
    # core), the rest from config #4's run (K2mma: its K2 on the mma.sync
    # core), K5 at nfft 32768 from the [full32k] run, K3 on cu8 from
    # config #3's, K3pre from [full4]'s, the DC prologue from the 1x4
    # flagship's sharded run, all host launches of eager steps, the
    # torch.fft route's from the [full128k] run; and each phase's launches per step, the graphs' as their
    # captured kernels times their replays
    counts = {**general_launches, **launches, "K2mma": general_launches["K2mma"],
              "K5@32768": s4k["K5"], "K3@cu8": s3["K3"], "K3pre": sf4["K3pre"],
              "OSfft": s4r["OSfft"], "Gather": g_counts["Gather"],
              **{k: int(shard_report["1x4 config #4"][k] * SHARD_STEPS)
                 for k in ("AGCenergy", "AGCchain")},
              "K1pro": int(shard_report["1x4 flagship"]["K1pro"] * SHARD_STEPS)}
    src["K5@32768"], rep["K5@32768"] = src["K5"], rep["K5"]
    src["K3@cu8"], rep["K3@cu8"] = src["K3"], rep["K3"]
    # K2dec is K2's kernel at the AM decimator's band; no phase here steps
    # the AM chain, so it has no launch count of its own
    src["K2dec"], rep["K2dec"] = src["K2"], rep["K2"]
    counts["K2dec"] = None
    src["IQest@skip"], rep["IQest@skip"] = src["IQest"], rep["IQest"]
    counts["IQest@skip"] = counts["IQest"]
    phases = {"flagship": (dict(launches, K3=0, K4=0, K5=0, AGC=0, IQest=0), STEPS),
              "#4": (general_launches, STEPS), "#4@32768": (s4k, GENERAL_STEPS),
              "#4@131072": (s4r, GENERAL_STEPS),
              "#5": (s5, GENERAL_STEPS), "#3": (s3, GENERAL_STEPS),
              "#4 no DC": (sf4, GENERAL_STEPS),
              "gather": (g_counts, GATHER_STEPS),
              "fold flagship C=1 F=8": (fold_counts["flagship"], 3),
              "fold #4 C=1 F=8": (fold_counts["config #4"], 3),
              **{f"shard {k}": (v, 1) for k, v in shard_report.items()},
              # the graphs: the kernels each capture recorded, times its replays
              **{f"graph {k} (captured x replays)": (
                  {wrapper_key[w]: c * r for w, c in v.items()}, r)
                 for k, (v, r) in graph_kernels.items()},
              **{f"shard graph {k} (captured x replays)": (
                  {wrapper_key[w]: c * r for w, c in v.items()}, r)
                 for k, (v, r) in shard_graph_kernels.items()}}
    say(json.dumps({"kernels": [
        {"name": k, "route": "torch.fft" if k == "OSfft" else "cuda", "source": src[k],
         "replaces": rep[k],
         "launches": counts[k], "max_abs_err": report[k]["err"],
         "ms": report[k]["ms"], "plain_ms": report[k]["plain"],
         "bound_ms": report[k]["bound"][0], "bound_by": report[k]["bound"][1],
         "library_ms": report[k]["lib"],
         "launches_per_step": {ph: c.get(k.split("@")[0], 0) / n
                               for ph, (c, n) in phases.items()}}
        for k in src]}))
    say(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
