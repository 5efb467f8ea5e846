#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (iq_tool_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the checkout around this file, and refuses jax,
jaxlib and the JAX package.  One line per phase, exits non-zero at the
first failure:

1. card: nvidia-smi name and power limit, torch and CUDA versions;
2. build: nvcc compiles the kernels from csrc/ (registers, spills);
3. kernels vs their plain twins on the card, at the flagship shapes
   (K1 stage 0, its DC prologue alone with a bit-for-bit repeat, K2
   stage 1 packed) and at the strides 224, 400 and 144 (planar and
   packed), each timed twin, kernel, kernel, twin with CUDA events (K2
   beside one float32 matmul of the unfolded windows);
4. the slice: the flagship Chain (128 channels x 262144 frames) for 6
   steps; both launch counters must read 6; output against the CPU twin
   chain on 2 channels and a tone SNR check; steady-state Msps and peak
   device memory;
5. the general step's kernels vs their twins at BASELINE config #4's
   shapes (128 channels): K3 dc_block_apply (cs16 and cu8 wire), K4
   post_apply, K5 osfft_apply (at nfft 16384 and, on the schedule the
   chain makes for --filter-fft-size 32768, at nfft 32768, each beside
   the twin's torch.fft core) and two helper kernels, the AGC's gains
   (segment energies and gain loop; its bound the larger of its bytes
   and its dependency chain, the chain alone timed over the same
   energies) and the I/Q estimator's descent, timed the same way;
6. the general step: config #4 (DC + I/Q + pre-shift, resampler,
   2175-tap overlap-save notch, post-shift, local AGC) at 128 x 262144
   for 6 steps with exact launch counters, against the CPU twin chain on
   2 channels, tone SNR, ms per step, Msps and peak memory, and the
   masked I/Q estimator's cost per step; then configs #5 and #3, and #4
   with --filter-fft-size 32768 ([full32k]), the same way at 4 steps;
7. [gather]: the gather resampler stage (2.048 Msps -> 25282.56 sps,
   449/36371) behind the DC kernel and in front of K4 (local AGC), 128 x
   254597 frames for 4 steps with exact launch counters, against the CPU
   twin chain on 2 channels and an in-band tone's SNR; ms per step, Msps
   and peak device memory; then the stage alone (weighted bag sums)
   timed, repeated bit for bit and held against its float64 definition;
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
   energies), timed; the first DC pass's cost a shard;
9. the CLI on a 10 s, 2.048 Msps cs16 tone file: the flagship flags, then
   the general step's (I/Q correction, notch, post-shift, AGC);
10. [ckpt]: the CLI (in this process, so the launch counters see it) on a
   2 s tone file with the flagship flags: an uninterrupted run, a run on
   the file cut off a block boundary with --checkpoint, a --resume run
   against the whole file: byte-identical; again with --time-fold 4;
11. [profile]: the CLI with --profile-dir: the trace names the DC and
   banded kernels;

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
    """Tensor-core operations of K2's 3xTF32 products: three m16n8k8
    products per 8x8 block of every column tile's span, two planes (four
    products with complex taps), 2 operations per multiply-add."""
    planes = 4 if band.taps_i is not None else 2
    return 3 * 2 * planes * channels * nb * band.n_tiles * 8 * band.span


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


def cs16_iq(wire: np.ndarray) -> np.ndarray:
    w = wire.astype(np.float64).reshape(-1, 2) / 32768.0
    return w[:, 0] + 1j * w[:, 1]


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
    from iq_tool_tpu_torch.ops import _build, kernels
    from iq_tool_tpu_torch.pipeline.chain import Chain, ChainConfig
    # the measured chains and their seeded tone, shared with the profiler
    from iq_tool_tpu_torch.profile_steps import (
        BLOCK, CHANNELS as CH, GATHER_RATE, GATHER_TONE_HZ, IN_RATE, OUT_RATE,
        POST_SHIFT_HZ, SEED, SHIFT_HZ, TONE_HZ, config, make_chain, to_cu8, tone_wire)

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
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say(f"[build] {line.strip()}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def nrsc5(block):
        return ChainConfig(input_format="cu8", output_format="cu8",
                           input_rate=2_400_000.0, target_rate=OUT_RATE,
                           dc_block=True, target_block=block)

    def time_pair(run_kernel, run_twin, reps=5, run_library=None):
        """(kernel ms, twin ms) per call, interleaved twin, kernel,
        kernel, twin after one warm-up of each; with ``run_library`` also
        its ms, timed in the same turns (twin, library, kernel, kernel,
        library, twin).  A spin kernel ahead of each run lets the host
        queue all its launches first, so the events time the card, not
        the wrappers' host code."""
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
        fns = [run_twin] + ([run_library] if run_library else []) + [run_kernel]
        for fn in fns:
            fn()
        torch.cuda.synchronize()
        first = [timed(fn) for fn in fns]
        second = [timed(fn) for fn in reversed(fns)][::-1]
        ms = [(x + y) / 2 for x, y in zip(first, second)]
        if run_library:
            return ms[2], ms[0], ms[1]
        return ms[1], ms[0]

    def max_abs(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    def launch_counts():
        return {"K1": kernels.banded_apply_dc.launches,
                "K2": kernels.banded_apply.launches,
                "K3": kernels.dc_block_apply.launches,
                "K4": kernels.post_apply.launches,
                "K5": kernels.osfft_apply.launches,
                "AGC": kernels.rms_gains.launches,
                "IQ": kernels.iq_descent.launches,
                "K1pro": kernels.dc_prologue.launches}

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
    torch.cuda.synchronize()
    snrs = [snr_db(w.cpu().numpy(), g.cpu().numpy()) for w, g in
            zip((*want[0], want[1], want[2], want[3]), (*got[0], got[1], got[2], got[3]))]
    k1_err = max_abs((*want[0], *want[1:]), (*got[0], *got[1:]))
    say(f"[k1] C={CH} n={BLOCK} s={st0.stride} hist={st0.hist} G={st0.band.g} "
        f"K={st0.band.k}: SNR planar {snrs[0]:.1f}/{snrs[1]:.1f} dB, tail "
        f"{snrs[2]:.1f}/{snrs[3]:.1f} dB, dc state {snrs[4]:.1f} dB, "
        f"max |err| {k1_err:.3e}")
    if min(snrs) < 100.0:
        fail(f"K1 disagrees with its twin: min SNR {min(snrs):.1f} dB < 100 dB")
    k1_ms, k1_plain = time_pair(lambda: kernels.banded_apply_dc(*k1_args),
                                lambda: kernels.banded_apply_dc_ref(*k1_args))
    nb0 = BLOCK // st0.stride
    fl0 = 4 * CH * nb0 * st0.band.g * st0.band.k
    # wire, states and DC state in; planes, tails and DC state out
    k1_bytes = CH * (4 * BLOCK + 2 * (16 + 8 * st0.hist)) + CH * nb0 * st0.band.g * 8
    k1_bound = bound(k1_bytes, tf32x3_ops(st0.band, CH, nb0), PEAK_TF32_S)
    say(f"[k1] kernel {k1_ms:.3f} ms, twin {k1_plain:.3f} ms; band product "
        f"{fl0 / 1e9:.2f} GFLOP -> {fl0 / k1_ms / 1e9:.2f} TFLOP/s; bound "
        f"{k1_bound[0]:.4f} ms ({k1_bound[1]}: {k1_bytes / 1e6:.1f} MB, "
        f"{tf32x3_ops(st0.band, CH, nb0) / 1e9:.2f} GFLOP of 3xTF32) -> "
        f"{100 * k1_bound[0] / k1_ms:.1f}% of bound")
    report["K1"] = dict(err=k1_err, ms=k1_ms, plain=k1_plain, lib=None, bound=k1_bound)

    # K1's DC prologue alone (the DC kernel's grid of (tiles, C) CTAs),
    # and two launches on the same input compared bit for bit
    pro_args = (wire, dc_st, big.dc_alpha, st0.hist, norm, 1.0, big.dtheta_pre, phase0)
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
        f"{100 * frac:.4f}% of samples")
    if s_k2 < 100.0 or int(dcode.max()) > 1 or frac > 0.01:
        fail("K2 disagrees with its twin at the flagship stage-1 shape")
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
    say(f"[k2] packed kernel {k2_ms:.3f} ms, twin {k2_plain:.3f} ms, one matmul "
        f"{k2_lib:.3f} ms; band product {fl1 / 1e9:.2f} GFLOP -> "
        f"{fl1 / k2_ms / 1e9:.2f} TFLOP/s; bound {k2_bound[0]:.4f} ms "
        f"({k2_bound[1]}: {k2_bytes / 1e6:.1f} MB, {k2_ops / 1e9:.2f} GFLOP of "
        f"3xTF32) -> {100 * k2_bound[0] / k2_ms:.1f}% of bound")
    report["K2"] = dict(err=k2_err, ms=k2_ms, plain=k2_plain, lib=k2_lib, bound=k2_bound)
    del ext1
    del got, want, planar, planar_ref, packed, packed_ref, wire

    # K2 at the strides the TPU sent to XLA
    for label, cfg, idx in (("flagship@16384 stage 1", config("flagship", 1, 16384), 1),
                            ("nrsc5@16384 stage 0", nrsc5(16384), 0),
                            ("nrsc5@16384 stage 1", nrsc5(16384), 1)):
        st = Chain(cfg, device=dev).resampler.stages[idx]
        n = (BLOCK // st.stride) * st.stride
        xr, xi = (0.2 * torch.randn((CH, n), generator=gen, device=dev)
                  for _ in range(2))
        sr, si = (0.2 * torch.randn((CH, st.hist), generator=gen, device=dev)
                  for _ in range(2))
        args = (sr, si, xr, xi, st.band, None, st.stride, st.hist)
        before = kernels.banded_apply.launches
        g_ = kernels.banded_apply(*args)
        w_ = kernels.banded_apply_ref(*args)
        gp = kernels.banded_apply(*args, pack_fmt="cs16")
        wp = kernels.banded_apply_ref(*args, pack_fmt="cs16")
        torch.cuda.synchronize()
        if kernels.banded_apply.launches != before + 2:
            fail(f"K2 did not launch at stride {st.stride}")
        s_ = min(snr_db(w.cpu().numpy(), g.cpu().numpy()) for w, g in zip(w_, g_))
        (gi, gq), (wi, wq) = codes(gp), codes(wp)
        dcode = torch.maximum((gi - wi).abs(), (gq - wq).abs())
        frac = float((dcode > 0).float().mean())
        ms, plain = time_pair(lambda: kernels.banded_apply(*args),
                              lambda: kernels.banded_apply_ref(*args))
        say(f"[k2] {label}: s={st.stride} hist={st.hist} G={st.band.g} "
            f"K={st.band.k} n={n}: SNR {s_:.1f} dB, packed cs16 max |dcode| "
            f"{int(dcode.max())} on {100 * frac:.4f}% of samples; planar kernel "
            f"{ms:.3f} ms, twin {plain:.3f} ms")
        if s_ < 100.0 or int(dcode.max()) > 1 or frac > 0.01:
            fail(f"K2 disagrees with its twin at stride {st.stride}")
        del g_, w_, gp, wp

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
                "K1pro": kernels.dc_prologue.launches}
    step_ms = ev[0].elapsed_time(ev[1]) / (STEPS - 2)
    peak = torch.cuda.max_memory_allocated()
    msps = CH * BLOCK / (step_ms / 1e3) / 1e6
    say(f"[slice] {STEPS} steps of {CH} x {BLOCK}: launches {launches}, "
        f"{step_ms:.3f} ms/step over steps 3-{STEPS} -> {msps:.1f} Msps in, "
        f"peak device memory {peak / 2 ** 20:.1f} MiB")
    if launches != {"K1": STEPS, "K2": STEPS, "K1pro": STEPS}:
        fail(f"launch counters {launches}, expected {STEPS} each")
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

    # the I/Q estimator's descent on the spectra of config #4's tap: the
    # block's first 1024 DC-blocked samples, here a tone behind a 1 % / 0.01
    # rad imbalance in the estimator's band
    m = 1024
    kk = torch.arange(m, device=dev, dtype=torch.float64)
    ph = 2 * np.pi * 0.07 * kk[None, :] + torch.arange(CH, device=dev)[:, None]
    xr_, xi_ = 0.4 * torch.cos(ph), 0.4 * torch.sin(ph)
    seg_ = torch.complex((xr_ * 1.01).float(), (xi_ + 0.01 * xr_).float())
    base, image = iq_balance._spectra(seg_)
    f0 = torch.zeros((CH, 2), device=dev)
    got = kernels.iq_descent(base, image, f0)
    want = kernels.iq_descent_ref(base, image, f0)
    torch.cuda.synchronize()
    iq_err = max_abs(want, got)
    moves = float((got[0] - want[0]).abs().max()) / 1e-4
    say(f"[iq] C={CH} nfft {m}, 25 passes: factors within {moves:.2f} moves of the "
        f"twin, max |err| {iq_err:.3e} (factors and gate dB)")
    if moves > 2.001:
        fail(f"I/Q descent kernel parts from its twin by {moves:.2f} moves (> 2)")
    iq_ms, iq_plain = time_pair(lambda: kernels.iq_descent(base, image, f0),
                                lambda: kernels.iq_descent_ref(base, image, f0), reps=3)
    # spectra in, factors and gate out; 25 passes x 4 moves x both sides of
    # the band, ~24 operations a bin (complex product, hypot, log10)
    lo, hi = iq_balance.band_edges(m)
    iq_bound = bound(CH * (2 * m * 8 + 8 + 12), CH * 25 * 4 * 2 * (hi - lo) * 24,
                     PEAK_FP32_S)
    say(f"[iq] kernel {iq_ms:.3f} ms, twin (25 passes of tensor ops) {iq_plain:.3f} "
        f"ms; bound {iq_bound[0]:.5f} ms ({iq_bound[1]})")
    report["IQ"] = dict(err=iq_err, ms=iq_ms, plain=iq_plain, lib=None, bound=iq_bound)

    # ------------------------------------------------- 6. the general step
    def run_general(name, steps):
        """Config `name` at CH x BLOCK for `steps` steps; returns the
        launch counts, and checks output against the CPU twin chain."""
        cfg = config(name)
        label = {"4": "[full]", "4k32": "[full32k]"}.get(name, f"[config{name}]")
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
        say(f"{label} {steps} steps of {CH} x {BLOCK}: launches {counts}, "
            f"{step_ms:.3f} ms/step over steps 3-{steps} -> "
            f"{CH * BLOCK / (step_ms / 1e3) / 1e6:.1f} Msps in, peak device "
            f"memory {peak / 2 ** 20:.1f} MiB")
        if "iq" in carry:
            # the I/Q estimator runs masked every step (no host sync):
            # its cost per step, alone
            m = 1024
            sr_, si_ = (torch.randn((CH, m), generator=gen, device=dev) for _ in range(2))
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            iq_balance.maybe_update_planar(sr_, si_, carry["iq"], ch_.iq_interval,
                                           advance_samples=BLOCK)
            e0.record()
            for _ in range(3):
                iq_balance.maybe_update_planar(sr_, si_, carry["iq"], ch_.iq_interval,
                                               advance_samples=BLOCK)
            e1.record()
            torch.cuda.synchronize()
            say(f"{label} masked I/Q estimator: {e0.elapsed_time(e1) / 3:.3f} "
                f"ms per step")
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
        if name in ("4", "4k32"):
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
    want_counts = {"K1": 0, "K2": 2 * STEPS, "K3": STEPS, "K4": STEPS,
                   "K5": STEPS, "AGC": STEPS, "IQ": STEPS, "K1pro": 0}
    if general_launches != want_counts:
        fail(f"config #4 launch counters {general_launches}, expected {want_counts}")
    s5 = run_general("5", GENERAL_STEPS)
    if s5 != {"K1": 0, "K2": 2 * GENERAL_STEPS, "K3": GENERAL_STEPS,
              "K4": GENERAL_STEPS, "K5": 0, "AGC": GENERAL_STEPS, "IQ": 0,
              "K1pro": 0}:
        fail(f"config #5 launch counters {s5}")
    s3 = run_general("3", GENERAL_STEPS)
    if s3 != {"K1": 0, "K2": 3 * GENERAL_STEPS, "K3": GENERAL_STEPS,
              "K4": 0, "K5": 0, "AGC": 0, "IQ": 0, "K1pro": 0}:
        fail(f"config #3 launch counters {s3}")
    s4k = run_general("4k32", GENERAL_STEPS)
    if s4k != {"K1": 0, "K2": 2 * GENERAL_STEPS, "K3": GENERAL_STEPS,
               "K4": GENERAL_STEPS, "K5": GENERAL_STEPS, "AGC": GENERAL_STEPS,
               "IQ": GENERAL_STEPS, "K1pro": 0}:
        fail(f"config #4 at nfft 32768 launch counters {s4k}")
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
        f"launches {g_counts}, {g_ms:.3f} ms/step over steps 2-{GATHER_STEPS} -> "
        f"{CH * n_g / (g_ms / 1e3) / 1e6:.1f} Msps in, peak device memory "
        f"{peak / 2 ** 20:.1f} MiB ({(peak - base_mem) / 2 ** 20:.1f} MiB above the "
        f"{base_mem / 2 ** 20:.1f} MiB held before the run, the input stream included)")
    want_g = {k: 0 for k in g_counts}
    want_g.update(K3=GATHER_STEPS, K4=GATHER_STEPS, AGC=GATHER_STEPS)
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
    # the gather stage alone (weighted bag sums): timed, twice on the same
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
        f"weighted bag sums): {gs_ms:.3f} ms; against its definition in float64 "
        f"{db_g:.1f} dB; two runs {'bit-identical' if same_g else 'differ'}")
    if db_g < 100.0 or not same_g:
        fail(f"[gather] the stage is {db_g:.1f} dB from its definition (>= 100 dB) "
             f"and two runs {'agree' if same_g else 'differ'} (bit for bit)")
    del stream, outs, carry, gch, twin, ext_g, def_g, again, yr_g, yi_g, xr_g, xi_g

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
            f"first {skip // 2} frames; launches per folded step "
            f"{ {k: v / 3 for k, v in fc_counts.items() if v} }")
        if d_twin > 4:
            fail(f"[fold] {label}: the card's fold differs from its CPU twin by "
                 f"{d_twin} codes (> 4)")
        if snr_f < 60.0 or np.abs(diff).max() > 32:
            fail(f"[fold] {label}: the fold leaves its contract (>= 60 dB, <= 32 codes)")
        if any(fc_counts[k] == 0 for k in (("K1", "K1pro", "K2") if cname == "c1"
                                            else ("K2", "K3", "K4", "K5", "AGC", "IQ"))):
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
    if counts != {"K1": 1, "K2": 1, "K1pro": 1}:
        fail(f"[shard] 1x1 flagship launches per step {counts}")
    shard_report["1x1 flagship"] = counts
    want_counts = {
        ("flagship", 1, 4): {"K2": 8, "K3": 4, "K1pro": 4},
        ("4", 1, 4): {"K2": 8, "K3": 8, "K4": 4, "K5": 4, "IQ": 1, "AGCenergy": 4,
                      "AGCchain": 1},
        ("flagship", 2, 2): {"K2": 8, "K3": 4, "K1pro": 4}}
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
    # energies and gains in and out, ~12 float operations a segment on
    # one thread's chain
    chain_bound = bound(c_g * (8 * n_seg_g + 16), c_g * n_seg_g * 12, PEAK_FP32_S)
    say(f"[shard] the AGC chain over the gathered energies ({c_g} x {n_seg_g}): max "
        f"relative error {chain_rel:.3e} from rms_scan_ref; kernel {chain_ms:.4f} ms, twin "
        f"{chain_plain:.3f} ms; bound {chain_bound[0]:.5f} ms ({chain_bound[1]})")
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
    say(f"[cli] {frames} frames in, {out.size // 2} out (want {want_frames}), "
        f"tone SNR {snr_c:.1f} dB after 1 s, wall {wall:.2f} s")
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
    say(f"[cli] general flags: {frames} frames in, {out.size // 2} out (want "
        f"{want_frames}), tone at {tone_g:.4f} Hz: SNR {snr_g:.1f} dB after 1 s, wall "
        f"{wall:.2f} s")
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
    for fold in ("1", "4"):
        fl = flags + ["--time-fold", fold]
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
    say(f"[ckpt] launches over the 6 runs: {ck_counts}")
    if not all(ck_counts[k] for k in ("K1", "K1pro", "K2")):
        fail(f"[ckpt] the CLI runs did not launch the flagship's kernels: {ck_counts}")

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
    n_k = sum(1 for e in events if e.get("cat") == "kernel")
    say(f"[profile] {os.path.basename(traces[0])}: {os.path.getsize(traces[0]) / 2 ** 20:.1f} "
        f"MiB, {len(events)} events, {n_k} kernel launches; the chain's kernels in it: {kern}")
    if not (any("dc_kernel" in k for k in kern) and any("banded_kernel" in k for k in kern)):
        fail("[profile] the trace does not name the DC and banded kernels")
    for p_ in (inp, half, full, part, ck, traces[0]):
        os.remove(p_)

    # ------------------------------------------------------------ result
    src = {"K1": "iq_tool_tpu_torch/csrc/banded_dc.cu",
           "K2": "iq_tool_tpu_torch/csrc/banded.cu",
           "K3": "iq_tool_tpu_torch/csrc/banded_dc.cu",
           "K4": "iq_tool_tpu_torch/csrc/post.cu",
           "K5": "iq_tool_tpu_torch/csrc/osfft.cu",
           "AGC": "iq_tool_tpu_torch/csrc/post.cu",
           "IQ": "iq_tool_tpu_torch/csrc/iq_est.cu",
           "K1pro": "iq_tool_tpu_torch/csrc/banded_dc.cu",
           "AGCenergy": "iq_tool_tpu_torch/csrc/post.cu",
           "AGCchain": "iq_tool_tpu_torch/csrc/post.cu"}
    rep = {"K1": "iq_tool_tpu/ops/pallas_kernels.py:772",
           "K2": "iq_tool_tpu/ops/pallas_kernels.py:492",
           "K3": "iq_tool_tpu/ops/pallas_kernels.py:1121",
           "K4": "iq_tool_tpu/ops/pallas_kernels.py:1506",
           "K5": "iq_tool_tpu/ops/pallas_kernels.py:1324",
           "AGC": "iq_tool_tpu/ops/agc.py:116",
           "IQ": "iq_tool_tpu/ops/iq_balance.py:147",
           "K1pro": "iq_tool_tpu/ops/pallas_kernels.py:772",
           "AGCenergy": "iq_tool_tpu/parallel/sharded.py:271",
           "AGCchain": "iq_tool_tpu/ops/agc.py:78"}
    # K1/K1pro/K2 launches from the flagship slice, the rest from config
    # #4's run, K5 at nfft 32768 from the [full32k] run, K3 on cu8 from
    # config #3's; and each phase's launches per step
    counts = {**general_launches, **launches, "K5@32768": s4k["K5"], "K3@cu8": s3["K3"],
              **{k: int(shard_report["1x4 config #4"][k] * SHARD_STEPS)
                 for k in ("AGCenergy", "AGCchain")}}
    src["K5@32768"], rep["K5@32768"] = src["K5"], rep["K5"]
    src["K3@cu8"], rep["K3@cu8"] = src["K3"], rep["K3"]
    phases = {"flagship": (dict(launches, K3=0, K4=0, K5=0, AGC=0, IQ=0), STEPS),
              "#4": (general_launches, STEPS), "#4@32768": (s4k, GENERAL_STEPS),
              "#5": (s5, GENERAL_STEPS), "#3": (s3, GENERAL_STEPS),
              "gather": (g_counts, GATHER_STEPS),
              "fold flagship C=1 F=8": (fold_counts["flagship"], 3),
              "fold #4 C=1 F=8": (fold_counts["config #4"], 3),
              **{f"shard {k}": (v, 1) for k, v in shard_report.items()}}
    say(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src[k], "replaces": rep[k],
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
