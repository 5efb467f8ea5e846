#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (iq_tool_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the checkout around this file.  One line per
phase, exits non-zero at the first failure:

1. card: nvidia-smi name and power limit, torch and CUDA versions;
2. build: nvcc compiles the kernels from csrc/ (registers, spills);
3. kernels vs their plain twins on the card, at the flagship shapes
   (K1 stage 0, K2 stage 1 packed) and at the strides 224, 400 and 144,
   each timed twin, kernel, kernel, twin with CUDA events;
4. the slice: the flagship Chain (128 channels x 262144 frames) for 6
   steps; both launch counters must read 6; output against the CPU twin
   chain on 2 channels and a tone SNR check; steady-state Msps and peak
   device memory;
5. the general step's kernels vs their twins at BASELINE config #4's
   shapes (128 channels): K3 dc_block_apply, K4 post_apply, K5
   osfft_apply and two helper kernels, the AGC's gain scan and the I/Q
   estimator's descent, timed the same way;
6. the general step: config #4 (DC + I/Q + pre-shift, resampler,
   2175-tap overlap-save notch, post-shift, local AGC) at 128 x 262144
   for 6 steps with exact launch counters, against the CPU twin chain on
   2 channels, tone SNR, ms per step, Msps and peak memory, and the
   masked I/Q estimator's cost per step; then configs #5 and #3 the same
   way at 4 steps;
7. the CLI on a 10 s, 2.048 Msps cs16 tone file: the flagship flags, then
   the general step's (I/Q correction, notch, post-shift, AGC);

then one JSON line per the kernels, the nvidia-smi line, and last
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
SEED = 20261016
CH = 128
BLOCK = 262144
STEPS = 6
IN_RATE, OUT_RATE = 2_048_000.0, 1_488_375.0
TONE_HZ = 37_000.0          # input tone; +100 kHz pre-shift -> 137 kHz out
SHIFT_HZ = 100_000.0
POST_SHIFT_HZ = -50_000.0   # config #4: 37 + 100 - 50 -> 87 kHz out
GENERAL_STEPS = 4           # configs #5 and #3


class _NoJax(importlib.abc.MetaPathFinder):
    """The port must run without jax: refuse it outright."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
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
    from iq_tool_tpu_torch.ops.fir_design import FilterRequest
    from iq_tool_tpu_torch.pipeline.chain import Chain, ChainConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: not available"
    name = torch.cuda.get_device_name(0)
    say(f"[card] {smi_line}")
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
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

    def flagship(channels, block):
        return ChainConfig(input_format="cs16", output_format="cs16",
                           input_rate=IN_RATE, target_rate=OUT_RATE,
                           channels=channels, dc_block=True,
                           freq_shift_pre_hz=SHIFT_HZ,
                           filters=(FilterRequest("lowpass", 400e3),),
                           target_block=block)

    def general(name, channels, block):
        """BASELINE configs #4, #5 and #3 (tools/bench_all.py)."""
        base = dict(input_rate=IN_RATE, target_rate=OUT_RATE,
                    channels=channels, target_block=block, dc_block=True)
        if name == 4:
            return ChainConfig(input_format="cs16", output_format="cs16",
                               iq_correction=True, freq_shift_pre_hz=SHIFT_HZ,
                               freq_shift_post_hz=POST_SHIFT_HZ,
                               filters=(FilterRequest("stop-range", 0.0, 10e3),),
                               agc_profile="local", **base)
        if name == 5:
            return ChainConfig(input_format="cs16", output_format="cs16",
                               freq_shift_pre_hz=SHIFT_HZ,
                               filters=(FilterRequest("lowpass", 400e3),),
                               agc_profile="local", **base)
        return ChainConfig(input_format="cu8", output_format="cs16",
                           filters=(FilterRequest("pass-range", 0.0, 400e3),),
                           filter_method="fft", filter_stage="pre", **base)

    def nrsc5(block):
        return ChainConfig(input_format="cu8", output_format="cu8",
                           input_rate=2_400_000.0, target_rate=OUT_RATE,
                           dc_block=True, target_block=block)

    def make_wire(channels, frames, tone_hz=TONE_HZ):
        """Seeded cs16 wire on the card: a 0.5 tone (channel-dependent
        phase) plus white noise at 1e-4, as (C, 2*frames) int16."""
        n = torch.arange(frames, device=dev, dtype=torch.float64)
        ph = 2 * np.pi * tone_hz / IN_RATE * n[None, :] \
            + torch.arange(channels, device=dev, dtype=torch.float64)[:, None]
        iq = torch.stack([0.5 * torch.cos(ph), 0.5 * torch.sin(ph)], dim=-1)
        iq = iq + 1e-4 * torch.randn(iq.shape, generator=gen, device=dev,
                                     dtype=torch.float64)
        q = torch.clamp(torch.round(iq * 32767.0), -32768, 32767)
        return q.to(torch.int16).reshape(channels, 2 * frames)

    def to_cu8(wire16):
        """The same tone as cu8 codes: (C, 2*frames) uint8."""
        x = wire16.to(torch.float32) / 32767.0
        return torch.clamp(torch.round(x * 127.5 + 127.5), 0, 255).to(torch.uint8)

    def time_pair(run_kernel, run_twin, reps=5):
        """(kernel ms, twin ms) per call, interleaved twin, kernel,
        kernel, twin after one warm-up of each."""
        def timed(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / reps
        run_twin()
        run_kernel()
        torch.cuda.synchronize()
        t1, k1 = timed(run_twin), timed(run_kernel)
        k2, t2 = timed(run_kernel), timed(run_twin)
        return (k1 + k2) / 2, (t1 + t2) / 2

    def max_abs(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    def codes(packed):
        p = packed.to(torch.int64) & 0xFFFFFFFF
        lo, hi = p & 0xFFFF, p >> 16
        return lo - ((lo >> 15) << 16), hi - ((hi >> 15) << 16)

    # --------------------------------------------------- 3. kernels vs twins
    report = {}
    big = Chain(flagship(CH, BLOCK), device=dev)
    st0, st1 = big.resampler.stages
    norm = big.fmt_in.normalizer
    wire = make_wire(CH, BLOCK).view(torch.int32)
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
    say(f"[k1] kernel {k1_ms:.3f} ms, twin {k1_plain:.3f} ms; band product "
        f"{fl0 / 1e9:.2f} GFLOP -> {fl0 / k1_ms / 1e9:.2f} TFLOP/s")
    report["K1"] = (k1_err, k1_ms, k1_plain)

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
    k2_ms, k2_plain = time_pair(
        lambda: kernels.banded_apply(*k2_args, pack_fmt="cs16"),
        lambda: kernels.banded_apply_ref(*k2_args, pack_fmt="cs16"))
    nb1 = x1r.shape[1] // st1.stride
    fl1 = 4 * CH * nb1 * st1.band.g * st1.band.k
    say(f"[k2] packed kernel {k2_ms:.3f} ms, twin {k2_plain:.3f} ms; band "
        f"product {fl1 / 1e9:.2f} GFLOP -> {fl1 / k2_ms / 1e9:.2f} TFLOP/s")
    report["K2"] = (k2_err, k2_ms, k2_plain)
    del got, want, planar, planar_ref, packed, packed_ref, wire

    # K2 at the strides the TPU sent to XLA
    for label, cfg, idx in (("flagship@16384 stage 1", flagship(1, 16384), 1),
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
        torch.cuda.synchronize()
        if kernels.banded_apply.launches != before + 1:
            fail(f"K2 did not launch at stride {st.stride}")
        s_ = min(snr_db(w.cpu().numpy(), g.cpu().numpy()) for w, g in zip(w_, g_))
        ms, plain = time_pair(lambda: kernels.banded_apply(*args),
                              lambda: kernels.banded_apply_ref(*args))
        say(f"[k2] {label}: s={st.stride} hist={st.hist} G={st.band.g} "
            f"K={st.band.k} n={n}: SNR {s_:.1f} dB, kernel {ms:.3f} ms, "
            f"twin {plain:.3f} ms")
        if s_ < 100.0:
            fail(f"K2 disagrees with its twin at stride {st.stride}")

    # ------------------------------------------------------------ 4. slice
    stream = make_wire(CH, STEPS * BLOCK)
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
                "K2": kernels.banded_apply.launches}
    step_ms = ev[0].elapsed_time(ev[1]) / (STEPS - 2)
    peak = torch.cuda.max_memory_allocated()
    msps = CH * BLOCK / (step_ms / 1e3) / 1e6
    say(f"[slice] {STEPS} steps of {CH} x {BLOCK}: launches {launches}, "
        f"{step_ms:.3f} ms/step over steps 3-{STEPS} -> {msps:.1f} Msps in, "
        f"peak device memory {peak / 2 ** 20:.1f} MiB")
    if launches != {"K1": STEPS, "K2": STEPS}:
        fail(f"launch counters {launches}, expected {STEPS} each")
    got_wire = torch.cat(outs, dim=-1).cpu().numpy()
    if got_wire.shape != (2, STEPS * 2 * big.n_out) or got_wire.dtype != np.int16:
        fail(f"chain output {got_wire.shape} {got_wire.dtype}")
    twin = Chain(flagship(2, BLOCK), device="cpu")
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
    from iq_tool_tpu_torch.ops import agc, iq_balance

    g4 = Chain(general(4, CH, BLOCK), device=dev)
    n_out = g4.n_out
    wire = make_wire(CH, BLOCK).view(torch.int32)
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
    say(f"[k3] kernel {k3_ms:.3f} ms, twin {k3_plain:.3f} ms; "
        f"{CH * BLOCK * 12 / k3_ms / 1e6:.1f} GB/s of wire in + planes out")
    report["K3"] = (k3_err, k3_ms, k3_plain)

    # K4 and the AGC scan on config #4's output-rate planes (C, 190512):
    # 1488 segments of 128 and a ragged 48
    pr, pi = (0.3 * torch.randn((CH, n_out), generator=gen, device=dev)
              for _ in range(2))
    n_seg, seg, beta = agc.rms_params(g4.agc_cfg, n_out)
    e_in = torch.mean((pr[:, :n_seg * seg] ** 2 + pi[:, :n_seg * seg] ** 2)
                      .reshape(CH, n_seg, seg), dim=-1).T.contiguous()
    g0 = torch.ones(CH, device=dev)
    e20 = torch.zeros(CH, device=dev)
    scan_args = (e_in, g0, e20, beta, g4.agc_cfg.target)
    got = kernels.rms_scan(*scan_args)
    want = kernels.rms_scan_ref(*scan_args)
    torch.cuda.synchronize()
    agc_rel = max(float(((g - w).abs() / w.abs()).max()) for w, g in zip(want, got))
    agc_err = max_abs(want, got)
    say(f"[agc] {n_seg} segments x {CH} channels: max relative error "
        f"{agc_rel:.3e}, max |err| {agc_err:.3e}")
    if agc_rel > 1e-4:
        fail(f"AGC scan disagrees with its twin: relative error {agc_rel:.3e} > 1e-4")
    agc_ms, agc_plain = time_pair(lambda: kernels.rms_scan(*scan_args),
                                  lambda: kernels.rms_scan_ref(*scan_args), reps=2)
    say(f"[agc] kernel {agc_ms:.3f} ms, twin (a loop of tensor ops) {agc_plain:.3f} ms")
    report["AGC"] = (agc_err, agc_ms, agc_plain)
    gains = got[0].T.contiguous()                        # (C, 1488)
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
    say(f"[k4] kernel {k4_ms:.3f} ms, twin {k4_plain:.3f} ms; "
        f"{CH * n_out * 12 / k4_ms / 1e6:.1f} GB/s of planes in + wire out")
    report["K4"] = (int(dcode.max()), k4_ms, k4_plain)

    filt = g4.post_filter
    b = filt.block
    spec, windows = filt._spectrum(dev), filt._schedule(n_out, dev)
    er, ei = (0.3 * torch.randn((CH, n_out + b), generator=gen, device=dev)
              for _ in range(2))
    k5_args = (er, ei, spec, b)
    got = kernels.osfft_apply(*k5_args, windows=windows)
    want = kernels.osfft_apply_ref(*k5_args, windows=windows)
    torch.cuda.synchronize()
    snrs = [snr_db(w.cpu().numpy(), g.cpu().numpy()) for w, g in zip(want, got)]
    k5_err = max_abs(want, got)
    full = sum(1 for h in windows.heads if h == b // 2)
    say(f"[k5] C={CH} n={n_out} taps {filt.num_taps} nfft {2 * b}: "
        f"{len(windows.starts)} windows ({full} at advance 3b/2, then the "
        f"re-anchored tail): SNR {snrs[0]:.1f}/{snrs[1]:.1f} dB vs torch.fft, "
        f"max |err| {k5_err:.3e}")
    if min(snrs) < 100.0:
        fail(f"K5 disagrees with its twin: min SNR {min(snrs):.1f} dB < 100 dB")
    k5_ms, k5_plain = time_pair(lambda: kernels.osfft_apply(*k5_args, windows=windows),
                                lambda: kernels.osfft_apply_ref(*k5_args, windows=windows))
    say(f"[k5] kernel {k5_ms:.3f} ms, twin (torch.fft) {k5_plain:.3f} ms")
    report["K5"] = (k5_err, k5_ms, k5_plain)
    del got, want, wire, pr, pi, er, ei

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
    say(f"[iq] kernel {iq_ms:.3f} ms, twin (25 passes of tensor ops) {iq_plain:.3f} ms")
    report["IQ"] = (iq_err, iq_ms, iq_plain)

    # ------------------------------------------------- 6. the general step
    def run_general(name, steps):
        """Config `name` at CH x BLOCK for `steps` steps; returns the
        launch counts, and checks output against the CPU twin chain."""
        cfg = general(name, CH, BLOCK)
        label = "[full]" if name == 4 else f"[config{name}]"
        ch_ = Chain(cfg, device=dev)
        stream = make_wire(CH, steps * BLOCK)
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
        counts = {"K1": kernels.banded_apply_dc.launches,
                  "K2": kernels.banded_apply.launches,
                  "K3": kernels.dc_block_apply.launches,
                  "K4": kernels.post_apply.launches,
                  "K5": kernels.osfft_apply.launches,
                  "AGC": kernels.rms_scan.launches,
                  "IQ": kernels.iq_descent.launches}
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
            fail(f"config #{name} output {got_w.shape} {got_w.dtype}")
        twin = Chain(general(name, 2, BLOCK), device="cpu")
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
        if name in (4, 5):
            tone += nco_hz(SHIFT_HZ, IN_RATE)
        if name == 4:
            tone += nco_hz(POST_SHIFT_HZ, OUT_RATE)
        snr_t = tone_snr_db(cs16_iq(got_w[0]), tone, OUT_RATE, 2 * ch_.n_out)
        say(f"{label} vs CPU twin chain (2 channels): max |dcode| {dmax} "
            f"past the first {skip // 2} frames; tone at {tone:.4f} Hz: SNR "
            f"{snr_t:.1f} dB over steps 3-{steps}")
        if dmax > 4:
            fail(f"config #{name} differs from its CPU twin by {dmax} codes (> 4)")
        # cu8 input: the 8-bit codes alone hold the tone to ~48 dB
        need = 40.0 if cfg.input_format == "cu8" else 60.0
        if snr_t < need:
            fail(f"config #{name} tone SNR {snr_t:.1f} dB < {need:.0f} dB")
        return counts

    general_launches = run_general(4, STEPS)
    want_counts = {"K1": 0, "K2": 2 * STEPS, "K3": STEPS, "K4": STEPS,
                   "K5": STEPS, "AGC": STEPS, "IQ": STEPS}
    if general_launches != want_counts:
        fail(f"config #4 launch counters {general_launches}, expected {want_counts}")
    s5 = run_general(5, GENERAL_STEPS)
    if s5 != {"K1": 0, "K2": 2 * GENERAL_STEPS, "K3": GENERAL_STEPS,
              "K4": GENERAL_STEPS, "K5": 0, "AGC": GENERAL_STEPS, "IQ": 0}:
        fail(f"config #5 launch counters {s5}")
    s3 = run_general(3, GENERAL_STEPS)
    if s3 != {"K1": 0, "K2": 3 * GENERAL_STEPS, "K3": GENERAL_STEPS,
              "K4": 0, "K5": 0, "AGC": 0, "IQ": 0}:
        fail(f"config #3 launch counters {s3}")

    # -------------------------------------------------------------- 7. CLI
    work = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    inp, outp = os.path.join(work, "tone_in.cs16"), os.path.join(work, "out.cs16")
    frames = int(10 * IN_RATE)
    make_wire(1, frames).cpu().numpy().tofile(inp)
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
    make_wire(1, frames, tone_hz=TONE_HZ + SHIFT_HZ).cpu().numpy().tofile(inp)
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

    # ------------------------------------------------------------ result
    src = {"K1": "iq_tool_tpu_torch/csrc/banded_dc.cu",
           "K2": "iq_tool_tpu_torch/csrc/banded.cu",
           "K3": "iq_tool_tpu_torch/csrc/banded_dc.cu",
           "K4": "iq_tool_tpu_torch/csrc/post.cu",
           "K5": "iq_tool_tpu_torch/csrc/osfft.cu",
           "AGC": "iq_tool_tpu_torch/csrc/post.cu",
           "IQ": "iq_tool_tpu_torch/csrc/iq_est.cu"}
    rep = {"K1": "iq_tool_tpu/ops/pallas_kernels.py:772",
           "K2": "iq_tool_tpu/ops/pallas_kernels.py:492",
           "K3": "iq_tool_tpu/ops/pallas_kernels.py:1121",
           "K4": "iq_tool_tpu/ops/pallas_kernels.py:1506",
           "K5": "iq_tool_tpu/ops/pallas_kernels.py:1324",
           "AGC": "iq_tool_tpu/ops/agc.py:78",
           "IQ": "iq_tool_tpu/ops/iq_balance.py:147"}
    # K1/K2 launches from the flagship slice, the rest from config #4's run
    counts = {**general_launches, **launches}
    say(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src[k], "replaces": rep[k],
         "launches": counts[k], "max_abs_err": report[k][0],
         "ms": report[k][1], "plain_ms": report[k][2]} for k in src]}))
    say(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
