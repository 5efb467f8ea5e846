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
5. the CLI on a 10 s, 2.048 Msps cs16 tone file;

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

    def nrsc5(block):
        return ChainConfig(input_format="cu8", output_format="cu8",
                           input_rate=2_400_000.0, target_rate=OUT_RATE,
                           dc_block=True, target_block=block)

    def make_wire(channels, frames):
        """Seeded cs16 wire on the card: a 0.5 tone (channel-dependent
        phase) plus white noise at 1e-4, as (C, 2*frames) int16."""
        n = torch.arange(frames, device=dev, dtype=torch.float64)
        ph = 2 * np.pi * TONE_HZ / IN_RATE * n[None, :] \
            + torch.arange(channels, device=dev, dtype=torch.float64)[:, None]
        iq = torch.stack([0.5 * torch.cos(ph), 0.5 * torch.sin(ph)], dim=-1)
        iq = iq + 1e-4 * torch.randn(iq.shape, generator=gen, device=dev,
                                     dtype=torch.float64)
        q = torch.clamp(torch.round(iq * 32767.0), -32768, 32767)
        return q.to(torch.int16).reshape(channels, 2 * frames)

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

    # -------------------------------------------------------------- 5. CLI
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

    # ------------------------------------------------------------ result
    src = {"K1": "iq_tool_tpu_torch/csrc/banded_dc.cu",
           "K2": "iq_tool_tpu_torch/csrc/banded.cu"}
    rep = {"K1": "iq_tool_tpu/ops/pallas_kernels.py:772",
           "K2": "iq_tool_tpu/ops/pallas_kernels.py:492"}
    say(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src[k], "replaces": rep[k],
         "launches": launches[k], "max_abs_err": report[k][0],
         "ms": report[k][1], "plain_ms": report[k][2]} for k in ("K1", "K2")]}))
    say(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
