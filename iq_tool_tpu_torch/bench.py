"""Throughput of the main path on the card: the port's counterpart of the
root ``bench.py`` and ``tools/bench_all.py``.

    python -m iq_tool_tpu_torch.bench [--flagship-only] [--reps 3]

Steps the flagship chain (cs16 -> DC -> +100 kHz -> 2.048 -> 1.488375
Msps -> 400 kHz lowpass -> cs16) and BASELINE's five configs
(``profile_steps.make_configs``) at 128 channels x 262144 frames (#5 at
max(64, channels)) as the engine steps them, one ``GraphedStep`` replay a
block, and times each with CUDA events over K1 = 3 and K2 = 13 replays
queued behind a spin: the difference of the two windows over K2 - K1,
the best of ``--reps`` (the analog of bench.py's two ``lax.scan``
lengths).  The metric counts input complex samples per second.

The baseline is native/baseline/iq_baseline.c (the flagship chain in C,
bench.py's gcc flags, one thread a core of this host), built into
build/iq_tool_tpu_torch/ and cached there for this host.  If gcc or the
run fails, ``vs_baseline`` is null and ``baseline_error`` says why.

The last line of standard output is bench.py's JSON line (``metric``,
``value`` = the flagship's Msps, ``unit``, ``vs_baseline``, ``configs``)
plus ``device``, the card's name and power limit as nvidia-smi gives
them, and ``baseline`` (its Msps, threads and host).  A config that
raises gets ``"error: ..."`` in its slot.  ``--device cpu`` (with
``--channels``/``--block``) runs the same steps on the CPU for the tests:
its numbers are the CPU's, timed by the host clock.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import platform
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from iq_tool_tpu_torch.pipeline.chain import Chain
from iq_tool_tpu_torch.profile_steps import (BASELINE_CONFIGS, BLOCK, CHANNELS, config,
                                             make_configs)

METRIC = "complex Msamples/s/chip (resample+filter chain, input rate)"
K1, K2 = 3, 13
ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build" / "iq_tool_tpu_torch"
BASELINE_SRC = ROOT / "native" / "baseline" / "iq_baseline.c"
GCC_FLAGS = ["-O3", "-march=native", "-ffast-math"]      # bench.py's


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    lines = res.stdout.strip().splitlines()
    if res.returncode != 0 or not lines:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()[:200]}")
    return lines[0]


def measure(cfg, device: str = "cuda", reps: int = 3) -> float:
    """Steady-state input Msps of ``cfg``'s step as the engine runs it (a
    GraphedStep), from the difference of K2 and K1 queued replays."""
    from iq_tool_tpu_torch.pipeline.graphed import GraphedStep
    step = GraphedStep(Chain(cfg, device=device))
    rng = np.random.default_rng(0)
    raw = rng.integers(-2 ** 15, 2 ** 15, (cfg.channels, step.chain.in_wire_len))
    step.input_buffer.copy_(torch.from_numpy(raw.astype(np.int16)
                                             .astype(step.chain.in_wire_dtype)))
    on_cuda = step.device.type == "cuda"
    if on_cuda:
        step.capture()
    carry = step.init_carry()
    for _ in range(2):
        carry, _ = step.step(carry, step.input_buffer)

    def window(k: int) -> float:
        nonlocal carry
        if not on_cuda:
            t0 = time.perf_counter()
            for _ in range(k):
                carry, _ = step.step(carry, step.input_buffer)
            return time.perf_counter() - t0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)           # the windows run queued
        start.record()
        for _ in range(k):
            carry, _ = step.step(carry, step.input_buffer)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3

    per = min((window(K2) - window(K1)) / (K2 - K1) for _ in range(reps))
    if per <= 0:
        raise RuntimeError(f"no time between {K1} and {K2} steps: {per} s")
    return cfg.channels * step.chain.n_in / per / 1e6


def baseline() -> dict:
    """The C baseline's Msps on this host, one thread a core: {"msps",
    "threads", "host"} or {"error"}.  Built and cached in
    build/iq_tool_tpu_torch/ by source, flags, threads and host."""
    threads = os.cpu_count() or 1
    host = f"{platform.node()} {platform.processor() or platform.machine()}"
    key = hashlib.sha256(BASELINE_SRC.read_bytes() + " ".join(GCC_FLAGS).encode()
                         + f"{threads} {host}".encode()).hexdigest()[:16]
    cache = BUILD / f"baseline-{key}.json"
    if cache.exists():
        return json.loads(cache.read_text())
    BUILD.mkdir(parents=True, exist_ok=True)
    binary = BUILD / f"iq_baseline-{key}"
    tmp = BUILD / f"iq_baseline-{key}.{os.getpid()}"
    try:
        if not binary.exists():
            subprocess.run(["gcc", *GCC_FLAGS, "-o", str(tmp), str(BASELINE_SRC),
                            "-lm", "-lpthread"], check=True, capture_output=True,
                           text=True, timeout=120)
            os.replace(tmp, binary)
        out = subprocess.run([str(binary), str(1 << 21), str(threads), "5"],
                             capture_output=True, text=True, check=True, timeout=120)
        msps = float(json.loads(out.stdout.strip().splitlines()[-1])["value"])
    except (OSError, subprocess.SubprocessError, ValueError, KeyError, IndexError) as e:
        detail = getattr(e, "stderr", None) or str(e)
        return {"error": f"{type(e).__name__}: {str(detail).strip()[-300:]}"}
    result = {"msps": msps, "threads": threads, "host": host}
    cache.write_text(json.dumps(result))
    return result


def run(channels: int = CHANNELS, block: int = BLOCK, device: str = "cuda",
        reps: int = 3, flagship_only: bool = False) -> dict:
    """The bench's record: the flagship's Msps and each config's, by
    bench.py's short name (a config that raises: its error)."""
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("the bench runs on a CUDA card (--device cpu for the tests)")
    value = measure(config("flagship", channels, block), device, reps)
    cfgs = {"flagship": value}
    if not flagship_only:
        for name, cfg in make_configs(channels, block).items():
            key = BASELINE_CONFIGS.get(name, (name,))[0]
            try:
                cfgs[key] = measure(cfg, device, reps)
            except Exception as e:     # keep the matrix going
                cfgs[key] = f"error: {type(e).__name__}: {str(e)[:120]}"
    base = baseline()
    line = {"metric": METRIC, "value": value, "unit": "Msamples/s",
            "vs_baseline": value / base["msps"] if "msps" in base else None,
            "configs": cfgs,
            "device": card_line() if device != "cpu" else "cpu",
            "channels": channels, "block": block}
    if "msps" in base:
        line["baseline"] = base
    else:
        line["baseline_error"] = base["error"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--flagship-only", action="store_true",
                    help="the flagship alone, not BASELINE's five configs")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: the tests' lane, at --channels x --block")
    ap.add_argument("--channels", type=int, default=CHANNELS)
    ap.add_argument("--block", type=int, default=BLOCK)
    args = ap.parse_args(argv)
    line = run(args.channels, args.block, args.device, args.reps, args.flagship_only)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
