"""The chains the port is measured on, and where a step's time goes on
the card.

    python -m iq_tool_tpu_torch.profile_steps [--configs flagship 4 5 3 4k32 c1 c1f8 4c1 4c1f8 gather
                                                         flagship@1x4 4@1x4 flagship@2x2]

``config``, ``make_chain`` and ``tone_wire`` are the one definition of
the measured chains and their seeded input; ``chip_smoke.py`` runs the
same.  Run as a module, for each configuration (128 channels x 262144
frames a step; "c1" and "4c1" the flagship and config #4 as one stream
at the CLI's default 16384-frame block, "f8" with --time-fold 8;
"gather" 128 x 254597 through the gather stage; "<name>@<C>x<T>" the
ShardedChain of <name> on a C x T mesh repeating the card, each shard a
128 / C x 262144 block): 3 warm-up steps, then 8 steps timed by the host clock (ending in a
synchronize), then 8 more under ``torch.profiler``.  Prints per
configuration the wall ms per step, the device's busy ms per step and
launches per step (kernels and copies, from the profiler's device
events), the idle share (1 - busy / unprofiled wall time) and the
kernels by device time.  Each step's block is a contiguous device
tensor, as the host engine hands it over.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import time

import numpy as np
import torch

from iq_tool_tpu_torch.ops.fir_design import FilterRequest
from iq_tool_tpu_torch.pipeline.chain import Chain, ChainConfig

SEED = 20261016
CHANNELS = 128
BLOCK = 262144
STEPS = 8
IN_RATE, OUT_RATE = 2_048_000.0, 1_488_375.0
TONE_HZ = 37_000.0          # input tone; +100 kHz pre-shift -> 137 kHz out
SHIFT_HZ = 100_000.0
POST_SHIFT_HZ = -50_000.0   # config #4: 37 + 100 - 50 -> 87 kHz out
GATHER_RATE = 25_282.56     # 2469/200000 of 2.048 Msps -> 449/36371: the gather stage
GATHER_TONE_HZ = 3_000.0
STREAM_BLOCK = 16384        # the CLI's default --block-size
CONFIGS = ("flagship", "4", "5", "3", "4k32", "c1", "c1f8", "4c1", "4c1f8", "gather",
           "flagship@1x4", "4@1x4", "flagship@2x2")


def config(name: str, channels: int = CHANNELS, block: int = BLOCK) -> ChainConfig:
    """The flagship chain (bench.py) and BASELINE configs #3-#5
    (tools/bench_all.py); "4k32" is #4 with --filter-fft-size 32768."""
    base = dict(input_rate=IN_RATE, target_rate=OUT_RATE, channels=channels,
                target_block=block, dc_block=True, output_format="cs16")
    if name == "flagship":
        return ChainConfig(input_format="cs16", freq_shift_pre_hz=SHIFT_HZ,
                           filters=(FilterRequest("lowpass", 400e3),), **base)
    if name in ("4", "4k32"):
        return ChainConfig(input_format="cs16", iq_correction=True,
                           freq_shift_pre_hz=SHIFT_HZ, freq_shift_post_hz=POST_SHIFT_HZ,
                           filters=(FilterRequest("stop-range", 0.0, 10e3),),
                           filter_fft_size=32768 if name == "4k32" else None,
                           agc_profile="local", **base)
    if name == "5":
        return ChainConfig(input_format="cs16", freq_shift_pre_hz=SHIFT_HZ,
                           filters=(FilterRequest("lowpass", 400e3),),
                           agc_profile="local", **base)
    if name == "3":
        return ChainConfig(input_format="cu8",
                           filters=(FilterRequest("pass-range", 0.0, 400e3),),
                           filter_method="fft", filter_stage="pre", **base)
    if name == "gather":
        return ChainConfig(input_format="cs16", agc_profile="local",
                           **{**base, "target_rate": GATHER_RATE})
    raise ValueError(f"unknown configuration {name!r}")


def make_chain(name: str, device="cuda"):
    """The chain a profile name stands for: a CONFIGS name, "c1"/"4c1"
    the flagship/config #4 as one stream at STREAM_BLOCK frames a row,
    with "f<F>" a FoldedChain of F rows, "<name>@<C>x<T>" a ShardedChain
    on a C x T mesh that repeats ``device``."""
    from iq_tool_tpu_torch.parallel.sharded import ShardedChain, make_mesh
    from iq_tool_tpu_torch.pipeline.folded import FoldedChain
    if "@" in name:
        base, mesh = name.split("@")
        c, t = map(int, mesh.split("x"))
        return ShardedChain(config(base), make_mesh([device] * (c * t), c, t))
    base, _, fold = name.partition("f") if name.startswith(("c1", "4c1")) else (name, "", "")
    if base in ("c1", "4c1"):
        cfg = config("flagship" if base == "c1" else "4", 1, STREAM_BLOCK)
        return FoldedChain(cfg, int(fold or 1), device=device)
    return Chain(config(name), device=device)


def tone_wire(channels: int, frames: int, gen: torch.Generator,
              tone_hz: float = TONE_HZ) -> torch.Tensor:
    """Seeded cs16 wire on gen's device: a 0.5 tone (channel-dependent
    phase) plus white noise at 1e-4, as (C, 2*frames) int16."""
    dev = gen.device
    n = torch.arange(frames, device=dev, dtype=torch.float64)
    ph = (2 * np.pi * tone_hz / IN_RATE * n[None, :]
          + torch.arange(channels, device=dev, dtype=torch.float64)[:, None])
    iq = torch.stack([0.5 * torch.cos(ph), 0.5 * torch.sin(ph)], dim=-1)
    iq = iq + 1e-4 * torch.randn(iq.shape, generator=gen, device=dev, dtype=torch.float64)
    q = torch.clamp(torch.round(iq * 32767.0), -32768, 32767)
    return q.to(torch.int16).reshape(channels, 2 * frames)


def to_cu8(wire16: torch.Tensor) -> torch.Tensor:
    """The same tone as cu8 codes: (C, 2*frames) uint8."""
    x = wire16.to(torch.float32) / 32767.0
    return torch.clamp(torch.round(x * 127.5 + 127.5), 0, 255).to(torch.uint8)


def profile(name: str) -> dict:
    dev = torch.device("cuda")
    chain = make_chain(name, dev)
    cfg, n = chain.cfg, chain.n_in
    n_blocks = 3 + 2 * STEPS
    # a sharded step's block is T times a chain's: its stream repeats 4
    # blocks, so the input stays as large as the unsharded chains'
    distinct = n_blocks if cfg.channels * n <= CHANNELS * BLOCK else 4
    wire = tone_wire(cfg.channels, distinct * n, torch.Generator(device=dev).manual_seed(SEED),
                     GATHER_TONE_HZ if name == "gather" else TONE_HZ)
    if cfg.input_format == "cu8":
        wire = to_cu8(wire)
    parts = [wire[:, k * 2 * n:(k + 1) * 2 * n].contiguous() for k in range(distinct)]
    blocks = iter([parts[k % distinct] for k in range(n_blocks)])
    del wire
    carry = chain.init_carry()

    def step():
        nonlocal carry
        carry, _ = chain.step(carry, next(blocks))

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name][0] += ev.time_range.elapsed_us() / 1e3
            by_name[ev.name][1] += 1
    busy_ms = sum(v[0] for v in by_name.values())
    launches = sum(v[1] for v in by_name.values())
    return dict(name=name, wall_ms=wall_ms, busy_ms=busy_ms / STEPS,
                launches=launches / STEPS,
                idle=1 - busy_ms / STEPS / wall_ms if busy_ms else None,
                kernels=sorted(((k, v[0] / STEPS, v[1] / STEPS) for k, v in by_name.items()),
                               key=lambda r: -r[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", nargs="+", default=list(CONFIGS), choices=CONFIGS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_steps needs a CUDA card")
    print(f"device {torch.cuda.get_device_name(0)}, torch {torch.__version__}")
    for name in args.configs:
        r = profile(name)
        if r["idle"] is None:
            print(f"[{name}] wall {r['wall_ms']:.3f} ms/step; device time not measured "
                  "(the profiler saw no device events)")
            continue
        print(f"[{name}] wall {r['wall_ms']:.3f} ms/step, device busy {r['busy_ms']:.3f} "
              f"ms/step in {r['launches']:.1f} launches/step, idle share "
              f"{100 * r['idle']:.1f} %")
        for k, ms, n in r["kernels"][:12]:
            print(f"    {ms:8.3f} ms {n:5.1f}x  {k[:100]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
