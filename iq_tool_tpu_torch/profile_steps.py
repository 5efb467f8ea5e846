"""The chains the port is measured on, and where a step's time goes on
the card.

    python -m iq_tool_tpu_torch.profile_steps [--configs flagship 1 2 4 5 3 4k32 4k128 4dx 4dig
                                                         full4 baseline3 c1 c1f8 4c1 4c1f8 gather
                                                         flagship@1x4 4@1x4 flagship@2x2
                                                         flagship@4x1]
                                              [--forms eager graph] [--channels 128]

``config``, ``make_chain`` and ``tone_wire`` are the one definition of
the measured chains and their seeded input; ``chip_smoke.py`` runs the
same.  Run as a module, for each configuration (128 channels, or
``--channels``, x 262144 frames a step; "1" to "5" BASELINE's configs
under bench.py's short names, "4k32" and "4k128" config #4 at
--filter-fft-size 32768 and 131072, "4dx" and "4dig" config #4 with the
dx and digital AGC profiles, "full4" config #4 without the DC block (the
benchmark's full4 chain), "baseline3" config #3 as the benchmark's
baseline3 runs it (an RTL-SDR's cu8 at 2.4 Msps, the DC block, the
102-215 kHz band-pass after the resampler); "c1" and "4c1" the flagship and config #4 as
one stream at the CLI's default 16384-frame block, "f8" with
--time-fold 8; "gather"
128 x 254597 through the gather stage; "hackrf10" the benchmark's HackRF
chain (cs8 at 10 Msps -> 744,187.5 Hz through the gather stage, the
digital AGC; 256,172 frames a step); "<name>@<C>x<T>" the
ShardedChain of <name> on a C x T mesh repeating the card, each shard a
128 / C x 262144 block): 3 warm-up steps, then 40 steps timed by the
host clock (ending in a synchronize; a short window after an idle card
reads slower than the card's steady state), then 8 more under
``torch.profiler``, then 40 more queued behind a spin kernel and timed
by CUDA events: the device's time a step with its queue full (no host
gaps) over the first 8 and over the last 8, when the card has run
without a pause for 32 steps, with the card's SM clock and power draw
sampled by nvidia-smi meanwhile.  Prints per configuration and form the
wall ms per step, the device's busy ms per step, its kernels and copies
per step (from the profiler's device events), the idle share (1 - busy
/ unprofiled wall time), the queued ms per step, the clock and power
and the kernels by device time.

Two forms of a step: "eager", the chain's step over a contiguous device
block a step, as the host engine hands a block to an eager step,
and "graph", the step as one CUDA graph (``pipeline/graphed.py``) over
its input buffer, filled once (a step's work does not depend on its
data), a sharded chain's too; a graph's kernels are held against the
eager step's (the same kernels, plus the graph's memset of the DC
kernel's status words and its copies into its static carry).  In the
graph form ``stage_split`` then splits 8 more profiled replays by the
capture's stage map (``GraphedStep.stages``): each replay's device
events (those of its graph launch, by the launch's correlation id) in
order of start, the k-th to the map's k-th node; a replay whose event
count is not the map's is not split.  It prints ms a replay by stage
(``chain.*``, the AGC's ``chain.agc`` apart from the rest of
``chain.post``, ``graph.carry``), the kernels each stage launches as
the capture noted them (``GraphedStep.stage_kernels``), each stage's
ops, and how far the stages' sum lies from the replay's busy time.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import itertools
import subprocess
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
RTLSDR_RATE = 2_400_000.0   # the RTL-SDR's default rate ("baseline3")
HACKRF_RATE, HACKRF_OUT = 10_000_000.0, 744_187.5   # "hackrf10": 4766/64043
CONFIGS = ("flagship", "1", "2", "4", "5", "3", "4k32", "4k128", "4dx", "4dig", "full4",
           "baseline3", "hackrf10", "c1", "c1f8", "4c1", "4c1f8", "gather", "flagship@1x4",
           "4@1x4",
           "flagship@2x2", "flagship@4x1")
# config #4's variants: --filter-fft-size, --output-agc; "full4" without
# the DC block (the benchmark's full4 chain)
_FULL = {"4": (None, "local"), "4k32": (32768, "local"), "4k128": (131072, "local"),
         "4dx": (None, "dx"), "4dig": (None, "digital"), "full4": (None, "local")}


def config(name: str, channels: int = CHANNELS, block: int = BLOCK) -> ChainConfig:
    """The flagship chain (bench.py), BASELINE configs #1-#5
    (tools/bench_all.py), config #4's variants (``_FULL``) and the
    benchmark's baseline3."""
    base = dict(input_rate=IN_RATE, target_rate=OUT_RATE, channels=channels,
                target_block=block, dc_block=True, output_format="cs16")
    if name == "flagship":
        return ChainConfig(input_format="cs16", freq_shift_pre_hz=SHIFT_HZ,
                           filters=(FilterRequest("lowpass", 400e3),), **base)
    if name == "1":
        return ChainConfig(input_format="cs16", **{**base, "dc_block": False})
    if name == "2":
        return ChainConfig(input_format="cs16", freq_shift_pre_hz=250e3,
                           filters=(FilterRequest("lowpass", 400e3),),
                           **{**base, "dc_block": False})
    if name in _FULL:
        fft_size, profile = _FULL[name]
        return ChainConfig(input_format="cs16", iq_correction=True,
                           freq_shift_pre_hz=SHIFT_HZ, freq_shift_post_hz=POST_SHIFT_HZ,
                           filters=(FilterRequest("stop-range", 0.0, 10e3),),
                           filter_fft_size=fft_size, agc_profile=profile,
                           **{**base, "dc_block": name != "full4"})
    if name == "5":
        return ChainConfig(input_format="cs16", freq_shift_pre_hz=SHIFT_HZ,
                           filters=(FilterRequest("lowpass", 400e3),),
                           agc_profile="local", **base)
    if name == "3":
        return ChainConfig(input_format="cu8",
                           filters=(FilterRequest("pass-range", 0.0, 400e3),),
                           filter_method="fft", filter_stage="pre", **base)
    if name == "baseline3":
        return ChainConfig(input_format="cu8", filters=(FilterRequest("pass-range", 102e3,
                                                                      215e3),),
                           filter_method="fft", **{**base, "input_rate": RTLSDR_RATE})
    if name == "gather":
        return ChainConfig(input_format="cs16", agc_profile="local",
                           **{**base, "target_rate": GATHER_RATE})
    if name == "hackrf10":
        return ChainConfig(input_format="cs8", agc_profile="digital",
                           **{**base, "dc_block": False, "input_rate": HACKRF_RATE,
                              "target_rate": HACKRF_OUT})
    raise ValueError(f"unknown configuration {name!r}")


# BASELINE's five configs: tools/bench_all.py's long names -> bench.py's
# short names (the keys of its "configs") and this module's
BASELINE_CONFIGS = {
    "1: raw cs16 -> resample -> cs16": ("1_raw_resample", "1"),
    "2: wav16 -> shift +250k -> resample -> lowpass": ("2_shift_lowpass", "2"),
    "3: cu8 -> dc -> fft band-pass -> resample -> cs16": ("3_cu8_fft_bandpass", "3"),
    "4: full chain (shift+iq+notch+resample+shift+agc)": ("4_full_notch", "4"),
    "5: 64-channel full chain (DP batch)": ("5_dp_batch", "5"),
}


def make_configs(channels: int = CHANNELS, block: int = BLOCK) -> dict:
    """The five BASELINE configs under tools/bench_all.py's long names
    (``make_configs`` there), #5 at max(64, channels) channels."""
    return {long: config(name, max(64, channels) if name == "5" else channels, block)
            for long, (_, name) in BASELINE_CONFIGS.items()}


def make_chain(name: str, device="cuda", channels: int = CHANNELS):
    """The chain a profile name stands for: a CONFIGS name (``channels``
    streams), "c1"/"4c1" the flagship/config #4 as one stream at
    STREAM_BLOCK frames a row, with "f<F>" a FoldedChain of F rows,
    "<name>@<C>x<T>" a ShardedChain on a C x T mesh that repeats
    ``device``."""
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
    return Chain(config(name, channels), device=device)


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


def to_cs8(wire16: torch.Tensor) -> torch.Tensor:
    """The same tone as cs8 codes: (C, 2*frames) int8."""
    x = wire16.to(torch.float32) / 32767.0
    return torch.clamp(torch.round(x * 128.0), -128, 127).to(torch.int8)


def device_work(prof) -> list:
    """The kineto events of a finished profiler's work on the card
    (kernels, memcpys, memsets): its CUDA events less the card's images of
    host ranges (a span's ``gpu_user_annotation``, which spans its range's
    device work and bears the range's name)."""
    events = prof.profiler.kineto_results.events()
    host = {e.name() for e in events if e.device_type().name != "CUDA"}
    return [e for e in events if e.device_type().name == "CUDA" and e.name() not in host]


def device_events(run, steps: int, attempts: int = 3) -> dict:
    """Run ``run`` ``steps`` times under torch.profiler (CPU and CUDA
    activity, ending in a synchronize): {device event name: [ms,
    launches]} summed over the runs, kernels and copies.  A window in
    which the profiler saw no device event at all (it happened on the
    H100 after a few dozen profiler sessions in one process) is run
    again, up to ``attempts`` windows."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(steps):
                run()
            torch.cuda.synchronize()
        by_name = collections.defaultdict(lambda: [0.0, 0])
        for ev in device_work(prof):
            by_name[ev.name()][0] += ev.duration_ns() / 1e6
            by_name[ev.name()][1] += 1
        if by_name:
            break
    return by_name


def stage_split(step, replays: int = STEPS) -> dict:
    """``replays`` replays of the captured GraphedStep ``step`` under
    torch.profiler (after one more, whose first node the profiler's start
    may miss), split by ``split_launches`` over ``step.stages``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(replays + 1):
            step.step(step._carry, step.input_buffer)
        torch.cuda.synchronize()
    events = [(e.correlation_id(), e.start_ns(), e.duration_ns(), e.name())
              for e in device_work(prof)]
    return split_launches(events, step.stages, skip=1)


def split_launches(events, stages, skip: int = 0) -> dict:
    """Each graph launch's device events split by a stage map: events
    [(launch correlation id, start ns, duration ns, name)], grouped by
    launch, the first ``skip`` launches (by start) left out, each other
    launch's events in order of start, the k-th to the map's k-th node; a
    launch whose event count is not the map's is not split.  Returns
    {replays, split (the launches split), nodes (the map's), events (each
    launch's count), busy_ms (a split launch's busy time, the union of its
    events), sum_ms (their durations' sum), stages {name: ms}, ops {name:
    {op: ms}}}, every ms a split launch."""
    by_launch = collections.defaultdict(list)
    for launch, t0, dur, name in events:
        by_launch[launch].append((t0, dur, name))
    launches = sorted(by_launch.values(), key=min)[skip:]
    names = [name for name, n in stages for _ in range(n)]
    split_stages: dict = {}
    ops: dict = {}
    busy = total = 0.0
    split = 0
    for launch in launches:
        if len(launch) != len(names):
            continue
        split += 1
        end = 0
        for (t0, dur, op), stage in zip(sorted(launch), names):
            busy += min(dur, max(0, t0 + dur - end))
            end = max(end, t0 + dur)
            total += dur
            split_stages[stage] = split_stages.get(stage, 0.0) + dur
            by_op = ops.setdefault(stage, {})
            by_op[_short(op)] = by_op.get(_short(op), 0.0) + dur
    per = 1e6 * max(split, 1)
    return dict(replays=len(launches), split=split, nodes=len(names),
                events=sorted(len(v) for v in launches),
                busy_ms=busy / per, sum_ms=total / per,
                stages={k: v / per for k, v in split_stages.items()},
                ops={k: {op: v / per for op, v in sorted(o.items(), key=lambda kv: -kv[1])}
                     for k, o in ops.items()})


def _short(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters."""
    return name.split("(")[0].split("<")[0].replace("void ", "").strip() or name[:60]


def print_split(label: str, sp: dict, stage_kernels: dict | None = None) -> None:
    """``stage_split``'s record as lines: ms a replay by stage, the
    kernels the capture noted for it (``stage_kernels``), its ops."""
    print(f"[{label} stages] {sp['split']} of {sp['replays']} replays split by the stage "
          f"map's {sp['nodes']} nodes (device events a replay: {sp['events']}); a replay "
          f"busy {sp['busy_ms']:.4f} ms, the stages' sum {sp['sum_ms']:.4f} ms "
          f"({100 * (sp['sum_ms'] / sp['busy_ms'] - 1) if sp['busy_ms'] else 0:+.2f} %)")
    for stage, ms in sp["stages"].items():
        top = ", ".join(f"{op[:48]} {v:.4f}" for op, v in list(sp["ops"][stage].items())[:6])
        noted = ", ".join(f"{sym} x{n}" for sym, n in (stage_kernels or {}).get(stage, {}).items())
        print(f"    {ms:8.4f} ms  {stage} [{noted or 'no kernel noted'}]: {top}")


def is_copy(event_name: str) -> bool:
    """A device event that moves bytes rather than runs a kernel (a
    cudaMemcpy or cudaMemset)."""
    return event_name.startswith(("Memcpy", "Memset"))


def profile(name: str, graphed: bool = False, channels: int = CHANNELS) -> dict:
    """One configuration's step profiled as above, eagerly or as a CUDA
    graph (``graphed``); the graph's record also holds its kernels per
    replay as counted at the capture (``captured``)."""
    from iq_tool_tpu_torch.pipeline.graphed import GraphedStep
    dev = torch.device("cuda")
    chain = make_chain(name, dev, channels)
    cfg, n = chain.cfg, chain.n_in
    # a sharded step's block is T times a chain's: its stream repeats 4
    # blocks, so the input stays as large as the unsharded chains'
    distinct = 3 + 2 * STEPS if cfg.channels * n <= CHANNELS * BLOCK else 4
    wire = tone_wire(cfg.channels, distinct * n, torch.Generator(device=dev).manual_seed(SEED),
                     GATHER_TONE_HZ if name == "gather" else TONE_HZ)
    if cfg.input_format == "cu8":
        wire = to_cu8(wire)
    elif cfg.input_format == "cs8":
        wire = to_cs8(wire)
    parts = [wire[:, k * 2 * n:(k + 1) * 2 * n].contiguous() for k in range(distinct)]
    blocks = itertools.cycle(parts)
    del wire
    if graphed:
        chain = GraphedStep(chain)
        chain.input_buffer.copy_(parts[0])
        chain.capture()
        blocks = itertools.repeat(chain.input_buffer)
        del parts
    carry = chain.init_carry()

    def step():
        nonlocal carry
        carry, _ = chain.step(carry, next(blocks))

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5 * STEPS):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / (5 * STEPS)

    by_name = device_events(step, STEPS)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "10"],
                           stdout=subprocess.PIPE, text=True)
    smi.stdout.readline()           # sampling has begun
    torch.cuda._sleep(50_000_000)
    for k in range(5 * STEPS):
        if k in (0, STEPS, 4 * STEPS):
            ev[(0, STEPS, 4 * STEPS).index(k)].record()
        step()
    ev[3].record()
    torch.cuda.synchronize()
    smi.terminate()
    samples = [tuple(map(float, ln.split(","))) for ln in smi.communicate()[0].splitlines()
               if ln.count(",") == 1]
    clock, power = (float(np.mean([x[i] for x in samples])) if samples else float("nan")
                    for i in (0, 1))
    split = stage_split(chain) if graphed else None
    busy_ms = sum(v[0] for v in by_name.values())
    kernels = sum(v[1] for k, v in by_name.items() if not is_copy(k))
    copies = sum(v[1] for k, v in by_name.items() if is_copy(k))
    return dict(name=name, form="graph" if graphed else "eager", wall_ms=wall_ms,
                busy_ms=busy_ms / STEPS, kernels_per_step=kernels / STEPS,
                copies_per_step=copies / STEPS,
                queued_ms=ev[0].elapsed_time(ev[1]) / STEPS,
                queued_late_ms=ev[2].elapsed_time(ev[3]) / STEPS, sm_mhz=clock,
                power_w=power,
                idle=1 - busy_ms / STEPS / wall_ms if busy_ms else None,
                captured=chain.kernels if graphed else None, split=split,
                stage_kernels=chain.stage_kernels if graphed else None,
                by_name={k: v[1] / STEPS for k, v in by_name.items()},
                kernels=sorted(((k, v[0] / STEPS, v[1] / STEPS) for k, v in by_name.items()),
                               key=lambda r: -r[1]))


def graph_kernels_differ(eager: dict, graph: dict) -> list:
    """How the device kernels of a graphed step differ from the eager
    step's (profile() records): the eager kernels the graph lacks or
    launches another number of times a step (rounded: the profiler may
    miss an event at its window's edge), and the graph's kernels that
    are neither the eager step's nor its own: the memset of the DC
    kernel's status words (a fill of bytes) and the multi-tensor copies
    into its static carry.  Empty when they agree."""
    out = []
    for k, v in eager["by_name"].items():
        got = graph["by_name"].get(k, 0)
        if not is_copy(k) and round(got) != round(v):
            out.append(f"{k[:80]}: {v} a step eagerly, {got} graphed")
    for k in graph["by_name"]:
        if not (is_copy(k) or k in eager["by_name"] or "FillFunctor<unsigned char>" in k
                or "multi_tensor_apply_kernel" in k):
            out.append(f"{k[:80]}: only in the graph")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", nargs="+", default=list(CONFIGS), choices=CONFIGS)
    ap.add_argument("--forms", nargs="+", default=["eager", "graph"],
                    choices=["eager", "graph"])
    ap.add_argument("--channels", type=int, default=CHANNELS,
                    help="streams of a CONFIGS chain (the benchmark's cells: 64)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_steps needs a CUDA card")
    print(f"device {torch.cuda.get_device_name(0)}, torch {torch.__version__}")
    bad = 0
    for name in args.configs:
        rs = {f: profile(name, f == "graph", args.channels) for f in args.forms}
        for f, r in rs.items():
            if r["idle"] is None:
                print(f"[{name} {f}] wall {r['wall_ms']:.3f} ms/step; device time not "
                      "measured (the profiler saw no device events)")
                continue
            captured = (f", {sum(r['captured'].values())} kernel launches captured, "
                        "host launches a step 1" if r["captured"] is not None else "")
            print(f"[{name} {f}] wall {r['wall_ms']:.3f} ms/step, device busy "
                  f"{r['busy_ms']:.3f} ms/step in {r['kernels_per_step']:.1f} kernels and "
                  f"{r['copies_per_step']:.1f} copies a step{captured}, idle share "
                  f"{100 * r['idle']:.1f} %; "
                  f"queued {r['queued_ms']:.3f} ms/step, after 32 steps "
                  f"{r['queued_late_ms']:.3f} (SM {r['sm_mhz']:.0f} MHz, "
                  f"{r['power_w']:.0f} W)")
            for k, ms, n in r["kernels"][:12]:
                print(f"    {ms:8.3f} ms {n:5.1f}x  {k[:100]}")
            if r["split"] is not None:
                print_split(f"{name} {f}", r["split"], r["stage_kernels"])
                bad += not r["split"]["split"]
        if len(rs) == 2 and None not in (rs["eager"]["idle"], rs["graph"]["idle"]):
            diff = graph_kernels_differ(rs["eager"], rs["graph"])
            bad += bool(diff)
            print(f"[{name}] the graph's device kernels "
                  + ("are the eager step's" if not diff else "DIFFER: " + "; ".join(diff)))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
