"""Run one cell of the benchmark of iq_tool_tpu_torch once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of BENCHMARK.json's ``workloads``; its workload,
configuration and traffic files are found by name under ``benchmark/``,
each metric's reader under ``benchmark/metrics/<name>.py``.  Set-up makes
the seeded input, builds the chain and drives it through the stream's
first blocks; the window runs for ``--seconds``; then the check compares
the kept output with the plain reference (``reference/``) and the last
line of standard output is the run's JSON record: ``--trace 0`` the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from a
torch.profiler window, with a ``breakdown``.  The numbers compared, each
with its limit, are the last lines of standard error and the record's
last key, ``check``.

Exits 2 without a record when torch sees no CUDA card (or fewer than the
cell asks for), and 3 when the JAX package, or JAX, has been loaded.
"""

from __future__ import annotations

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# every cache the program or torch may write stays at a fixed path in the
# checkout (the port's own kernels build into build/iq_tool_tpu_torch/)
_CACHE = os.path.join(ROOT, "build", "benchmark_cache")
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = os.path.join(_CACHE, _sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "iq_tool_tpu")


def process_start() -> float:
    """The perf_counter reading at this process's start (from /proc), or
    this module's first line where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return min(T_START, time.perf_counter() - (up - ticks / os.sysconf("SC_CLK_TCK")))
    except (OSError, ValueError, IndexError):
        return T_START


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def reader(name: str):
    """benchmark/metrics/<name>.py's ``read``."""
    from benchmark.harness.cell import reader_path
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card(torch) -> dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        info["power_limit"] = res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        info["power_limit"] = "unknown"
    return info


def execute(cell_name: str, seed: int, seconds: float, trace: bool, device: str,
            t_start: float) -> dict:
    """Set-up, window, metrics and check of one run on ``device``: the
    run's record (the JSON line's keys), without ``device``."""
    import torch

    from benchmark.harness import bounds, cell as cells, check, drive
    from benchmark.harness import trace as tracing
    cell = cells.load(cell_name)
    mode = cell.traffic["mode"]
    run = drive.Run(cell, seed, seconds, trace, device, t_start)
    drive.MODES[mode](run)
    if run.prof is not None:
        run.dev_trace = tracing.read(run.prof, run.window_s)
        run.prof = None
    run.bounds = bounds.step_bounds(cell.chain, cell.channels, run.n_in, run.n_out, run.rows)
    metrics = {}
    for m in (cell.per_layer if trace else cell.e2e):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    record = {"correct": False, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "memory_peak_bytes": run.memory_peak_bytes}
    if run.dev_trace is not None:
        t = run.dev_trace
        record["busy_s"], record["window_s"] = t.busy_s, t.window_s
        record["breakdown"] = {"device_ops": [[n, s] for n, s in t.ops[:10]],
                               "idle_gaps": [[n, s] for n, s in t.gaps[:10]]}
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.check(run, device)
    print(f"the check took {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    record["correct"] = all(v <= lim for _, v, lim in numbers)
    record["check"] = {n: {"value": v, "limit": lim} for n, v, lim in numbers}
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()
    from benchmark.harness import cell as cells
    entry = cells.load(args.workload).entry

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"error: the cell needs {entry['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    record = execute(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"error: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    device = card(torch)
    device.update(count=int(entry["chips"]), memory_peak_bytes=record.pop("memory_peak_bytes"))
    for key in ("busy_s", "window_s"):
        if key in record:
            device[key] = record.pop(key)
    check_ = record.pop("check")
    record["device"] = device
    if "breakdown" in record:
        record["breakdown"] = record.pop("breakdown")
    record["check"] = check_
    for name, c in check_.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
