"""The host's feed path at the main path's width, stage by stage: the
port's counterpart of ``tools/host_budget.py``, on the card's host.

    python -m iq_tool_tpu_torch.host_budget [--channels 128] [--block 262144] [--no-device]

Times each stage the engine runs a step (``pipeline/runtime.py``
``_run_chain.process`` and its reader and writer) alone, best of 5
runs, on a cs16 step of C channels x N frames:

  file_read         C reads of one block from a page-cache-hot file
  native_ring       a write and a read of each block through the native
                    ring (a live source's path; where
                    native/build/libiqnative.so is built)
  frombuffer+stack  the C byte strings -> one (C, 2N) int16 array
  pin_copy          that array copied into fresh pinned memory
  h2d_pageable      the array to the card from pageable memory
  h2d_pinned        the pinned copy to the card
  pinned_out_alloc  the step's pinned output, allocated
  d2h_pinned        the flagship's (C, 2 M) int16 output into it
  out_tobytes       each channel's output row -> bytes
  sink_write        C writes of one output row to a file

and prints one JSON line a stage (ns a complex input sample, and the
stage's own Msps), then a summary: the serial host path of a file-to-file
step (every stage but the ring and the pageable copy: the engine copies
from pinned memory), its Msps, and beside it the device step's Msps (the
flagship as a GraphedStep, ``bench.measure``) and the card's name and
power limit.  The transfers cross the host's own PCIe, so they count in
the serial total.  ``--no-device`` leaves out the transfers and the
device step, and the pinned memory, which needs the card (the tests'
lane).  Files go under build/iq_tool_tpu_torch/.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from iq_tool_tpu_torch import native
from iq_tool_tpu_torch.bench import BUILD, card_line, measure
from iq_tool_tpu_torch.profile_steps import BLOCK, CHANNELS, config

FLAGSHIP_OUT = 11907 / 16384        # the flagship's output frames per input frame
REPS = 5


def _best(f) -> float:
    """Best-of-REPS wall seconds of f()."""
    best = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        f()
        best = min(best, time.perf_counter() - t0)
    return best


def out(line: dict) -> None:
    print(json.dumps(line), flush=True)


def run(channels: int = CHANNELS, block: int = BLOCK, device: bool = True) -> None:
    """Time and print each stage, then the summary."""
    ch, n = channels, block
    samples = ch * n
    blk = 4 * n                             # cs16 bytes a channel
    n_out = int(n * FLAGSHIP_OUT)
    rng = np.random.default_rng(0)
    rows = [rng.integers(-2 ** 15, 2 ** 15, 2 * n).astype(np.int16).tobytes()
            for _ in range(ch)]
    results: dict = {}

    def report(stage, secs, note=""):
        rec = {"stage": stage, "ns_per_sample": secs / samples * 1e9,
               "standalone_Msps": samples / secs / 1e6}
        if note:
            rec["note"] = note
        results[stage] = rec
        out(rec)

    BUILD.mkdir(parents=True, exist_ok=True)
    path = BUILD / f"host_budget.{os.getpid()}.cs16"
    try:
        with open(path, "wb") as f:
            for r in rows:
                f.write(r)
        with open(path, "rb", buffering=0) as fd:
            def read_all():
                fd.seek(0)
                for _ in range(ch):
                    fd.read(blk)
            report("file_read", _best(read_all), "page-cache hot")

        if native.available():
            ring = native.NativeRingBuffer(blk * 4)

            def ring_rt():
                for r in rows:
                    ring.write(r)
                    ring.read(blk)
            report("native_ring", _best(ring_rt), "a live source's path")
        else:
            out({"stage": "native_ring",
                 "error": "native/build/libiqnative.so is not built here"})

        stacked = None

        def stack():
            nonlocal stacked
            stacked = np.stack([np.frombuffer(r, np.int16) for r in rows], axis=0)
        report("frombuffer+stack", _best(stack))
        host_in = torch.from_numpy(stacked)
        if not device:
            for stage in ("pin_copy", "h2d_pageable", "h2d_pinned", "pinned_out_alloc",
                          "d2h_pinned"):
                out({"stage": stage, "error": "not measured: --no-device"})
        else:
            report("pin_copy", _best(host_in.pin_memory))
            dev = torch.device("cuda")
            dev_in = torch.empty(host_in.shape, dtype=host_in.dtype, device=dev)
            pinned = host_in.pin_memory()

            def h2d(src):
                def go():
                    dev_in.copy_(src, non_blocking=True)
                    torch.cuda.synchronize()
                return go
            h2d(pinned)()
            report("h2d_pageable", _best(h2d(host_in)))
            report("h2d_pinned", _best(h2d(pinned)))
            out_dev = torch.zeros((ch, 2 * n_out), dtype=torch.int16, device=dev)
            report("pinned_out_alloc",
                   _best(lambda: torch.empty((ch, 2 * n_out), dtype=torch.int16,
                                             pin_memory=True)))
        host_out = torch.empty((ch, 2 * n_out), dtype=torch.int16, pin_memory=device)
        if device:
            def d2h():
                host_out.copy_(out_dev, non_blocking=True)
                torch.cuda.synchronize()
            d2h()
            report("d2h_pinned", _best(d2h))
        arr = host_out.numpy()
        report("out_tobytes", _best(lambda: [arr[c].tobytes() for c in range(ch)]))
        data = [arr[c].tobytes() for c in range(ch)]
        with open(path, "wb", buffering=0) as wfd:
            def sink():
                wfd.seek(0)
                for d in data:
                    wfd.write(d)
            report("sink_write", _best(sink), "page cache")
    finally:
        path.unlink(missing_ok=True)

    serial = [s for s in ("file_read", "frombuffer+stack", "pin_copy", "h2d_pinned",
                          "pinned_out_alloc", "d2h_pinned", "out_tobytes", "sink_write")
              if s in results]
    total_ns = sum(results[s]["ns_per_sample"] for s in serial)
    summary = {"summary": "the serial host path of a file-to-file step", "stages": serial,
               "ns_per_sample": total_ns, "host_Msps": 1e3 / total_ns,
               "channels": ch, "block": n, "device_step_Msps": None, "device": "cpu"}
    if device:
        summary["device_step_Msps"] = measure(config("flagship", ch, n))
        summary["device"] = card_line()
    out(summary)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--channels", type=int, default=CHANNELS)
    ap.add_argument("--block", type=int, default=BLOCK)
    ap.add_argument("--no-device", action="store_true",
                    help="no transfers and no device step (the tests' lane)")
    args = ap.parse_args(argv)
    if not args.no_device and not torch.cuda.is_available():
        raise SystemExit("host_budget times the card's transfers: no CUDA card "
                         "(--no-device for the host stages alone)")
    run(args.channels, args.block, not args.no_device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
