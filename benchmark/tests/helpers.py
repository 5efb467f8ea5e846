"""Small cells for the CPU tests: a BENCHMARK.json cell with its traffic
cut to a few channels and short blocks, and BASELINE config 3's chain as
a cell built in memory, since no file of the benchmark names it."""

import time

import torch

from benchmark.harness import cell as cells, drive

SMALL = dict(channels=4, block_frames=16384)

# BASELINE config 3: an RTL-SDR's cu8 capture -> DC block -> FFT-method
# band-pass (upstream's NRSC-5 USB sideband, which runs after the
# resampler by upstream's stage rule) -> resample -> cs16
CONFIG3 = {"input_format": "cu8", "output_format": "cs16", "input_rate": 2048000.0,
           "target_rate": 1488375.0, "dc_block": True, "iq_correction": False,
           "freq_shift_pre_hz": 0.0, "freq_shift_post_hz": 0.0,
           "filters": [["pass-range", 102000.0, 215000.0]], "filter_method": "fft",
           "filter_stage": "auto", "filter_fft_size": None, "agc_profile": None}


def small_cell(name: str, **over):
    c = cells.load(name)
    c.traffic = dict(c.traffic, **{**SMALL, **over})
    return c


def config3_cell(mode: str = "resident", **over):
    """Config 3's chain under the ``mode`` traffic of the baseline1 cell
    that has it, held to that cell's limits."""
    base = small_cell(f"baseline1-{mode}64", **over)
    name = f"config3-{mode}"
    return cells.Cell(name, dict(base.entry, name=name, config="config3"),
                      dict(base.workload, name=name), {"name": "config3", "chain": CONFIG3},
                      base.traffic, [], [])


def small_run(cell, seconds: float = 0.6, seed: int = 2147483649, **over) -> drive.Run:
    """A short run on the CPU of ``cell``: a small BENCHMARK.json cell by
    name, or a cell as built."""
    torch.set_num_threads(4)
    if isinstance(cell, str):
        cell = small_cell(cell, **over)
    run = drive.Run(cell, seed, seconds, False, "cpu", time.perf_counter())
    drive.MODES[cell.traffic["mode"]](run)
    return run
