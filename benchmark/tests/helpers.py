"""Small cells for the CPU tests: a BENCHMARK.json cell with its traffic
cut to a few channels and short blocks."""

import time

import torch

from benchmark.harness import cell as cells, drive

SMALL = dict(channels=4, block_frames=16384)


def small_cell(name: str, **over):
    c = cells.load(name)
    c.traffic = dict(c.traffic, **{**SMALL, **over})
    return c


def small_run(name: str, seconds: float = 0.6, seed: int = 2147483649, **over) -> drive.Run:
    torch.set_num_threads(4)
    cell = small_cell(name, **over)
    run = drive.Run(cell, seed, seconds, False, "cpu", time.perf_counter())
    drive.MODES[cell.traffic["mode"]](run)
    return run
