"""Small cells for the CPU tests: a BENCHMARK.json cell with its traffic
cut to a few channels and short blocks, and BASELINE config 3's chain
and a HackRF's as cells built in memory, since no file of the benchmark
names them."""

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


# A HackRF One at its default 10 Msps on its cs8 wire through upstream's
# preset cs16-fm-nrsc5 (iq_tool_presets.conf): 744,187.5 Hz cs16 with the
# digital AGC, no DC block, no I/Q correction; 4766/64043 runs the gather
# stage
HACKRF = {"input_format": "cs8", "output_format": "cs16", "input_rate": 10e6,
          "target_rate": 744187.5, "dc_block": False, "iq_correction": False,
          "freq_shift_pre_hz": 0.0, "freq_shift_post_hz": 0.0, "filters": [],
          "filter_method": "auto", "filter_fft_size": None, "agc_profile": "digital"}


# the host engine's cell: out of BENCHMARK.json, since its rate on the host's
# clock spreads between runs past the largest bound (PERF.md, sections 2
# and 7), but its workload, traffic and readers stay for its return, and
# the tests drive the engine mode through it
ENGINE = {"name": "baseline1-engine64", "config": "baseline1", "traffic": "engine", "chips": 1}


def load_cell(name: str) -> cells.Cell:
    """The cell BENCHMARK.json names ``name``, or the engine cell from its files."""
    return cells.from_entry(ENGINE) if name == ENGINE["name"] else cells.load(name)


def small_cell(name: str, **over):
    c = load_cell(name)
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


# the AGC state's limit for the HackRF chain: 14 times the program's widest
# reading on the card (1.47e-6), 6 times under the TF32 control's least
# (1.20e-4) and 25 times under one creep step (5e-4); PERF.md section 7
HACKRF_AGC_STATE_LIMIT = 2e-5


def hackrf_cell(input_rate: float = 10e6, target_rate: float = 744187.5,
                limits: dict | None = None, **over):
    """The HackRF chain at the given rates under the baseline1 resident
    cell's traffic (262144 frames a block), with ``over`` on the traffic,
    held to ``limits`` (default that cell's, and HACKRF_AGC_STATE_LIMIT on
    the digital AGC's state)."""
    base = cells.load("baseline1-resident64")
    chain = dict(HACKRF, input_rate=input_rate, target_rate=target_rate)
    limits = limits or dict(base.workload["limits"], end_agc_state_gap=HACKRF_AGC_STATE_LIMIT)
    workload = dict(base.workload, name="hackrf", limits=limits)
    return cells.Cell("hackrf", dict(base.entry, name="hackrf", config="hackrf"), workload,
                      {"name": "hackrf", "chain": chain}, dict(base.traffic, **over), [], [])


def small_run(cell, seconds: float = 0.6, seed: int = 2147483649, **over) -> drive.Run:
    """A short run on the CPU of ``cell``: a small BENCHMARK.json cell by
    name, or a cell as built."""
    torch.set_num_threads(4)
    if isinstance(cell, str):
        cell = small_cell(cell, **over)
    run = drive.Run(cell, seed, seconds, False, "cpu", time.perf_counter())
    drive.MODES[cell.traffic["mode"]](run)
    return run
