"""The two ways a cell's traffic reaches the program, and what a run
records of them.  Which one a cell takes is its traffic file's ``mode``:

* ``resident``: the capture lands in the card's memory (a ring of
  ``ring_blocks`` blocks, as a many-receiver front end with GPUDirect
  receives it); each step hands the next slot to ``GraphedStep.step``
  and copies the output into an output ring on the card, with at most
  ``in_flight`` steps queued;
* ``engine``: ``StreamEngine.run`` as the CLI drives it, from one
  replaying source a channel (the capture cycled in host memory, one
  ``Block`` a step as the raw-file input yields it) into one sink a
  channel that keeps what is compared and counts the rest, closed loop
  and unpaced; ``intra_op_threads`` caps torch's CPU thread pool, whose
  idle threads spin on the cores the engine's reader, main and writer
  threads need.

Both take the capture in the configuration's input format, in the
chain's wire dtype and length; the output stays cs16.  Every mode runs
the stream from its first block: set-up builds the
chain, captures its graph and drives it through its first blocks (kept
for the check from the stream's start); the window then runs for
``seconds``, ending on a block on which the I/Q estimator's update
period closes, and its last blocks are kept for the check of the
stream's end.  A chain with the digital AGC, whose state runs over the
whole stream, also keeps that state as it enters the compared end
(resident mode only: the engine mode takes no digital AGC).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
import weakref

import numpy as np
import torch

from benchmark.harness import signal
from benchmark.harness.cell import Cell, build_chain

START_STEPS = 3          # blocks from the stream's start that are compared
END_STEPS = 3            # blocks at the stream's end that are compared
# frames the reference runs before the compared end, from zero sample
# memory: the resampler's and the notch's histories and the AGC's loop
# settle within them, and a DC blocker's pole (1 - 3.07e-5 at 2.048
# Msps) leaves e^-16 of the state it did not have (2 blocks of 262144)
END_WARM_FRAMES = 524288


def least_blocks(n_in: int) -> int:
    """The fewest blocks a stream needs for both compared spans."""
    return START_STEPS + -(-END_WARM_FRAMES // n_in) + END_STEPS


@dataclasses.dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float                    # perf_counter at the process's start
    mode: str = ""
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0                    # blocks a channel in the window
    frames_in: int = 0                # input frames of all channels in the window
    attempted: int = 0
    failed: int = 0
    transits: list = dataclasses.field(default_factory=list)     # s, a block
    prof: object = None               # the torch.profiler of a traced window
    dev_trace: object = None          # trace.DeviceTrace
    memory_peak_bytes: int = 0
    # what the check reads
    rows: int = 1
    n_in: int = 0                     # frames a channel a block
    n_out: int = 0
    bounds: dict = dataclasses.field(default_factory=dict)   # bounds.step_bounds
    total_steps: int = 0              # blocks of the stream, the start's included
    start_out: list = dataclasses.field(default_factory=list)   # (C, 2 n_out) int16
    end_out: list = dataclasses.field(default_factory=list)     # the last END_STEPS
    final_factors: object = None      # the program's I/Q factors after its last update
    end_agc: dict | None = None       # the digital AGC's state entering the compared end
    inputs: object = None             # k -> block k's (C, in_wire_len) input wire


def _profiler(on: bool):
    if not on:
        return None
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def _factors(stepper) -> np.ndarray | None:
    carry = stepper._carry
    return carry["iq"].factors.double().cpu().numpy() if "iq" in carry else None


def _agc_keeper(cell: Cell, step):
    """For a chain with the digital AGC, (keep, state): ``keep(j)`` copies
    the static carry's AGC state, as it enters block j, into a ring of
    END_STEPS + 1 slots in one multi-tensor copy, and ``state(j)`` reads
    slot j back as {field: tensor}; else (None, None)."""
    if cell.chain.get("agc_profile") != "digital":
        return None, None
    agc = step._carry["agc"]
    names = [f.name for f in dataclasses.fields(agc)]
    src = [getattr(agc, f) for f in names]
    ring = [[t.clone() for t in src] for _ in range(END_STEPS + 1)]

    def keep(j: int) -> None:
        torch._foreach_copy_(ring[j % len(ring)], src)

    def state(j: int) -> dict:
        return {f: t.clone() for f, t in zip(names, ring[j % len(ring)])}

    return keep, state


def _end_setup(run: Run) -> None:
    """Set-up ends: the files it wrote (a first run's kernel build) go to
    disk now, not during the window."""
    os.sync()
    run.setup_s = time.perf_counter() - run.t_start


def capture(cell: Cell, chain, seed: int, device) -> torch.Tensor:
    """The cell's seeded capture of ``ring_blocks`` blocks a channel on
    ``device``: (C, ring_blocks * in_wire_len) in the configuration's
    input format, which has to be the chain's input wire dtype."""
    slots = int(cell.traffic["ring_blocks"])
    cap = signal.capture(seed, cell.channels, slots * chain.n_in,
                         float(cell.chain["input_rate"]), cell.traffic["signal"], device,
                         cell.chain["input_format"])
    got = torch.empty(0, dtype=cap.dtype).numpy().dtype
    if got != np.dtype(chain.in_wire_dtype) or cap.shape[1] != slots * chain.in_wire_len:
        raise RuntimeError(f"a {cell.chain['input_format']} capture is {got} x "
                           f"{cap.shape[1]}, the chain reads {chain.in_wire_dtype} x "
                           f"{slots * chain.in_wire_len}")
    return cap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev: torch.device) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


# ------------------------------------------------------------------ resident

def resident(run: Run) -> None:
    from iq_tool_tpu_torch.pipeline.graphed import GraphedStep
    cell, tr = run.cell, run.cell.traffic
    dev = torch.device(run.device)
    chain = build_chain(cell, dev)
    step = GraphedStep(chain)
    c, n_in, slots = cell.channels, chain.n_in, int(tr["ring_blocks"])
    cap = capture(cell, chain, run.seed, dev)
    ring = cap.view(c, slots, chain.in_wire_len).transpose(0, 1).contiguous()
    del cap
    step.capture()
    out_ring = torch.empty((slots, c, 2 * chain.n_out), dtype=torch.int16, device=dev)
    carry = step.init_carry()
    keep, agc_state = _agc_keeper(cell, step)
    for k in range(START_STEPS):
        carry, out = step.step(carry, ring[k])
        out_ring[k].copy_(out)
        if keep is not None:
            keep(k + 1)
    start = out_ring[:START_STEPS].clone()
    depth = int(tr["in_flight"])
    events = [torch.cuda.Event() if dev.type == "cuda" else None for _ in range(depth)]
    period = cell.due_period(n_in)
    _sync(dev)
    prof = _profiler(run.trace)
    _end_setup(run)
    k = START_STEPS
    if prof is not None:
        prof.start()
    t0 = time.perf_counter()
    while True:
        ev = events[k % depth]
        if ev is not None and k - START_STEPS >= depth:
            ev.synchronize()
        carry, out = step.step(carry, ring[k % slots])
        out_ring[k % slots].copy_(out)
        if keep is not None:
            keep(k + 1)
        if ev is not None:
            ev.record()
        k += 1
        if k % period == 0 and k >= least_blocks(n_in) and time.perf_counter() - t0 >= run.seconds:
            break
    _sync(dev)
    run.window_s = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
    run.prof = prof
    run.mode, run.rows = "resident", getattr(chain, "fold", 1)
    run.n_in, run.n_out = n_in, chain.n_out
    run.steps, run.total_steps = k - START_STEPS, k
    run.frames_in = run.steps * c * n_in
    run.attempted, run.failed = run.steps, 0
    run.memory_peak_bytes = _peak(dev)
    run.start_out = list(start)
    run.end_out = [out_ring[j % slots].clone() for j in range(k - END_STEPS, k)]
    run.final_factors = _factors(step)
    if agc_state is not None:
        run.end_agc = agc_state(k - END_STEPS)
    run.inputs = lambda j: ring[j % slots]


# ------------------------------------------------------ sources and sinks

def _modules():
    from iq_tool_tpu_torch.modules.base import Block, InputModule, OutputModule, SourceInfo

    class Source(InputModule):
        """One channel of a feed, yielding the blocks the feed releases."""
        name = "benchmark"

        is_realtime = False

        def __init__(self, feed, c: int):
            self.feed, self.c = feed, c

        def initialize(self, config, args):
            return SourceInfo(sample_rate=self.feed.rate, sample_format=self.feed.fmt)

        def blocks(self, frames_per_block: int):
            for payload in self.feed.payloads(self.c, frames_per_block):
                yield Block(payload=payload)

    class Sink(OutputModule):
        """One channel's sink: keeps the first and the last few blocks'
        bytes for the check, stamps the last channel's receipt of each."""
        name = "benchmark"

        def __init__(self, feed, c: int):
            self.feed, self.c = feed, c
            self.reset()

        def reset(self):
            self.count = 0
            self.first: list = []
            self.last = collections.deque(maxlen=END_STEPS)

        def initialize(self, config, args):
            pass

        def write(self, payload: bytes) -> None:
            if self.count < START_STEPS:
                self.first.append(payload)
            self.last.append(payload)
            if self.c == self.feed.channels - 1:
                self.feed.received.append(time.perf_counter())
            self.count += 1

    return Source, Sink


class ReplayFeed:
    """The capture cycled from host memory, a block at a time: stops after
    ``blocks`` blocks, or at the first block on a due period's boundary
    once ``seconds`` have passed since ``arm`` and the check has its
    blocks.  ``cap`` is (C, slots * wire) of a format of two items a
    frame, announced to the engine as ``fmt``.  The capture is also an
    in-memory file, and each payload a ``pread`` of it: a new bytes
    object copied with the GIL released, as the raw-file input's read of
    a cached capture file gives it."""

    def __init__(self, cap: np.ndarray, n_in: int, rate: float, period: int, fmt: str):
        self.cap, self.n_in, self.rate, self.period, self.fmt = cap, n_in, rate, period, fmt
        self.channels = cap.shape[0]
        self.slots = cap.shape[1] // (2 * n_in)
        self.fd = os.memfd_create("benchmark-capture")
        weakref.finalize(self, os.close, self.fd)
        data = memoryview(np.ascontiguousarray(cap)).cast("B")
        while data.nbytes:
            data = data[os.write(self.fd, data):]

    def arm(self, blocks: int | None = None, seconds: float | None = None) -> None:
        self.limit, self.seconds = blocks, seconds
        self.released, self.received = [], []
        self.t0 = time.perf_counter()

    def _more(self, c: int, k: int) -> bool:
        if c == 0 and self.limit is None and k % self.period == 0 and (
                k >= least_blocks(self.n_in)
                and time.perf_counter() - self.t0 >= self.seconds):
            self.limit = k
        return self.limit is None or k < self.limit

    def payloads(self, c: int, frames: int):
        if frames != self.n_in:
            raise ValueError(f"the engine asks for {frames}-frame blocks, not {self.n_in}")
        row, size = self.cap.shape[1] * self.cap.itemsize, 2 * self.n_in * self.cap.itemsize
        k = 0
        while self._more(c, k):
            with torch.profiler.record_function("benchmark.source"):
                payload = os.pread(self.fd, size, c * row + (k % self.slots) * size)
            if c == self.channels - 1:
                self.released.append(time.perf_counter())
            yield payload
            k += 1

    def block(self, k: int) -> torch.Tensor:
        s = (k % self.slots) * 2 * self.n_in
        return torch.from_numpy(self.cap[:, s:s + 2 * self.n_in])


def engine(run: Run) -> None:
    from iq_tool_tpu_torch import constants as C
    from iq_tool_tpu_torch.pipeline.runtime import StreamEngine
    cell, tr = run.cell, run.cell.traffic
    if cell.chain.get("agc_profile") == "digital":
        raise NotImplementedError("the engine mode records no digital AGC state for the check")
    if "intra_op_threads" in tr:
        torch.set_num_threads(int(tr["intra_op_threads"]))
    dev = torch.device(run.device)
    chain = build_chain(cell, dev)
    c, n_in = cell.channels, chain.n_in
    cap = capture(cell, chain, run.seed, dev).cpu().numpy()
    feed = ReplayFeed(cap, n_in, float(cell.chain["input_rate"]), cell.due_period(n_in),
                      cell.chain["input_format"])
    Source, Sink = _modules()
    sources = [Source(feed, j) for j in range(c)]
    sinks = [Sink(feed, j) for j in range(c)]
    eng = StreamEngine(chain, sources[0] if c == 1 else sources, sinks[0] if c == 1 else sinks,
                       pipeline_depth=C.PIPELINE_DEPTH)
    eng.prepare()
    feed.arm(blocks=START_STEPS)           # warm-up: the engine's threads, pinned memory
    eng.run()
    for s in sinks:
        s.reset()
    _sync(dev)
    prof = _profiler(run.trace)
    _end_setup(run)
    if prof is not None:                   # its start-up before the window's clock
        prof.start()
    feed.arm(seconds=run.seconds)
    summary = eng.run()
    if prof is not None:
        _sync(dev)
        prof.stop()
    run.prof = prof
    run.mode = "engine"
    run.window_s = feed.received[-1] - feed.t0
    run.transits = [b - a for a, b in zip(feed.released, feed.received)]
    run.rows, run.n_in, run.n_out = getattr(chain, "fold", 1), n_in, chain.n_out
    run.steps = run.total_steps = sinks[0].count
    run.frames_in = summary.frames_in * c
    run.attempted, run.failed = run.steps, feed.limit - run.steps
    run.memory_peak_bytes = _peak(dev)

    def stack(attr: str) -> list:
        # a block short of n_out frames (the stream's last, zero-padded)
        # keeps its own length
        return [torch.from_numpy(np.stack([np.frombuffer(getattr(s, attr)[i],
                                                         chain.out_wire_dtype)
                                           for s in sinks]))
                for i in range(len(getattr(sinks[0], attr)))]
    run.start_out = stack("first")
    run.end_out = stack("last")
    run.final_factors = _factors(eng.stepper)
    run.inputs = feed.block


MODES = {"resident": resident, "engine": engine}
