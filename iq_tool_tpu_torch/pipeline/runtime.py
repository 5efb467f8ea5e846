"""Host streaming engine: feeds the chain from input module(s) and drains
it into output module(s) (the port of ``iq_tool_tpu.pipeline.runtime``).

Three host threads around the device queue:

  reader thread: cuts the sources' bytes into blocks, each written once
      into a free slot of a ring of HOST_QUEUE_DEPTH + 2 (C, wire) host
      blocks (pinned on CUDA)  ->  bounded slot queue (HOST_QUEUE_DEPTH)
  -> main thread: the slot's copy to the device + step launch
      (asynchronous on CUDA), then the slot goes back to the reader
  -> bounded output queue (pipeline_depth)  ->  writer thread: waits for
      the step's copy-back event, then writes the sinks

so source I/O, device work and sink I/O overlap, while the output bytes
stay identical at any queue depth (FIFO order end to end).  A Chain, a
FoldedChain or a ShardedChain runs as a ``GraphedStep``
(``pipeline/graphed.py``: captured CUDA graphs on the card, by
``prepare``; the same static buffers on the CPU), except a ShardedChain
on a mesh that ``sharded_eager_reason`` names (positions in other
processes, a time row over several devices), which steps eagerly.  The
ring is made once an engine (``prepare``); a slot holds as many blocks
as the queue and the two ends of it can hold, so waiting for a free slot
is the reader's back-pressure.  On CUDA each block goes host -> device
as a ``non_blocking`` copy from its pinned slot, straight into the
graph's input buffer, with an event the reader waits on before it
refills the slot; each output comes back into a pinned tensor on the
current stream, enqueued before the next replay overwrites it, with an
event the writer waits on.  EOS pads the final partial block with zeros
and trims the output to exactly floor(valid_in * P/Q) frames; stream
discontinuities set the step's reset flag.

Every block's work is a span (``pipeline/trace.py``) under the run's
serial and the block's index: on the reader thread ``engine.source``
(the sources' blocks), ``engine.wait_slot`` (a free slot, and the end
of its last copy to the device) and ``engine.assemble`` (the block's
bytes copied into the slot); on the main thread ``engine.wait_input``
(the reader's queue), ``engine.h2d``, ``engine.step``, ``engine.d2h``
(the pinned output, its copy and event) and ``engine.wait_output`` (the
writer's queue); on the writer thread ``engine.wait_device`` and
``engine.write``; and ``engine.transit``, from the reader's hand-over
of the block to the writer's return from its last sink.  Around them
the main thread's ``engine.start``, ``engine.checkpoint`` and
``engine.drain`` (the flush and the threads' stop after the last
block), so that it is inside a span from ``run``'s start to its return.

With a checkpoint path the engine saves (carry, frames in, frames out)
every ``checkpoint_interval_sec`` and at the end, each time after the
writer has flushed, so the cut is consistent: everything consumed has
been written.  ``resume`` loads it, seeks or skips the input past the
frames consumed and truncates the sinks to the frames written.  The
carry comes to the host (a synchronising copy on CUDA) only at a
checkpoint and before a zero-padded partial block, whose padding would
otherwise pollute the state a checkpoint records.

Multi-channel: N sources + N sinks drive a ``channels=N`` chain; channels
advance in lockstep, a multi-channel stream ends at the SHORTEST channel
and a discontinuity on any channel resets the whole chain at the next
block boundary.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import os
import queue as queue_mod
import threading
import time

import numpy as np
import torch

from iq_tool_tpu_torch import constants as C
from iq_tool_tpu_torch.modules.base import OutputClosed
from iq_tool_tpu_torch.ops import convert
from iq_tool_tpu_torch.pipeline.chain import Chain
from iq_tool_tpu_torch.pipeline.checkpoint import load_checkpoint, save_checkpoint
from iq_tool_tpu_torch.pipeline.graphed import GraphedStep, eager_reason
from iq_tool_tpu_torch.pipeline.trace import add as add_span, now_ns, new_run, span


@dataclasses.dataclass
class StreamSummary:
    frames_in: int = 0
    frames_out: int = 0
    bytes_out: int = 0
    duration_sec: float = 0.0
    interrupted: bool = False

    @property
    def avg_mb_per_sec(self) -> float:
        if self.duration_sec <= 0:
            return 0.0
        return self.bytes_out / 1e6 / self.duration_sec


class _Writer:
    """Drains (host tensor, ready event, emit_frames, block, hand-over
    stamp) items in FIFO order: waits for the copy-back, splits per
    channel, writes each sink.  The bounded queue is the device pipeline:
    up to ``depth`` steps stay in flight before the oldest one is waited
    on."""

    def __init__(self, sinks, items_per_frame: int,
                 summary: StreamSummary, depth: int, run: int):
        self._sinks = sinks
        self._items = items_per_frame
        self._q = queue_mod.Queue(maxsize=max(1, depth))
        self._summary = summary
        self._serial = run
        self.closed = False            # an OutputClosed arrived
        self.dropped = False           # items discarded after close
        self.error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="iq-writer")
        self._thread.start()

    def put(self, host: torch.Tensor, ready, emit: int, block: int, handed_ns: int) -> None:
        self._q.put((host, ready, emit, block, handed_ns))

    def flush(self) -> None:
        self._q.join()

    def stop(self) -> None:
        try:
            # a consumer stuck mid-write keeps the queue full; do not let
            # shutdown hang on it (the thread is a daemon)
            self._q.put(None, timeout=2.0)
        except queue_mod.Full:
            self.closed = True
        self._thread.join(timeout=10.0)

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            host, ready, emit, block, handed_ns = item
            try:
                if self.closed:
                    self.dropped = True
                else:
                    with span("engine.wait_device", block, self._serial):
                        if ready is not None:
                            ready.synchronize()
                    with span("engine.write", block, self._serial):
                        arr = host.numpy()
                        n_items = emit * self._items
                        for c, sink in enumerate(self._sinks):
                            sink.write(arr[c, :n_items].tobytes())
                    add_span("engine.transit", handed_ns, now_ns(), self._serial, block)
                    self._summary.frames_out += emit
                    self._summary.bytes_out += (n_items * arr.itemsize
                                                * len(self._sinks))
            except OutputClosed:
                self.closed = True
                self.dropped = True
            except BaseException as e:      # surfaced on the main thread
                self.error = e
                self.closed = True
            finally:
                self._q.task_done()


class _Backlog:
    """A channel's source bytes not yet in a block: its payloads as
    memoryviews, oldest first, so that cutting blocks from them copies
    nothing."""

    def __init__(self):
        self._views: collections.deque = collections.deque()
        self.size = 0

    def add(self, payload) -> None:
        view = memoryview(payload).cast("B")
        if view.nbytes:
            self._views.append(view)
            self.size += view.nbytes

    def take(self, n: int) -> list:
        """The oldest ``n`` bytes, as views; the rest of a payload that
        runs past them stays for the next block."""
        out = []
        self.size -= n
        while n:
            view = self._views.popleft()
            if view.nbytes > n:
                self._views.appendleft(view[n:])
                view = view[:n]
            out.append(view)
            n -= view.nbytes
        return out

    def clear(self) -> None:
        self._views.clear()
        self.size = 0


class _Ring:
    """The host blocks the reader writes into: HOST_QUEUE_DEPTH + 2 slots
    (the reader's queue, the slot being filled, the slot being copied to
    the device) of (C, wire) in the chain's wire dtype, pinned on CUDA so
    that the copy to the device is asynchronous.  ``copied[i]`` is the
    event after slot i's newest copy to the device, None where that copy
    was synchronous."""

    def __init__(self, stepper):
        pin = stepper.device.type == "cuda"
        self.slots = [torch.empty((stepper.cfg.channels, stepper.in_wire_len),
                                  dtype=convert.torch_wire_dtype(stepper.fmt_in),
                                  pin_memory=pin)
                      for _ in range(C.HOST_QUEUE_DEPTH + 2)]
        self._bytes = [slot.numpy().view(np.uint8) for slot in self.slots]
        self.copied = [None] * len(self.slots)

    def fill(self, i: int, rows: list) -> None:
        """Write each channel's views (``_Backlog.take``) into its row of
        slot i, and zeros after them: no byte of an earlier block stays."""
        for row, views in zip(self._bytes[i], rows):
            pos = 0
            for view in views:
                row[pos:pos + view.nbytes] = np.frombuffer(view, np.uint8)
                pos += view.nbytes
            row[pos:] = 0


class _Reader:
    """Runs a block cutter (``StreamEngine._gen_single``, ``_gen_multi``)
    on a thread of its own, so source I/O overlaps device work.  Each block
    it cuts goes into a free slot of the ring (``engine.wait_slot``: the
    wait for one and for that slot's last copy to the device;
    ``engine.assemble``: the copy into it), and the slot's index into a
    bounded queue with the moment it was handed over (``trace.now_ns``).
    The main thread gives a slot back with ``release`` once the block is
    on its way to the device."""

    _EOS = ("eos", None, 0, False, 0)

    def __init__(self, gen, ring: _Ring, run: int):
        self._q = queue_mod.Queue(maxsize=C.HOST_QUEUE_DEPTH)
        self._free = queue_mod.Queue()
        for i in range(len(ring.slots)):
            self._free.put(i)
        self._ring = ring
        self._serial = run
        self._stop = threading.Event()
        self._gen = gen
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="iq-reader")
        self._thread.start()

    def get(self):
        return self._q.get()

    def release(self, i: int) -> None:
        self._free.put(i)

    def stop(self) -> None:
        self._stop.set()
        # drain so a blocked put wakes up, then wait for exit
        try:
            while True:
                self._q.get_nowait()
        except queue_mod.Empty:
            pass
        self._thread.join(timeout=5.0)

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue_mod.Full:
                continue
        return False

    def _slot(self, k: int) -> int | None:
        """A free slot whose last copy to the device is done; None once
        stopped."""
        with span("engine.wait_slot", k, self._serial):
            while not self._stop.is_set():
                try:
                    i = self._free.get(timeout=0.2)
                except queue_mod.Empty:
                    continue
                if self._ring.copied[i] is not None:
                    self._ring.copied[i].synchronize()
                return i
        return None

    def _run(self) -> None:
        try:
            for k, (rows, valid, reset) in enumerate(self._gen):
                i = self._slot(k)
                if i is None:
                    return
                with span("engine.assemble", k, self._serial):
                    self._ring.fill(i, rows)
                if not self._put(("chunk", i, valid, reset, now_ns())):
                    return
        except BaseException as e:
            self._put(("err", e, 0, False, 0))
            return
        self._put(self._EOS)


class StreamEngine:
    """Single- or multi-channel stream runner.

    ``source``/``sink`` may each be a single module or a sequence of
    ``channels`` modules (one stream per channel, lockstep).
    ``initial_carry`` starts the stream from a given carry (the CLI's
    pre-stream I/Q calibration); ``checkpoint_path``,
    ``checkpoint_interval_sec`` and ``resume`` as in the module
    docstring.  ``chain`` may be a ``Chain``, a ``FoldedChain`` or a ``ShardedChain``."""

    def __init__(self, chain: Chain | None, source, sink,
                 raw_passthrough: bool = False,
                 progress=None, progress_total_frames: int | None = None,
                 checkpoint_path: str | None = None,
                 checkpoint_interval_sec: float = 30.0,
                 resume: bool = False,
                 initial_carry: dict | None = None,
                 pipeline_depth: int = C.PIPELINE_DEPTH):
        if chain is None and not raw_passthrough:
            raise ValueError("need a chain unless raw_passthrough")
        self.chain = chain
        self.sources = (list(source) if isinstance(source, (list, tuple))
                        else [source])
        self.sinks = (list(sink) if isinstance(sink, (list, tuple))
                      else [sink])
        self.source = self.sources[0]
        self.sink = self.sinks[0]
        self.raw_passthrough = raw_passthrough
        self.progress = progress
        self.total_frames = progress_total_frames
        self.checkpoint_path = checkpoint_path
        self.checkpoint_interval = checkpoint_interval_sec
        self.resume = resume
        self.initial_carry = initial_carry
        self.pipeline_depth = max(1, pipeline_depth)
        n_ch = len(self.sources)
        if len(self.sinks) != n_ch:
            raise ValueError(
                f"{n_ch} sources need {n_ch} sinks, got {len(self.sinks)}")
        if chain is not None and chain.cfg.channels != n_ch:
            raise ValueError(
                f"chain has channels={chain.cfg.channels} but "
                f"{n_ch} source streams were given")
        if raw_passthrough and n_ch != 1:
            raise ValueError("raw passthrough is single-stream")
        self.stepper = (GraphedStep(chain) if chain is not None and eager_reason(chain) is None
                        else chain)
        self.serial: int | None = None     # the newest run's serial (its spans')
        self._ring: _Ring | None = None

    def prepare(self) -> None:
        """Build the kernels and capture the step's graph now (the first
        step does it otherwise; ``stepper.capture_sec`` says how long it
        took), and make the reader's ring, which every run reuses."""
        if isinstance(self.stepper, GraphedStep):
            self.stepper.capture()
        if self._ring is None and not self.raw_passthrough:
            self._ring = _Ring(self.stepper)

    def run(self) -> StreamSummary:
        if self.raw_passthrough:
            return self._run_passthrough()
        return self._run_chain()

    def _run_passthrough(self) -> StreamSummary:
        s = StreamSummary()
        t0 = time.monotonic()
        last_prog = t0
        try:
            for block in self.source.blocks(C.DEFAULT_BLOCK_SIZE):
                self.sink.write(block.payload)
                s.bytes_out += len(block.payload)
                last_prog = self._progress_tick(s, t0, last_prog)
        except OutputClosed:
            pass                # consumer closed the pipe: graceful stop
        except KeyboardInterrupt:
            s.interrupted = True
        s.duration_sec = time.monotonic() - t0
        return s

    # ----------------------------------------------------- chunk assembly

    def _gen_single(self, block_bytes: int, bpf: int, skip_bytes: int, run: int):
        """Single-channel block cutter: yields ([views of the block's
        bytes], valid frames, reset); drains the pre-gap remainder of a
        discontinuity as its own short block.  The spans of the end of the
        stream, which makes no block, have none."""
        backlog = _Backlog()
        pending_reset = False
        src = self.sources[0].blocks(block_bytes // bpf)
        k = 0                           # the index of the block being filled
        while True:
            with span("engine.source", k, run) as sp:
                block = next(src, None)
                if block is None and backlog.size < bpf:
                    sp.block = None
            if block is None or (block.discontinuity and backlog.size):
                valid = backlog.size // bpf
                views = backlog.take(valid * bpf)
                backlog.clear()
                if valid:
                    yield [views], valid, pending_reset
                    k += 1
            if block is None:
                return
            if block.discontinuity:
                pending_reset = True
            payload = block.payload
            if skip_bytes:              # resume on a non-seekable source
                drop = min(skip_bytes, len(payload))
                payload = payload[drop:]
                skip_bytes -= drop
            backlog.add(payload)
            while backlog.size >= block_bytes:
                yield [backlog.take(block_bytes)], block_bytes // bpf, pending_reset
                pending_reset = False
                k += 1

    def _gen_multi(self, block_bytes: int, bpf: int, skip_bytes: int, run: int):
        """Lockstep multi-channel block cutter (as ``_gen_single``, a list
        of views a channel); ends at the shortest channel.  The spans of
        the end of the stream, which makes no block, have none."""
        n = len(self.sources)
        backlogs = [_Backlog() for _ in range(n)]
        iters = [s.blocks(block_bytes // bpf) for s in self.sources]
        done = [False] * n
        skips = [skip_bytes] * n
        pending_reset = False
        for k in itertools.count():
            with span("engine.source", k, run) as sp:
                least = block_bytes
                for c in range(n):
                    while backlogs[c].size < block_bytes and not done[c]:
                        block = next(iters[c], None)
                        if block is None:
                            done[c] = True
                            break
                        if block.discontinuity:
                            pending_reset = True
                        payload = block.payload
                        if skips[c]:
                            drop = min(skips[c], len(payload))
                            payload = payload[drop:]
                            skips[c] -= drop
                        backlogs[c].add(payload)
                    least = min(least, backlogs[c].size)
                if least < bpf:
                    sp.block = None
            valid = least // bpf
            if valid:
                yield [b.take(valid * bpf) for b in backlogs], valid, pending_reset
            if least < block_bytes:
                return
            pending_reset = False

    # ------------------------------------------------------------- chain

    def _run_chain(self) -> StreamSummary:
        run = self.serial = new_run()
        with span("engine.start", run=run):
            ch = self.stepper
            self.prepare()
            bpf = ch.fmt_in.bytes_per_frame
            block_bytes = ch.n_in * bpf
            n_channels = ch.cfg.channels
            on_cuda = ch.device.type == "cuda"
            carry = (self.initial_carry if self.initial_carry is not None
                     else ch.init_carry(n_channels))
            s = StreamSummary()

            skip_frames = 0
            if self.resume and self.checkpoint_path and os.path.isfile(self.checkpoint_path):
                carry, fin, fout, _ = load_checkpoint(self.checkpoint_path, ch, carry)
                s.frames_in, s.frames_out = fin, fout
                skip_frames = fin
                if all(hasattr(src, "seek_frames") for src in self.sources):
                    for src in self.sources:
                        src.seek_frames(fin)
                    skip_frames = 0
                # a crash between checkpoints leaves the sink ahead of the
                # checkpointed cut: truncate, so the resume is sample-exact
                for snk in self.sinks:
                    if hasattr(snk, "truncate_to_frames"):
                        snk.truncate_to_frames(fout, ch.fmt_out.bytes_per_frame)

            t0 = time.monotonic()
            last_prog = t0
            last_ckpt = t0
            # frames the writer has been asked to emit (>= s.frames_out until
            # it catches up; equal after a flush)
            scheduled_out = s.frames_out
            gen_fn = self._gen_single if n_channels == 1 else self._gen_multi
            ring = self._ring
            reader = _Reader(gen_fn(block_bytes, bpf, skip_frames * bpf, run), ring, run)
            writer = _Writer(self.sinks, ch.fmt_out.items_per_frame, s,
                             self.pipeline_depth, run)
        # the cut before a zero-padded partial block: (host carry, frames
        # in), fetched before that block's step
        pre_partial = None

        def process(slot: int, valid_frames: int, reset: bool, k: int, handed_ns: int):
            nonlocal carry, scheduled_out, pre_partial
            if valid_frames < ch.n_in and self.checkpoint_path:
                # keep the oldest clean cut: on consecutive partials (a
                # pre-gap drain, then the EOS tail) the live carry has
                # already seen padding
                if pre_partial is None:
                    with span("engine.checkpoint", run=run):
                        pre_partial = (ch.carry_to_numpy(carry), s.frames_in)
            else:
                # a full block makes the live carry consistent again
                pre_partial = None
            with span("engine.h2d", k, run):
                host_in = ring.slots[slot]
                if isinstance(ch, GraphedStep):
                    raw = ch.input_buffer
                    raw.copy_(host_in, non_blocking=on_cuda)
                elif on_cuda:
                    raw = host_in.to(ch.device, non_blocking=True)
                else:
                    # an eager step's carry may keep views of its input,
                    # and the reader refills the slot
                    raw = host_in.clone()
                if on_cuda:
                    ring.copied[slot] = torch.cuda.Event()
                    ring.copied[slot].record(torch.cuda.current_stream(ch.device))
                reader.release(slot)
            with span("engine.step", k, run):
                carry, out = ch.step(carry, raw, reset)
                s.frames_in += valid_frames
                allowed = ch.expected_out_frames(s.frames_in)
                emit = max(0, min(allowed - scheduled_out, ch.n_out))
                scheduled_out += emit
            with span("engine.d2h", k, run):
                ready = None
                if on_cuda:
                    host_out = torch.empty(out.shape, dtype=out.dtype,
                                           pin_memory=True)
                    host_out.copy_(out, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record()
                else:
                    # the next step overwrites a GraphedStep's output while
                    # the writer may still read it
                    host_out = out.clone() if isinstance(ch, GraphedStep) else out
            with span("engine.wait_output", k, run):
                # blocks when the pipe is full
                writer.put(host_out, ready, emit, k, handed_ns)

        def consistent_cut():
            if pre_partial is not None:
                c, fin = pre_partial
                return c, fin, min(s.frames_out, ch.expected_out_frames(fin))
            return ch.carry_to_numpy(carry), s.frames_in, s.frames_out

        def maybe_checkpoint(now: float, last: float) -> float:
            if self.checkpoint_path and now - last >= self.checkpoint_interval:
                with span("engine.checkpoint", run=run):
                    writer.flush()
                    # a failed sink write sets error without dropped, yet its
                    # block never landed: saving would put frames_in ahead of
                    # the bytes on disk
                    if not writer.dropped and writer.error is None:
                        save_checkpoint(self.checkpoint_path, *consistent_cut())
                return now
            return last

        try:
            for k in itertools.count():
                with span("engine.wait_input", k, run) as waited:
                    kind, item, valid, reset, handed_ns = reader.get()
                    if kind != "chunk":
                        waited.block = None
                if kind == "eos":
                    break
                if kind == "err":
                    raise item
                process(item, valid, reset, k, handed_ns)
                if writer.error is not None:
                    raise writer.error
                if writer.closed:
                    break
                last_prog = self._progress_tick(s, t0, last_prog)
                last_ckpt = maybe_checkpoint(time.monotonic(), last_ckpt)
        except KeyboardInterrupt:
            s.interrupted = True
        except BaseException:
            reader.stop()
            writer.stop()
            raise
        with span("engine.drain", run=run):
            try:
                if not s.interrupted:
                    try:
                        writer.flush()
                    except KeyboardInterrupt:
                        s.interrupted = True
                if s.interrupted:
                    try:
                        writer.flush()
                    except Exception:
                        pass            # still return the summary
            finally:
                reader.stop()
                writer.stop()
            if writer.error is not None and not isinstance(writer.error,
                                                           OutputClosed):
                raise writer.error
            # a closed consumer dropped computed blocks: (carry, frames_in) is
            # ahead of frames_out, so keep the last periodic checkpoint
            if self.checkpoint_path and not writer.dropped:
                save_checkpoint(self.checkpoint_path, *consistent_cut())
            s.duration_sec = time.monotonic() - t0
        return s

    def _progress_tick(self, s: StreamSummary, t0: float, last: float) -> float:
        now = time.monotonic()
        if self.progress and now - last >= C.PROGRESS_INTERVAL_SEC:
            self.progress(s, now - t0, self.total_frames)
            return now
        return last
