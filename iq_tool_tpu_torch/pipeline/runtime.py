"""Host streaming engine: feeds the chain from input module(s) and drains
it into output module(s) (the port of ``iq_tool_tpu.pipeline.runtime``).

Three host threads around the device queue:

  reader thread  ->  bounded chunk queue (HOST_QUEUE_DEPTH)
      -> main thread: pinned host copy + step launch (asynchronous on CUDA)
  -> bounded output queue (pipeline_depth)  ->  writer thread: waits for
      the step's copy-back event, then writes the sinks

so source I/O, device work and sink I/O overlap, while the output bytes
stay identical at any queue depth (FIFO order end to end).  On CUDA each
block goes host -> device as a ``non_blocking`` copy from pinned memory,
and each output comes back into a pinned tensor on the current stream,
with an event the writer waits on.  EOS pads the final partial block with
zeros and trims the output to exactly floor(valid_in * P/Q) frames;
stream discontinuities set the step's reset flag.

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

import dataclasses
import os
import queue as queue_mod
import threading
import time

import numpy as np
import torch

from iq_tool_tpu_torch import constants as C
from iq_tool_tpu_torch.modules.base import OutputClosed
from iq_tool_tpu_torch.pipeline.chain import Chain
from iq_tool_tpu_torch.pipeline.checkpoint import load_checkpoint, save_checkpoint


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
    """Drains (host tensor, ready event, emit_frames) items in FIFO order:
    waits for the copy-back, splits per channel, writes each sink.  The
    bounded queue is the device pipeline: up to ``depth`` steps stay in
    flight before the oldest one is waited on."""

    def __init__(self, sinks, items_per_frame: int,
                 summary: StreamSummary, depth: int):
        self._sinks = sinks
        self._items = items_per_frame
        self._q = queue_mod.Queue(maxsize=max(1, depth))
        self._summary = summary
        self.closed = False            # an OutputClosed arrived
        self.dropped = False           # items discarded after close
        self.error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="iq-writer")
        self._thread.start()

    def put(self, host: torch.Tensor, ready, emit: int) -> None:
        self._q.put((host, ready, emit))

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
            host, ready, emit = item
            try:
                if self.closed:
                    self.dropped = True
                else:
                    if ready is not None:
                        ready.synchronize()
                    arr = host.numpy()
                    n_items = emit * self._items
                    for c, sink in enumerate(self._sinks):
                        sink.write(arr[c, :n_items].tobytes())
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


class _Reader:
    """Pumps assembled chunks from a generator into a bounded queue so
    source I/O overlaps device work."""

    _EOS = ("eos", None, 0, False)

    def __init__(self, gen, depth: int = C.HOST_QUEUE_DEPTH):
        self._q = queue_mod.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._gen = gen
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="iq-reader")
        self._thread.start()

    def get(self):
        return self._q.get()

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

    def _run(self) -> None:
        try:
            for item in self._gen:
                if not self._put(("chunk",) + item):
                    return
        except BaseException as e:
            self._put(("err", e, 0, False))
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

    def _gen_single(self, block_bytes: int, bpf: int, skip_bytes: int):
        """Single-channel chunk generator; drains the pre-gap remainder of
        a discontinuity as its own short block."""
        buf = bytearray()
        pending_reset = False
        src = self.sources[0].blocks(block_bytes // bpf)
        while True:
            block = next(src, None)
            if block is None:
                if buf:
                    valid = len(buf) // bpf
                    if valid:
                        yield ([bytes(buf[:valid * bpf])], valid,
                               pending_reset)
                return
            if block.discontinuity:
                if buf:
                    valid = len(buf) // bpf
                    if valid:
                        yield [bytes(buf[:valid * bpf])], valid, pending_reset
                    buf.clear()
                pending_reset = True
            payload = block.payload
            if skip_bytes:              # resume on a non-seekable source
                drop = min(skip_bytes, len(payload))
                payload = payload[drop:]
                skip_bytes -= drop
            buf.extend(payload)
            while len(buf) >= block_bytes:
                yield [bytes(buf[:block_bytes])], block_bytes // bpf, \
                    pending_reset
                pending_reset = False
                del buf[:block_bytes]

    def _gen_multi(self, block_bytes: int, bpf: int, skip_bytes: int):
        """Lockstep multi-channel chunk generator; ends at the shortest
        channel."""
        n = len(self.sources)
        bufs = [bytearray() for _ in range(n)]
        iters = [s.blocks(block_bytes // bpf) for s in self.sources]
        done = [False] * n
        skips = [skip_bytes] * n
        pending_reset = False
        while True:
            for c in range(n):
                while len(bufs[c]) < block_bytes and not done[c]:
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
                    bufs[c].extend(payload)
            if all(len(b) >= block_bytes for b in bufs):
                yield ([bytes(b[:block_bytes]) for b in bufs],
                       block_bytes // bpf, pending_reset)
                pending_reset = False
                for b in bufs:
                    del b[:block_bytes]
                continue
            valid = min(len(b) // bpf for b in bufs)
            if valid:
                yield ([bytes(b[:valid * bpf]) for b in bufs], valid,
                       pending_reset)
            return

    # ------------------------------------------------------------- chain

    def _run_chain(self) -> StreamSummary:
        ch = self.chain
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
        reader = _Reader(gen_fn(block_bytes, bpf, skip_frames * bpf))
        writer = _Writer(self.sinks, ch.fmt_out.items_per_frame, s,
                         self.pipeline_depth)
        # the cut before a zero-padded partial block: (host carry, frames
        # in), fetched before that block's step
        pre_partial = None

        def process(chunks: list[bytes], valid_frames: int, reset: bool):
            nonlocal carry, scheduled_out, pre_partial
            if valid_frames < ch.n_in and self.checkpoint_path:
                # keep the oldest clean cut: on consecutive partials (a
                # pre-gap drain, then the EOS tail) the live carry has
                # already seen padding
                if pre_partial is None:
                    pre_partial = (ch.carry_to_numpy(carry), s.frames_in)
            else:
                # a full block makes the live carry consistent again
                pre_partial = None
            rows = []
            for chunk in chunks:
                if len(chunk) < block_bytes:
                    chunk = chunk + b"\x00" * (block_bytes - len(chunk))
                rows.append(np.frombuffer(chunk, dtype=ch.in_wire_dtype))
            host_in = torch.from_numpy(np.stack(rows, axis=0))
            if on_cuda:
                raw = host_in.pin_memory().to(ch.device, non_blocking=True)
            else:
                raw = host_in
            carry, out = ch.step(carry, raw, reset)
            s.frames_in += valid_frames
            allowed = ch.expected_out_frames(s.frames_in)
            emit = max(0, min(allowed - scheduled_out, ch.n_out))
            scheduled_out += emit
            ready = None
            if on_cuda:
                host_out = torch.empty(out.shape, dtype=out.dtype,
                                       pin_memory=True)
                host_out.copy_(out, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record()
            else:
                host_out = out
            writer.put(host_out, ready, emit)   # blocks when the pipe is full

        def consistent_cut():
            if pre_partial is not None:
                c, fin = pre_partial
                return c, fin, min(s.frames_out, ch.expected_out_frames(fin))
            return ch.carry_to_numpy(carry), s.frames_in, s.frames_out

        def maybe_checkpoint(now: float, last: float) -> float:
            if self.checkpoint_path and now - last >= self.checkpoint_interval:
                writer.flush()
                # a failed sink write sets error without dropped, yet its
                # block never landed: saving would put frames_in ahead of
                # the bytes on disk
                if not writer.dropped and writer.error is None:
                    save_checkpoint(self.checkpoint_path, *consistent_cut())
                return now
            return last

        try:
            while True:
                kind, payload, valid, reset = reader.get()
                if kind == "eos":
                    break
                if kind == "err":
                    raise payload
                process(payload, valid, reset)
                if writer.error is not None:
                    raise writer.error
                if writer.closed:
                    break
                last_prog = self._progress_tick(s, t0, last_prog)
                last_ckpt = maybe_checkpoint(time.monotonic(), last_ckpt)
            writer.flush()
        except KeyboardInterrupt:
            s.interrupted = True
            try:
                writer.flush()
            except Exception:
                pass                    # still return the summary
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
