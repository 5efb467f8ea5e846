"""The port's checkpoint/resume, stream engine and watchdog, written as the
JAX package's tests/test_infra.py and tests/test_runtime.py write their
cases: a resume reproduces the uninterrupted output bit for bit, a
checkpoint of another chain is refused, none is saved after a failed
sink write, an interrupt returns a summary even when the last flush
fails, and the watchdog fires on a stale heartbeat only.  The engine's
ring of input slots: a stream longer than the ring gives the chain's
bytes stepped block by block, a partial block keeps no byte of a slot's
earlier block, and a second run reuses the ring.
"""

import itertools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iq_tool_tpu.pipeline.chain import Chain as JaxChain  # noqa: E402
from iq_tool_tpu.pipeline.chain import ChainConfig as JaxConfig  # noqa: E402
from iq_tool_tpu.pipeline.checkpoint import load_checkpoint as jax_load  # noqa: E402
from iq_tool_tpu_torch.modules.base import (Block, InputModule, OutputModule,  # noqa: E402
                                            SourceInfo)
from iq_tool_tpu_torch.ops.fir_design import FilterRequest  # noqa: E402
from iq_tool_tpu_torch.parallel.sharded import Mesh, ShardedChain  # noqa: E402
from iq_tool_tpu_torch.pipeline import runtime  # noqa: E402
from iq_tool_tpu_torch.pipeline.chain import Chain, ChainConfig, carry_to_numpy  # noqa: E402
from iq_tool_tpu_torch.pipeline.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from iq_tool_tpu_torch.pipeline.graphed import GraphedStep, _leaves  # noqa: E402
from iq_tool_tpu_torch.pipeline.runtime import StreamEngine  # noqa: E402
from iq_tool_tpu_torch.utils.watchdog import Watchdog  # noqa: E402


class FakeSource(InputModule):
    name = "fake"

    def __init__(self, payload: bytes, cuts, fail_at=None):
        self._payload = payload
        self._cuts = list(cuts)
        self._fail_at = fail_at

    def initialize(self, config, args) -> SourceInfo:
        return SourceInfo(sample_rate=2_048_000.0, sample_format="cs16")

    def blocks(self, frames_per_block: int):
        pos = 0
        for i, cut in enumerate(self._cuts):
            if i == self._fail_at:
                raise KeyboardInterrupt
            yield Block(self._payload[pos:cut])
            pos = cut
        if pos < len(self._payload):
            yield Block(self._payload[pos:])


class FakeSink(OutputModule):
    name = "fake"
    requires_output_path = False

    def __init__(self):
        self.data = bytearray()

    def initialize(self, config, args) -> None:
        pass

    def write(self, payload: bytes) -> None:
        self.data.extend(payload)


def _cfg(**kw):
    base = dict(input_format="cs16", output_format="cs16", input_rate=2_048_000.0,
                target_rate=1_488_375.0, dc_block=True, agc_profile="local",
                filters=(FilterRequest("lowpass", 400_000.0),), target_block=4096)
    base.update(kw)
    return ChainConfig(**base)


def test_checkpoint_resume_exact(tmp_path, rng):
    """tests/test_infra.py:102: two blocks, a checkpoint, a reload, two
    more blocks give the uninterrupted run's bytes."""
    ch = Chain(_cfg(iq_correction=True, freq_shift_post_hz=-20e3), device="cpu")
    raws = [torch.from_numpy(rng.integers(-2 ** 14, 2 ** 14, (1, ch.in_wire_len))
                             .astype(np.int16)) for _ in range(4)]
    carry, outs = ch.init_carry(), []
    for raw in raws:
        carry, out = ch.step(carry, raw)
        outs.append(out.numpy())
    carry = ch.init_carry()
    for raw in raws[:2]:
        carry, _ = ch.step(carry, raw)
    path = str(tmp_path / "state.ckpt")
    save_checkpoint(path, ch.carry_to_numpy(carry), frames_in=2 * ch.n_in,
                    frames_out=2 * ch.n_out, meta={"cfg": "test"})
    carry2, fin, fout, extra = load_checkpoint(path, ch)
    assert (fin, fout, extra) == (2 * ch.n_in, 2 * ch.n_out, {"cfg": "test"})
    assert carry2["nco_pre"].dtype == torch.int64
    for k, v in carry.items():
        leaves = lambda c: (list(c) if isinstance(c, tuple) else
                            [getattr(c, f.name) for f in c.__dataclass_fields__.values()]
                            if hasattr(c, "__dataclass_fields__") else [c])
        for a, b in zip(leaves(v), leaves(carry2[k])):
            a, b = (a, b) if isinstance(a, torch.Tensor) else (torch.stack(a), torch.stack(b))
            assert a.dtype == b.dtype and torch.equal(a, b), k
    for i, raw in enumerate(raws[2:]):
        carry2, out = ch.step(carry2, raw)
        np.testing.assert_array_equal(out.numpy(), outs[2 + i])


def test_checkpoint_layout_is_the_references(tmp_path, rng):
    """The file holds the carry in the reference's layout: the JAX
    package's loader reads a port checkpoint of the same chain, and its
    leaves equal the port's carry_to_numpy leaves."""
    kw = dict(input_format="cs16", output_format="cs16", input_rate=2_048_000.0,
              target_rate=1_488_375.0, dc_block=True, agc_profile="local",
              target_block=4096)
    ch = Chain(ChainConfig(**kw), device="cpu")
    carry, _ = ch.step(ch.init_carry(), torch.from_numpy(
        rng.integers(-2 ** 14, 2 ** 14, (1, ch.in_wire_len)).astype(np.int16)))
    path = str(tmp_path / "s.ckpt")
    save_checkpoint(path, ch.carry_to_numpy(carry), ch.n_in, ch.n_out)
    jcarry, fin, fout, _ = jax_load(path, JaxChain(JaxConfig(**kw)).init_carry())
    assert (fin, fout) == (ch.n_in, ch.n_out)
    mine = carry_to_numpy(carry)
    np.testing.assert_array_equal(np.asarray(jcarry["nco_pre"]), mine["nco_pre"])
    for a, b in zip(jcarry["dc"], mine["dc"]):
        np.testing.assert_array_equal(np.asarray(a), b)
    for a, b in zip(jcarry["agc"], mine["agc"]):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_checkpoint_rejects_mismatched_chain(tmp_path):
    """tests/test_infra.py:140."""
    mk = lambda rate: Chain(ChainConfig(input_format="cs16", output_format="cs16",
                                        input_rate=1_000_000.0, target_rate=rate,
                                        target_block=4096), device="cpu")
    path = str(tmp_path / "s.ckpt")
    a, b = mk(500_000.0), mk(250_000.0)
    save_checkpoint(path, a.carry_to_numpy(a.init_carry()), 0, 0)
    with pytest.raises(ValueError, match="mismatch"):
        load_checkpoint(path, b)
    # same structure, another width: the leaf check
    save_checkpoint(path, a.carry_to_numpy(a.init_carry(2)), 0, 0)
    with pytest.raises(ValueError, match="checkpoint leaf mismatch"):
        load_checkpoint(path, a, a.init_carry(1))


def _engine_chain():
    return Chain(ChainConfig(input_format="cs16", output_format="cs16",
                             input_rate=2_048_000.0, target_rate=1_536_000.0,
                             dc_block=True, freq_shift_pre_hz=100e3,
                             filters=(FilterRequest("lowpass", 400e3),),
                             target_block=2048), device="cpu")


def test_no_checkpoint_after_sink_write_failure(tmp_path, rng):
    """tests/test_runtime.py:143: a sink write that fails (not
    OutputClosed) is not followed by a checkpoint: the saved cut never
    runs ahead of the bytes written."""

    class FailingSink(FakeSink):
        def write(self, payload: bytes) -> None:
            if len(self.data) >= 2 * len(payload):   # fail on the 3rd block
                time.sleep(0.2)        # lands during maybe_checkpoint's flush
                raise IOError("disk full")
            super().write(payload)

    chain = _engine_chain()
    payload = rng.integers(-2 ** 15, 2 ** 15, 2 * chain.n_in * 6).astype(np.int16).tobytes()
    sink = FailingSink()
    ckpt = str(tmp_path / "state.ckpt")
    eng = StreamEngine(chain, FakeSource(payload, [len(payload)]), sink,
                       checkpoint_path=ckpt, checkpoint_interval_sec=0.0,
                       pipeline_depth=1)
    with pytest.raises(IOError, match="disk full"):
        eng.run()
    _, fin, fout, _ = load_checkpoint(ckpt, chain)
    assert fout == chain.expected_out_frames(fin)
    assert fout * 4 == len(sink.data)


def test_engine_resume_skips_a_non_seekable_source(tmp_path, rng):
    """Resume on a source without seek_frames drops the consumed bytes
    from its stream (skip_bytes), across fragmented deliveries, and the
    two runs' bytes are the uninterrupted run's."""
    chain = _engine_chain()
    n = chain.n_in * 5 + 777
    payload = rng.integers(-2 ** 14, 2 ** 14, 2 * n).astype(np.int16).tobytes()
    full = FakeSink()
    StreamEngine(chain, FakeSource(payload, [1000, 50_000]), full).run()
    cut = 4 * (chain.n_in * 2 + 300)
    ckpt = str(tmp_path / "s.ckpt")
    first = FakeSink()
    s1 = StreamEngine(chain, FakeSource(payload[:cut], [cut // 3]), first,
                      checkpoint_path=ckpt).run()
    second = FakeSink()
    s2 = StreamEngine(chain, FakeSource(payload, [333, 9000, 70_000]), second,
                      checkpoint_path=ckpt, resume=True).run()
    _, fin, fout, _ = load_checkpoint(ckpt, chain)
    assert s1.frames_in == cut // 4 and s2.frames_in == n
    # each run's last checkpoint is its cut before the zero-padded tail
    assert fin == (n // chain.n_in) * chain.n_in and fout == chain.expected_out_frames(fin)
    got = bytes(first.data[:4 * (2 * chain.n_out)]) + bytes(second.data)
    assert got == bytes(full.data)


def test_interrupt_returns_summary_when_flush_fails(rng, monkeypatch):
    """An interrupt whose last writer flush fails still returns the
    summary (the reference engine guards that flush)."""
    chain = _engine_chain()
    payload = rng.integers(-2 ** 14, 2 ** 14, 2 * chain.n_in * 4).astype(np.int16).tobytes()
    cuts = [4 * chain.n_in * k for k in (1, 2, 3)]

    def failing_flush(self):
        raise OSError("flush failed")

    monkeypatch.setattr(runtime._Writer, "flush", failing_flush)
    s = StreamEngine(chain, FakeSource(payload, cuts, fail_at=2), FakeSink()).run()
    assert s.interrupted and s.frames_in == 2 * chain.n_in


class CutSource(InputModule):
    """A source whose k-th pass (``blocks`` call) yields its k-th stream,
    in payloads of ``sizes`` bytes in turn."""
    name = "cut"

    def __init__(self, streams, sizes):
        self._streams = list(streams)
        self._sizes = sizes

    def initialize(self, config, args) -> SourceInfo:
        return SourceInfo(sample_rate=2_048_000.0, sample_format="cs16")

    def blocks(self, frames_per_block: int):
        stream, pos = self._streams.pop(0), 0
        for size in itertools.cycle(self._sizes):
            if pos >= len(stream):
                return
            yield Block(stream[pos:pos + size])
            pos += size


def _ring_chain(stepper: str, channels: int):
    cfg = ChainConfig(input_format="cs16", output_format="cs16", input_rate=2_048_000.0,
                      target_rate=1_536_000.0, dc_block=True, freq_shift_pre_hz=100e3,
                      filters=(FilterRequest("lowpass", 400e3),), agc_profile="local",
                      target_block=2048, channels=channels)
    if stepper == "graphed":
        return Chain(cfg, device="cpu")
    # a time row over two device names steps eagerly (sharded_eager_reason)
    return ShardedChain(cfg, Mesh([["cpu", "cpu:0"]]))


def _engine(chain, streams, sizes):
    """An engine over one CutSource and one FakeSink a channel."""
    sinks = [FakeSink() for _ in streams[0]]
    sources = [CutSource([s[c].tobytes() for s in streams], sizes) for c in range(len(sinks))]
    return StreamEngine(chain, sources, sinks), sinks


RING_SLOTS = runtime.C.HOST_QUEUE_DEPTH + 2


@pytest.mark.parametrize("stepper", ["graphed", "eager"])
@pytest.mark.parametrize("channels", [1, 3])
def test_engine_ring_gives_the_stepped_bytes(rng, channels, stepper):
    """A stream of more blocks than the ring has slots, its payloads cut
    at odd sizes, its last block partial: each sink's bytes are the
    chain's stepped block by block over the zero-padded stream, trimmed,
    on the graphed step and on an eager one (handed a copy of its slot)."""
    chain = _ring_chain(stepper, channels)
    blocks = RING_SLOTS + 4
    n = chain.n_in * (blocks - 1) + 777
    payload = rng.integers(-2 ** 14, 2 ** 14, (channels, 2 * n)).astype(np.int16)
    wire = np.zeros((channels, blocks * chain.in_wire_len), np.int16)
    wire[:, :2 * n] = payload
    carry, outs = chain.init_carry(), []
    for b in np.split(wire, blocks, axis=1):
        carry, out = chain.step(carry, torch.from_numpy(b.copy()))
        outs.append(out.numpy().copy())
    want = np.concatenate(outs, -1)[:, :2 * chain.expected_out_frames(n)]
    eng, sinks = _engine(chain, [payload], [1000, 50_000, 333])
    assert eng.run().frames_in == n
    assert isinstance(eng.stepper, GraphedStep) == (stepper == "graphed")
    assert len(eng._ring.slots) == RING_SLOTS < blocks
    assert [bytes(s.data) for s in sinks] == [row.tobytes() for row in want]


def test_engine_partial_block_keeps_no_stale_bytes(rng):
    """A run's partial block lands in a slot whose last block, the run
    before's, was full of non-zero data: its output and the final carry
    are a fresh engine's over that block alone."""
    chain = _ring_chain("graphed", 2)
    full = rng.integers(-2 ** 14, 2 ** 14, (2, 2 * chain.n_in * (RING_SLOTS + 2)))
    part = rng.integers(-2 ** 14, 2 ** 14, (2, 2 * (chain.n_in // 2 + 5)))
    full, part = full.astype(np.int16), part.astype(np.int16)
    eng, sinks = _engine(chain, [full, part], [50_000])
    eng.run()
    assert [s.count_nonzero() > 0 for s in eng._ring.slots] == [True] * RING_SLOTS
    for s in sinks:
        s.data.clear()
    eng.run()
    fresh, fresh_sinks = _engine(chain, [part], [50_000])
    fresh.run()
    assert [bytes(s.data) for s in sinks] == [bytes(s.data) for s in fresh_sinks]
    assert bytes(sinks[0].data)
    for a, b in zip(_leaves(eng.stepper._carry), _leaves(fresh.stepper._carry)):
        assert torch.equal(a, b)


def test_engine_second_run_reuses_the_ring(rng):
    """A second run of one engine writes into the slots the first made and
    gives the first run's bytes."""
    chain = _ring_chain("graphed", 3)
    payload = rng.integers(-2 ** 14, 2 ** 14, (3, 2 * (chain.n_in * 12 + 99))).astype(np.int16)
    eng, sinks = _engine(chain, [payload, payload], [1000, 50_000, 333])
    eng.run()
    ptrs = [s.data_ptr() for s in eng._ring.slots]
    first = [bytes(s.data) for s in sinks]
    for s in sinks:
        s.data.clear()
    eng.run()
    assert [s.data_ptr() for s in eng._ring.slots] == ptrs
    assert [bytes(s.data) for s in sinks] == first


def test_watchdog_fires():
    """tests/test_infra.py:81 on the port's copy."""
    fired = []
    hb = time.monotonic() - 100.0
    w = Watchdog(lambda: hb, stale_sec=0.2, poll_sec=0.05,
                 on_stale=lambda msg: fired.append(msg))
    w.start()
    time.sleep(0.4)
    w.stop()
    assert fired and "stalled" in fired[0]


def test_watchdog_quiet_when_alive():
    """tests/test_infra.py:92 on the port's copy."""
    fired = []
    w = Watchdog(time.monotonic, stale_sec=1.0, poll_sec=0.05,
                 on_stale=lambda msg: fired.append(msg))
    w.start()
    time.sleep(0.3)
    w.stop()
    assert not fired
