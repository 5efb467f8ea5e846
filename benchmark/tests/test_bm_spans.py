"""The readers of the host engine's spans on the CPU: nothing where the
program keeps no span record (a program without one, or one that has
recorded no engine run), and each block's median of a small engine run
where it does."""

import sys
import types
from pathlib import Path

import pytest

from benchmark.tests.helpers import small_run

BENCH = Path(__file__).resolve().parents[1]
METRICS = ("engine_assemble_ms.engine", "engine_feed_ms.engine", "engine_write_ms.engine",
           "engine_input_wait_ms.engine", "engine_output_wait_ms.engine",
           "engine_block_transit_ms.engine")


def _reader(name):
    sys.path.insert(0, str(BENCH))
    import run as entry
    return entry.reader(name)


@pytest.mark.parametrize("name", METRICS)
def test_nothing_without_a_record(name, monkeypatch):
    from iq_tool_tpu_torch.pipeline import trace
    run = types.SimpleNamespace(mode="engine")
    monkeypatch.setattr(trace, "record", lambda: [])
    assert _reader(name)(run) is None
    # a program without the span module, as the parent of the spans was
    monkeypatch.setitem(sys.modules, "iq_tool_tpu_torch.pipeline.trace", None)
    assert _reader(name)(run) is None


def test_each_reader_reads_the_newest_engine_run():
    """After a small engine run every reader gives a positive median; the
    feed reads no less than its step, and a block's transit no less than
    its feed and write."""
    from iq_tool_tpu_torch.pipeline import trace
    run = small_run("baseline1-engine64")
    got = {name: _reader(name)(run) for name in METRICS}
    assert all(v is not None and v > 0 for v in got.values()), got
    newest = max(s.run for s in trace.record() if s.name.startswith("engine."))
    steps = sorted((s.end_ns - s.start_ns) / 1e6 for s in trace.record()
                   if s.run == newest and s.name == "engine.step")
    assert len(steps) == run.steps
    assert got["engine_feed_ms.engine"] >= steps[0]
    assert got["engine_block_transit_ms.engine"] >= max(got["engine_write_ms.engine"],
                                                        got["engine_assemble_ms.engine"])
