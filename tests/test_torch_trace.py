"""The port's spans (``pipeline/trace.py``): the host engine's spans a
block on its three threads, the chain's stage spans under a profiler,
the record's bound and clock, and ``GraphedStep``'s stage map.

The file imports no jax: its card-only test (marked ``gpu``, skipped
without a card) runs on a machine that has only torch:

    pytest --noconftest -m gpu tests/test_torch_trace.py
"""

import collections
import statistics
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iq_tool_tpu_torch.modules.base import Block, InputModule, OutputModule, SourceInfo  # noqa: E402
from iq_tool_tpu_torch.ops import convert  # noqa: E402
from iq_tool_tpu_torch.ops.fir_design import FilterRequest  # noqa: E402
from iq_tool_tpu_torch.pipeline import trace  # noqa: E402
from iq_tool_tpu_torch.pipeline.chain import Chain, ChainConfig  # noqa: E402
from iq_tool_tpu_torch.pipeline.graphed import GraphedStep, _stage_map  # noqa: E402
from iq_tool_tpu_torch.pipeline.runtime import StreamEngine  # noqa: E402

# the spans every block has, and the thread each runs on
BLOCK_SPANS = {"engine.source": "iq-reader", "engine.wait_slot": "iq-reader",
               "engine.assemble": "iq-reader", "engine.wait_input": "MainThread",
               "engine.h2d": "MainThread", "engine.step": "MainThread",
               "engine.d2h": "MainThread", "engine.wait_output": "MainThread",
               "engine.wait_device": "iq-writer", "engine.write": "iq-writer",
               "engine.transit": None}


class ToneSource(InputModule):
    """One channel of a seeded cs16 stream, in source blocks of ``cut``
    frames."""
    name = "tone"

    def __init__(self, frames: int, cut: int, seed: int):
        rng = np.random.default_rng(seed)
        self._payload = rng.integers(-2 ** 14, 2 ** 14, 2 * frames).astype(np.int16).tobytes()
        self._cut = 4 * cut

    def initialize(self, config, args) -> SourceInfo:
        return SourceInfo(sample_rate=2_048_000.0, sample_format="cs16")

    def blocks(self, frames_per_block: int):
        for pos in range(0, len(self._payload), self._cut):
            yield Block(self._payload[pos:pos + self._cut])


class KeepSink(OutputModule):
    name = "keep"
    requires_output_path = False

    def __init__(self):
        self.data = bytearray()

    def initialize(self, config, args) -> None:
        pass

    def write(self, payload: bytes) -> None:
        self.data.extend(payload)


def _chain(channels: int, **kw) -> Chain:
    base = dict(input_format="cs16", output_format="cs16", input_rate=2_048_000.0,
                target_rate=1_488_375.0, channels=channels, target_block=2048)
    base.update(kw)
    return Chain(ChainConfig(**base), device="cpu")


CONFIG4 = dict(dc_block=True, iq_correction=True, freq_shift_pre_hz=100e3,
               freq_shift_post_hz=-50e3, agc_profile="local",
               filters=(FilterRequest("stop-range", 0.0, 10e3),))


@pytest.fixture(scope="module")
def engine_run():
    """A 3-channel engine run over 5 full blocks and a partial one, its
    sources cutting each block in three: (engine, the run's engine.*
    spans; the chain's own nest in engine.step)."""
    chain = _chain(3)
    frames = 5 * chain.n_in + chain.n_in // 2
    eng = StreamEngine(chain, [ToneSource(frames, chain.n_in // 3 + 7, s) for s in range(3)],
                       [KeepSink() for _ in range(3)], pipeline_depth=2)
    summary = eng.run()
    assert summary.frames_in == frames
    return eng, [s for s in trace.record()
                 if s.run == eng.serial and s.name.startswith("engine.")]


def test_engine_spans_one_of_each_a_block(engine_run):
    """Each block of a run has one of each per-block span, under the run's
    serial and its index, on its thread; the run has one engine.start and
    one engine.drain, and a second run another serial."""
    eng, spans = engine_run
    blocks = 6
    per = collections.Counter((s.name, s.block) for s in spans if s.block is not None)
    assert per == {(name, k): 1 for name in BLOCK_SPANS for k in range(blocks)}
    for s in spans:
        if s.name in BLOCK_SPANS:
            assert s.thread == BLOCK_SPANS[s.name], s
            assert s.start_ns <= s.end_ns, s
    assert [s.name for s in spans if s.block is None and s.thread == "MainThread"
            and s.name != "engine.wait_input"] == ["engine.start", "engine.drain"]
    serial = eng.serial
    eng.run()
    assert eng.serial == serial + 1


def test_engine_spans_tile_each_thread(engine_run):
    """On each thread the spans do not overlap and sum to no more than the
    run's wall time (engine.start's start to engine.drain's end); the
    main thread is inside a span from the run's start to its end, but for
    the Python between two spans; a block's transit starts after its
    source span and ends after its write."""
    _, spans = engine_run
    start = next(s for s in spans if s.name == "engine.start")
    drain = next(s for s in spans if s.name == "engine.drain")
    wall = drain.end_ns - start.start_ns
    for thread in ("MainThread", "iq-reader", "iq-writer"):
        mine = sorted((s for s in spans if s.thread == thread), key=lambda s: s.start_ns)
        assert mine, thread
        for a, b in zip(mine, mine[1:]):
            assert a.end_ns <= b.start_ns, (a, b)
        assert sum(s.end_ns - s.start_ns for s in mine) <= wall
        assert start.start_ns <= mine[0].start_ns and mine[-1].end_ns <= drain.end_ns
    main = sorted((s for s in spans if s.thread == "MainThread"), key=lambda s: s.start_ns)
    assert main[0] is start and main[-1] is drain
    assert max(b.start_ns - a.end_ns for a, b in zip(main, main[1:])) < 50e6
    by = {(s.name, s.block): s for s in spans}
    for k in range(6):
        transit = by["engine.transit", k]
        assert by["engine.source", k].end_ns <= transit.start_ns
        assert by["engine.write", k].end_ns <= transit.end_ns


def test_record_stays_at_its_bound():
    """The record keeps the newest CAPACITY spans."""
    for k in range(trace.CAPACITY + 100):
        trace.add("test.bound", k, k + 1, -1, k)
    rec = trace.record()
    assert len(rec) == trace.CAPACITY
    assert rec[0].block == 100 and rec[-1].block == trace.CAPACITY + 99


def test_record_on_the_profilers_clock():
    """Under a CPU profiler a span is also a profiler range of its name,
    starting where the record says (the profiler stamps the wall clock;
    a process's first range, which makes the range's handle type, is
    left out); with no profiler it opens none."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trace.new_run()
        with trace.span("test.first"):
            pass
        for k in range(20):
            with trace.span("test.clock", k):
                torch.ones(64).sum()
    rec = {s.block: s for s in trace.record() if s.name == "test.clock"}
    kin = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                 if e.name() == "test.clock")
    assert len(kin) == 20
    diffs = [abs(k - rec[i].start_ns) / 1e6 for i, k in enumerate(kin)]
    assert statistics.median(diffs) < 0.1 and max(diffs) < 1.0, diffs
    with trace.span("test.off") as sp:
        assert sp._range is None


def test_spans_of_other_threads_reach_the_record():
    """A span on a thread the profiler does not record lands in the record
    under that thread's name."""
    def work():
        with trace.span("test.thread", 7):
            pass
    t = threading.Thread(target=work, name="test-thread")
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert any(s.name == "test.thread" and s.thread == "test-thread" and s.block == 7
               for s in trace.record())


@pytest.mark.parametrize("fields, stages", [
    (dict(dc_block=True, freq_shift_pre_hz=100e3, filters=(FilterRequest("lowpass", 400e3),)),
     ["chain.resample.0", "chain.resample.1"]),
    (CONFIG4, ["chain.pre", "chain.iq_estimate", "chain.resample.0", "chain.resample.1",
               "chain.post_filter", "chain.post", "chain.agc"]),
    (dict(iq_correction=True, freq_shift_pre_hz=100e3, agc_profile="local"),
     ["chain.pre", "chain.iq_estimate", "chain.resample.0", "chain.resample.1",
      "chain.post", "chain.agc"]),
], ids=["flagship", "config4", "config4-no-dc"])
def test_eager_step_names_its_stages(fields, stages):
    """An eager Chain.step under a CPU profiler shows each stage's span."""
    chain = _chain(2, **fields)
    raw = torch.zeros((2, chain.in_wire_len), dtype=torch.int16)
    carry = chain.init_carry()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        chain.step(carry, raw)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert set(stages) <= names, sorted(n for n in names if n.startswith("chain."))
    assert not any(n.startswith("chain.") for n in names - set(stages))


def test_stage_map_from_marks():
    """Each captured node goes to the innermost span open at its capture,
    a node captured outside every span to none; a stage split by a span
    inside it is two entries, adjacent pieces of one stage one."""
    marks = [("a", True, 0), ("a", False, 3), ("b", True, 3), ("c", True, 4),
             ("c", False, 6), ("b", False, 7), ("x", True, 8), ("x", False, 8),
             ("a", True, 9), ("a", False, 10), ("a", True, 10), ("a", False, 12)]
    assert _stage_map(marks) == [("a", 3), ("b", 1), ("c", 2), ("b", 1), ("a", 3)]


def test_split_launches_by_the_stage_map():
    """profile_steps' split: events grouped by their launch, the skipped
    first launch and a launch whose count is not the map's left out, each
    other launch's k-th event (by start) to the map's k-th node; busy is
    the union of a launch's events."""
    from iq_tool_tpu_torch.profile_steps import split_launches
    events = [(7, 100, 10, "void k1<1>(x)"), (7, 110, 5, "void k2(x)"),
              (8, 215, 3, "Memcpy DtoD"), (8, 200, 10, "void k1<1>(x)"),
              (8, 212, 5, "void k2(x)"),
              (9, 300, 10, "void k1<1>(x)"), (9, 305, 10, "void k2(x)"),
              (9, 320, 3, "Memcpy DtoD"),
              (10, 400, 1, "void k1<1>(x)")]
    sp = split_launches(events, [("a", 1), ("b", 2)], skip=1)
    assert (sp["replays"], sp["split"], sp["nodes"], sp["events"]) == (3, 2, 3, [1, 3, 3])
    assert sp["stages"] == pytest.approx({"a": 10e-6, "b": 10.5e-6})
    assert sp["ops"]["b"] == pytest.approx({"k2": 7.5e-6, "Memcpy DtoD": 3e-6})
    assert sp["busy_ms"] == pytest.approx(17e-6) and sp["sum_ms"] == pytest.approx(20.5e-6)


def test_device_work_leaves_out_the_spans_images():
    """A span's range shows on the card's timeline under its own name
    (kineto's gpu_user_annotation): profile_steps counts kernels and
    copies, not those."""
    import types
    from iq_tool_tpu_torch.profile_steps import device_work

    def ev(name, kind):
        return types.SimpleNamespace(name=lambda: name,
                                     device_type=lambda: types.SimpleNamespace(name=kind))
    events = [ev("chain.pre", "CPU"), ev("cudaLaunchKernel", "CPU"), ev("chain.pre", "CUDA"),
              ev("void iqk::dc_kernel<1>(x)", "CUDA"), ev("Memcpy DtoD (Device -> Device)", "CUDA")]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    assert [e.name() for e in device_work(prof)] == ["void iqk::dc_kernel<1>(x)",
                                                     "Memcpy DtoD (Device -> Device)"]


# a HackRF One's cs8 at 10 Msps through upstream's preset cs16-fm-nrsc5:
# the gather stage of 4766/64043 and the digital AGC
HACKRF = dict(input_format="cs8", input_rate=10e6, target_rate=744_187.5,
              agc_profile="digital")


@pytest.mark.parametrize("fields, agc", [
    (HACKRF, True),
    (dict(CONFIG4, dc_block=False), True),
    (dict(CONFIG4, agc_profile="dx"), True),
    ({}, False),
], ids=["hackrf", "full4", "config4-dx", "baseline1"])
def test_the_agc_is_a_stage_inside_the_post_stage(fields, agc):
    """An eager step opens ``chain.agc`` for the AGC's gain work of every
    profile, nested in ``chain.post`` (so a capture's map splits it from
    K4's pack); a chain without an AGC opens none."""
    chain = _chain(2, **{**fields, "target_block": 65536})
    raw = torch.zeros((2, chain.in_wire_len), dtype=convert.torch_wire_dtype(chain.fmt_in))
    seen = []
    with trace.observe(lambda name, opening: seen.append((name, opening))):
        chain.step(chain.init_carry(), raw)
    assert (("chain.agc", True) in seen) == agc, seen
    if agc:
        i, j = seen.index(("chain.agc", True)), seen.index(("chain.agc", False))
        assert seen[i - 1] == ("chain.post", True) and seen[j + 1] == ("chain.post", False)
        assert seen.count(("chain.agc", True)) == 1


def test_the_stage_map_is_none_until_a_capture():
    """A fresh process, and a CPU GraphedStep's steps (the CPU captures
    nothing), publish no stage map."""
    import subprocess
    import sys
    code = ("import torch\n"
            "from iq_tool_tpu_torch.pipeline import trace\n"
            "from iq_tool_tpu_torch.pipeline.chain import Chain, ChainConfig\n"
            "from iq_tool_tpu_torch.pipeline.graphed import GraphedStep\n"
            "assert trace.stage_map() is None\n"
            "g = GraphedStep(Chain(ChainConfig(input_format='cs16', output_format='cs16',"
            " input_rate=2048000.0, target_rate=1488375.0, channels=2, target_block=2048),"
            " device='cpu'))\n"
            "g.step(g.init_carry(), g.input_buffer)\n"
            "assert trace.stage_map() is None and g.stages == []\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


def test_the_newest_captures_stage_map_is_published():
    """``stage_map()`` gives the newest published map and node count, as a
    copy; a capture of several graphs publishes None."""
    old = trace.stage_map()
    try:
        trace.publish_stage_map([("chain.pre", 1), ("chain.resample.0", 5)], 6)
        trace.publish_stage_map([("chain.resample.0", 9), ("chain.agc", 20),
                                 ("chain.post", 1), ("graph.carry", 2)], 32)
        got = trace.stage_map()
        assert got == ([("chain.resample.0", 9), ("chain.agc", 20), ("chain.post", 1),
                        ("graph.carry", 2)], 32)
        got[0].clear()
        assert len(trace.stage_map()[0]) == 4
        trace.publish_stage_map(None)
        assert trace.stage_map() is None
    finally:
        trace.publish_stage_map(*(old if old is not None else (None,)))


def test_graphed_step_on_the_cpu_has_no_stage_map():
    """The CPU captures no graph: the map stays empty and the step still
    marks its stages in the record."""
    g = GraphedStep(_chain(2, **CONFIG4))
    g.step(g.init_carry(), g.input_buffer)
    assert g.stages == [] and g.graph_nodes == 0
    assert {"chain.post", "graph.carry"} <= {s.name for s in trace.record()[-20:]}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["flagship", "4"])
def test_stage_map_covers_the_graph(name):
    """On the card: the stage map of the flagship's and config #4's
    captured step counts every device node of the graph, and a replay
    still equals the eager step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from iq_tool_tpu_torch.profile_steps import config, tone_wire
    chain = Chain(config(name, 8, 16384), device="cuda")
    g = GraphedStep(chain)
    g.capture()
    assert sum(n for _, n in g.stages) == g.graph_nodes > 0
    assert g.stages[-1][0] == "graph.carry"
    assert trace.stage_map() == (g.stages, g.graph_nodes)
    assert ("chain.agc" in dict(g.stages)) == (name == "4")
    raw = tone_wire(8, chain.n_in, torch.Generator(device="cuda").manual_seed(5))
    _, want = chain.step(chain.init_carry(), raw)
    g.input_buffer.copy_(raw)
    _, got = g.step(g.init_carry(), g.input_buffer)
    assert torch.equal(got, want)


def test_note_counts_under_the_innermost_stage():
    """A launch is noted under the innermost stage (a chain.* span) open
    on its thread: a plain span inside it keeps the stage, a nested stage
    takes it over until it closes, and a launch outside every stage is
    noted under None."""
    before = trace.launches()
    with trace.span("engine.step"):
        trace.note("outside_kernel")
        with trace.stage_span("chain.pre"):
            trace.note("dc_kernel")
            with trace.span("graph.carry"):
                trace.note("dc_kernel")
            with trace.stage_span("chain.resample.0"):
                trace.note("banded_mma_kernel")
            trace.note("pre_kernel")
    trace.note("outside_kernel")
    assert trace.stage_launches(before, trace.launches()) == {
        None: {"outside_kernel": 2},
        "chain.pre": {"dc_kernel": 2, "pre_kernel": 1},
        "chain.resample.0": {"banded_mma_kernel": 1}}


def test_note_keeps_each_threads_stage():
    """Another thread's launch is noted under its own open span, not under
    the span this thread has open."""
    before = trace.launches()

    def work():
        with trace.stage_span("chain.post"):
            trace.note("post_kernel")
    with trace.stage_span("chain.post_filter"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=10)
        trace.note("banded_kernel")
    assert trace.stage_launches(before, trace.launches()) == {
        "chain.post": {"post_kernel": 1}, "chain.post_filter": {"banded_kernel": 1}}


def test_note_loses_no_launch_across_threads():
    """Eight threads noting under one stage, switching every microsecond:
    every launch is counted."""
    import sys
    before = trace.launches()
    interval = sys.getswitchinterval()

    def work():
        with trace.stage_span("chain.stress"):
            for _ in range(5000):
                trace.note("stress_kernel")
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert trace.stage_launches(before, trace.launches()) == {
        "chain.stress": {"stress_kernel": 40000}}


def test_launch_counters_count_as_before():
    """A launch still moves its wrappers' ``launches`` counters (K2 on the
    mma.sync core both of its names'), which ``launch_counts`` and
    ``reset_launch_counts`` read and clear, and is noted once under its
    kernel's symbol."""
    from iq_tool_tpu_torch.ops import kernels
    kernels.reset_launch_counts()
    before = trace.launches()
    with trace.stage_span("chain.resample.1"):
        kernels._launched("banded_mma_kernel", kernels.banded_apply, kernels.banded_apply_mma)
    with trace.stage_span("chain.post_filter"):
        kernels._launched("banded_kernel", kernels.banded_apply)
    with trace.stage_span("chain.pre"):
        kernels._launched("dc_kernel", kernels.dc_block_apply)
    counts = kernels.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "banded_apply": 2, "banded_apply_mma": 1, "dc_block_apply": 1}
    assert trace.stage_launches(before, trace.launches()) == {
        "chain.resample.1": {"banded_mma_kernel": 1}, "chain.post_filter": {"banded_kernel": 1},
        "chain.pre": {"dc_kernel": 1}}
    kernels.reset_launch_counts()
    assert not any(kernels.launch_counts().values())


def test_the_newest_captures_stage_kernels_are_published():
    """``stage_kernels()`` gives the newest published map, as a copy."""
    trace.publish_stage_kernels({"chain.pre": {"dc_kernel": 1}})
    trace.publish_stage_kernels({"chain.post_filter": {"banded_kernel": 1}})
    got = trace.stage_kernels()
    assert got == {"chain.post_filter": {"banded_kernel": 1}}
    got["chain.post_filter"]["banded_kernel"] = 5
    assert trace.stage_kernels() == {"chain.post_filter": {"banded_kernel": 1}}


def test_graphed_step_on_the_cpu_notes_no_kernel():
    """The CPU runs the kernels' twins, which launch nothing: a DC +
    band-pass chain's GraphedStep on the CPU has no stage kernels."""
    g = GraphedStep(_chain(2, input_format="cu8", dc_block=True, filter_method="fft",
                           filters=(FilterRequest("pass-range", 102e3, 215e3),)))
    before = trace.launches()
    g.step(g.init_carry(), g.input_buffer)
    assert g.stage_kernels == {} and g.kernels == {}
    assert trace.launches() == before


def test_cli_summary_lists_each_stage_with_its_kernels(tmp_path, monkeypatch):
    """The CLI's end summary has a row a stage of the step: its host time
    and the kernels it launches (none on the CPU, whose twins launch
    nothing); a graphed stepper's rows take the capture's kernels."""
    import types
    from iq_tool_tpu_torch import cli
    tables = {}
    monkeypatch.setattr(cli, "_print_summary_table",
                        lambda title, items, file=None: tables.__setitem__(title, items))
    inp = tmp_path / "in.cu8"
    inp.write_bytes(np.random.default_rng(3).integers(0, 256, 2 * 40000)
                    .astype(np.uint8).tobytes())
    assert cli.main(["--device", "cpu", "-i", "raw-file", "-o", "raw",
                     "--raw-file-input-rate", "2400000", "--raw-file-input-sample-format",
                     "cu8", "--output-rate", "1488375", "--dc-block", "--pass-range",
                     "102e3:215e3", "--filter-type", "fft", str(inp),
                     str(tmp_path / "out.raw")]) == 0
    rows = tables["Step Stages (host ms, kernels; a step)"]
    assert set(rows) == {"chain.pre", "chain.resample.0", "chain.resample.1",
                         "chain.post_filter"}, rows
    assert all(r.endswith(" ms; no kernel") for r in rows.values()), rows
    trace.new_run()
    with trace.span("engine.step"):
        pass
    eng = types.SimpleNamespace(serial=trace._run, stepper=types.SimpleNamespace(
        stage_kernels={"chain.pre": {"dc_kernel": 1},
                       "chain.post_filter": {"banded_kernel": 1}}))
    assert cli._stage_rows(eng, trace.launches()) == {
        "chain.pre": "in the graph; dc_kernel x1",
        "chain.post_filter": "in the graph; banded_kernel x1"}


@pytest.mark.gpu
def test_capture_records_each_stages_kernels():
    """On the card: the capture of a DC + band-pass chain (the benchmark's
    baseline3 at 4 channels) notes each stage's kernels, which the trace
    publishes as the newest capture's; the launch counters count the
    same launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from iq_tool_tpu_torch.profile_steps import config
    g = GraphedStep(Chain(config("baseline3", 4, 65536), device="cuda"))
    g.capture()
    want = {"chain.pre": {"dc_kernel": 1}, "chain.resample.0": {"banded_mma_kernel": 1},
            "chain.resample.1": {"banded_mma_kernel": 1},
            "chain.post_filter": {"banded_kernel": 1}}
    assert g.stage_kernels == want and trace.stage_kernels() == want
    assert g.kernels == {"dc_block_apply": 1, "banded_apply": 3, "banded_apply_mma": 2}
    before = trace.launches()
    g.step(g._carry, g.input_buffer)
    torch.cuda.synchronize()
    assert trace.launches() == before          # a replay notes nothing
