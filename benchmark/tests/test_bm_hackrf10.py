"""The HackRF cell's files (``configs/hackrf10.json``,
``workloads/hackrf10-resident64.json``) and the ``gather_roofline``
reader's split of a traced window by the program's stage map, on
synthetic events."""

import gc
import types

import pytest
import torch

from benchmark.harness import bounds, cell as cells
from benchmark.tests.helpers import HACKRF, HACKRF_AGC_STATE_LIMIT, hackrf_cell
from benchmark.run import reader

CELL = "hackrf10-resident64"


def test_the_cell_is_the_hackrf_deployment():
    """One chip, the resident traffic of the other cells (64 channels of
    262144-frame blocks, an 8-block ring, 4 in flight), the HackRF's cs8
    at 10 Msps to the preset's 744,187.5 Hz cs16 with the digital AGC and
    nothing else, the limits set from the card's readings; the in-memory
    HackRF chain and AGC limit of the tests are the files'."""
    cell = cells.load(CELL)
    assert cell.entry == {**cell.entry, "config": "hackrf10", "traffic": "resident",
                          "chips": 1}
    assert cell.config["reduced"] == []
    assert cell.chain == {**HACKRF, "filter_stage": "auto"}
    assert (cell.chain["input_format"], cell.chain["input_rate"], cell.chain["target_rate"],
            cell.chain["agc_profile"]) == ("cs8", 10e6, 744187.5, "digital")
    assert not (cell.chain["dc_block"] or cell.chain["iq_correction"] or cell.chain["filters"]
                or cell.chain["freq_shift_pre_hz"] or cell.chain["freq_shift_post_hz"])
    assert cell.workload["limits"] == {"start_gap_codes": 2.5, "end_gap_codes": 2.5,
                                       "end_median_gap_codes": 2.1,
                                       "end_agc_state_gap": HACKRF_AGC_STATE_LIMIT}
    assert cell.traffic == cells.load("baseline1-resident64").traffic
    assert (cell.channels, cell.block, cell.traffic["ring_blocks"],
            cell.traffic["in_flight"]) == (64, 262144, 8, 4)
    assert {m["name"] for m in cell.e2e} == {"resident_msps", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "step_roofline.resident", "device_idle_pct.resident", "gather_roofline"}


def test_the_cell_runs_one_gather_stage_between_k3pre_and_k4():
    chain = cells.build_chain(hackrf_cell(channels=2), "cpu")
    assert (chain.n_in, chain.n_out) == (256172, 19064)
    assert chain.route.pre == "K3pre" and chain.route.out == "K4"
    assert chain.resampler.plan.fallback and len(chain.resampler.stages) == 1
    mod = _reader_module()
    assert mod.gather_stage(cells.load(CELL).chain, 256172) == "chain.resample.0"
    assert mod.gather_stage(cells.load("baseline1-resident64").chain, 262144) is None


# ------------------------------------------------------------ the reader

def _reader_module():
    read = reader("gather_roofline")
    return types.SimpleNamespace(**read.__globals__)


MAP = [("chain.pre", 1), ("chain.resample.0", 3), ("chain.agc", 2), ("chain.post", 1),
       ("graph.carry", 1)]
NODES = 8


def _ev(name, kind, corr, t0=0, dur=0):
    return types.SimpleNamespace(name=lambda: name, correlation_id=lambda: corr,
                                 start_ns=lambda: t0, duration_ns=lambda: dur,
                                 device_type=lambda: types.SimpleNamespace(name=kind))


def _launch(corr: int, t0: int, nodes: int = NODES) -> list:
    """A graph launch's host event and its device events: node k takes k +
    1 us, the gather stage's three (nodes 1-3) 2, 3 and 4 us, 20 % of each
    node's duration apart, listed out of order of start."""
    evs = [_ev("cudaGraphLaunch", "CPU", corr)]
    t = t0
    for k in range(nodes):
        dur = 1000 * (k + 1)
        evs.append(_ev(f"void kernel_{k}<float>(x)", "CUDA", corr, t, dur))
        t += dur + dur // 5
    return [evs[0]] + evs[:0:-1]


def _run(chain: dict, n_in: int, events: list, prof=True):
    b = bounds.step_bounds(chain, 64, n_in, 19064)
    kin = types.SimpleNamespace(events=lambda: events)
    p = types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=kin))
    return types.SimpleNamespace(bounds=b, cell=types.SimpleNamespace(chain=chain),
                                 n_in=n_in, rows=1, prof=p if prof else None)


@pytest.fixture
def stage_map(monkeypatch):
    """Publish ``MAP`` as the program's newest capture's (or what the
    test sets)."""
    from iq_tool_tpu_torch.pipeline import trace
    box = {"map": (MAP, NODES)}
    monkeypatch.setattr(trace, "stage_map", lambda: box["map"])
    return box


def _window(bad: int = 0, launches: int = 6) -> list:
    """``launches`` graph launches, the first ``bad`` of them one event
    short, beside a copy launched outside the graph and a span's image on
    the card."""
    evs = [_ev("chain.post", "CPU", 0), _ev("chain.post", "CUDA", 0, 0, 10 ** 9)]
    for i in range(launches):
        evs += _launch(100 + i, 10 ** 6 * i, NODES - 1 if i < bad else NODES)
        evs += [_ev("cudaMemcpyAsync", "CPU", 200 + i),
                _ev("Memcpy DtoD (Device -> Device)", "CUDA", 200 + i, 10 ** 6 * i + 9, 50)]
    return evs


def test_the_split_gives_the_gather_stages_seconds(stage_map):
    """Each split launch's 2nd-4th events by start (2 + 3 + 4 us) are the
    gather stage's; the copy outside the graph, the span's image and the
    launches one event short count for nothing."""
    cell = cells.load(CELL)
    run = _run(cell.chain, 256172, _window(bad=2))
    mod = _reader_module()
    traced, split, sec = mod.split_stage(*mod.graph_events(run.prof), MAP, "chain.resample.0")
    assert (traced, split) == (6, 4) and sec == pytest.approx(4 * 9e-6)
    want = 100.0 * run.bounds["gather"] * 4 / (4 * 9e-6)
    assert reader("gather_roofline")(run) == pytest.approx(want)
    assert run.bounds["gather"] == pytest.approx(12.73e-6, rel=1e-3)


def test_under_half_the_launches_split_reads_nothing(stage_map):
    cell = cells.load(CELL)
    read = reader("gather_roofline")
    assert read(_run(cell.chain, 256172, _window(bad=3))) is not None
    assert read(_run(cell.chain, 256172, _window(bad=4))) is None


def test_no_map_reads_nothing(stage_map, monkeypatch):
    """No map published, a map that does not cover the graph, and a
    program without ``stage_map`` (the parent's)."""
    cell = cells.load(CELL)
    read = reader("gather_roofline")
    run = _run(cell.chain, 256172, _window())
    stage_map["map"] = None
    assert read(run) is None
    stage_map["map"] = (MAP, NODES + 1)
    assert read(run) is None
    from iq_tool_tpu_torch.pipeline import trace
    monkeypatch.delattr(trace, "stage_map")
    assert read(run) is None


def test_a_chain_without_a_gather_stage_reads_nothing(stage_map):
    chain = cells.load("baseline1-resident64").chain
    run = _run(chain, 262144, _window())
    assert "gather" not in run.bounds
    assert reader("gather_roofline")(run) is None


def test_the_reader_finds_the_stopped_profiler_the_harness_let_go():
    """``run.py`` drops ``run.prof`` once it has read the device trace;
    the stopped profiler is still in memory, and the reader takes it."""
    gc.collect()
    mod = _reader_module()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
    run = types.SimpleNamespace(prof=None)
    assert mod.traced_profile(run) is prof
    run.prof = object()
    assert mod.traced_profile(run) is run.prof
