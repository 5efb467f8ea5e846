"""The baseline3-resident64 cell on the CPU: its files and plan, the split
of its banded bound among the DC kernel, K2's stages and the band-pass
pass, the port against the plain reference at a small size, a short
resident run through harness/drive.py and the check, the TF32 control at the
cell's limits, and the two readers of the program's stage record."""

import sys
import types
from pathlib import Path

import pytest
import torch

from benchmark import control
from benchmark.harness import bounds, cell as cells, check, drive, signal, trace
from benchmark.reference import design as D
from benchmark.reference.chain import RefChain, code_gap
from benchmark.tests.helpers import small_cell, small_run

BENCH = Path(__file__).resolve().parents[1]
NAME = "baseline3-resident64"
STAGES = {"chain.pre": {"dc_kernel": 1}, "chain.resample.0": {"banded_mma_kernel": 1},
          "chain.resample.1": {"banded_mma_kernel": 1},
          "chain.post_filter": {"banded_kernel": 1}}


def _reader(name):
    sys.path.insert(0, str(BENCH))
    import run as entry
    return entry.reader(name)


def test_the_cell_loads_and_its_plan():
    """cu8 at 2.4 Msps to 1.488375 Msps: 441/400 (interpolating) then
    9/16, 262400 frames in and 162729 out a step, the 102-215 kHz band
    after the resampler on a banded pass of its own."""
    cell = cells.load(NAME)
    assert cell.entry["chips"] == 1 and cell.config["reduced"] == []
    assert cell.chain["input_format"] == "cu8" and cell.chain["input_rate"] == 2.4e6
    assert {m["name"] for m in cell.e2e} == {"resident_msps", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "step_roofline.resident", "banded_roofline", "device_idle_pct.resident",
        "post_filter_roofline", "dc_roofline"}
    plan = D.plan_resampler(cell.chain["target_rate"] / cell.chain["input_rate"], cell.block)
    assert [(s.p, s.q) for s in plan.stages] == [(441, 400), (9, 16)]
    assert (plan.n_in, plan.n_out) == (262400, 162729)
    cell.traffic = dict(cell.traffic, channels=2)
    chain = cells.build_chain(cell, "cpu")
    assert (chain.n_in, chain.n_out) == (262400, 162729)
    assert [(s.p, s.q) for s in chain.resampler.stages] == [(441, 400), (9, 16)]
    taps = D.design_chain([tuple(f) for f in cell.chain["filters"]], cell.chain["target_rate"])
    assert len(taps) == 103 and bounds.filter_pass(cell.chain, taps) == "banded"


def test_the_readers_bounds_split_the_banded_bound():
    """The DC kernel's term, K2's two stages over planes and the band-pass
    pass's term sum to step_bounds' banded bound."""
    from benchmark.metrics.dc_roofline import dc_bound
    from benchmark.metrics.post_filter_roofline import post_filter_bound
    chain = cells.load(NAME).chain
    n = n_in = 262400
    k2 = 0.0
    for st in D.plan_resampler(chain["target_rate"] / chain["input_rate"], n_in).stages:
        g = D.group_stride(st.p, st.q, n)
        k2 += bounds._banded(D.banded_matrix(st, g).astype(complex), g * st.q, n, 64,
                             planes_in=True, packed_out=False, dc=False, wire=2)
        n = n * st.p // st.q
    dc, pf = dc_bound(chain, 64, n_in), post_filter_bound(chain, 64, n_in)
    assert dc > 0 and pf > 0 and k2 > 0
    assert dc + k2 + pf == pytest.approx(bounds.step_bounds(chain, 64, n_in, n)["banded"],
                                         rel=1e-12)
    # no term of their own where the chain runs no such pass, or blocks
    # DC inside K1
    assert post_filter_bound(cells.load("baseline1-resident64").chain, 64, 262144) is None
    assert dc_bound(cells.load("baseline1-resident64").chain, 64, 262144) is None
    k1 = dict(chain, filters=[])
    assert dc_bound(k1, 64, n_in) is None


def test_the_port_matches_the_reference_over_blocks():
    """4 channels x 16384 frames over 4 blocks of the cell's capture: the
    widest gap is rounding to the code grid (0.5) and float32 against
    float64."""
    torch.set_num_threads(4)
    cell = small_cell(NAME)
    chain = cells.build_chain(cell, "cpu")
    n = chain.n_in
    cap = signal.capture(2147483657, cell.channels, 4 * n, cell.chain["input_rate"],
                         cell.traffic["signal"], "cpu", "cu8")
    ref = RefChain(cell.chain, cell.channels, cell.block, 1, "cpu")
    assert ref.n_in == n and ref.n_out == chain.n_out
    carry, gaps = chain.init_carry(), []
    for k in range(4):
        w = cap[:, 2 * k * n:2 * (k + 1) * n]
        carry, out = chain.step(carry, w)
        gaps.append(code_gap(out, ref.step(w)))
    assert max(gaps) < 0.55, gaps


def test_a_short_resident_run_is_correct():
    """drive.py's resident mode ends its window on time, not on a count of
    blocks: a window that a loaded CPU leaves short of the blocks the
    check compares is run again, longer."""
    for seconds in (0.6, 2.4, 9.6):
        run = small_run(NAME, seconds=seconds)
        if run.total_steps >= drive.least_blocks(run.n_in):
            break
    assert run.mode == "resident" and run.inputs(0).dtype == torch.uint8
    numbers = check.check(run, "cpu")
    assert all(v <= lim for _, v, lim in numbers), numbers


def test_the_tf32_control_is_not_correct_at_the_cells_limits():
    torch.set_num_threads(4)
    cell = small_cell(NAME)
    numbers = check.check(control.control_run(cell, 2147483659, "cpu", 10), "cpu")
    assert not all(v <= lim for _, v, lim in numbers), numbers


def _run(kernels: dict, steps: int = 10):
    dev = trace.DeviceTrace(1.0, 0.5, kernels, [], [])
    return types.SimpleNamespace(dev_trace=dev, steps=steps, n_in=262400, rows=1,
                                 cell=cells.load(NAME))


def test_the_readers_share_of_each_stage(monkeypatch):
    """Each reader's share over a hand-made trace and stage record: the
    stage's own kernels' time, by symbol whatever the namespace and
    template arguments."""
    from benchmark.metrics.dc_roofline import dc_bound
    from benchmark.metrics.post_filter_roofline import post_filter_bound
    from iq_tool_tpu_torch.pipeline import trace as program
    monkeypatch.setattr(program, "stage_kernels", lambda: STAGES)
    run = _run({"void iqk::banded_kernel<2, true>(iqk::BandedArgs)": (0.004, 10),
                "void iqk::mma::banded_mma_kernel<1>(iqk::BandedArgs)": (0.005, 20),
                "void iqk::dc_kernel<false, false, true>(iqk::DcArgs)": (0.001, 10),
                "Memcpy DtoD (Device -> Device)": (0.0005, 10)})
    chain = run.cell.chain
    assert _reader("post_filter_roofline")(run) == pytest.approx(
        100 * post_filter_bound(chain, 64, 262400) * 10 / 0.004)
    assert _reader("dc_roofline")(run) == pytest.approx(
        100 * dc_bound(chain, 64, 262400) * 10 / 0.001)


@pytest.mark.parametrize("record", ["none", "no module", "no reader", "shared"])
def test_the_readers_read_nothing_without_a_record(monkeypatch, record):
    """Nothing where the program keeps no stage record (none captured, no
    span module, a program without the record, as the parent of the
    record was) or where a stage's kernel is launched by another stage
    too."""
    from iq_tool_tpu_torch.pipeline import trace as program
    run = _run({"void iqk::banded_kernel<2>(A)": (0.004, 10),
                "void iqk::dc_kernel<1>(B)": (0.001, 10)})
    if record == "none":
        monkeypatch.setattr(program, "stage_kernels", lambda: None)
    elif record == "no module":
        monkeypatch.setitem(sys.modules, "iq_tool_tpu_torch.pipeline.trace", None)
    elif record == "no reader":
        monkeypatch.delattr(program, "stage_kernels")
    else:
        shared = dict(STAGES, **{"chain.resample.0": {"banded_kernel": 1, "dc_kernel": 1}})
        monkeypatch.setattr(program, "stage_kernels", lambda: shared)
    assert _reader("post_filter_roofline")(run) is None
    assert _reader("dc_roofline")(run) is None
