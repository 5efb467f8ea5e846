"""The SDRplay AM cell (``configs/sdrplay2-am.json``,
``traffic/resident-am.json``, ``workloads/sdrplay2-am-resident64.json``)
on the CPU: its files, its plan against the port's and the reference
design's, the port's chain against the plain reference over carried
blocks, a short resident run of its chain through harness/drive.py and
the check, the TF32 control at its limits, and ``banded_roofline`` over a
hand-made trace of the cell's step."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from benchmark import control
from benchmark.harness import bounds, cell as cells, check, drive, signal, trace
from benchmark.reference import design as D
from benchmark.reference.chain import RefChain, code_gap
from benchmark.run import reader
from benchmark.tests.helpers import small_cell, small_run

NAME = "sdrplay2-am-resident64"
# a small block of the cell's grouping: 43 x 384 frames, 4 windows of 172
SMALL_BLOCK = 16512
SEED = 2147483693


def test_the_cell_is_the_sdrplay_am_deployment():
    """One chip; 64 channels of 1,056,768 cs16 frames (43 x 24,576), an
    8-block ring, 4 in flight; the resident traffic's signal with its tones
    inside +-15 kHz; the SDRplay's 2 Msps to the preset's 46,511.71875 Hz
    cs16 with the digital AGC and nothing else."""
    cell = cells.load(NAME)
    assert cell.entry == {**cell.entry, "config": "sdrplay2-am", "traffic": "resident-am",
                          "chips": 1}
    assert cell.config["reduced"] == [] and cell.config["architecture"] is None
    assert (cell.chain["input_format"], cell.chain["output_format"], cell.chain["input_rate"],
            cell.chain["target_rate"], cell.chain["agc_profile"]) == (
        "cs16", "cs16", 2e6, 46511.71875, "digital")
    assert not (cell.chain["dc_block"] or cell.chain["iq_correction"] or cell.chain["filters"]
                or cell.chain["freq_shift_pre_hz"] or cell.chain["freq_shift_post_hz"])
    resident = cells.load("baseline1-resident64").traffic
    assert cell.traffic == {**resident, "block_frames": 43 * 24576,
                            "signal": {**resident["signal"], "tone_max_hz": 15000.0}}
    assert (cell.channels, cell.block, cell.traffic["ring_blocks"],
            cell.traffic["in_flight"]) == (64, 1056768, 8, 4)
    assert set(cell.workload["limits"]) == {"start_gap_codes", "end_gap_codes",
                                            "end_median_gap_codes", "end_agc_state_gap"}
    assert {m["name"] for m in cell.e2e} == {"resident_msps", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "step_roofline.resident", "device_idle_pct.resident", "banded_roofline"}


def test_the_plan_is_the_ports():
    """The port frames 1,056,768 frames exactly (24,576 out) through one
    banded stage of 1/43 on the wgmma core between K3pre and K4, at the
    reference design's geometry."""
    from iq_tool_tpu_torch.ops import kernels
    from iq_tool_tpu_torch.ops.resample import _MatmulStage
    cell = cells.load(NAME)
    cell.traffic = dict(cell.traffic, channels=2)
    chain = cells.build_chain(cell, "cpu")
    assert (chain.n_in, chain.n_out) == (1056768, 24576)
    assert chain.route.pre == "K3pre" and chain.route.out == "K4"
    assert chain.route.stages == (0,) and not chain.route.wire_stage0
    (st,) = chain.resampler.stages
    assert isinstance(st, _MatmulStage)
    (ref,) = D.plan_resampler(cell.chain["target_rate"] / cell.chain["input_rate"],
                              cell.block).stages
    g = D.group_stride(ref.p, ref.q, chain.n_in)
    assert (st.p, st.q, st.g, st.stride) == (ref.p, ref.q, g, g * ref.q) == (1, 43, 4, 172)
    a = D.banded_matrix(ref, g)
    assert st.hist == a.shape[0] - st.stride == 687
    assert st.band.k == D.column_span(a) == 687 and kernels.banded_core(st.band) == "wgmma"


@pytest.mark.parametrize("block", [1056768, 262128, SMALL_BLOCK])
def test_the_planners_geometry_is_the_designs(block):
    """2 Msps to 46,511.71875 Hz rationalizes to 1/43 (2 ppm off) in the
    port and in the reference design alike; at the cell's 1,056,768
    frames, at 262,128 and at 16,512 the one banded stage takes 4 windows
    of 43 (stride 172) over 687 taps of history, a band of k 687 in a span
    of 816 rows; the port's float32 matrix is the design's float64 one to
    float32 rounding."""
    from iq_tool_tpu_torch.ops.resample import Resampler
    am = cells.load(NAME).chain
    ratio = am["target_rate"] / am["input_rate"]
    res, plan = Resampler(ratio, block), D.plan_resampler(ratio, block)
    assert (res.plan.p, res.plan.q) == (plan.p, plan.q) == (1, 43)
    assert abs(am["input_rate"] / 43 / am["target_rate"] - 1) < 3e-6
    assert (res.plan.n_in, res.plan.n_out) == (plan.n_in, plan.n_out)
    (st,), (want,) = res.stages, plan.stages
    g = D.group_stride(want.p, want.q, plan.n_in)
    a = D.banded_matrix(want, g)
    assert (st.p, st.q, st.g, st.stride) == (want.p, want.q, g, g * want.q) == (1, 43, 4, 172)
    assert st.hist == a.shape[0] - st.stride == 687
    np.testing.assert_allclose(st._a, a, rtol=0, atol=1e-9)
    st.bind("cpu")
    assert st.band.k == D.column_span(a) == 687 and st.band.span == 816


@pytest.mark.parametrize("blocks", [12, 256], ids=["12-blocks", "past-the-lock"])
def test_the_chain_holds_to_the_reference(blocks):
    """4 channels x 16,512-frame blocks of the cell's seeded capture (its
    tones inside +-15 kHz) over carried blocks, stepped by the port's
    Chain and by reference/chain.py: every block's widest gap in codes is
    under the cell's start limit (rounding to the code grid gives 0.5 of
    it, float32 sums against float64 the rest), and the digital AGC's
    state after the last block is the reference's within the cell's state
    limit (float32 peaks and gain against float64).  The K2 history, the
    AGC state and the carry cross every block; 256 blocks (98,304
    outputs) also cross the AGC's lock after 2 s of output (93,023)."""
    from iq_tool_tpu_torch.ops.fir_design import FilterRequest
    from iq_tool_tpu_torch.pipeline.chain import Chain, ChainConfig
    torch.set_num_threads(4)
    cell = cells.load(NAME)
    am, limits, channels = cell.chain, cell.workload["limits"], 4
    fields = dict(am, filters=tuple(FilterRequest(*f) for f in am["filters"]))
    chain = Chain(ChainConfig(channels=channels, target_block=SMALL_BLOCK, **fields),
                  device="cpu")
    ref = RefChain(am, channels, SMALL_BLOCK)
    n = chain.n_in
    assert (n, chain.n_out) == (ref.n_in, ref.n_out) == (SMALL_BLOCK, 384)
    cap = signal.capture(SEED, channels, blocks * n, am["input_rate"], cell.traffic["signal"],
                         "cpu", "cs16")
    carry, gaps = chain.init_carry(), []
    for k in range(blocks):
        w = cap[:, 2 * k * n:2 * (k + 1) * n]
        carry, out = chain.step(carry, w)
        gaps.append(code_gap(out, ref.step(w)))
    assert max(gaps) <= limits["start_gap_codes"], gaps
    agc = carry["agc"]
    prog = {f.name: getattr(agc, f.name) for f in dataclasses.fields(agc)}
    own = ref.agc_state()
    assert bool(own["locked"].all()) == (blocks * 384 >= ref.lock_samples)
    gap = check.agc_state_gap(prog, own, ref.lock_samples, ref.hang_samples)
    assert gap <= limits["end_agc_state_gap"], gap


def test_a_short_resident_run_is_correct():
    """4 channels of 16,512-frame blocks through drive.py's resident mode:
    the check, with the digital AGC's state, at the cell's limits."""
    for seconds in (0.6, 2.4, 9.6):
        run = small_run(NAME, seconds=seconds, block_frames=SMALL_BLOCK)
        if run.total_steps >= drive.least_blocks(run.n_in):
            break
    assert run.mode == "resident" and (run.n_in, run.n_out) == (SMALL_BLOCK, 384)
    assert run.end_agc is not None
    numbers = check.check(run, "cpu")
    assert all(v <= lim for _, v, lim in numbers), numbers


def test_the_tf32_control_is_not_correct_at_the_cells_limits():
    torch.set_num_threads(4)
    cell = small_cell(NAME, block_frames=SMALL_BLOCK)
    numbers = check.check(control.control_run(cell, 2147483659, "cpu", 40), "cpu")
    assert not all(v <= lim for _, v, lim in numbers), numbers


def test_banded_roofline_reads_the_decimators_bound():
    """banded_roofline in this cell: step_bounds' banded term is the 1/43
    stage's, the chain's one banded launch (64 x (1,056,768 + 687) planes
    in, 24,576 planes out a channel at 3.35 TB/s: 165.4 us, over the
    taps' 26.2 us of 3xTF32 operations), times the steps over the banded
    kernels' device time; no other kernel counts."""
    chain = cells.load(NAME).chain
    kernels = {"void iqk::banded_kernel<false, true, false, 2, 2>(iqk::BandedArgs)": (0.004, 10),
               "void iqk::pre_kernel<0>(iqk::PreArgs)": (0.002, 10),
               "Memcpy DtoD (Device -> Device)": (0.0005, 20)}
    run = types.SimpleNamespace(dev_trace=trace.DeviceTrace(1.0, 0.5, kernels, [], []),
                                steps=10, bounds=bounds.step_bounds(chain, 64, 1056768, 24576))
    want_bytes = 64 * (1056768 + 687) * 8 + 64 * 24576 * 8
    assert run.bounds["banded"] == pytest.approx(want_bytes / bounds.PEAK_BYTES_S, rel=1e-12)
    assert run.bounds["banded"] == pytest.approx(165.4e-6, rel=1e-3)
    ops = 3 * 2 * 2 * 64 * 6144 * 4 * 687
    assert ops / bounds.PEAK_TF32_S == pytest.approx(26.2e-6, rel=1e-2)
    assert reader("banded_roofline")(run) == pytest.approx(
        100 * run.bounds["banded"] * 10 / 0.004)
