"""The benchmark's plain reference against the port's CPU path (the
kernels' plain twins) at a small size, for both configurations, over
several blocks and a time fold; and the frozen design against the
port's."""

import numpy as np
import pytest
import torch

from benchmark.harness import bounds, cell as cells, signal
from benchmark.harness.check import AGC_START_FRAMES
from benchmark.reference import design as D
from benchmark.reference.chain import RefChain, code_gap, quantize_cs16, round_tf32
from benchmark.tests.helpers import small_cell


def _port_chain(cell, fold=None):
    from iq_tool_tpu_torch.pipeline.folded import FoldedChain
    chain = cells.build_chain(cell, "cpu")
    if fold:
        return FoldedChain(chain.cfg, fold, device="cpu")
    return chain


def _gaps(cell, steps, fold=None, seed=11):
    chain = _port_chain(cell, fold)
    n = chain.n_in
    cap = signal.capture(seed, cell.channels, steps * n, 2.048e6, cell.traffic["signal"], "cpu")
    ref = RefChain(cell.chain, cell.channels, cell.block, fold or 1, "cpu")
    assert ref.n_in == n and ref.n_out == chain.n_out
    carry, gaps = chain.init_carry(), []
    skip = 2 * AGC_START_FRAMES if cell.chain.get("agc_profile") else 0
    for k in range(steps):
        w = cap[:, 2 * k * n:2 * (k + 1) * n]
        carry, out = chain.step(carry, w)
        codes = ref.step(w)
        if k == 0:
            out, codes = out[:, skip:], codes[:, skip // 2:]
        gaps.append(code_gap(out, codes))
    return gaps, carry, ref


@pytest.mark.parametrize("cell_name", ["baseline1-resident64", "full4-resident64"])
def test_reference_matches_the_port_over_blocks(cell_name):
    torch.set_num_threads(4)
    gaps, carry, ref = _gaps(small_cell(cell_name), 4)
    # rounding to the code grid is 0.5; float32 against float64 adds < 0.05
    assert max(gaps) < 0.55, gaps
    if "iq" in carry:
        np.testing.assert_allclose(carry["iq"].factors.double().numpy(), ref.factors.numpy(),
                                   atol=2e-6)


def test_reference_matches_the_folded_port():
    """One stream at the CLI's fold of 8 rows: the AGC's segments laid per
    row, the estimator on the block's first 1024 frames."""
    torch.set_num_threads(4)
    cell = small_cell("full4-resident64", channels=1)
    gaps, _, _ = _gaps(cell, 3, fold=8)
    assert max(gaps) < 0.55, gaps


def test_the_frozen_design_is_the_ports():
    from iq_tool_tpu_torch.ops import fir_design, resample
    taps = D.design_chain([("stop-range", 0.0, 10e3)], 1488375.0)
    port = fir_design.design_chain([fir_design.FilterRequest("stop-range", 0.0, 10e3)],
                                   1488375.0)
    assert len(taps) == 2175
    np.testing.assert_allclose(taps, port.taps, rtol=0, atol=1e-7)
    rs = resample.Resampler(1488375.0 / 2048000.0, 262144)
    plan = D.plan_resampler(1488375.0 / 2048000.0, 262144)
    assert (plan.n_in, plan.n_out) == (rs.plan.n_in, rs.plan.n_out) == (262144, 190512)
    assert [(s.p, s.q) for s in plan.stages] == list(rs.plan.stages) == [(441, 512), (27, 32)]
    for st, pst in zip(plan.stages, rs.stages):
        a = D.banded_matrix(st, pst.g)
        np.testing.assert_allclose(a, pst._a, rtol=0, atol=1e-7)


@pytest.mark.parametrize("dc", [False, True])
def test_follow_is_the_estimator_of_the_stream(dc):
    """The estimator followed alone from block 3 (a due block's first
    frames, DC-blocked from a warmed state) leaves the factors that the
    whole chain run block by block has, on every block."""
    torch.set_num_threads(4)
    cell = small_cell("full4-resident64")
    chain = dict(cell.chain, dc_block=dc)
    n = 2 * cell.due_period(16384) + 3
    cap = signal.capture(13, 4, 4 * 16384, 2.048e6, cell.traffic["signal"], "cpu")
    block = lambda k: cap[:, 2 * 16384 * (k % 4):2 * 16384 * (k % 4 + 1)]
    whole, part = (RefChain(chain, 4, 16384, 1, "cpu") for _ in range(2))
    seen = []
    for k in range(n):
        whole.step(block(k))
        seen.append(whole.factors)
        if k < 3:
            part.step(block(k))
    got = part.follow(3, n, block, 524288)
    assert len(got) == n - 3 and float(seen[-1].abs().max()) > 0
    for k in range(3, n):
        torch.testing.assert_close(got[k - 3], seen[k], rtol=0, atol=1e-9)


def test_bounds_of_the_flagship_step():
    """K1's and K2's bounds as the port's chip_smoke.py counts them (0.109
    and 0.098 ms at 128 x 262144, bench.py's flagship chain: DC block,
    +100 kHz, the 400 kHz lowpass composed in), and the step's wire in
    and out."""
    flagship = dict(cells.load("baseline1-resident64").chain, dc_block=True,
                    freq_shift_pre_hz=100e3, filters=[["lowpass", 400e3, 0.0]])
    b = bounds.step_bounds(flagship, 128, 262144, 190512)
    assert b["step"] == pytest.approx(128 * (4 * 262144 + 4 * 190512) / 3.35e12)
    assert b["banded"] * 1e3 == pytest.approx(0.207, abs=0.003)
    assert b["osfft"] == 0.0
    f = cells.load("full4-resident64")
    assert bounds.step_bounds(f.chain, 128, 262144, 190512)["osfft"] * 1e3 == pytest.approx(
        0.119, abs=0.002)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0000001])
    assert round_tf32(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -10, -3.0]


def test_quantizer_rounds_half_away_and_clamps():
    codes = torch.tensor([[0.5 - 0.5j, 2.5 + 40000j, -40000 - 1.49j]], dtype=torch.complex128)
    assert quantize_cs16(codes).tolist() == [[1, -1, 3, 32767, -32768, -1]]
