"""The benchmark's plain reference against the port's CPU path (the
kernels' plain twins) at a small size, for both configurations and
config 3's cu8 chain, over several blocks and a time fold; the cu8
decode and capture; the frozen design against the port's; and the
bounds' byte counts."""

import numpy as np
import pytest
import torch

from benchmark.harness import bounds, cell as cells, signal
from benchmark.harness.check import AGC_START_FRAMES
from benchmark.reference import design as D
from benchmark.reference.chain import (RefChain, code_gap, decode_cs16, decode_cu8,
                                       quantize_cs16, round_tf32)
from benchmark.tests.helpers import CONFIG3, config3_cell, small_cell


def _port_chain(cell, fold=None):
    from iq_tool_tpu_torch.pipeline.folded import FoldedChain
    chain = cells.build_chain(cell, "cpu")
    if fold:
        return FoldedChain(chain.cfg, fold, device="cpu")
    return chain


def _gaps(cell, steps, fold=None, seed=11):
    chain = _port_chain(cell, fold)
    n = chain.n_in
    cap = signal.capture(seed, cell.channels, steps * n, 2.048e6, cell.traffic["signal"], "cpu",
                         cell.chain["input_format"])
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


@pytest.mark.parametrize("cell_name", ["baseline1-resident64", "full4-resident64", "config3"])
def test_reference_matches_the_port_over_blocks(cell_name):
    """Config 3: cu8 in, the DC block, the band-pass after the resampler
    on its own banded pass, cs16 out."""
    torch.set_num_threads(4)
    cell = config3_cell() if cell_name == "config3" else small_cell(cell_name)
    gaps, carry, ref = _gaps(cell, 4)
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
    cap = signal.capture(13, 4, 4 * 16384, 2.048e6, cell.traffic["signal"], "cpu", "cs16")
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


def _every_cu8_code() -> torch.Tensor:
    """(2, 512) cu8 wire: every code of I against a permutation of Q in
    one channel, the roles swapped in the other."""
    codes = torch.arange(256)
    perm = (codes * 7 + 3) % 256
    one = torch.stack([codes, perm], -1).reshape(-1)
    two = torch.stack([perm, codes], -1).reshape(-1)
    return torch.stack([one, two]).to(torch.uint8)


def test_the_cu8_decode_is_the_ports():
    """All 256 codes of I and of Q: the reference's decode against the
    port's convert and, over the packed wire, its DC kernel's twin
    against the reference's DC block, within float32 rounding."""
    from iq_tool_tpu_torch.formats import get_format
    from iq_tool_tpu_torch.ops import convert, dc_block, kernels
    wire = _every_cu8_code()
    x = decode_cu8(wire)
    assert sorted(set((x.real[0] * 128 + 127.5).tolist())) == list(range(256))
    xr, xi = convert.to_planar(wire, "cu8")
    torch.testing.assert_close(xr.double(), x.real, rtol=0, atol=0)
    torch.testing.assert_close(xi.double(), x.imag, rtol=0, atol=0)
    packed, kind = convert.wire_pack(wire, "cu8")
    yr, yi, _ = kernels.dc_block_apply_ref(
        None, None, dc_block.init_planar(2, "cpu"), dc_block.alpha_for_rate(2.048e6),
        wire_i32=packed, wire_norm=get_format("cu8").normalizer, wire_kind=kind)
    y = RefChain(CONFIG3, 2, 16384)._dc_block(x)
    ULP2 = 2 * 2.0 ** -23          # two float32 steps at the outputs' size (|y| < 2)
    assert float(y.abs().max()) < 2
    torch.testing.assert_close(yr.double(), y.real, rtol=0, atol=ULP2)
    torch.testing.assert_close(yi.double(), y.imag, rtol=0, atol=ULP2)


def test_a_cu8_capture_is_the_signal_within_half_a_code():
    """The same draws quantized as cs16 and as cu8: the cu8 wire lies
    within half a cu8 code (1/256 of full scale) of the signal, which the
    cs16 wire holds to within 1/65536."""
    sig = cells.load("baseline1-resident64").traffic["signal"]
    args = (2147483657, 3, 20000, 2.048e6, sig, "cpu")
    w16, w8 = signal.capture(*args, "cs16"), signal.capture(*args, "cu8")
    assert w16.dtype == torch.int16 and w8.dtype == torch.uint8 and w8.shape == w16.shape
    gap = torch.view_as_real(decode_cu8(w8) - decode_cs16(w16)).abs().amax((0, 1))
    assert float(gap.max()) <= 1 / 256 + 1 / 65536, gap       # I and Q
    assert float(gap.min()) > 1 / 512                       # a cu8 wire, not a cs16 one
    with pytest.raises(ValueError):
        signal.capture(*args, "cf32")


def test_bounds_count_two_bytes_of_cu8_wire_a_frame():
    """Config 3's step reads 2 bytes a frame in and writes 4 out; its DC
    kernel (the general step's, before planes reach the resampler) reads
    2 and writes 8: the bound with the DC block less the bound without."""
    c, n_in, n_out = 64, 262144, 190512
    b = bounds.step_bounds(CONFIG3, c, n_in, n_out)
    assert b["step"] == pytest.approx(c * (2 * n_in + 4 * n_out) / bounds.PEAK_BYTES_S)
    no_dc = bounds.step_bounds(dict(CONFIG3, dc_block=False), c, n_in, n_out)
    assert b["banded"] - no_dc["banded"] == pytest.approx(
        c * ((2 + 8) * n_in + 48) / bounds.PEAK_BYTES_S)
    cs16 = bounds.step_bounds(dict(CONFIG3, input_format="cs16"), c, n_in, n_out)
    assert cs16["banded"] - b["banded"] == pytest.approx(c * 2 * n_in / bounds.PEAK_BYTES_S)
    # the band-pass on a banded pass of its own, after the resampler
    assert bounds.filter_pass(CONFIG3, D.design_chain([("pass-range", 102e3, 215e3)],
                                                      1488375.0)) == "banded"
    assert b["osfft"] == 0.0


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0000001])
    assert round_tf32(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -10, -3.0]


def test_quantizer_rounds_half_away_and_clamps():
    codes = torch.tensor([[0.5 - 0.5j, 2.5 + 40000j, -40000 - 1.49j]], dtype=torch.complex128)
    assert quantize_cs16(codes).tolist() == [[1, -1, 3, 32767, -32768, -1]]
