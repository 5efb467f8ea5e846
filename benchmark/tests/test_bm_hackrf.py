"""A HackRF One's chain on the CPU, as a cell built in memory (no file of
the benchmark names it): its cs8 wire, the gather stage of its
4766/64043 ratio, upstream's digital AGC and the gather stage's bound;
the reference against the port, a resident run through drive.py and the
check, and the TF32 control."""

import numpy as np
import pytest
import torch

from benchmark import control
from benchmark.harness import bounds, cell as cells, check, drive, signal
from benchmark.reference import design as D
from benchmark.reference.chain import (RefChain, code_gap, decode_cs8, decode_cs16,
                                       digital_init, digital_update)
from benchmark.tests.helpers import HACKRF, hackrf_cell, small_run

SEED = 2147483663
TENTH = dict(input_rate=1e6, target_rate=74418.75)     # the same ratio at a tenth


@pytest.mark.parametrize("rates", [(10e6, 744187.5), (2.048e6, 46511.71875),
                                   (20e6, 1488375.0)])
def test_the_gather_plan_is_the_ports(rates):
    """A HackRF at 10 and 20 Msps to the FM preset's rate, and a 2.048 Msps
    capture to the AM preset's: one gather stage each, framed and
    weighted as the port's."""
    from iq_tool_tpu_torch.ops import resample
    ratio = rates[1] / rates[0]
    plan = D.plan_resampler(ratio, 262144)
    rs = resample.Resampler(ratio, 262144)
    assert rs.plan.fallback and len(plan.stages) == len(rs.stages) == 1
    st, port = plan.stages[0], rs.stages[0].plan
    assert isinstance(st, D.Gather) and (st.p, st.q) == (port.p, port.q)
    assert (plan.n_in, plan.n_out) == (port.n_in, port.n_out)
    assert st.weights.shape == port.weights.shape and 2 * st.m - 1 == port.history
    np.testing.assert_array_equal(st.starts, port.starts)
    np.testing.assert_allclose(st.weights, port.weights, rtol=0, atol=1e-7)
    np.testing.assert_allclose(st.weights.sum(1), 1.0, rtol=0, atol=1e-12)
    if rates[0] == 10e6:
        assert (plan.n_in, plan.n_out, 2 * st.m) == (256172, 19064, 216)


def test_the_port_matches_the_reference_over_blocks():
    """4 blocks of 2 channels at 10 Msps: K3pre's cs8 decode, the gather
    stage, the scanning digital AGC and K4's pack, within rounding to the
    code grid (0.5) and float32 against float64."""
    torch.set_num_threads(4)
    cell = hackrf_cell(channels=2)
    chain = cells.build_chain(cell, "cpu")
    assert chain.route.pre == "K3pre" and chain.route.out == "K4"
    n = chain.n_in
    cap = signal.capture(SEED, 2, 4 * n, 10e6, cell.traffic["signal"], "cpu", "cs8")
    ref = RefChain(HACKRF, 2, cell.block, 1, "cpu")
    assert (ref.n_in, ref.n_out) == (chain.n_in, chain.n_out) == (256172, 19064)
    carry, gaps = chain.init_carry(), []
    for k in range(4):
        w = cap[:, 2 * k * n:2 * (k + 1) * n]
        carry, out = chain.step(carry, w)
        gaps.append(code_gap(out, ref.step(w)))
    assert max(gaps) < 0.55, gaps


def _peaks() -> np.ndarray:
    """(blocks, 3) block peaks: a channel that scans up, locks, clips once
    and then creeps after its hang until a strong block; one whose peaks
    stay under the scan's first peak memory, so it creeps; one that stays
    strong."""
    a = [0.1, 0.3, 0.2, 0.25, 0.1, 0.2, 0.15, 0.25, 0.5] + [0.1] * 16 + [0.4] + [0.1] * 14
    b = [1e-6 * (1 + k % 3) for k in range(len(a))]
    c = [0.3 + 0.01 * (k % 5) for k in range(len(a))]
    return np.array([a, b, c], np.float32).T


def test_the_digital_agc_is_the_ports():
    """The reference's state machine against the port's ``digital_update``
    on one peak sequence a channel, through the scan, the lock, a clip's
    ratchet, the hang and the creep: the same gains within float32 and
    the same lock, counters and weak run."""
    from iq_tool_tpu_torch.ops import agc
    n, rate = 1000, 2500.0                     # locks after 5000 samples, hangs 10000
    cfg = agc.AgcConfig.make("digital", rate)
    port = agc.init(3)
    ref = digital_init(3)
    lock, hang = int(D.AGC_DIGITAL_SCAN_SEC * rate), int(D.AGC_DIGITAL_HANG_SEC * rate)
    gains_p, gains_r = [], []
    for peak in _peaks():
        gp, port = agc.digital_update(port, torch.from_numpy(peak), n, cfg)
        gr, ref = digital_update(ref, torch.from_numpy(peak).double(), n, lock, hang)
        gains_p.append(gp.double())
        gains_r.append(gr)
        assert torch.equal(port.locked, ref["locked"])
        assert torch.equal(port.samples_seen, ref["samples_seen"])
        assert torch.equal(port.weak_run, ref["weak_run"])
        torch.testing.assert_close(port.peak_mem.double(), ref["peak_mem"], rtol=1e-7, atol=0)
    gp, gr = torch.stack(gains_p), torch.stack(gains_r)
    torch.testing.assert_close(gp, gr, rtol=2e-6, atol=0)
    # every branch was taken: the ratchet, the creep, the scan's floor
    assert float(gr[9, 0]) == pytest.approx(0.99 / 0.5, rel=1e-6)
    assert float(gr[-1, 0]) > float(gr[-12, 0]) and float(gr[-1, 1]) > 18.0
    assert float(gr[-1, 2]) == pytest.approx(0.9 / 0.34, rel=1e-6)


def test_a_resident_run_with_the_digital_agc_is_correct_and_its_control_is_not():
    """The chain at a tenth of its rates, so that the AGC locks after 8
    blocks: a stream through drive.py's resident mode and the check (both
    end routes run, the program's AGC state as it entered the end and the
    reference's own), and the TF32 control over 12 blocks.  The run's
    stream is 32 blocks or more, so that the weak channels' gain has
    crept (from block 25 on: 8 blocks of scan, then more than 4 s of
    weak blocks)."""
    torch.set_num_threads(4)
    cell = hackrf_cell(**TENTH, channels=2)
    for seconds in (2.0, 6.0, 18.0):
        run = small_run(cell, seconds=seconds, seed=SEED)
        if run.total_steps >= 32:
            break
    assert run.inputs(0).dtype == torch.int8 and run.end_agc is not None
    assert bool(run.end_agc["locked"].all())
    gain, pm = run.end_agc["gain"].double(), run.end_agc["peak_mem"].double()
    assert bool((gain > 0.9 / pm * 1.001).any())         # the gain crept after its lock
    numbers = check.check(run, "cpu")
    assert all(v <= lim for _, v, lim in numbers), numbers
    assert max(v for _, v, _ in numbers) < 0.55, numbers
    ctl = control.control_run(cell, SEED, "cpu", 12)
    assert ctl.total_steps >= 12 and bool(ctl.end_agc["locked"].all())
    numbers = check.check(ctl, "cpu")
    assert not all(v <= lim for _, v, lim in numbers), numbers


def test_the_engine_mode_takes_no_digital_agc():
    cell = hackrf_cell(**TENTH, channels=2, mode="engine", intra_op_threads=1)
    with pytest.raises(NotImplementedError):
        small_run(cell)


def test_peaks_that_do_not_repeat_with_the_ring_raise():
    """The reference's own AGC is followed over a ring's repeating peaks;
    blocks that do not repeat (a capture longer than the ring said) are
    refused."""
    cell = hackrf_cell(**TENTH, channels=2, ring_blocks=2)
    ref = RefChain(cell.chain, 2, cell.block, 1, "cpu")
    n = ref.n_in
    cap = signal.capture(SEED, 2, 8 * n, 1e6, cell.traffic["signal"], "cpu", "cs8")
    run = drive.Run(cell, SEED, 0.0, False, "cpu", 0.0, total_steps=12)
    run.inputs = lambda k: cap[:, 2 * n * (k % 8):2 * n * (k % 8 + 1)]
    with pytest.raises(RuntimeError, match="repeat"):
        check.reference_agc(ref, run, 9)
    run.inputs = lambda k: cap[:, 2 * n * (k % 2):2 * n * (k % 2 + 1)]
    assert bool(check.reference_agc(ref, run, 9)["locked"].all())


def test_the_references_own_agc_is_its_stream_stepped_block_by_block():
    """``check.reference_agc`` against the reference run over every block:
    a ring of 20 blocks of which only the first carries a strong in-band
    signal, so that the weak run passes the hang (15.6 blocks at a tenth of
    the rates) and the gain creeps in each turn until the strong block."""
    torch.set_num_threads(4)
    slots, end = 20, 47
    cell = hackrf_cell(**TENTH, channels=2, ring_blocks=slots)
    ref = RefChain(cell.chain, 2, cell.block, 1, "cpu")
    n = ref.n_in
    loud = dict(cell.traffic["signal"], tone_dbfs=[-12.0, -9.0], tone_max_hz=20000.0)
    cap = torch.zeros((2, 2 * slots * n), dtype=torch.int8)
    cap[:, :2 * n] = signal.capture(SEED, 2, n, 1e6, loud, "cpu", "cs8")
    run = drive.Run(cell, SEED, 0.0, False, "cpu", 0.0, total_steps=end + 3)
    run.inputs = lambda k: cap[:, 2 * n * (k % slots):2 * n * (k % slots + 1)]
    whole = RefChain(cell.chain, 2, cell.block, 1, "cpu")
    for k in range(end):
        whole.step(run.inputs(k))
    want = whole.agc_state()
    got = check.reference_agc(ref, run, end)
    assert bool(want["locked"].all())
    assert bool((want["gain"] > 0.9 / want["peak_mem"] * 1.001).all())     # it crept
    for f, v in want.items():
        torch.testing.assert_close(got[f], v, rtol=1e-12, atol=0)


def test_a_cs8_capture_is_the_signal_within_half_a_code():
    """The same draws quantized as cs16 and as cs8: the cs8 wire lies
    within half a cs8 code (1/256 of full scale) of the signal, which the
    cs16 wire holds to within 1/65536."""
    sig = hackrf_cell().traffic["signal"]
    args = (2147483657, 3, 20000, 10e6, sig, "cpu")
    w16, w8 = signal.capture(*args, "cs16"), signal.capture(*args, "cs8")
    assert w8.dtype == torch.int8 and w8.shape == w16.shape
    gap = torch.view_as_real(decode_cs8(w8) - decode_cs16(w16)).abs().amax((0, 1))
    assert float(gap.max()) <= 1 / 256 + 1 / 65536, gap       # I and Q
    assert float(gap.min()) > 1 / 512                       # a cs8 wire, not a cs16 one


def test_the_cs8_decode_is_the_ports():
    """All 256 codes of I and of Q: x / 128, as the port converts cs8."""
    from iq_tool_tpu_torch.ops import convert
    codes = torch.arange(-128, 128)
    wire = torch.stack([torch.stack([codes, codes.flip(0)], -1).reshape(-1),
                        torch.stack([codes.flip(0), codes], -1).reshape(-1)]).to(torch.int8)
    x = decode_cs8(wire)
    assert sorted(set((x.real[0] * 128).tolist())) == list(range(-128, 128))
    xr, xi = convert.to_planar(wire, "cs8")
    torch.testing.assert_close(xr.double(), x.real, rtol=0, atol=0)
    torch.testing.assert_close(xi.double(), x.imag, rtol=0, atol=0)


def test_the_gather_stages_bound(monkeypatch):
    """The HackRF step at 64 x 256172: the gather family's bytes bound it,
    the cs8 wire in (2 bytes a frame) and the 215-frame history, planes
    out (the AGC's peak comes between the stage and the pack), or the
    cs16 wire where only the pack follows; its operations (with the
    bandwidth out of the way) 3 (3xTF32) x 2 x 2 planes x 216 taps an
    output at the TF32 peak, as the banded stages count theirs, so 12.73
    us against 6.39 us; the step's wire in at 2 bytes and cs16 out; no
    banded or K5 work."""
    c, n_in, n_out = 64, 256172, 19064
    b = bounds.step_bounds(HACKRF, c, n_in, n_out)
    nbytes = c * (2 * n_in + 8 * 215) + c * 8 * n_out
    assert b["gather"] == nbytes / bounds.PEAK_BYTES_S
    assert b["gather"] == pytest.approx(12.73e-6, abs=0.01e-6)
    assert b["step"] == pytest.approx(c * (2 * n_in + 4 * n_out) / bounds.PEAK_BYTES_S)
    assert b["banded"] == 0.0 and b["osfft"] == 0.0
    plain = bounds.step_bounds(dict(HACKRF, agc_profile=None), c, n_in, n_out)
    assert plain["gather"] == (nbytes - c * 4 * n_out) / bounds.PEAK_BYTES_S
    # a stage after another reads planes
    st = D.plan_resampler(744187.5 / 10e6, 262144).stages[0]
    assert bounds._gather(st, n_in, c, 8, 8) == (nbytes + c * 6 * n_in) / bounds.PEAK_BYTES_S
    monkeypatch.setattr(bounds, "PEAK_BYTES_S", 1e30)
    ops = 12 * 216 * c * n_out
    assert bounds.step_bounds(HACKRF, c, n_in, n_out)["gather"] == ops / bounds.PEAK_TF32_S
    assert ops / bounds.PEAK_TF32_S == pytest.approx(6.39e-6, abs=0.01e-6)


@pytest.mark.parametrize("fault", ["state", "half", "answer"])
def test_a_broken_step_with_the_digital_agc_is_not_correct(monkeypatch, fault):
    """The step broken underneath as in test_bm_control (its state left
    unchanged, half of its channels left out, one sample altered), at a
    tenth of the rates past the AGC's lock."""
    from benchmark.tests.test_bm_control import _broken
    _broken(monkeypatch, fault)
    cell = hackrf_cell(**TENTH, channels=2)
    for seconds in (1.0, 3.0, 9.0):
        run = small_run(cell, seconds=seconds, seed=SEED)
        if run.total_steps >= 12:
            break
    numbers = check.check(run, "cpu")
    assert not all(v <= lim for _, v, lim in numbers), numbers


def test_a_program_agc_that_creeps_early_fails_the_state_gap(monkeypatch):
    """The program's digital AGC with a 3 s hang in place of 4 s: its gain
    creeps early in the channels that creep, which the AGC state's gap
    reads over its limit, though the program's own state carries the end
    span (``end_gap_codes``) and a median passes where fewer than half of
    the channels creep."""
    from iq_tool_tpu_torch import constants
    torch.set_num_threads(4)
    monkeypatch.setattr(constants, "AGC_DIGITAL_HANG_SEC", 3.0)
    cell = hackrf_cell(**TENTH, channels=2)
    for seconds in (2.0, 6.0, 18.0):
        run = small_run(cell, seconds=seconds, seed=SEED)
        if run.total_steps >= 32:
            break
    numbers = {n: (v, lim) for n, v, lim in check.check(run, "cpu")}
    value, limit = numbers["end_agc_state_gap"]
    assert value > 10 * limit, numbers
    assert numbers["end_gap_codes"][0] < 0.55, numbers
