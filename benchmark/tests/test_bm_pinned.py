"""The cs16 paths as they were before the harness took a cu8 wire: the
capture's bytes, the reference's quantized output and the three cells'
step bounds, each written in from the harness that measured the cells'
first readings; and the four cells' captures, reference codes and step
bounds as they were before the harness took the cs8 wire, the gather
stage and the digital AGC.  A change to any of them changes what those
cells read."""

import hashlib

import pytest
import torch

from benchmark.harness import bounds, cell as cells, signal
from benchmark.reference import design as D
from benchmark.reference.chain import RefChain, quantize_cs16
from benchmark.tests.helpers import load_cell

SEED, CHANNELS, BLOCK, BLOCKS = 2147483655, 4, 16384, 3
CAPTURE_SHA256 = "d010feb29b357b944986e632a895b4b3ae3c1c41b839755b9e94fd107eff3a0f"
REFERENCE_SHA256 = {
    "baseline1-resident64": "c860c7798e04595d24f6da805f53b244e95470de8e5f2735474f6ad8efe8dfaf",
    "full4-resident64": "728a9a78e46937113e7e5df2392e89844db1640a3dddbd71c0ef10fbf6b68f94",
}
BASELINE1 = {"step": 3.459102567164179e-05, "banded": 0.00010361634388059702, "osfft": 0.0}
STEP_BOUNDS = {
    "baseline1-resident64": BASELINE1,
    "baseline1-engine64": BASELINE1,
    "full4-resident64": {"step": 3.459102567164179e-05, "banded": 0.00013820973850746268,
                         "osfft": 5.9525272835820895e-05},
}


def _capture() -> torch.Tensor:
    sig = cells.load("baseline1-resident64").traffic["signal"]
    return signal.capture(SEED, CHANNELS, BLOCKS * BLOCK, 2.048e6, sig, "cpu", "cs16")


def test_the_cs16_capture_is_pinned():
    cap = _capture()
    assert cap.dtype == torch.int16 and cap.shape == (CHANNELS, 2 * BLOCKS * BLOCK)
    assert hashlib.sha256(cap.numpy().tobytes()).hexdigest() == CAPTURE_SHA256


@pytest.mark.parametrize("name", sorted(REFERENCE_SHA256))
def test_the_references_cs16_output_is_pinned(name):
    """The reference's quantized output over the pinned capture's blocks."""
    torch.set_num_threads(4)
    cap = _capture()
    ref = RefChain(load_cell(name).chain, CHANNELS, BLOCK, 1, "cpu")
    assert ref.n_in == BLOCK
    h = hashlib.sha256()
    for k in range(BLOCKS):
        h.update(quantize_cs16(ref.step(cap[:, 2 * BLOCK * k:2 * BLOCK * (k + 1)]))
                 .numpy().tobytes())
    assert h.hexdigest() == REFERENCE_SHA256[name]


@pytest.mark.parametrize("name", sorted(STEP_BOUNDS))
def test_the_cells_step_bounds_are_pinned(name):
    """Each accepted cell's bounds at its own size, equal as floats."""
    cell = load_cell(name)
    chain = cell.chain
    plan = D.plan_resampler(float(chain["target_rate"]) / float(chain["input_rate"]), cell.block)
    assert (plan.n_in, plan.n_out) == (262144, 190512)
    assert bounds.step_bounds(chain, cell.channels, plan.n_in, plan.n_out) == STEP_BOUNDS[name]


# before the cs8 wire, the gather stage and the digital AGC: 2 channels,
# 3 blocks of each configuration's framing of 16384 frames
SEED2, CHANNELS2 = 2147483661, 2
CAPTURE2_SHA256 = {
    "cs16": "13af96e23da160f47c2fbd02b3cb7e60f6e67b3f6b796793e35ff99f56f9948b",
    "cu8": "b2702e8d79ea9381e1bb5380a192468c8062dc1391fef087cc93b7ff3914c07d",
}
REFERENCE2 = {          # name: (frames a block, sha256 of the codes)
    "baseline1-resident64": (16384,
        "5a1705dd5b7ec377ae4d2ce1c9fffef9ca39d5e8c179444d8de1cefa9d45a62f"),
    "full4-resident64": (16384,
        "3ed3e4ebb07071009f27914c0bc947ab4972a795b249bd7e746dff1da02f3cdb"),
    "baseline3-resident64": (19200,
        "ce7d07db9e161885f17a4f6c3394a84d74a1796297ed774af923492b28d50ca7"),
}
STEP_BOUNDS2 = {        # name: (n_in, n_out, bounds)
    "baseline1-resident64": (262144, 190512, {
        "step": 3.459102567164179e-05, "banded": 0.00010361634388059702, "osfft": 0.0}),
    "baseline1-engine64": (262144, 190512, {
        "step": 3.459102567164179e-05, "banded": 0.00010361634388059702, "osfft": 0.0}),
    "full4-resident64": (262144, 190512, {
        "step": 3.459102567164179e-05, "banded": 0.00013820973850746268,
        "osfft": 5.9525272835820895e-05}),
    "baseline3-resident64": (262400, 162729, {
        "step": 2.246144e-05, "banded": 0.0002555552259473541, "osfft": 0.0}),
}


@pytest.mark.parametrize("name", sorted(REFERENCE2))
def test_the_captures_and_reference_codes_are_pinned(name):
    """Each configuration's capture in its own input format and the
    reference's quantized output over it."""
    torch.set_num_threads(4)
    chain = load_cell(name).chain
    ref = RefChain(chain, CHANNELS2, BLOCK, 1, "cpu")
    n, want = REFERENCE2[name]
    assert ref.n_in == n
    cap = signal.capture(SEED2, CHANNELS2, BLOCKS * n, float(chain["input_rate"]),
                         load_cell(name).traffic["signal"], "cpu", chain["input_format"])
    assert hashlib.sha256(cap.numpy().tobytes()).hexdigest() == CAPTURE2_SHA256[
        chain["input_format"]]
    h = hashlib.sha256()
    for k in range(BLOCKS):
        h.update(quantize_cs16(ref.step(cap[:, 2 * n * k:2 * n * (k + 1)])).numpy().tobytes())
    assert h.hexdigest() == want


@pytest.mark.parametrize("name", sorted(STEP_BOUNDS2))
def test_the_four_cells_step_bounds_are_pinned(name):
    """Every family's bound of each cell at its own size, equal as floats,
    with no gather family."""
    cell = load_cell(name)
    chain = cell.chain
    n_in, n_out, want = STEP_BOUNDS2[name]
    plan = D.plan_resampler(float(chain["target_rate"]) / float(chain["input_rate"]), cell.block)
    assert (plan.n_in, plan.n_out) == (n_in, n_out)
    assert bounds.step_bounds(chain, cell.channels, n_in, n_out) == want
