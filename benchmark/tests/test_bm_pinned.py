"""The cs16 paths as they were before the harness took a cu8 wire: the
capture's bytes, the reference's quantized output and the three cells'
step bounds, each written in from the harness that measured the cells'
first readings.  A change to any of them changes what those cells read."""

import hashlib

import pytest
import torch

from benchmark.harness import bounds, cell as cells, signal
from benchmark.reference import design as D
from benchmark.reference.chain import RefChain, quantize_cs16

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
    ref = RefChain(cells.load(name).chain, CHANNELS, BLOCK, 1, "cpu")
    assert ref.n_in == BLOCK
    h = hashlib.sha256()
    for k in range(BLOCKS):
        h.update(quantize_cs16(ref.step(cap[:, 2 * BLOCK * k:2 * BLOCK * (k + 1)]))
                 .numpy().tobytes())
    assert h.hexdigest() == REFERENCE_SHA256[name]


@pytest.mark.parametrize("name", sorted(STEP_BOUNDS))
def test_the_cells_step_bounds_are_pinned(name):
    """Each accepted cell's bounds at its own size, equal as floats."""
    cell = cells.load(name)
    chain = cell.chain
    plan = D.plan_resampler(float(chain["target_rate"]) / float(chain["input_rate"]), cell.block)
    assert (plan.n_in, plan.n_out) == (262144, 190512)
    assert bounds.step_bounds(chain, cell.channels, plan.n_in, plan.n_out) == STEP_BOUNDS[name]
