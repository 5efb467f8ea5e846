"""The check that decides ``correct`` has to fail: the TF32 control in the
program's place at a size a test run holds, and a run whose timed path
is broken underneath (its state left unchanged, half of its channels
left out, one output sample altered where it is produced), driven as a
run is, past the harness's look for a card."""

import pytest
import torch

from benchmark import control
from benchmark.harness import check, drive
from benchmark.tests.helpers import config3_cell, small_cell, small_run


@pytest.mark.parametrize("name", ["baseline1-resident64", "full4-resident64"])
def test_the_tf32_control_is_not_correct(name):
    """The control driven as a run and judged by the run's own check."""
    torch.set_num_threads(4)
    cell = small_cell(name)
    run = control.control_run(cell, 2147483651, "cpu", 2 * cell.due_period(16384) + 8)
    assert run.total_steps % cell.due_period(16384) == 0
    assert len(run.start_out) == drive.START_STEPS and len(run.end_out) == drive.END_STEPS
    numbers = check.check(run, "cpu")
    assert not all(v <= lim for _, v, lim in numbers), numbers


def test_the_tf32_control_runs_config3():
    """The control takes config 3's cu8 wire as it is and reads at least
    three times the sound step's widest gap, the room a limit needs
    between the two."""
    torch.set_num_threads(4)
    cell = config3_cell()
    ctl = check.check(control.control_run(cell, 2147483651, "cpu", 10), "cpu")
    sound = check.check(small_run(cell, seed=2147483651), "cpu")
    assert max(v for _, v, _ in ctl) >= 3 * max(v for _, v, _ in sound), (ctl, sound)


def _broken(monkeypatch, fault: str):
    from iq_tool_tpu_torch.pipeline.graphed import GraphedStep
    real = GraphedStep.step

    def step(self, carry, raw, reset=False):
        if fault == "state":                 # every step from the first one's state
            carry = self.init_carry()
        carry, out = real(self, carry, raw, reset)
        if fault == "half":                  # half of the channels left out
            out[out.shape[0] // 2:] = 0
        elif fault == "answer":              # one sample altered where it is produced
            out[0, 7] = out[0, 7] // 2 + 1
        return carry, out

    monkeypatch.setattr(GraphedStep, "step", step)


@pytest.mark.parametrize("fault", ["state", "half", "answer"])
@pytest.mark.parametrize("name", ["full4-resident64", "baseline1-engine64"])
def test_a_broken_step_is_not_correct(monkeypatch, name, fault):
    _broken(monkeypatch, fault)
    run = small_run(name)
    numbers = check.check(run, "cpu")
    assert not all(v <= lim for _, v, lim in numbers), numbers


def test_the_sound_step_is_correct():
    run = small_run("full4-resident64")
    assert len(run.end_out) == drive.END_STEPS
    numbers = check.check(run, "cpu")
    assert all(v <= lim for _, v, lim in numbers), numbers
