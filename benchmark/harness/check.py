"""The check that decides ``correct``: the program's output blocks against
the plain reference (``reference/chain.py``), in codes.

Two spans of the stream are compared, every channel and every sample:
its first START_STEPS blocks, against the reference run from the
stream's start, and its last END_STEPS blocks, against the reference
warm-started END_WARM_FRAMES frames before them with the phases the
stream has there.  Three numbers:

* ``start_gap_codes``: the widest gap over the start;
* ``end_gap_codes``: the widest gap over the end, every stage but the
  I/Q estimator's later updates: the reference applies the I/Q factors
  the program has there;
* ``end_median_gap_codes``: the median over channels of each channel's
  widest gap over the end, the reference applying its own factors: its
  estimator follows the whole stream, every due block's update on that
  block's first 1024 frames, so the program's updates are held to it.
  The median, because the estimator's greedy descent is discontinuous:
  over a stream's ~1,700 updates a float32 and a float64 estimator part
  on a near-tie now and then, and in a channel or two of 64 on some
  seeds settle in different orbits (PERF.md), which a widest gap reads.

Where the chain has no estimator the two end numbers are of the same
gaps.

The digital AGC holds one gain a block, from state that runs over the
whole stream (its peak memory, locked after 2 s of output; the weak run
that lets the gain creep).  A warm start cannot rebuild that, so with a
digital AGC the two end numbers enter the compared end with a state of
their own, as they do with the I/Q factors, and the AGC's state machine
then runs on the reference's own block peaks:

* ``end_gap_codes``: the program's state as it entered the end
  (``Run.end_agc``);
* ``end_median_gap_codes``: the reference's own, its state machine run
  from the stream's start over its own peak of every block before the
  end.  The input is a ring of ``ring_blocks`` blocks, so past the
  ring's first turn a block's peak is the one a turn before: the
  reference computes the peaks of two turns and the first block after
  them, holds the second turn to the first, and takes the later blocks'
  peaks from it.  A chain whose peaks do not repeat so raises.

The start span runs the reference's own AGC from the stream's start.
A fourth number holds the program's AGC state to the reference's own,
channel by channel, since the median lets a fault in fewer than half of
the channels pass (a wrong hang, so that the gain creeps too early):

* ``end_agc_state_gap``: over channels, the widest of the relative gaps
  of the gain and of the peak memory, the weak runs' gap in hang
  lengths, the samples seen's in lock lengths, and 1 where one side has
  locked and the other has not, as the two states enter the end.
"""

from __future__ import annotations

import torch

from benchmark.harness.drive import END_STEPS, END_WARM_FRAMES, Run
from benchmark.reference.chain import (RefChain, channel_gaps, code_gap, digital_init,
                                       digital_update)

# With an RMS AGC the stream's first frames are not compared: the AGC starts
# at gain 1 on the resampler's start-up from zero history (output under
# 1e-9 of full scale) and drives its gain toward its 1e6 clamp there,
# multiplying the program's float32 rounding residue into codes until
# the signal arrives (about 1000 frames).
AGC_START_FRAMES = 4096
# how far two block peaks of the reference that one ring turn parts may
# lie apart and still count as the same
PEAK_RTOL = 1e-12


def _end(ref: RefChain, run: Run, e0: int, factors, agc=None) -> torch.Tensor:
    """Each channel's widest gap over the end span: the reference
    warm-started at block e0, applying ``factors(k)`` on block k, and
    entering the compared blocks with the digital AGC's state ``agc``
    where given."""
    n = run.total_steps
    ref.skip_to(e0 * run.n_in)
    gaps = None
    for k in range(e0, n):
        if agc is not None and k == n - END_STEPS:
            ref.set_agc_state(agc)
        ref.factors = factors(k)
        codes = ref.step(run.inputs(k), estimate=False)
        if k >= n - END_STEPS:
            g = channel_gaps(run.end_out[k - (n - END_STEPS)], codes)
            gaps = g if gaps is None else torch.maximum(gaps, g)
    return gaps


def reference_agc(ref: RefChain, run: Run, end: int) -> dict:
    """The reference's own digital AGC state entering block ``end``: its
    state machine from the stream's start over its own block peaks, those
    past the ring's second turn taken from a turn before."""
    slots = int(run.cell.traffic["ring_blocks"])
    chain = RefChain(ref.cfg, ref.ch, run.cell.block, ref.rows, ref.dev)
    peaks = [chain.agc_input(run.inputs(k)).abs().amax(-1).cpu()
             for k in range(min(end, 2 * slots + 1))]
    if end > 2 * slots + 1:
        turn, again = torch.stack(peaks[1:slots + 1]), torch.stack(peaks[slots + 1:])
        if not torch.allclose(again, turn, rtol=PEAK_RTOL, atol=0.0):
            raise RuntimeError("the reference's block peaks do not repeat with the input "
                               "ring: its own digital AGC cannot be followed to the end")
    state = digital_init(ref.ch)
    for k in range(end):
        peak = peaks[k] if k < len(peaks) else peaks[slots + 1 + (k - slots - 1) % slots]
        _, state = digital_update(state, peak, ref.n_out, ref.lock_samples, ref.hang_samples)
    return state


def agc_state_gap(prog: dict, own: dict, lock_samples: int, hang_samples: int) -> float:
    """The widest gap over channels between the program's digital AGC
    state ``prog`` and the reference's ``own`` (module docstring)."""
    p = {f: torch.as_tensor(prog[f]).to(own[f].device) for f in own}
    rel = lambda f: (p[f].double() / own[f] - 1.0).abs()
    steps = lambda f, n: (p[f].long() - own[f]).abs().double() / n
    gap = torch.stack([rel("gain"), rel("peak_mem"), steps("weak_run", hang_samples),
                       steps("samples_seen", lock_samples),
                       (p["locked"] != own["locked"]).double()])
    return float(gap.max())


def spans(run: Run, device) -> dict:
    """{number: value} of the run's kept blocks against the reference's."""
    cell = run.cell
    ref = RefChain(cell.chain, cell.channels, cell.block, run.rows, device)
    if ref.n_in != run.n_in:
        raise RuntimeError(f"the reference frames {ref.n_in} frames a block, the program "
                           f"{run.n_in}")
    start = 0.0
    digital = ref.agc == "digital"
    skip = 2 * AGC_START_FRAMES if ref.agc in ("local", "dx") else 0
    for k, out in enumerate(run.start_out):
        codes = ref.step(run.inputs(k))
        if k == 0:
            out, codes = out[:, skip:], codes[:, skip // 2:]
        start = max(start, code_gap(out, codes))
    n, k0 = run.total_steps, len(run.start_out)
    e0 = n - END_STEPS - -(-END_WARM_FRAMES // run.n_in)
    if e0 < k0:
        raise RuntimeError(f"a stream of {n} blocks is too short for the check")
    own = ref.follow(k0, n, run.inputs, END_WARM_FRAMES)
    prog_agc = own_agc = None
    if digital:
        prog_agc, own_agc = run.end_agc, reference_agc(ref, run, n - END_STEPS)
    own_gaps = _end(ref, run, e0, lambda k: own[k - k0], own_agc)
    gaps = own_gaps
    if ref.iq:
        if cell.due_period(run.n_in) < n - e0:
            raise RuntimeError("an I/Q update would fall inside the compared end")
        prog = torch.as_tensor(run.final_factors, dtype=torch.float64).to(ref.dev)
        gaps = _end(ref, run, e0, lambda k: prog, prog_agc)
    elif digital:
        gaps = _end(ref, run, e0, lambda k: own[k - k0], prog_agc)
    numbers = {"start_gap_codes": start, "end_gap_codes": float(gaps.max()),
               "end_median_gap_codes": float(own_gaps.median())}
    if digital:
        numbers["end_agc_state_gap"] = agc_state_gap(prog_agc, own_agc, ref.lock_samples,
                                                     ref.hang_samples)
    return numbers


def check(run: Run, device) -> list:
    """[(name, value, limit)] of the numbers compared."""
    with torch.no_grad():
        numbers = spans(run, device)
    limits = run.cell.workload["limits"]
    return [(name, value, float(limits[name])) for name, value in numbers.items()]
