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
"""

from __future__ import annotations

import torch

from benchmark.harness.drive import END_STEPS, END_WARM_FRAMES, Run
from benchmark.reference.chain import RefChain, channel_gaps, code_gap

# With an AGC the stream's first frames are not compared: the AGC starts
# at gain 1 on the resampler's start-up from zero history (output under
# 1e-9 of full scale) and drives its gain toward its 1e6 clamp there,
# multiplying the program's float32 rounding residue into codes until
# the signal arrives (about 1000 frames).
AGC_START_FRAMES = 4096


def _end(ref: RefChain, run: Run, e0: int, factors) -> torch.Tensor:
    """Each channel's widest gap over the end span: the reference
    warm-started at block e0, applying ``factors(k)`` on block k."""
    n = run.total_steps
    ref.skip_to(e0 * run.n_in)
    gaps = None
    for k in range(e0, n):
        ref.factors = factors(k)
        codes = ref.step(run.inputs(k), estimate=False)
        if k >= n - END_STEPS:
            g = channel_gaps(run.end_out[k - (n - END_STEPS)], codes)
            gaps = g if gaps is None else torch.maximum(gaps, g)
    return gaps


def spans(run: Run, device) -> dict:
    """{number: value} of the run's kept blocks against the reference's."""
    cell = run.cell
    ref = RefChain(cell.chain, cell.channels, cell.block, run.rows, device)
    if ref.n_in != run.n_in:
        raise RuntimeError(f"the reference frames {ref.n_in} frames a block, the program "
                           f"{run.n_in}")
    start = 0.0
    skip = 2 * AGC_START_FRAMES if cell.chain.get("agc_profile") else 0
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
    own_gaps = _end(ref, run, e0, lambda k: own[k - k0])
    gaps = own_gaps
    if ref.iq:
        if cell.due_period(run.n_in) < n - e0:
            raise RuntimeError("an I/Q update would fall inside the compared end")
        prog = torch.as_tensor(run.final_factors, dtype=torch.float64).to(ref.dev)
        gaps = _end(ref, run, e0, lambda k: prog)
    return {"start_gap_codes": start, "end_gap_codes": float(gaps.max()),
            "end_median_gap_codes": float(own_gaps.median())}


def check(run: Run, device) -> list:
    """[(name, value, limit)] of the numbers compared."""
    with torch.no_grad():
        numbers = spans(run, device)
    limits = run.cell.workload["limits"]
    return [(name, value, float(limits[name])) for name, value in numbers.items()]
