"""The control of the check that decides ``correct``: the plain reference
put in the program's place and computed one precision below the
configuration's float32, every product's operands in TF32
(``reference/chain.py`` ``precision="tf32"``), driven at the cell's own
size over the cell's own seeded input and judged by the run's own check
(``harness/check.py``), which has to read it as not correct.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 [--device cuda]

Prints one JSON line a seed: ``correct`` and each number compared with
its limit.  The stream is ``--blocks`` long (at least the blocks both
compared spans need, and with the digital AGC past its scan, rounded up
to the I/Q estimator's period), as a short window at the cell's load:
it compares as many blocks as a run.  The control's digital AGC state
entering the compared end is recorded as the program's is.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from benchmark.harness import cell as cells, check, drive  # noqa: E402
from benchmark.reference.chain import RefChain, quantize_cs16  # noqa: E402


def control_run(cell, seed: int, device, blocks: int) -> drive.Run:
    """A run whose stepper is the TF32 reference: the cell's capture, its
    ring cycled a block a step, the first and last blocks kept."""
    chain = cells.build_chain(cell, device)
    n_in, n_out, rows = chain.n_in, chain.n_out, getattr(chain, "fold", 1)
    c, slots = cell.channels, int(cell.traffic["ring_blocks"])
    cap = drive.capture(cell, chain, seed, device)
    ring = cap.view(c, slots, chain.in_wire_len).transpose(0, 1).contiguous()
    del cap, chain
    ctl = RefChain(cell.chain, c, cell.block, rows, device, "tf32")
    least = drive.least_blocks(n_in)
    if ctl.agc == "digital":            # past the scan: the block entered with 2 s seen
        least = max(least, ctl.lock_samples // n_out + 2 + drive.END_STEPS)
    period = cell.due_period(n_in)
    n = -(-max(blocks, least) // period) * period
    run = drive.Run(cell, seed, 0.0, False, str(device), 0.0, mode="control", rows=rows,
                    n_in=n_in, n_out=n_out, total_steps=n, steps=n)
    run.inputs = lambda k: ring[k % slots]
    for k in range(n):
        if ctl.agc == "digital" and k == n - drive.END_STEPS:
            run.end_agc = ctl.agc_state()
        out = quantize_cs16(ctl.step(run.inputs(k)))
        if k < drive.START_STEPS:
            run.start_out.append(out)
        if k >= n - drive.END_STEPS:
            run.end_out.append(out)
    run.final_factors = ctl.factors
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--blocks", type=int, default=40)
    args = ap.parse_args(argv)
    cell = cells.load(args.workload)
    for seed in args.seeds:
        with torch.no_grad():
            run = control_run(cell, seed, args.device, args.blocks)
        numbers = check.check(run, args.device)
        print(json.dumps({"cell": cell.name, "seed": seed, "control": "tf32",
                          "blocks": run.total_steps,
                          "correct": all(v <= lim for _, v, lim in numbers),
                          "check": {n: {"value": v, "limit": lim} for n, v, lim in numbers}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
