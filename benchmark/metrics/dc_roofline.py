"""dc_roofline: the DC kernel's bound a step over the packed wire (the
wire in, 2 bytes a frame for cu8 and 4 for cs16, the processed planes
out, 40 operations a frame at FP32 peak: the term harness/bounds.py
``step_bounds`` adds for a DC block outside K1) times the steps traced,
over the device time of dc_kernel (csrc/banded_dc.cu) as the program's
stage record lists it for the stage that runs the DC block
(post_filter_roofline.stage_record).  Nothing is read where the program
keeps no record, where the DC block runs inside K1 (stage 0 reading the
wire: its bound is K1's), or where more than one stage launches
dc_kernel."""

from benchmark.harness import bounds as B
from benchmark.reference import design as D
from benchmark.metrics.post_filter_roofline import stage_record, stage_seconds

SYMBOL = "dc_kernel"


def dc_bound(chain: dict, channels: int, n_in: int) -> float | None:
    """Seconds a step: the DC kernel's least time over (channels, n_in)
    blocks, as ``bounds.step_bounds`` adds it; None where the chain has
    no DC block or runs it inside K1."""
    if not chain.get("dc_block"):
        return None
    reqs = [tuple(f) for f in chain.get("filters", [])]
    taps = D.design_chain(reqs, float(chain["target_rate"])) if reqs else None
    tail = chain.get("agc_profile") or chain.get("freq_shift_post_hz")
    fpass = B.filter_pass(chain, taps)
    if not (chain.get("iq_correction") or tail or fpass in ("banded", "osfft")):
        return None          # the wire path: K1 blocks DC in its loader
    wire = B.WIRE_BYTES[chain["input_format"]]
    return B.bound(channels * ((wire + 8) * n_in + 48), 40 * channels * n_in, B.PEAK_FP32_S)


def read(run):
    record = stage_record()
    stages = [st for st, k in (record or {}).items() if SYMBOL in k]
    if len(stages) != 1:
        return None
    sec = stage_seconds(run.dev_trace, record, stages[0], {SYMBOL})
    if sec is None:
        return None
    bound = dc_bound(run.cell.chain, run.cell.channels, run.n_in)
    return None if bound is None else 100.0 * bound * run.steps / sec
