"""engine_feed_ms.<mode>: the median over the newest engine run's blocks
of the main thread's feed of a block, in ms: the spans engine.stack,
engine.pin, engine.h2d, engine.step and engine.d2h that the program's
host engine (iq_tool_tpu_torch/pipeline/runtime.py) records in its span
record (pipeline/trace.py) under the run's serial and the block's
index.  ``block_median_ms`` is the one reading of that record for every
engine span metric; a program without the record reads nothing."""

import statistics

SPANS = ("engine.stack", "engine.pin", "engine.h2d", "engine.step", "engine.d2h")


def block_median_ms(names) -> float | None:
    """The median over the newest engine run's blocks of the time a block
    spent in the spans ``names``, in ms; None where the program records
    none of them."""
    try:
        from iq_tool_tpu_torch.pipeline import trace
    except ImportError:
        return None
    spans = [s for s in trace.record() if s.name.startswith("engine.")]
    if not spans:
        return None
    newest = max(s.run for s in spans)
    per: dict = {}
    for s in spans:
        if s.run == newest and s.name in names and s.block is not None:
            per[s.block] = per.get(s.block, 0) + s.end_ns - s.start_ns
    return 1e-6 * statistics.median(per.values()) if per else None


def read(run):
    return block_median_ms(SPANS)
