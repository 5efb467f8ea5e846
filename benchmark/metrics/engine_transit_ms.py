"""engine_transit_ms.<mode>: the median over the window's blocks of the
time from the benchmark's source handing the engine a block's last byte
to its sink receiving that block's output, in ms: the host engine's
reader queue, stack, pinned copy, step and writer, stamped by the
benchmark's own source and sink."""

import statistics


def read(run):
    if not run.transits:
        return None
    return 1e3 * statistics.median(run.transits)
