"""engine_assemble_ms.<mode>: the reader thread's cut of a block's bytes, a
channel at a time, from its sources' blocks, in ms: the span
engine.assemble of the program's span record, its median over the newest
engine run's blocks (engine_feed_ms.block_median_ms)."""

from benchmark.metrics.engine_feed_ms import block_median_ms


def read(run):
    return block_median_ms(("engine.assemble",))
