"""engine_write_ms.<mode>: the writer thread's write of a block's output
rows into the sinks, in ms: the span engine.write of the program's span
record, its median over the newest engine run's blocks
(engine_feed_ms.block_median_ms)."""

from benchmark.metrics.engine_feed_ms import block_median_ms


def read(run):
    return block_median_ms(("engine.write",))
