"""engine_input_wait_ms.<mode>: the main thread's wait for the reader's
next block, in ms: the span engine.wait_input of the program's span
record, its median over the newest engine run's blocks
(engine_feed_ms.block_median_ms)."""

from benchmark.metrics.engine_feed_ms import block_median_ms


def read(run):
    return block_median_ms(("engine.wait_input",))
