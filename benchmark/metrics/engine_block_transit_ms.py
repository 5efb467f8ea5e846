"""engine_block_transit_ms.<mode>: a block's time from the reader's
hand-over to the writer's return from its last sink, in ms: the span
engine.transit of the program's span record, its median over the newest
engine run's blocks (engine_feed_ms.block_median_ms)."""

from benchmark.metrics.engine_feed_ms import block_median_ms


def read(run):
    return block_median_ms(("engine.transit",))
