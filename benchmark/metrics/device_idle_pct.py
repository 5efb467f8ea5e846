"""device_idle_pct.<mode>: the share of the traced window in which no
operation ran on the card, 100 * (1 - busy / window), busy being the
union of the device events of torch.profiler's trace.  One reader for
every split of the metric (each moves its own cells' end-to-end metric).
On a CUDA graph the profiler's busy reads up to 6.3 % high against CUDA
events, so the idle share of a graphed step reads low by as much."""


def read(run):
    t = run.dev_trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
