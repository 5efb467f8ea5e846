"""step_roofline.<mode>: the least time any implementation of the step
could take, the wire in read once and the wire out written once at
3.35 TB/s, over the device's busy time a step in the traced window.
The byte count does not depend on which kernels do the work."""


def read(run):
    t = run.dev_trace
    if t is None or t.busy_s <= 0 or not run.steps:
        return None
    return 100.0 * run.bounds["step"] / (t.busy_s / run.steps)
