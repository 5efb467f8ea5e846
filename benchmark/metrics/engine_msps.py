"""engine_msps: input Msps through the host engine, the frames of all
channels whose output reached the sinks over the time from run()'s
start to its last sink write (the drain included)."""


def read(run):
    if run.mode != "engine" or run.window_s <= 0:
        return None
    return run.frames_in / run.window_s / 1e6
