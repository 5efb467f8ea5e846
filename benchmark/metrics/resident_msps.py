"""resident_msps: input Msps of the resident window, every channel's
frames of every step completed over the window's wall time, which ends
in torch.cuda.synchronize()."""


def read(run):
    if run.mode != "resident" or run.window_s <= 0:
        return None
    return run.frames_in / run.window_s / 1e6
