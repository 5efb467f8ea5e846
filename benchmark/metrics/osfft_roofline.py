"""osfft_roofline: K5's bound a step (the overlap-save notch's
samples in and out once, harness/bounds.py) times the steps traced, over
the device time of the launches named osfft_kernel (csrc/osfft.cu)."""


def read(run):
    t = run.dev_trace
    if t is None or not run.bounds.get("osfft"):
        return None
    sec, _ = t.family_s("osfft_kernel")
    if sec <= 0:
        return None
    return 100.0 * run.bounds["osfft"] * run.steps / sec
