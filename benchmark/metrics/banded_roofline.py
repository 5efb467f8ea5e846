"""banded_roofline: the banded kernels' bounds a step (K1, the DC
kernel, K2: harness/bounds.py) times the steps traced, over the device
time of the launches named banded_kernel, banded_mma_kernel and
dc_kernel (csrc/banded.cu, banded_mma.cu, banded_dc.cu)."""

FAMILY = ("banded_kernel", "banded_mma_kernel", "dc_kernel")


def read(run):
    t = run.dev_trace
    if t is None or not run.bounds.get("banded"):
        return None
    sec, launches = t.family_s(*FAMILY)
    if sec <= 0:
        return None
    return 100.0 * run.bounds["banded"] * run.steps / sec
