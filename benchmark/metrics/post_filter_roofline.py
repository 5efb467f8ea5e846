"""post_filter_roofline: the band-pass pass's bound a step (the designed
filter after the resampler on a banded pass of its own, as
harness/bounds.py counts it: ``bounds._banded`` over
``design.filter_band`` at the stride ``bounds.step_bounds`` takes)
times the steps traced, over the device time of the port's kernels that
the program's stage record lists for the stage chain.post_filter.

The stage record is the newest graph capture's {stage: {CUDA symbol:
launches}} (``trace.stage_kernels()`` in
iq_tool_tpu_torch/pipeline/trace.py).  Nothing is read where the program
keeps no record, where the chain runs no such pass, or where a kernel
the stage lists is also launched by another stage: its time is not
apportioned between them.  ``stage_record`` and ``stage_seconds`` serve
every reader of the record."""

from benchmark.harness import bounds as B
from benchmark.harness.trace import _short
from benchmark.reference import design as D

STAGE = "chain.post_filter"


def stage_record() -> dict | None:
    """The program's newest capture's {stage: {symbol: launches}}, or None
    where the program keeps none."""
    try:
        from iq_tool_tpu_torch.pipeline import trace
    except ImportError:
        return None
    read = getattr(trace, "stage_kernels", None)
    return read() if read is not None else None


def _symbol(name: str) -> str:
    """A device event's kernel symbol: its short name without namespaces."""
    return _short(name).split("::")[-1]


def stage_seconds(dev_trace, record: dict | None, stage: str,
                  symbols=None) -> float | None:
    """Device seconds in the traced window of the kernels ``record`` lists
    for ``stage`` (of those among ``symbols``, if given); None where the
    record lists none, or where another stage launches one of them too."""
    if dev_trace is None or not record or not record.get(stage):
        return None
    mine = {s for s in record[stage] if symbols is None or s in symbols}
    if not mine or any(mine & set(k) for st, k in record.items() if st != stage):
        return None
    sec = sum(s for name, (s, _) in dev_trace.kernels.items() if _symbol(name) in mine)
    return sec if sec > 0 else None


def post_filter_bound(chain: dict, channels: int, n_in: int, rows: int = 1) -> float | None:
    """Seconds a step: the least time of the band-pass pass of ``chain``
    over (channels, n_in) blocks, as ``bounds.step_bounds`` adds it; None
    where the chain runs no filter pass of its own on the banded kernel."""
    out_rate = float(chain["target_rate"])
    reqs = [tuple(f) for f in chain.get("filters", [])]
    taps = D.design_chain(reqs, out_rate) if reqs else None
    if B.filter_pass(chain, taps) != "banded":
        return None
    n = n_in
    for st in D.plan_resampler(out_rate / float(chain["input_rate"]), n_in // rows).stages:
        n = n * st.p // st.q
    tail = chain.get("agc_profile") or chain.get("freq_shift_post_hz")
    stride = D.largest_divisor_leq(n, D.BANDED_STRIDE_CAP)
    return B._banded(D.filter_band(taps, stride), stride, n, channels, planes_in=True,
                     packed_out=not tail, dc=False, wire=B.WIRE_BYTES[chain["input_format"]])


def read(run):
    sec = stage_seconds(run.dev_trace, stage_record(), STAGE)
    if sec is None:
        return None
    bound = post_filter_bound(run.cell.chain, run.cell.channels, run.n_in, run.rows)
    return None if bound is None else 100.0 * bound * run.steps / sec
