"""The least time the card could take for a step's work, by kernel family.

The arithmetic is the port's ``chip_smoke.py`` ``bound``/``tf32x3_ops``
and its byte counts, copied: each input byte read once and each output
byte written once, and for a banded launch the band's own work (three
TF32 products a tap of each column, the band's longest, two planes, or
four with complex taps), never the kernel's padded tiles.  The shapes
come from the benchmark's own copy of the design (``reference/design.py``).
"""

from __future__ import annotations

from benchmark.reference import design as D

# NVIDIA's data sheet for the H100 SXM (dense)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_TF32_S = 495e12


def bound(nbytes: float, ops: float, rate: float) -> float:
    """Seconds: the larger of bytes over bandwidth and ops over peak."""
    return max(nbytes / PEAK_BYTES_S, ops / rate)


def _banded(a, stride: int, n: int, channels: int, planes_in: bool, packed_out: bool,
            dc: bool) -> float:
    """One banded stage over an n-sample block: windows of stride inputs
    give G outputs each."""
    nb = n // stride
    g_cols = a.shape[1]
    hist = a.shape[0] - stride
    k = D.column_span(a)
    planes = 4 if abs(a.imag).max() > 0 else 2
    ops = 3 * 2 * planes * channels * nb * g_cols * k
    if dc:       # the wire, the DC state and the tails in; planes out
        nbytes = channels * (4 * n + 2 * (16 + 8 * hist)) + channels * nb * g_cols * 8
    else:
        nbytes = (channels * (n + hist) * (8 if planes_in else 4)
                  + channels * nb * g_cols * (4 if packed_out else 8))
    return bound(nbytes, ops, PEAK_TF32_S)


def _osfft_windows(n: int, b: int) -> int:
    """Windows of the overlap-save schedule: 3b/2 advances, then b, then
    one re-anchored window for the rest."""
    w, s = 0, 0
    for adv in (3 * b // 2, b):
        w += (n - s) // adv
        s += (n - s) // adv * adv
    return w + (1 if s < n else 0)


def step_bounds(chain: dict, channels: int, n_in: int, n_out: int, rows: int = 1) -> dict:
    """{family: seconds a step} for the step of ``chain`` over (channels,
    n_in) blocks: "banded" (K1, the DC kernel, K2), "osfft" (K5), and
    "step", the wire in read once and the wire out written once."""
    in_rate, out_rate = float(chain["input_rate"]), float(chain["target_rate"])
    plan = D.plan_resampler(out_rate / in_rate, n_in // rows)
    reqs = [tuple(f) for f in chain.get("filters", [])]
    taps = D.design_chain(reqs, out_rate) if reqs else None
    fir = taps is not None and len(taps) <= D.FIR_MAX_TAPS
    wire_path = not (chain.get("iq_correction") or chain.get("agc_profile")
                     or chain.get("freq_shift_post_hz") or (taps is not None and not fir))
    out = {"step": channels * (4 * n_in + 4 * n_out) / PEAK_BYTES_S, "banded": 0.0,
           "osfft": 0.0}
    if not wire_path and chain.get("dc_block"):
        # the DC kernel over the packed wire: wire in, planes out
        out["banded"] += bound(channels * (12 * n_in + 48), 40 * channels * n_in, PEAK_FP32_S)
    n = n_in
    last = len(plan.stages) - 1
    for i, st in enumerate(plan.stages):
        g = D.group_stride(st.p, st.q, n // rows)
        a = D.banded_matrix(st, g).astype(complex)
        if fir and i == last and len(taps) <= D.FUSE_MAX_TAPS:
            a = D.compose_output_fir(a, g * st.q, taps)
        out["banded"] += _banded(a, g * st.q, n, channels, planes_in=not (wire_path and i == 0),
                                 packed_out=i == last and (wire_path or fir),
                                 dc=wire_path and i == 0 and bool(chain.get("dc_block")))
        n = n * st.p // st.q
    if taps is not None and not fir:
        b = D.choose_fft_block(len(taps), chain.get("filter_fft_size"))
        nfft = 2 * b
        nbytes = channels * (n + b) * 8 + channels * n * 8 + nfft * 8
        ops = channels * _osfft_windows(n, b) * (2 * 5 * nfft * (nfft.bit_length() - 1)
                                                 + 6 * nfft)
        out["osfft"] += bound(nbytes, ops, PEAK_FP32_S)
    return out
