"""The least time the card could take for a step's work, by kernel family.

The arithmetic is the port's ``chip_smoke.py`` ``bound``/``tf32x3_ops``
and its byte counts, copied: each input byte read once and each output
byte written once, and for a banded launch the band's own work (three
TF32 products a tap of each column, the band's longest, two planes, or
four with complex taps), never the kernel's padded tiles.  The shapes
come from the benchmark's own copy of the design (``reference/design.py``).
The input wire's bytes a frame follow the configuration's input format
(``WIRE_BYTES``); the output is cs16, 4 bytes a frame.

The gather stage (a ratio that no split into small stages gives) is a
family of its own: each output a dot of its own 2m taps, counted as the
banded stages' dot products are (3xTF32 on tensor cores: a kernel that
takes the tensor cores must not read over its bound), over the least
bytes it could move.
"""

from __future__ import annotations

from benchmark.reference import design as D

# NVIDIA's data sheet for the H100 SXM (dense)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_TF32_S = 495e12

WIRE_BYTES = {"cs16": 4, "cu8": 2, "cs8": 2}      # input wire bytes a frame
OUT_BYTES = 4                           # cs16 out


def bound(nbytes: float, ops: float, rate: float) -> float:
    """Seconds: the larger of bytes over bandwidth and ops over peak."""
    return max(nbytes / PEAK_BYTES_S, ops / rate)


def _banded(a, stride: int, n: int, channels: int, planes_in: bool, packed_out: bool,
            dc: bool, wire: int) -> float:
    """One banded stage over an n-sample block: windows of stride inputs
    give G outputs each; without ``planes_in`` it reads the input wire of
    ``wire`` bytes a frame."""
    nb = n // stride
    g_cols = a.shape[1]
    hist = a.shape[0] - stride
    k = D.column_span(a)
    planes = 4 if abs(a.imag).max() > 0 else 2
    ops = 3 * 2 * planes * channels * nb * g_cols * k
    if dc:       # the wire, the DC state and the tails in; planes out
        nbytes = channels * (wire * n + 2 * (16 + 8 * hist)) + channels * nb * g_cols * 8
    else:
        nbytes = (channels * (n + hist) * (8 if planes_in else wire)
                  + channels * nb * g_cols * (OUT_BYTES if packed_out else 8))
    return bound(nbytes, ops, PEAK_TF32_S)


def _gather(st: D.Gather, n: int, channels: int, in_bytes: int, out_bytes: int) -> float:
    """The gather stage over an n-sample block: 3 (3xTF32) x 2 x 2 planes
    x 2m taps an output of each channel at the TF32 peak, as ``_banded``
    counts real taps; the block in at ``in_bytes`` a frame and the
    stage's history (planes), the outputs out at ``out_bytes`` a frame."""
    n_out = n * st.p // st.q
    hist = 2 * st.m - 1
    ops = 3 * 2 * 2 * 2 * st.m * channels * n_out
    nbytes = channels * (n * in_bytes + 8 * hist) + channels * n_out * out_bytes
    return bound(nbytes, ops, PEAK_TF32_S)


def _osfft_windows(n: int, b: int) -> int:
    """Windows of the overlap-save schedule: 3b/2 advances, then b, then
    one re-anchored window for the rest."""
    w, s = 0, 0
    for adv in (3 * b // 2, b):
        w += (n - s) // adv
        s += (n - s) // adv * adv
    return w + (1 if s < n else 0)


def filter_pass(chain: dict, taps) -> str | None:
    """How the port runs the designed filter after the resampler: "fused"
    into the last stage (an FIR of up to FUSE_MAX_TAPS), "banded" (a pass
    of its own on the banded kernel: any other FIR, and an FFT-method
    filter of up to FFT_BANDED_MAX_TAPS, which overlap-save would compute
    exactly), or "osfft" (K5); None without a filter."""
    if taps is None:
        return None
    method = chain.get("filter_method", "auto")
    if method == "auto":
        method = "fir" if len(taps) <= D.FIR_MAX_TAPS else "fft"
    if method == "fir":
        return "fused" if len(taps) <= D.FUSE_MAX_TAPS else "banded"
    return "banded" if len(taps) <= D.FFT_BANDED_MAX_TAPS else "osfft"


def step_bounds(chain: dict, channels: int, n_in: int, n_out: int, rows: int = 1) -> dict:
    """{family: seconds a step} for the step of ``chain`` over (channels,
    n_in) blocks: "banded" (K1, the DC kernel, K2), "osfft" (K5), "gather"
    (the gather stage, a key only where the plan has one), and "step",
    the wire in read once and the wire out written once.

    The gather stage as stage 0 reads the wire: the elementwise work
    before it could be fused into its loader, as K1 and K2 decode the
    wire in theirs.  It writes the output wire where it is the last stage
    and only the pack follows, else planes.  An FIR after it runs as a
    banded pass of its own: only a banded stage takes one in."""
    in_rate, out_rate = float(chain["input_rate"]), float(chain["target_rate"])
    wire = WIRE_BYTES[chain["input_format"]]
    plan = D.plan_resampler(out_rate / in_rate, n_in // rows)
    reqs = [tuple(f) for f in chain.get("filters", [])]
    taps = D.design_chain(reqs, out_rate) if reqs else None
    fpass = filter_pass(chain, taps)
    if fpass == "fused" and isinstance(plan.stages[-1], D.Gather):
        fpass = "banded"
    tail = chain.get("agc_profile") or chain.get("freq_shift_post_hz")   # K4 packs
    wire_path = not (chain.get("iq_correction") or tail or fpass in ("banded", "osfft"))
    out = {"step": channels * (wire * n_in + OUT_BYTES * n_out) / PEAK_BYTES_S,
           "banded": 0.0, "osfft": 0.0}
    if not wire_path and chain.get("dc_block"):
        # the DC kernel over the packed wire: wire in, planes out
        out["banded"] += bound(channels * ((wire + 8) * n_in + 48), 40 * channels * n_in,
                               PEAK_FP32_S)
    n = n_in
    last = len(plan.stages) - 1
    for i, st in enumerate(plan.stages):
        packed_out = i == last and fpass in (None, "fused") and not tail
        if isinstance(st, D.Gather):
            out["gather"] = _gather(st, n, channels, wire if i == 0 else 8,
                                     OUT_BYTES if packed_out else 8)
            n = n * st.p // st.q
            continue
        g = D.group_stride(st.p, st.q, n // rows)
        a = D.banded_matrix(st, g).astype(complex)
        if fpass == "fused" and i == last:
            a = D.compose_output_fir(a, g * st.q, taps)
        out["banded"] += _banded(a, g * st.q, n, channels, planes_in=not (wire_path and i == 0),
                                 packed_out=packed_out,
                                 dc=wire_path and i == 0 and bool(chain.get("dc_block")),
                                 wire=wire)
        n = n * st.p // st.q
    if fpass == "banded":
        stride = D.largest_divisor_leq(n, D.BANDED_STRIDE_CAP)
        out["banded"] += _banded(D.filter_band(taps, stride), stride, n, channels,
                                 planes_in=True, packed_out=not tail, dc=False, wire=wire)
    if fpass == "osfft":
        b = D.choose_fft_block(len(taps), chain.get("filter_fft_size"))
        nfft = 2 * b
        nbytes = channels * (n + b) * 8 + channels * n * 8 + nfft * 8
        ops = channels * _osfft_windows(n, b) * (2 * 5 * nfft * (nfft.bit_length() - 1)
                                                 + 6 * nfft)
        out["osfft"] += bound(nbytes, ops, PEAK_FP32_S)
    return out
