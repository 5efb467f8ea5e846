"""Multi-stage rational polyphase resampler, the port of
``iq_tool_tpu.ops.resample``.

The design half is numpy and is the reference's, line for line, so the
port's banded matrices equal the reference's bit for bit: the ratio is
rationalized to P/Q, split into small coprime stages p_i/q_i, and each
stage's exact per-phase Kaiser-sinc weights are densified into a banded
matrix A[L, G] (windows of L = g*q + hist inputs at stride g*q give
G = g*p outputs).  The run half applies each stage through the K2
wrapper (ops/kernels.py), which launches the CUDA kernel on CUDA tensors
and runs the plain windows + matmul path on CPU tensors.

Ratios whose rationalization keeps a prime factor too large to stage
run one exact gather stage instead (``_ArbStage``) through
``kernels.gather_apply``: on the card a CUDA kernel of its own
(``csrc/gather.cu``), on the CPU its plain twin; the reference runs the
stage in XLA outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import numpy as np
import torch

from iq_tool_tpu_torch import constants as C
from iq_tool_tpu_torch.ops import banded, kernels
from iq_tool_tpu_torch.ops.fir_design import kaiser_beta as _kaiser_beta
from iq_tool_tpu_torch.pipeline.trace import stage_span


def rationalize(ratio: float, max_denom: int = C.RESAMP_MAX_DENOM) -> tuple[int, int]:
    """ratio -> (P, Q) in lowest terms, |ratio - P/Q| minimal for Q <= max."""
    if not (C.RESAMPLE_RATIO_MIN <= ratio <= C.RESAMPLE_RATIO_MAX):
        raise ValueError(
            f"resample ratio {ratio} out of range "
            f"[{C.RESAMPLE_RATIO_MIN}, {C.RESAMPLE_RATIO_MAX}]")
    fr = Fraction(ratio).limit_denominator(max_denom)
    return fr.numerator, fr.denominator


def _kernel(t: np.ndarray, fc: float, semilen: int, beta: float) -> np.ndarray:
    """Kaiser-windowed sinc at arbitrary real offsets t (input-sample units)."""
    w_arg = 1.0 - (t / semilen) ** 2
    w = np.where(w_arg > 0, np.i0(beta * np.sqrt(np.maximum(w_arg, 0.0))), 0.0)
    w = w / np.i0(beta)
    g = 2.0 * fc * np.sinc(2.0 * fc * t)
    return np.where(np.abs(t) <= semilen, g * w, 0.0)


def _prime_factors(n: int) -> list[int]:
    """Prime factors with multiplicity, descending."""
    out, d = [], 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return sorted(out, reverse=True)


def decompose_stages(p: int, q: int,
                     max_factor: int = C.RESAMP_STAGE_MAX) -> list[tuple[int, int]] | None:
    """Split P/Q (coprime) into stage ratios (p_i, q_i), each <= max_factor,
    whose product is exactly P/Q, or None if a prime factor is too large.
    Stages are sorted by descending ratio so intermediate rates never dip
    below the final rate."""
    pf, qf = _prime_factors(p), _prime_factors(q)
    if (pf and pf[0] > max_factor) or (qf and qf[0] > max_factor):
        return None
    stages: list[tuple[int, int]] = []
    while pf or qf:
        pi = 1
        while pf and pi * pf[0] <= max_factor:
            pi *= pf.pop(0)
        qi = 1
        while qf and qi * qf[0] <= max_factor and pi / (qi * qf[0]) >= 0.45:
            qi *= qf.pop(0)
        if pi == 1 and qi == 1 and qf:
            qi = qf.pop(0)                      # forced deep-decim stage
        if pi == 1 and qi == 1:
            break
        stages.append((pi, qi))
    stages.sort(key=lambda s: s[0] / s[1], reverse=True)
    return stages


@dataclasses.dataclass(frozen=True)
class ArbPlan:
    p: int
    q: int
    n_in: int
    n_out: int
    semilength: int
    history: int
    weights: np.ndarray
    starts: np.ndarray


def _make_arb_plan(p: int, q: int, n_in: int, atten_db: float,
                   semilength: int) -> ArbPlan:
    if n_in % q:
        raise ValueError(f"block {n_in} is not a multiple of q={q}")
    n_out = n_in * p // q
    m = int(semilength)
    k_taps = 2 * m
    hist = 2 * m - 1
    beta = _kaiser_beta(atten_db)
    fc = 0.5 * min(1.0, p / q) * C.RESAMP_FC_FACTOR

    mm = np.arange(n_out, dtype=np.float64)
    tau = mm * q / p - m               # delayed interpolation time
    n_base = np.floor(tau).astype(np.int64)
    frac = tau - n_base
    k = np.arange(k_taps, dtype=np.float64)
    t = frac[:, None] + (m - 1) - k[None, :]
    w = _kernel(t, fc, m, beta)
    w = w / np.sum(w, axis=1, keepdims=True)   # exact unity DC per phase
    starts = (n_base - m + 1 + hist).astype(np.int64)
    if starts.min() < 0 or starts.max() + k_taps > n_in + hist:
        raise ValueError(f"polyphase plan out of range for p/q={p}/{q}")
    return ArbPlan(p=p, q=q, n_in=n_in, n_out=n_out, semilength=m,
                   history=hist, weights=w.astype(np.float32),
                   starts=starts.astype(np.int32))


class _ArbStage:
    """The gather stage (the reference's ``_ArbStage``): one exact
    polyphase stage, output m the dot of the plan's K weights with the K
    inputs from ``starts[m]`` on, over ext = history ++ block.

    Gathered whole, the windows are a (C, M, K) tensor: at 128 channels,
    3143 outputs and 1298 taps (2469/200000 at a 262144-frame target)
    2.1 GB a plane.  So no window tensor is built: ``kernels.gather_apply``
    runs the stage, on the card as one kernel (``csrc/gather.cu``: each
    CTA stages its span of history and block in shared memory and sums
    in FP32 in a fixed order), on the CPU as its twin's weighted bag sums
    (``embedding_bag``), the reference's gather and einsum bit for bit.
    Either way two runs give the same bits.  The plan's outputs repeat
    every n_in inputs, so a block of r * n_in samples (a time fold) takes
    the plan's rows r times, each n_in further on, in one call."""

    def __init__(self, plan: ArbPlan):
        self.plan = plan
        self.p, self.q = plan.p, plan.q
        self.hist = plan.history
        self.table: kernels.Gather | None = None

    def bind(self, device) -> None:
        self.table = kernels.Gather.build(self.plan.weights, self.plan.starts,
                                          self.plan.n_in, self.hist, device)

    def init_planar(self, channels: int, device=None):
        z = lambda: torch.zeros((channels, self.hist), dtype=torch.float32,
                                device=device)
        return z(), z()

    def apply_planar(self, xr, xi, state_r, state_i, pack_fmt=None):
        """((yr, yi), new_r, new_i) for a block of a multiple of n_in."""
        if pack_fmt:
            raise ValueError("the gather stage has no packed epilogue")
        y = kernels.gather_apply(xr, xi, state_r, state_i, self.table)
        return (y, banded.new_tail(state_r, xr, self.hist),
                banded.new_tail(state_i, xi, self.hist))


class _MatmulStage:
    """Rational p/q polyphase stage: windows of L = g*q + hist at stride
    g*q, out = win @ A with A[L, g*p] the exact per-phase weights (the
    reference's ``_MatmulStage``).  ``bind(device)`` places A on a device
    for the run half."""

    def __init__(self, p: int, q: int, n_in: int, atten_db: float,
                 semilength: int, group_cap: int = C.RESAMP_GROUP_CAP):
        if n_in % q:
            raise ValueError(f"block {n_in} is not a multiple of q={q}")
        nb_total = n_in // q
        g = 1
        cap = max(1, group_cap // max(p, q))
        # the reference prefers lane-aligned strides; the same search keeps
        # the port's geometry equal to it (the CUDA kernels take any stride)
        for align in (128, 16, 1):
            found = 0
            for d in range(cap, 0, -1):
                if nb_total % d == 0 and (d * q) % align == 0:
                    found = d
                    break
            if found:
                g = found
                break
        m = max(semilength, int(np.ceil(semilength * q / (2.0 * p))))
        plan = _make_arb_plan(p, q, g * q, atten_db, m)
        k_taps = plan.weights.shape[1]
        L = g * q + plan.history
        G = g * p
        a = np.zeros((L, G), np.float32)
        for i in range(G):
            a[plan.starts[i]:plan.starts[i] + k_taps, i] = plan.weights[i]
        self.p, self.q, self.g = p, q, g
        self.stride = g * q
        self.hist = plan.history
        self._a = a
        self._a_i = None          # imaginary part when an FIR was composed
        self.band: kernels.Band | None = None

    # An FIR before/after the stage is also LTI, so it folds into the
    # banded matrix at design time: one fewer pass at run time.

    def compose_input_fir(self, taps: np.ndarray) -> None:
        """Absorb y = stage(fir(x)): convolve A's rows with the taps."""
        k = len(taps)
        l_old, g = self._a.shape
        a_old = (self._a.astype(np.complex128)
                 + (1j * self._a_i if self._a_i is not None else 0))
        a_new = np.zeros((l_old + k - 1, g), np.complex128)
        for j in range(k):
            a_new[k - 1 - j:k - 1 - j + l_old, :] += taps[j] * a_old
        self.hist += k - 1
        self._a = np.ascontiguousarray(a_new.real.astype(np.float32))
        self._a_i = (np.ascontiguousarray(a_new.imag.astype(np.float32))
                     if np.abs(a_new.imag).max() > 0 else None)

    def compose_output_fir(self, taps: np.ndarray) -> None:
        """Absorb z = fir(stage(x)): z[bG+i] = sum_j h[j] y[bG+i-j] reaches
        ceil((K-1)/G) groups back, so the window grows left by that many
        strides and A's columns accumulate shifted copies."""
        k = len(taps)
        l_old, gg = self._a.shape
        s = self.stride
        kb = -(-(k - 1) // gg)
        ext = kb * s
        a_old = (self._a.astype(np.complex128)
                 + (1j * self._a_i if self._a_i is not None else 0))
        a_c = np.zeros((l_old + ext, gg), np.complex128)
        for j in range(k):
            for i in range(gg):
                d, r = divmod(i - j, gg)       # d <= 0: groups back
                off = ext + d * s
                a_c[off:off + l_old, i] += taps[j] * a_old[:, r]
        self.hist += ext
        self._a = np.ascontiguousarray(a_c.real.astype(np.float32))
        self._a_i = (np.ascontiguousarray(a_c.imag.astype(np.float32))
                     if np.abs(a_c.imag).max() > 0 else None)

    def bind(self, device) -> None:
        """Place the (final, composed) matrix on `device`."""
        self.band = kernels.Band.build(self._a, self._a_i, device)

    def init_planar(self, channels: int, device=None):
        z = lambda: torch.zeros((channels, self.hist), dtype=torch.float32,
                                device=device)
        return z(), z()

    def apply_planar(self, xr, xi, state_r, state_i, pack_fmt=None):
        """(y planes | packed wire, new_r, new_i) for one block."""
        y = kernels.banded_apply(state_r, state_i, xr, xi, self.band, None,
                                 self.stride, self.hist, pack_fmt=pack_fmt)
        return (y, banded.new_tail(state_r, xr, self.hist),
                banded.new_tail(state_i, xi, self.hist))


@dataclasses.dataclass(frozen=True)
class ResamplePlan:
    p: int
    q: int
    n_in: int
    n_out: int
    stages: tuple[tuple[int, int], ...]   # per-stage (p_i, q_i); () = passthrough
    fallback: bool = False                # True -> one gather stage (_ArbStage)

    @property
    def ratio(self) -> float:
        return self.p / self.q


class Resampler:
    """Multi-stage streaming resampler design.

    Block contract: input blocks of exactly ``plan.n_in`` frames produce
    exactly ``plan.n_out`` frames.  A ratio with a prime factor above
    RESAMP_STAGE_MAX runs one gather stage (``plan.fallback``)."""

    def __init__(self, ratio: float, target_block: int = C.DEFAULT_BLOCK_SIZE,
                 atten_db: float = C.RESAMPLER_ATTENUATION_DB,
                 semilength: int = C.RESAMP_SEMILENGTH,
                 max_denom: int = C.RESAMP_MAX_DENOM,
                 max_out: int = 1 << 21):
        p, q = rationalize(ratio, max_denom)
        ratios = decompose_stages(p, q)

        unit = q
        blocks = max(1, round(target_block / unit))
        n_in = blocks * unit
        n_out = n_in * p // q
        while n_out > max_out and blocks > 1:
            blocks -= 1
            n_in = blocks * unit
            n_out = n_in * p // q
        if n_out > max_out:
            raise ValueError(
                f"ratio {p}/{q}: block would need {n_out} outputs (> {max_out})")

        self.stages: list = []
        fallback = ratios is None and p != q
        if fallback:
            # deep decimation needs the semilength scaling _MatmulStage
            # applies, else the anti-alias transition band is far too wide
            # (~11 dB alias rejection at 2469/200000 unscaled)
            m = max(semilength, int(np.ceil(semilength * q / (2.0 * p))))
            self.stages.append(_ArbStage(_make_arb_plan(p, q, n_in, atten_db, m)))
            ratios = [(p, q)]
        elif p != q:
            n_s = n_in
            for pi, qi in ratios:
                self.stages.append(_MatmulStage(pi, qi, n_s, atten_db, semilength))
                n_s = n_s * pi // qi
            if n_s != n_out:
                raise ValueError(f"stage cascade gives {n_s} outputs, not {n_out}")
        else:
            ratios = []
        self.plan = ResamplePlan(p=p, q=q, n_in=n_in, n_out=n_out,
                                 stages=tuple(ratios or ()), fallback=fallback)

    @property
    def packs(self) -> bool:
        """Whether the last stage can quantize to the packed wire (a
        banded stage; the gather stage cannot)."""
        return bool(self.stages) and isinstance(self.stages[-1], _MatmulStage)

    def bind(self, device) -> None:
        for st in self.stages:
            st.bind(device)

    def init_planar(self, channels: int, device=None) -> tuple:
        return tuple(s.init_planar(channels, device) for s in self.stages)

    def apply_planar(self, xr, xi, state: tuple, pack_fmt=None):
        """All stages; the last one quantizes straight to the packed wire
        when ``pack_fmt`` is given (only where ``packs``).  Returns
        (y planes | packed wire, new_state)."""
        new_states = []
        last = len(self.stages) - 1
        y = (xr, xi)
        for i, (stage, (sr, si)) in enumerate(zip(self.stages, state)):
            with stage_span(f"chain.resample.{i}"):
                y, nr, ni = stage.apply_planar(*y, sr, si,
                                               pack_fmt=pack_fmt if i == last else None)
            new_states.append((nr, ni))
        return y, tuple(new_states)
