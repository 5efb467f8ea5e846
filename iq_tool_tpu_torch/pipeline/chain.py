"""The DSP chain on torch: one step per block of the whole signal path
(the port of ``iq_tool_tpu.pipeline.chain``).

    convert -> dc_block -> iq_correct -> pre-NCO -> pre-filter
            -> resample -> post-filter -> post-NCO -> AGC -> convert

The stages a step runs are decided once, in ``Chain.route`` (a
``Route``), and ``Chain._step`` walks them; the time-sharded step
(``parallel/sharded.py``) walks the same route.  Two paths, as in the
reference:

* the wire-to-wire resample path (``route.wire_stage0``) when nothing but
  DC block, pre-NCO and the resampler runs on a packable wire: stage 0
  is K1 (``kernels.banded_apply_dc``) with the DC block, else K2 with
  the wire + NCO prologue; the last stage quantizes straight to the wire;
* the general step otherwise: the pre-stage is K3
  (``kernels.dc_block_apply``: DC block + I/Q apply + pre-NCO over the
  packed wire or, for other formats, converted planes) when the DC block
  is on, K3pre (``kernels.pre_apply``: the same without the DC block)
  when it is off; filters run on K2 (banded) or
  K5 (``kernels.osfft_apply``, overlap-save); the resampler's stages on
  K2, or its one gather stage in plain torch; the post stage is K4
  (``kernels.post_apply``: post-NCO + AGC gains + pack, the RMS gains
  from the ``kernels.rms_gains`` helper) for a packable output, plain
  ops for the others.  Whatever op is last
  before the convert packs the wire in its kernel epilogue.

On a CUDA device each of those calls launches its kernel; on the CPU the
same calls run the kernels' plain twins.  The device is an explicit
argument: asking for CUDA without a card raises, nothing falls back to
the CPU.  A step never reads a device value back to the host (the I/Q
estimator's kernel reads its due counter on the card, see
``ops/iq_balance.py``).  All stream state
lives in the carry, a dict of tensors:

    nco_pre, nco_post: (C,) int64 holding uint32 NCO phases
    dc:                (C, 4) float32 [xr_prev, xi_prev, yr_prev, yi_prev]
    iq:                iq_balance.IqState (factors kept across a reset)
    pre_f, post_f:     filter tails (state_r, state_i)
    rs:                per stage (state_r, state_i), (C, hist) float32,
                       the PROCESSED input history
    agc:               agc.AgcState
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from iq_tool_tpu_torch import constants as C
from iq_tool_tpu_torch.formats import get_format
from iq_tool_tpu_torch.ops import agc, convert, dc_block, iq_balance, kernels, nco
from iq_tool_tpu_torch.ops.filters import StreamingFilter
from iq_tool_tpu_torch.ops.fir_design import (FilterRequest, design_chain,
                                              max_filter_freq_hz)
from iq_tool_tpu_torch.ops.resample import Resampler, _MatmulStage
from iq_tool_tpu_torch.pipeline.trace import stage_span

@dataclasses.dataclass(frozen=True)
class ChainConfig:
    """User intent for one stream (the same fields as the reference's)."""
    input_format: str
    output_format: str
    input_rate: float
    target_rate: float | None = None          # None -> no resample
    channels: int = 1
    gain: float = 1.0
    dc_block: bool = False
    iq_correction: bool = False
    freq_shift_pre_hz: float = 0.0
    freq_shift_post_hz: float = 0.0
    filters: Sequence[FilterRequest] = ()
    filter_stage: str = "auto"                # auto | pre | post
    filter_method: str = "auto"               # auto | fir | fft
    filter_fft_size: int | None = None
    filter_taps: int | None = None
    filter_transition_hz: float | None = None
    filter_attenuation_db: float = C.RESAMPLER_ATTENUATION_DB
    agc_profile: str | None = None            # dx | local | digital
    agc_target: float | None = None
    target_block: int = C.DEFAULT_BLOCK_SIZE
    resampler_semilength: int = C.RESAMP_SEMILENGTH
    fuse_filters: bool = True              # fold direct FIRs into resampler stages

    @property
    def resampling(self) -> bool:
        return (self.target_rate is not None
                and abs(self.target_rate - self.input_rate) > 1e-9)

    @property
    def output_rate(self) -> float:
        return self.target_rate if self.resampling else self.input_rate


@dataclasses.dataclass(frozen=True)
class Route:
    """The stages of a Chain's step, decided once from its configuration
    (``Chain.route``) and walked by ``Chain._step`` and by the
    time-sharded step (``parallel/sharded.py``) alike.

    ``out`` says what makes the output wire: "stage" (the last resampler
    stage packs it), "post_filter" (the filter's packed epilogue), "K4"
    (``kernels.post_apply``) or "plain" (tensor ops and the convert).
    ``rms_after_nco``: the plain post's RMS AGC reads the rotated planes
    (K4's gains and the digital profile's peak read them before the NCO)."""
    wire_stage0: bool      # resampler stage 0 decodes the packed wire: no pre-stage
    pre: str | None        # the pre-stage's kernel: "K3" (with the DC block), "K3pre", None
    pre_filter: bool
    stages: tuple[int, ...]  # the resampler stages run over planes, in order
    post_filter: bool
    out: str
    rms_after_nco: bool

    @property
    def packed(self) -> bool:
        """Whether a stage before the post-stage packs the wire."""
        return self.out in ("stage", "post_filter")


def _decide_filter_stage(cfg: ChainConfig) -> str:
    """Post-resample iff downsampling and the chain fits under the output
    Nyquist; error if it does not fit under the input Nyquist."""
    if not cfg.filters:
        return "none"
    if cfg.filter_stage in ("pre", "post"):
        return cfg.filter_stage
    if not cfg.resampling:
        return "pre"
    in_rate, out_rate = cfg.input_rate, cfg.target_rate
    mx = max_filter_freq_hz(list(cfg.filters))
    if mx > in_rate / 2.0:
        raise ValueError(
            f"filter chain extends to {mx:.0f} Hz, above the input Nyquist "
            f"{in_rate / 2:.0f} Hz")
    if out_rate < in_rate:
        if mx > out_rate / 2.0:
            raise ValueError(
                f"filter chain extends to {mx:.0f} Hz, but the output rate "
                f"{out_rate:.0f} Hz supports only {out_rate / 2:.0f} Hz")
        return "post"
    return "pre"


def resolve_device(device) -> torch.device:
    """The torch device for `device`, refusing CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                               "device (this package never falls back to the CPU)")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


class Chain:
    """Built chain for one configuration on one device."""

    def __init__(self, cfg: ChainConfig, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.fmt_in = get_format(cfg.input_format)
        self.fmt_out = get_format(cfg.output_format)

        stage = _decide_filter_stage(cfg)
        design_rate = cfg.output_rate if stage == "post" else cfg.input_rate
        designed = design_chain(list(cfg.filters), design_rate,
                                cfg.filter_attenuation_db, cfg.filter_taps,
                                cfg.filter_transition_hz) if cfg.filters else None
        self.filter_stage = stage
        self.designed_filter = designed
        filt = (StreamingFilter(designed.taps, cfg.filter_method, cfg.filter_fft_size)
                if designed is not None else None)
        self.pre_filter = filt if stage == "pre" else None
        self.post_filter = filt if stage == "post" else None

        # block geometry: the resampler's framing of the target block,
        # doubled until an FFT-method filter's block fits in it
        tb = cfg.target_block
        for _ in range(10):
            rs = (Resampler(cfg.target_rate / cfg.input_rate, tb,
                            cfg.filter_attenuation_db, cfg.resampler_semilength)
                  if cfg.resampling else None)
            n_in = rs.plan.n_in if rs else tb
            n_out = rs.plan.n_out if rs else tb
            if all(f is None or f.method != "fft" or n >= f.block
                   for f, n in ((self.pre_filter, n_in), (self.post_filter, n_out))):
                break
            tb *= 2
        else:
            raise ValueError("could not find a block size fitting the filter")
        self.resampler = rs
        self.n_in = n_in
        self.n_out = n_out

        # a direct FIR next to a banded resampler stage is LTI: it folds
        # into the stage's matrix (one fewer pass per step)
        for attr, idx in (("pre_filter", 0), ("post_filter", -1)):
            f = getattr(self, attr)
            if (cfg.fuse_filters and rs is not None and rs.stages and f is not None
                    and isinstance(rs.stages[idx], _MatmulStage)
                    and f.method == "fir" and f.num_taps <= C.FUSE_MAX_TAPS):
                taps = np.asarray(f.taps, np.complex128)
                if idx == 0:
                    rs.stages[0].compose_input_fir(taps)
                else:
                    rs.stages[-1].compose_output_fir(taps)
                setattr(self, attr, None)
        if rs is not None and rs.stages[0].hist > self.n_in:
            raise ValueError(f"block of {self.n_in} frames is shorter than the "
                             f"first stage's history {rs.stages[0].hist}")

        self.dc_alpha = dc_block.alpha_for_rate(cfg.input_rate)
        self.dtheta_pre = nco.freq_to_dtheta(cfg.freq_shift_pre_hz, cfg.input_rate)
        self.dtheta_post = nco.freq_to_dtheta(cfg.freq_shift_post_hz,
                                              cfg.output_rate)
        for shift, rate, name in ((cfg.freq_shift_pre_hz, cfg.input_rate, "pre"),
                                  (cfg.freq_shift_post_hz, cfg.output_rate, "post")):
            if abs(shift) > C.FREQ_SHIFT_SANITY_FACTOR * rate:
                raise ValueError(
                    f"{name} frequency shift {shift:.0f} Hz exceeds "
                    f"{C.FREQ_SHIFT_SANITY_FACTOR}x the rate")
        self.agc_cfg = (agc.AgcConfig.make(cfg.agc_profile, cfg.output_rate,
                                           cfg.agc_target)
                        if cfg.agc_profile else None)
        self.iq_interval = int(C.IQ_UPDATE_INTERVAL_SEC * cfg.input_rate)

        if rs is not None:
            rs.bind(self.device)
        self.pack_fmt = (self.fmt_out.name if kernels.packable_out(self.fmt_out.name)
                         else None)
        self._wire_kind = convert.wire_kind(self.fmt_in)
        self.route = self._decide_route()
        self.in_wire_len = self.n_in * self.fmt_in.items_per_frame
        self.out_wire_len = self.n_out * self.fmt_out.items_per_frame
        self.in_wire_dtype = convert.wire_dtype(self.fmt_in)
        self.out_wire_dtype = convert.wire_dtype(self.fmt_out)

    def _decide_route(self) -> Route:
        cfg, rs, post_f = self.cfg, self.resampler, self.post_filter
        convert_only = not self.dtheta_post and self.agc_cfg is None
        wire_stage0 = (rs is not None and isinstance(rs.stages[0], _MatmulStage)
                       and not cfg.iq_correction and convert_only
                       and self.pre_filter is None and post_f is None
                       and self._wire_kind is not None)
        if wire_stage0:
            pre = None
        elif cfg.dc_block:
            pre = "K3"
        elif self._wire_kind is not None or cfg.iq_correction or self.dtheta_pre:
            pre = "K3pre"
        else:
            pre = None                         # nothing to apply to the planes
        if self.pack_fmt and convert_only:
            out = ("stage" if post_f is None and rs is not None and rs.packs else
                   "post_filter" if post_f is not None and post_f.packs else "plain")
        else:
            out = "K4" if self.pack_fmt else "plain"
        n_stages = len(rs.stages) if rs is not None else 0
        return Route(wire_stage0=wire_stage0, pre=pre,
                     pre_filter=self.pre_filter is not None,
                     stages=tuple(range(int(wire_stage0), n_stages)),
                     post_filter=post_f is not None, out=out,
                     rms_after_nco=(out == "plain" and bool(self.dtheta_post)
                                    and self.agc_cfg is not None
                                    and self.agc_cfg.profile != "digital"))

    def band_geometries(self, rows: int = 1) -> dict:
        """{stage span: [geometry]} of each banded launch a step over
        ``rows`` row blocks makes, from the plan (``kernels.band_geometry``):
        stage 0 over the wire (K1 on the wgmma core with the DC block, else
        K2), each banded resampler stage and each filter that runs banded,
        on the core ``kernels.banded_core`` picks."""
        out: dict = {}
        r, rs = self.route, self.resampler
        if r.wire_stage0:
            st = rs.stages[0]
            core = kernels.banded_core(st.band, dc=self.cfg.dc_block)
            out["chain.resample.0"] = [kernels.band_geometry(st.band, st.stride, core)]
        for i in r.stages:
            st = rs.stages[i]
            if isinstance(st, _MatmulStage):
                out[f"chain.resample.{i}"] = [
                    kernels.band_geometry(st.band, st.stride, kernels.banded_core(st.band))]
        for name, f, n in (("chain.pre_filter", self.pre_filter, self.n_in),
                           ("chain.post_filter", self.post_filter, self.n_out)):
            geo = f.band_geometry(n * rows, self.device) if f is not None else None
            if geo is not None:
                out[name] = [geo]
        return out

    @property
    def _wire_resample(self) -> bool:
        """Whether stage 0 reads the wire (``route.wire_stage0``)."""
        return self.route.wire_stage0

    # ------------------------------ carry ------------------------------------

    def carry_to_numpy(self, carry: dict) -> dict:
        """This chain's carry in the reference's layout (numpy)."""
        return carry_to_numpy(carry)

    def carry_from_numpy(self, tree: dict) -> dict:
        """A carry in the reference's layout, on this chain's device."""
        return carry_from_numpy(tree, self.device)

    def init_carry(self, channels: int | None = None) -> dict:
        ch = channels or self.cfg.channels
        dev = self.device
        carry = {"nco_pre": nco.init(ch, dev), "nco_post": nco.init(ch, dev)}
        if self.cfg.dc_block:
            carry["dc"] = dc_block.init_planar(ch, dev)
        if self.cfg.iq_correction:
            carry["iq"] = iq_balance.init(ch, dev)
        if self.pre_filter is not None:
            carry["pre_f"] = self.pre_filter.init_planar(ch, dev)
        if self.resampler is not None:
            carry["rs"] = self.resampler.init_planar(ch, dev)
        if self.post_filter is not None:
            carry["post_f"] = self.post_filter.init_planar(ch, dev)
        if self.agc_cfg is not None:
            carry["agc"] = agc.init(ch, dev)
        return carry

    def _reset_carry(self, carry: dict) -> dict:
        """Discontinuity semantics: sample memory and NCO phases to zero,
        AGC to its initial state, learned I/Q factors kept."""
        out = dict(carry)
        out["nco_pre"] = nco.reset(carry["nco_pre"])
        out["nco_post"] = nco.reset(carry["nco_post"])
        if "dc" in carry:
            out["dc"] = torch.zeros_like(carry["dc"])
        for key in ("pre_f", "post_f"):
            if key in carry:
                out[key] = tuple(torch.zeros_like(t) for t in carry[key])
        if "rs" in carry:
            out["rs"] = tuple((torch.zeros_like(r), torch.zeros_like(i))
                              for r, i in carry["rs"])
        if "agc" in carry:
            out["agc"] = agc.reset(carry["agc"])
        return out

    # ------------------------------ step --------------------------------------

    def step(self, carry: dict, raw: torch.Tensor, reset: bool = False):
        """raw: (C, n_in * items) wire tensor on this chain's device ->
        (new carry, (C, n_out * items) wire tensor)."""
        return self._step(carry, raw, reset, 1)

    def _step(self, carry: dict, raw: torch.Tensor, reset: bool, rows: int):
        """One step over a block of any whole number of resampler blocks:
        the walk of ``route``, each stage's state from the carry.
        ``rows`` > 1 (``FoldedChain``): each channel's block is that many
        consecutive row blocks, and the RMS AGC lays its segments per row
        (agc.rms_gains); every other stage is the same over the whole
        block as over its rows in turn."""
        if raw.device.type != self.device.type:
            raise ValueError(f"input on {raw.device}, chain on {self.device}")
        if reset:
            carry = self._reset_carry(carry)
        new = dict(carry)
        r = self.route
        rs = list(carry.get("rs", ()))
        if r.wire_stage0:
            dth = self.dtheta_pre
            with stage_span("chain.resample.0"):
                phase = carry["nco_pre"] if dth else None
                x, tail, dc = self.wire_stage0(raw, rs[0], phase, carry.get("dc"))
                rs[0] = tail or self.wire_tail(raw, phase)
                if dc is not None:
                    new["dc"] = dc
                if dth:
                    new["nco_pre"] = nco.advance(carry["nco_pre"], self._frames(raw), dth)
        else:
            x = self._pre(raw, carry, new)
        if r.pre_filter:
            with stage_span("chain.pre_filter"):
                x, new["pre_f"] = self.apply_filter("pre", x, carry["pre_f"])
        for i in r.stages:
            with stage_span(f"chain.resample.{i}"):
                x, rs[i] = self.resample_stage(i, x, rs[i])
        if rs:
            new["rs"] = tuple(rs)
        if r.post_filter:
            with stage_span("chain.post_filter"):
                x, new["post_f"] = self.apply_filter("post", x, carry["post_f"])
        if r.packed:
            return new, convert.packed_to_wire(x, self.fmt_out)
        with stage_span("chain.post"):
            return new, self._post(*x, carry, new, rows)

    def _frames(self, raw) -> int:
        return raw.shape[-1] // self.fmt_in.items_per_frame

    def _pre(self, raw, carry: dict, new: dict):
        """The pre-stage from the carry: decode, [the I/Q estimator], then
        ``pre_stage`` from the carried DC state and NCO phase."""
        with stage_span("chain.pre"):
            xr, xi, src = self.decode(raw)
        state = carry.get("dc")
        factors = None
        if self.cfg.iq_correction:
            with stage_span("chain.iq_estimate"):
                new["iq"] = self.estimate(self.iq_input(xr, xi, src), carry["iq"], state)
            factors = new["iq"].factors
        dth = self.dtheta_pre
        with stage_span("chain.pre"):
            yr, yi, dc = self.pre_stage(xr, xi, src, state, factors,
                                        carry["nco_pre"] if dth else None)
            if dc is not None:
                new["dc"] = dc
            if dth:
                new["nco_pre"] = nco.advance(carry["nco_pre"], self._frames(raw), dth)
        return yr, yi

    def _post(self, xr, xi, carry: dict, new: dict, rows: int):
        """The post-stage from the carry: the AGC's gains (its state
        stepped; the stage ``chain.agc`` inside ``chain.post``) and the
        carried post-NCO phase."""
        n = xr.shape[-1]
        dth, cfg_agc = self.dtheta_post, self.agc_cfg
        phase = carry["nco_post"] if dth else None
        if self.route.rms_after_nco:
            xr, xi = nco.mix(xr, xi, phase, dth)
            phase = None
        gains, seg, digital = None, 0, None
        if cfg_agc is not None:
            with stage_span("chain.agc"):
                if cfg_agc.profile == "digital":
                    digital, new["agc"] = agc.digital_update(
                        carry["agc"], agc.block_peak(xr, xi), n, cfg_agc)
                else:
                    gains, seg, new["agc"] = agc.rms_gains(xr, xi, carry["agc"], cfg_agc, rows)
        out = self.post(xr, xi, phase, gains, seg, digital, rows)
        if dth:
            new["nco_post"] = nco.advance(carry["nco_post"], n, dth)
        return out

    # ------------------------------ stages ------------------------------------
    # Each takes the state it needs from the last block as arguments and
    # returns its new state: ``_step`` passes the carry's, the time-sharded
    # step what its collectives composed.

    def _src(self, wire) -> dict:
        """The kernels' arguments for the packed wire ``wire``."""
        return dict(wire_i32=wire, wire_norm=self.fmt_in.normalizer,
                    wire_gain=self.cfg.gain, wire_kind=self._wire_kind[1])

    def decode(self, raw):
        """(xr, xi, src): the block as the pre-stage reads it, the packed
        wire's kernel arguments ``src`` (planes None) for a format with
        one, else the converted planes (``src`` empty)."""
        if self._wire_kind is not None:
            return None, None, self._src(convert.wire_pack(raw, self.fmt_in)[0])
        xr, xi = convert.to_planar(raw, self.fmt_in, self.cfg.gain)
        return xr.contiguous(), xi.contiguous(), {}

    def iq_input(self, xr, xi, src) -> tuple:
        """The I/Q estimator's input of a decoded block: (wire,) where the
        format packs, else (xr, xi)."""
        return (src["wire_i32"],) if src else (xr, xi)

    def estimate(self, x: tuple, state, dc_state=None, advance: int | None = None):
        """The I/Q estimator (``kernels.iq_estimate``) over ``x``
        (``iq_input``'s, or its first IQ_FFT_SIZE frames), DC-blocking
        what it reads from ``dc_state`` when given: the new IqState.  The
        counter advances by ``advance`` (default the frames of ``x``)."""
        planes, src = ((None, None), self._src(x[0])) if len(x) == 1 else (x, {})
        return iq_balance.maybe_update_planar(
            *planes, state, self.iq_interval, advance_samples=advance,
            dc_state=dc_state, dc_alpha=self.dc_alpha, **src)

    def pre_stage(self, xr, xi, src, dc_state, factors, phase):
        """DC block + I/Q apply + pre-NCO over a decoded block in one
        launch from the DC state ``dc_state``, the I/Q ``factors`` and the
        first NCO ``phase`` (None where they do not apply): K3
        (``kernels.dc_block_apply``) with the DC block, else K3pre
        (``kernels.pre_apply``), else nothing.  (yr, yi, new DC state or
        None)."""
        if self.route.pre == "K3":
            return kernels.dc_block_apply(xr, xi, dc_state, self.dc_alpha, factors, phase,
                                          self.dtheta_pre, **src)
        if self.route.pre == "K3pre":
            return (*kernels.pre_apply(xr, xi, factors, phase, self.dtheta_pre, **src), None)
        return xr, xi, None

    def wire_stage0(self, raw, hist: tuple, phase, dc_state=None):
        """The resampler's stage 0 over the packed wire from its history's
        planes ``hist`` and the first pre-NCO ``phase``: K1
        (``kernels.banded_apply_dc``) with the DC block from ``dc_state``,
        else K2 decoding the wire in its prologue.  (output, K1's new
        history or None, K1's new DC state or None): K2's new history is
        ``wire_tail``'s."""
        st0 = self.resampler.stages[0]
        kw = dict(nco_dtheta=self.dtheta_pre, nco_phase=phase, pack_fmt=self.stage_pack(0),
                  **self.decode(raw)[2])
        if self.cfg.dc_block:
            y, tr, ti, dc = kernels.banded_apply_dc(*hist, dc_state, self.dc_alpha, st0.band,
                                                    None, st0.stride, st0.hist, **kw)
            return y, (tr, ti), dc
        y = kernels.banded_apply(*hist, None, None, st0.band, None, st0.stride, st0.hist,
                                 **kw)
        return y, None, None

    def wire_tail(self, raw, phase) -> tuple:
        """The history stage 0 leaves without the DC block: the block's
        last frames decoded and, with a pre-NCO, rotated at their indices
        from the first ``phase`` (the history is the post-shift signal)."""
        hist = self.resampler.stages[0].hist
        items = self.fmt_in.items_per_frame
        tr, ti = convert.to_planar(raw[:, -hist * items:], self.fmt_in, self.cfg.gain)
        if self.dtheta_pre:
            tr, ti = nco.mix(tr, ti, phase, self.dtheta_pre,
                             start=self._frames(raw) - hist)
        return tr.contiguous(), ti.contiguous()

    def stage_pack(self, i: int):
        """The packed format resampler stage ``i`` quantizes to, or None."""
        last = i == len(self.resampler.stages) - 1
        return self.pack_fmt if self.route.out == "stage" and last else None

    def resample_stage(self, i: int, x: tuple, hist: tuple):
        """Resampler stage ``i`` over the planes ``x`` from its history:
        (planes or, where it packs, the wire; the new history)."""
        y, nr, ni = self.resampler.stages[i].apply_planar(*x, *hist,
                                                          pack_fmt=self.stage_pack(i))
        return y, (nr, ni)

    def apply_filter(self, which: str, x: tuple, hist: tuple):
        """The "pre" or "post" filter over the planes ``x`` from its tail:
        (planes or, where the route packs there, the wire; the new tail)."""
        if which == "post" and self.route.out == "post_filter":
            y, nr, ni = self.post_filter.apply_planar_packed(*x, *hist, out_fmt=self.pack_fmt)
            return y, (nr, ni)
        f = self.pre_filter if which == "pre" else self.post_filter
        yr, yi, nr, ni = f.apply_planar(*x, *hist)
        return (yr, yi), (nr, ni)

    def post(self, xr, xi, phase=None, gains=None, seg: int = 0, digital=None,
             rows: int = 1):
        """Post-NCO + AGC + convert: K4 (``kernels.post_apply``, the NCO,
        the gains and the pack in one pass, over the block's ``rows`` rows,
        each with its own gains and first NCO phase) or, as the route says,
        tensor ops and the plain convert.  ``phase``: the first post-NCO
        phase (None: no NCO left to apply); ``gains``/``seg``: the RMS
        AGC's segment gains (C * rows, n_seg) or ``digital`` the digital
        profile's (C,) gain.  Block energies and peaks are
        rotation-invariant, so K4's gains read the planes before the NCO
        (the digital profile's hard thresholds then see the same peak on
        every path)."""
        dth = self.dtheta_post
        if self.route.out == "K4":
            c, n = xr.shape
            xr, xi = xr.contiguous(), xi.contiguous()
            if digital is not None:
                gains = digital[:, None].repeat_interleave(rows, 0).contiguous()
            elif gains is None:
                gains = torch.ones((c * rows, 1), dtype=torch.float32, device=xr.device)
            phases = nco.row_phases(phase, rows, n // rows, dth) if phase is not None else None
            out = kernels.post_apply(xr.view(c * rows, -1), xi.view(c * rows, -1), gains,
                                     seg, phases, dth, out_fmt=self.pack_fmt)
            return convert.packed_to_wire(out.view(c, n), self.fmt_out)
        if phase is not None:
            xr, xi = nco.mix(xr, xi, phase, dth)
        if digital is not None:
            xr, xi = xr * digital[:, None], xi * digital[:, None]
        elif gains is not None:
            xr, xi = agc.apply_gains(xr, xi, gains, seg, rows)
        return convert.from_planar(xr, xi, self.fmt_out)

    # --------------------------- accounting -----------------------------------

    def expected_out_frames(self, in_frames: int) -> int:
        """Output frames the stream should yield for in_frames inputs
        (the host trims the padded final block with it)."""
        if self.resampler is None:
            return in_frames
        return in_frames * self.resampler.plan.p // self.resampler.plan.q


# ----------------------------- carry exchange ---------------------------------

_CARRY_KEYS = {"nco_pre", "nco_post", "dc", "iq", "pre_f", "rs", "post_f", "agc"}


def carry_from_numpy(tree: dict, device="cpu") -> dict:
    """The inverse of ``carry_to_numpy``: a carry in the reference's
    layout (a checkpoint's, or the reference chain's fetched with
    ``jax.device_get``) as this package's carry on `device`."""
    extra = set(tree) - _CARRY_KEYS
    if extra:
        raise ValueError(f"carry keys the port does not know: {sorted(extra)}")
    dev = resolve_device(device)
    t = lambda a, dt: torch.from_numpy(np.array(a, dtype=dt, order="C")).to(dev)
    f32 = lambda a: t(a, np.float32)
    out = {k: t(tree[k], np.int64) for k in ("nco_pre", "nco_post")}
    if "dc" in tree:
        out["dc"] = f32(np.stack([np.asarray(v, np.float32) for v in tree["dc"]],
                                 axis=-1))
    if "iq" in tree:
        factors, counter = tree["iq"]
        out["iq"] = iq_balance.IqState(f32(factors), t(counter, np.int64))
    for key in ("pre_f", "post_f"):
        if key in tree:
            out[key] = tuple(f32(v) for v in tree[key])
    if "rs" in tree:
        out["rs"] = tuple((f32(r), f32(i)) for r, i in tree["rs"])
    if "agc" in tree:
        gain, e2, peak_mem, locked, seen, weak = tree["agc"]
        out["agc"] = agc.AgcState(f32(gain), f32(e2), f32(peak_mem),
                                  t(locked, np.bool_), t(seen, np.int64),
                                  t(weak, np.int64))
    return out


def carry_to_numpy(carry: dict) -> dict:
    """This package's carry as numpy in the reference's layout: uint32
    NCO phases and counters, dc as the 4-tuple (xr, xi, yr, yi) of (C,)
    planes, iq as (factors, samples_since_opt), agc as the reference's
    six fields in order, filter tails and rs as (state_r, state_i)."""
    n = lambda x: x.detach().to("cpu", copy=True).numpy()
    out = {k: n(carry[k]).astype(np.uint32) for k in ("nco_pre", "nco_post")}
    if "dc" in carry:
        d = n(carry["dc"])
        out["dc"] = tuple(np.ascontiguousarray(d[:, j]) for j in range(4))
    if "iq" in carry:
        out["iq"] = (n(carry["iq"].factors),
                     n(carry["iq"].samples_since_opt).astype(np.uint32))
    for key in ("pre_f", "post_f"):
        if key in carry:
            out[key] = tuple(n(v) for v in carry[key])
    if "rs" in carry:
        out["rs"] = tuple((n(r), n(i)) for r, i in carry["rs"])
    if "agc" in carry:
        s = carry["agc"]
        out["agc"] = (n(s.gain), n(s.e2), n(s.peak_mem), n(s.locked),
                      n(s.samples_seen).astype(np.uint32),
                      n(s.weak_run).astype(np.uint32))
    return out
