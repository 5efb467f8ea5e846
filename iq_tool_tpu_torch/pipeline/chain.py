"""The DSP chain on torch: one step per block of the whole signal path
(the port of ``iq_tool_tpu.pipeline.chain``).

    convert -> dc_block -> iq_correct -> pre-NCO -> pre-filter
            -> resample -> post-filter -> post-NCO -> AGC -> convert

Two paths, as in the reference:

* the wire-to-wire resample path (``_wire_resample``) when nothing but
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
from iq_tool_tpu_torch.pipeline.trace import span

_PACKED_INPUTS = ("cs16", "sc16q11", "cu16", "cu8", "cs8")


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
        self._wire_resample = (rs is not None and isinstance(rs.stages[0], _MatmulStage)
                               and not cfg.iq_correction
                               and self.pre_filter is None and self.post_filter is None
                               and not self.dtheta_post and self.agc_cfg is None
                               and self.fmt_in.name in _PACKED_INPUTS)
        self.in_wire_len = self.n_in * self.fmt_in.items_per_frame
        self.out_wire_len = self.n_out * self.fmt_out.items_per_frame
        self.in_wire_dtype = convert.wire_dtype(self.fmt_in)
        self.out_wire_dtype = convert.wire_dtype(self.fmt_out)

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
        """One step over a block of any whole number of resampler blocks.
        ``rows`` > 1 (``FoldedChain``): each channel's block is that many
        consecutive row blocks, and the RMS AGC lays its segments per row
        (agc.rms_gains); every other stage is the same over the whole
        block as over its rows in turn."""
        if raw.device.type != self.device.type:
            raise ValueError(f"input on {raw.device}, chain on {self.device}")
        if reset:
            carry = self._reset_carry(carry)
        new = dict(carry)
        if self._wire_resample:
            return new, self._wire_resample_step(raw, carry, new)
        xr, xi = self._pre(raw, carry, new)
        if self.pre_filter is not None:
            with span("chain.pre_filter"):
                xr, xi, nr, ni = self.pre_filter.apply_planar(xr, xi, *carry["pre_f"])
            new["pre_f"] = (nr, ni)
        convert_only = not self.dtheta_post and self.agc_cfg is None
        if self.resampler is not None:
            if (self.post_filter is None and convert_only and self.pack_fmt
                    and self.resampler.packs):
                y, new["rs"] = self.resampler.apply_planar(xr, xi, carry["rs"],
                                                           pack_fmt=self.pack_fmt)
                return new, convert.packed_to_wire(y, self.fmt_out)
            (xr, xi), new["rs"] = self.resampler.apply_planar(xr, xi, carry["rs"])
        if self.post_filter is not None:
            with span("chain.post_filter"):
                res = None
                if convert_only and self.pack_fmt:
                    res = self.post_filter.apply_planar_packed(
                        xr, xi, *carry["post_f"], out_fmt=self.pack_fmt)
                if res is None:
                    xr, xi, nr, ni = self.post_filter.apply_planar(xr, xi, *carry["post_f"])
                else:
                    y, nr, ni = res
            new["post_f"] = (nr, ni)
            if res is not None:
                return new, convert.packed_to_wire(y, self.fmt_out)
        with span("chain.post"):
            if self.pack_fmt and not convert_only:
                return new, self._fused_post(xr, xi, carry, new, rows)
            return new, self._plain_post(xr, xi, carry, new, rows)

    def _pre(self, raw, carry: dict, new: dict):
        """Convert + [DC block] + [I/Q] + [pre-NCO] in one launch over the
        packed wire (decoded in the kernel) or, for formats without one,
        the converted planes: K3 (``kernels.dc_block_apply``) with the DC
        block, else K3pre (``kernels.pre_apply``).  The I/Q estimator taps
        the (DC-blocked) signal before the correction: its kernel decodes
        (and DC-blocks, from the carried DC state) the block's
        IQ_FFT_SIZE-frame prefix itself, ahead of the pre-stage."""
        cfg = self.cfg
        with span("chain.pre"):
            packed = convert.wire_pack(raw, self.fmt_in)
            if packed is None:
                xr, xi = (p.contiguous() for p in convert.to_planar(raw, self.fmt_in,
                                                                     cfg.gain))
                wire, kind, norm = None, "cs16", 0.0
            else:
                (wire, kind), xr, xi = packed, None, None
                norm = self.fmt_in.normalizer
        n = (wire if wire is not None else xr).shape[-1]
        state = carry.get("dc")
        src = dict(wire_i32=wire, wire_norm=norm, wire_gain=cfg.gain, wire_kind=kind)
        factors = None
        if cfg.iq_correction:
            with span("chain.iq_estimate"):
                new["iq"] = iq_balance.maybe_update_planar(
                    xr, xi, carry["iq"], self.iq_interval, dc_state=state,
                    dc_alpha=self.dc_alpha, **src)
            factors = new["iq"].factors
        dth = self.dtheta_pre
        phase = carry["nco_pre"] if dth else None
        with span("chain.pre"):
            if cfg.dc_block:
                yr, yi, new["dc"] = kernels.dc_block_apply(
                    xr, xi, state, self.dc_alpha, factors, phase, dth, **src)
            elif wire is None and factors is None and not dth:
                yr, yi = xr, xi                    # nothing to apply to the planes
            else:
                yr, yi = kernels.pre_apply(xr, xi, factors, phase, dth, **src)
            if dth:
                new["nco_pre"] = nco.advance(carry["nco_pre"], n, dth)
        return yr, yi

    def _fused_post(self, xr, xi, carry: dict, new: dict, rows: int = 1):
        """K4: post-NCO + AGC gains + quantize/interleave in one pass,
        over the block's ``rows`` rows (each row with its own gains and
        first NCO phase).  Block energies and peaks are rotation-invariant,
        so the AGC reads the planes before the NCO (the digital profile's
        hard thresholds then see the same peak on every path)."""
        c, n = xr.shape
        xr, xi = xr.contiguous(), xi.contiguous()
        dth = self.dtheta_post
        cfg_agc = self.agc_cfg
        seg = 0
        if cfg_agc is not None and cfg_agc.profile != "digital":
            gains, seg, new["agc"] = agc.rms_gains(xr, xi, carry["agc"], cfg_agc, rows)
        elif cfg_agc is not None:
            g, new["agc"] = agc.digital_update(carry["agc"], agc.block_peak(xr, xi),
                                               n, cfg_agc)
            gains = g[:, None].repeat_interleave(rows, 0).contiguous()
        else:
            gains = torch.ones((c * rows, 1), dtype=torch.float32, device=xr.device)
        phases = nco.row_phases(carry["nco_post"], rows, n // rows, dth) if dth else None
        out = kernels.post_apply(xr.view(c * rows, -1), xi.view(c * rows, -1), gains,
                                 seg, phases, dth, out_fmt=self.pack_fmt)
        if dth:
            new["nco_post"] = nco.advance(carry["nco_post"], n, dth)
        return convert.packed_to_wire(out.view(c, n), self.fmt_out)

    def _plain_post(self, xr, xi, carry: dict, new: dict, rows: int = 1):
        """Post-NCO, AGC and convert as tensor ops: formats without a
        packed epilogue, or nothing but the convert left.  The digital
        AGC measures its block peak before the NCO, as K4's path does."""
        cfg_agc = self.agc_cfg
        dig_gain = None
        if cfg_agc is not None and cfg_agc.profile == "digital":
            dig_gain, new["agc"] = agc.digital_update(
                carry["agc"], agc.block_peak(xr, xi), xr.shape[-1], cfg_agc)
        if self.dtheta_post:
            xr, xi, new["nco_post"] = nco.apply_planar(xr, xi, carry["nco_post"],
                                                       self.dtheta_post)
        if dig_gain is not None:
            xr, xi = xr * dig_gain[:, None], xi * dig_gain[:, None]
        elif cfg_agc is not None:
            xr, xi, new["agc"] = agc.apply_planar(xr, xi, carry["agc"], cfg_agc, rows)
        return convert.from_planar(xr, xi, self.fmt_out)

    def _wire_resample_step(self, raw, carry: dict, new: dict):
        """Packed wire -> [DC] -> [NCO] -> resampler -> wire: stage 0
        decodes the wire in its prologue (K1 with the DC block, else K2),
        the last stage packs the output."""
        stages = self.resampler.stages
        with span("chain.resample.0"):
            y, tr, ti = self._wire_stage0(raw, carry, new)
        new_rs = [(tr, ti)]
        last = len(stages) - 1
        for i, stage in enumerate(stages[1:], start=1):
            s_r, s_i = carry["rs"][i]
            with span(f"chain.resample.{i}"):
                y, nr, ni = stage.apply_planar(
                    *y, s_r, s_i, pack_fmt=self.pack_fmt if i == last else None)
            new_rs.append((nr, ni))
        new["rs"] = tuple(new_rs)
        if self.pack_fmt:
            return convert.packed_to_wire(y, self.fmt_out)
        with span("chain.post"):
            return convert.from_planar(*y, self.fmt_out)

    def _wire_stage0(self, raw, carry: dict, new: dict):
        """The resampler's stage 0 over the packed wire (K1 with the DC
        block, else K2 and the carried history's planes): (its output,
        the new history's planes)."""
        cfg = self.cfg
        wire, kind = convert.wire_pack(raw, self.fmt_in)
        stages = self.resampler.stages
        st0 = stages[0]
        sr, si = carry["rs"][0]
        pack0 = self.pack_fmt if len(stages) == 1 else None
        dth = self.dtheta_pre
        pacc = carry["nco_pre"] if dth else None
        n_frames = wire.shape[-1]
        norm = self.fmt_in.normalizer
        if cfg.dc_block:
            y, tr, ti, new["dc"] = kernels.banded_apply_dc(
                sr, si, carry["dc"], self.dc_alpha, st0.band, None,
                st0.stride, st0.hist, wire_i32=wire, wire_norm=norm,
                wire_gain=cfg.gain, nco_dtheta=dth, nco_phase=pacc,
                pack_fmt=pack0, wire_kind=kind)
        else:
            y = kernels.banded_apply(
                sr, si, None, None, st0.band, None, st0.stride, st0.hist,
                pack_fmt=pack0, wire_i32=wire, wire_norm=norm,
                wire_gain=cfg.gain, nco_dtheta=dth, nco_phase=pacc,
                wire_kind=kind)
            items = self.fmt_in.items_per_frame
            tr, ti = convert.to_planar(raw[:, -st0.hist * items:], self.fmt_in,
                                       cfg.gain)
            if dth:
                # the carried history is the post-shift signal: rotate the
                # stored tail at its indices in this block
                tr, ti = nco.mix(tr, ti, carry["nco_pre"], dth,
                                 start=n_frames - st0.hist)
            tr, ti = tr.contiguous(), ti.contiguous()
        if dth:
            new["nco_pre"] = nco.advance(carry["nco_pre"], n_frames, dth)
        return y, tr, ti

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
