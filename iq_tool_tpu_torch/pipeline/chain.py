"""The DSP chain on torch: one step per block of the whole signal path
(the port of ``iq_tool_tpu.pipeline.chain``).

This package runs the reference's wire-to-wire resample path
(``Chain._fused_wire_resample``):

    cs16/cu16/cu8/cs8 wire -> [DC block] -> [pre-NCO] -> resampler stages
    (a direct FIR composed into the first or last stage) -> wire

Stage 0 is K1 (``kernels.banded_apply_dc``) when the DC block is on and
K2 (``kernels.banded_apply``) with the wire + NCO prologue otherwise;
later stages are K2, the last one quantizing straight to the packed
wire.  On a CUDA device every stage launches a kernel; on the CPU the
same calls run the kernels' plain twins.

The device is an explicit argument.  Asking for CUDA without a card
raises; nothing falls back to the CPU.  All stream state lives in the
carry, a dict of tensors:

    nco_pre, nco_post: (C,) int64 holding uint32 NCO phases
    dc:                (C, 4) float32 [xr_prev, xi_prev, yr_prev, yi_prev]
    rs:                per stage (state_r, state_i), (C, hist) float32,
                       the PROCESSED (post-DC, post-NCO) input history
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from iq_tool_tpu import constants as C
from iq_tool_tpu.formats import get_format
from iq_tool_tpu_torch.ops import convert, dc_block, kernels, nco
from iq_tool_tpu_torch.ops.fir_design import (FilterRequest, design_chain,
                                              max_filter_freq_hz)
from iq_tool_tpu_torch.ops.resample import Resampler

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


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to iq_tool_tpu_torch yet (ROADMAP {item})")


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
        if cfg.iq_correction:
            raise _not_ported("I/Q correction", "Queue 1 item 8")
        if cfg.agc_profile:
            raise _not_ported("AGC", "Queue 1 item 8")
        if not cfg.resampling:
            raise _not_ported("a chain without a resampler", "Queue 1 item 8")
        if self.fmt_in.name not in _PACKED_INPUTS:
            raise _not_ported(f"input format {self.fmt_in.name}",
                              "Queue 1 item 8 (K3 pre-stage)")

        stage = _decide_filter_stage(cfg)
        design_rate = cfg.output_rate if stage == "post" else cfg.input_rate
        designed = design_chain(list(cfg.filters), design_rate,
                                cfg.filter_attenuation_db, cfg.filter_taps,
                                cfg.filter_transition_hz) if cfg.filters else None

        # block geometry: with no FFT-method filter there is no block
        # constraint, so the resampler's framing of target_block decides
        rs = Resampler(cfg.target_rate / cfg.input_rate, cfg.target_block,
                       cfg.filter_attenuation_db, cfg.resampler_semilength)
        self.resampler = rs
        self.n_in = rs.plan.n_in
        self.n_out = rs.plan.n_out

        if designed is not None:
            taps = designed.taps
            method = cfg.filter_method
            if method == "auto":
                method = "fir" if len(taps) <= 1024 else "fft"
            if method == "fft":
                raise _not_ported("an FFT-method filter", "Queue 1 item 7, K5")
            if not cfg.fuse_filters or len(taps) > C.FUSE_MAX_TAPS:
                raise _not_ported("a filter that does not compose into a "
                                  "resampler stage", "Queue 1 item 7")
            taps = np.asarray(taps, np.complex128)
            if stage == "pre":
                rs.stages[0].compose_input_fir(taps)
            else:
                rs.stages[-1].compose_output_fir(taps)
        if rs.stages[0].hist > self.n_in:
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
        if self.dtheta_post:
            raise _not_ported("a shift after the resampler", "Queue 1 item 8, K4")

        rs.bind(self.device)
        self.pack_fmt = (self.fmt_out.name if kernels.packable_out(self.fmt_out.name)
                         else None)
        self.in_wire_len = self.n_in * self.fmt_in.items_per_frame
        self.out_wire_len = self.n_out * self.fmt_out.items_per_frame
        self.in_wire_dtype = convert.wire_dtype(self.fmt_in)

    # ------------------------------ carry ------------------------------------

    def init_carry(self, channels: int | None = None) -> dict:
        ch = channels or self.cfg.channels
        carry = {"nco_pre": nco.init(ch, self.device),
                 "nco_post": nco.init(ch, self.device),
                 "rs": self.resampler.init_planar(ch, self.device)}
        if self.cfg.dc_block:
            carry["dc"] = dc_block.init_planar(ch, self.device)
        return carry

    def _reset_carry(self, carry: dict) -> dict:
        """Discontinuity semantics: sample memory and NCO phases to zero."""
        out = dict(carry)
        out["nco_pre"] = nco.reset(carry["nco_pre"])
        out["nco_post"] = nco.reset(carry["nco_post"])
        if "dc" in carry:
            out["dc"] = torch.zeros_like(carry["dc"])
        out["rs"] = tuple((torch.zeros_like(r), torch.zeros_like(i))
                          for r, i in carry["rs"])
        return out

    # ------------------------------ step --------------------------------------

    def step(self, carry: dict, raw: torch.Tensor, reset: bool = False):
        """raw: (C, n_in * items) wire tensor on this chain's device ->
        (new carry, (C, n_out * items) wire tensor)."""
        cfg = self.cfg
        if raw.device.type != self.device.type:
            raise ValueError(f"input on {raw.device}, chain on {self.device}")
        if reset:
            carry = self._reset_carry(carry)
        new = dict(carry)
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
        new_rs = [(tr, ti)]
        last = len(stages) - 1
        for i, stage in enumerate(stages[1:], start=1):
            s_r, s_i = carry["rs"][i]
            y, nr, ni = stage.apply_planar(
                *y, s_r, s_i, pack_fmt=self.pack_fmt if i == last else None)
            new_rs.append((nr, ni))
        new["rs"] = tuple(new_rs)
        if self.pack_fmt:
            return new, convert.packed_to_wire(y, self.fmt_out)
        return new, convert.from_planar(*y, self.fmt_out)

    # --------------------------- accounting -----------------------------------

    def expected_out_frames(self, in_frames: int) -> int:
        """Output frames the stream should yield for in_frames inputs
        (the host trims the padded final block with it)."""
        return in_frames * self.resampler.plan.p // self.resampler.plan.q


# ----------------------------- carry exchange ---------------------------------

def carry_from_jax(tree: dict, device="cpu") -> dict:
    """The reference chain's carry, fetched to numpy (``jax.device_get``),
    as this package's carry on `device`.  Covers the keys of the slice:
    nco_pre, nco_post, dc and rs."""
    extra = set(tree) - {"nco_pre", "nco_post", "dc", "rs"}
    if extra:
        raise ValueError(f"carry keys outside the ported slice: {sorted(extra)}")
    dev = resolve_device(device)
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(dt))).to(dev)
    out = {k: t(tree[k], np.int64) for k in ("nco_pre", "nco_post")}
    if "dc" in tree:
        out["dc"] = t(np.stack([np.asarray(v, np.float32) for v in tree["dc"]],
                               axis=-1), np.float32)
    out["rs"] = tuple((t(r, np.float32), t(i, np.float32)) for r, i in tree["rs"])
    return out


def carry_to_numpy(carry: dict) -> dict:
    """This package's carry as numpy in the reference's layout: uint32
    NCO phases, dc as the 4-tuple (xr, xi, yr, yi) of (C,) planes, rs as
    per-stage (state_r, state_i)."""
    n = lambda x: x.detach().cpu().numpy()
    out = {k: n(carry[k]).astype(np.uint32) for k in ("nco_pre", "nco_post")}
    if "dc" in carry:
        d = n(carry["dc"])
        out["dc"] = tuple(np.ascontiguousarray(d[:, j]) for j in range(4))
    out["rs"] = tuple((n(r), n(i)) for r, i in carry["rs"])
    return out
