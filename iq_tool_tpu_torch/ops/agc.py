"""Output AGC, the port of ``iq_tool_tpu.ops.agc``: dx / local (RMS
tracking) and digital (peak-lock) profiles.

* dx/local: per AGC_SEGMENT (128) samples, g *= (target^2 / e2)^(beta/2)
  with e2 the smoothed output energy and beta = 1 - (1-bw)^L; the gain
  is clamped to [1e-6, 1e6].  The per-segment loop is sequential
  (~1500 segments per full block): on a CUDA tensor the segment energies
  and the loop are one kernel (``kernels.rms_gains``), on the CPU a mean
  and the plain loop.
* digital: a block-granular state machine (scan for 2 s, then lock;
  ratchet on clip, creep after 4 s of weak peaks) in tensor ops.

Time windows count samples at the output rate.  uint32 fields are int64
tensors holding uint32 values, wrapped as the reference wraps them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from iq_tool_tpu_torch import constants as C
from iq_tool_tpu_torch.ops import kernels

PROFILES = ("dx", "local", "digital")
_MASK = 0xFFFFFFFF


def _f32(v: float) -> float:
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class AgcConfig:
    profile: str
    target: float
    sample_rate: float      # output rate, for the lock/hang sample windows

    @classmethod
    def make(cls, profile: str, sample_rate: float, target: float | None = None):
        if profile not in PROFILES:
            raise ValueError(f"unknown AGC profile '{profile}'; valid: {PROFILES}")
        if target is None or target <= 0:
            target = (C.AGC_DIGITAL_TARGET if profile == "digital"
                      else C.AGC_TARGET)
        return cls(profile, float(target), float(sample_rate))


@dataclasses.dataclass(frozen=True)
class AgcState:
    gain: torch.Tensor          # (C,) float32 current gain
    e2: torch.Tensor            # (C,) float32 smoothed output energy (dx/local)
    peak_mem: torch.Tensor      # (C,) float32 scan-phase peak memory (digital)
    locked: torch.Tensor        # (C,) bool
    samples_seen: torch.Tensor  # (C,) int64 holding a uint32
    weak_run: torch.Tensor      # (C,) int64 holding a uint32


def init(channels: int, device=None) -> AgcState:
    f = lambda v: torch.full((channels,), v, dtype=torch.float32, device=device)
    z = lambda dt: torch.zeros((channels,), dtype=dt, device=device)
    return AgcState(gain=f(1.0), e2=f(0.0), peak_mem=f(0.05),
                    locked=z(torch.bool), samples_seen=z(torch.int64),
                    weak_run=z(torch.int64))


def reset(state: AgcState) -> AgcState:
    """Gain 1, unlocked, peak memory 0.05, counters 0."""
    return init(state.gain.shape[0], state.gain.device)


def rms_params(cfg: AgcConfig, n: int) -> tuple[int, int, float]:
    """(n_seg, seg_len, beta) for a block of n samples."""
    bw = C.AGC_BW_DX if cfg.profile == "dx" else C.AGC_BW_LOCAL
    n_seg, seg = kernels.agc_segments(n)
    beta = float(1.0 - (1.0 - bw) ** seg)
    return n_seg, seg, beta


def rms_gains(xr: torch.Tensor, xi: torch.Tensor, state: AgcState,
              cfg: AgcConfig, rows: int = 1):
    """(gains (C * rows, n_seg), seg, new_state): the per-segment gain
    schedule of a block, shared by the plain apply below and the post
    kernel.  With ``rows`` > 1 each channel's block is that many
    consecutive rows (a time fold): the segments are laid per row and the
    gain scan runs once over all rows' segments in time order."""
    c, n = xr.shape
    n_seg, seg, beta = rms_params(cfg, n // rows)
    gains, g_fin, e2_fin = kernels.rms_gains(xr.contiguous(), xi.contiguous(),
                                             state.gain, state.e2, beta, cfg.target,
                                             rows)
    new_state = dataclasses.replace(
        state, gain=g_fin, e2=e2_fin,
        samples_seen=(state.samples_seen + n) & _MASK)
    return gains.reshape(c * rows, n_seg), seg, new_state


def _apply_rms_planar(xr, xi, state: AgcState, cfg: AgcConfig, rows: int = 1):
    gains, seg, new_state = rms_gains(xr, xi, state, cfg, rows)
    return (*apply_gains(xr, xi, gains, seg, rows), new_state)


def apply_gains(xr, xi, gains: torch.Tensor, seg: int, rows: int = 1):
    """(yr, yi): the (C, N) planes times ``rms_gains``'s segment gains."""
    c, n = xr.shape
    r, n_seg = gains.shape
    n_row = n // rows
    xr, xi = xr.reshape(r, n_row), xi.reshape(r, n_row)
    gseg = gains[:, :, None]
    yr = (xr[:, :n_seg * seg].reshape(r, n_seg, seg) * gseg).reshape(r, n_seg * seg)
    yi = (xi[:, :n_seg * seg].reshape(r, n_seg, seg) * gseg).reshape(r, n_seg * seg)
    if n_seg * seg < n_row:      # ragged tail: the row's last gain
        g_last = gains[:, -1:]
        yr = torch.cat([yr, xr[:, n_seg * seg:] * g_last], dim=-1)
        yi = torch.cat([yi, xi[:, n_seg * seg:] * g_last], dim=-1)
    return yr.reshape(c, n), yi.reshape(c, n)


def block_peak(xr: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """(C,) peak magnitude of a block."""
    return torch.sqrt(torch.amax(xr * xr + xi * xi, dim=-1))


def digital_update(state: AgcState, peak: torch.Tensor, n: int,
                   cfg: AgcConfig):
    """The digital profile's per-block state machine given the block
    peak.  Returns (gain_to_apply (C,), new_state)."""
    target = _f32(cfg.target)
    lock_samples = int(C.AGC_DIGITAL_SCAN_SEC * cfg.sample_rate) & _MASK
    hang_samples = int(C.AGC_DIGITAL_HANG_SEC * cfg.sample_rate) & _MASK

    # phase A (scanning)
    peak_mem_a = torch.maximum(state.peak_mem, peak)
    running_gain = target / torch.clamp(peak_mem_a, min=1e-4)
    lock_now = state.samples_seen > lock_samples

    # phase B (locked)
    g = state.gain
    out_peak = peak * g
    clip = out_peak > 1.0
    g_ratchet = _f32(C.AGC_DIGITAL_CLIP_RATCHET) / torch.clamp(peak, min=1e-9)
    strong = out_peak > _f32(target * _f32(C.AGC_DIGITAL_CREEP_THRESH))
    weak_run_b = torch.where(clip | strong, torch.zeros_like(state.weak_run),
                             (state.weak_run + n) & _MASK)
    creep = ~clip & ~strong & (state.weak_run > hang_samples)
    g_b = torch.where(clip, g_ratchet,
                      torch.where(creep, g * _f32(C.AGC_DIGITAL_CREEP), g))

    locked = state.locked
    gain_out = torch.where(locked, g_b, running_gain)
    new_state = AgcState(
        gain=torch.where(locked, g_b, torch.where(lock_now, running_gain, g)),
        e2=state.e2,
        peak_mem=torch.where(locked, state.peak_mem, peak_mem_a),
        locked=locked | lock_now,
        samples_seen=(state.samples_seen + n) & _MASK,
        weak_run=torch.where(locked, weak_run_b, torch.zeros_like(weak_run_b)))
    return gain_out, new_state


def _apply_digital_planar(xr, xi, state: AgcState, cfg: AgcConfig):
    gain_out, new_state = digital_update(state, block_peak(xr, xi),
                                         xr.shape[-1], cfg)
    g = gain_out[:, None]
    return xr * g, xi * g, new_state


def apply_planar(xr: torch.Tensor, xi: torch.Tensor, state: AgcState,
                 cfg: AgcConfig, rows: int = 1):
    """Planar float32 (C, N) planes -> (yr, yi, new state); ``rows`` as
    in rms_gains (the digital profile takes one peak over the block)."""
    if cfg.profile == "digital":
        return _apply_digital_planar(xr, xi, state, cfg)
    return _apply_rms_planar(xr, xi, state, cfg, rows)
