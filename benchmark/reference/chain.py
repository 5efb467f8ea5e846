"""The plain reference of the measured chains: what the program's output
should be, in float64 PyTorch, one block at a time.

    wire in (cs16, cu8 or cs8) -> [DC block] -> [I/Q estimate + correct]
            -> pre-shift -> [pre-filter] -> resampler stages
            -> [post-filter] -> [AGC] -> post-shift -> wire out

Written from the chain's definitions (a first-order DC blocker at 10 Hz,
the I/Q estimator's greedy descent on the spectral asymmetry, a 32-bit
phase NCO, Kaiser polyphase stages or one gather stage, linear
convolution with the designed FIR, the RMS AGC's per-segment gain loop
or the digital AGC's block state machine, round-half-away quantization),
with the design worked out again by ``design.py``.  It imports nothing of
the program: no kernel, no table, no plan.  Every stage is the plainest
form of its equation: the DC recurrence as a doubling scan, each
resampler stage as windows times its per-phase weights (the gather
stage: each output's window times its own weights), each filter as an
FFT convolution over the carried history.

``precision="tf32"`` is the control: every product's operands are
rounded to TF32 (10-bit mantissa) and summed in float32, as a chain
that dropped 3xTF32 for one TF32 product would compute.

A block is ``rows`` consecutive row blocks of ``n_in`` frames (a time
fold): the stages run over the whole block, the AGC lays its segments
per row, and the I/Q estimator reads the block's first 1024 frames.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import design as D

_MASK = 0xFFFFFFFF
_COUNTER_SAT = 0xF0000000
_DIRS = ((1, 1), (1, -1), (-1, 1), (-1, -1))
CS16_NORM = 1.0 / 32768.0        # wire -> float
CU8_OFFSET, CU8_NORM = 127.5, 1.0 / 128.0    # (x - 127.5) / 128
CS8_NORM = 1.0 / 128.0           # x / 128
CS16_SCALE = 32767.0             # float -> wire, clamped to [-32768, 32767]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 (10 mantissa bits)."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def decode_cs16(wire: torch.Tensor) -> torch.Tensor:
    """(C, 2N) int16 cs16 wire -> (C, N) complex128."""
    w = wire.double() * CS16_NORM
    return torch.complex(w[:, 0::2], w[:, 1::2])


def decode_cu8(wire: torch.Tensor) -> torch.Tensor:
    """(C, 2N) uint8 cu8 wire -> (C, N) complex128."""
    w = (wire.double() - CU8_OFFSET) * CU8_NORM
    return torch.complex(w[:, 0::2], w[:, 1::2])


def decode_cs8(wire: torch.Tensor) -> torch.Tensor:
    """(C, 2N) int8 cs8 wire -> (C, N) complex128."""
    w = wire.double() * CS8_NORM
    return torch.complex(w[:, 0::2], w[:, 1::2])


DECODERS = {"cs16": decode_cs16, "cu8": decode_cu8, "cs8": decode_cs8}
# values a gathered chunk of windows holds: (C, outputs, 2m) complex
GATHER_CHUNK = 1 << 24


def scan(coef: float, b: torch.Tensor) -> torch.Tensor:
    """y[k] = coef * y[k-1] + b[k] along the last axis, by doubling."""
    y = b.clone()
    s = 1
    while s < y.shape[-1]:
        y[..., s:] = y[..., s:] + coef ** s * y[..., :-s]
        s *= 2
    return y


class RefChain:
    """One stream of ``channels`` channels through a configuration (the
    benchmark's configuration file's ``chain`` fields), block by block."""

    def __init__(self, chain: dict, channels: int, target_block: int, rows: int = 1,
                 device="cpu", precision: str = "float64"):
        if chain["input_format"] not in DECODERS or chain["output_format"] != "cs16":
            raise NotImplementedError("the reference runs cs16, cu8 or cs8 in and cs16 out")
        if precision not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.cfg = chain
        self.decode = DECODERS[chain["input_format"]]
        self.ch, self.rows, self.dev, self.prec = channels, rows, torch.device(device), precision
        in_rate, out_rate = float(chain["input_rate"]), float(chain["target_rate"])
        att = float(chain.get("filter_attenuation_db", D.RESAMPLER_ATTENUATION_DB))
        self.plan = D.plan_resampler(out_rate / in_rate, target_block, att)
        self.n_in, self.n_out = self.plan.n_in * rows, self.plan.n_out * rows
        self.alpha = 2.0 * math.pi * D.DC_BLOCK_CUTOFF_HZ / in_rate
        self.dth_pre = D.freq_to_dtheta(chain.get("freq_shift_pre_hz", 0.0), in_rate)
        self.dth_post = D.freq_to_dtheta(chain.get("freq_shift_post_hz", 0.0), out_rate)
        reqs = [tuple(f) for f in chain.get("filters", [])]
        taps = D.design_chain(reqs, out_rate, att) if reqs else None
        if taps is not None and (D.max_filter_freq_hz(reqs) > out_rate / 2
                                 or chain.get("filter_stage", "auto") != "auto"):
            raise NotImplementedError("the reference runs a filter after the resampler")
        self.taps = taps
        self.dc = bool(chain.get("dc_block"))
        self.iq = bool(chain.get("iq_correction"))
        self.iq_interval = int(D.IQ_UPDATE_INTERVAL_SEC * in_rate)
        prof = chain.get("agc_profile")
        if prof not in (None, "local", "dx", "digital"):
            raise NotImplementedError(f"AGC profile {prof!r}")
        self.agc = prof
        self.lock_samples = int(D.AGC_DIGITAL_SCAN_SEC * out_rate) & _MASK
        self.hang_samples = int(D.AGC_DIGITAL_HANG_SEC * out_rate) & _MASK
        self.mats = [self._stage_matrix(st) for st in self.plan.stages]
        self.moves = D.IQ_EST_STEP * torch.tensor(_DIRS, dtype=torch.float64, device=self.dev)
        self._graph = None
        self.reset()

    def _stage_matrix(self, st):
        """A split stage's banded matrix; the gather stage's (weights,
        starts)."""
        if isinstance(st, D.Gather):
            return (torch.from_numpy(st.weights).to(self.dev),
                    torch.from_numpy(st.starts).to(self.dev))
        return torch.from_numpy(D.banded_matrix(st, 1)).to(self.dev)

    # -------------------------------------------------------------- state

    def reset(self) -> None:
        """The stream's start: every memory zero, the estimator due."""
        c, dev = self.ch, self.dev
        z = lambda n: torch.zeros((c, n), dtype=torch.complex128, device=dev)
        self.dc_x = torch.zeros(c, dtype=torch.complex128, device=dev)
        self.dc_y = torch.zeros(c, dtype=torch.complex128, device=dev)
        self.ph_pre = 0
        self.ph_post = 0
        self.hist = [z(2 * st.m - 1) for st in self.plan.stages]
        self.ftail = z(len(self.taps) - 1) if self.taps is not None else None
        self.gain = torch.ones(c, dtype=torch.float64, device=dev)
        self.e2 = torch.zeros(c, dtype=torch.float64, device=dev)
        self.digital = digital_init(c, dev)
        self.factors = torch.zeros((c, 2), dtype=torch.float64, device=dev)
        self.counter = _MASK

    def skip_to(self, frames: int) -> None:
        """Start at ``frames`` into the stream with the phases it has
        there and zero sample memory (a warm start: the DC blocker, the
        filters and the AGC forget it within the blocks run before the
        compared ones).  The I/Q estimator's factors and counter are
        kept."""
        factors, counter = self.factors, self.counter
        self.reset()
        self.factors, self.counter = factors, counter
        self.ph_pre = (frames * self.dth_pre) & _MASK
        self.ph_post = (frames * self.plan.p // self.plan.q * self.dth_post) & _MASK

    # ------------------------------------------------------------- stages

    def _dc_block(self, x: torch.Tensor) -> torch.Tensor:
        a = 1.0 - self.alpha
        b = x - torch.cat([self.dc_x[:, None], x[:, :-1]], dim=-1)
        b[:, 0] += a * self.dc_y
        y = torch.complex(scan(a, b.real.contiguous()), scan(a, b.imag.contiguous()))
        self.dc_x, self.dc_y = x[:, -1].clone(), y[:, -1].clone()
        return y

    def _mix(self, x: torch.Tensor, phase: int, dth: int) -> torch.Tensor:
        if not dth:
            return x
        idx = torch.arange(x.shape[-1], dtype=torch.int64, device=self.dev)
        ph = (phase + idx * dth) & _MASK
        return x * torch.polar(torch.ones_like(ph, dtype=torch.float64),
                               ph.double() * (2.0 * math.pi / 4294967296.0))

    def _product(self, win: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        """Complex windows (C, nb, L) times a real matrix (L, G)."""
        if self.prec == "float64":
            return torch.complex(win.real @ a, win.imag @ a)
        a32 = round_tf32(a.float())
        return torch.complex(round_tf32(win.real.float()) @ a32,
                             round_tf32(win.imag.float()) @ a32).to(torch.complex128)

    def _stage(self, i: int, x: torch.Tensor) -> torch.Tensor:
        st, a = self.plan.stages[i], self.mats[i]
        ext = torch.cat([self.hist[i], x], dim=-1)
        self.hist[i] = ext[:, -(2 * st.m - 1):].clone()
        if isinstance(st, D.Gather):
            return self._gather(ext, *a)
        win = ext.unfold(-1, a.shape[0], st.q)               # (C, n/q, q + 2m - 1)
        return self._product(win, a).reshape(x.shape[0], -1)

    def _gather(self, ext: torch.Tensor, w: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
        """The gather stage over history ++ block ``ext``: each output the
        dot of its window with its weights, a row block (``plan.n_in``
        inputs) at a time, in chunks of outputs that fit; in the control
        both operands of every product rounded to TF32 and summed in
        float32."""
        c, (m_out, k) = ext.shape[0], w.shape
        rows = (ext.shape[-1] - k + 1) // self.plan.n_in
        chunk = max(1, GATHER_CHUNK // (c * k))
        taps = torch.arange(k, device=self.dev)
        planes = torch.view_as_real(ext)                     # (C, L, 2)
        if self.prec == "tf32":
            planes, w = round_tf32(planes), round_tf32(w)
        out = []
        for r in range(rows):
            for j0 in range(0, m_out, chunk):
                idx = starts[j0:j0 + chunk, None] + taps + r * self.plan.n_in
                y = torch.einsum("cjkp,jk->cjp", planes[:, idx], w[j0:j0 + chunk])
                out.append(torch.view_as_complex(y.double().contiguous()))
        return torch.cat(out, -1)

    def _fir(self, x: torch.Tensor) -> torch.Tensor:
        """Causal linear convolution with the designed taps, across blocks."""
        k = len(self.taps)
        ext = torch.cat([self.ftail, x], dim=-1)
        self.ftail = ext[:, -(k - 1):].clone()
        n = 1 << (ext.shape[-1] + k - 2).bit_length()
        h = torch.from_numpy(self.taps).to(self.dev)
        if self.prec == "tf32":
            ext = torch.complex(round_tf32(ext.real.float()), round_tf32(ext.imag.float()))
            h = torch.complex(round_tf32(h.real.float()), round_tf32(h.imag.float()))
        y = torch.fft.ifft(torch.fft.fft(ext, n) * torch.fft.fft(h, n))
        return y[:, k - 1:k - 1 + x.shape[-1]].to(torch.complex128)

    # ------------------------------------------------------ I/Q estimator

    def _spectra(self, seg: torch.Tensor):
        n = seg.shape[-1]
        i = torch.arange(n, dtype=torch.float64, device=self.dev)
        w = 0.54 - 0.46 * torch.cos(2.0 * math.pi * i / (n - 1))
        base = torch.fft.fftshift(torch.fft.fft(w * seg), dim=-1)
        image = torch.fft.fftshift(torch.fft.fft(w * seg.real.to(seg.dtype)), dim=-1)
        return base, image

    @staticmethod
    def _spec_db(base, image, g, phi):
        v = base + torch.complex(g, phi)[..., None] * image
        return 20.0 * torch.log10(v.abs() / base.shape[-1] + 1e-12)

    @staticmethod
    def _band(s: torch.Tensor):
        half = s.shape[-1] // 2
        lo, hi = int(D.IQ_BAND_LO * half), int(D.IQ_BAND_HI * half)
        n = s.shape[-1]
        return torch.flip(s[..., n - hi:n - lo], dims=(-1,)), s[..., lo:hi]

    def _utility(self, s):
        pos, neg = self._band(s)
        mask = (pos > D.IQ_SPECTRUM_FLOOR_DB) | (neg > D.IQ_SPECTRUM_FLOOR_DB)
        return torch.where(mask, (pos - neg) ** 2, 0.0).sum(-1)

    def _descend(self, seg: torch.Tensor, f: torch.Tensor):
        """The descent from factors ``f`` on a block's first 1024 frames:
        25 greedy passes over the four diagonal moves of 1e-4, maximizing
        the spectral asymmetry over the band; and whether each channel
        passes the gate, a 20 dB peak-to-average ratio over the band."""
        base, image = self._spectra(seg)
        s0 = self._spec_db(base, image, f[:, 0], f[:, 1])
        pos, neg = self._band(s0)
        gate = torch.maximum(pos.amax(-1), neg.amax(-1)) - (pos.sum(-1) + neg.sum(-1)) / (
            2.0 * pos.shape[-1])
        cur, cur_u = f, self._utility(s0)
        rows = torch.arange(f.shape[0], device=self.dev)
        for _ in range(D.IQ_PASSES):
            cands = cur[None] + self.moves[:, None, :]                  # (4, C, 2)
            us = self._utility(self._spec_db(base[None], image[None],
                                             cands[..., 0], cands[..., 1]))
            best = torch.argmax(us, dim=0)
            better = us[best, rows] > cur_u
            cur = torch.where(better[:, None], cands[best, rows], cur)
            cur_u = torch.where(better, us[best, rows], cur_u)
        return cur, gate >= D.IQ_POWER_GATE_DB

    def _descent(self, seg: torch.Tensor, f: torch.Tensor):
        """``_descend``; on a card replayed as one CUDA graph of its ~900
        small operations, captured at the first call (the same operations
        on the same values, without the host's launch of each)."""
        if self.dev.type != "cuda":
            return self._descend(seg, f)
        if self._graph is None:
            self._g_in = (seg.clone(), f.clone())
            side = torch.cuda.Stream(self.dev)
            side.wait_stream(torch.cuda.current_stream(self.dev))
            with torch.cuda.stream(side):
                self._descend(*self._g_in)
            torch.cuda.current_stream(self.dev).wait_stream(side)
            self._graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self._graph):
                self._g_out = self._descend(*self._g_in)
        self._g_in[0].copy_(seg)
        self._g_in[1].copy_(f)
        self._graph.replay()
        return tuple(t.clone() for t in self._g_out)

    def _estimate(self, seg: torch.Tensor, due: bool) -> None:
        """The estimator on the block's first 1024 frames (DC-blocked where
        the chain blocks DC), due every 0.5 s of input: the descent's
        factors smoothed into the factors with weight 0.05 in the channels
        that pass the gate."""
        if due:
            f = self.factors
            cur, ok = self._descent(seg, f)
            sm = D.IQ_SMOOTHING
            self.factors = torch.where(ok[:, None], (1.0 - sm) * f + sm * cur, f)
            if bool(ok.any()):
                self.counter = 0
                return
        self.counter = min(min(self.counter, _COUNTER_SAT) + self.n_in, _COUNTER_SAT)

    def follow(self, k0: int, k1: int, block, warm_frames: int) -> list:
        """The I/Q estimator alone over blocks k0 .. k1 - 1 of the stream,
        as ``step`` runs it there, without the rest of the chain:
        ``block(k)`` is block k's (C, 2 n_in) wire, and a due block's
        first 1024 frames are DC-blocked from a state warmed over the
        ``warm_frames`` before it.  Returns the factors in force on each
        block."""
        if not self.iq:
            return [self.factors] * (k1 - k0)
        out = []
        warm = -(-warm_frames // self.n_in)
        for k in range(k0, k1):
            due = self.counter >= self.iq_interval
            seg = None
            if due:
                seg = self.decode(block(k)[:, :2 * D.IQ_FFT_SIZE].to(self.dev))
                if self.dc:
                    state = self.dc_x, self.dc_y
                    self.dc_x = torch.zeros_like(self.dc_x)
                    self.dc_y = torch.zeros_like(self.dc_y)
                    for j in range(max(0, k - warm), k):
                        self._dc_block(self.decode(block(j).to(self.dev)))
                    seg = self._dc_block(seg)
                    self.dc_x, self.dc_y = state
            self._estimate(seg, due)
            out.append(self.factors)
        return out

    # --------------------------------------------------------------- AGC

    def _agc(self, x: torch.Tensor) -> torch.Tensor:
        """The RMS AGC: per segment of about 128 samples of each row,
        g *= (target^2 / e2)^(beta / 2) with e2 the smoothed output
        energy, clamped to [1e-6, 1e6]; a segment takes the gain after its
        own update, samples past a row's last whole segment the row's
        last gain."""
        c, n = x.shape
        r = self.rows
        n_row = n // r
        n_seg = max(n_row // D.AGC_SEGMENT, 1)
        seg = n_row // n_seg
        bw = D.AGC_BW_DX if self.agc == "dx" else D.AGC_BW_LOCAL
        beta = 1.0 - (1.0 - bw) ** seg
        t2 = D.AGC_TARGET ** 2
        xr = x.reshape(c, r, n_row)
        e_in = (xr[..., :n_seg * seg].abs() ** 2).reshape(c, r, n_seg, seg).mean(-1)
        e_in = e_in.reshape(c, r * n_seg).T.cpu()
        g, e2 = self.gain.cpu(), self.e2.cpu()
        gains = torch.empty_like(e_in)
        for k in range(e_in.shape[0]):
            e2 = (1.0 - beta) * e2 + beta * e_in[k] * g * g
            g = torch.clamp(g * torch.exp(-0.5 * beta * torch.log(torch.clamp(e2, min=1e-16)
                                                                  / t2)), 1e-6, 1e6)
            gains[k] = g
        self.gain, self.e2 = g.to(self.dev), e2.to(self.dev)
        gains = gains.T.reshape(c, r, n_seg).to(self.dev)
        per = torch.cat([gains.repeat_interleave(seg, -1),
                         gains[..., -1:].expand(c, r, n_row - n_seg * seg)], -1)
        return x * per.reshape(c, n)

    def agc_state(self) -> dict:
        """The digital AGC's state, {field: (C,) tensor} (``digital_init``)."""
        return {f: t.clone() for f, t in self.digital.items()}

    def set_agc_state(self, state: dict) -> None:
        """Enter the next block with the digital AGC's ``state`` (a program's
        recorded state, or this chain's own)."""
        self.digital = {f: torch.as_tensor(state[f]).to(self.dev, t.dtype)
                        for f, t in self.digital.items()}

    # -------------------------------------------------------------- step

    def agc_input(self, wire: torch.Tensor, estimate: bool = True) -> torch.Tensor:
        """(C, 2 n_in) input wire -> (C, n_out) complex128: the block as the
        AGC reads it, every stage before it stepped."""
        x = self.decode(wire.to(self.dev))
        if self.dc:
            x = self._dc_block(x)
        if self.iq:
            if estimate:
                self._estimate(x[:, :D.IQ_FFT_SIZE], self.counter >= self.iq_interval)
            g, phi = self.factors[:, 0:1], self.factors[:, 1:2]
            x = torch.complex((1.0 + g) * x.real, x.imag + phi * x.real)
        x = self._mix(x, self.ph_pre, self.dth_pre)
        self.ph_pre = (self.ph_pre + self.n_in * self.dth_pre) & _MASK
        for i in range(len(self.plan.stages)):
            x = self._stage(i, x)
        if self.taps is not None:
            x = self._fir(x)
        return x

    def step(self, wire: torch.Tensor, estimate: bool = True) -> torch.Tensor:
        """(C, 2 n_in) input wire -> (C, n_out) complex128 output in codes
        (y * 32767), before rounding and clamping.  ``estimate=False``
        applies the I/Q factors as they stand, without the estimator."""
        x = self.agc_input(wire, estimate)
        if self.agc == "digital":
            gain, self.digital = digital_update(self.digital, x.abs().amax(-1), x.shape[-1],
                                                self.lock_samples, self.hang_samples)
            x = x * gain[:, None]
        elif self.agc:
            x = self._agc(x)
        x = self._mix(x, self.ph_post, self.dth_post)
        self.ph_post = (self.ph_post + self.n_out * self.dth_post) & _MASK
        return x * CS16_SCALE


def _f32(v: float) -> float:
    """``v`` as a float32: upstream's AGC keeps its gain, its peaks and its
    constants in floats."""
    return torch.tensor(v, dtype=torch.float32).item()


def digital_init(channels: int, device="cpu") -> dict:
    """The digital AGC's state at the stream's start, {field: (C,) tensor}
    under the program's names: gain 1, scanning from the peak memory
    0.05, counters 0."""
    f = lambda v, dt: torch.full((channels,), v, dtype=dt, device=device)
    return {"gain": f(1.0, torch.float64),
            "peak_mem": f(_f32(D.AGC_DIGITAL_PEAK_INIT), torch.float64),
            "locked": f(False, torch.bool), "samples_seen": f(0, torch.int64),
            "weak_run": f(0, torch.int64)}


def digital_update(state: dict, peak: torch.Tensor, n: int, lock_samples: int,
                   hang_samples: int) -> tuple:
    """The digital AGC's block state machine: (the block's gain, the new
    state) from the block's peak magnitude ``peak`` over ``n`` output
    samples, per channel.  Scanning, the gain is target / max(peak
    memory, 1e-4), the peak memory the running maximum of block peaks; a
    block entered with more than ``lock_samples`` seen locks the gain it
    takes.  Locked, a block whose output peak would pass 1 takes the gain
    0.99 / peak; one whose output peak is over 0.75 of the target ends
    the weak run, and a weak block entered after more than
    ``hang_samples`` of weak blocks takes the gain times 1.0005.  The
    constants are upstream's floats (1.0005 is 1.000499963760376)."""
    target = _f32(D.AGC_DIGITAL_TARGET)
    g, seen, weak_run = state["gain"], state["samples_seen"], state["weak_run"]
    locked = state["locked"]
    pm = torch.maximum(state["peak_mem"], peak)
    scan_gain = target / torch.clamp(pm, min=D.AGC_DIGITAL_PEAK_FLOOR)
    lock_now = seen > lock_samples
    out_peak = peak * g
    clip = out_peak > 1.0
    strong = out_peak > _f32(target * _f32(D.AGC_DIGITAL_CREEP_THRESH))
    creep = ~clip & ~strong & (weak_run > hang_samples)
    held = torch.where(clip, _f32(D.AGC_DIGITAL_CLIP_RATCHET)
                       / torch.clamp(peak, min=D.AGC_DIGITAL_RATCHET_FLOOR),
                       torch.where(creep, g * _f32(D.AGC_DIGITAL_CREEP), g))
    zero = torch.zeros_like(weak_run)
    weak = torch.where(clip | strong, zero, (weak_run + n) & _MASK)
    gain = torch.where(locked, held, scan_gain)
    return gain, {"gain": torch.where(locked | lock_now, gain, g),
                  "peak_mem": torch.where(locked, state["peak_mem"], pm),
                  "locked": locked | lock_now, "samples_seen": (seen + n) & _MASK,
                  "weak_run": torch.where(locked, weak, zero)}


def quantize_cs16(codes: torch.Tensor) -> torch.Tensor:
    """Output values in codes -> the (C, 2N) int16 wire: round half away
    from zero, clamp to [-32768, 32767]."""
    v = torch.stack([codes.real, codes.imag], dim=-1).reshape(codes.shape[0], -1)
    v = torch.trunc(torch.where(v > 0, v + 0.5, v - 0.5))
    return torch.clamp(v, -32768, 32767).to(torch.int16)


def channel_gaps(wire: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Each channel's widest gap, in codes, between a program's (C, 2M)
    int16 output wire and the reference's values (their first M frames),
    clamped to the wire's range: a (C,) float64 tensor."""
    ref = torch.stack([codes.real, codes.imag], dim=-1).reshape(codes.shape[0], -1)
    ref = torch.clamp(ref[:, :wire.shape[-1]], -32768.0, 32767.0)
    return (wire.to(ref.device).double() - ref).abs().amax(-1)


def code_gap(wire: torch.Tensor, codes: torch.Tensor) -> float:
    """The widest gap over every channel (``channel_gaps``)."""
    return float(channel_gaps(wire, codes).max())
