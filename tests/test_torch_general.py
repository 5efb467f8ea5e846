"""The port's general chain step against the JAX package's on the CPU:
BASELINE configs #3, #4 and #5, a chain without a resampler, inputs
without a packed wire, a carry handed over mid-stream, and reset.

The JAX chain runs its XLA path here (no Pallas flag set, so its block
never grows for the overlap-save kernel) and the port its kernels'
plain twins.  Bound: max |delta code| <= 4 over 3 carried blocks, and a
fed tone keeps >= 60 dB.  One exception, stated where it applies: an
overlap-save filter starts from a zero tail, so its first (taps - 1)/2
outputs are the filter's ramp at ~1e-5 of full scale; a fast AGC lifts
those by up to 1e4, until the float32 FFT rounding of either package
(~3e-7 absolute) shows as tens of codes.  Those frames of a stream's
first block are left out of the code bound.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iq_tool_tpu.ops import convert as jconvert  # noqa: E402
from iq_tool_tpu.ops.fir_design import FilterRequest as JaxFilter  # noqa: E402
from iq_tool_tpu.pipeline.chain import Chain as JaxChain  # noqa: E402
from iq_tool_tpu.pipeline.chain import ChainConfig as JaxConfig  # noqa: E402
from iq_tool_tpu_torch import profile_steps  # noqa: E402
from iq_tool_tpu_torch.ops import kernels, nco  # noqa: E402
from iq_tool_tpu_torch.ops.fir_design import FilterRequest  # noqa: E402
from iq_tool_tpu_torch.pipeline.chain import (Chain, ChainConfig,  # noqa: E402
                                              carry_from_numpy, carry_to_numpy)
from tests import ref_dsp  # noqa: E402

IN_RATE, OUT_RATE = 2_048_000.0, 1_488_375.0

CONFIG3 = dict(input_format="cu8", dc_block=True, filter_method="fft",
               filter_stage="pre", req=("pass-range", 0.0, 400e3))
CONFIG4 = dict(dc_block=True, iq_correction=True, freq_shift_pre_hz=100e3,
               freq_shift_post_hz=-50e3, agc_profile="local",
               req=("stop-range", 0.0, 10e3))
CONFIG5 = dict(dc_block=True, freq_shift_pre_hz=100e3, agc_profile="local",
               req=("lowpass", 400e3, 0.0))


def _configs(block, channels=2, **kw):
    """(JAX config, port config) of the same chain (BASELINE's
    tools/bench_all.py fields; ``req`` is one filter request)."""
    req = kw.pop("req", None)
    base = dict(input_format="cs16", output_format="cs16", input_rate=IN_RATE,
                target_rate=OUT_RATE, channels=channels, target_block=block)
    base.update(kw)
    return (JaxConfig(filters=(JaxFilter(*req),) if req else (), **base),
            ChainConfig(filters=(FilterRequest(*req),) if req else (), **base))


def _wire(rng, fmt, channels, frames, tone_hz=37e3, imbalance=(1.02, 0.03),
          noise=0.03, dc=0.06):
    """A tone, noise and a DC offset behind an I/Q imbalance, as the wire
    of `fmt` (made by the reference's converter)."""
    t = np.arange(frames) / IN_RATE
    x = (0.4 * np.exp(2j * np.pi * tone_hz * t)[None, :] + dc
         + noise * (rng.standard_normal((channels, frames))
                    + 1j * rng.standard_normal((channels, frames))))
    g, phi = imbalance
    xr = (x.real * g).astype(np.float32)
    xi = (x.imag + phi * x.real).astype(np.float32)
    return np.array(jconvert.from_planar(xr, xi, fmt))


def _run_jax(chain, raw, blocks, carry=None):
    carry = chain.init_carry() if carry is None else carry
    outs = []
    w = chain.in_wire_len
    for b in blocks:
        carry, o = chain.step(carry, raw[:, b * w:(b + 1) * w], np.bool_(False))
        outs.append(np.asarray(o))
    return carry, np.concatenate(outs, -1)


def _run_port(chain, raw, blocks, carry=None):
    carry = chain.init_carry() if carry is None else carry
    outs = []
    w = chain.in_wire_len
    for b in blocks:
        carry, o = chain.step(carry, torch.from_numpy(raw[:, b * w:(b + 1) * w]))
        outs.append(o.numpy())
    return carry, np.concatenate(outs, -1)


def _ramp_items(chain):
    """Output wire items of the first block left out of the code bound:
    an overlap-save filter's ramp when an AGC runs after it."""
    filt = chain.post_filter or chain.pre_filter
    if chain.agc_cfg is None or filt is None or filt._exec_banded:
        return 0
    frames = filt.num_taps // 2
    if filt is chain.pre_filter and chain.resampler is not None:
        frames = frames * chain.n_out // chain.n_in + 1
    return frames * chain.fmt_out.items_per_frame


def _max_dcode(got, want, skip=0):
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    return int(d[:, skip:].max())


@pytest.mark.parametrize("name,block", [(3, 16384), (4, 16384), (5, 16384),
                                        (4, 65536)],
                         ids=["config3", "config4", "config5", "config4-65536"])
def test_general_configs_parity(rng, name, block):
    """At 65536 config #4's notch runs every window kind: 3/4-advance,
    one half-advance and the re-anchored tail."""
    cfg = {3: CONFIG3, 4: CONFIG4, 5: CONFIG5}[name]
    jcfg, pcfg = _configs(block, **cfg)
    jc, pc = JaxChain(jcfg), Chain(pcfg, device="cpu")
    assert (jc.n_in, jc.n_out) == (pc.n_in, pc.n_out)
    if name == 4:
        assert not pc.post_filter._exec_banded and pc.post_filter.num_taps == 2175
    if name == 5:
        assert pc.post_filter is None and pc.pre_filter is None      # composed
    if name == 3:
        assert pc.pre_filter is not None and pc.pre_filter._exec_banded
    raw = _wire(rng, pcfg.input_format, 2, 3 * jc.n_in)
    jcarry, want = _run_jax(jc, raw, range(3))
    launches = kernels.dc_block_apply.launches
    pcarry, got = _run_port(pc, raw, range(3))
    assert kernels.dc_block_apply.launches == launches          # CPU: the twins
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _max_dcode(got, want, _ramp_items(pc)) <= 4
    pnp = carry_to_numpy(pcarry)
    np.testing.assert_array_equal(pnp["nco_post"], np.asarray(jcarry["nco_post"]))
    if "iq" in pnp:
        np.testing.assert_allclose(pnp["iq"][0], np.asarray(jcarry["iq"].factors),
                                   rtol=0, atol=1e-5)
        assert pnp["iq"][1] == np.asarray(jcarry["iq"].samples_since_opt)
    if "agc" in pnp:
        np.testing.assert_allclose(pnp["agc"][0], np.asarray(jcarry["agc"].gain),
                                   rtol=1e-3)


@pytest.mark.parametrize("name", ["3", "4", "5", "4k32", "full4"])
def test_measured_configs_are_baseline(name):
    """The chains chip_smoke.py and the profiler measure are the configs
    tested here (4k32: #4 with --filter-fft-size 32768; full4: #4
    without the DC block)."""
    cfg = {"3": CONFIG3, "4": CONFIG4, "5": CONFIG5,
           "4k32": dict(CONFIG4, filter_fft_size=32768),
           "full4": dict(CONFIG4, dc_block=False)}[name]
    _, want = _configs(16384, **cfg)
    assert profile_steps.config(name, 2, 16384) == want


def test_profiled_full4_is_the_benchmarks():
    """profile_steps' "full4" is the chain of the benchmark's full4
    configuration (benchmark/configs/full4.json), field for field."""
    import json
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "benchmark/configs/full4.json"
    fields = dict(json.loads(path.read_text())["chain"])
    fields["filters"] = tuple(FilterRequest(*f) for f in fields["filters"])
    want = ChainConfig(channels=64, target_block=262144, **fields)
    assert profile_steps.config("full4", 64) == want


def test_profiled_baseline3_is_the_benchmarks():
    """profile_steps' "baseline3" is the chain of the benchmark's baseline3
    configuration (benchmark/configs/baseline3.json), field for field."""
    import json
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "benchmark/configs/baseline3.json"
    fields = dict(json.loads(path.read_text())["chain"])
    fields["filters"] = tuple(FilterRequest(*f) for f in fields["filters"])
    want = ChainConfig(channels=64, target_block=262144, **fields)
    assert profile_steps.config("baseline3", 64) == want


def test_profiled_hackrf10_is_the_benchmarks():
    """profile_steps' "hackrf10" is the chain of the benchmark's hackrf10
    configuration (benchmark/configs/hackrf10.json), field for field, and
    its input the measured tone as cs8 codes."""
    import json
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "benchmark/configs/hackrf10.json"
    fields = dict(json.loads(path.read_text())["chain"])
    fields["filters"] = tuple(FilterRequest(*f) for f in fields["filters"])
    want = ChainConfig(channels=64, target_block=262144, **fields)
    assert profile_steps.config("hackrf10", 64) == want
    w = profile_steps.tone_wire(3, 4096, torch.Generator().manual_seed(7))
    c = profile_steps.to_cs8(w)
    assert c.dtype == torch.int8 and 63 <= int(c.abs().max()) <= 65


def test_measured_tone_wire():
    """The measured chains' input: seeded, full-scale-safe cs16, and the
    same tone as cu8 codes."""
    wires = [profile_steps.tone_wire(3, 4096, torch.Generator().manual_seed(7))
             for _ in range(2)]
    assert torch.equal(*wires)
    w = wires[0]
    assert w.shape == (3, 8192) and w.dtype == torch.int16
    assert 16300 < int(w.abs().max()) <= 16400          # a 0.5 tone plus noise
    u = profile_steps.to_cu8(w)
    assert u.dtype == torch.uint8 and 63 <= int(u.min()) and int(u.max()) <= 192


def test_config4_tone_snr(rng):
    """A clean tone through config #4: >= 60 dB at 37 + 100 - 50 kHz (at
    the post-NCO's realised shift) over the third 131072-frame block."""
    jcfg, pcfg = _configs(131072, channels=1, **CONFIG4)
    jc, pc = JaxChain(jcfg), Chain(pcfg, device="cpu")
    raw = _wire(rng, "cs16", 1, 3 * jc.n_in, imbalance=(1.0, 0.0), noise=1e-4, dc=0.0)
    _, want = _run_jax(jc, raw, range(3))
    _, got = _run_port(pc, raw, range(3))
    assert _max_dcode(got, want, _ramp_items(pc)) <= 4
    d = nco.freq_to_dtheta(-50e3, OUT_RATE)
    tone = 137e3 + (d - ((d >> 31) << 32)) / 2 ** 32 * OUT_RATE
    for wire in (got[0], want[0]):
        y = ref_dsp.to_cf32(wire, "cs16")[2 * jc.n_out:]
        m = np.arange(2 * jc.n_out, 2 * jc.n_out + y.size)
        ideal = np.exp(2j * np.pi * tone / OUT_RATE * m)
        a = np.vdot(ideal, y) / np.vdot(ideal, ideal)
        snr = 10 * np.log10(np.mean(np.abs(a * ideal) ** 2)
                            / np.mean(np.abs(y - a * ideal) ** 2))
        assert snr >= 60.0


@pytest.mark.parametrize("case", [
    dict(input_format="cs16", output_format="cu8", target_rate=None, dc_block=True,
         iq_correction=True, freq_shift_pre_hz=60e3, freq_shift_post_hz=25e3,
         agc_profile="digital", req=("lowpass", 300e3, 0.0)),
    dict(input_format="cs24", dc_block=True, iq_correction=True,
         agc_profile="dx", freq_shift_post_hz=-30e3),
    dict(input_format="cf32", output_format="cf32", target_rate=None,
         iq_correction=True, agc_profile="local", filter_method="fft",
         req=("stop-range", 0.0, 10e3)),
], ids=["no-resampler-digital-agc", "cs24-planar-k3", "cf32-no-dc-overlap-save"])
def test_other_general_chains_parity(rng, case):
    """A chain without a resampler (its lowpass runs as a banded
    StreamingFilter: nothing to compose into), non-packable inputs (K3's
    planar mode, or no DC block at all) and a non-packable output (the
    plain post path)."""
    case = dict(case)
    fmt_in = case["input_format"]
    jcfg, pcfg = _configs(16384, **case)
    jc, pc = JaxChain(jcfg), Chain(pcfg, device="cpu")
    if pcfg.target_rate is None:
        assert pc.resampler is None and pc.pre_filter is not None
        assert pc.expected_out_frames(12345) == 12345
    raw = _wire(rng, fmt_in, 2, 3 * jc.n_in)
    _, want = _run_jax(jc, raw, range(3))
    _, got = _run_port(pc, raw, range(3))
    assert got.dtype == want.dtype and got.shape == want.shape
    skip = _ramp_items(pc)
    if pcfg.output_format == "cf32":
        np.testing.assert_allclose(got[:, skip:], want[:, skip:], rtol=0,
                                   atol=4 / 32768)
    else:
        assert _max_dcode(got, want, skip) <= 4


def test_general_carry_handover(rng):
    """Config #4: block 1 in JAX, its carry (I/Q, AGC and the notch's
    tail among its keys) converted, blocks 2-3 in the port; the port's
    carry converts back to the reference's layout."""
    jcfg, pcfg = _configs(16384, **CONFIG4)
    jc, pc = JaxChain(jcfg), Chain(pcfg, device="cpu")
    raw = _wire(rng, "cs16", 2, 3 * jc.n_in)
    jfull, want = _run_jax(jc, raw, range(3))
    jcarry, first = _run_jax(jc, raw, range(1))
    carry = carry_from_numpy(jax.device_get(jcarry))
    assert {"iq", "agc", "post_f", "dc", "rs"} <= set(carry)
    pcarry, rest = _run_port(pc, raw, range(1, 3), carry)
    got = np.concatenate([first, rest], -1)
    assert _max_dcode(got, want) <= 4
    pnp, jnp_ = carry_to_numpy(pcarry), jax.device_get(jfull)
    assert set(pnp) == set(jnp_)
    for key in ("post_f", "dc"):
        for a, b in zip(pnp[key], jnp_[key]):
            assert ref_dsp.snr_db(np.asarray(b, np.float64), a) >= 80.0
    for a, b in zip(pnp["agc"], jnp_["agc"]):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=1e-3)


def test_general_reset_keeps_iq_factors(rng):
    """A discontinuity zeroes sample memory and resets the AGC but keeps
    the learned I/Q factors, as the reference's _reset_carry does."""
    _, pcfg = _configs(16384, **CONFIG4)
    pc = Chain(pcfg, device="cpu")
    raw = _wire(rng, "cs16", 2, 2 * pc.n_in, tone_hz=137e3)   # in the estimator's band
    carry, _ = _run_port(pc, raw, range(1))
    assert carry["iq"].factors.abs().sum() > 0
    nxt = torch.from_numpy(raw[:, pc.in_wire_len:])
    _, after_reset = pc.step(carry, nxt, reset=True)
    fresh = pc.init_carry()
    fresh["iq"] = carry["iq"]
    _, want = pc.step(fresh, nxt)
    np.testing.assert_array_equal(after_reset.numpy(), want.numpy())
