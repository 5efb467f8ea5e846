"""The torch port's chain against the JAX package's on the CPU: the
resampler design bit for bit, the step over carried blocks, a carry
handed over mid-stream, BASELINE configs #1/#2, and the CLI; plus the
port's guarantees that it imports no jax and never falls back from CUDA.

Bound: max |delta code| <= 4, the bound the JAX package holds between its
own fused and XLA paths; a tone through the chain keeps >= 60 dB SNR.
"""

import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from iq_tool_tpu.cli import main as jax_main  # noqa: E402
from iq_tool_tpu.ops.fir_design import FilterRequest as JaxFilter  # noqa: E402
from iq_tool_tpu.pipeline.chain import Chain as JaxChain  # noqa: E402
from iq_tool_tpu.pipeline.chain import ChainConfig as JaxConfig  # noqa: E402
from iq_tool_tpu_torch.cli import main as port_main  # noqa: E402
from iq_tool_tpu_torch.ops.fir_design import FilterRequest  # noqa: E402
from iq_tool_tpu_torch.pipeline.chain import (Chain, ChainConfig,  # noqa: E402
                                              carry_from_numpy, carry_to_numpy)
from tests import ref_dsp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN_RATE, OUT_RATE = 2_048_000.0, 1_488_375.0


def _configs(block, channels=2, **kw):
    """(JAX config, port config) pairs of the same chain; ``lowpass`` (Hz)
    or ``band`` ((type, freq1, freq2)) adds one filter request."""
    band = kw.pop("band", None)
    lowpass = kw.pop("lowpass", None)
    req = ("lowpass", lowpass, 0.0) if lowpass else band
    base = dict(input_format="cs16", output_format="cs16", input_rate=IN_RATE,
                target_rate=OUT_RATE, channels=channels, target_block=block)
    base.update(kw)
    return (JaxConfig(filters=(JaxFilter(*req),) if req else (), **base),
            ChainConfig(filters=(FilterRequest(*req),) if req else (), **base))


FLAGSHIP = dict(dc_block=True, freq_shift_pre_hz=100e3, lowpass=400e3)
CONFIG1 = dict()
CONFIG2 = dict(freq_shift_pre_hz=250e3, lowpass=400e3)


def _stream(rng, channels, frames, tone_hz=37e3, noise=0.05, dc=0.08):
    t = np.arange(frames) / IN_RATE
    x = (0.45 * np.exp(2j * np.pi * tone_hz * t)[None, :]
         + noise * (rng.standard_normal((channels, frames))
                    + 1j * rng.standard_normal((channels, frames))) + dc)
    pairs = np.stack([x.real, x.imag], -1).reshape(channels, 2 * frames)
    return np.clip(np.round(pairs * 32767), -32768, 32767).astype(np.int16)


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


def _max_dcode(a, b):
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def _tone_snr(wire, freq_hz, start):
    """Tone SNR of a cs16 output fitted as tests/test_cli.py does."""
    y = ref_dsp.to_cf32(wire, "cs16")[start:]
    m = np.arange(start, start + y.size)
    ideal = np.exp(2j * np.pi * (freq_hz / OUT_RATE) * m)
    a = np.vdot(ideal, y) / np.vdot(ideal, ideal)
    return 10 * np.log10(np.mean(np.abs(a * ideal) ** 2)
                         / np.mean(np.abs(y - a * ideal) ** 2))


@pytest.mark.parametrize("block", [16384, 262144])
def test_design_bit_equal(block):
    jcfg, pcfg = _configs(block, **FLAGSHIP)
    jc, pc = JaxChain(jcfg), Chain(pcfg, device="cpu")
    assert (jc.n_in, jc.n_out) == (pc.n_in, pc.n_out)
    assert jc.dc_alpha == pc.dc_alpha and int(jc.dtheta_pre) == pc.dtheta_pre
    assert len(jc.resampler.stages) == len(pc.resampler.stages) == 2
    for js, ps in zip(jc.resampler.stages, pc.resampler.stages):
        assert (js.p, js.q, js.g, js.stride, js.hist) == (ps.p, ps.q, ps.g, ps.stride, ps.hist)
        assert np.array_equal(js._a, ps._a)
        assert (js._a_i is None) == (ps._a_i is None)
        if js._a_i is not None:
            assert np.array_equal(js._a_i, ps._a_i)


@pytest.mark.parametrize("block", [16384, 131072])
def test_flagship_chain_parity(rng, block):
    jcfg, pcfg = _configs(block, **FLAGSHIP)
    jc, pc = JaxChain(jcfg), Chain(pcfg, device="cpu")
    raw = _stream(rng, 2, 3 * jc.n_in)
    jcarry, want = _run_jax(jc, raw, range(3))
    pcarry, got = _run_port(pc, raw, range(3))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _max_dcode(got, want) <= 4
    # the carries agree too
    pnp = carry_to_numpy(pcarry)
    np.testing.assert_array_equal(pnp["nco_pre"], np.asarray(jcarry["nco_pre"]))
    for (jr, ji), (pr, pi) in zip(jcarry["rs"], pnp["rs"]):
        assert ref_dsp.snr_db(np.asarray(jr) + 1j * np.asarray(ji), pr + 1j * pi) >= 80.0


def test_flagship_tone_snr(rng):
    """A clean tone through both chains: >= 60 dB once the 10 Hz DC
    blocker's start-up transient (time constant ~32.6k samples) has
    decayed, i.e. over the third 131072-frame block."""
    jcfg, pcfg = _configs(131072, channels=1, **FLAGSHIP)
    jc, pc = JaxChain(jcfg), Chain(pcfg, device="cpu")
    raw = _stream(rng, 1, 3 * jc.n_in, noise=1e-4, dc=0.0)
    _, want = _run_jax(jc, raw, range(3))
    _, got = _run_port(pc, raw, range(3))
    assert _max_dcode(got, want) <= 4
    for wire in (got[0], want[0]):
        assert _tone_snr(wire, 37e3 + 100e3, 2 * jc.n_out) >= 60.0


def test_mid_stream_handoff(rng):
    """Block 1 in JAX, its carry converted, blocks 2-3 in the port."""
    jcfg, pcfg = _configs(16384, **FLAGSHIP)
    jc, pc = JaxChain(jcfg), Chain(pcfg, device="cpu")
    raw = _stream(rng, 2, 3 * jc.n_in)
    _, want = _run_jax(jc, raw, range(3))
    jcarry, first = _run_jax(jc, raw, range(1))
    carry = carry_from_numpy(jax.device_get(jcarry))
    _, rest = _run_port(pc, raw, range(1, 3), carry)
    got = np.concatenate([first, rest], -1)
    assert _max_dcode(got, want) <= 4


@pytest.mark.parametrize("cfg", [CONFIG1, CONFIG2], ids=["config1", "config2"])
def test_baseline_configs_parity(rng, cfg):
    jcfg, pcfg = _configs(16384, **cfg)
    jc, pc = JaxChain(jcfg), Chain(pcfg, device="cpu")
    raw = _stream(rng, 2, 3 * jc.n_in)
    _, want = _run_jax(jc, raw, range(3))
    _, got = _run_port(pc, raw, range(3))
    assert _max_dcode(got, want) <= 4


@pytest.mark.parametrize("case", [
    dict(input_format="cu8", output_format="cf32", dc_block=True),
    dict(input_format="sc16q11", output_format="cs24", freq_shift_pre_hz=-75e3),
    dict(input_format="cs8", output_format="cu16", dc_block=True,
         band=("pass-range", 150e3, 300e3)),          # complex composed taps
    dict(input_format="cu16", output_format="cs32", band=("highpass", 200e3, 0.0)),
], ids=["cu8-cf32", "sc16q11-cs24", "cs8-cu16-complex", "cu16-cs32"])
def test_other_formats_parity(rng, case):
    """Every packed input kind, the planar (non-packable) outputs and a
    complex composed filter, against the JAX chain."""
    from iq_tool_tpu.ops import convert as jconvert
    jcfg, pcfg = _configs(16384, **case)
    jc, pc = JaxChain(jcfg), Chain(pcfg, device="cpu")
    if "band" in case and case["band"][0] == "pass-range":
        assert pc.resampler.stages[-1]._a_i is not None
    x = _stream(rng, 2, 3 * jc.n_in).astype(np.float32) / 32768.0
    xr, xi = x[:, 0::2] * 0.9, x[:, 1::2] * 0.9
    raw = np.array(jconvert.from_planar(xr, xi, case["input_format"]))
    _, want = _run_jax(jc, raw, range(3))
    _, got = _run_port(pc, raw, range(3))
    assert got.dtype == want.dtype and got.shape == want.shape
    fmt = case["output_format"]
    if fmt == "cf32":
        np.testing.assert_allclose(got, want, rtol=0, atol=4 / 32768)
    elif fmt == "cs24":
        g = ref_dsp.to_cf32(got[0], fmt)
        w = ref_dsp.to_cf32(want[0], fmt)
        assert np.abs(g - w).max() <= 4 * 2 ** -23 * np.sqrt(2)
    elif fmt == "cs32":
        assert np.abs(got.astype(np.int64) - want).max() <= 4 * 2 ** 16
    else:
        assert _max_dcode(got, want) <= 4


def test_reset_clears_stream_state(rng):
    _, pcfg = _configs(16384, **FLAGSHIP)
    pc = Chain(pcfg, device="cpu")
    raw = _stream(rng, 2, 2 * pc.n_in)
    carry, _ = _run_port(pc, raw, range(1))
    _, after_reset = pc.step(carry, torch.from_numpy(raw[:, pc.in_wire_len:]), reset=True)
    _, fresh = pc.step(pc.init_carry(), torch.from_numpy(raw[:, pc.in_wire_len:]))
    np.testing.assert_array_equal(after_reset.numpy(), fresh.numpy())


FLAGSHIP_FLAGS = ["-i", "raw-file", "-o", "raw",
                  "--raw-file-input-rate", "2048000",
                  "--raw-file-input-sample-format", "cs16",
                  "--output-rate", "1488375", "--dc-block",
                  "--freq-shift", "100000", "--lowpass", "400000"]


def test_cli_parity(rng, tmp_path):
    n = 16384 * 3 + 1000
    inp = tmp_path / "in.raw"
    inp.write_bytes(_stream(rng, 1, n).tobytes())
    out_j, out_p = tmp_path / "jax.raw", tmp_path / "port.raw"
    assert jax_main([str(inp), str(out_j), *FLAGSHIP_FLAGS]) == 0
    res = subprocess.run([sys.executable, "-m", "iq_tool_tpu_torch", str(inp),
                          str(out_p), *FLAGSHIP_FLAGS, "--device", "cpu"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    want = np.frombuffer(out_j.read_bytes(), np.int16)
    got = np.frombuffer(out_p.read_bytes(), np.int16)
    assert got.size == want.size == 2 * (n * 11907 // 16384)
    assert _max_dcode(got, want) <= 4


def test_cli_multichannel_and_passthrough(rng, tmp_path):
    """--channels 2 with a {ch} template runs both streams as one batch in
    lockstep: each channel's output matches the JAX single-stream run of
    the same file; --raw-passthrough copies bytes."""
    n = 16384 * 2 + 777
    for c in range(2):
        (tmp_path / f"in_{c}.raw").write_bytes(_stream(rng, 1, n).tobytes())
    assert port_main([str(tmp_path / "in_{ch}.raw"), str(tmp_path / "out_{ch}.raw"),
                      *FLAGSHIP_FLAGS, "--channels", "2", "--device", "cpu"]) == 0
    for c in range(2):
        ref = tmp_path / f"jax_{c}.raw"
        assert jax_main([str(tmp_path / f"in_{c}.raw"), str(ref), *FLAGSHIP_FLAGS]) == 0
        want = np.frombuffer(ref.read_bytes(), np.int16)
        got = np.frombuffer((tmp_path / f"out_{c}.raw").read_bytes(), np.int16)
        assert got.size == want.size == 2 * (n * 11907 // 16384)
        assert _max_dcode(got, want) <= 4
    assert port_main([str(tmp_path / "in_0.raw"), str(tmp_path / "copy.raw"),
                      "-i", "raw-file", "-o", "raw", "--raw-file-input-rate",
                      "2048000", "--raw-file-input-sample-format", "cs16",
                      "--raw-passthrough", "--device", "cpu"]) == 0
    assert (tmp_path / "copy.raw").read_bytes() == (tmp_path / "in_0.raw").read_bytes()


@pytest.mark.parametrize("flag", [["--mesh-time", "2"], ["--time-fold", "2"],
                                  ["--checkpoint", "x.ckpt"], ["--mesh-channel", "2"],
                                  ["--resume"], ["--profile-dir", "p"]])
def test_cli_refuses_unported_flags(tmp_path, capsys, flag):
    """No flag of the JAX CLI is refused as not yet ported any more: the
    mesh, fold, checkpoint, resume and profile flags pass the parser and
    reach the run (which fails here on the missing input file)."""
    argv = [str(tmp_path / "a"), str(tmp_path / "b"), *FLAGSHIP_FLAGS, "--device", "cpu",
            *flag]
    assert port_main(argv) == 1
    err = capsys.readouterr().err
    assert "not yet ported" not in err and "error:" in err


def test_unported_chain_features_raise(rng):
    """The gather stage (a ratio with a prime factor above 512, here
    521/512) raised NotImplementedError until it was ported: both chains
    now build on it and match the JAX chain over carried blocks."""
    for kw in (dict(target_rate=2_084_000.0),
               dict(target_rate=2_084_000.0, iq_correction=True, agc_profile="local")):
        jcfg, pcfg = _configs(16384, **kw)
        jc, pc = JaxChain(jcfg), Chain(pcfg, device="cpu")
        assert pc.resampler.plan.fallback and jc.resampler.plan.fallback
        assert (pc.n_in, pc.n_out) == (jc.n_in, jc.n_out)
        raw = _stream(rng, 2, 2 * jc.n_in)
        _, want = _run_jax(jc, raw, range(2))
        _, got = _run_port(pc, raw, range(2))
        assert _max_dcode(got, want) <= 4


def test_port_imports_no_jax(tmp_path):
    """In a fresh interpreter that refuses jax, jaxlib and the JAX
    package itself: import the port, run one CPU block of the flagship
    chain and of the general step, the CLI's --help, and the CLI file to
    file."""
    src = tmp_path / "in.cs16"
    np.random.default_rng(7).integers(-3000, 3000, 2 * 40000, dtype=np.int16).tofile(src)
    script = textwrap.dedent("""
        import os, runpy, sys
        REFUSED = ("jax", "jaxlib", "iq_tool_tpu")
        src, dst = sys.argv[1:3]
        class NoJax:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in REFUSED:
                    raise ImportError("refused: " + name)
        sys.meta_path.insert(0, NoJax())
        import torch
        import iq_tool_tpu_torch.cli, iq_tool_tpu_torch.pipeline.runtime
        import iq_tool_tpu_torch.pipeline.folded, iq_tool_tpu_torch.utils.watchdog
        import iq_tool_tpu_torch.parallel.multihost, iq_tool_tpu_torch.parallel.worker
        from iq_tool_tpu_torch.parallel import ShardedChain, make_mesh
        from iq_tool_tpu_torch.ops.fir_design import FilterRequest
        from iq_tool_tpu_torch.pipeline.chain import Chain, ChainConfig
        ch = Chain(ChainConfig(input_format="cs16", output_format="cs16",
                               input_rate=2048000.0, target_rate=1488375.0,
                               dc_block=True, freq_shift_pre_hz=100e3,
                               filters=(FilterRequest("lowpass", 400e3),)),
                   device="cpu")
        raw = torch.zeros((1, ch.in_wire_len), dtype=torch.int16)
        _, out = ch.step(ch.init_carry(), raw)
        assert out.shape == (1, ch.out_wire_len)
        # the same chain over a 1 x 2 mesh of the CPU
        sc = ShardedChain(ch.cfg, make_mesh(["cpu"] * 2, 1, 2))
        _, out = sc.step(sc.init_carry(), torch.zeros((1, sc.in_wire_len), dtype=torch.int16))
        assert out.shape == (1, sc.out_wire_len)
        # the general step: I/Q, overlap-save notch, post-shift, AGC
        g = Chain(ChainConfig(input_format="cs16", output_format="cs16",
                              input_rate=2048000.0, target_rate=1488375.0,
                              dc_block=True, iq_correction=True,
                              freq_shift_pre_hz=100e3, freq_shift_post_hz=-50e3,
                              filters=(FilterRequest("stop-range", 0.0, 10e3),),
                              agc_profile="local"), device="cpu")
        raw = torch.ones((1, g.in_wire_len), dtype=torch.int16)
        _, out = g.step(g.init_carry(), raw)
        assert out.shape == (1, g.out_wire_len)
        sys.argv = ["iq_tool_tpu_torch", "--help"]
        try:
            runpy.run_module("iq_tool_tpu_torch", run_name="__main__")
        except SystemExit as e:
            assert e.code in (0, None), e.code
        from iq_tool_tpu_torch.cli import main
        assert main([src, dst, "-i", "raw-file", "-o", "raw",
                     "--raw-file-input-rate", "2048000",
                     "--raw-file-input-sample-format", "cs16",
                     "--output-rate", "1488375", "--dc-block", "--lowpass", "400000",
                     "--block-size", "16384", "--device", "cpu"]) in (0, None)
        assert os.path.getsize(dst) == 4 * (40000 * 11907 // 16384), os.path.getsize(dst)
        assert not any(m.split(".")[0] in REFUSED for m in sys.modules)
    """)
    res = subprocess.run([sys.executable, "-c", script, str(src), str(tmp_path / "out.cs16")],
                         cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "--device" in res.stdout


def test_no_fallback_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks the CPU-only case")
    for kw in (FLAGSHIP, dict(dc_block=True, iq_correction=True,
                              freq_shift_post_hz=-50e3, agc_profile="local",
                              band=("stop-range", 0.0, 10e3))):
        _, pcfg = _configs(16384, **kw)
        with pytest.raises(RuntimeError, match="CUDA"):
            Chain(pcfg, device="cuda")
    # chip_smoke.py fails, from the checkout and alone in a directory
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for cwd in (REPO, str(alone)):
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout


@pytest.mark.parametrize("case", [dict(lowpass=400e3), dict(band=("stop-range", 0.0, 10e3)),
                                  dict(target_rate=None), dict(output_format="cu8")],
                         ids=["fir", "notch", "no-resample", "cu8-out"])
def test_chain_attributes_match_jax(case):
    """designed_filter (the filter design the chain runs) and
    out_wire_dtype, as the JAX chain's (pipeline/chain.py:131, :229)."""
    jcfg, pcfg = _configs(16384, **case)
    jc, pc = JaxChain(jcfg), Chain(pcfg, device="cpu")
    assert pc.out_wire_dtype == jc.out_wire_dtype
    jd, pd = jc.designed_filter, pc.designed_filter
    assert (jd is None) == (pd is None)
    if pd is not None:
        np.testing.assert_array_equal(np.asarray(pd.taps), np.asarray(jd.taps))
        assert pc.filter_stage == jc.filter_stage


# config #4's shape without the DC block (the benchmark's full4 chain):
# I/Q correction, +100 kHz pre-NCO, the 0-10 kHz stop-range after the
# resampler, -50 kHz post-NCO, local AGC; a case beside the fuzz CASES,
# which hold no chain with I/Q correction and a pre-NCO but no DC block
FULL4_CASE = (dict(input_format="cs16", target_rate=1_488_375.0, iq_correction=True,
                   freq_shift_pre_hz=100e3, freq_shift_post_hz=-50e3,
                   filters=(JaxFilter("stop-range", 0.0, 10e3),), agc_profile="local"),
              150e3)


# upstream's AM HD Radio preset (cs16-am-nrsc5) from an SDRplay's cs16 at
# 2 Msps, the benchmark's sdrplay2-am chain: one banded stage decimating
# 43:1 (k 687, 4 outputs a window) to 46,511.71875 Hz, the digital AGC; 16
# blocks of 16,512 frames, so that 2,048 output frames a channel lie past
# the AGC's left-out start
AM_CASE = (dict(input_format="cs16", input_rate=2_000_000.0, target_rate=46_511.71875,
                filters=(), agc_profile="digital", target_block=16512, blocks=16), 5e3)


@pytest.mark.parametrize("out", ["cf32", "cs16"])
@pytest.mark.parametrize("case", range(10))
def test_fuzz_cases_vs_jax(case, out):
    """tests/test_chain_fuzz.py's eight CASES, FULL4_CASE (case 8) and
    AM_CASE (case 9), 2 channels x 4 carried blocks at an 8192-frame
    target (AM_CASE its own rate, block and blocks), the same
    band-limited noise through both packages.  cs16: cases 5 and 6
    byte-identical; without the DC blocker within 1 code on <= 0.1 % of
    the items; with it, or with an AGC past its start-up, >= 60 dB and 1
    code on <= 1 %.  cf32: >= 90 dB.  The pre-NCO's phase and the I/Q
    estimator's factors (to 1e-5, as tests/test_torch_general.py holds
    them) and counter as the JAX chain's; an AGC's state to 1e-5 of
    each field (float32 peaks and energies summed in another order)."""
    import scipy.signal as sig

    from tests.test_chain_fuzz import CASES
    kw, center = (CASES + [FULL4_CASE, AM_CASE])[case]
    kw = dict(kw)
    filters = kw.pop("filters")
    blocks = kw.pop("blocks", 4)
    base = dict(dict(output_format=out, input_rate=IN_RATE, channels=2, target_block=8192),
                **kw)
    jc = JaxChain(JaxConfig(filters=filters, **base))
    pc = Chain(ChainConfig(filters=tuple(FilterRequest(f.type, f.freq1_hz, f.freq2_hz)
                                         for f in filters), **base), device="cpu")
    rng = np.random.default_rng(1234)
    n = jc.n_in * blocks
    z = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    lim = 0.08 * min(jc.cfg.input_rate, jc.cfg.output_rate) / jc.cfg.input_rate
    z = sig.lfilter(sig.firwin(257, lim), [1.0], z, axis=-1)
    z = z * np.exp(2j * np.pi * center / jc.cfg.input_rate * np.arange(n))
    z = (0.4 * z / np.abs(z).max()).astype(np.complex64)
    wire = np.stack([np.asarray(ref_dsp.from_cf32(z[c], jc.cfg.input_format))
                     for c in range(2)])
    jcarry, want = _run_jax(jc, wire, range(blocks))
    pcarry, got = _run_port(pc, wire, range(blocks))
    # an AGC starts from gain 1 and lifts the notch's start-up ramp (~1e-5
    # of full scale) until either package's float32 FFT rounding shows:
    # its first 4096 output frames are left out (as benchmark/harness/
    # check.py leaves them out), and past them its gain lifts that
    # rounding into code flips as the DC blocker's recurrence does
    skip = 4096 * 2 if kw.get("agc_profile") else 0
    lifted = kw.get("dc_block") or kw.get("agc_profile")
    got, want = got[:, skip:], want[:, skip:]
    d = got.astype(np.float64) - want.astype(np.float64)
    snr = 10 * np.log10((want.astype(np.float64) ** 2).mean() / max((d ** 2).mean(), 1e-300))
    if out == "cf32":
        assert snr >= 90.0, snr
    elif case in (5, 6):
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(d).max() <= 1
        assert (d != 0).mean() <= (1e-2 if lifted else 1e-3), (d != 0).mean()
        if lifted:
            assert snr >= 60.0, snr
    pnp = carry_to_numpy(pcarry)
    np.testing.assert_array_equal(pnp["nco_pre"], np.asarray(jcarry["nco_pre"]))
    if "iq" in pnp:
        np.testing.assert_allclose(pnp["iq"][0], np.asarray(jcarry["iq"].factors),
                                   rtol=0, atol=1e-5)
        assert pnp["iq"][1] == np.asarray(jcarry["iq"].samples_since_opt)
    if "agc" in pnp:
        for mine, theirs in zip(pnp["agc"], jcarry["agc"]):
            np.testing.assert_allclose(np.asarray(mine, np.float64),
                                       np.asarray(theirs, np.float64), rtol=1e-5, atol=0)
