"""The port's CLI against the JAX package's on the CPU for the general
step's flags: I/Q correction with its pre-stream calibration, a notch,
the shift moved after the resampler, and the output AGC; written as
tests/test_cli.py writes its cases.

Bound: the chain's, max |delta code| <= 4, past the notch's start-up
ramp (tests/test_torch_general.py says why those first frames differ).
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iq_tool_tpu.cli import main as jax_main  # noqa: E402
from iq_tool_tpu_torch.cli import build_chain, build_parser, config_from_args  # noqa: E402
from iq_tool_tpu_torch.cli import main as port_main  # noqa: E402
from tests import ref_dsp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN_RATE = 2_048_000.0

BASE = ["-i", "raw-file", "-o", "raw", "--raw-file-input-rate", "2048000",
        "--raw-file-input-sample-format", "cs16", "--output-rate", "1488375"]
GENERAL = ["--dc-block", "--iq-correction", "--stopband", "0:10000",
           "--freq-shift", "-50000", "--shift-after-resample", "--output-agc",
           "--agc-profile", "local"]
NOTCH_RAMP = 2 * (2175 // 2)            # output items of the notch's ramp


def _tone_file(path, rng, frames, tone_hz=137e3, imbalance=(1.01, 0.01)):
    """A tone inside the I/Q estimator's band (5-95 % of Nyquist) behind
    an I/Q imbalance, plus a little noise, as a cs16 file."""
    k = np.arange(frames)
    x = 0.5 * np.exp(2j * np.pi * tone_hz / IN_RATE * k)
    g, phi = imbalance
    pairs = np.stack([x.real * g, x.imag + phi * x.real], -1)
    pairs += 1e-4 * rng.standard_normal(pairs.shape)
    path.write_bytes(np.clip(np.round(pairs * 32767), -32768, 32767)
                     .astype(np.int16).tobytes())


def _max_dcode(a, b, skip=0):
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64))[skip:].max())


def test_cli_general_flags_parity(rng, tmp_path):
    """File -> file through both CLIs, the pre-stream calibration
    included; a ragged last block."""
    n = 16384 * 3 + 1000
    inp = tmp_path / "in.raw"
    _tone_file(inp, rng, n)
    out_j, out_p = tmp_path / "jax.raw", tmp_path / "port.raw"
    assert jax_main([str(inp), str(out_j), *BASE, *GENERAL]) == 0
    res = subprocess.run([sys.executable, "-m", "iq_tool_tpu_torch", str(inp),
                          str(out_p), *BASE, *GENERAL, "--device", "cpu"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    want = np.frombuffer(out_j.read_bytes(), np.int16)
    got = np.frombuffer(out_p.read_bytes(), np.int16)
    assert got.size == want.size == 2 * (n * 11907 // 16384)
    assert _max_dcode(got, want, NOTCH_RAMP) <= 4


def _open(inp, tmp_path, flags):
    """(config, chain, source) as the CLI builds them for `flags`."""
    from iq_tool_tpu.modules import get_input
    from iq_tool_tpu_torch.config import resolve_rates
    args = build_parser().parse_args([str(inp), str(tmp_path / "o.raw"), *flags])
    cfg = config_from_args(args)
    src = get_input(cfg.input_type)
    info = src.initialize(cfg, args)
    resolve_rates(cfg, info.sample_rate, info.sample_format)
    return cfg, build_chain(cfg, 16384, channels=1, device="cpu"), src


def test_cli_calibration_and_shift_mapping(rng, tmp_path):
    """--shift-after-resample moves the shift to the post-NCO; the
    calibrated carry holds factors that undo the file's imbalance."""
    from iq_tool_tpu_torch.cli import calibrate_carry
    inp = tmp_path / "in.raw"
    _tone_file(inp, rng, 8192)
    cfg, chain, src = _open(inp, tmp_path, [*BASE, *GENERAL])
    try:
        assert cfg.iq_correction and cfg.output_agc and cfg.shift_after_resample
        assert chain.dtheta_pre == 0 and chain.dtheta_post != 0
        assert chain.agc_cfg.profile == "local"
        carry = calibrate_carry(chain, [src], cfg.gain)
    finally:
        src.close()
    f = carry["iq"].factors.numpy()
    assert (f[:, 0] < 0).all() and (f[:, 1] < 0).all()      # toward I/1.01, Q - 0.01 I
    assert int(carry["agc"].samples_seen[0]) == 0


def test_cli_no_resample_general(rng, tmp_path):
    """--no-resample with the general flags: the notch runs at the input
    rate and the output has exactly the input's frames."""
    n = 16384 * 2 + 333
    inp = tmp_path / "in.raw"
    _tone_file(inp, rng, n)
    out_p, out_j = tmp_path / "port.raw", tmp_path / "jax.raw"
    flags = [*BASE[:-2], *GENERAL, "--no-resample"]       # no --output-rate
    assert port_main([str(inp), str(out_p), *flags, "--device", "cpu"]) == 0
    assert jax_main([str(inp), str(out_j), *flags]) == 0
    got = np.frombuffer(out_p.read_bytes(), np.int16)
    want = np.frombuffer(out_j.read_bytes(), np.int16)
    assert got.size == want.size == 2 * n
    _, chain, src = _open(inp, tmp_path, flags)
    src.close()
    assert chain.resampler is None
    assert _max_dcode(got, want, 2 * (chain.pre_filter.num_taps // 2)) <= 4


# ------------------------------------------- checkpoint, resume, profile

CKPT_FLAGS = ["-i", "raw-file", "-o", "raw", "--raw-file-input-rate", "2048000",
              "--raw-file-input-sample-format", "cs16", "--output-rate", "1488375",
              "--dc-block", "--freq-shift", "30e3", "--lowpass", "400e3",
              "--device", "cpu"]


def _raw_tone(path, n, freq=80_000.0):
    t = np.arange(n) / IN_RATE
    x = (0.5 * np.exp(2j * np.pi * freq * t)).astype(np.complex64)
    path.write_bytes(ref_dsp.from_cf32(x, "cs16").tobytes())


@pytest.mark.parametrize("cut_frames", [16384 * 2, 16384 * 2 - 1003])
def test_checkpoint_resume_cli(tmp_path, cut_frames):
    """tests/test_cli.py:159: a run on a cut input with --checkpoint, then
    --resume against the whole input, gives the uninterrupted run's
    bytes; the unaligned cut covers the EOS partial block, whose
    zero-padded step must not reach the checkpoint."""
    inp = tmp_path / "in.raw"
    n = 16384 * 4
    _raw_tone(inp, n)
    full = tmp_path / "full.raw"
    assert port_main(CKPT_FLAGS + [str(inp), str(full)]) == 0
    half_in = tmp_path / "half.raw"
    half_in.write_bytes(inp.read_bytes()[: cut_frames * 4])
    part, ckpt = tmp_path / "part.raw", tmp_path / "state.ckpt"
    assert port_main(CKPT_FLAGS + [str(half_in), str(part), "--checkpoint", str(ckpt)]) == 0
    assert ckpt.exists()
    assert port_main(CKPT_FLAGS + [str(inp), str(part), "--checkpoint", str(ckpt),
                                   "--resume"]) == 0
    assert part.read_bytes() == full.read_bytes()


def test_checkpoint_resume_wav_output(tmp_path):
    """tests/test_cli.py:222: resume into a WAV (RF64) output adopts its
    header and appends."""
    from iq_tool_tpu_torch.io.wav import WavReader, WavWriter
    n, fs = 16384 * 4, 2_048_000
    t = np.arange(n) / fs
    payload = ref_dsp.from_cf32((0.4 * np.exp(2j * np.pi * 90_000.0 * t))
                                .astype(np.complex64), "cs16").tobytes()
    inp, half = tmp_path / "in.wav", tmp_path / "half.wav"
    for path, data in ((inp, payload), (half, payload[: len(payload) // 2])):
        with WavWriter(str(path), fs, "cs16", container="wav") as w:
            w.write(data)
    base = ["-i", "wav", "-o", "wav", "--output-rate", "1488375", "--device", "cpu"]
    full, part, ck = tmp_path / "full.wav", tmp_path / "part.wav", tmp_path / "c.ckpt"
    assert port_main(base + [str(inp), str(full)]) == 0
    assert port_main(base + [str(half), str(part), "--checkpoint", str(ck)]) == 0
    assert port_main(base + [str(inp), str(part), "--checkpoint", str(ck), "--resume"]) == 0
    rf, rp = WavReader(str(full)), WavReader(str(part))
    try:
        assert rf.info.frames == rp.info.frames
        assert rf.read_frames(rf.info.frames) == rp.read_frames(rp.info.frames)
    finally:
        rf.close()
        rp.close()


def test_crash_resume_truncates_stale_output(tmp_path):
    """tests/test_cli.py:268: output written after the last checkpoint (a
    crash) is truncated on resume, not duplicated."""
    inp = tmp_path / "in.raw"
    n = 16384 * 4
    _raw_tone(inp, n)
    flags = CKPT_FLAGS[:10] + ["--device", "cpu"]          # no DC, shift, filter
    full = tmp_path / "full.raw"
    assert port_main(flags + [str(inp), str(full)]) == 0
    half_in, part, ckpt = tmp_path / "half.raw", tmp_path / "part.raw", tmp_path / "s.ckpt"
    half_in.write_bytes(inp.read_bytes()[: n // 2 * 4])
    assert port_main(flags + [str(half_in), str(part), "--checkpoint", str(ckpt)]) == 0
    with open(part, "ab") as f:
        f.write(b"\x55\xaa" * 2048)
    assert port_main(flags + [str(inp), str(part), "--checkpoint", str(ckpt), "--resume"]) == 0
    assert part.read_bytes() == full.read_bytes()


def test_profile_dir_writes_a_trace(tmp_path):
    """--profile-dir on the CPU: a Chrome/Perfetto trace JSON naming the
    chain's torch ops and the engine's spans, the reader's and the
    writer's among them (the profiler records every thread)."""
    import json
    inp = tmp_path / "in.raw"
    _raw_tone(inp, 16384 * 2 + 100)
    prof = tmp_path / "prof"
    assert port_main(CKPT_FLAGS + [str(inp), str(tmp_path / "o.raw"),
                                   "--profile-dir", str(prof)]) == 0
    (trace,) = prof.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names), sorted(map(str, names))[:20]
    assert {"engine.assemble", "engine.write", "engine.step", "chain.resample.0"} <= names


def test_cli_gather_ratio_vs_jax(tmp_path, rng):
    """--output-rate 25282.56 (2469/200000 -> 449/36371, the gather
    stage) with --dc-block and the output AGC through both CLIs."""
    n = 36371 * 3 + 5000
    inp = tmp_path / "in.raw"
    _tone_file(inp, rng, n, tone_hz=4e3)
    flags = [*BASE[:-1], "25282.56", "--dc-block", "--output-agc", "--agc-profile", "local"]
    out_j, out_p = tmp_path / "jax.raw", tmp_path / "port.raw"
    assert jax_main([str(inp), str(out_j), *flags]) == 0
    assert port_main([str(inp), str(out_p), *flags, "--device", "cpu"]) == 0
    want = np.frombuffer(out_j.read_bytes(), np.int16)
    got = np.frombuffer(out_p.read_bytes(), np.int16)
    assert got.size == want.size == 2 * (n * 449 // 36371)
    assert _max_dcode(got, want) <= 4


# --------------------------------------------- watchdog and sink finalize

def _live_tone(monkeypatch, started):
    """Register a live (realtime) tone source with a heartbeat, and a
    Watchdog stand-in that records its start and stop."""
    from iq_tool_tpu_torch import modules
    from iq_tool_tpu_torch.modules.input_tone import ToneInput
    from iq_tool_tpu_torch.utils import watchdog

    class LiveTone(ToneInput):
        is_realtime = True

        def blocks(self, frames_per_block):
            for b in super().blocks(frames_per_block):
                self.heartbeat = time.monotonic()
                yield b

    class Recorder:
        def __init__(self, heartbeat_fn):
            self.heartbeat_fn = heartbeat_fn
            started.append(self)
            self.events = []

        def start(self):
            self.events.append("start")

        def stop(self):
            self.events.append("stop")

    monkeypatch.setitem(modules.INPUT_MODULES, "tone", LiveTone)
    LiveTone.heartbeat = 0.0
    monkeypatch.setattr(watchdog, "Watchdog", Recorder)


LIVE = ["-i", "tone", "-o", "raw", "--tone-rate", "2048000", "--tone-seconds", "0.02",
        "--no-resample", "--device", "cpu", "--force-overwrite"]


def test_watchdog_on_live_sources(tmp_path, monkeypatch):
    """The CLI starts the watchdog on a realtime source with a heartbeat,
    stops it before finalize; --no-watchdog starts none."""
    started = []
    _live_tone(monkeypatch, started)
    assert port_main(["tone", str(tmp_path / "a.raw"), *LIVE]) == 0
    assert len(started) == 1 and started[0].events[:2] == ["start", "stop"]
    assert set(started[0].events[2:]) <= {"stop"}
    assert started[0].heartbeat_fn() > 0
    assert port_main(["tone", str(tmp_path / "b.raw"), *LIVE, "--no-watchdog"]) == 0
    assert len(started) == 1


def test_each_sink_finalizes_and_the_stream_error_shows(tmp_path, monkeypatch, rng, capsys):
    """One sink whose finalize fails neither skips the other sinks'
    finalize nor hides the stream's own error, and the watchdog is
    stopped before any finalize."""
    from iq_tool_tpu_torch.modules.output_raw import RawFileOutput
    started, calls = [], []
    _live_tone(monkeypatch, started)
    orig = RawFileOutput.finalize

    def finalize(self):
        calls.append(list(started[0].events) if started else None)
        orig(self)
        if len(calls) == 1:
            raise OSError("finalize boom")

    monkeypatch.setattr(RawFileOutput, "finalize", finalize)
    # two channels of a file source: both sinks finalize though the first fails
    for c in range(2):
        (tmp_path / f"in_{c}.raw").write_bytes(
            rng.integers(-3000, 3000, 2 * 20000, dtype=np.int16).tobytes())
    assert port_main([str(tmp_path / "in_{ch}.raw"), str(tmp_path / "out_{ch}.raw"),
                      *BASE, "--channels", "2", "--device", "cpu"]) == 0
    assert len(calls) == 2
    assert "finalize failed: finalize boom" in capsys.readouterr().err
    # a live stream whose source fails: its error is the one reported,
    # and the watchdog was stopped before the failing finalize ran
    calls.clear()
    from iq_tool_tpu_torch.modules.input_tone import ToneInput

    def failing_blocks(self, frames_per_block):
        raise OSError("source gone")
        yield

    monkeypatch.setattr(ToneInput, "blocks", failing_blocks)
    assert port_main(["tone", str(tmp_path / "c.raw"), *LIVE]) == 1
    err = capsys.readouterr().err
    assert "error: source gone" in err and "finalize failed: finalize boom" in err
    assert calls == [["start", "stop"]]
