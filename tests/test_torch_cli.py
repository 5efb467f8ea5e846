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

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iq_tool_tpu.cli import main as jax_main  # noqa: E402
from iq_tool_tpu_torch.cli import build_chain, build_parser, config_from_args  # noqa: E402
from iq_tool_tpu_torch.cli import main as port_main  # noqa: E402

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
