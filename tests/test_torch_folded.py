"""The port's time fold (``FoldedChain``, ``--time-fold``) against the
JAX package's on the CPU (its XLA path, as tests/test_folded.py runs it),
with that file's configurations, and against the port's own row chain
run F times per folded block.

Bounds (tests/test_folded.py's): without the DC blocker max |delta| <= 1
code on < 0.1 % of samples; with it >= 60 dB and <= 32 codes.  Between
the packages the unfolded chains already differ by 1 code on ~0.1 % of
these samples (their NCO, AGC and product roundings), so there the
fold's bound is 1 code on at most that share plus 0.1 %.  The CLI
against the JAX CLI within 4 codes, as the other CLI tests allow.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iq_tool_tpu.cli import main as jax_main  # noqa: E402
from iq_tool_tpu.ops.fir_design import FilterRequest as JaxFilter  # noqa: E402
from iq_tool_tpu.pipeline.chain import Chain as JaxChain  # noqa: E402
from iq_tool_tpu.pipeline.chain import ChainConfig as JaxConfig  # noqa: E402
from iq_tool_tpu.pipeline.folded import FoldedChain as JaxFolded  # noqa: E402
from iq_tool_tpu_torch.cli import main as port_main  # noqa: E402
from iq_tool_tpu_torch.ops.fir_design import FilterRequest  # noqa: E402
from iq_tool_tpu_torch.pipeline.chain import Chain, ChainConfig, carry_to_numpy  # noqa: E402
from iq_tool_tpu_torch.pipeline.folded import FoldedChain, auto_fold  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfgs(channels=1, block=2048, dc=True, **kw):
    """(JAX config, port config) of tests/test_folded.py's ``_cfg``."""
    base = dict(input_format="cs16", output_format="cs16",
                input_rate=2_048_000.0, target_rate=1_488_375.0,
                channels=channels, dc_block=dc,
                freq_shift_pre_hz=150_000.0, freq_shift_post_hz=-25_000.0,
                agc_profile="local", target_block=block)
    base.update(kw)
    return (JaxConfig(filters=[JaxFilter("lowpass", 400_000.0)], **base),
            ChainConfig(filters=(FilterRequest("lowpass", 400_000.0),), **base))


def _raws(n_blocks, fc, rng):
    return [rng.integers(-2 ** 14, 2 ** 14, (fc.channels, fc.in_wire_len)).astype(np.int16)
            for _ in range(n_blocks)]


def _run_jax(fc, raws, reset_idx=None):
    carry = fc.init_carry()
    outs = []
    for i, raw in enumerate(raws):
        carry, out = fc.step(carry, raw, np.bool_(reset_idx == i))
        outs.append(np.asarray(out))
    return np.concatenate(outs, axis=-1)


def _run_port(fc, raws, reset_idx=None, carries=None):
    carry = fc.init_carry()
    outs = []
    for i, raw in enumerate(raws):
        carry, out = fc.step(carry, torch.from_numpy(raw), reset_idx == i)
        outs.append(out.numpy())
        if carries is not None:
            carries.append(carry_to_numpy(carry))
    return np.concatenate(outs, axis=-1)


def _sequential(cfg, raws, fold, reset_idx=None):
    """The port's row-block chain fed each folded block in F slices
    (tests/test_folded.py's ``_sequential``)."""
    single = Chain(cfg, device="cpu")
    carry = single.init_carry()
    outs = []
    w = single.in_wire_len
    for i, raw in enumerate(raws):
        for j in range(fold):
            carry, out = single.step(carry, torch.from_numpy(raw[:, j * w:(j + 1) * w]),
                                     reset_idx == i and j == 0)
            outs.append(out.numpy())
    return np.concatenate(outs, axis=-1)


def _jax_sequential(cfg, raws, fold, reset_idx=None):
    single = JaxChain(cfg)
    carry = single.init_carry()
    outs = []
    w = single.in_wire_len
    for i, raw in enumerate(raws):
        for j in range(fold):
            carry, out = single.step(carry, raw[:, j * w:(j + 1) * w],
                                     np.bool_(reset_idx == i and j == 0))
            outs.append(np.asarray(out))
    return np.concatenate(outs, axis=-1)


def _differing(got, want) -> float:
    return float((got.astype(np.int32) != want.astype(np.int32)).mean())


def _assert_codes(got, want, max_code=1, frac=1e-3):
    assert got.shape == want.shape
    diff = got.astype(np.int32) - want.astype(np.int32)
    assert np.abs(diff).max() <= max_code, np.abs(diff).max()
    assert (diff != 0).mean() < frac, (diff != 0).mean()


def _assert_snr(got, want, db=60.0, max_code=32):
    diff = got.astype(np.float64) - want.astype(np.float64)
    snr = 10 * np.log10((want.astype(np.float64) ** 2).mean()
                        / ((diff ** 2).mean() + 1e-30))
    assert snr > db, snr
    assert np.abs(diff).max() <= max_code, np.abs(diff).max()


@pytest.mark.parametrize("case", [
    dict(channels=1, dc=False, fold=8, reset=None),
    dict(channels=2, dc=False, fold=4, reset=None),
    dict(channels=1, dc=False, fold=8, reset=1),
], ids=["no-dc", "two-channels", "reset"])
def test_folded_vs_jax_folded(rng, case):
    """tests/test_folded.py:67, :89 and :98: the port's fold against its
    own row chain run F times (the fold contract), and against the JAX
    fold, beside the two packages' unfolded row chains."""
    jcfg, pcfg = _cfgs(channels=case["channels"], dc=case["dc"])
    fold, reset = case["fold"], case["reset"]
    jf, pf = JaxFolded(jcfg, fold), FoldedChain(pcfg, fold, device="cpu")
    assert (pf.n_in, pf.n_out, pf.in_wire_len) == (jf.n_in, jf.n_out, jf.in_wire_len)
    raws = _raws(3 if case["channels"] == 1 else 2, pf, rng)
    got = _run_port(pf, raws, reset)
    seq = _sequential(pcfg, raws, fold, reset)
    _assert_codes(got, seq)
    unfolded_gap = _differing(seq, _jax_sequential(jcfg, raws, fold, reset))
    _assert_codes(got, _run_jax(jf, raws, reset), frac=unfolded_gap + 1e-3)


def test_folded_full_chain_snr(rng):
    """tests/test_folded.py:76: the full chain with the DC blocker."""
    jcfg, pcfg = _cfgs(dc=True)
    jf, pf = JaxFolded(jcfg, 8), FoldedChain(pcfg, 8, device="cpu")
    raws = _raws(3, pf, rng)
    got = _run_port(pf, raws)
    _assert_snr(got, _run_jax(jf, raws))
    _assert_snr(got, _sequential(pcfg, raws, 8))


def test_folded_digital_agc_semantics(rng):
    """tests/test_folded.py:125: one peak-lock update per folded step,
    the peak over the block.  The port's gain trajectory is JAX's, and
    its fold equals its unfolded chain at the global block."""
    jcfg, pcfg = _cfgs(dc=False, agc_profile="digital")
    jf, pf = JaxFolded(jcfg, 8), FoldedChain(pcfg, 8, device="cpu")
    raws = _raws(3, pf, rng)
    carries = []
    got = _run_port(pf, raws, carries=carries)
    jcarry = jf.init_carry()
    outs = []
    for raw, pc in zip(raws, carries):
        jcarry, out = jf.step(jcarry, raw, np.bool_(False))
        outs.append(np.asarray(out))
        gain, _, peak_mem, locked, seen, weak = (np.asarray(v) for v in jcarry["agc"])
        np.testing.assert_allclose(pc["agc"][0], gain, rtol=1e-5)
        np.testing.assert_allclose(pc["agc"][2], peak_mem, rtol=1e-5)
        np.testing.assert_array_equal(pc["agc"][3], locked)
        np.testing.assert_array_equal(pc["agc"][4], seen)
        np.testing.assert_array_equal(pc["agc"][5], weak)
    _assert_snr(got, np.concatenate(outs, -1), max_code=1 << 16)
    big = Chain(ChainConfig(**{**pcfg.__dict__, "target_block": pf.n_in}), device="cpu")
    assert big.n_in == pf.n_in
    carry, outs = big.init_carry(), []
    for raw in raws:
        carry, out = big.step(carry, torch.from_numpy(raw))
        outs.append(out.numpy())
    _assert_snr(got, np.concatenate(outs, -1), max_code=1 << 16)


def test_folded_fft_filter_and_odd_agc_rows(rng):
    """A fold over an overlap-save filter (its window schedule made for
    the global block: the same linear convolution, the FFTs' roundings
    fall elsewhere), and the fold's AGC over rows whose outputs hold no
    whole number of 128-sample segments and over rows that do, against
    the port's row chain run F times."""
    _, pcfg = _cfgs(dc=False, target_rate=None, freq_shift_post_hz=0.0,
                    filter_method="fft", filter_taps=2049, block=4096, agc_profile=None)
    pcfg = ChainConfig(**{**pcfg.__dict__,
                          "filters": (FilterRequest("stop-range", 0.0, 10e3),)})
    pf = FoldedChain(pcfg, 4, device="cpu")
    assert pf.local.pre_filter is not None and not pf.local.pre_filter._exec_banded
    raws = _raws(2, pf, rng)
    _assert_codes(_run_port(pf, raws), _sequential(pcfg, raws, 4), frac=1e-2)
    for kw, odd in ((dict(block=4096), True), (dict(block=4096, target_rate=None), False)):
        _, pcfg = _cfgs(dc=False, **kw)
        pf = FoldedChain(pcfg, 3, device="cpu")
        assert bool(pf.local.n_out % 128) == odd
        raws = _raws(2, pf, rng)
        _assert_codes(_run_port(pf, raws), _sequential(pcfg, raws, 3))


def test_auto_fold():
    assert [auto_fold(c) for c in (1, 2, 8, 128)] == [8, 4, 1, 1]


def test_folded_rejects_tail_wider_than_row():
    """tests/test_folded.py:180: a 3001-tap FIR's tail is wider than the
    2048-frame row, valid unfolded, refused folded."""
    cfg = ChainConfig(input_format="cs16", output_format="cs16",
                      input_rate=2_048_000.0, target_rate=None,
                      filters=(FilterRequest("lowpass", 400_000.0),),
                      filter_method="fir", filter_taps=3001, target_block=2048)
    Chain(cfg, device="cpu")
    FoldedChain(cfg, 1, device="cpu")
    with pytest.raises(ValueError, match="time-fold"):
        FoldedChain(cfg, 8, device="cpu")
    with pytest.raises(ValueError, match="fold must be"):
        FoldedChain(cfg, 0, device="cpu")


def test_cli_time_fold_conflicts_with_mesh(tmp_path, rng, capsys):
    """tests/test_folded.py:196."""
    inp = tmp_path / "in.raw"
    rng.integers(-100, 100, 4096).astype(np.int16).tofile(str(inp))
    with pytest.raises(SystemExit) as e:
        port_main(["-i", "raw-file", "-o", "raw", str(inp), str(tmp_path / "out.raw"),
                   "--raw-file-input-rate", "2048000",
                   "--raw-file-input-sample-format", "cs16",
                   "--output-rate", "1488375", "--output-sample-format", "cs16",
                   "--mesh-time", "2", "--time-fold", "8", "--force-overwrite",
                   "--device", "cpu"])
    assert e.value.code != 0
    assert "--time-fold does not combine" in capsys.readouterr().err


def _tone_file(path, n):
    i = np.arange(n, dtype=np.float64)
    x = 0.4 * np.exp(2j * np.pi * 80e3 * i / 2.048e6)
    raw = np.empty(2 * n, np.int16)
    raw[0::2] = np.rint(32767 * x.real)
    raw[1::2] = np.rint(32767 * x.imag)
    raw.tofile(str(path))


FLAGS = ["-i", "raw-file", "-o", "raw", "--raw-file-input-rate", "2048000",
         "--raw-file-input-sample-format", "cs16", "--output-rate", "1488375",
         "--dc-block", "--freq-shift", "30e3", "--lowpass", "400e3",
         "--force-overwrite", "--device", "cpu"]


def test_checkpoint_interchange_folded_unfolded(tmp_path):
    """tests/test_folded.py:210: a checkpoint of an unfolded run resumes
    under --time-fold 8 (both carries are the row chain's), and the
    result matches the uninterrupted run within the fold contract."""
    n = 16384 * 4
    inp = tmp_path / "in.raw"
    _tone_file(inp, n)
    full = tmp_path / "full.raw"
    assert port_main(FLAGS + ["--time-fold", "1", str(inp), str(full)]) == 0
    cut = 16384 * 2 + 5000
    half = tmp_path / "half.raw"
    half.write_bytes(inp.read_bytes()[:cut * 4])
    part, ckpt = tmp_path / "part.raw", tmp_path / "state.ckpt"
    assert port_main(FLAGS + ["--time-fold", "1", str(half), str(part),
                              "--checkpoint", str(ckpt)]) == 0
    assert port_main(FLAGS + ["--time-fold", "8", str(inp), str(part),
                              "--checkpoint", str(ckpt), "--resume"]) == 0
    a = np.frombuffer(part.read_bytes(), np.int16)
    b = np.frombuffer(full.read_bytes(), np.int16)
    assert len(a) == len(b) == 2 * (n * 11907 // 16384)
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert d.max() <= 32 and (d != 0).mean() < 0.01


def test_cli_time_fold_vs_jax(tmp_path, rng):
    """--time-fold 4 through the port's CLI (a subprocess, as a user runs
    it) against the JAX CLI's --time-fold 4; both against their unfolded
    runs' length (tests/test_folded.py:155)."""
    n = 300_000
    inp = tmp_path / "in.raw"
    rng.integers(-2 ** 14, 2 ** 14, 2 * n).astype(np.int16).tofile(str(inp))
    argv = ["-i", "raw-file", "-o", "raw", "--raw-file-input-rate", "2048000",
            "--raw-file-input-sample-format", "cs16", "--output-rate", "1488375",
            "--output-sample-format", "cs16", "--freq-shift", "-100e3",
            "--lowpass", "400000", "--force-overwrite", "--time-fold", "4"]
    out_j, out_p = tmp_path / "jax.raw", tmp_path / "port.raw"
    assert jax_main(argv + [str(inp), str(out_j)]) == 0
    res = subprocess.run([sys.executable, "-m", "iq_tool_tpu_torch", *argv, str(inp),
                          str(out_p), "--device", "cpu"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    a = np.frombuffer(out_p.read_bytes(), np.int16)
    b = np.frombuffer(out_j.read_bytes(), np.int16)
    assert len(a) == len(b) == 2 * (n * 11907 // 16384)
    assert int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max()) <= 4


def test_folded_out_wire_dtype():
    """FoldedChain's out_wire_dtype is the reference fold's (and its row
    chain's)."""
    for fmt in ("cs16", "cu8", "cf32"):
        jcfg, pcfg = _cfgs(output_format=fmt)
        pf = FoldedChain(pcfg, 2, device="cpu")
        assert pf.out_wire_dtype == JaxFolded(jcfg, 2).out_wire_dtype == pf.local.out_wire_dtype


@pytest.mark.parametrize("seed", range(25))
def test_fuzz_folded_vs_chain(seed):
    """tests/test_chain_fuzz.py:238: a random chain folded F times (the
    same draws), against the port's row chain fed each folded block in F
    slices (at the global block for the digital AGC, one update a folded
    step)."""
    from tests.test_chain_fuzz import _assert_parity, _draw_cfg, _fuzz_raw
    rs = np.random.default_rng(1000 + seed)
    jcfg = _draw_cfg(rs, channels=1)
    cfg = ChainConfig(**{**jcfg.__dict__, "filters": tuple(
        FilterRequest(f.type, f.freq1_hz, f.freq2_hz) for f in jcfg.filters)})
    fold = int(rs.choice([2, 4, 8]))
    fc = FoldedChain(cfg, fold, device="cpu")
    raws = [_fuzz_raw(cfg, fc.in_wire_len, 1, rs) for _ in range(2)]
    got = _run_port(fc, raws)
    if cfg.agc_profile == "digital":
        big = Chain(ChainConfig(**{**cfg.__dict__, "target_block": fc.n_in}), device="cpu")
        assert big.n_in == fc.n_in
        want = _sequential(big.cfg, raws, 1)
    else:
        want = _sequential(cfg, raws, fold)
    _assert_parity(got, want, (seed, cfg, fold))
