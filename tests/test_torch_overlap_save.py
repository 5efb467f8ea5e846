"""Overlap-save windows above K5's largest (``kernels.OSFFT_MAX_NFFT``
points): the port's torch.fft route (``ops/filters.py``
``overlap_save_fft``, the reference's XLA overlap-save) on the CPU.

* against the K5 kernel's plain twin ``osfft_apply_ref`` at >= 100 dB,
  on blocks that the filter block divides and on ragged ones;
* BASELINE config #4 at ``--filter-fft-size 131072`` (nfft 131072), 2
  channels over 3 carried blocks, against the JAX chain (its XLA
  overlap-save) at tests/test_torch_general.py's bound, the route's own
  counter moving once a step;
* the chains the profiler and chip_smoke.py measure besides
  tests/test_torch_general.py's: configs #1 and #2 and config #4's
  variants, as BASELINE and the CLI define them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iq_tool_tpu.pipeline.chain import Chain as JaxChain  # noqa: E402
from iq_tool_tpu_torch import profile_steps  # noqa: E402
from iq_tool_tpu_torch.ops import filters, kernels  # noqa: E402
from iq_tool_tpu_torch.pipeline.chain import Chain, carry_to_numpy  # noqa: E402
from tests.test_torch_general import (CONFIG4, _configs, _max_dcode, _ramp_items,  # noqa: E402
                                      _run_jax, _run_port, _wire)


def _windows(n, b):
    """The twin's schedule of half-advance windows and the re-anchored
    ragged tail."""
    return kernels.Windows.build(*filters.osfft_windows(n, b, (b,)), "cpu")


def _snr_db(want, got):
    want, got = want.double(), got.double()
    return 10 * np.log10(float((want ** 2).mean()) / max(float(((want - got) ** 2).mean()),
                                                         1e-300))


@pytest.mark.parametrize("n_of_b", [2, 2.907], ids=["n=2b", "ragged"])
def test_route_matches_twin_at_nfft_131072(rng, n_of_b):
    """A 2175-tap notch at --filter-fft-size 131072 (b = 65536): the
    filter takes the route, not K5, and agrees with K5's twin over the
    same tail and block at >= 100 dB."""
    taps = profile_steps.config("4k128", 2).filters
    chain = Chain(profile_steps.config("4k128", 2, 131072), device="cpu")
    filt = chain.post_filter
    assert taps and filt.nfft == 131072 > kernels.OSFFT_MAX_NFFT
    b, n = filt.block, int(n_of_b * filt.block)
    xr, xi, tr, ti = (torch.from_numpy(rng.standard_normal((2, m)).astype(np.float32))
                      for m in (n, n, b, b))
    before = dict(kernels.launch_counts())
    yr, yi, nr, ni = filt.apply_planar(xr, xi, tr, ti)
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "overlap_save_fft": 1}
    want = kernels.osfft_apply_ref(xr, xi, filt._h, b, windows=_windows(n, b), tail=(tr, ti))
    assert _snr_db(want[0], yr) >= 100.0 and _snr_db(want[1], yi) >= 100.0
    assert torch.equal(nr, xr[:, -b:]) and torch.equal(ni, xi[:, -b:])


@pytest.mark.parametrize("n", [4 * 4096, 4 * 4096 + 1234], ids=["divides", "ragged"])
def test_route_matches_twin_small(rng, n):
    """The route alone at b = 4096 (complex taps), against the twin's
    re-anchored windows at >= 100 dB."""
    taps = (rng.standard_normal(3001) + 1j * rng.standard_normal(3001)).astype(np.complex64)
    b = 4096
    h = np.fft.fft(taps, 2 * b).astype(np.complex64)
    xr, xi, tr, ti = (torch.from_numpy(rng.standard_normal((3, m)).astype(np.float32))
                      for m in (n, n, b, b))
    yr, yi, _, _ = filters.overlap_save_fft(xr, xi, tr, ti, torch.from_numpy(h), b)
    want = kernels.osfft_apply_ref(xr, xi, h, b, windows=_windows(n, b), tail=(tr, ti))
    assert yr.shape == (3, n)
    assert _snr_db(want[0], yr) >= 100.0 and _snr_db(want[1], yi) >= 100.0


def test_config4_at_nfft_131072_matches_jax(rng):
    """Config #4 with --filter-fft-size 131072, 2 channels, 3 carried
    blocks: within 4 codes of the JAX chain past the notch's start-up
    ramp, the NCO, I/Q and notch carries equal or as close as the two
    packages' products, the route once a step and K5 never."""
    jcfg, pcfg = _configs(131072, **CONFIG4, filter_fft_size=131072)
    jc, pc = JaxChain(jcfg), Chain(pcfg, device="cpu")
    assert (jc.n_in, jc.n_out) == (pc.n_in, pc.n_out)
    assert pc.post_filter.nfft == 131072 and not pc.post_filter._exec_banded
    raw = _wire(rng, "cs16", 2, 3 * jc.n_in)
    jcarry, want = _run_jax(jc, raw, range(3))
    kernels.reset_launch_counts()
    pcarry, got = _run_port(pc, raw, range(3))
    counts = kernels.launch_counts()
    assert counts["overlap_save_fft"] == 3 and counts["osfft_apply"] == 0
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _max_dcode(got, want, _ramp_items(pc)) <= 4
    pnp = carry_to_numpy(pcarry)
    np.testing.assert_array_equal(pnp["nco_post"], np.asarray(jcarry["nco_post"]))
    np.testing.assert_allclose(pnp["iq"][0], np.asarray(jcarry["iq"].factors),
                               rtol=0, atol=1e-5)
    # the notch's carried input tail: the resampler's output, as close as
    # the two packages' products
    np.testing.assert_allclose(np.asarray(pnp["post_f"]), np.asarray(jcarry["post_f"]),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["1", "2", "4k128", "4dx", "4dig"])
def test_added_measured_configs_are_baseline(name):
    """Configs #1 and #2 (tools/bench_all.py) and config #4 at
    --filter-fft-size 131072 and with the dx and digital AGC profiles."""
    want = {"1": dict(),
            "2": dict(freq_shift_pre_hz=250e3, req=("lowpass", 400e3, 0.0)),
            "4k128": dict(CONFIG4, filter_fft_size=131072),
            "4dx": dict(CONFIG4, agc_profile="dx"),
            "4dig": dict(CONFIG4, agc_profile="digital")}[name]
    _, cfg = _configs(16384, **want)
    assert profile_steps.config(name, 2, 16384) == cfg
