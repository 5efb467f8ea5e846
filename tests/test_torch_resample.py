"""The port's gather resampler stage (``_ArbStage``, for ratios whose
rationalization keeps a prime factor above 512) against the JAX
package's on the CPU: the plan bit for bit, the stage over carried
blocks, the alias-rejection and in-band cases of tests/test_resample.py,
and a chain with that ratio (DC + local AGC) against JAX ``Chain.step``.

The port computes the stage as weighted bag sums (``embedding_bag``),
JAX as a gather and an einsum.  Bounds: the stage >= 100 dB against JAX with
tails equal to 1e-6; the chain within 4 codes, as the other chain tests
allow.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iq_tool_tpu.ops import resample as jrs  # noqa: E402
from iq_tool_tpu.pipeline.chain import Chain as JaxChain  # noqa: E402
from iq_tool_tpu.pipeline.chain import ChainConfig as JaxConfig  # noqa: E402
from iq_tool_tpu_torch.ops import resample as prs  # noqa: E402
from iq_tool_tpu_torch.pipeline.chain import Chain, ChainConfig  # noqa: E402
from tests import ref_dsp  # noqa: E402

RATIO = 2469.0 / 200000.0          # 449/36371; 36371 = 37 * 983
IN_RATE = 2_048_000.0


def _resamplers(block=16384):
    j = jrs.Resampler(RATIO, target_block=block)
    p = prs.Resampler(RATIO, target_block=block)
    p.bind("cpu")
    return j, p


def _port_run(r, x_blocks, channels=1):
    """The port's resampler over complex (C, n_in) blocks with its carry."""
    state = r.init_planar(channels)
    outs = []
    for x in x_blocks:
        xr = torch.from_numpy(np.ascontiguousarray(x.real, np.float32))
        xi = torch.from_numpy(np.ascontiguousarray(x.imag, np.float32))
        (yr, yi), state = r.apply_planar(xr, xi, state)
        outs.append(yr.numpy() + 1j * yi.numpy())
    return np.concatenate(outs, axis=-1), state


def test_gather_plan_bit_equal():
    j, p = _resamplers()
    assert (p.plan.p, p.plan.q, p.plan.n_in, p.plan.n_out) == (449, 36371, 36371, 449)
    assert p.plan.fallback and j.plan.fallback and p.plan.stages == j.plan.stages
    (js,), (ps,) = j.stages, p.stages
    assert isinstance(ps, prs._ArbStage) and not p.packs
    assert ps.hist == js.plan.history == 1297
    np.testing.assert_array_equal(ps.plan.starts, js.plan.starts)
    np.testing.assert_array_equal(ps.plan.weights, js.plan.weights)


def test_gather_stage_vs_jax_carried_blocks(rng):
    """Three carried blocks of two channels through both stages."""
    j, p = _resamplers()
    (js,), (ps,) = j.stages, p.stages
    n = j.plan.n_in
    jr = ji = np.zeros((2, js.plan.history), np.float32)
    pr, pi = ps.init_planar(2)
    for _ in range(3):
        xr, xi = (rng.standard_normal((2, n)).astype(np.float32) for _ in range(2))
        wr, wi, jr, ji = (np.asarray(a) for a in js.apply_planar(xr, xi, jr, ji))
        (gr, gi), pr, pi = ps.apply_planar(torch.from_numpy(xr), torch.from_numpy(xi),
                                           pr, pi)
        assert ref_dsp.snr_db(wr + 1j * wi, gr.numpy() + 1j * gi.numpy()) >= 100.0
        np.testing.assert_allclose(pr.numpy(), jr, rtol=0, atol=1e-6)
        np.testing.assert_allclose(pi.numpy(), ji, rtol=0, atol=1e-6)


def test_gather_stage_rows_equal_blocks(rng):
    """A block of two row blocks (a time fold) gives the two blocks'
    outputs and the second one's tail, bit for bit."""
    _, p = _resamplers()
    (ps,) = p.stages
    n = p.plan.n_in
    xr, xi = (torch.from_numpy(rng.standard_normal((3, 2 * n)).astype(np.float32))
              for _ in range(2))
    sr, si = (torch.from_numpy(rng.standard_normal((3, ps.hist)).astype(np.float32))
              for _ in range(2))
    (yr, yi), tr, ti = ps.apply_planar(xr, xi, sr, si)
    (ar, ai), ur, ui = ps.apply_planar(xr[:, :n].contiguous(), xi[:, :n].contiguous(),
                                       sr, si)
    (br, bi), vr, vi = ps.apply_planar(xr[:, n:].contiguous(), xi[:, n:].contiguous(),
                                       ur, ui)
    assert torch.equal(yr, torch.cat([ar, br], -1)) and torch.equal(yi, torch.cat([ai, bi], -1))
    assert torch.equal(tr, vr) and torch.equal(ti, vi)
    with pytest.raises(ValueError, match="packed"):
        ps.apply_planar(xr, xi, sr, si, pack_fmt="cs16")


def test_gather_product_is_the_plan(rng):
    """The bag sums compute the plan's definition, output m the dot of
    its K weights with ext[starts[m]:starts[m] + K], here in float64 with
    numpy: >= 120 dB (the float32 sums round), and two runs agree bit
    for bit."""
    _, p = _resamplers()
    (ps,) = p.stages
    n = p.plan.n_in
    xr, xi, sr, si = (rng.standard_normal((2, w)).astype(np.float32)
                      for w in (n, n, ps.hist, ps.hist))
    (yr, yi), _, _ = ps.apply_planar(*(torch.from_numpy(a) for a in (xr, xi, sr, si)))
    ext = np.concatenate([sr, xr], -1) + 1j * np.concatenate([si, xi], -1)
    k = ps.plan.weights.shape[1]
    win = ext[:, ps.plan.starts.astype(np.int64)[:, None] + np.arange(k)]   # (C, M, K)
    want = np.einsum("cmk,mk->cm", win, ps.plan.weights.astype(np.float64))
    assert ref_dsp.snr_db(want, yr.numpy() + 1j * yi.numpy()) >= 120.0
    (ar, ai), _, _ = ps.apply_planar(*(torch.from_numpy(a) for a in (xr, xi, sr, si)))
    assert torch.equal(ar, yr) and torch.equal(ai, yi)


def test_gather_alias_rejection_and_in_band():
    """tests/test_resample.py:121: a tone 8x past the output Nyquist is
    rejected below -50 dB, an in-band tone passes at unity gain."""
    _, p = _resamplers()
    n_in = p.plan.n_in
    blocks = [np.exp(2j * np.pi * 0.05 * np.arange(b * n_in, (b + 1) * n_in))[None, :]
              for b in range(8)]
    y, _ = _port_run(p, blocks)
    y = y[0, y.shape[-1] // 2:]
    assert 10 * np.log10(np.mean(np.abs(y) ** 2) + 1e-30) < -50.0
    f_in = RATIO * 0.1
    blocks = [np.exp(2j * np.pi * f_in * np.arange(b * n_in, (b + 1) * n_in))[None, :]
              for b in range(4)]
    y, _ = _port_run(p, blocks)
    y = y[0]
    skip = min(len(y) // 2, 4096)
    m = np.arange(skip, len(y))
    ideal = np.exp(2j * np.pi * (f_in * p.plan.q / p.plan.p) * m)
    a = np.vdot(ideal, y[skip:]) / np.vdot(ideal, ideal)
    snr = 10 * np.log10(np.mean(np.abs(a * ideal) ** 2)
                        / np.mean(np.abs(y[skip:] - a * ideal) ** 2))
    assert snr > 50.0 and abs(abs(a) - 1.0) < 0.05, (snr, abs(a))


@pytest.mark.parametrize("kw", [dict(dc_block=True, agc_profile="local"),
                                dict(dc_block=True, freq_shift_pre_hz=-3e3),
                                dict(output_format="cf32", dc_block=True)],
                         ids=["dc-local-agc", "dc-shift-packless", "cf32-out"])
def test_gather_chain_vs_jax(rng, kw):
    """cs16 -> DC -> 2469/200000 (gather) -> [AGC] -> wire through both
    chains over 3 carried blocks of 2 channels."""
    base = dict(input_format="cs16", output_format="cs16", input_rate=IN_RATE,
                target_rate=IN_RATE * RATIO, channels=2, target_block=16384)
    base.update(kw)
    jc, pc = JaxChain(JaxConfig(**base)), Chain(ChainConfig(**base), device="cpu")
    assert pc.resampler.plan.fallback and not pc._wire_resample
    assert (pc.n_in, pc.n_out) == (jc.n_in, jc.n_out) == (36371, 449)
    frames = 3 * jc.n_in
    t = np.arange(frames) / IN_RATE
    x = (0.45 * np.exp(2j * np.pi * 4e3 * t)[None, :] + 0.08
         + 0.05 * (rng.standard_normal((2, frames)) + 1j * rng.standard_normal((2, frames))))
    pairs = np.stack([x.real, x.imag], -1).reshape(2, 2 * frames)
    raw = np.clip(np.round(pairs * 32767), -32768, 32767).astype(np.int16)
    w = jc.in_wire_len
    jcarry, pcarry = jc.init_carry(), pc.init_carry()
    want, got = [], []
    for b in range(3):
        blk = raw[:, b * w:(b + 1) * w]
        jcarry, o = jc.step(jcarry, blk, np.bool_(False))
        want.append(np.asarray(o))
        pcarry, o = pc.step(pcarry, torch.from_numpy(blk))
        got.append(o.numpy())
    want, got = np.concatenate(want, -1), np.concatenate(got, -1)
    assert got.shape == want.shape and got.dtype == want.dtype
    if base["output_format"] == "cf32":
        np.testing.assert_allclose(got, want, rtol=0, atol=4 / 32768)
    else:
        assert int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max()) <= 4
