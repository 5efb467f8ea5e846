"""The port's sharded chain (``iq_tool_tpu_torch.parallel``) on meshes of
repeated CPU devices (``["cpu"] * k``, the counterpart of the reference
tests' eight virtual CPU devices), with tests/test_sharded.py's cases.

Each is held against the port's own ``Chain`` stepped at the per-shard
framing: byte-identical without the DC blocker and on the channel axis;
with it, tests/test_chain_fuzz.py's ``_assert_parity`` (>= 60 dB and a
code cap), since each shard's DC start is composed in float64 and
rounded once.  Four cases are also held against the JAX ShardedChain on
the same mesh (its Pallas kernels in interpret mode where the JAX test
turns them on): within 1 code on at most the share the two packages'
unsharded chains already differ on plus 0.1 %, or ``_assert_parity``
with the DC blocker.  Then the sharded half of the stitch fuzz, the
carry in the JAX layout, and the CLI's mesh flags.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iq_tool_tpu.cli import main as jax_main  # noqa: E402
from iq_tool_tpu.ops.fir_design import FilterRequest as JaxFilter  # noqa: E402
from iq_tool_tpu.parallel import ShardedChain as JaxSharded  # noqa: E402
from iq_tool_tpu.parallel import make_mesh as jax_mesh  # noqa: E402
from iq_tool_tpu.pipeline.chain import Chain as JaxChain  # noqa: E402
from iq_tool_tpu.pipeline.chain import ChainConfig as JaxConfig  # noqa: E402
from iq_tool_tpu_torch.cli import main as port_main  # noqa: E402
from iq_tool_tpu_torch.ops import kernels  # noqa: E402
from iq_tool_tpu_torch.ops.fir_design import FilterRequest  # noqa: E402
from iq_tool_tpu_torch.parallel import ShardedChain, make_mesh  # noqa: E402
from iq_tool_tpu_torch.pipeline.chain import Chain, ChainConfig  # noqa: E402
from tests import ref_dsp  # noqa: E402
from tests.test_chain_fuzz import _assert_parity, _draw_cfg, _fuzz_raw  # noqa: E402

IN_RATE, OUT_RATE = 2_048_000.0, 1_488_375.0


def _cfgs(channels=1, block=2048, filt=("lowpass", 400_000.0), **kw):
    """(JAX config, port config) of one chain; test_sharded.py's
    ``_full_cfg`` by default."""
    base = dict(input_format="cs16", output_format="cs16", input_rate=IN_RATE,
                target_rate=OUT_RATE, channels=channels, dc_block=True,
                freq_shift_pre_hz=150_000.0, freq_shift_post_hz=-25_000.0,
                agc_profile="local", target_block=block)
    base.update(kw)
    return (JaxConfig(filters=[JaxFilter(*filt)] if filt else [], **base),
            ChainConfig(filters=(FilterRequest(*filt),) if filt else (), **base))


def _raws(n_blocks, sc, rng, channels=1):
    return [rng.integers(-2 ** 14, 2 ** 14, (channels, sc.in_wire_len)).astype(np.int16)
            for _ in range(n_blocks)]


def _run(sc, raws, reset_idx=None, carry=None):
    """Steps ``sc`` (either package's chain) over the blocks ->
    (carry, output)."""
    carry = sc.init_carry() if carry is None else carry
    outs = []
    port = isinstance(sc, (Chain, ShardedChain))
    for i, raw in enumerate(raws):
        reset = reset_idx == i
        if port:
            carry, out = sc.step(carry, torch.from_numpy(raw), reset)
            outs.append(out.numpy())
        else:
            carry, out = sc.step(carry, raw, np.bool_(reset))
            outs.append(np.asarray(jax.device_get(out)))
    return carry, np.concatenate(outs, axis=-1)


def _per_shard(cfg, raws, t, jax_chain=False):
    """The unsharded chain at the per-shard framing over the same stream
    (tests/test_sharded.py's ``_run_single_subblocks``)."""
    single = (JaxChain(cfg) if jax_chain else Chain(cfg, device="cpu"))
    w = single.in_wire_len
    return _run(single, [raw[:, j * w:(j + 1) * w] for raw in raws for j in range(t)])[1]


def _differing(a, b) -> float:
    return float((a.astype(np.int32) != b.astype(np.int32)).mean())


def _assert_codes(got, want, max_code=1, frac=1e-3):
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= max_code, diff.max()
    assert (diff != 0).mean() <= frac, (diff != 0).mean()


def _vs_jax(jcfg, pcfg, jmesh, got, raws, t, dc, global_block=None):
    """The port's sharded output against the JAX ShardedChain's.  Without
    the DC blocker: within 1 code on at most the share that the JAX
    sharded path differs on from its own unsharded chain, plus the share
    the two packages' unsharded chains differ on, plus 0.1 %.  The
    unsharded chains run at the per-shard framing, or with
    ``global_block`` at the sharded step's block (the digital AGC)."""
    _, want = _run(JaxSharded(jcfg, jmesh), raws)
    if dc:
        _assert_parity(got, want, "vs jax")
        return
    if global_block:
        jcfg = JaxConfig(**{**jcfg.__dict__, "target_block": global_block})
        pcfg = ChainConfig(**{**pcfg.__dict__, "target_block": global_block})
        t = 1
    jax_single = _per_shard(jcfg, raws, t, jax_chain=True)
    gap = (_differing(want, jax_single)
           + _differing(_per_shard(pcfg, raws, t), jax_single))
    _assert_codes(got, want, frac=gap + 1e-3)


@pytest.fixture
def jax_interpret(monkeypatch):
    """tests/test_sharded.py:175: the JAX package's Pallas kernels in
    interpret mode on its sharded path."""
    from iq_tool_tpu.parallel import sharded as sharded_mod
    monkeypatch.setattr(sharded_mod, "_FUSED_INTERPRET", True)


# ------------------------------ tests/test_sharded.py's cases ---------------

def test_time_sharded_matches_single(rng):
    """:46: the full chain (DC, both shifts, lowpass, AGC) over 1 x 8."""
    jcfg, pcfg = _cfgs(block=2048)
    sc = ShardedChain(pcfg, make_mesh(["cpu"] * 8, 1, 8))
    single = Chain(pcfg, device="cpu")
    assert sc.n_in == 8 * single.n_in and sc.n_out == 8 * single.n_out
    raws = _raws(2, sc, rng)
    _, got = _run(sc, raws)
    _assert_parity(got, _per_shard(pcfg, raws, 8), "1x8")
    _vs_jax(jcfg, pcfg, jax_mesh(jax.devices(), 1, 8), got, raws, 8, dc=True)


@pytest.mark.parametrize("mesh", [(4, 2), (4, 1)], ids=["4x2", "4x1"])
def test_channel_sharded_matches_single(rng, mesh):
    """:80: four channels over 4 x 2, each channel against the chain on
    it alone; on a C x 1 mesh byte-identical to the chain over all four."""
    c, t = mesh
    _, pcfg = _cfgs(channels=4, block=2048)
    sc = ShardedChain(pcfg, make_mesh(["cpu"] * (c * t), c, t))
    raws = _raws(2, sc, rng, channels=4)
    _, got = _run(sc, raws)
    if t == 1:
        np.testing.assert_array_equal(got, _per_shard(pcfg, raws, 1))
        return
    one = ChainConfig(**{**pcfg.__dict__, "channels": 1})
    for ch in (0, 3):
        _assert_parity(got[ch:ch + 1],
                       _per_shard(one, [r[ch:ch + 1] for r in raws], t), ch)


def test_sharded_reset(rng):
    """:105: a reset step equals a fresh carry's."""
    _, pcfg = _cfgs(block=2048)
    sc = ShardedChain(pcfg, make_mesh(["cpu"] * 8, 1, 8))
    raws = _raws(2, sc, rng)
    carry, _ = _run(sc, raws[:1])
    _, after = _run(sc, raws[1:], reset_idx=0, carry=carry)
    _, fresh = _run(sc, raws[1:])
    np.testing.assert_array_equal(after, fresh)


def test_sharded_tone_quality():
    """:118: a tone through the sharded chain keeps >= 55 dB."""
    _, pcfg = _cfgs(block=2048, dc_block=False, freq_shift_pre_hz=0.0,
                    freq_shift_post_hz=0.0, agc_profile=None)
    sc = ShardedChain(pcfg, make_mesh(["cpu"] * 8, 1, 8))
    raws = []
    for b in range(3):
        t = np.arange(b * sc.n_in, (b + 1) * sc.n_in) / IN_RATE
        x = (0.5 * np.exp(2j * np.pi * 100_000.0 * t)).astype(np.complex64)
        raws.append(ref_dsp.from_cf32(x, "cs16")[None, :])
    _, out = _run(sc, raws)
    y = ref_dsp.to_cf32(out[0], "cs16")[sc.n_out:]
    m = np.arange(sc.n_out, 3 * sc.n_out)
    ideal = np.exp(2j * np.pi * (100_000.0 / OUT_RATE) * m)
    a = np.vdot(ideal, y) / np.vdot(ideal, ideal)
    snr = 10 * np.log10(np.mean(np.abs(a * ideal) ** 2) / np.mean(np.abs(y - a * ideal) ** 2))
    assert snr > 55.0 and abs(abs(a) - 0.5) < 0.01


def test_sharded_without_dc_is_exact(rng):
    """:144: without the DC blocker, byte-identical to the chain."""
    jcfg, pcfg = _cfgs(block=2048, dc_block=False, freq_shift_post_hz=0.0)
    sc = ShardedChain(pcfg, make_mesh(["cpu"] * 8, 1, 8))
    raws = _raws(2, sc, rng)
    _, got = _run(sc, raws)
    np.testing.assert_array_equal(got, _per_shard(pcfg, raws, 8))
    _vs_jax(jcfg, pcfg, jax_mesh(jax.devices(), 1, 8), got, raws, 8, dc=False)


def test_sharded_fused_pre_stage(rng, monkeypatch):
    """:169: DC + I/Q + pre-NCO in the pre-stage kernel, each shard run
    twice (zero start, then the composed start), shard 0's DC-blocked
    prefix broadcast to the I/Q estimator."""
    _, pcfg = _cfgs(block=2048, iq_correction=True, freq_shift_post_hz=0.0,
                    agc_profile=None)
    calls = []
    orig = kernels.dc_block_apply
    monkeypatch.setattr(kernels, "dc_block_apply",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    sc = ShardedChain(pcfg, make_mesh(["cpu"] * 4, 1, 4))
    raws = _raws(2, sc, rng)
    _, got = _run(sc, raws)
    assert len(calls) == 2 * 4 * 2        # two passes a shard a step
    _assert_parity(got, _per_shard(pcfg, raws, 4), "1x4")


def test_sharded_dc_matches_exact_recurrence(rng):
    """:205: the sharded DC blocker (cf32 in and out) against the scalar
    float64 recurrence, and against the JAX ShardedChain."""
    base = dict(input_format="cf32", output_format="cf32", input_rate=100_000.0,
                dc_block=True, target_block=2048)
    pcfg, jcfg = ChainConfig(**base), JaxConfig(**base)
    sc = ShardedChain(pcfg, make_mesh(["cpu"] * 8, 1, 8))
    n = sc.n_in
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    raw = np.empty((1, 2 * n), np.float32)
    raw[0, 0::2], raw[0, 1::2] = x.real, x.imag
    _, out = _run(sc, [raw])
    y = out[0, 0::2] + 1j * out[0, 1::2]
    a = 1.0 - sc.local.dc_alpha
    want = np.zeros(n, np.complex128)
    xp = yp = 0.0
    for i in range(n):
        want[i] = x[i] - xp + a * yp
        xp, yp = x[i], want[i]
    np.testing.assert_allclose(y, want, atol=3e-4)
    _, jout = _run(JaxSharded(jcfg, jax_mesh(jax.devices(), 1, 8)), [raw])
    np.testing.assert_allclose(out, jout, atol=3e-4)


def test_time_sharded_dft_engine_filter(rng):
    """:230: a 2175-tap notch on the overlap-save kernel's twin; its
    (C, block) tail crosses the shards like any other."""
    _, pcfg = _cfgs(block=1 << 16, filt=("stop-range", 0.0, 10_000.0),
                    freq_shift_pre_hz=100_000.0, freq_shift_post_hz=0.0,
                    agc_profile=None)
    sc = ShardedChain(pcfg, make_mesh(["cpu"] * 4, 1, 4))
    assert not sc.local.post_filter._exec_banded
    raws = _raws(2, sc, rng)
    _, got = _run(sc, raws)
    _assert_codes(got, _per_shard(pcfg, raws, 4), max_code=1, frac=0.02)


def test_sharded_wire_stage0_dc(rng, jax_interpret, monkeypatch):
    """:272: the full chain over 1 x 4 with its K3 pre-stage and K4 post
    kernel on the path (calls counted through the wrappers), against
    the chain and the JAX ShardedChain (its fused stage 0)."""
    jcfg, pcfg = _cfgs(block=4096)
    seen = {"dc_block_apply": 0, "post_apply": 0}
    for name in seen:
        orig = getattr(kernels, name)

        def spy(*a, _orig=orig, _name=name, **k):
            seen[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(kernels, name, spy)
    sc = ShardedChain(pcfg, make_mesh(["cpu"] * 4, 1, 4))
    raws = _raws(3, sc, rng)
    _, got = _run(sc, raws)
    assert seen == {"dc_block_apply": 2 * 4 * 3, "post_apply": 4 * 3}, seen
    _assert_parity(got, _per_shard(pcfg, raws, 4), "1x4")
    _vs_jax(jcfg, pcfg, jax_mesh(jax.devices()[:4], 1, 4), got, raws, 4, dc=True)


def test_sharded_wire_stage0_nco_parity(rng, monkeypatch):
    """:313: config #2's shape (shift, resample with the lowpass composed,
    no DC): stage 0 decodes the wire, its halo the rotated raw tail."""
    _, pcfg = _cfgs(block=4096, dc_block=False, freq_shift_pre_hz=250_000.0,
                    freq_shift_post_hz=0.0, agc_profile=None)
    wired = []
    orig = kernels.banded_apply
    monkeypatch.setattr(kernels, "banded_apply", lambda *a, **k: wired.append(
        k.get("wire_i32") is not None) or orig(*a, **k))
    sc = ShardedChain(pcfg, make_mesh(["cpu"] * 4, 1, 4))
    assert sc.local.pre_filter is None and sc.local._wire_resample
    raws = _raws(3, sc, rng)
    _, got = _run(sc, raws)
    assert wired.count(True) == 4 * 3
    np.testing.assert_array_equal(got, _per_shard(pcfg, raws, 4))


def test_sharded_wire_to_wire_single_stage(rng):
    """:336: one 441/512 stage and nothing else: wire in and out in one
    kernel a shard."""
    _, pcfg = _cfgs(block=4096, target_rate=1_764_000.0, filt=None, dc_block=False,
                    freq_shift_pre_hz=0.0, freq_shift_post_hz=0.0, agc_profile=None)
    sc = ShardedChain(pcfg, make_mesh(["cpu"] * 4, 1, 4))
    assert len(sc.local.resampler.stages) == 1
    raws = _raws(3, sc, rng)
    _, got = _run(sc, raws)
    np.testing.assert_array_equal(got, _per_shard(pcfg, raws, 4))


@pytest.mark.parametrize("flagship", [False, True], ids=["full", "flagship"])
def test_sharded_wire_stage0_dc_reset(rng, flagship):
    """:356: a reset through the DC stage 0 equals a fresh start (the
    flagship's wire path: the DC kernel twice, then K2)."""
    kw = (dict(freq_shift_post_hz=0.0, agc_profile=None, freq_shift_pre_hz=100_000.0)
          if flagship else {})
    _, pcfg = _cfgs(block=4096, **kw)
    sc = ShardedChain(pcfg, make_mesh(["cpu"] * 4, 1, 4))
    assert sc.local._wire_resample == flagship
    raws = _raws(2, sc, rng)
    carry, _ = _run(sc, raws[:1])
    _, after = _run(sc, raws[1:], reset_idx=0, carry=carry)
    _, fresh = _run(sc, raws[1:])
    np.testing.assert_array_equal(after, fresh)
    if flagship:
        _assert_parity(fresh, _per_shard(pcfg, raws[1:], 4), "flagship")


def test_sharded_digital_agc_decisions(rng, jax_interpret):
    """:373: the digital AGC takes one peak over every shard, before the
    post-NCO on both post paths (K4 for cs16 out, tensor ops for cf32
    out): the same states step for step, and the output against the JAX
    ShardedChain's and the unsharded chain at the global block."""
    base = dict(freq_shift_pre_hz=0.0, dc_block=False, agc_profile="digital", block=4096)
    jcfg, pcfg = _cfgs(**base)
    _, fcfg = _cfgs(output_format="cf32", **base)
    mesh = make_mesh(["cpu"] * 4, 1, 4)
    raws = _raws(6, ShardedChain(pcfg, mesh), np.random.default_rng(7))
    states = []
    for cfg in (pcfg, fcfg):
        sc = ShardedChain(cfg, mesh)
        carry, got = sc.init_carry(), []
        trace = []
        for raw in raws:
            carry, out = sc.step(carry, torch.from_numpy(raw))
            trace.append(carry[(0, 0)]["agc"])
            got.append(out.numpy())
        states.append(trace)
        if cfg is pcfg:
            got = np.concatenate(got, -1)
            big = Chain(ChainConfig(**{**pcfg.__dict__, "target_block": sc.n_in}),
                        device="cpu")
            assert big.n_in == sc.n_in
            _assert_codes(got, _run(big, raws)[1], max_code=1, frac=1e-3)
            _vs_jax(jcfg, pcfg, jax_mesh(jax.devices()[:4], 1, 4), got, raws, 4, dc=False,
                    global_block=sc.n_in)
    for a, b in zip(*states):
        assert torch.equal(a.locked, b.locked) and torch.equal(a.gain, b.gain)


# ------------------------------ the stitch fuzz -----------------------------

def _oracle(cfg, sc, raws):
    """tests/test_chain_fuzz.py's ``_oracle_chain`` on the port's Chain:
    the per-shard framing, or the global block for the digital AGC (one
    update per sharded step), over each channel shard's slab (the CPU's
    FFT and products round differently for another channel count, which
    an overlap-save filter's start-up ramp under the AGC shows)."""
    block = sc.n_in if cfg.agc_profile == "digital" else sc.local.cfg.target_block
    cl = sc.c_local
    single = Chain(ChainConfig(**{**cfg.__dict__, "target_block": block, "channels": cl}),
                   device="cpu")
    w = single.in_wire_len
    return np.concatenate([_run(single, [r[c:c + cl, j * w:(j + 1) * w] for r in raws
                                         for j in range(sc.in_wire_len // w)])[1]
                           for c in range(0, cfg.channels, cl)], axis=0)


@pytest.mark.parametrize("seed", range(25))
def test_fuzz_sharded_vs_chain(seed):
    """test_chain_fuzz.py:269: a random chain over a random mesh (the
    same draws), against the port's Chain."""
    rs = np.random.default_rng(2000 + seed)
    c_sh, t_sh = [(1, 2), (1, 4), (1, 8), (2, 2), (2, 4), (4, 2),
                  (4, 1), (8, 1)][int(rs.integers(0, 8))]
    jcfg = _draw_cfg(rs, channels=c_sh)
    cfg = ChainConfig(**{**jcfg.__dict__, "filters": tuple(
        FilterRequest(f.type, f.freq1_hz, f.freq2_hz) for f in jcfg.filters)})
    sc = ShardedChain(cfg, make_mesh(["cpu"] * (c_sh * t_sh), c_sh, t_sh))
    raws = [_fuzz_raw(cfg, sc.in_wire_len, c_sh, rs) for _ in range(2)]
    _, got = _run(sc, raws)
    want = _oracle(cfg, sc, raws)
    if not cfg.dc_block and cfg.agc_profile != "digital":
        np.testing.assert_array_equal(got, want)
    _assert_parity(got, want, (seed, cfg, (c_sh, t_sh)))


# ------------------------------ the carry and the CLI -----------------------

def test_carry_round_trip_jax_layout(rng):
    """The JAX ShardedChain's carry after a step, converted, continues in
    the port as the JAX chain continues; the port's carry converts back
    to the same keys and shapes, and round-trips exactly."""
    jcfg, pcfg = _cfgs(block=2048, iq_correction=True)
    jsc = JaxSharded(jcfg, jax_mesh(jax.devices()[:4], 1, 4))
    sc = ShardedChain(pcfg, make_mesh(["cpu"] * 4, 1, 4))
    raws = _raws(3, sc, rng)
    jcarry, _ = _run(jsc, raws[:1])
    jtree = jax.device_get(jcarry)
    _, want = _run(jsc, raws[1:], carry=jcarry)
    carry = sc.carry_from_numpy(jtree)
    assert set(carry) == set(sc.init_carry())
    pcarry, got = _run(sc, raws[1:], carry=carry)
    _assert_parity(got, want, "handover")
    tree = sc.carry_to_numpy(pcarry)
    assert set(tree) == set(jtree) == {"nco_pre", "nco_post", "dc_x", "dc_y", "iq",
                                       "rs0", "rs1", "agc"}
    for key in tree:
        for a, b in zip(jax.tree_util.tree_leaves(tree[key]),
                        jax.tree_util.tree_leaves(jtree[key])):
            assert np.shape(a) == np.shape(b), key
    again = sc.carry_to_numpy(sc.carry_from_numpy(tree))
    for a, b in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


FLAGS = ["-i", "raw-file", "-o", "raw", "--raw-file-input-rate", "2048000",
         "--raw-file-input-sample-format", "cs16", "--block-size", "4096",
         "--force-overwrite"]


def _tone(path, n, dc=0.0):
    t = np.arange(n) / IN_RATE
    x = (0.5 * np.exp(2j * np.pi * 80_000.0 * t) + dc).astype(np.complex64)
    path.write_bytes(ref_dsp.from_cf32(x, "cs16").tobytes())


@pytest.mark.parametrize("dc", [False, True], ids=["no-dc", "dc"])
def test_cli_mesh_time_vs_jax(tmp_path, dc):
    """``--mesh-time 2 --device cpu`` against the port's CLI unsharded at
    the same per-shard block (byte-identical without the DC blocker) and
    the JAX CLI at ``--mesh-time 2``."""
    inp = tmp_path / "in.raw"
    _tone(inp, 4096 * 9 + 1000, dc=0.05)
    flags = FLAGS + ["--output-rate", "512000", "--lowpass", "200000"]
    if dc:
        flags += ["--dc-block", "--freq-shift", "100000"]
    mesh, plain, jx = (tmp_path / f"{k}.raw" for k in ("mesh", "plain", "jax"))
    assert port_main([str(inp), str(mesh), *flags, "--mesh-time", "2", "--device", "cpu"]) == 0
    assert port_main([str(inp), str(plain), *flags, "--device", "cpu"]) == 0
    assert jax_main([str(inp), str(jx), *flags, "--mesh-time", "2"]) == 0
    got, unsharded, want = (np.fromfile(p, np.int16)[None, :] for p in (mesh, plain, jx))
    if dc:
        _assert_parity(got, unsharded, "unsharded")
        _assert_parity(got, want, "jax")
    else:
        np.testing.assert_array_equal(got, unsharded)
        np.testing.assert_array_equal(got, want)


def test_cli_mesh_checkpoint_resume(tmp_path):
    """``--checkpoint``/``--resume`` with a 1 x 2 mesh: a cut run resumed
    gives the uninterrupted run's bytes; the file holds the JAX layout."""
    inp = tmp_path / "in.raw"
    n = 4096 * 2 * 5
    _tone(inp, n)
    flags = FLAGS + ["--output-rate", "1488375", "--dc-block", "--freq-shift", "100000",
                     "--lowpass", "400000", "--mesh-time", "2", "--device", "cpu"]
    full = tmp_path / "full.raw"
    assert port_main([str(inp), str(full), *flags]) == 0
    half = tmp_path / "half.raw"
    half.write_bytes(inp.read_bytes()[:4096 * 2 * 2 * 4 + 4000])
    part, ckpt = tmp_path / "part.raw", tmp_path / "state.ckpt"
    assert port_main([str(half), str(part), *flags, "--checkpoint", str(ckpt)]) == 0
    with np.load(ckpt) as z:
        assert "dc_x" in bytes(z["__meta__"]).decode()
    assert port_main([str(inp), str(part), *flags, "--checkpoint", str(ckpt),
                      "--resume"]) == 0
    assert part.read_bytes() == full.read_bytes()


def test_cli_mesh_flags(tmp_path, capsys):
    """The reference CLI's mesh rules: an axis fills from the devices,
    the channel axis divides --channels, a mesh larger than the devices
    is an error, and --device cuda needs a card."""
    from iq_tool_tpu_torch.cli import build_mesh
    assert build_mesh("cpu", 1, None, 2).shape == {"channel": 1, "time": 2}
    assert build_mesh("cpu", 4, 2, None).shape == {"channel": 2, "time": 4}
    assert build_mesh("cpu", 6, None, 2).shape == {"channel": 3, "time": 2}
    with pytest.raises(ValueError, match="needs 16 devices"):
        build_mesh("cpu", 1, 4, 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_mesh("cuda", 1, None, 2)
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
    with pytest.raises(ValueError, match="2x3 != 4"):
        make_mesh(["cpu"] * 4, 2, 3)
    _, pcfg = _cfgs(channels=3)
    with pytest.raises(ValueError, match="not divisible"):
        ShardedChain(pcfg, make_mesh(["cpu"] * 2, 2, 1))
    inp = tmp_path / "in.raw"
    _tone(inp, 4096)
    assert port_main([str(inp), str(tmp_path / "o.raw"), *FLAGS, "--output-rate", "1488375",
                      "--mesh-time", "16", "--device", "cpu"]) == 1
    assert "needs 16 devices" in capsys.readouterr().err
