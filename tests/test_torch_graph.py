"""The port's graphed step (``pipeline/graphed.py``) on the CPU, where it
runs the chain's eager step over its static buffers, and the CLI's
choice of time fold.

* against the JAX package's jitted Chain (its fused Pallas stages in
  interpret mode, as tests/test_chain_fuzz.py runs them): the flagship
  and config #4 at 2 channels, 6 carried blocks with a reset at block 4,
  held to tests/test_torch_chain.py's bound (max |delta code| <= 4) and,
  with the DC blocker on, >= 60 dB;
* against the JAX fold (F = 4), to tests/test_torch_folded.py's bounds:
  without the DC blocker 1 code on at most the share the two packages'
  unfolded chains already differ on plus 0.1 %, with it >= 60 dB and
  <= 32 codes;
* byte for byte against the eager ``Chain.step``: outputs and carries,
  the static carry handed back, a carry from ``carry_from_numpy``, a
  reset, and the stream engine with a checkpoint cut and a resume.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iq_tool_tpu.ops.fir_design import FilterRequest as JaxFilter  # noqa: E402
from iq_tool_tpu.pipeline import chain as jax_chain_mod  # noqa: E402
from iq_tool_tpu.pipeline.chain import Chain as JaxChain  # noqa: E402
from iq_tool_tpu.pipeline.chain import ChainConfig as JaxConfig  # noqa: E402
from iq_tool_tpu.pipeline.folded import FoldedChain as JaxFolded  # noqa: E402
from iq_tool_tpu_torch.cli import choose_time_fold, fold_chain  # noqa: E402
from iq_tool_tpu_torch.ops.fir_design import FilterRequest  # noqa: E402
from iq_tool_tpu_torch.parallel import ShardedChain, make_mesh  # noqa: E402
from iq_tool_tpu_torch.parallel.sharded import Mesh  # noqa: E402
from iq_tool_tpu_torch.pipeline.chain import Chain, ChainConfig  # noqa: E402
from iq_tool_tpu_torch.pipeline.checkpoint import load_checkpoint  # noqa: E402
from iq_tool_tpu_torch.pipeline.folded import FoldedChain  # noqa: E402
from iq_tool_tpu_torch.pipeline.graphed import GraphedStep, _leaves  # noqa: E402
from iq_tool_tpu_torch.pipeline.runtime import StreamEngine  # noqa: E402
from tests.test_torch_runtime import FakeSink, FakeSource  # noqa: E402

IN_RATE, OUT_RATE = 2_048_000.0, 1_488_375.0
BLOCKS, RESET = 6, 4

# (chain fields, filter request) of the flagship and BASELINE config #4
FLAGSHIP = (dict(dc_block=True, freq_shift_pre_hz=100e3), ("lowpass", 400e3, 0.0))
CONFIG4 = (dict(dc_block=True, iq_correction=True, freq_shift_pre_hz=100e3,
                freq_shift_post_hz=-50e3, agc_profile="local"),
           ("stop-range", 0.0, 10e3))


def _configs(spec, block, channels=2, **kw):
    """(JAX config, port config) of the same chain."""
    fields, req = spec
    base = dict(input_format="cs16", output_format="cs16", input_rate=IN_RATE,
                target_rate=OUT_RATE, channels=channels, target_block=block)
    base.update(fields)
    base.update(kw)
    return (JaxConfig(filters=(JaxFilter(*req),), **base),
            ChainConfig(filters=(FilterRequest(*req),), **base))


def _stream(rng, channels, frames, tone_hz=37e3):
    """A tone, noise and a DC offset as cs16 (C, 2 * frames)."""
    t = np.arange(frames) / IN_RATE
    x = (0.45 * np.exp(2j * np.pi * tone_hz * t)[None, :] + 0.08
         + 0.05 * (rng.standard_normal((channels, frames))
                   + 1j * rng.standard_normal((channels, frames))))
    pairs = np.stack([x.real, x.imag], -1).reshape(channels, 2 * frames)
    return np.clip(np.round(pairs * 32767), -32768, 32767).astype(np.int16)


def _blocks(raw, width, n):
    return [raw[:, b * width:(b + 1) * width] for b in range(n)]


def _run_graph(step, blocks, reset_idx=RESET):
    """The graphed step over `blocks` (numpy), each written into its input
    buffer as the engine writes it: the outputs (numpy) and the carry."""
    carry = step.init_carry()
    outs = []
    for i, raw in enumerate(blocks):
        step.input_buffer.copy_(torch.from_numpy(raw))
        carry, out = step.step(carry, step.input_buffer, i == reset_idx)
        outs.append(out.numpy().copy())
    return carry, np.concatenate(outs, -1)


def _run_eager(chain, blocks, reset_idx=RESET, carry=None):
    carry = chain.init_carry() if carry is None else carry
    outs, carries = [], []
    for i, raw in enumerate(blocks):
        carry, out = chain.step(carry, torch.from_numpy(raw), i == reset_idx)
        outs.append(out.numpy())
        carries.append([t.clone() for t in _leaves(carry)])
    return carries, np.concatenate(outs, -1)


def _run_jax(chain, blocks, reset_idx=RESET):
    carry = chain.init_carry()
    outs = []
    for i, raw in enumerate(blocks):
        carry, out = chain.step(carry, raw, np.bool_(i == reset_idx))
        outs.append(np.asarray(out))
    return np.concatenate(outs, -1)


def _snr_db(got, want):
    diff = got.astype(np.float64) - want.astype(np.float64)
    return 10 * np.log10((want.astype(np.float64) ** 2).mean()
                         / max((diff ** 2).mean(), 1e-30))


def _max_dcode(got, want, skip=0):
    return int(np.abs(got.astype(np.int64) - want.astype(np.int64))[:, skip:].max())


@pytest.mark.parametrize("name,spec,block", [("flagship", FLAGSHIP, 4096),
                                             ("config4", CONFIG4, 16384)],
                         ids=["flagship", "config4"])
def test_graph_vs_jax_chain(rng, monkeypatch, name, spec, block):
    """The graphed port step against the reference's jitted step, its
    fused pre/post stages in interpret mode; config #4's overlap-save
    notch starts from a zero tail that its AGC lifts, at the stream's
    start and again at the reset, so those ramps (tests/test_torch_general.py)
    are left out of the code bound."""
    monkeypatch.setattr(jax_chain_mod, "_FUSED_POST_INTERPRET", True)
    monkeypatch.setattr(jax_chain_mod, "_FUSED_PRE_INTERPRET", True)
    jcfg, pcfg = _configs(spec, block)
    jc, pc = JaxChain(jcfg), Chain(pcfg, device="cpu")
    assert (jc.n_in, jc.n_out) == (pc.n_in, pc.n_out)
    blocks = _blocks(_stream(rng, 2, BLOCKS * pc.n_in), pc.in_wire_len, BLOCKS)
    _, got = _run_graph(GraphedStep(pc), blocks)
    want = _run_jax(jc, blocks)
    assert got.shape == want.shape and got.dtype == want.dtype
    keep = np.ones(got.shape[-1], bool)
    if pc.post_filter is not None and pc.agc_cfg is not None:
        ramp = 2 * (pc.post_filter.num_taps // 2)
        for start in (0, 2 * RESET * pc.n_out):
            keep[start:start + ramp] = False
    assert _max_dcode(got[:, keep], want[:, keep]) <= 4
    assert _snr_db(got[:, keep], want[:, keep]) >= 60.0


@pytest.mark.parametrize("dc", [False, True], ids=["no-dc", "dc"])
def test_graph_vs_jax_fold(rng, dc):
    """The graphed FoldedChain (F = 4, 2 channels) against the JAX fold,
    beside the two packages' unfolded row chains (tests/test_folded.py's
    configuration)."""
    base = dict(freq_shift_pre_hz=150e3, freq_shift_post_hz=-25e3, agc_profile="local")
    jcfg, pcfg = _configs((base, ("lowpass", 400e3, 0.0)), 2048, dc_block=dc)
    jf, pf = JaxFolded(jcfg, 4), FoldedChain(pcfg, 4, device="cpu")
    assert (pf.n_in, pf.n_out) == (jf.n_in, jf.n_out)
    blocks = _blocks(_stream(rng, 2, 3 * pf.n_in), pf.in_wire_len, 3)
    _, got = _run_graph(GraphedStep(pf), blocks, reset_idx=1)
    want = _run_jax(jf, blocks, reset_idx=1)
    if dc:
        assert _snr_db(got, want) > 60.0 and _max_dcode(got, want) <= 32
        return
    # the unfolded chains' gap over the same stream
    rows = [raw[:, j * pf.local.in_wire_len:(j + 1) * pf.local.in_wire_len]
            for raw in blocks for j in range(4)]
    _, seq = _run_eager(Chain(pcfg, device="cpu"), rows, reset_idx=4)
    jseq = _run_jax(JaxChain(jcfg), rows, reset_idx=4)
    gap = float((seq != jseq).mean())
    diff = got.astype(np.int32) - want.astype(np.int32)
    assert np.abs(diff).max() <= 1 and (diff != 0).mean() < gap + 1e-3


def _eager_and_graph(pcfg, fold, rng, blocks=BLOCKS):
    chain = FoldedChain(pcfg, fold, device="cpu") if fold > 1 else Chain(pcfg, device="cpu")
    raws = _blocks(_stream(rng, pcfg.channels, blocks * chain.n_in, tone_hz=137e3),
                   chain.in_wire_len, blocks)
    return chain, GraphedStep(chain), raws


@pytest.mark.parametrize("name,spec,block,fold", [
    ("flagship", FLAGSHIP, 4096, 1), ("config4", CONFIG4, 16384, 1),
    ("config4-fold4", CONFIG4, 4096, 4),
    ("config3-cu8", (dict(input_format="cu8", dc_block=True, filter_method="fft",
                          filter_stage="pre"), ("pass-range", 0.0, 400e3)), 16384, 1)],
    ids=["flagship", "config4", "config4-fold4", "config3-cu8"])
def test_graph_is_eager_bit_for_bit(rng, name, spec, block, fold):
    """Every output and carry of the graphed step equals the eager step's
    over 6 blocks with a reset at block 4; the carry handed back is the
    one static carry, and each step overwrites the output it returned
    before (the donation contract)."""
    _, pcfg = _configs(spec, block)
    chain, g, raws = _eager_and_graph(pcfg, fold, rng)
    if pcfg.input_format == "cu8":
        raws = [(r.astype(np.int32) // 256 + 128).astype(np.uint8) for r in raws]
    carries, want = _run_eager(chain, raws)
    carry = g.init_carry()
    outs, first = [], None
    for i, raw in enumerate(raws):
        carry, out = g.step(carry, torch.from_numpy(raw), i == RESET)
        first = (carry, out) if first is None else first
        assert carry is first[0] and out is first[1]
        outs.append(out.numpy().copy())
        for a, b in zip(_leaves(carry), carries[i]):
            assert a.dtype == b.dtype and torch.equal(a, b)
    np.testing.assert_array_equal(np.concatenate(outs, -1), want)
    assert g.replays == BLOCKS and g.kernels == {}


def test_graph_takes_a_carry_from_numpy(rng):
    """A carry that is not the static one, a checkpoint's converted by
    carry_from_numpy as a resume does, is copied in: the rest of the
    stream is the eager run's, bit for bit."""
    _, pcfg = _configs(CONFIG4, 16384)
    chain, g, raws = _eager_and_graph(pcfg, 1, rng, blocks=4)
    _, want = _run_eager(chain, raws, reset_idx=None)
    carry = g.init_carry()
    outs = []
    for i, raw in enumerate(raws):
        if i == 2:
            resumed = g.carry_from_numpy(g.carry_to_numpy(carry))
            assert resumed is not carry
            carry = resumed
        carry, out = g.step(carry, torch.from_numpy(raw))
        outs.append(out.numpy().copy())
    np.testing.assert_array_equal(np.concatenate(outs, -1), want)


def test_graph_reset_is_the_eager_reset(rng):
    """A reset mid-stream from a carry handed in gives the eager step's
    bits, output and carry; the learned I/Q factors are kept."""
    _, pcfg = _configs(CONFIG4, 16384)
    chain, g, raws = _eager_and_graph(pcfg, 1, rng, blocks=3)
    carry, _ = chain.step(chain.init_carry(), torch.from_numpy(raws[0]))
    carry, _ = chain.step(carry, torch.from_numpy(raws[1]))
    assert carry["iq"].factors.abs().sum() > 0
    want_c, want = chain.step(carry, torch.from_numpy(raws[2]), True)
    got_c, got = g.step(carry, torch.from_numpy(raws[2]), True)
    assert torch.equal(got, want)
    for a, b in zip(_leaves(got_c), _leaves(want_c)):
        assert torch.equal(a, b)


def test_graph_refuses_what_it_cannot_take(rng):
    """A sharded chain on a mesh the rule keeps eager (positions in
    another process, a time row over two devices) and what is no chain
    raise; so do an input of another shape or device type, or a carry of
    another layout."""
    _, pcfg = _configs(FLAGSHIP, 4096)
    with pytest.raises(TypeError, match=r"steps eagerly \(multi-process\)"):
        GraphedStep(ShardedChain(pcfg, Mesh([["cpu"], ["cpu"]], ranks=[[0], [1]], rank=0)))
    with pytest.raises(TypeError, match=r"steps eagerly \(time shards span devices\)"):
        GraphedStep(ShardedChain(pcfg, make_mesh(["cpu", "cpu:0"], 1, 2)))
    with pytest.raises(TypeError, match="Chain, a FoldedChain or a ShardedChain"):
        GraphedStep(pcfg)
    g = GraphedStep(Chain(pcfg, device="cpu"))
    carry = g.init_carry()
    with pytest.raises(ValueError, match="the step takes"):
        g.step(carry, torch.zeros((1, g.in_wire_len), dtype=torch.int16))
    with pytest.raises(ValueError, match="layout"):
        g.step(Chain(pcfg, device="cpu").init_carry(1), g.input_buffer)


def _engine_chain(fold):
    cfg = ChainConfig(input_format="cs16", output_format="cs16", input_rate=IN_RATE,
                      target_rate=1_536_000.0, dc_block=True, freq_shift_pre_hz=100e3,
                      filters=(FilterRequest("lowpass", 400e3),), agc_profile="local",
                      target_block=2048)
    return FoldedChain(cfg, fold, device="cpu") if fold > 1 else Chain(cfg, device="cpu")


@pytest.mark.parametrize("fold", [1, 2], ids=["chain", "fold2"])
def test_engine_steps_the_graph(tmp_path, rng, fold):
    """The engine steps a GraphedStep whose input buffer takes each block:
    its bytes are the eager steps' over the zero-padded stream, trimmed;
    a run cut off a block boundary with a checkpoint, then resumed,
    gives the same bytes."""
    chain = _engine_chain(fold)
    n = chain.n_in * 4 + 777
    payload = rng.integers(-2 ** 14, 2 ** 14, 2 * n).astype(np.int16)
    padded = np.concatenate([payload, np.zeros(2 * (5 * chain.n_in - n), np.int16)])
    _, want = _run_eager(chain, _blocks(padded[None, :], chain.in_wire_len, 5),
                         reset_idx=None)
    want = want[0, :2 * chain.expected_out_frames(n)].tobytes()
    full = FakeSink()
    eng = StreamEngine(chain, FakeSource(payload.tobytes(), [1000, 50_000]), full)
    eng.run()
    assert isinstance(eng.stepper, GraphedStep) and eng.stepper.replays == 5
    assert bytes(full.data) == want
    cut = 4 * (chain.n_in * 2 + 300)
    ckpt = str(tmp_path / "s.ckpt")
    first, second = FakeSink(), FakeSink()
    StreamEngine(chain, FakeSource(payload.tobytes()[:cut], [cut // 3]), first,
                 checkpoint_path=ckpt, checkpoint_interval_sec=0.0).run()
    _, fin, _, _ = load_checkpoint(ckpt, chain)
    assert fin == 2 * chain.n_in
    StreamEngine(chain, FakeSource(payload.tobytes(), [333, 70_000]), second,
                 checkpoint_path=ckpt, resume=True).run()
    assert bytes(first.data[:4 * 2 * chain.n_out]) + bytes(second.data) == want


@pytest.mark.parametrize("args,want", [
    ((None, 1, "cuda", False), (8, True)),
    ((None, 2, "cuda", False), (4, True)),
    ((None, 9, "cuda", False), (1, True)),
    ((None, 1, "cpu", False), (1, True)),
    ((None, 1, "cuda", True), (1, True)),
    ((4, 1, "cpu", False), (4, False)),
], ids=["cuda-1ch", "cuda-2ch", "cuda-9ch", "cpu", "mesh", "explicit"])
def test_choose_time_fold(args, want):
    """The automatic fold is the JAX CLI's auto_fold on the card (8 rows
    at one channel, 1 past 8 channels), 1 on the CPU and with a mesh
    flag; an explicit fold is taken as given."""
    assert choose_time_fold(*args) == want


def test_fold_falls_back_only_when_automatic():
    """A fold the configuration cannot take (the I/Q estimator needs 1024
    frames a row) raises when asked for, and the automatic fold falls
    back to the unfolded Chain."""
    cfg = ChainConfig(input_format="cs16", output_format="cs16", input_rate=IN_RATE,
                      iq_correction=True, target_block=512)
    with pytest.raises(ValueError, match="I/Q estimation"):
        fold_chain(cfg, 8, False, "cpu")
    chain = fold_chain(cfg, 8, True, "cpu")
    assert type(chain) is Chain and chain.n_in == 512
    assert type(fold_chain(_engine_chain(1).cfg, 8, True, "cpu")) is FoldedChain
