"""The port's graphed sharded step (``GraphedStep`` over a ``ShardedChain``,
``pipeline/graphed.py``) on meshes of repeated CPU devices, where it runs
the sharded chain's eager step over its static buffers, and the rule that
keeps some meshes eager (``sharded_eager_reason``).

* byte for byte against the eager ``ShardedChain.step``: outputs and
  carries over 5 carried blocks with a reset and a carry handed in from
  ``carry_from_numpy``, on 2x1, 4x1, 1x4 and 2x2 meshes, with and
  without the DC blocker, the flagship and config #4; and on a 2x1 mesh
  over two device names ("cpu" and "cpu:0"), one graph a device;
* against the JAX ShardedChain on the same mesh of virtual CPU devices,
  at tests/test_torch_sharded.py's bounds;
* the stream engine stepping it, a checkpoint cut and a resume
  byte-identical to the uninterrupted run.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iq_tool_tpu.parallel import make_mesh as jax_mesh  # noqa: E402
from iq_tool_tpu_torch.ops.fir_design import FilterRequest  # noqa: E402
from iq_tool_tpu_torch.parallel import ShardedChain, make_mesh  # noqa: E402
from iq_tool_tpu_torch.parallel.sharded import Mesh, sharded_eager_reason  # noqa: E402
from iq_tool_tpu_torch.pipeline.chain import Chain, ChainConfig  # noqa: E402
from iq_tool_tpu_torch.pipeline.checkpoint import load_checkpoint  # noqa: E402
from iq_tool_tpu_torch.pipeline.graphed import GraphedStep, _leaves, step_form  # noqa: E402
from iq_tool_tpu_torch.pipeline.runtime import StreamEngine  # noqa: E402
from tests.test_torch_runtime import FakeSink, FakeSource  # noqa: E402
from tests.test_torch_sharded import _cfgs, _run, _vs_jax  # noqa: E402

IN_RATE, OUT_RATE = 2_048_000.0, 1_488_375.0
BLOCKS, RESET, RESUME = 5, 2, 3


def _config(name, channels, block, dc=True):
    """The flagship or BASELINE config #4 (profile_steps.config) at a
    small width."""
    base = dict(input_format="cs16", output_format="cs16", input_rate=IN_RATE,
                target_rate=OUT_RATE, channels=channels, target_block=block,
                dc_block=dc, freq_shift_pre_hz=100e3)
    if name == "flagship":
        return ChainConfig(filters=(FilterRequest("lowpass", 400e3),), **base)
    return ChainConfig(filters=(FilterRequest("stop-range", 0.0, 10e3),),
                       iq_correction=True, freq_shift_post_hz=-50e3,
                       agc_profile="local", **base)


def _wires(rng, sc, n):
    return [torch.from_numpy(rng.integers(-2 ** 14, 2 ** 14, (sc.cfg.channels, sc.in_wire_len))
                             .astype(np.int16)) for _ in range(n)]


@pytest.mark.parametrize("name,mesh,dc,devices", [
    ("flagship", (2, 1), True, None), ("flagship", (4, 1), True, None),
    ("flagship", (1, 4), True, None), ("flagship", (2, 2), True, None),
    ("flagship", (1, 4), False, None), ("flagship", (2, 2), False, None),
    ("config4", (2, 1), True, None), ("config4", (1, 2), True, None),
    ("config4", (2, 2), True, None), ("config4", (1, 2), False, None),
    ("flagship", (2, 1), True, ["cpu", "cpu:0"]),
    ("config4", (2, 1), True, ["cpu", "cpu:0"])],
    ids=["flagship-2x1", "flagship-4x1", "flagship-1x4", "flagship-2x2",
         "flagship-nodc-1x4", "flagship-nodc-2x2", "config4-2x1", "config4-1x2",
         "config4-2x2", "config4-nodc-1x2", "flagship-2x1-two-devices",
         "config4-2x1-two-devices"])
def test_sharded_graph_is_eager_bit_for_bit(rng, name, mesh, dc, devices):
    """Every output and carry of the graphed sharded step equals the eager
    ShardedChain.step's over 5 blocks with a reset at block 2 and, at
    block 3, a carry from carry_from_numpy; the carry handed back is the
    one static carry and the output the one the next step overwrites."""
    c, t = mesh
    cfg = _config(name, 4, 2048 if name == "flagship" else 8192, dc)
    mk = lambda: ShardedChain(cfg, make_mesh(devices or ["cpu"] * (c * t), c, t))  # noqa: E731
    sc, g = mk(), GraphedStep(mk())
    assert len(g._parts) == (2 if devices else 1)
    raws = _wires(rng, sc, BLOCKS)
    ce, cg, first = sc.init_carry(), g.init_carry(), None
    for k, raw in enumerate(raws):
        if k == RESUME:
            cg = g.carry_from_numpy(g.carry_to_numpy(cg))
        ce, oe = sc.step(ce, raw, k == RESET)
        cg, og = g.step(cg, raw, k == RESET)
        first = (cg, og) if first is None else first
        assert cg is first[0] and og is first[1]
        assert torch.equal(og, oe), k
        for a, b in zip(_leaves(cg), _leaves(ce)):
            assert a.dtype == b.dtype and torch.equal(a, b), k
    assert g.replays == BLOCKS and g.kernels == {}


@pytest.mark.parametrize("mesh", [(2, 1), (1, 4), (2, 2)], ids=["2x1", "1x4", "2x2"])
def test_sharded_graph_vs_jax(rng, mesh):
    """The graphed sharded step against the JAX ShardedChain on the same
    mesh of virtual CPU devices: tests/test_torch_sharded.py's full chain
    (DC, both shifts, lowpass, AGC), held by its ``_assert_parity``."""
    c, t = mesh
    jcfg, pcfg = _cfgs(channels=2, block=2048)
    g = GraphedStep(ShardedChain(pcfg, make_mesh(["cpu"] * (c * t), c, t)))
    raws = [r.numpy() for r in _wires(rng, g, 3)]
    carry, outs = g.init_carry(), []
    for raw in raws:
        carry, out = g.step(carry, torch.from_numpy(raw))
        outs.append(out.numpy().copy())
    _vs_jax(jcfg, pcfg, jax_mesh(jax.devices()[:c * t], c, t), np.concatenate(outs, -1),
            raws, t, dc=True)


def test_sharded_graph_without_dc_vs_jax(rng):
    """Without the DC blocker, 1 x 4: within 1 code of the JAX ShardedChain
    on at most the share the two packages' unsharded chains already
    differ on plus 0.1 %, and byte-identical to the eager sharded step."""
    jcfg, pcfg = _cfgs(channels=1, block=2048, dc_block=False, freq_shift_post_hz=0.0)
    mesh = make_mesh(["cpu"] * 4, 1, 4)
    g = GraphedStep(ShardedChain(pcfg, mesh))
    raws = [r.numpy() for r in _wires(rng, g, 2)]
    carry, outs = g.init_carry(), []
    for raw in raws:
        carry, out = g.step(carry, torch.from_numpy(raw))
        outs.append(out.numpy().copy())
    got = np.concatenate(outs, -1)
    np.testing.assert_array_equal(got, _run(ShardedChain(pcfg, mesh), raws)[1])
    _vs_jax(jcfg, pcfg, jax_mesh(jax.devices()[:4], 1, 4), got, raws, 4, dc=False)


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2)], ids=["2x1", "1x2"])
def test_engine_steps_the_sharded_graph(tmp_path, rng, mesh):
    """The engine steps a graphed ShardedChain (2 channels, one source and
    sink each): its bytes are the eager sharded steps' over the
    zero-padded stream, trimmed; a run cut off a block boundary with a
    checkpoint, then resumed, gives the same bytes."""
    c, t = mesh
    cfg = ChainConfig(input_format="cs16", output_format="cs16", input_rate=IN_RATE,
                      target_rate=1_536_000.0, dc_block=True, freq_shift_pre_hz=100e3,
                      filters=(FilterRequest("lowpass", 400e3),), agc_profile="local",
                      target_block=2048, channels=2)
    sc = ShardedChain(cfg, make_mesh(["cpu"] * (c * t), c, t))
    n = sc.n_in * 4 + 777
    payload = rng.integers(-2 ** 14, 2 ** 14, (2, 2 * n)).astype(np.int16)
    padded = np.concatenate([payload, np.zeros((2, 2 * (5 * sc.n_in - n)), np.int16)], -1)
    w = sc.in_wire_len
    _, want = _run(sc, [padded[:, b * w:(b + 1) * w] for b in range(5)])
    want = want[:, :2 * sc.expected_out_frames(n)]
    sinks = [FakeSink(), FakeSink()]
    eng = StreamEngine(sc, [FakeSource(p.tobytes(), [1000, 50_000]) for p in payload], sinks)
    eng.run()
    assert isinstance(eng.stepper, GraphedStep) and eng.stepper.replays == 5
    assert [bytes(s.data) for s in sinks] == [row.tobytes() for row in want]
    cut = 4 * (sc.n_in * 2 + 300)
    ckpt = str(tmp_path / "s.ckpt")
    first, second = [FakeSink(), FakeSink()], [FakeSink(), FakeSink()]
    StreamEngine(sc, [FakeSource(p.tobytes()[:cut], [cut // 3]) for p in payload], first,
                 checkpoint_path=ckpt, checkpoint_interval_sec=0.0).run()
    _, fin, _, _ = load_checkpoint(ckpt, sc)
    assert fin == 2 * sc.n_in
    StreamEngine(sc, [FakeSource(p.tobytes(), [333, 70_000]) for p in payload], second,
                 checkpoint_path=ckpt, resume=True).run()
    for ch in range(2):
        assert (bytes(first[ch].data[:4 * 2 * sc.n_out]) + bytes(second[ch].data)
                == want[ch].tobytes())


@pytest.mark.parametrize("devices,ranks,want", [
    ([["cuda:0"] * 4], None, None),
    ([["cuda:0"], ["cuda:1"], ["cuda:2"], ["cuda:3"]], None, None),
    ([["cuda:0", "cuda:0"], ["cuda:1", "cuda:1"]], None, None),
    ([["cuda:0", "cuda:1"]], None, "time shards span devices"),
    ([["cpu", "cpu"], ["cpu", "cpu"]], [[0, 0], [1, 1]], "multi-process"),
    ([["cpu"], ["cpu"]], [[0], [0]], None),
], ids=["1x4-one-card", "4x1-four-cards", "2x2-rows-on-cards", "1x2-two-cards",
        "two-processes", "ranks-of-one-process"])
def test_sharded_eager_reason(devices, ranks, want):
    """The rule that keeps a sharded step eager: positions in another
    process, or a time row over several devices; every other mesh is
    captured, one graph a device."""
    assert sharded_eager_reason(Mesh(devices, ranks=ranks, rank=0)) == want


def test_step_form_names_the_rule():
    """What the CLI prints as the step's form: the rule's reason first,
    then the CPU's (it captures no graph)."""
    cfg = _config("flagship", 2, 2048)
    two = ShardedChain(cfg, Mesh([["cpu"], ["cpu"]], ranks=[[0], [1]], rank=0))
    assert step_form(two) == "eager (multi-process)"
    assert step_form(Chain(cfg, device="cpu")) == "eager (the CPU captures no graph)"
    assert step_form(ShardedChain(cfg, make_mesh(["cpu"] * 2, 1, 2))) == (
        "eager (the CPU captures no graph)")


def test_cli_prints_the_step_form(tmp_path, monkeypatch):
    """The CLI's Configuration Summary names the step's form; with a mesh
    flag on the CPU the engine steps the graphed sharded chain's eager
    body, byte-identical to the unsharded CLI run at the same block."""
    from iq_tool_tpu_torch import cli
    from tests.test_torch_sharded import FLAGS, _tone
    tables = {}
    monkeypatch.setattr(cli, "_print_summary_table",
                        lambda title, items, file=None: tables.setdefault(title, items))
    inp = tmp_path / "in.raw"
    _tone(inp, 4096 * 5 + 300)
    flags = FLAGS + ["--output-rate", "1488375", "--lowpass", "400000", "--device", "cpu"]
    mesh, plain = tmp_path / "mesh.raw", tmp_path / "plain.raw"
    assert cli.main([str(inp), str(mesh), *flags, "--mesh-channel", "1",
                     "--mesh-time", "1"]) == 0
    assert tables["Configuration Summary"]["Step"] == "eager (the CPU captures no graph)"
    assert cli.main([str(inp), str(plain), *flags]) == 0
    assert mesh.read_bytes() == plain.read_bytes()
