"""K2 as a 43:1 decimator: upstream's AM HD Radio preset
(``[preset:cs16-am-nrsc5]``, 46,511.71875 Hz cs16 with the digital AGC)
from an SDRplay's cs16 at its default 2 Msps.

On the CPU: the port's plan against the JAX package's at three blocks;
each banded launch's geometry (``kernels.band_geometry``) and the chain's
table of them (``Chain.band_geometries``), which the CLI prints.  The
chain itself is held against the JAX chain in
``tests/test_torch_chain.py::test_fuzz_cases_vs_jax`` (``AM_CASE``).  On
a card (marked ``gpu``, skipped without one): the plan's cores are the
kernels the capture launches.

    pytest --noconftest -m gpu tests/test_torch_decimator.py
"""

import fractions

import numpy as np
import pytest
import torch

from iq_tool_tpu_torch.ops import kernels
from iq_tool_tpu_torch.ops.fir_design import FilterRequest
from iq_tool_tpu_torch.ops.resample import _MatmulStage
from iq_tool_tpu_torch.pipeline.chain import Chain, ChainConfig

AM = dict(input_format="cs16", output_format="cs16", input_rate=2_000_000.0,
          target_rate=46_511.71875, agc_profile="digital")
CELL_BLOCK = 1056768            # 43 x 24,576 frames
BLOCK = 43 * 384                # a small block of the same grouping (g 4)
# the decimator's geometry at every block of 43 x 4k frames
GEOMETRY = {"core": "wgmma", "p": 1, "q": 43, "g": 4, "stride": 172, "k": 687,
            "span": 816, "cols": 32, "tiles": 1, "useful": 4 * 687 / (32 * 816)}
LINE = "wgmma p/q 1/43 g 4 stride 172 k 687 span 816 cols 32 x1 useful 10.5 %"

_BASE = dict(input_format="cs16", output_format="cs16", input_rate=2_048_000.0,
             target_rate=1_488_375.0, channels=1, target_block=262144)
# chains by what their banded launches are: the AM decimator; config #1's
# 441/512 over the wire; the flagship's K1 (DC block over the wire) and
# its 27/32 with the lowpass composed; an RTL-SDR's cu8 through the DC
# kernel, a 441/512 stage and the NRSC-5 band-pass run banded after it;
# the HackRF's gather stage, which launches none
CHAINS = {
    "am": dict(AM, channels=1, target_block=BLOCK),
    "config1": _BASE,
    "flagship": dict(_BASE, dc_block=True, freq_shift_pre_hz=100e3,
                     filters=(FilterRequest("lowpass", 400e3),)),
    "baseline3": dict(_BASE, input_format="cu8", dc_block=True, filter_method="fft",
                      filters=(FilterRequest("pass-range", 102e3, 215e3),)),
    "gather": dict(_BASE, input_format="cs8", input_rate=10e6, target_rate=744_187.5,
                   agc_profile="digital"),
}


def _chain(name: str, device: str = "cpu", **over) -> Chain:
    return Chain(ChainConfig(**{**CHAINS[name], **over}), device=device)


@pytest.mark.parametrize("block", [CELL_BLOCK, 262128, BLOCK])
def test_the_decimators_plan_is_the_jax_packages(block):
    """2 Msps to 46,511.71875 Hz rationalizes to 1/43 (2 ppm off): at
    1,056,768 frames, at 262,128 and at 16,512 the one banded stage takes
    4 windows of 43 (stride 172) over 687 taps of history, its matrix bit
    for bit the JAX package's, a band of k 687 in a span of 816 rows on
    the wgmma core."""
    from iq_tool_tpu.pipeline.chain import Chain as JaxChain
    from iq_tool_tpu.pipeline.chain import ChainConfig as JaxConfig
    pc = Chain(ChainConfig(channels=1, target_block=block, **AM), device="cpu")
    jc = JaxChain(JaxConfig(channels=1, target_block=block, **AM))
    assert (pc.n_in, pc.n_out) == (jc.n_in, jc.n_out)
    assert abs(AM["input_rate"] / 43 / AM["target_rate"] - 1) < 3e-6
    (ps,), (js,) = pc.resampler.stages, jc.resampler.stages
    assert (ps.p, ps.q, ps.g, ps.stride, ps.hist) == (js.p, js.q, js.g, js.stride, js.hist) == (
        1, 43, 4, 172, 687)
    assert np.array_equal(ps._a, js._a) and ps._a_i is None and js._a_i is None
    assert (ps.band.k, ps.band.span) == (687, 816)
    assert kernels.banded_core(ps.band) == "wgmma"


@pytest.mark.parametrize("case", ["decimator", "decimator-mma", "441/512", "27/32+lowpass"])
def test_band_geometry(case):
    """A banded launch's geometry: the decimator's on the wgmma core (4 x
    687 taps in 32 x 816 issued products a window: 10.5 %) and on the
    mma.sync core's 16-column tiles; config #1's 441/512 and the
    flagship's 27/32 with its lowpass composed, p and q recovered from
    the stride and the columns."""
    if case.startswith("decimator"):
        st = _chain("am").resampler.stages[0]
        core = "wgmma" if case == "decimator" else "mma"
        want = dict(GEOMETRY) if core == "wgmma" else dict(
            GEOMETRY, core="mma", cols=16, span=st.band.frag_span,
            useful=4 * 687 / (16 * st.band.frag_span))
        assert kernels.band_geometry(st.band, st.stride, core) == pytest.approx(want)
        assert kernels.band_line(kernels.band_geometry(st.band, st.stride, "wgmma")) == LINE
        return
    st = (_chain("config1").resampler.stages[0] if case == "441/512"
          else _chain("flagship").resampler.stages[1])
    core = kernels.banded_core(st.band)
    got = kernels.band_geometry(st.band, st.stride, core)
    cols, tiles, span = ((16, st.band.frag_tiles, st.band.frag_span) if core == "mma"
                         else (32, st.band.n_tiles, st.band.span))
    assert (got["core"], got["p"], got["q"], got["g"]) == (core, st.p, st.q, st.g)
    assert (got["stride"], got["k"], got["cols"], got["tiles"], got["span"]) == (
        st.stride, st.band.k, cols, tiles, span)
    assert got["useful"] == pytest.approx(st.g * st.p * st.band.k / (tiles * cols * span))
    assert 0 < got["useful"] <= 1


@pytest.mark.parametrize("name", list(CHAINS))
def test_the_chains_banded_launches(name):
    """``Chain.band_geometries``: one entry under each stage span that
    launches a banded kernel, on the core the launch takes (K1 over the
    wire on the wgmma core, K2 by ``banded_core``); the resampler stages'
    p/q multiply to the plan's ratio; a banded filter is p = q = 1 at the
    stride that divides its block; the gather stage launches none."""
    chain = _chain(name)
    got = chain.band_geometries()
    stages = chain.resampler.stages
    banded = [i for i, st in enumerate(stages) if isinstance(st, _MatmulStage)]
    want = {f"chain.resample.{i}" for i in banded}
    if chain.post_filter is not None and chain.post_filter.packs:
        want.add("chain.post_filter")
    assert set(got) == want and all(len(bs) == 1 for bs in got.values())
    if name == "am":
        assert got == {"chain.resample.0": [pytest.approx(GEOMETRY)]}
    if name == "gather":
        assert got == {} and not banded
    for i in banded:
        (b,) = got[f"chain.resample.{i}"]
        dc = i == 0 and chain.route.wire_stage0 and chain.cfg.dc_block
        assert b["core"] == ("wgmma" if dc else kernels.banded_core(stages[i].band))
        assert (b["p"], b["q"], b["g"], b["stride"]) == (
            stages[i].p, stages[i].q, stages[i].g, stages[i].stride)
    if banded == list(range(len(stages))) and banded:
        ratio = fractions.Fraction(1)
        for i in banded:
            ratio *= fractions.Fraction(got[f"chain.resample.{i}"][0]["p"],
                                        got[f"chain.resample.{i}"][0]["q"])
        assert ratio == fractions.Fraction(chain.resampler.plan.p, chain.resampler.plan.q)
    if "chain.post_filter" in got:
        (b,) = got["chain.post_filter"]
        assert (b["p"], b["q"], b["k"]) == (1, 1, chain.post_filter.num_taps)
        assert chain.n_out % b["stride"] == 0
    if name in ("flagship", "config1"):
        assert got["chain.resample.0"][0]["core"] == {"flagship": "wgmma", "config1": "mma"}[name]


def test_the_cli_summary_lists_each_banded_launch():
    """The CLI's table of banded launches, one line a stage: a chain's
    from its plan, a folded chain's from its row chain at the fold's
    rows, none for a sharded chain."""
    from iq_tool_tpu_torch import cli
    from iq_tool_tpu_torch.parallel import ShardedChain, make_mesh
    from iq_tool_tpu_torch.pipeline.folded import FoldedChain
    assert cli._band_rows(_chain("am")) == {"chain.resample.0": LINE}
    cfg = ChainConfig(**CHAINS["baseline3"])
    folded = FoldedChain(cfg, 2, device="cpu")
    rows = cli._band_rows(folded)
    want = {stage: "; ".join(kernels.band_line(b) for b in bs)
            for stage, bs in folded.local.band_geometries(2).items()}
    assert rows == want and "chain.post_filter" in rows
    assert cli._band_rows(ShardedChain(ChainConfig(**CHAINS["am"]),
                                       make_mesh(["cpu"] * 2, 1, 2))) == {}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["am", "config1", "flagship"])
def test_the_plans_cores_are_the_captures_kernels(name):
    """On the card: each stage the plan lists launches the kernel of its
    core in the captured step (wgmma: banded_kernel, mma:
    banded_mma_kernel), and no other stage launches a banded kernel; the
    AM chain at the cell's block on 4 channels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from iq_tool_tpu_torch.pipeline.graphed import GraphedStep
    over = dict(channels=4, target_block=CELL_BLOCK) if name == "am" else {}
    chain = _chain(name, "cuda", **over)
    bands = chain.band_geometries()
    g = GraphedStep(chain)
    g.capture()
    symbol = {"wgmma": "banded_kernel", "mma": "banded_mma_kernel"}
    for stage, kern in g.stage_kernels.items():
        launched = {s for s in kern if s in symbol.values()}
        assert launched == {symbol[b["core"]] for b in bands.get(stage, [])}, (stage, kern)
    if name == "am":
        assert bands == {"chain.resample.0": [pytest.approx(GEOMETRY)]}
