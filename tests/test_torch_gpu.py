"""The port's CUDA kernels against their plain twins, on a CUDA card.

Every test here is marked ``gpu`` and skips without a card.  The file
imports no jax, so it also runs on a machine that has only torch:

    pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` because tests/conftest.py configures jax).  Bounds:
kernel and twin differ only in the order of float32 sums, so planar
outputs are held to >= 100 dB and packed codes to |delta| <= 1.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iq_tool_tpu_torch.formats import get_format  # noqa: E402
from iq_tool_tpu_torch.ops import convert, kernels  # noqa: E402
from iq_tool_tpu_torch.ops.fir_design import FilterRequest  # noqa: E402
from iq_tool_tpu_torch.pipeline.chain import Chain, ChainConfig  # noqa: E402

pytestmark = pytest.mark.gpu

DC_ALPHA = 3.0679615757712826e-05        # 10 Hz pole at 2.048 Msps
DTHETA = 209715200                       # +100 kHz at 2.048 Msps


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _chain_cfg(name, block, channels=1):
    if name == "flagship":
        return ChainConfig(input_format="cs16", output_format="cs16",
                           input_rate=2_048_000.0, target_rate=1_488_375.0,
                           channels=channels, dc_block=True,
                           freq_shift_pre_hz=100e3,
                           filters=(FilterRequest("lowpass", 400e3),),
                           target_block=block)
    return ChainConfig(input_format="cu8", output_format="cu8",        # NRSC5
                       input_rate=2_400_000.0, target_rate=1_488_375.0,
                       channels=channels, dc_block=True, target_block=block)


def _stage(name, block, idx):
    st = Chain(_chain_cfg(name, block), device="cpu").resampler.stages[idx]
    st.bind("cuda")
    return st


def _snr(want, got):
    want = want.double().cpu().numpy().ravel()
    err = want - got.double().cpu().numpy().ravel()
    return 10 * np.log10(np.mean(want ** 2) / max(np.mean(err ** 2), 1e-300))


def _cuda(a):
    return torch.from_numpy(np.ascontiguousarray(a)).cuda()


def _planes(rng, ch, n, scale=0.2):
    return tuple(_cuda((rng.standard_normal((ch, n)) * scale).astype(np.float32))
                 for _ in range(2))


def _random_wire(rng, fmt, ch, n):
    dt = convert.wire_dtype(fmt)
    info = np.iinfo(dt)
    raw = rng.integers(info.min // 2, int(info.max) // 2 + 1, (ch, 2 * n))
    return convert.wire_pack(_cuda(raw.astype(dt)), fmt)


CORES = ["wgmma", "mma"]     # csrc/banded.cu, csrc/banded_mma.cu


def _counts():
    return kernels.banded_apply.launches, kernels.banded_apply_mma.launches


def _counted(before, core, n=1):
    """K2's counters moved by n launches on ``core``."""
    return _counts() == (before[0] + n, before[1] + (n if core == "mma" else 0))


def _packed_codes_close(want, got, fmt):
    bits = 16 if want.dtype == torch.int32 else 8
    mask = (1 << bits) - 1
    w = want.to(torch.int64) & ((1 << 2 * bits) - 1)
    g = got.to(torch.int64) & ((1 << 2 * bits) - 1)
    d = torch.maximum(((w & mask) - (g & mask)).abs(), ((w >> bits) - (g >> bits)).abs())
    return int(d.max()) <= 1 and float((d > 0).float().mean()) <= 0.01


@pytest.mark.parametrize("which", [
    ("flagship", 1, 224),   # the CLI's default block: stage 1 regroups to stride 224
    ("nrsc5", 0, 400),      # NRSC5 2.4 -> 1.488375 Msps at the CLI block
    ("nrsc5", 1, 144),
])
@pytest.mark.parametrize("core", CORES)
def test_k2_engages_at_any_stride(rng, which, core):
    _need_card()
    name, idx, stride = which
    st = _stage(name, 16384, idx)
    assert st.stride == stride
    ch, n = 4, 40 * st.stride
    xr, xi = _planes(rng, ch, n)
    sr, si = _planes(rng, ch, st.hist)
    before = _counts()
    got = kernels.banded_apply(sr, si, xr, xi, st.band, None, st.stride, st.hist, core=core)
    torch.cuda.synchronize()
    assert _counted(before, core)
    want = kernels.banded_apply_ref(sr, si, xr, xi, st.band, None, st.stride, st.hist)
    for w, g in zip(want, got):
        assert _snr(w, g) >= 100.0


@pytest.mark.parametrize("fmt", ["cs16", "sc16q11", "cu16", "cu8", "cs8"])
@pytest.mark.parametrize("core", CORES)
def test_k2_wire_nco_packed_formats(rng, fmt, core):
    _need_card()
    st = _stage("flagship", 131072, 0)
    ch, n = 3, 24 * st.stride
    wire, kind = _random_wire(rng, fmt, ch, n)
    sr, si = _planes(rng, ch, st.hist)
    ph = _cuda(rng.integers(0, 2 ** 32, ch).astype(np.int64))
    args = (sr, si, None, None, st.band, None, st.stride, st.hist)
    kw = dict(wire_i32=wire, wire_norm=get_format(fmt).normalizer,
              wire_gain=0.7, nco_dtheta=DTHETA, nco_phase=ph, wire_kind=kind, core=core)
    got = kernels.banded_apply(*args, pack_fmt=fmt, **kw)
    kw.pop("core")
    want = kernels.banded_apply_ref(*args, pack_fmt=fmt, **kw)
    assert got.dtype == want.dtype
    assert _packed_codes_close(want, got, fmt)
    got_p = kernels.banded_apply(*args, **kw, core=core)
    want_p = kernels.banded_apply_ref(*args, **kw)
    for w, g in zip(want_p, got_p):
        assert _snr(w, g) >= 100.0


@pytest.mark.parametrize("case", [(1155, False), (1155, True), (3 * 1009, False)],
                         ids=["stride-231", "stride-231-complex", "stride-3"])
@pytest.mark.parametrize("core", CORES)
def test_k2_odd_strides(rng, case, core):
    """A FIR filter's Toeplitz band at the stride its block length gives:
    odd (the kernel's single-word loads, pairs straddling staged rows)
    and below 8 (spans crossing several rows per chunk); the filter's own
    call takes the rule's core (mma.sync: 75 taps), and each core is held
    against the twin on the same inputs."""
    _need_card()
    from iq_tool_tpu_torch.ops.filters import StreamingFilter
    n, cplx = case
    taps = rng.standard_normal(75).astype(np.complex64) / 75
    if cplx:
        taps = taps * np.exp(2j * np.pi * 0.1 * np.arange(75)).astype(np.complex64)
    f = StreamingFilter(taps, "fir")
    xr, xi = _planes(rng, 2, n)
    sr, si = _planes(rng, 2, f.block)
    before = _counts()
    got = f.apply_planar(xr, xi, sr, si)
    torch.cuda.synchronize()
    assert _counted(before, "mma")
    stride = n // 5 if n == 1155 else 3
    band = f._band(stride, "cuda")
    assert (band.taps_i is not None) == cplx
    st_r, st_i = sr[:, -74:].contiguous(), si[:, -74:].contiguous()
    want = kernels.banded_apply_ref(st_r, st_i, xr, xi, band, None, stride, 74)
    for w, g in zip(want, got[:2]):
        assert _snr(w, g) >= 100.0
    forced = kernels.banded_apply(st_r, st_i, xr, xi, band, None, stride, 74, core=core)
    for w, g in zip(want, forced):
        assert _snr(w, g) >= 100.0


@pytest.mark.parametrize("core", CORES)
def test_k2_complex_taps(rng, core):
    _need_card()
    st = Chain(_chain_cfg("flagship", 16384), device="cpu").resampler.stages[1]
    st.compose_output_fir(np.exp(2j * np.pi * 0.1 * np.arange(9)) / 9)
    st.bind("cuda")
    assert st.band.taps_i is not None
    ch, n = 2, 30 * st.stride
    xr, xi = _planes(rng, ch, n)
    sr, si = _planes(rng, ch, st.hist)
    before = _counts()
    got = kernels.banded_apply(sr, si, xr, xi, st.band, None, st.stride, st.hist, core=core)
    torch.cuda.synchronize()
    assert _counted(before, core)
    want = kernels.banded_apply_ref(sr, si, xr, xi, st.band, None, st.stride, st.hist)
    for w, g in zip(want, got):
        assert _snr(w, g) >= 100.0


def test_k2_fir_2048_taps(rng):
    """The longest FIR that runs banded (2048 taps, past the overlap-save
    cut): its Toeplitz tile spans 2064 rows, more than the taps' shared
    memory holds, so the producers stream each tile through the ring;
    planar and packed against the twin."""
    _need_card()
    from iq_tool_tpu_torch.ops.filters import StreamingFilter
    taps = (np.hanning(2050)[1:-1] / 1024).astype(np.complex64)
    f = StreamingFilter(taps, "fft")
    n = 40 * 256       # stride 256 (BANDED_STRIDE_CAP): 1.25 window groups
    xr, xi = _planes(rng, 3, n)
    sr, si = _planes(rng, 3, f.block)
    before = _counts()
    got = f.apply_planar(xr, xi, sr, si)
    torch.cuda.synchronize()
    assert _counted(before, "wgmma")
    band = f._band(256, "cuda")
    assert band.span >= 2048 and band.taps_i is None
    hist = 2047
    st_r, st_i = sr[:, -hist:].contiguous(), si[:, -hist:].contiguous()
    want = kernels.banded_apply_ref(st_r, st_i, xr, xi, band, None, 256, hist)
    for w, g in zip(want, got[:2]):
        assert _snr(w, g) >= 100.0
    got_p = kernels.banded_apply(st_r, st_i, xr, xi, band, None, 256, hist, pack_fmt="cs16")
    want_p = kernels.banded_apply_ref(st_r, st_i, xr, xi, band, None, 256, hist,
                                      pack_fmt="cs16")
    assert _packed_codes_close(want_p, got_p, "cs16")


@pytest.mark.parametrize("core", CORES)
def test_k2_is_deterministic(rng, core):
    """Two launches of K2 on the same input give the same bits, planar
    and packed, at the flagship's stage 1 (the wgmma core: two CTAs an
    SM) and stage 0 (one), on either core."""
    _need_card()
    for idx in (1, 0):
        st = _stage("flagship", 131072, idx)
        ch, n = 16, 65536 + 3 * st.stride
        xr, xi = _planes(rng, ch, n)
        sr, si = _planes(rng, ch, st.hist)
        args = (sr, si, xr, xi, st.band, None, st.stride, st.hist)
        a = kernels.banded_apply(*args, core=core)
        b = kernels.banded_apply(*args, core=core)
        pa = kernels.banded_apply(*args, pack_fmt="cs16", core=core)
        pb = kernels.banded_apply(*args, pack_fmt="cs16", core=core)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b)) and torch.equal(pa, pb)


@pytest.mark.parametrize("which", [("flagship", 1, "wgmma"), ("flagship", 0, "mma"),
                                   ("nrsc5", 1, "mma"), ("narrow", 1, "mma")],
                         ids=["flagship-1", "flagship-0", "nrsc5-1", "narrow-1"])
def test_k2_core_rule_on_card(rng, which):
    """Both sides of the rule that picks K2's core (kernels.banded_core:
    the wgmma core over 96 or more taps a column, the mma.sync core
    below): a call without ``core`` takes the rule's core, counted as
    such, and gives the bits that core gives when asked for."""
    _need_card()
    name, idx, core = which
    if name == "narrow":      # stage 1 without the lowpass (configs #1, #3, #4)
        cfg = ChainConfig(input_format="cs16", output_format="cs16", input_rate=2_048_000.0,
                          target_rate=1_488_375.0, channels=1, target_block=131072)
        st = Chain(cfg, device="cpu").resampler.stages[idx]
        st.bind("cuda")
    else:
        st = _stage(name, 131072, idx)
    assert kernels.banded_core(st.band) == core
    ch, n = 4, 40 * st.stride + 7
    xr, xi = _planes(rng, ch, n)
    sr, si = _planes(rng, ch, st.hist)
    args = (sr, si, xr, xi, st.band, None, st.stride, st.hist)
    before = _counts()
    got = kernels.banded_apply(*args, pack_fmt="cs16")
    torch.cuda.synchronize()
    assert _counted(before, core)
    assert torch.equal(got, kernels.banded_apply(*args, pack_fmt="cs16", core=core))
    assert _packed_codes_close(kernels.banded_apply_ref(*args, pack_fmt="cs16"), got, "cs16")


def _offset_wire(wire, off):
    """The same (C, n) packed wire, contiguous, ``off`` elements past its
    allocation's start: rows begin off 16-byte alignment."""
    flat = torch.empty(wire.numel() + off, dtype=wire.dtype, device=wire.device)
    view = flat[off:].view(wire.shape)
    view.copy_(wire)
    return view


@pytest.mark.parametrize("stride", ["even", "odd"])
@pytest.mark.parametrize("dtheta", [0, DTHETA], ids=["no-nco", "nco"])
@pytest.mark.parametrize("fmt", ["cs16", "cu16", "cu8", "cs8"])
def test_k2_mma_wire_staging(rng, fmt, dtheta, stride):
    """The mma.sync core over a packed wire stages it from its raw buffer
    (cp.async of the next group's raw wire, decoded from shared memory):
    an even stride (stage 0's 512, paired loads) and an odd one (a 75-tap
    FIR at 231), hist 31 and 74, so no group's first sample is 16-byte
    aligned, rows of n = 37 s + 3 frames starting off alignment, the
    third group 5 windows long.  Without the NCO the output equals, bit
    for bit, the same launch over the planes convert.decode_packed gives
    on the card; with it the twin's bounds hold; two launches agree bit
    for bit."""
    _need_card()
    if stride == "even":
        st = _stage("flagship", 131072, 0)
        band, s, hist = st.band, st.stride, st.hist
    else:
        from iq_tool_tpu_torch.ops.filters import StreamingFilter
        taps = rng.standard_normal(75).astype(np.complex64) / 75
        s, hist = 231, 74
        band = StreamingFilter(taps, "fir")._band(s, "cuda")
    assert kernels.banded_core(band) == "mma" and hist % 4 != 0
    ch, n = 3, 37 * s + 3
    wire, kind = _random_wire(rng, fmt, ch, n)
    wire = _offset_wire(wire, 1)
    sr, si = _planes(rng, ch, hist)
    ph = _cuda(rng.integers(0, 2 ** 32, ch).astype(np.int64))
    norm, gain = get_format(fmt).normalizer, 0.7
    kw = dict(wire_i32=wire, wire_norm=norm, wire_gain=gain, nco_dtheta=dtheta,
              nco_phase=ph if dtheta else None, wire_kind=kind)
    args = (sr, si, None, None, band, None, s, hist)
    before = _counts()
    got = kernels.banded_apply(*args, **kw, core="mma")
    again = kernels.banded_apply(*args, **kw, core="mma")
    torch.cuda.synchronize()
    assert _counted(before, "mma", 2)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    if dtheta:
        want = kernels.banded_apply_ref(*args, **kw)
        for w, g in zip(want, got):
            assert _snr(w, g) >= 100.0
        packed = kernels.banded_apply(*args, **kw, pack_fmt=fmt, core="mma")
        assert _packed_codes_close(kernels.banded_apply_ref(*args, **kw, pack_fmt=fmt),
                                   packed, fmt)
    else:
        xr, xi = convert.decode_packed(wire, kind, norm, gain)
        planar = kernels.banded_apply(sr, si, xr, xi, band, None, s, hist, core="mma")
        assert all(torch.equal(x, y) for x, y in zip(got, planar))


# K2's launches on the mma.sync core over planes at the three resident
# cells' stage geometries (64 channels): (grid, threads, shared bytes, CTAs
# an SM, groups a channel) as the launcher chose them before the wire got
# its own staging (H100 80GB HBM3, 132 SMs)
PLANAR_PLANS = {
    ("1", 0, 262144): (132, 512, 141440, 1, 32),
    ("1", 1, 225792): (396, 256, 71808, 3, 56),
    ("full4", 0, 262144): (132, 512, 141440, 1, 32),
    ("full4", 1, 225792): (396, 256, 71808, 3, 56),
    ("baseline3", 0, 262400): (264, 256, 110976, 2, 41),
    ("baseline3", 1, 289296): (396, 256, 41344, 3, 126),
}


def test_k2_mma_plans_on_card():
    """kernels.banded_plan names the staging: "wire" over a packed wire,
    "planar" over planes; the planar launches at the resident cells'
    stage geometries keep the geometry they had; a wire launch takes no
    fewer CTAs an SM than the planar launch at its shape."""
    _need_card()
    from iq_tool_tpu_torch.profile_steps import config
    keys = ("grid", "threads", "smem", "ctas_per_sm", "groups")
    for (name, idx, n), want in PLANAR_PLANS.items():
        st = Chain(config(name, 64), device="cpu").resampler.stages[idx]
        st.bind("cuda")
        geo = (st.band, st.stride, st.hist, n, 64)
        planar = kernels.banded_plan(*geo, core="mma")
        assert planar["staging"] == "planar"
        assert tuple(planar[k] for k in keys) == want, (name, idx, planar)
        for fmt in ("cs16", "cu16", "cu8", "cs8"):
            wire = kernels.banded_plan(*geo, core="mma", wire_kind=fmt)
            assert wire["staging"] == "wire"
            assert wire["ctas_per_sm"] >= planar["ctas_per_sm"]
            assert wire["smem"] < planar["smem"] and wire["groups"] == planar["groups"]


@pytest.mark.parametrize("case", [
    ("flagship", "cs16", DTHETA, 3 * 4096 + 7 * 512),
    ("nrsc5", "cu8", 0, 3 * 4096 + 7 * 400),
    ("flagship", "cs16", DTHETA, 40 * 512 + 77),   # 1.25 window groups, ragged
    ("nrsc5", "cu8", DTHETA, 37 * 400 + 123),      # boundaries inside DC tiles
], ids=["flagship", "nrsc5", "flagship-ragged", "nrsc5-ragged"])
def test_k1_matches_twin(rng, case):
    """K1 on the card, the carry pass then the banded kernel with the
    DC-wire loader, over 3 carried blocks (each path carrying its own
    stage history and DC state) against the twin at >= 100 dB; n is not
    a multiple of the 32-window group and, at nrsc5's stride 400, the
    group boundaries (every 12800 samples) fall inside the DC kernel's
    4096-sample tiles."""
    _need_card()
    name, fmt, dth, n = case
    st = _stage(name, 131072, 0)
    ch = 4
    sr, si = _planes(rng, ch, st.hist, 0.05)
    dc = _cuda((rng.standard_normal((ch, 4)) * 0.05).astype(np.float32))
    ph = _cuda(rng.integers(0, 2 ** 32, ch).astype(np.int64)) if dth else None
    got_c = want_c = (sr, si, dc)
    before = (kernels.banded_apply_dc.launches, kernels.dc_carry.launches,
              kernels.dc_prologue.launches)
    for _ in range(3):
        wire, kind = _random_wire(rng, fmt, ch, n)
        tail = (st.band, None, st.stride, st.hist, wire, get_format(fmt).normalizer,
                1.0, dth, ph)
        got = kernels.banded_apply_dc(*got_c[:2], got_c[2], DC_ALPHA, *tail,
                                      wire_kind=kind)
        want = kernels.banded_apply_dc_ref(*want_c[:2], want_c[2], DC_ALPHA, *tail,
                                           wire_kind=kind)
        torch.cuda.synchronize()
        for w, g in zip((*want[0], *want[1:]), (*got[0], *got[1:])):
            assert _snr(w, g) >= 100.0
        got_c, want_c = got[1:], want[1:]
    assert (kernels.banded_apply_dc.launches, kernels.dc_carry.launches,
            kernels.dc_prologue.launches) == (before[0] + 3, before[1] + 3, before[2])


def test_k1_is_deterministic(rng):
    """Two launches of the fused K1 on the same input give the same bits
    (planes, packed output, tails, DC state)."""
    _need_card()
    st = _stage("flagship", 131072, 0)
    ch, n = 16, 262144 + 5 * 512
    wire, kind = _dc_wire(rng, "cs16", ch, n)
    sr, si = _planes(rng, ch, st.hist, 0.05)
    dc = _cuda((rng.standard_normal((ch, 4)) * 0.05).astype(np.float32))
    ph = _cuda(rng.integers(0, 2 ** 32, ch).astype(np.int64))
    args = (sr, si, dc, DC_ALPHA, st.band, None, st.stride, st.hist, wire,
            get_format("cs16").normalizer, 1.0, DTHETA, ph)
    for pack in (None, "cs16"):
        a = kernels.banded_apply_dc(*args, pack_fmt=pack, wire_kind=kind)
        b = kernels.banded_apply_dc(*args, pack_fmt=pack, wire_kind=kind)
        torch.cuda.synchronize()
        for x, y in zip((*a[0], *a[1:]) if pack is None else a,
                        (*b[0], *b[1:]) if pack is None else b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("case", [("cs16", DTHETA, 512, 262144 + 77, 31),
                                  ("cu8", 0, 400, 37 * 400 + 123, 31),
                                  ("cs16", DTHETA, 1, 200, 70)],
                         ids=["flagship", "nrsc5", "stride-1"])
def test_dc_carry_matches_twin(rng, case):
    """K1's carry pass alone against its twin: the float64 states before
    each window group within 1e-9 of the states' scale, the halos, tail
    and new DC state at >= 100 dB; at stride 1 the halos (70 samples)
    are wider than a group (32) and overlap."""
    _need_card()
    fmt, dth, stride, n, hist = case
    ch = 3
    wire, kind = _dc_wire(rng, fmt, ch, n)
    dc = _cuda((rng.standard_normal((ch, 4)) * 0.05).astype(np.float32))
    ph = _cuda(rng.integers(0, 2 ** 32, ch).astype(np.int64)) if dth else None
    args = (wire, dc, DC_ALPHA, stride, hist, get_format(fmt).normalizer, 1.0, dth, ph)
    before = kernels.dc_carry.launches
    got = kernels.dc_carry(*args, wire_kind=kind)
    want = kernels.dc_carry_ref(*args, wire_kind=kind)
    torch.cuda.synchronize()
    assert kernels.dc_carry.launches == before + 1
    assert got[0].shape == (ch, kernels.dc_groups(n, stride), 4)
    scale = float(want[0].abs().max())
    assert float((got[0] - want[0]).abs().max()) <= 1e-9 * scale
    for w, g in zip(want[1:], got[1:]):
        assert _snr(w, g) >= 100.0


def test_k1_refuses_what_it_cannot_stage(rng):
    """A stride whose window group does not fit one CTA's shared memory
    raises: nothing falls back to the prologue's planes or the CPU."""
    _need_card()
    from iq_tool_tpu_torch.ops.kernels import Band
    s, hist, g = 2048, 31, 64
    a = np.zeros((s + hist, g), np.float32)
    for j in range(g):
        a[16 * j:16 * j + 32, j] = 1.0 / 32
    band = Band.build(a, None, "cuda")
    ch, n = 2, 40 * s
    wire, kind = _random_wire(rng, "cs16", ch, n)
    sr, si = _planes(rng, ch, hist)
    dc = _cuda(np.zeros((ch, 4), np.float32))
    before = kernels.dc_prologue.launches, kernels.banded_apply_dc.launches
    with pytest.raises(RuntimeError):
        kernels.banded_apply_dc(sr, si, dc, DC_ALPHA, band, None, s, hist, wire,
                                get_format("cs16").normalizer, wire_kind=kind)
    assert (kernels.dc_prologue.launches, kernels.banded_apply_dc.launches) == before


def test_chain_on_card_matches_cpu_chain(rng):
    _need_card()
    cfg = _chain_cfg("flagship", 16384, channels=2)
    gpu, cpu = Chain(cfg, device="cuda"), Chain(cfg, device="cpu")
    t = np.arange(3 * gpu.n_in) / 2.048e6
    x = 0.4 * np.exp(2j * np.pi * 37e3 * t) + 0.05
    pairs = np.stack([x.real, x.imag], -1).reshape(1, -1)
    raw = np.repeat(np.round(pairs * 32767).astype(np.int16), 2, axis=0)
    gc, cc = gpu.init_carry(), cpu.init_carry()
    k1, k2 = kernels.banded_apply_dc.launches, kernels.banded_apply.launches
    carry, pro = kernels.dc_carry.launches, kernels.dc_prologue.launches
    w = gpu.in_wire_len
    for b in range(3):
        blk = torch.from_numpy(raw[:, b * w:(b + 1) * w])
        gc, go = gpu.step(gc, blk.cuda())
        cc, co = cpu.step(cc, blk)
        d = (go.cpu().to(torch.int64) - co.to(torch.int64)).abs().max()
        assert int(d) <= 4
    assert kernels.banded_apply_dc.launches == k1 + 3
    assert kernels.banded_apply.launches == k2 + 3
    assert (kernels.dc_carry.launches, kernels.dc_prologue.launches) == (carry + 3, pro)


def test_wrappers_refuse_mixed_devices(rng):
    _need_card()
    st = _stage("flagship", 16384, 1)
    xr, xi = _planes(rng, 1, 4 * st.stride)
    with pytest.raises(ValueError):
        kernels.banded_apply(torch.zeros((1, st.hist)), torch.zeros((1, st.hist)),
                             xr, xi, st.band, None, st.stride, st.hist)


# ----------------------------- K3, K4, K5 and the AGC gains -------------------

def _general_cfg(block, channels=1):
    """BASELINE config #4: DC + I/Q + pre-shift, 2175-tap overlap-save
    notch after the resampler, post-shift, local AGC."""
    return ChainConfig(input_format="cs16", output_format="cs16",
                       input_rate=2_048_000.0, target_rate=1_488_375.0,
                       channels=channels, dc_block=True, iq_correction=True,
                       freq_shift_pre_hz=100e3, freq_shift_post_hz=-50e3,
                       filters=(FilterRequest("stop-range", 0.0, 10e3),),
                       agc_profile="local", target_block=block)


@pytest.mark.parametrize("case", [("cs16", True, DTHETA), ("planar", True, 0),
                                  ("cu8", False, DTHETA), ("cs16", False, 0),
                                  ("planar", False, 0), ("planar", True, DTHETA),
                                  ("cu8", True, 0)],
                         ids=["cs16-iq-nco", "planar-iq", "cu8-nco", "cs16",
                              "planar", "planar-iq-nco", "cu8-iq"])
def test_k3_matches_twin(rng, case):
    """Any N: 3 whole 4096-sample tiles plus a ragged 77 (not a multiple
    of 128, which the TPU kernel required, nor of 8: the kernel's scalar
    loads and stores)."""
    _need_card()
    fmt, iq, dth = case
    ch, n = 4, 3 * 4096 + 77
    dc = _cuda((rng.standard_normal((ch, 4)) * 0.05).astype(np.float32))
    fac = _cuda((rng.standard_normal((ch, 2)) * 0.02).astype(np.float32)) if iq else None
    ph = _cuda(rng.integers(0, 2 ** 32, ch).astype(np.int64)) if dth else None
    if fmt == "planar":
        xr, xi = _planes(rng, ch, n, 0.3)
        kw = dict(xr=xr, xi=xi)
    else:
        wire, kind = _random_wire(rng, fmt, ch, n)
        kw = dict(xr=None, xi=None, wire_i32=wire, wire_kind=kind,
                  wire_norm=get_format(fmt).normalizer, wire_gain=0.9)
    before = kernels.dc_block_apply.launches
    got = kernels.dc_block_apply(state=dc, alpha=DC_ALPHA, iq_factors=fac,
                                 phase_acc=ph, dtheta=dth, **kw)
    want = kernels.dc_block_apply_ref(state=dc, alpha=DC_ALPHA, iq_factors=fac,
                                      phase_acc=ph, dtheta=dth, **kw)
    torch.cuda.synchronize()
    assert kernels.dc_block_apply.launches == before + 1
    for w, g in zip(want, got):
        assert _snr(w, g) >= 100.0


@pytest.mark.parametrize("n", [16384, 16390, 16391], ids=["n16384", "n16390", "n16391"])
@pytest.mark.parametrize("dth", [DTHETA, 0], ids=["nco", "no-nco"])
@pytest.mark.parametrize("iq", [True, False], ids=["iq", "no-iq"])
@pytest.mark.parametrize("fmt", ["cs16", "cu8", "planar"])
def test_k3pre_matches_twin(rng, fmt, iq, dth, n):
    """K3pre (csrc/pre.cu) against its twin: 16390 and 16391 frames a row
    put every row but the first off 16-byte alignment (its head and tail
    frames), 16384 is the chain's shape."""
    _need_card()
    ch = 5
    fac = _cuda((rng.standard_normal((ch, 2)) * 0.02).astype(np.float32)) if iq else None
    ph = _cuda(rng.integers(0, 2 ** 32, ch).astype(np.int64)) if dth else None
    if fmt == "planar":
        xr, xi = _planes(rng, ch, n, 0.3)
        args, kw = (xr, xi), {}
    else:
        wire, kind = _random_wire(rng, fmt, ch, n)
        args = (None, None)
        kw = dict(wire_i32=wire, wire_kind=kind, wire_norm=get_format(fmt).normalizer,
                  wire_gain=0.9)
    before = kernels.pre_apply.launches
    got = kernels.pre_apply(*args, fac, ph, dth, **kw)
    want = kernels.pre_apply_ref(*args, fac, ph, dth, **kw)
    torch.cuda.synchronize()
    assert kernels.pre_apply.launches == before + 1
    for w, g in zip(want, got):
        assert _snr(w, g) >= 100.0
    if not dth:                          # no sin or cos: the twin's bits
        for w, g in zip(want, got):
            assert torch.equal(w, g)


@pytest.mark.parametrize("fmt", ["cs16", "cu8", "planar"])
def test_k3pre_rows_off_alignment(rng, fmt):
    """Input views one element past an aligned address: the wire's (or
    the planes') rows never share the outputs' alignment, so every row
    takes the kernel's one-frame-a-thread path."""
    _need_card()
    ch, n = 3, 8192 + 3
    fac = _cuda((rng.standard_normal((ch, 2)) * 0.02).astype(np.float32))
    ph = _cuda(rng.integers(0, 2 ** 32, ch).astype(np.int64))
    if fmt == "planar":
        bufs = _planes(rng, 1, ch * n + 1, 0.3)
        args, kw = tuple(b[0, 1:].view(ch, n) for b in bufs), {}
    else:
        wire, kind = _random_wire(rng, fmt, 1, ch * n + 1)
        args = (None, None)
        kw = dict(wire_i32=wire[0, 1:].view(ch, n), wire_kind=kind,
                  wire_norm=get_format(fmt).normalizer)
    got = kernels.pre_apply(*args, fac, ph, DTHETA, **kw)
    want = kernels.pre_apply_ref(*args, fac, ph, DTHETA, **kw)
    for w, g in zip(want, got):
        assert _snr(w, g) >= 100.0


def _dc_wire(rng, fmt, ch, n):
    """A wire of a tone behind noise and a DC offset (the pole keeps the
    offset's step for the whole block)."""
    k = np.arange(n)
    x = 0.3 * np.exp(2j * np.pi * 0.013 * k) + 0.1 + 0.05 * (
        rng.standard_normal((ch, n)) + 1j * rng.standard_normal((ch, n)))
    if fmt == "cs16":
        pairs = np.clip(np.round(np.stack([x.real, x.imag], -1) * 32767), -32768, 32767)
        return convert.wire_pack(_cuda(pairs.reshape(ch, 2 * n).astype(np.int16)), fmt)
    pairs = np.clip(np.round(np.stack([x.real, x.imag], -1) * 127.5 + 127.5), 0, 255)
    return convert.wire_pack(_cuda(pairs.reshape(ch, 2 * n).astype(np.uint8)), fmt)


@pytest.mark.parametrize("n_of_tile", ["1", "100", "T-1", "T", "T+1", "262144"])
def test_dc_kernel_sizes_over_carried_blocks(rng, n_of_tile):
    """The DC kernel at N = 1, 100, T - 1, T, T + 1 and 262144 (64 tiles,
    two look-back groups) over 3 carried blocks, each path carrying its
    own state: K1's prologue on cs16 with the NCO (planes, tail, state)
    and K3 on cu8 with I/Q and the NCO, against their twins at >= 100 dB."""
    _need_card()
    tile = kernels.DC_TILE
    n = {"1": 1, "100": 100, "T-1": tile - 1, "T": tile, "T+1": tile + 1,
         "262144": 262144}[n_of_tile]
    ch, hist = 3, min(31, n)
    norm16, norm8 = get_format("cs16").normalizer, get_format("cu8").normalizer
    ph = _cuda(rng.integers(0, 2 ** 32, ch).astype(np.int64))
    fac = _cuda((rng.standard_normal((ch, 2)) * 0.02).astype(np.float32))
    dc0 = _cuda((rng.standard_normal((ch, 4)) * 0.05).astype(np.float32))
    k1_got = k1_want = k3_got = k3_want = dc0
    before = kernels.dc_prologue.launches, kernels.dc_block_apply.launches
    for _ in range(3):
        w16, kind16 = _dc_wire(rng, "cs16", ch, n)
        w8, kind8 = _dc_wire(rng, "cu8", ch, n)
        got = kernels.dc_prologue(w16, k1_got, DC_ALPHA, hist, norm16, 1.0, DTHETA, ph,
                                  wire_kind=kind16)
        want = kernels.dc_prologue_ref(w16, k1_want, DC_ALPHA, hist, norm16, 1.0, DTHETA,
                                       ph, wire_kind=kind16)
        for w, g in zip(want, got):
            assert _snr(w, g) >= 100.0
        k1_got, k1_want = got[-1], want[-1]
        kw = dict(alpha=DC_ALPHA, iq_factors=fac, phase_acc=ph, dtheta=DTHETA,
                  wire_i32=w8, wire_norm=norm8, wire_kind=kind8)
        got = kernels.dc_block_apply(None, None, k3_got, **kw)
        want = kernels.dc_block_apply_ref(None, None, k3_want, **kw)
        for w, g in zip(want, got):
            assert _snr(w, g) >= 100.0
        k3_got, k3_want = got[-1], want[-1]
    torch.cuda.synchronize()
    assert (kernels.dc_prologue.launches, kernels.dc_block_apply.launches) == (
        before[0] + 3, before[1] + 3)


def test_dc_kernel_is_deterministic(rng):
    """Two launches on the same input give the same bits: the look-back
    combines in one fixed order."""
    _need_card()
    ch, n = 16, 262144 + 4096 * 33
    wire, kind = _dc_wire(rng, "cs16", ch, n)
    dc = _cuda((rng.standard_normal((ch, 4)) * 0.05).astype(np.float32))
    args = (wire, dc, DC_ALPHA, 31, get_format("cs16").normalizer)
    a = kernels.dc_prologue(*args, wire_kind=kind)
    b = kernels.dc_prologue(*args, wire_kind=kind)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("case", [("cs16", 128, 123456789), ("cu8", 128, 0),
                                  ("cs16", 0, 0), ("sc16q11", 0, 987654321)],
                         ids=["cs16-seg-nco", "cu8-seg", "cs16-one-gain",
                              "sc16q11-one-gain-nco"])
def test_k4_matches_twin(rng, case):
    """seg 128 with a ragged 48-sample tail (the last segment's gain
    applies), and one gain per channel."""
    _need_card()
    fmt, seg, dth = case
    ch, n = 3, 128 * 37 + 48
    xr, xi = _planes(rng, ch, n, 0.3)
    m = n // 128 if seg else 1
    gains = _cuda(rng.uniform(0.5, 2.0, (ch, m)).astype(np.float32))
    ph = _cuda(rng.integers(0, 2 ** 32, ch).astype(np.int64)) if dth else None
    before = kernels.post_apply.launches
    got = kernels.post_apply(xr, xi, gains, seg, ph, dth, out_fmt=fmt)
    want = kernels.post_apply_ref(xr, xi, gains, seg, ph, dth, out_fmt=fmt)
    torch.cuda.synchronize()
    assert kernels.post_apply.launches == before + 1
    assert got.dtype == want.dtype
    assert _packed_codes_close(want, got, fmt)


@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("target", [None, 0.3], ids=["default-target", "target-0.3"])
@pytest.mark.parametrize("n", [200, 190512, 128 * 5000 + 77])
@pytest.mark.parametrize("profile", ["local", "dx"])
def test_agc_gains_matches_twin(rng, profile, n, target, rows):
    """The fused AGC kernel (segment energies and the gain loop) against
    rms_gains_ref: rows of one segment of 200, config #4's 1488 segments
    and a ragged 48, and 5000 segments (many shared-memory chunks), one
    row or 8 (a time fold: segments laid per row, one scan), at the
    default target (t2 a power of two: the chain's division is a
    multiplication) and at 0.3 (a division).  Bound: gains within 1e-4
    relative (the energies sum in another order; the loop's feedback
    keeps the sum of those roundings from growing)."""
    _need_card()
    from iq_tool_tpu_torch.ops import agc
    cfg = agc.AgcConfig.make(profile, 1_488_375.0, target)
    n_seg, seg, beta = agc.rms_params(cfg, n)
    ch = 5
    ramp = np.linspace(1e-2, 1.0, rows * n)[None, :]
    xr, xi = (_cuda((rng.standard_normal((ch, rows * n)) * 0.3 * ramp).astype(np.float32))
              for _ in range(2))
    g0 = _cuda(rng.uniform(0.5, 2.0, ch).astype(np.float32))
    e20 = _cuda(rng.uniform(0.0, 0.1, ch).astype(np.float32))
    before = kernels.rms_gains.launches
    got = kernels.rms_gains(xr, xi, g0, e20, beta, cfg.target, rows)
    want = kernels.rms_gains_ref(xr, xi, g0, e20, beta, cfg.target, rows)
    torch.cuda.synchronize()
    assert kernels.rms_gains.launches == before + 1
    assert got[0].shape == (ch, rows * n_seg)
    for w, g in zip(want, got):
        assert float(((g - w).abs() / w.abs().clamp(min=1e-30)).max()) <= 1e-4


@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("n", [200, 190512, 128 * 5000 + 77])
def test_segment_energies_matches_twin(rng, n, rows):
    """The AGC's segment energies alone (the fused kernel's producer
    warps, the sharded chain's energies) against segment_energies_ref:
    one segment of 200, config #4's 1488 and a ragged 5000, one row or 8.
    Bound: 1e-5 relative (a warp's sum against torch.mean's order over
    at most 131 products)."""
    _need_card()
    ch = 5
    ramp = np.linspace(1e-2, 1.0, rows * n)[None, :]
    xr, xi = (_cuda((rng.standard_normal((ch, rows * n)) * 0.3 * ramp).astype(np.float32))
              for _ in range(2))
    before = kernels.segment_energies.launches
    got = kernels.segment_energies(xr, xi, rows)
    want = kernels.segment_energies_ref(xr, xi, rows)
    torch.cuda.synchronize()
    assert kernels.segment_energies.launches == before + 1
    assert got.shape == want.shape == (ch, rows * kernels.agc_segments(n)[0])
    assert float(((got - want).abs() / want.abs()).max()) <= 1e-5


@pytest.mark.parametrize("target", [None, 0.3], ids=["default-target", "target-0.3"])
@pytest.mark.parametrize("n_seg", [1, 1488, 5000])
def test_agc_chain_matches_scan_twin(rng, n_seg, target):
    """The AGC's chain alone (the floor chip_smoke.py times) against
    rms_scan_ref on the same energies: one segment, config #4's 1488 and
    5000 (three shared-memory chunks), at the default target (t2 a power
    of two: the division as a multiplication) and at 0.3 (divided).  Both
    run the reference's float32 operations in its order: gains within
    1e-6 relative."""
    _need_card()
    from iq_tool_tpu_torch.ops import agc
    cfg = agc.AgcConfig.make("local", 1_488_375.0, target)
    _, _, beta = agc.rms_params(cfg, 190512)
    ch = 5
    e = _cuda((rng.uniform(0.0, 0.2, (ch, n_seg))
               * np.linspace(1e-4, 1.0, n_seg)[None, :]).astype(np.float32))
    g0 = _cuda(rng.uniform(0.5, 2.0, ch).astype(np.float32))
    e20 = _cuda(rng.uniform(0.0, 0.1, ch).astype(np.float32))
    got = kernels.agc_chain(e, g0, e20, beta, cfg.target)
    want = kernels.rms_scan_ref(e.T, g0, e20, beta, cfg.target)
    torch.cuda.synchronize()
    for w, g in zip((want[0].T, *want[1:]), got):
        assert g.shape == w.shape
        assert float(((g - w).abs() / w.abs()).max()) <= 1e-6


@pytest.mark.parametrize("case", [(2175, None, 190512), (2175, None, 3 * 8192),
                                  (5000, 16384, 5 * 8192 + 1234),
                                  (5000, None, 190512), (9000, 32768, 5 * 16384 + 1234)],
                         ids=["three-quarter-and-tail", "three-quarter-exact",
                              "half-and-tail", "nfft32768-three-quarter-and-tail",
                              "nfft32768-half-and-tail"])
def test_k5_matches_twin(rng, case):
    """nfft 16384: 3/4-advance windows then the re-anchored ragged tail
    (config #4's 190512 outputs), 3/4 with nothing left over, and a
    5000-tap filter forced to half advance; nfft 32768 (a 2-CTA cluster
    per window): 5000 taps at the default size (3/4 advance) and 9000
    taps with --filter-fft-size 32768 (half advance).  The kernel reads
    the carried tail and the block through two pointers.  >= 100 dB
    against torch.fft."""
    _need_card()
    from iq_tool_tpu_torch.ops.filters import StreamingFilter
    taps_n, fft_size, n = case
    taps = rng.standard_normal(taps_n).astype(np.complex64)
    taps /= np.abs(taps).sum()
    f = StreamingFilter(taps, "fft", fft_size)
    b = fft_size // 2 if fft_size else (16384 if taps_n > 4097 else 8192)
    assert not f._exec_banded and f.block == b
    assert f.osfft_advance == (b if fft_size else 3 * b // 2)
    ch = 3
    xr, xi = _planes(rng, ch, n, 0.3)
    sr, si = _planes(rng, ch, f.block, 0.3)
    before = kernels.osfft_apply.launches
    got = f.apply_planar(xr, xi, sr, si)
    torch.cuda.synchronize()
    assert kernels.osfft_apply.launches == before + 1
    ext_r, ext_i = torch.cat([sr, xr], -1), torch.cat([si, xi], -1)
    want = kernels.osfft_apply_ref(ext_r, ext_i, f._spectrum("cuda"), f.block,
                                   windows=f._schedule(n, "cuda"))
    for w, g in zip(want, got[:2]):
        assert g.shape == (ch, n)
        assert _snr(w, g) >= 100.0


def test_k5_nfft_65536_and_uniform_windows(rng):
    """A 10000-tap filter's nfft 65536 (a cluster of 4 CTAs per window),
    on the chain's schedule with the carried tail, and in the reference's
    own form: ext in one pair, uniform half advance."""
    _need_card()
    from iq_tool_tpu_torch.ops.filters import StreamingFilter
    taps = rng.standard_normal(10000).astype(np.complex64)
    taps /= np.abs(taps).sum()
    f = StreamingFilter(taps, "fft")
    b = f.block
    assert 2 * b == 65536
    spec = f._spectrum("cuda")
    assert spec.log2c == 2
    ch, n = 2, 3 * b + 777
    xr, xi = _planes(rng, ch, n, 0.3)
    sr, si = _planes(rng, ch, b, 0.3)
    kw = dict(windows=f._schedule(n, "cuda"), tail=(sr, si))
    before = kernels.osfft_apply.launches
    got = kernels.osfft_apply(xr, xi, spec, b, **kw)
    want = kernels.osfft_apply_ref(xr, xi, spec, b, **kw)
    ext = (xr[:, :3 * b], xi[:, :3 * b])
    got_u = kernels.osfft_apply(*(e.contiguous() for e in ext), spec, b, advance=b)
    want_u = kernels.osfft_apply_ref(*ext, spec, b, advance=b)
    torch.cuda.synchronize()
    assert kernels.osfft_apply.launches == before + 2
    for w, g in zip((*want, *want_u), (*got, *got_u)):
        assert _snr(w, g) >= 100.0


def test_general_chain_on_card_matches_cpu_chain(rng):
    """Config #4 at 16384 frames, 2 channels, 3 blocks: every kernel of
    the general step launches once per block, and the output agrees with
    the CPU chain to 4 codes past the notch's start-up ramp (its first
    1087 outputs are ~1e-5 of full scale, which the AGC lifts until the
    float32 FFT rounding of either path shows)."""
    _need_card()
    cfg = _general_cfg(16384, channels=2)
    gpu, cpu = Chain(cfg, device="cuda"), Chain(cfg, device="cpu")
    t = np.arange(3 * gpu.n_in) / 2.048e6
    x = 0.4 * np.exp(2j * np.pi * 37e3 * t) + 0.05
    x = x.real * 1.02 + 1j * (x.imag + 0.03 * x.real)       # I/Q imbalance
    pairs = np.stack([x.real, x.imag], -1).reshape(1, -1)
    raw = np.repeat(np.round(pairs * 32767).astype(np.int16), 2, axis=0)
    gc, cc = gpu.init_carry(), cpu.init_carry()
    kernels.reset_launch_counts()
    w = gpu.in_wire_len
    ramp = 2 * (gpu.post_filter.num_taps // 2)                # wire items
    for b in range(3):
        blk = torch.from_numpy(raw[:, b * w:(b + 1) * w])
        gc, go = gpu.step(gc, blk.cuda())
        cc, co = cpu.step(cc, blk)
        d = (go.cpu().to(torch.int64) - co.to(torch.int64)).abs()
        assert int(d[:, ramp if b == 0 else 0:].max()) <= 4
    assert (kernels.dc_block_apply.launches, kernels.banded_apply.launches,
            kernels.osfft_apply.launches, kernels.post_apply.launches,
            kernels.rms_gains.launches, kernels.iq_estimate.launches,
            kernels.banded_apply_dc.launches, kernels.dc_prologue.launches) == (
                3, 6, 3, 3, 3, 3, 0, 0)


def test_full4_chain_on_card_matches_cpu_chain(rng):
    """Config #4 without the DC block (the benchmark's full4 chain) at
    16384 frames, 2 channels, 3 blocks: the pre-stage is K3pre, one
    launch a step, and no DC kernel runs; the output agrees with the CPU
    chain to 4 codes past the notch's start-up ramp, as config #4's."""
    _need_card()
    from iq_tool_tpu_torch import profile_steps
    cfg = profile_steps.config("full4", 2, 16384)
    gpu, cpu = Chain(cfg, device="cuda"), Chain(cfg, device="cpu")
    t = np.arange(3 * gpu.n_in) / 2.048e6
    x = 0.4 * np.exp(2j * np.pi * 37e3 * t) + 0.05
    x = x.real * 1.02 + 1j * (x.imag + 0.03 * x.real)       # I/Q imbalance
    pairs = np.stack([x.real, x.imag], -1).reshape(1, -1)
    raw = np.repeat(np.round(pairs * 32767).astype(np.int16), 2, axis=0)
    gc, cc = gpu.init_carry(), cpu.init_carry()
    kernels.reset_launch_counts()
    w = gpu.in_wire_len
    ramp = 2 * (gpu.post_filter.num_taps // 2)                # wire items
    for b in range(3):
        blk = torch.from_numpy(raw[:, b * w:(b + 1) * w])
        gc, go = gpu.step(gc, blk.cuda())
        cc, co = cpu.step(cc, blk)
        d = (go.cpu().to(torch.int64) - co.to(torch.int64)).abs()
        assert int(d[:, ramp if b == 0 else 0:].max()) <= 4
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    assert counts == {"pre_apply": 3, "iq_estimate": 3, "banded_apply": 6,
                      "banded_apply_mma": 6, "osfft_apply": 3, "post_apply": 3,
                      "rms_gains": 3}, counts
    assert torch.equal(gc["nco_pre"].cpu(), cc["nco_pre"])
    assert torch.equal(gc["iq"].samples_since_opt.cpu(), cc["iq"].samples_since_opt)


def test_iq_descent_matches_twin(rng):
    """The estimator kernel's descent, unsmoothed (the calibration mode:
    no counter, always due), against its tensor-op twin on an imbalanced
    two-tone block from given factors: factors within 2 moves (a
    near-tie may go the other way when sums round differently), the
    power gate within 1e-4 dB relative."""
    _need_card()
    ch, n = 16, 1024
    x = _cuda(_imbalanced(rng, ch, n))
    f0 = _cuda((rng.standard_normal((ch, 2)) * 1e-3).astype(np.float32))
    before = kernels.iq_estimate.launches
    got, cnt, gate = kernels.iq_estimate(x.real, x.imag, f0, None, passes=25)
    want, _, want_gate = kernels.iq_estimate_ref(x.real, x.imag, f0, None, passes=25)
    torch.cuda.synchronize()
    assert kernels.iq_estimate.launches == before + 1 and cnt is None
    assert float((got - want).abs().max()) <= 2e-4 + 1e-7
    assert float(((gate - want_gate).abs() / want_gate.abs()).max()) <= 1e-4


def _imbalanced(rng, ch, n, noise=1e-3):
    """Tones at 0.07 and -0.19 of the rate behind a 1 % / 0.012 rad I/Q
    imbalance, plus noise: (C, n) complex64."""
    k = np.arange(n)
    x = (0.4 * np.exp(2j * np.pi * 0.07 * k) + 0.1 * np.exp(-2j * np.pi * 0.19 * k)
         + noise * (rng.standard_normal((ch, n)) + 1j * rng.standard_normal((ch, n))))
    return (x.real * 1.01 + 1j * (x.imag + 0.012 * x.real)).astype(np.complex64)


_IQ_CASES = ["cs16-dc", "cu8-dc", "cs8-dc", "cu16-dc", "planes-dc", "planes",
             "strided", "short-dc", "notdue", "noise"]


@pytest.mark.parametrize("case", _IQ_CASES)
def test_iq_estimate_matches_twin(rng, case):
    """The estimator of a step, whole, against its twin in each mode: the
    packed wires with the DC prefix, planes with and without it, planes
    with a stride (to_planar's views), a block shorter than 1024, a step
    that is not due (factors bit-identical, gate NaN) and noise that
    never passes the gate (the counter saturates).  Over 3 carried steps
    (due, due, not due at interval 2n): factors within 2 smoothed moves,
    the gate within 1e-3 dB, the counter exact, one launch a step."""
    _need_card()
    from iq_tool_tpu_torch.formats import get_format
    ch = 8
    n = 700 if case.startswith("short") else 4096
    x = (_imbalanced(rng, ch, 3 * n) if case != "noise" else
         (1e-3 * (rng.standard_normal((ch, 3 * n))
                  + 1j * rng.standard_normal((ch, 3 * n)))).astype(np.complex64))
    fac = _cuda((rng.standard_normal((ch, 2)) * 1e-3).astype(np.float32))
    cnt = torch.tensor(5 if case == "notdue" else 0xFFFFFFFF, dtype=torch.int64).cuda()
    want_f, want_c = fac, cnt
    dc = _cuda((rng.standard_normal((ch, 4)) * 0.05).astype(np.float32))
    interval = n + 1
    for step in range(3):
        blk = x[:, step * n:(step + 1) * n]
        kw = dict(dc_state=dc if "dc" in case else None, dc_alpha=DC_ALPHA)
        xr = xi = None
        if case.split("-")[0] in ("cs16", "cu8", "cs8", "cu16"):
            fmt = get_format(case.split("-")[0])
            raw = convert.from_planar(torch.from_numpy(blk.real.copy()),
                                      torch.from_numpy(blk.imag.copy()), fmt)
            wire, kind = convert.wire_pack(raw.cuda(), fmt)
            kw.update(wire_i32=wire, wire_norm=fmt.normalizer, wire_gain=1.0,
                      wire_kind=kind)
        elif case == "strided":
            xc = _cuda(blk)
            xr, xi = xc.real, xc.imag
        else:
            xr, xi = _cuda(blk.real), _cuda(blk.imag)
        before = kernels.iq_estimate.launches
        got = kernels.iq_estimate(xr, xi, fac, cnt, interval, n, **kw)
        want = kernels.iq_estimate_ref(xr, xi, want_f, want_c, interval, n, **kw)
        torch.cuda.synchronize()
        assert kernels.iq_estimate.launches == before + 1
        assert int(got[1]) == int(want[1])
        due = int(cnt) >= interval
        if due:
            assert float((got[0] - want[0]).abs().max()) <= 2 * 1e-4 * 0.05 * (step + 1) + 1e-7
            assert float((got[2] - want[2]).abs().max()) <= 1e-3
        else:
            assert torch.equal(got[0], fac)
            assert bool(torch.isnan(got[2]).all())
        if case == "noise":
            assert int(got[1]) == 0xF0000000 and torch.equal(got[0], fac)
        fac, cnt = got[0], got[1]
        want_f, want_c = want[0], want[1]


def test_iq_estimate_ticket_rearms_and_calibrates(rng):
    """Many channels and repeated launches: each launch's last CTA re-arms
    the ticket (the counter stays exact over 6 launches, on two
    streams); iq_balance.calibrate goes through the kernel (one launch
    of 250 passes) within 2 moves of the CPU's 10 rounds of 25."""
    _need_card()
    from iq_tool_tpu_torch.ops import iq_balance
    ch, n = 130, 2048
    x = _imbalanced(rng, ch, n)
    xr, xi = _cuda(x.real), _cuda(x.imag)
    state = iq_balance.init(ch, "cuda")
    want = iq_balance.init(ch, "cpu")
    side = torch.cuda.Stream()
    for k in range(6):
        with torch.cuda.stream(side if k % 2 else torch.cuda.current_stream()):
            state = iq_balance.maybe_update_planar(xr, xi, state, 3000)
        torch.cuda.synchronize()
        want = iq_balance.maybe_update_planar(xr.cpu(), xi.cpu(), want, 3000)
        assert int(state.samples_since_opt) == int(want.samples_since_opt)
    before = kernels.iq_estimate.launches
    cal = iq_balance.calibrate(_cuda(x[:, :1024]))
    assert kernels.iq_estimate.launches == before + 1
    want_cal = iq_balance.calibrate(torch.from_numpy(x[:, :1024]))
    assert float((cal.cpu() - want_cal).abs().max()) <= 2e-4 + 1e-7


def test_folded_on_card_matches_cpu_chain(rng):
    """FoldedChain at F = 4 on the card against the same fold on the CPU
    (config #4 at 16384 frames a row, one stream, 3 folded blocks; the
    AGC's gains one launch a step, segments laid per row): within 4
    codes past the notch's ramp."""
    _need_card()
    from iq_tool_tpu_torch.pipeline.folded import FoldedChain
    cfg = _general_cfg(16384, channels=1)
    gpu, cpu = FoldedChain(cfg, 4, device="cuda"), FoldedChain(cfg, 4, device="cpu")
    raw = rng.integers(-2 ** 13, 2 ** 13, (1, 3 * gpu.in_wire_len)).astype(np.int16)
    gc, cc = gpu.init_carry(), cpu.init_carry()
    kernels.reset_launch_counts()
    w = gpu.in_wire_len
    ramp = 2 * (gpu.local.post_filter.num_taps // 2)
    for b in range(3):
        blk = torch.from_numpy(raw[:, b * w:(b + 1) * w])
        gc, go = gpu.step(gc, blk.cuda())
        cc, co = cpu.step(cc, blk)
        d = (go.cpu().to(torch.int64) - co.to(torch.int64)).abs()
        assert int(d[:, ramp if b == 0 else 0:].max()) <= 4
    assert (kernels.dc_block_apply.launches, kernels.banded_apply.launches,
            kernels.osfft_apply.launches, kernels.post_apply.launches,
            kernels.rms_gains.launches) == (3, 6, 3, 3, 3)


def test_gather_chain_on_card_matches_cpu_chain(rng):
    """The gather stage (2469/200000) behind the DC kernel and in front
    of K4 on the card, against the CPU chain: within 4 codes."""
    _need_card()
    cfg = ChainConfig(input_format="cs16", output_format="cs16", input_rate=2_048_000.0,
                      target_rate=25_282.56, channels=2, dc_block=True,
                      agc_profile="local", target_block=16384)
    gpu, cpu = Chain(cfg, device="cuda"), Chain(cfg, device="cpu")
    assert gpu.resampler.plan.fallback
    raw = rng.integers(-2 ** 13, 2 ** 13, (2, 3 * gpu.in_wire_len)).astype(np.int16)
    gc, cc = gpu.init_carry(), cpu.init_carry()
    kernels.reset_launch_counts()
    w = gpu.in_wire_len
    for b in range(3):
        blk = torch.from_numpy(raw[:, b * w:(b + 1) * w])
        gc, go = gpu.step(gc, blk.cuda())
        cc, co = cpu.step(cc, blk)
        assert int((go.cpu().to(torch.int64) - co.to(torch.int64)).abs().max()) <= 4
    assert (kernels.dc_block_apply.launches, kernels.post_apply.launches,
            kernels.rms_gains.launches, kernels.banded_apply.launches,
            kernels.gather_apply.launches) == (3, 3, 3, 0, 3)


GATHER_PLANS = {"hackrf": (4766 / 64043, 256172),      # the HackRF cell: 10 Msps -> 744,187.5
                "2469": (2469 / 200000, 16384)}        # 449/36371, K = 1,298


def _gather_stage(plan):
    from iq_tool_tpu_torch.ops import resample as prs
    (st,) = prs.Resampler(*GATHER_PLANS[plan]).stages
    st.bind("cuda")
    return st


@pytest.mark.parametrize("plan,channels,rows", [("hackrf", 64, 1), ("hackrf", 64, 2),
                                                ("2469", 3, 1), ("2469", 3, 2)])
def test_gather_kernel_is_the_plan(rng, plan, channels, rows):
    """The gather kernel (csrc/gather.cu) at the HackRF plan (64
    channels) and 449/36371 (3 channels), over one and two row blocks
    after a carried history: >= 120 dB from the plan's float64
    definition, as test_gather_product_is_the_plan asks of the twin, and
    >= 100 dB from the twin on the card; two launches bit-identical, each
    counted, the twin counting none."""
    _need_card()
    st = _gather_stage(plan)
    pl = st.plan
    twin = kernels.Gather.build(pl.weights, pl.starts, pl.n_in, st.hist, "cuda", twin=True)
    n = rows * pl.n_in
    xr, xi = _planes(rng, channels, n)
    sr, si = _planes(rng, channels, st.hist)
    kernels.reset_launch_counts()
    yr, yi = kernels.gather_apply(xr, xi, sr, si, st.table)
    ar, ai = kernels.gather_apply(xr, xi, sr, si, st.table)
    tr, ti = kernels.gather_apply_ref(xr, xi, sr, si, twin)
    torch.cuda.synchronize()
    assert kernels.gather_apply.launches == 2
    assert torch.equal(yr, ar) and torch.equal(yi, ai)
    assert yr.shape == yi.shape == (channels, rows * pl.n_out)
    ext = torch.complex(torch.cat([sr, xr], -1).double(), torch.cat([si, xi], -1).double())
    w = torch.from_numpy(pl.weights).cuda().double().repeat(rows, 1)        # (rows M, K)
    outs = (torch.arange(rows, device="cuda")[:, None] * pl.n_in
            + torch.from_numpy(pl.starts).cuda().long()[None, :]).reshape(-1)
    want = torch.zeros((channels, outs.numel()), dtype=torch.complex128, device="cuda")
    for k in range(w.shape[1]):
        want += w[:, k] * ext[:, outs + k]
    snrs = [_snr(want.real, yr), _snr(want.imag, yi), _snr(tr, yr), _snr(ti, yi)]
    assert min(snrs[:2]) >= 120.0 and min(snrs[2:]) >= 100.0, snrs


def test_gather_kernel_refuses_bad_inputs(rng):
    """The wrapper checks device, dtype, shape and contiguity and raises;
    a CPU tensor runs the twin, which needs the twin's rows."""
    _need_card()
    st = _gather_stage("2469")
    n = st.plan.n_in
    xr, xi = _planes(rng, 2, n)
    sr, si = _planes(rng, 2, st.hist)
    g = st.table
    with pytest.raises(ValueError, match="multiple"):
        kernels.gather_apply(xr[:, :-1], xi[:, :-1], sr, si, g)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.gather_apply(torch.cat([xr, xr], -1)[:, ::2], xi, sr, si, g)
    with pytest.raises(ValueError, match="float32"):
        kernels.gather_apply(xr.double(), xi, sr, si, g)
    with pytest.raises(ValueError, match="history"):
        kernels.gather_apply(xr, xi, sr[:, 1:].contiguous(), si, g)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.gather_apply(xr, xi.cpu(), sr, si, g)
    with pytest.raises(ValueError, match="twin"):
        kernels.gather_apply(xr.cpu(), xi.cpu(), sr.cpu(), si.cpu(), g)


def test_gather_chain_graph_runs_the_kernel():
    """The HackRF chain (the benchmark's hackrf10) captured as a graph:
    the stage record lists the gather kernel under chain.resample.0 and
    no torch gather, and the stage's nodes are the kernel and the two
    history copies."""
    _need_card()
    from iq_tool_tpu_torch.pipeline import trace
    from iq_tool_tpu_torch.pipeline.graphed import GraphedStep
    from iq_tool_tpu_torch.profile_steps import config
    g = GraphedStep(Chain(config("hackrf10", 4), device="cuda"))
    g.capture()
    assert g.stage_kernels["chain.resample.0"] == {"gather_kernel": 1}
    assert trace.stage_kernels() == g.stage_kernels
    assert not any("embedding" in k for v in g.stage_kernels.values() for k in v)
    assert g.kernels["gather_apply"] == 1
    assert dict(g.stages)["chain.resample.0"] == 3


@pytest.mark.parametrize("fold", ["1", "4"])
def test_checkpoint_resume_on_card(tmp_path, fold):
    """--checkpoint then --resume on the card, the input cut off a block
    boundary: byte-identical to the uninterrupted run; the card's
    checkpoint loads into a CPU chain's carry."""
    _need_card()
    from iq_tool_tpu_torch.cli import main
    from iq_tool_tpu_torch.pipeline.checkpoint import load_checkpoint
    n = 16384 * 6
    t = np.arange(n) / 2.048e6
    x = 0.5 * np.exp(2j * np.pi * 80e3 * t)
    pairs = np.stack([x.real, x.imag], -1).reshape(-1)
    inp = tmp_path / "in.raw"
    inp.write_bytes(np.round(pairs * 32767).astype(np.int16).tobytes())
    base = ["-i", "raw-file", "-o", "raw", "--raw-file-input-rate", "2048000",
            "--raw-file-input-sample-format", "cs16", "--output-rate", "1488375",
            "--dc-block", "--freq-shift", "100000", "--lowpass", "400000",
            "--device", "cuda", "--time-fold", fold]
    full, half, part, ck = (tmp_path / f for f in ("full.raw", "half.raw", "part.raw",
                                                   "s.ckpt"))
    assert main(base + [str(inp), str(full)]) == 0
    half.write_bytes(inp.read_bytes()[:4 * (16384 * 3 + 1003)])
    assert main(base + [str(half), str(part), "--checkpoint", str(ck)]) == 0
    assert main(base + [str(inp), str(part), "--checkpoint", str(ck), "--resume"]) == 0
    assert part.read_bytes() == full.read_bytes()
    cpu = Chain(_chain_cfg("flagship", 16384), device="cpu")
    carry, fin, fout, _ = load_checkpoint(str(ck), cpu)
    assert carry["nco_pre"].device.type == "cpu" and fout == cpu.expected_out_frames(fin)


@pytest.mark.parametrize("name,mesh", [("flagship", (1, 1)), ("flagship", (1, 4)),
                                       ("flagship", (2, 2)), ("general", (1, 2))])
def test_sharded_on_card_matches_chain(rng, name, mesh):
    """The sharded chain on a mesh repeating cuda:0, 2 channels of 8192
    frames a shard, 3 steps, against Chain on the card at the per-shard
    framing: a 1 x 1 mesh byte-identical, the rest >= 60 dB and <= 32
    codes; each shard runs the DC kernel twice, and the general step's
    AGC its segment energies once a shard and its gain loop in the chain
    kernel once a step and slab."""
    _need_card()
    from iq_tool_tpu_torch.parallel import ShardedChain, make_mesh
    c_, t_ = mesh
    cfg = (_chain_cfg("flagship", 8192, channels=2) if name == "flagship"
           else _general_cfg(8192, channels=2))
    sc = ShardedChain(cfg, make_mesh(["cuda:0"] * (c_ * t_), c_, t_))
    ch = Chain(cfg, device="cuda")
    raw = _cuda(rng.integers(-2 ** 14, 2 ** 14, (2, 3 * sc.in_wire_len)).astype(np.int16))
    w = ch.in_wire_len
    c1, want = ch.init_carry(), []
    for k in range(3 * t_):
        c1, o = ch.step(c1, raw[:, k * w:(k + 1) * w])
        want.append(o)
    kernels.reset_launch_counts()
    cs, got = sc.init_carry(), []
    for k in range(3):
        cs, o = sc.step(cs, raw[:, k * t_ * w:(k + 1) * t_ * w])
        got.append(o)
    got, want = torch.cat(got, -1).cpu().numpy(), torch.cat(want, -1).cpu().numpy()
    if mesh == (1, 1):
        np.testing.assert_array_equal(got, want)
        return
    d = got.astype(np.float64) - want.astype(np.float64)
    assert np.abs(d).max() <= 32
    assert 10 * np.log10((want.astype(np.float64) ** 2).mean()
                         / max((d ** 2).mean(), 1e-300)) >= 60.0
    # the first DC pass is K3's entry on both paths; the second the
    # flagship's prologue (K1's) or the general step's K3
    shards = 3 * c_ * t_
    assert (kernels.dc_block_apply.launches, kernels.dc_prologue.launches) == (
        (2 * shards, 0) if name == "general" else (shards, shards))
    assert kernels.agc_chain.launches == (3 * c_ if name == "general" else 0)
    assert kernels.segment_energies.launches == (shards if name == "general" else 0)


def _graph_against_eager(ch, raws, reset=4, resume=None):
    """A GraphedStep of ``ch`` replayed over ``raws`` (a reset at step
    ``reset``, a carry from carry_from_numpy at ``resume``) against the
    eager step, bit for bit, outputs and carries; the captured kernels
    against the eager step's launches a step.  Returns the GraphedStep."""
    from iq_tool_tpu_torch.pipeline.graphed import GraphedStep, _leaves
    carry, want = ch.init_carry(), []
    for k, raw in enumerate(raws):
        kernels.reset_launch_counts()
        carry, out = ch.step(carry, raw, k == reset)
        eager = {k_: v for k_, v in kernels.launch_counts().items() if v}
        want.append((out.clone(), [t.clone() for t in _leaves(carry)]))
    g = GraphedStep(ch)
    carry = g.init_carry()
    for k, raw in enumerate(raws):
        g.input_buffer.copy_(raw)
        if k == resume:
            carry = g.carry_from_numpy(g.carry_to_numpy(carry))
        carry, out = g.step(carry, g.input_buffer, k == reset)
        assert torch.equal(out, want[k][0]), k
        for a, b in zip(_leaves(carry), want[k][1]):
            assert torch.equal(a, b), k
    assert g.replays == len(raws) and g.kernels == eager
    return g


@pytest.mark.parametrize("name,fold", [
    ("flagship", 1), ("general", 1), ("general", 4), ("1", 1), ("2", 1), ("3", 1),
    ("5", 1), ("gather", 1), ("4k32", 1), ("4k128", 1), ("4dx", 1), ("4dig", 1),
    ("full4", 1)],
    ids=["flagship", "general", "general-fold4", "config1", "config2", "config3",
         "config5", "gather", "4k32", "4k128", "4dx", "4dig", "full4"])
def test_graph_replays_equal_eager(rng, name, fold):
    """The step as one CUDA graph (pipeline/graphed.py), 8 replays with
    distinct inputs, a reset at the fifth and a carry from
    carry_from_numpy at the seventh, against the eager step bit for bit,
    outputs and carries: 4 channels of 262144 frames (64 DC tiles a
    channel, two look-back groups), so a DC launch replayed with the
    status words its previous replay left would take stale aggregates.
    Every chain profile_steps measures: the flagship, BASELINE configs
    #1-#5 (#3 on cu8), the gather stage, config #4 at nfft 32768 (K5's
    cluster) and 131072 (the torch.fft route), its dx and digital AGC,
    and without its DC block (full4).  The capture records the kernels a replay launches: the eager step's."""
    _need_card()
    from iq_tool_tpu_torch import profile_steps
    from iq_tool_tpu_torch.pipeline.folded import FoldedChain
    block = 262144 // fold
    if name in ("flagship", "general"):
        cfg = (_chain_cfg("flagship", block, channels=4) if name == "flagship"
               else _general_cfg(block, channels=4))
    else:
        cfg = profile_steps.config(name, 4, block)
    ch = FoldedChain(cfg, fold, device="cuda") if fold > 1 else Chain(cfg, device="cuda")
    dt = convert.wire_dtype(ch.fmt_in)
    lo, hi = (0, 256) if dt == np.uint8 else (-2 ** 14, 2 ** 14)
    raws = [_cuda(rng.integers(lo, hi, (4, ch.in_wire_len)).astype(dt)) for _ in range(8)]
    g = _graph_against_eager(ch, raws, resume=6)
    if name == "flagship":
        assert g.kernels == {"banded_apply": 1, "banded_apply_dc": 1, "dc_carry": 1}
    elif name == "general":
        # both K2 stages on the mma.sync core (narrow bands)
        assert g.kernels == {"banded_apply": 2, "banded_apply_mma": 2, "dc_block_apply": 1,
                             "post_apply": 1, "rms_gains": 1, "osfft_apply": 1,
                             "iq_estimate": 1}
    elif name == "4k128":
        assert g.kernels["overlap_save_fft"] == 1 and "osfft_apply" not in g.kernels
    elif name == "full4":
        # without the DC block the pre-stage is K3pre
        assert g.kernels == {"banded_apply": 2, "banded_apply_mma": 2, "pre_apply": 1,
                             "post_apply": 1, "rms_gains": 1, "osfft_apply": 1,
                             "iq_estimate": 1}


def test_graph_keeps_its_scratch_when_the_stream_grows(rng):
    """A graph's DC look-back buffer outlives its stream's table entry: a
    larger chain warmed up and captured on the first graph's capture
    stream grows that entry, a tensor made there afterwards does not get
    the old buffer's memory, and the first graph's replays stay the eager
    step's bit for bit."""
    _need_card()
    from iq_tool_tpu_torch.pipeline.graphed import GraphedStep, _leaves
    small = Chain(_chain_cfg("flagship", 8192, channels=2), device="cuda")
    raws = [_cuda(rng.integers(-2 ** 14, 2 ** 14, (2, small.in_wire_len)).astype(np.int16))
            for _ in range(3)]
    g = GraphedStep(small)
    g.capture()
    stream = g._parts[0].stream
    key = (torch.cuda.current_device(), stream.cuda_stream)
    old = kernels._DC_SCRATCH[key]
    ptr, size = old.data_ptr(), old.numel()
    del old
    big = Chain(_chain_cfg("flagship", 262144, channels=8), device="cuda")
    wire = _cuda(rng.integers(-2 ** 14, 2 ** 14, (8, big.in_wire_len)).astype(np.int16))
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        carry = big.init_carry()
        for _ in range(2):
            big.step(carry, wire)
        junk = torch.full((size,), 7, dtype=torch.uint8, device="cuda")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        big.step(carry, wire)
    torch.cuda.synchronize()
    assert kernels._DC_SCRATCH[key].numel() > size and junk.data_ptr() != ptr
    assert any(t.data_ptr() == ptr for t in g._scratch)
    carry, want = small.init_carry(), []
    for raw in raws:
        carry, out = small.step(carry, raw)
        want.append((out.clone(), [t.clone() for t in _leaves(carry)]))
    carry = g.init_carry()
    for k, raw in enumerate(raws):
        graph.replay()
        carry, out = g.step(carry, raw)
        assert torch.equal(out, want[k][0]), k
        assert all(torch.equal(a, b) for a, b in zip(_leaves(carry), want[k][1])), k
    torch.cuda.synchronize()
    assert int(junk.min()) == 7 and int(junk.max()) == 7


@pytest.mark.parametrize("name,mesh", [("flagship", (4, 1)), ("flagship", (1, 4)),
                                       ("flagship", (2, 2)), ("general", (1, 4)),
                                       ("general", (4, 1))])
def test_sharded_graph_replays_equal_eager(rng, name, mesh):
    """The sharded step as one CUDA graph on a mesh repeating cuda:0, 4
    channels of 16384 frames a shard, 6 replays with a reset and a carry
    from carry_from_numpy, against the eager ShardedChain step bit for
    bit, its captured kernels the eager step's launches."""
    _need_card()
    from iq_tool_tpu_torch.parallel import ShardedChain, make_mesh
    c_, t_ = mesh
    cfg = (_chain_cfg("flagship", 16384, channels=4) if name == "flagship"
           else _general_cfg(16384, channels=4))
    sc = ShardedChain(cfg, make_mesh(["cuda:0"] * (c_ * t_), c_, t_))
    raws = [_cuda(rng.integers(-2 ** 14, 2 ** 14, (4, sc.in_wire_len)).astype(np.int16))
            for _ in range(6)]
    _graph_against_eager(sc, raws, reset=2, resume=4)


def test_route_at_nfft_131072_on_card(rng):
    """Config #4's notch at nfft 131072 on the card: K5 refuses the size
    and names the route; the filter takes the torch.fft route, >= 100 dB
    from K5's twin on a ragged block."""
    _need_card()
    from iq_tool_tpu_torch import profile_steps
    from iq_tool_tpu_torch.ops import filters
    filt = Chain(profile_steps.config("4k128", 2, 131072), device="cuda").post_filter
    b, n = filt.block, 190512
    xr, xi, tr, ti = _planes(rng, 4, n) + _planes(rng, 4, b)
    with pytest.raises(NotImplementedError, match="overlap_save_fft"):
        kernels.osfft_apply(xr, xi, filt._h, b, tail=(tr, ti))
    before = kernels.launch_counts()
    got = filt.apply_planar(xr, xi, tr, ti)
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "overlap_save_fft": 1}
    windows = kernels.Windows.build(*filters.osfft_windows(n, b, (b,)), "cuda")
    want = kernels.osfft_apply_ref(xr, xi, filt._h, b, windows=windows, tail=(tr, ti))
    assert _snr(want[0], got[0]) >= 100.0 and _snr(want[1], got[1]) >= 100.0


def test_graph_capture_needs_warm_scratch(monkeypatch):
    """A DC launch captured on a stream whose look-back buffer was never
    made raises: the buffer would come from the graph's pool."""
    _need_card()
    monkeypatch.setattr(kernels, "_DC_SCRATCH", {})
    wire = torch.zeros((2, 8192), dtype=torch.int32, device="cuda")
    dc = torch.zeros((2, 4), dtype=torch.float32, device="cuda")
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="before the CUDA graph capture"):
        with torch.cuda.graph(g, stream=torch.cuda.Stream()):
            kernels.dc_block_apply(None, None, dc, DC_ALPHA, wire_i32=wire,
                                   wire_norm=get_format("cs16").normalizer)


def _ring_run(chain, payload, sizes):
    """The stream engine over ``payload`` (C, 2 n) cs16, each channel's
    stream cut into payloads of ``sizes`` bytes in turn: (the engine, each
    channel's output bytes)."""
    from iq_tool_tpu_torch.modules.base import Block, InputModule, OutputModule, SourceInfo
    from iq_tool_tpu_torch.pipeline.runtime import StreamEngine

    class Source(InputModule):
        name = "cut"

        def __init__(self, stream):
            self.stream = stream

        def initialize(self, config, args):
            return SourceInfo(sample_rate=2_048_000.0, sample_format="cs16")

        def blocks(self, frames_per_block):
            pos = 0
            for size in itertools.cycle(sizes):
                if pos >= len(self.stream):
                    return
                yield Block(self.stream[pos:pos + size])
                pos += size

    class Sink(OutputModule):
        name = "keep"
        requires_output_path = False

        def __init__(self):
            self.data = bytearray()

        def initialize(self, config, args):
            pass

        def write(self, payload):
            self.data.extend(payload)

    sinks = [Sink() for _ in payload]
    eng = StreamEngine(chain, [Source(row.tobytes()) for row in payload], sinks)
    eng.run()
    return eng, [bytes(s.data) for s in sinks]


@pytest.mark.parametrize("name", ["convert", "flagship"])
def test_engine_ring_on_card(rng, name):
    """The engine on the card over more blocks than its ring has slots,
    payloads cut at odd sizes, the last block partial: the slots are
    pinned, and each sink's bytes are the CPU engine's over the same
    stream (``convert``: a chain whose one kernel gives its twin's bits)
    or the card's chain stepped block by block over the zero-padded
    stream (``flagship``)."""
    _need_card()
    from iq_tool_tpu_torch import constants as C
    if name == "convert":
        cfg = ChainConfig(input_format="cs16", output_format="cs16", input_rate=2_048_000.0,
                          gain=0.9, channels=2, target_block=16384)
    else:
        cfg = _chain_cfg("flagship", 16384, channels=2)
    card = Chain(cfg, device="cuda")
    blocks = C.HOST_QUEUE_DEPTH + 6
    n = card.n_in * (blocks - 1) + 777
    payload = rng.integers(-2 ** 14, 2 ** 14, (2, 2 * n)).astype(np.int16)
    eng, got = _ring_run(card, payload, [1000, 50_000, 333])
    assert len(eng._ring.slots) < blocks
    assert all(s.is_pinned() for s in eng._ring.slots)
    if name == "convert":
        _, want = _ring_run(Chain(cfg, device="cpu"), payload, [4096])
    else:
        wire = np.zeros((2, blocks * card.in_wire_len), np.int16)
        wire[:, :2 * n] = payload
        carry, outs = card.init_carry(), []
        for b in np.split(wire, blocks, axis=1):
            carry, out = card.step(carry, _cuda(b))
            outs.append(out.cpu().numpy())
        want = [row[:2 * card.expected_out_frames(n)].tobytes()
                for row in np.concatenate(outs, -1)]
    assert got == want
