"""The port's CUDA kernels against their plain twins, on a CUDA card.

Every test here is marked ``gpu`` and skips without a card.  The file
imports no jax, so it also runs on a machine that has only torch:

    pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` because tests/conftest.py configures jax).  Bounds:
kernel and twin differ only in the order of float32 sums, so planar
outputs are held to >= 100 dB and packed codes to |delta| <= 1.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iq_tool_tpu.formats import get_format  # noqa: E402
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
def test_k2_engages_at_any_stride(rng, which):
    _need_card()
    name, idx, stride = which
    st = _stage(name, 16384, idx)
    assert st.stride == stride
    ch, n = 4, 40 * st.stride
    xr, xi = _planes(rng, ch, n)
    sr, si = _planes(rng, ch, st.hist)
    before = kernels.banded_apply.launches
    got = kernels.banded_apply(sr, si, xr, xi, st.band, None, st.stride, st.hist)
    torch.cuda.synchronize()
    assert kernels.banded_apply.launches == before + 1
    want = kernels.banded_apply_ref(sr, si, xr, xi, st.band, None, st.stride, st.hist)
    for w, g in zip(want, got):
        assert _snr(w, g) >= 100.0


@pytest.mark.parametrize("fmt", ["cs16", "sc16q11", "cu16", "cu8", "cs8"])
def test_k2_wire_nco_packed_formats(rng, fmt):
    _need_card()
    st = _stage("flagship", 131072, 0)
    ch, n = 3, 24 * st.stride
    wire, kind = _random_wire(rng, fmt, ch, n)
    sr, si = _planes(rng, ch, st.hist)
    ph = _cuda(rng.integers(0, 2 ** 32, ch).astype(np.int64))
    args = (sr, si, None, None, st.band, None, st.stride, st.hist)
    kw = dict(wire_i32=wire, wire_norm=get_format(fmt).normalizer,
              wire_gain=0.7, nco_dtheta=DTHETA, nco_phase=ph, wire_kind=kind)
    got = kernels.banded_apply(*args, pack_fmt=fmt, **kw)
    want = kernels.banded_apply_ref(*args, pack_fmt=fmt, **kw)
    assert got.dtype == want.dtype
    assert _packed_codes_close(want, got, fmt)
    got_p = kernels.banded_apply(*args, **kw)
    want_p = kernels.banded_apply_ref(*args, **kw)
    for w, g in zip(want_p, got_p):
        assert _snr(w, g) >= 100.0


def test_k2_complex_taps(rng):
    _need_card()
    st = Chain(_chain_cfg("flagship", 16384), device="cpu").resampler.stages[1]
    st.compose_output_fir(np.exp(2j * np.pi * 0.1 * np.arange(9)) / 9)
    st.bind("cuda")
    assert st.band.taps_i is not None
    ch, n = 2, 30 * st.stride
    xr, xi = _planes(rng, ch, n)
    sr, si = _planes(rng, ch, st.hist)
    got = kernels.banded_apply(sr, si, xr, xi, st.band, None, st.stride, st.hist)
    want = kernels.banded_apply_ref(sr, si, xr, xi, st.band, None, st.stride, st.hist)
    for w, g in zip(want, got):
        assert _snr(w, g) >= 100.0


@pytest.mark.parametrize("case", [("flagship", "cs16", DTHETA), ("nrsc5", "cu8", 0)])
def test_k1_matches_twin(rng, case):
    _need_card()
    name, fmt, dth = case
    st = _stage(name, 131072, 0)
    ch, n = 4, 3 * 4096 + 7 * st.stride       # whole and partial prologue chunks
    wire, kind = _random_wire(rng, fmt, ch, n)
    sr, si = _planes(rng, ch, st.hist, 0.05)
    dc = _cuda((rng.standard_normal((ch, 4)) * 0.05).astype(np.float32))
    ph = _cuda(rng.integers(0, 2 ** 32, ch).astype(np.int64)) if dth else None
    args = (sr, si, dc, DC_ALPHA, st.band, None, st.stride, st.hist, wire,
            get_format(fmt).normalizer, 1.0, dth, ph)
    before = kernels.banded_apply_dc.launches
    got = kernels.banded_apply_dc(*args, wire_kind=kind)
    want = kernels.banded_apply_dc_ref(*args, wire_kind=kind)
    torch.cuda.synchronize()
    assert kernels.banded_apply_dc.launches == before + 1
    for w, g in zip((*want[0], *want[1:]), (*got[0], *got[1:])):
        assert _snr(w, g) >= 100.0


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
    w = gpu.in_wire_len
    for b in range(3):
        blk = torch.from_numpy(raw[:, b * w:(b + 1) * w])
        gc, go = gpu.step(gc, blk.cuda())
        cc, co = cpu.step(cc, blk)
        d = (go.cpu().to(torch.int64) - co.to(torch.int64)).abs().max()
        assert int(d) <= 4
    assert kernels.banded_apply_dc.launches == k1 + 3
    assert kernels.banded_apply.launches == k2 + 3


def test_wrappers_refuse_mixed_devices(rng):
    _need_card()
    st = _stage("flagship", 16384, 1)
    xr, xi = _planes(rng, 1, 4 * st.stride)
    with pytest.raises(ValueError):
        kernels.banded_apply(torch.zeros((1, st.hist)), torch.zeros((1, st.hist)),
                             xr, xi, st.band, None, st.stride, st.hist)
