"""The torch port's host-side ops against the JAX package on the same
numpy inputs: format conversion bit for bit on all 16 formats, the NCO
and the DC blocker within float rounding."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iq_tool_tpu.formats import FORMATS, get_format  # noqa: E402
from iq_tool_tpu.ops import convert as jconvert  # noqa: E402
from iq_tool_tpu.ops import dc_block as jdc  # noqa: E402
from iq_tool_tpu.ops import nco as jnco  # noqa: E402
from iq_tool_tpu_torch.ops import convert, dc_block, nco  # noqa: E402
from tests import ref_dsp  # noqa: E402
from tests.test_convert import _random_wire  # noqa: E402

ALL_FORMATS = sorted(FORMATS)
PACKABLE = ["cs16", "sc16q11", "cu16", "cu8", "cs8"]
COMPLEX_FORMATS = sorted(n for n, f in FORMATS.items() if f.is_complex)


def _wire(rng, name, n_frames, channels=3):
    fmt = get_format(name)
    if not fmt.is_complex:
        info = np.iinfo(fmt.wire_dtype) if fmt.wire_dtype.kind in "iu" else None
        if info is None:
            return rng.standard_normal((channels, n_frames)).astype(np.float32)
        return rng.integers(info.min, int(info.max) + 1, (channels, n_frames),
                            dtype=fmt.wire_dtype)
    return np.stack([_random_wire(rng, name, n_frames) for _ in range(channels)])


@pytest.mark.parametrize("gain", [1.0, 2.5])
@pytest.mark.parametrize("fmt", ALL_FORMATS)
def test_to_planar_bit_identical(rng, fmt, gain):
    raw = _wire(rng, fmt, 2048)
    if not get_format(fmt).is_complex:
        for mod, arr in ((jconvert, raw), (convert, torch.from_numpy(raw))):
            with pytest.raises(ValueError):
                mod.to_planar(arr, fmt, gain)
        return
    want = jconvert.to_planar(raw, fmt, gain)
    got = convert.to_planar(torch.from_numpy(raw), fmt, gain)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("fmt", ALL_FORMATS)
def test_from_planar_bit_identical(rng, fmt):
    xr = (rng.standard_normal((2, 4096)) * 0.45).astype(np.float32)
    xi = (rng.standard_normal((2, 4096)) * 0.45).astype(np.float32)
    # exact halves, clipping extremes, zeros and tiny values
    edge = np.array([0, 1.5, -1.5, 2.0, -2.0, 0.5 / 32767.0, -0.5 / 32767.0,
                     1.0, 0.5 / 127.0, -0.5 / 127.0], np.float32)
    xr[0, :edge.size] = edge
    xi[1, :edge.size] = edge[::-1]
    if not get_format(fmt).is_complex:
        with pytest.raises(ValueError):
            convert.from_planar(torch.from_numpy(xr), torch.from_numpy(xi), fmt)
        return
    want = np.asarray(jconvert.from_planar(xr, xi, fmt))
    got = convert.from_planar(torch.from_numpy(xr), torch.from_numpy(xi), fmt).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # and the reference's own numpy oracle agrees for the exact formats
    if fmt not in ("cs32", "cu32"):
        np.testing.assert_array_equal(
            got[0], ref_dsp.from_cf32((xr[0] + 1j * xi[0]).astype(np.complex64), fmt))


@pytest.mark.parametrize("fmt", COMPLEX_FORMATS)
def test_wire_pack_and_decode_bit_identical(rng, fmt):
    raw = _wire(rng, fmt, 1024)
    jp = jconvert.wire_pack(raw, fmt)
    tp = convert.wire_pack(torch.from_numpy(raw), fmt)
    assert (jp is None) == (tp is None) == (fmt not in PACKABLE)
    if tp is None:
        return
    (jw, jkind), (tw, tkind) = jp, tp
    assert jkind == tkind
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    norm = get_format(fmt).normalizer
    for g, w in zip(convert.decode_packed(tw, tkind, norm, 1.5),
                    jconvert.decode_packed(jw, jkind, norm, 1.5)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # packed_to_wire inverts wire_pack: the same bytes as the wire
    back = convert.packed_to_wire(tw, fmt).numpy()
    assert back.dtype == raw.dtype
    np.testing.assert_array_equal(back, raw)


def test_nco_matches_jax(rng):
    ch, n = 4, 5000
    acc = rng.integers(0, 2 ** 32, (ch,), dtype=np.uint32)
    dth = jnco.freq_to_dtheta(-123456.7, 2_048_000.0)
    assert nco.freq_to_dtheta(-123456.7, 2_048_000.0) == int(dth)
    xr = rng.standard_normal((ch, n)).astype(np.float32)
    xi = rng.standard_normal((ch, n)).astype(np.float32)
    jr, ji, jacc = jnco.apply_planar(xr, xi, acc, dth)
    tr, ti, tacc = nco.apply_planar(torch.from_numpy(xr), torch.from_numpy(xi),
                                    torch.from_numpy(acc.astype(np.int64)), int(dth))
    np.testing.assert_array_equal(tacc.numpy().astype(np.uint32), np.asarray(jacc))
    for g, w in ((tr, jr), (ti, ji)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [4096, 3000])      # tiled and flat-scan forms
def test_dc_block_matches_jax(rng, n):
    ch = 3
    alpha = jdc.alpha_for_rate(2_048_000.0)
    jst = jdc.init_planar(ch)
    tst = dc_block.init_planar(ch)
    for _ in range(3):
        xr = (rng.standard_normal((ch, n)) * 0.3 + 0.2).astype(np.float32)
        xi = (rng.standard_normal((ch, n)) * 0.3 - 0.1).astype(np.float32)
        jr, ji, jst = jdc.apply_planar(xr, xi, jst, alpha)
        tr, ti, tst = dc_block.apply_planar(torch.from_numpy(xr),
                                            torch.from_numpy(xi), tst, alpha)
        want = np.asarray(jr) + 1j * np.asarray(ji)
        assert ref_dsp.snr_db(want, tr.numpy() + 1j * ti.numpy()) >= 90.0
    jstate = np.stack([np.asarray(v) for v in jst], axis=-1)
    assert ref_dsp.snr_db(jstate, tst.numpy()) >= 90.0
