"""The chain's pre-stage without a DC block (K3pre, ``kernels.pre_apply``)
on the CPU: its plain twin and ``Chain._pre`` against the torch-op route
that ran the stage before the kernel (decode, I/Q apply, pre-NCO; the I/Q
estimator on the converted planes), bit for bit over cs16, cu8 and cf32
input, I/Q correction and pre-NCO on and off, odd and even N.  The kernel
itself is held against the twin on the card in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iq_tool_tpu_torch.formats import get_format  # noqa: E402
from iq_tool_tpu_torch.ops import convert, iq_balance, kernels, nco  # noqa: E402
from iq_tool_tpu_torch.pipeline.chain import Chain, ChainConfig  # noqa: E402

RATE = 8000.0          # the estimator's interval is 4000 frames: due every other block
SHIFT_HZ = 1234.5
GAIN = 1.25
FORMATS = ["cs16", "cu8", "cf32"]


def _wire(rng, fmt, ch, n):
    """A tone and noise behind an I/Q imbalance, as the (ch, 2n) wire of
    `fmt`."""
    t = np.arange(n) / RATE
    x = (0.4 * np.exp(2j * np.pi * 300.0 * t)[None, :]
         + 0.05 * (rng.standard_normal((ch, n)) + 1j * rng.standard_normal((ch, n))))
    xr = torch.from_numpy((x.real * 1.03).astype(np.float32))
    xi = torch.from_numpy((x.imag + 0.04 * x.real).astype(np.float32))
    return convert.from_planar(xr, xi, fmt)


def _old_pre(chain, raw, carry, new):
    """The no-DC pre-stage as torch ops, as Chain._pre ran it before K3pre."""
    cfg = chain.cfg
    xr, xi = convert.to_planar(raw, chain.fmt_in, cfg.gain)
    if cfg.iq_correction:
        new["iq"] = iq_balance.maybe_update_planar(xr, xi, carry["iq"], chain.iq_interval)
        xr, xi = iq_balance.apply_planar(xr, xi, new["iq"].factors)
    if chain.dtheta_pre:
        xr, xi, new["nco_pre"] = nco.apply_planar(xr, xi, carry["nco_pre"],
                                                  chain.dtheta_pre)
    return xr.contiguous(), xi.contiguous()


def _chain(fmt, iq, shift, n):
    return Chain(ChainConfig(input_format=fmt, output_format="cs16", input_rate=RATE,
                             channels=2, gain=GAIN, iq_correction=iq,
                             freq_shift_pre_hz=SHIFT_HZ if shift else 0.0,
                             target_block=n), device="cpu")


GRID = pytest.mark.parametrize("n", [4096, 4097], ids=["even", "odd"])
IQ = pytest.mark.parametrize("iq", [True, False], ids=["iq", "no-iq"])
SHIFT = pytest.mark.parametrize("shift", [True, False], ids=["nco", "no-nco"])


@GRID
@IQ
@SHIFT
@pytest.mark.parametrize("fmt", FORMATS)
def test_pre_apply_twin_is_the_old_route(fmt, iq, shift, n):
    rng = np.random.default_rng(7)
    raw = _wire(rng, fmt, 3, n)
    factors = (torch.from_numpy((rng.standard_normal((3, 2)) * 0.02).astype(np.float32))
               if iq else None)
    phase = torch.from_numpy(rng.integers(0, 2 ** 32, 3).astype(np.int64))
    dth = nco.freq_to_dtheta(SHIFT_HZ, RATE) if shift else 0
    fm = get_format(fmt)
    want = convert.to_planar(raw, fm, GAIN)
    if iq:
        want = iq_balance.apply_planar(*want, factors)
    if dth:
        want = nco.mix(*want, phase, dth)
    packed = convert.wire_pack(raw, fm)
    if packed is None:
        args = convert.to_planar(raw, fm, GAIN)
        src = {}
    else:
        args = (None, None)
        src = dict(wire_i32=packed[0], wire_norm=fm.normalizer, wire_gain=GAIN,
                   wire_kind=packed[1])
    before = kernels.pre_apply.launches
    for fn in (kernels.pre_apply_ref, kernels.pre_apply):
        got = fn(*args, factors, phase if dth else None, dth, **src)
        for w, g in zip(want, got):
            assert g.is_contiguous() and g.dtype == torch.float32
            assert torch.equal(w, g)
    assert kernels.pre_apply.launches == before          # CPU: the twin


@GRID
@IQ
@SHIFT
@pytest.mark.parametrize("fmt", FORMATS)
def test_chain_pre_is_the_old_route(fmt, iq, shift, n):
    """Chain._pre over 4 carried blocks, against the old route fed the
    same carries: the planes, the nco_pre carry and the estimator's
    factors and counter bit for bit.  The estimator now reads the packed
    wire's prefix where the old route read the converted planes; the two
    decode the same values."""
    chain = _chain(fmt, iq, shift, n)
    assert not chain._wire_resample and "dc" not in chain.init_carry()
    raw = _wire(np.random.default_rng(11), fmt, 2, 4 * n)
    items = chain.fmt_in.items_per_frame
    carry = old = chain.init_carry()
    updates = 0
    for b in range(4):
        blk = raw[:, b * n * items:(b + 1) * n * items]
        new, new_old = dict(carry), dict(old)
        got = chain._pre(blk, carry, new)
        want = _old_pre(chain, blk, old, new_old)
        for w, g in zip(want, got):
            assert torch.equal(w, g), b
        assert torch.equal(new["nco_pre"], new_old["nco_pre"])
        if iq:
            assert torch.equal(new["iq"].factors, new_old["iq"].factors), b
            assert torch.equal(new["iq"].samples_since_opt,
                               new_old["iq"].samples_since_opt), b
            updates += int(new["iq"].samples_since_opt) == 0
        carry, old = new, new_old
    assert not iq or updates == 2                    # blocks 0 and 2 fell due
    assert not shift or int(carry["nco_pre"][0]) == nco.advance(
        torch.zeros(1, dtype=torch.int64), 4 * n, chain.dtheta_pre)[0]


def test_pre_apply_refuses_what_it_cannot_run():
    w = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="wire_norm"):
        kernels.pre_apply(None, None, wire_i32=w)
    with pytest.raises(ValueError, match="phase_acc"):
        kernels.pre_apply(None, None, dtheta=5, wire_i32=w, wire_norm=1.0)
    assert "pre_apply" in kernels.launch_counts()
