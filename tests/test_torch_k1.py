"""K1 as the card runs it, emulated on the CPU: the DC kernel's carry pass
(csrc/banded_dc.cu iq_dc_carry) and the banded kernel's DC-wire loader
(csrc/banded.cu stage_dc), held against the plain twin of K1
(kernels.banded_apply_dc_ref) and against the JAX package.

* The carry pass's twin (kernels.dc_carry_ref) gives each window
  group's float64 DC state and halo, the tail and the new DC state; an
  emulation of the kernel's index arithmetic (which thread writes which
  state and halo entry) is held to the twin's layout, also where the
  halos are wider than a group.
* The fused loader is emulated in float64 numpy as the kernel computes
  it: a group's new samples in rows of ``per`` (odd) a thread, each row
  from y = 0, a 5-level warp scan and a Horner pass over the warp totals,
  each row rerun from the carry pass's state before the group, rounded
  to float32 once, NCO-mixed at its index; the group's span is the
  carry pass's halo (the carried history for group 0) and those
  samples, multiplied by ops/banded.py apply_planar.

Bounds: the emulation and the twin differ only in the order of float64
sums (rounded once to float32) and of float32 products, so K1's outputs,
tails and DC state are held to >= 100 dB; against the JAX package (its
Pallas K1 in interpret mode multiplies in 3-term split bf16, ~88 dB) to
>= 80 dB, as tests/test_torch_kernels.py holds the twins.  Blocks are
ragged: n is not a multiple of the 32-window group, and at nrsc5's
stride 400 the group boundaries (every 12800 samples) fall inside the DC
kernel's 4096-sample tiles.  Three blocks are carried.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from iq_tool_tpu.ops import banded as jbanded  # noqa: E402
from iq_tool_tpu.ops import pallas_kernels  # noqa: E402
from iq_tool_tpu_torch.formats import get_format  # noqa: E402
from iq_tool_tpu_torch.ops import banded, convert, kernels, nco  # noqa: E402
from iq_tool_tpu_torch.ops.fir_design import FilterRequest  # noqa: E402
from iq_tool_tpu_torch.pipeline.chain import Chain, ChainConfig  # noqa: E402
from tests import ref_dsp  # noqa: E402

CH = 4
DC_ALPHA = 3.0679615757712826e-05        # 10 Hz pole at 2.048 Msps
DTHETA = 209715200                       # +100 kHz at 2.048 Msps
BLOCKS = 3
THREADS = 512                            # csrc/banded.cu K1: four warpgroups


def _stage0(name):
    if name == "flagship":
        cfg = ChainConfig(input_format="cs16", output_format="cs16",
                          input_rate=2_048_000.0, target_rate=1_488_375.0,
                          dc_block=True, freq_shift_pre_hz=100e3,
                          filters=(FilterRequest("lowpass", 400e3),),
                          target_block=131072)
    else:
        cfg = ChainConfig(input_format="cu8", output_format="cu8",
                          input_rate=2_400_000.0, target_rate=1_488_375.0,
                          dc_block=True, target_block=131072)
    return Chain(cfg, device="cpu").resampler.stages[0]


def _wire(rng, fmt, n, ch=CH):
    """A tone behind noise and a DC offset, packed (convert.wire_pack)."""
    k = np.arange(n)
    x = 0.3 * np.exp(2j * np.pi * 0.013 * k) + 0.1 + 0.05 * (
        rng.standard_normal((ch, n)) + 1j * rng.standard_normal((ch, n)))
    pairs = np.stack([x.real, x.imag], -1).reshape(ch, 2 * n)
    if fmt == "cs16":
        raw = np.clip(np.round(pairs * 32767), -32768, 32767).astype(np.int16)
    else:
        raw = np.clip(np.round(pairs * 127.5 + 127.5), 0, 255).astype(np.uint8)
    return convert.wire_pack(torch.from_numpy(raw), fmt)


def _snr(want, got):
    return ref_dsp.snr_db(np.asarray(want, np.float64).ravel(),
                          np.asarray(got, np.float64).ravel())


# ------------------------------------------------------- the carry pass's writes

def _carry_writes_emulated(n, bw, groups, hist, per=kernels.DC_PER,
                           tile=kernels.DC_TILE, group=kernels.DC_GROUP):
    """Which sample of the block the carry pass writes into each group
    state, halo and tail entry, by the kernel's own arithmetic: a tile
    that keeps nothing (and ends no look-back group) stops after its
    aggregate; in the others each thread's row of `per` samples from f
    finds the row position of the sample before the next boundary and a
    bit mask of the samples it keeps (those in the halos touching the
    row and in the tail); tile 0 writes group 0's state (-1 below: the
    carried state) and zeroes the halo entries before the block (-2).
    Returns ({g: sample}, {(g, j): sample}, {j: sample})."""
    bound, halo, tail = {0: -1}, {}, {}
    for g in range(groups):
        for j in range(max(0, hist - g * bw)):
            halo[(g, j)] = -2

    def span(f, lo, hi):
        lo, hi = max(lo - f, 0), min(hi - f, per)
        return ((1 << hi) - 1) & ~((1 << lo) - 1) if lo < hi else 0

    tiles = -(-n // tile)

    def keeps(t):
        s0, length, h = t * tile, min(tile, n - t * tile), max(hist, 1)
        g1 = s0 // bw + 1
        return (s0 + length > n - h or (g1 < groups and g1 * bw - h < s0 + length)
                or (t % group == group - 1 and t + 1 < tiles))

    for f in range(0, n, per):
        if not keeps(f // tile):
            continue
        g_lo = f // bw + 1
        rec_j = g_lo * bw - 1 - f if g_lo < groups and g_lo * bw <= f + per else -1
        g_hi = min(groups - 1, (f + per - 1 + hist) // bw)
        keep = span(f, g_lo * bw - hist, g_hi * bw) if g_lo <= g_hi else 0
        keep |= span(f, n - hist, n)
        for j in range(min(per, n - f)):
            idx = f + j
            if j == rec_j:
                assert (idx + 1) // bw not in bound
                bound[(idx + 1) // bw] = idx
            if keep >> j & 1:
                if idx >= n - hist:
                    tail[idx - (n - hist)] = idx
                g = idx // bw + 1
                while g < groups and g * bw - hist <= idx:
                    halo[(g, idx - (g * bw - hist))] = idx
                    g += 1
    return bound, halo, tail


@pytest.mark.parametrize("geo", [(40 * 512 + 77, 512, 31), (37 * 400 + 123, 400, 31),
                                 (200, 1, 70), (6 * 64 + 5, 2, 63), (300, 2, 64),
                                 (16 * 16 * 3, 16, 0), (70 * 4096 + 9, 512, 31),
                                 (9 * 4096, 16, 0)],
                         ids=["flagship", "nrsc5", "halo-over-groups", "halo-near-group",
                              "halo-one-group", "no-history", "two-look-back-groups",
                              "no-history-many-tiles"])
def test_carry_pass_writes_every_entry_once_in_place(geo):
    """Every group state is the sample just before its group, every halo
    and tail entry the sample it stands for (zero before the block): the
    carry pass leaves nothing of its outputs unwritten, also where the
    halo (70, 63 or 64 samples) is wider than a group (32), nearly as
    wide or as wide (64)."""
    n, s, hist = geo
    bw, groups = kernels.BAND_WIN * s, kernels.dc_groups(n, s)
    bound, halo, tail = _carry_writes_emulated(n, bw, groups, hist)
    assert bound == {g: (g * bw - 1 if g else -1) for g in range(groups)}
    assert halo == {(g, j): (g * bw - hist + j if g * bw - hist + j >= 0 else -2)
                    for g in range(groups) for j in range(hist)}
    assert tail == {j: n - hist + j for j in range(hist)}


# ---------------------------------------------------------- the fused loader

def _group_scan_emulated(x, x_prev, y_prev, a, per, threads):
    """stage_dc's float64 decomposition of y[k] = a y[k-1] + x[k] -
    x[k-1] over one group's L new samples, from the state before it
    (x_prev, y_prev: (C,)): rows of `per` a thread from y = 0, the warp
    scan, the Horner pass over the warp totals, each row rerun from its
    incoming y.  x: (C, L) float64; returns y (C, L) float64."""
    c, length = x.shape
    assert per % 2 == 1 and per * threads >= length
    warps = threads // 32
    tot = threads * per
    valid = (np.arange(tot) < length).reshape(threads, per)
    xp = np.zeros((c, tot))
    xp[:, :length] = x
    b = (xp - np.concatenate([x_prev[:, None], xp[:, :-1]], axis=1)).reshape(
        c, threads, per)
    e = np.zeros((c, threads))
    for j in range(per):
        e = np.where(valid[:, j], a * e + b[..., j], e)
    s = e.reshape(c, warps, 32).copy()
    for k in range(5):
        off = 1 << k
        prev = s.copy()
        s[..., off:] = prev[..., off:] + a ** (per * off) * prev[..., :-off]
    ex = np.concatenate([np.zeros((c, warps, 1)), s[..., :-1]], axis=-1)
    before = np.zeros((c, warps))
    for w in range(1, warps):
        before[:, w] = a ** (32 * per) * before[:, w - 1] + s[:, w - 1, -1]
    z = (ex + a ** (per * np.arange(32)) * before[..., None]).reshape(c, threads)
    y = z + a ** (per * np.arange(threads)) * y_prev[:, None]
    out = np.zeros((c, threads, per))
    for j in range(per):
        y = np.where(valid[:, j], a * y + b[..., j], y)
        out[..., j] = y
    return out.reshape(c, -1)[:, :length]


def _k1_emulated(state_r, state_i, carry, wire, kind, norm, st, dth, phase, threads):
    """K1's banded kernel with the DC-wire loader, group by group, from
    the carry pass's outputs (bound, halo_r, halo_i, ...)."""
    bound, halo_r, halo_i = (t.numpy() for t in carry[:3])
    s, hist = st.stride, st.hist
    xr, xi = (t.double().numpy() for t in convert.decode_packed(wire, kind, norm, 1.0))
    n = xr.shape[-1]
    nb, bw = n // s, kernels.BAND_WIN * s
    per = -(-bw // threads) | 1
    a = 1.0 - DC_ALPHA
    outs_r, outs_i = [], []
    assert hist <= bw
    for g in range(kernels.dc_groups(n, s)):
        p = g * bw
        length = min(bw, nb * s - p)
        yr, yi = (torch.from_numpy(_group_scan_emulated(
            x[:, p:p + length], bound[:, g, 2 + k], bound[:, g, k], a, per,
            threads).astype(np.float32)) for k, x in enumerate((xr, xi)))
        if dth:
            yr, yi = nco.mix(yr, yi, phase, dth, start=p)
        hr, hi = ((state_r, state_i) if g == 0 else
                  (torch.from_numpy(halo_r[:, g]), torch.from_numpy(halo_i[:, g])))
        o_r, o_i = banded.apply_planar(hr, hi, yr, yi, st.band.a_r, None, s, hist)
        outs_r.append(o_r)
        outs_i.append(o_i)
    return torch.cat(outs_r, -1), torch.cat(outs_i, -1)


def test_group_scan_is_the_recurrence(rng):
    """The loader's decomposition against the direct recurrence within
    1e-12 of the output's scale, at 512 threads (rows of 17 and 13
    samples at the strides 512 and 400 over 16-window groups; the
    kernel's 33 and 25 over its 32-window groups), 256 (25, and a ragged
    group) and 64 (129), for whole groups and ragged ones."""
    import scipy.signal
    a = 1.0 - DC_ALPHA
    for threads, length in ((512, 16 * 512), (512, 16 * 400), (256, 16 * 400),
                            (512, 5 * 400 + 3), (64, 16 * 512), (512, 32 * 512),
                            (512, 32 * 400), (256, 9 * 400 + 3)):
        per = -(-length // threads) | 1
        x = rng.standard_normal((2, length)) * 0.3 + 0.05
        xp, yp = rng.standard_normal(2) * 0.05, rng.standard_normal(2) * 0.05
        got = _group_scan_emulated(x, xp, yp, a, per, threads)
        exact = scipy.signal.lfilter([1.0, -1.0], [1.0, -a], x, axis=-1,
                                     zi=(a * yp - xp)[:, None])[0]
        assert np.abs(got - exact).max() <= 1e-12 * np.abs(exact).max()


CASES = [("flagship", "cs16", DTHETA, 40 * 512 + 77),
         ("flagship", "cs16", 0, 40 * 512 + 77),
         ("nrsc5", "cu8", 0, 37 * 400 + 123),
         ("nrsc5", "cu8", DTHETA, 37 * 400 + 123)]


@pytest.mark.parametrize("threads", [256, THREADS])
@pytest.mark.parametrize("case", CASES, ids=["flagship-nco", "flagship", "nrsc5",
                                             "nrsc5-nco"])
def test_carry_and_fused_loader_match_k1_twin(rng, case, threads):
    """The carry pass's twin and the fused loader's emulation, composed as
    the card runs K1, against banded_apply_dc_ref over 3 carried blocks
    (each path carrying its own stage history and DC state): >= 100 dB
    on the planes, tails and DC state; the carry pass's tail and state
    are the twin's."""
    name, fmt, dth, n = case
    st = _stage0(name)
    norm = get_format(fmt).normalizer
    sr, si = (torch.from_numpy((rng.standard_normal((CH, st.hist)) * 0.05)
                               .astype(np.float32)) for _ in range(2))
    dc = torch.from_numpy((rng.standard_normal((CH, 4)) * 0.05).astype(np.float32))
    phase = torch.from_numpy(rng.integers(0, 2 ** 32, CH).astype(np.int64))
    ph = phase if dth else None
    emu = ref = (sr, si, dc)
    for blk in range(BLOCKS):
        wire, kind = _wire(rng, fmt, n)
        carry = kernels.dc_carry(wire, emu[2], DC_ALPHA, st.stride, st.hist, norm,
                                 1.0, dth, ph, wire_kind=kind)
        assert carry[0].shape == (CH, kernels.dc_groups(n, st.stride), 4)
        got = _k1_emulated(emu[0], emu[1], carry, wire, kind, norm, st, dth, ph,
                           threads)
        want = kernels.banded_apply_dc_ref(ref[0], ref[1], ref[2], DC_ALPHA,
                                           st.band, None, st.stride, st.hist, wire,
                                           norm, 1.0, dth, ph, wire_kind=kind)
        for w, g in zip(want[0], got):
            assert _snr(w, g) >= 100.0
        for w, g in zip(want[1:], carry[3:]):
            assert _snr(w, g) >= 100.0
        emu, ref = carry[3:], want[1:]
        if dth:
            ph = phase = nco.advance(phase, n, dth)


@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[2]],
                         ids=["flagship-nco", "flagship", "nrsc5"])
def test_carry_and_fused_loader_match_jax(rng, case):
    """The same composition against the JAX package over 3 carried
    blocks of 40 strides (1.25 window groups), >= 80 dB: at the flagship
    stage 0 its Pallas K1 in interpret mode; at nrsc5's stride 400, which
    its K1 does not take, its Pallas K3 (decode and DC block, interpret
    mode) and the plain banded map."""
    name, fmt, dth, n = case
    st = _stage0(name)
    # the TPU kernels' geometries: K1 at 40 strides, K3 at a multiple of 128
    n = 40 * st.stride
    norm = get_format(fmt).normalizer
    sr, si = ((rng.standard_normal((CH, st.hist)) * 0.05).astype(np.float32)
              for _ in range(2))
    dc = (rng.standard_normal((CH, 4)) * 0.05).astype(np.float32)
    phase = rng.integers(0, 2 ** 32, CH).astype(np.uint32)
    emu = (torch.from_numpy(sr), torch.from_numpy(si), torch.from_numpy(dc))
    jst = (jnp.asarray(sr), jnp.asarray(si), jnp.asarray(dc))
    for blk in range(BLOCKS):
        wire, kind = _wire(rng, fmt, n)
        ph = torch.from_numpy(phase.astype(np.int64)) if dth else None
        carry = kernels.dc_carry(wire, emu[2], DC_ALPHA, st.stride, st.hist, norm,
                                 1.0, dth, ph, wire_kind=kind)
        got = _k1_emulated(emu[0], emu[1], carry, wire, kind, norm, st, dth, ph,
                           THREADS)
        jwire = jnp.asarray(wire.numpy())
        if name == "flagship":
            want = pallas_kernels.banded_apply_dc(
                *jst, DC_ALPHA, st._a, None, st.stride, st.hist, wire_i32=jwire,
                wire_norm=norm, nco_dtheta=dth,
                nco_phase=jnp.asarray(phase)[:, None] if dth else None,
                interpret=True)
            jst = want[1:]
        else:
            yr, yi, dcs = pallas_kernels.dc_block_apply(
                None, None, jst[2], DC_ALPHA, interpret=True, wire_i32=jwire,
                wire_norm=norm, wire_kind=kind)
            want = (jbanded.apply_planar(jst[0], jst[1], yr, yi, st._a, None,
                                         st.stride, st.hist),
                    jbanded.new_tail(jst[0], yr, st.hist),
                    jbanded.new_tail(jst[1], yi, st.hist), dcs)
            jst = want[1:]
        for w, g in zip(want[0], got):
            assert _snr(w, g.numpy()) >= 80.0
        for w, g in zip(want[1:], carry[3:]):
            assert _snr(w, g.numpy()) >= 80.0
        emu = carry[3:]
        phase = (phase.astype(np.uint64) + n * DTHETA).astype(np.uint32)
