"""Time-folded execution of one stream (the port of
``iq_tool_tpu.pipeline.folded``).

The reference folds each channel's block into F consecutive time rows
because Mosaic tiles channels in 8-sublane blocks, so a single stream
leaves most of the TPU idle; it then stitches the rows' state inside
the step (row halos, the DC prefix across rows, per-row NCO phases).
None of that stitching is needed here.  No kernel of this package needs
its blocks to run in time order: the DC kernel's decoupled look-back
composes the tile starts exactly (what the reference's
``_compose_dc_starts`` does per row), K2 and K5 read a window's left
context straight from the block (the reference's ``_shift_rows``
halo), and the NCO phase is closed form.  So a folded step runs the row
chain's stages and kernels once over the whole (C, F * n_in) block, and
keeps the fold's own semantics, which differ from F separate row steps:

* one digital-AGC update per folded step, its peak over the block;
* the I/Q estimator reads the block's first IQ_FFT_SIZE samples, and
  its interval counts global samples;
* a reset applies at the folded block;
* one RMS-AGC gain scan over the segments of all rows in time order
  (segments laid per row: ``Chain._step`` with ``rows``);
* an FFT-method filter's window schedule is made for the global block.

The carry is the row chain's, so checkpoints move between a folded and
an unfolded run.
"""

from __future__ import annotations

from iq_tool_tpu_torch import constants as C
from iq_tool_tpu_torch.pipeline.chain import Chain, ChainConfig


def auto_fold(channels: int) -> int:
    """The reference's rows per channel that fill an 8-sublane block (1
    past 8 channels); the CLI's automatic fold stays 1 off the TPU."""
    return max(1, 8 // max(1, channels))


def widest_tail(chain: Chain) -> str | None:
    """The first stage of ``chain`` whose carried tail is wider than the
    block it runs on, described, or None.  A fold or a time shard takes
    that tail from its neighbour's block alone, so it must fit."""
    tails = []
    if chain.pre_filter is not None:
        tails.append(("pre-filter", chain.pre_filter.block, chain.n_in))
    if chain.resampler is not None:
        n = chain.n_in
        for i, st in enumerate(chain.resampler.stages):
            tails.append((f"resampler stage {i}", st.hist, n))
            n = n * st.p // st.q
    if chain.post_filter is not None:
        tails.append(("post-filter", chain.post_filter.block, chain.n_out))
    for name, width, row in tails:
        if width > row:
            return f"{name} carries {width} samples, its block holds {row}"
    return None


class FoldedChain:
    """Chain-compatible step over blocks of ``fold`` row blocks: the same
    surface as Chain (step, init_carry, n_in, n_out, expected_out_frames,
    wire formats) at the global block size n_in = fold * local.n_in."""

    def __init__(self, cfg: ChainConfig, fold: int, device="cuda"):
        if fold < 1:
            raise ValueError("fold must be >= 1")
        self.fold = int(fold)
        self.local = Chain(cfg, device=device)     # row-block geometry + plans
        self.cfg = cfg
        self.device = self.local.device
        self.channels = cfg.channels
        self.rows = self.channels * self.fold
        if cfg.iq_correction and self.local.n_in < C.IQ_FFT_SIZE:
            raise ValueError("row block too small for I/Q estimation")
        self.n_in = self.local.n_in * self.fold
        self.n_out = self.local.n_out * self.fold
        self.in_wire_len = self.n_in * self.fmt_in.items_per_frame
        self.out_wire_len = self.n_out * self.fmt_out.items_per_frame
        self.in_wire_dtype = self.local.in_wire_dtype
        self.out_wire_dtype = self.local.out_wire_dtype
        # the reference's fold carries every stage's tail from one row to
        # the next, so a tail wider than the row (valid unfolded) is
        # refused with the reference's error
        wide = widest_tail(self.local)
        if fold > 1 and wide is not None:
            raise ValueError(
                f"configuration incompatible with --time-fold {fold} (a stage's "
                f"carried state exceeds the {self.local.n_in}-frame row block); "
                f"use --time-fold 1: {wide}")

    @property
    def fmt_in(self):
        return self.local.fmt_in

    @property
    def fmt_out(self):
        return self.local.fmt_out

    @property
    def resampler(self):
        return self.local.resampler

    def expected_out_frames(self, in_frames: int) -> int:
        return self.local.expected_out_frames(in_frames)

    def init_carry(self, channels: int | None = None) -> dict:
        return self.local.init_carry(channels)

    def carry_to_numpy(self, carry: dict) -> dict:
        return self.local.carry_to_numpy(carry)

    def carry_from_numpy(self, tree: dict) -> dict:
        return self.local.carry_from_numpy(tree)

    def step(self, carry: dict, raw, reset: bool = False):
        """raw: (C, n_in * items) wire tensor -> (new carry, (C, n_out *
        items) wire tensor)."""
        return self.local._step(carry, raw, reset, self.fold)
