"""Strided-window banded map: the shared execution primitive of the
resampler stages (the port of ``iq_tool_tpu.ops.banded``).

Every output of a polyphase stage depends on K consecutive inputs.  The
band is densified over a group of G outputs into a constant matrix
A[L, G]; windows of length L = stride + hist at stride S over the
tail-extended input make the whole group one product ``win @ A``.

This module holds the plain path (windows + matmul), which is the twin
the hand-written kernels are held against.  The dispatch is in
``ops.kernels``: its wrappers launch the kernels on CUDA tensors and run
this path on CPU tensors.
"""

from __future__ import annotations

import torch


def build_windows(ext: torch.Tensor, stride: int, hist: int) -> torch.Tensor:
    """win[b] = ext[b*S : b*S + S + hist] as a strided view.

    ext: (C, hist + n) with n a multiple of stride -> (C, n // S, S + hist).
    """
    return ext.unfold(-1, stride + hist, stride)


def window_matmul_planar(win_r: torch.Tensor, win_i: torch.Tensor,
                         a_r: torch.Tensor, a_i: torch.Tensor | None = None):
    """Planar (C, nb, L) f32 windows @ (L, G) -> two (C, nb*G) f32 planes.
    Real A takes 2 real products, complex A 4."""
    ch, nb, _ = win_r.shape
    g = a_r.shape[1]
    yr = torch.matmul(win_r, a_r)
    yi = torch.matmul(win_i, a_r)
    if a_i is not None:
        yr = yr - torch.matmul(win_i, a_i)
        yi = yi + torch.matmul(win_r, a_i)
    return yr.reshape(ch, nb * g), yi.reshape(ch, nb * g)


def new_tail(state: torch.Tensor, x: torch.Tensor, hist: int) -> torch.Tensor:
    """The carry for the next block: last `hist` samples of state ++ x."""
    if x.shape[-1] >= hist:
        return x[:, x.shape[-1] - hist:].contiguous()
    return torch.cat([state, x], dim=-1)[:, -hist:].contiguous()


def apply_planar(state_r, state_i, xr, xi, a_r: torch.Tensor,
                 a_i: torch.Tensor | None, stride: int, hist: int):
    """Plain banded map over a block with carried tap history.

    state_*: (C, hist); x*: (C, n); returns (yr, yi): (C, (n//stride)*G).
    """
    ext_r = torch.cat([state_r, xr], dim=-1)
    ext_i = torch.cat([state_i, xi], dim=-1)
    return window_matmul_planar(build_windows(ext_r, stride, hist),
                                build_windows(ext_i, stride, hist), a_r, a_i)
