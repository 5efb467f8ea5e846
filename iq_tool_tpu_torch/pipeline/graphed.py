"""The chain step as one captured CUDA graph: the port's counterpart of
the reference's ``jax.jit(step, donate_argnums=(0,))``
(``iq_tool_tpu/pipeline/chain.py``, ``pipeline/folded.py``).

An eager step runs the step's Python every block: 5 to 25 ctypes
launches, torch ops and their argument checks.  ``GraphedStep``
captures that work once and replays it as one graph launch a step.
Nothing in a step reads a device value back to the host (see
``pipeline/chain.py``), so the captured work holds for every input and
carry.

Static buffers take the place of the reference's donated ones: the
graph reads the input wire from ``input_buffer`` and the carry from its
static carry, writes its output into the graph's own output tensor, and
ends by copying the step's new carry into the static one (only the
small carry tensors are copied; the block never is).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from iq_tool_tpu_torch.ops import convert
from iq_tool_tpu_torch.pipeline.chain import Chain
from iq_tool_tpu_torch.pipeline.folded import FoldedChain

# eager steps on the capture stream before the capture: they make every
# lazily built constant and per-stream scratch buffer
WARMUP_STEPS = 2


def _leaves(tree) -> list:
    """The tensors of a carry in one fixed order: dicts by key, tuples in
    order, the state dataclasses by field."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _leaves(x)]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in _leaves(getattr(tree, f.name))]
    raise TypeError(f"unexpected carry entry {type(tree).__name__}")


def _same_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _copy(pairs) -> None:
    """dst.copy_(src) for each (dst, src), as one multi-tensor copy a
    dtype: in a graph, a few kernels in place of a memcpy node per carry
    tensor."""
    by_dtype: dict = {}
    for d, s in pairs:
        dsts, srcs = by_dtype.setdefault(d.dtype, ([], []))
        dsts.append(d)
        srcs.append(s)
    for dsts, srcs in by_dtype.values():
        torch._foreach_copy_(dsts, srcs)


class GraphedStep:
    """The step of ``chain`` (a ``Chain`` or a ``FoldedChain``) with the
    chain's step surface, replayed as one CUDA graph on a CUDA device.

    Donation contract, as the reference's donated carry: ``step`` returns
    this object's static carry, updated in place by every step, and an
    output tensor that the next step overwrites.  A caller keeps what it
    needs of either (a copy to the host, a clone) before the next call.
    A carry that is not the static one (a resumed checkpoint's, from
    ``carry_from_numpy``) is copied into it first; ``raw`` is copied into
    ``input_buffer`` unless it is that buffer, so a caller that writes
    its block straight into ``input_buffer`` hands it over with no copy
    on the device.  ``reset`` resets the static carry in place before the
    replay, as ``Chain.step`` resets its carry before the step.

    ``capture()`` builds the kernels, runs WARMUP_STEPS eager steps on a
    stream of its own and captures the step there; the first ``step``
    calls it when no one did before.  A capture that fails raises:
    nothing runs the eager step in its place.  On the CPU nothing is
    captured: a step runs the chain's eager step over the same static
    buffers and copies into them as the graph does, so the CPU tests
    cover the buffer logic.

    The kernels' ``launches`` counters count host calls, so a replay does
    not move them: ``kernels`` holds their change during the capture
    (the kernels a replay launches), ``replays`` the steps taken.
    ``ShardedChain`` stays eager: its steps run collectives, and at one
    time shard it steps one local Chain for several mesh positions.
    """

    def __init__(self, chain: Chain | FoldedChain):
        if not isinstance(chain, (Chain, FoldedChain)):
            raise TypeError(f"GraphedStep takes a Chain or a FoldedChain, not "
                            f"{type(chain).__name__}")
        self.chain = chain
        self._row = chain.local if isinstance(chain, FoldedChain) else chain
        for name in ("cfg", "device", "n_in", "n_out", "in_wire_len", "out_wire_len",
                     "in_wire_dtype", "out_wire_dtype", "fmt_in", "fmt_out",
                     "resampler"):
            setattr(self, name, getattr(chain, name))
        self.input_buffer = torch.zeros((self.cfg.channels, self.in_wire_len),
                                        dtype=convert.torch_wire_dtype(self.fmt_in),
                                        device=self.device)
        self._carry = chain.init_carry()
        self._static = _leaves(self._carry)
        self._graph = None
        self._out = None
        self.kernels: dict | None = None
        self.replays = 0
        self.capture_sec = 0.0

    # ------------------------------------------------------ chain surface

    def init_carry(self, channels: int | None = None) -> dict:
        return self.chain.init_carry(channels)

    def carry_to_numpy(self, carry: dict) -> dict:
        return self.chain.carry_to_numpy(carry)

    def carry_from_numpy(self, tree: dict) -> dict:
        return self.chain.carry_from_numpy(tree)

    def expected_out_frames(self, in_frames: int) -> int:
        return self.chain.expected_out_frames(in_frames)

    # ---------------------------------------------------------------- step

    def _load(self, carry) -> None:
        """Copy ``carry``'s tensors into the static carry."""
        src = _leaves(carry)
        if len(src) != len(self._static) or any(
                s.shape != d.shape or s.dtype != d.dtype for s, d in zip(src, self._static)):
            raise ValueError("the carry does not have this chain's layout")
        _copy((d, s) for d, s in zip(self._static, src) if s is not d)

    def _body(self) -> torch.Tensor:
        """One eager step over the static buffers, its new carry copied
        into the static carry; returns the step's output."""
        new, out = self.chain.step(self._carry, self.input_buffer, False)
        moved = [(d, s) for d, s in zip(self._static, _leaves(new)) if s is not d]
        # the copies run together: none may read what another one writes
        for d, s in moved:
            if any(_same_storage(s, d2) for d2, _ in moved) or _same_storage(out, d):
                raise RuntimeError("a step's output or new carry aliases the static "
                                   "carry it overwrites")
        _copy(moved)
        return out

    def capture(self) -> None:
        """Build the kernels and capture the step (CUDA), once; records
        the seconds taken in ``capture_sec``."""
        if self._graph is not None or self.device.type != "cuda":
            return
        from iq_tool_tpu_torch.ops import _build, kernels
        t0 = time.perf_counter()
        _build.library()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            for _ in range(WARMUP_STEPS):
                self.chain.step(self._carry, self.input_buffer, False)
        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out = self._body()
        after = kernels.launch_counts()
        self.kernels = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        self._graph, self._out = graph, out
        torch.cuda.synchronize(self.device)
        self.capture_sec = time.perf_counter() - t0

    def step(self, carry: dict, raw: torch.Tensor, reset: bool = False):
        """raw: (C, n_in * items) wire tensor on this chain's device, or
        ``input_buffer`` itself -> (the static carry, the output)."""
        if raw is not self.input_buffer:
            if raw.device.type != self.device.type:
                raise ValueError(f"input on {raw.device}, chain on {self.device}")
            if raw.shape != self.input_buffer.shape or raw.dtype != self.input_buffer.dtype:
                raise ValueError(f"input {tuple(raw.shape)} {raw.dtype}, the step takes "
                                 f"{tuple(self.input_buffer.shape)} "
                                 f"{self.input_buffer.dtype}")
            self.input_buffer.copy_(raw)
        if carry is not self._carry:
            self._load(carry)
        if reset:
            self._load(self._row._reset_carry(self._carry))
        if self.device.type == "cuda":
            self.capture()
            self._graph.replay()
        else:
            out = self._body()
            if self._out is None:
                self._out = torch.empty_like(out)
                self.kernels = {}
            self._out.copy_(out)
        self.replays += 1
        return self._carry, self._out
