"""The chain step as captured CUDA graphs: the port's counterpart of the
reference's ``jax.jit(step, donate_argnums=(0,))``
(``iq_tool_tpu/pipeline/chain.py``, ``pipeline/folded.py``) and of its
jitted, carry-donating ``shard_map`` step
(``iq_tool_tpu/parallel/sharded.py``).

An eager step runs the step's Python every block: 5 to 25 ctypes
launches a chain step (about 100 a sharded one), torch ops and their
argument checks.  ``GraphedStep`` captures that work once and replays
it as one graph launch a step (one a device for a sharded chain whose
mesh spans devices).  Nothing in a step reads a device value back to
the host (see ``pipeline/chain.py``), so the captured work holds for
every input and carry.

Static buffers take the place of the reference's donated ones: the
graph reads the input wire from ``input_buffer`` and the carry from its
static carry, writes its output into the graph's own output tensor, and
ends by copying the step's new carry into the static one (only the
small carry tensors are copied; the block never is).
"""

from __future__ import annotations

import ctypes
import dataclasses
import time

import torch

from iq_tool_tpu_torch.ops import convert
from iq_tool_tpu_torch.parallel.sharded import ShardedChain, sharded_eager_reason
from iq_tool_tpu_torch.pipeline import trace
from iq_tool_tpu_torch.pipeline.chain import Chain
from iq_tool_tpu_torch.pipeline.folded import FoldedChain

# eager steps on the capture stream before the capture: they make every
# lazily built constant, FFT plan and per-stream scratch buffer
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
    dtype and device: in a graph, a few kernels in place of a memcpy node
    per carry tensor."""
    groups: dict = {}
    for d, s in pairs:
        dsts, srcs = groups.setdefault((d.dtype, str(d.device)), ([], []))
        dsts.append(d)
        srcs.append(s)
    for dsts, srcs in groups.values():
        torch._foreach_copy_(dsts, srcs)


def _capture_nodes(lib, stream) -> int:
    """The device nodes (kernels, memcpys, memsets) of the graph that
    ``stream`` is capturing into."""
    counts = (ctypes.c_longlong * 4)()
    rc = lib.iq_capture_nodes(ctypes.c_void_p(stream.cuda_stream), counts)
    if rc != 0:
        raise RuntimeError(f"reading the capture's nodes: CUDA error {rc}")
    return counts[0] + counts[1] + counts[2]


def _stage_map(marks: list) -> list:
    """[(span name, device nodes)] in capture order from a capture's marks
    ((name, opening, nodes so far) as each span opened and closed): each
    node goes to the innermost span open when it was captured, a node
    captured outside every span to none."""
    stages, stack, last = [], [], 0
    for name, opening, nodes in marks:
        if stack and nodes > last:
            if stages and stages[-1][0] == stack[-1] and stages[-1][2] == last:
                stages[-1][1:] = [stages[-1][1] + nodes - last, nodes]
            else:
                stages.append([stack[-1], nodes - last, nodes])
        last = nodes
        if opening:
            stack.append(name)
        else:
            stack.pop()
    return [(name, n) for name, n, _ in stages]


def eager_reason(chain) -> str | None:
    """Why the engine steps ``chain`` eagerly rather than as a GraphedStep
    (a ShardedChain's mesh, ``sharded_eager_reason``), or None."""
    return sharded_eager_reason(chain.mesh) if isinstance(chain, ShardedChain) else None


def step_form(chain) -> str:
    """The form the engine steps ``chain`` in, as the CLI prints it:
    "graph", or "eager (<why>)"."""
    why = eager_reason(chain) or ("the CPU captures no graph"
                                  if chain.device.type != "cuda" else None)
    return "graph" if why is None else f"eager ({why})"


@dataclasses.dataclass
class _Part:
    """The share of a step that one graph captures: the whole step (rows
    None), or a sharded chain's channel shards ``rows`` on ``device``
    over its static blocks."""
    device: torch.device
    rows: list | None = None
    positions: list = dataclasses.field(default_factory=list)
    graph: torch.cuda.CUDAGraph | None = None
    stream: torch.cuda.Stream | None = None      # the capture stream
    out: object = None


class GraphedStep:
    """The step of ``chain`` (a ``Chain``, a ``FoldedChain`` or a
    ``ShardedChain``) with the chain's step surface, replayed as captured
    CUDA graphs on a CUDA device.

    Donation contract, as the reference's donated carry: ``step`` returns
    this object's static carry, updated in place by every step, and an
    output tensor that the next step overwrites.  A caller keeps what it
    needs of either (a copy to the host, a clone) before the next call.
    A carry that is not the static one (a resumed checkpoint's, from
    ``carry_from_numpy``) is copied into it first; ``raw`` is copied into
    ``input_buffer`` unless it is that buffer, so a caller that writes
    its block straight into ``input_buffer`` hands it over with no copy
    on the device.  ``reset`` resets the static carry in place before the
    replay, as the chain's step resets its carry before the step.

    A ShardedChain's static carry is its dict of positions' carries and
    ``input_buffer`` its global (C, T * n_in * items) wire.  On a mesh
    whose positions share one device (the meshes that repeat a card) one
    graph captures the whole sharded step: the shard split, the time
    row's in-process collectives, every kernel and the output's cat.  On
    a mesh over several devices each device's channel shards are one
    graph, their blocks copied in from ``input_buffer`` and their outputs
    into the step's output around the replays.  A mesh that
    ``sharded_eager_reason`` names (positions in other processes, a time
    row over several devices) raises: the engine steps such a chain
    eagerly.

    ``capture()`` builds the kernels, runs WARMUP_STEPS eager steps on a
    stream of its own and captures the step there; the first ``step``
    calls it when no one did before.  The graph keeps a reference to the
    per-stream scratch buffers its capture stream uses (the DC look-back,
    the estimator's ticket), so a later, larger launch on that pool
    stream cannot free them under it; two graphs captured on one pool
    stream share that scratch and must not replay at the same time (the
    engine replays on one stream).  A capture that fails raises: nothing
    runs the eager step in its place.  On the CPU nothing is captured: a
    step runs the chain's eager step over the same static buffers and
    copies into them as the graph does, so the CPU tests cover the
    buffer logic.

    The kernels' ``launches`` counters count host calls, so a replay does
    not move them: ``kernels`` holds their change during the capture
    (the kernels a replay launches), ``replays`` the steps taken.
    ``stage_kernels`` is what the capture noted in the stage record
    (``trace.note``): {stage: {CUDA symbol: launches}}, the kernels each
    ``chain.*`` stage of a replay launches, which the capture also
    publishes as the newest (``trace.stage_kernels()``).

    ``stages`` is the capture's stage map: [(span name, device nodes)] in
    capture order, each of the step's spans (``chain.*``, ``graph.carry``;
    ``pipeline/trace.py``) with the kernels, memcpys and memsets captured
    inside it, the parts' maps one after another; ``graph_nodes`` counts
    the graphs' device nodes, so the map covers the step when their
    totals agree.  A replay runs a one-part step's nodes in capture order
    (the capture is one stream's), so its k-th device event belongs to
    the map's k-th node (``profile_steps`` splits a replay's time so).
    The capture publishes a one-part step's map with ``graph_nodes``
    (``trace.stage_map()``); a step of several parts publishes None.
    """

    def __init__(self, chain: Chain | FoldedChain | ShardedChain):
        if isinstance(chain, ShardedChain):
            why = sharded_eager_reason(chain.mesh)
            if why is not None:
                raise TypeError(f"a ShardedChain on this mesh steps eagerly ({why})")
            self._reset = chain._reset_carry
        elif isinstance(chain, (Chain, FoldedChain)):
            row = chain.local if isinstance(chain, FoldedChain) else chain
            self._reset = row._reset_carry
        else:
            raise TypeError(f"GraphedStep takes a Chain, a FoldedChain or a ShardedChain, "
                            f"not {type(chain).__name__}")
        self.chain = chain
        for name in ("cfg", "device", "n_in", "n_out", "in_wire_len", "out_wire_len",
                     "in_wire_dtype", "out_wire_dtype", "fmt_in", "fmt_out",
                     "resampler"):
            setattr(self, name, getattr(chain, name))
        self.input_buffer = torch.zeros((self.cfg.channels, self.in_wire_len),
                                        dtype=convert.torch_wire_dtype(self.fmt_in),
                                        device=self.device)
        self._carry = chain.init_carry()
        self._static = _leaves(self._carry)
        rows = chain.device_rows() if isinstance(chain, ShardedChain) else {}
        if len(rows) > 1:
            self._parts = [_Part(torch.device(d), r, [p for p in chain.positions if p[0] in r])
                           for d, r in rows.items()]
            w = chain.local.in_wire_len
            self._blocks = {p: torch.zeros((chain.c_local, w), dtype=self.input_buffer.dtype,
                                           device=chain._dev(*p)) for p in chain.positions}
        else:
            self._parts = [_Part(self.device)]
        self._scratch: list = []
        self._out = None
        self.kernels: dict | None = None
        self.stage_kernels: dict | None = None
        self.stages: list = []
        self.graph_nodes = 0
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

    def _eager(self, part: _Part):
        """One eager step of ``part``'s share over the static buffers:
        ((static, new) carry tensor pairs, the output: the step's, or
        {position: output} of the part's positions)."""
        if part.rows is None:
            new, out = self.chain.step(self._carry, self.input_buffer, False)
            return list(zip(self._static, _leaves(new))), out
        blocks = {p: self._blocks[p] for p in part.positions}
        new, out = self.chain.step_rows(self._carry, blocks, part.rows)
        return [(d, s) for p in part.positions
                for d, s in zip(_leaves(self._carry[p]), _leaves(new[p]))], out

    def _body(self, part: _Part):
        """``_eager``, its new carry copied into the static carry; returns
        its output."""
        pairs, out = self._eager(part)
        outs = list(out.values()) if isinstance(out, dict) else [out]
        moved = [(d, s) for d, s in pairs if s is not d]
        # the copies run together: none may read what another one writes
        for d, s in moved:
            if (any(_same_storage(s, d2) for d2, _ in moved)
                    or any(_same_storage(o, d) for o in outs)):
                raise RuntimeError("a step's output or new carry aliases the static "
                                   "carry it overwrites")
        with trace.span("graph.carry"):
            _copy(moved)
        return out

    def capture(self) -> None:
        """Build the kernels and capture the step (CUDA), once: a graph a
        part, each after its warm-up on its own stream; records the
        seconds taken in ``capture_sec``."""
        if self._parts[0].graph is not None or self.device.type != "cuda":
            return
        from iq_tool_tpu_torch.ops import _build, kernels
        t0 = time.perf_counter()
        lib = _build.library()
        self.kernels, self.stage_kernels = {}, {}
        for part in self._parts:
            with torch.cuda.device(part.device):
                stream = torch.cuda.Stream(part.device)
                stream.wait_stream(torch.cuda.current_stream(part.device))
                with torch.cuda.stream(stream):
                    for _ in range(WARMUP_STEPS):
                        self._eager(part)
                self._scratch += kernels.stream_scratch(part.device, stream)
                before, noted = kernels.launch_counts(), trace.launches()
                graph = torch.cuda.CUDAGraph()
                marks = []
                with torch.cuda.graph(graph, stream=stream):
                    with trace.observe(lambda name, opening: marks.append(
                            (name, opening, _capture_nodes(lib, stream)))):
                        part.out = self._body(part)
                    self.graph_nodes += _capture_nodes(lib, stream)
                self.stages += _stage_map(marks)
                after = kernels.launch_counts()
                for k in after:
                    if after[k] != before[k]:
                        self.kernels[k] = self.kernels.get(k, 0) + after[k] - before[k]
                for stage, syms in trace.stage_launches(noted, trace.launches()).items():
                    mine = self.stage_kernels.setdefault(stage, {})
                    for sym, n in syms.items():
                        mine[sym] = mine.get(sym, 0) + n
                part.graph, part.stream = graph, stream
                torch.cuda.synchronize(part.device)
        trace.publish_stage_kernels(self.stage_kernels)
        trace.publish_stage_map(self.stages if len(self._parts) == 1 else None,
                                self.graph_nodes)
        self.capture_sec = time.perf_counter() - t0

    def _slab(self, p) -> torch.Tensor:
        """Position p's (c_local, n_in * items) block of input_buffer."""
        (ci, t), cl, w = p, self.chain.c_local, self._blocks[p].shape[-1]
        return self.input_buffer[ci * cl:(ci + 1) * cl, t * w:(t + 1) * w]

    def _assemble(self, outs: dict) -> None:
        """The parts' {position: output} into the step's output."""
        cl = self.chain.c_local
        for (ci, t), o in outs.items():
            if self._out is None:
                self._out = torch.empty((self.cfg.channels, o.shape[-1] * self.chain.t),
                                        dtype=o.dtype, device=self.device)
            w = o.shape[-1]
            self._out[ci * cl:(ci + 1) * cl, t * w:(t + 1) * w].copy_(o, non_blocking=True)

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
            self._load(self._reset(self._carry))
        split = self._parts[0].rows is not None
        if split:
            for p, blk in self._blocks.items():
                blk.copy_(self._slab(p), non_blocking=True)
        if self.device.type == "cuda":
            self.capture()
            for part in self._parts:
                with torch.cuda.device(part.device):
                    part.graph.replay()
            outs = [part.out for part in self._parts]
        else:
            outs = [self._body(part) for part in self._parts]
            self.kernels, self.stage_kernels = {}, {}
        if split:
            for o in outs:
                self._assemble(o)
        elif self.device.type == "cuda":
            self._out = outs[0]
        else:
            if self._out is None:
                self._out = torch.empty_like(outs[0])
            self._out.copy_(outs[0])
        self.replays += 1
        return self._carry, self._out
