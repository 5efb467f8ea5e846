"""Channel- and time-sharded execution of the chain (the port of
``iq_tool_tpu.parallel.sharded``).

A step takes a global block of ``T * n_in`` frames of every channel, laid
over a (channel, time) mesh of devices: channel shard ``c`` holds
``channels / C`` streams, time shard ``t`` the t-th per-shard block of
them.  Each position runs the stages of a local ``Chain`` at the
per-shard framing, so ``--block-size`` is per time shard.  Channels are
independent: a C x 1 mesh is the local chain on each channel slab, step
for step, and at T == 1 a position's step IS ``Chain.step`` (no copy, no
extra launch).  At T > 1 the sequential state crosses the time shards
through four collectives of the time axis (``_TimeRow``):

* ``ring_shift``: every stage that keeps a tail (the DC blocker's last
  input sample, the pre- and post-filter, each resampler stage) takes
  the previous shard's tail; shard 0 takes the carried one, and the
  wrapped result is the next step's carry (only shard 0's slot of it is
  read again);
* ``all_gather``: the DC blocker's zero-start ends and the RMS AGC's
  segment energies;
* ``all_max``: the digital AGC's block peak;
* ``broadcast0``: shard 0's first IQ_FFT_SIZE frames (packed wire or
  planes) and its carried DC state, from which the I/Q estimator's
  kernel decodes and DC-blocks what it reads.

The NCO needs none: shard t's phase is the carry advanced by t * n.  The
DC recurrence is exact across shards by running the DC kernel twice: once
from a zero y-state for each shard's end, whose all-gather composes each
shard's true start in float64 (start_t = end0_{t-1} + a^n start_{t-1}),
then again from that start.  The AGC's gain loop runs over the gathered
segment energies (each shard's from ``kernels.segment_energies``) of the
whole global block (``kernels.agc_chain``), each shard keeping its own
slice for K4; the digital profile updates once per
global block from the peak over all shards.  The I/Q estimator runs once
per global step on shard 0's samples and advances its interval by T * n.

Inside one process the collectives are copies between the shards'
devices (a mesh may repeat a device: ``["cpu"] * 8`` is the counterpart
of the reference's eight virtual CPU devices).  Across processes
(``parallel/multihost.py``) a time neighbour in another process is
reached with ``torch.distributed`` point-to-point calls.

The carry is a dict, (channel shard, time shard) -> that position's
local ``Chain`` carry, the replicated leaves (NCO phases, the DC output
state, I/Q, AGC) equal at every position of a channel slab.
``ShardedChain.carry_to_numpy`` and ``carry_from_numpy`` exchange it in
the reference ShardedChain's layout: keys nco_pre (when the pre-NCO
runs), nco_post (likewise), dc_x, dc_y, iq, pre_f, rs{i}, post_f, agc;
halo leaves as (C, T * 2H) planar rows (real tail then imaginary tail
per time slot).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from iq_tool_tpu_torch import constants as C
from iq_tool_tpu_torch.ops import agc, convert, kernels, nco
from iq_tool_tpu_torch.pipeline.chain import (Chain, ChainConfig, carry_from_numpy,
                                              carry_to_numpy, resolve_device)
from iq_tool_tpu_torch.pipeline.folded import widest_tail


class Mesh:
    """A (channel, time) grid of torch devices.  ``ranks`` (the same
    grid of process ranks, ``multihost.global_mesh``) marks the
    positions of other processes; None means every position is this
    process's."""

    def __init__(self, devices, ranks=None, rank: int = 0):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        if not self.devices or len({len(r) for r in self.devices}) != 1:
            raise ValueError("a mesh is a non-empty (channel, time) grid")
        self.ranks = ranks
        self.rank = rank
        self.shape = {"channel": len(self.devices), "time": len(self.devices[0])}

    def is_local(self, ci: int, ti: int) -> bool:
        return self.ranks is None or self.ranks[ci][ti] == self.rank

    def local_positions(self) -> list:
        return [(ci, ti) for ci in range(self.shape["channel"])
                for ti in range(self.shape["time"]) if self.is_local(ci, ti)]


def sharded_eager_reason(mesh: Mesh) -> str | None:
    """Why a ShardedChain on ``mesh`` steps eagerly rather than as captured
    CUDA graphs (``pipeline/graphed.py``), or None when it can be captured:
    a mesh with positions in other processes ("multi-process": the halos
    travel by point-to-point calls that the host waits on) or with a time
    row over more than one device ("time shards span devices": the row's
    collectives would be copies between devices inside one graph).  Every
    other mesh is captured, one graph per device."""
    if mesh.ranks is not None and any(r != mesh.rank for row in mesh.ranks for r in row):
        return "multi-process"
    if any(len({str(d) for d in row}) > 1 for row in mesh.devices):
        return "time shards span devices"
    return None


def visible_devices() -> list:
    """Every visible CUDA device; an error without one (the CPU is a
    mesh device only when the caller names it)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible: pass CPU devices explicitly to "
                           "shard on the CPU (this package never falls back to it)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices=None, channel_shards: int | None = None,
              time_shards: int | None = None) -> Mesh:
    """A channel_shards x time_shards mesh over ``devices`` (default:
    every visible CUDA device), filled row by row.  An unspecified axis
    takes what the other leaves; the grid must use every device.  A list
    may repeat a device."""
    devs = visible_devices() if devices is None else [resolve_device(d) for d in devices]
    for d in devs:
        if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
            raise ValueError(f"{d} is not a visible device")
    _, t = mesh_axes(len(devs), channel_shards, time_shards)
    return Mesh(grid(devs, t))


def mesh_axes(n: int, channel_shards: int | None, time_shards: int | None):
    """(channel, time) shards of a mesh over n devices: an unspecified
    axis takes what the other leaves, and the grid uses every device."""
    if channel_shards is None and time_shards is None:
        channel_shards, time_shards = 1, n
    elif channel_shards is None:
        channel_shards = n // time_shards
    elif time_shards is None:
        time_shards = n // channel_shards
    if channel_shards < 1 or time_shards < 1 or channel_shards * time_shards != n:
        raise ValueError(f"{channel_shards}x{time_shards} != {n} devices")
    return channel_shards, time_shards


def grid(values: list, time_shards: int) -> list:
    """A flat list cut into rows of ``time_shards`` (the mesh's order)."""
    return [values[i:i + time_shards] for i in range(0, len(values), time_shards)]


def _to(tree, dev):
    """A carry leaf tree (tensors, tuples, state dataclasses) on ``dev``;
    a tensor already there is returned as it is."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev, non_blocking=True)
    if isinstance(tree, tuple):
        return tuple(_to(v, dev) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _to(getattr(tree, f.name), dev)
                                            for f in dataclasses.fields(tree)})
    return tree


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for v in tree for x in _tensors(v)]


def _like(tree, flat: list):
    if isinstance(tree, torch.Tensor):
        return flat.pop(0)
    return tuple(_like(v, flat) for v in tree)


class _TimeRow:
    """The time axis of one channel slab: the positions this process
    holds and the four collectives between its shards.  A value is a
    tensor or a tuple of tensors of the same shapes at every shard;
    ``all_gather``, ``all_max`` and ``broadcast0`` leave their result on
    ``lead``, the device of this process's first shard of the slab."""

    def __init__(self, mesh: Mesh, ci: int):
        self.t = mesh.shape["time"]
        self.devs = mesh.devices[ci]
        self.held = [ti for ti in range(self.t) if mesh.is_local(ci, ti)]
        self.lead = self.devs[self.held[0]]
        self.owner = (mesh.ranks[ci] if mesh.ranks is not None
                      else [mesh.rank] * self.t)
        self.peers = sorted({r for r in self.owner if r != mesh.rank})

    def _p2p(self, sends: list, recvs: list) -> None:
        """Point-to-point with other processes, each pair's messages in
        position order on both sides; (tensor, rank) pairs."""
        ops = [dist.P2POp(dist.isend, t.contiguous(), r) for t, r in sends]
        ops += [dist.P2POp(dist.irecv, t, r) for t, r in recvs]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    def ring_shift(self, vals: dict) -> dict:
        """{t: shard t-1's value} (shard 0 gets shard T-1's) on shard t's
        device."""
        out, sends, recvs = {}, [], []
        for t in self.held:
            src = (t - 1) % self.t
            if src in vals:
                out[t] = _to(vals[src], self.devs[t])
            else:
                bufs = [torch.empty_like(x) for x in _tensors(vals[t])]
                recvs += [(b, self.owner[src]) for b in bufs]
                out[t] = _like(vals[t], bufs)
        for t in self.held:
            dst = (t + 1) % self.t
            if dst not in vals:
                sends += [(x, self.owner[dst]) for x in _tensors(vals[t])]
        self._p2p(sends, recvs)
        return out

    def all_gather(self, vals: dict) -> list:
        """Every shard's value, in time order, on ``lead``."""
        out, sends, recvs = [], [], []
        for t in range(self.t):
            if t in vals:
                out.append(_to(vals[t], self.lead))
                sends += [(x, r) for r in self.peers for x in _tensors(vals[t])]
            else:
                like = vals[self.held[0]]
                bufs = [torch.empty_like(x, device=self.lead) for x in _tensors(like)]
                recvs += [(b, self.owner[t]) for b in bufs]
                out.append(_like(like, bufs))
        self._p2p(sends, recvs)
        return out

    def all_max(self, vals: dict) -> torch.Tensor:
        return torch.stack(self.all_gather(vals)).amax(dim=0)

    def broadcast0(self, val, specs: tuple) -> tuple:
        """Shard 0's tensors (``val`` where this process holds shard 0,
        else None; ``specs`` their (shape, dtype)) on ``lead``."""
        if 0 in self.held:
            self._p2p([(x, r) for r in self.peers for x in val], [])
            return _to(val, self.lead)
        bufs = tuple(torch.empty(s, dtype=d, device=self.lead) for s, d in specs)
        self._p2p([], [(b, self.owner[0]) for b in bufs])
        return bufs


class ShardedChain:
    """A chain stepped over a (channel, time) mesh, with Chain's surface
    (step, init_carry, n_in, n_out, expected_out_frames, the wire
    formats): ``step`` takes the global (C, T * n_in * items) wire and
    returns the global output on ``device``, the mesh's first device."""

    def __init__(self, cfg: ChainConfig, mesh: Mesh):
        self.mesh = mesh
        self.t = mesh.shape["time"]
        self.c_shards = mesh.shape["channel"]
        if cfg.channels % self.c_shards:
            raise ValueError(f"channels {cfg.channels} not divisible by channel axis "
                             f"{self.c_shards}")
        self.c_local = cfg.channels // self.c_shards
        self.cfg = cfg
        self.positions = mesh.local_positions()
        if not self.positions:
            raise ValueError("no position of the mesh belongs to this process")
        self.device = mesh.devices[self.positions[0][0]][self.positions[0][1]]
        # one local chain per distinct device: a Chain holds its plans and
        # kernel operands, never stream state, so positions on one device
        # share it
        local_cfg = dataclasses.replace(cfg, channels=self.c_local)
        self._chains: dict = {}
        for ci, ti in self.positions:
            dev = mesh.devices[ci][ti]
            if str(dev) not in self._chains:
                self._chains[str(dev)] = Chain(local_cfg, device=dev)
        self.local = self._chains[str(self.device)]
        if cfg.iq_correction and self.local.n_in < C.IQ_FFT_SIZE:
            raise ValueError("per-shard block too small for I/Q estimation")
        wide = widest_tail(self.local) if self.t > 1 else None
        if wide is not None:
            raise ValueError(f"configuration incompatible with {self.t} time shards "
                             f"(a shard's halo comes from its neighbour's block alone): "
                             f"{wide}")
        self._rows = {ci: _TimeRow(mesh, ci) for ci in sorted({p[0] for p in self.positions})}
        self.n_in = self.local.n_in * self.t
        self.n_out = self.local.n_out * self.t
        self.in_wire_len = self.n_in * self.fmt_in.items_per_frame
        self.out_wire_len = self.n_out * self.fmt_out.items_per_frame
        self.in_wire_dtype = self.local.in_wire_dtype
        self.out_wire_dtype = self.local.out_wire_dtype

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

    def _dev(self, ci: int, ti: int) -> torch.device:
        return self.mesh.devices[ci][ti]

    def _chain(self, ci: int, ti: int) -> Chain:
        return self._chains[str(self._dev(ci, ti))]

    # ------------------------------ carry ------------------------------------

    def device_rows(self) -> dict:
        """{device name: the channel shards whose time row leads on it},
        in mesh order (on a mesh that ``sharded_eager_reason`` lets be
        captured, each row sits on one device)."""
        out: dict = {}
        for ci, row in self._rows.items():
            out.setdefault(str(row.lead), []).append(ci)
        return out

    def _reset_carry(self, carry: dict) -> dict:
        """Each position's carry reset as ``step(..., reset=True)`` resets
        it (``Chain._reset_carry``: I/Q kept, AGC re-initialised, the rest
        zero)."""
        return {p: self._chain(*p)._reset_carry(c) for p, c in carry.items()}

    def init_carry(self, channels: int | None = None) -> dict:
        if channels is not None and channels != self.cfg.channels:
            raise ValueError(f"carry channels {channels} != configured "
                             f"{self.cfg.channels}")
        return {(ci, ti): self._chain(ci, ti).init_carry(self.c_local)
                for ci, ti in self.positions}

    def _halo_widths(self) -> dict:
        """Halo leaf name -> H (its planar width is 2H)."""
        lc = self.local
        widths = {}
        if lc.pre_filter is not None:
            widths["pre_f"] = lc.pre_filter.block
        if lc.resampler is not None:
            for si, st in enumerate(lc.resampler.stages):
                widths[f"rs{si}"] = st.hist
        if lc.post_filter is not None:
            widths["post_f"] = lc.post_filter.block
        return widths

    def carry_to_numpy(self, carry: dict) -> dict:
        """The carry in the reference ShardedChain's layout (numpy)."""
        if len(carry) != self.c_shards * self.t:
            raise ValueError("carry_to_numpy needs every position of the mesh "
                             "(a single-process mesh)")
        lc = self.local
        pos = {p: carry_to_numpy(c) for p, c in carry.items()}
        rows = range(self.c_shards)
        times = range(self.t)
        cat = lambda f: np.concatenate([f(ci) for ci in rows], axis=0)
        first = lambda ci: pos[(ci, 0)]
        out = {}
        if lc.dtheta_pre:
            out["nco_pre"] = cat(lambda ci: first(ci)["nco_pre"])
        if lc.dtheta_post:
            out["nco_post"] = cat(lambda ci: first(ci)["nco_post"])
        if self.cfg.dc_block:
            out["dc_x"] = cat(lambda ci: np.concatenate(
                [np.stack(pos[(ci, t)]["dc"][:2], axis=-1) for t in times], axis=-1))
            out["dc_y"] = cat(lambda ci: np.stack(first(ci)["dc"][2:], axis=-1))
        if self.cfg.iq_correction:
            out["iq"] = (cat(lambda ci: first(ci)["iq"][0]), pos[(0, 0)]["iq"][1])
        for name in self._halo_widths():
            leaf = lambda p: (p["rs"][int(name[2:])] if name.startswith("rs") else p[name])
            out[name] = cat(lambda ci: np.concatenate(
                [np.concatenate(leaf(pos[(ci, t)]), axis=-1) for t in times], axis=-1))
        if lc.agc_cfg is not None:
            out["agc"] = tuple(cat(lambda ci, j=j: first(ci)["agc"][j]) for j in range(6))
        return out

    def carry_from_numpy(self, tree: dict) -> dict:
        """The inverse of carry_to_numpy (this process's positions)."""
        widths = self._halo_widths()
        known = {"nco_pre", "nco_post", "dc_x", "dc_y", "iq", "agc", *widths}
        extra = set(tree) - known
        if extra:
            raise ValueError(f"sharded carry keys this chain does not know: {sorted(extra)}")
        cl = self.c_local
        n_rs = len(self.local.resampler.stages) if self.local.resampler else 0
        out = {}
        for ci, ti in self.positions:
            rows = slice(ci * cl, (ci + 1) * cl)
            zero = np.zeros(cl, np.uint32)
            p = {k: np.asarray(tree[k])[rows] if k in tree else zero
                 for k in ("nco_pre", "nco_post")}
            if "dc_x" in tree:
                x = np.asarray(tree["dc_x"], np.float32)[rows, 2 * ti:2 * ti + 2]
                y = np.asarray(tree["dc_y"], np.float32)[rows]
                p["dc"] = (x[:, 0], x[:, 1], y[:, 0], y[:, 1])
            if "iq" in tree:
                p["iq"] = (np.asarray(tree["iq"][0])[rows], tree["iq"][1])
            for name, h in widths.items():
                v = np.asarray(tree[name], np.float32)[rows, 2 * h * ti:2 * h * (ti + 1)]
                pair = (v[:, :h], v[:, h:])
                if name.startswith("rs"):
                    p.setdefault("rs", [None] * n_rs)[int(name[2:])] = pair
                else:
                    p[name] = pair
            if "rs" in p:
                p["rs"] = tuple(p["rs"])
            if "agc" in tree:
                p["agc"] = tuple(np.asarray(v)[rows] for v in tree["agc"])
            out[(ci, ti)] = carry_from_numpy(p, self._dev(ci, ti))
        return out

    # ------------------------------ step ------------------------------------

    def place_input(self, raw: torch.Tensor) -> dict:
        """The local positions' (c_local, n_in * items) blocks of a global
        wire (or of this process's channel slab), each on its device."""
        first, count = self.local_channels()
        if raw.shape[0] == self.cfg.channels:
            first = 0
        elif raw.shape[0] != count:
            raise ValueError(f"input has {raw.shape[0]} channels, expected "
                             f"{self.cfg.channels} (or this process's {count})")
        if raw.shape[-1] != self.in_wire_len:
            raise ValueError(f"input has {raw.shape[-1]} items a channel, expected "
                             f"{self.in_wire_len}")
        w = self.local.in_wire_len
        cl = self.c_local
        blocks = {}
        for ci, ti in self.positions:
            b = raw[ci * cl - first:(ci + 1) * cl - first, ti * w:(ti + 1) * w]
            blocks[(ci, ti)] = b.contiguous().to(self._dev(ci, ti), non_blocking=True)
        return blocks

    def local_channels(self) -> tuple[int, int]:
        """(first channel, count) of this process's channel slabs."""
        idx = sorted(self._rows)
        if idx != list(range(idx[0], idx[0] + len(idx))):
            raise ValueError(f"this process's channel shards {idx} are not contiguous; "
                             "order the mesh's devices process-major")
        return idx[0] * self.c_local, len(idx) * self.c_local

    def step(self, carry: dict, raw, reset: bool = False):
        """raw: the global (C, n_in * items) wire (or this process's
        channel slab of it), or ``multihost.shard_input``'s placed blocks
        -> (new carry, the output of this process's positions: the
        global (C, n_out * items) wire on ``device`` when the mesh is
        this process's)."""
        blocks = raw if isinstance(raw, dict) else self.place_input(raw)
        new, outs = self.step_rows(carry, blocks, list(self._rows), reset)
        return new, self._assemble(outs)

    def step_rows(self, carry: dict, blocks: dict, rows: list, reset: bool = False):
        """The step of the channel shards ``rows`` alone over their
        positions' placed blocks -> ({position: new carry}, {position:
        output})."""
        new, outs = {}, {}
        for ci in rows:
            row = self._rows[ci]
            if self.t == 1:
                nc, outs[(ci, 0)] = self._chain(ci, 0).step(carry[(ci, 0)],
                                                            blocks[(ci, 0)], reset)
                new[(ci, 0)] = nc
                continue
            rc, ro = _RowStep(self, ci, row, {t: carry[(ci, t)] for t in row.held},
                              {t: blocks[(ci, t)] for t in row.held}, bool(reset)).run()
            for t in row.held:
                new[(ci, t)], outs[(ci, t)] = rc[t], ro[t]
        return new, outs

    def _assemble(self, outs: dict) -> torch.Tensor:
        held = [row.held for row in self._rows.values()]
        if any(h != held[0] for h in held):
            raise ValueError("this process's positions are not a rectangle of the mesh")
        rows = []
        for ci, row in self._rows.items():
            parts = [outs[(ci, t)].to(self.device, non_blocking=True) for t in row.held]
            rows.append(parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1))
        return rows[0] if len(rows) == 1 else torch.cat(rows, dim=0)


class _RowStep:
    """One step of one channel slab over T > 1 time shards.  It walks the
    local Chain's route (``Chain.route``) as ``Chain._step`` does, each
    stage a ``Chain`` method on every held shard, and supplies the state
    that crosses the shards: the halos, the DC starts, shard 0's
    estimator input, the AGC's gains and each shard's first NCO phase."""

    def __init__(self, sc: ShardedChain, ci: int, row: _TimeRow, carry: dict,
                 raws: dict, reset: bool):
        self.sc, self.row, self.raws = sc, row, raws
        self.held = row.held
        self.t = sc.t
        self.ch = {t: sc._chain(ci, t) for t in self.held}
        self.lc = sc.local
        if reset:
            carry = {t: self.ch[t]._reset_carry(c) for t, c in carry.items()}
        self.carry = carry
        self.rep = carry[self.held[0]]          # the replicated leaves, on lead
        self.new = {t: dict(c) for t, c in carry.items()}

    def each(self, fn) -> dict:
        return {t: fn(t) for t in self.held}

    def place(self, key: str, value) -> None:
        """A replicated leaf computed on lead, into every shard's carry."""
        for t in self.held:
            self.new[t][key] = _to(value, self.row.devs[t])

    def halo(self, vals: dict, carried: dict):
        """(use, recv): each shard's preceding samples (shard 0: the carry)
        and the ring shift's result, the next step's carry."""
        recv = self.row.ring_shift(vals)
        return {t: carried[t] if t == 0 else recv[t] for t in self.held}, recv

    def tails(self, y: dict, h: int) -> dict:
        n = y[self.held[0]][0].shape[-1]
        return self.each(lambda t: (y[t][0][:, n - h:].contiguous(),
                                    y[t][1][:, n - h:].contiguous()))

    def phases(self, key: str, n: int, dth: int) -> dict:
        """Each shard's first NCO phase (the carry t * n samples on; None
        without the NCO); the carry advances by T * n."""
        if not dth:
            return dict.fromkeys(self.held)
        for t in self.held:
            self.new[t][key] = nco.advance(self.carry[t][key], self.t * n, dth)
        return self.each(lambda t: nco.advance(self.carry[t][key], t * n, dth))

    # --- DC ------------------------------------------------------------------

    def dc_starts(self, dec: dict) -> dict:
        """The DC state (C, 4) each shard starts from, for its decoded
        block (``Chain.decode``): the preceding raw input sample and the
        true y start, composed in float64 from every shard's end as the DC
        kernel leaves it from a zero y start.  Sets the carry's dc: the
        wrapped x halo, the composed end."""
        lc = self.lc
        last = self.each(lambda t: torch.cat(
            [p[:, -1:] for p in (dec[t][:2] if dec[t][0] is not None else self.last_frame(t))],
            -1))
        x_prev, x_recv = self.halo(last, self.each(lambda t: self.carry[t]["dc"][:, 0:2]))
        ends = self.row.all_gather(self.each(lambda t: kernels.dc_block_apply(
            dec[t][0], dec[t][1], torch.cat([x_prev[t], torch.zeros_like(x_prev[t])], -1),
            lc.dc_alpha, **dec[t][2])[2][:, 2:4]))
        a_n = float((1.0 - lc.dc_alpha) ** lc.n_in)
        s = self.rep["dc"][:, 2:4].double()
        starts = [s]
        for j in range(1, self.t):
            s = ends[j - 1].double() + a_n * s
            starts.append(s)
        end = (ends[-1].double() + a_n * starts[-1]).float()
        for t in self.held:
            self.new[t]["dc"] = torch.cat([x_recv[t], end.to(self.row.devs[t])], -1)
        return self.each(lambda t: torch.cat(
            [x_prev[t], starts[t].float().to(self.row.devs[t])], -1).contiguous())

    def last_frame(self, t: int):
        """Shard t's last input frame, decoded as the DC kernel decodes it."""
        items = self.lc.fmt_in.items_per_frame
        return convert.to_planar(self.raws[t][:, -items:], self.lc.fmt_in, self.lc.cfg.gain)

    # --- pre-stage -------------------------------------------------------------

    def iq_update(self, dec: dict) -> torch.Tensor:
        """The estimator run once on lead over shard 0's input
        (``Chain.iq_input``'s first IQ_FFT_SIZE frames, broadcast; with the
        DC block also shard 0's carried DC state): the factors (lead)."""
        lc, dc = self.lc, self.lc.cfg.dc_block
        m = min(lc.n_in, C.IQ_FFT_SIZE)
        prefix = None
        if 0 in self.held:
            prefix = tuple(v[:, :m] for v in lc.iq_input(*dec[0]))
            prefix += (self.carry[0]["dc"],) if dc else ()
        kind = convert.wire_kind(lc.fmt_in)
        shape = (self.sc.c_local, m)
        specs = [(shape, kind[0])] if kind else [(shape, torch.float32)] * 2
        specs += [((self.sc.c_local, 4), torch.float32)] if dc else []
        got = self.row.broadcast0(prefix, tuple(specs))
        x, dc_state = (got[:-1], got[-1]) if dc else (got, None)
        state = lc.estimate(x, self.rep["iq"], dc_state, advance=self.t * lc.n_in)
        self.place("iq", state)
        return state.factors

    def pre(self) -> dict:
        """Chain's pre-stage on each shard from its DC start, the factors
        and its first NCO phase: {t: (xr, xi)}."""
        lc = self.lc
        phase = self.phases("nco_pre", lc.n_in, lc.dtheta_pre)
        dec = self.each(lambda t: self.ch[t].decode(self.raws[t]))
        state = self.dc_starts(dec) if lc.cfg.dc_block else dict.fromkeys(self.held)
        fac = self.iq_update(dec) if lc.cfg.iq_correction else None
        return self.each(lambda t: self.ch[t].pre_stage(
            *dec[t], state[t], _to(fac, self.row.devs[t]), phase[t])[:2])

    def wire_stage0(self) -> dict:
        """Resampler stage 0 over each shard's packed wire: without the DC
        block Chain's K2, its halo the previous shard's ``wire_tail``."""
        lc = self.lc
        phase = self.phases("nco_pre", lc.n_in, lc.dtheta_pre)
        carried = self.each(lambda t: self.carry[t]["rs"][0])
        if lc.cfg.dc_block:
            y, recv = self.wire_stage0_dc(phase, carried)
        else:
            use, recv = self.halo(self.each(
                lambda t: self.ch[t].wire_tail(self.raws[t], phase[t])), carried)
            y = self.each(lambda t: self.ch[t].wire_stage0(self.raws[t], use[t],
                                                           phase[t])[0])
        for t in self.held:
            self.rs[t][0] = recv[t]
        return y

    def wire_stage0_dc(self, phase: dict, carried: dict):
        """Stage 0 with the DC block over the wire, the one stage a time
        shard does not run as Chain does.  Chain's K1 DC-blocks each window
        group from a state its carry pass runs up from the block's first
        sample; a shard knows that first state only once every shard's
        first DC pass has ended (``dc_starts``).  So: the DC kernel twice,
        ``kernels.dc_prologue`` from the composed start (the decoded,
        DC-blocked, rotated planes and their tail, the halo), then K2 over
        the planes.  (outputs, the received halos)."""
        lc = self.lc
        dec = self.each(lambda t: self.ch[t].decode(self.raws[t]))
        state = self.dc_starts(dec)
        pro = self.each(lambda t: kernels.dc_prologue(
            dc_state=state[t], dc_alpha=lc.dc_alpha, hist=lc.resampler.stages[0].hist,
            nco_dtheta=lc.dtheta_pre, nco_phase=phase[t], **dec[t][2]))
        use, recv = self.halo(self.each(lambda t: pro[t][2:4]), carried)
        return self.each(lambda t: self.ch[t].resample_stage(0, pro[t][:2], use[t])[0]), recv

    # --- stages ----------------------------------------------------------------

    def filt(self, which: str, x: dict) -> dict:
        """The pre- or post-filter over its halo (``Chain.apply_filter``)."""
        h = getattr(self.lc, which + "_filter").block
        key = which + "_f"
        carried = self.each(lambda t: self.carry[t][key])
        use, recv = self.halo(self.tails(x, h), carried) if h else (carried, carried)
        for t in self.held:
            self.new[t][key] = recv[t]
        return self.each(lambda t: self.ch[t].apply_filter(which, x[t], use[t])[0])

    def stage(self, si: int, x: dict) -> dict:
        """Resampler stage ``si`` over its halo (``Chain.resample_stage``)."""
        use, recv = self.halo(self.tails(x, self.lc.resampler.stages[si].hist),
                              self.each(lambda t: self.carry[t]["rs"][si]))
        for t in self.held:
            self.rs[t][si] = recv[t]
        return self.each(lambda t: self.ch[t].resample_stage(si, x[t], use[t])[0])

    # --- post ------------------------------------------------------------------

    def rms_gains(self, x: dict):
        """(gains {t: (C, n_seg)}, seg): the gain loop over the global
        block's segment energies, each shard its own slice."""
        cfg_agc = self.lc.agc_cfg
        n = x[self.held[0]][0].shape[-1]
        n_seg, seg, beta = agc.rms_params(cfg_agc, n)
        e = torch.cat(self.row.all_gather(self.each(lambda t: kernels.segment_energies(
            x[t][0].contiguous(), x[t][1].contiguous()))), dim=-1)
        st = self.rep["agc"]
        gains, g_fin, e2_fin = kernels.agc_chain(e, st.gain, st.e2, beta, cfg_agc.target)
        self.place("agc", dataclasses.replace(
            st, gain=g_fin, e2=e2_fin,
            samples_seen=(st.samples_seen + self.t * n) & 0xFFFFFFFF))
        return self.each(lambda t: _to(gains[:, t * n_seg:(t + 1) * n_seg].contiguous(),
                                       self.row.devs[t])), seg

    def digital_gain(self, x: dict) -> torch.Tensor:
        """The digital profile's gain (lead), its peak over every shard."""
        n = x[self.held[0]][0].shape[-1]
        peak = self.row.all_max(self.each(lambda t: agc.block_peak(*x[t])))
        g, st = agc.digital_update(self.rep["agc"], peak, self.t * n, self.lc.agc_cfg)
        self.place("agc", st)
        return g

    def post(self, x: dict) -> dict:
        """Chain's post-stage on each shard from the AGC's gains over every
        shard and its first NCO phase."""
        lc = self.lc
        dth, cfg_agc = lc.dtheta_post, lc.agc_cfg
        phase = self.phases("nco_post", x[self.held[0]][0].shape[-1], dth)
        if lc.route.rms_after_nco:
            x = self.each(lambda t: nco.mix(*x[t], phase[t], dth))
            phase = dict.fromkeys(self.held)
        gains, seg, dig = {}, 0, None
        if cfg_agc is not None and cfg_agc.profile == "digital":
            dig = self.digital_gain(x)
        elif cfg_agc is not None:
            gains, seg = self.rms_gains(x)
        return self.each(lambda t: self.ch[t].post(
            *x[t], phase[t], gains.get(t), seg, _to(dig, self.row.devs[t])))

    # --- the step --------------------------------------------------------------

    def run(self):
        r, fmt_out = self.lc.route, self.lc.fmt_out
        self.rs = {t: list(self.carry[t].get("rs", ())) for t in self.held}
        x = self.wire_stage0() if r.wire_stage0 else self.pre()
        if r.pre_filter:
            x = self.filt("pre", x)
        for si in r.stages:
            x = self.stage(si, x)
        if self.lc.resampler is not None:
            for t in self.held:
                self.new[t]["rs"] = tuple(self.rs[t])
        if r.post_filter:
            x = self.filt("post", x)
        if r.packed:
            return self.new, self.each(lambda t: convert.packed_to_wire(x[t], fmt_out))
        return self.new, self.post(x)
