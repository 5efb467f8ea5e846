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
* ``broadcast0``: shard 0's first IQ_FFT_SIZE DC-blocked samples, which
  the I/Q estimator reads.

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
from iq_tool_tpu_torch.ops import agc, convert, dc_block, iq_balance, kernels, nco
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

    def broadcast0(self, val, shapes: tuple) -> tuple:
        """Shard 0's float32 tensors (``val`` where this process holds
        shard 0, else None; ``shapes`` theirs) on ``lead``."""
        if 0 in self.held:
            self._p2p([(x, r) for r in self.peers for x in val], [])
            return _to(val, self.lead)
        bufs = tuple(torch.empty(s, dtype=torch.float32, device=self.lead) for s in shapes)
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
        new, outs = {}, {}
        for ci, row in self._rows.items():
            if self.t == 1:
                nc, outs[(ci, 0)] = self._chain(ci, 0).step(carry[(ci, 0)],
                                                            blocks[(ci, 0)], reset)
                new[(ci, 0)] = nc
                continue
            rc, ro = _RowStep(self, ci, row, {t: carry[(ci, t)] for t in row.held},
                              {t: blocks[(ci, t)] for t in row.held}, bool(reset)).run()
            for t in row.held:
                new[(ci, t)], outs[(ci, t)] = rc[t], ro[t]
        return new, self._assemble(outs)

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
    """One step of one channel slab over T > 1 time shards: each stage
    runs on every held shard, its halo crossing between them."""

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

    def phases(self, key: str, n: int, dth: int) -> dict | None:
        """Each shard's first NCO phase (the carry t * n samples on); the
        carry advances by T * n."""
        if not dth:
            return None
        for t in self.held:
            self.new[t][key] = nco.advance(self.carry[t][key], self.t * n, dth)
        return self.each(lambda t: nco.advance(self.carry[t][key], t * n, dth))

    # --- DC ------------------------------------------------------------------

    def dc_starts(self, x_prev: dict, first_pass) -> dict:
        """The DC state (C, 4) each shard starts from: x_prev and the true
        y start, composed in float64 from every shard's zero-start end
        (``first_pass(t, state)`` runs the DC kernel, returning its new
        state).  Sets the carry's dc: the wrapped x halo, the composed
        end."""
        z = self.each(lambda t: torch.zeros_like(x_prev[t]))
        ends = self.row.all_gather(self.each(
            lambda t: first_pass(t, torch.cat([x_prev[t], z[t]], -1))[:, 2:4]))
        a_n = float((1.0 - self.lc.dc_alpha) ** self.lc.n_in)
        s = self.rep["dc"][:, 2:4].double()
        starts = [s]
        for j in range(1, self.t):
            s = ends[j - 1].double() + a_n * s
            starts.append(s)
        end = (ends[-1].double() + a_n * starts[-1]).float()
        for t in self.held:
            self.new[t]["dc"] = torch.cat([self.x_recv[t], end.to(self.row.devs[t])], -1)
        return self.each(lambda t: torch.cat(
            [x_prev[t], starts[t].float().to(self.row.devs[t])], -1).contiguous())

    def x_halo(self, planes: dict) -> dict:
        """Each shard's preceding raw input sample (C, 2): shard 0's from
        the carry."""
        last = self.each(lambda t: torch.cat([planes[t][0][:, -1:], planes[t][1][:, -1:]], -1))
        use, self.x_recv = self.halo(last, self.each(lambda t: self.carry[t]["dc"][:, 0:2]))
        return use

    # --- pre-stage -------------------------------------------------------------

    def iq_update(self, seg0) -> torch.Tensor:
        """Shard 0's estimator input broadcast, the estimator run once on
        lead over it: the factors (lead)."""
        shape = (self.sc.c_local, min(self.lc.n_in, C.IQ_FFT_SIZE))
        seg_r, seg_i = self.row.broadcast0(seg0, (shape, shape))
        state = iq_balance.maybe_update_planar(seg_r, seg_i, self.rep["iq"],
                                               self.lc.iq_interval,
                                               advance_samples=self.t * self.lc.n_in)
        self.place("iq", state)
        return state.factors

    def pre(self) -> dict:
        """Convert + [DC + I/Q + pre-NCO]: {t: (xr, xi)} (Chain._pre)."""
        lc, cfg = self.lc, self.lc.cfg
        n = lc.n_in
        phase = self.phases("nco_pre", n, lc.dtheta_pre)
        if not cfg.dc_block:
            x = self.each(lambda t: convert.to_planar(self.raws[t], lc.fmt_in, cfg.gain))
            if cfg.iq_correction:
                m = min(n, C.IQ_FFT_SIZE)
                seg0 = (x[0][0][:, :m], x[0][1][:, :m]) if 0 in x else None
                fac = self.iq_update(seg0)
                x = self.each(lambda t: iq_balance.apply_planar(*x[t], _to(fac, self.row.devs[t])))
            if phase is not None:
                x = self.each(lambda t: nco.mix(*x[t], phase[t], lc.dtheta_pre))
            return self.each(lambda t: (x[t][0].contiguous(), x[t][1].contiguous()))
        # K3 twice: zero-start ends, then from the composed starts
        wires = self.each(lambda t: convert.wire_pack(self.raws[t], lc.fmt_in))
        planes, args = {}, {}
        for t in self.held:
            if wires[t] is None:
                xr, xi = (p.contiguous() for p in convert.to_planar(
                    self.raws[t], lc.fmt_in, cfg.gain))
                planes[t] = (xr, xi)
                args[t] = dict(xr=xr, xi=xi)
            else:
                planes[t] = None
                args[t] = dict(xr=None, xi=None, wire_i32=wires[t][0],
                               wire_norm=lc.fmt_in.normalizer, wire_gain=cfg.gain,
                               wire_kind=wires[t][1])
        x_prev = self.x_halo(self.each(lambda t: planes[t] or self.last_frame(t)))
        state = self.dc_starts(x_prev, lambda t, st: kernels.dc_block_apply(
            state=st, alpha=lc.dc_alpha, **args[t])[2])
        fac = None
        if cfg.iq_correction:
            seg0 = None
            if 0 in self.held:
                m = min(n, C.IQ_FFT_SIZE)
                a0 = args[0]
                pr, pi = ((a0["xr"], a0["xi"]) if planes[0] is not None else
                          convert.decode_packed(a0["wire_i32"][:, :m], a0["wire_kind"],
                                                a0["wire_norm"], cfg.gain))
                seg0 = dc_block.apply_prefix(pr, pi, self.carry[0]["dc"], lc.dc_alpha, m)
            fac = self.iq_update(seg0)
        out = {}
        for t in self.held:
            yr, yi, _ = kernels.dc_block_apply(
                state=state[t], alpha=lc.dc_alpha,
                iq_factors=None if fac is None else _to(fac, self.row.devs[t]),
                phase_acc=phase[t] if phase else None, dtheta=lc.dtheta_pre, **args[t])
            out[t] = (yr, yi)
        return out

    def last_frame(self, t: int):
        """Shard t's last input frame, decoded as the DC kernel decodes it."""
        items = self.lc.fmt_in.items_per_frame
        return convert.to_planar(self.raws[t][:, -items:], self.lc.fmt_in, self.lc.cfg.gain)

    # --- stages ----------------------------------------------------------------

    def filt(self, key: str, x: dict, packed_fmt=None):
        """The pre- or post-filter over a halo; with ``packed_fmt`` the
        packed epilogue where the filter has one ({t: wire} or None)."""
        f = lambda t: getattr(self.ch[t], key + "_filter")
        h = f(self.held[0]).block
        carried = self.each(lambda t: self.carry[t][key + "_f"])
        use, recv = self.halo(self.tails(x, h), carried) if h else (carried, carried)
        for t in self.held:
            self.new[t][key + "_f"] = recv[t]
        if packed_fmt:
            res = self.each(lambda t: f(t).apply_planar_packed(*x[t], *use[t],
                                                                 out_fmt=packed_fmt))
            if res[self.held[0]] is not None:
                return {t: r[0] for t, r in res.items()}, True
        return self.each(lambda t: f(t).apply_planar(*x[t], *use[t])[:2]), False

    def stages(self, x: dict, start: int, pack_fmt) -> dict:
        """Resampler stages ``start``.. over their halos; the last one
        packs the wire when ``pack_fmt`` is given."""
        stages = self.lc.resampler.stages
        rs = {t: list(self.new[t]["rs"]) for t in self.held}
        for si in range(start, len(stages)):
            use, recv = self.halo(self.tails(x, stages[si].hist),
                                  self.each(lambda t: self.carry[t]["rs"][si]))
            pf = pack_fmt if si == len(stages) - 1 else None
            x = self.each(lambda t: self.ch[t].resampler.stages[si].apply_planar(
                *x[t], *use[t], pack_fmt=pf)[0])
            for t in self.held:
                rs[t][si] = recv[t]
        for t in self.held:
            self.new[t]["rs"] = tuple(rs[t])
        return x

    def wire_stage0(self) -> dict:
        """Stage 0 on the packed wire (Chain._wire_resample_step): the DC
        kernel twice and K2 over its planes with the DC blocker, else K2
        decoding the wire, its halo the previous shard's decoded, rotated
        raw tail."""
        lc, cfg = self.lc, self.lc.cfg
        n = lc.n_in
        st0 = lc.resampler.stages[0]
        hist = st0.hist
        norm = lc.fmt_in.normalizer
        pack0 = lc.pack_fmt if len(lc.resampler.stages) == 1 else None
        dth = lc.dtheta_pre
        phase = self.phases("nco_pre", n, dth)
        ph = (lambda t: phase[t]) if phase else (lambda t: None)
        wires = self.each(lambda t: convert.wire_pack(self.raws[t], lc.fmt_in))
        band = lambda t: self.ch[t].resampler.stages[0].band
        carried = self.each(lambda t: self.carry[t]["rs"][0])
        if cfg.dc_block:
            x_prev = self.x_halo(self.each(self.last_frame))
            state = self.dc_starts(x_prev, lambda t, st: kernels.dc_block_apply(
                None, None, st, lc.dc_alpha, wire_i32=wires[t][0], wire_norm=norm,
                wire_gain=cfg.gain, wire_kind=wires[t][1])[2])
            pro = self.each(lambda t: kernels.dc_prologue(
                wires[t][0], state[t], lc.dc_alpha, hist, norm, cfg.gain, dth, ph(t),
                wires[t][1]))
            use, recv = self.halo(self.each(lambda t: pro[t][2:4]), carried)
            y = self.each(lambda t: kernels.banded_apply(
                *use[t], *pro[t][:2], band(t), None, st0.stride, hist, pack_fmt=pack0))
        else:
            items = lc.fmt_in.items_per_frame

            def tail(t):
                tr, ti = convert.to_planar(self.raws[t][:, -hist * items:], lc.fmt_in,
                                           cfg.gain)
                if dth:
                    tr, ti = nco.mix(tr, ti, phase[t], dth, start=n - hist)
                return tr.contiguous(), ti.contiguous()
            use, recv = self.halo(self.each(tail), carried)
            y = self.each(lambda t: kernels.banded_apply(
                *use[t], None, None, band(t), None, st0.stride, hist, pack_fmt=pack0,
                wire_i32=wires[t][0], wire_norm=norm, wire_gain=cfg.gain,
                nco_dtheta=dth, nco_phase=ph(t), wire_kind=wires[t][1]))
        for t in self.held:
            self.new[t]["rs"] = (recv[t], *self.carry[t]["rs"][1:])
        return y

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
        """Post-NCO + AGC + convert (Chain._fused_post / _plain_post)."""
        lc = self.lc
        n = x[self.held[0]][0].shape[-1]
        dth = lc.dtheta_post
        cfg_agc = lc.agc_cfg
        phase = self.phases("nco_post", n, dth)
        if lc.pack_fmt and (dth or cfg_agc is not None):
            seg = 0
            if cfg_agc is not None and cfg_agc.profile != "digital":
                gains, seg = self.rms_gains(x)
            elif cfg_agc is not None:
                g = self.digital_gain(x)[:, None].contiguous()
                gains = self.each(lambda t: _to(g, self.row.devs[t]))
            else:
                gains = self.each(lambda t: torch.ones((x[t][0].shape[0], 1),
                                                       dtype=torch.float32,
                                                       device=self.row.devs[t]))
            return self.each(lambda t: convert.packed_to_wire(kernels.post_apply(
                x[t][0].contiguous(), x[t][1].contiguous(), gains[t], seg,
                phase[t] if phase else None, dth, out_fmt=lc.pack_fmt), lc.fmt_out))
        dig = None
        if cfg_agc is not None and cfg_agc.profile == "digital":
            dig = self.digital_gain(x)
        if phase is not None:
            x = self.each(lambda t: nco.mix(*x[t], phase[t], dth))
        if dig is not None:
            x = self.each(lambda t: tuple(p * _to(dig, self.row.devs[t])[:, None]
                                          for p in x[t]))
        elif cfg_agc is not None:
            gains, seg = self.rms_gains(x)
            x = self.each(lambda t: tuple(p * kernels._segment_gains(gains[t], seg, n)
                                          for p in x[t]))
        return self.each(lambda t: convert.from_planar(*x[t], lc.fmt_out))

    # --- the step --------------------------------------------------------------

    def run(self):
        lc = self.lc
        convert_only = not lc.dtheta_post and lc.agc_cfg is None
        if lc._wire_resample:
            y = self.wire_stage0()
            if len(lc.resampler.stages) > 1:
                y = self.stages(y, 1, lc.pack_fmt)
            if lc.pack_fmt:
                return self.new, self.each(lambda t: convert.packed_to_wire(y[t], lc.fmt_out))
            return self.new, self.each(lambda t: convert.from_planar(*y[t], lc.fmt_out))
        x = self.pre()
        if lc.pre_filter is not None:
            x, _ = self.filt("pre", x)
        if lc.resampler is not None:
            if (lc.post_filter is None and convert_only and lc.pack_fmt
                    and lc.resampler.packs):
                y = self.stages(x, 0, lc.pack_fmt)
                return self.new, self.each(lambda t: convert.packed_to_wire(y[t], lc.fmt_out))
            x = self.stages(x, 0, None)
        if lc.post_filter is not None:
            x, packed = self.filt("post", x, lc.pack_fmt if convert_only else None)
            if packed:
                return self.new, self.each(lambda t: convert.packed_to_wire(x[t], lc.fmt_out))
        return self.new, self.post(x)
