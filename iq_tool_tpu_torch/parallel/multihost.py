"""Multi-process execution of the sharded chain (the port of
``iq_tool_tpu.parallel.multihost``).

``initialize`` joins this process to a ``torch.distributed`` job (gloo
for CPU devices, NCCL for CUDA ones); ``global_mesh`` lays the (channel,
time) mesh over every process's devices, process-major, so each process
holds a contiguous run of mesh positions; each process feeds only its
own channel slab (``host_local_channels``, ``shard_input``).  Channel
shards never talk to each other; a time neighbour in another process is
reached by point-to-point sends of its halo (``sharded._TimeRow``).  In a
single process every function degrades to the local mesh.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from iq_tool_tpu_torch.parallel.sharded import (Mesh, ShardedChain, grid, make_mesh,
                                                mesh_axes, visible_devices)
from iq_tool_tpu_torch.pipeline.chain import resolve_device

def _devices(local_devices) -> list:
    return (visible_devices() if local_devices is None
            else [resolve_device(d) for d in local_devices])


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, local_devices=None,
               backend: str | None = None) -> None:
    """Join the job as process ``rank`` of ``world_size`` (nothing to join
    when there is one process).  ``init_method`` is the rendezvous
    ("tcp://host:port", or "env://" to read MASTER_ADDR/MASTER_PORT);
    ``local_devices`` are this process's mesh devices (default: every
    visible CUDA device; CPU devices only when named, and then gloo
    carries the collectives)."""
    if world_size is None or world_size <= 1:
        return
    devs = _devices(local_devices)
    if backend is None:
        backend = "gloo" if all(d.type == "cpu" for d in devs) else "nccl"
    if backend == "nccl":
        torch.cuda.set_device(devs[0])
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)


def global_mesh(channel_shards: int | None = None, time_shards: int | None = None,
                local_devices=None) -> Mesh:
    """The mesh over every process's devices, process-major (rank 0's
    first); ``local_devices`` are this process's, as ``initialize`` took
    them."""
    local = _devices(local_devices)
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return make_mesh(local, channel_shards, time_shards)
    lists = [None] * dist.get_world_size()
    dist.all_gather_object(lists, [str(d) for d in local])
    devices = [d for lst in lists for d in lst]
    ranks = [r for r, lst in enumerate(lists) for _ in lst]
    _, t = mesh_axes(len(devices), channel_shards, time_shards)
    return Mesh(grid(devices, t), ranks=grid(ranks, t), rank=dist.get_rank())


def host_local_channels(sc: ShardedChain) -> tuple[int, int]:
    """(first channel, count) this process feeds: the channels of the
    channel shards its devices hold.  Raises when they are not
    contiguous (order the mesh process-major)."""
    return sc.local_channels()


def shard_input(sc: ShardedChain, host_array) -> dict:
    """A (channels, n_in * items) wire, global or this process's channel
    slab, as the step's placed blocks: {(channel shard, time shard):
    tensor on its device} for this process's positions."""
    if isinstance(host_array, np.ndarray):
        host_array = torch.from_numpy(np.ascontiguousarray(host_array))
    return sc.place_input(host_array)
