"""Sharded execution of the chain over a (channel, time) mesh of devices
(the port of ``iq_tool_tpu.parallel``): ``sharded`` steps a chain over
the mesh, ``multihost`` spans it over several processes."""

from iq_tool_tpu_torch.parallel.sharded import Mesh, ShardedChain, make_mesh  # noqa: F401
