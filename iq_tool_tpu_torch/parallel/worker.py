"""One process of a multi-process sharded-chain job.

    python -m iq_tool_tpu_torch.parallel.worker --rank 0 --world-size 2 \\
        --init-method tcp://127.0.0.1:29500 --device cpu \\
        --devices-per-process 4 --channels 4 --blocks 3 --check

Runs ``multihost.initialize`` -> ``global_mesh`` (one channel shard per
process unless told otherwise) -> ``host_local_channels`` -> each step
fed this process's channel slab through ``shard_input``.  Every process
makes the same seeded global stream and keeps its slab.  With
``--check`` it also runs the single-device ``Chain`` over its slab at the
per-shard framing and requires its own output positions byte-identical
(the chain has no DC blocker, whose cross-shard start is exact only up
to float rounding).  ``--chain general`` runs BASELINE config #4's
stages instead (DC, I/Q, both shifts, the 2175-tap notch, local AGC),
and ``--check`` then holds it against the same mesh stepped in one
process (``--device cpu``).  With ``--device cuda`` each process takes
its own ``--devices-per-process`` cards (NCCL).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from iq_tool_tpu_torch.ops.fir_design import FilterRequest
from iq_tool_tpu_torch.parallel import multihost
from iq_tool_tpu_torch.parallel.sharded import ShardedChain, make_mesh
from iq_tool_tpu_torch.pipeline.chain import Chain, ChainConfig


def build_config(channels: int, target_block: int, chain: str = "flat") -> ChainConfig:
    """"flat": cs16 -> +150 kHz -> 400 kHz lowpass -> 1.488375 Msps ->
    local AGC -> cs16, without the DC blocker; "general": config #4."""
    if chain == "general":
        return ChainConfig(input_format="cs16", output_format="cs16",
                           input_rate=2_048_000.0, target_rate=1_488_375.0,
                           channels=channels, dc_block=True, iq_correction=True,
                           freq_shift_pre_hz=100_000.0, freq_shift_post_hz=-50_000.0,
                           filters=(FilterRequest("stop-range", 0.0, 10_000.0),),
                           agc_profile="local", target_block=target_block)
    return ChainConfig(input_format="cs16", output_format="cs16",
                       input_rate=2_048_000.0, target_rate=1_488_375.0,
                       channels=channels, freq_shift_pre_hz=150_000.0,
                       filters=(FilterRequest("lowpass", 400_000.0),),
                       agc_profile="local", target_block=target_block)


def reference(chain, raws: list, parts: int, keep: list) -> np.ndarray:
    """``chain`` stepped over each block cut into ``parts`` sub-blocks;
    the outputs of the sub-blocks in ``keep``, in order."""
    carry, outs = chain.init_carry(), []
    w = raws[0].shape[-1] // parts
    for raw in raws:
        for j in range(parts):
            carry, o = chain.step(carry, raw[:, j * w:(j + 1) * w].contiguous())
            if j in keep:
                outs.append(o.cpu().numpy())
    return np.concatenate(outs, axis=-1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="iq_tool_tpu_torch.parallel.worker")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--init-method", default="tcp://127.0.0.1:29500")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--devices-per-process", type=int, default=1)
    ap.add_argument("--channels", type=int, default=4)
    ap.add_argument("--channel-shards", type=int, default=None,
                    help="default: one channel shard per process")
    ap.add_argument("--time-shards", type=int, default=None)
    ap.add_argument("--target-block", type=int, default=2048)
    ap.add_argument("--chain", choices=("flat", "general"), default="flat")
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--check", action="store_true",
                    help="hold the output against the single-device chain")
    args = ap.parse_args(argv)

    k = args.devices_per_process
    if args.device == "cpu":
        # one thread: the processes share the host's cores, and a fixed
        # thread count keeps the CPU products' summation order fixed
        torch.set_num_threads(1)
    local = (["cpu"] * k if args.device == "cpu"
             else [f"cuda:{args.rank * k + i}" for i in range(k)])
    multihost.initialize(args.init_method, args.world_size, args.rank, local)
    pid = args.rank
    n_dev = args.world_size * k
    c_shards = args.channel_shards or args.world_size
    t_shards = args.time_shards or n_dev // c_shards
    mesh = multihost.global_mesh(c_shards, t_shards, local)
    cfg = build_config(args.channels, args.target_block, args.chain)
    sc = ShardedChain(cfg, mesh)
    first_ch, n_ch = multihost.host_local_channels(sc)
    held = sorted({ti for _, ti in sc.positions})
    print(f"[proc {pid}] mesh={c_shards}x{t_shards} feeds channels "
          f"[{first_ch}, {first_ch + n_ch}), time shards {held}", flush=True)

    rng = np.random.default_rng(20260817)
    raws = [rng.integers(-2 ** 14, 2 ** 14, (args.channels, sc.in_wire_len)).astype(np.int16)
            for _ in range(args.blocks)]
    carry = sc.init_carry()
    outs = []
    for raw in raws:
        carry, out = sc.step(carry, multihost.shard_input(sc, raw[first_ch:first_ch + n_ch]))
        outs.append(out.cpu().numpy())
    got = np.concatenate(outs, axis=-1)

    if args.check:
        first_ch, n_ch = multihost.host_local_channels(sc)
        slabs = [r[first_ch:first_ch + n_ch] for r in raws]
        if args.chain == "general":
            one = ShardedChain(cfg, make_mesh(["cpu"] * n_dev, c_shards, t_shards))
            want = reference(one, [torch.from_numpy(r) for r in raws], 1, [0])
            w = sc.local.out_wire_len
            want = np.concatenate([want[first_ch:first_ch + n_ch, (k * t_shards + j) * w:
                                        (k * t_shards + j + 1) * w]
                                   for k in range(args.blocks) for j in held], axis=-1)
        else:
            single = Chain(ChainConfig(**{**cfg.__dict__, "channels": n_ch}), device=sc.device)
            want = reference(single, [torch.from_numpy(r).to(sc.device) for r in slabs],
                             t_shards, held)
        if got.shape != want.shape or not np.array_equal(got, want):
            d = (np.abs(got.astype(np.int64) - want.astype(np.int64)).max()
                 if got.shape == want.shape else "shape")
            print(f"[proc {pid}] CHECK FAILED max|diff| = {d}", flush=True)
            return 1
        what = "single-process mesh" if args.chain == "general" else "single-device chain"
        print(f"[proc {pid}] CHECK OK: {got.shape} byte-identical to the {what}", flush=True)
    print(f"[proc {pid}] PASS", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
