"""Checkpoint and resume of a stream's state (the port of
``iq_tool_tpu.pipeline.checkpoint``).

All stream memory lives in the chain's carry, so the carry plus the
input and output frame counts is enough to resume a job sample-exactly.
The file holds the carry in the reference's layout
(the chain's ``carry_to_numpy``: plain numpy leaves, uint32 NCO phases
and counters), so a checkpoint written on the card loads on the CPU and the
other way round.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np


def _flatten(tree) -> list:
    """The numpy leaves of a carry tree: dict keys sorted, tuples in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _flatten(v)]
    return [np.asarray(tree)]


def _unflatten(example, leaves: list):
    """``leaves`` in the shape of the tree ``example`` (consumed in order)."""
    if isinstance(example, dict):
        return {k: _unflatten(example[k], leaves) for k in sorted(example)}
    if isinstance(example, (tuple, list)):
        return tuple(_unflatten(v, leaves) for v in example)
    return leaves.pop(0)


def _structure(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k}:{_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        return "(" + ",".join(_structure(v) for v in tree) + ")"
    return "*"


def save_checkpoint(path: str, host: dict, frames_in: int, frames_out: int,
                    meta: dict | None = None) -> None:
    """Atomically write carry + stream position to ``path`` (.npz): a
    temporary file, fsync, rename, fsync of the directory.  ``host`` is
    the carry in the reference's layout (the chain's
    ``carry_to_numpy``)."""
    leaves = _flatten(host)
    payload = {f"leaf_{i}": leaf for i, leaf in enumerate(leaves)}
    payload["__meta__"] = np.frombuffer(json.dumps({
        "frames_in": int(frames_in),
        "frames_out": int(frames_out),
        "treedef": _structure(host),
        "complex_mask": [False] * len(leaves),     # the reference's loader reads it
        "extra": meta or {},
    }).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
            # fsync before the rename: a journaled rename of an unsynced
            # temporary file can lose both checkpoints on power loss
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, chain, example_carry: dict | None = None):
    """(carry, frames_in, frames_out, extra_meta): the carry of ``chain``
    (a Chain, FoldedChain or ShardedChain), whose leaves' shapes and
    dtypes must match those of ``example_carry`` (default
    ``chain.init_carry()``)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files) - 1)]
    if example_carry is None:
        example_carry = chain.init_carry()
    example = chain.carry_to_numpy(example_carry)
    want = _flatten(example)
    if meta["treedef"] != _structure(example) or len(leaves) != len(want):
        raise ValueError(
            f"checkpoint structure mismatch: {meta['treedef']} with {len(leaves)} "
            f"leaves vs {_structure(example)} with {len(want)} — chain config "
            "differs from the checkpointed one")
    for a, b in zip(leaves, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(
                f"checkpoint leaf mismatch: {a.shape}/{a.dtype} vs "
                f"{b.shape}/{b.dtype} — chain config differs from the "
                "checkpointed one")
    carry = chain.carry_from_numpy(_unflatten(example, list(leaves)))
    return carry, meta["frames_in"], meta["frames_out"], meta["extra"]
