"""The port's multi-process sharded chain (``iq_tool_tpu_torch.parallel.
multihost``) as tests/test_multihost.py runs the JAX package's: N local
processes of ``python -m iq_tool_tpu_torch.parallel.worker`` joined by
torch.distributed over gloo, each with CPU mesh devices, each feeding
its own channel slab.  Every process holds its output byte-identical to
the single-device port chain at the per-shard framing (``--check``), or
for config #4's stages (DC, I/Q, notch, AGC: every collective crosses a
process) to the same mesh stepped in one process.
"""

import os
import socket
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_job(num_processes: int, devices_per_proc: int, extra: list,
             timeout: float = 300.0) -> list:
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, "-m", "iq_tool_tpu_torch.parallel.worker", "--rank", str(r),
         "--world-size", str(num_processes), "--init-method", f"tcp://127.0.0.1:{port}",
         "--device", "cpu", "--devices-per-process", str(devices_per_proc), *extra],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(num_processes)]
    outs, failed = [], []
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"worker {r} timed out after {timeout}s")
        outs.append(out)
        if p.returncode != 0:
            failed.append((r, p.returncode, out))
    assert not failed, "\n\n".join(f"worker {r} exited {rc}:\n{out[-3000:]}"
                                   for r, rc, out in failed)
    for r, out in enumerate(outs):
        assert f"[proc {r}] CHECK OK" in out and f"[proc {r}] PASS" in out, out[-2000:]
    return outs


def test_two_process_byte_identical():
    """tests/test_multihost.py:72: 2 processes x 4 devices, a 2 x 4 mesh."""
    outs = _run_job(2, 4, ["--channels", "4", "--blocks", "3", "--check"])
    assert "mesh=2x4" in outs[0] and "feeds channels [2, 4)" in outs[1]


def test_four_process_byte_identical():
    """tests/test_multihost.py:79: 4 processes x 2 devices, a 4 x 2 mesh."""
    outs = _run_job(4, 2, ["--channels", "8", "--blocks", "2", "--check"])
    assert all("mesh=4x2" in o for o in outs)


def test_time_halo_crosses_processes():
    """A 1 x 2 mesh over 2 processes of one device each: every halo, the
    AGC's energies and the wrapped carry cross the process boundary."""
    outs = _run_job(2, 1, ["--channels", "2", "--channel-shards", "1", "--time-shards", "2",
                           "--blocks", "3", "--check"])
    assert "time shards [0]" in outs[0] and "time shards [1]" in outs[1]


def test_general_chain_across_processes():
    """Config #4's stages over a 1 x 4 mesh of 2 processes: the DC ends,
    the I/Q window, the AGC energies and every halo cross the boundary."""
    outs = _run_job(2, 2, ["--channels", "2", "--channel-shards", "1", "--time-shards", "4",
                           "--target-block", "4096", "--blocks", "2", "--chain", "general",
                           "--check"])
    assert "time shards [2, 3]" in outs[1]
