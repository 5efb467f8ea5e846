"""A run of each cell on the card, short: it exits 0 with a record whose
``correct`` is true.  Skips without a card (run on the card with
``pytest -m gpu benchmark/tests``)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import cell as cells

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in cells.spec()["workloads"]])
def test_a_short_run_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                          "2147483653", "--seconds", "4", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    record = json.loads(res.stdout.strip().splitlines()[-1])
    assert record["correct"] and record["device"]["platform"] == "gpu", record
    assert set(record["metrics"]) == {m["name"] for m in cells.load(name).e2e}
