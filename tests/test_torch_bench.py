"""The port's measurement entry points on the CPU, at 4 channels x 16384
frames: ``python -m iq_tool_tpu_torch.bench`` (the counterpart of the
root bench.py and tools/bench_all.py) and ``python -m
iq_tool_tpu_torch.host_budget`` (tools/host_budget.py's).  On the CPU
their numbers are the CPU's; what is checked is their configs, their
keys and their lines.  The configs are held equal to tools/bench_all.py's
field by field (exact).
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from iq_tool_tpu_torch import bench  # noqa: E402
from iq_tool_tpu_torch.pipeline.chain import Chain, ChainConfig  # noqa: E402
from iq_tool_tpu_torch.profile_steps import BASELINE_CONFIGS, make_configs  # noqa: E402
from tools.bench_all import make_configs as jax_make_configs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHORT = ["1_raw_resample", "2_shift_lowpass", "3_cu8_fft_bandpass", "4_full_notch",
         "5_dp_batch"]
HOST_STAGES = ["file_read", "native_ring", "frombuffer+stack", "pin_copy", "h2d_pageable",
               "h2d_pinned", "pinned_out_alloc", "d2h_pinned", "out_tobytes", "sink_write"]


def _fields(cfg) -> dict:
    """A ChainConfig's fields, its filter requests as their fields."""
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    out["filters"] = [dataclasses.astuple(r) for r in cfg.filters]
    return out


@pytest.mark.parametrize("channels", [4, 128])
def test_make_configs_are_bench_alls(channels):
    """The five configs under tools/bench_all.py's long names, field for
    field its ChainConfigs (#5 at max(64, channels)), each mapped to
    bench.py's short name; each builds a Chain on the CPU."""
    block = 16384
    mine, theirs = make_configs(channels, block), jax_make_configs(channels, block)
    assert list(mine) == list(theirs) == list(BASELINE_CONFIGS)
    assert [BASELINE_CONFIGS[k][0] for k in mine] == SHORT
    for name, cfg in mine.items():
        assert isinstance(cfg, ChainConfig)
        assert _fields(cfg) == _fields(theirs[name]), name
    assert mine["5: 64-channel full chain (DP batch)"].channels == max(64, channels)
    if channels == 4:
        for cfg in mine.values():
            Chain(cfg, device="cpu")


def test_config_names_resolve_before_the_measurement(monkeypatch):
    """A config bench.py's map does not name keeps its own name, and one
    that raises gets "error: ..." in its slot: the rest of the matrix is
    measured (ADVICE.md: a renamed config must not collapse it)."""
    cfgs = make_configs(4, 16384)
    one = "1: raw cs16 -> resample -> cs16"
    bad = dataclasses.replace(cfgs[one], input_format="no-such-format")
    monkeypatch.setattr(bench, "make_configs", lambda channels, block: {
        "9: renamed": cfgs[one], "10: broken": bad, one: cfgs[one]})
    line = bench.run(4, 16384, device="cpu", reps=1)
    got = line["configs"]
    assert list(got) == ["flagship", "9: renamed", "10: broken", "1_raw_resample"]
    assert got["9: renamed"] > 0 and got["1_raw_resample"] > 0
    assert got["10: broken"].startswith("error: ")


def test_bench_cpu_last_line():
    """``python -m iq_tool_tpu_torch.bench --device cpu`` at 4 x 16384: the
    last line is bench.py's JSON line, every config a number, the device
    named, the C baseline measured or its error given."""
    res = subprocess.run([sys.executable, "-m", "iq_tool_tpu_torch.bench", "--device", "cpu",
                          "--channels", "4", "--block", "16384", "--reps", "1"],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["metric"] == bench.METRIC and line["unit"] == "Msamples/s"
    assert list(line["configs"]) == ["flagship", *SHORT]
    assert all(isinstance(v, float) and v > 0 for v in line["configs"].values())
    assert line["value"] == line["configs"]["flagship"]
    assert line["device"] == "cpu"
    if line["vs_baseline"] is None:
        assert line["baseline_error"]
    else:
        assert line["baseline"]["msps"] > 0 and line["baseline"]["threads"] >= 1
        assert line["vs_baseline"] == pytest.approx(line["value"] / line["baseline"]["msps"],
                                                    rel=1e-12)


def test_host_budget_no_device():
    """``python -m iq_tool_tpu_torch.host_budget --no-device`` at 4
    channels: one line a stage (the transfers and pinned memory marked
    not measured, the ring measured or marked unbuilt), then a summary
    of the serial host path with no device step."""
    res = subprocess.run([sys.executable, "-m", "iq_tool_tpu_torch.host_budget", "--no-device",
                          "--channels", "4", "--block", "16384"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(x) for x in res.stdout.strip().splitlines()]
    stages = {r["stage"]: r for r in lines if "stage" in r}
    assert set(stages) == set(HOST_STAGES)
    for s in ("file_read", "frombuffer+stack", "out_tobytes", "sink_write"):
        assert stages[s]["ns_per_sample"] > 0 and stages[s]["standalone_Msps"] > 0
    for s in ("pin_copy", "h2d_pageable", "h2d_pinned", "pinned_out_alloc", "d2h_pinned"):
        assert "not measured" in stages[s]["error"]
    summary = lines[-1]
    assert summary["stages"] == ["file_read", "frombuffer+stack", "out_tobytes", "sink_write"]
    assert summary["host_Msps"] == pytest.approx(1e3 / summary["ns_per_sample"])
    assert summary["device_step_Msps"] is None and summary["device"] == "cpu"
    assert (summary["channels"], summary["block"]) == (4, 16384)
