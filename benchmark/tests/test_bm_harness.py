"""The harness on the CPU: the traffic drivers' ring indexing and stamps
at tiny sizes, the benchmark's files by name, the entry
point without a card, the import guard, the trace reader and the metric
readers."""

import ast
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness import cell as cells, drive, trace
from benchmark.tests.helpers import config3_cell, small_run

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "iq_tool_tpu"}


# ------------------------------------------------------------ the files

def test_benchmark_json_and_every_file_load_by_name():
    spec = cells.spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "benchmark/run.py"] and spec["paths"] == ["benchmark"]
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in spec["workloads"]:
        cell = cells.load(w["name"], spec)
        assert cell.workload["name"] == w["name"] and cell.traffic["mode"] in drive.MODES
        names = {m["name"] for m in cell.e2e}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in names
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert cells.reader_path(m["name"]).is_file(), m["name"]
        assert 0.01 <= m.get("bound", 0.01) <= 0.25


def test_names_and_units_use_the_allowed_characters():
    spec = cells.spec()
    things = spec["configs"] + spec["workloads"] + spec["end_to_end"] + spec["per_layer"]
    for t in things:
        assert cells.NAME_RE.match(t["name"]), t["name"]
        for k in ("config", "traffic"):
            if k in t:
                assert cells.NAME_RE.match(t[k])
        for k in t.get("reduced", []):
            assert cells.NAME_RE.match(k)
        if "unit" in t:
            assert cells.UNIT_RE.match(t["unit"]), t["unit"]
        for k in ("why", "layer", "source"):
            if isinstance(t.get(k), str):
                assert 1 <= len(t[k]) <= 200 and "\n" not in t[k] and "\t" not in t[k]
    assert len({t["name"] for t in things}) == len(things)


def test_run_without_a_card_exits_nonzero():
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "baseline1-resident64", "--seed", "2147483650", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert not res.stdout.strip()


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_nothing_imports_jax_or_the_jax_package():
    """Top-level names compared whole: iq_tool_tpu_torch is not iq_tool_tpu."""
    for path in BENCH.rglob("*.py"):
        assert not (_imports(path) & FORBIDDEN), path
    for path in (BENCH / "reference").rglob("*.py"):
        assert "iq_tool_tpu_torch" not in _imports(path), path


# ------------------------------------------------------- traffic drivers

def test_due_period():
    c = cells.load("full4-resident64")
    assert c.due_period(262144) == 5 and c.due_period(131072) == 9
    assert cells.load("baseline1-resident64").due_period(262144) == 1


def test_replay_feed_indexes_the_ring_and_stops_in_step(monkeypatch):
    cap = np.arange(3 * 2 * 2 * 4, dtype=np.int16).reshape(3, -1)      # 3 channels, 4 blocks of 2
    feed = drive.ReplayFeed(cap, 2, 1.0, 3, "cs16")
    feed.arm(blocks=6)
    gens = [list(feed.payloads(c, 2)) for c in range(3)]
    assert [len(g) for g in gens] == [6, 6, 6]
    for k in range(6):
        np.testing.assert_array_equal(np.frombuffer(gens[1][k], np.int16),
                                      cap[1, 4 * (k % 4):4 * (k % 4) + 4])
        np.testing.assert_array_equal(feed.block(k).numpy(), cap[:, 4 * (k % 4):4 * (k % 4) + 4])
    assert len(feed.released) == 6
    # out of time at once: the first period boundary past the blocks the
    # check needs (3 + 4 / 2 + 3 = 8)
    monkeypatch.setattr(drive, "END_WARM_FRAMES", 4)
    feed.arm(seconds=0.0)
    assert len(list(feed.payloads(0, 2))) == 9 and feed.limit == 9


@pytest.mark.parametrize("name", ["baseline1-resident64", "baseline1-engine64",
                                  "full4-resident64", "config3-resident", "config3-engine"])
def test_a_small_run_through_each_driver(name):
    """Each cell, and config 3's cu8 chain in either mode, through its
    driver and the check."""
    run = small_run(config3_cell(name.split("-")[1]) if name.startswith("config3") else name)
    wire = torch.uint8 if name.startswith("config3") else torch.int16
    assert run.inputs(0).dtype == wire and run.inputs(0).shape[-1] == 2 * run.n_in
    assert run.steps > 0 and run.window_s > 0 and run.total_steps >= run.steps
    assert len(run.start_out) == drive.START_STEPS and len(run.end_out) == drive.END_STEPS
    assert run.total_steps % run.cell.due_period(run.n_in) == 0
    if run.mode == "engine":
        assert len(run.transits) == run.steps and min(run.transits) > 0
    from benchmark.harness import check
    numbers = check.check(run, "cpu")
    assert all(v <= lim for _, v, lim in numbers), numbers


# ------------------------------------------------------------- readers

def _fake_prof(dev, host):
    def ev(t0, t1, name, kind):
        return types.SimpleNamespace(start_ns=lambda: int(t0 * 1e9),
                                     duration_ns=lambda: int((t1 - t0) * 1e9),
                                     name=lambda: name,
                                     device_type=lambda: types.SimpleNamespace(name=kind))
    events = [ev(*d, "CUDA") for d in dev] + [ev(*h, "CPU") for h in host]
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def test_trace_reader_takes_the_union_and_labels_gaps():
    dev = [(0.0, 1.0, "void iqk::banded_kernel<1>(A)"), (0.5, 1.5, "void iqk::dc_kernel<2>(B)"),
           (3.0, 3.5, "void iqk::banded_kernel<1>(A)")]
    host = [(1.0, 4.0, "outer"), (1.6, 2.9, "cudaEventSynchronize")]
    t = trace.read(_fake_prof(dev, host), 5.0)
    assert t.busy_s == pytest.approx(2.0)
    assert t.gaps[0] == ("cudaEventSynchronize", pytest.approx(1.5))
    assert t.family_s("banded_kernel") == (pytest.approx(1.5), 2)
    assert t.ops[0] == ("iqk::banded_kernel", pytest.approx(1.5))


def test_readers_return_nothing_where_there_is_nothing_to_read():
    sys.path.insert(0, str(BENCH))
    import run as entry
    r = types.SimpleNamespace(mode="engine", window_s=2.0, frames_in=4e8, dev_trace=None,
                              steps=10, bounds={"banded": 1e-4, "osfft": 0.0, "step": 7e-5},
                              transits=[0.1, 0.3, 0.2], setup_s=9.0)
    assert entry.reader("engine_msps")(r) == pytest.approx(200.0)
    assert entry.reader("resident_msps")(r) is None
    assert entry.reader("banded_roofline")(r) is None
    assert entry.reader("engine_transit_ms.engine")(r) == pytest.approx(200.0)
    r.mode, r.dev_trace = "resident", trace.DeviceTrace(1.0, 0.5, {"k": (0.5, 10)}, [], [])
    assert entry.reader("step_roofline.resident")(r) == pytest.approx(100 * 7e-5 / 0.05)
    assert entry.reader("device_idle_pct.resident")(r) == pytest.approx(50.0)
    # a metric split by what it moves has the one reader of its base
    assert cells.reader_path("device_idle_pct.engine").name == "device_idle_pct.py"
    assert entry.reader("device_idle_pct.engine")(r) == pytest.approx(50.0)
    assert entry.reader("osfft_roofline")(r) is None
    assert entry.reader("banded_roofline")(r) is None      # no banded kernel in the trace
