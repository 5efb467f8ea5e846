"""A cell as the files name it: BENCHMARK.json's entry, its workload file,
its configuration file and its traffic file, each found by name under the
benchmark's folder; and the program's chain built from them."""

from __future__ import annotations

import dataclasses
import json
import math
import re
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]          # the benchmark's folder
ROOT = HERE.parent                                  # the checkout
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def check_name(name: str) -> str:
    if not NAME_RE.match(name):
        raise ValueError(f"bad name {name!r}")
    return name


def reader_path(name: str) -> Path:
    """The reader of metric ``name``: metrics/<name>.py, or for a metric
    split by the end-to-end metric it moves (``<base>.<split>``) the one
    reader of its base, metrics/<base>.py."""
    path = HERE / "metrics" / f"{check_name(name)}.py"
    return path if path.is_file() else HERE / "metrics" / f"{name.split('.')[0]}.py"


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict          # BENCHMARK.json's workloads entry
    workload: dict       # workloads/<name>.json
    config: dict         # configs/<config>.json
    traffic: dict        # traffic/<traffic>.json
    e2e: list            # the end_to_end metrics this cell reports
    per_layer: list      # the per_layer metrics this cell reports

    @property
    def chain(self) -> dict:
        return self.config["chain"]

    @property
    def channels(self) -> int:
        return int(self.traffic["channels"])

    @property
    def block(self) -> int:
        """The target block the chain is framed at (a row's, when folded)."""
        return int(self.traffic["block_frames"])

    def due_period(self, n_in: int) -> int:
        """Steps between the I/Q estimator's updates (1 without one): it is
        due at the first step and then once its counter of input frames,
        advanced a step at a time, has passed 0.5 s of input."""
        if not self.chain.get("iq_correction"):
            return 1
        interval = int(0.5 * float(self.chain["input_rate"]))
        return math.ceil(interval / n_in) + 1


def load(cell: str, bench: dict | None = None) -> Cell:
    """The cell BENCHMARK.json names ``cell``."""
    bench = bench or spec()
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json")
    return from_entry(entry, bench)


def from_entry(entry: dict, bench: dict | None = None) -> Cell:
    """A cell from a workloads entry (name, config, traffic, chips) and its
    files, reporting the metrics BENCHMARK.json gives it."""
    bench = bench or spec()
    cell = entry["name"]
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(cell, entry,
                load_json(HERE / "workloads" / f"{check_name(cell)}.json"),
                load_json(HERE / "configs" / f"{check_name(entry['config'])}.json"),
                load_json(HERE / "traffic" / f"{check_name(entry['traffic'])}.json"),
                e2e, per)


def build_chain(cell: Cell, device):
    """The program's chain for the cell, by the CLI's rule for the fold
    (``cli.choose_time_fold`` and ``cli.fold_chain``: 8 rows at one
    channel on the card, 1 past 8 channels) over a ChainConfig made
    from the configuration file.  ``cli.build_chain`` itself takes an
    AppConfig, which holds one frequency shift; config #4 has two."""
    from iq_tool_tpu_torch import cli
    from iq_tool_tpu_torch.ops.fir_design import FilterRequest
    from iq_tool_tpu_torch.pipeline.chain import ChainConfig
    fields = dict(cell.chain)
    fields["filters"] = tuple(FilterRequest(*f) for f in fields.get("filters", []))
    cfg = ChainConfig(channels=cell.channels, target_block=cell.block, **fields)
    fold, auto = cli.choose_time_fold(cell.traffic.get("time_fold"), cell.channels,
                                      device, False)
    return cli.fold_chain(cfg, fold, auto, device)
