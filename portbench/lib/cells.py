"""Cells, and the files each is made of, found by name.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.
Its configuration is ``configs/<config>.json`` (whose ``kind`` picks the
driver ``lib/<kind>_cell.py``), its mix ``traffic/<traffic>.json``, its
correctness limits ``limits/<cell>.json``, and each of its metrics a
reader ``metrics/<metric>.py`` with ``read(record) -> float | None``.
Adding a configuration, a mix, a cell or a metric is adding files and
entries: nothing here lists them.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent.parent     # portbench/
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    mix: dict
    limits: dict
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False
    device: str = "cuda"
    t_start: float = 0.0          # time.monotonic() at process start
    # test hook: called with the system under test once it is built,
    # and may break it underneath (the fault tests)
    fault: Optional[Callable[[Any], Any]] = None
    control: Optional[str] = None  # "fp8": the reference in the program's place


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str, base: Path = HERE, **kw) -> Cell:
    """The cell ``name`` of ``bench``, its files read from ``base`` (the
    benchmark's folder)."""
    for w in bench["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    limits_path = base / "limits" / f"{name}.json"
    return Cell(name=name, chips=int(w["chips"]),
                cfg=load_json(base.parent / cfg_entry["file"]),
                mix=load_json(base / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(limits_path) if limits_path.exists() else {},
                **kw)


def metrics_for(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metrics this cell reports: its end-to-end ones untraced, its
    per-layer ones traced."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries
            if cell_name in m.get("workloads", [cell_name])]


def reader(name: str, base: Path = HERE):
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def drive(c: Cell) -> dict:
    """Run the cell's driver: set-up, the window, the check.  Returns
    its record."""
    kind = c.cfg["kind"]
    return importlib.import_module(f"portbench.lib.{kind}_cell").run(c)


def result(bench: dict, c: Cell, record: dict, base: Path = HERE) -> dict:
    """The result line: every metric of the cell that its reader finds,
    then the device, then the compared numbers beside their limits."""
    metrics = {}
    for m in metrics_for(bench, c.name, c.trace):
        value = reader(m["name"], base)(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {"correct": record["correct"], "attempted": record["attempted"],
           "failed": record["failed"], "metrics": metrics,
           "device": record["device"]}
    if c.trace and record.get("trace"):
        out["breakdown"] = {"device_ops": record["trace"]["device_ops"],
                            "idle_gaps": record["trace"]["idle_gaps"]}
    # how late an open loop's generator ran, whether the traffic ran
    # out, how long the check took: for a reader of the line, not checked
    out["notes"] = {k: record[k] for k in
                    ("max_lag_s", "traffic_exhausted", "reference_s",
                     "setup_s") if k in record}
    out["power_limit"] = record.get("power_limit")
    out["checks"] = record["checks"]
    return out


def judge(numbers: Dict[str, float], limits: dict) -> tuple:
    """(correct, checks): each number beside its limit; a number with no
    limit is shown and not held; a number that is not finite fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if not math.isfinite(value) or (limit is not None and value > limit):
            ok = False
    return ok, checks
