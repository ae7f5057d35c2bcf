"""``BENCHMARK.json`` and the files it names. Everything a cell needs is
found by name: its configuration's ``file``, its traffic file
``benchmark/traffic/<traffic>.json``, the driver of the traffic's ``kind``
(``benchmark/drivers/<kind>.py``) and a reader per metric
(``benchmark/metrics/<metric name>.py``)."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(manifest: dict, workload: str, root: Path = ROOT) -> dict:
    """{"config", "traffic"} of one cell: its configuration file's content
    and its traffic file's content."""
    found = [w for w in manifest["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    entry = [c for c in manifest["configs"] if c["name"] == w["config"]][0]
    with open(root / entry["file"]) as f:
        config = json.load(f)
    with open(root / "benchmark" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return {"config": config, "traffic": traffic}


def end_to_end(manifest: dict, workload: str) -> List[dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])]


def per_layer(manifest: dict, workload: str) -> List[dict]:
    """The per-layer metrics this cell reports: those whose ``workloads``
    list it. Every per-layer entry lists its cells."""
    return [m for m in manifest["per_layer"] if workload in m["workloads"]]


def driver(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def reader(name: str):
    """The module of ``benchmark/metrics/<name>.py``; its ``read(ctx)``
    returns the metric's value or None."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
