"""BENCHMARK.json and the files it names agree, and a new cell is taken from
its files alone."""

import json
import os
import re
import shutil
import statistics

import pytest
import torch

from benchmark import run
from benchmark.harness import manifest as mf

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def man():
    return mf.load()


def test_top_level_keys_and_command(man):
    assert set(man) == KEYS
    assert man["command"] == ["python3", "benchmark/run.py"]
    assert man["paths"] == ["benchmark"]
    assert 1 <= man["run_seconds"] <= 51 and isinstance(man["run_seconds"], int)
    assert os.path.getsize(mf.ROOT / "BENCHMARK.json") <= 64 * 1024


def test_entries_have_only_their_keys(man):
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_names_units_and_bounds(man):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in man[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    bounds = {m["name"]: m["bound"] for m in man["end_to_end"]}
    assert bounds["setup_s"] == 0.25
    assert all(0.01 <= b <= 0.25 for b in bounds.values())


def test_every_file_is_there_and_used(man):
    configs = {c["name"] for c in man["configs"]}
    used = {w["config"] for w in man["workloads"]}
    assert used == configs
    files = [c["file"] for c in man["configs"]]
    assert len(files) == len(set(files))
    for c in man["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(mf.ROOT / c["file"]) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert all(key in body for key in c["reduced"])
    for w in man["workloads"]:
        cell = mf.cell(man, w["name"])
        assert hasattr(mf.driver(cell["traffic"]["kind"]), "window")
        assert cell["traffic"]["limits"]


def test_every_cell_reports_setup_another_metric_and_a_layer(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for w in man["workloads"]:
        mine = {m["name"] for m in mf.end_to_end(man, w["name"])}
        assert "setup_s" in mine and len(mine) >= 3
        layers = mf.per_layer(man, w["name"])
        assert layers
        for m in layers:
            assert m["moves"] in mine
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        assert m["workloads"], m["name"]
        for w in m["workloads"]:
            assert m["moves"] in {x["name"] for x in mf.end_to_end(man, w)}


def test_every_per_layer_metric_has_a_reader(man):
    for m in man["per_layer"]:
        assert callable(mf.reader(m["name"]).read)


def test_layers_are_named_alike(man):
    layers = {m["layer"] for m in man["per_layer"]}
    assert layers <= {"whole step", "device", "entry", "kernels"}


def test_run_seconds_fit_the_check_with_24_cells(man):
    seconds = man["run_seconds"]
    cells = 24
    total = (2 + 14 * cells) * (seconds + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_quartile_spread_rule_is_pythons():
    # the bounds were set from statistics.quantiles(values, n=4)
    q1, _, q3 = statistics.quantiles([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], n=4)
    assert (q1, q3) == (1.75, 5.25)


def test_a_new_cell_is_taken_from_its_files_alone(tmp_path, small):
    """A checkout whose only change is a new traffic file and its line in
    BENCHMARK.json runs that cell: nothing else is edited."""
    shutil.copytree(mf.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = mf.load()
    traffic = dict(json.loads((mf.BENCH / "traffic" / "rollout-1m-r8.json").read_text()),
                   n_bodies=1200, segment_steps=5, samples=1)
    (tmp_path / "benchmark" / "traffic" / "rollout-1200-test.json").write_text(json.dumps(traffic))
    man["workloads"].append({"name": "gnn-rollout-1200", "config": "gnn_reference",
                             "traffic": "rollout-1200-test", "chips": 1, "why": "a test cell"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "gnn-rollout-1m" in m.get("workloads", []):
            m["workloads"].append("gnn-rollout-1200")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    res, numbers = run.run_cell("gnn-rollout-1200", 5, 0.2, False, torch.device("cpu"), 0.0,
                                root=tmp_path)
    assert res["correct"], numbers
    assert set(res["metrics"]) == {"rollout_particle_steps_per_s", "peak_mem_gib", "setup_s"}
