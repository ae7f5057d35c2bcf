"""The port's large-N experiment, ``python -m nbody_tpu_torch.experiments.large_scale``,
on the CPU (the kernels' twins) at N = 600, just above the Morton search's
small-N branch (N <= 512 at the default block of 256): both surrogate
families, every mode, and the JSON lines of the JAX script
(``nbody_tpu/experiments/large_scale.py:137-143``)."""

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

from nbody_tpu_torch.experiments import large_scale

REPO = Path(__file__).resolve().parents[1]
# keys of the JAX script's lines per mode
KEYS = {"direct": {"mode", "n_bodies", "steps", "seconds", "psteps_per_s"},
        "surrogate": {"mode", "n_bodies", "steps", "seconds", "psteps_per_s",
                      "graph_refresh", "final_pos_rmse_vs_direct"},
        "hybrid": {"mode", "n_bodies", "steps", "seconds", "psteps_per_s"}}


@pytest.mark.parametrize("argv", [
    ["--model", "contconv", "--conv-impl", "kernel", "--knn-impl", "kernel"],
    ["--model", "contconv", "--conv-impl", "dense", "--knn-impl", "dense"],
    ["--model", "gnn", "--knn-method", "morton", "--knn-impl", "kernel"],
    ["--model", "gnn", "--knn-method", "exact", "--graph-refresh", "2"],
])
def test_large_scale_all_modes(argv, capsys, tmp_path):
    out = tmp_path / "r.json"
    large_scale.main(["--n-bodies", "600", "--steps", "3", "--hybrid-warmup", "1",
                      "--device", "cpu", "--out", str(out), *argv])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert [r["mode"] for r in lines] == ["direct", "surrogate", "hybrid"]
    for r in lines:
        assert set(r) == KEYS[r["mode"]]
        assert r["n_bodies"] == 600 and r["steps"] == 3
        assert math.isfinite(r["seconds"]) and r["psteps_per_s"] > 0
    rmse = lines[1]["final_pos_rmse_vs_direct"]
    assert math.isfinite(rmse) and rmse < 1e-3  # 3 steps of dt 1e-4 apart
    assert json.loads(out.read_text())["device"] == "cpu"


def test_large_scale_profile_and_cpu_defaults(capsys, tmp_path):
    out = tmp_path / "r.json"
    res = large_scale.main(["--n-bodies", "600", "--steps", "2", "--hybrid-warmup", "1",
                            "--device", "cpu", "--model", "contconv", "--profile",
                            "--out", str(out)])
    assert list(res) == ["direct", "surrogate", "hybrid"]
    for r in res.values():
        assert set(r) >= KEYS["direct"] - {"mode", "n_bodies", "steps"}
        assert math.isfinite(r["busy_seconds"]) and r["busy_seconds"] > 0
        assert r["idle_share"] == pytest.approx(1 - r["busy_seconds"] / r["seconds"])
        assert r["top_ms"] and all(ms >= 0 for _, ms in r["top_ms"])
    saved = json.loads(out.read_text())
    assert (saved["conv_impl"], saved["knn_impl"]) == ("dense", "dense")  # kernel on cuda


def test_large_scale_cli_runs_on_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "nbody_tpu_torch.experiments.large_scale", "--model",
         "contconv", "--n-bodies", "600", "--steps", "3", "--device", "cpu",
         "--modes", "surrogate"], cwd=str(REPO), capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    (line,) = [json.loads(s) for s in res.stdout.splitlines()]
    assert line["mode"] == "surrogate" and line["graph_refresh"] == 1


def test_approx_knn_raises():
    with pytest.raises(NotImplementedError):
        large_scale.main(["--n-bodies", "600", "--steps", "2", "--device", "cpu",
                          "--knn-method", "approx", "--modes", "surrogate"])
