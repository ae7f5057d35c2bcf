"""The treecode entry points of the port on the CPU, at 2000 bodies:
``datagen --force-backend bh``, ``experiments.bh_rollout`` and
``experiments.treeforce_bench`` write the JAX package's schemas and keys
(``nbody_tpu/data/schema.py``, ``nbody_tpu/experiments/bh_rollout.py:153-174``,
``nbody_tpu/experiments/treeforce_bench.py:99-216``). And no entry point runs
on the CPU unless ``--device cpu`` asks for it."""

import json
import math
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from nbody_tpu.data.schema import CSV_FIELDS as J_CSV_FIELDS
from nbody_tpu_torch.cli import datagen
from nbody_tpu_torch.experiments import (bh_rollout, contconv_experiment, crossover,
                                         gnn_experiment, knn_recall, large_scale, run,
                                         train_large, tree_kernel_bench, treeforce_bench)

N = 2000
CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "gnn_reference.json")
ROLLOUT_KEYS = {"n", "steps", "dt", "engine", "bh_near", "block", "bh_refresh",
                "wall_s", "ms_per_step", "psteps_per_s", "audit_s", "device"}
ENERGY_KEYS = {"E0", "E1", "rel_energy_drift"}
SAMPLE_KEYS = {"error_sample", "end_rel_err_median", "end_rel_err_p99"}
PROFILE_KEYS = {"profile_steps", "profile_wall_s", "busy_seconds", "idle_share", "top_ms"}
BENCH_KEYS = {"n", "n_near", "block", "exact_ms", "bh_fresh_ms", "bh_reused_ms",
              "partition_ms", "rel_err_median", "rel_err_p99", "err_over_rms_p99",
              "speedup_fresh", "speedup_reused", "seed"}


def _json_lines(out):
    return [json.loads(s) for s in out.splitlines() if s.startswith("{")]


def test_datagen_cli_bh_backend(tmp_path, capsys):
    out = str(tmp_path / "bh.csv")
    datagen.main(["--n-bodies", str(N), "--sim-type", "spiral", "--steps", "3",
                  "--force-backend", "bh", "--seed", "1", "--device", "cpu",
                  "--output", out])
    df = pd.read_csv(out)
    assert list(df.columns) == J_CSV_FIELDS and len(df) == 3 * N
    assert np.isfinite(df.drop(columns=["scene_type"]).to_numpy(np.float64)).all()
    data = np.load(out[:-4] + ".npz")
    assert data["scene0_pos"].shape == (3, N, 3)
    assert "done" in capsys.readouterr().out


@pytest.mark.parametrize("argv,extra", [
    (["--engine", "bh", "--steps", "4", "--bh-refresh", "2"], ENERGY_KEYS),
    (["--engine", "bh2", "--block", "128", "--steps", "4", "--chunk-steps", "2",
      "--chunked-energy-audit", "700"], ENERGY_KEYS | {"coarse", "rc", "chunk_steps",
                                                       "chunked_energy_audit"}),
    (["--engine", "bh3", "--block", "128", "--steps", "3", "--chunk-steps", "2",
      "--no-energy-audit", "--error-sample", "256", "--profile"],
     SAMPLE_KEYS | PROFILE_KEYS | {"coarse", "rc", "sub_block", "n_sub", "chunk_steps"}),
])
def test_bh_rollout(argv, extra, tmp_path, capsys):
    out = tmp_path / "r.json"
    row = bh_rollout.main(["--n-bodies", str(N), "--device", "cpu", "--out", str(out),
                           *argv])
    (line,) = _json_lines(capsys.readouterr().out)
    assert line == row == json.loads(out.read_text())
    assert set(row) == ROLLOUT_KEYS | extra | {"device_kind"}
    assert row["device"] == "cpu" and row["steps"] == 4  # 3 steps round up to 2 chunks of 2
    assert math.isfinite(row["wall_s"]) and row["psteps_per_s"] > 0
    if "rel_energy_drift" in row:
        assert row["rel_energy_drift"] < 1e-3  # a few leapfrog steps of dt 1e-4
    else:
        assert row["error_sample"] == 256
        assert 0 < row["end_rel_err_median"] < 0.1
        assert math.isfinite(row["end_rel_err_p99"])
        assert row["end_rel_err_p99"] >= row["end_rel_err_median"]
        assert row["profile_steps"] == 2 and row["busy_seconds"] > 0
        assert row["idle_share"] == pytest.approx(
            1 - row["busy_seconds"] / row["profile_wall_s"])


@pytest.mark.parametrize("engine,extra", [
    ("bh", set()), ("bh2", {"coarse", "rc"}), ("bh3", {"coarse", "rc", "sub_block", "n_sub"})])
def test_treeforce_bench(engine, extra, tmp_path, capsys):
    out = tmp_path / "b.json"
    rows = treeforce_bench.main(["--n-bodies", str(N), "--engine", engine, "--block", "128",
                                 "--n-near", "8", "--coarse", "4", "--rc", "4", "--reps", "1",
                                 "--device", "cpu", "--out", str(out)])
    (line,) = _json_lines(capsys.readouterr().out)
    assert [line] == rows == json.loads(out.read_text())["rows"]
    assert set(line) == BENCH_KEYS | extra
    assert all(math.isfinite(v) and v >= 0 for v in line.values())
    assert line["rel_err_median"] < 0.1


def test_treeforce_bench_sampled_error(capsys):
    (row,) = treeforce_bench.main(["--n-bodies", str(N), "--block", "128", "--n-near", "8",
                                   "--reps", "1", "--exact-cap", "100", "--error-sample",
                                   "300", "--device", "cpu"])
    assert "exact_ms" not in row and row["error_sample"] == 300
    assert row["rel_err_median"] < 0.1


@pytest.mark.parametrize("entry,argv", [
    (datagen.main, ["--n-bodies", "5", "--steps", "2", "--output", "never.csv"]),
    (large_scale.main, ["--n-bodies", "600", "--steps", "2"]),
    (bh_rollout.main, ["--n-bodies", "600", "--steps", "2"]),
    (treeforce_bench.main, ["--n-bodies", "600", "--reps", "1"]),
    (gnn_experiment.main, ["--quick", "--base", "never"]),
    (contconv_experiment.main, ["--quick", "--base", "never"]),
    (run.main, ["--config", CONFIG, "--set", "base=never"]),
    (crossover.main, ["--n-bodies", "600", "--steps", "2", "--out", "never.json"]),
    (train_large.main, ["--n-bodies", "600", "--steps", "2", "--epochs", "1"]),
    (knn_recall.main, ["--n-bodies", "600", "--out", "never.json"]),
])
def test_entry_points_need_cuda_or_device_cpu(entry, argv, monkeypatch, tmp_path):
    """Without ``--device`` an entry point runs on cuda; with no CUDA device
    it raises, naming ``--device cpu``, before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="--device cpu"):
        entry(argv)
    assert not list(tmp_path.iterdir())


def test_tree_kernel_bench_needs_cuda(monkeypatch, tmp_path):
    """The treecode kernels' bench times CUDA kernels only: with no CUDA
    device it exits, naming that, before it builds or writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tree_kernel_bench.main(["--out", "never.json"])
    assert not list(tmp_path.iterdir())
