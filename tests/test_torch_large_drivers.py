"""The port's large-N entry points on the CPU at tiny sizes:
``experiments/crossover.py``, ``experiments/train_large.py`` and
``experiments/knn_recall.py`` write the JAX scripts' rows and keys
(``nbody_tpu/experiments/crossover.py:127-212``, ``train_large.py:357-437``,
``knn_recall.py:76-135``); ``train_large`` resumes, stops on its time budget
and reruns its eval from saved weights; the committed 1M weights equal the
conversion of the JAX msgpack; and a ``train_large``-shaped training run
(Morton graphs, fused EdgeConv, remat, batch 1) gives the JAX ``Trainer``'s
per-epoch losses from the same weights at rtol 2e-4, the bar of
``tests/test_torch_train.py``."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from flax import serialization

from nbody_tpu.models import GraphModel as JGraphModel
from nbody_tpu.train import PlateauScheduler as JPlateau
from nbody_tpu.train import Trainer as JTrainer
from nbody_tpu.data.dataset import BatchIterator as JBatchIterator
from nbody_tpu.data.dataset import SnapshotDataset as JSnapshotDataset
from nbody_tpu_torch.experiments import crossover, knn_recall, train_large
from nbody_tpu_torch.models import GraphModel, graph_model_state_dict
from nbody_tpu_torch.ops import contconv_kernel as cck
from nbody_tpu_torch.train import PlateauScheduler, Trainer

REPO = Path(__file__).resolve().parents[1]
PARAMS_1M = REPO / "results" / "large_scale" / "train_1m_params.pt"
N = 700  # above the Morton search's small-N branch (N <= 512)
DATA = ["--n-bodies", str(N), "--train-scenes", "1", "--steps", "8", "--stride", "4",
        "--batch-size", "1"]
GNN = [*DATA, "--neighbors", "4", "--gnn-dim", "8", "--remat"]
EVAL_KEYS = {"stepwise_scaled_rmse", "predict_zero_baseline_scaled_rmse", "rollout_horizon",
             "rollout_seconds", "rollout_pos_rmse", "final_acc_median_rel_err_vs_exact",
             "final_acc_rmse_vs_exact", "final_acc_rel_rmse_vs_exact"}


def _json_lines(out):
    return [json.loads(s) for s in out.splitlines() if s.startswith("{")]


@pytest.fixture(scope="module")
def gnn_run(tmp_path_factory):
    """One ``train_large`` GNN run: 2 epochs with a checkpoint each."""
    root = tmp_path_factory.mktemp("train_large")
    out = root / "gnn.json"
    argv = [*GNN, "--save-every", "1", "--scan-chunk", "3", "--data-dir", str(root / "data"),
            "--out", str(out), "--device", "cpu"]
    res = train_large.main([*argv, "--epochs", "2"])
    return root, out, argv, res


# ------------------------------------------------------------- train_large

def test_train_large_writes_the_jax_scripts_keys(gnn_run, tmp_path):
    """The result JSON of the same flags, key by key, against the JAX
    script's (run in a process of its own, with its compile cache under the
    test's directory); the port adds ``device_kind``."""
    _, out, _, res = gnn_run
    jout = tmp_path / "jax.json"
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               NBODY_TPU_COMPILE_CACHE=str(tmp_path / "xla"))
    proc = subprocess.run(
        [sys.executable, "-m", "nbody_tpu.experiments.train_large", *GNN, "--epochs", "2",
         "--scan-chunk", "3", "--data-dir", str(tmp_path / "jdata"), "--out", str(jout)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(jout.read_text())
    got = json.loads(out.read_text())
    assert got == json.loads(json.dumps(res))
    assert set(got) == set(want) | {"device_kind"}
    for section in ("dataset", "training", "eval"):
        assert set(got[section]) == set(want[section]), section
    assert set(got["eval"]) == EVAL_KEYS
    assert set(got["eval"]["rollout_pos_rmse"][0]) == set(want["eval"]["rollout_pos_rmse"][0])
    assert got["device"] == "cpu" and got["training"]["scan_chunk"] == 3
    assert got["training"]["remat"] is True and got["dataset"]["snapshots_per_scene"] == 2
    assert [r["step"] for r in got["eval"]["rollout_pos_rmse"]] == [0, 4]
    assert all(math.isfinite(got["eval"][k]) for k in EVAL_KEYS - {"rollout_pos_rmse"})
    # the epoch CSV has the JAX script's columns
    cols = list(pd.read_csv(str(jout)[:-5] + "_epoch_loss.csv").columns)
    assert list(pd.read_csv(str(out)[:-5] + "_epoch_loss.csv").columns) == cols


def test_train_large_resume_then_eval_only(gnn_run):
    """A relaunch with ``--save-every`` resumes from the latest checkpoint
    and continues the epoch CSV; ``--load-params`` then runs the eval stages
    only, keeps the training record and repeats the resumed run's eval."""
    root, out, argv, first = gnn_run
    stem = str(out)[:-5]
    assert sorted(os.listdir(stem + "_ckpt")) == ["ckpt_1.pt", "ckpt_2.pt"]
    assert list(pd.read_csv(stem + "_epoch_loss.csv")["epoch"]) == [1, 2]
    again = train_large.main([*argv, "--epochs", "1", "--skip-datagen"])
    csv = pd.read_csv(stem + "_epoch_loss.csv")
    assert list(csv["epoch"]) == [1, 2, 3] and list(csv.columns) == [
        "epoch", "loss", "mse_loss", "wall_s"]
    assert csv["loss"].iloc[1] == pytest.approx(first["training"]["final_scaled_rmse"])
    assert csv["loss"].iloc[2] == pytest.approx(again["training"]["final_scaled_rmse"])
    assert sorted(os.listdir(stem + "_ckpt")) == ["ckpt_1.pt", "ckpt_2.pt", "ckpt_3.pt"]
    assert len(again["training"]["seconds_per_epoch"]) == 1
    assert again["dataset"]["datagen_seconds"] == 0.0

    params = stem + "_params.pt"
    saved = torch.load(params, weights_only=True)
    assert list(saved) == list(GraphModel(input_dim=4, gnn_dim=8, message_passing_steps=2,
                                          neighbors=4).state_dict())
    ev = train_large.main([*argv, "--skip-datagen", "--load-params", params])
    assert ev["training"] == json.loads(json.dumps(again["training"]))
    assert ev["eval"]["params_loaded_from"] == params
    assert ev["eval"]["stepwise_scaled_rmse"] == again["eval"]["stepwise_scaled_rmse"]
    assert ev["eval"]["rollout_pos_rmse"] == again["eval"]["rollout_pos_rmse"]
    assert sorted(os.listdir(stem + "_ckpt")) == ["ckpt_1.pt", "ckpt_2.pt", "ckpt_3.pt"]
    assert list(pd.read_csv(stem + "_epoch_loss.csv")["epoch"]) == [1, 2, 3]


def test_train_large_time_budget_stops_after_one_epoch(gnn_run, tmp_path):
    root, _, _, _ = gnn_run
    out = tmp_path / "budget.json"
    res = train_large.main([*GNN, "--epochs", "5", "--train-time-budget", "1e-9",
                            "--save-every", "4", "--skip-datagen", "--data-dir",
                            str(root / "data"), "--out", str(out), "--device", "cpu"])
    assert len(res["training"]["seconds_per_epoch"]) == 1 and res["training"]["epochs"] == 5
    assert os.listdir(str(out)[:-5] + "_ckpt") == ["ckpt_1.pt"]  # the stop checkpoints
    assert set(res["eval"]) == EVAL_KEYS  # and the eval still ran


def test_train_large_frees_the_trainer_caches_before_eval(gnn_run, tmp_path, monkeypatch):
    """The training snapshots (and their device copies) are dropped through
    ``Trainer.free_caches`` once, after training."""
    root = gnn_run[0]
    seen = []
    free = Trainer.free_caches

    def spy(self):
        seen.append((len(self._ds_cache), len(self._dev_cache)))
        free(self)
        seen.append((len(self._ds_cache), len(self._dev_cache)))

    monkeypatch.setattr(Trainer, "free_caches", spy)
    train_large.main([*GNN, "--epochs", "1", "--skip-datagen", "--data-dir",
                      str(root / "data"), "--out", str(tmp_path / "free.json"),
                      "--device", "cpu"])
    assert len(seen) == 2 and min(seen[0]) > 0 and seen[1] == (0, 0)


def test_train_large_contconv_in_node_chunks(gnn_run, tmp_path, monkeypatch):
    """The reference-recipe ContConv through ``train_large`` with 3 node chunks:
    the collect runs once per chunk, layer and step in the forward and once
    more in the backward (rematerialised), once per chunk and layer in each
    eval forward; the result has the GNN run's keys."""
    root, _, _, gnn = gnn_run
    calls = []
    real = cck._Collect.apply
    monkeypatch.setattr(cck._Collect, "apply",
                        lambda *a: (calls.append(torch.is_grad_enabled()), real(*a))[1])
    out = tmp_path / "cc.json"
    res = train_large.main(["--model", "contconv", "--conv-node-chunks", "3", *DATA,
                            "--epochs", "1", "--skip-datagen", "--data-dir",
                            str(root / "data"), "--out", str(out), "--device", "cpu"])
    chunks, layers, steps = 3, 2, 2
    evals = 2 + res["eval"]["rollout_horizon"] + 1  # stepwise snapshots + rollout forwards
    assert sum(calls) == 2 * chunks * layers * steps
    assert len(calls) - sum(calls) == chunks * layers * evals
    assert res["model"] == "contconv" and set(res) == set(gnn)
    assert all(set(res[s]) == set(gnn[s]) for s in ("dataset", "training", "eval"))
    assert math.isfinite(res["training"]["final_scaled_rmse"])
    assert os.path.exists(str(out)[:-5] + "_params.pt")
    with pytest.raises(ValueError, match="kernel"):
        train_large.main(["--model", "contconv", "--conv-node-chunks", "2", "--conv-impl",
                          "dense", *DATA, "--skip-datagen", "--data-dir", str(root / "data"),
                          "--out", str(tmp_path / "never.json"), "--device", "cpu"])


def _losses_from_the_same_weights(train_dir, converted=True, **kw):
    """Three epochs of ``train_large``'s training call in both packages from
    the same weights: (JAX's losses, the port's). The port's model takes the
    converted JAX weights, or (``converted=False``) its trainer draws them
    from the seed as ``train_large`` does."""
    kw = dict(input_dim=4, message_passing_steps=2, aggr="mean", scale_factor=1e6,
              knn_method="morton", fused_edgeconv=True, output_scale=1e6, **kw)
    jt = JTrainer(JGraphModel(**kw, knn_impl="xla"), learning_rate=1e-3, dt=1e-4, seed=0,
                  scheduler=JPlateau(lr=1e-3, factor=0.25, patience=5))
    model = GraphModel(**kw, knn_impl="dense")
    if converted:
        ds = JSnapshotDataset.from_file(os.path.join(train_dir, "train_0.npz"))
        jt._ensure_state(next(iter(JBatchIterator(ds, 1, shuffle=False))))
        model.load_state_dict(graph_model_state_dict(
            jax.tree_util.tree_map(np.asarray, jt.state.params)))
    tt = Trainer(model, learning_rate=1e-3, dt=1e-4, seed=0,
                 scheduler=PlateauScheduler(lr=1e-3, factor=0.25, patience=5))
    call = dict(epochs=3, batch_size=1, batch_mode="bucketed", verbose=False)
    want, _ = jt.train_from_dir(train_dir, **call)
    got, _ = tt.train_from_dir(train_dir, **call)
    return want, got


@pytest.mark.parametrize("case", ["converted", "zero_init_from_the_seed"])
def test_train_large_shaped_losses_match_jax_trainer(gnn_run, case):
    """The slice as a whole: ``train_large``'s dataset, its model (Morton graphs,
    fused EdgeConv, remat, output scale) and its training call, from the
    same converted weights in both packages; and with ``--zero-init-output``
    (the flag of the 2-scene artifacts), each package drawing its weights
    from the seed alone."""
    root, _, _, _ = gnn_run
    zero = case == "zero_init_from_the_seed"
    want, got = _losses_from_the_same_weights(str(root / f"data{N}" / "train"),
                                              converted=not zero, gnn_dim=8, neighbors=4,
                                              remat=True, zero_init_output=zero)
    np.testing.assert_allclose(got, want, rtol=2e-4)


def test_train_large_shaped_losses_match_jax_trainer_without_remat(gnn_run):
    """The 20k-100k artifacts' GNN: no ``--remat``, k = 10."""
    root, _, _, _ = gnn_run
    want, got = _losses_from_the_same_weights(str(root / f"data{N}" / "train"), gnn_dim=8,
                                              neighbors=10, remat=False)
    np.testing.assert_allclose(got, want, rtol=2e-4)


# -------------------------------------------------------------- the weights

def test_committed_1m_weights_equal_the_converted_msgpack():
    """``results/large_scale/train_1m_params.pt`` is the JAX package's
    ``train_1m_params.msgpack`` through ``graph_model_state_dict``, tensor
    for tensor, and loads into the crossover model, fused or not."""
    raw = serialization.msgpack_restore(PARAMS_1M.with_suffix(".msgpack").read_bytes())
    want = graph_model_state_dict(raw)
    got = torch.load(PARAMS_1M, weights_only=True)
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    for fused in (False, True):
        model = GraphModel(input_dim=4, gnn_dim=64, message_passing_steps=2, aggr="mean",
                           neighbors=8, knn_method="morton", fused_edgeconv=fused, remat=fused)
        model.load_state_dict(got)


# ---------------------------------------------------------------- crossover

def test_crossover_rows_merge_and_steps_mismatch(tmp_path, capsys):
    out = tmp_path / "c.json"
    base = ["--n-bodies", str(N), "--steps", "2", "--neighbors", "8", "--device", "cpu",
            "--out", str(out)]
    rows = crossover.main([*base, "--bh", "--bh2", "--bh3", "--graph-refresh", "1", "2",
                           "--load-params", str(PARAMS_1M)])
    assert rows == _json_lines(capsys.readouterr().out)
    modes = [r["mode"] for r in rows]
    assert modes == ["direct", "bh(M=32,refresh=8)", "bh2(M=32,B=128,rc=48,refresh=8)",
                     "bh3(M=32,B=128,rc=48,K=24,refresh=8)", "surrogate(refresh=1)",
                     "surrogate(refresh=2)"]
    for r in rows:
        surrogate = r["mode"].startswith("surrogate")
        assert set(r) == {"n", "mode", "ms_per_step", "psteps_per_s", "finite"} | (
            {"params"} if surrogate else set())
        assert r["n"] == N and r["ms_per_step"] > 0 and r["finite"] is True
        assert r["psteps_per_s"] == pytest.approx(N / r["ms_per_step"] * 1e3)
        assert not surrogate or r["params"] == str(PARAMS_1M)
    art = json.loads(out.read_text())
    assert set(art) == {"device", "device_kind", "steps", "rows"}
    assert art["device"] == art["device_kind"] == "cpu" and art["steps"] == 2
    assert art["rows"] == sorted(rows, key=lambda r: (r["n"], r["mode"]))

    # --only extends the artifact: a rerun with an impl tag replaces the
    # untagged surrogate row, the other rows stay
    new = crossover.main([*base, "--only", "surrogate", "--graph-refresh", "2", "--knn-impl",
                          "kernel", "--no-fused"])
    assert [r["mode"] for r in new] == ["surrogate(kernel,refresh=2)"]
    assert new[0]["params"].startswith("random-init")
    merged = json.loads(out.read_text())["rows"]
    assert sorted(r["mode"] for r in merged) == sorted(
        modes[:5] + ["surrogate(kernel,refresh=2)"])
    assert [r for r in merged if r["mode"] == "direct"] == [rows[0]]

    # another --steps: refused under --only, a fresh sweep starts over
    with pytest.raises(SystemExit, match="steps=2"):
        crossover.main([*base[:2], "--steps", "3", *base[4:], "--only", "direct"])
    assert json.loads(out.read_text())["rows"] == merged
    crossover.main([*base[:2], "--steps", "3", *base[4:], "--only", "direct", "--out",
                    str(tmp_path / "fresh.json")])
    fresh = crossover.main([*base[:2], "--steps", "3", *base[4:], "--graph-refresh", "1"])
    art = json.loads(out.read_text())
    assert art["steps"] == 3 and art["rows"] == sorted(fresh, key=lambda r: r["mode"])


# --------------------------------------------------------------- knn_recall

def test_knn_recall_rows(tmp_path, capsys):
    out = tmp_path / "k.json"
    rows = knn_recall.main(["--n-bodies", str(N), "--k", "5", "--windows", "64",
                            "--kernel-blocks", "128", "--kernel-copies", "4", "2",
                            "--device", "cpu", "--out", str(out)])
    assert rows == _json_lines(capsys.readouterr().out) == json.loads(out.read_text())["rows"]
    assert [r["method"] for r in rows[:5]] == ["exact", "approx", "morton(W=64)",
                                               "morton-kernel(B=128)",
                                               "morton-kernel(B=128,C=2)"]
    assert [r["profile"] for r in rows] == ["disk"] * 5 + ["spiral"] * 5
    for r in rows:
        assert set(r) == {"profile", "n", "k", "method", "seconds", "recall"}
        assert r["seconds"] > 0 and 0.9 <= r["recall"] <= 1.0
    assert all(r["recall"] == 1.0 for r in rows if r["method"] in ("exact", "approx"))
    assert set(json.loads(out.read_text())) == {"device", "device_kind", "methodology", "rows"}


def test_recall_of_counts_valid_slots_only():
    exact = (torch.tensor([[1, 2], [0, 2], [0, 0]]), torch.tensor([[True, True]] * 2
                                                                  + [[True, False]]))
    got = (torch.tensor([[2, 5], [2, 0], [0, 0]]), torch.tensor([[True, True], [True, False],
                                                                [False, False]]))
    assert knn_recall.recall_of(*got, *exact) == pytest.approx(2 / 5)
    assert knn_recall.recall_of(*exact, *exact) == 1.0


# ------------------------------------------------------------ without JAX

_JAX_FREE = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "nbody_tpu"):
    sys.modules[name] = None
import os, tempfile
import torch
from nbody_tpu_torch.experiments import crossover, knn_recall, train_large
from nbody_tpu_torch.ops import edgeconv_kernel as ek
d = tempfile.mkdtemp()
rows = crossover.main(["--n-bodies", "600", "--steps", "2", "--graph-refresh", "2",
                       "--neighbors", "8", "--load-params", sys.argv[1], "--device", "cpu"])
assert [r["mode"] for r in rows] == ["direct", "surrogate(refresh=2)"]
res = train_large.main(["--n-bodies", "600", "--train-scenes", "1", "--steps", "4",
                        "--stride", "2", "--epochs", "1", "--batch-size", "1",
                        "--neighbors", "4", "--gnn-dim", "8", "--remat", "--data-dir",
                        os.path.join(d, "data"), "--out", os.path.join(d, "t.json"),
                        "--device", "cpu"])
assert res["eval"]["rollout_horizon"] == 2
assert len(knn_recall.main(["--n-bodies", "600", "--windows", "64", "--kernel-blocks", "128",
                            "--profiles", "spiral", "--device", "cpu"])) == 4
g = torch.Generator().manual_seed(0)
u, v = torch.randn(64, 8, generator=g), torch.randn(64, 8, generator=g)
idx = torch.randint(0, 64, (64, 3), generator=g).to(torch.int32)
valid = torch.rand(64, 3, generator=g) < 0.8
plan = ek.plan_windowed_gather(idx, valid, tile=16, half=8, budget=192)
out = ek.edge_message_sum(u, v, idx, plan, tile=16, half=8)
want = torch.where(valid[:, :, None], torch.tanh(u[:, None] + v[idx.long()]), 0.0).sum(1)
assert int(plan.overflow) == 0 and torch.allclose(out, want, rtol=2e-6, atol=2e-6)
assert not [k for k in sys.modules if k.split(".")[0] in ("jax", "flax", "nbody_tpu")
            and sys.modules[k] is not None]
print("JAX-FREE-OK")
"""


def test_large_entry_points_run_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _JAX_FREE, str(PARAMS_1M)], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX-FREE-OK" in out.stdout
