"""The port's experiment entry points end to end on the CPU, at a few bodies,
steps and epochs: ``gnn_experiment --quick``, ``contconv_experiment --quick``
and ``run --config configs/contconv_adopted.json``. Each writes the JAX
experiments' three CSVs with their columns and index names
(``nbody_tpu/experiments/gnn_experiment.py:84-133``: ``epoch_loss.csv``
with one ``loss`` column, the stepwise frame indexed by (filename, scene),
the rollout frame by (filename, scene, step)); a second ``run`` resumes
from the latest checkpoint and continues the epoch numbering. The config
maps the JAX implementation names to the port's, so one file drives both
packages."""

import os

import numpy as np
import pandas as pd
import pytest

from nbody_tpu.config import ExperimentConfig as JExperimentConfig
from nbody_tpu_torch.config import ExperimentConfig
from nbody_tpu_torch.experiments import contconv_experiment, gnn_experiment, run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPWISE = ["filename", "scene", "loss", "step_time"]
ROLLOUT = ["filename", "scene", "step", "pos_rmse", "vel_rmse", "acc_rmse"]


def _check_results(results_dir, epochs, scenes, steps):
    loss = pd.read_csv(os.path.join(results_dir, "epoch_loss.csv"))
    assert list(loss.columns) == ["loss"] and len(loss) == epochs
    assert np.isfinite(loss["loss"]).all()
    step = pd.read_csv(os.path.join(results_dir, "test_results_stepwise.csv"))
    assert list(step.columns) == STEPWISE and len(step) == scenes
    roll = pd.read_csv(os.path.join(results_dir, "test_results_rollout.csv"))
    assert list(roll.columns) == ROLLOUT and len(roll) == scenes * steps
    for df in (step, roll):
        assert np.isfinite(df.drop(columns=["filename"]).to_numpy(float)).all()


@pytest.mark.parametrize("experiment,name,extra", [
    (gnn_experiment, "gnn", ["--check", "--batch-mode", "reference"]),
    (contconv_experiment, "contconv", ["--batch-mode", "mixed"]),
])
def test_quick_experiments_write_the_reference_csvs(tmp_path, experiment, name, extra):
    out = experiment.main(["--quick", "--base", str(tmp_path), "--sim-steps", "12",
                           "--epochs", "2", "--seed", "3", "--device", "cpu",
                           "--profile", str(tmp_path / "prof"), *extra])
    assert out["trainer"].epoch == 2 and len(out["epoch_loss"]) == 2
    assert sorted(os.listdir(tmp_path / f"{name}_weights")) == ["ckpt_1.pt", "ckpt_2.pt"]
    _check_results(tmp_path / "results" / name, epochs=2, scenes=2, steps=12)
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0


@pytest.mark.parametrize("ok", [True, False])
def test_nonfinite_guards_match_jax(ok):
    """``--check``'s guards raise on the same inputs as the JAX package's."""
    import jax.numpy as jnp
    import torch

    from nbody_tpu.utils.debug import assert_finite_state as j_assert_finite_state
    from nbody_tpu.utils.debug import throw_if_nonfinite as j_throw_if_nonfinite
    from nbody_tpu_torch.utils.debug import assert_finite_state, throw_if_nonfinite

    bad = np.array([1.0, 2.0, np.nan if not ok else 3.0], np.float32)
    tree = {"a": np.ones(3, np.float32), "b": {"c": bad}}
    module = torch.nn.Linear(3, 1)
    with torch.no_grad():
        module.weight[0] = torch.from_numpy(bad)
    calls = [(j_throw_if_nonfinite, (tree,), Exception),  # checkify's JaxRuntimeError
             (j_assert_finite_state, (jnp.asarray(bad), bad), FloatingPointError),
             (throw_if_nonfinite, ({"a": torch.ones(3), "b": [torch.from_numpy(bad)]},),
              FloatingPointError),
             (throw_if_nonfinite, (module,), FloatingPointError),
             (assert_finite_state, (torch.from_numpy(bad), torch.zeros(3)), FloatingPointError)]
    for fn, args, error in calls:
        if ok:
            fn(*args)
        else:
            with pytest.raises(error):
                fn(*args)


def test_run_adopted_config_trains_resumes_and_evaluates(tmp_path):
    overrides = [f"base={tmp_path}", "datagen.n_bodies=[3,20]", "datagen.steps=12",
                 "datagen.train_files=1", "train.epochs=1", "train.save_every=1",
                 "train.sim_steps=8", "model.kwargs.conv_impl=pallas"]
    argv = ["--config", os.path.join(ROOT, "configs", "contconv_adopted.json"),
            "--device", "cpu"] + [a for o in overrides for a in ("--set", o)]
    first = run.main(argv)
    model = first["trainer"].model
    assert model.conv_impl == "kernel" and all(c.impl == "kernel" for c in model.convs)
    again = run.main(argv)  # resumes from the epoch-1 checkpoint
    assert again["trainer"].epoch == 2
    assert sorted(os.listdir(tmp_path / "contconv_weights")) == ["ckpt_1.pt", "ckpt_2.pt"]
    _check_results(tmp_path / "results" / "contconv", epochs=1, scenes=2, steps=8)
    saved = ExperimentConfig.load(tmp_path / "results" / "contconv" / "config.json")
    assert saved.model.kwargs["conv_impl"] == "pallas"  # the file keeps the JAX name


@pytest.mark.parametrize("kind,kwargs,attr,want", [
    ("contconv", {"conv_impl": "pallas", "radius_impl": "xla", "radius_method": "morton"},
     "conv_impl", "kernel"),
    ("contconv", {"conv_impl": "xla"}, "conv_impl", "dense"),
    ("gnn", {"knn_method": "morton", "knn_impl": "pallas", "neighbors": 4}, "knn_impl",
     "kernel"),
])
def test_config_maps_jax_impl_names(kind, kwargs, attr, want):
    d = {"model": {"type": kind, "kwargs": kwargs}}
    model = ExperimentConfig.from_dict(d).build_model()
    assert getattr(model, attr) == want
    jmodel = JExperimentConfig.from_dict(d).build_model()  # the same file in JAX
    assert jmodel.graph_spec[0] == model.graph_spec[0]


def test_config_overrides_and_scenarios_match_jax():
    over = ["train.epochs=7", "datagen.n_bodies=[5,9]", "datagen.force_backend=pallas",
            "model.kwargs.gnn_dim=32", "name=x"]
    jcfg = JExperimentConfig().apply_overrides(over)
    cfg = ExperimentConfig().apply_overrides(over)
    assert cfg.to_dict() == jcfg.to_dict()
    js, ts = jcfg.scenarios(seed=4), cfg.scenarios(seed=4)
    assert [s.n_bodies for s in ts] == [s.n_bodies for s in js] == [5, 9]
    assert {s.force_backend for s in ts} == {"kernel"} and ts[0].seed == 4
    with pytest.raises(ValueError):
        cfg.apply_overrides(["train.epochs"])


@pytest.mark.parametrize("kind,kwargs,device,key,want", [
    ("contconv", {"radius_method": "morton"}, "cuda", "radius_impl", "kernel"),
    ("contconv", {"radius_method": "morton"}, "cpu", "radius_impl", "dense"),
    ("contconv", {"radius_method": "morton", "radius_impl": "xla"}, "cuda", "radius_impl",
     "dense"),
    ("contconv", {}, "cuda", "radius_impl", None),
    ("gnn", {"knn_method": "morton", "neighbors": 4}, "cuda", "knn_impl", "kernel"),
    ("gnn", {"knn_method": "morton", "neighbors": 4}, None, "knn_impl", None),
    ("gnn", {"neighbors": 4}, "cuda", "knn_impl", None),
])
def test_config_resolves_an_unset_morton_impl_from_the_device(kind, kwargs, device, key, want):
    """A Morton search whose impl the config leaves unset takes the kernels on
    cuda and the plain search elsewhere, decided once in the config layer;
    an impl that is set, another method, or no device leave it alone (and
    ``build_graph`` then defaults to "dense")."""
    import torch

    cfg = ExperimentConfig.from_dict({"model": {"type": kind, "kwargs": kwargs}})
    dev = None if device is None else torch.device(device)  # naming a device needs no card
    assert cfg.model_kwargs(dev).get(key) == want
    model = cfg.build_model(device=dev)
    assert model.graph_spec[1].get("impl") == want
    assert all(p.device.type == "cpu" for p in model.parameters())  # the caller moves it


@pytest.mark.parametrize("device,want", [("cuda", "kernel"), ("cpu", "dense")])
def test_run_passes_the_resolved_device_to_the_model(tmp_path, monkeypatch, capsys, device,
                                                     want):
    """``run`` resolves the Morton impl from the device it runs on and prints
    the resolved graph spec. The device poses as cuda here: the datasets are
    there already, and the run stops where the trainer would start."""
    import torch

    class Stop(Exception):
        pass

    def stop(*args, **kwargs):
        raise Stop

    for split in ("train", "test"):
        (tmp_path / "data" / split).mkdir(parents=True)
        (tmp_path / "data" / split / "kept.npz").write_bytes(b"")
    monkeypatch.setattr(run, "resolve_device", lambda name: torch.device(device))
    monkeypatch.setattr(torch.nn.Module, "to", lambda self, *a, **k: self)
    monkeypatch.setattr(run, "Trainer", stop)
    cfg = ExperimentConfig.load(os.path.join(ROOT, "configs", "contconv_adopted.json"))
    cfg = cfg.apply_overrides([f"base={tmp_path}", "model.kwargs.radius_method=morton"])
    with pytest.raises(Stop):
        run.run(cfg)
    line = [ln for ln in capsys.readouterr().out.splitlines() if "graph spec" in ln]
    assert len(line) == 1 and f"'impl': '{want}'" in line[0] and f"on {device}" in line[0]


def test_contconv_bench_row_on_the_cpu():
    """``contconv_bench`` at a few hundred bodies: on the CPU every step is
    its plain version, so the plan equals it and B3-B5 are exact; B5's two
    passes over the plan give the plain backward's feature gradient."""
    from nbody_tpu_torch.experiments import contconv_bench

    (row,) = contconv_bench.main(["--device", "cpu", "--n-bodies", "600", "--d", "3",
                                  "--neighbors", "8", "--width", "8"])
    assert row["plan_equals_plain"] and row["same_bits_twice"]
    assert 0 < row["live_edges"] <= 600 * 8 and row["live_edges"] <= row["pairs"] <= 600 * 27
    assert row["b3_vs_plain"] == row["b4_vs_plain"] == row["b5_vs_plain"] == 0.0
    assert row["b6_vs_plain"] == 0.0
    assert row["bins_vs_plain"] <= 1e-6 and row["dg_vs_plain"] == row["unbins_vs_plain"] == 0.0
    assert all(row[key] > 0 for key in ("plan_ms", "bins_ms", "b3_ms", "b4_ms", "dg_ms",
                                        "unbins_ms", "b5_ms", "b6_ms", "bound_ms",
                                        "b6_bound_ms"))
    assert row["bound_by"] in ("operations", "bytes")


def test_contconv_bench_digests_compare_a_second_run(tmp_path):
    """``--digests``: the first run writes B3's, B4's and B5's output
    digests, a second run of the same code finds its bits equal to them."""
    from nbody_tpu_torch.experiments import contconv_bench

    argv = ["--device", "cpu", "--n-bodies", "300", "--d", "3", "--neighbors", "6",
            "--width", "4", "--digests", str(tmp_path / "digests.json")]
    (first,) = contconv_bench.main(argv)
    assert "bits_equal_saved" not in first and (tmp_path / "digests.json").exists()
    (second,) = contconv_bench.main(argv)
    assert second["bits_equal_saved"] == {"b3": True, "b4": True, "b5": True}


def test_determinism_check_repeats_the_loss_on_one_path_only(tmp_path):
    """One epoch from the same seed repeats its loss, within a call and
    between calls that train on the same file paths; the same files under
    another directory are batched in another order (the batch order is
    seeded from the paths, the JAX trainer's formula)."""
    import shutil
    import zlib

    from nbody_tpu_torch.experiments import determinism_check

    argv = ["--config", os.path.join(ROOT, "configs", "contconv_adopted.json"), "--device",
            "cpu", "--set", "datagen.train_files=1", "--set", "datagen.steps=12", "--set",
            "datagen.n_bodies=[3,25]", "--set", "model.kwargs.continuous_conv_dim=8",
            "--set", "train.batch_size=4"]
    first = determinism_check.main(argv + ["--runs", "2", "--data-dir", str(tmp_path / "a")])
    again = determinism_check.main(argv + ["--runs", "1", "--data-dir", str(tmp_path / "a")])
    assert [r["deterministic_algorithms"] for r in first] == [False, True]
    assert all(r["all_equal"] and not r["ops_without_a_deterministic_implementation"]
               for r in first)
    assert {v for r in first + again for v in r["epoch_loss"]} == {first[0]["epoch_loss"][0]}

    def order_seed(name):  # of epoch 0, as the trainer's ``_group_rng`` takes it
        return zlib.crc32(str(tmp_path / name / "output_file_1.npz").encode()) % 1000

    other = next(n for n in ("b", "c", "d", "e") if order_seed(n) != order_seed("a"))
    shutil.copytree(tmp_path / "a", tmp_path / other)
    moved = determinism_check.main(argv + ["--runs", "1", "--data-dir", str(tmp_path / other)])
    assert moved[0]["epoch_loss"][0] != first[0]["epoch_loss"][0]


def test_force_bench_rows_on_the_cpu():
    """``force_bench`` on the CPU: the plain version at a square and a
    few-targets shape, at the recipe's softening and at one under the
    distance floor, within the force bar of its float64 run, one chunk
    (the split rule leaves shapes this small whole), the same bits twice;
    then the datagen rows, with no kernel launch on the CPU."""
    from nbody_tpu_torch.experiments import force_bench

    rows = force_bench.main(["--device", "cpu", "--shapes", "300", "40x3000", "--softening",
                             "0.05", "1e-10", "--reps", "1", "--check-rows", "32",
                             "--datagen", "3", "25", "--steps", "4"])
    shapes, steps = rows[:4], rows[4:]
    assert [(r["targets"], r["sources"], r["softening"]) for r in shapes] == [
        (300, 300, 0.05), (300, 300, 1e-10), (40, 3000, 0.05), (40, 3000, 1e-10)]
    for r in shapes:
        assert r["rel_err_vs_float64"] <= 2e-5 and r["same_bits_twice"] and r["chunks"] == 1
        assert r["ms"] > 0 and r["bound_ms"] > 0 and r["bound_by"] == "operations"
        assert r["check_rows"] == min(32, r["targets"])
    assert [(r["datagen_n"], r["steps"]) for r in steps] == [(3, 4), (25, 4)]
    assert all(r["ms_per_step"] > 0 and r["b1_launches_per_step"] == 0 for r in steps)


def test_force_bench_energy_rows_on_the_cpu():
    """``force_bench``'s B2 rows on the CPU (the plain version, no launch, no
    device time), masked and cross, and the chunked exact energy equal to
    the masked one within the energy bar."""
    from nbody_tpu_torch.experiments import force_bench

    rows = force_bench.main(["--device", "cpu", "--shapes", "--energy", "300", "100x200",
                             "--chunked", "300:110"])
    masked, cross, chunked = rows
    assert (masked["energy_targets"], masked["masked"]) == (300, True)
    assert (cross["energy_targets"], cross["energy_sources"], cross["masked"]) == (100, 200,
                                                                                   False)
    for r in (masked, cross):
        assert r["rel_err_vs_plain"] == 0.0 and r["one_value_in_5_calls"]
        assert r["b2_launches_per_call"] == 0 and r["bound_ms"] > 0 and "ms" not in r
    assert chunked["b2_launches"] == 0 and chunked["seconds"] > 0
    assert abs(chunked["u"] - masked["u"]) <= 1e-5 * abs(masked["u"])


def test_edgeconv_bench_rows_on_the_cpu():
    """``edgeconv_bench`` on the CPU: the synthetic row (phase 10a's input
    at a small N) and the path row (the 1M model's first EdgeConv, with its
    committed weights, on a Morton graph), each function run once and no
    time; every valid edge of the path is in the window, in the fallback
    list or counted as overflow."""
    from nbody_tpu_torch.experiments import edgeconv_bench

    synth, path = edgeconv_bench.main(["--device", "cpu", "--n-bodies", "700"])
    assert synth["case"] == "synthetic" and synth["rows"] == 768 and synth["device"] == "cpu"
    assert 0 < synth["edges_in_window"] < 768 * 8
    assert path["case"] == "path" and (path["n"], path["k"], path["d"]) == (700, 8, 64)
    assert path["in_window"] + path["fallback"] + path["overflow"] == path["valid_edges"] > 0
    assert all(v is None for key, v in {**synth, **path}.items() if key.endswith(("_ms",
                                                                                 "_kernels")))


def test_select_bench_rows_on_the_cpu():
    """``select_bench`` on the CPU: one row a case with the shape's bounds
    and no times; a case is ``K`` or ``K:self`` and nothing else."""
    from nbody_tpu_torch.experiments import select_bench

    rows = select_bench.main(["--device", "cpu", "--n-bodies", "700", "--cases", "8",
                              "32:self"])
    assert [(r["k"], r["include_self"]) for r in rows] == [(8, False), (32, True)]
    for r in rows:
        assert "b7_ms" not in r and "b7_host_us" not in r
        assert r["b7_bound_by"] == "operations" and r["b8_bound_ms"] > 0
    # the 32-deep select reads the same candidates as the 8-deep one
    assert rows[0]["b7_bound_ms"] == rows[1]["b7_bound_ms"]
    with pytest.raises(ValueError):
        select_bench.parse_case("8:all")
