"""The port's figure renderer: tests/test_visualize.py's four cases on test
datasets the port's datagen writes (the (filename, scene) -> (n_bodies,
step_time) map and its ``results/scene_info.json`` sidecar, each call held
against the JAX package's on a copy of the same directory), and every
figure rendered from result files in the port's schemas with a
``crossover`` artifact that carries ``device_kind``."""

import json
import os
import shutil

import pandas as pd
import pytest

from nbody_tpu.experiments.visualize import _scene_n_bodies as j_scene_n_bodies
from nbody_tpu_torch.data.generate import ScenarioConfig, generate_dataset
from nbody_tpu_torch.experiments import visualize
from nbody_tpu_torch.experiments.visualize import _scene_n_bodies as t_scene_n_bodies


def _sidecar(base):
    path = os.path.join(base, "results", "scene_info.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _scene_n_bodies(base):
    """The port's map of ``base``, which must equal the JAX package's map of
    a copy of ``base`` taken just before, the sidecar each writes included."""
    twin = base.rstrip("/") + "_jax"
    shutil.copytree(base, twin)
    try:
        want, want_sidecar = j_scene_n_bodies(twin), _sidecar(twin)
    finally:
        shutil.rmtree(twin)
    got = t_scene_n_bodies(base)
    assert got == want
    assert _sidecar(base) == want_sidecar
    return got


def _write_test_csv(path, sizes):
    generate_dataset([ScenarioConfig(n_bodies=n, sim_type="disk", steps=2, seed=i,
                                     force_backend="dense") for i, n in enumerate(sizes)],
                     str(path), write_npz=False, verbose=False, device="cpu")


@pytest.fixture
def base(tmp_path):
    (tmp_path / "data" / "test").mkdir(parents=True)
    (tmp_path / "results").mkdir()
    _write_test_csv(tmp_path / "data" / "test" / "output_file_1.csv", [3, 5])
    _write_test_csv(tmp_path / "data" / "test" / "output_file_2.csv", [7])
    return str(tmp_path)


def test_keyed_by_file_and_scene(base):
    info = _scene_n_bodies(base)
    assert info[("output_file_1.csv", 0)][0] == 3
    assert info[("output_file_1.csv", 1)][0] == 5
    # scene 0 of file 2 must not overwrite scene 0 of file 1
    assert info[("output_file_2.csv", 0)][0] == 7
    df = pd.read_csv(os.path.join(base, "data", "test", "output_file_1.csv"))
    assert info[("output_file_1.csv", 1)][1] == pytest.approx(
        df[df.scene == 1]["step_time"].mean())


def test_sidecar_written_and_survives_data_deletion(base):
    info = _scene_n_bodies(base)
    sidecar = os.path.join(base, "results", "scene_info.json")
    with open(sidecar) as f:
        assert len(json.load(f)) == 3
    for f in os.listdir(os.path.join(base, "data", "test")):  # a fresh checkout
        os.remove(os.path.join(base, "data", "test", f))
    assert _scene_n_bodies(base) == info


def test_no_data_no_sidecar_is_empty(tmp_path):
    assert _scene_n_bodies(str(tmp_path)) == {}


def test_sidecar_merges_with_partial_data(base):
    """Regenerating only SOME test files must not truncate the mapping for
    the others."""
    info_full = _scene_n_bodies(base)
    os.remove(os.path.join(base, "data", "test", "output_file_2.csv"))
    assert _scene_n_bodies(base) == info_full


def test_renders_every_figure_from_port_results(base, capsys):
    """loss, stepwise bars, rollout grid and the crossover figure, from the
    port's result schemas and a port crossover artifact (``device_kind``)
    beside a JAX one (``device`` only), whose series stay apart."""
    res = os.path.join(base, "results", "gnn")
    os.makedirs(res)
    pd.DataFrame({"loss": [3e6, 2e6, 1e6]}).to_csv(os.path.join(res, "epoch_loss.csv"),
                                                    index=False)
    keys = [("output_file_1.csv", 0), ("output_file_1.csv", 1), ("output_file_2.csv", 0)]
    pd.DataFrame([{"filename": f, "scene": s, "loss": 1e-3 * (s + 1), "step_time": 2e-3}
                  for f, s in keys]).to_csv(os.path.join(res, "test_results_stepwise.csv"),
                                            index=False)
    pd.DataFrame([{"filename": f, "scene": s, "step": t, "pos_rmse": 1e-4 * (t + 1),
                   "vel_rmse": 1e-3 * (t + 1), "acc_rmse": 1e-2 * (t + 1)}
                  for f, s in keys for t in range(4)]).to_csv(
        os.path.join(res, "test_results_rollout.csv"), index=False)
    large = os.path.join(base, "results", "large_scale")
    os.makedirs(large)
    rows = [{"n": n, "mode": m, "ms_per_step": 0.1 * n ** 0.5, "psteps_per_s": 1e6}
            for n in (10_000, 100_000) for m in ("direct", "surrogate(kernel,refresh=8)")]
    with open(os.path.join(large, "crossover.json"), "w") as f:
        json.dump({"device": "gpu", "device_kind": "NVIDIA H100 80GB HBM3", "steps": 10,
                   "rows": rows}, f)
    with open(os.path.join(large, "crossover_r3.json"), "w") as f:
        json.dump({"device": "tpu", "steps": 10, "rows": rows[:1]}, f)
    visualize.main(["--base", base, "--models", "gnn", "contconv"])
    figures = os.path.join(base, "figures")
    assert sorted(os.listdir(figures)) == ["crossover.png", "loss.png", "rollout.png",
                                           "stepwise_loss.png", "stepwise_time.png"]
    assert "figures written to" in capsys.readouterr().out
