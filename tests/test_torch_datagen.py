"""Port datagen and dataset files against the JAX package: a dataset written
by either package loads in the other's ``SnapshotDataset`` with equal arrays,
the CSV has the same columns, and the CLI runs on the CPU."""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from nbody_tpu.data.dataset import SnapshotDataset as JDataset
from nbody_tpu.data.generate import ScenarioConfig as JScenario
from nbody_tpu.data.generate import generate_dataset as jgenerate_dataset
from nbody_tpu.data.schema import CSV_FIELDS as J_CSV_FIELDS
from nbody_tpu_torch.cli import datagen
from nbody_tpu_torch.data.dataset import BatchIterator, SnapshotDataset
from nbody_tpu_torch.data.generate import (ScenarioConfig, generate_dataset,
                                           run_scenario, save_npz_atomic,
                                           scenario_product, valid_npz)
from nbody_tpu_torch.data.schema import CSV_FIELDS


def _assert_same_dataset(a, b):
    assert sorted(a.buckets) == sorted(b.buckets)
    for n in a.buckets:
        ba, bb = a.buckets[n], b.buckets[n]
        for field in ("x", "y", "scene", "step"):
            np.testing.assert_array_equal(getattr(ba, field), getattr(bb, field))
    assert a.scene_ids() == b.scene_ids()


def test_first_snapshot_matches_jax(tmp_path):
    """The same scenes through both packages' ``generate_dataset`` (two
    seeds of a spiral as one group, a disk): the first snapshot's rows,
    the ICs drawn from the same ``jax.random`` keys, within the bounds of
    ``tests/test_torch_ics.py``; its accelerations within 1e-5 of max |a|."""
    kw = [dict(sim_type="spiral", seed=42), dict(sim_type="spiral", seed=43),
          dict(sim_type="disk", seed=7)]
    common = dict(n_bodies=48, steps=2, force_backend="dense")
    port, jax_out = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    generate_dataset([ScenarioConfig(**common, **k) for k in kw], port, verbose=False,
                     write_csv_file=False, device="cpu")
    jgenerate_dataset([JScenario(**common, **k) for k in kw], jax_out, verbose=False,
                      write_csv_file=False)
    with np.load(port[:-4] + ".npz") as a, np.load(jax_out[:-4] + ".npz") as b:
        for i in range(len(kw)):
            for field, frac in (("pos", 1e-6), ("vel", 1e-4), ("acc", 1e-5), ("mass", 0.0)):
                got, want = a[f"scene{i}_{field}"], b[f"scene{i}_{field}"]
                if field != "mass":
                    got, want = got[0], want[0]
                np.testing.assert_allclose(got, want, rtol=1e-5,
                                           atol=frac * np.abs(want).max())


def test_csv_fields_match_jax():
    assert CSV_FIELDS == J_CSV_FIELDS


@pytest.mark.parametrize("fmt", ["csv", "npz"])
def test_port_dataset_loads_in_jax(tmp_path, fmt):
    scenarios = scenario_product(n_bodies=[6, 11], steps=5, sim_type=["disk", "spiral"],
                                 seed=3, force_backend="kernel")
    out = str(tmp_path / "port.csv")
    generate_dataset(scenarios, out, verbose=False, device="cpu")
    path = out if fmt == "csv" else out[:-4] + ".npz"
    loader = "from_csv" if fmt == "csv" else "from_npz"
    mine = getattr(SnapshotDataset, loader)(path)
    theirs = getattr(JDataset, loader)(path)
    _assert_same_dataset(mine, theirs)
    assert mine.n_snapshots == 4 * 5
    df = pd.read_csv(out)
    assert list(df.columns) == J_CSV_FIELDS
    assert np.isfinite(df[["x", "y", "z", "vx", "ax", "u", "k"]].to_numpy()).all()


@pytest.mark.parametrize("fmt", ["csv", "npz"])
def test_jax_dataset_loads_in_port(tmp_path, fmt):
    scenarios = [JScenario(n_bodies=n, sim_type="spiral", steps=4, seed=2,
                           force_backend="dense") for n in (5, 9)]
    out = str(tmp_path / "jax.csv")
    jgenerate_dataset(scenarios, out, verbose=False, vmap_scenes=False)
    path = out if fmt == "csv" else out[:-4] + ".npz"
    loader = "from_csv" if fmt == "csv" else "from_npz"
    mine = getattr(SnapshotDataset, loader)(path)
    _assert_same_dataset(mine, getattr(JDataset, loader)(path))
    traj = mine.scene_trajectory(1)
    assert traj.pos.shape == (4, 9, 3) and traj.mass.shape == (9,)
    batches = list(BatchIterator(mine, 3, shuffle=False))
    assert all(b.x.shape[0] == 3 for b in batches)


def test_npz_payload_keys_match_jax(tmp_path):
    kw = dict(n_bodies=7, sim_type="disk", steps=3, seed=1)
    generate_dataset([ScenarioConfig(**kw)], str(tmp_path / "p.csv"), verbose=False,
                     device="cpu")
    jgenerate_dataset([JScenario(**kw, force_backend="dense")], str(tmp_path / "j.csv"),
                      verbose=False)
    p, j = np.load(tmp_path / "p.npz"), np.load(tmp_path / "j.npz")
    assert sorted(p.files) == sorted(j.files)
    for key in p.files:
        assert p[key].dtype == j[key].dtype and p[key].shape == j[key].shape, key


def test_cli_runs_on_cpu(tmp_path, capsys):
    out = str(tmp_path / "x.csv")
    datagen.main(["--n-bodies", "25", "--integrator", "leapfrog", "--sim-type",
                  "spiral", "--steps", "20", "--output", out, "--device", "cpu",
                  "--seed", "0"])
    df = pd.read_csv(out)
    assert list(df.columns) == J_CSV_FIELDS
    assert len(df) == 25 * 20
    assert "done" in capsys.readouterr().out
    datagen.main(["--n-bodies", "5", "--steps", "3", "--output", out, "--device",
                  "cpu", "--profile", str(tmp_path / "trace")])
    assert os.path.exists(tmp_path / "trace" / "trace.json")


def test_snapshot_stride_and_npz_only(tmp_path):
    scenarios = scenario_product(n_bodies=8, steps=10, sim_type="disk", seed=7)
    out = str(tmp_path / "s.csv")
    generate_dataset(scenarios, out, verbose=False, snapshot_stride=4, device="cpu")
    df = pd.read_csv(out)
    assert sorted(df["step"].unique()) == [0, 4, 8]
    ds = SnapshotDataset.from_npz(out[:-4] + ".npz")
    assert sorted(ds.buckets[8].step.tolist()) == [0, 4, 8]
    out2 = str(tmp_path / "only.csv")
    generate_dataset(scenarios, out2, verbose=False, snapshot_stride=2,
                     write_csv_file=False, device="cpu")
    assert not os.path.exists(out2)
    assert SnapshotDataset.from_file(out2).n_snapshots == 5


def test_calc_energy_off_and_time_chunks(tmp_path):
    cfg = ScenarioConfig(n_bodies=6, steps=9, seed=1, calc_energy=False)
    traj, mass, step_time = run_scenario(cfg, time_chunks=3, device="cpu")
    assert traj.u_energy is None and traj.positions.shape == (9, 6, 3)
    assert np.shape(step_time) == (9,) and np.all(np.asarray(step_time) > 0)
    whole, _, _ = run_scenario(cfg, device="cpu")
    torch.testing.assert_close(traj.positions, whole.positions, rtol=0, atol=0)
    out = str(tmp_path / "e.csv")
    generate_dataset([cfg], out, verbose=False, time_chunks=3, device="cpu")
    df = pd.read_csv(out)
    assert df["u"].isna().all() and df["k"].isna().all()
    assert np.load(out[:-4] + ".npz")["scene0_step_time"].shape == (9,)


def test_atomic_npz_and_validity(tmp_path):
    path = str(tmp_path / "a.npz")
    save_npz_atomic(path, x=np.arange(10))
    assert valid_npz(path) and not os.path.exists(path + ".tmp.npz")
    with open(path, "rb") as f:
        head = f.read(40)
    bad = str(tmp_path / "b.npz")
    with open(bad, "wb") as f:
        f.write(head)
    assert not valid_npz(bad) and not valid_npz(str(tmp_path / "missing.npz"))


def test_check_flag_raises_on_nonfinite(tmp_path):
    cfg = ScenarioConfig(n_bodies=4, steps=3, seed=1, dt=float("nan"))
    with pytest.raises(FloatingPointError):
        generate_dataset([cfg], str(tmp_path / "n.csv"), verbose=False, check=True,
                         device="cpu")
