"""``scripts/h100_treecode_runs.py`` and ``scripts/answer_ratios.py`` on the CPU:
the command lines that answer the JAX package's sweep artifacts, an answer
made end to end from hand-made artifacts at a few hundred bodies, and the
ratio table's row matching and bars on two hand-made JSON pairs."""

import importlib.util
import json
import math
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


runs, ratios = _script("h100_treecode_runs"), _script("answer_ratios")


def test_every_row_of_every_artifact_has_a_command_line():
    for name in runs.NAMES:
        art = runs.jax_artifact(name)
        jobs = runs.jobs_of(name)
        answered = [r for _, _, rows in jobs if rows is not None for r in rows]
        assert answered == art.get("rows", []), name
        assert jobs and all(argv and "--device" not in argv for _, argv, _ in jobs)


@pytest.mark.parametrize("name,row,want", [
    ("bh", 3, "--engine bh --n-bodies 100000 --n-near 32 --block 256 --reps 20 --seed 0 "
              "--i-chunk 32 --error-cap 100000"),
    ("bh", 19, "--engine bh --n-bodies 1000000 --n-near 16 --block 512 --reps 10 --seed 0 "
               "--error-cap 1000000"),
    ("bh", 14, "--engine bh --n-bodies 200000 --n-near 48 --block 256 --reps 20 --seed 0"),
    ("bh2", 11, "--engine bh --n-bodies 1000000 --n-near 32 --block 256 --reps 10 --seed 0"),
    ("bh2", 0, "--engine bh2 --n-bodies 200000 --n-near 32 --block 256 --reps 10 --seed 0 "
               "--coarse 16 --rc 12 --error-cap 200000"),
    ("bh3_1m_m48_ns32", 0, "--engine bh3 --n-bodies 1000000 --n-near 48 --block 128 --reps 5 "
                           "--seed 0 --coarse 16 --rc 48 --sub-block 32 --n-sub 32 "
                           "--error-sample 4096"),
])
def test_treecode_rows_take_their_own_knobs(name, row, want):
    art = runs.jax_artifact(name)
    assert " ".join(runs.treecode_argv(name, art, art["rows"][row])) == want


@pytest.mark.parametrize("name,want", [
    ("bh_rollout", "--n-bodies 100000 --steps 1000 --engine bh --bh-near 32 --block 256 "
                   "--bh-refresh 8 --profile"),
    ("bh_rollout_10m", "--n-bodies 10000000 --steps 200 --engine bh2 --bh-near 16 --block 512 "
                       "--bh-refresh 8 --profile --coarse 16 --rc 48 --chunk-steps 10 "
                       "--no-energy-audit --error-sample 4096"),
    ("bh_rollout_10m_refresh4", "--n-bodies 10000000 --steps 50 --engine bh2 --bh-near 16 "
                                "--block 512 --bh-refresh 4 --profile --coarse 16 --rc 48 "
                                "--chunk-steps 10 --chunked-energy-audit 200000"),
])
def test_rollouts_take_their_knobs_and_audit(name, want):
    assert " ".join(runs.rollout_argv(runs.jax_artifact(name))) == want


@pytest.mark.parametrize("name,n,want", [
    ("crossover", 10_000, "--only direct surrogate --graph-refresh 1 8 --knn-impl dense"),
    ("crossover_pallas", 200_000, "--only bh direct --bh-near 32"),
    ("crossover_pallas_fast", 20_000, "--only direct surrogate --graph-refresh 8 --knn-impl "
                                      "kernel --knn-copies 2 --knn-block 512"),
    ("crossover_r4", 1_000_000, "--only bh bh2 bh3 surrogate --graph-refresh 1 8 --knn-impl "
                                "dense --bh-near 32 --rc 48 --n-sub 24 --neighbors 8"),
    ("crossover_r5", 1_000_000, "--only surrogate --graph-refresh 8 --knn-impl kernel "
                                "--load-params results/large_scale/train_1m_params.pt "
                                "--neighbors 8"),
])
def test_crossover_rows_take_their_modes(name, n, want):
    (argv,) = [a for a, rows in runs.crossover_jobs(name, runs.jax_artifact(name))
               if rows[0]["n"] == n]
    assert " ".join(argv).split(" --only ")[1] == want.split("--only ")[1]


def _hand_made(tmp_path):
    """Small artifacts of each shape that the runner answers."""
    jax = tmp_path / "jax"
    jax.mkdir()
    arts = {
        "bh": {"reps": 1, "rows": [
            {"n": 700, "n_near": 2, "block": 32, "near_impl": "pallas", "rel_err_median": 1e-3,
             "rel_err_p99": 1e-2},
            {"n": 700, "n_near": 2, "block": 32, "i_chunk": 4, "bh_fresh_ms": 1.0}]},
        "bh2": {"reps": 1, "rows": [
            {"n": 800, "n_near": 2, "block": 16, "coarse": 4, "rc": 3, "rel_err_median": 1e-2,
             "rel_err_p99": 0.1, "err_over_rms_p99": 0.1}]},
        "knn_recall": {"rows": [
            {"profile": p, "n": 600, "k": 4, "method": m, "seconds": 0.1, "recall": 0.999}
            for p in ("disk", "spiral") for m in ("exact", "approx", "morton(W=64)",
                                                   "morton-pallas(B=128)")]},
        "crossover_r3": {"steps": 2, "rows": [
            {"n": 600, "mode": "direct", "ms_per_step": 1.0},
            {"n": 600, "mode": "surrogate(pallas,refresh=2)", "ms_per_step": 2.0}]},
        "bh_rollout": {"n": 600, "steps": 3, "bh_near": 2, "bh_refresh": 2,
                       "rel_energy_drift": 1e-7},
    }
    for name, art in arts.items():
        (jax / f"{name}.json").write_text(json.dumps(art))
    return jax, arts


def test_answers_from_hand_made_artifacts_on_the_cpu(tmp_path, monkeypatch):
    jax, arts = _hand_made(tmp_path)
    monkeypatch.setattr(runs, "JAX_DIR", str(jax))
    port = tmp_path / "port"
    port.mkdir()
    for name in arts:
        ans = runs.answer(name, device="cpu", card="cpu")
        assert ans["device_kind"] == "cpu" and ans["card"] == "cpu"
        (port / f"{name}.json").write_text(json.dumps(ans))
    bh = json.loads((port / "bh.json").read_text())["rows"]
    assert [r["engine"] for r in bh] == ["bh", "bh"] and bh[1]["i_chunk"] == 4
    assert "jax_near_path" in bh[1] and "jax_near_path" not in bh[0]
    # under the entry point's exact cap (100,000) a row has its errors, as JAX's had
    assert all("rel_err_median" in r and "exact_ms" in r for r in bh)
    assert all(r["argv"].startswith("python -m nbody_tpu_torch.experiments.treeforce_bench")
               for r in bh)
    knn = json.loads((port / "knn_recall.json").read_text())["rows"]
    assert [r["method"] for r in knn] == [
        "exact", "approx", "morton(W=64)", "morton-kernel(B=128)"] * 2
    assert all(r["recall"] == 1.0 and r["argv"] for r in knn if r["method"] == "approx")
    cross = json.loads((port / "crossover_r3.json").read_text())
    assert cross["steps"] == 2 and all(r["finite"] for r in cross["rows"])
    rows = ratios.main(["--port", str(port), "--jax", str(jax)])
    verdicts = {(r[0], r[2], r[7]) for r in rows}
    assert ("knn_recall", "recall", "met") in verdicts
    assert all(r[7] == "met" for r in rows if r[0] == "knn_recall" and r[2] == "recall"
               and r[1].endswith(" approx"))
    assert {r[7] for r in rows if r[0] == "crossover_r3"} == {"info"}
    drift = [r for r in rows if r[0] == "bh_rollout" and r[2] == "rel_energy_drift"]
    assert len(drift) == 1 and drift[0][6:] == ("< 1.1e-06", "met")
    assert all(r[7] != "MISSING" for r in rows)


def _write(tmp_path, name, jax_art, port_art):
    for side, art in (("jax", jax_art), ("port", port_art)):
        (tmp_path / side).mkdir(exist_ok=True)
        (tmp_path / side / f"{name}.json").write_text(json.dumps(art))


def test_ratio_table_matches_rows_and_holds_bars(tmp_path, capsys):
    # pair 1: a treecode sweep with a repeated key, a lineage row and a miss
    jax_rows = [{"n": 100, "n_near": 32, "block": 256, "rel_err_median": 0.01,
                 "rel_err_p99": 0.1, "bh_fresh_ms": 5.0},
                {"n": 100, "n_near": 32, "block": 256, "i_chunk": 8, "rel_err_median": 0.02,
                 "rel_err_p99": 0.2},
                {"n": 100, "n_near": 32, "block": 256, "coarse": 16, "rc": 12,
                 "rel_err_median": 0.04, "err_over_rms_p99": 1.0},
                {"n": 100, "n_near": 32, "block": 256, "coarse": 16, "engine": "bh1-baseline",
                 "bh_fresh_ms": 3.0}]
    port_rows = [{"n": 100, "n_near": 32, "block": 256, "engine": "bh",
                  "rel_err_median": 0.0124, "rel_err_p99": 0.19, "bh_fresh_ms": 1.0},
                 {"n": 100, "n_near": 32, "block": 256, "engine": "bh",
                  "rel_err_median": 0.0159, "rel_err_p99": 0.41},
                 {"n": 100, "n_near": 32, "block": 256, "coarse": 16, "rc": 12,
                  "engine": "bh2", "rel_err_median": 0.05, "err_over_rms_p99": 0.49},
                 {"n": 100, "n_near": 32, "block": 256, "engine": "bh", "bh_fresh_ms": 2.0}]
    _write(tmp_path, "sweep", {"rows": jax_rows}, {"rows": port_rows})
    # pair 2: recall rows, an approx row at JAX's recall or above, one answer missing
    jax_knn = [{"profile": "spiral", "n": 10, "k": 2, "method": m, "seconds": 1.0,
                "recall": r} for m, r in (("exact", 1.0), ("approx", 0.98),
                                          ("morton(W=64)", 0.99), ("morton-pallas(B=256)", 0.99),
                                          ("morton(W=96)", 0.995))]
    port_knn = [{"profile": "spiral", "n": 10, "k": 2, "method": "exact", "seconds": 0.5,
                 "recall": 1.0},
                {"profile": "spiral", "n": 10, "k": 2, "method": "approx", "seconds": 0.5,
                 "recall": 1.0},
                {"profile": "spiral", "n": 10, "k": 2, "method": "morton(W=64)",
                 "seconds": 0.5, "recall": 0.9904},
                {"profile": "spiral", "n": 10, "k": 2, "method": "morton-kernel(B=256)",
                 "seconds": 0.5, "recall": 0.9894}]
    _write(tmp_path, "knn_recall", {"rows": jax_knn}, {"rows": port_knn})
    rows = ratios.main(["--port", str(tmp_path / "port"), "--jax", str(tmp_path / "jax")])
    table = capsys.readouterr().out
    got = {(r[0], r[1].split(":")[0], r[2]): r for r in rows}
    assert got[("sweep", "0", "rel_err_median")][7] == "met"        # 1.24x
    assert got[("sweep", "0", "rel_err_p99")][7] == "met"           # 1.9x
    assert got[("sweep", "0", "bh_fresh_ms")][7] == "info"
    assert got[("sweep", "1", "rel_err_median")][7] == "MISSED"     # 0.795x
    assert math.isclose(got[("sweep", "1", "rel_err_median")][5], 0.795)
    assert got[("sweep", "1", "rel_err_p99")][7] == "MISSED"        # 2.05x
    assert got[("sweep", "2", "rel_err_median")][7] == "met"        # 1.25x
    assert got[("sweep", "2", "err_over_rms_p99")][7] == "MISSED"   # 0.49x
    assert got[("sweep", "3", "bh_fresh_ms")][5] == pytest.approx(2 / 3)
    assert got[("knn_recall", "0", "recall")][7] == "met"
    assert got[("knn_recall", "1", "recall")][7] == "met"            # 1.0 >= 0.98
    assert got[("knn_recall", "2", "recall")][7] == "met"           # +4e-4
    assert got[("knn_recall", "3", "recall")][7] == "MISSED"        # -6e-4
    assert got[("knn_recall", "4", "row")][7] == "MISSING"
    assert "5 reading(s) outside their bar" in table


def test_ratio_table_holds_training_bars(tmp_path, capsys):
    """A hand-made training pair: epoch 1 read from the epoch-loss CSVs (not
    ``first_scaled_rmse``, a resumed session's first epoch), inside its bar;
    the final loss outside; and a 1M pair whose stepwise error and baseline
    have no bar (the bh seam)."""
    def art(n, first, final, stepwise, zero):
        return {"n_bodies": n, "training": {"first_scaled_rmse": first,
                                            "final_scaled_rmse": final},
                "eval": {"stepwise_scaled_rmse": stepwise,
                         "predict_zero_baseline_scaled_rmse": zero}}

    _write(tmp_path, "train_2k", art(2000, 0.5, 0.02, 0.03, 0.09),
           art(2000, 0.9, 0.026, 0.036, 0.0905))
    _write(tmp_path, "train_1m", art(1_000_000, 0.04, 0.04, 0.04, 0.09),
           art(1_000_000, 0.09, 0.04, 0.06, 0.1))
    for side, e1 in (("jax", 0.05), ("port", 0.06)):
        (tmp_path / side / "train_2k_epoch_loss.csv").write_text(
            f"epoch,loss,mse_loss,wall_s\n1,{e1},1e-15,1.0\n2,0.02,1e-15,1.0\n")
    rows = ratios.main(["--port", str(tmp_path / "port"), "--jax", str(tmp_path / "jax")])
    got = {(r[0], r[2]): r for r in rows}
    assert got[("train_2k", "first_scaled_rmse")][5] == pytest.approx(1.2)
    assert got[("train_2k", "first_scaled_rmse")][7] == "met"
    assert got[("train_2k", "final_scaled_rmse")][7] == "MISSED"            # 1.3x
    assert got[("train_2k", "stepwise_scaled_rmse")][7] == "met"            # 1.2x
    assert got[("train_2k", "predict_zero_baseline_scaled_rmse")][7] == "met"
    assert got[("train_1m", "first_scaled_rmse")][7] == "MISSED"            # 2.25x
    assert got[("train_1m", "final_scaled_rmse")][7] == "met"
    for key in ("stepwise_scaled_rmse", "predict_zero_baseline_scaled_rmse"):
        assert got[("train_1m", key)][6].endswith("seam") and got[("train_1m", key)][7] == "-"
    assert "2 reading(s) outside their bar" in capsys.readouterr().out


# the artifacts answered with their command lines and the card's line (the
# 2M-10M answers before them hold neither)
SWEEPS = runs.selected(["bh", "bh2", "bh3", "bh3_1m_*", "bh_rollout", "knn_recall",
                        "crossover*", "contconv_large*"])


@pytest.mark.parametrize("name", SWEEPS)
def test_committed_answer_holds_its_bars(name):
    """``results/large_scale_h100/NAME.json``: one row for each JAX row with the
    command line that gives it, the card's name and ``nvidia-smi`` line, every
    barred reading within its bar (``approx`` rows answered, their recall
    at least JAX's), and every speed row's final state finite."""
    ans = json.loads((REPO / "results" / "large_scale_h100" / f"{name}.json").read_text())
    art = runs.jax_artifact(name)
    assert ans["device"] == "gpu" and ans["device_kind"].startswith("NVIDIA")
    assert ans["card"].startswith(ans["device_kind"] + ", ") and ans["card"].endswith(" W")
    assert len(ans.get("rows", [])) == len(art.get("rows", []))
    want = [runs.command(module, argv) for module, argv, rows in runs.jobs_of(name)
            for r in (rows or [{}])]
    assert [r.get("argv") for r in ans.get("rows", [ans])] == want
    rows = ratios.compare(name, ans, art)
    assert rows and all(r[7] in ("met", "info", "-") for r in rows), rows
    assert all(r[6] == ">= JAX" for r in rows if r[1].endswith(" approx") and r[2] == "recall")
    assert all(r["finite"] for r in ans.get("rows", []) if "mode" in r)
    if "results" in ans:
        assert ans["results"]["surrogate"]["finite"]
