"""The port's answers against the JAX package's artifacts of the same name:
each reading of ``results/large_scale_h100/NAME.json`` beside
``results/large_scale/NAME.json``, their ratio (port / JAX) and, where the
reading has a bar, its verdict, as a markdown table::

    python scripts/answer_ratios.py [--port DIR] [--jax DIR] [NAME ...]

Artifacts with rows are matched row by row on a key (the k-th JAX row of a
key with the k-th answer of that key):

- treecode sweeps: ``(n, n_near, block, coarse, rc, sub_block, n_sub,
  engine)``; the median relative force error must lie within 0.8-1.25x
  JAX's, its p99 and ``err_over_rms_p99`` within 0.5-2.0x; the times are
  printed for information;
- ``knn_recall``: ``(profile, n, k, method)`` (the port's
  ``morton-kernel`` is JAX's ``morton-pallas``); an ``exact`` row's recall
  must be 1.0, an ``approx`` row's at least JAX's, a Morton row's within
  5e-4 of JAX's; seconds are printed for information;
- ``crossover*`` and ``contconv_large``: ``(n, mode)``, the kNN impl tag
  left out; ms a step for information, the run's final state finite.

Artifacts without rows: for ``train_*`` the first and final epoch losses,
the stepwise error and the predict-zero baseline, each held to
``TRAIN_BARS``, then the median and relative RMS force error and the
rollout's position RMSE at its horizon for information. The first epoch's
loss is row 1 of the ``_epoch_loss.csv`` beside the JSON where there is one
(``first_scaled_rmse`` is the first epoch of a run's last session, so epoch
23 in JAX's resumed ``train_1m``). At 1M bodies the stepwise error and the
baseline carry the bh treecode's float32 near/far seam (``ROADMAP.md`` C,
known differences) and have no bar. For rollouts ``E0``, the energy drift
(``bh_rollout`` held below ``DRIFT_BAR``) or the sampled audit; for
``contconv_large_r3`` the surrogate's seconds. These have no bar unless
named here.

Then the two reference experiments of ``run_experiments.sh`` (``REFERENCE``),
in a table of their own: ``results/NAME_h100/`` against ``results/NAME/``.
Epoch 1's loss is held to ``TRAIN_BARS``' band; the last epoch's loss and
each scene's stepwise loss too where the port's run reached JAX's epochs,
and otherwise printed as "epoch N of M" without a bar (the eval is then
read against JAX's last epoch). Where ``JAX_RERUN`` keeps a JAX run of
the script's own recipe beside the answer, the first epochs are also held
to the band against it and the rest of it printed. The rollout is printed
for information:
each scene's median over steps of ``acc_rmse`` (the RMSE of the mean signed
error over bodies, which two initialisations of one recipe move several
times over) and its last step's ``pos_rmse``. ``NAME`` ``reference``
prints this table alone; it follows the other when no name is given.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import re
from statistics import median

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATIO_BARS = {"rel_err_median": (0.8, 1.25), "rel_err_p99": (0.5, 2.0),
              "err_over_rms_p99": (0.5, 2.0)}
RECALL_TOL = 5e-4
DRIFT_BAR = {"bh_rollout": 1.1e-6}  # twice the artifact's 5.44e-7
TREE_KEY = ("n", "n_near", "block", "coarse", "rc", "sub_block", "n_sub", "engine")
TREE_INFO = ("exact_ms", "bh_fresh_ms", "bh_reused_ms", "partition_ms")
TRAIN_BARS = {"first_scaled_rmse": (0.8, 1.25), "final_scaled_rmse": (0.8, 1.25),
              "stepwise_scaled_rmse": (0.8, 1.25),
              "predict_zero_baseline_scaled_rmse": (0.99, 1.01)}
# training answers at SEAM_N: these readings carry the seam and have no bar
SEAM_N, SEAM_KEYS = 1_000_000, ("stepwise_scaled_rmse", "predict_zero_baseline_scaled_rmse")
SEAM = "none: the bh near/far seam"
REFERENCE = ("gnn", "contconv")
REFERENCE_BAR = TRAIN_BARS["first_scaled_rmse"]
# a JAX run of run_experiments.sh's own recipe, kept beside the port's answer
# where results/NAME/ holds an older recipe's run: its file in results/NAME_h100/
# and the epochs held to the band (later ones printed for information).
# jax_68a9263_epoch_loss.csv is results/contconv/epoch_loss.csv as commit 68a9263
# held it: JAX's mixed-batch rerun, 10 epochs
JAX_RERUN = {"contconv": ("jax_68a9263_epoch_loss.csv", 3)}


def tree_engine(row: dict) -> str:
    if row.get("engine") in ("bh", "bh2", "bh3"):
        return row["engine"]
    if "sub_block" in row:
        return "bh3"
    if "coarse" in row and row.get("engine") != "bh1-baseline":
        return "bh2"
    return "bh"


def row_key(row: dict) -> tuple:
    if "method" in row:
        return (row["profile"], row["n"], row["k"],
                row["method"].replace("morton-kernel", "morton-pallas"))
    if "mode" in row:
        return (row["n"], re.sub(r"(pallas|xla|kernel|dense),", "", row["mode"]))
    engine = tree_engine(row)
    used = {"bh": 3, "bh2": 5, "bh3": 7}[engine]  # bh has no coarse level, bh2 no sub-blocks
    return tuple(row.get(k) for k in TREE_KEY[:used]) + (None,) * (7 - used) + (engine,)


def pair_rows(jax_rows: list, port_rows: list) -> list:
    """(JAX row, its answer or None) in JAX's order."""
    pool = {}
    for r in port_rows:
        pool.setdefault(row_key(r), []).append(r)
    pairs = []
    for r in jax_rows:
        left = pool.get(row_key(r), [])
        pairs.append((r, left.pop(0) if left else None))
    return pairs


def _ratio(mine, ref):
    return mine / ref if ref else float("nan")


def row_readings(want: dict, got) -> list:
    """(reading, JAX, port, ratio, bar, verdict) of one matched row pair."""
    if got is None:
        return [("row", None, None, None, "answered", "MISSING")]
    out = []
    if "method" in want:
        if want["method"] == "exact":
            ok = got["recall"] == 1.0
            out.append(("recall", want["recall"], got["recall"], _ratio(got["recall"],
                        want["recall"]), "== 1.0", "met" if ok else "MISSED"))
        elif want["method"] == "approx":
            ok = got["recall"] >= want["recall"]
            out.append(("recall", want["recall"], got["recall"], _ratio(got["recall"],
                        want["recall"]), ">= JAX", "met" if ok else "MISSED"))
        else:
            ok = abs(got["recall"] - want["recall"]) <= RECALL_TOL
            out.append(("recall", want["recall"], got["recall"],
                        _ratio(got["recall"], want["recall"]),
                        f"+- {RECALL_TOL:g}", "met" if ok else "MISSED"))
        out.append(("seconds", want["seconds"], got["seconds"],
                    _ratio(got["seconds"], want["seconds"]), "-", "info"))
        return out
    if "mode" in want:
        finite = got.get("finite", True)
        out.append(("ms_per_step", want["ms_per_step"], got["ms_per_step"],
                    _ratio(got["ms_per_step"], want["ms_per_step"]), "finite",
                    "info" if finite else "MISSED"))
        return out
    for key, (lo, hi) in RATIO_BARS.items():
        if key not in want:
            continue
        if key not in got:
            out.append((key, want[key], None, None, f"{lo}-{hi}x", "MISSING"))
            continue
        r = _ratio(got[key], want[key])
        out.append((key, want[key], got[key], r, f"{lo}-{hi}x",
                    "met" if lo <= r <= hi else "MISSED"))
    for key in TREE_INFO:
        if key in want and key in got:
            out.append((key, want[key], got[key], _ratio(got[key], want[key]), "-", "info"))
    return out


def readings(a: dict) -> dict:
    """The comparable numbers of one answer or artifact without rows."""
    if "training" in a:
        e, t = a["eval"], a["training"]
        return {"first_scaled_rmse": a.get("epoch_1_loss", t["first_scaled_rmse"]),
                "final_scaled_rmse": t["final_scaled_rmse"],
                "stepwise_scaled_rmse": e["stepwise_scaled_rmse"],
                "predict_zero_baseline_scaled_rmse": e["predict_zero_baseline_scaled_rmse"],
                "median": e.get("final_acc_median_rel_err_vs_exact"),
                "rel_rmse": e.get("final_acc_rel_rmse_vs_exact"),
                "pos_rmse": (e["rollout_pos_rmse"][-1]["pos_rmse"]
                             if e.get("rollout_pos_rmse") else None)}
    if "results" in a:
        return {"surrogate_seconds": a["results"]["surrogate"]["seconds"]}
    return {k: a.get(k) for k in ("E0", "rel_energy_drift", "end_rel_err_median",
                                  "end_rel_err_p99", "ms_per_step") if k in a}


def compare(name: str, mine: dict, theirs: dict) -> list:
    """(answer, row, reading, JAX, port, ratio, bar, verdict) for one answer."""
    if "rows" in theirs:
        rows = []
        for i, (want, got) in enumerate(pair_rows(theirs["rows"], mine.get("rows", []))):
            label = f"{i}: " + " ".join(str(x) for x in row_key(want) if x is not None)
            rows += [(name, label, *r) for r in row_readings(want, got)]
        return rows
    rows = []
    mine_r, theirs_r = readings(mine), readings(theirs)
    for key, value in mine_r.items():
        ref = theirs_r.get(key)
        if value is None or ref is None:
            continue
        bar, verdict, r = "-", "-", _ratio(value, ref)
        if key == "rel_energy_drift" and name in DRIFT_BAR:
            bar = f"< {DRIFT_BAR[name]:g}"
            verdict = "met" if abs(value) < DRIFT_BAR[name] else "MISSED"
        elif key in TRAIN_BARS:
            lo, hi = TRAIN_BARS[key]
            if mine.get("n_bodies") == SEAM_N and key in SEAM_KEYS:
                bar = SEAM
            else:
                bar, verdict = f"{lo}-{hi}x", "met" if lo <= r <= hi else "MISSED"
        rows.append((name, "-", key, ref, value, r, bar, verdict))
    return rows


def with_epoch_1(a: dict, directory: str, name: str) -> dict:
    """A training answer or artifact with ``epoch_1_loss``, row 1's loss of
    ``NAME_epoch_loss.csv`` in ``directory``, where that file has one."""
    path = os.path.join(directory, name + "_epoch_loss.csv")
    if "training" not in a or not os.path.exists(path):
        return a
    with open(path, newline="") as f:
        first = next(csv.DictReader(f), None)
    return a if first is None else {**a, "epoch_1_loss": float(first["loss"])}


def _column(path: str, key: str, by: str = None) -> list:
    """The floats of column ``key`` of a CSV, or with ``by``, a dict of
    lists by the value of column ``by``."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    if by is None:
        return [float(r[key]) for r in rows]
    out = {}
    for r in rows:
        out.setdefault(r[by], []).append(float(r[key]))
    return out


def reference_rows(name: str) -> list:
    """(answer, row, reading, JAX, port, ratio, bar, verdict) of the reference
    experiment ``name``: ``results/NAME_h100/`` against ``results/NAME/``."""
    results = os.path.join(ROOT, "results")
    port, jax = os.path.join(results, name + "_h100"), os.path.join(results, name)
    lo, hi = REFERENCE_BAR
    rows = []

    def add(row, reading, ref, value, bar=None):
        """``bar``: True for the band, a note for no bar, None for information."""
        r = _ratio(value, ref)
        if bar is True:
            bar, verdict = f"{lo}-{hi}x", "met" if lo <= r <= hi else "MISSED"
        else:
            bar, verdict = (bar, "-") if bar else ("-", "info")
        rows.append((f"reference {name}", row, reading, ref, value, r, bar, verdict))

    mine = _column(os.path.join(port, "epoch_loss.csv"), "loss")
    theirs = _column(os.path.join(jax, "epoch_loss.csv"), "loss")
    later = True if len(mine) >= len(theirs) else f"none: epoch {len(mine)} of {len(theirs)}"
    add("epoch 1", "loss", theirs[0], mine[0], True)
    add(f"epoch {len(mine)}", "loss", theirs[len(mine) - 1], mine[-1], later)
    step = [_column(os.path.join(d, "test_results_stepwise.csv"), "loss", by="scene")
            for d in (jax, port)]
    for scene, (want,) in step[0].items():
        add(f"scene {scene}", "stepwise loss", want, step[1][scene][0], later)
    roll = [(_column(os.path.join(d, "test_results_rollout.csv"), "acc_rmse", by="scene"),
             _column(os.path.join(d, "test_results_rollout.csv"), "pos_rmse", by="scene"))
            for d in (jax, port)]
    for scene in roll[0][0]:
        add(f"scene {scene}", "rollout acc_rmse median", median(roll[0][0][scene]),
            median(roll[1][0][scene]))
        add(f"scene {scene}", "rollout pos_rmse last step", roll[0][1][scene][-1],
            roll[1][1][scene][-1])
    if name in JAX_RERUN:
        fname, barred = JAX_RERUN[name]
        rerun = _column(os.path.join(port, fname), "loss")
        for e, (want, got) in enumerate(zip(rerun, mine)):
            add(f"epoch {e + 1}", f"loss vs {fname}", want, got, True if e < barred else None)
    return rows


def _print_table(rows: list) -> None:
    print("| answer | row | reading | JAX | port | port / JAX | bar | verdict |\n"
          "| --- | --- | --- | --- | --- | --- | --- | --- |")
    for r in rows:
        ratio = "-" if r[5] is None else f"{r[5]:.4f}"
        print(f"| {r[0]} | {r[1]} | {r[2]} | {_fmt(r[3])} | {_fmt(r[4])} | {ratio} | "
              f"{r[6]} | {r[7]} |")
    missed = [r for r in rows if r[7] in ("MISSED", "MISSING")]
    print(f"\n{len(missed)} reading(s) outside their bar" if missed
          else "\nevery barred reading within its bar")


def _fmt(x) -> str:
    if x is None:
        return "-"
    return f"{x:.6g}" if isinstance(x, float) else str(x)


def main(argv=None) -> list:
    p = argparse.ArgumentParser()
    p.add_argument("--port", default=os.path.join(ROOT, "results", "large_scale_h100"))
    p.add_argument("--jax", default=os.path.join(ROOT, "results", "large_scale"))
    p.add_argument("names", nargs="*")
    args = p.parse_args(argv)
    names = [n for n in args.names if n != "reference"] or (
        [] if args.names else sorted(os.path.basename(f)[:-5]
                                     for f in glob.glob(os.path.join(args.port, "*.json"))))
    rows = []
    for name in names:
        jax_path = os.path.join(args.jax, name + ".json")
        if not os.path.exists(jax_path):
            continue
        with open(os.path.join(args.port, name + ".json")) as f:
            mine = with_epoch_1(json.load(f), args.port, name)
        with open(jax_path) as f:
            theirs = with_epoch_1(json.load(f), args.jax, name)
        rows += compare(name, mine, theirs)
    if names:
        _print_table(rows)
    if not args.names or "reference" in args.names:
        ref = [r for name in REFERENCE for r in reference_rows(name)]
        print("\n## The reference experiments (run_experiments.sh)\n")
        _print_table(ref)
        rows += ref
    return rows


if __name__ == "__main__":
    main()
