"""The port's answers against the JAX package's artifacts of the same name:
each reading of ``results/large_scale_h100/NAME.json`` beside
``results/large_scale/NAME.json`` and their ratio (port / JAX), as a
markdown table::

    python scripts/answer_ratios.py [--port DIR] [--jax DIR] [NAME ...]

Readings: for ``train_*`` the final training loss, stepwise error,
predict-zero baseline, median and relative RMS force error, and the
rollout's position RMSE at its horizon; for the
treecode answers the sampled (or full) median and p99 relative force error,
or for rollouts ``E0`` and the energy drift, or the sampled audit.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(a: dict) -> dict:
    """The comparable numbers of one answer or artifact."""
    if "training" in a:
        e = a["eval"]
        return {"final": a["training"]["final_scaled_rmse"],
                "stepwise": e["stepwise_scaled_rmse"],
                "zero": e["predict_zero_baseline_scaled_rmse"],
                "median": e.get("final_acc_median_rel_err_vs_exact"),
                "rel_rmse": e.get("final_acc_rel_rmse_vs_exact"),
                "pos_rmse": (e["rollout_pos_rmse"][-1]["pos_rmse"]
                             if e.get("rollout_pos_rmse") else None)}
    if "rows" in a:
        r = a["rows"][0]
        return {"median": r.get("rel_err_median"), "p99": r.get("rel_err_p99")}
    return {k: a.get(k) for k in ("E0", "rel_energy_drift", "end_rel_err_median",
                                  "end_rel_err_p99") if k in a}


def main(argv=None) -> list:
    p = argparse.ArgumentParser()
    p.add_argument("--port", default=os.path.join(ROOT, "results", "large_scale_h100"))
    p.add_argument("--jax", default=os.path.join(ROOT, "results", "large_scale"))
    p.add_argument("names", nargs="*")
    args = p.parse_args(argv)
    names = args.names or sorted(os.path.basename(f)[:-5]
                                 for f in glob.glob(os.path.join(args.port, "*.json")))
    rows = []
    print("| answer | reading | JAX | port | port / JAX |\n| --- | --- | --- | --- | --- |")
    for name in names:
        jax_path = os.path.join(args.jax, name + ".json")
        if not os.path.exists(jax_path):
            continue
        with open(os.path.join(args.port, name + ".json")) as f:
            mine = readings(json.load(f))
        with open(jax_path) as f:
            theirs = readings(json.load(f))
        for key, value in mine.items():
            ref = theirs.get(key)
            if value is None or ref is None:
                continue
            ratio = value / ref if ref else float("nan")
            rows.append((name, key, ref, value, ratio))
            print(f"| {name} | {key} | {ref:.6g} | {value:.6g} | {ratio:.4f} |")
    return rows


if __name__ == "__main__":
    main()
